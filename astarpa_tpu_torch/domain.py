"""Heuristic-informed per-pair band domains (the A* domain on device).

The port's own copy of ``astarpa_tpu/domain.py`` (numpy only, kept
identical in behaviour).

The reference restricts its block DP to cells with ``g(u) + h(u) <= f_max``
(`astarpa2/src/domain.rs:117-235`), reading ``g`` from the DP itself —
impossible for a batched device kernel without a round-trip per block.
This module computes a *static* superset up front:

    D(f_max) = { (i, j) : h_rev(i, j) + h_fwd(i, j) <= f_max }

where ``h_fwd`` is the GCSH estimate of dist((i,j) -> (n,m)) and ``h_rev``
the GCSH-on-reversed-sequences estimate of dist((0,0) -> (i,j)).  Both are
admissible, so every cell of any path with cost <= f_max lies in D, and a
banded DP covering D is exact whenever its result is <= f_max — the same
certificate as the reference's band doubling (`band.rs:100-141`), with an
f ladder starting at h_fwd(0,0) (DoublingStart::H0).

The native runtime samples D's per-column interval hull
(`native/astarpa_native.cpp::gcsh_domain`); :func:`domain_schedule` turns
the hull into the banded kernel's per-pair shift schedule + band height.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ops.bitpack import W


@dataclass
class PairDomain:
    """Sampled interval hull of D(f_max) for one pair."""

    n: int
    m: int
    f_max: int
    h0: int
    step: int
    lo: np.ndarray  # (n_samples,) row hull minima at columns 0, step, ..., n
    hi: np.ndarray
    empty: bool = False


def gcsh_domain(a: bytes, b: bytes, f_max: int, k: int = 12, r: int = 1,
                step: int = 64) -> PairDomain:
    """Sample the fwd+rev GCSH domain hull (native; falls back to the gap
    domain — h = gap cost both ways — when no native toolchain)."""
    from . import native as native_mod

    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return PairDomain(n, m, f_max, abs(n - m), step,
                          np.zeros(2, np.int32), np.full(2, m, np.int32))
    if native_mod.available():
        return native_mod.gcsh_domain(a, b, f_max, k=k, r=r, step=step)
    return gap_domain(n, m, f_max, step)


def gap_domain(n: int, m: int, f_max: int, step: int = 64) -> PairDomain:
    """Heuristic-free domain: h_fwd/h_rev = gap cost (|Δi - Δj|).  The hull
    is the cost-f_max parallelogram between the corner diagonals."""
    ns = n // step + 2
    i = np.minimum(np.arange(ns) * step, n)
    d = m - n
    s = f_max - abs(d)
    if s < 0:
        return PairDomain(n, m, f_max, abs(d), step,
                          np.zeros(ns, np.int32), np.zeros(ns, np.int32), True)
    lo = np.clip(i + min(d, 0) - s // 2, 0, m)
    hi = np.clip(i + max(d, 0) + s // 2, 0, m)
    return PairDomain(n, m, f_max, abs(d), step,
                      lo.astype(np.int32), hi.astype(np.int32))


@dataclass
class PairSchedule:
    """Kernel-ready schedule for one pair at one f_max."""

    sched: np.ndarray  # (n,) uint8 shift-before-column flags
    band_words: int    # minimal window height covering the domain
    f_max: int
    quantum: int = 1   # shifts only at multiples of this (kernel Q)


def domain_schedule(dom: PairDomain) -> PairSchedule | None:
    """Turn a sampled domain hull into a (schedule, band height) pair.

    The window top word per column is the hull top, monotonized (window
    may only widen: nondecreasing at <= 1 word/column from lo=0) and the
    band height is whatever still covers the hull bottom everywhere.
    Returns None when the hull is empty or the top would have to descend
    faster than one word per column (pathological; retry wider f).
    """
    if dom.empty:
        return None
    n, m, step = dom.n, dom.m, dom.step
    if n == 0:
        return PairSchedule(np.zeros(0, np.uint8), max(1, -(-m // W)), dom.f_max)
    ns = len(dom.lo)
    # Per-column hull: union of the two nearest samples (the native target
    # already carries the +-2*step Lipschitz margin).
    i = np.arange(n)
    s_idx = np.minimum(i // step, ns - 2)
    dlo = np.minimum(dom.lo[s_idx], dom.lo[s_idx + 1])
    dhi = np.maximum(dom.hi[s_idx], dom.hi[s_idx + 1])
    # The final column must cover the corner row m.
    dhi[-1] = max(dhi[-1], m)
    dlo[-1] = min(dlo[-1], m)

    top_word = dlo // W
    # Window top must be nondecreasing (the kernel only slides down): take
    # the running future-min (widening-only).
    top_word = np.minimum.accumulate(top_word[::-1])[::-1]
    # ... start at 0 and move at most one word per column.  The maximal
    # such minorant is the min-plus smoothing
    #   g(i) = i + min(0, min_{j<=i}(top_word(j) - j))
    # (widening-only: the window top descends earlier than needed; slope
    # stays in [0, 1] because top_word is nondecreasing).
    top_word = i + np.minimum(0, np.minimum.accumulate(top_word - i))
    # Quantize: hold the top from each Q-group start (shifts land only at
    # multiples of Q, delayed — widening-only; the band height computed
    # below against the quantized top absorbs the bottom deficit).  Pick
    # the largest Q whose group deltas stay <= 1 word.
    for quantum in (32, 16, 8, 4, 2, 1):
        tq = top_word[(i // quantum) * quantum]
        jumps = np.diff(tq, prepend=0)
        if (jumps <= 1).all():
            top_word = tq
            break
    assert (jumps >= 0).all() and (jumps <= 1).all()
    bot_word = -(-(dhi + 1) // W)  # exclusive word bound covering dhi
    band_words = int(np.max(bot_word - top_word))
    band_words = max(band_words, 1)
    return PairSchedule(jumps.astype(np.uint8), band_words, dom.f_max, quantum)


def domain_cells(dom: PairDomain) -> int:
    """Approximate |D| in DP cells (for work accounting / tests)."""
    ns = len(dom.lo)
    widths = (dom.hi - dom.lo + 1).astype(np.int64)
    return int(widths.mean() * max(dom.n, 1))
