"""Banded batched Myers DP: host schedule, certificates and the plain
torch version of the cost kernel.

Counterpart of ``astarpa_tpu/ops/banded.py``.  A bucket of similarly sized
pairs is aligned with one window of ``band_words`` uint32 words per pair
that slides down one word whenever the bucket diagonal crosses a word
boundary (the shared schedule :func:`shift_at_array`).  The result is an
upper bound that equals the edit distance whenever the optimal path stays
inside the band; :func:`band_threshold` certifies that.

The schedule and certificate helpers are numpy, copied verbatim from the
reference (which lives in a module that depends on JAX).
:func:`banded_cost_ref` is the plain torch version of the CUDA kernel
(``csrc/banded_cost.cu``) and bit-identical to the reference's
``banded_cost_block``; the CPU runs it, the card compares against it.
"""

from __future__ import annotations

import numpy as np
import torch

from astarpa_tpu.ops.bitpack import W, n_words

from .words import ONES, myers_word, popcount, value_to_window

#: Result of a pair whose final row lies below the window (never certified).
INF = 1 << 30


def shift_schedule(n_max: int, m_max: int, band_words: int) -> tuple[int, int]:
    """Static schedule parameters ``(lo_max, m_words)``: the window top word
    never passes ``lo_max = m_words - band_words``."""
    m_words = n_words(m_max) if m_max else 1
    lo_max = max(0, m_words - band_words)
    return lo_max, m_words


def shift_at_array(n_max: int, s_words: int, band_words: int,
                   diag: tuple[int, int] | None = None) -> np.ndarray:
    """Host-precomputed schedule: ``shift_at[i] = 1`` iff the window slides
    one word down before processing column ``i``.

    diag: the true bucket diagonal ``(n_top, m_top)`` the window centre
    tracks; defaults to the padded ``(n_max, s_words*W)``.  Aiming at the
    true tops keeps shape padding out of the band certificate."""
    SW = min(band_words, s_words)
    lo_max = max(0, s_words - SW)
    half = (SW * W) // 2
    n_top, m_top = diag if diag is not None else (n_max, s_words * W)
    n = max(n_top, 1)
    i = np.arange(n_max, dtype=np.int64)
    center = (2 * np.minimum(i, n - 1) + 1) * m_top // (2 * n)
    desired = np.clip((center - half) // W, 0, lo_max)
    shift = np.diff(np.concatenate([[0], desired])).astype(np.int32)
    # One shift per column max (guaranteed by bucketing: m_max <= W * n_max).
    assert (shift >= 0).all() and (shift <= 1).all(), (
        "bucket too skewed: m_max > W * n_max"
    )
    return shift


def band_threshold(band_words: int, n, m, n_max: int, m_max: int):
    """Largest certified-exact distance for this band (numpy, per pair):
    ``band_words*W - 4W - |m-n| - 2*dev``, with ``dev`` the pair's skew
    against the bucket diagonal ``(n_max, m_max)``."""
    n = np.maximum(np.asarray(n, np.int64), 1)
    m = np.asarray(m, np.int64)
    g = np.abs(m - n)
    dev = np.abs(m_max * n // max(n_max, 1) - m)
    return band_words * W - 4 * W - g - 2 * dev


def band_for_cost(cost, n, m, n_max: int, m_max: int):
    """Smallest band (words, per pair) whose :func:`band_threshold` admits
    ``cost``.  A failed rung's banded result is an upper bound on the true
    distance, so this jumps the ladder straight to a certifying band."""
    n = np.maximum(np.asarray(n, np.int64), 1)
    m = np.asarray(m, np.int64)
    g = np.abs(m - n)
    dev = np.abs(m_max * n // max(n_max, 1) - m)
    return -(-(np.asarray(cost, np.int64) + 4 * W + g + 2 * dev) // W)


def banded_cost_ref(a0, a1, pb0, pb1, n, m, band_words: int,
                    diag: tuple | None = None) -> torch.Tensor:
    """Banded edit distances (upper bounds) for one shape bucket: the plain
    torch version of the cost kernel.

    Args:
      a0, a1: (n_max, B) int32 a-char sign-mask planes.
      pb0, pb1: (S, B) int32 negated b profiles (pad rows read as 'G').
      n, m: (B,) true lengths (numpy or tensor).
      band_words: window height in words; clamped to S.
      diag: bucket diagonal for :func:`shift_at_array`.

    Returns (B,) int32 on the planes' device: ``m`` where ``n == 0``,
    ``INF`` where the window no longer covers row ``m`` at column ``n-1``.
    """
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = min(band_words, S)
    dev = a0.device
    n_host = np.asarray(torch.as_tensor(n).cpu(), np.int64)
    n_t = torch.as_tensor(n_host, dtype=torch.int32, device=dev)
    m_t = torch.as_tensor(np.asarray(torch.as_tensor(m).cpu()),
                          dtype=torch.int32, device=dev)
    shift_at = shift_at_array(n_max, S, SW, diag)
    capture_cols = set(int(c) for c in n_host - 1 if c >= 0)

    vp = torch.full((SW, B), ONES, dtype=torch.int32, device=dev)
    vm = torch.zeros((SW, B), dtype=torch.int32, device=dev)
    top_val = torch.zeros(B, dtype=torch.int32, device=dev)
    top_rows = torch.zeros(B, dtype=torch.int32, device=dev)
    result = m_t.clone()  # n == 0 pairs keep cost m
    ones_row = torch.ones(B, dtype=torch.int32, device=dev)
    zeros_row = torch.zeros(B, dtype=torch.int32, device=dev)
    lo = 0
    for i in range(n_max):
        if shift_at[i]:
            # Every lane absorbs the departing top word, active or not.
            top_val = top_val + popcount(vp[0]) - popcount(vm[0])
            top_rows = top_rows + W
            vp = torch.cat([vp[1:], torch.full_like(vp[:1], ONES)])
            vm = torch.cat([vm[1:], torch.zeros_like(vm[:1])])
            lo += 1
        eq = (a0[i] ^ pb0[lo:lo + SW]) & (a1[i] ^ pb1[lo:lo + SW])
        vp2 = torch.empty_like(vp)
        vm2 = torch.empty_like(vm)
        hp, hm = ones_row, zeros_row
        for w in range(SW):
            vp2[w], vm2[w], hp, hm = myers_word(eq[w], vp[w], vm[w], hp, hm)
        active = i < n_t
        vp = torch.where(active, vp2, vp)
        vm = torch.where(active, vm2, vm)
        top_val = top_val + active.to(torch.int32)
        if i in capture_cols:
            rows = m_t - top_rows
            res_now = top_val + value_to_window(vp, vm, rows)
            res_now = torch.where(rows <= SW * W, res_now, INF)
            result = torch.where(n_t - 1 == i, res_now, result)
    return result
