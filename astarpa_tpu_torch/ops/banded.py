"""Banded batched Myers DP: host schedules, certificates and the plain
torch versions of the banded kernels.

Counterpart of ``astarpa_tpu/ops/banded.py``.  A bucket of similarly sized
pairs is aligned with one window of ``band_words`` uint32 words per pair
that slides down one word whenever the bucket diagonal crosses a word
boundary (the shared schedule :func:`shift_at_array`), or on each pair's
own schedule (:func:`pair_gap_schedule`, :mod:`..domain`).  The
result is an upper bound that equals the edit distance whenever the
optimal path stays inside the band; :func:`band_threshold` certifies that.

The schedule and certificate helpers are numpy, copied verbatim from the
reference (which lives in a module that depends on JAX).  The plain torch
versions of the CUDA kernels (``csrc/banded.cu``) share one column loop,
:func:`_sweep`: :func:`banded_cost_ref` (K1), :func:`banded_ck_ref` (K2),
:func:`banded_fill_ref` and :func:`banded_fill_pp_ref` (K3: every column's
planes, the reference's ``banded_fill`` and ``banded_fill_tpu``), and
:func:`banded_cost_pp_ref` and :func:`banded_ck_pp_ref` (K4).  They are bit-identical to the reference; the CPU runs
them, the card compares against them.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitpack import W, n_words
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


#: Per-pair schedules only shift at multiples of this column quantum (the
#: kernels read the schedule only there).
SCHEDULE_Q = 32


def pair_gap_schedule(n, m, band_words: int, n_max: int, s_words: int):
    """Per-pair shift schedules: each window tracks its own pair's
    gap-centered line (row center ``i + (m-n)/2``), so the exactness
    threshold drops to ``SW*W - 6W`` with no ``|m-n|`` or bucket-skew terms.
    The ``6W`` slack covers the word quantization of the window top, the
    SCHEDULE_Q-delayed shifts' bottom deficit and the ``//2`` center
    rounding.

    Returns ``(sched (n_max, B) uint8, thr (B,) int64)``; ``thr[p] = -1``
    marks pairs whose parallelogram cannot be entered at <=1 word shift per
    column from lo=0 (|m-n| >= SW*W): never certified at this band.
    """
    n_arr = np.maximum(np.asarray(n, np.int64), 1)
    m_arr = np.asarray(m, np.int64)
    B = n_arr.shape[0]
    SW = min(band_words, s_words)
    half = (SW * W) // 2
    lo_max = np.maximum(0, -(-m_arr // W) - SW)  # window must end over m
    d = m_arr - n_arr
    i = np.arange(n_max, dtype=np.int64)[:, None]
    # Freeze each pair's schedule at its own final column.
    i_eff = np.minimum(i, np.maximum(n_arr, 1)[None, :] - 1)
    center = (2 * i_eff + d[None, :]) // 2
    desired = np.clip((center - half) // W, 0, lo_max[None, :])
    # Hold from each group start: shifts only at multiples of SCHEDULE_Q,
    # delayed (the top stays higher, sound; the <= 1-word bottom deficit is
    # in the -6W slack).  The slope is 1/W per column, so group deltas are
    # always <= 1.
    desired = desired[(i[:, 0] // SCHEDULE_Q) * SCHEDULE_Q]
    sched = np.diff(desired, axis=0, prepend=0).astype(np.uint8)
    bad = desired[0] > 0
    sched[:, bad] = 0
    thr = np.full(B, SW * W - 6 * W, np.int64)
    thr[bad] = -1
    assert (sched <= 1).all()
    return sched, thr


def check_schedule(schedule, n_max: int, B: int, quantum: int) -> np.ndarray:
    """Validate a per-pair schedule: host (n_max, B) 0/1 that shifts only at
    columns that are multiples of ``quantum``.  The kernels read it only at
    those columns, so an unquantized schedule would silently differ.
    Returns it as contiguous uint8."""
    sched = np.ascontiguousarray(schedule, dtype=np.uint8)
    if sched.shape != (n_max, B):
        raise ValueError(f"schedule must be ({n_max}, {B}), got {sched.shape}")
    if quantum < 1:
        raise ValueError(f"schedule quantum must be >= 1, got {quantum}")
    if sched.max(initial=0) > 1:
        raise ValueError("schedule entries must be 0 or 1")
    if quantum > 1 and sched[np.arange(n_max) % quantum != 0].any():
        raise ValueError(f"schedule shifts off its quantum {quantum}")
    return sched


def ck_col_block(col_block: int, n_max: int, quantum: int | None = None) -> int:
    """Effective checkpoint interval: ``min(col_block, n_max)``, rounded for
    per-pair schedules (``quantum`` set) to whole quantum groups,
    ``max(Q, CB // Q * Q)``.  Checkpoint k is taken before column k*CB."""
    cb = min(col_block, max(n_max, 1))
    if quantum is not None:
        cb = max(quantum, cb // quantum * quantum)
    if cb < 1:
        raise ValueError(f"col_block must be >= 1, got {col_block}")
    return cb


def _sweep(a0, a1, pb0, pb1, n, m, SW: int, shift, *, ck_cb: int | None = None,
           fill: bool = False):
    """The plain column loop every mode shares.

    ``shift``: host numpy, either a shared (n_max,) 0/1 schedule or a
    per-pair (n_max, B) one (already checked by :func:`check_schedule`).
    Before column i, every lane whose schedule says so absorbs its window's
    top word into ``top_val`` and slides one word down; the entering
    profile word is ``pb[min(lo+SW-1, S-1)]``.  Lanes slide whether or not
    they are still active; only active lanes (``i < n``) run the column.

    Returns ``(result, ck, cols)``: ck is ``(vp, vm, tv)`` of shapes
    (n_ck, SW, B), (n_ck, SW, B), (n_ck, B) when ``ck_cb`` is set
    (checkpoint k = the window and ``top_val`` before column k*ck_cb's
    shift), cols ``(vp, vm)`` (n_max, SW, B) after every column when
    ``fill``.
    """
    n_max, B = a0.shape
    S = pb0.shape[0]
    dev = a0.device
    n_host = np.asarray(torch.as_tensor(n).cpu(), np.int64)
    n_t = torch.as_tensor(n_host, dtype=torch.int32, device=dev)
    m_t = torch.as_tensor(np.asarray(torch.as_tensor(m).cpu()),
                          dtype=torch.int32, device=dev)
    capture_cols = set(int(c) for c in n_host - 1 if c >= 0)
    per_pair = shift.ndim == 2
    if per_pair:
        shift_cols = np.flatnonzero(shift.any(axis=1))
        shift_t = torch.as_tensor(shift, device=dev).bool()
    else:
        shift_cols = np.flatnonzero(shift)
    shift_cols = set(int(c) for c in shift_cols)

    vp = torch.full((SW, B), ONES, dtype=torch.int32, device=dev)
    vm = torch.zeros((SW, B), dtype=torch.int32, device=dev)
    win0, win1 = pb0[:SW].clone(), pb1[:SW].clone()
    lo = torch.zeros(B, dtype=torch.int64, device=dev)
    top_val = torch.zeros(B, dtype=torch.int32, device=dev)
    top_rows = torch.zeros(B, dtype=torch.int32, device=dev)
    result = m_t.clone()  # n == 0 pairs keep cost m
    ones_row = torch.ones(B, dtype=torch.int32, device=dev)
    zeros_row = torch.zeros(B, dtype=torch.int32, device=dev)
    ck = cols = None
    if ck_cb is not None:
        n_ck = -(-n_max // ck_cb)
        ck = (torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
              torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
              torch.empty((n_ck, B), dtype=torch.int32, device=dev))
    if fill:
        cols = (torch.empty((n_max, SW, B), dtype=torch.int32, device=dev),
                torch.empty((n_max, SW, B), dtype=torch.int32, device=dev))
    for i in range(n_max):
        if ck is not None and i % ck_cb == 0:
            ck[0][i // ck_cb], ck[1][i // ck_cb], ck[2][i // ck_cb] = vp, vm, top_val
        if i in shift_cols:
            lo_new = lo + (shift_t[i].long() if per_pair else 1)
            ent = torch.clamp(lo_new + SW - 1, max=S - 1)[None, :]
            rolled = (
                torch.cat([vp[1:], torch.full_like(vp[:1], ONES)]),
                torch.cat([vm[1:], torch.zeros_like(vm[:1])]),
                torch.cat([win0[1:], pb0.gather(0, ent)]),
                torch.cat([win1[1:], pb1.gather(0, ent)]),
            )
            gain = popcount(vp[0]) - popcount(vm[0])
            if per_pair:
                sel = shift_t[i]
                top_val = torch.where(sel, top_val + gain, top_val)
                top_rows = top_rows + W * sel.to(torch.int32)
                vp, vm, win0, win1 = (torch.where(sel[None, :], r, x) for r, x in
                                      zip(rolled, (vp, vm, win0, win1)))
            else:
                top_val = top_val + gain
                top_rows = top_rows + W
                vp, vm, win0, win1 = rolled
            lo = lo_new
        eq = (a0[i] ^ win0) & (a1[i] ^ win1)
        vp2 = torch.empty_like(vp)
        vm2 = torch.empty_like(vm)
        hp, hm = ones_row, zeros_row
        for w in range(SW):
            vp2[w], vm2[w], hp, hm = myers_word(eq[w], vp[w], vm[w], hp, hm)
        active = i < n_t
        vp = torch.where(active, vp2, vp)
        vm = torch.where(active, vm2, vm)
        top_val = top_val + active.to(torch.int32)
        if cols is not None:
            cols[0][i], cols[1][i] = vp, vm
        if i in capture_cols:
            rows = m_t - top_rows
            res_now = top_val + value_to_window(vp, vm, rows)
            res_now = torch.where(rows <= SW * W, res_now, INF)
            result = torch.where(n_t - 1 == i, res_now, result)
    return result, ck, cols


def banded_cost_ref(a0, a1, pb0, pb1, n, m, band_words: int,
                    diag: tuple | None = None) -> torch.Tensor:
    """Banded edit distances (upper bounds) for one shape bucket on the
    shared schedule: the plain torch version of kernel K1, bit-identical to
    the reference's ``banded_cost_block``.

    Args:
      a0, a1: (n_max, B) int32 a-char sign-mask planes.
      pb0, pb1: (S, B) int32 negated b profiles (pad rows read as 'G').
      n, m: (B,) true lengths (numpy or tensor).
      band_words: window height in words; clamped to S.
      diag: bucket diagonal for :func:`shift_at_array`.

    Returns (B,) int32 on the planes' device: ``m`` where ``n == 0``,
    ``INF`` where the window no longer covers row ``m`` at column ``n-1``.
    """
    n_max, S = a0.shape[0], pb0.shape[0]
    SW = min(band_words, S)
    return _sweep(a0, a1, pb0, pb1, n, m, SW, shift_at_array(n_max, S, SW, diag))[0]


def banded_fill_ref(a0, a1, pb0, pb1, n, m, band_words: int,
                    diag: tuple | None = None):
    """Like :func:`banded_cost_ref`, also returning the window planes after
    every column: ``(costs, vp_cols, vm_cols)`` with planes (n_max, SW, B),
    the twin of the reference's ``banded_fill_block``: the plain version of
    kernel K3.  Row i is the window after column i's shift and word steps;
    a lane past its pair's end keeps its window and still slides."""
    n_max, S = a0.shape[0], pb0.shape[0]
    SW = min(band_words, S)
    res, _, cols = _sweep(a0, a1, pb0, pb1, n, m, SW,
                          shift_at_array(n_max, S, SW, diag), fill=True)
    return (res,) + cols


def banded_fill_pp_ref(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                       quantum: int = SCHEDULE_Q):
    """:func:`banded_fill_ref` on a per-pair schedule: the plain version of
    kernel K3 with ``schedule=`` (the reference's ``banded_fill_tpu(...,
    schedule=...)``).  ``schedule``: host (n_max, B) 0/1, shifting only at
    multiples of ``quantum``; each pair's entering word is clamped at row
    S-1, as :func:`banded_cost_pp_ref`'s."""
    n_max, B = a0.shape
    SW = min(band_words, pb0.shape[0])
    sched = check_schedule(schedule, n_max, B, quantum)
    res, _, cols = _sweep(a0, a1, pb0, pb1, n, m, SW, sched, fill=True)
    return (res,) + cols


def banded_ck_ref(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
                  diag: tuple | None = None):
    """Banded costs plus window checkpoints on the shared schedule: the
    plain version of kernel K2 (the reference's ``banded_ck_tpu`` with
    ``schedule=None``).

    Returns ``(costs (B,), ck_vp (n_ck, SW, B), ck_vm, ck_tv (n_ck, B))``
    with ``CB = min(col_block, n_max)`` and ``n_ck = ceil(n_max / CB)``:
    checkpoint k holds the window planes and ``top_val`` before the shift
    of column k*CB (checkpoint 0 is the all-ones init with top_val 0).
    Finished lanes keep sliding, so every checkpoint is defined.
    """
    n_max, S = a0.shape[0], pb0.shape[0]
    SW = min(band_words, S)
    res, ck, _ = _sweep(a0, a1, pb0, pb1, n, m, SW,
                        shift_at_array(n_max, S, SW, diag),
                        ck_cb=ck_col_block(col_block, n_max))
    return (res,) + ck


def banded_cost_pp_ref(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                       quantum: int = SCHEDULE_Q) -> torch.Tensor:
    """Banded upper bounds with a per-pair schedule: the plain version of
    kernel K4 in cost mode, bit-identical to the reference's
    ``banded_cost_block_pp``.  ``schedule``: host (n_max, B) 0/1, shifting
    only at multiples of ``quantum``; each pair's entering word is clamped
    at row S-1."""
    n_max, B = a0.shape
    SW = min(band_words, pb0.shape[0])
    sched = check_schedule(schedule, n_max, B, quantum)
    return _sweep(a0, a1, pb0, pb1, n, m, SW, sched)[0]


def banded_ck_pp_ref(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                     col_block: int, quantum: int = SCHEDULE_Q):
    """:func:`banded_cost_pp_ref` plus checkpoints (kernel K4 in ck mode),
    the contract of :func:`banded_ck_ref` with the interval rounded to whole
    quantum groups (:func:`ck_col_block`)."""
    n_max, B = a0.shape
    SW = min(band_words, pb0.shape[0])
    sched = check_schedule(schedule, n_max, B, quantum)
    res, ck, _ = _sweep(a0, a1, pb0, pb1, n, m, SW, sched,
                        ck_cb=ck_col_block(col_block, n_max, quantum))
    return (res,) + ck
