"""Scalar block-grid traversal orders (host benchmark variants).

The port of ``astarpa_tpu/ops/layouts.py``, which steps numpy uint32 words
with the JAX package's ``ops.myers.step_word``; here the same five orders
step int32-view tensors (:mod:`.words`) with :func:`.myers.step_word`, on
the device of the input planes, and return int32-view tensors.

Mirror of `pa-bitpacking/src/scalar.rs:9-99`: the word-level Myers step
sweeps an (n columns) x (nw word-rows) grid, and the *order* of the sweep
is a free choice — each cell depends only on its left neighbour (through
the ``h`` bits) and its upper neighbour (through the ``v`` word).  The
reference keeps col/row/diagonal orders as scalar benchmark fodder for
memory-layout exploration; here they double as an executable statement of
the dependency structure the CUDA kernels exploit:

- ``col`` / ``col_local_h`` — column-major: K1's ring
  (``banded_ring_kernel``, ``csrc/pinned.cu``) walking columns, each
  column's words chained top to bottom through the ``h`` carry.
- ``row`` — row-major: the resident rings (``ring_body`` in
  ``csrc/pinned.cu``), which hold words and stream columns past them.
- ``diag_ru`` / ``diag_ld`` — anti-diagonal: all cells on one
  anti-diagonal are independent, which is K11's wavefront
  (``nw_kernel``, ``csrc/nw.cu``: word ``w`` takes column ``t - w`` at
  step ``t``); the two orders differ only in sweep direction, and each
  anti-diagonal is one vectorised :func:`.myers.step_word` call.

All five produce bit-identical ``(vp, vm, hp, hm)`` states; the parity
test (`tests/test_torch_extras.py`) asserts that, against the reference's
numpy output too, and checks the distance against the oracle.  The word
arithmetic wraps in int32 as the reference's does in uint32; every carry
out of a word is masked with ``& 1`` (:func:`.words.myers_word`).
"""

from __future__ import annotations

import torch

from .myers import step_word
from .words import ONES, popcount


def _eq(ca0, ca1, pb0w, pb1w):
    return (ca0 ^ pb0w) & (ca1 ^ pb1w)


def _init(n: int, nw: int, device):
    vp = torch.full((nw,), ONES, dtype=torch.int32, device=device)
    vm = torch.zeros(nw, dtype=torch.int32, device=device)
    hp = torch.ones(n, dtype=torch.int32, device=device)
    hm = torch.zeros(n, dtype=torch.int32, device=device)
    return vp, vm, hp, hm


def col(a0, a1, pb0, pb1):
    """Column by column (`scalar.rs:9-18`)."""
    n, nw = len(a0), len(pb0)
    vp, vm, hp, hm = _init(n, nw, a0.device)
    for i in range(n):
        for w in range(nw):
            vp[w], vm[w], hp[i], hm[i] = step_word(
                _eq(a0[i], a1[i], pb0[w], pb1[w]), vp[w], vm[w], hp[i], hm[i]
            )
    return vp, vm, hp, hm


def col_local_h(a0, a1, pb0, pb1):
    """Column by column with the h bit kept local (`scalar.rs:20-34`);
    valid because the top edge always enters with h = +1."""
    n, nw = len(a0), len(pb0)
    vp, vm, hp, hm = _init(n, nw, a0.device)
    for i in range(n):
        h = (torch.ones_like(hp[i]), torch.zeros_like(hm[i]))
        for w in range(nw):
            vp[w], vm[w], *h = step_word(
                _eq(a0[i], a1[i], pb0[w], pb1[w]), vp[w], vm[w], *h
            )
        hp[i], hm[i] = h
    return vp, vm, hp, hm


def row(a0, a1, pb0, pb1):
    """Word-row by word-row (`scalar.rs:36-46`)."""
    n, nw = len(a0), len(pb0)
    vp, vm, hp, hm = _init(n, nw, a0.device)
    for w in range(nw):
        for i in range(n):
            vp[w], vm[w], hp[i], hm[i] = step_word(
                _eq(a0[i], a1[i], pb0[w], pb1[w]), vp[w], vm[w], hp[i], hm[i]
            )
    return vp, vm, hp, hm


def _diag(a0, a1, pb0, pb1, reverse: bool):
    n, nw = len(a0), len(pb0)
    vp, vm, hp, hm = _init(n, nw, a0.device)
    for d in range(1, n + nw):
        i0, i1 = max(d - nw, 0), min(d, n)
        ii = torch.arange(i0, i1, device=a0.device)
        ww = d - 1 - ii  # pairs (i, w) on the anti-diagonal, independent
        if reverse:
            ii, ww = ii.flip(0), ww.flip(0)
        eq = _eq(a0[ii], a1[ii], pb0[ww], pb1[ww])
        nvp, nvm, nhp, nhm = step_word(eq, vp[ww], vm[ww], hp[ii], hm[ii])
        vp[ww], vm[ww], hp[ii], hm[ii] = nvp, nvm, nhp, nhm
    return vp, vm, hp, hm


def diag_ru(a0, a1, pb0, pb1):
    """Anti-diagonals, each swept right-up (`scalar.rs:48-75`); the
    independent cells vectorize into one `step_word` call per diagonal."""
    return _diag(a0, a1, pb0, pb1, reverse=False)


def diag_ld(a0, a1, pb0, pb1):
    """Anti-diagonals, each swept left-down (`scalar.rs:77-99`)."""
    return _diag(a0, a1, pb0, pb1, reverse=True)


LAYOUTS = {
    "col": col,
    "col_local_h": col_local_h,
    "row": row,
    "diag_ru": diag_ru,
    "diag_ld": diag_ld,
}


def distance(hp, hm, m_rows: int) -> int:
    """Unit-cost edit distance from the final bottom-edge h bits: value at
    (n, m) = m + sum of bottom horizontal deltas (rows must be word-aligned,
    i.e. ``m_rows == nw * W``)."""
    return int(m_rows + int(popcount(hp).sum()) - int(popcount(hm).sum()))
