"""Bitpacked Myers DP on int32 bit planes (plain torch): the block DP of
the block aligner and the full-rectangle NW.

The port of ``astarpa_tpu/ops/myers.py`` and of the plain function of
``astarpa_tpu/ops/pallas_myers.py`` (kernel K11).  The block half (the
reference's ``:36-199``) drives :mod:`.block_kernel`:

- :func:`compute_block` / :func:`compute_block_eq` — a block of columns
  over a range of words: right-edge ``(vp, vm)`` and the bottom h bits of
  every column, from the sign masks or from precomputed match masks;
- :func:`fill_block` / :func:`fill_block_eq` — the same plus the planes
  after every column (for traceback);
- :func:`step_word` (:func:`.words.myers_word`), :func:`eq_cols`,
  :func:`value_to`.

The reference runs a block as a scan over columns with a scan over words
inside; here a block runs on the anti-diagonal schedule (word ``w`` takes
column ``t - w`` at step ``t``), ``ncols + nwords - 1`` vector steps
instead of ``ncols * nwords`` scalar ones, which computes the same DP bit
for bit.  The NW half:

- :func:`nw_cost_batch` — ``myers.nw_cost_padded`` vmapped
  (``nw_cost_batch``): a column loop with the words chained inside each
  column, vectorised over pairs, on the pair-major planes of
  :func:`astarpa_tpu_torch.aligners.nw.pack_batch`;
- :func:`nw_right_edge_ref` — the plain K11: each pair's ``(vp, vm)``
  planes at column ``n`` on all S words (pad rows included), on the
  pair-minor planes of :mod:`.pack`, computed on the TPU kernel's own
  anti-diagonal schedule (word ``w`` runs column ``t - w`` at step ``t``).

Both compute the same DP; the CUDA kernel (``csrc/nw.cu``, wrapper
:func:`.nw_kernel.nw_right_edge`) must match the second bit for bit.  Every
entry point of the port runs the second (through the wrapper); the first
is the reference's public column loop, kept as an implementation
independent of K11's schedule that the tests hold both against.  The
reference's ``popcount``, ``value_to``, ``row_valid_mask`` and
``_value_up_to`` are :func:`.words.popcount`, :func:`.words.value_to_window`
and :func:`.words.prefix_mask`.
"""

from __future__ import annotations

import torch

from .bitpack import W
from .words import ONES, lengths, myers_word, popcount, prefix_mask, value_to_window

#: One 32-cell column step of Myers'99 (the reference's ``step_word``).
step_word = myers_word


def eq_cols(a0, a1, pb0, pb1):
    """Match masks for columns x words: ``eq[i, w]`` (ncols, nwords)."""
    return (a0[:, None] ^ pb0[None, :]) & (a1[:, None] ^ pb1[None, :])


def value_to(vp, vm, j):
    """Sum of the vertical diffs of rows ``[0, j)`` of (..., nwords) word
    planes (the reference's ``value_to``)."""
    rows = torch.arange(vp.shape[-1], dtype=torch.int32, device=vp.device) * W
    mask = prefix_mask((j - rows).clamp(0, W))
    return (popcount(vp & mask) - popcount(vm & mask)).sum(-1, dtype=torch.int32)


def compute_block(a0, a1, pb0, pb1, vp, vm, hp_in, hm_in):
    """A block of ``ncols`` columns over ``nwords`` words.

    a0/a1: (ncols,) sign masks of the ``a`` slice; pb0/pb1: (nwords,)
    negated profile words of the ``b`` slice; vp/vm: (nwords,) vertical
    diffs at the left edge; hp_in/hm_in: (ncols,) 0/1 horizontal diff bits
    entering at the top of each column.  Returns ``(vp, vm, hp_out,
    hm_out)``: the right-edge diffs and the bits leaving the bottom word of
    each column."""
    return _block(eq_cols(a0, a1, pb0, pb1), vp, vm, hp_in, hm_in, fill=False)


def fill_block(a0, a1, pb0, pb1, vp, vm, hp_in, hm_in):
    """:func:`compute_block` plus the planes after every column: ``(vp, vm,
    hp_out, hm_out, vp_cols, vm_cols)``, the planes (ncols, nwords)."""
    return _block(eq_cols(a0, a1, pb0, pb1), vp, vm, hp_in, hm_in, fill=True)


def compute_block_eq(eqs, vp, vm, hp_in, hm_in):
    """:func:`compute_block` over precomputed (ncols, nwords) match masks."""
    return _block(eqs, vp, vm, hp_in, hm_in, fill=False)


def fill_block_eq(eqs, vp, vm, hp_in, hm_in):
    """:func:`fill_block` over precomputed (ncols, nwords) match masks."""
    return _block(eqs, vp, vm, hp_in, hm_in, fill=True)


def _block(eqs, vp, vm, hp_in, hm_in, fill: bool):
    """The block DP on the anti-diagonal schedule: at step ``t`` word ``w``
    runs column ``t - w`` when that column exists, taking its h bits from
    word ``w - 1``'s step ``t - 1`` (word 0: the column's top bits)."""
    ncols, nwords = eqs.shape
    dev = eqs.device
    if ncols == 0 or nwords == 0:  # the h bits pass straight through
        out = (vp.clone(), vm.clone(), hp_in.clone(), hm_in.clone())
        return out + (eqs.new_empty((ncols, nwords)),) * 2 if fill else out
    T = ncols + nwords - 1
    w = torch.arange(nwords, device=dev)[None, :]
    col = torch.arange(T, device=dev)[:, None] - w
    act = (col >= 0) & (col < ncols)
    eqd = eqs[col.clamp(0, ncols - 1), w]  # (T, nwords): the mask word w meets at step t
    top_p = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    top_m = torch.zeros_like(top_p)
    top_p[:ncols], top_m[:ncols] = hp_in, hm_in
    hop = torch.zeros(nwords, dtype=torch.int32, device=dev)
    hom = torch.zeros_like(hop)
    bot_p = torch.empty(T, dtype=torch.int32, device=dev)
    bot_m = torch.empty_like(bot_p)
    if fill:
        vpd = torch.empty((T, nwords), dtype=torch.int32, device=dev)
        vmd = torch.empty_like(vpd)
    for t in range(T):
        vp2, vm2, hp2, hm2 = myers_word(eqd[t], vp, vm,
                                        torch.cat([top_p[t:t + 1], hop[:-1]]),
                                        torch.cat([top_m[t:t + 1], hom[:-1]]))
        a = act[t]
        vp, vm = torch.where(a, vp2, vp), torch.where(a, vm2, vm)
        hop, hom = torch.where(a, hp2, hop), torch.where(a, hm2, hom)
        bot_p[t], bot_m[t] = hop[-1], hom[-1]
        if fill:
            vpd[t], vmd[t] = vp, vm
    out = (vp, vm, bot_p[nwords - 1:], bot_m[nwords - 1:])
    if not fill:
        return out
    diag = torch.arange(ncols, device=dev)[:, None] + w  # column c of word w ran at step c + w
    return out + (vpd[diag, w], vmd[diag, w])


def nw_cost_batch(a0, a1, pb0, pb1, n, m) -> torch.Tensor:
    """Edit distances of a pair-major batch, ``(B,)`` int32.

    a0/a1: (B, max_n) sign-mask planes; pb0/pb1: (B, max_words) negated b
    profiles (pad rows code 3); n/m: (B,) true lengths.  A pair's columns
    past its ``n`` leave its state unchanged, so the final ``(vp, vm)`` is
    the right edge at column ``n`` and the cost is ``n + value_to(v, m)``.
    """
    B, nwords = pb0.shape
    dev = a0.device
    n, m = lengths(n, B, dev), lengths(m, B, dev)
    vp = torch.full((B, nwords), ONES, dtype=torch.int32, device=dev)
    vm = torch.zeros_like(vp)
    top_p, top_m = torch.ones_like(n), torch.zeros_like(n)  # +1 at the top row
    for i in range(int(n.max()) if B else 0):  # columns past every n change nothing
        eq = (a0[:, i, None] ^ pb0) & (a1[:, i, None] ^ pb1)
        hp, hm, new_vp, new_vm = top_p, top_m, [], []
        for w in range(nwords):
            vpw, vmw, hp, hm = myers_word(eq[:, w], vp[:, w], vm[:, w], hp, hm)
            new_vp.append(vpw)
            new_vm.append(vmw)
        active = (i < n)[:, None]
        vp = torch.where(active, torch.stack(new_vp, 1), vp)
        vm = torch.where(active, torch.stack(new_vm, 1), vm)
    return n + value_to_window(vp.T, vm.T, m)


def nw_right_edge_ref(a0, a1, pb0, pb1, n):
    """Plain K11: right-edge ``(vp, vm)`` (S, B) int32 planes at column
    ``n`` per pair.

    a0/a1: (n_max, B) sign-mask planes; pb0/pb1: (S, B) negated b profiles;
    n: (B,) lengths in ``[0, n_max]``.  Step ``t`` advances every word
    ``w`` with ``0 <= t - w < n`` by column ``t - w``; the h carry moves
    down one word a step, entering the top word as +1.  ``n == 0`` keeps
    the all-ones column 0 state.
    """
    n_max, B = a0.shape
    S = pb0.shape[0]
    dev = a0.device
    n = lengths(n, B, dev)
    w = torch.arange(S, dtype=torch.int64, device=dev)[:, None]
    vp = torch.full((S, B), ONES, dtype=torch.int32, device=dev)
    vm = torch.zeros_like(vp)
    hop, hom = torch.zeros_like(vp), torch.zeros_like(vp)
    top_p, top_m = torch.ones_like(vp[:1]), torch.zeros_like(vp[:1])
    for t in range(n_max + S - 1):
        col = t - w
        rows = col.clamp(0, n_max - 1)[:, 0]
        eq = (a0[rows] ^ pb0) & (a1[rows] ^ pb1)
        hin_p = torch.cat([top_p, hop[:-1]])
        hin_m = torch.cat([top_m, hom[:-1]])
        vp2, vm2, hop2, hom2 = myers_word(eq, vp, vm, hin_p, hin_m)
        act = (col >= 0) & (col < n[None, :])
        vp, vm = torch.where(act, vp2, vp), torch.where(act, vm2, vm)
        hop, hom = torch.where(act, hop2, hop), torch.where(act, hom2, hom)
    return vp, vm
