"""Full-rectangle bitpacked Myers NW on int32 bit planes (plain torch).

The port of the NW half of ``astarpa_tpu/ops/myers.py`` and of the plain
function of ``astarpa_tpu/ops/pallas_myers.py`` (kernel K11):

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

from .words import ONES, lengths, myers_word, value_to_window


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
