"""Batch packing into the banded kernel's pair-minor layout.

Counterpart of ``astarpa_tpu/ops/pallas_myers.py::pack_batch_staggered``,
``_unpack_planes`` and ``_pack_planes``.  The host half is the same native
C++ ``pack_batch_planes`` (2-bit a codes 4 per byte, negated b bit planes
pair-major); the device half unpacks and transposes in torch.  Planes are
int32 views of uint32 words (see :mod:`.words`).  ``ns``/``ms`` stay host
numpy: the runner reads them on every rung.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from . import bitpack
from .words import to_tensor


def pack_batch_staggered(pairs, lane_multiple: int = 512,
                         shape_quantum: int | None = None, *, device):
    """Pack byte pairs into ``(a0, a1) (n_max, B)`` and ``(pb0, pb1) (S, B)``
    int32 planes on ``device``, plus host ``ns``/``ms`` (B,) int32.

    Returns ``((a0, a1, pb0, pb1, ns, ms), B0)`` with ``B0 = len(pairs)``;
    lanes past ``B0`` are padding (length-1 pairs).  ``shape_quantum``
    rounds the column count up and keeps the bucket-diagonal ratio in
    1/256ths, exactly as the reference does, so a stream of same-sized
    batches shares one geometry.
    """
    host = HostPack(pairs, lane_multiple, shape_quantum)
    return host.planes(0, host.B, device) + (host.ns, host.ms), len(pairs)


class HostPack:
    """The host half of a pack: the native library's pair-major buffers
    (2-bit a codes 4 per byte, negated b bit planes), or the raw byte codes
    without it, and the lengths and geometry.  :meth:`planes` uploads a
    contiguous range of lanes and unpacks it on a device, so a batch split
    over devices is packed once."""

    def __init__(self, pairs, lane_multiple: int, shape_quantum: int | None):
        B0 = len(pairs)
        B = max(lane_multiple, -(-B0 // lane_multiple) * lane_multiple)
        self.ns = np.array([len(a) for a, _ in pairs] + [1] * (B - B0), dtype=np.int32)
        self.ms = np.array([len(b) for _, b in pairs] + [1] * (B - B0), dtype=np.int32)
        n_max = max(8, int(self.ns.max()))
        S = max(1, bitpack.n_words(int(self.ms.max())))
        if shape_quantum:
            n_q = -(-n_max // shape_quantum) * shape_quantum
            ratio = -(-(S * bitpack.W * 256) // n_max)  # ceil, 1/256ths
            n_max = n_q
            S = max(S, -(-(n_q * ratio) // (256 * bitpack.W)))
        self.B, self.n_max, self.S = B, n_max, S
        self.native = native.available()
        if self.native:
            self.bufs = native.pack_batch_planes(pairs, B, n_max, S)
        else:
            acodes = np.zeros((B, n_max), dtype=np.uint8)
            bcodes = np.full((B, S * bitpack.W), 0xFF, dtype=np.uint8)  # pad char
            for idx, (a, b) in enumerate(pairs):
                acodes[idx, : len(a)] = np.frombuffer(a, np.uint8)
                bcodes[idx, : len(b)] = np.frombuffer(b, np.uint8)
            self.bufs = (acodes, bcodes)

    def planes(self, lo: int, hi: int, device) -> tuple:
        """``(a0, a1, pb0, pb1)`` of lanes ``lo:hi`` on ``device`` (the
        buffers are pair-major, so the range is one contiguous upload)."""
        cut = [to_tensor(x[lo:hi], device) for x in self.bufs]
        if self.native:
            return unpack_planes(*cut, self.n_max)
        return pack_planes(*cut, self.S)


def unpack_planes(a4: torch.Tensor, pb0pm: torch.Tensor, pb1pm: torch.Tensor,
                  n_max: int):
    """Device half of the native pack: 4-per-byte a codes (B, n4) uint8 ->
    (n_max, B) sign-mask planes; pair-major b planes (B, S) -> (S, B)."""
    B = a4.shape[0]
    shifts = (torch.arange(4, dtype=torch.uint8, device=a4.device) * 2)[None, None, :]
    ac = ((a4[:, :, None] >> shifts) & 3).reshape(B, -1)[:, :n_max].to(torch.int32)
    a0 = (-(ac & 1)).T.contiguous()
    a1 = (-((ac >> 1) & 1)).T.contiguous()
    return a0, a1, pb0pm.T.contiguous(), pb1pm.T.contiguous()


def pack_planes(acodes: torch.Tensor, bcodes: torch.Tensor, S: int):
    """Planes from raw byte codes (the path without the native library):
    acodes (B, n_max) uint8, bcodes (B, S*W) uint8 padded with 0xFF."""
    W = bitpack.W
    B = acodes.shape[0]
    ac = ((acodes >> 1) & 3).to(torch.int32)
    bc = ((bcodes >> 1) & 3).to(torch.int32)  # pad 0xFF -> code 3
    a0 = (-(ac & 1)).T.contiguous()
    a1 = (-((ac >> 1) & 1)).T.contiguous()
    shifts = torch.arange(W, dtype=torch.int32, device=acodes.device)
    bits0 = ((bc & 1) ^ 1).reshape(B, S, W)
    bits1 = (((bc >> 1) & 1) ^ 1).reshape(B, S, W)
    # Distinct bits: the int32 sum is their OR and never overflows.
    pb0 = (bits0 << shifts).sum(2, dtype=torch.int32).T.contiguous()
    pb1 = (bits1 << shifts).sum(2, dtype=torch.int32).T.contiguous()
    return a0, a1, pb0, pb1
