"""Entry points of the block DP for the block aligner
(:mod:`..aligners.block`, :mod:`..aligners.astarpa2`).

Counterpart of ``astarpa_tpu/ops/block_kernel.py``: :class:`BlockKernel`
holds one pair's packed planes and computes column ranges x word ranges,
natively (``native.block_compute`` / ``block_fill``) or with the torch
block DP (:func:`.myers.compute_block` / :func:`.myers.fill_block`) on a
device.  The reference pads every block to a shape bucket so that XLA
compiles one kernel a bucket (columns masked, extra words below the range
computed and dropped, which is exact: DP values at row j depend only on
rows <= j); torch runs the exact shapes, with the same results.

Mirrors `astarpa2/src/blocks.rs:686-748` (`compute_block`) and
`pa_bitpacking::simd::fill` (`simd.rs:326-437`) at the API level.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import myers
from .words import to_numpy_u32, to_tensor


class BlockKernel:
    """Host-facing kernel wrapper around one pair's packed profiles.

    Holds the full packed ``a`` planes and ``b`` word-planes, and computes
    column ranges x word ranges.  Results are host numpy uint32 arrays on
    both paths.

    Args:
      a0, a1: (n,) uint32 sign masks of ``a``; pb0, pb1: (words,) uint32
        negated profile of ``b``.
      device: where the torch path runs: None = the card (raises without
        one), or "cpu".  Unused on the native path.
    """

    #: Class-level switch: None = auto (native when available).  The torch
    #: path stays as the device twin; tests force both.
    use_native: bool | None = None

    def __init__(self, a0, a1, pb0, pb1, device=None):
        self.a0 = np.ascontiguousarray(a0, dtype=np.uint32)
        self.a1 = np.ascontiguousarray(a1, dtype=np.uint32)
        self.pb0 = np.ascontiguousarray(pb0, dtype=np.uint32)
        self.pb1 = np.ascontiguousarray(pb1, dtype=np.uint32)
        # Stats, mirroring BlockStats (`blocks.rs:76-84`).
        self.computed_lanes = 0
        self.computed_cols = 0
        if BlockKernel.use_native is None:
            from .. import native

            self._native = native.available()
        else:
            self._native = bool(BlockKernel.use_native)
        self.device = None
        if not self._native:
            self.device = resolve_device(device)
            self._planes = tuple(to_tensor(x, self.device)
                                 for x in (self.a0, self.a1, self.pb0, self.pb1))

    def _host_slices(self, i0, i1, w0, w1):
        """The native path's inputs: the a columns and the profile words of
        the range, zero past the profile's end."""
        nwords = w1 - w0
        pb0 = np.zeros(nwords, np.uint32)
        pb1 = np.zeros(nwords, np.uint32)
        avail = max(0, min(w1, len(self.pb0)) - w0)
        pb0[:avail] = self.pb0[w0 : w0 + avail]
        pb1[:avail] = self.pb1[w0 : w0 + avail]
        return (np.ascontiguousarray(self.a0[i0:i1]),
                np.ascontiguousarray(self.a1[i0:i1]), pb0, pb1)

    def _device_slices(self, i0, i1, w0, w1):
        """:meth:`_host_slices` on the device, cut from the planes uploaded
        once."""
        a0, a1, pb0_all, pb1_all = self._planes
        pb0 = torch.zeros(w1 - w0, dtype=torch.int32, device=self.device)
        pb1 = torch.zeros_like(pb0)
        avail = max(0, min(w1, len(self.pb0)) - w0)
        pb0[:avail] = pb0_all[w0 : w0 + avail]
        pb1[:avail] = pb1_all[w0 : w0 + avail]
        return a0[i0:i1], a1[i0:i1], pb0, pb1

    def _upload(self, x, size: int, fill: int) -> torch.Tensor:
        x = np.full(size, fill, np.uint32) if x is None else np.asarray(x, np.uint32)
        return to_tensor(x, self.device)

    def compute(self, i0, i1, w0, w1, vp, vm, hp_in=None, hm_in=None):
        """Compute columns (i0, i1] over word rows [w0, w1).

        vp/vm: (w1-w0,) uint32 left-edge vertical diffs (consumed).
        hp_in/hm_in: optional (i1-i0,) top-edge h bits; default +1.
        Returns (vp, vm, hp_out, hm_out) as numpy, cropped to true sizes.
        """
        ncols = i1 - i0
        nwords = w1 - w0
        self.computed_lanes += nwords * ncols
        self.computed_cols += ncols
        if self._native:
            from .. import native

            a0, a1, pb0, pb1 = self._host_slices(i0, i1, w0, w1)
            vp_o = np.ascontiguousarray(vp, np.uint32).copy()
            vm_o = np.ascontiguousarray(vm, np.uint32).copy()
            hp = np.ascontiguousarray(
                hp_in if hp_in is not None else np.ones(ncols, np.uint32),
                np.uint32,
            ).copy()
            hm = np.ascontiguousarray(
                hm_in if hm_in is not None else np.zeros(ncols, np.uint32),
                np.uint32,
            ).copy()
            native.block_compute(a0, a1, pb0, pb1, vp_o, vm_o, hp, hm)
            return vp_o, vm_o, hp, hm

        out = myers.compute_block(
            *self._device_slices(i0, i1, w0, w1),
            self._upload(vp, nwords, 0), self._upload(vm, nwords, 0),
            self._upload(hp_in, ncols, 1), self._upload(hm_in, ncols, 0),
        )
        return tuple(to_numpy_u32(x) for x in out)

    def fill(self, i0, i1, w0, w1, vp, vm):
        """Like compute but returns per-column v planes (ncols, nwords)."""
        ncols = i1 - i0
        nwords = w1 - w0
        self.computed_lanes += nwords * ncols
        self.computed_cols += ncols
        if self._native:
            from .. import native

            a0, a1, pb0, pb1 = self._host_slices(i0, i1, w0, w1)
            vp_c = np.ascontiguousarray(vp, np.uint32).copy()
            vm_c = np.ascontiguousarray(vm, np.uint32).copy()
            hp = np.ones(ncols, np.uint32)
            hm = np.zeros(ncols, np.uint32)
            vp_cols = np.zeros((ncols, nwords), np.uint32)
            vm_cols = np.zeros((ncols, nwords), np.uint32)
            native.block_fill(a0, a1, pb0, pb1, vp_c, vm_c, hp, hm,
                              vp_cols, vm_cols)
            return vp_cols, vm_cols

        out = myers.fill_block(
            *self._device_slices(i0, i1, w0, w1),
            self._upload(vp, nwords, 0), self._upload(vm, nwords, 0),
            self._upload(None, ncols, 1), self._upload(None, ncols, 0),
        )
        return to_numpy_u32(out[4]), to_numpy_u32(out[5])
