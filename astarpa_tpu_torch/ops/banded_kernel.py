"""Wrapper of the banded cost kernel (``csrc/banded_cost.cu``).

Counterpart of ``astarpa_tpu/ops/pallas_banded.py::banded_cost_tpu`` (with
``schedule=None``) and ``_banded_call`` in ``EMIT_COST`` mode: the same
contract as :func:`.banded.banded_cost_ref`.  A tensor on the CPU goes to
that plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .banded import banded_cost_ref, shift_at_array
from .words import to_tensor

#: Launches of the CUDA kernel in this process (reset by callers that need
#: to show a run went through the kernel).
LAUNCHES = 0


def route(device: torch.device) -> str:
    """Label of what :func:`banded_cost` runs for tensors on ``device``."""
    return "cuda-banded" if device.type == "cuda" else "torch-ref"


def banded_cost(a0, a1, pb0, pb1, n, m, band_words: int,
                diag: tuple | None = None) -> torch.Tensor:
    """Banded edit-distance upper bounds, (B,) int32 on the planes' device.

    a0/a1 (n_max, B), pb0/pb1 (S, B) int32 planes; n/m (B,) lengths (host
    numpy or tensors); ``band_words`` is clamped to S; ``diag`` as in
    :func:`.banded.shift_at_array`.
    """
    if a0.device.type == "cpu":
        return banded_cost_ref(a0, a1, pb0, pb1, n, m, band_words, diag)
    if a0.device.type != "cuda":
        raise ValueError(f"banded_cost: unsupported device {a0.device}")
    return _launch(a0, a1, pb0, pb1, n, m, band_words, diag)


def _launch(a0, a1, pb0, pb1, n, m, band_words, diag):
    global LAUNCHES
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = min(band_words, S)
    for name, x, shape in (("a0", a0, (n_max, B)), ("a1", a1, (n_max, B)),
                           ("pb0", pb0, (S, B)), ("pb1", pb1, (S, B))):
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"banded_cost: {name} must be a contiguous int32 {shape} tensor "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if SW < 1:
        raise ValueError(f"banded_cost: band_words must be >= 1, got {band_words}")
    n_t = _lengths(n, B, dev)
    m_t = _lengths(m, B, dev)
    shift = shift_at_array(n_max, S, SW, diag)
    if int(shift.sum()) > S - SW:
        raise ValueError("banded_cost: schedule slides past the last word")
    shift_t = to_tensor(shift, dev)
    ring_vp = torch.empty((SW, B), dtype=torch.int32, device=dev)
    ring_vm = torch.empty((SW, B), dtype=torch.int32, device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_banded_cost(
            a0.data_ptr(), a1.data_ptr(), pb0.data_ptr(), pb1.data_ptr(),
            n_t.data_ptr(), m_t.data_ptr(), shift_t.data_ptr(),
            ring_vp.data_ptr(), ring_vm.data_ptr(), out.data_ptr(),
            n_max, B, SW, stream,
        )
    if rc != 0:
        raise RuntimeError(f"banded_cost kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def _lengths(x, B: int, dev) -> torch.Tensor:
    """Host numpy lengths upload without blocking; tensors are converted."""
    if isinstance(x, np.ndarray):
        t = to_tensor(x.astype(np.int32), dev)
    else:
        t = x.to(device=dev, dtype=torch.int32).contiguous()
    if tuple(t.shape) != (B,):
        raise ValueError(f"banded_cost: lengths must have shape ({B},)")
    return t
