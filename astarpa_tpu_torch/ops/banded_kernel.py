"""Wrappers of the banded kernels (``csrc/banded.cu``).

Counterparts of ``astarpa_tpu/ops/pallas_banded.py::banded_cost_tpu`` and
``banded_ck_tpu`` (``_banded_call``), one wrapper per kernel:

- :func:`banded_cost` — K1, shared schedule, costs;
- :func:`banded_ck` — K2, shared schedule, costs and checkpoints;
- :func:`banded_cost_pp` — K4, per-pair schedules, costs;
- :func:`banded_ck_pp` — K4, per-pair schedules, costs and checkpoints.

Each has the contract of its plain version in :mod:`.banded`.  A tensor on
the CPU goes to that plain version; a CUDA tensor launches the kernel or
raises.  Per-pair schedules are host numpy (n_max, B) 0/1 arrays, checked
to shift only at multiples of their quantum on both routes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import banded
from .words import to_tensor

#: Launches of each CUDA kernel in this process, by wrapper name (callers
#: that need to show a run went through a kernel reset them first).
LAUNCHES = {"banded_cost": 0, "banded_ck": 0, "banded_cost_pp": 0,
            "banded_ck_pp": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_LABELS = {"banded_cost": "cuda-banded", "banded_ck": "cuda-banded-ck",
           "banded_cost_pp": "cuda-banded-pp", "banded_ck_pp": "cuda-banded-ck-pp"}


def route(device: torch.device, kernel: str = "banded_cost") -> str:
    """Label of what ``kernel``'s wrapper runs for tensors on ``device``."""
    return _LABELS[kernel] if device.type == "cuda" else "torch-ref"


def banded_cost(a0, a1, pb0, pb1, n, m, band_words: int,
                diag: tuple | None = None) -> torch.Tensor:
    """Banded edit-distance upper bounds, (B,) int32 on the planes' device.

    a0/a1 (n_max, B), pb0/pb1 (S, B) int32 planes; n/m (B,) lengths (host
    numpy or tensors); ``band_words`` is clamped to S; ``diag`` as in
    :func:`.banded.shift_at_array`.
    """
    if _plain(a0):
        return banded.banded_cost_ref(a0, a1, pb0, pb1, n, m, band_words, diag)
    return _launch("banded_cost", a0, a1, pb0, pb1, n, m, band_words, diag=diag)


def banded_ck(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
              diag: tuple | None = None):
    """Costs plus checkpoints every ``min(col_block, n_max)`` columns on the
    shared schedule: ``(costs, ck_vp, ck_vm, ck_tv)`` as
    :func:`.banded.banded_ck_ref`."""
    if _plain(a0):
        return banded.banded_ck_ref(a0, a1, pb0, pb1, n, m, band_words,
                                    col_block, diag)
    return _launch("banded_ck", a0, a1, pb0, pb1, n, m, band_words, diag=diag,
                   col_block=col_block)


def banded_cost_pp(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                   quantum: int = banded.SCHEDULE_Q) -> torch.Tensor:
    """Upper bounds with per-pair schedules, as
    :func:`.banded.banded_cost_pp_ref`."""
    if _plain(a0):
        return banded.banded_cost_pp_ref(a0, a1, pb0, pb1, n, m, schedule,
                                         band_words, quantum)
    return _launch("banded_cost_pp", a0, a1, pb0, pb1, n, m, band_words,
                   schedule=schedule, quantum=quantum)


def banded_ck_pp(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                 col_block: int, quantum: int = banded.SCHEDULE_Q):
    """Per-pair costs plus checkpoints, as :func:`.banded.banded_ck_pp_ref`
    (the interval rounded to whole quantum groups)."""
    if _plain(a0):
        return banded.banded_ck_pp_ref(a0, a1, pb0, pb1, n, m, schedule,
                                       band_words, col_block, quantum)
    return _launch("banded_ck_pp", a0, a1, pb0, pb1, n, m, band_words,
                   schedule=schedule, quantum=quantum, col_block=col_block)


def _plain(a0) -> bool:
    if a0.device.type == "cpu":
        return True
    if a0.device.type != "cuda":
        raise ValueError(f"banded kernels: unsupported device {a0.device}")
    return False


def _launch(kernel, a0, a1, pb0, pb1, n, m, band_words, *, diag=None,
            schedule=None, quantum=1, col_block=None):
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
                f"{kernel}: {name} must be a contiguous int32 {shape} tensor "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if SW < 1:
        raise ValueError(f"{kernel}: band_words must be >= 1, got {band_words}")
    n_t = _lengths(n, B, dev)
    m_t = _lengths(m, B, dev)
    per_pair = schedule is not None
    if per_pair:
        sched = to_tensor(banded.check_schedule(schedule, n_max, B, quantum), dev)
    else:
        shift = banded.shift_at_array(n_max, S, SW, diag)
        if int(shift.sum()) > S - SW:
            raise ValueError(f"{kernel}: schedule slides past the last word")
        sched = to_tensor(shift, dev)
    ring_vp = torch.empty((SW, B), dtype=torch.int32, device=dev)
    ring_vm = torch.empty((SW, B), dtype=torch.int32, device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    head = [a0, a1, pb0, pb1, n_t, m_t, sched, ring_vp, ring_vm, out]
    ck = ()
    if col_block is not None:
        CB = banded.ck_col_block(col_block, n_max, quantum if per_pair else None)
        n_ck = -(-n_max // CB)
        ck = (torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
              torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
              torch.empty((n_ck, B), dtype=torch.int32, device=dev))
    ints = [n_max, B, S, SW] + ([quantum] if per_pair else []) \
        + ([CB] if ck else [])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"astarpa_{kernel}")(
            *(t.data_ptr() for t in head + list(ck)), *ints, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    LAUNCHES[kernel] += 1
    return (out,) + ck if ck else out


def _lengths(x, B: int, dev) -> torch.Tensor:
    """Host numpy lengths upload without blocking; tensors are converted."""
    if isinstance(x, np.ndarray):
        t = to_tensor(x.astype(np.int32), dev)
    else:
        t = x.to(device=dev, dtype=torch.int32).contiguous()
    if tuple(t.shape) != (B,):
        raise ValueError(f"banded kernels: lengths must have shape ({B},)")
    return t
