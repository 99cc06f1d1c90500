"""Device choice for the port (replaces the reference runner's JAX
backend checks, ``runner.py:492,549,967,1088,1645,1982``)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` and ``"cuda"`` mean the card: the current CUDA device, and
    a ``RuntimeError`` without a usable one.  Only ``"cpu"`` runs on the
    CPU (the kernels' plain versions): the port never drops to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
