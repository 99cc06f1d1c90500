"""Device choice for the port (replaces the reference runner's JAX
backend checks, ``runner.py:492,549,967,1088,1645,1982``)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` picks the first CUDA device when one exists, else the CPU.
    An explicit CUDA device without a usable GPU raises: the port never
    drops to the CPU on its own."""
    if device is None:
        return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
