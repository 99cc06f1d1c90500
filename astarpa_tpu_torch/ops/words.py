"""Word-level bit operations on int32 views of uint32 bit planes.

Port-wide convention: every bit plane (a-char sign masks, negated b
profiles, Myers vp/vm words) is an ``int32`` tensor holding the uint32 bit
pattern.  ``torch.uint32`` cannot be used: on the CPU it raises
``NotImplementedError`` for add, shift and ``~``, and there is no
``torch.bitwise_count``.  Two's-complement int32 gives the same bits for
``& | ^ ~ +`` and ``<<``; only the right shift differs (arithmetic on
int32), so every carry extraction masks with ``& 1`` and every logical
right shift masks off the sign-extended bits (:func:`srl`).  The CUDA
kernels reinterpret the same buffers as ``uint32_t*``.

Counterparts: ``astarpa_tpu/ops/pallas_banded.py::_myers_word`` and
``astarpa_tpu/ops/banded.py::_popcount`` / ``_value_to_window``.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitpack import W

#: uint32 0xFFFFFFFF as an int32.
ONES = -1


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 words by ``0 < k < 32``."""
    return (x >> k) & ((1 << (W - k)) - 1)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR per-word popcount of int32-held uint32 words (int32 result)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    # The top byte of the wrapped product is the count (<= 32, so the
    # arithmetic shift brings in no sign bits).
    return (x * 0x01010101) >> 24


def myers_word(eqw, vpw, vmw, hp, hm):
    """One Myers word step; ``hp``/``hm`` are 0/1 carries entering at the
    word's top row.  Returns ``(vp', vm', hp_out, hm_out)``."""
    vx = eqw | vmw
    eq2 = eqw | hm
    hx = (((eq2 & vpw) + vpw) ^ vpw) | eq2
    hpo = vmw | ~(hx | vpw)
    hmo = vpw & hx
    hp_next = (hpo >> (W - 1)) & 1
    hm_next = (hmo >> (W - 1)) & 1
    hpo = (hpo << 1) | hp
    hmo = (hmo << 1) | hm
    return hmo | ~(vx | hpo), hpo & vx, hp_next, hm_next


def prefix_mask(full: torch.Tensor) -> torch.Tensor:
    """Mask of the low ``full`` bits, ``full`` in ``[0, W]`` (int32 view).
    ``full == W`` takes the all-ones branch: ``1 << 32`` is undefined."""
    low = (1 << full.clamp(max=W - 1)) - 1  # 1 << 31 wraps to INT_MIN; -1 wraps back
    return torch.where(full >= W, torch.full_like(full, ONES), low)


def value_to_window(vp, vm, rows):
    """Sum of v diffs of the first ``rows`` rows of the window, per pair.

    vp/vm: (SW, B) int32 views; rows: (B,) int32 (any sign: clamped per
    word to ``[0, W]``)."""
    SW = vp.shape[0]
    base = torch.arange(SW, dtype=torch.int32, device=vp.device)[:, None] * W
    mask = prefix_mask((rows[None, :] - base).clamp(0, W))
    return (popcount(vp & mask) - popcount(vm & mask)).sum(0, dtype=torch.int32)


def to_tensor(x: np.ndarray, device) -> torch.Tensor:
    """numpy array -> tensor on ``device``, uint32 as int32 with the bits
    kept.  A CUDA upload goes through pinned memory without blocking the
    host, so it queues behind the kernels in flight instead of waiting
    for them."""
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:  # torch.from_numpy needs a writable buffer
        x = x.copy()
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    t = torch.from_numpy(x)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def lengths(x, B: int, device) -> torch.Tensor:
    """(B,) int32 lengths on ``device``: host numpy uploads without
    blocking (:func:`to_tensor`), a tensor is converted."""
    if isinstance(x, np.ndarray):
        t = to_tensor(x.astype(np.int32), device)
    else:
        t = torch.as_tensor(x).to(device=device, dtype=torch.int32).contiguous()
    if tuple(t.shape) != (B,):
        raise ValueError(f"lengths must have shape ({B},), got {tuple(t.shape)}")
    return t


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array with the same bits."""
    return x.detach().cpu().contiguous().numpy().view(np.uint32)


def planes_from_numpy(a0, a1, pb0, pb1, n, m, device):
    """The JAX package's packed state (numpy/uint32 planes, int32 lengths)
    -> the port's int32-view tensors on ``device``.  ``n``/``m`` stay host
    numpy int32, as the runner keeps them."""
    planes = tuple(to_tensor(np.asarray(x), device) for x in (a0, a1, pb0, pb1))
    return planes + (np.asarray(n, np.int32), np.asarray(m, np.int32))


def planes_to_numpy(a0, a1, pb0, pb1, n, m):
    """Inverse of :func:`planes_from_numpy`: uint32 numpy planes."""
    planes = tuple(to_numpy_u32(x) for x in (a0, a1, pb0, pb1))
    return planes + (np.asarray(n, np.int32), np.asarray(m, np.int32))
