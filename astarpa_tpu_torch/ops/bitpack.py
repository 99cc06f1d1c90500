"""Bit-profile construction for the Myers bitpacked DP (W = 32).

The port's own copy of ``astarpa_tpu/ops/bitpack.py`` (numpy only, kept
identical).  A re-design of `pa-bitpacking/src/profile.rs`:

- The reference packs 64 rows per machine word (`W=64`, `profile.rs:96-157`).
  TPU VPU lanes are 32-bit, so this framework uses ``W = 32`` rows per lane
  (the algorithm is width-generic, cf. the reference's `small_blocks` W=u8
  feature, `pa-bitpacking/src/lib.rs:40-45`).
- `BitProfile` equality trick (`profile.rs:141-144`): store chars of ``a``
  as two sign-extended bit-planes and chars of ``b`` negated and bit-packed;
  then ``eq = (a0 ^ b0) & (a1 ^ b1)`` gives a 32-row match mask in 2 ops.

Padding: rows past ``len(b)`` are packed as a sentinel that matches nothing
(both negated planes complemented relative to every ``a`` char is not
possible with 2 bits, so instead the padded rows read as char 3; this is
harmless: the block drivers never *read* values at rows > len(b), and DP
values at row j only depend on rows <= j, so garbage below the band can
never corrupt in-band values).
"""

from __future__ import annotations

import numpy as np

#: Rows per lane-word. The reference uses 64 (u64); TPU lanes are 32-bit.
W = 32

#: uint32 with all bits set (V::one() positive plane).
ONES = np.uint32(0xFFFFFFFF)


def n_words(m: int) -> int:
    return (m + W - 1) // W


def pack_a(a_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Explode ``a``'s 2-bit codes into sign-extended uint32 bit-planes.

    Returns ``(a0, a1)`` of shape ``(n,)``: ``a0[i]`` is all-ones iff bit 0
    of the code is set, likewise ``a1`` for bit 1
    (cf. `profile.rs:112-123`).
    """
    codes = np.asarray(a_codes, dtype=np.uint32)
    a0 = (np.uint32(0) - (codes & 1)).astype(np.uint32)
    a1 = (np.uint32(0) - ((codes >> 1) & 1)).astype(np.uint32)
    return a0, a1


def pack_b(b_codes: np.ndarray, num_words: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Pack ``b``'s 2-bit codes, negated, 32 chars per uint32 word.

    Returns ``(pb0, pb1)`` of shape ``(num_words,)`` where bit ``j % 32`` of
    word ``j // 32`` holds the *complement* of bit 0 / bit 1 of code ``j``
    (cf. `profile.rs:124-132`).  Padded rows read as code 3.
    """
    codes = np.asarray(b_codes, dtype=np.uint32)
    m = len(codes)
    nw = n_words(m) if num_words is None else num_words
    padded = np.full(nw * W, 3, dtype=np.uint32)
    padded[:m] = codes
    bits0 = ((padded & 1) ^ 1).astype(np.uint32)
    bits1 = (((padded >> 1) & 1) ^ 1).astype(np.uint32)
    shifts = np.arange(W, dtype=np.uint32)
    pb0 = (bits0.reshape(nw, W) << shifts).sum(axis=1, dtype=np.uint32)
    pb1 = (bits1.reshape(nw, W) << shifts).sum(axis=1, dtype=np.uint32)
    return pb0, pb1


def eq_mask(a0: int, a1: int, pb0: np.ndarray, pb1: np.ndarray) -> np.ndarray:
    """32-row match mask: bit j set iff a == b_j (`profile.rs:141-144`)."""
    return (a0 ^ pb0) & (a1 ^ pb1)


def popcount32(x: np.ndarray) -> np.ndarray:
    """Per-element popcount of uint32 (NumPy host-side)."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x - ((x >> 1) & np.uint32(0x55555555))
        x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
        x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
        return ((x * np.uint32(0x01010101)) >> 24).astype(np.int32)


def v_value(vp: np.ndarray, vm: np.ndarray) -> np.ndarray:
    """Word value: popcount(p) - popcount(m) (`encoding.rs:20-22`)."""
    return popcount32(vp) - popcount32(vm)


def v_value_of_prefix(vp: int, vm: int, j: int) -> int:
    """Value of the first ``j`` bits, 0 <= j < W (`encoding.rs:26-30`)."""
    assert 0 <= j < W
    mask = np.uint32((1 << j) - 1)
    return int(popcount32(np.uint32(vp) & mask)) - int(popcount32(np.uint32(vm) & mask))


def v_value_of_suffix(vp: int, vm: int, j: int) -> int:
    """Value of the last ``j`` bits, 0 < j <= W (`encoding.rs:34-38`)."""
    assert 0 < j <= W
    mask = np.uint32(((1 << j) - 1) << (W - j))
    return int(popcount32(np.uint32(vp) & mask)) - int(popcount32(np.uint32(vm) & mask))
