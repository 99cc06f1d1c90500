"""ChaCha8-seeded random streams (the reference corpora's RNG family).

The port's own copy of ``astarpa_tpu/chacha.py`` (numpy only, kept
identical).

The reference's datasets come from the external `pa-generate` crate, which
draws from `rand_chacha::ChaCha8Rng` (`pa-bin` Cargo.lock: pa-generate ->
rand_chacha 0.9).  That crate is a git-only dependency whose source is not
part of the reference checkout, so its exact *sampling call sequence*
cannot be replicated here; what CAN be replicated bit-exactly is the RNG
itself.  This module implements:

- the ChaCha block function (vectorized over blocks in NumPy), verified
  against the RFC 8439 quarter-round and 20-round block test vectors —
  the 8-round variant is the same core with ROUNDS=8;
- `rand_chacha`'s stream layout: the DJB variant with a 64-bit block
  counter in words 12-13 and a 64-bit stream id in words 14-15, u32
  output words in block-sequential order;
- `rand_core`'s `seed_from_u64` seed expansion (PCG32 over the 32 seed
  bytes), so `ChaCha8Rng.seed_from_u64(s)` yields the same word stream
  as Rust's `ChaCha8Rng::seed_from_u64(s)`;
- a Lemire widening-multiply uniform integer sampler (documented as OUR
  sampling convention — not guaranteed identical to rand 0.9's).

`generate.py` uses this as its optional `rng="chacha8"` backend: corpora
are then reproducible cross-platform from (seed, stream) alone, with no
dependency on NumPy's bit-generator streams.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_MASK32 = np.uint32(0xFFFFFFFF)
# "expand 32-byte k"
_CONSTANTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                      dtype=np.uint64)


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    return ((x << _U32(k)) | (x >> _U32(32 - k))).astype(_U32)


def _qr(x: np.ndarray, a: int, b: int, c: int, d: int) -> None:
    """One ChaCha quarter round on rows of a (16, nb) uint32 state."""
    x[a] += x[b]
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] += x[d]
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] += x[b]
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] += x[d]
    x[b] = _rotl(x[b] ^ x[c], 7)


def chacha_core(init: np.ndarray, rounds: int) -> np.ndarray:
    """Run the ChaCha core on a (16, nb) uint32 initial-state array;
    returns the (16, nb) output words (state + initial, per RFC 8439)."""
    assert rounds % 2 == 0
    x = init.astype(_U32).copy()
    with np.errstate(over="ignore"):
        for _ in range(rounds // 2):
            # Column round.
            _qr(x, 0, 4, 8, 12)
            _qr(x, 1, 5, 9, 13)
            _qr(x, 2, 6, 10, 14)
            _qr(x, 3, 7, 11, 15)
            # Diagonal round.
            _qr(x, 0, 5, 10, 15)
            _qr(x, 1, 6, 11, 12)
            _qr(x, 2, 7, 8, 13)
            _qr(x, 3, 4, 9, 14)
        x += init.astype(_U32)
    return x


def seed_from_u64(seed: int) -> bytes:
    """rand_core's `SeedableRng::seed_from_u64`: expand a u64 into 32 seed
    bytes with PCG32 (one 32-bit output per 4-byte chunk)."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    state = seed & ((1 << 64) - 1)
    out = bytearray()
    for _ in range(8):
        state = (state * MUL + INC) & ((1 << 64) - 1)
        xorshifted = (((state >> 18) ^ state) >> 27) & 0xFFFFFFFF
        rot = state >> 59
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & 0xFFFFFFFF
        out += int(x).to_bytes(4, "little")
    return bytes(out)


class ChaCha8Rng:
    """ChaCha with 8 rounds in `rand_chacha`'s DJB layout (64-bit block
    counter, 64-bit stream).  Emits u32 words in block-sequential order."""

    ROUNDS = 8
    _CHUNK_BLOCKS = 256  # blocks generated per refill (16 KiB of stream)

    def __init__(self, key32: bytes, stream: int = 0):
        assert len(key32) == 32
        self._key = np.frombuffer(key32, dtype="<u4").astype(np.uint64)
        self._stream = stream & ((1 << 64) - 1)
        self._counter = 0
        self._buf = np.zeros(0, dtype=_U32)
        self._pos = 0

    @classmethod
    def seed_from_u64(cls, seed: int, stream: int = 0) -> "ChaCha8Rng":
        return cls(seed_from_u64(seed), stream=stream)

    def _refill(self) -> None:
        nb = self._CHUNK_BLOCKS
        ctr = self._counter + np.arange(nb, dtype=np.uint64)
        init = np.empty((16, nb), dtype=_U32)
        init[0:4] = _CONSTANTS.astype(_U32)[:, None]
        init[4:12] = self._key.astype(_U32)[:, None]
        init[12] = (ctr & 0xFFFFFFFF).astype(_U32)
        init[13] = (ctr >> np.uint64(32)).astype(_U32)
        init[14] = _U32(self._stream & 0xFFFFFFFF)
        init[15] = _U32(self._stream >> 32)
        out = chacha_core(init, self.ROUNDS)
        self._buf = out.T.reshape(-1)  # block-sequential words
        self._pos = 0
        self._counter += nb

    def words(self, count: int) -> np.ndarray:
        """The next `count` u32 words of the stream."""
        parts = []
        need = count
        while need:
            if self._pos >= len(self._buf):
                self._refill()
            take = min(need, len(self._buf) - self._pos)
            parts.append(self._buf[self._pos : self._pos + take])
            self._pos += take
            need -= take
        return np.concatenate(parts) if len(parts) != 1 else parts[0]

    def next_u32(self) -> int:
        return int(self.words(1)[0])

    def next_u64(self) -> int:
        w = self.words(2)
        return int(w[0]) | (int(w[1]) << 32)

    # ---- uniform sampling (OUR convention: Lemire widening multiply with
    # rejection — unbiased, but not claimed identical to rand 0.9's) ----

    def integers(self, low: int, high: int | None = None, size=None):
        """Uniform ints in [low, high) — the `np.random.Generator.integers`
        subset the generators use."""
        if high is None:
            low, high = 0, low
        n = high - low
        assert 0 < n <= 1 << 32
        if size is None:
            return low + self._below_scalar(n)
        cnt = int(np.prod(size))
        out = np.empty(cnt, dtype=np.int64)
        filled = 0
        # Reject low halves < t to remove modulo bias.  NB: this must be
        # 2^32 mod n computed in *unbounded* Python ints — the C idiom
        # `(-n) % n` relies on u32 wraparound and is identically 0 here.
        t = (1 << 32) % n
        while filled < cnt:
            x = self.words(cnt - filled).astype(np.uint64)
            m = x * np.uint64(n)
            keep = (m & np.uint64(0xFFFFFFFF)) >= np.uint64(t)
            got = (m[keep] >> np.uint64(32)).astype(np.int64)
            out[filled : filled + len(got)] = got
            filled += len(got)
        return (low + out).reshape(size)

    def _below_scalar(self, n: int) -> int:
        t = (1 << 32) % n  # 2^32 mod n (unbounded ints; see integers())
        while True:
            m = self.next_u32() * n
            if (m & 0xFFFFFFFF) >= t:
                return m >> 32
