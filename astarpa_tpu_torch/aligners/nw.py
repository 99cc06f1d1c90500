"""Full-rectangle bitpacked NW: exact edit distances of a batch, cost only.

Port of ``astarpa_tpu/aligners/nw.py``.  Pairs are padded to shared
``(max_n, max_words)`` shapes; padding is exact (pad rows read as code 3
and are never summed, pad columns are skipped).  The batch runs
:func:`..ops.nw_kernel.nw_cost` on the transposed planes: K11 on the card,
its plain version on the CPU.  The reference runs its jnp scan
(``ops/myers.nw_cost_batch``), which computes the same function.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..ops import bitpack, nw_kernel
from ..ops.words import to_tensor
from ..types import seq_to_codes


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def pack_batch(pairs: list[tuple[bytes, bytes]], pad_cols: int = 64, pad_words: int = 2):
    """Pack a batch of byte-string pairs into padded host arrays.

    Returns dict of numpy arrays: a0/a1 (B, max_n) and pb0/pb1 (B,
    max_words) uint32, n/m (B,) int32 — the reference's arrays.
    """
    B = len(pairs)
    ns = np.array([len(a) for a, _ in pairs], dtype=np.int32)
    ms = np.array([len(b) for _, b in pairs], dtype=np.int32)
    max_n = max(1, _round_up(int(ns.max(initial=0)), pad_cols))
    max_words = max(1, _round_up(bitpack.n_words(int(ms.max(initial=0))), pad_words))

    a0 = np.zeros((B, max_n), dtype=np.uint32)
    a1 = np.zeros((B, max_n), dtype=np.uint32)
    pb0 = np.zeros((B, max_words), dtype=np.uint32)
    pb1 = np.zeros((B, max_words), dtype=np.uint32)
    for idx, (a, b) in enumerate(pairs):
        ca0, ca1 = bitpack.pack_a(seq_to_codes(a))
        a0[idx, : len(a)] = ca0
        a1[idx, : len(a)] = ca1
        b0, b1 = bitpack.pack_b(seq_to_codes(b), num_words=max_words)
        pb0[idx] = b0
        pb1[idx] = b1
    return dict(a0=a0, a1=a1, pb0=pb0, pb1=pb1, n=ns, m=ms)


def nw_cost_batch(pairs: list[tuple[bytes, bytes]], device=None) -> np.ndarray:
    """Exact edit distances for a batch of pairs.  ``device`` ``None`` or
    ``"cuda"`` runs K11 on the card and raises without one; ``"cpu"`` runs
    its plain version."""
    dev = resolve_device(device)
    if not pairs:
        return np.zeros((0,), dtype=np.int32)
    batch = pack_batch(pairs)
    planes = [to_tensor(np.ascontiguousarray(batch[k].T), dev)
              for k in ("a0", "a1", "pb0", "pb1")]
    return nw_kernel.nw_cost(*planes, batch["n"], batch["m"]).cpu().numpy()


def nw_cost(a: bytes, b: bytes, device=None) -> int:
    """Exact edit distance of one pair."""
    return int(nw_cost_batch([(a, b)], device)[0])
