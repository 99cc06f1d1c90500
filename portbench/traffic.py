"""The benchmark's pair generator: the uniform error model, vectorized.

A pair is a uniform random ACGT sequence ``a`` of ``n`` bases and ``b``,
``a`` after ``ceil(e * n)`` edits, each uniformly a substitution (by a
uniform base, which may equal the old one), an insertion of a uniform base
or a deletion.  The edits are drawn at positions of ``a`` all at once and
applied in one pass, so a batch of 4096 x 10 kbp pairs takes well under a
second; the program's own generator applies them one after another in
Python.  Whatever the draws, ``b`` is at most ``ceil(e * n)`` edits from
``a``: the reference uses that bound for its band.

The same seed gives the same bytes, and every seed the same pairs in an
order of its own (:func:`make_batches`).  Nothing here imports the program.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def edits_for(n: int, e: float) -> int:
    """The number of edits applied to a pair of ``n`` bases at rate ``e``."""
    return int(math.ceil(e * n))


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a stream label."""
    return np.random.default_rng([seed % 2**64, *stream])


def uniform_batch(rng: np.random.Generator, count: int, n: int, e: float):
    """``count`` pairs ``(a, b)`` of bytes and the edit bound ``k``.

    Substitutions and deletions fall on positions ``0..n-1`` of ``a``;
    insertions go before a position ``0..n`` (``n`` appends).  Where two
    substitutions hit one position the later one wins; a deleted position
    keeps its insertions."""
    k = edits_for(n, e)
    a = ACGT[np.frombuffer(rng.bytes(count * n), dtype=np.uint8).reshape(count, n) & 3]
    kind = rng.integers(0, 3, size=(count, k), dtype=np.uint8)
    on_a = rng.integers(0, n, size=(count, k), dtype=np.int64)
    pos = rng.integers(0, n + 1, size=(count, k), dtype=np.int64)
    char = ACGT[rng.integers(0, 4, size=(count, k), dtype=np.uint8)]
    pair = np.broadcast_to(np.arange(count, dtype=np.int64)[:, None], (count, k))

    b0 = a.copy()
    sub = kind == 0
    b0[pair[sub], on_a[sub]] = char[sub]
    keep = np.ones((count, n), dtype=bool)
    dele = kind == 2
    keep[pair[dele], on_a[dele]] = False

    # b, pair after pair: at each slot s of a pair its insertions, then
    # a's base s if kept.  ``end`` is where each slot's output ends.
    ins = kind == 1
    slot = pair[ins] * (n + 1) + pos[ins]
    order = np.argsort(slot, kind="stable")
    slot, ins_char = slot[order], char[ins][order]
    per_slot = np.zeros((count, n + 1), dtype=np.int32)
    per_slot[:, :n] = keep
    np.add.at(per_slot.reshape(-1), slot, 1)
    end = np.cumsum(per_slot.reshape(-1), dtype=np.int64)
    out = np.empty(int(end[-1]), dtype=np.uint8)
    out[end.reshape(count, n + 1)[:, :n][keep] - 1] = b0[keep]
    # An insertion's rank among those of its slot, in draw order.
    rank = np.arange(len(slot)) - np.searchsorted(slot, slot, side="left")
    out[end[slot] - per_slot.reshape(-1)[slot] + rank] = ins_char
    bounds = np.concatenate(([0], end[n::n + 1])).tolist()

    a_bytes = [row.tobytes() for row in a]
    b_bytes = [out[lo:hi].tobytes() for lo, hi in zip(bounds[:-1], bounds[1:])]
    return list(zip(a_bytes, b_bytes)), k


#: Each batch is drawn as this many chunks of pairs, each from a stream of
#: its own, generated on a thread each (numpy releases the GIL): the bytes
#: do not depend on how many cores the host has.
CHUNKS = 8


def make_batches(seed: int, config: dict):
    """The batches a run hands over in turn, for ``seed``: a list of
    ``(pairs, edit_bound)``.

    Every seed gets the same pairs: distinct batch ``i`` is drawn from the
    configuration's ``pair_seeds[i]``, chunk ``c`` of it from stream
    ``(pair_seeds[i], 1, c)``.  The run's seed only puts each batch's pairs
    in another order (stream ``(seed, 3, i)``), so the work a run does is
    the same for every seed."""
    n, e, count = config["pair_bp"], config["error_rate"], config["batch_pairs"]
    step = -(-count // CHUNKS)
    jobs = [(i, c, min(step, count - c * step))
            for i, _ in enumerate(config["pair_seeds"]) for c in range(CHUNKS)
            if c * step < count]
    with ThreadPoolExecutor(min(len(jobs), os.cpu_count() or 1)) as ex:
        parts = list(ex.map(
            lambda j: uniform_batch(rng_for(config["pair_seeds"][j[0]], 1, j[1]), j[2], n, e),
            jobs))
    batches = []
    for i, _ in enumerate(config["pair_seeds"]):
        mine = [p for (bi, _, _), p in zip(jobs, parts) if bi == i]
        pairs = [pair for ps, _ in mine for pair in ps]
        order = rng_for(seed, 3, i).permutation(len(pairs))
        batches.append(([pairs[j] for j in order], mine[0][1]))
    return batches
