"""Multi-host streaming alignment (BASELINE config #5).

Counterpart of ``astarpa_tpu/parallel/multihost.py`` on
``torch.distributed``.  Embarrassingly parallel over pairs: each process

1. reads its stripe of the input stream (``pairs[rank::world_size]``,
   deterministic, no coordination),
2. aligns its stripe on its own devices through :class:`BatchAligner`
   (which may split it further over a ``mesh``),
3. streams ``{cost},{cigar}`` lines to its own output shard,
4. merges the global counts with one all-reduce (:func:`_merge_counts`).

The all-reduce runs over gloo on CPU tensors whatever the aligner's device:
the counts are host counters, there is one all-reduce a run, and NCCL
refuses two ranks on one card.  A single process that never calls
:func:`init_distributed` is rank 0 of 1.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .runner import BatchAligner, BatchStats


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the process group at ``coordinator`` (``host:port``) as rank
    ``process_id`` of ``num_processes``; returns ``(rank, world_size)``.
    Without a coordinator nothing is joined and a process outside any
    group is ``(0, 1)``."""
    if coordinator is not None and not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    return _rank_and_size()


def _rank_and_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_stripe(num_items: int, process_index: int, process_count: int) -> np.ndarray:
    """Deterministic round-robin stripe of input indices for this host."""
    return np.arange(process_index, num_items, process_count)


@dataclass
class MultiHostResult:
    local_pairs: int
    global_pairs: int
    local_bp: int
    global_bp: int
    seconds: float
    stats: BatchStats


class MultiHostRunner:
    """Streams pair batches through each process's aligner."""

    def __init__(self, aligner: BatchAligner | None = None, batch_size: int = 4096):
        self.aligner = aligner if aligner is not None else BatchAligner()
        self.batch_size = batch_size

    def run(self, pairs, out_path: str | None = None, with_cigars: bool = False,
            process_index: int | None = None, process_count: int | None = None
            ) -> MultiHostResult:
        """Align this process's stripe of ``pairs`` (the process group's
        rank and size unless given), write its lines to ``out_path`` and
        merge the pair and base counts over the group.  With
        ``with_cigars`` the stripe streams through ``align_iter`` (batch k's
        traces drain while batch k+1 runs), else ``cost_with_stats`` a
        batch."""
        rank, size = _rank_and_size()
        pi = rank if process_index is None else process_index
        pc = size if process_count is None else process_count
        local = [pairs[i] for i in host_stripe(len(pairs), pi, pc)]

        t0 = time.perf_counter()
        stats = BatchStats()
        chunks = (local[lo:lo + self.batch_size]
                  for lo in range(0, len(local), self.batch_size))
        with open(out_path or os.devnull, "w") as out:
            if with_cigars:
                for results, cstats in self.aligner.align_iter(chunks):
                    for cost, cigar in results:
                        out.write(f"{cost},{cigar.to_string()}\n")
                    _acc(stats, cstats)
            else:
                for chunk in chunks:
                    costs, cstats = self.aligner.cost_with_stats(chunk)
                    for c in costs:
                        out.write(f"{c},\n")
                    _acc(stats, cstats)
        dt = time.perf_counter() - t0

        global_pairs, global_bp = _merge_counts(stats.pairs, stats.aligned_bp)
        return MultiHostResult(local_pairs=stats.pairs, global_pairs=global_pairs,
                               local_bp=stats.aligned_bp, global_bp=global_bp,
                               seconds=dt, stats=stats)


def _acc(stats: BatchStats, cstats: BatchStats) -> None:
    stats.pairs += cstats.pairs
    stats.buckets += cstats.buckets
    stats.band_retries += cstats.band_retries
    stats.cells_computed += cstats.cells_computed
    stats.aligned_bp += cstats.aligned_bp
    stats.direct_traces += cstats.direct_traces
    stats.kernel = cstats.kernel or stats.kernel


_LIMBS = 4  # 4 x 16-bit limbs cover counters up to 2^64


def _merge_counts(*vals: int) -> tuple[int, ...]:
    """Global sum of per-process counters: one all-reduce over the process
    group (gloo, CPU tensors), or the values themselves outside a group.

    Exact for 64-bit counters, whose sum an int64 cannot hold: each value is
    split into 16-bit limbs summed in int64 (limb sums stay far below 2^63
    for any group size), and the carries are resolved in Python integers.
    """
    limbs = torch.zeros((len(vals), _LIMBS), dtype=torch.int64)
    for c, v in enumerate(vals):
        v = int(v)
        if not 0 <= v < 1 << (16 * _LIMBS):
            raise ValueError(f"a count must be in [0, 2^64), got {v}")
        for k in range(_LIMBS):
            limbs[c, k] = (v >> (16 * k)) & 0xFFFF
    if _rank_and_size()[1] > 1:
        dist.all_reduce(limbs, op=dist.ReduceOp.SUM)
    return tuple(sum(int(limbs[c, k]) << (16 * k) for k in range(_LIMBS))
                 for c in range(len(vals)))
