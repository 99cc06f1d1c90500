"""A* search statistics (mirror of `astarpa/src/stats.rs:11-185`)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Timing:
    """Phase timers in seconds (`stats.rs:12-22`)."""

    total: float = 0.0
    precomp: float = 0.0
    astar: float = 0.0
    traceback: float = 0.0
    reordering: float = 0.0


from ..heuristic.stats import HeuristicStats


@dataclass
class AstarStats:
    """End-to-end search counters (`stats.rs:25-47`)."""

    len_a: int = 0
    len_b: int = 0
    distance: int = 0
    expanded: int = 0
    explored: int = 0
    extended: int = 0
    reordered: int = 0
    pq_shifts: int = 0
    hashmap_size: int = 0
    timing: Timing = field(default_factory=Timing)
    h: HeuristicStats = field(default_factory=HeuristicStats)

    @staticmethod
    def init(a: bytes, b: bytes) -> "AstarStats":
        return AstarStats(len_a=len(a), len_b=len(b))

    def pretty(self) -> str:
        rows = [
            ("len_a", self.len_a),
            ("len_b", self.len_b),
            ("distance", self.distance),
            ("expanded", self.expanded),
            ("explored", self.explored),
            ("extended", self.extended),
            ("reordered", self.reordered),
            ("pq_shifts", self.pq_shifts),
            ("pruned", self.h.num_pruned),
            ("t_total_ms", round(self.timing.total * 1e3, 3)),
            ("t_precomp_ms", round(self.timing.precomp * 1e3, 3)),
            ("t_astar_ms", round(self.timing.astar * 1e3, 3)),
            ("t_traceback_ms", round(self.timing.traceback * 1e3, 3)),
        ]
        w = max(len(k) for k, _ in rows)
        return "\n".join(f"{k:<{w}}  {v}" for k, v in rows)


class PhaseTimer:
    """Tiny helper for subtraction-style phase accounting
    (`astar.rs:243-250`)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        t = time.perf_counter()
        dt = t - self.t0
        self.t0 = t
        return dt
