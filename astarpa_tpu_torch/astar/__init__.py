"""The A* alignment runtime (re-design of the `astarpa` crate, L3a).

Public surface mirrors `astarpa/src/lib.rs:56-149`:

- :func:`astarpa`: GCSH + DT, r=2, k=15, prune-by-start.
- :func:`astarpa_gcsh`: custom r/k/prune.
- :class:`AstarPa`: reusable aligner object `{dt, h, v}`.
- :func:`astar` / :func:`astar_dt`: the raw search loops.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import Cigar
from .search import astar, astar_dt
from .stats import AstarStats

__all__ = [
    "astar",
    "astar_dt",
    "AstarPa",
    "AstarStats",
    "astarpa",
    "astarpa_gcsh",
]


@dataclass
class AstarPa:
    """Reusable A* aligner (`astarpa/src/lib.rs:105-129`).

    ``dt``: search in diagonal-transition state space.
    ``h``: a heuristic factory with ``.build(a, b)``.
    ``v``: optional visualizer factory with ``.build(a, b)``.
    """

    dt: bool
    h: object
    v: object = None

    def align_with_stats(self, a: bytes, b: bytes):
        f = astar_dt if self.dt else astar
        return f(a, b, self.h, self.v)

    def align(self, a: bytes, b: bytes) -> tuple[int, Cigar]:
        return self.align_with_stats(a, b)[0]

    def cost(self, a: bytes, b: bytes) -> int:
        return self.align(a, b)[0]


def astarpa_gcsh(a: bytes, b: bytes, r: int, k: int, prune) -> tuple[int, Cigar]:
    """GCSH + DT with custom parameters (`astarpa/src/lib.rs:69-77`)."""
    from ..heuristic.csh import GCSH
    from ..heuristic.matches import MatchConfig
    from ..heuristic.prune import Prune, Pruning

    if isinstance(prune, str):
        prune = Prune(prune)
    h = GCSH(MatchConfig(k=k, r=r), Pruning(prune))
    return astar_dt(a, b, h)[0]


def astarpa(a: bytes, b: bytes) -> tuple[int, Cigar]:
    """Default A*PA settings (`astarpa/src/lib.rs:56-64`): GCSH, DT,
    inexact matches r=2, seed length k=15, prune by start."""
    from ..heuristic.prune import Prune

    return astarpa_gcsh(a, b, 2, 15, Prune.START)
