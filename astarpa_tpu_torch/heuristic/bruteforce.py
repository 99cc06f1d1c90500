"""Brute-force oracles and lockstep wrappers for differential testing.

Mirrors the reference's correctness devices (SURVEY.md §4):

- :class:`BruteForceContours`: O(#arrows) per query chain-score oracle
  (`pa-heuristic/src/contour/bruteforce.rs:10-146`), same interface as the
  production :class:`~astarpa_tpu_torch.heuristic.contours.Contours`.
- :class:`BruteForceGCSH`: recomputes h by scanning all matches
  (`pa-heuristic/src/heuristic/bruteforce_gcsh.rs:9-80`).
- :class:`EqualHeuristic`: runs two heuristics in lockstep and asserts
  equal h at every query (`pa-heuristic/src/heuristic/wrappers.rs:5-120`).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import Pos
from .contours import Arrow
from .distances import GapCost, HeuristicInstance
from .matches import MatchConfig, find_matches
from .prune import MatchPruner, Pruning
from .seeds import Seeds
from .stats import HeuristicStats

INF = (1 << 31) - 1


class BruteForceContours:
    """Chain scores by direct recursion over the arrow set."""

    def __init__(self, arrows_by_start=None):
        self.arrows: list[Arrow] = []
        self._memo: dict[Pos, int] = {}
        if arrows_by_start:
            self.build(arrows_by_start)

    def build(self, arrows_by_start) -> None:
        self.arrows = [a for _, group in arrows_by_start for a in group]
        self._memo = {}

    def _value_of_start(self, start: Pos) -> int:
        v = self._memo.get(start)
        if v is None:
            v = max(
                (a.score + self.score(a.end) for a in self.arrows if a.start == start),
                default=0,
            )
            self._memo[start] = v
        return v

    def score(self, q: Pos) -> int:
        return max(
            (
                self._value_of_start(a.start)
                for a in self.arrows
                if q.i <= a.start.i and q.j <= a.start.j
            ),
            default=0,
        )

    def score_with_hint(self, q: Pos, hint):
        return self.score(q), hint

    def num_layers(self) -> int:
        return self.score(Pos(-INF, -INF))


@dataclass
class BruteForceGCSH:
    """Factory (`bruteforce_gcsh.rs:9-28`); ``distance_function`` is a
    distance-heuristic factory (GapCost for GCSH-equality, NoCost for CSH)."""

    match_config: MatchConfig
    distance_function: object
    pruning: Pruning

    def build(self, a: bytes, b: bytes) -> "BruteForceGCSHI":
        return BruteForceGCSHI(a, b, self)

    name = "BruteForceGCSH"


class BruteForceGCSHI(HeuristicInstance):
    def __init__(self, a: bytes, b: bytes, params: BruteForceGCSH):
        self.params = params
        ms = find_matches(a, b, params.match_config, transform_filter=False)
        self.seeds: Seeds = ms.seeds
        self.target = Pos(len(a), len(b))
        self.dist = params.distance_function.build(a, b)
        self.pruner = MatchPruner(
            params.pruning,
            # Consistency with GCSH (`bruteforce_gcsh.rs:74-79`).
            getattr(params.distance_function, "name", "") == "Gap",
            ms.matches,
            self.seeds,
        )
        self.hstats = HeuristicStats(
            num_seeds=len(self.seeds.seeds),
            num_matches=len(ms.matches),
            num_filtered_matches=len(ms.matches),
        )
        self._build()
        self.hstats.h0 = self.h(Pos(0, 0))

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        return max(
            self.dist.distance(from_pos, to_pos),
            self.seeds.potential_distance(from_pos, to_pos),
        )

    def _build(self) -> None:
        """h values at match starts, filled right-to-left
        (`bruteforce_gcsh.rs:97-120`)."""
        self.h_at_matches: dict[Pos, int] = {self.target: 0}
        ms = [m for m in self.pruner if m.is_active()]
        ms.sort(key=lambda m: (m.start.i, m.start.j))
        for m in reversed(ms):
            update_val = m.match_cost + self.h(m.end)
            query_val = self.h(m.start)
            if update_val < query_val:
                self.h_at_matches[m.start] = update_val

    def h(self, pos: Pos) -> int:
        return min(
            self.distance(pos, parent) + val
            for parent, val in self.h_at_matches.items()
            if pos.i <= parent.i and pos.j <= parent.j
        )

    def h_with_hint(self, pos: Pos, hint):
        return self.h(pos), hint

    def root_potential(self) -> int:
        return int(self.seeds.potential[0])

    def is_seed_start_or_end(self, pos: Pos) -> bool:
        return self.seeds.is_seed_start_or_end(pos)

    def prune(self, pos: Pos, hint):
        if not self.params.pruning.is_enabled():
            return 0, 0
        p_start, p_end = self.pruner.prune(self.seeds, pos)
        if p_start + p_end > 0:
            self.hstats.num_pruned += p_start + p_end
            self._build()
        return 0, 0

    def stats(self) -> HeuristicStats:
        self.hstats.h0_end = self.h(Pos(0, 0))
        return self.hstats


@dataclass
class EqualHeuristic:
    """Lockstep equality wrapper; h1 = slow oracle, h2 = fast structure."""

    h1: object
    h2: object

    def build(self, a: bytes, b: bytes) -> "EqualHeuristicI":
        return EqualHeuristicI(self.h1.build(a, b), self.h2.build(a, b))

    name = "Equal"


class EqualHeuristicI(HeuristicInstance):
    def __init__(self, h1, h2):
        self.h1 = h1
        self.h2 = h2

    def h(self, pos: Pos) -> int:
        v1, v2 = self.h1.h(pos), self.h2.h(pos)
        assert v1 == v2, f"h differs at {pos}: oracle {v1} vs fast {v2}"
        return v2

    def h_with_hint(self, pos: Pos, hint):
        if hint is None:
            hint = (self.h1.default_hint(), self.h2.default_hint())
        v1, hint1 = self.h1.h_with_hint(pos, hint[0])
        v2, hint2 = self.h2.h_with_hint(pos, hint[1])
        assert v1 == v2, f"h differs at {pos}: oracle {v1} vs fast {v2}"
        return v2, (hint1, hint2)

    def default_hint(self):
        return (self.h1.default_hint(), self.h2.default_hint())

    def root_potential(self) -> int:
        return self.h2.root_potential()

    def is_seed_start_or_end(self, pos: Pos) -> bool:
        s1 = self.h1.is_seed_start_or_end(pos)
        s2 = self.h2.is_seed_start_or_end(pos)
        assert s1 == s2
        return s2

    def prune(self, pos: Pos, hint):
        if hint is None:
            hint = (self.h1.default_hint(), self.h2.default_hint())
        self.h1.prune(pos, hint[0])
        self.h2.prune(pos, hint[1])
        return 0, self.order_zero()

    def explore(self, pos: Pos) -> None:
        self.h1.explore(pos)
        self.h2.explore(pos)

    def stats(self) -> HeuristicStats:
        return self.h2.stats() if callable(getattr(self.h2, "stats", None)) else HeuristicStats()
