"""Seed heuristic (SH): h(pos) = potential(pos.i) - score(pos.i).

Mirror of `pa-heuristic/src/heuristic/sh.rs` and
`pa-heuristic/src/contour/sh_contours.rs`: SH ignores ``j`` entirely, so its
contours are one-dimensional — ``layer_starts[v]`` is the largest column
where chain score ``v`` is still reachable, and pruning a seed's last match
of some length removes the corresponding layer(s).  The queue shift order is
the column index ``i``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import Pos
from ..utils.split_vec import SplitVec
from .distances import HeuristicInstance
from .matches import Match, MatchConfig, find_matches
from .prune import MatchPruner, Pruning
from .seeds import Seeds
from .stats import HeuristicStats


@dataclass(frozen=True)
class ShArrow:
    """1-D arrow: f(start) >= f(end) + score (`sh_contours.rs:7-12`)."""

    start: int
    end: int
    score: int


def _match_to_arrow(m: Match) -> ShArrow:
    return ShArrow(m.start.i, m.end.i, m.score())


class ShContours:
    """Layered 1-D contours (`sh_contours.rs:16-148`).

    ``layer_starts`` is non-increasing; ``score(i)`` is the largest layer
    whose start is >= i.  ``num_arrows_per_length[l][seed]`` counts active
    arrows so a prune can detect when a seed's last arrow of a given score
    dies and remove the layer.
    """

    def __init__(self, seeds: Seeds, arrows, max_len: int):
        layer_starts = SplitVec()
        layer_starts.push(seeds.n)  # layer 0 starts at the end of a
        for seed in reversed(seeds.seeds):
            seed_score = seed.seed_potential - seed.seed_cost
            for _ in range(seed_score):
                layer_starts.push(seed.start)
        self.layer_starts = layer_starts

        self.num_arrows_per_length = [
            [0] * len(seeds.seeds) for _ in range(max_len + 1)
        ]
        for a in arrows:
            seed_idx = int(seeds.seed_at_arr[a.start])
            assert seed_idx >= 0
            self.num_arrows_per_length[a.score][seed_idx] += 1

    def score(self, i: int) -> int:
        """Largest layer v with layer_starts[v] >= i (`sh_contours.rs:63-75`)."""
        ls = self.layer_starts
        lo, hi = 0, len(ls)
        # Invariant: ls[lo] >= i (layer 0 always qualifies for i <= n).
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if ls[mid] >= i:
                lo = mid
            else:
                hi = mid
        return lo

    def score_with_hint(self, i: int, hint: int) -> tuple[int, int]:
        """Linear probe around the hint, else binary search
        (`sh_contours.rs:79-116`).  The hint counts layers *before* the
        position (stable under pruning, which mostly removes layers after).
        """
        ls = self.layer_starts
        n_layers = len(ls)
        layer = n_layers - max(hint, 1)
        if layer < 0:
            layer = 0
        SEARCH_RANGE = 5
        found = -1
        if ls[layer] >= i:
            for l in range(layer + 1, min(layer + 1 + SEARCH_RANGE, n_layers)):
                if ls[l] < i:
                    found = l - 1
                    break
        else:
            for l in range(layer - 1, max(layer - SEARCH_RANGE, 0) - 1, -1):
                if ls[l] >= i:
                    found = l
                    break
        if found < 0:
            found = self.score(i)
        return found, n_layers - found

    def prune_with_hint(self, seeds: Seeds, a: ShArrow, hint: int) -> int:
        """Remove one arrow; drop layers when a seed loses its last arrow of
        a score class (`sh_contours.rs:118-148`).  Returns #layers removed.
        """
        seed_idx = int(seeds.seed_at_arr[a.start])
        counts = self.num_arrows_per_length
        assert counts[a.score][seed_idx] > 0, "match count is already 0"
        counts[a.score][seed_idx] -= 1
        if counts[a.score][seed_idx] > 0:
            return 0
        for l in range(a.score + 1, len(counts)):
            if counts[l][seed_idx] > 0:
                return 0
        removed = 0
        score = self.score_with_hint(a.start, hint)[0]
        for l in range(a.score, 0, -1):
            if counts[l][seed_idx] > 0:
                break
            assert self.layer_starts[score] == a.start
            self.layer_starts.remove(score)
            removed += 1
            score -= 1
        return removed


@dataclass
class SH:
    """SH config/factory (`sh.rs:8-31`)."""

    match_config: MatchConfig
    pruning: Pruning

    def build(self, a: bytes, b: bytes) -> "SHI":
        return SHI(a, b, self)

    name = "SH"


class SHI(HeuristicInstance):
    """Instantiated SH (`sh.rs:34-180`)."""

    def __init__(self, a: bytes, b: bytes, params: SH):
        self.params = params
        ms = find_matches(a, b, params.match_config, transform_filter=False)
        self.seeds: Seeds = ms.seeds
        self.contours = ShContours(
            self.seeds, map(_match_to_arrow, reversed(ms.matches)), params.match_config.r
        )
        self.pruner = MatchPruner(params.pruning, False, ms.matches, self.seeds)
        self.max_explored_pos = Pos(0, 0)
        self.hstats = HeuristicStats(
            num_seeds=len(self.seeds.seeds),
            num_matches=len(ms.matches),
            num_filtered_matches=len(ms.matches),
        )
        self.hstats.h0 = self.h(Pos(0, 0))

    # --- h ------------------------------------------------------------------

    def h(self, pos: Pos) -> int:
        return self.seeds.pot(pos) - self.contours.score(pos.i)

    def h_with_hint(self, pos: Pos, hint):
        if hint is None:
            hint = 0
        m, new_hint = self.contours.score_with_hint(pos.i, hint)
        self.hstats.h_calls += 1
        return self.seeds.pot(pos) - m, new_hint

    def default_hint(self):
        return 0

    def root_potential(self) -> int:
        return int(self.seeds.potential[0])

    def is_seed_start_or_end(self, pos: Pos) -> bool:
        return self.seeds.is_seed_start_or_end(pos)

    # --- order (queue shifts) -------------------------------------------------

    def order_of(self, pos: Pos) -> int:
        return pos.i

    def order_zero(self) -> int:
        return 0

    # --- pruning ---------------------------------------------------------------

    def prune(self, pos: Pos, hint) -> tuple[int, int]:
        """Prune matches at ``pos``; the shift is the number of layers
        removed, valid when ``pos`` dominates everything explored
        (`sh.rs:120-149`)."""
        if not self.params.pruning.is_enabled():
            return 0, 0
        if hint is None:
            hint = 0
        change = 0

        def on_prune(m: Match) -> None:
            nonlocal change
            c = self.contours.prune_with_hint(self.seeds, _match_to_arrow(m), hint)
            if m.start.i == pos.i:
                change += c

        p_start, p_end = self.pruner.prune(self.seeds, pos, on_prune)
        self.hstats.num_pruned += p_start + p_end
        self.hstats.prune_calls += 1
        if (
            pos.i >= self.max_explored_pos.i
            and pos.j >= self.max_explored_pos.j
        ):
            return change, pos.i
        return 0, 0

    def explore(self, pos: Pos) -> None:
        self.max_explored_pos = Pos(
            max(self.max_explored_pos.i, pos.i),
            max(self.max_explored_pos.j, pos.j),
        )

    def stats(self) -> HeuristicStats:
        self.hstats.h0_end = self.h(Pos(0, 0))
        return self.hstats

    def matches(self):
        return list(self.pruner)
