"""(Gap-)Chained Seed Heuristic — the production heuristic.

Mirror of `pa-heuristic/src/heuristic/csh.rs`:

    h(pos) = potential(pos) - contours.score(T(pos))

falling back to the distance to the target when the score is 0
(`csh.rs:341-350`).  GCSH is CSH with ``use_gap_cost=True``: arrows live in
the transformed domain (`csh.rs:47-60`), and the distance fallback is
``max(gap_cost, potential_distance)``.

Block pruning defers contour updates: `prune_block` only marks matches;
`update_contours` rebuilds the layers (cf. `csh.rs:472-554`; the reference
ripples incrementally, same resulting scores).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import Pos
from .contours import Arrow, Contours
from .distances import HeuristicInstance
from .matches import MatchConfig, find_matches
from .prune import MatchPruner, Prune, Pruning
from .seeds import Seeds
from .stats import HeuristicStats


@dataclass
class CSH:
    """Heuristic config/factory (`csh.rs:12-60`)."""

    match_config: MatchConfig
    pruning: Pruning
    use_gap_cost: bool = False

    def build(self, a: bytes, b: bytes) -> "CSHI":
        return CSHI(a, b, self)

    @property
    def name(self) -> str:
        return "GCSH" if self.use_gap_cost else "CSH"


def GCSH(match_config: MatchConfig, pruning: Pruning) -> CSH:
    return CSH(match_config, pruning, use_gap_cost=True)


class CSHI(HeuristicInstance):
    """Instantiated heuristic (`csh.rs:152-579`)."""

    def __init__(self, a: bytes, b: bytes, params: CSH):
        self.params = params
        ms = find_matches(a, b, params.match_config, params.use_gap_cost)
        self.seeds: Seeds = ms.seeds
        self.target = Pos(len(a), len(b))
        self.t_target = self.transform(self.target)
        self.pruner = MatchPruner(
            params.pruning, params.use_gap_cost, ms.matches, self.seeds
        )
        self.contours = Contours()
        self._dirty = False
        self._rebuild_contours()
        self.num_pruned = 0
        self.max_transformed_pos = Pos(0, 0)
        self.hstats = HeuristicStats(
            num_seeds=len(self.seeds.seeds),
            num_matches=len(ms.matches),
            num_filtered_matches=len(ms.matches),
        )
        self.hstats.h0 = self.h(Pos(0, 0))

    # --- transform -----------------------------------------------------------

    def transform(self, pos: Pos) -> Pos:
        return self.seeds.transform(pos) if self.params.use_gap_cost else pos

    # --- contours ------------------------------------------------------------

    def _rebuild_contours(self) -> None:
        """Arrows from active matches with end <= T(target), grouped by start,
        reverse-sorted (`csh.rs:243-277`)."""
        tt = self.t_target
        groups: list[tuple[Pos, list[Arrow]]] = []
        cur_start = None
        cur: list[Arrow] = []
        # by_start is sorted by LexPos(start) ascending; iterate reversed.
        for m in reversed(self.pruner.by_start):
            if not m.is_active():
                continue
            s = self.transform(m.start)
            e = self.transform(m.end)
            if not (e.i <= tt.i and e.j <= tt.j):
                continue
            if m.start != cur_start:
                if cur:
                    groups.append((self.transform(cur_start), cur))
                cur_start = m.start
                cur = []
            cur.append(Arrow(s, e, m.score()))
        if cur:
            groups.append((self.transform(cur_start), cur))
        self.contours.build(groups)
        self._dirty = False

    # --- h -------------------------------------------------------------------

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        pd = self.seeds.potential_distance(from_pos, to_pos)
        if self.params.use_gap_cost:
            gap = abs((to_pos.i - from_pos.i) - (to_pos.j - from_pos.j))
            return max(gap, pd)
        return pd

    def h(self, pos: Pos) -> int:
        p = self.seeds.pot(pos)
        val = self.contours.score(self.transform(pos))
        if val == 0:
            return self.distance(pos, self.target)
        return p - val

    def h_with_hint(self, pos: Pos, hint):
        self.hstats.h_calls += 1
        p = self.seeds.pot(pos)
        val, new_hint = self.contours.score_with_hint(self.transform(pos), hint)
        if val == 0:
            return self.distance(pos, self.target), new_hint
        return p - val, new_hint

    def default_hint(self):
        return None

    def root_potential(self) -> int:
        return self.seeds.pot(Pos(0, 0))

    def is_seed_start_or_end(self, pos: Pos) -> bool:
        return self.seeds.is_seed_start_or_end(pos)

    # --- order (queue shifts) --------------------------------------------------

    def order_of(self, pos: Pos):
        return (pos.i, pos.j)

    def order_zero(self):
        return (0, 0)

    def explore(self, pos: Pos) -> None:
        """Track the max explored transformed position (`csh.rs:556-560`);
        gates whether a prune's shift may be applied to the whole queue."""
        t = self.transform(pos)
        self.max_transformed_pos = Pos(
            max(self.max_transformed_pos.i, t.i),
            max(self.max_transformed_pos.j, t.j),
        )

    # --- pruning ---------------------------------------------------------------

    def prune(self, pos: Pos, hint) -> tuple[int, tuple[int, int]]:
        """Per-position prune for the A* loop (`csh.rs:393-468`).

        Departure from the reference: the contours are rebuilt from the
        active match set instead of rippled incrementally (exact by
        construction).  The O(1) queue-shift amount is the score decrease
        at the pruned position — the same quantity the reference's
        incremental ripple reports (`hint_contours.rs:459-637`) — gated
        for GCSH on the pruned position dominating everything explored
        (`csh.rs:452-459`); the ShiftQueue additionally verifies that it
        dominates everything *pushed* before applying the shift.
        """
        if not self.params.pruning.is_enabled():
            return 0, self.order_zero()
        tpos = self.transform(pos)
        v_before = self.contours.score(tpos)
        p_start, p_end = self.pruner.prune(self.seeds, pos)
        self.hstats.prune_calls += 1
        if p_start + p_end == 0:
            return 0, self.order_of(pos)
        self.num_pruned += p_start + p_end
        self.hstats.num_pruned += p_start + p_end
        self._rebuild_contours()
        change = max(0, v_before - self.contours.score(tpos))
        if self.params.use_gap_cost and not (
            self.max_transformed_pos.i <= tpos.i
            and self.max_transformed_pos.j <= tpos.j
        ):
            change = 0
        return change, self.order_of(pos)

    def stats(self) -> HeuristicStats:
        self.hstats.h0_end = self.h(Pos(0, 0))
        return self.hstats

    def prune_block(self, i_range, j_range) -> None:
        """Mark matches starting in the block as pruned (`csh.rs:472-493`);
        contours update is deferred to `update_contours`."""
        if not self.params.pruning.is_enabled():
            return
        n = self.pruner.prune_block(i_range, j_range)
        if n:
            self.num_pruned += n
            self._dirty = True

    def update_contours(self, pos: Pos) -> None:
        """Flush pending prunes (`csh.rs:497-554`; full rebuild here)."""
        if self._dirty:
            self._rebuild_contours()

    def matches(self):
        return list(self.pruner)
