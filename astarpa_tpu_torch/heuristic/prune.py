"""Match store with block-granular pruning.

Mirror of `pa-heuristic/src/prune.rs`: matches sorted by
``(start, match_cost)`` with per-seed active ranges; ``prune_block`` marks
all matches *starting* inside a column x row block as pruned, using the
before/after two-pointer split so matches between disjoint pruned row
ranges are swept too (`prune.rs:245-292`).
"""

from __future__ import annotations

import bisect
import enum
from dataclasses import dataclass

from ..types import Pos
from .matches import Match
from .seeds import Seeds


class Prune(enum.Enum):
    NONE = "none"
    START = "start"
    END = "end"
    BOTH = "both"

    @property
    def prune_start(self) -> bool:
        return self in (Prune.START, Prune.BOTH)

    @property
    def prune_end(self) -> bool:
        return self in (Prune.END, Prune.BOTH)

    @property
    def is_enabled(self) -> bool:
        return self != Prune.NONE


@dataclass
class Pruning:
    enabled: Prune = Prune.START
    skip_prune: int | None = None

    @staticmethod
    def disabled() -> "Pruning":
        return Pruning(Prune.NONE)

    @staticmethod
    def start() -> "Pruning":
        return Pruning(Prune.START)

    def is_enabled(self) -> bool:
        return self.enabled.is_enabled


class _ActiveRange:
    __slots__ = ("col", "before_start", "before_end", "after_start", "after_end", "split")

    def __init__(self, col, lo, hi):
        self.col = col
        self.before_start = lo
        self.before_end = hi
        self.after_start = hi
        self.after_end = hi
        self.split = False


class MatchPruner:
    def __init__(
        self,
        pruning: Pruning,
        check_consistency: bool,
        matches: list[Match],
        seeds: Seeds,
    ):
        self.pruning = pruning
        # Consistency repair is only needed for inexact matches in the
        # transformed (GCSH) domain (`csh.rs:240` passes use_gap_cost).
        self.check_consistency_flag = check_consistency
        self.skip = 1
        # Sort by (LexPos(start), match_cost): prune low cost first.
        matches.sort(key=lambda m: (m.start.i, m.start.j, m.match_cost))
        self.by_start = matches
        self.start_index: dict[Pos, tuple[int, int]] = {}
        i = 0
        while i < len(matches):
            j = i
            while j < len(matches) and matches[j].start == matches[i].start:
                j += 1
            self.start_index[matches[i].start] = (i, j)
            i = j

        # The *same* Match objects sorted by end: pruning marks the shared
        # object, keeping both views in sync (the reference keeps two copies
        # synced via `mut_match_start/end`, `prune.rs:295-311`).
        self.by_end: list[Match] = []
        self.end_index: dict[Pos, tuple[int, int]] = {}
        if pruning.enabled.prune_end:
            self.by_end = sorted(
                matches, key=lambda m: (m.end.i, m.end.j, m.match_cost)
            )
            i = 0
            while i < len(self.by_end):
                j = i
                while j < len(self.by_end) and self.by_end[j].end == self.by_end[i].end:
                    j += 1
                self.end_index[self.by_end[i].end] = (i, j)
                i = j

        # Per-seed active ranges for block pruning (`prune.rs:166-188`).
        self.active_range: list[_ActiveRange] = []
        if pruning.enabled.prune_start:
            idx = 0
            for s in seeds.seeds:
                lo = idx
                while idx < len(matches) and matches[idx].start.i == s.start:
                    idx += 1
                self.active_range.append(_ActiveRange(s.start, lo, idx))

    def matches_for_start(self, pos: Pos) -> list[Match]:
        rng = self.start_index.get(pos)
        if rng is None:
            return []
        return self.by_start[rng[0] : rng[1]]

    def __iter__(self):
        return iter(self.by_start)

    # --- per-position pruning (the A* path, `prune.rs:213-240`) -------------

    def prune(self, seeds: Seeds, pos: Pos, on_prune=None) -> tuple[int, int]:
        """Prune active matches starting (resp. ending) at ``pos``.

        Returns (#pruned by start, #pruned by end).  Each candidate passes
        the consistency check (`prune.rs:328-349`) and the `skip_prune`
        throttle (`prune.rs:352-365`) before being marked.
        """
        cnt = [0, 0]
        if self.pruning.enabled.prune_start and seeds.is_seed_start(pos):
            rng = self.start_index.get(pos)
            if rng is not None:
                for m in self.by_start[rng[0] : rng[1]]:
                    if m.is_active() and self._consistent(m) and self._skip_filter():
                        m.prune()
                        cnt[0] += 1
                        if on_prune:
                            on_prune(m)
        if self.pruning.enabled.prune_end and seeds.is_seed_end(pos):
            rng = self.end_index.get(pos)
            if rng is not None:
                for m in self.by_end[rng[0] : rng[1]]:
                    if m.is_active() and self._consistent(m) and self._skip_filter():
                        m.prune()
                        cnt[1] += 1
                        if on_prune:
                            on_prune(m)
        return cnt[0], cnt[1]

    def _max_score_for_match(self, start: Pos, end: Pos) -> int:
        rng = self.start_index.get(start)
        if rng is None:
            return 0
        return max(
            (
                m.score()
                for m in self.by_start[rng[0] : rng[1]]
                if m.is_active() and m.end == end
            ),
            default=0,
        )

    def _consistent(self, m: Match) -> bool:
        """A cost-1 match may only be pruned if no neighbouring (one-indel
        shifted) match of larger score depends on it (`prune.rs:328-349`)."""
        if not self.check_consistency_flag or m.match_cost == 0:
            return True
        score = m.score()
        for s, e in (
            (Pos(m.start.i, m.start.j + 1), m.end),
            (Pos(m.start.i, m.start.j - 1), m.end),
            (m.start, Pos(m.end.i, m.end.j + 1)),
            (m.start, Pos(m.end.i, m.end.j - 1)),
        ):
            if self._max_score_for_match(s, e) > score:
                return False
        return True

    def _skip_filter(self) -> bool:
        """False once every `skip_prune` candidates (`prune.rs:352-365`)."""
        if self.pruning.skip_prune is None:
            return True
        self.skip -= 1
        if self.skip == 0:
            self.skip = self.pruning.skip_prune
            return False
        return True

    def prune_block(self, i_range, j_range, on_prune=None) -> int:
        """Prune matches starting in ``(i_range[0], i_range[1]] x
        [j_range[0], j_range[1]]`` (both j-inclusive), `prune.rs:245-292`."""
        assert self.pruning.enabled == Prune.START
        assert j_range[0] <= j_range[1]
        count = 0
        by_start = self.by_start
        seed_idx = bisect.bisect_left(self.active_range, i_range[0] + 1, key=lambda ar: ar.col)
        while seed_idx < len(self.active_range):
            ar = self.active_range[seed_idx]
            if ar.col > i_range[1]:
                break
            if not ar.split:
                # Split into before (j <= j_range[1]) and after.
                while (
                    ar.after_start >= ar.before_start + 1
                    and by_start[ar.after_start - 1].start.j > j_range[1]
                ):
                    ar.before_end -= 1
                    ar.after_start -= 1
                ar.split = True
            # Prune the tail of `before` with j >= j_range[0] ...
            while (
                ar.before_end > ar.before_start
                and by_start[ar.before_end - 1].start.j >= j_range[0]
            ):
                m = by_start[ar.before_end - 1]
                m.prune()
                count += 1
                if on_prune:
                    on_prune(m)
                ar.before_end -= 1
            # ... and the head of `after` with j <= j_range[1].
            while ar.after_start < ar.after_end and by_start[ar.after_start].start.j <= j_range[1]:
                m = by_start[ar.after_start]
                m.prune()
                count += 1
                if on_prune:
                    on_prune(m)
                ar.after_start += 1
            seed_idx += 1
        return count
