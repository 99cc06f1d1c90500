"""Layered contours: chain scores via dominance staircases.

Re-design of `pa-heuristic/src/contour/hint_contours.rs`.  Semantics
(`contour.rs:24-152`): ``score(q)`` is the maximum chain value over arrows
whose start dominates ``q``; layer ``v`` contains the start points of value
``v``.  Two deliberate departures from the reference's implementation (same
observable values, simpler structure):

- An arrow of score ``s`` pushes its start onto layers ``v-s+1 ..= v`` so
  that layers are strictly nested (the reference instead searches a
  ``max_len`` window around each probe, `hint_contours.rs:283-344`).
- Pruning rebuilds the layers from the active arrow set instead of rippling
  updates upward (`hint_contours.rs:459-637`).  The block aligner only
  flushes prunes once per band-doubling attempt (`domain.rs:364-371`), so a
  rebuild is O(#matches log) per attempt and exact by construction.

Each layer is a staircase of dominant points stored as parallel sorted
arrays; containment is one bisect.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from ..types import Pos

INT_MAX = (1 << 31) - 1


@dataclass
class Arrow:
    """f(start) >= f(end) + score (`contour.rs:59-67`)."""

    start: Pos
    end: Pos
    score: int


class _Staircase:
    """Dominant points of one layer: i ascending, j descending."""

    __slots__ = ("xs", "ys")

    def __init__(self):
        self.xs: list[int] = []
        self.ys: list[int] = []

    def contains(self, q: Pos) -> bool:
        # The point with the smallest i >= q.i has the largest j among those.
        k = bisect.bisect_left(self.xs, q.i)
        return k < len(self.xs) and self.ys[k] >= q.j

    def push(self, p: Pos) -> None:
        """Insert p, dropping points it dominates; no-op if dominated."""
        k = bisect.bisect_left(self.xs, p.i)
        if k < len(self.xs) and self.ys[k] >= p.j:
            return  # dominated by (or equal to) an existing point
        hi = k
        if hi < len(self.xs) and self.xs[hi] == p.i:
            hi += 1  # same i with smaller j: dominated by p
        lo = k
        while lo > 0 and self.ys[lo - 1] <= p.j:
            lo -= 1  # points left of k with j <= p.j: dominated by p
        self.xs[lo:hi] = [p.i]
        self.ys[lo:hi] = [p.j]


class Contours:
    """Nested layered contours with hint-accelerated queries."""

    def __init__(self, arrows_by_start: list[tuple[Pos, list[Arrow]]] | None = None):
        # layers[v] for v >= 1; layer 0 implicitly contains everything.
        self.layers: list[_Staircase] = []
        if arrows_by_start:
            self.build(arrows_by_start)

    def build(self, arrows_by_start: list[tuple[Pos, list[Arrow]]]) -> None:
        """Build from arrows grouped by start, reverse-sorted by LexPos(start)
        (`hint_contours.rs:213-254`)."""
        self.layers = []
        for start, arrows in arrows_by_start:
            v = 0
            l = 0
            for a in arrows:
                nv = self.score(a.end) + a.score
                if nv > v:
                    v = nv
                l = max(l, a.score)
            if v == 0:
                continue
            while len(self.layers) < v:
                self.layers.append(_Staircase())
            for layer in range(max(1, v - l + 1), v + 1):
                self.layers[layer - 1].push(start)

    def num_layers(self) -> int:
        return len(self.layers)

    def contains(self, v: int, q: Pos) -> bool:
        if v <= 0:
            return True
        if v > len(self.layers):
            return False
        return self.layers[v - 1].contains(q)

    def score(self, q: Pos) -> int:
        lo, hi = 0, len(self.layers) + 1
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self.contains(mid, q):
                lo = mid
            else:
                hi = mid
        return lo

    def score_with_hint(self, q: Pos, hint: int | None) -> tuple[int, int]:
        """Nested layers make a linear walk from the hint exact."""
        if hint is None:
            v = self.score(q)
            return v, v
        v = min(max(hint, 0), len(self.layers))
        if self.contains(v, q):
            while self.contains(v + 1, q):
                v += 1
        else:
            while v > 0 and not self.contains(v, q):
                v -= 1
        return v, v
