"""The implicit unit-cost edit graph and diagonal-transition coordinates.

Host-side runtime component (the A* state space is pointer-chasing and
inherently sequential; the TPU-shaped reformulation of the same alignment
problem is the block aligner in :mod:`astarpa_tpu_torch.aligners`).  Semantics
mirror `astarpa/src/alignment_graph.rs:6-184`.
"""

from __future__ import annotations

import enum

from ..types import Pos


class Edge(enum.IntEnum):
    """Edge kinds of the edit graph (`alignment_graph.rs:6-13`)."""

    NONE = 0
    MATCH = 1
    SUB = 2
    RIGHT = 3  # deletion: consumes a char of `a` (i+1)
    DOWN = 4  # insertion: consumes a char of `b` (j+1)

    def cost(self) -> int:
        assert self != Edge.NONE
        return 0 if self == Edge.MATCH else 1

    def to_f(self) -> int:
        """Contribution to the farthest-reaching value fr = i + j when
        stepping back (`alignment_graph.rs:57-63`)."""
        return 0 if self in (Edge.NONE, Edge.DOWN) else 1

    def back(self, pos: Pos) -> Pos | None:
        """The predecessor along this edge, or None at the boundary."""
        i, j = pos
        if self in (Edge.MATCH, Edge.SUB):
            return Pos(i - 1, j - 1) if i > 0 and j > 0 else None
        if self == Edge.RIGHT:
            return Pos(i - 1, j) if i > 0 else None
        if self == Edge.DOWN:
            return Pos(i, j - 1) if j > 0 else None
        return None

    def dt_back(self, diagonal: int, g: int):
        """Predecessor in DT coordinates (`alignment_graph.rs:29-47`)."""
        if self == Edge.MATCH:
            return (diagonal, g)
        if g == 0:
            return None
        if self == Edge.SUB:
            return (diagonal, g - 1)
        if self == Edge.RIGHT:
            return (diagonal - 1, g - 1)
        if self == Edge.DOWN:
            return (diagonal + 1, g - 1)
        return None


def dt_key(pos: Pos, g: int) -> tuple[int, int]:
    """DtPos: (diagonal, g) (`alignment_graph.rs:67-90`)."""
    return (pos.i - pos.j, g)


def dt_fr(pos: Pos) -> int:
    return pos.i + pos.j


def dt_to_pos(diagonal: int, fr: int) -> Pos:
    return Pos((fr + diagonal) // 2, (fr - diagonal) // 2)


class EditGraph:
    """Implicit alignment graph over two byte strings
    (`alignment_graph.rs:98-184`)."""

    __slots__ = ("a", "b", "target", "greedy_matching")

    def __init__(self, a: bytes, b: bytes, greedy_matching: bool = True):
        self.a = a
        self.b = b
        self.target = Pos(len(a), len(b))
        self.greedy_matching = greedy_matching

    def is_match(self, pos: Pos) -> Pos | None:
        i, j = pos
        if i < self.target.i and j < self.target.j and self.a[i] == self.b[j]:
            return Pos(i + 1, j + 1)
        return None

    def outgoing_edges(self, pos: Pos) -> list[tuple[Pos, Edge]]:
        """Successors of ``pos``.  With greedy matching, a matching diagonal
        shadows the indel edges; otherwise the diagonal edge is listed last
        so the LIFO bucket queue expands it first
        (`alignment_graph.rs:155-183`).
        """
        i, j = pos
        n, m = self.target
        match_next = self.is_match(pos)
        if self.greedy_matching and match_next is not None:
            return [(match_next, Edge.MATCH)]
        out = []
        if i + 1 <= n:
            out.append((Pos(i + 1, j), Edge.RIGHT))
        if j + 1 <= m:
            out.append((Pos(i, j + 1), Edge.DOWN))
        if i + 1 <= n and j + 1 <= m:
            out.append(
                (Pos(i + 1, j + 1), Edge.MATCH if match_next is not None else Edge.SUB)
            )
        return out
