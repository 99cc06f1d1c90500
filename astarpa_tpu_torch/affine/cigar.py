"""Affine CIGARs with layer open/close markers.

The port's own copy of ``astarpa_tpu/affine/cigar.py`` (the code kept
identical).  Re-design of `pa-affine-types/src/cigar.rs`: run-length
encoded edit ops extended with per-layer affine insert/delete plus
``open``/``close`` markers that carry the gap-open cost.  ``verify``
re-checks every op against the sequences under an
:class:`~astarpa_tpu_torch.affine.cost_model.AffineCost` and returns the
total cost — the CIGAR-parity contract (`cigar.rs:265-334`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..types import Cigar, CigarOp
from .cost_model import AffineCost, AffineLayerType


class AffineOpKind(enum.Enum):
    MATCH = "match"
    SUB = "sub"
    INS = "ins"
    DEL = "del"
    AFFINE_INS = "affine-ins"
    AFFINE_DEL = "affine-del"
    AFFINE_OPEN = "open"
    AFFINE_CLOSE = "close"


@dataclass(frozen=True)
class AffineCigarOp:
    """(kind, layer); layer is None for linear ops (`cigar.rs:5-23`)."""

    kind: AffineOpKind
    layer: int | None = None

    def to_base(self) -> CigarOp | None:
        k = self.kind
        if k == AffineOpKind.MATCH:
            return CigarOp.MATCH
        if k == AffineOpKind.SUB:
            return CigarOp.SUB
        if k in (AffineOpKind.INS, AffineOpKind.AFFINE_INS):
            return CigarOp.INS
        if k in (AffineOpKind.DEL, AffineOpKind.AFFINE_DEL):
            return CigarOp.DEL
        return None

    @staticmethod
    def from_base(op: CigarOp) -> "AffineCigarOp":
        return AffineCigarOp(
            {
                CigarOp.MATCH: AffineOpKind.MATCH,
                CigarOp.SUB: AffineOpKind.SUB,
                CigarOp.INS: AffineOpKind.INS,
                CigarOp.DEL: AffineOpKind.DEL,
            }[op]
        )


MATCH = AffineCigarOp(AffineOpKind.MATCH)
SUB = AffineCigarOp(AffineOpKind.SUB)
INS = AffineCigarOp(AffineOpKind.INS)
DEL = AffineCigarOp(AffineOpKind.DEL)


def affine_ins(layer: int) -> AffineCigarOp:
    return AffineCigarOp(AffineOpKind.AFFINE_INS, layer)


def affine_del(layer: int) -> AffineCigarOp:
    return AffineCigarOp(AffineOpKind.AFFINE_DEL, layer)


def affine_open(layer: int) -> AffineCigarOp:
    return AffineCigarOp(AffineOpKind.AFFINE_OPEN, layer)


def affine_close(layer: int) -> AffineCigarOp:
    return AffineCigarOp(AffineOpKind.AFFINE_CLOSE, layer)


@dataclass
class AffineCigarElem:
    op: AffineCigarOp
    cnt: int


@dataclass
class AffineCigar:
    ops: list[AffineCigarElem] = field(default_factory=list)

    # -- construction (`cigar.rs:126-179`) ------------------------------------

    def push_op(self, op: AffineCigarOp, cnt: int = 1) -> None:
        if cnt == 0:
            return
        if self.ops and self.ops[-1].op == op:
            self.ops[-1].cnt += cnt
        else:
            self.ops.append(AffineCigarElem(op, cnt))

    def push_elem(self, elem: AffineCigarElem) -> None:
        self.push_op(elem.op, elem.cnt)

    def match_push(self, cnt: int) -> None:
        self.push_op(MATCH, cnt)

    def reverse(self) -> None:
        self.ops.reverse()

    def append(self, other: "AffineCigar") -> None:
        for e in other.ops:
            self.push_elem(e)

    # -- conversion -------------------------------------------------------------

    @staticmethod
    def from_base(cigar: Cigar) -> "AffineCigar":
        out = AffineCigar()
        for e in cigar.ops:
            out.push_op(AffineCigarOp.from_base(e.op), e.cnt)
        return out

    def to_base(self) -> Cigar:
        out = Cigar()
        for e in self.ops:
            base = e.op.to_base()
            if base is not None:
                out.push(base, e.cnt)
        return out

    def to_string(self) -> str:
        return self.to_base().to_string()

    __str__ = to_string

    def to_path(self):
        return self.to_base().to_path()

    def to_path_with_costs(self, cm: AffineCost):
        """Positions and accumulated costs along the path
        (`cigar.rs:185-263`)."""
        pos = (0, 0)
        cost = 0
        layer = None
        path = [(pos, cost)]
        for e in self.ops:
            k = e.op.kind
            if k == AffineOpKind.AFFINE_OPEN:
                assert layer is None
                cost += cm.affine[e.op.layer].open
                layer = e.op.layer
                continue
            if k == AffineOpKind.AFFINE_CLOSE:
                assert layer == e.op.layer
                layer = None
                continue
            for _ in range(e.cnt):
                if k == AffineOpKind.MATCH:
                    pos = (pos[0] + 1, pos[1] + 1)
                elif k == AffineOpKind.SUB:
                    pos = (pos[0] + 1, pos[1] + 1)
                    cost += cm.sub
                elif k == AffineOpKind.INS:
                    pos = (pos[0], pos[1] + 1)
                    cost += cm.ins
                elif k == AffineOpKind.DEL:
                    pos = (pos[0] + 1, pos[1])
                    cost += cm.delete
                elif k == AffineOpKind.AFFINE_INS:
                    assert layer == e.op.layer
                    pos = (pos[0], pos[1] + 1)
                    cost += cm.affine[e.op.layer].extend
                else:
                    assert layer == e.op.layer
                    pos = (pos[0] + 1, pos[1])
                    cost += cm.affine[e.op.layer].extend
                path.append((pos, cost))
        return path

    # -- verification (`cigar.rs:265-334`) ---------------------------------------

    def verify(self, cm: AffineCost, a: bytes, b: bytes) -> int:
        i = j = 0
        layer = None
        cost = 0
        for e in self.ops:
            k = e.op.kind
            if k == AffineOpKind.MATCH:
                assert layer is None
                assert a[i : i + e.cnt] == b[j : j + e.cnt], "match op on unequal chars"
                i += e.cnt
                j += e.cnt
            elif k == AffineOpKind.SUB:
                assert layer is None
                for _ in range(e.cnt):
                    assert i < len(a) and j < len(b) and a[i] != b[j], (
                        "sub op on equal chars"
                    )
                    i += 1
                    j += 1
                cost += cm.sub * e.cnt
            elif k == AffineOpKind.INS:
                assert layer is None
                j += e.cnt
                cost += cm.ins * e.cnt
            elif k == AffineOpKind.DEL:
                assert layer is None
                i += e.cnt
                cost += cm.delete * e.cnt
            elif k == AffineOpKind.AFFINE_INS:
                assert layer == e.op.layer
                assert cm.affine[e.op.layer].affine_type == AffineLayerType.INSERT
                j += e.cnt
                cost += cm.affine[e.op.layer].extend * e.cnt
            elif k == AffineOpKind.AFFINE_DEL:
                assert layer == e.op.layer
                assert cm.affine[e.op.layer].affine_type == AffineLayerType.DELETE
                i += e.cnt
                cost += cm.affine[e.op.layer].extend * e.cnt
            elif k == AffineOpKind.AFFINE_OPEN:
                assert layer is None
                cost += cm.affine[e.op.layer].open
                layer = e.op.layer
            else:  # AFFINE_CLOSE
                assert layer == e.op.layer
                layer = None
        assert i == len(a) and j == len(b), (
            f"affine CIGAR ends at ({i},{j}), target ({len(a)},{len(b)})"
        )
        return cost
