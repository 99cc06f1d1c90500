"""Affine cost models (re-design of `pa-affine-types/src/cost_model.rs`).

The port's own copy of ``astarpa_tpu/affine/cost_model.py`` (the code kept
identical).  ``AffineCost`` carries linear sub/ins/del costs (None = op not
allowed) plus any number of affine (open, extend) gap layers, with derived
min/max open/extend aggregates used by band and front bounds
(`cost_model.rs:49-110,230-310`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

INF = (1 << 31) - 1


class AffineLayerType(enum.Enum):
    INSERT = "insert"
    DELETE = "delete"

    @property
    def is_insert(self) -> bool:
        return self == AffineLayerType.INSERT

    @property
    def is_delete(self) -> bool:
        return self == AffineLayerType.DELETE


@dataclass(frozen=True)
class AffineLayerCosts:
    affine_type: AffineLayerType
    open: int
    extend: int


@dataclass(frozen=True)
class AffineCost:
    """Cost model with N affine layers (`cost_model.rs:44-76`)."""

    sub: int | None
    ins: int | None
    delete: int | None
    affine: tuple[AffineLayerCosts, ...] = ()

    def __post_init__(self):
        assert self.sub is None or self.sub > 0
        assert self.ins is None or self.ins > 0
        assert self.delete is None or self.delete > 0
        for l in self.affine:
            assert l.open > 0 and l.extend > 0

    # -- constructors (`cost_model.rs:110-190`) ------------------------------

    @staticmethod
    def unit() -> "AffineCost":
        return AffineCost(1, 1, 1)

    @staticmethod
    def lcs() -> "AffineCost":
        return AffineCost(None, 1, 1)

    @staticmethod
    def linear(sub: int, indel: int) -> "AffineCost":
        return AffineCost(sub, indel, indel)

    @staticmethod
    def linear_asymmetric(sub: int, ins: int, delete: int) -> "AffineCost":
        return AffineCost(sub, ins, delete)

    @staticmethod
    def affine_model(sub: int, open: int, extend: int) -> "AffineCost":
        return AffineCost(
            sub,
            None,
            None,
            (
                AffineLayerCosts(AffineLayerType.INSERT, open, extend),
                AffineLayerCosts(AffineLayerType.DELETE, open, extend),
            ),
        )

    @staticmethod
    def affine_asymmetric(
        sub: int, ins_open: int, ins_extend: int, del_open: int, del_extend: int
    ) -> "AffineCost":
        return AffineCost(
            sub,
            None,
            None,
            (
                AffineLayerCosts(AffineLayerType.INSERT, ins_open, ins_extend),
                AffineLayerCosts(AffineLayerType.DELETE, del_open, del_extend),
            ),
        )

    @staticmethod
    def double_affine(
        sub: int, open: int, extend: int, open2: int, extend2: int
    ) -> "AffineCost":
        return AffineCost(
            sub,
            None,
            None,
            (
                AffineLayerCosts(AffineLayerType.INSERT, open, extend),
                AffineLayerCosts(AffineLayerType.DELETE, open, extend),
                AffineLayerCosts(AffineLayerType.INSERT, open2, extend2),
                AffineLayerCosts(AffineLayerType.DELETE, open2, extend2),
            ),
        )

    # -- derived aggregates (`cost_model.rs:230-310`) -------------------------

    @property
    def n_layers(self) -> int:
        return len(self.affine)

    def _agg(self, is_insert: bool, f, reduce_fn, default: int) -> int:
        linear = self.ins if is_insert else self.delete
        vals = [
            f(l) for l in self.affine if l.affine_type.is_insert == is_insert
        ]
        if linear is not None:
            vals.append(f(AffineLayerCosts(AffineLayerType.INSERT, 0, linear)))
        return reduce_fn(vals) if vals else default

    @property
    def min_ins_extend(self) -> int:
        return self._agg(True, lambda l: l.extend, min, INF)

    @property
    def max_ins_extend(self) -> int:
        return self._agg(True, lambda l: l.extend, max, -INF)

    @property
    def min_del_extend(self) -> int:
        return self._agg(False, lambda l: l.extend, min, INF)

    @property
    def max_del_extend(self) -> int:
        return self._agg(False, lambda l: l.extend, max, -INF)

    @property
    def min_ins_open_extend(self) -> int:
        return self._agg(True, lambda l: l.open + l.extend, min, INF)

    @property
    def max_ins_open_extend(self) -> int:
        return self._agg(True, lambda l: l.open + l.extend, max, -INF)

    @property
    def min_del_open_extend(self) -> int:
        return self._agg(False, lambda l: l.open + l.extend, min, INF)

    @property
    def max_del_open_extend(self) -> int:
        return self._agg(False, lambda l: l.open + l.extend, max, -INF)

    # -- cost queries ----------------------------------------------------------

    def sub_cost(self, ca: int, cb: int) -> int | None:
        """Cost of aligning chars ca/cb (`cost_model.rs:312-322`)."""
        return 0 if ca == cb else self.sub

    def gap_cost(self, s, t) -> int:
        """Min cost of a pure gap from s to t (`cost_model.rs:453-487`)."""
        delta = (t[0] - s[0]) - (t[1] - s[1])
        if delta == 0:
            return 0
        d = abs(delta)
        is_insert = delta < 0
        c = INF
        linear = self.ins if is_insert else self.delete
        if linear is not None:
            c = min(c, d * linear)
        for l in self.affine:
            if l.affine_type.is_insert == is_insert:
                c = min(c, l.open + d * l.extend)
        assert c != INF
        return c

    def extend_cost(self, s, t) -> int:
        """Like gap_cost but without open costs (`cost_model.rs:490-520`)."""
        delta = (t[0] - s[0]) - (t[1] - s[1])
        if delta == 0:
            return 0
        d = abs(delta)
        is_insert = delta < 0
        c = INF
        linear = self.ins if is_insert else self.delete
        if linear is not None:
            c = min(c, d * linear)
        for l in self.affine:
            if l.affine_type.is_insert == is_insert:
                c = min(c, d * l.extend)
        assert c != INF
        return c
