"""Affine-cost alignment types (re-design of the `pa-affine-types` crate).

The port's own copy of ``astarpa_tpu/affine/`` (pure Python, the code kept
identical), which :mod:`astarpa_tpu_torch.base` builds on.

- :class:`AffineCost`: linear + N affine (open, extend) layers.
- :class:`AffineCigar`: CIGARs with affine-layer markers and cost-checked
  :meth:`~AffineCigar.verify`.
- :class:`State`: edit-graph state ``(i, j, layer)``
  (`pa-affine-types/src/lib.rs:10-36`).
"""

from __future__ import annotations

from dataclasses import dataclass

from .cigar import (
    DEL,
    INS,
    MATCH,
    SUB,
    AffineCigar,
    AffineCigarElem,
    AffineCigarOp,
    AffineOpKind,
    affine_close,
    affine_del,
    affine_ins,
    affine_open,
)
from .cost_model import AffineCost, AffineLayerCosts, AffineLayerType


@dataclass(frozen=True)
class State:
    """State in the affine edit graph: position plus active layer
    (None = main layer)."""

    i: int
    j: int
    layer: int | None = None

    def pos(self):
        return (self.i, self.j)


__all__ = [
    "AffineCost",
    "AffineLayerCosts",
    "AffineLayerType",
    "AffineCigar",
    "AffineCigarElem",
    "AffineCigarOp",
    "AffineOpKind",
    "State",
    "MATCH",
    "SUB",
    "INS",
    "DEL",
    "affine_ins",
    "affine_del",
    "affine_open",
    "affine_close",
]
