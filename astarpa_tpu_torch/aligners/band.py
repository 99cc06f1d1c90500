"""Band / threshold search strategies (mirror of `astarpa2/src/band.rs`).

The port's copy of ``astarpa_tpu/aligners/band.py``.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Callable, Optional, TypeVar

T = TypeVar("T")

INF = 1 << 30


class DoublingStart(enum.Enum):
    ZERO = "zero"
    GAP = "gap"
    H0 = "h0"

    def initial_values(self, n: int, m: int, h0: int) -> tuple[int, int]:
        """(start_f, start_increment), cf. `band.rs:13-23`."""
        if self == DoublingStart.ZERO:
            return 0, 1
        if self == DoublingStart.GAP:
            x = abs(n - m)  # unit-cost gap cost start->target
            return x, x
        return h0, 1


@dataclass(frozen=True)
class DoublingType:
    kind: str  # 'none' | 'band-doubling' | 'linear-search' | 'local-doubling'
    start: DoublingStart = DoublingStart.H0
    factor: float = 2.0
    delta: float = 0.0
    start_increment: int | None = None

    @staticmethod
    def none() -> "DoublingType":
        return DoublingType("none")

    @staticmethod
    def band_doubling(start=DoublingStart.H0, factor=2.0) -> "DoublingType":
        return DoublingType("band-doubling", start=start, factor=factor)

    @staticmethod
    def linear_search(start=DoublingStart.GAP, delta=1.0) -> "DoublingType":
        return DoublingType("linear-search", start=start, delta=delta)

    @staticmethod
    def local_doubling() -> "DoublingType":
        return DoublingType("local-doubling")


def exponential_search(
    offset: int, s0: int, factor: float, f: Callable[[int], Optional[tuple[int, T]]]
) -> tuple[int, T]:
    """Try thresholds ``offset + s0 * factor^i`` until ``f`` succeeds.

    ``f(s)`` returns ``(cost, payload)`` when a (possibly too-expensive)
    path was found, else None. Mirrors `band.rs:100-141` including the
    overshoot cap ``maxs``.
    """
    last_s = -1
    s = offset + s0
    maxs = INF
    while True:
        r = f(s)
        if r is not None:
            cost, t = r
            assert cost <= maxs, (
                f"A solution {maxs} was found for a previous s<={last_s}, but s={s} gives {cost}"
            )
            if cost <= s:
                assert cost > last_s, (
                    f"Cost {cost} was found at s {s} but should already have been found at last_s {last_s}"
                )
                return cost, t
            maxs = min(maxs, cost)
        else:
            assert maxs == INF, (
                f"A solution {maxs} was found for a previous s<={last_s}, but not for current s={s}"
            )
        last_s = s
        s = max(math.ceil(factor * (s - offset)), 1) + offset
        s = min(s, maxs)


def linear_search(
    s0: int, delta: int, f: Callable[[int], Optional[tuple[int, T]]]
) -> tuple[int, T]:
    """Mirror of `band.rs:143-182`."""
    last_s = -1
    s = s0
    maxs = INF
    while True:
        r = f(s)
        if r is not None:
            cost, t = r
            assert cost <= maxs
            if cost <= s:
                assert cost > last_s
                return cost, t
            maxs = min(maxs, cost)
        else:
            assert maxs == INF
        last_s = s
        s = min(s + delta, maxs)
