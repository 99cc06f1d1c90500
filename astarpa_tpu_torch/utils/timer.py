"""Sampling timer (mirror of `pa-heuristic/src/util.rs:8-38`).

The port's own copy of ``astarpa_tpu/utils/timer.py`` (stdlib only, the
code kept identical).  Times one in every ``period`` calls and
extrapolates, so hot loops can be instrumented at negligible cost.
Accumulates into a float cell.
"""

from __future__ import annotations

import time


class Timer:
    """Usage::

        t = Timer.each(64, stats, "h_calls")
        ...work...
        t.end(stats, "h_duration")
    """

    __slots__ = ("period", "t0")

    _counters: dict[int, int] = {}

    def __init__(self, period: int, count: int):
        self.period = period
        self.t0 = time.perf_counter() if count % period == 0 else None

    @classmethod
    def each(cls, period: int, obj, counter_attr: str) -> "Timer":
        cnt = getattr(obj, counter_attr)
        setattr(obj, counter_attr, cnt + 1)
        return cls(period, cnt)

    def end(self, obj, duration_attr: str) -> float:
        """Add the extrapolated elapsed time; returns the sample (or 0)."""
        if self.t0 is None:
            return 0.0
        dt = time.perf_counter() - self.t0
        setattr(obj, duration_attr, getattr(obj, duration_attr) + dt * self.period)
        return dt
