"""The roofline arithmetic at the shapes whose bounds the program's smoke
runs printed (PERF.md, the table of kernels): K1's ring on 4096 x 10 kbp
at SW=32, and config #5's SW=2048 rung, at 132 SMs and 1980 MHz."""

from __future__ import annotations

import pytest

from portbench import roofline


@pytest.mark.parametrize("pairs,cols,sw,ms", [(4096, 10_000, 32, 1.0970), (128, 500_000, 2048, 109.70)])
def test_bound_of_known_rungs(pairs, cols, sw, ms):
    got = roofline.least_seconds(sw, pairs * cols, 0, 0, 132, 1.98e9) * 1e3
    assert round(got, 4 if ms < 10 else 2) == ms


def test_bytes_bound_wins_when_larger():
    # 3.35 GB in and out takes a millisecond at 3.35 TB/s.
    assert roofline.least_seconds(1, 1, 3_350_000_000, 0, 132, 1.98e9) == pytest.approx(1e-3)
