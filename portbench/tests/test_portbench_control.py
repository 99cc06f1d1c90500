"""The control comes out not correct through a cell's own run and check:
at a size a test run holds on the CPU, and (marked ``cuda``) at config #5's
own size on the card."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT

from portbench import control


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_at_a_small_size(tiny_root, seed):
    # 400 bp pairs at e=5% drift a few diagonals: a band of 2 either side
    # misses some of their alignments, as 16 does at 10 kbp.
    got = control.control_run(tiny_root, "tiny-cost", seed, 0.5, "cpu", half_band=2)
    assert not got["correct"], json.dumps(got)
    assert got["checks"]["cost_wrong"]["value"] > got["checks"]["cost_wrong"]["limit"]


def test_control_on_the_align_path_fails_the_cigar_check(tiny_root):
    got = control.control_run(tiny_root, "tiny-align", 4, 0.5, "cpu", half_band=2)
    assert not got["correct"], json.dumps(got)
    assert got["checks"]["cost_wrong"]["value"] > 0


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(cuda):
    for seed in (21, 22, 23):
        got = control.control_run(ROOT, "cfg5-cost", seed, 3.0, "cuda")
        assert not got["correct"], json.dumps(got)
        assert got["checks"]["cost_wrong"]["value"] > 0


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(cuda):
    import time

    from portbench import harness

    res, checks = harness.run_cell(ROOT, "cfg5-cost", 31, 3.0, False, time.perf_counter())
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert checks == {"cost_wrong": 0, "cigar_wrong": 0}
