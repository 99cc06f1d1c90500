"""The program's spans and launch records read in a traced run
(:mod:`portbench.program_trace`) on the tiny CPU cell, and the harness
left as it was for every other run."""

from __future__ import annotations

import time

from conftest import TINY, add_cell
from test_portbench_layout import ALLOWED_LINE

from astarpa_tpu_torch.utils import spans
from portbench import harness, program_trace


def test_program_readings_beside_the_wrappers(tiny_root):
    # Smaller than the tiny cell: the profiler's events of the plain
    # versions take seconds a batch to read.
    add_cell(tiny_root, "mini-cost", dict(TINY, name="mini", pair_bp=100, batch_pairs=8),
             "cost_stream", "tiny-cost")
    names = (harness._Spies, harness._read_trace, harness.Run)
    res, checks = program_trace.run_cell(tiny_root, "mini-cost", 2**31 + 7, 0.4,
                                         time.perf_counter(), device="cpu")
    assert res["correct"] and checks == {"cost_wrong": 0, "cigar_wrong": 0}
    got = res["metrics"]
    assert got["host_ms_per_batch.cost"]["value"] > 0
    twin, wrapped = got["pack_span_share.cost"]["value"], got["pack_share.cost"]["value"]
    assert twin > 0 and abs(twin - wrapped) <= 0.05 * wrapped
    # No card: no program kernel to match, nothing to read.
    assert "launch_roofline.cost" not in got and "ring_roofline.cost" not in got
    assert res["program_trace"]["kernels"] == 0 and res["program_trace"]["launch_records"] > 0
    assert list(res)[-1] == "checks"
    assert (harness._Spies, harness._read_trace, harness.Run) == names
    assert not spans.on()

    # The untraced line, after it, has the keys and metrics it had.
    res, _ = harness.run_cell(tiny_root, "mini-cost", 4, 0.5, False, time.perf_counter(),
                              device="cpu")
    assert list(res) == ALLOWED_LINE + ["checks"]
    assert set(res["metrics"]) == {"cost_Mbp_s", "setup_s"}


def test_intervals():
    u = program_trace._union([(3, 5), (0, 1), (4, 8), (9, 12)], 0.5, 10)
    assert u == [[0.5, 1], [3, 8], [9, 10]] and program_trace._length(u) == 6.5
    assert program_trace._overlap(u, [[0, 4], [7.5, 9.5]]) == 0.5 + 1 + 0.5 + 0.5
