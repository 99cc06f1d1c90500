"""The data-driven layout: a new configuration, traffic mix and metric are
files and entries only; the result line's keys; BENCHMARK.json's shape."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

from conftest import ROOT, TINY, add_cell

from portbench import harness

ALLOWED_LINE = ["correct", "attempted", "failed", "metrics", "device"]


def test_new_files_are_picked_up_by_name(tiny_root):
    cfg = dict(TINY, name="tiny_other", pair_bp=300, batch_pairs=8)
    (tiny_root / "portbench" / "traffic" / "cost_stream_other.json").write_text(json.dumps(
        {"name": "cost_stream_other", "entry": "cost_iter"}))
    (tiny_root / "portbench" / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return len(run.batches)\n")
    add_cell(tiny_root, "tiny-other", cfg, "cost_stream_other", "cfg5-cost")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "batches_seen", "unit": "batches", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-other"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, checks = harness.run_cell(tiny_root, "tiny-other", 3, 0.5, False, time.perf_counter(),
                                   device="cpu")
    assert res["correct"] and checks == {"cost_wrong": 0, "cigar_wrong": 0}
    assert res["metrics"]["batches_seen"]["value"] >= 1
    assert set(res["metrics"]) == {"batches_seen", "cost_Mbp_s", "setup_s"}
    assert res["attempted"] % 8 == 0 and res["attempted"] > 0


def test_result_line_keys(tiny_root):
    for trace in (False, True):
        res, _ = harness.run_cell(tiny_root, "tiny-cost", 4, 0.5, trace, time.perf_counter(),
                                  device="cpu")
        keys = list(res)
        # The numbers compared come last, under a key of their own.
        assert keys[-1] == "checks"
        assert keys[:-1] in (ALLOWED_LINE, ALLOWED_LINE + ["breakdown"])
        assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        if trace:
            assert {"busy_s", "window_s"} <= set(res["device"])


def test_no_card_no_result(tiny_root):
    """Without a CUDA device run.py exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tiny-cost",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tiny_root)
    import torch

    if not torch.cuda.is_available():
        assert out.returncode != 0 and out.stdout.strip() == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_shape():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    names = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moves = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= moves[m["moves"]]
