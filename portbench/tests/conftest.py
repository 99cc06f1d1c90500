"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny
cells that the program's plain CPU versions run in seconds, and the card
check for the tests marked ``cuda``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: A tiny shape of config #2: two distinct batches of 16 pairs of 400 bp.
TINY = {"name": "tiny", "pair_bp": 400, "error_rate": 0.05, "batch_pairs": 16,
        "pair_seeds": [5, 6], "aligner": {}, "reference_pairs": None,
        "cigars_per_batch": 4, "reduced": []}


def add_cell(root: Path, name: str, config: dict, mix: str, like: str) -> None:
    """Add a cell on ``config`` (written as a file of its own) and the
    traffic ``mix`` to the copy at ``root``; it reports the metrics of
    cell ``like``."""
    (root / "portbench" / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if config["name"] not in [c["name"] for c in bench["configs"]]:
        bench["configs"].append({"name": config["name"], "source": "test", "reduced": [],
                                 "file": f"portbench/configs/{config['name']}.json",
                                 "why": "test"})
    bench["workloads"].append({"name": name, "config": config["name"], "traffic": mix,
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` with the cells
    ``tiny-cost`` and ``tiny-align`` on :data:`TINY`."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_cell(tmp_path, "tiny-cost", TINY, "cost_stream", "cfg5-cost")
    add_cell(tmp_path, "tiny-align", TINY, "align_stream", "tiny-cost")
    return tmp_path


@pytest.fixture
def cuda():
    """Skips the test where torch sees no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
