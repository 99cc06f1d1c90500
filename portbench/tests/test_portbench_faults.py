"""A run with the timed path broken underneath comes out not correct: once
for each fault a stream of batches can have.  (A cell on one card has no
exchange between chips to leave out.)  The harness's look for a card is
skipped: the tiny cells run the program's plain CPU versions."""

from __future__ import annotations

import time

import numpy as np
import pytest

from astarpa_tpu_torch.parallel.runner import BatchAligner
from portbench import harness


def stale(results):
    """A step that returns its state unchanged: every batch gets the
    first batch's results."""
    first = None
    for out, stats in results:
        first = out if first is None else first
        yield first, stats


def half(results):
    """Half of each batch left out."""
    for out, stats in results:
        yield out[: len(out) // 2], stats


def altered(results):
    """One answer altered where it is produced: the first pair's cost, or
    the first run of every CIGAR."""
    for out, stats in results:
        if isinstance(out, np.ndarray):
            out = out.copy()
            out[0] += 1
        else:
            out = [(c, _flip(str(cig))) for c, cig in out]
        yield out, stats


def _flip(cigar: str) -> str:
    head = cigar.index("=") if "=" in cigar else None
    return cigar if head is None else cigar[:head] + "X" + cigar[head + 1:]


@pytest.mark.parametrize("fault", [stale, half, altered])
@pytest.mark.parametrize("cell,entry", [("tiny-cost", "cost_iter"), ("tiny-align", "align_iter")])
def test_a_broken_stream_is_not_correct(tiny_root, monkeypatch, fault, cell, entry):
    orig = getattr(BatchAligner, entry)
    monkeypatch.setattr(BatchAligner, entry, lambda self, batches: fault(orig(self, batches)))
    res, checks = harness.run_cell(tiny_root, cell, 9, 1.0, False, time.perf_counter(),
                                   device="cpu")
    assert not res["correct"] and res["failed"] > 0
    assert any(v > 0 for v in checks.values())


@pytest.mark.parametrize("cell", ["tiny-cost", "tiny-align"])
def test_the_sound_stream_is_correct(tiny_root, cell):
    res, checks = harness.run_cell(tiny_root, cell, 9, 1.0, False, time.perf_counter(),
                                   device="cpu")
    assert res["correct"] and res["failed"] == 0
    assert checks == {"cost_wrong": 0, "cigar_wrong": 0}
