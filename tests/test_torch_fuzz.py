"""The port's fuzzer (``python -m astarpa_tpu_torch.fuzz``) on the CPU: 10
iterations of each batch mode against the oracle, and its shrinker on a
deliberately wrong aligner."""

import pytest
import torch

from astarpa_tpu import native
from astarpa_tpu_torch import fuzz, oracle

torch.set_num_threads(1)


@pytest.mark.skipif(not native.available(), reason="native toolchain unavailable")
@pytest.mark.parametrize("mode", ["batch", "batch-ck", "batch-domain", "batch-bigband"])
def test_batch_modes_pass(mode, capsys):
    assert fuzz.main(["--aligner", mode, "--iters", "10", "--max-n", "400", "--seed", "7",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "no failures" in out and "launches: {}" in out


def test_bigband_routes_restore_the_constants():
    from astarpa_tpu_torch.ops import banded_kernel
    from astarpa_tpu_torch.parallel import runner

    saved = runner.STRIPED_MIN_SW, banded_kernel.RING_MAX_WORDS
    align = fuzz.build("batch-bigband", "cpu")
    a, b = b"ACGT" * 70, b"ACGA" * 70
    for _ in fuzz.BIGBAND_ROUTES:
        cost, cigar = align(a, b)
        assert cost == oracle.levenshtein(a, b) == cigar.verify(a, b)
    assert (runner.STRIPED_MIN_SW, banded_kernel.RING_MAX_WORDS) == saved


def test_shrink_finds_a_small_reproducer():
    def wrong(a, b):
        cost = oracle.levenshtein(a, b)
        return (cost + 1 if b"T" in a else cost), None

    with pytest.raises(AssertionError):
        fuzz.check(wrong, b"ACGTACGT", b"ACGAACGA")
    a, b = fuzz.shrink(wrong, b"ACGTACGT", b"ACGAACGA")
    assert a == b"T" and b == b""
