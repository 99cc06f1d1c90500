"""Card tests of the port: the CUDA kernel against its plain torch version,
and the runner on the GPU against the runner on the CPU.  They skip without
a CUDA device.  This file imports no JAX, so a GPU host without it runs
them with the suite's conftest (which configures JAX) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, oracle
from astarpa_tpu_torch import BatchAligner
from astarpa_tpu_torch.ops import banded, banded_kernel
from astarpa_tpu_torch.ops.pack import pack_batch_staggered

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _random_pairs(seed, count, n_hi, m_hi):
    rng = np.random.default_rng(seed)

    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [(seq(int(rng.integers(1, n_hi))), seq(int(rng.integers(1, m_hi))))
             for _ in range(count)]
    return pairs + [(b"", seq(40))]  # an n == 0 lane


@pytest.mark.parametrize("count", [0, 32, 77])
def test_kernel_matches_plain(gpu, count):
    pairs = _random_pairs(count, count, 300, 1300)
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    S = args[2].shape[0]
    before = banded_kernel.LAUNCHES
    for sw in (1, 5, 32, 33, S):
        for diag in (None, (args[0].shape[0], S * 32 - 40)):
            got = banded_kernel.banded_cost(*args, sw, diag)
            want = banded.banded_cost_ref(*args, sw, diag)
            assert torch.equal(got, want), (sw, diag)
    assert banded_kernel.LAUNCHES == before + 10


def _mixed():
    pairs = [generate.uniform_seeded(60 + 37 * s, [0.0, 0.05, 0.2][s % 3], 300 + s)
             for s in range(12)]
    return pairs + [(b"ACG", b"ACGT" * 40), (b"", b"AC"), (b"A", b"A")]


def test_runner_on_gpu_matches_cpu(gpu):
    pairs = _mixed()
    costs, stats = BatchAligner(band_words=4, device=gpu).cost_with_stats(pairs)
    ref, ref_stats = BatchAligner(band_words=4, device="cpu").cost_with_stats(pairs)
    assert list(costs) == list(ref) == [oracle.levenshtein(a, b) for a, b in pairs]
    for f in ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert (stats.kernel, ref_stats.kernel) == ("cuda-banded", "torch-ref")
    res, astats = BatchAligner(band_words=4, device=gpu).align_with_stats(pairs)
    assert [c for c, _ in res] == list(ref)
    assert astats.direct_traces == len(pairs) - 1  # the empty pair is trivial
    for (a, b), (c, cig) in zip(pairs, res):
        assert cig.verify(a, b) == c


def test_streams_on_gpu(gpu):
    batches = [[generate.uniform_seeded(150 + 20 * s + 30 * k, 0.08, 10 * k + s)
                for s in range(5)] for k in range(4)]
    ba = BatchAligner(band_words=2, device=gpu)
    for pairs, (costs, _) in zip(batches, ba.cost_iter(iter(batches))):
        assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    for pairs, (res, _) in zip(batches, ba.align_iter(iter(batches))):
        for (a, b), (c, cig) in zip(pairs, res):
            assert cig.verify(a, b) == c == oracle.levenshtein(a, b)
