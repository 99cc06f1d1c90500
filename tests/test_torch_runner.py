"""The port's BatchAligner against the reference BatchAligner on the CPU:
identical costs and ladder statistics, verified CIGARs and the streaming
iterators (the mesh: ``test_torch_mesh.py``)."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _mixed_lengths():
    rng = np.random.default_rng(3)
    pairs = [
        generate.uniform_seeded(int(rng.integers(1, 500)),
                                float(rng.uniform(0, 0.3)), 1000 + s)
        for s in range(12)
    ]
    # A skewed pair (full-height singleton bucket) and trivial pairs.
    return pairs + [(b"ACG", b"ACGT" * 40), (b"", b""), (b"ACGT", b""), (b"", b"ACGT")]


def _extreme_skew():
    return [
        (b"ACGTACGTACGT", generate.uniform_seeded(1000, 0.0, 5)[0]),
        (b"A" * 3, b"ACGT" * 300),
        (b"ACGT" * 300, b"A" * 3),
    ]


def _ladder_clamp():
    a, _ = generate.uniform_seeded(600, 0.0, 9)
    return [(a, a[::-1])]


def _single_chars():
    return [(b"A", b"A"), (b"A", b"C"), (b"AC", b"A")]


COST_CASES = {
    "mixed_lengths": (_mixed_lengths, dict(band_words=4)),
    "extreme_skew": (_extreme_skew, dict(band_words=4)),
    "ladder_clamp": (_ladder_clamp, dict(band_words=2, max_band_doublings=1)),
    "single_chars": (_single_chars, dict(band_words=2)),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_with_stats_matches_reference(case):
    make, kw = COST_CASES[case]
    pairs = make()
    ref_costs, ref_stats = RefAligner(lane_multiple=8, domain_mode="off",
                                      **kw).cost_with_stats(pairs)
    costs, stats = BatchAligner(device="cpu", lane_multiple=8, domain_mode="off",
                                **kw).cost_with_stats(pairs)
    assert list(costs) == list(ref_costs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    for f in ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert stats.kernel == "torch-ref"


def _align_pairs():
    return [
        generate.generate_model(
            100 + (s * 53) % 200, [0.0, 0.05, 0.25][s % 3],
            list(generate.ErrorModel)[s % 4], 70 + s,
        )
        for s in range(6)
    ] + [(b"ACGT" * 30, b"")]


@needs_native
@pytest.mark.parametrize("make", [_align_pairs, _single_chars])
def test_align_with_stats_matches_reference(make):
    pairs = make()
    ref = RefAligner(band_words=4, lane_multiple=128, pallas_interpret=True,
                     domain_mode="off")
    ref_res, ref_stats = ref.align_with_stats(pairs)
    ba = BatchAligner(band_words=4, device="cpu", domain_mode="off")
    res, stats = ba.align_with_stats(pairs)
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    for f in ("pairs", "buckets", "band_retries", "cells_computed", "direct_traces"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    for (a, b), (c, cig) in zip(pairs, res):
        assert cig.verify(a, b) == c == oracle.levenshtein(a, b)


def _stream(k_batches, n0, e, seed):
    return [
        [generate.uniform_seeded(n0 + 11 * s + 40 * k, e, seed * k + s)
         for s in range(3)]
        for k in range(k_batches)
    ]


def test_cost_iter_in_order_and_equal_to_cost():
    batches = _stream(3, 180, 0.12, 77)
    batches[1].append((b"", b"ACGT"))
    ba = BatchAligner(band_words=2, device="cpu", domain_mode="off")
    got = list(ba.cost_iter(iter(batches)))
    assert len(got) == 3
    ba2 = BatchAligner(band_words=2, device="cpu", domain_mode="off")
    for pairs, (costs, stats) in zip(batches, got):
        assert stats.pairs == len(pairs)
        assert [int(c) for c in costs] == [oracle.levenshtein(a, b) for a, b in pairs]
        assert list(ba2.cost(pairs)) == list(costs)


@needs_native
def test_align_iter_in_order_and_equal_to_align():
    batches = _stream(4, 200, 0.08, 100)
    ba = BatchAligner(band_words=8, device="cpu", domain_mode="off")
    got = list(ba.align_iter(iter(batches)))
    assert len(got) == 4
    ba2 = BatchAligner(band_words=8, device="cpu", domain_mode="off")
    for pairs, (res, stats) in zip(batches, got):
        assert stats.pairs == len(pairs) and stats.direct_traces == len(pairs)
        assert [c for c, _ in res] == [c for c, _ in ba2.align(pairs)]
        for (a, b), (c, cig) in zip(pairs, res):
            assert cig.verify(a, b) == c == oracle.levenshtein(a, b)
