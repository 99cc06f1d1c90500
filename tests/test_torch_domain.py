"""The port's per-pair domain ladder against the reference BatchAligner on
the CPU: identical costs and ``BatchStats`` (all but ``kernel``) on the
inputs of ``tests/test_banded.py``, verified CIGARs from direct and
checkpoint traces, and stragglers finishing on the shared ladder."""

import os

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner

torch.set_num_threads(1)

STATS = ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp",
         "direct_traces")

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _assert_stats_equal(stats, ref_stats):
    for f in STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f


def _assert_exact(pairs, results):
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cigar.verify(a, b) == cost == oracle.levenshtein(a, b)


def _gap_pairs():
    """test_banded.py::test_domain_ladder_gap_mode."""
    return [
        generate.generate_model(700 + 37 * s, [0.04, 0.15][s % 2],
                                list(generate.ErrorModel)[s % 4], 300 + s)
        for s in range(6)
    ] + [(b"ACGT" * 120, b"ACGT" * 250)]  # heavy length skew


def _gcsh_pairs():
    """test_banded.py::test_domain_ladder_gcsh_mode."""
    return [generate.generate_model(1000 + 61 * s, 0.1, generate.ErrorModel.UNIFORM, s)
            for s in range(4)]


def _ck_domain_pairs(seed0):
    """test_banded.py::test_align_domain_ladder_{ck,direct}_interpret."""
    return [
        generate.generate_model(500 + 67 * s, [0.05, 0.15][s % 2],
                                list(generate.ErrorModel)[s % 4], seed0 + s)
        for s in range(6)
    ]


COST_CASES = {
    "gap": (_gap_pairs, dict(domain_mode="gap")),
    "gcsh": (_gcsh_pairs, dict(domain_mode="gcsh", domain_k=10, domain_r=2)),
    "gap_one_round": (_gap_pairs, dict(domain_mode="gap", max_f_rounds=1)),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_domain_cost_matches_reference(case):
    make, kw = COST_CASES[case]
    if kw["domain_mode"] == "gcsh" and not native.available():
        pytest.skip("native toolchain unavailable")
    pairs = make()
    kw = dict(band_words=4, lane_multiple=8, domain_min_bp=0, **kw)
    ref_costs, ref_stats = RefAligner(**kw).cost_with_stats(pairs)
    costs, stats = BatchAligner(device="cpu", **kw).cost_with_stats(pairs)
    assert list(costs) == list(ref_costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    _assert_stats_equal(stats, ref_stats)
    assert stats.kernel == "torch-ref"
    if kw.get("max_f_rounds") == 1:
        # The stragglers of the one round finished on the shared ladder.
        assert stats.band_retries > 0


ALIGN_CASES = {
    "ck_rounds": (lambda: _ck_domain_pairs(900), dict(direct_dt=False)),
    "direct_rounds": (lambda: _ck_domain_pairs(950), dict()),
    "stragglers": (lambda: _ck_domain_pairs(900), dict(direct_dt=False, max_f_rounds=1)),
}


@needs_native
@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_domain_align_matches_reference(case):
    make, kw = ALIGN_CASES[case]
    pairs = make()
    kw = dict(band_words=4, domain_mode="gap", domain_min_bp=0, **kw)
    ref_res, ref_stats = RefAligner(lane_multiple=128, pallas_interpret=True,
                                    **kw).align_with_stats(pairs)
    res, stats = BatchAligner(device="cpu", **kw).align_with_stats(pairs)
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    _assert_stats_equal(stats, ref_stats)
    _assert_exact(pairs, res)
    if kw.get("direct_dt", True):
        assert stats.direct_traces > 0
    else:
        assert stats.direct_traces == 0


def test_auto_mode_resolution():
    ba = BatchAligner(device="cpu")
    big = [(b"A" * 40_000, b"A" * 40_000)]
    want = "gcsh" if native.available() and (os.cpu_count() or 1) >= 8 else None
    assert ba._resolve_domain_mode(big, [0], want_cigars=False) == want
    assert ba._resolve_domain_mode([(b"A" * 100, b"A" * 100)], [0], False) is None
    assert BatchAligner(device="cpu", domain_mode="gap")._resolve_domain_mode(
        big, [0], want_cigars=True) == ("gap" if native.available() else None)


def test_gap_provider_matches_reference():
    from astarpa_tpu.parallel.runner import _GapDomainProvider as RefGap
    from astarpa_tpu_torch.parallel.runner import _GapDomainProvider

    for n, m in ((700, 760), (1000, 300), (1, 40)):
        ours, ref = _GapDomainProvider(b"A" * n, b"C" * m), RefGap(b"A" * n, b"C" * m)
        assert ours.h0 == ref.h0
        for f in (64, 500):
            a, b = ours.sample(f), ref.sample(f)
            assert np.array_equal(a.lo, b.lo) and np.array_equal(a.hi, b.hi)
            assert a.empty == b.empty
