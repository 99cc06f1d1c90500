"""The port's align path beyond direct traces: checkpoint rungs (kernel
K2's CPU route) against the reference BatchAligner, full-height rungs past
the direct-trace budget, the thread-pooled trace flush over mixed jobs, the
gcsh prefetch consumed by the streams, and no JAX on the way."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _assert_exact(pairs, results):
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cigar.verify(a, b) == cost == oracle.levenshtein(a, b)


def test_ck_rungs_match_reference():
    """test_banded.py::test_align_combined_ck_interpret on the port."""
    pairs = [
        generate.uniform_seeded(150 + (s * 41) % 80, [0.02, 0.12][s % 2], 40 + s)
        for s in range(24)
    ]
    kw = dict(band_words=4, domain_mode="off", direct_dt=False)
    ref_res, ref_stats = RefAligner(lane_multiple=128, pallas_interpret=True,
                                    **kw).align_with_stats(pairs)
    res, stats = BatchAligner(device="cpu", **kw).align_with_stats(pairs)
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    for f in ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp",
              "direct_traces"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert stats.direct_traces == 0
    _assert_exact(pairs, res)


def test_skewed_pair_past_the_direct_budget_is_exact():
    """A full-height rung certifies costs up to n+m > DIRECT_DT_MAX, so the
    align path takes the checkpoint kernel at full height (S = 525 words)."""
    pairs = [(b"ACG", b"ACGT" * 4200)]
    assert 3 + 4 * 4200 > native.DIRECT_DT_MAX
    res, stats = BatchAligner(device="cpu").align_with_stats(pairs)
    _assert_exact(pairs, res)
    assert stats.direct_traces == 0 and stats.buckets == 1


def test_flush_traces_fills_every_result_from_mixed_jobs():
    """One staged list holding direct jobs on a shared rung schedule, direct
    jobs on per-pair domain schedules and checkpoint jobs: the pooled flush
    fills every result, exact and verified."""
    small = [generate.uniform_seeded(150 + 10 * s, 0.05, 60 + s) for s in range(5)]
    big = [generate.uniform_seeded(420 + 23 * s, 0.1, 70 + s) for s in range(3)]
    pairs = small + big + [(b"ACG", b"ACGT" * 4200), (b"", b"AC")]
    ba = BatchAligner(band_words=8, device="cpu", domain_mode="gap", domain_min_bp=400)
    results, stats, jobs = ba._align_dispatch_finish(ba._align_dispatch_start(pairs))
    direct = [j for j in jobs if j.slices is None]
    shared = {id(j.shift) for j in direct if j.pair < len(small)}
    per_pair = {id(j.shift) for j in direct if j.pair >= len(small)}
    assert len(shared) == 1 and len(per_pair) == len(big)
    assert [j.pair for j in jobs if j.slices is not None] == [len(small) + len(big)]
    assert sum(r is None for r in results) == len(jobs) == len(pairs) - 1
    ba._flush_traces(jobs, pairs, results)
    assert not jobs
    _assert_exact(pairs, results)


def test_gcsh_prefetch_consumed_by_streams():
    """test_banded.py::test_gcsh_prefetch_streaming on the port: the builds
    each stream starts at dispatch are popped by the ladders."""
    batches = [
        [generate.generate_model(600 + 67 * s + 31 * k, 0.1,
                                 generate.ErrorModel.UNIFORM, 10 * k + s)
         for s in range(3)]
        for k in range(3)
    ]
    ba = BatchAligner(band_words=4, device="cpu", domain_mode="gcsh",
                      domain_min_bp=0, domain_k=10, domain_r=2)
    prefetched = []
    submit = ba._prefetch_domains

    def spy(pairs, want_cigars):
        submit(pairs, want_cigars)
        prefetched.append(len(ba._domain_prefetch))

    ba._prefetch_domains = spy
    got = list(ba.cost_iter(iter(batches)))
    assert len(got) == 3 and min(prefetched) >= 1
    for pairs, (costs, _) in zip(batches, got):
        assert [int(c) for c in costs] == [oracle.levenshtein(a, b) for a, b in pairs]
    assert not ba._domain_prefetch, "prefetched futures must be consumed"
    prefetched.clear()
    got = list(ba.align_iter(iter(batches)))
    assert len(got) == 3 and min(prefetched) >= 1
    for pairs, (res, _) in zip(batches, got):
        _assert_exact(pairs, res)
    assert not ba._domain_prefetch


def test_domain_and_ck_paths_never_import_jax():
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        import astarpa_tpu_torch as att
        pairs = [att.generate.uniform_seeded(300 + 45 * s, 0.1, s) for s in range(3)]
        for mode in ("gap", "gcsh", "off"):
            ba = att.BatchAligner(device="cpu", domain_mode=mode, domain_min_bp=0)
            costs = ba.cost(pairs)
            for direct_dt in (True, False):
                ba.direct_dt = direct_dt
                for (a, b), c, (c2, cig) in zip(pairs, costs, ba.align(pairs)):
                    assert c == c2 == cig.verify(a, b) == att.oracle.levenshtein(a, b)
        jax_mods = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
        assert not jax_mods, jax_mods
        print("ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
