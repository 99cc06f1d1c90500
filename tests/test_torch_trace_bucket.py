"""The port's cost-then-trace align route (``BatchAligner(combined=False)``:
the cost ladder, then ``_trace_bucket``'s direct, host and fill arms, and
``_align_host_fallback`` without the native library) against the JAX
package's ``BatchAligner``, which takes exactly this route on the CPU.
Tolerance: none — equal costs, identical CIGAR strings and equal
``BatchStats`` fields."""

import pytest
import torch

import astarpa_tpu.native as jnative
from astarpa_tpu import generate, oracle
from astarpa_tpu.parallel.runner import BatchAligner as JBatchAligner
from astarpa_tpu_torch import native
from astarpa_tpu_torch.aligners import astarpa2
from astarpa_tpu_torch.parallel import runner
from astarpa_tpu_torch.parallel.runner import BatchAligner

from test_banded import _mixed_pairs

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)

FIELDS = ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp",
          "direct_traces")


def _same(got, want):
    (res, st), (jres, jst) = got, want
    assert [c for c, _ in res] == [c for c, _ in jres]
    assert [c.to_string() for _, c in res] == [c.to_string() for _, c in jres]
    for f in FIELDS:
        assert getattr(st, f) == getattr(jst, f), f


def _spy(monkeypatch, obj, name, calls):
    fn = getattr(obj, name)

    def spy(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(obj, name, spy)


@needs_native
@pytest.mark.parametrize("direct_dt", [True, False], ids=["direct", "fill"])
def test_trace_route_matches_reference(monkeypatch, direct_dt):
    """``tests/test_banded.py:336-352``'s pairs: the direct arm traces them
    all with ``direct_dt``; without it every bucket runs the fill arm (K3's
    plain version, then ``native.trace_banded``)."""
    pairs = _mixed_pairs(40, count=6) + [(b"", b"ACGT"), (b"ACG", b"")]
    calls = []
    _spy(monkeypatch, runner, "banded_fill", calls)
    got = BatchAligner(band_words=8, lane_multiple=8, direct_dt=direct_dt,
                       device="cpu", combined=False).align_with_stats(pairs)
    want = JBatchAligner(band_words=8, lane_multiple=8,
                         direct_dt=direct_dt).align_with_stats(pairs)
    _same(got, want)
    assert bool(calls) != direct_dt
    assert got[1].kernel == "torch-ref"
    for (a, b), (c, cig) in zip(pairs, got[0]):
        assert c == oracle.levenshtein(a, b) == cig.verify(a, b)


@needs_native
def test_host_arm_runs_astar_and_the_block_aligner(monkeypatch):
    """A start band of 128 words (> 64) sends both pairs to the host arm:
    the low-divergence pair (cost * 12 < n) to native A*, the other to the
    block aligner with its native block DP."""
    pairs = [generate.generate_model(4300, 0.02, generate.ErrorModel.UNIFORM, 11),
             generate.generate_model(4200, 0.2, generate.ErrorModel.UNIFORM, 12)]
    calls = []
    _spy(monkeypatch, runner.native, "astarpa_native", calls)
    _spy(monkeypatch, astarpa2.AstarPa2, "align", calls)
    _spy(monkeypatch, runner, "banded_fill", calls)
    kw = dict(band_words=128, lane_multiple=8, direct_dt=False)
    got = BatchAligner(device="cpu", combined=False, **kw).align_with_stats(pairs)
    _same(got, JBatchAligner(**kw).align_with_stats(pairs))
    assert calls == ["astarpa_native", "align"]


@pytest.mark.parametrize("combined", [True, False])
def test_host_fallback_without_native(monkeypatch, combined):
    """Without the native library ``align`` no longer raises: both routes
    run the cost ladder and then the block aligner on every pair, its block
    DP in torch on the aligner's device, as the reference's runs in jnp."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    pairs = _mixed_pairs(70, count=3) + [(b"", b"ACGT"), (b"ACGTTA", b"")]
    pairs = [(a[:300], b[:300]) for a, b in pairs]
    calls = []
    _spy(monkeypatch, BatchAligner, "_align_host_fallback", calls)
    ba = BatchAligner(band_words=8, lane_multiple=8, device="cpu", combined=combined)
    got = ba.align_with_stats(pairs)
    _same(got, JBatchAligner(band_words=8, lane_multiple=8).align_with_stats(pairs))
    assert calls == ["_align_host_fallback"]
    streamed = list(ba.align_iter([pairs[:2], pairs[2:]]))
    assert [c.to_string() for r, _ in streamed for _, c in r] == \
        [c.to_string() for _, c in got[0]]


@needs_native
def test_align_iter_without_combined_runs_batch_by_batch(monkeypatch):
    batches = [_mixed_pairs(90 + k, count=3) for k in range(3)]
    ba = BatchAligner(band_words=8, lane_multiple=8, direct_dt=False, device="cpu",
                      combined=False)
    calls = []
    _spy(monkeypatch, BatchAligner, "_trace_bucket", calls)
    got = list(ba.align_iter(batches))
    assert len(got) == 3 and calls
    jba = JBatchAligner(band_words=8, lane_multiple=8, direct_dt=False)
    for g, batch in zip(got, batches):
        _same(g, jba.align_with_stats(batch))
    assert not any(c is None for r, _ in got for c in r)


@needs_native
def test_trace_disagreeing_with_the_certified_cost_raises(monkeypatch):
    fn = native.trace_banded
    monkeypatch.setattr(native, "trace_banded",
                        lambda *a, **kw: (fn(*a, **kw)[0] + 1, fn(*a, **kw)[1]))
    ba = BatchAligner(band_words=8, lane_multiple=8, direct_dt=False, device="cpu",
                      combined=False)
    with pytest.raises(RuntimeError, match="trace cost"):
        ba.align(_mixed_pairs(40, count=2))


@needs_native
def test_combined_default_keeps_the_align_rungs(monkeypatch):
    """``combined=True`` (the default) never reaches ``_trace_bucket``."""
    calls = []
    _spy(monkeypatch, BatchAligner, "_trace_bucket", calls)
    ba = BatchAligner(band_words=8, lane_multiple=8, device="cpu")
    assert ba.combined
    pairs = _mixed_pairs(40, count=3)
    res, st = ba.align_with_stats(pairs)
    assert not calls and st.direct_traces == 3
    assert [c for c, _ in res] == [oracle.levenshtein(a, b) for a, b in pairs]
