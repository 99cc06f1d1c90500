"""The port's ``BatchAligner(mesh=...)`` against the reference's mesh on the
CPU: an 8-way mesh of ``"cpu"`` shards (the port's stand-in for the
reference's 8 virtual CPU devices, ``tests/conftest.py``) gives the same
costs, ``BatchStats`` counters and verified CIGARs as the reference's
8-device mesh and as the unsharded port, on the shared ladder, the
checkpoint rungs, a big-band rung and the gap domain ladder; a mesh of one
device gives exactly what ``mesh=None`` gives; and a bad mesh raises.

The reference's ``_mesh_ck_kind`` routing (``tests/test_banded.py::
test_mesh_ck_kind_routing_table``) has no counterpart: it gates on TPU VMEM,
and the port routes a shard as it routes a whole batch."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner
from astarpa_tpu_torch.ops import banded_kernel
from astarpa_tpu_torch.parallel import runner
from astarpa_tpu_torch.parallel.dryrun import dryrun_multichip
from test_banded import _mixed_pairs

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)

STATS = ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp", "direct_traces")
CPU8 = ["cpu"] * 8


def _ref_mesh(n: int = 8) -> Mesh:
    return Mesh(np.array(jax.devices("cpu")[:n]), axis_names=("batch",))


def _same_stats(got, want, fields=STATS):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


def _verified(pairs, results):
    for (a, b), (c, cig) in zip(pairs, results):
        assert cig.verify(a, b) == c == oracle.levenshtein(a, b)


def test_mesh_costs_match_reference():
    """``tests/test_banded.py::test_batch_aligner_mesh``'s pairs and
    settings: the shared ladder over 8 shards."""
    pairs = _mixed_pairs(21, count=16)
    ref_costs, ref_stats = RefAligner(band_words=8, lane_multiple=8,
                                      mesh=_ref_mesh()).cost_with_stats(pairs)
    costs, stats = BatchAligner(band_words=8, lane_multiple=8, mesh=CPU8).cost_with_stats(pairs)
    one_costs, one_stats = BatchAligner(band_words=8, lane_multiple=8,
                                        device="cpu").cost_with_stats(pairs)
    assert list(costs) == list(ref_costs) == list(one_costs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    _same_stats(stats, ref_stats)
    _same_stats(stats, one_stats)
    assert stats.kernel == "torch-ref"


def _ck_pairs():
    return [generate.uniform_seeded(40 + s % 17, [0.0, 0.1, 0.3][s % 3], 800 + s)
            for s in range(48)]


@needs_native
def test_mesh_ck_cigars_match_reference():
    """``tests/test_banded.py::test_batch_aligner_mesh_ck_cigars``'s pairs
    with ``direct_dt=False``, the reference run plainly (its cost ladder
    over the mesh, then its trace route): the port's same route over 8
    shards gives its costs and counters; the port's checkpoint rungs over
    8 shards give the unsharded port's."""
    pairs = _ck_pairs()
    kw = dict(band_words=4, domain_mode="off", direct_dt=False)
    ref_res, ref_stats = RefAligner(lane_multiple=128, mesh=_ref_mesh(),
                                    **kw).align_with_stats(pairs)
    res, stats = BatchAligner(lane_multiple=8, mesh=CPU8, combined=False,
                              **kw).align_with_stats(pairs)
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    _same_stats(stats, ref_stats)
    _verified(pairs, res)
    ck_res, ck_stats = BatchAligner(lane_multiple=8, mesh=CPU8, **kw).align_with_stats(pairs)
    one_res, one_stats = BatchAligner(lane_multiple=8, device="cpu",
                                      **kw).align_with_stats(pairs)
    assert [c for c, _ in ck_res] == [c for c, _ in one_res] == [c for c, _ in res]
    _same_stats(ck_stats, one_stats)
    assert ck_stats.direct_traces == 0
    _verified(pairs, ck_res)


@needs_native
def test_mesh_direct_traces_count():
    """The default align path over 8 shards: every pair traced directly
    from the sharded cost rungs, as the unsharded port."""
    pairs = _ck_pairs()[:20]
    res, stats = BatchAligner(band_words=4, lane_multiple=8, mesh=CPU8,
                              domain_mode="off").align_with_stats(pairs)
    _, one_stats = BatchAligner(band_words=4, lane_multiple=8, device="cpu",
                                domain_mode="off").align_with_stats(pairs)
    _same_stats(stats, one_stats)
    assert stats.direct_traces == len(pairs)
    _verified(pairs, res)


@needs_native
def test_mesh_gap_domain_ladder_matches_reference():
    """A cut of ``tests/test_banded.py::test_batch_aligner_mesh_domain_
    ladder_ck``: per-pair schedules split with their pairs; costs and
    counters equal the reference's sharded per-pair ladder (interpret
    mode) and the unsharded port's, every CIGAR verified."""
    pairs = [generate.uniform_seeded(350 + 41 * s, [0.04, 0.12][s % 2], 850 + s)
             for s in range(4)]
    kw = dict(band_words=4, domain_mode="gap", domain_min_bp=0, direct_dt=False)
    ref_res, ref_stats = RefAligner(lane_multiple=128, mesh=_ref_mesh(), pallas_interpret=True,
                                    **kw).align_with_stats(pairs)
    assert ref_stats.kernel in ("pallas-ck-perpair-sharded", "pallas-ck-sharded")
    seen = []
    orig = runner.BatchAligner._domain_kernel

    def spy(self, packed, *rest):
        seen.append(len(packed.shards))
        return orig(self, packed, *rest)

    runner.BatchAligner._domain_kernel = spy
    try:
        res, stats = BatchAligner(lane_multiple=4, mesh=CPU8, **kw).align_with_stats(pairs)
    finally:
        runner.BatchAligner._domain_kernel = orig
    assert seen and set(seen) == {8}
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    _same_stats(stats, ref_stats)
    _verified(pairs, res)
    one_res, one_stats = BatchAligner(lane_multiple=4, device="cpu", **kw).align_with_stats(pairs)
    assert [cig.to_string() for _, cig in res] == [cig.to_string() for _, cig in one_res]
    _same_stats(stats, one_stats)


@needs_native
@pytest.mark.parametrize("doublings", [8, 0], ids=["ring_k6", "full_height_k8"])
def test_mesh_big_band_ck_rungs(monkeypatch, doublings):
    """Big-band checkpoint rungs on every shard (``STRIPED_MIN_SW``
    lowered): K6 at SW 8, K8 at a full height off the 8-grain; costs,
    counters and CIGAR strings equal the unsharded port's, and the costs
    the reference's."""
    monkeypatch.setattr(runner, "STRIPED_MIN_SW", 8)
    pairs = [generate.uniform_seeded(260 + 17 * s, 0.06, 90 + s) for s in range(4)]
    kw = dict(band_words=8, lane_multiple=4, domain_mode="off", direct_dt=False,
              max_band_doublings=doublings)
    calls = []
    for name in ("striped_ck", "pinned_ck", "banded_ck"):
        def spy(*args, _fn=getattr(runner, name), _name=name):
            calls.append((_name, args[0].shape[1]))
            return _fn(*args)
        monkeypatch.setattr(runner, name, spy)
    res, stats = BatchAligner(mesh=CPU8, **kw).align_with_stats(pairs)
    want = "striped_ck" if doublings else "pinned_ck"
    assert (want, 4) in calls and len([c for c in calls if c[0] == want]) % 8 == 0, calls
    one_res, one_stats = BatchAligner(device="cpu", **kw).align_with_stats(pairs)
    assert [cig.to_string() for _, cig in res] == [cig.to_string() for _, cig in one_res]
    _same_stats(stats, one_stats)
    _verified(pairs, res)
    ref_costs = RefAligner(band_words=8, lane_multiple=8, domain_mode="off",
                           max_band_doublings=doublings, mesh=_ref_mesh()).cost(pairs)
    assert [c for c, _ in res] == list(ref_costs)


def test_mesh_bucket_not_a_multiple_of_the_shards():
    """13 pairs over 3 shards: padded so every shard gets the same whole
    number of lane groups; costs and counters as the reference's 3-device
    mesh and the unsharded port."""
    pairs = [generate.uniform_seeded(60 + 23 * s, [0.0, 0.05, 0.2][s % 3], 40 + s)
             for s in range(13)]
    ref_costs, ref_stats = RefAligner(band_words=4, lane_multiple=4,
                                      mesh=_ref_mesh(3)).cost_with_stats(pairs)
    ba = BatchAligner(band_words=4, lane_multiple=4, mesh=["cpu"] * 3)
    packed, B0 = ba._pack(pairs)
    assert B0 == 13 and packed.B == 24
    assert [(s.lo, s.hi) for s in packed.shards] == [(0, 8), (8, 16), (16, 24)]
    assert list(packed.n[13:]) == list(packed.m[13:]) == [1] * 11
    costs, stats = ba.cost_with_stats(pairs)
    assert list(costs) == list(ref_costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    _same_stats(stats, ref_stats)


def _ring_straddling_pairs():
    """Two pairs of one bucket, at full height over 4375 words: alone, the
    first (4000 columns, so 4000 live words) fits K7's 4096-word ring and
    the second (4500 columns) needs the wide ring."""
    return [(generate.uniform_seeded(n, 0.0, s)[0], generate.uniform_seeded(m, 0.1, s + 1)[0])
            for n, m, s in ((4000, 120_000, 1), (4500, 140_000, 3))]


def test_mesh_shards_run_the_buckets_cost_ring(monkeypatch):
    """A cost rung's shards run the ring design of the whole bucket, not
    each the one its own pairs would pick, so ``BatchStats.kernel`` names
    what ran on every shard: here the wide ring (16 slots a thread) on
    both, though the first shard's pair alone fits K7."""
    pairs = _ring_straddling_pairs()
    kw = dict(band_words=8, lane_multiple=1, max_band_doublings=0, domain_mode="off")
    ba = BatchAligner(mesh=["cpu"] * 2, **kw)
    packed, _ = ba._pack(pairs)
    assert [(s.lo, s.hi) for s in packed.shards] == [(0, 1), (1, 2)]
    S = packed.S
    assert banded_kernel.pinned_cost_kernel(packed.n_max, S, S, None, packed.n) == "ring_cost_wide"
    assert banded_kernel.pinned_cost_kernel(packed.n_max, S, S, None, packed.n[:1]) == "pinned_cost"
    seen = []

    def spy(*args):
        seen.append((int(args[4].max()), args[9]))
        return banded_kernel.pinned_cost(*args)

    monkeypatch.setattr(runner, "pinned_cost", spy)
    costs, stats = ba.cost_with_stats(pairs)
    assert seen == [(4000, 16), (4500, 16)]
    seen.clear()
    want, want_st = BatchAligner(device="cpu", **kw).cost_with_stats(pairs)
    assert seen == [(4500, 16)]
    assert list(costs) == list(want)
    assert stats == want_st


@needs_native
def test_one_device_mesh_is_mesh_none():
    pairs = _ck_pairs()[:12] + [(b"ACGT", b""), (b"A", b"ACGTACGT" * 30)]
    kw = dict(band_words=4, lane_multiple=8, domain_mode="off")
    for call in ("cost_with_stats", "align_with_stats"):
        got, st = getattr(BatchAligner(mesh=["cpu"], **kw), call)(pairs)
        want, want_st = getattr(BatchAligner(device="cpu", **kw), call)(pairs)
        if call == "cost_with_stats":
            assert list(got) == list(want)
        else:
            assert [(c, g.to_string()) for c, g in got] == [(c, g.to_string()) for c, g in want]
        assert st == want_st


def _stream(k_batches):
    return [[generate.uniform_seeded(150 + 11 * s + 40 * k, 0.1, 7 * k + s) for s in range(5)]
            for k in range(k_batches)]


def test_mesh_cost_iter():
    batches = _stream(3)
    batches[1].append((b"", b"ACGT"))
    got = list(BatchAligner(band_words=2, mesh=["cpu"] * 4, domain_mode="off").cost_iter(
        iter(batches)))
    one = list(BatchAligner(band_words=2, device="cpu", domain_mode="off").cost_iter(
        iter(batches)))
    assert len(got) == len(one) == 3
    for pairs, (costs, stats), (want, want_st) in zip(batches, got, one):
        assert list(costs) == list(want) == [oracle.levenshtein(a, b) for a, b in pairs]
        _same_stats(stats, want_st)


@needs_native
def test_mesh_align_iter():
    batches = _stream(4)
    got = list(BatchAligner(band_words=8, mesh=["cpu"] * 4, domain_mode="off",
                            direct_dt=False).align_iter(iter(batches)))
    one = list(BatchAligner(band_words=8, device="cpu", domain_mode="off",
                            direct_dt=False).align_iter(iter(batches)))
    assert len(got) == len(one) == 4
    for pairs, (res, stats), (want, want_st) in zip(batches, got, one):
        assert [c for c, _ in res] == [c for c, _ in want]
        _same_stats(stats, want_st)
        _verified(pairs, res)


@pytest.mark.parametrize("mesh, device", [
    (["cpu", "cuda:0"], None),
    (["cuda:0", "cpu"], None),
    ([], None),
    ((), None),
    (object(), None),
    (["cpu", "meta"], None),
    (["cpu", "cpu"], "cuda"),
    (["cpu"], "meta"),
], ids=["cpu_then_cuda", "cuda_then_cpu", "empty_list", "empty_tuple", "not_a_sequence",
        "meta_device", "device_cuda_mesh_cpu", "device_meta"])
def test_mesh_validation_raises(mesh, device):
    """Mixed CPU and CUDA entries, an empty mesh, a non-sequence, another
    device type and a ``device`` that is not the mesh's first raise
    ``ValueError`` (before any CUDA device is asked for)."""
    with pytest.raises(ValueError):
        BatchAligner(mesh=mesh, device=device)


def test_mesh_device_defaults_to_its_first():
    ba = BatchAligner(mesh=("cpu", torch.device("cpu")))
    assert ba.device == torch.device("cpu")
    assert BatchAligner(mesh=["cpu"] * 2, device="cpu").device == torch.device("cpu")


def test_cuda_mesh_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchAligner(mesh=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="need 2 CUDA devices"):
        dryrun_multichip(2)


@needs_native
def test_dryrun_multichip_on_cpu_shards(capsys):
    """The port's twin of ``__graft_entry__.dryrun_multichip`` over 8 CPU
    shards: costs, the checkpoint and direct paths, the gap domain ladder
    and the big-band ck rungs (ring K6, ring K8, the stripe kernels)."""
    dryrun_multichip(8, devices=CPU8)
    assert "dryrun_multichip OK on 8 devices" in capsys.readouterr().out
