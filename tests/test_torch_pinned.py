"""The port's pinned per-pair big-band path: the plain versions of kernels
K9 and K10 against the JAX package's ``pinned_cost_pp_tpu`` and
``pinned_ck_pp_tpu`` in interpret mode (bit for bit on costs and every
readable checkpoint), against K4 and the oracle, through native traces,
and the runner's domain rounds on K9/K10 against the reference
``BatchAligner`` whose domain rounds run the same Pallas kernels.  The CUDA
kernels' own tests are in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.ops.pallas_myers import pack_batch_staggered as jpack
from astarpa_tpu.ops.pinned import pinned_ck_pp_tpu, pinned_cost_pp_tpu
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner, domain
from astarpa_tpu_torch.ops import banded, banded_kernel, pinned, striped, words
from astarpa_tpu_torch.parallel import runner

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)

STATS = ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp",
         "direct_traces")


def _packed(pairs):
    """Reference pack (B = 128) as numpy, and the same planes for the port."""
    args, B0 = jpack(pairs, lane_multiple=128)
    args = tuple(np.asarray(x) for x in args)
    return args, words.planes_from_numpy(*args, "cpu"), B0


@pytest.fixture(scope="module")
def mixed():
    """tests/test_pinned.py::test_pinned_perpair_vs_sliding_and_oracle's
    inputs."""
    pairs = [generate.uniform_seeded(500 + (s * 53) % 260, [0.03, 0.1, 0.22][s % 3], 40 + s)
             for s in range(128)]
    return pairs, _packed(pairs)


def _gap(args, sw):
    return banded.pair_gap_schedule(args[4], args[5], sw, args[0].shape[0],
                                    args[2].shape[0])


def _gcsh(pairs, args, scale):
    """Per-pair schedules from the native gcsh hulls at f = scale * h0, as
    the domain ladder samples them; idle lanes take pair 0's schedule."""
    n_max, B = args[0].shape
    sched = np.zeros((n_max, B), np.uint8)
    sw, quantum = 1, 32
    for slot, (a, b) in enumerate(pairs):
        h = native.DomainHandle(a, b, k=10, r=2)
        f = max(int(h.h0 * scale), 64)
        ps = domain.domain_schedule(h.sample(f, 64))
        while ps is None:
            f += max(f // 4, 64)
            ps = domain.domain_schedule(h.sample(f, 64))
        h.close()
        sched[: len(ps.sched), slot] = ps.sched
        sw, quantum = max(sw, ps.band_words), min(quantum, ps.quantum)
    sched[:, len(pairs):] = sched[:, :1]
    return sched, min(sw, args[2].shape[0]), quantum


def _schedule(case, pairs, args):
    if case == "gcsh":
        if not native.available():
            pytest.skip("native toolchain unavailable")
        return _gcsh(pairs, args, 1.25)
    sw = int(case.split()[1])
    return _gap(args, sw)[0], sw, banded.SCHEDULE_Q


@pytest.mark.parametrize("case", ["gap 8", "gap 24", "gcsh"])
def test_plain_k9_matches_pallas(mixed, case):
    pairs, (args, planes, _) = mixed
    sched, sw, q = _schedule(case, pairs, args)
    want = np.asarray(pinned_cost_pp_tpu(*args, band_words=sw, schedule=sched,
                                         time_block=128, interpret=True))
    got = banded_kernel.pinned_cost_pp(*planes, sched, sw, q)  # CPU route: plain
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case,cb", [("gap 8", 128), ("gap 24", 200), ("gcsh", 96)])
def test_plain_k10_matches_pallas(mixed, case, cb):
    """Costs, and every checkpoint a trace reads (``k*CB <= n``); the
    reference gets the interval rounded as the runner rounds it."""
    pairs, (args, planes, _) = mixed
    sched, sw, q = _schedule(case, pairs, args)
    n_max = args[0].shape[0]
    CB = banded.ck_col_block(cb, n_max, q)
    want = [np.asarray(x) for x in pinned_ck_pp_tpu(
        *args, band_words=sw, schedule=sched, col_block=CB, time_block=128,
        interpret=True)]
    got = banded_kernel.pinned_ck_pp(*planes, sched, sw, cb, q)
    assert got[1].shape == (-(-n_max // CB), sw, 128)
    assert np.array_equal(got[0].numpy(), want[0])
    n = args[4]
    checked = 0
    for k in range(got[1].shape[0]):
        live = n >= k * CB
        for g, w in zip(got[1:3], want[1:3]):
            assert np.array_equal(words.to_numpy_u32(g)[k][:, live], w[k][:, live]), k
        assert np.array_equal(got[3].numpy()[k][live], want[3][k][live]), k
        checked += int(live.any())
    assert checked >= 4


def test_plain_k9_bounded_by_k4_and_exact_where_certified(mixed):
    """tests/test_pinned.py:73-109 on the port: K9 <= K4 everywhere, and
    equal to the oracle wherever the gap schedule's threshold certifies
    K4's result; every pair is certified at one of the two bands."""
    pairs, (args, planes, B0) = mixed
    want = [oracle.levenshtein(a, b) for a, b in pairs]
    certified = np.zeros(B0, bool)
    for sw in (8, 24):
        sched, thr = _gap(args, sw)
        got = pinned.pinned_cost_pp_ref(*planes, sched, sw, 32).numpy()[:B0]
        k4 = banded.banded_cost_pp_ref(*planes, sched, sw, 32).numpy()[:B0]
        assert (got <= k4).all()
        ok = k4 <= thr[:B0]
        for p in np.flatnonzero(ok):
            assert got[p] == want[p], (sw, p)
        certified |= ok
    assert certified.all()


@pytest.mark.parametrize("sw", [8, 16])
def test_plain_k9_broadcast_schedule_equals_k5(mixed, sw):
    """Every pair on the bucket schedule reproduces the striped kernel's
    plain version (tests/test_pinned.py:112-133, where the reference's
    shared pinned kernel equals its striped one)."""
    _, (args, planes, _) = mixed
    n_max, B, S = args[0].shape[0], args[0].shape[1], args[2].shape[0]
    shift = banded.shift_at_array(n_max, S, sw)
    sched = np.broadcast_to(shift[:, None], (n_max, B))
    got = pinned.pinned_cost_pp_ref(*planes, sched, sw, 1)
    assert torch.equal(got, striped.striped_cost_ref(*planes, sw))


@pytest.mark.parametrize("threads", [32, 64])
def test_event_tables_of_a_broadcast_schedule_equal_k5s(mixed, threads):
    """The per-pair event tables the kernel reads, built by torch on the
    schedule's device (here the CPU), repeat the shared plan's table in
    every pair's rows when every pair has the bucket schedule."""
    _, (args, _, _) = mixed
    n_max, B, S = args[0].shape[0], args[0].shape[1], args[2].shape[0]
    sw = 12
    shift = banded.shift_at_array(n_max, S, sw)
    sched = np.ascontiguousarray(np.broadcast_to(shift[:, None], (n_max, B)))
    ev, stripe_t = banded_kernel.striped_events(striped.plan_striped(n_max, S, sw),
                                                n_max, threads)
    n_lim = torch.full((B,), n_max, dtype=torch.int32)
    plan, ev_pp, stripe_pp, nsp = banded_kernel.pinned_pp_events(
        sched, args[4], sw, threads, n_lim, "cpu")
    assert tuple(ev_pp.shape) == (B,) + ev.shape
    assert all(np.array_equal(x.numpy(), ev) for x in ev_pp)
    assert all(np.array_equal(x.numpy(), stripe_t) for x in stripe_pp)
    assert (nsp.numpy() == stripe_t.shape[0]).all()
    assert plan["T"] == striped.plan_striped(n_max, S, sw)["T"]


def test_schedule_and_interval_checks(mixed):
    _, (args, planes, _) = mixed
    n_max, B = args[0].shape
    sched = np.zeros((n_max, B), np.uint8)
    sched[32, 0] = 1
    banded_kernel.pinned_cost_pp(*planes, sched, 4, 32)
    bad = sched.copy()
    bad[0, 3] = 1
    with pytest.raises(ValueError, match="column 0"):
        banded_kernel.pinned_cost_pp(*planes, bad, 4, 1)
    bad = sched.copy()
    bad[33, 1] = 1
    with pytest.raises(ValueError, match="quantum 32"):
        banded_kernel.pinned_cost_pp(*planes, bad, 4, 32)
    with pytest.raises(ValueError, match="col_block"):
        banded_kernel.pinned_ck_pp(*planes, sched, 24, 16, 1)
    # The rounded interval, not the requested one, meets the band.
    with pytest.raises(ValueError, match="col_block"):
        banded_kernel.pinned_ck_pp(*planes, sched, 24, 30, 16)


@needs_native
def test_native_trace_from_plain_k10():
    """tests/test_pinned.py:236-271 on the port, shorter pairs: CIGARs
    from K10's plain checkpoints through the native trace equal the oracle
    and verify."""
    pairs = [generate.uniform_seeded(900 + 31 * s, [0.04, 0.1][s % 2], 30 + s)
             for s in range(12)]
    args, planes, B0 = _packed(pairs)
    sw, CB = 24, 256
    sched, thr = _gap(args, sw)
    costs, ckvp, ckvm, cktv = pinned.pinned_ck_pp_ref(*planes, sched, sw, CB, 32)
    costs, ckvp, ckvm = costs.numpy(), words.to_numpy_u32(ckvp), words.to_numpy_u32(ckvm)
    checked = 0
    for p in range(B0):
        if costs[p] > thr[p]:
            continue
        a, b = pairs[p]
        sc = np.ascontiguousarray(sched[:, p], np.int32)
        cost, cig = native.trace_banded_ck(a, b, args[2].shape[0], ckvp[:, :, p],
                                           ckvm[:, :, p], cktv.numpy()[:, p], sc, sw, CB)
        assert cost == costs[p] == oracle.levenshtein(a, b)
        assert cig.verify(a, b) == cost
        checked += 1
    assert checked >= 8


def _pinned_reference(monkeypatch):
    """Make the reference runner's domain rounds run its pinned per-pair
    kernels in interpret mode (its own routing takes them only on a TPU),
    with the checkpoint interval rounded as its pinned arm rounds it."""

    def domain_kernel(self, a0, a1, pb0, pb1, n, m, sw, sched_arr, quantum, want_ck):
        if want_ck:
            CB = self._cb(sw, a0.shape[0])
            CB = max(quantum, CB // quantum * quantum)
            return pinned_ck_pp_tpu(a0, a1, pb0, pb1, n, m, band_words=sw,
                                    schedule=sched_arr, col_block=CB,
                                    time_block=256, interpret=True)
        return pinned_cost_pp_tpu(a0, a1, pb0, pb1, n, m, band_words=sw,
                                  schedule=sched_arr, time_block=256, interpret=True)

    monkeypatch.setattr(RefAligner, "_domain_kernel", domain_kernel)


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        fn = getattr(runner, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append(_name)
            return _fn(*args)

        monkeypatch.setattr(runner, name, spy)
    return calls


def _gap_pairs():
    """tests/test_banded.py::test_domain_ladder_gap_mode."""
    return [
        generate.generate_model(700 + 37 * s, [0.04, 0.15][s % 2],
                                list(generate.ErrorModel)[s % 4], 300 + s)
        for s in range(6)
    ] + [(b"ACGT" * 120, b"ACGT" * 250)]  # heavy length skew


def _gcsh_pairs():
    """tests/test_banded.py::test_domain_ladder_gcsh_mode."""
    return [generate.generate_model(1000 + 61 * s, 0.1, generate.ErrorModel.UNIFORM, s)
            for s in range(4)]


PP_NAMES = ["pinned_cost_pp", "pinned_ck_pp", "banded_cost_pp", "banded_ck_pp"]


@pytest.mark.parametrize("mode", ["gap", "gcsh"])
def test_runner_cost_rounds_on_k9_match_reference(monkeypatch, mode):
    """With the routing constant low every domain round runs K9's plain
    version: costs equal the oracle, and BatchStats (but ``kernel``) equal
    the reference's, whose rounds ran its pinned per-pair kernel."""
    if mode == "gcsh" and not native.available():
        pytest.skip("native toolchain unavailable")
    pairs = _gap_pairs() if mode == "gap" else _gcsh_pairs()
    kw = dict(band_words=4, lane_multiple=128, domain_mode=mode, domain_min_bp=0,
              domain_k=10, domain_r=2)
    _pinned_reference(monkeypatch)
    monkeypatch.setattr(runner, "PINNED_PP_MIN_SW", 1)
    calls = _spy(monkeypatch, PP_NAMES)
    ref_costs, ref_stats = RefAligner(pallas_interpret=True, **kw).cost_with_stats(pairs)
    costs, stats = BatchAligner(device="cpu", **kw).cost_with_stats(pairs)
    assert list(costs) == list(ref_costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    for f in STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert calls and set(calls) == {"pinned_cost_pp"}
    assert stats.kernel == "torch-ref"


@needs_native
@pytest.mark.parametrize("direct", [False, True])
def test_runner_align_rounds_on_k10_match_reference(monkeypatch, direct):
    """direct_dt=False: the domain rounds run K10 and CIGARs come from its
    checkpoints; direct_dt=True: they run K9 and CIGARs come from direct
    traces.  Costs, BatchStats and verified CIGARs equal the reference's."""
    pairs = [generate.generate_model(500 + 67 * s, [0.05, 0.15][s % 2],
                                     list(generate.ErrorModel)[s % 4], 900 + s)
             for s in range(6)]
    kw = dict(band_words=4, lane_multiple=128, domain_mode="gap", domain_min_bp=0,
              direct_dt=direct)
    _pinned_reference(monkeypatch)
    monkeypatch.setattr(runner, "PINNED_PP_MIN_SW", 1)
    calls = _spy(monkeypatch, PP_NAMES)
    ref_res, ref_stats = RefAligner(pallas_interpret=True, **kw).align_with_stats(pairs)
    res, stats = BatchAligner(device="cpu", **kw).align_with_stats(pairs)
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    for f in STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert set(calls) == {"pinned_cost_pp" if direct else "pinned_ck_pp"}
    assert (stats.direct_traces > 0) == direct
    for (a, b), (c, cig) in zip(pairs, res):
        assert cig.verify(a, b) == c == oracle.levenshtein(a, b)


def test_runner_routes_rounds_by_band(monkeypatch):
    """Rounds below PINNED_PP_MIN_SW words run K4, rounds at or above it
    K9, with the same costs."""
    pairs = _gap_pairs()[:4]
    kw = dict(band_words=4, domain_mode="gap", domain_min_bp=0, max_f_rounds=1)
    sw = {}
    orig = runner.BatchAligner._domain_kernel

    def spy(self, args, s, *rest):
        sw.setdefault("first", s)
        return orig(self, args, s, *rest)

    monkeypatch.setattr(runner.BatchAligner, "_domain_kernel", spy)
    calls = _spy(monkeypatch, PP_NAMES)
    base = BatchAligner(device="cpu", **kw).cost(pairs)
    first = sw["first"]
    for limit, want in ((first + 1, "banded_cost_pp"), (first, "pinned_cost_pp")):
        calls.clear()
        monkeypatch.setattr(runner, "PINNED_PP_MIN_SW", limit)
        assert list(BatchAligner(device="cpu", **kw).cost(pairs)) == list(base)
        assert calls[0] == want, limit
