"""The port's striped big-band path: the plain versions of kernels K5 and K6
against the JAX package's ``striped_cost_tpu``/``striped_ck_tpu`` in
interpret mode (bit for bit on costs and every readable checkpoint row),
against the oracle at full height and through native traces, and the
runner's striped rungs against the reference ``BatchAligner``.  The CUDA
kernels' own tests are in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.ops.pallas_myers import pack_batch_staggered as jpack
from astarpa_tpu.ops.striped import striped_ck_tpu, striped_cost_tpu
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner
from astarpa_tpu_torch.ops import banded, banded_kernel, striped, words
from astarpa_tpu_torch.parallel import runner

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _packed(pairs):
    """Reference pack (B = 128) as numpy, and the same planes for the port."""
    args, B0 = jpack(pairs, lane_multiple=128)
    args = tuple(np.asarray(x) for x in args)
    return args, words.planes_from_numpy(*args, "cpu"), B0


@pytest.fixture(scope="module")
def mixed():
    """tests/test_striped.py's parity inputs, a little shorter."""
    return _packed([
        generate.uniform_seeded(500 + (s * 97) % 300, [0.03, 0.12, 0.25][s % 3], s)
        for s in range(128)
    ])


@pytest.mark.parametrize("sw,ws", [(8, 8), (16, 8), (24, 16), ("S", 8), ("S", 16)])
def test_plain_k5_matches_pallas_and_k1(mixed, sw, ws):
    args, planes, _ = mixed
    S = args[2].shape[0]
    sw = S if sw == "S" else sw
    want = np.asarray(striped_cost_tpu(*args, band_words=sw, stripe_words=ws,
                                       time_block=64, interpret=True))
    got = banded_kernel.striped_cost(*planes, sw)  # the CPU route: plain
    assert np.array_equal(got.numpy(), want)
    # K1 where the window covers row m at the last column, INF elsewhere.
    k1 = banded.banded_cost_ref(*planes, sw).numpy()
    covered = want < banded.INF
    assert covered.sum() > 64
    assert np.array_equal(k1[covered], want[covered])
    assert (k1[~covered] == banded.INF).all()


def test_plain_k5_full_height_equals_oracle():
    """At band_words >= S the striped DP is exact, even for pairs no banded
    certificate accepts (tests/test_striped.py:35-53)."""
    pairs = [generate.uniform_seeded(300 + 7 * s, [0.3, 0.5][s % 2], 70 + s)
             for s in range(24)]
    a, _ = generate.uniform_seeded(500, 0.0, 99)
    pairs[0] = (a, bytes(a[::-1]))
    pairs[1] = (b"ACGT" * 40, b"TTGCA" * 120)
    args, planes, B0 = _packed(pairs)
    S = args[2].shape[0]
    got = striped.striped_cost_ref(*planes, S)[:B0].numpy()
    for p in range(0, B0, 3):
        assert got[p] == oracle.levenshtein(*pairs[p]), p


@pytest.fixture(scope="module")
def ck_pairs():
    return _packed([
        generate.uniform_seeded(600 + (s * 137) % 200, [0.03, 0.12][s % 2], s)
        for s in range(128)
    ])


@pytest.mark.parametrize("sw,cb,ws", [(16, 64, 16), (24, 128, 8), (8, 200, 8)])
def test_plain_k6_matches_pallas(ck_pairs, sw, cb, ws):
    """Costs, and every readable checkpoint row and top value: rows
    ``[lo & 7, (lo & 7) + SW)`` of checkpoints with ``k*CB <= n`` (windows
    spanning the reference's stripe boundaries included: SW+8 > WS)."""
    args, planes, _ = ck_pairs
    n_max, S = args[0].shape[0], args[2].shape[0]
    want = [np.asarray(x) for x in striped_ck_tpu(
        *args, band_words=sw, col_block=cb, stripe_words=ws, time_block=64,
        interpret=True)]
    got = banded_kernel.striped_ck(*planes, sw, cb)
    CB = min(cb, n_max)
    assert got[1].shape == (n_max // CB + 1, sw + 8, 128) == want[1].shape
    assert np.array_equal(got[0].numpy(), want[0])
    lo = striped.plan_striped(n_max, S, sw)["lo"]
    n = args[4]
    checked = 0
    for k in range(got[1].shape[0]):
        live = n >= k * CB
        pad = int(lo[k * CB - 1]) & 7 if k else 0
        rows = slice(pad, pad + sw)
        for g, w in zip(got[1:3], want[1:3]):
            assert np.array_equal(words.to_numpy_u32(g)[k, rows][:, live],
                                  w[k, rows][:, live]), k
        assert np.array_equal(got[3].numpy()[k][live], want[3][k][live]), k
        checked += int(live.any())
    assert checked >= 4


def test_k6_contract_is_checked():
    pairs = [generate.uniform_seeded(300, 0.1, s) for s in range(4)]
    _, planes, _ = _packed(pairs)
    with pytest.raises(ValueError, match="multiple of 8"):
        banded_kernel.striped_ck(*planes, 6, 64)
    with pytest.raises(ValueError, match="band_words"):
        banded_kernel.striped_ck(*planes, 8, 15)


@needs_native
def test_native_trace_from_plain_k6_full_height():
    """tests/test_striped.py:127-165 on the port's planes: full height,
    the profile padded with copies of its last row to a multiple of 8."""
    pairs = [generate.uniform_seeded(300 + 9 * s, [0.05, 0.3][s % 2], 11 + s)
             for s in range(20)]
    args, planes, B0 = _packed(pairs)
    n_max, S = args[0].shape[0], args[2].shape[0]
    sw = -(-S // 8) * 8
    pad = lambda x: torch.cat([x] + [x[-1:]] * (sw - S))  # noqa: E731
    planes = planes[:2] + (pad(planes[2]), pad(planes[3])) + planes[4:]
    CB = 128
    costs, ckvp, ckvm, cktv = striped.striped_ck_ref(*planes, sw, CB)
    costs, ckvp, ckvm = costs.numpy(), words.to_numpy_u32(ckvp), words.to_numpy_u32(ckvm)
    shift = banded.shift_at_array(n_max, sw, sw)
    for p in range(0, B0, 3):
        a, b = pairs[p]
        cost, cig = native.trace_banded_ck(
            a, b, sw, ckvp[:, :, p], ckvm[:, :, p], cktv.numpy()[:, p], shift, sw, CB)
        assert cost == costs[p] == oracle.levenshtein(a, b)
        assert cig.verify(a, b) == cost


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        fn = getattr(runner, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, args[6]))
            return _fn(*args)

        monkeypatch.setattr(runner, name, spy)
    return calls


def _cost_cases():
    rng = np.random.default_rng(3)
    mixed = [generate.uniform_seeded(int(rng.integers(1, 500)),
                                     float(rng.uniform(0, 0.3)), 1000 + s)
             for s in range(12)] + [(b"ACG", b"ACGT" * 40), (b"", b"")]
    a, _ = generate.uniform_seeded(600, 0.0, 9)
    return {"mixed": (mixed, dict(band_words=4)),
            "clamp": ([(a, a[::-1])], dict(band_words=2, max_band_doublings=1))}


@pytest.mark.parametrize("case", ["clamp", "mixed"])
def test_runner_cost_rungs_on_k5(monkeypatch, case):
    """With the routing constant low and K7 refusing every rung, every
    shared cost rung runs K5's plain version: costs equal the oracle and
    BatchStats (but ``kernel``) equal the reference's, whose ladder ran
    the sliding kernel."""
    pairs, kw = _cost_cases()[case]
    monkeypatch.setattr(runner, "STRIPED_MIN_SW", 1)
    monkeypatch.setattr(runner, "pinned_cost_takes", lambda sw: False)
    calls = _spy(monkeypatch, ["striped_cost", "banded_cost"])
    ref_costs, ref_stats = RefAligner(lane_multiple=8, domain_mode="off",
                                      **kw).cost_with_stats(pairs)
    costs, stats = BatchAligner(device="cpu", lane_multiple=8, domain_mode="off",
                                **kw).cost_with_stats(pairs)
    assert list(costs) == list(ref_costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    for f in ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert {c[0] for c in calls} == {"striped_cost"}
    assert stats.kernel == "torch-ref"


@needs_native
def test_runner_ck_rungs_on_k6_match_reference(monkeypatch):
    """direct_dt=False on pairs of 2-3 kbp from a 64-word band: the port's
    ck rungs run K6 (constant patched to 64); the reference's run
    striped_ck_tpu in interpret mode (its pp < 512 and sw >= 64 arm at
    B = 128).  Costs, BatchStats and verified CIGARs agree."""
    pairs = [generate.uniform_seeded(2100 + (s * 97) % 900, [0.02, 0.08][s % 2], 500 + s)
             for s in range(10)]
    kw = dict(band_words=64, lane_multiple=128, domain_mode="off", direct_dt=False)
    monkeypatch.setattr(runner, "STRIPED_MIN_SW", 64)
    calls = _spy(monkeypatch, ["striped_ck", "banded_ck"])
    ref_res, ref_stats = RefAligner(pallas_interpret=True, **kw).align_with_stats(pairs)
    res, stats = BatchAligner(device="cpu", **kw).align_with_stats(pairs)
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    for f in ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp",
              "direct_traces"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert calls and {c[0] for c in calls} == {"striped_ck"}
    for (a, b), (c, cig) in zip(pairs, res):
        assert cig.verify(a, b) == c == oracle.levenshtein(a, b)


@needs_native
def test_full_height_ck_rung_off_the_8_grain_runs_k2(monkeypatch):
    """A full-height ck rung whose S is not a multiple of 8 goes to K8, not
    K6 (which needs SW % 8 == 0) and no longer K2, whose route the name
    recalls; costs and CIGARs stay exact."""
    a, _ = generate.uniform_seeded(600, 0.0, 9)
    pairs = [(a, a[::-1])]
    monkeypatch.setattr(runner, "STRIPED_MIN_SW", 4)
    calls = _spy(monkeypatch, ["striped_ck", "pinned_ck", "banded_ck"])
    ba = BatchAligner(device="cpu", band_words=8, max_band_doublings=1,
                      domain_mode="off", direct_dt=False)
    res, stats = ba.align_with_stats(pairs)
    S = -(-len(a) // 32)
    assert S % 8 and calls == [("striped_ck", 8), ("pinned_ck", S)]
    (c, cig), = res
    assert cig.verify(*pairs[0]) == c == oracle.levenshtein(*pairs[0])


def test_ck_helpers_stage_k6_planes(monkeypatch):
    """The ck-plane helpers' one shape rule (lanes on the last axis) on a
    K6-shaped set of SW+8 rows: gather some lanes, stage them in chunks,
    read them back."""
    g = torch.Generator().manual_seed(5)
    n_ck, SW, B = 3, 16, 40
    ck = (torch.randint(-2**31, 2**31 - 1, (n_ck, SW + 8, B), generator=g, dtype=torch.int32),
          torch.randint(-2**31, 2**31 - 1, (n_ck, SW + 8, B), generator=g, dtype=torch.int32),
          torch.randint(0, 1000, (n_ck, B), generator=g, dtype=torch.int32))
    assert runner._ck_bytes(ck) == 4 * (2 * n_ck * (SW + 8) + n_ck)
    slots = [3, 0, 17, 39, 8]
    picked = runner._gather_lanes(ck, slots)
    assert [tuple(x.shape) for x in picked] == [(n_ck, SW + 8, 5)] * 2 + [(n_ck, 5)]
    monkeypatch.setattr(runner, "_CHUNK_TARGET_BYTES", runner._ck_bytes(ck))
    chunks = runner._stage_ck_chunks(*picked, len(slots))  # a lane a chunk
    assert len(chunks) == len(slots)
    for pos, slot in enumerate(slots):
        c0, sl = runner._chunk_of(chunks, pos)
        vp, vm, tv = sl.numpy()
        assert np.array_equal(vp[:, :, pos - c0], ck[0][:, :, slot].numpy())
        assert np.array_equal(vm[:, :, pos - c0], ck[1][:, :, slot].numpy())
        assert np.array_equal(tv[:, pos - c0], ck[2][:, slot].numpy())
