"""The port's shared-schedule checkpoint kernel K8: its plain version
against the JAX package's ``pinned_ck_tpu`` in interpret mode where the
reference takes the band (``SW % 8 == 0``, B = 128), against the plain K2
(``banded_ck_ref``) on every checkpoint a trace reads off the 8-grain, in
a skewed bucket's single capture window, through native traces, and the
runner's full-height ck rung on K8 against the reference ``BatchAligner``.
The CUDA kernel's own test is in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.ops.pallas_myers import pack_batch_staggered as jpack
from astarpa_tpu.ops.pinned import pinned_ck_tpu
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner
from astarpa_tpu_torch.ops import banded, banded_kernel, words
from astarpa_tpu_torch.ops.pack import pack_batch_staggered
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
def grain_pairs():
    """128 pairs of 380-470 bp; pair 0's b of 500 bp makes S = 16 words,
    so full height is on the 8-grain."""
    pairs = [generate.uniform_seeded(380 + (s * 37) % 90, [0.03, 0.12][s % 2], 900 + s)
             for s in range(128)]
    a, _ = pairs[0]
    pairs[0] = (a, generate.uniform_seeded(500, 0.0, 899)[0])
    return _packed(pairs)


@pytest.mark.parametrize("sw,cb", [(8, 64), (16, 100), ("S", "S")])
def test_plain_k8_matches_pallas(grain_pairs, sw, cb):
    """Costs and every row of every checkpoint (the reference, like the
    plain version, runs every pair's band to n_max), and the top values of
    the checkpoints a trace reads (``k*CB <= n``; past a pair's end the
    reference's top value follows no contract)."""
    args, planes, _ = grain_pairs
    n_max, S = args[0].shape[0], args[2].shape[0]
    assert S == 16
    sw = S if sw == "S" else sw
    cb = S if cb == "S" else cb
    want = [np.asarray(x) for x in pinned_ck_tpu(
        *args, band_words=sw, col_block=cb, time_block=64, interpret=True)]
    got = banded_kernel.pinned_ck(*planes, sw, cb)  # the CPU route: plain
    CB = min(cb, n_max)
    assert got[1].shape == (n_max // CB + 1, sw, 128) == want[1].shape
    assert np.array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:3], want[1:3]):
        assert np.array_equal(words.to_numpy_u32(g), w.astype(np.uint32))
    n = args[4]
    for k in range(got[1].shape[0]):
        live = n >= k * CB
        assert np.array_equal(got[3].numpy()[k][live], want[3][k][live]), k


def _assert_readable_equal(k8, k2, n, CB: int) -> int:
    """K8 == K2 on the covered costs and on every checkpoint both have
    that a trace reads; returns how many checkpoints had a live lane."""
    cov = k8[0] < banded.INF
    assert cov.any()
    assert torch.equal(k8[0][cov], k2[0][cov])
    checked = 0
    for k in range(min(k8[1].shape[0], k2[1].shape[0])):
        live = torch.as_tensor(np.asarray(n) >= k * CB)
        for g, w in zip(k8[1:3], k2[1:3]):
            assert torch.equal(g[k][:, live], w[k][:, live]), k
        assert torch.equal(k8[3][k][live], k2[3][k][live]), k
        checked += int(live.any())
    return checked


@pytest.fixture(scope="module")
def off_grain():
    pairs = [generate.uniform_seeded(200 + (s * 37) % 120, [0.03, 0.12][s % 2], 900 + s)
             for s in range(24)]
    return pack_batch_staggered(pairs, 8, device="cpu")[0]


@pytest.mark.parametrize("sw,cb", [(13, 13), (13, 16), ("S", "S"), ("S", "S+3"),
                                   ("S", 4096), (5, 40)])
def test_plain_k8_matches_plain_k2_off_the_grain(off_grain, sw, cb):
    """Bands off the 8-grain (13 words, full height S = 10), CB = SW, SW+3
    and one window; K2's checkpoint k is the state before column k*CB, K8's
    the state after column k*CB - 1."""
    args = off_grain
    n_max, S = args[0].shape[0], args[2].shape[0]
    assert S % 8
    sw = S if sw == "S" else sw
    cb = {"S": S, "S+3": S + 3}.get(cb, cb)
    k8 = banded_kernel.pinned_ck(*args, sw, cb)
    k2 = banded.banded_ck_ref(*args, sw, cb)
    CB = min(cb, n_max)
    assert k8[1].shape == (n_max // CB + 1, min(sw, S), args[0].shape[1])
    assert _assert_readable_equal(k8, k2, args[4], CB) >= min(2, n_max // CB)


def _skewed():
    """One pair with m > 32 n: full height S = 94 words over n_max = 40."""
    pairs = [(b"ACGTTGCA" * 5, generate.uniform_seeded(3000, 0.0, 5)[0])]
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    return pairs, args


def test_plain_k8_single_window_in_a_skewed_bucket():
    """The full height S exceeds n_max, so ``CB = n_max < SW`` and K8 has
    one capture window, the state after the last column: K2's last column
    of ``banded_fill_ref`` with top value n_max (no shift at full height).
    The cost is the oracle's."""
    pairs, args = _skewed()
    n_max, S = args[0].shape[0], args[2].shape[0]
    assert S > n_max
    costs, vp, vm, tv = banded_kernel.pinned_ck(*args, S, 4096)
    assert vp.shape == (2, S, 1)
    assert int(costs[0]) == oracle.levenshtein(*pairs[0])
    fill = banded.banded_fill_ref(*args, S)
    assert torch.equal(vp[1], fill[1][-1]) and torch.equal(vm[1], fill[2][-1])
    assert (vp[0] == words.ONES).all() and (vm[0] == 0).all()
    assert tv.tolist() == [[0], [n_max]]


def test_k8_contract_is_checked(off_grain):
    """CB < SW raises on both routes unless it leaves one capture window."""
    with pytest.raises(ValueError, match="col_block"):
        banded_kernel.pinned_ck(*off_grain, 8, 7)
    with pytest.raises(ValueError, match="col_block"):
        banded_kernel.pinned_ck(*off_grain, 8, 0)
    _, args = _skewed()
    n_max, S = args[0].shape[0], args[2].shape[0]
    with pytest.raises(ValueError, match="col_block 20 < band_words"):
        banded_kernel.pinned_ck(*args, S, 20)  # two windows of 94 words
    costs, vp, vm, tv = banded_kernel.pinned_ck(*args, S, 30)  # one, at column 30
    assert vp.shape == (n_max // 30 + 1, S, 1) == (2, S, 1)
    fill = banded.banded_fill_ref(*args, S)
    assert torch.equal(vp[1], fill[1][29]) and torch.equal(vm[1], fill[2][29])
    assert tv.tolist() == [[0], [30]]


@needs_native
def test_native_trace_from_plain_k8_full_height(off_grain):
    """CIGARs from plain-K8 planes at full height off the 8-grain through
    the native ``trace_banded_ck``, which reads them as K2's."""
    args = off_grain
    pairs = [generate.uniform_seeded(200 + (s * 37) % 120, [0.03, 0.12][s % 2], 900 + s)
             for s in range(24)]
    n_max, S = args[0].shape[0], args[2].shape[0]
    CB = 64
    costs, ckvp, ckvm, cktv = banded_kernel.pinned_ck(*args, S, CB)
    ckvp, ckvm, cktv = words.to_numpy_u32(ckvp), words.to_numpy_u32(ckvm), cktv.numpy()
    shift = banded.shift_at_array(n_max, S, S)
    for p in range(0, len(pairs), 3):
        a, b = pairs[p]
        cost, cig = native.trace_banded_ck(
            a, b, S, ckvp[:, :, p], ckvm[:, :, p], cktv[:, p], shift, S, CB)
        assert cost == int(costs[p]) == oracle.levenshtein(a, b)
        assert cig.verify(a, b) == cost


def test_k8_single_window_below_sw_is_taken(off_grain):
    """CB < SW with one capture window is K8's to take outside a skewed
    bucket too, and a CB < SW with more windows raises."""
    args = off_grain
    with pytest.raises(ValueError, match="col_block"):
        banded_kernel.pinned_ck(*args, 8, 7)
    with pytest.raises(ValueError, match="col_block"):
        banded_kernel.pinned_ck(*args, 8, 0)
    # One capture window below SW is taken: CB = 200 of n_max ~310 columns.
    n_max = args[0].shape[0]
    assert n_max // 200 + 1 == 2
    got = banded_kernel.pinned_ck(*args, 400, 200)
    assert got[1].shape[0] == 2


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        fn = getattr(runner, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, args[6]))
            return _fn(*args)

        monkeypatch.setattr(runner, name, spy)
    return calls


def _runner_cases():
    a, _ = generate.uniform_seeded(600, 0.0, 9)
    return {
        # Rung 0 at 8 words, then full height S = 19 words (off the grain).
        "off-grain": [(a, a[::-1])] + [
            generate.uniform_seeded(560 + 7 * s, [0.05, 0.2][s % 2], 600 + s)
            for s in range(4)],
        # m > 32 n: a singleton bucket at full height S = 47 > n_max = 40,
        # so CB = n_max < S and one capture window.
        "skewed": [(b"ACGTTGCA" * 5, generate.uniform_seeded(1500, 0.1, 7)[0])],
    }


@needs_native
@pytest.mark.parametrize("case", ["off-grain", "skewed"])
def test_runner_full_height_ck_rung_on_k8_matches_reference(monkeypatch, case):
    """direct_dt=False from an 8-word band with one doubling, the routing
    constant at 16 words: rungs below it run K2 and the full-height rung,
    which K6 refuses (S % 8, or CB = n_max < S + 8), runs K8.  The
    reference runs every rung on ``banded_ck_tpu`` in interpret mode (it
    cannot run a band above 64 words off the 8-grain, so the full height
    stays below 64 here).  Costs, BatchStats and verified CIGARs agree, and
    the costs are the oracle's."""
    pairs = _runner_cases()[case]
    kw = dict(band_words=8, lane_multiple=128, max_band_doublings=1,
              domain_mode="off", direct_dt=False)
    monkeypatch.setattr(runner, "STRIPED_MIN_SW", 16)
    calls = _spy(monkeypatch, ["striped_ck", "pinned_ck", "banded_ck"])
    ref_res, ref_stats = RefAligner(pallas_interpret=True, **kw).align_with_stats(pairs)
    res, stats = BatchAligner(device="cpu", **kw).align_with_stats(pairs)
    S = -(-max(len(b) for _, b in pairs) // 32)
    assert S >= 16 and S % 8
    want = [("pinned_ck", S)] if case == "skewed" else [("banded_ck", 8), ("pinned_ck", S)]
    assert calls == want
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    for f in ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp",
              "direct_traces"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    for (a, b), (c, cig) in zip(pairs, res):
        assert cig.verify(a, b) == c == oracle.levenshtein(a, b)
