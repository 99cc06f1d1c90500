"""Card tests of the port: the CUDA kernels against their plain torch
versions, and the runner on the GPU against the runner on the CPU.  They
skip without a CUDA device.  This file imports no JAX and nothing of the
JAX package, so a GPU host without it runs them with the suite's conftest
(which configures JAX) left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from astarpa_tpu_torch import BatchAligner, generate, oracle
from astarpa_tpu_torch.aligners import nw
from astarpa_tpu_torch.ops import banded, banded_kernel, myers, nw_kernel, pinned, striped
from astarpa_tpu_torch.ops.pack import pack_batch_staggered
from astarpa_tpu_torch.parallel import runner

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
    before = dict(banded_kernel.LAUNCHES)
    for sw in (1, 5, 32, 33, S):
        for diag in (None, (args[0].shape[0], S * 32 - 40)):
            got = banded_kernel.banded_cost(*args, sw, diag)
            want = banded.banded_cost_ref(*args, sw, diag)
            assert torch.equal(got, want), (sw, diag)
    # K1 runs its ring kernel; the old K1 only through its internal launch.
    assert banded_kernel.LAUNCHES["banded_ring"] == before["banded_ring"] + 10
    assert banded_kernel.LAUNCHES["banded_cost"] == before["banded_cost"]


def _assert_same(got, want, label):
    for g, w in zip(got, want):
        assert torch.equal(g, w), label


@pytest.mark.parametrize("count", [32, 77])
def test_ck_kernel_matches_plain(gpu, count):
    pairs = _random_pairs(100 + count, count, 300, 1300)
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    before = dict(banded_kernel.LAUNCHES)
    for sw, cb, diag in ((1, 64, None), (5, 64, None), (33, 512, None),
                         (8, 100, (n_max, S * 32 - 40)), (S, 64, None)):
        got = banded_kernel.banded_ck(*args, sw, cb, diag)
        want = banded.banded_ck_ref(*args, sw, cb, diag)
        assert got[1].shape == (-(-n_max // min(cb, n_max)), min(sw, S), args[0].shape[1])
        _assert_same(got, want, (sw, cb, diag))
    # K2's ring takes these intervals; one below SW with several capture
    # windows runs the old K2.
    assert banded_kernel.LAUNCHES["banded_ring_ck"] == before["banded_ring_ck"] + 5
    assert banded_kernel.k2_kernel(n_max, 33, 20) == "banded_ck"
    _assert_same(banded_kernel.banded_ck(*args, 33, 20),
                 banded.banded_ck_ref(*args, 33, 20), "CB < SW")
    assert banded_kernel.LAUNCHES["banded_ck"] == before["banded_ck"] + 1


@pytest.mark.parametrize("quantum", [32, 8, 1])
def test_perpair_kernels_match_plain(gpu, quantum):
    pairs = [generate.uniform_seeded(150 + 23 * s, [0.02, 0.1, 0.25][s % 3], 500 + s)
             for s in range(40)] + [(b"ACGT" * 20, b"ACGT" * 90), (b"", b"ACG")]
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    a0, a1, pb0, pb1, n, m = args
    n_max, S, B = a0.shape[0], pb0.shape[0], a0.shape[1]
    rng = np.random.default_rng(quantum)
    rows = np.arange(0, n_max, quantum)
    before = dict(banded_kernel.LAUNCHES)
    for sw in (2, 4, 9):
        scheds = [banded.pair_gap_schedule(n, m, sw, n_max, S)[0]] if quantum == 32 else []
        rand = np.zeros((n_max, B), np.uint8)
        rand[rows] = rng.random((len(rows), B)) < 0.3
        rand[rows, ::5] = 1  # these lanes slide past the last word (clamped)
        for sched in scheds + [rand]:
            got = banded_kernel.banded_cost_pp(*args, sched, sw, quantum)
            want = banded.banded_cost_pp_ref(*args, sched, sw, quantum)
            assert torch.equal(got, want), (sw, quantum)
            for cb in (64, 512):
                got = banded_kernel.banded_ck_pp(*args, sched, sw, cb, quantum)
                want = banded.banded_ck_pp_ref(*args, sched, sw, cb, quantum)
                _assert_same(got, want, (sw, cb, quantum))
    # K4 runs its rings (column-0 shifts included); the old K4 none.
    runs = 3 + 3 * (quantum == 32)
    assert banded_kernel.LAUNCHES["banded_ring_pp"] == before["banded_ring_pp"] + runs
    assert banded_kernel.LAUNCHES["banded_ring_ck_pp"] == before["banded_ring_ck_pp"] + 2 * runs
    assert banded_kernel.LAUNCHES["banded_cost_pp"] == before["banded_cost_pp"]
    assert banded_kernel.LAUNCHES["banded_ck_pp"] == before["banded_ck_pp"]
    bad = np.zeros((n_max, B), np.uint8)
    bad[1, 0] = 1
    with pytest.raises(ValueError, match="quantum"):
        banded_kernel.banded_cost_pp(*args, bad, 4, 2)


def test_perpair_shared_schedule_matches_k1(gpu):
    pairs = _random_pairs(5, 64, 400, 500)
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
    for sw in (4, 16):
        sched = np.broadcast_to(banded.shift_at_array(n_max, S, sw)[:, None], (n_max, B))
        got = banded_kernel.banded_cost_pp(*args, sched, sw, 1)
        assert torch.equal(got, banded_kernel.banded_cost(*args, sw))


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
    assert (stats.kernel, ref_stats.kernel) == ("cuda-banded-ring", "torch-ref")
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


@pytest.mark.parametrize("count", [33, 160])
def test_striped_kernels_match_plain(gpu, count):
    """K5 and K6 against their plain versions, bit for bit on costs, every
    checkpoint row and top value: bands from 8 words to full height, and
    bands taller than a 256-word stripe (a skewed pair makes S ~ 280)."""
    pairs = [generate.uniform_seeded(100 + (s * 61) % 900, [0.03, 0.15][s % 2], 700 + s)
             for s in range(count)]
    pairs[1] = (b"", b"ACGTAC")
    pairs[2] = (pairs[2][0][:200], generate.uniform_seeded(9000, 0.1, 699)[0])
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    diag = (n_max, max(len(b) for _, b in pairs[3:]))
    before = dict(banded_kernel.LAUNCHES)
    cases = ((8, 64, diag, None), (24, 512, None, None), (64, 512, diag, 256),
             (S // 8 * 8, 512, None, 256), (S, None, None, None))
    for sw, cb, dg, ws in cases:
        want = striped.striped_cost_ref(*args, sw, dg)
        # The stripe kernel (the cost ring takes these bands by default).
        stripe = ws or 8 * banded_kernel.striped_threads(min(sw, S))
        assert torch.equal(banded_kernel.striped_cost(*args, sw, dg, stripe), want), sw
        if cb is not None:
            got = banded_kernel.striped_ck(*args, sw, cb, dg, stripe)
            _assert_same(got, striped.striped_ck_ref(*args, sw, cb, dg), (sw, cb))
            assert got[1].shape == (n_max // min(cb, n_max) + 1, sw + 8, len(pairs))
    assert banded_kernel.LAUNCHES["striped_cost"] == before["striped_cost"] + len(cases)
    assert banded_kernel.LAUNCHES["striped_ck"] == before["striped_ck"] + len(cases) - 1


def test_runner_striped_rungs_on_gpu(gpu, monkeypatch):
    """A 64-word band on 3 kbp pairs, the cost ring's capacity patched below
    every rung: cost rungs run K5's stripes and ck rungs K6 on the card
    (ring K6, and the stripe kernel with the ring's capacity patched below
    the band), with the costs, ladder and CIGARs of the CPU route."""
    monkeypatch.setattr(banded_kernel, "RING_COST_MAX_WORDS", 32)
    pairs = [generate.uniform_seeded(2500 + 97 * s, 0.1, 40 + s) for s in range(6)]
    kw = dict(band_words=64, domain_mode="off")
    costs, stats = BatchAligner(device=gpu, **kw).cost_with_stats(pairs)
    ref, ref_stats = BatchAligner(device="cpu", **kw).cost_with_stats(pairs)
    assert list(costs) == list(ref) == [oracle.levenshtein(a, b) for a, b in pairs]
    assert (stats.kernel, stats.cells_computed) == ("cuda-striped", ref_stats.cells_computed)
    for ring, label in ((banded_kernel.RING_MAX_WORDS, "cuda-ring-ck"), (32, "cuda-striped-ck")):
        monkeypatch.setattr(banded_kernel, "RING_MAX_WORDS", ring)
        key = "ring_ck" if label == "cuda-ring-ck" else "striped_ck"
        before = banded_kernel.LAUNCHES[key]
        res, astats = BatchAligner(device=gpu, direct_dt=False, **kw).align_with_stats(pairs)
        assert astats.kernel == label and banded_kernel.LAUNCHES[key] > before
        for (a, b), (c, cig), want in zip(pairs, res, ref):
            assert cig.verify(a, b) == c == want


@pytest.mark.parametrize("quantum", [32, 1])
def test_pinned_pp_kernels_match_plain(gpu, quantum):
    """K9 and K10 (their stripe kernels) against their plain versions, bit for bit on costs, every
    checkpoint row and top value: gap, random and broadcast schedules,
    bands from 8 words to full height, bands taller than a 256-word stripe
    (a skewed pair makes S ~ 280), CB 64 and 512."""
    pairs = [generate.uniform_seeded(100 + (s * 61) % 900, [0.03, 0.15][s % 2], 800 + s)
             for s in range(40)]
    pairs[1] = (b"", b"ACGTAC")
    pairs[2] = (pairs[2][0][:200], generate.uniform_seeded(9000, 0.1, 799)[0])
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
    rng = np.random.default_rng(quantum)
    rand = np.zeros((n_max, B), np.uint8)
    rows = np.arange(quantum, n_max, quantum)
    rand[rows] = rng.random((len(rows), B)) < 0.3
    before = dict(banded_kernel.LAUNCHES)
    cases = 0
    for sw, ws in ((8, None), (24, None), (64, 256), (S, 256), (S, None)):
        shared = np.broadcast_to(banded.shift_at_array(n_max, S, sw)[:, None], (n_max, B))
        scheds = [(rand, quantum), (shared, 1)]
        if quantum == 32:
            scheds.append((banded.pair_gap_schedule(args[4], args[5], sw, n_max, S)[0], 32))
        for sched, q in scheds:
            want = pinned.pinned_cost_pp_ref(*args, sched, sw, q)
            stripe = ws or 8 * banded_kernel.striped_threads(min(sw, S))
            got = banded_kernel.pinned_cost_pp(*args, sched, sw, q, stripe)
            assert torch.equal(got, want), (sw, q)
            for cb in (64, 512):
                if banded.ck_col_block(cb, n_max, q) < min(sw, S):
                    continue
                got = banded_kernel.pinned_ck_pp(*args, sched, sw, cb, q, stripe)
                _assert_same(got, pinned.pinned_ck_pp_ref(*args, sched, sw, cb, q),
                             (sw, cb, q))
                cases += 1
    assert banded_kernel.LAUNCHES["pinned_cost_pp"] == before["pinned_cost_pp"] + 5 * len(scheds)
    assert banded_kernel.LAUNCHES["pinned_ck_pp"] == before["pinned_ck_pp"] + cases


@pytest.mark.parametrize("count", [33, 160])
def test_pinned_cost_kernel_matches_plain(gpu, count):
    """K7 against its plain version (and K5), bit for bit: bands from 8
    words to full height off the 8-grain, rings forced to 256 words so
    they wrap several times (a skewed pair makes S ~ 280), n == 0 and m ==
    0 lanes, with and without a diagonal; then a skewed bucket whose ring
    is lower than its full height."""
    pairs = [generate.uniform_seeded(100 + (s * 61) % 900, [0.03, 0.15][s % 2], 2700 + s)
             for s in range(count)]
    pairs[1], pairs[3] = (b"", b"ACGTAC"), (pairs[3][0], b"")
    pairs[2] = (pairs[2][0][:200], generate.uniform_seeded(9000, 0.1, 2699)[0])
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    diag = (n_max, max(len(b) for _, b in pairs[3:]))
    before = banded_kernel.LAUNCHES["pinned_cost"]
    cases = ((8, diag, None), (13, None, 256), (64, diag, 256), (67, None, None),
             (256, diag, 512), (S, None, None))
    for sw, dg, rw in cases:
        want = striped.pinned_cost_ref(*args, sw, dg)
        assert torch.equal(banded_kernel.pinned_cost(*args, sw, dg, rw), want), (sw, rw)
        assert torch.equal(banded_kernel.striped_cost(*args, sw, dg), want), sw
    assert S % 8 and S > 256
    # A skewed bucket at full height taller than its ring (S = 375 words,
    # 200 live), also shape-quantized (n_max 2048 past the longest a):
    # the ended top word's slot is reused.
    tall = [(generate.uniform_seeded(200 - 5 * s, 0.1, 2800 + s)[0],
             generate.uniform_seeded(12_000 - 300 * s, 0.1, 2900 + s)[0]) for s in range(9)]
    for quantum in (None, 2048):
        targs, _ = pack_batch_staggered(tall, 1, quantum, device=gpu)
        St = targs[2].shape[0]
        assert banded_kernel.ring_threads(200) * 8 < St
        got = banded_kernel.pinned_cost(*targs, St)
        assert torch.equal(got, striped.pinned_cost_ref(*targs, St)), quantum
        assert int(got[0]) == oracle.levenshtein(*tall[0])
    # striped_cost runs the cost ring on these bands too.
    assert banded_kernel.LAUNCHES["pinned_cost"] == before + 2 * len(cases) + 2


def test_pinned_cost_on_a_2048_word_ring(gpu):
    """K7 on config #5's ring size, 2048 words in 8 warps (the cross-warp
    link and the barrier on every step), and the wide ring at the same
    size: e=0.15 pairs of a few kbp, bit for bit with the plain version,
    and at full height the edit distance of the first pairs."""
    rng = np.random.default_rng(2048)
    pairs = [generate.uniform_seeded(int(rng.integers(2000, 5001)), 0.15, 4100 + s)
             for s in range(24)]
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    diag = (n_max, max(len(b) for _, b in pairs))
    before = dict(banded_kernel.LAUNCHES)
    for sw, dg in ((S, None), (96, diag), (32, diag)):
        want = striped.pinned_cost_ref(*args, sw, dg)
        for tw in (8, 16):
            got = banded_kernel.pinned_cost(*args, sw, dg, 2048, tw)
            assert torch.equal(got, want), (sw, tw)
        if dg is None:
            for p in range(4):
                assert int(got[p]) == oracle.levenshtein(*pairs[p]), p
    assert banded_kernel.LAUNCHES["pinned_cost"] == before["pinned_cost"] + 3
    assert banded_kernel.LAUNCHES["ring_cost_wide"] == before["ring_cost_wide"] + 3


def test_pinned_cost_raises_past_its_ring(gpu):
    """More than 4096 live words (a full height of 4375 words over 4500
    columns) raise before any launch on K7 forced (8 slots a thread) and
    run the wide ring by default; a ring below the live words raises; more
    than 16384 live words (a full height over 16400 columns) raise on the
    cost ring, and K5's stripes take them."""
    pairs = [(generate.uniform_seeded(4500, 0.0, 1)[0],
              generate.uniform_seeded(140_000, 0.1, 2)[0])]
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    S = args[2].shape[0]
    before = dict(banded_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="exceed"):
        banded_kernel.pinned_cost(*args, S, None, None, 8)
    with pytest.raises(ValueError, match="ring_words"):
        banded_kernel.pinned_cost(*args, 512, None, 256)
    assert banded_kernel.LAUNCHES == before
    got = banded_kernel.pinned_cost(*args, S)
    assert banded_kernel.LAUNCHES["ring_cost_wide"] == before["ring_cost_wide"] + 1
    assert int(got[0]) == oracle.levenshtein(*pairs[0])
    over = [(generate.uniform_seeded(16_400, 0.0, 3)[0],
             generate.uniform_seeded(530_000, 0.1, 4)[0])]
    oargs, _ = pack_batch_staggered(over, 1, device=gpu)
    before = dict(banded_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="exceed"):
        banded_kernel.pinned_cost(*oargs, oargs[2].shape[0])
    assert banded_kernel.LAUNCHES == before
    assert not banded_kernel.pinned_cost_takes(oargs[2].shape[0])


@pytest.mark.parametrize("count", [33, 160])
def test_ring_cost_kernels_match_plain(gpu, count):
    """The redesigned K7 and the wide ring against their plain version and
    K5's stripes, bit for bit: n == 0 and m == 0 lanes, K7 and wide rings
    forced small so they wrap (one warp without a barrier, several warps),
    a band of 8192 words and the full height beside a 5000 x 300 kbp pair
    (more than 4096 live words: the wide ring by default)."""
    pairs = [generate.uniform_seeded(100 + (s * 61) % 900, [0.03, 0.15][s % 2], 3700 + s)
             for s in range(count)]
    pairs[1], pairs[3] = (b"", b"ACGTAC"), (pairs[3][0], b"")
    pairs[2] = (pairs[2][0][:500], generate.uniform_seeded(150_000, 0.1, 3699)[0])
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    dg = (n_max, 32 * n_max)  # S > n_max: a word a column below full height
    before = dict(banded_kernel.LAUNCHES)
    cases = ((64, dg, 256, 8), (4352, dg, 1024, 16), (4352, dg, 1024, 32),
             (256, dg, 2048, 16), (S, None, 4096, 32))
    for sw, dg, rw, tw in cases:
        want = striped.pinned_cost_ref(*args, sw, dg)
        assert torch.equal(banded_kernel.pinned_cost(*args, sw, dg, rw, tw), want), (sw, rw, tw)
        stripe = 8 * banded_kernel.striped_threads(min(sw, S))
        assert torch.equal(banded_kernel.striped_cost(*args, sw, dg, stripe), want), sw
    assert banded_kernel.LAUNCHES["pinned_cost"] == before["pinned_cost"] + 1
    assert banded_kernel.LAUNCHES["ring_cost_wide"] == before["ring_cost_wide"] + 4
    rng = np.random.default_rng(count)
    tall = [generate.uniform_seeded(int(rng.integers(1, 5001)), 0.1, 3800 + s) for s in range(33)]
    tall[0] = (generate.uniform_seeded(5000, 0.1, 3799)[0],
               generate.uniform_seeded(300_000, 0.1, 3798)[0])
    targs, _ = pack_batch_staggered(tall, 1, device=gpu)
    St = targs[2].shape[0]
    dt = (targs[0].shape[0], 32 * targs[0].shape[0])
    before = banded_kernel.LAUNCHES["ring_cost_wide"]
    for sw, d in ((8192, dt), (St, None)):
        want = striped.pinned_cost_ref(*targs, sw, d)
        assert torch.equal(banded_kernel.pinned_cost(*targs, sw, d), want), sw
    assert banded_kernel.LAUNCHES["ring_cost_wide"] == before + 2


def _ring_packs(gpu, seed):
    """A 160-lane pack of pairs up to 1 kbp with an n == 0 lane, an m == 0
    lane and a skewed pair making S ~ 280 words, its first 33 lanes, and
    33 pairs of up to 5 kbp beside a tall one (S = 1188), on which a
    256-word ring wraps at least 3 times."""
    pairs = [generate.uniform_seeded(100 + (s * 61) % 900, [0.03, 0.15][s % 2], seed + s)
             for s in range(160)]
    pairs[1], pairs[3] = (b"", b"ACGTAC"), (pairs[3][0], b"")
    pairs[2] = (pairs[2][0][:200], generate.uniform_seeded(9000, 0.1, seed - 1)[0])
    wide, _ = pack_batch_staggered(pairs, 1, device=gpu)
    narrow = tuple(x[..., :33].contiguous() if torch.is_tensor(x) else x[:33] for x in wide)
    rng = np.random.default_rng(seed)
    lng = [generate.uniform_seeded(int(rng.integers(1, 5001)), float(rng.uniform(0, 0.25)),
                                   seed + 200 + s) for s in range(33)]
    lng[0] = (generate.uniform_seeded(5000, 0.1, seed + 198)[0],
              generate.uniform_seeded(38_000, 0.1, seed + 199)[0])
    long_, _ = pack_batch_staggered(lng, 1, device=gpu)
    return wide, narrow, long_, (long_[0].shape[0], max(len(b) for _, b in lng))


@pytest.mark.parametrize("which", ["wide", "narrow", "long"])
def test_ring_ck_kernel_matches_plain(gpu, which):
    """Ring K6 against its plain version and the stripe kernel, bit for bit
    on costs, every checkpoint row (the zero rows outside the true windows
    included) and every top value: SW 8 to the 8-grain below full height,
    CB = SW + 8 and larger, with and without a diagonal, rings forced to
    256 words; on the long pack the forced rings wrap at least 3 times."""
    wide, narrow, long_, diag_l = _ring_packs(gpu, 3100)
    args = {"wide": wide, "narrow": narrow, "long": long_}[which]
    n_max, S = args[0].shape[0], args[2].shape[0]
    diag = diag_l if which == "long" else (n_max, int(np.asarray(args[5]).max()))
    s8 = S // 8 * 8
    cases = ((8, 16, diag, None), (64, 72, diag, 256), (64, 512, None, None),
             (256, 264, diag, 256), (s8, s8 + 8, None, None), (s8, 4096, diag, None))
    before = dict(banded_kernel.LAUNCHES)
    for sw, cb, dg, rw in cases:
        want = striped.striped_ck_ref(*args, sw, cb, dg)
        got = banded_kernel.striped_ck(*args, sw, cb, dg, ring_words=rw)
        _assert_same(got, want, (which, sw, cb, rw))
        stripe = banded_kernel.striped_ck(*args, sw, cb, dg, 8 * banded_kernel.striped_threads(min(sw, S)))
        _assert_same(got, stripe, (which, sw, cb, "stripe"))
        if which == "long" and rw == 256:
            plan = striped.plan_striped(n_max, S, min(sw, S), dg)
            assert plan["n_words_live"] >= 3 * 256, plan["n_words_live"]
    assert banded_kernel.LAUNCHES["ring_ck"] == before["ring_ck"] + len(cases)
    assert banded_kernel.LAUNCHES["striped_ck"] == before["striped_ck"] + len(cases)


@pytest.mark.parametrize("quantum", [32, 8, 1])
def test_ring_pp_kernel_matches_plain(gpu, quantum):
    """Ring K9 against its plain version and the stripe kernel, bit for
    bit: gap, random and broadcast schedules, bands from 8 words to full
    height off the 8-grain, rings forced to 256 words; on the long pack
    they wrap at least 3 times."""
    wide, narrow, long_, _ = _ring_packs(gpu, 3300 + quantum)
    before = dict(banded_kernel.LAUNCHES)
    rng = np.random.default_rng(quantum)
    runs = 0
    for args, sws in ((narrow, (8, 64)), (wide, (24, "S")), (long_, (64, 256))):
        n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
        rand = np.zeros((n_max, B), np.uint8)
        rows = np.arange(quantum, n_max, quantum)
        rand[rows] = rng.random((len(rows), B)) < 0.3
        for sw in sws:
            sw = S if sw == "S" else sw
            shared = np.broadcast_to(banded.shift_at_array(n_max, S, sw)[:, None], (n_max, B))
            scheds = [(rand, quantum), (shared, 1)]
            if quantum == 32:
                scheds.append((banded.pair_gap_schedule(args[4], args[5], sw, n_max, S)[0], 32))
            for sched, q in scheds:
                want = pinned.pinned_cost_pp_ref(*args, sched, sw, q)
                for rw in (None, 256 if sw <= 256 else None):
                    got = banded_kernel.pinned_cost_pp(*args, sched, sw, q, ring_words=rw)
                    assert torch.equal(got, want), (sw, q, rw)
                    runs += 1
                stripe = 8 * banded_kernel.striped_threads(min(sw, S))
                assert torch.equal(banded_kernel.pinned_cost_pp(*args, sched, sw, q, stripe),
                                   want), (sw, q)
    assert banded_kernel.LAUNCHES["ring_cost_pp"] == before["ring_cost_pp"] + runs


def test_ring_kernels_raise_past_their_ring(gpu):
    """Asked for a ring, ring K6, ring K9 and ring K10 refuse a band of more
    live words than 4096 (a full height of 4376 words over 4500 columns)
    before any launch; by default the stripe kernels take it."""
    pairs = [(generate.uniform_seeded(4500, 0.0, 1)[0],
              generate.uniform_seeded(140_032, 0.1, 2)[0])]
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    s8 = S // 8 * 8
    sched = np.broadcast_to(banded.shift_at_array(n_max, S, s8)[:, None], (n_max, 1))
    before = dict(banded_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="exceed"):
        banded_kernel.striped_ck(*args, s8, s8 + 8, None, ring_words=4096)
    with pytest.raises(ValueError, match="exceed"):
        banded_kernel.pinned_cost_pp(*args, sched, s8, 1, ring_words=4096)
    with pytest.raises(ValueError, match="exceed"):
        banded_kernel.pinned_ck_pp(*args, sched, s8, n_max, 1, ring_words=4096)
    assert banded_kernel.LAUNCHES == before
    assert not banded_kernel.ring_takes(s8)
    got = banded_kernel.pinned_cost_pp(*args, sched, s8, 1)
    assert banded_kernel.LAUNCHES["pinned_cost_pp"] == before["pinned_cost_pp"] + 1
    assert torch.equal(got, pinned.pinned_cost_pp_ref(*args, sched, s8, 1))
    ck = banded_kernel.pinned_ck_pp(*args, sched, s8, n_max, 1)
    assert banded_kernel.LAUNCHES["pinned_ck_pp"] == before["pinned_ck_pp"] + 1
    assert torch.equal(ck[0], got)


def _k1_grid(gpu):
    """Pairs of up to 400 bp beside b of up to 2200 bp (S >= 63), an n == 0
    pair, a short a against a long b (row m below the window at small
    bands) and a long a against a short b (row m above it)."""
    rng = np.random.default_rng(11)

    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [generate.uniform_seeded(int(rng.integers(1, 400)), float(rng.uniform(0, 0.3)),
                                     600 + s) for s in range(30)]
    pairs += [(seq(int(rng.integers(1, 300))), seq(int(rng.integers(300, 2200))))
              for _ in range(8)]
    pairs += [(b"", seq(90)), (b"ACG", seq(700)), (seq(390), b"ACGTAC")]
    return pack_batch_staggered(pairs, 1, device=gpu)[0]


@pytest.mark.parametrize("sw", [1, 2, 31, 32, 33, 63])
def test_banded_ring_kernel_matches_plain(gpu, sw):
    """K1's ring kernel against K1's plain version, bit for bit, with and
    without a diagonal, at the runner's layout and at every other ring
    size below a warp that holds the band's live words, and as one ring
    a block (64 lanes); pairs covered, above and below the window and n ==
    0 (cost m)."""
    args = _k1_grid(gpu)
    n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
    assert S >= 63
    before = dict(banded_kernel.LAUNCHES)
    runs = 0
    for diag in (None, (n_max, S * 32 - 50)):
        want = banded.banded_cost_ref(*args, sw, diag)
        assert torch.equal(banded_kernel.banded_cost(*args, sw, diag), want), (sw, diag)
        span = striped.ring_span(striped.plan_striped(n_max, S, sw, diag),
                                 int(np.max(args[4])))
        for lanes in (1, 2, 4, 8, 16, 32, 64):
            if lanes * 8 >= span:
                got = banded_kernel._launch_banded_ring(*args, sw, diag, lanes)
                assert torch.equal(got, want), (sw, diag, lanes)
                runs += 1
        n0 = np.flatnonzero(np.asarray(args[4]) == 0)
        assert len(n0) and want[n0].tolist() == np.asarray(args[5])[n0].tolist()
    assert banded_kernel.LAUNCHES["banded_ring"] == before["banded_ring"] + 2 + runs
    assert banded_kernel.LAUNCHES["banded_cost"] == before["banded_cost"]


@pytest.mark.parametrize("quantum", [1, 8])
def test_ring_ck_pp_kernel_matches_plain(gpu, quantum):
    """Ring K10 against its plain version and the stripe K10, bit for bit
    on costs, every checkpoint row and top value: random and broadcast
    schedules, CB = SW and larger, bands from 8 words to full height, rings
    forced to 256 words; on the long pack (33 pairs of up to 5 kbp beside
    a 38 kbp one) they wrap at least 3 times."""
    wide, narrow, long_, _ = _ring_packs(gpu, 3500 + quantum)
    before = dict(banded_kernel.LAUNCHES)
    rng = np.random.default_rng(quantum)
    runs, wraps = 0, []
    for args, cases in ((narrow, ((8, 8), (64, 100))), (wide, ((24, 40), ("S", "S"))),
                        (long_, ((256, 256), (200, 264)))):
        n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
        rand = np.zeros((n_max, B), np.uint8)
        rows = np.arange(quantum, n_max, quantum)
        # Every quantum column shifts on the long pack: 256-word rings wrap
        # at least 3 times at Q = 8 too.
        rand[rows] = rng.random((len(rows), B)) < (1.0 if args is long_ else 0.5)
        for sw, cb in cases:
            sw = S if sw == "S" else sw
            cb = -(-S // quantum) * quantum if cb == "S" else cb
            shared = np.broadcast_to(banded.shift_at_array(n_max, S, sw)[:, None], (n_max, B))
            scheds = [(rand, quantum)] + ([(shared, 1)] if not shared[0].any() else [])
            for sched, q in scheds:
                if banded.ck_col_block(cb, n_max, q) < min(sw, S):
                    continue
                want = pinned.pinned_ck_pp_ref(*args, sched, sw, cb, q)
                for rw in (None, 256 if min(sw, S) <= 256 else None):
                    got = banded_kernel.pinned_ck_pp(*args, sched, sw, cb, q, ring_words=rw)
                    _assert_same(got, want, (sw, cb, q, rw))
                    runs += 1
                    if rw == 256 and args is long_:
                        plan = pinned.plan_pp(sched, np.asarray(args[4]), sw, "cpu")
                        wraps.append(float(plan["nwl"].max()) / 256)
                stripe = 8 * banded_kernel.striped_threads(min(sw, S))
                _assert_same(banded_kernel.pinned_ck_pp(*args, sched, sw, cb, q, stripe), want,
                             (sw, cb, q))
    assert min(wraps) >= 3
    assert banded_kernel.LAUNCHES["ring_ck_pp"] == before["ring_ck_pp"] + runs


def _k4_ring_pack(gpu):
    """Pairs of up to 400 bp beside b of up to 900 bp, some shorter than
    n_max by far, an n == 0 pair, a short a against a long b and a long a
    against a short b (row m below and above the window)."""
    rng = np.random.default_rng(12)

    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [generate.uniform_seeded(int(rng.integers(1, 400)), float(rng.uniform(0, 0.3)),
                                     700 + s) for s in range(37)]
    pairs += [(seq(int(rng.integers(1, 200))), seq(int(rng.integers(200, 900))))
              for _ in range(4)]
    pairs += [(b"", seq(90)), (b"ACG", seq(700)), (seq(390), b"ACGTAC")]
    return pack_batch_staggered(pairs, 1, device=gpu)[0]


@pytest.mark.parametrize("quantum", [1, 8])
def test_banded_ring_pp_kernels_match_plain(gpu, quantum):
    """K4's rings (cost and checkpoints) against K4's plain versions, bit
    for bit on costs, every checkpoint row and top value: random schedules
    shifting at column 0 on some lanes and sliding past the last word on
    others (the entering word clamped at S - 1), the pairs' gap schedules,
    bands of 1 word to full height, CB = SW and larger, at the runner's
    layout and with rings forced to 32 and 64 lanes; an interval below SW
    runs the old K4."""
    args = _k4_ring_pack(gpu)
    a0, _, pb0, _, n, m = args
    n_max, S, B = a0.shape[0], pb0.shape[0], a0.shape[1]
    rng = np.random.default_rng(quantum)
    rows = np.arange(0, n_max, quantum)
    before = dict(banded_kernel.LAUNCHES)
    runs = 0
    for sw in (1, 4, 16, S):
        rand = np.zeros((n_max, B), np.uint8)
        rand[rows] = rng.random((len(rows), B)) < 0.3
        rand[0, ::3] = 1
        rand[rows, ::7] = 1
        gap = banded.pair_gap_schedule(n, m, sw, n_max, S)[0]
        gap[np.arange(n_max) % quantum != 0] = 0
        cb = -(-max(min(sw, S), 24) // quantum) * quantum  # CB >= SW after Q rounding
        for sched in (rand, gap):
            want = banded.banded_ck_pp_ref(*args, sched, sw, cb, quantum)
            cost = banded.banded_cost_pp_ref(*args, sched, sw, quantum)
            assert torch.equal(cost, want[0])
            for lanes in (None, 32, 64):
                got = banded_kernel._launch_banded_ring_pp(*args, sched, sw, quantum,
                                                           lanes=lanes)
                assert torch.equal(got, cost), (sw, lanes)
                got = banded_kernel._launch_banded_ring_pp(*args, sched, sw, quantum, cb,
                                                           lanes=lanes)
                _assert_same(got, want, (sw, lanes))
                runs += 1
    assert banded_kernel.LAUNCHES["banded_ring_pp"] == before["banded_ring_pp"] + runs
    assert banded_kernel.LAUNCHES["banded_ring_ck_pp"] == before["banded_ring_ck_pp"] + runs
    small = np.zeros((n_max, B), np.uint8)
    assert banded_kernel.k4_kernel(n_max, 16, quantum, quantum) == "banded_ck_pp"
    got = banded_kernel.banded_ck_pp(*args, small, 16, quantum, quantum)
    _assert_same(got, banded.banded_ck_pp_ref(*args, small, 16, quantum, quantum), "CB < SW")
    assert banded_kernel.LAUNCHES["banded_ck_pp"] == before["banded_ck_pp"] + 1


def test_rings_take_a_shared_shift_at_column_0(gpu):
    """K1's, K3's and K2's rings, ring K8 and the cost rings (K7, the wide
    ring) on a shared schedule shifted at column 0 (a diagonal steeper
    than a word a column at the start), bit for bit their plain
    versions."""
    pairs = _random_pairs(31, 37, 120, 1300)
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    col0 = (1, (8 * 32 // 2 + 32) * 2)
    assert banded.shift_at_array(n_max, S, 8, col0)[:2].tolist() == [1, 0]
    assert torch.equal(banded_kernel.banded_cost(*args, 8, col0),
                       banded.banded_cost_ref(*args, 8, col0))
    _assert_same(banded_kernel.banded_fill(*args, 8, col0),
                 banded.banded_fill_ref(*args, 8, col0), "fill")
    before = dict(banded_kernel.LAUNCHES)
    want = striped.pinned_cost_ref(*args, 8, col0)
    for tw in (None, 16):
        assert torch.equal(banded_kernel.pinned_cost(*args, 8, col0, None, tw), want), tw
    _assert_same(banded_kernel.banded_ck(*args, 8, 24, col0),
                 banded.banded_ck_ref(*args, 8, 24, col0), "K2")
    _assert_same(banded_kernel.pinned_ck(*args, 8, 24, col0),
                 striped.pinned_ck_ref(*args, 8, 24, col0), "K8")
    for key in ("pinned_cost", "ring_cost_wide", "banded_ring_ck", "ring_ck_exact"):
        assert banded_kernel.LAUNCHES[key] == before[key] + 1, key


@pytest.mark.parametrize("which", ["wide", "long"])
def test_ring_ck_exact_kernel_matches_plain(gpu, which):
    """Ring K8 against its plain version and the stripe K8, bit for bit on
    costs, every checkpoint row (past each pair's end too) and top value:
    SW 8, 13, 67, 1152 and a full height off the 8-grain, CB = SW and
    larger, with and without a diagonal, rings forced to 256 words (on the
    long pack they wrap at least 3 times) and to two warps."""
    wide, _, long_, diag_l = _ring_packs(gpu, 3300)
    args = {"wide": wide, "long": long_}[which]
    n_max, S = args[0].shape[0], args[2].shape[0]
    assert S % 8
    diag = diag_l if which == "long" else (n_max, int(np.asarray(args[5]).max()))
    cases = ((8, 8, diag, None), (13, 13, None, 256), (67, 70, diag, 512),
             (256, 256, diag, 256), (1152, 1152, None, None), (S, S + 3, None, None))
    before = dict(banded_kernel.LAUNCHES)
    for sw, cb, dg, rw in cases:
        want = striped.pinned_ck_ref(*args, sw, cb, dg)
        got = banded_kernel.pinned_ck(*args, sw, cb, dg, ring_words=rw)
        _assert_same(got, want, (which, sw, cb, rw))
        stripe = 8 * banded_kernel.striped_threads(min(sw, S))
        _assert_same(banded_kernel.pinned_ck(*args, sw, cb, dg, stripe), got,
                     (which, sw, cb, "stripe"))
        if which == "long" and rw == 256:
            plan = striped.plan_striped(n_max, S, min(sw, S), dg)
            assert plan["n_words_live"] >= 3 * 256, plan["n_words_live"]
    assert banded_kernel.LAUNCHES["ring_ck_exact"] == before["ring_ck_exact"] + len(cases)
    assert banded_kernel.LAUNCHES["pinned_ck"] == before["pinned_ck"] + len(cases)


@pytest.mark.parametrize("count", [37, 300])
def test_banded_ring_ck_kernel_matches_plain(gpu, count):
    """K2's ring against K2's plain version, bit for bit on costs, every
    checkpoint row and top value (past each pair's end too): rings of 1 to
    16 lanes a pair (several pairs a warp, a tail warp) and forced to two
    warps, SW 1 to the full height, CB = SW and larger, a single capture
    window below SW, with and without a diagonal."""
    pairs = _random_pairs(500 + count, count, 300, 1300)
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    diag = (n_max, S * 32 - 40)
    before = dict(banded_kernel.LAUNCHES)
    cases = ((1, 64, None, None), (5, 5, diag, None), (13, 24, None, None),
             (16, 24, diag, 64), (33, 33, None, None), (S, 64, diag, None),
             (S, n_max // 2 + 1, None, None))
    for sw, cb, dg, lanes in cases:
        assert banded_kernel.k2_kernel(n_max, min(sw, S), cb) == "banded_ring_ck"
        got = banded_kernel._launch_banded_ring_ck(*args, sw, cb, dg, lanes)
        _assert_same(got, banded.banded_ck_ref(*args, sw, cb, dg), (sw, cb, dg, lanes))
    assert banded_kernel.LAUNCHES["banded_ring_ck"] == before["banded_ring_ck"] + len(cases)
    assert banded_kernel.LAUNCHES["banded_ck"] == before["banded_ck"]


def test_runner_config5_shaped_rung_on_k7(gpu):
    """Config #5's shape at a fifth of its length: 8 pairs of 100 kbp at
    e=15%, ``band_words=2048``, ``domain_mode="off"``.  The rung (K5 would
    run two stripes of 2048 words over S ~ 3200) runs K7, and its costs
    are the exact ones of a full-height K5 sweep."""
    pairs = [generate.uniform_seeded(100_000, 0.15, 7 + s) for s in range(8)]
    before = banded_kernel.LAUNCHES["pinned_cost"]
    costs, stats = BatchAligner(device=gpu, band_words=2048,
                                domain_mode="off").cost_with_stats(pairs)
    assert stats.kernel == "cuda-pinned" and stats.band_retries == 0
    assert banded_kernel.LAUNCHES["pinned_cost"] == before + 1
    args, _ = pack_batch_staggered(pairs[:2], 1, device=gpu)
    exact = banded_kernel.striped_cost(*args, args[2].shape[0])
    assert [int(c) for c in costs[:2]] == exact.tolist()


def test_pinned_ck_refuses_short_intervals(gpu):
    pairs = [generate.uniform_seeded(300, 0.1, s) for s in range(4)]
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    sched = np.zeros(args[0].shape, np.uint8)
    before = banded_kernel.LAUNCHES["pinned_ck_pp"]
    with pytest.raises(ValueError, match="col_block"):
        banded_kernel.pinned_ck_pp(*args, sched, 8, 7, 1)
    with pytest.raises(ValueError, match="column 0"):
        bad = sched.copy()
        bad[0] = 1
        banded_kernel.pinned_cost_pp(*args, bad, 8, 1)
    assert banded_kernel.LAUNCHES["pinned_ck_pp"] == before


@pytest.mark.parametrize("count", [37, 128])
def test_pinned_ck_kernel_matches_plain(gpu, count):
    """K8 against its plain version, bit for bit on costs, every checkpoint
    row and top value: SW on and off the 8-grain up to full height (a skewed
    pair makes S ~ 280, taller than a 256-word stripe), CB = SW, SW + 3 and
    512, with and without a diagonal; then a skewed bucket's single capture
    window (CB = n_max < S).  A short CB raises without a launch."""
    pairs = [generate.uniform_seeded(100 + (s * 61) % 900, [0.03, 0.15][s % 2], 1700 + s)
             for s in range(count)]
    pairs[1] = (b"", b"ACGTAC")
    pairs[2] = (pairs[2][0][:200], generate.uniform_seeded(9000, 0.1, 1699)[0])
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S = args[0].shape[0], args[2].shape[0]
    diag = (n_max, max(len(b) for _, b in pairs[3:]))
    before = dict(banded_kernel.LAUNCHES)
    cases = [(8, 64, diag), (13, 13, None), (67, 70, diag), (67, 512, None),
             (S, S, None), (S, 512, None)]
    for sw, cb, dg in cases:
        got = banded_kernel.pinned_ck(*args, sw, cb, dg)
        _assert_same(got, striped.pinned_ck_ref(*args, sw, cb, dg), (sw, cb))
        assert got[1].shape == (n_max // min(cb, n_max) + 1, min(sw, S), len(pairs))
        stripe = 8 * banded_kernel.striped_threads(min(sw, S))
        _assert_same(banded_kernel.pinned_ck(*args, sw, cb, dg, stripe), got, (sw, cb, "stripe"))
    skew = [(b"ACGTTGCA" * 5, generate.uniform_seeded(3000, 0.0, 5)[0])]
    sargs, _ = pack_batch_staggered(skew, 1, device=gpu)
    S2 = sargs[2].shape[0]
    got = banded_kernel.pinned_ck(*sargs, S2, 4096)
    _assert_same(got, striped.pinned_ck_ref(*sargs, S2, 4096), "skewed")
    assert int(got[0][0]) == oracle.levenshtein(*skew[0])
    with pytest.raises(ValueError, match="col_block"):
        banded_kernel.pinned_ck(*args, 67, 66)
    # Ring K8 ran every case, the stripe K8 each forced one.
    assert banded_kernel.LAUNCHES["ring_ck_exact"] == before["ring_ck_exact"] + len(cases) + 1
    assert banded_kernel.LAUNCHES["pinned_ck"] == before["pinned_ck"] + len(cases)


def test_runner_full_height_ck_rung_on_k8(gpu, monkeypatch):
    """A full-height ck rung off the 8-grain (S = 67 words, at least
    STRIPED_MIN_SW) runs K8 on the card, with the costs and CIGARs of the
    CPU route."""
    pairs = [generate.uniform_seeded(2080 + 7 * s, [0.05, 0.2][s % 2], 600 + s)
             for s in range(6)]
    kw = dict(band_words=8, max_band_doublings=0, domain_mode="off", direct_dt=False)
    ref, _ = BatchAligner(device="cpu", **kw).cost_with_stats(pairs)
    before = dict(banded_kernel.LAUNCHES)
    res, stats = BatchAligner(device=gpu, **kw).align_with_stats(pairs)
    assert stats.kernel == "cuda-ring-ck-exact"
    assert banded_kernel.LAUNCHES["ring_ck_exact"] == before["ring_ck_exact"] + 1
    assert banded_kernel.LAUNCHES["pinned_ck"] == before["pinned_ck"]
    for (a, b), (c, cig), want in zip(pairs, res, ref):
        assert cig.verify(a, b) == c == want == oracle.levenshtein(a, b)


def test_runner_routes_domain_rounds_on_gpu(gpu, monkeypatch):
    """Domain rounds below PINNED_PP_MIN_SW words run K4, at or above it
    K9 (costs; ring K9, whose ring holds these bands) and K10
    (checkpoints; ring K10), with the costs and CIGARs of the CPU route."""
    pairs = [generate.uniform_seeded(2000 + 97 * s, 0.1, 60 + s) for s in range(6)]
    kw = dict(band_words=4, domain_mode="gap", domain_min_bp=0)
    ref, _ = BatchAligner(device="cpu", **kw).cost_with_stats(pairs)
    for limit, labels in ((10**6, ("cuda-banded-ring-pp", "cuda-banded-ring-ck-pp")),
                          (1, ("cuda-ring-pp", "cuda-ring-pp-ck"))):
        monkeypatch.setattr(runner, "PINNED_PP_MIN_SW", limit)
        costs, stats = BatchAligner(device=gpu, **kw).cost_with_stats(pairs)
        assert list(costs) == list(ref) == [oracle.levenshtein(a, b) for a, b in pairs]
        assert stats.kernel == labels[0]
        res, astats = BatchAligner(device=gpu, direct_dt=False, **kw).align_with_stats(pairs)
        assert astats.kernel == labels[1]
        for (a, b), (c, cig), want in zip(pairs, res, ref):
            assert cig.verify(a, b) == c == want


@pytest.mark.parametrize("count", [33, 160])
def test_nw_kernel_matches_plain(gpu, count):
    """K11 against its plain version, bit for bit on both planes (pad rows
    included): ragged lanes, n == 0 and m == 0 lanes, S from one word to
    313 (a 10 kbp b: ten stripes of 32 words, the last partial); costs from
    both entries equal the oracle."""
    pairs = [generate.uniform_seeded(50 + (s * 67) % 1400, [0.01, 0.1, 0.3][s % 3], 900 + s)
             for s in range(count)]
    pairs[1], pairs[2] = (b"", b"ACGTAC"), (b"ACGTT", b"")
    pairs[3] = (pairs[3][0][:150], generate.uniform_seeded(10_000, 0.1, 899)[0])
    before = banded_kernel.LAUNCHES["nw_right_edge"]
    for cut in (1, 32, 47, None):  # S = 1, 32, 47 and 313 words
        sub = [(a, b[: 32 * cut] if cut else b) for a, b in pairs]
        args, _ = pack_batch_staggered(sub, 1, device=gpu)
        got = nw_kernel.nw_right_edge(*args[:5])
        want = myers.nw_right_edge_ref(*args[:5])
        _assert_same(got, want, cut)
        costs = [oracle.levenshtein(a, b) for a, b in sub]
        assert list(nw_kernel.nw_cost(*args).cpu().numpy()) == costs
        assert list(nw_kernel.nw_cost_pairs(sub, device=gpu)) == costs
    assert banded_kernel.LAUNCHES["nw_right_edge"] == before + 12
    assert list(nw.nw_cost_batch(pairs[:40], device=gpu)) == [
        oracle.levenshtein(a, b) for a, b in pairs[:40]]
    assert nw.nw_cost(b"ACTCGCT", b"AACTCGTT", device=gpu) == 2


@pytest.mark.parametrize("count", [1, 37, 128])
def test_fill_kernels_match_plain(gpu, count):
    """K3 in both schedule modes against its plain versions: costs and both
    planes on every row, an n == 0 lane, bands of 1 word to full height and
    a schedule shifting at column 0 and at the last column; the shared mode
    (K3's ring) with its planes stored pair-major."""
    pairs = _random_pairs(300 + count, count, 300, 1300)
    args, _ = pack_batch_staggered(pairs, 1, device=gpu)
    n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
    before = dict(banded_kernel.LAUNCHES)
    for sw, diag in ((1, None), (8, None), (28, (n_max, S * 32 - 40)), (S, None)):
        got = banded_kernel.banded_fill(*args, sw, diag)
        assert got[1].shape == (n_max, min(sw, S), B)
        assert got[1].permute(2, 0, 1).is_contiguous()
        _assert_same(got, banded.banded_fill_ref(*args, sw, diag), (sw, diag))
    rng = np.random.default_rng(count)
    for sw, q in ((4, 32), (8, 1)):
        sched = np.zeros((n_max, B), np.uint8)
        rows = np.arange(0, n_max, q)
        sched[rows] = rng.random((len(rows), B)) < 0.2
        sched[0], sched[n_max - 1 - (n_max - 1) % q] = 1, 1
        got = banded_kernel.banded_fill_pp(*args, sched, sw, q)
        _assert_same(got, banded.banded_fill_pp_ref(*args, sched, sw, q), (sw, q))
    assert banded_kernel.LAUNCHES["banded_ring_fill"] == before["banded_ring_fill"] + 4
    assert banded_kernel.LAUNCHES["banded_fill"] == before["banded_fill"]
    assert banded_kernel.LAUNCHES["banded_fill_pp"] == before["banded_fill_pp"] + 2


def test_runner_trace_route_on_gpu(gpu):
    """``combined=False`` on the card: the cost ladder, then the fill arm
    (K3) for every bucket, CIGARs equal to the CPU route's."""
    pairs = [generate.uniform_seeded(900 + 37 * s, 0.08, 700 + s) for s in range(40)]
    kw = dict(band_words=8, direct_dt=False, combined=False)
    before = dict(banded_kernel.LAUNCHES)
    res, st = BatchAligner(device=gpu, **kw).align_with_stats(pairs)
    assert banded_kernel.LAUNCHES["banded_ring_fill"] > before["banded_ring_fill"]
    assert banded_kernel.LAUNCHES["banded_fill"] == before["banded_fill"]
    assert st.kernel == "cuda-banded-ring-fill"
    want = BatchAligner(device="cpu", **kw).align(pairs)
    assert [c.to_string() for _, c in res] == [c.to_string() for _, c in want]
    for (a, b), (c, cig) in zip(pairs, res):
        assert c == oracle.levenshtein(a, b) == cig.verify(a, b)


def test_block_kernel_on_gpu(gpu, monkeypatch):
    """The torch block DP on the card: the block aligner's costs and CIGARs
    equal those of its native block DP."""
    from dataclasses import replace

    from astarpa_tpu_torch.aligners.astarpa2 import AstarPa2Params
    from astarpa_tpu_torch.ops.block_kernel import BlockKernel

    pairs = [generate.uniform_seeded(600, e, 40 + k) for k, e in enumerate((0.05, 0.2))]
    want = [AstarPa2Params.simple().make_aligner(True).align(a, b) for a, b in pairs]
    monkeypatch.setattr(BlockKernel, "use_native", False)
    aligner = replace(AstarPa2Params.simple(), device=gpu).make_aligner(True)
    for (a, b), (c, cig) in zip(pairs, want):
        got = aligner.align(a, b)
        assert got[0] == c and got[1].to_string() == cig.to_string()


def _ck_spy(monkeypatch, names=("banded_ck", "striped_ck", "pinned_ck", "banded_ck_pp",
                                "pinned_ck_pp")):
    """Record every checkpoint wrapper's outputs the runner receives."""
    outs = []
    for name in names:
        def spy(*args, _fn=getattr(runner, name)):
            got = _fn(*args)
            outs.append(got)
            return got
        monkeypatch.setattr(runner, name, spy)
    return outs


def _lanes(outs, shards: int):
    """The checkpoint planes of each rung or round, their shards' joined on
    the lane axis, as host arrays."""
    rungs = [outs[k:k + shards] for k in range(0, len(outs), shards)]
    return [[torch.cat([part[i] for part in rung], dim=-1).cpu() for i in range(4)]
            for rung in rungs]


@pytest.mark.parametrize("mode", ["off", "gap"])
def test_mesh_two_shards_on_one_card(gpu, monkeypatch, mode):
    """``mesh=("cuda:0", "cuda:0")``: two shards, each on its own stream,
    give the unsharded costs, CIGARs, counters and checkpoint planes bit
    for bit (the unsharded lanes: the same pairs, then the same pad pairs),
    two launches a rung or round."""
    pairs = [generate.uniform_seeded(1500 + 37 * s, 0.05, 300 + s) for s in range(96)]
    kw = dict(band_words=4, domain_mode=mode, domain_min_bp=0, direct_dt=False)
    two = BatchAligner(mesh=("cuda:0", "cuda:0"), **kw)
    one = BatchAligner(device=gpu, **kw)
    costs, st = two.cost_with_stats(pairs)
    want, want_st = one.cost_with_stats(pairs)
    assert list(costs) == list(want)
    assert st == want_st
    outs = _ck_spy(monkeypatch)
    before = dict(banded_kernel.LAUNCHES)
    res, st = two.align_with_stats(pairs)
    launched = {k: v - before[k] for k, v in banded_kernel.LAUNCHES.items() if v > before[k]}
    sharded = _lanes(outs, 2)
    outs.clear()
    want_res, want_st = one.align_with_stats(pairs)
    plain = _lanes(outs, 1)
    assert [(c, g.to_string()) for c, g in res] == [(c, g.to_string()) for c, g in want_res]
    assert st == want_st
    assert len(sharded) == len(plain) >= 1
    assert sum(launched.values()) == 2 * len(sharded), launched
    for got, ref in zip(sharded, plain):
        for g, w in zip(got, ref):
            assert torch.equal(g[..., :w.shape[-1]], w)
    for (a, b), (c, g) in zip(pairs, res):
        assert g.verify(a, b) == c == oracle.levenshtein(a, b)


def test_dryrun_multichip_on_one_card(gpu, capsys):
    from astarpa_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(2, devices=["cuda:0"] * 2)
    assert "dryrun_multichip OK on 2 devices" in capsys.readouterr().out


def test_mesh_shards_run_the_buckets_cost_ring(gpu):
    """Two shards of one card on a bucket whose first pair alone fits K7's
    ring and whose second needs the wide ring: both shards launch the
    wide ring the label names, with the unsharded costs."""
    pairs = [(generate.uniform_seeded(n, 0.0, s)[0], generate.uniform_seeded(m, 0.1, s + 1)[0])
             for n, m, s in ((4000, 120_000, 1), (4500, 140_000, 3))]
    kw = dict(band_words=8, lane_multiple=1, max_band_doublings=0, domain_mode="off")
    before = dict(banded_kernel.LAUNCHES)
    costs, st = BatchAligner(mesh=("cuda:0", "cuda:0"), **kw).cost_with_stats(pairs)
    launched = {k: v - before[k] for k, v in banded_kernel.LAUNCHES.items() if v > before[k]}
    assert launched == {"ring_cost_wide": 2}
    assert st.kernel == banded_kernel.route(torch.device(gpu), "ring_cost_wide")
    want, want_st = BatchAligner(device=gpu, **kw).cost_with_stats(pairs)
    assert list(costs) == list(want) == [oracle.levenshtein_myers(a, b) for a, b in pairs]
    assert st == want_st
