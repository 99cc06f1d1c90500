"""K4's and K3's ring kernels on what the CPU can check: the plain
staggered twins (``pinned.banded_cost_pp_staggered_ref``,
``pinned.banded_ck_pp_staggered_ref`` and
``striped.banded_fill_staggered_ref``: K4's and K3's functions computed in
the order the rings compute them, word w at column ``t - w``) against K4's
and K3's plain versions bit for bit, on gcsh, gap and random per-pair
schedules at Q 1 and 8 (a shift at column 0, windows sliding past the last
word to the ``S - 1`` clamp, pairs far shorter than n_max so that
checkpoints and fill rows lie past their end, n == 0, row m above, inside
and below the window); the rings' launch layout for per-pair spans; the
host test that sends an interval below SW to the old K4; the domain
ladder's schedules never shifting at column 0; and the runner's labels for
K4's rounds and K3's fill.  K4's and K3's plain versions are held to the
JAX package in ``test_torch_perpair.py`` and ``test_torch_fill.py``; the
CUDA kernels' own tests are in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu_torch import BatchAligner
from astarpa_tpu_torch import domain as tdomain
from astarpa_tpu_torch.ops import _build, banded, banded_kernel, pinned, striped
from astarpa_tpu_torch.ops.bitpack import W
from astarpa_tpu_torch.ops.pack import pack_batch_staggered
from astarpa_tpu_torch.parallel import runner

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _pack():
    """Similar pairs of up to 300 bp (most far shorter than n_max), random
    pairs beside b of up to 900 bp, an n == 0 pair, a short a against a
    long b (row m below the window) and a long a against a short b (above
    it)."""
    rng = np.random.default_rng(12)

    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [generate.uniform_seeded(int(rng.integers(1, 300)), 0.15, 600 + s)
             for s in range(10)]
    pairs += [(seq(int(rng.integers(1, 200))), seq(int(rng.integers(200, 900))))
              for _ in range(4)]
    pairs += [(b"", seq(90)), (b"ACG", seq(700)), (seq(290), b"ACGTAC")]
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    return pairs, args


def _gcsh(pairs, n_max: int):
    """The pairs' gcsh schedules at f = 1.25 h0, as the domain ladder
    samples them, with their band and quantum."""
    sched = np.zeros((n_max, len(pairs)), np.uint8)
    sw, q = 1, 32
    for slot, (a, b) in enumerate(pairs):
        if not a or not b:
            continue
        h = native.DomainHandle(a, b, k=10, r=2)
        f = max(int(h.h0 * 1.25), 64)
        ps = tdomain.domain_schedule(h.sample(f, 64))
        while ps is None:
            f += max(f // 4, 64)
            ps = tdomain.domain_schedule(h.sample(f, 64))
        h.close()
        sched[: len(ps.sched), slot] = ps.sched
        sw, q = max(sw, ps.band_words), min(q, ps.quantum)
    return sched, sw, q


def _schedule(kind: str, q: int, sw: int, pairs, args):
    """A per-pair schedule: random shifts at multiples of ``q`` (every
    third lane also at column 0, every fifth at every quantum column, so
    its window slides past the last word), the pairs' gap schedules, or
    their gcsh schedules (whose band and quantum they return)."""
    a0, _, pb0, _, n, m = args
    n_max, S, B = a0.shape[0], pb0.shape[0], a0.shape[1]
    if kind == "gcsh":
        return _gcsh(pairs, n_max)
    if kind == "gap":
        return banded.pair_gap_schedule(n, m, sw, n_max, S)[0], sw, 32
    rng = np.random.default_rng(sw * 10 + q)
    sched = np.zeros((n_max, B), np.uint8)
    rows = np.arange(0, n_max, q)
    sched[rows] = rng.random((len(rows), B)) < 0.03 * q
    sched[0, ::3] = 1
    sched[rows, ::5] = 1
    return sched, sw, q


CASES = [("random", 1, 1), ("random", 1, 5), ("random", 8, 2), ("random", 8, 16),
         ("gap", 32, 4), ("gcsh", 0, 0)]


def _kinds(args, sched, sw):
    """What the pack holds at this schedule: n == 0, and row m above,
    inside and below the window at each pair's last column."""
    a0, _, pb0, _, n, m = args
    n_max, B = a0.shape
    n_h, m_h = np.asarray(n, np.int64), np.asarray(m, np.int64)
    lo_end = np.cumsum(sched, 0)[np.clip(n_h - 1, 0, n_max - 1), np.arange(B)]
    rows = m_h - lo_end * W
    SW = min(sw, pb0.shape[0])
    return {"n0" if nn == 0 else "above" if r < 0 else "below" if r > SW * W else "covered"
            for nn, r in zip(n_h, rows)}


@pytest.mark.parametrize("kind,q,sw", CASES)
def test_k4_cost_twin_equals_k4(kind, q, sw):
    """K4's staggered cost twin equals K4's plain version bit for bit."""
    if kind == "gcsh" and not native.available():
        pytest.skip("native toolchain unavailable")
    pairs, args = _pack()
    sched, sw, q = _schedule(kind, q, sw, pairs, args)
    want = banded.banded_cost_pp_ref(*args, sched, sw, q)
    got = pinned.banded_cost_pp_staggered_ref(*args, sched, sw, q)
    assert torch.equal(got, want)
    kinds = _kinds(args, sched, sw)
    assert "n0" in kinds and ("covered" in kinds or sw < 4)
    n = np.asarray(args[4])
    assert int(want[n == 0][0]) == int(np.asarray(args[5])[n == 0][0])  # cost m
    if kind == "random":
        assert sched[0].any() and {"above", "below"} <= kinds


@pytest.mark.parametrize("kind,q,sw", CASES)
def test_k4_ck_twin_equals_k4(kind, q, sw):
    """K4's staggered checkpoint twin equals K4's plain version bit for bit
    on costs, every checkpoint row and top value, at CB = SW (Q-rounded)
    and larger; checkpoints past a pair's end hold its last window, slid,
    with K4's top value."""
    if kind == "gcsh" and not native.available():
        pytest.skip("native toolchain unavailable")
    pairs, args = _pack()
    sched, sw, q = _schedule(kind, q, sw, pairs, args)
    n_max, S = args[0].shape[0], args[2].shape[0]
    past = 0
    for cb in sorted({max(min(sw, S), q), 24, 64}):
        if banded.ck_col_block(cb, n_max, q) < min(sw, S):
            continue
        want = banded.banded_ck_pp_ref(*args, sched, sw, cb, q)
        got = pinned.banded_ck_pp_staggered_ref(*args, sched, sw, cb, q)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), cb
        CB = banded.ck_col_block(cb, n_max, q)
        past += int(((np.arange(len(want[3]))[:, None] * CB) > np.asarray(args[4])).sum())
    assert past > 0


def test_k4_ring_refuses_overlapping_windows():
    """An interval below SW with several checkpoints: the twin raises (as
    K10's plain version does) and the wrapper's host test sends it to the
    old K4; one checkpoint, or CB >= SW, goes to the ring."""
    pairs, args = _pack()
    n_max, B = args[0].shape
    sched = np.zeros((n_max, B), np.uint8)
    with pytest.raises(ValueError, match="col_block"):
        pinned.banded_ck_pp_staggered_ref(*args, sched, 16, 8, 8)
    assert not pinned.k4_ring_takes(n_max, 16, 8, 8)
    assert banded_kernel.k4_kernel(n_max, 16, 8, 8) == "banded_ck_pp"
    assert banded_kernel.k4_kernel(n_max, 16, 16, 8) == "banded_ring_ck_pp"
    assert banded_kernel.k4_kernel(n_max, 16, n_max, 1) == "banded_ring_ck_pp"
    assert banded_kernel.k4_kernel(n_max, 16) == "banded_ring_pp"


def test_fill_plane_limit_is_per_pair():
    """K3's ring indexes each pair's planes from a 64-bit base, so a batch
    whose planes hold 2^32 words or more is taken (1024 pairs of 100 kbp
    at 64 words: 6.5G words, ~26 GB a plane); only one pair's plane of
    2^31 words is refused, before any allocation."""
    banded_kernel.fill_plane_check(102_400, 64)
    assert 102_400 * 64 * 1024 >= 1 << 32
    banded_kernel.fill_plane_check((1 << 31) // 64 - 1, 64)
    with pytest.raises(ValueError, match="2\\^31"):
        banded_kernel.fill_plane_check((1 << 31) // 64, 64)
    assert "(size_t)p * n_max * SW" in (_build.CSRC / "pinned.cu").read_text()


@pytest.mark.parametrize("sw", [1, 8, 28, 32, 64, "S"])
def test_fill_twin_equals_k3(sw):
    """K3's staggered fill twin equals K3's plain version bit for bit on
    costs and both planes on every row: rows past a pair's end hold its
    last window slid down the schedule, words entering after the end
    all-ones; with and without a diagonal, and (at SW 8) a diagonal whose
    only shift is at column 0."""
    rng = np.random.default_rng(24)

    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [generate.uniform_seeded(int(rng.integers(1, 100)), 0.1, 40 + s) for s in range(8)]
    pairs += [(b"", seq(37)), (b"GATTACA" * 14, b"TACGGA" * 380), (seq(99), seq(60))]
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    n_max, S = args[0].shape[0], args[2].shape[0]
    sw = S if sw == "S" else sw
    diags = [None, (n_max, S * W - 50)]
    if sw == 8:
        diags.append((1, (8 * 32 // 2 + 32) * 2))
        assert banded.shift_at_array(n_max, S, 8, diags[-1])[:2].tolist() == [1, 0]
    for diag in diags:
        want = banded.banded_fill_ref(*args, sw, diag)
        got = striped.banded_fill_staggered_ref(*args, sw, diag)
        for g, w in zip(got, want, strict=True):
            assert torch.equal(g, w), diag


@pytest.mark.parametrize("kind,q,sw", CASES[:5])
def test_k4_ring_layout_for_per_pair_spans(kind, q, sw):
    """K4's ring holds the most words any pair keeps live up to its own
    last capture (``ring_span_pp`` at each pair's n, never more than the
    band): the fewest lanes, a power of two, whose 8 slots hold it and one
    more, 32 // lanes pairs a warp; past 2048 live words K4's and K3's
    rings refuse."""
    pairs, args = _pack()
    sched, sw, q = _schedule(kind, q, sw, pairs, args)
    n = np.asarray(args[4], np.int64)
    SW = min(sw, args[2].shape[0])
    plan = pinned.plan_pp(sched, n, SW, "cpu")
    spans = pinned.ring_span_pp(plan, np.maximum(n, 1), SW)
    span = int(spans.max())
    assert 1 <= span <= SW
    assert (spans <= pinned.ring_span_pp(plan, np.full_like(n, args[0].shape[0]), SW)).all()
    lay = banded_kernel.banded_ring_layout(span, len(n), max_words=banded_kernel.RING_K4_MAX_WORDS)
    lanes = lay["lanes"]
    assert lanes * 8 > span and (lanes == 1 or lanes * 4 <= span)
    assert lay["pairs"] * lanes == 32 and lay["blocks"] * lay["pairs"] >= len(n)
    for bad in (banded_kernel.RING_K4_MAX_WORDS + 1, banded_kernel.RING_MAX_WORDS):
        with pytest.raises(ValueError, match="live words"):
            banded_kernel.banded_ring_layout(bad, 4, max_words=banded_kernel.RING_K4_MAX_WORDS)
    assert banded_kernel.banded_ring_layout(
        2048, 4, max_words=banded_kernel.RING_K4_MAX_WORDS)["lanes"] == 256


@pytest.mark.parametrize("seed", range(3))
def test_domain_schedules_never_shift_at_column_0(seed):
    """The domain ladder's schedules (gap hulls through ``domain_schedule``,
    and ``pair_gap_schedule``) start every band at word 0, so K9 and K10,
    which refuse a shift at column 0, take them; K4's ring takes one
    anyway."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n = int(rng.integers(1, 3000))
        m = max(0, n + int(rng.integers(-n // 2, n // 2 + 1)))
        ps = tdomain.domain_schedule(tdomain.gap_domain(n, m, int(rng.integers(0, 400)), 64))
        assert ps is None or not ps.sched[:1].any()
    n = rng.integers(1, 5000, 64)
    m = np.maximum(0, n + rng.integers(-2000, 2000, 64))
    sched, _ = banded.pair_gap_schedule(n, m, 4, int(n.max()), int(-(-m.max() // 32)))
    assert not sched[0].any()


@needs_native
def test_runner_labels_k4_rounds_and_the_fill_as_rings(monkeypatch):
    """Domain rounds below PINNED_PP_MIN_SW run K4, labelled as K4's rings
    on the card (cost and checkpoint rounds), and the trace route's fill
    K3's ring (the route patched as on the card); costs and CIGARs equal
    the oracle's."""
    monkeypatch.setattr(runner, "route", lambda device, kernel="banded_cost":
                        banded_kernel._LABELS[kernel])
    pairs = [generate.uniform_seeded(400 + 53 * s, 0.08, 960 + s) for s in range(4)]
    want = [oracle.levenshtein(a, b) for a, b in pairs]
    kw = dict(band_words=4, device="cpu", domain_mode="gap", domain_min_bp=0)
    costs, stats = BatchAligner(**kw).cost_with_stats(pairs)
    assert list(costs) == want and stats.kernel == "cuda-banded-ring-pp"
    res, stats = BatchAligner(direct_dt=False, **kw).align_with_stats(pairs)
    assert stats.kernel == "cuda-banded-ring-ck-pp"
    res2, stats2 = BatchAligner(band_words=8, device="cpu", direct_dt=False,
                                combined=False).align_with_stats(pairs)
    assert stats2.kernel == "cuda-banded-ring-fill"
    for (a, b), (c, cig), (c2, cig2), w in zip(pairs, res, res2, want):
        assert cig.verify(a, b) == c == c2 == cig2.verify(a, b) == w
    for key, label in (("banded_ring_pp", "cuda-banded-ring-pp"),
                       ("banded_ring_ck_pp", "cuda-banded-ring-ck-pp"),
                       ("banded_ring_fill", "cuda-banded-ring-fill")):
        assert banded_kernel.route(torch.device("cuda"), key) == label
        assert banded_kernel.route(torch.device("cpu"), key) == "torch-ref"
