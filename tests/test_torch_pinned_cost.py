"""The port's resident-ring big-band cost kernel K7: its plain version
against the JAX package's ``pinned_cost_tpu`` in interpret mode and against
the plain K5 (``striped_cost_ref``), the ring capacity rule against a brute
force over every step, and the runner's K5/K7 routing against the reference
``BatchAligner``.  The CUDA kernel's own test is in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, oracle
from astarpa_tpu.ops.pallas_myers import pack_batch_staggered as jpack
from astarpa_tpu.ops.pinned import pinned_cost_tpu
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner
from astarpa_tpu_torch.ops import banded, banded_kernel, striped, words
from astarpa_tpu_torch.ops.pack import pack_batch_staggered
from astarpa_tpu_torch.parallel import runner

torch.set_num_threads(1)


def _packed(pairs):
    """Reference pack (B = 128) as numpy, and the same planes for the port."""
    args, B0 = jpack(pairs, lane_multiple=128)
    args = tuple(np.asarray(x) for x in args)
    return args, words.planes_from_numpy(*args, "cpu"), B0


@pytest.fixture(scope="module")
def mixed():
    """tests/test_pinned.py:12-50's 128 pairs (four error models)."""
    return _packed([
        generate.generate_model(100 + (s * 29) % 150, [0.0, 0.05, 0.15, 0.3][s % 4],
                                list(generate.ErrorModel)[s % 4], 60 + s)
        for s in range(128)
    ])


@pytest.fixture(scope="module")
def tall():
    """128 pairs of 500-800 bp: S = 26 words, so bands of 4 and 12 words
    move across the profile."""
    return _packed([
        generate.uniform_seeded(500 + (s * 97) % 300, [0.03, 0.12, 0.25][s % 3], 300 + s)
        for s in range(128)
    ])


@pytest.mark.parametrize("case,sw,tb", [("mixed", 4, 128), ("mixed", 12, 128),
                                        ("mixed", "S", 64), ("tall", 4, 128),
                                        ("tall", 12, 64), ("tall", "S", 128)])
def test_plain_k7_matches_pallas(request, case, sw, tb):
    """Bit for bit with ``pinned_cost_tpu`` (its time blocks compacting the
    resident window at TB = 64) and with the plain K5."""
    args, planes, _ = request.getfixturevalue(case)
    S = args[2].shape[0]
    sw = S if sw == "S" else sw
    want = np.asarray(pinned_cost_tpu(*args, band_words=sw, time_block=tb, interpret=True))
    got = banded_kernel.pinned_cost(*planes, sw)  # the CPU route: plain
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, striped.striped_cost_ref(*planes, sw))
    assert (want < banded.INF).sum() > 32


def test_plain_k7_compaction_case():
    """tests/test_pinned.py:52-70: 250 bp pairs at SW = 6, TB = 64, the
    band aimed at the longest b (the default aim at S * 32 rows certifies
    none of them); the certified costs are the oracle's."""
    pairs = [generate.uniform_seeded(250, 0.1, 10 + s) for s in range(128)]
    args, planes, B0 = _packed(pairs)
    diag = (args[0].shape[0], int(args[5].max()))
    want = np.asarray(pinned_cost_tpu(*args, band_words=6, time_block=64, interpret=True,
                                      diag=diag))
    got = striped.pinned_cost_ref(*planes, 6, diag).numpy()
    assert np.array_equal(got, want)
    thr = banded.band_threshold(6, args[4][:B0], args[5][:B0], *diag)
    ok = np.flatnonzero(got[:B0] <= thr)
    assert len(ok) > 64
    for p in ok[::8]:
        assert got[p] == oracle.levenshtein(*pairs[p])


@pytest.mark.parametrize("seed", range(4))
def test_plain_k7_equals_plain_k5(seed):
    """Ragged lengths with n == 0 and m == 0 lanes, a skewed pair, with and
    without a diagonal."""
    rng = np.random.default_rng(seed)
    pairs = [generate.uniform_seeded(int(rng.integers(1, 400)), float(rng.uniform(0, 0.3)),
                                     40 * seed + s) for s in range(9)]
    pairs[1] = (b"", b"ACGTA")
    pairs[2] = (pairs[2][0], b"")
    pairs[3] = (b"ACGTTGCA", generate.uniform_seeded(900, 0.1, seed)[0])
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    n_max, S = args[0].shape[0], args[2].shape[0]
    for sw in (1, 3, 8, S):
        for diag in (None, (n_max, max(len(b) for _, b in pairs[4:]))):
            got = banded_kernel.pinned_cost(*args, sw, diag)
            assert torch.equal(got, striped.striped_cost_ref(*args, sw, diag)), (sw, diag)


def _brute_span(plan, n_lim: int) -> int:
    """Most live words over every step a pair can need, by definition: the
    words with ``ent_t <= t < end_t``, counted at every step ``t`` (each
    word adds one from its entry and takes it back at its end)."""
    ent = plan["ent_t"].astype(np.int64)
    ab = plan["abs_t"].astype(np.int64)
    w = np.arange(len(ent))
    end = np.minimum(np.where(ab < striped.NEVER, ab + 1, striped.NEVER), n_lim + w)
    SW = len(ent) - int(plan["lo"][-1])
    t_stop = n_lim - 1 + int(plan["lo"][n_lim - 1]) + SW
    live = np.zeros(t_stop + 1, np.int64)
    np.add.at(live, np.minimum(ent, t_stop), 1)
    np.add.at(live, np.minimum(end, t_stop), -1)
    return int(np.cumsum(live)[:t_stop].max())


@pytest.mark.parametrize("seed", range(6))
def test_ring_span_is_the_most_live_words(seed):
    """``ring_span`` against a count of live words at every step, on random
    geometries, diagonals and column limits; never more than the band."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(8):
        n_max = int(rng.integers(8, 400))
        S = int(rng.integers(1, min(60, n_max) + 1))  # at most a shift a column
        SW = int(rng.integers(1, S + 1))
        diag = None if rng.random() < 0.3 else (n_max, int(rng.integers(1, S * 32 + 1)))
        n_lim = int(rng.integers(1, n_max + 1))
        plan = striped.plan_striped(n_max, S, SW, diag)
        span = striped.ring_span(plan, n_lim)
        assert span == _brute_span(plan, n_lim), (n_max, S, SW, diag, n_lim)
        assert 1 <= span <= SW


def test_ring_capacity_rule():
    """Ring K6 and ring K9: the least warp multiple of 256 words,
    ``ring_words`` checked, more than 4096 live words raise.  The shared
    cost ring takes more: a full height over 4375 words with 4500 columns
    (every word stays live) runs the wide ring, and more than 16384 live
    words raise on both routes, before any work."""
    assert banded_kernel.ring_threads(1) == 32
    assert banded_kernel.ring_threads(257) == 64
    assert banded_kernel.ring_threads(4096) == 512
    assert banded_kernel.ring_threads(100, 512) == 64
    for bad in (100, 200, 4352):
        with pytest.raises(ValueError, match="ring_words"):
            banded_kernel.ring_threads(150, bad)
    with pytest.raises(ValueError, match="exceed"):
        banded_kernel.ring_threads(4097)
    pairs = [(generate.uniform_seeded(4500, 0.0, 1)[0], generate.uniform_seeded(140_000, 0.1, 2)[0])]
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    n_max, S = args[0].shape[0], args[2].shape[0]
    assert S > 4096 and banded_kernel.pinned_cost_takes(S)
    assert banded_kernel.pinned_cost_kernel(n_max, S, S, None, args[4]) == "ring_cost_wide"
    assert banded_kernel.pinned_cost_takes(16384) and not banded_kernel.pinned_cost_takes(16385)
    # Full height over 16563 words with 16400 columns: 16400 live words.
    pairs = [(generate.uniform_seeded(16_400, 0.0, 3)[0],
              generate.uniform_seeded(530_000, 0.1, 4)[0])]
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    S = args[2].shape[0]
    with pytest.raises(ValueError, match="exceed"):
        banded_kernel.pinned_cost(*args, S)


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        fn = getattr(runner, name)

        def spy(*args, _fn=fn, _name=name):
            calls.append((_name, args[6]))
            return _fn(*args)

        monkeypatch.setattr(runner, name, spy)
    return calls


def test_runner_routes_cost_rungs_to_k7(monkeypatch):
    """8.4-8.6 kbp pairs (S = 274 words) from a 32-word band with one
    doubling, every band routed to the big-band kernels: rung 0 (two
    256-word stripes in K5) and the full-height rung that a reversed pair
    needs (one stripe in K5) both run K7.  Costs and BatchStats equal the
    reference's, whose ladder ran the sliding kernel; the certified costs
    of rung 0 are the oracle's."""
    pairs = [generate.uniform_seeded(8400 + 50 * s, [0.02, 0.05, 0.1][s], 900 + s)
             for s in range(3)]
    a, _ = generate.uniform_seeded(8500, 0.0, 903)
    pairs.append((a, a[::-1]))
    kw = dict(band_words=32, lane_multiple=8, domain_mode="off", max_band_doublings=1)
    monkeypatch.setattr(runner, "STRIPED_MIN_SW", 1)
    calls = _spy(monkeypatch, ["pinned_cost", "striped_cost", "banded_cost"])
    ref_costs, ref_stats = RefAligner(**kw).cost_with_stats(pairs)
    costs, stats = BatchAligner(device="cpu", **kw).cost_with_stats(pairs)
    # The full height S of the shape-quantized pack (n_max 8704) is 274.
    assert calls == [("pinned_cost", 32), ("pinned_cost", 274)], (calls, stats)
    assert banded_kernel.striped_threads(274) * 8 == 512
    assert list(costs) == list(ref_costs)
    for f in ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp"):
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert (stats.buckets, stats.band_retries, stats.kernel) == (1, 1, "torch-ref")
    for (a, b), c in list(zip(pairs, costs))[:2]:
        assert c == oracle.levenshtein(a, b)


def _skewed_pairs():
    """A skewed pair (m > 32 n) whose full height is 4125 words, and a
    short pair in a bucket of its own."""
    return [(generate.uniform_seeded(300, 0.1, 5)[0],
             generate.uniform_seeded(132_000, 0.1, 6)[0]),
            generate.uniform_seeded(500, 0.1, 7)]


def test_runner_routes_past_the_ring_to_k5(monkeypatch):
    """A rung of more words than the shared cost ring holds runs K5: the
    skewed pair's full height of 4125 words with the ring's capacity
    patched to 4096 (no configuration reaches the real 16384); the short
    pair beside it stays on K1.  The costs are the oracle's."""
    pairs = _skewed_pairs()
    monkeypatch.setattr(banded_kernel, "RING_COST_MAX_WORDS", banded_kernel.RING_MAX_WORDS)
    calls = _spy(monkeypatch, ["pinned_cost", "striped_cost", "banded_cost"])
    costs, stats = BatchAligner(device="cpu", lane_multiple=8,
                                domain_mode="off").cost_with_stats(pairs)
    assert calls == [("striped_cost", 4125), ("banded_cost", 8)], calls
    assert not banded_kernel.pinned_cost_takes(4125)
    assert list(costs) == [oracle.levenshtein_myers(a, b) for a, b in pairs]
    assert (stats.buckets, stats.band_retries) == (2, 0)


def test_runner_routes_wide_rungs_to_the_wide_ring(monkeypatch):
    """A full-height rung of 4481 words over 4500 columns (more live words
    than K7's 4096) runs the shared cost ring,
    labelled by the design that runs it: the wide ring
    (``ring_cost_wide``, ``cuda-ring-wide`` on the card); the skewed
    pair's full height of 4125 words has only 300 columns, so at most 300
    live words, and runs K7.  The costs are the oracle's."""
    pairs = [(generate.uniform_seeded(4500, 0.0, 1)[0],
              generate.uniform_seeded(140_000, 0.1, 2)[0]), _skewed_pairs()[0]]
    calls = _spy(monkeypatch, ["pinned_cost", "striped_cost", "banded_cost"])
    labels = []

    def route(device, kernel="banded_cost"):
        labels.append(kernel)
        return banded_kernel.route(device, kernel)

    monkeypatch.setattr(runner, "route", route)
    costs, stats = BatchAligner(device="cpu", lane_multiple=8, domain_mode="off",
                                max_band_doublings=0).cost_with_stats(pairs)
    # The runner's shape-quantized bucket of the 4500 x 140 kbp pair has a
    # full height of 4481 words.
    assert sorted(calls) == [("pinned_cost", 4125), ("pinned_cost", 4481)], calls
    assert sorted(labels) == ["pinned_cost", "ring_cost_wide"], labels
    assert banded_kernel.route(torch.device("cuda"), "ring_cost_wide") == "cuda-ring-wide"
    assert list(costs) == [oracle.levenshtein_myers(a, b) for a, b in pairs]
    assert (stats.buckets, stats.band_retries, stats.kernel) == (2, 0, "torch-ref")


@pytest.mark.parametrize("sw", [4352, 8192, 16384])
def test_ring_span_at_wide_bands(sw):
    """``ring_span`` against the count of live words at every step at the
    wide ring's bands, on random geometries (up to a shift a column),
    diagonals and column limits: never more than the band, so the shared
    cost ring holds every rung of up to 16384 words."""
    rng = np.random.default_rng(sw)
    for _ in range(4):
        S = int(rng.integers(sw, sw + 2000))
        n_max = int(rng.integers(S, 3 * S))
        diag = None if rng.random() < 0.3 else (n_max, int(rng.integers(1, S * 32 + 1)))
        n_lim = int(rng.integers(1, n_max + 1))
        plan = striped.plan_striped(n_max, S, sw, diag)
        span = striped.ring_span(plan, n_lim)
        assert span == _brute_span(plan, n_lim), (n_max, S, diag, n_lim)
        assert 1 <= span <= sw
        threads, words = banded_kernel.ring_cost_layout(span)
        assert span <= threads * words <= banded_kernel.RING_COST_MAX_WORDS


def test_ring_cost_layout_at_wide_sizes():
    """The shared cost ring's block: K7's 8 slots a thread up to 4096 live
    words, then 16 (up to 8192) and 32 (up to 16384) slots, the least warp
    multiple of threads; forced sizes checked; the event table padded one
    ring past the live words; more than 16384 live words raise.  Ring K6
    and ring K9 still stop at 4096."""
    layout = banded_kernel.ring_cost_layout
    assert [layout(s) for s in (1, 4096, 4097, 4352, 8192, 8193, 15742, 16384)] == [
        (32, 8), (512, 8), (288, 16), (288, 16), (512, 16), (288, 32), (512, 32), (512, 32)]
    assert layout(100, 256) == (32, 8) and layout(100, 512, 16) == (32, 16)
    assert layout(100, 1024, 32) == (32, 32) and layout(100, None, 32) == (32, 32)
    assert layout(4352, 8192) == (512, 16)
    for args, match in (((16385,), "exceed"), ((5000, None, 8), "exceed"),
                        ((150, 4352), "ring_words"), ((600, 512, 16), "ring_words"),
                        ((150, None, 12), "thread_words")):
        with pytest.raises(ValueError, match=match):
            layout(*args)
    for S, sw in ((4800, 4352), (9000, 8192), (17000, 16384)):
        plan = striped.plan_striped(3 * S, S, sw, None)
        threads, words = layout(striped.ring_span(plan, 3 * S))
        rw = threads * words
        ev = banded_kernel.ring_events(plan, rw)
        nwl = plan["n_words_live"]
        assert ev.shape[1] % rw == 0 and nwl + rw <= ev.shape[1] < nwl + 2 * rw
        assert (ev[:, nwl:] == striped.NEVER).all()
        assert np.array_equal(ev[2, :nwl], plan["abs_t"])
    assert banded_kernel.ring_takes(4096) and not banded_kernel.ring_takes(4097)
    assert banded_kernel.RING_MAX_WORDS == 4096 and banded_kernel.RING_COST_MAX_WORDS == 16384


def test_ring_step_variants_build_from_the_source():
    """``ops.ring_step``'s timed variants are edits of ``csrc/pinned.cu``:
    each one applies to the source as it stands and ends in the variant
    entry, the K7 of ``pinned_ring_kernel`` or of ``ring_cost_kernel``."""
    from astarpa_tpu_torch.ops import _build, ring_step

    src = (_build.CSRC / "pinned.cu").read_text()
    texts = ring_step.variants(src)
    assert sorted(texts) == sorted(
        ["pinned_ring", "pinned_ring_noevent", "pinned_ring_nomove", "pinned_ring_floor",
         "ring_cost", "ring_cost_notop", "ring_cost_nohandler", "ring_cost_nohandler_nobar",
         "ring_cost_alu", "ring_cost_alu_nohandler", "ring_cost_alu_nohandler_nobar",
         "ring_cost_full", "ring_cost_full_nohandler_nobar"])
    for name, text in texts.items():
        assert text.count("astarpa_ring_variant") == 1, name
        call = "launch_cost<0>" if name.startswith("ring_cost") else "launch<false, false>"
        assert call in text.split("astarpa_ring_variant")[1], name
        assert (text.startswith(src)) == (name in ("pinned_ring", "ring_cost")), name
    assert "if (false) {" in texts["ring_cost_nohandler"]
    assert "const bool multi = false;" in texts["ring_cost_nohandler_nobar"]
    # K7 runs the split word step; the _alu variants the ALU pipe's alone.
    for name, text in texts.items():
        split = "constexpr bool kSplit = kMode == kRingCost;" in text
        assert split == (not name.startswith("ring_cost_alu")), name
    assert "const bool multi = false;" in texts["ring_cost_alu_nohandler_nobar"]
    # The full split: both carry bits from IMAD.HI, both shifts multiply-adds.
    for name in ("ring_cost_full", "ring_cost_full_nohandler_nobar"):
        step = texts[name].split("void word_step_split(")[1].split("\n}\n")[0]
        assert step.count("__umulhi") == 2 and "__funnelshift_l" not in step, name
    assert "const bool multi = false;" in texts["ring_cost_full_nohandler_nobar"]
    assert "xa0[j] = a0" not in texts["pinned_ring_nomove"].split("pinned_ring_kernel(")[1]

