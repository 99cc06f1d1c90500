"""The port's redesigned big-band kernels, ring K6 (checkpoints on the
shared schedule) and ring K9 (costs on per-pair schedules), on what the CPU
can check: the ring capacities (``striped.ring_span`` at ``n_lim =
n_max``, ``pinned.ring_span_pp``) against a brute force over every step,
the per-pair ring event table against the shared one, the ring invariants
the checkpoint rows rely on, and the runner's routing of ck rungs and
domain rounds between the ring and stripe kernels against the reference
``BatchAligner``.  The kernels compute the functions of the plain
versions ``striped_ck_ref`` and ``pinned_cost_pp_ref``, whose parity with
the JAX package is tested in ``test_torch_striped.py`` and
``test_torch_pinned.py``; the CUDA kernels' own tests are in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.ops.pinned import pinned_ck_pp_tpu, pinned_cost_pp_tpu
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch import BatchAligner
from astarpa_tpu_torch.ops import banded, banded_kernel, pinned, striped
from astarpa_tpu_torch.ops.pack import pack_batch_staggered
from astarpa_tpu_torch.parallel import runner

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)

STATS = ("pairs", "buckets", "band_retries", "cells_computed", "aligned_bp",
         "direct_traces")


def _brute_span(ent, ab, lo, n_lim: int, SW: int) -> int:
    """Most live words over every step a sweep stopping after column
    ``n_lim - 1`` can need, by definition (word w live at ``[ent_t[w],
    end_t[w])``)."""
    ent, ab = np.asarray(ent, np.int64), np.asarray(ab, np.int64)
    w = np.arange(len(ent))
    end = np.minimum(np.where(ab < striped.NEVER, ab + 1, striped.NEVER), n_lim + w)
    t_stop = n_lim - 1 + int(lo[n_lim - 1]) + SW
    return max(int(((ent <= t) & (t < end)).sum()) for t in range(t_stop))


def _random_geometry(rng):
    n_max = int(rng.integers(8, 400))
    S = int(rng.integers(1, min(60, n_max) + 1))  # at most a shift a column
    SW = int(rng.integers(1, S + 1))
    diag = None if rng.random() < 0.3 else (n_max, int(rng.integers(1, S * 32 + 1)))
    return n_max, S, SW, diag


@pytest.mark.parametrize("seed", range(4))
def test_ring_span_at_n_max_is_the_most_live_words(seed):
    """Ring K6 sizes its ring at ``n_lim = n_max`` (its rows are defined up
    to the last column): ``ring_span`` there against a count of live words
    at every step, never more than the band."""
    rng = np.random.default_rng(200 + seed)
    for _ in range(8):
        n_max, S, SW, diag = _random_geometry(rng)
        plan = striped.plan_striped(n_max, S, SW, diag)
        span = striped.ring_span(plan, n_max)
        assert span == _brute_span(plan["ent_t"], plan["abs_t"], plan["lo"], n_max,
                                   min(SW, S)), (n_max, S, SW, diag)
        assert 1 <= span <= SW


def _random_pp_schedule(rng, n_max: int, B: int, q: int, rate: float) -> np.ndarray:
    sched = np.zeros((n_max, B), np.uint8)
    rows = np.arange(q, n_max, q)
    sched[rows] = rng.random((len(rows), B)) < rate
    return sched


@pytest.mark.parametrize("seed", range(4))
def test_ring_span_pp_is_each_pairs_most_live_words(seed):
    """``ring_span_pp`` per pair against the brute force on random per-pair
    schedules (quantum 1, 8, 32, sparse and dense shifts) with each pair's
    own last column, never more than the band."""
    rng = np.random.default_rng(300 + seed)
    for q in (1, 8, 32):
        n_max, S, SW, _ = _random_geometry(rng)
        B = int(rng.integers(1, 9))
        sched = _random_pp_schedule(rng, n_max, B, q, float(rng.uniform(0.05, 0.9)))
        n = rng.integers(0, n_max + 1, B)
        plan = pinned.plan_pp(sched, n, SW, "cpu")
        n_lim = np.maximum(n, 1)
        got = pinned.ring_span_pp(plan, torch.as_tensor(n_lim), SW).tolist()
        lo = plan["lo"].numpy()
        for p in range(B):
            want = _brute_span(plan["ent_t"][p].numpy(), plan["abs_t"][p].numpy(), lo[p],
                               int(n_lim[p]), SW)
            assert got[p] == want, (q, p, n_max, S, SW)
            assert 1 <= got[p] <= SW


@pytest.mark.parametrize("seed", range(3))
def test_ring_span_pp_broadcast_equals_shared(seed):
    """Under a broadcast shared schedule each pair's ring span is the shared
    ``ring_span`` at that pair's last column, and the per-pair ring event
    table is the shared one row for row, padding included."""
    rng = np.random.default_rng(400 + seed)
    done = 0
    while done < 6:
        n_max, S, SW, diag = _random_geometry(rng)
        shift = banded.shift_at_array(n_max, S, SW, diag)
        if shift[0]:
            continue  # the pinned kernels' schedules start unshifted
        B = int(rng.integers(1, 7))
        sched = np.ascontiguousarray(np.broadcast_to(shift[:, None], (n_max, B)))
        n = rng.integers(0, n_max + 1, B)
        plan = striped.plan_striped(n_max, S, SW, diag)
        span = pinned.ring_span_pp(pinned.plan_pp(sched, n, SW, "cpu"),
                                   torch.as_tensor(np.maximum(n, 1)), SW)
        assert span.tolist() == [striped.ring_span(plan, max(int(x), 1)) for x in n]
        for ring_words in (None, 512):
            _, ev, threads = banded_kernel.ring_pp_events(sched, n, SW, "cpu", ring_words)
            shared = banded_kernel.ring_events(plan, threads * 8)
            assert ev.shape == (B,) + shared.shape
            for p in range(B):
                assert np.array_equal(ev[p].numpy(), shared), (p, ring_words)
        done += 1


def _pack(pairs):
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    return args[0].shape[0], args[2].shape[0], max(len(b) for _, b in pairs)


def _phase27_geometries():
    """``(label, n_max, S, diag top)`` of the packs ``chip_smoke.py`` phase
    27 runs ring K6 on: phase 10's 160 pairs of up to 1.5 kbp (a skewed
    pair makes S ~ 280; its 33-lane cut and its copy with an m == 0 lane
    have the same geometry), 33 pairs of up to 3.5 kbp beside a 38 kbp one
    (S = 1188), and 33 pairs of up to 3 kbp beside a 70 kbp one (S =
    2188, for SW 2048)."""
    rng = np.random.default_rng(13)
    wide = [generate.uniform_seeded(int(rng.integers(1, 1501)), float(rng.uniform(0, 0.25)),
                                    5000 + s) for s in range(160)]
    wide[1] = (b"", b"ACGTACGTAC")
    m_top = max(len(b) for _, b in wide)
    wide[2] = (wide[2][0][:300] or b"A", generate.uniform_seeded(9000, 0.1, 4999)[0])
    out = [("wide", *_pack(wide)[:2], m_top)]
    for label, n_hi, m_tall, seed in (("long", 3500, 38_000, 9400), ("big", 3000, 70_000, 9500)):
        rng = np.random.default_rng(seed)
        pairs = [generate.uniform_seeded(int(rng.integers(1, n_hi + 1)),
                                         float(rng.uniform(0, 0.25)), seed + 1 + s)
                 for s in range(33)]
        pairs[0] = (generate.uniform_seeded(n_hi, 0.1, seed - 1)[0],
                    generate.uniform_seeded(m_tall, 0.1, seed - 2)[0])
        out.append((label, *_pack(pairs)))
    return out


#: Ring K6's cases in phase 27: (pack, SW, CB, diagonal, ring words).  Phase
#: 10's checkpoint cases, each at its own ring and (up to 256 words) at a
#: forced 256-word one, then the new ones.
PHASE27_CK = [("wide", sw, cb, d, rw)
              for sw, cb, d in ((8, 64, True), (16, 64, True), (24, 512, False),
                                (64, 512, True), (200, 512, True), ("s8", 512, False),
                                ("s8", 512, True))
              for rw in ((None,) if sw == "s8" else (None, 256))]
PHASE27_CK += [("wide", 64, 72, True, None), ("wide", 256, 264, True, 256),
               ("long", 64, 72, True, 256), ("big", 2048, 2056, True, None)]


def test_ring_invariants_of_checkpoints():
    """On phase 27's shapes: for every checkpoint k and every word w of its
    true window, w is live at step ``k*CB - 1 + w`` and word ``w + RW``
    enters only after w ends; no word is absorbed at the step the window
    top is taken, so the running sum read there is stable.  The grid holds
    a checkpoint whose column shifts (the word above the window top is
    absorbed the step before), and forced 256-word rings that wrap at least
    3 times."""
    geoms = {g[0]: g[1:] for g in _phase27_geometries()}
    shifted, wraps = 0, []
    for pack, sw, cb, use_diag, ring_words in PHASE27_CK:
        n_max, S, m_top = geoms[pack]
        sw = S // 8 * 8 if sw == "s8" else sw
        diag = (n_max, m_top) if use_diag else None
        plan = striped.plan_striped(n_max, S, sw, diag)
        CB, n_ck, ckw0 = striped.ck_layout(n_max, sw, cb, plan["lo"])
        RW = banded_kernel.ring_threads(striped.ring_span(plan, n_max), ring_words) * 8
        ent = plan["ent_t"].astype(np.int64)
        ab = plan["abs_t"].astype(np.int64)
        nwl = plan["n_words_live"]
        end = np.minimum(np.where(ab < striped.NEVER, ab + 1, striped.NEVER),
                         n_max + np.arange(nwl))
        absorbs = set(ab[ab < striped.NEVER].tolist())
        for k in range(1, n_ck):
            w = np.arange(int(ckw0[k]), int(ckw0[k]) + sw)
            t = k * CB - 1 + w
            assert ((ent[w] <= t) & (t < end[w])).all(), (pack, sw, cb, k)
            nxt = w + RW
            inside = nxt < nwl
            assert (ent[nxt[inside]] >= end[w[inside]]).all(), (pack, sw, cb, k)
            assert int(t[0]) not in absorbs, (pack, sw, cb, k)
            shifted += int(plan["lo"][k * CB - 1] != plan["lo"][k * CB - 2])
        if ring_words is not None and pack == "long":
            wraps.append(nwl / RW)
    assert shifted > 0
    assert min(wraps) >= 3


def _label_route(device, kernel="banded_cost"):
    """``banded_kernel.route`` as on the card, so the CPU run names the
    kernel each rung or round would launch."""
    return banded_kernel._LABELS[kernel]


@needs_native
@pytest.mark.parametrize("ring", [True, False])
def test_runner_routes_ck_rungs_between_ring_and_stripes(monkeypatch, ring):
    """direct_dt=False on pairs of 2-3 kbp from a 64-word band with the
    routing constant at 64: the ck rungs run K6, labelled ring K6 where the
    ring holds the band and the stripe kernel where it does not (its
    capacity patched below 64 words).  Costs, BatchStats (but ``kernel``)
    and verified CIGARs equal the reference's, whose ck rungs run
    ``striped_ck_tpu`` in interpret mode."""
    pairs = [generate.uniform_seeded(2100 + (s * 97) % 900, [0.02, 0.08][s % 2], 500 + s)
             for s in range(4)]
    kw = dict(band_words=64, lane_multiple=128, domain_mode="off", direct_dt=False)
    monkeypatch.setattr(runner, "STRIPED_MIN_SW", 64)
    monkeypatch.setattr(runner, "route", _label_route)
    if not ring:
        monkeypatch.setattr(banded_kernel, "RING_MAX_WORDS", 32)
    ref_res, ref_stats = RefAligner(pallas_interpret=True, **kw).align_with_stats(pairs)
    res, stats = BatchAligner(device="cpu", **kw).align_with_stats(pairs)
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    for f in STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert stats.kernel == ("cuda-ring-ck" if ring else "cuda-striped-ck")
    for (a, b), (c, cig) in zip(pairs, res):
        assert cig.verify(a, b) == c == oracle.levenshtein(a, b)


def _gap_pairs():
    """tests/test_banded.py::test_domain_ladder_gap_mode, fewer pairs."""
    return [
        generate.generate_model(700 + 37 * s, [0.04, 0.15][s % 2],
                                list(generate.ErrorModel)[s % 4], 300 + s)
        for s in range(4)
    ] + [(b"ACGT" * 120, b"ACGT" * 250)]  # heavy length skew


@pytest.mark.parametrize("ring", [True, False])
def test_runner_routes_domain_rounds_between_ring_and_stripes(monkeypatch, ring):
    """Every gap-domain round runs K9 (routing constant 1), labelled ring
    K9 where the ring holds the band and the stripe kernel where it does
    not (its capacity patched below the first round).  Costs equal the
    oracle's, and BatchStats (but ``kernel``) the reference's, whose rounds
    run ``pinned_cost_pp_tpu`` in interpret mode."""
    pairs = _gap_pairs()
    kw = dict(band_words=4, lane_multiple=128, domain_mode="gap", domain_min_bp=0)

    def ref_round(self, a0, a1, pb0, pb1, n, m, sw, sched_arr, quantum, want_ck):
        assert not want_ck
        return pinned_cost_pp_tpu(a0, a1, pb0, pb1, n, m, band_words=sw,
                                  schedule=sched_arr, time_block=256, interpret=True)

    monkeypatch.setattr(RefAligner, "_domain_kernel", ref_round)
    monkeypatch.setattr(runner, "PINNED_PP_MIN_SW", 1)
    monkeypatch.setattr(runner, "route", _label_route)
    if not ring:
        monkeypatch.setattr(banded_kernel, "RING_MAX_WORDS", 2)
    labels = []
    orig = runner.BatchAligner._domain_kernel

    def spy(self, *args):
        got, name = orig(self, *args)
        labels.append(name)
        return got, name

    monkeypatch.setattr(runner.BatchAligner, "_domain_kernel", spy)
    ref_costs, ref_stats = RefAligner(pallas_interpret=True, **kw).cost_with_stats(pairs)
    costs, stats = BatchAligner(device="cpu", **kw).cost_with_stats(pairs)
    assert list(costs) == list(ref_costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    for f in STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert labels and set(labels) == {"ring_cost_pp" if ring else "pinned_cost_pp"}
    assert stats.kernel == ("cuda-ring-pp" if ring else "cuda-pinned-pp")


def test_wrappers_take_one_design_argument():
    """``stripe_words`` picks the stripe kernel, ``ring_words`` the ring:
    both at once raise on both routes; either leaves the results alone on
    the CPU route (the plain version)."""
    pairs = [generate.uniform_seeded(300, 0.1, 70 + s) for s in range(3)]
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
    sched = np.zeros((n_max, B), np.uint8)
    with pytest.raises(ValueError, match="at most one"):
        banded_kernel.striped_ck(*args, 8, 16, None, 256, 256)
    with pytest.raises(ValueError, match="at most one"):
        banded_kernel.pinned_cost_pp(*args, sched, 8, 1, 256, 256)
    want = striped.striped_ck_ref(*args, 8, 16)
    for kw in ({}, {"stripe_words": 256}, {"ring_words": 256}):
        got = banded_kernel.striped_ck(*args, 8, 16, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), kw
        assert torch.equal(banded_kernel.pinned_cost_pp(*args, sched, 8, 1, **kw),
                           pinned.pinned_cost_pp_ref(*args, sched, 8, 1)), kw
    assert banded_kernel.ring_takes(banded_kernel.RING_MAX_WORDS)
    assert not banded_kernel.ring_takes(banded_kernel.RING_MAX_WORDS + 1)
    assert banded_kernel.route(torch.device("cuda"), "ring_ck") == "cuda-ring-ck"
    assert banded_kernel.route(torch.device("cuda"), "ring_cost_pp") == "cuda-ring-pp"
    assert banded_kernel.route(torch.device("cpu"), "ring_ck") == "torch-ref"


def _ck_cursor(ckw0, ent, ab, p: int, RW: int, SW: int, CB: int, n_ck: int):
    """Ring K10's checkpoint row cursor as each thread of the ring walks
    it (``ck_seek``/``ck_take`` in ``csrc/pinned.cu``): ``(thread, step,
    k, word)`` of every row the ring takes, thread by thread in cursor
    order.  Thread ``tid`` holds the words ``tid*8 + q % 8 + (q // 8)*RW``."""
    out = []
    for tid in range(RW // 8):
        w0 = tid * 8

        def seek(d):
            dd = d - w0
            lap = dd // RW if dd > 0 else 0
            r = dd - lap * RW if dd > 0 else 0
            q = lap * 8 + r if r < 8 else (lap + 1) * 8
            return q, w0 + q % 8 + (q // 8) * RW

        for k in range(1, n_ck):
            top = int(ckw0[k, p])
            q, w = seek(top)
            while w < top + SW:
                out.append((tid, k * CB - 1 + w, k, w))
                q += 1
                w = w0 + q % 8 + (q // 8) * RW
    return out


@pytest.mark.parametrize("seed", range(3))
def test_ring_ck_pp_host_side(seed):
    """Ring K10 on random per-pair schedules (Q 1 and 8, ragged n, CB = SW
    and CB > SW, rings at their size and forced to 256 words): the ring
    span at ``n_lim = n_max`` against a brute force and the event table
    against the plan; every checkpoint row taken once, by its word's own
    thread in step order, at step ``k*CB - 1 + w`` while the word is live
    and its slot not yet taken by word ``w + RW``, into row ``w -
    lo_p(k*CB - 1)``; no two rows taken at one step (checkpoint k's last
    before k+1's first); every word above a window top absorbed before the
    top is taken and none at or below it (the top values the threads
    add)."""
    rng = np.random.default_rng(500 + seed)
    for q in (1, 8):
        for cb_extra in (0, 37):
            n_max = int(rng.integers(300, 900))
            B = int(rng.integers(1, 6))
            S = int(rng.integers(300, 600))
            SW = int(rng.integers(8, 257)) // q * q  # CB = SW at a whole quantum
            sched = _random_pp_schedule(rng, n_max, B, q, float(rng.uniform(0.05, 0.8)))
            n = rng.integers(0, n_max + 1, B)
            CB, n_ck = pinned.ck_layout_pp(SW + cb_extra, n_max, q, SW)
            plan = pinned.plan_pp(sched, n, SW, "cpu")
            span = pinned.ring_span_pp(plan, torch.full((B,), n_max), SW).tolist()
            lo = plan["lo"].numpy()
            for ring_words in (None, 256):
                _, ev, threads = banded_kernel.ring_pp_events(sched, n, SW, "cpu", ring_words,
                                                              n_lim=n_max)
                RW = threads * 8
                ckw0 = pinned.ck_tops(plan["lo"], CB, n_ck).numpy()
                for p in range(B):
                    ent, ab = plan["ent_t"][p].numpy(), plan["abs_t"][p].numpy()
                    assert span[p] == _brute_span(ent, ab, lo[p], n_max, SW) <= RW <= max(SW, 256)
                    for row, key in enumerate(("ent_t", "top_t", "abs_t")):
                        nw = plan[key].shape[1]
                        assert np.array_equal(ev[p, row, :nw].numpy(), plan[key][p].numpy())
                        assert (ev[p, row, nw:] == striped.NEVER).all()
                    nwl = int(plan["nwl"][p])
                    ent_x = np.full(nwl + RW, striped.NEVER, np.int64)
                    ent_x[:nwl] = ent[:nwl]
                    end = np.minimum(np.where(ab < striped.NEVER, ab + 1, striped.NEVER).astype(
                        np.int64), n_max + np.arange(len(ab)))
                    taken = _ck_cursor(ckw0, ent, ab, p, RW, SW, CB, n_ck)
                    want = {(k, w) for k in range(1, n_ck)
                            for w in range(int(ckw0[k, p]), int(ckw0[k, p]) + SW)}
                    assert sorted((k, w) for _, _, k, w in taken) == sorted(want)
                    steps = [t for _, t, _, _ in taken]
                    assert len(set(steps)) == len(steps)
                    by_step = sorted(taken, key=lambda x: x[1])
                    assert [k for _, _, k, _ in by_step] == sorted(k for _, _, k, _ in by_step)
                    for tid in range(threads):
                        mine = [t for i, t, _, _ in taken if i == tid]
                        assert mine == sorted(mine)
                    for tid, t, k, w in taken:
                        assert w // 8 % threads == tid
                        assert ent[w] <= t < end[w], (q, p, k, w)
                        assert ent_x[w + RW] >= end[w], (q, p, k, w)
                        assert 0 <= w - int(lo[p, k * CB - 1]) < SW
                    fin = ab[ab < striped.NEVER]
                    assert (np.diff(fin) > 0).all()
                    for k in range(1, n_ck):
                        top, t_top = int(ckw0[k, p]), k * CB - 1 + int(ckw0[k, p])
                        assert top == 0 or ab[top - 1] < t_top
                        assert ab[top] > t_top


@needs_native
@pytest.mark.parametrize("ring", [True, False])
def test_runner_routes_domain_ck_rounds_between_ring_and_stripes(monkeypatch, ring):
    """direct_dt=False on the gap-domain pairs with the routing constant at
    1: every checkpoint round runs K10, labelled ring K10 where the ring
    holds the band and the stripe kernel where it does not (its capacity
    patched below the first round).  Costs, BatchStats (but ``kernel``)
    and verified CIGARs equal the reference's, whose rounds run
    ``pinned_ck_pp_tpu`` in interpret mode."""
    pairs = _gap_pairs()
    kw = dict(band_words=4, lane_multiple=128, domain_mode="gap", domain_min_bp=0,
              direct_dt=False)

    def ref_round(self, a0, a1, pb0, pb1, n, m, sw, sched_arr, quantum, want_ck):
        assert want_ck
        CB = self._cb(sw, a0.shape[0])
        CB = max(quantum, CB // quantum * quantum)
        return pinned_ck_pp_tpu(a0, a1, pb0, pb1, n, m, band_words=sw, schedule=sched_arr,
                                col_block=CB, time_block=256, interpret=True)

    monkeypatch.setattr(RefAligner, "_domain_kernel", ref_round)
    monkeypatch.setattr(runner, "PINNED_PP_MIN_SW", 1)
    monkeypatch.setattr(runner, "route", _label_route)
    if not ring:
        monkeypatch.setattr(banded_kernel, "RING_MAX_WORDS", 2)
    labels = []
    orig = runner.BatchAligner._domain_kernel

    def spy(self, *args):
        got, name = orig(self, *args)
        labels.append(name)
        return got, name

    monkeypatch.setattr(runner.BatchAligner, "_domain_kernel", spy)
    ref_res, ref_stats = RefAligner(pallas_interpret=True, **kw).align_with_stats(pairs)
    res, stats = BatchAligner(device="cpu", **kw).align_with_stats(pairs)
    assert [c for c, _ in res] == [c for c, _ in ref_res]
    for f in STATS:
        assert getattr(stats, f) == getattr(ref_stats, f), f
    assert labels and set(labels) == {"ring_ck_pp" if ring else "pinned_ck_pp"}
    assert stats.kernel == ("cuda-ring-pp-ck" if ring else "cuda-pinned-pp-ck")
    for (a, b), (c, cig) in zip(pairs, res):
        assert cig.verify(a, b) == c == oracle.levenshtein(a, b)


def test_pinned_ck_pp_takes_one_design_argument():
    """``pinned_ck_pp`` takes ``stripe_words`` or ``ring_words`` as the
    other ring wrappers do: both at once raise on both routes; either
    leaves the plain results alone."""
    pairs = [generate.uniform_seeded(300, 0.1, 80 + s) for s in range(3)]
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    n_max, B = args[0].shape
    sched = np.zeros((n_max, B), np.uint8)
    sched[8::8] = 1
    with pytest.raises(ValueError, match="at most one"):
        banded_kernel.pinned_ck_pp(*args, sched, 8, 16, 1, 256, 256)
    want = pinned.pinned_ck_pp_ref(*args, sched, 8, 16, 8)
    for kw in ({}, {"stripe_words": 256}, {"ring_words": 256}):
        got = banded_kernel.pinned_ck_pp(*args, sched, 8, 16, 8, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), kw
    assert banded_kernel.route(torch.device("cuda"), "ring_ck_pp") == "cuda-ring-pp-ck"
