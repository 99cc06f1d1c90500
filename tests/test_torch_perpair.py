"""The port's per-pair-schedule kernel K4 (plain version, cost and
checkpoint modes) against the reference: jnp ``banded_cost_pp`` on gap and
gcsh schedules, the Pallas per-pair kernel in interpret mode, and the
shared-schedule kernel when every pair gets the shared schedule.  All
comparisons are exact.  The CUDA kernel's own tests are in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import domain, generate, native, oracle
from astarpa_tpu.ops import banded as jbanded
from astarpa_tpu.ops.pallas_banded import banded_ck_tpu, banded_cost_tpu
from astarpa_tpu.ops.pallas_myers import pack_batch_staggered as jpack
from astarpa_tpu_torch.ops import banded, banded_kernel, words

from test_banded import _mixed_pairs

torch.set_num_threads(1)


def _pack(pairs, lane_multiple):
    args, B0 = jpack(pairs, lane_multiple=lane_multiple)
    args = tuple(np.asarray(x) for x in args)
    return args, words.planes_from_numpy(*args, "cpu"), B0


def _u32(x):
    return words.to_numpy_u32(x)


@pytest.fixture(scope="module")
def packed_128():
    """128 pairs for the Pallas kernel (the inputs of
    ``test_banded.py::test_pallas_perpair_parity_interpret``, shortened)."""
    pairs = [
        generate.uniform_seeded(120 + (s * 31) % 90, [0.02, 0.1, 0.25][s % 3], 70 + s)
        for s in range(127)
    ] + [(b"ACGT" * 30, b"ACGT" * 70)]
    return _pack(pairs, 128)


@pytest.mark.parametrize("sw", [2, 4, 8, 16])
def test_pair_gap_schedule_matches_reference(sw):
    pairs = _mixed_pairs(31, count=12) + [(b"ACGT" * 30, b"ACGT" * 60),
                                          (b"ACGT" * 60, b"ACGT" * 25)]
    args, planes, B0 = _pack(pairs, 8)
    n_max, S = args[0].shape[0], args[2].shape[0]
    sched, thr = banded.pair_gap_schedule(args[4], args[5], sw, n_max, S)
    want_sched, want_thr = jbanded.pair_gap_schedule(args[4], args[5], sw, n_max, S)
    assert np.array_equal(sched, want_sched) and np.array_equal(thr, want_thr)
    got = banded_kernel.banded_cost_pp(*planes, sched, sw)  # CPU route: plain
    want = np.asarray(jbanded.banded_cost_pp(*args, sched, band_words=sw))
    assert np.array_equal(got.numpy(), want)
    # Certified results are exact (test_banded.py::test_pair_gap_schedule_certified_exact).
    got = got.numpy()[:B0]
    for slot, (a, b) in enumerate(pairs):
        if got[slot] <= thr[slot]:
            assert got[slot] == oracle.levenshtein(a, b)


@pytest.mark.skipif(not native.available(), reason="native toolchain unavailable")
def test_cost_pp_matches_jnp_on_gcsh_schedules():
    pairs = [generate.generate_model(400 + 61 * s, 0.1, generate.ErrorModel.UNIFORM, s)
             for s in range(6)]
    args, planes, B0 = _pack(pairs, 8)
    n_max, B = args[0].shape[0], args[0].shape[1]
    for f_scale in (1.0, 1.5):
        sched = np.zeros((n_max, B), np.uint8)
        sw, quantum = 1, 32
        for slot, (a, b) in enumerate(pairs):
            h = native.DomainHandle(a, b, k=10, r=2)
            f = int(max(h.h0 * f_scale, 64))
            ps = domain.domain_schedule(h.sample(f, 64))
            h.close()
            sched[: len(ps.sched), slot] = ps.sched
            sw, quantum = max(sw, ps.band_words), min(quantum, ps.quantum)
        sw = min(sw, args[2].shape[0])
        got = banded.banded_cost_pp_ref(*planes, sched, sw, quantum)
        want = np.asarray(jbanded.banded_cost_pp(*args, sched, band_words=sw))
        assert np.array_equal(got.numpy(), want), f_scale


@pytest.mark.parametrize("sw", [4, 8])
def test_cost_pp_matches_pallas_interpret(packed_128, sw):
    args, planes, _ = packed_128
    n_max, S = args[0].shape[0], args[2].shape[0]
    sched, _ = banded.pair_gap_schedule(args[4], args[5], sw, n_max, S)
    got = banded.banded_cost_pp_ref(*planes, sched, sw)
    want = banded_cost_tpu(*args, band_words=sw, pairs_per_program=128,
                           interpret=True, schedule=sched)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sw,cb,quantum", [(4, 64, 32), (8, 100, 32), (4, 40, 8)])
def test_ck_pp_matches_pallas_interpret(packed_128, sw, cb, quantum):
    args, planes, _ = packed_128
    n_max, S = args[0].shape[0], args[2].shape[0]
    sched, _ = banded.pair_gap_schedule(args[4], args[5], sw, n_max, S)
    if quantum != 32:  # shifts `quantum` columns earlier: off the 32-grid
        sched = np.concatenate([sched[quantum:], np.zeros_like(sched[:quantum])])
        assert sched[np.arange(n_max) % 32 != 0].any()
    got = banded_kernel.banded_ck_pp(*planes, sched, sw, cb, quantum)
    n_ck = -(-n_max // banded.ck_col_block(cb, n_max, quantum))
    assert got[1].shape[0] == got[3].shape[0] == n_ck
    want = banded_ck_tpu(*args, band_words=sw, col_block=cb, pairs_per_program=128,
                         interpret=True, schedule=sched, schedule_quantum=quantum)
    for g, w in zip((got[0].numpy(), _u32(got[1]), _u32(got[2]), got[3].numpy()), want):
        assert np.array_equal(g, np.asarray(w))


@pytest.mark.parametrize("sw", [4, 16])
def test_shared_schedule_as_perpair_matches_shared(sw):
    """Every pair on the bucket schedule reproduces the shared kernel and
    its checkpoints (pattern of test_banded.py::test_perpair_schedule_matches_shared)."""
    args, planes, _ = _pack(_mixed_pairs(11, count=12), 8)
    n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
    sched = np.broadcast_to(banded.shift_at_array(n_max, S, sw)[:, None], (n_max, B))
    shared = banded.banded_ck_ref(*planes, sw, 64)
    for g, w in zip(banded.banded_ck_pp_ref(*planes, sched, sw, 64, 1), shared):
        assert torch.equal(g, w)
    want = np.asarray(jbanded.banded_cost_pp(*args, sched, band_words=sw))
    assert np.array_equal(shared[0].numpy(), want)


def test_schedule_checks():
    planes = words.planes_from_numpy(*_pack(_mixed_pairs(3, count=2), 8)[0], "cpu")
    n_max, B = planes[0].shape
    sched = np.zeros((n_max, B), np.uint8)
    sched[32, 0] = 1
    banded_kernel.banded_cost_pp(*planes, sched, 2, 32)
    sched[33, 1] = 1
    with pytest.raises(ValueError, match="quantum 32"):
        banded_kernel.banded_cost_pp(*planes, sched, 2, 32)
    with pytest.raises(ValueError, match="quantum 32"):
        banded_kernel.banded_ck_pp(*planes, sched, 2, 64, 32)
    with pytest.raises(ValueError, match="schedule must be"):
        banded_kernel.banded_cost_pp(*planes, sched[:-1], 2, 1)
