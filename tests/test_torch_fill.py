"""Kernel K3's plain versions (``banded_fill_ref`` on the shared schedule,
``banded_fill_pp_ref`` on per-pair schedules) against the reference: the
Pallas kernel ``banded_fill_tpu`` in interpret mode (shared and
``schedule=``) and the jnp ``banded.banded_fill``.  Tolerance: none, costs
and both planes bit for bit on every row.  The CUDA kernel's own tests are
in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate
from astarpa_tpu.ops import banded as jbanded
from astarpa_tpu.ops.pallas_banded import banded_fill_tpu
from astarpa_tpu.ops.pallas_myers import pack_batch_staggered as jpack
from astarpa_tpu_torch.ops import banded, banded_kernel, words

torch.set_num_threads(1)

B = 128  # the Pallas kernel's lane tile


def _u32(x):
    return words.to_numpy_u32(x)


@pytest.fixture(scope="module")
def packed():
    """128 lanes (n <= 300): mixed lengths and divergences, two zero-length
    a sides, an empty b side, and one tall b (S = 72 words) so that bands
    of up to 64 words stay below full height."""
    rng = np.random.default_rng(5)
    pairs = []
    for s in range(B - 4):
        n = int(rng.integers(1, 301))
        pairs.append(generate.generate_model(n, [0.0, 0.05, 0.2][s % 3],
                                             generate.ErrorModel.UNIFORM, 300 + s))
    pairs.append((b"", b"ACGTTGCA" * 5))
    pairs.append((b"", b""))
    pairs.append((b"ACGTAC" * 20, b""))
    pairs.append((b"GATTACA" * 42, b"TACGGA" * 380))  # m = 2280: S = 72
    args, _ = jpack(pairs, lane_multiple=B)
    return tuple(np.asarray(x) for x in args)


def _same(got, want):
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("sw", [2, 8, 28, 64, "S"])
def test_fill_matches_pallas_and_jnp(packed, sw):
    n_max, S = packed[0].shape[0], packed[2].shape[0]
    sw = S if sw == "S" else sw
    diag = (n_max, S * 32 - 96)
    got = banded_kernel.banded_fill(*words.planes_from_numpy(*packed, "cpu"), sw, diag)
    assert got[1].shape == (n_max, min(sw, S), B)
    _same(got, banded_fill_tpu(*packed, band_words=sw, interpret=True, diag=diag))
    _same(got, jbanded.banded_fill(*packed, band_words=sw, diag=diag))


def test_fill_sw1_matches_jnp(packed):
    """SW = 1 < S: the Pallas kernel refuses it (ROADMAP hazards), so this
    case is held against the jnp fill only."""
    got = banded.banded_fill_ref(*words.planes_from_numpy(*packed, "cpu"), 1)
    _same(got, jbanded.banded_fill(*packed, band_words=1))


def test_fill_shifting_at_column_0():
    """A diagonal that puts the shared schedule's only shift at column 0."""
    pairs = [generate.uniform_seeded(300 + s, 0.1, 60 + s) for s in range(B)]
    packed = tuple(np.asarray(x) for x in jpack(pairs, lane_multiple=B)[0])
    sw, diag = 8, (1, 320)
    shift = banded.shift_at_array(packed[0].shape[0], packed[2].shape[0], sw, diag)
    assert shift[0] == 1 and shift[1:].sum() == 0
    got = banded_kernel.banded_fill(*words.planes_from_numpy(*packed, "cpu"), sw, diag)
    _same(got, banded_fill_tpu(*packed, band_words=sw, interpret=True, diag=diag))


def _schedules(packed, sw, q, rng):
    """Per-pair schedules shifting only at multiples of ``q``: each pair's
    own gap schedule for most lanes, and for every fourth a random one that
    shifts at column 0 (and, at ``q == 1``, at the last column)."""
    n_max, S = packed[0].shape[0], packed[2].shape[0]
    sched, _ = banded.pair_gap_schedule(packed[4], packed[5], sw, n_max, S)
    lo_max = S - min(sw, S)
    cols = np.arange(q, n_max - 1, q)
    for p in range(0, B, 4):
        sched[:, p] = 0
        if not lo_max:
            continue
        sched[0, p] = 1
        k = min(lo_max - 1, len(cols))
        sched[rng.choice(cols, size=k, replace=False), p] = 1
        if q == 1 and k:
            sched[cols[sched[cols, p] > 0][-1], p] = 0
            sched[n_max - 1, p] = 1
    return sched


@pytest.mark.parametrize("sw,q", [(4, 32), (8, 1), (28, 8), (64, 32)])
def test_fill_pp_matches_pallas(packed, sw, q):
    rng = np.random.default_rng(sw * 10 + q)
    sched = _schedules(packed, sw, q, rng)
    got = banded_kernel.banded_fill_pp(*words.planes_from_numpy(*packed, "cpu"),
                                       sched, sw, q)
    want = banded_fill_tpu(*packed, band_words=sw, interpret=True, schedule=sched,
                           schedule_quantum=q)
    _same(got, want)
    # On a shared schedule broadcast to every lane, K3's two modes agree.
    n_max, S = packed[0].shape[0], packed[2].shape[0]
    shared = banded.shift_at_array(n_max, S, sw)
    bcast = np.repeat(shared[:, None], B, 1).astype(np.uint8)
    planes = words.planes_from_numpy(*packed, "cpu")
    pp = banded.banded_fill_pp_ref(*planes, bcast, sw, 1)
    sh = banded.banded_fill_ref(*planes, sw)
    for g, w in zip(pp, sh):
        assert torch.equal(g, w)


def test_fill_costs_are_the_cost_kernels(packed):
    planes = words.planes_from_numpy(*packed, "cpu")
    got = banded.banded_fill_ref(*planes, 8)
    assert torch.equal(got[0], banded.banded_cost_ref(*planes, 8))


def test_fill_wrapper_refuses_bad_inputs(packed):
    planes = list(words.planes_from_numpy(*packed, "cpu"))
    bad = [planes[0].to(torch.int64)] + planes[1:]
    with pytest.raises(ValueError, match="int32"):
        banded_kernel.banded_fill(*bad, 8)
    bad = planes[:3] + [planes[3][:-1]] + planes[4:]
    with pytest.raises(ValueError, match="pb1"):
        banded_kernel.banded_fill(*bad, 8)
    with pytest.raises(ValueError, match="band_words"):
        banded_kernel.banded_fill(*planes, 0)
    n_max = planes[0].shape[0]
    off_grid = np.zeros((n_max, B), np.uint8)
    off_grid[5, 0] = 1
    with pytest.raises(ValueError, match="quantum"):
        banded_kernel.banded_fill_pp(*planes, off_grid, 8, 32)
    with pytest.raises(ValueError, match="schedule must be"):
        banded_kernel.banded_fill_pp(*planes, off_grid[:-1], 8, 1)
    with pytest.raises(ValueError, match="int32"):
        banded_kernel.banded_fill_pp(*([planes[0].to(torch.int64)] + planes[1:]),
                                     off_grid, 8, 1)
