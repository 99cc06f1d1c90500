"""The port's checkpoint path (kernel K2's plain version and the fill)
against the reference: jnp ``banded_fill``, the Pallas ck kernel in
interpret mode and the host-derived checkpoints of ``tests/test_banded.py``,
bit for bit; and native checkpoint traces from the port's checkpoints.
The CUDA kernel's own tests are in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native, oracle
from astarpa_tpu.ops import banded as jbanded
from astarpa_tpu.ops.pallas_banded import banded_ck_tpu
from astarpa_tpu.ops.pallas_myers import pack_batch_staggered as jpack
from astarpa_tpu_torch.ops import banded, banded_kernel, words

from test_banded import _host_checkpoints, _mixed_pairs

torch.set_num_threads(1)

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _u32(x):
    return words.to_numpy_u32(x)


@pytest.fixture(scope="module")
def packed_128():
    """128 pairs packed by the reference (B % 128 == 0 for the Pallas
    kernel), the inputs of ``test_banded.py::test_ck_kernel_interpret_top_val``
    shortened so the plain version's column loop stays small."""
    pairs = [generate.uniform_seeded(150 + 3 * s, 0.1, 900 + s) for s in range(127)]
    pairs.append((b"ACGT" * 10, b"ACGT" * 60))  # m > n: the window slides far
    args, _ = jpack(pairs, lane_multiple=128)
    return tuple(np.asarray(x) for x in args)


@pytest.mark.parametrize("sw", [1, 4, "S"])
def test_fill_matches_jnp_fill(sw):
    pairs = _mixed_pairs(80, count=8)
    args, _ = jpack(pairs, lane_multiple=8)
    args = tuple(np.asarray(x) for x in args)
    S = args[2].shape[0]
    sw = S if sw == "S" else sw
    diag = (args[0].shape[0], S * 32 - 40)
    want = jbanded.banded_fill(*args, band_words=sw, diag=diag)
    got = banded.banded_fill_ref(*words.planes_from_numpy(*args, "cpu"), sw, diag)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(_u32(g), np.asarray(w))


@pytest.mark.parametrize("sw,cb", [(8, 64), (4, 100), (16, 1024)])
def test_ck_matches_pallas_and_host_checkpoints(packed_128, sw, cb):
    a0, a1, pb0, pb1, n, m = packed_128
    n_max, S = a0.shape[0], pb0.shape[0]
    planes = words.planes_from_numpy(*packed_128, "cpu")
    got = banded_kernel.banded_ck(*planes, sw, cb)  # the CPU route: plain
    CB = min(cb, n_max)
    n_ck = -(-n_max // CB)
    assert got[1].shape == (n_ck, sw, a0.shape[1]) and got[3].shape == (n_ck, a0.shape[1])
    pallas = banded_ck_tpu(*packed_128, band_words=sw, col_block=cb,
                           pairs_per_program=128, interpret=True)
    for g, w in zip((got[0].numpy(), _u32(got[1]), _u32(got[2]), got[3].numpy()), pallas):
        assert np.array_equal(g, np.asarray(w))
    costs, vp_cols, vm_cols = jbanded.banded_fill(*packed_128, band_words=sw)
    host = _host_checkpoints(np.asarray(vp_cols), np.asarray(vm_cols),
                             jbanded.shift_at_array(n_max, S, sw), n, CB, n_ck)
    assert np.array_equal(got[0].numpy(), np.asarray(costs))
    for g, w in zip((_u32(got[1]), _u32(got[2]), got[3].numpy()), host):
        assert np.array_equal(g, w)


def test_ck_with_diagonal_and_full_height(packed_128):
    a0, a1, pb0, pb1, n, m = packed_128
    n_max, S = a0.shape[0], pb0.shape[0]
    planes = words.planes_from_numpy(*packed_128, "cpu")
    for sw, diag in ((8, (n_max, S * 32 - 64)), (S, None)):
        got = banded.banded_ck_ref(*planes, sw, 128, diag)
        want = banded_ck_tpu(*packed_128, band_words=sw, col_block=128,
                             pairs_per_program=128, interpret=True, diag=diag)
        for g, w in zip((got[0].numpy(), _u32(got[1]), _u32(got[2]), got[3].numpy()), want):
            assert np.array_equal(g, np.asarray(w)), (sw, diag)
        # The ck costs are the cost kernel's.
        assert torch.equal(got[0], banded.banded_cost_ref(*planes, sw, diag))


@needs_native
@pytest.mark.parametrize("use_dt", [True, False])
def test_native_trace_from_port_checkpoints(use_dt):
    """``native.trace_banded_ck`` on the port's checkpoints (uint32 views)
    gives the oracle cost and a CIGAR that verifies at it."""
    CB, SW = 64, 8
    pairs = _mixed_pairs(70, count=10)
    args, _ = jpack(pairs, lane_multiple=8)
    n_max, S = args[0].shape[0], args[2].shape[0]
    costs, ckvp, ckvm, cktv = banded.banded_ck_ref(
        *words.planes_from_numpy(*args, "cpu"), SW, CB)
    costs, ckvp, ckvm, cktv = costs.numpy(), _u32(ckvp), _u32(ckvm), cktv.numpy()
    shift = banded.shift_at_array(n_max, S, SW)
    checked = 0
    for slot, (a, b) in enumerate(pairs):
        if costs[slot] > banded.band_threshold(SW, len(a), len(b), n_max, S * 32):
            continue
        for known in (-1, int(costs[slot])):
            cost, cig = native.trace_banded_ck(
                a, b, S, ckvp[:, :, slot], ckvm[:, :, slot], cktv[:, slot],
                shift, SW, CB, use_dt=use_dt, known_cost=known,
            )
            assert cost == costs[slot] == oracle.levenshtein(a, b)
            assert cig.verify(a, b) == cost
        checked += 1
    assert checked >= len(pairs) // 2


def test_ck_col_block():
    assert banded.ck_col_block(1024, 300) == 300
    assert banded.ck_col_block(64, 300) == 64
    # Per-pair: whole quantum groups, at least one.
    assert banded.ck_col_block(100, 300, 32) == 96
    assert banded.ck_col_block(1024, 20, 32) == 32
    assert banded.ck_col_block(4096, 100_352, 8) == 4096
