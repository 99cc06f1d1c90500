"""The port's banded cost: the plain torch version against the reference
(jnp ``banded_cost`` and the Pallas kernel in interpret mode) on the same
packed planes, and certified results against the oracle.  All comparisons
are exact.  The CUDA kernel's own tests are in ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, oracle
from astarpa_tpu.ops import banded as jbanded
from astarpa_tpu.ops.pallas_banded import banded_cost_tpu
from astarpa_tpu.ops.pallas_myers import pack_batch_staggered as jpack
from astarpa_tpu_torch.ops import _build, banded, banded_kernel, words
from astarpa_tpu_torch.ops.pack import pack_batch_staggered

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def packed_128():
    """128 pairs packed by the reference (B % 128 == 0 for the Pallas
    kernel), S > 16 so every SW of the grid below the top is a real band."""
    pairs = [
        generate.uniform_seeded(200 + (s * 37) % 200, [0.02, 0.08, 0.15][s % 3], s)
        for s in range(127)
    ] + [(b"ACGT" * 30, b"ACGT" * 150)]
    args, _ = jpack(pairs, lane_multiple=128)
    return tuple(np.asarray(x) for x in args)


@pytest.mark.parametrize("diag_set", [False, True])
@pytest.mark.parametrize("sw", [1, 4, 8, 16, "S"])
def test_plain_cost_matches_jnp_and_pallas(packed_128, sw, diag_set):
    a0, a1, pb0, pb1, n, m = packed_128
    n_max, S = a0.shape[0], pb0.shape[0]
    sw = S if sw == "S" else sw
    assert sw <= S
    diag = (n_max, S * 32 - 40) if diag_set else None
    want = np.asarray(jbanded.banded_cost(*packed_128, band_words=sw, diag=diag))
    planes = words.planes_from_numpy(*packed_128, "cpu")
    got = banded.banded_cost_ref(*planes, sw, diag)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # The CPU route of the kernel wrapper is the plain version.
    assert np.array_equal(banded_kernel.banded_cost(*planes, sw, diag).numpy(), want)
    if sw > 1:  # the Pallas kernel's window slicing refuses SW == 1 < S
        pallas = np.asarray(banded_cost_tpu(
            *packed_128, band_words=sw, pairs_per_program=128, interpret=True,
            diag=diag,
        ))
        assert np.array_equal(pallas, want)


def _mixed_pairs(seed0, count=16):
    """The tests/test_banded.py mix (error models, e up to 20%), shortened
    so the plain version's column loop stays small."""
    models = list(generate.ErrorModel)
    return [
        generate.generate_model(100 + (s * 97) % 400, [0.0, 0.02, 0.08, 0.2][s % 4],
                                models[s % len(models)], seed0 + s)
        for s in range(count)
    ]


def test_certified_costs_equal_oracle():
    pairs = _mixed_pairs(1)
    args, B0 = pack_batch_staggered(pairs, 8, device="cpu")
    a0, a1, pb0, pb1, n, m = args
    S = pb0.shape[0]
    expected = np.array([oracle.levenshtein(a, b) for a, b in pairs])
    accepted_any = np.zeros(B0, dtype=bool)
    for sw in (4, 8, 16, 32):
        sw_eff = min(sw, S)
        got = banded.banded_cost_ref(*args, sw).numpy()[:B0]
        if sw_eff >= S:
            ok = np.ones(B0, bool)
        else:
            ok = got <= banded.band_threshold(sw_eff, n[:B0], m[:B0], a0.shape[0], S * 32)
        assert (got >= expected).all()  # always an upper bound
        assert (got[ok] == expected[ok]).all()
        accepted_any |= ok
    assert accepted_any.all()


@pytest.mark.parametrize("sw", [2, 4, 8])
def test_narrow_band_is_an_upper_bound(sw):
    pairs = [
        generate.uniform_seeded(100 + 17 * s, [0.05, 0.2, 0.4][s % 3], s)
        for s in range(24)
    ]
    args, B0 = pack_batch_staggered(pairs, 24, device="cpu")
    exact = np.array([oracle.levenshtein(a, b) for a, b in pairs])
    assert (banded.banded_cost_ref(*args, sw).numpy()[:B0] >= exact).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        banded_kernel.banded_cost(x, x, x, x, np.ones(8, np.int32),
                                  np.ones(8, np.int32), 2)
    f = torch.zeros((4, 8), dtype=torch.float32)
    i = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous int32"):
        banded_kernel._launch("banded_cost", f, i, i, i, np.ones(8, np.int32), np.ones(8, np.int32), 2)
    strided = torch.zeros((8, 4), dtype=torch.int32).T  # right shape, not contiguous
    with pytest.raises(ValueError, match="contiguous int32"):
        banded_kernel._launch("banded_cost", i, i, strided, i, np.ones(8, np.int32),
                              np.ones(8, np.int32), 2)


def test_library_path_is_keyed_on_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR
    assert _build.library_path() == first
    src.write_text("// two\n")
    assert _build.library_path() != first
