"""Port word ops, packing and host schedule helpers against the reference.

Bit operations run on int32 views in the port; the reference's own
functions run on numpy uint32 (or jnp) on the same words.  All
comparisons are exact.
"""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, native
from astarpa_tpu.ops import banded as jbanded
from astarpa_tpu.ops import bitpack, pallas_myers
from astarpa_tpu.ops.pallas_banded import _myers_word
from astarpa_tpu_torch.ops import banded, pack, words

torch.set_num_threads(1)

N_WORDS = 65_536


def _u32(rng, size):
    return rng.integers(0, 2**32, size, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return words.to_tensor(x, "cpu")


def test_myers_word_matches_reference_uint32():
    rng = np.random.default_rng(0)
    eq, vp, vm = (_u32(rng, N_WORDS) for _ in range(3))
    hp = rng.integers(0, 2, N_WORDS).astype(np.uint32)
    hm = rng.integers(0, 2, N_WORDS).astype(np.uint32)
    want = _myers_word(eq, vp, vm, hp, hm)
    got = words.myers_word(_t(eq), _t(vp), _t(vm), _t(hp), _t(hm))
    for w, g, name in zip(want, got, ("vp", "vm", "hp", "hm")):
        assert np.array_equal(np.asarray(w, np.uint32), words.to_numpy_u32(g)), name


def test_popcount_and_logical_shift_match_uint32():
    rng = np.random.default_rng(1)
    x = _u32(rng, N_WORDS)
    x[:3] = (0, 0xFFFFFFFF, 0x80000000)
    assert np.array_equal(words.popcount(_t(x)).numpy(), bitpack.popcount32(x))
    assert np.array_equal(
        words.popcount(_t(x)).numpy(), np.asarray(jbanded._popcount(x))
    )
    for k in (1, 7, 31):
        assert np.array_equal(words.to_numpy_u32(words.srl(_t(x), k)), x >> np.uint32(k))


def test_value_to_window_matches_reference():
    rng = np.random.default_rng(2)
    SW, B = 5, 4096
    vp, vm = _u32(rng, (SW, B)), _u32(rng, (SW, B))
    rows = rng.integers(-40, SW * 32 + 40, B).astype(np.int32)
    rows[:3] = (0, SW * 32, 31)
    want = np.asarray(jbanded._value_to_window(vp, vm, np.clip(rows, 0, SW * 32)))
    assert np.array_equal(words.value_to_window(_t(vp), _t(vm), _t(rows)).numpy(), want)
    full = torch.arange(33, dtype=torch.int32)
    want_mask = np.array([(1 << f) - 1 for f in range(33)], np.uint64).astype(np.uint32)
    assert np.array_equal(words.to_numpy_u32(words.prefix_mask(full)), want_mask)


def _pack_pairs():
    """The tests/test_pack.py grid: an odd count, an empty and a skewed pair."""
    rng = np.random.default_rng(3)
    pairs = []
    for s in range(13):
        n = int(rng.integers(1, 700))
        e = float(rng.choice([0.0, 0.05, 0.3]))
        pairs.append(generate.uniform_seeded(n, e, 500 + s))
    pairs.append((b"", b""))
    pairs.append((b"A" * 5, b"C"))
    return pairs


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("quantum", [None, 128])
def test_pack_batch_staggered_matches_reference(quantum, use_native, monkeypatch):
    if use_native and not native.available():
        pytest.skip("native toolchain unavailable")
    if not use_native:
        # Both packages then take their numpy-codes path.
        monkeypatch.setattr(native, "available", lambda: False)
    pairs = _pack_pairs()
    (ref, B0) = pallas_myers.pack_batch_staggered(pairs, 16, shape_quantum=quantum)
    (got, gB0) = pack.pack_batch_staggered(pairs, 16, shape_quantum=quantum, device="cpu")
    assert gB0 == B0 == len(pairs)
    got_np = words.planes_to_numpy(*got)
    for r, g, name in zip(ref, got_np, "a0 a1 pb0 pb1 n m".split()):
        assert np.asarray(r).shape == g.shape, name
        assert np.array_equal(np.asarray(r), g), name


def test_unpack_and_pack_planes_match_reference():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    pairs = _pack_pairs()
    B, n_max, S = 16, 699, 23
    a4, pb0pm, pb1pm = native.pack_batch_planes(pairs, B, n_max, S)
    want = pallas_myers._unpack_planes(a4, pb0pm, pb1pm, n_max=n_max)
    got = pack.unpack_planes(_t(a4), _t(pb0pm), _t(pb1pm), n_max)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), words.to_numpy_u32(g))

    acodes = np.zeros((B, n_max), np.uint8)
    bcodes = np.full((B, S * 32), 0xFF, np.uint8)
    for i, (a, b) in enumerate(pairs):
        acodes[i, : len(a)] = np.frombuffer(a, np.uint8)
        bcodes[i, : len(b)] = np.frombuffer(b, np.uint8)
    want = pallas_myers._pack_planes(acodes, bcodes, S)
    got = pack.pack_planes(_t(acodes), _t(bcodes), S)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), words.to_numpy_u32(g))


def test_planes_round_trip():
    rng = np.random.default_rng(4)
    planes = [_u32(rng, (9, 6)), _u32(rng, (9, 6)), _u32(rng, (3, 6)), _u32(rng, (3, 6))]
    n, m = np.arange(6, dtype=np.int32), np.arange(6, dtype=np.int32) + 2
    t = words.planes_from_numpy(*planes, n, m, "cpu")
    assert all(x.dtype == torch.int32 for x in t[:4])
    back = words.planes_to_numpy(*t)
    for w, g in zip(planes + [n, m], back):
        assert np.array_equal(w, g)


@pytest.mark.parametrize("n_max", [8, 100, 613])
def test_schedule_and_certificates_match_reference(n_max):
    rng = np.random.default_rng(n_max)
    n = rng.integers(0, n_max + 1, 64)
    for S in (1, 3, 20):
        m = rng.integers(0, S * 32 + 1, 64)
        for sw in (1, 2, 7, 32):
            for diag in (None, (n_max, S * 32 - 5), (max(1, n_max // 2), S * 20)):
                try:
                    want = jbanded.shift_at_array(n_max, S, sw, diag)
                except AssertionError:  # too skewed for one shift a column
                    with pytest.raises(AssertionError):
                        banded.shift_at_array(n_max, S, sw, diag)
                    continue
                got = banded.shift_at_array(n_max, S, sw, diag)
                assert got.dtype == want.dtype and np.array_equal(got, want)
            m_top = S * 32 - 3
            assert np.array_equal(
                banded.band_threshold(sw, n, m, n_max, m_top),
                jbanded.band_threshold(sw, n, m, n_max, m_top),
            )
            cost = rng.integers(0, 3000, 64)
            assert np.array_equal(
                banded.band_for_cost(cost, n, m, n_max, m_top),
                jbanded.band_for_cost(cost, n, m, n_max, m_top),
            )
    assert banded.shift_schedule(n_max, 300, 4) == jbanded.shift_schedule(n_max, 300, 4)
