"""The block half of the port's ``ops/myers.py``, its ``BlockKernel`` (both
``use_native`` settings) and the block aligner's copies
(``aligners/{band,block,trace,astarpa2}.py``) against the JAX package's, on
the patterns of ``tests/test_myers.py`` and ``tests/test_astarpa2.py``.
Tolerance: none — bit-identical planes and h bits, equal costs and
identical CIGAR strings."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from astarpa_tpu import generate, oracle
from astarpa_tpu.aligners.astarpa2 import AstarPa2Params as JParams
from astarpa_tpu.aligners.astarpa2 import Domain as JDomain
from astarpa_tpu.aligners.band import DoublingStart as JStart
from astarpa_tpu.aligners.band import DoublingType as JDoubling
from astarpa_tpu.heuristic.distances import NoCost as JNoCost
from astarpa_tpu.ops import bitpack
from astarpa_tpu.ops import myers as jmyers
from astarpa_tpu.ops.block_kernel import BlockKernel as JBlockKernel
from astarpa_tpu.types import seq_to_codes
from astarpa_tpu_torch import native
from astarpa_tpu_torch.aligners.astarpa2 import AstarPa2Params, Domain
from astarpa_tpu_torch.aligners.band import DoublingStart, DoublingType
from astarpa_tpu_torch.heuristic.distances import NoCost
from astarpa_tpu_torch.ops import myers, words
from astarpa_tpu_torch.ops.block_kernel import BlockKernel

from test_astarpa2 import TRICKY, gen_grid

torch.set_num_threads(1)

MYERS_CASES = [(1, 0, 0.0, 1), (5, 3, 0.5, 2), (32, 0, 0.1, 3), (33, 5, 0.2, 4),
               (64, 0, 0.05, 5), (100, 17, 0.15, 6), (128, -20, 0.3, 7)]

USE_NATIVE = [pytest.param(True, marks=pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"), id="native"),
    pytest.param(False, id="torch")]


def _pair(n, m_extra, e, seed):
    a, b = generate.generate_model(n, e, generate.ErrorModel.UNIFORM, seed)
    if m_extra > 0:
        b = b + generate.random_seq(m_extra, np.random.default_rng(seed))
    elif m_extra < 0 and len(b) > -m_extra:
        b = b[:m_extra]
    return a, b or b"A"


def _t(x):
    return words.to_tensor(np.asarray(x, np.uint32), "cpu")


def _u32(x):
    return words.to_numpy_u32(x)


@pytest.mark.parametrize("n,m_extra,e,seed", MYERS_CASES)
def test_block_functions_match_reference(n, m_extra, e, seed):
    """compute/fill, from the sign masks and from match masks, on random
    left edges and top bits, equal the reference's scans; from the all-ones
    edge the right edge equals the oracle's column diffs."""
    a, b = _pair(n, m_extra, e, seed)
    a0, a1 = bitpack.pack_a(seq_to_codes(a))
    pb0, pb1 = bitpack.pack_b(seq_to_codes(b))
    rng = np.random.default_rng(seed)
    nw_, nc = len(pb0), len(a0)
    vp = rng.integers(0, 1 << 32, nw_, dtype=np.uint64).astype(np.uint32)
    vm = rng.integers(0, 1 << 32, nw_, dtype=np.uint64).astype(np.uint32) & ~vp
    hp = rng.integers(0, 2, nc).astype(np.uint32)
    hm = (rng.integers(0, 2, nc).astype(np.uint32)) & (1 - hp)
    args = (a0, a1, pb0, pb1, vp, vm, hp, hm)
    want_c = jmyers.compute_block(*map(jnp.asarray, args))
    want_f = jmyers.fill_block(*map(jnp.asarray, args))
    got_c = myers.compute_block(*map(_t, args))
    got_f = myers.fill_block(*map(_t, args))
    for g, w in zip(got_c + got_f, want_c + want_f):
        assert np.array_equal(_u32(g), np.asarray(w))
    eqs = jmyers.eq_cols(*map(jnp.asarray, (a0, a1, pb0, pb1)))
    assert np.array_equal(_u32(myers.eq_cols(*map(_t, (a0, a1, pb0, pb1)))), np.asarray(eqs))
    rest = (vp, vm, hp, hm)
    for gfn, jfn in ((myers.compute_block_eq, jmyers.compute_block_eq),
                     (myers.fill_block_eq, jmyers.fill_block_eq)):
        got = gfn(_t(eqs), *map(_t, rest))
        for g, w in zip(got, jfn(eqs, *map(jnp.asarray, rest))):
            assert np.array_equal(_u32(g), np.asarray(w))
    for j in (0, 1, len(b) // 2, len(b)):
        assert int(myers.value_to(got_c[0], got_c[1], j)) == \
            int(jmyers.value_to(want_c[0], want_c[1], j))
    # From the all-ones left edge: the oracle's right-edge column diffs.
    ones = np.full(nw_, 0xFFFFFFFF, np.uint32)
    vp_o, vm_o, _, _ = myers.compute_block(
        *map(_t, (a0, a1, pb0, pb1, ones, np.zeros(nw_), np.ones(nc), np.zeros(nc))))
    D = oracle.dp_matrix(a, b)
    vp_o, vm_o = _u32(vp_o), _u32(vm_o)
    for j in range(len(b)):
        got = ((int(vp_o[j // 32]) >> (j % 32)) & 1) - ((int(vm_o[j // 32]) >> (j % 32)) & 1)
        assert got == int(D[len(a)][j + 1] - D[len(a)][j])


def test_block_functions_empty_ranges():
    z = torch.zeros(0, dtype=torch.int32)
    v = torch.tensor([-1, 0], dtype=torch.int32)
    out = myers.fill_block(z, z, v, v, v, v, z, z)
    assert torch.equal(out[0], v) and out[2].numel() == 0 and out[4].shape == (0, 2)
    h = torch.tensor([1, 0, 1], dtype=torch.int32)
    out = myers.compute_block(h, h, z, z, z, z, h, 1 - h)
    assert torch.equal(out[2], h) and torch.equal(out[3], 1 - h)


@pytest.mark.parametrize("use_native", USE_NATIVE)
def test_block_kernel_matches_reference(monkeypatch, use_native):
    """``compute`` and ``fill`` over column and word ranges (ranges past
    the profile's end included) equal the reference kernel's, natively and
    in torch against the reference's native and jnp paths."""
    monkeypatch.setattr(BlockKernel, "use_native", use_native)
    monkeypatch.setattr(JBlockKernel, "use_native", use_native)
    a, b = generate.generate_model(700, 0.1, generate.ErrorModel.UNIFORM, 3)
    planes = bitpack.pack_a(seq_to_codes(a)) + bitpack.pack_b(seq_to_codes(b))
    got, want = BlockKernel(*planes, device="cpu"), JBlockKernel(*planes)
    rng = np.random.default_rng(1)
    S = len(planes[2])
    for i0, i1, w0, w1 in ((0, 256, 0, 4), (256, 300, 2, 9), (300, 700, S - 3, S + 2),
                           (10, 11, 0, 1)):
        nw_ = w1 - w0
        vp = rng.integers(0, 1 << 32, nw_, dtype=np.uint64).astype(np.uint32)
        vm = rng.integers(0, 1 << 32, nw_, dtype=np.uint64).astype(np.uint32) & ~vp
        hp = rng.integers(0, 2, i1 - i0).astype(np.uint32)
        for g, w in zip(got.compute(i0, i1, w0, w1, vp, vm, hp, 1 - hp),
                        want.compute(i0, i1, w0, w1, vp, vm, hp, 1 - hp)):
            assert np.array_equal(g, w) and g.dtype == np.uint32
        for g, w in zip(got.compute(i0, i1, w0, w1, vp, vm),
                        want.compute(i0, i1, w0, w1, vp, vm)):
            assert np.array_equal(g, w)
        for g, w in zip(got.fill(i0, i1, w0, w1, vp, vm), want.fill(i0, i1, w0, w1, vp, vm)):
            assert np.array_equal(g, w)
    assert got.computed_lanes == want.computed_lanes
    assert got.computed_cols == want.computed_cols
    assert (got.device is None) == use_native


def _both(name, **over):
    """The port's and the reference's params of one preset."""
    mine = replace(getattr(AstarPa2Params, name)(), device="cpu", **over)
    return mine, replace(getattr(JParams, name)(), **over)


def _agree(params, jparams, pairs, ctx=""):
    mine, ref = params.make_aligner(True), jparams.make_aligner(True)
    for a, b in pairs:
        cost, cigar, stats = mine.cost_or_align(a, b, True)
        jcost, jcigar, jstats = ref.cost_or_align(a, b, True)
        assert cost == jcost == oracle.levenshtein(a, b), (ctx, a, b)
        assert cigar.to_string() == jcigar.to_string(), (ctx, a, b)
        assert cigar.verify(a, b) == cost
        assert stats == type(stats)(**vars(jstats))


def _grid(seed, **kw):
    return [p for p, _ in gen_grid(seed=seed, **kw)]


@pytest.mark.parametrize("use_native", USE_NATIVE)
@pytest.mark.parametrize("name", ["nw", "simple", "full"])
def test_aligner_presets_match_reference(monkeypatch, use_native, name):
    monkeypatch.setattr(BlockKernel, "use_native", use_native)
    monkeypatch.setattr(JBlockKernel, "use_native", use_native)
    pairs = TRICKY + _grid(10 + len(name), sizes=(1, 20, 100, 257), errors=(0.0, 0.1, 0.5))
    _agree(*_both(name), pairs, name)
    if name == "simple":
        _agree(*_both(name), [generate.generate_model(2000, 0.05,
                                                      generate.ErrorModel.UNIFORM, 99)])


@pytest.mark.parametrize("variant", ["no-dt-trace", "gap-start", "gap-gap", "dijkstra",
                                     "dense-h", "local-doubling"])
def test_aligner_variants_match_reference(monkeypatch, variant):
    """The other domains, doublings and trace settings of
    ``tests/test_astarpa2.py`` on the torch block kernel."""
    monkeypatch.setattr(BlockKernel, "use_native", False)
    monkeypatch.setattr(JBlockKernel, "use_native", False)
    gap = dict(heuristic=None, sparse_h=False)
    over, jover, name = {
        "no-dt-trace": ({"dt_trace": False}, {"dt_trace": False}, "simple"),
        "gap-start": ({**gap, "domain": Domain.GAP_START,
                       "doubling": DoublingType.band_doubling(DoublingStart.GAP, 2.0)},
                      {**gap, "domain": JDomain.GAP_START,
                       "doubling": JDoubling.band_doubling(JStart.GAP, 2.0)}, "simple"),
        "gap-gap": ({**gap, "domain": Domain.GAP_GAP,
                     "doubling": DoublingType.band_doubling(DoublingStart.GAP, 2.0)},
                    {**gap, "domain": JDomain.GAP_GAP,
                     "doubling": JDoubling.band_doubling(JStart.GAP, 2.0)}, "simple"),
        "dijkstra": ({"heuristic": NoCost()}, {"heuristic": JNoCost()}, "simple"),
        "dense-h": ({"sparse_h": False}, {"sparse_h": False}, "simple"),
        "local-doubling": ({"doubling": DoublingType.local_doubling()},
                           {"doubling": JDoubling.local_doubling()}, "full"),
    }[variant]
    mine = replace(getattr(AstarPa2Params, name)(), device="cpu", **over)
    ref = replace(getattr(JParams, name)(), **jover)
    _agree(mine, ref, TRICKY[:4] + _grid(20, sizes=(10, 100, 300), errors=(0.05, 0.2)),
           variant)


def test_torch_block_kernel_needs_a_device_choice(monkeypatch):
    """The torch path runs on the card by default and raises without one;
    the native path takes no device."""
    monkeypatch.setattr(BlockKernel, "use_native", False)
    planes = bitpack.pack_a(seq_to_codes(b"ACGT")) + bitpack.pack_b(seq_to_codes(b"ACG"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BlockKernel(*planes)
    assert BlockKernel(*planes, device="cpu").device.type == "cpu"
