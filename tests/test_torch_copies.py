"""The port's own copies of the JAX package's framework-free modules
(``types``, ``generate``/``chacha``, ``oracle``, ``domain``, ``native``)
against their originals: the same inputs give the same bytes, costs,
CIGARs and schedules."""

import numpy as np
import pytest

import astarpa_tpu.domain as jdomain
import astarpa_tpu.generate as jgenerate
import astarpa_tpu.oracle as joracle
import astarpa_tpu.types as jtypes
from astarpa_tpu import native as jnative
from astarpa_tpu_torch import domain, generate, native, oracle, types
from astarpa_tpu_torch.ops import bitpack

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)

SEEDS = [0, 7, 1234]


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_same_bytes(seed):
    for n, e in ((0, 0.1), (1, 0.5), (300, 0.0), (900, 0.15)):
        assert generate.uniform_seeded(n, e, seed) == jgenerate.uniform_seeded(n, e, seed)
    for model, jmodel in zip(generate.ErrorModel, jgenerate.ErrorModel):
        for rng in ("numpy", "chacha8"):
            assert generate.generate_model(400, 0.2, model, seed, rng) == \
                jgenerate.generate_model(400, 0.2, jmodel, seed, rng)
    batch = generate.generate_batch(5, 700, 0.15, seed=seed)
    assert batch == jgenerate.generate_batch(5, 700, 0.15, seed=seed)
    assert generate.generate_batch(3, 200, 0.1, seed=seed, rng="chacha8") == \
        jgenerate.generate_batch(3, 200, 0.1, seed=seed, rng="chacha8")
    if seed == SEEDS[0]:  # the port's spawned workers, once
        assert generate.generate_batch(5, 700, 0.15, seed=seed, workers=2) == batch


@pytest.mark.parametrize("seed", SEEDS)
def test_oracle_and_cigars_agree(seed):
    pairs = [generate.uniform_seeded(150 + 31 * k, [0.05, 0.3][k % 2], seed + k)
             for k in range(4)] + [(b"", b"ACG"), (b"ACGT", b"")]
    for a, b in pairs:
        assert oracle.levenshtein(a, b) == joracle.levenshtein(a, b)
        assert oracle.levenshtein_myers(a, b) == joracle.levenshtein_myers(a, b)
        cost, cig = oracle.align(a, b)
        jcost, jcig = joracle.align(a, b)
        assert cost == jcost and cig.to_string() == jcig.to_string()
        assert cig.verify(a, b) == jcig.verify(a, b) == cost
        back = types.Cigar.from_string(jcig.to_string())
        assert back.to_string() == jcig.to_string() and back.verify(a, b) == cost
    codes = types.seq_to_codes(pairs[0][0])
    assert np.array_equal(codes, jtypes.seq_to_codes(pairs[0][0]))
    assert types.Pos(3, 4) == jtypes.Pos(3, 4)
    assert [op.char for op in types.CigarOp] == [op.char for op in jtypes.CigarOp]


@needs_native
@pytest.mark.parametrize("seed", SEEDS)
def test_domain_schedules_agree(seed):
    a, b = generate.uniform_seeded(3000, 0.1, seed)
    for f in (200, 500):
        got, want = (domain.domain_schedule(domain.gap_domain(len(a), len(b), f)),
                     jdomain.domain_schedule(jdomain.gap_domain(len(a), len(b), f)))
        assert got.band_words == want.band_words and got.quantum == want.quantum
        assert np.array_equal(got.sched, want.sched)
        h, jh = native.DomainHandle(a, b, k=12, r=2), jnative.DomainHandle(a, b, k=12, r=2)
        assert h.h0 == jh.h0
        dom, jdom = h.sample(f, 64), jh.sample(f, 64)
        h.close()
        jh.close()
        assert np.array_equal(dom.lo, jdom.lo) and np.array_equal(dom.hi, jdom.hi)
        got, want = domain.domain_schedule(dom), jdomain.domain_schedule(jdom)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got.sched, want.sched)
            assert got.band_words == want.band_words
    assert bitpack.W == 32 and bitpack.n_words(65) == 3
