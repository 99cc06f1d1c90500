"""The port's semi-global search (``astarpa_tpu_torch.search``) against the
reference's (``astarpa_tpu.search``) and its dense oracle: the reference's
six cases run on the port, and the same seeded patterns and texts go
through both packages with equal output arrays and equal traces.  Every
comparison is exact."""

import numpy as np
import pytest

from astarpa_tpu import search as jsearch
from astarpa_tpu_torch import generate
from astarpa_tpu_torch.search import search
from astarpa_tpu_torch.types import CigarOp
from test_search import _rand_seq, semiglobal_oracle


def _same_trace(got, want):
    cig, poss = got
    jcig, jposs = want
    assert cig.to_string() == jcig.to_string()
    assert [(p.i, p.j) for p in poss] == [(p.i, p.j) for p in jposs]


def test_reference_docstring_example():
    res = search(b"AC", b"CTTACTTA", 0.0)
    assert res.out == [0, 0, 1, 2, 1, 0, 1, 2, 1, 0, 0]


@pytest.mark.parametrize("unmatched", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("plen", [5, 17, 32, 47, 64])
def test_search_out_vs_oracle_and_reference(plen, unmatched):
    rng = np.random.default_rng(plen * 10 + int(unmatched * 10))
    for trial in range(3):
        text = _rand_seq(rng, 150)
        pattern = _rand_seq(rng, plen)
        res = search(pattern, text, unmatched)
        exp, _ = semiglobal_oracle(pattern, text, unmatched)
        assert res.out == exp, (trial, pattern, text)
        ref = jsearch.search(pattern, text, unmatched)
        assert res.out == ref.out
        assert np.array_equal(res._planes, ref._planes)
        assert np.array_equal(res._v0p, ref._v0p) and res._padding == ref._padding
        for idx in range(0, len(text) + 1, 37):
            _same_trace(res.trace(idx), ref.trace(idx))


@pytest.mark.parametrize("unmatched", [0.0, 0.5, 1.0])
def test_search_wildcards(unmatched):
    rng = np.random.default_rng(5)
    text = _rand_seq(rng, 120)
    pattern = bytearray(_rand_seq(rng, 20))
    pattern[3] = ord("N")
    pattern[7] = ord("*")
    pattern[11] = ord("Y")
    pattern[15] = ord("R")
    pattern = bytes(pattern)
    res = search(pattern, text, unmatched)
    exp, _ = semiglobal_oracle(pattern, text, unmatched)
    assert res.out == exp == jsearch.search(pattern, text, unmatched).out
    ref = jsearch.search(pattern, text, unmatched)
    for idx in range(0, len(res.out), 11):
        _same_trace(res.trace(idx), ref.trace(idx))
    with pytest.raises(ValueError):
        search(b"ACQ", text)


def test_search_finds_embedded_pattern():
    rng = np.random.default_rng(9)
    pattern = _rand_seq(rng, 30)
    noise1 = _rand_seq(rng, 70)
    noise2 = _rand_seq(rng, 50)
    text = noise1 + pattern + noise2
    res = search(pattern, text, 0.0)
    end = len(noise1) + len(pattern)
    assert res.out[end] == 0
    cigar, poss = res.trace(end)
    assert poss[0] == (len(noise1), 0)
    assert poss[-1] == (end, len(pattern))
    assert all(e.op == CigarOp.MATCH for e in cigar.ops)
    _same_trace((cigar, poss), jsearch.search(pattern, text, 0.0).trace(end))


def test_search_trace_costs():
    rng = np.random.default_rng(11)
    _rand_seq(rng, 25)
    a, b = generate.uniform_seeded(25, 0.2, 3)
    text = _rand_seq(rng, 40) + b + _rand_seq(rng, 40)
    res = search(a, text, 0.0)
    ref = jsearch.search(a, text, 0.0)
    assert res.out == ref.out
    # Every bottom-row index must trace to a CIGAR of exactly its cost.
    for idx in range(0, len(text) + 1, 7):
        cigar, poss = res.trace(idx)
        cost = sum(e.cnt for e in cigar.ops if e.op != CigarOp.MATCH)
        assert cost == res.out[idx]
        # The path consumes the whole pattern down to a free start.
        assert poss[-1][1] == len(a)
        _same_trace((cigar, poss), ref.trace(idx))


def test_search_trace_right_column():
    res = search(b"ACGTACGT", b"TTACGTAC", 0.0)
    ref = jsearch.search(b"ACGTACGT", b"TTACGTAC", 0.0)
    n = 8
    for idx in range(n + 1, len(res.out), 3):
        cigar, poss = res.trace(idx)
        cost = sum(e.cnt for e in cigar.ops if e.op != CigarOp.MATCH)
        j_end = res.idx_to_pos(idx).j
        assert poss[-1][1] == j_end
        assert cost <= res.out[idx]
        _same_trace((cigar, poss), ref.trace(idx))


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_search_planted_pattern_agrees(seed):
    """A pattern cut from a generated text with edits planted and one
    ``N``, at each unmatched cost: equal outputs, and the best match traces
    to the same CIGAR and positions in both packages."""
    text, _ = generate.uniform_seeded(2000, 0.0, seed)
    rng = np.random.default_rng(seed)
    at = int(rng.integers(0, len(text) - 150))
    pattern = bytearray(text[at:at + 150])
    for k in rng.choice(150, 7, replace=False):
        pattern[k] = b"ACGT"[(b"ACGT".index(pattern[k]) + 1) % 4]
    pattern[int(rng.integers(0, 150))] = ord("N")
    pattern = bytes(pattern)
    for unmatched in (0.0, 0.5, 1.0):
        res, ref = search(pattern, text, unmatched), jsearch.search(pattern, text, unmatched)
        assert res.out == ref.out
        best = int(np.argmin(res.out[: len(text) + 1]))
        assert res.out[best] <= 7
        _same_trace(res.trace(best), ref.trace(best))
