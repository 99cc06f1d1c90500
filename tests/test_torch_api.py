"""The port's single-pair API (``astarpa_tpu_torch.api``, exported from the
package) against the reference's ``astarpa_tpu.api`` and the oracle, on the
cases of ``tests/test_astar.py`` and ``tests/test_astarpa2.py`` that the
entries cover: the same costs and CIGAR strings, every CIGAR verified."""

import pytest
import torch

import astarpa_tpu.api as japi
import astarpa_tpu_torch as att
from astarpa_tpu import oracle
from astarpa_tpu.heuristic.prune import Prune as JPrune
from astarpa_tpu_torch import generate
from astarpa_tpu_torch.heuristic.prune import Prune
from astarpa_tpu_torch.ops.block_kernel import BlockKernel
from test_astar import _grid
from test_astarpa2 import TRICKY, gen_grid

torch.set_num_threads(1)

BLOCK = ("astarpa2_nw", "astarpa2_simple", "astarpa2_full")


def _same(got, want, a, b):
    assert got[0] == want[0] == oracle.levenshtein(a, b), (a, b)
    assert got[1].to_string() == want[1].to_string(), (a, b)
    assert got[1].verify(a, b) == got[0]


@pytest.mark.parametrize("name", BLOCK)
@pytest.mark.parametrize("a,b", TRICKY)
def test_block_entries_tricky(name, a, b):
    _same(getattr(att, name)(a, b, device="cpu"), getattr(japi, name)(a, b), a, b)


@pytest.mark.parametrize("name", BLOCK)
def test_block_entries_grid(name):
    for (a, b), _ in gen_grid(seed=1, sizes=(1, 20, 64, 100, 257), errors=(0.0, 0.1, 0.5)):
        _same(getattr(att, name)(a, b, device="cpu"), getattr(japi, name)(a, b), a, b)


def test_block_entries_on_the_torch_block_dp(monkeypatch):
    """With the native block DP switched off, the entries run the torch
    block DP on the device they are given, with the same results; None
    means the card, which raises without one."""
    monkeypatch.setattr(BlockKernel, "use_native", False)
    a, b = generate.uniform_seeded(300, 0.1, 5)
    for name in BLOCK:
        _same(getattr(att, name)(a, b, device="cpu"), getattr(japi, name)(a, b), a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            att.astarpa2_simple(a, b)


def test_astarpa_full_grid_default():
    """``tests/test_astar.py::test_full_grid_default``: the public
    ``astarpa`` on the generator grid."""
    for a, b in _grid(4242):
        _same(att.astarpa(a, b), japi.astarpa(a, b), a, b)


def test_astarpa_tricky_pairs():
    cases = [(b"", b""), (b"A", b""), (b"", b"A"), (b"A", b"A"), (b"A", b"C"),
             (b"ACGT" * 10, b"ACGT" * 10), (b"AAAAAAAAAA", b"TTTTTTTTTT"),
             (b"ACGTACGTAC", b"ACGTTACGTA"),
             (b"AGCCGCGACGTTTAAGGCAG", b"AGCCGCGACGTTTAAGGCAG"[::-1])]
    for a, b in cases:
        _same(att.astarpa(a, b), japi.astarpa(a, b), a, b)


@pytest.mark.parametrize("r,k,prune", [(1, 8, "START"), (2, 10, "NONE"), (2, 15, "START")])
def test_astarpa_gcsh_params(r, k, prune):
    for seed in (3, 4):
        a, b = generate.uniform_seeded(200, 0.15, seed)
        _same(att.astarpa_gcsh(a, b, r, k, Prune[prune]),
              japi.astarpa_gcsh(a, b, r, k, JPrune[prune]), a, b)


def test_package_exports():
    for name in BLOCK + ("astarpa", "astarpa_gcsh"):
        assert name in att.__all__ and callable(getattr(att, name))
    assert att.AstarPa.__module__ == "astarpa_tpu_torch.astar"
