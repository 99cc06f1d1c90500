"""K1's ring layout on what the CPU can check: the plain staggered twin
(``striped.banded_cost_staggered_ref``, K5's staggered DP under K1's
result rule, the function K1's ring kernel computes) against K1's plain
version ``banded.banded_cost_ref`` bit for bit, on pairs covered by the
window, above it (K1's ``top_val``) and below it (``INF``), and with
``n == 0``; the launch layout (lanes a pair, pairs a warp, blocks) for
every band of 1 to 63 words; and the runner's label for the K1 rungs.
``banded_cost_ref``'s parity with the JAX package is tested in
``test_torch_banded.py``; the CUDA kernel's own tests are in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, oracle
from astarpa_tpu_torch import BatchAligner
from astarpa_tpu_torch.ops import banded, banded_kernel, striped
from astarpa_tpu_torch.ops.bitpack import W
from astarpa_tpu_torch.ops.pack import pack_batch_staggered
from astarpa_tpu_torch.parallel import runner

torch.set_num_threads(1)


def _grid_pack():
    """Pairs of up to 400 bp beside b of up to 2200 bp (S = 69 words), an
    n == 0 pair, a short a against a long b (row m below the window at a
    small band) and a long a against a short b (row m above it once the
    window slides down the bucket diagonal)."""
    rng = np.random.default_rng(11)

    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [generate.uniform_seeded(int(rng.integers(1, 400)), float(rng.uniform(0, 0.3)),
                                     600 + s) for s in range(14)]
    pairs += [(seq(int(rng.integers(1, 300))), seq(int(rng.integers(300, 2200))))
              for _ in range(6)]
    pairs += [(b"", seq(90)), (b"ACG", seq(700)), (seq(390), b"ACGTAC")]
    args, _ = pack_batch_staggered(pairs, 1, device="cpu")
    return args


@pytest.mark.parametrize("sw", [1, 2, 31, 32, 33, 63])
def test_staggered_twin_equals_k1(sw):
    """The staggered twin equals K1's plain version bit for bit, with and
    without a diagonal; the grid holds covered pairs, pairs whose row m is
    above the window at their last column (cost = K1's top_val) and below
    it (INF), and an n == 0 pair (cost m)."""
    args = _grid_pack()
    a0, _, pb0, _, n, m = args
    n_max, S = a0.shape[0], pb0.shape[0]
    assert S >= 63
    kinds = set()
    for diag in (None, (n_max, S * W - 50)):
        want = banded.banded_cost_ref(*args, sw, diag)
        got = striped.banded_cost_staggered_ref(*args, sw, diag)
        assert torch.equal(got, want), (sw, diag)
        plan = striped.plan_striped(n_max, S, min(sw, S), diag)
        rows = np.asarray(m, np.int64) - striped.loend_of(plan["lo"], n).astype(np.int64) * W
        n_h = np.asarray(n)
        kinds |= {"n0" if n_h[p] == 0 else "above" if rows[p] < 0 else
                  "below" if rows[p] > min(sw, S) * W else "covered" for p in range(len(n_h))}
        assert int(want[n_h == 0][0]) == int(np.asarray(m)[n_h == 0][0])
        assert bool((want[torch.as_tensor(rows > min(sw, S) * W) & torch.as_tensor(n_h > 0)]
                     == banded.INF).all())
    assert {"n0", "below"} <= kinds
    if sw >= 31:
        assert {"covered", "above"} <= kinds


def _brute_lanes(span: int) -> int:
    for lanes in (1, 2, 4, 8, 16, 32):
        if 8 * lanes > span:
            return lanes
    return -(-span // 256) * 32


@pytest.mark.parametrize("B", [1, 31, 33, 4097])
def test_banded_ring_layout_for_every_band(B):
    """For every band of 1 to 63 words on a real geometry, and every span
    a ring takes: the fewest lanes, a power of two below a warp whose 8
    slots each hold the live words and one more, else a warp multiple
    holding them; 32 // lanes pairs a one-warp block below a warp, and
    just enough blocks for B
    pairs (B not a multiple of the pairs a block)."""
    args = _grid_pack()
    n_max, S = args[0].shape[0], args[2].shape[0]
    for sw in range(1, 64):
        span = striped.ring_span(striped.plan_striped(n_max, S, sw, None), n_max)
        assert 1 <= span <= sw
        lay = banded_kernel.banded_ring_layout(span, B)
        assert lay["lanes"] * 8 >= span and lay["lanes"] == _brute_lanes(span)
        assert lay["lanes"] == 1 or lay["lanes"] * 4 <= span or lay["lanes"] >= 32
    for span in list(range(1, 300)) + [4095, 4096]:
        lay = banded_kernel.banded_ring_layout(span, B)
        lanes, pairs = lay["lanes"], lay["pairs"]
        assert lanes == _brute_lanes(span), span
        if lanes < 32:
            assert lanes & (lanes - 1) == 0 and pairs * lanes == 32 and lay["threads"] == 32
        else:
            assert lanes % 32 == 0 and pairs == 1 and lay["threads"] == lanes
        assert lay["blocks"] * pairs >= B > (lay["blocks"] - 1) * pairs
    with pytest.raises(ValueError):
        banded_kernel.banded_ring_layout(4097, B)
    for bad in (3, 48, 8):
        with pytest.raises(ValueError, match="lanes"):
            banded_kernel.banded_ring_layout(100, B, lanes=bad)
    assert banded_kernel.banded_ring_layout(100, B, lanes=64)["threads"] == 64


def test_runner_labels_k1_rungs_as_the_ring(monkeypatch):
    """Shared cost rungs below STRIPED_MIN_SW run K1, labelled as K1's ring
    kernel on the card (the route patched as on the card); costs equal the
    oracle's."""
    pairs = [generate.uniform_seeded(300 + 41 * s, 0.08, 950 + s) for s in range(5)]
    monkeypatch.setattr(runner, "route", lambda device, kernel="banded_cost":
                        banded_kernel._LABELS[kernel])
    costs, stats = BatchAligner(band_words=4, device="cpu",
                                domain_mode="off").cost_with_stats(pairs)
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]
    assert stats.kernel == "cuda-banded-ring"
    assert banded_kernel.route(torch.device("cuda"), "banded_ring") == "cuda-banded-ring"
    assert banded_kernel.route(torch.device("cpu"), "banded_ring") == "torch-ref"


def test_every_c_entry_is_declared_for_ctypes():
    """``_build.ENTRIES`` names every C entry of ``csrc/*.cu`` with its
    pointer and int arguments (the stream last): ctypes passes an
    undeclared argument as a 32-bit int, which cuts a device pointer."""
    import re

    from astarpa_tpu_torch.ops import _build

    found = {}
    for src in _build.sources():
        for name, params in re.findall(r"\bint (astarpa_\w+)\(([^)]*)\)", src.read_text()):
            kinds = [p.strip().rsplit(" ", 1)[0] for p in params.split(",")]
            assert kinds[-1] == "void*", name  # the stream
            n_ptr = sum(k.endswith("*") for k in kinds[:-1])
            assert n_ptr + sum(k == "int" for k in kinds[:-1]) == len(kinds) - 1, name
            found[name] = (n_ptr, len(kinds) - 1 - n_ptr)
    assert found == _build.ENTRIES
