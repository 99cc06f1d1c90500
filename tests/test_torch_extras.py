"""The port's auxiliary modules against the reference's: the ``pa-test``
harness (``testing``) on the port's aligners, the sampling ``Timer``, the
compressed DT history, ``PathHeuristic`` on ``device="cpu"`` and the five
scalar layouts (``ops.layouts``, int32-view tensors) bit for bit against
the reference's numpy output.  Every comparison is exact."""

import numpy as np
import pytest
import torch

from astarpa_tpu import testing as jtesting
from astarpa_tpu.experimental import compressed_history as jch
from astarpa_tpu.experimental import PathHeuristic as JPathHeuristic
from astarpa_tpu.heuristic import csh as jcsh
from astarpa_tpu.heuristic import matches as jmatches
from astarpa_tpu.heuristic import prune as jprune
from astarpa_tpu.ops import bitpack as jbitpack
from astarpa_tpu.ops import layouts as jlayouts
from astarpa_tpu.types import Pos as JPos
from astarpa_tpu_torch import api, generate, oracle, testing, types
from astarpa_tpu_torch.astar import AstarPa
from astarpa_tpu_torch.experimental import PathHeuristic
from astarpa_tpu_torch.experimental.compressed_history import (
    CompressedHistory,
    TracebackState,
    dt_align_compressed,
)
from astarpa_tpu_torch.heuristic.csh import GCSH
from astarpa_tpu_torch.heuristic.matches import MatchConfig
from astarpa_tpu_torch.heuristic.prune import Prune, Pruning
from astarpa_tpu_torch.ops import layouts, words
from astarpa_tpu_torch.utils.timer import Timer

torch.set_num_threads(1)


class _Obj:
    calls = 0
    dur = 0.0


def test_sampling_timer():
    o = _Obj()
    for _ in range(128):
        t = Timer.each(64, o, "calls")
        t.end(o, "dur")
    assert o.calls == 128
    assert o.dur >= 0.0
    # One call in ``period`` is timed; the others add nothing.
    assert Timer(64, 1).end(o, "dur") == 0.0 and Timer(64, 64).t0 is not None


class _Api:
    """``.align(a, b)`` over one of the port's single-pair entry points."""

    def __init__(self, name):
        self.fn = getattr(api, name)

    def align(self, a, b):
        return self.fn(a, b, device="cpu")


class _Batch:
    """``.align(a, b)`` over ``BatchAligner(device="cpu")``, one pair a
    call."""

    def __init__(self, **kw):
        from astarpa_tpu_torch import BatchAligner

        self.ba = BatchAligner(device="cpu", **kw)

    def align(self, a, b):
        return self.ba.align([(a, b)])[0]


def test_tricky_pairs_agree():
    assert testing.TRICKY_PAIRS == jtesting.TRICKY_PAIRS
    assert (b"", b"") in testing.TRICKY_PAIRS


@pytest.mark.parametrize("name", ["astarpa", "astarpa2_nw", "astarpa2_simple",
                                  "astarpa2_full", "batch", "batch-ck"])
def test_testing_harness_passes_on_the_port(name):
    if name == "astarpa":
        aligner = AstarPa(dt=True, h=GCSH(MatchConfig(k=8, r=1), Pruning(Prune.START)))
    elif name.startswith("astarpa2"):
        aligner = _Api(name)
    else:
        aligner = _Batch(direct_dt=name == "batch")
    testing.check_aligner_up_to(aligner, max_n=120, samples=10)


def test_testing_harness_catches_bad_aligner():
    class Bad:
        def align(self, a, b):
            return 0, None

    with pytest.raises(AssertionError):
        testing.check_aligner_up_to(Bad(), max_n=50, samples=3)

    class OffByOne:
        def align(self, a, b):
            return oracle.levenshtein(a, b) + 1

    with pytest.raises(AssertionError):
        testing.check_aligner(OffByOne())


def test_compressed_history_agrees():
    """``dt_align_compressed``: the reference's cost, CIGAR and swept store
    (one anchor per error edge plus the root), and the anchor walk."""
    rng = np.random.default_rng(11)
    cases = [(b"", b""), (b"A", b""), (b"", b"ACGT"), (b"ACGT", b"ACGT"),
             (b"AAAA", b"AACAA"), (b"ACAC", b"CACA")]
    for n, e in [(20, 0.1), (64, 0.05), (130, 0.2), (200, 0.02), (80, 0.5)]:
        cases.append(generate.generate_model(n, e, generate.ErrorModel.UNIFORM,
                                             seed=int(rng.integers(1 << 30))))
    for a, b in cases:
        cost, cigar, hist = dt_align_compressed(a, b)
        jcost, jcigar, jhist = jch.dt_align_compressed(a, b)
        assert cost == jcost == oracle.levenshtein(a, b), (a, b)
        assert cigar.to_string() == jcigar.to_string()
        assert cigar.verify(a, b) == cost
        assert len(hist.states) == len(jhist.states) == cost + 1
        assert [(p, s.d, s.fr) for p, s in hist.states] == \
            [(p, s.d, s.fr) for p, s in jhist.states]

    h = CompressedHistory()
    p1 = h.push(TracebackState.from_coords(2, 2), h.ROOT)
    p2 = h.push(TracebackState.from_coords(4, 4), p1)
    assert h.traceback(TracebackState.from_coords(6, 5), p2).to_string() == "2=1X1=1D1="


class _Prebuilt:
    def __init__(self, inst):
        self.inst = inst

    def build(self, a, b):
        return self.inst


@pytest.mark.parametrize("seed", [3, 4])
def test_path_heuristic_agrees(seed):
    """``PathHeuristic(device="cpu")``: the reference's path cost, the same
    matches pruned and the same h everywhere; the pre-pruned instance still
    admits the optimal cost in A*."""
    a, b = generate.uniform_seeded(200, 0.1, seed)
    cost, inst = PathHeuristic(GCSH(MatchConfig(k=8, r=1), Pruning.disabled()),
                               device="cpu").build_with_cost(a, b)
    jcost, jinst = JPathHeuristic(jcsh.GCSH(jmatches.MatchConfig(k=8, r=1),
                                            jprune.Pruning.disabled())).build_with_cost(a, b)
    assert cost == jcost == oracle.levenshtein(a, b)
    assert [(m.start.i, m.start.j, m.is_active()) for m in inst.pruner] == \
        [(m.start.i, m.start.j, m.is_active()) for m in jinst.pruner]
    assert any(not m.is_active() for m in inst.pruner)
    rng = np.random.default_rng(seed)
    pos = [(int(rng.integers(0, len(a) + 1)), int(rng.integers(0, len(b) + 1)))
           for _ in range(200)]
    assert [inst.h(types.Pos(i, j)) for i, j in pos] == [jinst.h(JPos(i, j)) for i, j in pos]
    (c2, cigar), _ = AstarPa(dt=False, h=_Prebuilt(inst)).align_with_stats(a, b)
    assert c2 == cost and cigar.verify(a, b) == c2


LAYOUT_CASES = [(1, 96, 0.1), (2, 200, 0.3), (3, 64, 0.0)]


@pytest.mark.parametrize("name", sorted(layouts.LAYOUTS))
@pytest.mark.parametrize("seed,n,e", LAYOUT_CASES)
def test_scalar_layouts_bit_identical(seed, n, e, name):
    """Each order on int32-view tensors: bit-equal to the reference's numpy
    ``col`` (and to the same order there), and the oracle distance."""
    a, b = generate.generate_model(n, e, generate.ErrorModel.UNIFORM, seed)
    b = b[: (len(b) // 32) * 32]  # word-aligned rows: no padding terms
    planes = jbitpack.pack_a(types.seq_to_codes(a)) + jbitpack.pack_b(types.seq_to_codes(b))
    got = layouts.LAYOUTS[name](*(words.to_tensor(x, "cpu") for x in planes))
    assert all(x.dtype == torch.int32 for x in got)
    for want in (jlayouts.col(*planes), jlayouts.LAYOUTS[name](*planes)):
        for x, y in zip(got, want):
            assert np.array_equal(words.to_numpy_u32(x), np.asarray(y, np.uint32))
    assert layouts.distance(got[2], got[3], len(b)) == oracle.levenshtein(a, b) == \
        jlayouts.distance(*(np.asarray(x) for x in jlayouts.col(*planes)[2:]), len(b))
