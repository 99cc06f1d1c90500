"""The port's full-rectangle NW path (K11) against the reference.

Plain K11 (``ops/myers.py::nw_right_edge_ref``) is held bit for bit on both
planes, pad rows included, against the Pallas kernel
``astarpa_tpu.ops.pallas_myers.nw_right_edge`` run in interpret mode on the
same packed planes.  The batch entries (``ops/nw_kernel.py::nw_cost``,
``nw_cost_pairs``, ``aligners/nw.py``) and the port's column loop
``ops/myers.py::nw_cost_batch`` are held against the reference's jnp
``myers.nw_cost_batch`` and the oracle on the inputs of
``tests/test_pallas.py`` and ``tests/test_myers.py``.  All comparisons are
exact.  The CUDA kernel's own test is in ``test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

from astarpa_tpu import generate, oracle
from astarpa_tpu.aligners import nw as jnw
from astarpa_tpu.ops import myers as jmyers
from astarpa_tpu.ops import pallas_myers
from astarpa_tpu_torch.aligners import nw
from astarpa_tpu_torch.ops import banded_kernel, myers, nw_kernel, words

torch.set_num_threads(1)


def _random_pairs(seed, count, n_lo, n_hi, m_lo, m_hi):
    rng = np.random.default_rng(seed)
    return [(generate.random_seq(int(rng.integers(n_lo, n_hi + 1)), rng),
             generate.random_seq(int(rng.integers(m_lo, m_hi + 1)), rng))
            for _ in range(count)]


def _interpret(monkeypatch):
    """Run the Pallas kernel in interpret mode on the CPU."""
    monkeypatch.setattr(pallas_myers.pl, "pallas_call",
                        functools.partial(pallas_myers.pl.pallas_call, interpret=True))


@pytest.mark.parametrize("case", ["similar", "ragged"])
def test_plain_k11_matches_pallas_interpret(monkeypatch, case):
    """Both planes bit for bit on every word, pad rows included: 16 similar
    pairs of 300-405 bp, and 32 ragged lanes (n 0-120, m 0-400, one-word
    and multi-word m, n == 0 and m == 0 lanes)."""
    if case == "similar":
        pairs = [generate.generate_model(300 + 7 * s, [0.01, 0.1, 0.3][s % 3],
                                         generate.ErrorModel.UNIFORM, 50 + s)
                 for s in range(16)]
        lanes = 16
    else:
        pairs = _random_pairs(9, 30, 1, 120, 1, 400) + [(b"", b"ACGTT"), (b"ACG", b"")]
        lanes = 32
    args, B0 = pallas_myers.pack_batch_staggered(pairs, lane_multiple=lanes)
    host = tuple(np.asarray(x) for x in args)
    assert host[2].shape[0] > 1  # multi-word m
    _interpret(monkeypatch)
    want = pallas_myers.nw_right_edge(*host[:5], lanes_per_program=lanes)
    planes = words.planes_from_numpy(*host, "cpu")
    got = myers.nw_right_edge_ref(*planes[:5])
    for g, w, name in zip(got, want, ("vp", "vm")):
        assert np.array_equal(words.to_numpy_u32(g), np.asarray(w)), name
    # The wrapper's CPU route is the plain version; costs are the oracle's.
    wrapped = nw_kernel.nw_right_edge(*planes[:5])
    assert all(torch.equal(g, w) for g, w in zip(wrapped, got))
    costs = nw_kernel.nw_cost(*planes).numpy()[:B0]
    assert list(costs) == [oracle.levenshtein(a, b) for a, b in pairs]


def _inputs(name):
    """The reference's test inputs (tests/test_pallas.py:33-60,
    tests/test_myers.py:90-126), n == 0 / m == 0 pairs, and skewed pairs
    whose profile runs to 313 words (10 kbp)."""
    if name == "pallas_oracle":
        rng = np.random.default_rng(7)
        pairs = [(b"ACTCGCT", b"AACTCGTT"), (b"A", b"T"), (b"ACGT", b"ACGT"), (b"AAAA", b"A")]
        for n, e in [(20, 0.1), (33, 0.3), (40, 0.0)]:
            pairs.append(generate.generate_model(n, e, generate.ErrorModel.UNIFORM,
                                                 int(rng.integers(1 << 31))))
        return pairs
    if name == "pallas_ragged":
        return [(b"A" * 5, b"A" * 65), (b"ACGT" * 10, b"ACGT" * 16), (b"T" * 40, b"T" * 3),
                (b"G", b"C")]
    if name == "myers_grid":
        rng = np.random.default_rng(42)
        return [generate.generate_model(n, e, generate.ErrorModel.UNIFORM,
                                        int(rng.integers(1 << 31)))
                for n in [1, 7, 31, 32, 33, 64, 100, 255, 300] for e in [0.0, 0.1, 0.4]]
    if name == "error_models":
        return [generate.generate_model(150, 0.2, model, seed)
                for model in generate.ErrorModel for seed in [1, 2, 3]]
    if name == "unequal":
        return [(b"A" * 10, b"A" * 200), (b"ACGT" * 50, b"ACGT" * 2), (b"A", b"T" * 33)]
    if name == "empty":
        return [(b"", b""), (b"", b"ACGTACGT" * 5), (b"ACGTT" * 9, b""), (b"ACG", b"AG")]
    if name == "skewed":
        rng = np.random.default_rng(3)
        return [(generate.random_seq(int(rng.integers(20, 90)), rng),
                 generate.random_seq(int(rng.integers(9000, 10_016)), rng)) for _ in range(3)]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["pallas_oracle", "pallas_ragged", "myers_grid",
                                  "error_models", "unequal", "empty", "skewed"])
def test_nw_costs_match_reference_and_oracle(name):
    """``nw_cost_pairs`` (plain K11 on the staggered pack),
    ``aligners.nw.nw_cost_batch`` (plain K11 on the reference's pack) and the
    column loop ``ops.myers.nw_cost_batch`` (on the reference's pair-major
    pack) equal the reference's jnp costs and the oracle."""
    pairs = _inputs(name)
    want = [oracle.levenshtein(a, b) for a, b in pairs]
    batch = jnw.pack_batch(pairs)
    ref = np.asarray(jmyers.nw_cost_batch(*(batch[k] for k in ("a0", "a1", "pb0", "pb1",
                                                               "n", "m"))))
    assert list(ref) == want
    assert list(nw_kernel.nw_cost_pairs(pairs, device="cpu")) == want
    got = nw.nw_cost_batch(pairs, device="cpu")
    assert got.dtype == np.int32 and list(got) == want
    planes = [words.to_tensor(batch[k], "cpu") for k in ("a0", "a1", "pb0", "pb1")]
    assert list(myers.nw_cost_batch(*planes, batch["n"], batch["m"]).numpy()) == want


def test_pack_batch_equals_reference():
    pairs = _inputs("myers_grid") + _inputs("empty")
    got, want = nw.pack_batch(pairs), jnw.pack_batch(pairs)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    for pc, pw in ((1, 1), (8, 3)):
        got, want = nw.pack_batch(pairs, pc, pw), jnw.pack_batch(pairs, pc, pw)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_single_pair_and_empty_batch():
    assert nw.nw_cost(b"ACTCGCT", b"AACTCGTT", device="cpu") == 2  # astarpa-c/example.c
    assert nw.nw_cost_batch([], device="cpu").shape == (0,)
    assert nw_kernel.nw_cost_pairs([], device="cpu").shape == (0,)


def test_device_none_means_the_card():
    """``device=None`` means the card: without one every entry raises."""
    pairs = [(b"ACGT", b"AGT")]
    if torch.cuda.is_available():
        assert list(nw_kernel.nw_cost_pairs(pairs)) == [1]
        return
    for call in (lambda: nw_kernel.nw_cost_pairs(pairs), lambda: nw_kernel.nw_cost_pairs([]),
                 lambda: nw.nw_cost_batch(pairs), lambda: nw.nw_cost(*pairs[0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_wrapper_refuses_bad_planes():
    pairs = _inputs("pallas_ragged")
    planes = words.planes_from_numpy(*(np.asarray(x) for x in
                                       pallas_myers.pack_batch_staggered(pairs, 1)[0]), "cpu")
    a0, a1, pb0, pb1, n, _ = planes
    before = banded_kernel.LAUNCHES["nw_right_edge"]
    with pytest.raises(ValueError, match="lengths in"):
        nw_kernel.nw_right_edge(a0, a1, pb0, pb1, n + a0.shape[0])
    with pytest.raises(ValueError, match="int32"):
        nw_kernel.nw_right_edge(a0.to(torch.int64), a1, pb0, pb1, n)
    with pytest.raises(ValueError, match="contiguous"):
        nw_kernel.nw_right_edge(a0, a1, pb0.T.contiguous().T, pb1, n)
    assert banded_kernel.route(a0.device, "nw_right_edge") == "torch-ref"
    assert banded_kernel.LAUNCHES["nw_right_edge"] == before


_SASS = """
        Function : _ZN3nw_kernelEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LOP3.LUT R5, R2, R3, R4, 0x96, !PT ;
.L_x_2:
        /*0020*/                   IMAD.IADD R5, R2, 0x1, R3 ;
        /*0030*/                   SHF.L.U32.HI R6, RZ, 0x1, R5 ;
        /*0040*/               @P0 BRA `(.L_x_2) ;
        /*0050*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0060*/              @!P1 BRA `(.L_x_1) ;
        /*0070*/                   EXIT ;
        Function : _Z5otherv
        /*0000*/                   ULDC UR4, c[0x0][0x0] ;
        /*0010*/                   LOP3.LUT R5, R2, R3, R4, 0x96, !PT ;
        /*0020*/               @P0 BRA 0x10 ;
        /*0030*/                   BRA 0x50 ;
        /*0050*/                   EXIT ;
"""


def test_sass_count_finds_loops_by_label_and_by_address():
    """The SASS loop finder behind the word-step count of K11's bound."""
    from astarpa_tpu_torch.ops import sass_count

    funcs = sass_count.functions(_SASS)
    assert list(funcs) == ["_ZN3nw_kernelEv", "_Z5otherv"]
    inner, outer = sass_count.loops(funcs["_ZN3nw_kernelEv"])
    assert inner == (["IMAD.IADD", "SHF.L.U32.HI", "BRA"], True)
    assert outer[1] is False and len(outer[0]) == 6
    assert sass_count.loops(funcs["_Z5otherv"]) == [(["LOP3.LUT", "BRA"], True)]
    assert [sass_count.klass(op) for op in ("LOP3.LUT", "LDG.E", "BRA", "ULDC", "IMAD.IADD")] == [
        "alu", "memory", "control", "uniform", "alu"]


_RING_SASS = """
        Function : _ZN12_GLOBAL__N_116ring_cost_kernelILi8EEEvPKh
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   SHFL.IDX PT, R5, R2, R80, 0x1f ;
        /*0020*/                   ISETP.GE.AND P1, PT, R7, R8, PT ;
        /*0030*/               @P1 BRA `(.L_x_3) ;
        /*0040*/                   MOV R9, R2 ;
.L_x_3:
        /*0050*/                   LOP3.LUT R5, R2, R3, R4, 0x96, !PT ;
        /*0060*/                   IMAD.IADD R5, R2, 0x1, R3 ;
        /*0070*/                   SHF.L.W.U32.HI R6, R9, 0x1, R5 ;
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/               @P0 BRA `(.L_x_1) ;
        /*00a0*/                   EXIT ;
.L_x_4:
        /*00b0*/                   MOV R5, R2 ;
        /*00c0*/                   BRA `(.L_x_1) ;
"""


def test_sass_step_split_of_a_ring_loop():
    """The ring mode of the SASS counter: the step loop is the largest loop
    closed by a conditional branch (not the unconditional return of an
    out-of-line block), split by class over its body and over the path
    that skips the blocks its forward conditional branches jump over; a
    ``ring_cost_kernel`` instance names its slots."""
    from astarpa_tpu_torch.ops import sass_count

    (name, lines), = sass_count.functions(_RING_SASS).items()
    assert sass_count._slots(name, 8) == 16 and sass_count._slots("_Z3fooPv", 8) == 8
    split = sass_count.step_split(lines, steps=1, slots=1)
    assert split["instructions"] == 9
    assert split["body_per_step"] == {"alu": 2.0, "fma": 1.0, "moves": 1.0, "handoff": 2.0,
                                      "tests": 1.0, "control": 2.0}
    assert split["no_event_total_per_step"] == 8.0 and "moves" not in split["no_event_per_step"]
    assert split["int_beyond_word_steps"] == 3.0 - sass_count.OPS_PER_WORD_STEP
    assert [sass_count.step_class(op) for op in ("SHFL.IDX", "IMAD.MOV.U32", "POPC", "BRX",
                                                 "LDG.E.U8", "LOP3.LUT")] == [
        "handoff", "moves", "tests", "control", "memory", "alu"]


_SPLIT_SASS = """
        Function : _ZN12_GLOBAL__N_116ring_cost_kernelILi0EEEvPKh
.L_x_7:
        /*0000*/                   LOP3.LUT R5, R2, R3, R4, 0x28, !PT ;
        /*0010*/                   IMAD.HI.U32 R6, R9, c[0x0][0x1a4], RZ ;
        /*0020*/                   LOP3.LUT R7, R5, R6, RZ, 0xfc, !PT ;
        /*0030*/                   IMAD R8, R7, c[0x0][0x1a0], R2 ;
        /*0040*/                   IMAD.WIDE.U32 R10, R8, c[0x0][0x1a4], R6 ;
        /*0050*/                   IMAD.SHL.U32 R11, R8, 0x2, RZ ;
        /*0060*/                   IMAD.IADD R12, R11, 0x1, R6 ;
        /*0070*/                   IMUL R13, R12, R11 ;
        /*0080*/                   IMAD.MOV.U32 R14, RZ, RZ, R13 ;
        /*0090*/                   SHF.L.W.U32.HI R15, R9, 0x1, R5 ;
        /*00a0*/                   IADD3 R16, R15, R5, RZ ;
        /*00b0*/                   LEA.HI R17, R16, R5, RZ, 0x1 ;
        /*00c0*/                   MOV R18, R17 ;
        /*00d0*/               @P0 BRA `(.L_x_7) ;
"""


def test_sass_step_split_by_pipe():
    """The word step's integer work split by pipe: every IMAD and IMUL form
    (.HI, .WIDE, .SHL, .IADD) is the FMA pipe's but IMAD.MOV, a move; LOP3,
    SHF, IADD3 and LEA the ALU pipe's; each over the slots, a word step."""
    from astarpa_tpu_torch.ops import sass_count

    (name, lines), = sass_count.functions(_SPLIT_SASS).items()
    assert sass_count._slots(name, 4) == 8
    split = sass_count.step_split(lines, steps=1, slots=2)
    assert split["no_event_per_step"] == {"alu": 5.0, "fma": 6.0, "moves": 2.0, "control": 1.0}
    assert split["alu_per_word_step"] == 2.5 and split["fma_per_word_step"] == 3.0
    assert split["int_beyond_word_steps"] == 11.0 - 2 * sass_count.OPS_PER_WORD_STEP
    assert [sass_count.step_class(op) for op in (
        "IMAD.HI.U32", "IMAD.WIDE.U32", "IMAD.SHL.U32", "IMAD.IADD", "IMUL.WIDE.U32", "IMAD.X",
        "IMAD.MOV.U32", "SHF.R.U32.HI", "LEA.HI.X", "IADD3.X", "LOP3.LUT")] == [
        "fma"] * 6 + ["moves"] + ["alu"] * 4

