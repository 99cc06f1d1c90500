"""The port's own copies of the JAX package's framework-free modules
(``types``, ``generate``/``chacha``, ``oracle``, ``domain``, ``native``,
``heuristic/``, ``utils/split_vec``, ``params``, ``astar/``, ``pairs_io``)
against their originals: the same inputs give the same bytes, costs,
CIGARs, planes, schedules, matches, heuristic values, search counts, JSON
and files.  The copies of ``affine/``, ``base/``, ``vis/``, ``search``,
``testing``, ``utils/timer`` and ``experimental/compressed_history`` keep
the reference's code, docstrings aside (their behaviour is held in
``test_torch_{affine,vis,search,extras}.py``)."""

import numpy as np
import pytest

import astarpa_tpu.domain as jdomain
import astarpa_tpu.generate as jgenerate
import astarpa_tpu.oracle as joracle
import astarpa_tpu.types as jtypes
from astarpa_tpu import native as jnative
from astarpa_tpu.heuristic import bruteforce as jbruteforce
from astarpa_tpu.heuristic import csh as jcsh
from astarpa_tpu.heuristic import distances as jdistances
from astarpa_tpu.heuristic import matches as jmatches
from astarpa_tpu.heuristic import prune as jprune
from astarpa_tpu.heuristic import sh as jsh
from astarpa_tpu.utils.split_vec import SplitVec as JSplitVec
from astarpa_tpu_torch import domain, generate, native, oracle, types
from astarpa_tpu_torch.heuristic import bruteforce, csh, distances, matches, prune, sh
from astarpa_tpu_torch.ops import bitpack
from astarpa_tpu_torch.utils.split_vec import SplitVec

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


@needs_native
@pytest.mark.parametrize("seed", SEEDS)
def test_native_aligner_and_traces_agree(seed):
    """``astarpa_native``, ``trace_banded`` (from every column's window
    planes), ``trace_direct`` and ``block_fill``: the same costs, CIGAR
    strings and planes as the original loader's."""
    a, b = generate.uniform_seeded(900, 0.08, seed)
    got, want = native.astarpa_native(a, b), jnative.astarpa_native(a, b)
    assert got[0] == want[0] == oracle.levenshtein(a, b)
    assert got[1].to_string() == want[1].to_string()
    st = native.astarpa_native(a, b, r=1, k=8, prune="both", with_stats=True)
    assert st[2] == jnative.astarpa_native(a, b, r=1, k=8, prune="both", with_stats=True)[2]
    # Every column's window planes of a full-height fill (the plain version
    # of K3): lo stays 0.
    from astarpa_tpu_torch.ops import banded, words
    from astarpa_tpu_torch.ops.pack import pack_batch_staggered

    args, _ = pack_batch_staggered([(a, b)], 1, device="cpu")
    S = args[2].shape[0]
    _, vp, vm = banded.banded_fill_ref(*args, S)
    vp, vm = words.to_numpy_u32(vp)[: len(a), :, 0], words.to_numpy_u32(vm)[: len(a), :, 0]
    lo = np.zeros(len(a), np.int32)
    got, want = native.trace_banded(a, b, vp, vm, lo, S), jnative.trace_banded(a, b, vp, vm, lo, S)
    assert got[0] == want[0] == oracle.levenshtein(a, b)
    assert got[1].to_string() == want[1].to_string()
    shift = np.zeros(len(a), np.int32)
    got = native.trace_direct(a, b, S, shift, S, known_cost=want[0])
    jgot = jnative.trace_direct(a, b, S, shift, S, known_cost=want[0])
    assert got[0] == jgot[0] and got[1].to_string() == jgot[1].to_string()
    a0, a1 = bitpack.pack_a(types.seq_to_codes(a[:300]))
    pb0, pb1 = bitpack.pack_b(types.seq_to_codes(b[:200]))
    outs = []
    for mod in (native, jnative):
        vp0 = np.full(len(pb0), 0xFFFFFFFF, np.uint32)
        vm0, hp = np.zeros(len(pb0), np.uint32), np.ones(len(a0), np.uint32)
        hm = np.zeros(len(a0), np.uint32)
        cols = np.zeros((2, len(a0), len(pb0)), np.uint32)
        mod.block_fill(a0, a1, pb0, pb1, vp0, vm0, hp, hm, cols[0], cols[1])
        outs.append((vp0, vm0, hp, hm, cols))
    for g, w in zip(*outs):
        assert np.array_equal(g, w)


def _heuristics(mods):
    cfg = mods["matches"].MatchConfig
    pr = mods["prune"]
    return {
        "gcsh": mods["csh"].GCSH(cfg(k=8, r=2), pr.Pruning(pr.Prune.START)),
        "csh": mods["csh"].CSH(cfg(k=10, r=1), pr.Pruning(pr.Prune.BOTH)),
        "sh": mods["sh"].SH(cfg(k=8, r=1), pr.Pruning(pr.Prune.START)),
        "bruteforce": mods["bruteforce"].BruteForceGCSH(
            cfg(k=8, r=1), mods["distances"].GapCost(), pr.Pruning(pr.Prune.NONE)),
        "gap": mods["distances"].GapCost(),
        "count": mods["distances"].CountCost(),
        "bicount": mods["distances"].BiCountCost(),
        "mum": mods["csh"].GCSH(cfg(k=8, r=1, max_matches=2), pr.Pruning(pr.Prune.NONE)),
    }


MODS = dict(csh=csh, sh=sh, matches=matches, prune=prune, bruteforce=bruteforce,
            distances=distances)
JMODS = dict(csh=jcsh, sh=jsh, matches=jmatches, prune=jprune, bruteforce=jbruteforce,
             distances=jdistances)


@pytest.mark.parametrize("name", sorted(_heuristics(MODS)))
def test_heuristics_agree(name):
    """Each heuristic copy builds the same seeds and matches and gives the
    same h at every queried position, before and after pruning."""
    a, b = generate.uniform_seeded(400, 0.1, 11)
    got, want = _heuristics(MODS)[name].build(a, b), _heuristics(JMODS)[name].build(a, b)
    rng = np.random.default_rng(3)
    pos = [types.Pos(int(rng.integers(0, len(a) + 1)), int(rng.integers(0, len(b) + 1)))
           for _ in range(200)]
    assert [got.h(p) for p in pos] == [want.h(jtypes.Pos(p.i, p.j)) for p in pos]
    if hasattr(got, "prune"):
        for p in sorted(pos, key=lambda q: (-q.i, -q.j))[:60]:
            if got.is_seed_start_or_end(p):
                assert got.prune(p, None)[0] == want.prune(jtypes.Pos(p.i, p.j), None)[0]
        assert [got.h(p) for p in pos] == [want.h(jtypes.Pos(p.i, p.j)) for p in pos]
    if hasattr(got, "seeds"):
        ms = matches.find_matches(a, b, matches.MatchConfig(k=8, r=2), True)
        jms = jmatches.find_matches(a, b, jmatches.MatchConfig(k=8, r=2), True)
        assert [(m.start.i, m.start.j, m.end.i, m.end.j, m.match_cost) for m in ms.matches] \
            == [(m.start.i, m.start.j, m.end.i, m.end.j, m.match_cost) for m in jms.matches]


def test_split_vec_agrees():
    got, want = SplitVec(range(10)), JSplitVec(range(10))
    for v in (got, want):
        v.push(10)
        v.push(11)
    assert len(got) == len(want) and [got[i] for i in range(len(got))] == \
        [want[i] for i in range(len(want))]


def test_params_json_round_trips_both_ways():
    """``params``: the reference's JSON loads in the copy and back, and the
    copy's in the reference, for every heuristic type."""
    from astarpa_tpu import params as jparams
    from astarpa_tpu_torch import params

    for t, jt in zip(params.HeuristicType, jparams.HeuristicType):
        assert t.value == jt.value
        ref = jparams.AlignerParams(aligner="astarpa", dt=False, block_width=64,
                                    heuristic=jparams.HeuristicParams(heuristic=jt, k=9, p=1))
        got = params.AlignerParams.from_json(ref.to_json())
        assert got.to_json() == ref.to_json()
        assert jparams.AlignerParams.from_json(got.to_json()) == ref
    assert params.HeuristicParams.from_json('{"k": 7, "extra": 1}').k == 7


@pytest.mark.parametrize("kind", ["none", "zero", "gap", "max", "count", "bicount",
                                  "affine-gap", "sh", "csh", "gcsh", "bruteforce-gcsh"])
def test_params_build_the_same_heuristics(kind):
    """``HeuristicParams.build`` (the HeuristicMapper) gives the same h at
    every queried position as the reference's."""
    from astarpa_tpu import params as jparams
    from astarpa_tpu_torch import params

    a, b = generate.uniform_seeded(160, 0.1, 3)
    kw = dict(k=8, r=1, prune="none")
    got = params.HeuristicParams(heuristic=params.HeuristicType(kind), **kw).build()
    want = jparams.HeuristicParams(heuristic=jparams.HeuristicType(kind), **kw).build()
    assert type(got).__name__ == type(want).__name__
    if hasattr(got, "build"):
        got, want = got.build(a, b), want.build(a, b)
    rng = np.random.default_rng(1)
    pos = [(int(rng.integers(0, len(a) + 1)), int(rng.integers(0, len(b) + 1)))
           for _ in range(80)]
    if hasattr(got, "h"):
        assert [got.h(types.Pos(i, j)) for i, j in pos] == \
            [want.h(jtypes.Pos(i, j)) for i, j in pos]


@pytest.mark.parametrize("seed", SEEDS)
def test_astar_copy_agrees(seed):
    """``astar/``: every configuration of the search gives the reference's
    cost, CIGAR and expanded and explored counts."""
    from astarpa_tpu.astar import AstarPa as JAstarPa
    from astarpa_tpu_torch.astar import AstarPa

    a, b = generate.uniform_seeded(150, 0.12, seed)
    for dt in (False, True):
        for k, r, pr in ((8, 1, prune.Prune.START), (10, 2, prune.Prune.BOTH)):
            got = AstarPa(dt=dt, h=csh.GCSH(matches.MatchConfig(k=k, r=r), prune.Pruning(pr)))
            want = JAstarPa(dt=dt, h=jcsh.GCSH(jmatches.MatchConfig(k=k, r=r),
                                               jprune.Pruning(jprune.Prune(pr.value))))
            (c, cig), st = got.align_with_stats(a, b)
            (jc, jcig), jst = want.align_with_stats(a, b)
            assert c == jc == oracle.levenshtein(a, b)
            assert cig.to_string() == jcig.to_string()
            assert (st.expanded, st.explored) == (jst.expanded, jst.explored)


def test_pairs_io_agrees(tmp_path):
    """``pairs_io``: the same pairs from .seq, .txt and FASTA files, and the
    same bytes from the converters."""
    from astarpa_tpu import pairs_io as jio
    from astarpa_tpu_torch import pairs_io

    pairs = [generate.uniform_seeded(50 + 13 * s, 0.1, s) for s in range(3)]
    (tmp_path / "p.seq").write_text("".join(f">{a.decode()}\n<{b.decode()}\n" for a, b in pairs))
    (tmp_path / "p.txt").write_text("".join(f"{a.decode()}\n{b.decode()}\n" for a, b in pairs))
    (tmp_path / "p.fa").write_text("".join(f">r{i}a\n{a.decode()}\n>r{i}b\n{b.decode()}\n"
                                           for i, (a, b) in enumerate(pairs)))
    for name in ("p.seq", "p.txt", "p.fa"):
        path = str(tmp_path / name)
        assert list(pairs_io.read_pairs(path)) == list(jio.read_pairs(path)) == pairs
    assert pairs_io.txt_to_seq(str(tmp_path / "p.txt"), str(tmp_path / "a.seq")) == \
        jio.txt_to_seq(str(tmp_path / "p.txt"), str(tmp_path / "b.seq")) == 3
    assert (tmp_path / "a.seq").read_bytes() == (tmp_path / "b.seq").read_bytes()
    (tmp_path / "ref.fa").write_text(">chr1 x\n" + pairs[0][0].decode() + "\n")
    (tmp_path / "reads.fa").write_text(">chr1_3_aligned_0_F_2_30_4\n"
                                       + pairs[0][1][:36].decode() + "\n>junk\nACGT\n")
    got = pairs_io.nanosim_to_seq(*(str(tmp_path / n) for n in ("ref.fa", "reads.fa", "c.seq")))
    want = jio.nanosim_to_seq(*(str(tmp_path / n) for n in ("ref.fa", "reads.fa", "d.seq")))
    assert got == want == 1
    assert (tmp_path / "c.seq").read_bytes() == (tmp_path / "d.seq").read_bytes()
    with pytest.raises(ValueError):
        list(pairs_io.read_pairs(str(tmp_path / "p.csv")))


def _code(path):
    """A module's syntax tree with every docstring taken out."""
    import ast

    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", [
    "affine/__init__.py", "affine/cost_model.py", "affine/cigar.py", "base/__init__.py",
    "base/dt.py", "base/nw_affine.py", "vis/__init__.py", "vis/canvas.py", "vis/html.py",
    "utils/timer.py", "testing.py", "search.py", "experimental/__init__.py",
    "experimental/compressed_history.py"])
def test_copy_code_is_the_reference_code(rel):
    """The framework-free copies keep the reference's code: only their
    docstrings differ (relative imports resolve inside each package)."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert _code(root / "astarpa_tpu_torch" / rel) == _code(root / "astarpa_tpu" / rel)
