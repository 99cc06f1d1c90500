"""The port's import boundary and device choice.

The main-path run happens in a subprocess: the test suite's conftest
imports jax, so only a fresh interpreter can show that the port does not.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from astarpa_tpu_torch.device import resolve_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_port_main_path_never_imports_jax():
    """Cost, align, the gap domain ladder, a striped rung (K5 and K6's
    plain versions), the full-rectangle NW entries (plain K11 and the
    column loop), the cost-then-trace route (plain K3, native A*) and the
    block aligners on the torch block kernel on the CPU load no ``jax``
    and no ``astarpa_tpu``."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        import astarpa_tpu_torch as att
        from astarpa_tpu_torch.parallel import runner
        pairs = [att.generate.uniform_seeded(120 + 45 * s, 0.08, s)
                 for s in range(4)] + [(b"", b"ACG")]
        ba = att.BatchAligner(device="cpu")
        costs = ba.cost(pairs)
        for (a, b), c, (c2, cig) in zip(pairs, costs, ba.align(pairs)):
            assert c == c2 == cig.verify(a, b) == att.oracle.levenshtein(a, b)
        gap = att.BatchAligner(device="cpu", domain_mode="gap", domain_min_bp=0)
        assert (gap.cost(pairs) == costs).all()
        runner.STRIPED_MIN_SW = 8
        calls = []
        for name in ("pinned_cost", "striped_cost", "striped_ck"):
            def spy(*args, _fn=getattr(runner, name), _name=name):
                calls.append(_name)
                return _fn(*args)
            setattr(runner, name, spy)
        big = att.BatchAligner(device="cpu", band_words=8, domain_mode="off",
                               direct_dt=False)
        res, st = big.align_with_stats(pairs[:4])
        assert st.kernel == "torch-ref"
        assert [c for c, _ in res] == list(costs[:4])
        assert (big.cost(pairs) == costs).all()
        assert {"pinned_cost", "striped_ck"} <= set(calls), calls
        from astarpa_tpu_torch.aligners import nw
        from astarpa_tpu_torch.ops import nw_kernel
        assert list(nw_kernel.nw_cost_pairs(pairs, device="cpu")) == list(costs)
        assert list(nw.nw_cost_batch(pairs, device="cpu")) == list(costs)
        # The cost-then-trace route: the fill arm (plain K3), the host arm,
        # and the block aligners (every heuristic copy) in torch.
        from dataclasses import replace
        from astarpa_tpu_torch.aligners.astarpa2 import AstarPa2Params
        from astarpa_tpu_torch.ops.block_kernel import BlockKernel
        trace = att.BatchAligner(device="cpu", combined=False, direct_dt=False)
        assert [c for c, _ in trace.align(pairs)] == list(costs)
        host = att.BatchAligner(device="cpu", combined=False, direct_dt=False,
                                band_words=128)
        long = [att.generate.uniform_seeded(4200, 0.02, 3)]
        assert host.align(long)[0][0] == att.oracle.levenshtein(*long[0])
        BlockKernel.use_native = False
        for name in ("nw", "simple", "full"):
            params = replace(getattr(AstarPa2Params, name)(), device="cpu")
            a, b = pairs[0]
            assert params.make_aligner(True).align(a, b)[0] == costs[0]
        mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "astarpa_tpu"))
        assert not mods, mods
        print("ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_slice_entry_points_never_import_jax(tmp_path):
    """The mesh (its dry run on CPU shards), the multi-host runner and its
    count merge, the single-pair API, ``params``/``pairs_io`` and the CLI
    and the fuzzer's entry points load no ``jax`` and no ``astarpa_tpu``."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        torch.set_num_threads(1)
        import astarpa_tpu_torch as att
        from astarpa_tpu_torch import cli, fuzz, pairs_io
        from astarpa_tpu_torch.params import AlignerParams
        from astarpa_tpu_torch.parallel.dryrun import dryrun_multichip
        from astarpa_tpu_torch.parallel.multihost import MultiHostRunner, _merge_counts
        pairs = [att.generate.uniform_seeded(90 + 30 * s, 0.1, s) for s in range(5)]
        mesh = att.BatchAligner(device="cpu", mesh=["cpu"] * 2, band_words=4)
        costs = mesh.cost(pairs)
        assert [c for c, _ in mesh.align(pairs)] == list(costs)
        dryrun_multichip(2, devices=["cpu"] * 2)
        res = MultiHostRunner(mesh, batch_size=2).run(pairs, r"{tmp_path / 'shard.csv'}",
                                                      with_cigars=True)
        assert res.global_pairs == 5 and _merge_counts(2**40) == (2**40,)
        a, b = pairs[0]
        for name in ("astarpa2_nw", "astarpa2_simple", "astarpa2_full"):
            assert getattr(att, name)(a, b, device="cpu")[0] == costs[0]
        assert att.astarpa(a, b)[0] == costs[0]
        assert AlignerParams(aligner="nw").build(device="cpu").align(a, b)[0] == costs[0]
        pairs_io.write_pairs_seq(r"{tmp_path / 'p.seq'}", pairs)
        assert cli.main(["-i", r"{tmp_path / 'p.seq'}", "--aligner", "batch", "--device",
                         "cpu", "-o", r"{tmp_path / 'out.csv'}"]) == 0
        assert fuzz.main(["--aligner", "batch-ck", "--iters", "2", "--seed", "1",
                          "--device", "cpu"]) == 0
        mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "astarpa_tpu"))
        assert not mods, mods
        print("ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"



def test_remaining_modules_never_import_jax(tmp_path):
    """The semi-global search, ``affine/``, ``base/``, ``experimental/``
    (``PathHeuristic`` on ``device="cpu"``), ``vis/``, the figure suite,
    ``testing``, ``utils.timer`` and ``ops.layouts`` load no ``jax`` and no
    ``astarpa_tpu`` when imported and driven."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        torch.set_num_threads(1)
        import astarpa_tpu_torch as att
        from astarpa_tpu_torch import figures, testing
        from astarpa_tpu_torch.affine import AffineCost
        from astarpa_tpu_torch.base import DiagonalTransition, NwAffine
        from astarpa_tpu_torch.experimental import PathHeuristic, dt_align_compressed
        from astarpa_tpu_torch.heuristic.csh import GCSH
        from astarpa_tpu_torch.heuristic.matches import MatchConfig
        from astarpa_tpu_torch.heuristic.prune import Pruning
        from astarpa_tpu_torch.ops import bitpack, layouts, words
        from astarpa_tpu_torch.search import search
        from astarpa_tpu_torch.utils.timer import Timer
        from astarpa_tpu_torch.vis import VisConfig
        from astarpa_tpu_torch.vis.html import export_html
        assert "search" not in att.__all__
        a, b = att.generate.uniform_seeded(160, 0.08, 2)
        cost = att.oracle.levenshtein(a, b)
        res = search(a[40:100], a, 0.5)
        assert res.out[100] == 0 and res.trace(100)[1][-1] == (100, 60)
        assert DiagonalTransition(dc=True).align(a, b)[0] == cost
        assert NwAffine(AffineCost.unit()).align(a, b)[0] == cost
        assert dt_align_compressed(a, b)[0] == cost
        h = PathHeuristic(GCSH(MatchConfig(k=8, r=1), Pruning.disabled()), device="cpu")
        assert h.build_with_cost(a, b)[0] == cost
        assert figures.main(["--small", "--fig", "intro", "--device", "cpu",
                             "--out", r"{tmp_path / 'fig'}"]) == 0
        export_html(r"{tmp_path / 'fig' / 'intro-gcsh'}", r"{tmp_path / 'x.html'}")
        class One:
            ba = att.BatchAligner(device="cpu")

            def align(self, x, y):
                return self.ba.align([(x, y)])[0]

        testing.check_aligner_up_to(One(), max_n=60, samples=2)
        bb = b[:128]
        planes = [words.to_tensor(x, "cpu") for x in
                  bitpack.pack_a(att.types.seq_to_codes(a)) + bitpack.pack_b(att.types.seq_to_codes(bb))]
        st = layouts.diag_ru(*planes)
        assert layouts.distance(st[2], st[3], len(bb)) == att.oracle.levenshtein(a, bb)
        Timer(1, 0).end(type("O", (), {{"t": 0.0}})(), "t")
        mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "astarpa_tpu"))
        assert not mods, mods
        print("ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"

def test_cuda_request_raises_without_a_gpu():
    from astarpa_tpu_torch import BatchAligner

    if torch.cuda.is_available():
        assert BatchAligner(device="cuda").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchAligner(device="cuda")
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")


def test_resolve_device():
    """None means the card, as "cuda" does: it raises without one; only
    "cpu" runs on the CPU."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
        from astarpa_tpu_torch import BatchAligner

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BatchAligner()
    with pytest.raises(ValueError):
        resolve_device("meta")
