"""The port's multi-host runner on ``torch.distributed`` against the
reference's: the stripes, the exact count merge, the output shards line for
line, and a real two-process gloo run (in fresh interpreters that load no
``jax``) merging counts past 2^24 exactly."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from astarpa_tpu import generate, oracle
from astarpa_tpu.parallel.multihost import MultiHostRunner as RefRunner
from astarpa_tpu.parallel.multihost import host_stripe as ref_stripe
from astarpa_tpu.parallel.runner import BatchAligner as RefAligner
from astarpa_tpu_torch.parallel.multihost import (MultiHostRunner, _merge_counts,
                                                  host_stripe, init_distributed)
from astarpa_tpu_torch.parallel.runner import BatchAligner
from astarpa_tpu_torch.types import Cigar

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_host_stripe_partition():
    n, pc = 23, 4
    stripes = [host_stripe(n, p, pc) for p in range(pc)]
    assert sorted(int(i) for s in stripes for i in s) == list(range(n))
    for p, s in enumerate(stripes):
        assert all(i % pc == p for i in s)
        assert list(s) == list(ref_stripe(n, p, pc))


def test_init_distributed_single_process():
    assert init_distributed() == (0, 1)


def test_merge_counts_single_process():
    assert _merge_counts(7, 1000) == (7, 1000)


def test_merge_counts_exact_beyond_float32():
    """Counters past the 2^24 float32 integer range, and past 2^63, come
    back exactly (16-bit limbs)."""
    vals = (2**53 - 111, 2**24 + 1, 41_000_000, 0, 2**64 - 1)
    assert _merge_counts(*vals) == vals


@pytest.mark.parametrize("bad", [-1, 2**64])
def test_merge_counts_refuses_counts_outside_64_bits(bad):
    with pytest.raises(ValueError):
        _merge_counts(bad)


def _shard_lines(runner, pairs, path, **kw):
    res = runner.run(pairs, out_path=str(path), **kw)
    return res, path.read_text().splitlines()


def test_runner_two_simulated_hosts(tmp_path):
    pairs = [
        generate.generate_model(100 + 17 * s, 0.1, generate.ErrorModel.UNIFORM, s)
        for s in range(9)
    ]
    runner = MultiHostRunner(BatchAligner(device="cpu", band_words=4, lane_multiple=8),
                             batch_size=4)
    ref = RefRunner(RefAligner(band_words=4, lane_multiple=8), batch_size=4)
    seen = {}
    for p in range(2):
        res, lines = _shard_lines(runner, pairs, tmp_path / f"shard{p}.csv",
                                  process_index=p, process_count=2)
        ref_res, ref_lines = _shard_lines(ref, pairs, tmp_path / f"ref{p}.csv",
                                          process_index=p, process_count=2)
        assert lines == ref_lines
        stripe = host_stripe(len(pairs), p, 2)
        assert res.local_pairs == ref_res.local_pairs == len(stripe)
        assert res.local_bp == ref_res.local_bp
        assert (res.global_pairs, res.global_bp) == (res.local_pairs, res.local_bp)
        for i, line in zip(stripe, lines):
            seen[int(i)] = int(line.split(",")[0])
    assert [seen[i] for i in range(len(pairs))] == [oracle.levenshtein(a, b) for a, b in pairs]


def test_runner_with_cigars(tmp_path):
    pairs = [generate.uniform_seeded(80, 0.15, s) for s in range(4)]
    runner = MultiHostRunner(BatchAligner(device="cpu", band_words=4, lane_multiple=8),
                             batch_size=2)
    res, lines = _shard_lines(runner, pairs, tmp_path / "shard.csv", with_cigars=True)
    ref = RefRunner(RefAligner(band_words=4, lane_multiple=8), batch_size=2)
    _, ref_lines = _shard_lines(ref, pairs, tmp_path / "ref.csv", with_cigars=True)
    assert len(lines) == len(pairs)
    assert [l.split(",")[0] for l in lines] == [l.split(",")[0] for l in ref_lines]
    for (a, b), line in zip(pairs, lines):
        cost, cig = line.split(",", 1)
        assert Cigar.from_string(cig).verify(a, b) == int(cost) == oracle.levenshtein(a, b)
    assert res.stats.pairs == len(pairs) and res.stats.direct_traces == len(pairs)


WORKER = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from astarpa_tpu_torch import generate
    from astarpa_tpu_torch.parallel.multihost import (MultiHostRunner, _merge_counts,
                                                      init_distributed)
    from astarpa_tpu_torch.parallel.runner import BatchAligner
    port, pid, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    rank, size = init_distributed(f"127.0.0.1:{port}", 2, pid)
    pairs = [generate.uniform_seeded(60 + 7 * s, 0.1, s) for s in range(9)]
    runner = MultiHostRunner(BatchAligner(device="cpu", band_words=4, lane_multiple=8),
                             batch_size=4)
    res = runner.run(pairs, out_path=out, with_cigars=True)
    big = _merge_counts(2**40 + 3 * pid, 2**24 + 1, 2**63 + pid)
    mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "astarpa_tpu"))
    print(json.dumps({"rank": rank, "size": size, "local": res.local_pairs,
                      "global": res.global_pairs, "gbp": res.global_bp,
                      "big": [str(v) for v in big], "mods": mods}))
""")


def test_two_process_gloo_merge(tmp_path):
    """Two OS processes join one gloo group on localhost, each aligns its
    stripe and writes its shard; the merged counts equal the sums, past
    2^24 and 2^63 exactly, and neither process loads jax."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(script), str(port), str(p),
                               str(tmp_path / f"out{p}.csv")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=ROOT)
             for p in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-2000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    pairs = [generate.uniform_seeded(60 + 7 * s, 0.1, s) for s in range(9)]
    total_bp = sum(len(a) for a, _ in pairs)
    want_big = [str(2 * 2**40 + 3), str(2 * (2**24 + 1)), str(2 * 2**63 + 1)]
    assert sorted(o["rank"] for o in outs) == [0, 1]
    for o in outs:
        assert o["size"] == 2 and o["global"] == 9 and o["gbp"] == total_bp
        assert o["big"] == want_big and o["mods"] == []
    assert sum(o["local"] for o in outs) == 9
    seen = {}
    for o in outs:
        stripe = host_stripe(len(pairs), o["rank"], 2)
        lines = (tmp_path / f"out{o['rank']}.csv").read_text().splitlines()
        for i, line in zip(stripe, lines):
            cost, cig = line.split(",", 1)
            a, b = pairs[int(i)]
            assert Cigar.from_string(cig).verify(a, b) == int(cost) == oracle.levenshtein(a, b)
            seen[int(i)] = int(cost)
    assert sorted(seen) == list(range(9))
