"""The port's CLI (``python -m astarpa_tpu_torch.cli``) against the
reference's ``astarpa_tpu.cli`` with ``--device cpu``: the cases of
``tests/test_cli.py``, one case for each other aligner, and ``--params-json``
written by the reference's ``AlignerParams``: the same output lines, each
cost the oracle's and each CIGAR verified."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from astarpa_tpu import cli as jcli
from astarpa_tpu import generate, native, oracle
from astarpa_tpu.params import AlignerParams as JParams
from astarpa_tpu.params import HeuristicParams as JHeuristic
from astarpa_tpu.params import HeuristicType as JType
from astarpa_tpu_torch import cli
from astarpa_tpu_torch.params import AlignerParams
from astarpa_tpu_torch.types import Cigar

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

needs_native = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def _run(mod, args, tmp_path, name):
    out = tmp_path / name
    assert mod.main(args + ["--output", str(out)]) == 0
    return out.read_text().strip().splitlines()


def _both(args, tmp_path, name="out.csv"):
    """The port's lines (on the CPU) and the reference's, which must agree."""
    got = _run(cli, args + ["--device", "cpu"], tmp_path, "port_" + name)
    want = _run(jcli, args, tmp_path, "ref_" + name)
    assert got == want
    return got


def _check_lines(lines, pairs):
    assert len(lines) == len(pairs)
    for (a, b), line in zip(pairs, lines):
        cost_s, cigar_s = line.split(",", 1)
        assert int(cost_s) == oracle.levenshtein(a, b)
        if cigar_s:
            assert Cigar.from_string(cigar_s).verify(a, b) == int(cost_s)


def test_cli_generated_batch(tmp_path):
    lines = _both(["--length", "300", "--error-rate", "0.08", "--cnt", "5",
                   "--seed", "11", "--aligner", "batch"], tmp_path)
    _check_lines(lines, generate.generate_batch(5, 300, 0.08, generate.ErrorModel.UNIFORM, 11))


def test_cli_batch_chunked_matches_unchunked(tmp_path):
    args = ["--length", "250", "--error-rate", "0.05", "--cnt", "7",
            "--seed", "3", "--aligner", "batch"]
    plain = _both(args, tmp_path, "plain.csv")
    chunked = _both(args + ["--chunk", "3"], tmp_path, "chunked.csv")
    assert plain == chunked
    _check_lines(chunked, generate.generate_batch(7, 250, 0.05, generate.ErrorModel.UNIFORM, 3))


def test_cli_no_cigar_and_file_input(tmp_path):
    pairs = generate.generate_batch(3, 200, 0.1, generate.ErrorModel.UNIFORM, 5)
    seq = tmp_path / "pairs.seq"
    seq.write_text("".join(f">{a.decode()}\n<{b.decode()}\n" for a, b in pairs))
    lines = _both(["--input", str(seq), "--aligner", "batch", "--no-cigar"], tmp_path)
    assert [int(l.rstrip(",")) for l in lines] == [oracle.levenshtein(a, b) for a, b in pairs]


OTHER = {
    "astarpa": ["-k", "8", "-r", "1"],
    "astarpa-native": ["-k", "10", "-r", "2", "--heuristic", "gcsh"],
    "astarpa2-simple": [],
    "astarpa2-full": [],
    "nw": [],
}


@pytest.mark.parametrize("aligner", sorted(OTHER))
def test_cli_other_aligners(aligner, tmp_path):
    if aligner == "astarpa-native" and not native.available():
        pytest.skip("native toolchain unavailable")
    args = ["-n", "180", "-e", "0.1", "--cnt", "3", "--seed", "9", "--aligner", aligner]
    lines = _both(args + OTHER[aligner], tmp_path)
    _check_lines(lines, generate.generate_batch(3, 180, 0.1, generate.ErrorModel.UNIFORM, 9))


@pytest.mark.parametrize("aligner", ["astarpa", "astarpa2-full"])
def test_cli_params_json_from_the_reference(aligner, tmp_path):
    """``AlignerParams`` JSON written by the reference loads in the port,
    builds an aligner with the same results, and drives the CLI."""
    ref = JParams(aligner=aligner, heuristic=JHeuristic(heuristic=JType.GCSH, k=9, r=2,
                                                        prune="both"), block_width=128)
    text = ref.to_json()
    params = AlignerParams.from_json(text)
    assert params.to_json() == text
    a, b = generate.uniform_seeded(240, 0.12, 21)
    got, want = params.build(device="cpu").align(a, b), ref.build().align(a, b)
    assert got[0] == want[0] == oracle.levenshtein(a, b)
    assert got[1].to_string() == want[1].to_string()
    lines = _both(["-n", "150", "--cnt", "2", "--seed", "4", "--params-json", text], tmp_path)
    _check_lines(lines, generate.generate_batch(2, 150, 0.05, generate.ErrorModel.UNIFORM, 4))


def test_cli_convert_txt(tmp_path):
    src = tmp_path / "in.txt"
    src.write_text("ACGT\nACGA\nTTTT\nTTT\n")
    for mod, name in ((cli, "port.seq"), (jcli, "ref.seq")):
        assert mod.main(["convert-txt", str(src), str(tmp_path / name)]) == 0
    assert (tmp_path / "port.seq").read_bytes() == (tmp_path / "ref.seq").read_bytes()


@needs_native
def test_cli_module_runs(tmp_path):
    """``python -m astarpa_tpu_torch.cli`` as a user runs it."""
    proc = subprocess.run(
        [sys.executable, "-m", "astarpa_tpu_torch.cli", "-n", "200", "--cnt", "4",
         "--aligner", "batch", "--chunk", "2", "--device", "cpu", "--stats"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    _check_lines(proc.stdout.strip().splitlines(),
                 generate.generate_batch(4, 200, 0.05, generate.ErrorModel.UNIFORM, 31415))
    assert '"pairs": 4' in proc.stderr
