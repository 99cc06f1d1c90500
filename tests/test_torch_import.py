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
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        import astarpa_tpu_torch as att
        pairs = [att.generate.uniform_seeded(120 + 45 * s, 0.08, s)
                 for s in range(4)] + [(b"", b"ACG")]
        ba = att.BatchAligner(device="cpu")
        costs = ba.cost(pairs)
        for (a, b), c, (c2, cig) in zip(pairs, costs, ba.align(pairs)):
            assert c == c2 == cig.verify(a, b) == att.oracle.levenshtein(a, b)
        jax_mods = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
        assert not jax_mods, jax_mods
        print("ok")
    """)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


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
    assert resolve_device("cpu") == torch.device("cpu")
    auto = resolve_device(None)
    assert auto.type == ("cuda" if torch.cuda.is_available() else "cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
