"""The import check and the read check: a run loads neither JAX nor the JAX
package, and opens no file of the JAX package, ``bench.py`` or
``scripts/``."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from conftest import ROOT

from portbench import harness


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "astarpa_tpu_torch_like", sys)
    assert "astarpa_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "astarpa_tpu.fake", sys)
    assert harness.banned_modules() == ["astarpa_tpu"]


def test_run_imports_and_reads_no_jax(tiny_root):
    """A whole tiny run in a fresh interpreter, with every file it opens
    recorded: the check of loaded modules passes, and nothing is read from
    the JAX package, bench.py, scripts/ or chip_smoke.py."""
    code = textwrap.dedent(f"""
        import json, sys, time
        opened = []
        sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
        sys.path[:0] = [{str(ROOT)!r}]
        from pathlib import Path
        from portbench import harness
        res, _ = harness.run_cell(Path({str(tiny_root)!r}), "tiny-align", 5, 0.5, False,
                                  time.perf_counter(), device="cpu")
        print(json.dumps(dict(banned=harness.banned_modules(), opened=opened,
                              correct=res["correct"])))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["banned"] == [] and got["correct"]
    bad = [str(ROOT / "astarpa_tpu") + "/", str(ROOT / "bench.py"), str(ROOT / "scripts") + "/",
           str(ROOT / "chip_smoke.py")]
    assert not [p for p in got["opened"] if any(p.startswith(b) for b in bad)]
