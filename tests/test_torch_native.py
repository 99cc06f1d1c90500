"""The port's native loader: its own library, built once under a lock.

Several processes load the port's native library at once from an empty
build directory (as test workers or a process pool do); every one loads
the same whole file, no partial file is left behind, and the JAX
package's ``native/libastarpa_native.so`` is not replaced.
"""

import subprocess
import sys
from pathlib import Path

from astarpa_tpu_torch import native

REPO = Path(__file__).resolve().parents[1]

_CHILD = """
import sys
from pathlib import Path
import astarpa_tpu_torch.native as n
n._BUILD_DIR = Path(sys.argv[1])
print(n.available(), n._lib._name)
"""


def test_library_path_is_the_ports_own():
    so = native._so_path()
    assert so.parent == REPO / "build" / "native"
    assert so.name.startswith("libastarpa_native_") and so.suffix == ".so"
    assert so != REPO / "native" / "libastarpa_native.so"


def test_concurrent_loaders_share_one_build(tmp_path):
    jax_so = REPO / "native" / "libastarpa_native.so"
    before = jax_so.stat().st_mtime_ns if jax_so.exists() else None
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=600)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    want = str(tmp_path / native._so_path().name)
    assert outs == [["True", want]] * 3
    # One library and the lock: no partial file or build directory is left.
    assert sorted(x.name for x in tmp_path.iterdir()) == ["build.lock", Path(want).name]
    after = jax_so.stat().st_mtime_ns if jax_so.exists() else None
    assert after == before
