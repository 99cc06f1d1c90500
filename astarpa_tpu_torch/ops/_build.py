"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``
(all started together), and the objects are linked into one shared library
with a plain C interface, loaded with ctypes.  The output goes to
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so a fresh checkout builds at first use and an edited source
never loads a stale library.  ``ptxas -v`` (registers, shared memory and
spills of every kernel) is kept beside the library in a ``.log`` file.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libastarpa_cuda_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built"
    )


def build() -> Path:
    """Compile the library if the current sources have none; returns its path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = out.with_name(f"{tag}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    log = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}"
            )
        log.append(err)
    tmp = out.with_name(f"{tag}.so.tmp")
    cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o",
           str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    for obj in objs:
        obj.unlink()
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


#: Every C entry of the library: (pointer arguments, int arguments); each
#: also takes the stream last.  ``load`` declares them for ctypes, which
#: would otherwise pass every argument as a 32-bit int.
ENTRIES = {
    "astarpa_banded_cost": (10, 4),
    "astarpa_banded_ck": (13, 5),
    "astarpa_banded_cost_pp": (10, 5),
    "astarpa_banded_ck_pp": (13, 6),
    "astarpa_banded_fill": (12, 4),
    "astarpa_banded_fill_pp": (12, 5),
    "astarpa_striped_cost": (10, 8),
    "astarpa_striped_ck": (14, 10),
    "astarpa_pinned_cost": (8, 7),
    "astarpa_pinned_ck": (14, 10),
    "astarpa_pinned_cost_pp": (11, 8),
    "astarpa_pinned_ck_pp": (15, 10),
    "astarpa_ring_ck": (12, 9),
    "astarpa_ring_cost_pp": (8, 6),
    "astarpa_ring_cost_wide": (8, 8),
    "astarpa_ring_ck_pp": (12, 8),
    "astarpa_banded_ring": (8, 7),
    "astarpa_banded_ring_pp": (8, 6),
    "astarpa_banded_ring_ck_pp": (12, 8),
    "astarpa_banded_ring_fill": (11, 7),
    "astarpa_ring_ck_exact": (12, 8),
    "astarpa_banded_ring_ck": (12, 8),
    "astarpa_nw_right_edge": (8, 2),
}

_lib = None


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry's
    argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, (n_ptr, n_int) in ENTRIES.items():
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
        _lib = lib
    return _lib
