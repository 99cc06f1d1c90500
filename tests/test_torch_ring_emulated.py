"""The ring kernels of ``csrc/pinned.cu`` run on the CPU: the CUDA source is
compiled by the host C++ compiler against ``tests/cuda_emu/cuda_runtime.h``
(each block runs as ``blockDim.x`` threads, a warp's shuffles and
reductions as exchanges between barriers of its threads), loaded with
ctypes in place of the card's library, and driven through the wrappers'
own launch functions on CPU tensors.  Their results are held bit for bit
against the plain versions: K4's rings (``banded_ring_pp_kernel``,
``banded_ring_ck_pp_kernel``) on per-pair schedules shifting at column 0
and sliding past the last word, with pairs far shorter than n_max, at the
runner's layout and as a 64-thread block ring; K3's ring
(``banded_ring_fill_kernel``) storing pair-major planes; K1's and K3's
rings, and the cost rings (K7, the wide ring, whose wrapper runs the band
one word down), on a shared schedule shifted at column 0; ring K8
(``ring_ck_exact_kernel``) and K2's ring (``banded_ring_ck_kernel``) on
costs, every checkpoint row and top value (SW off the 8-grain, full
heights, pairs far shorter than n_max, n == 0, a single capture window
below SW, a shift at column 0, sub-warp, one-warp and two-warp rings).
This models what the
kernels compute, not the card: ``test_torch_cuda.py`` holds them on the
card.  Skips without a C++ compiler."""

import contextlib
import ctypes
import hashlib
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from astarpa_tpu_torch import generate
from astarpa_tpu_torch.ops import _build, banded, striped
from astarpa_tpu_torch.ops import banded_kernel as bk
from astarpa_tpu_torch.ops.pack import pack_batch_staggered

torch.set_num_threads(1)

_EMU = Path(__file__).resolve().parent / "cuda_emu"
_SRC = _build.CSRC / "pinned.cu"


def _host_source() -> str:
    """``csrc/pinned.cu`` with its launches (``k<<<grid, block, ...>>>(``)
    as calls of ``emu_launch`` and its shared memory as statics."""
    s = _SRC.read_text()
    s = re.sub(r"(\w+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), [^>]*>>>\(",
               r"emu_launch(\2, \3, \1, ", s)
    s = s.replace("extern __shared__ uint2 s_dyn[];", "uint2* s_dyn = emu::dynamic_shared;")
    s = s.replace("__shared__ ", "static ")
    return '#include "cuda_runtime.h"\n' + s


@pytest.fixture(scope="module")
def emulated():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    src = _host_source()
    h = hashlib.sha256((src + (_EMU / "cuda_runtime.h").read_text()).encode()).hexdigest()[:16]
    out_dir = _build.BUILD_DIR.parent / "emu"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libpinned_emu_{h}.so"
    if not lib_path.exists():
        cpp = out_dir / f"pinned_emu_{h}.cpp"
        cpp.write_text(src)
        tmp = lib_path.with_suffix(".tmp")
        subprocess.run([cxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
                        "-Wno-unknown-pragmas", f"-I{_EMU}", str(cpp), "-o", str(tmp)],
                       check=True, capture_output=True)
        tmp.replace(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (n_ptr, n_int) in _build.ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    return lib


@pytest.fixture
def on_cpu(emulated, monkeypatch):
    """The wrappers' launch functions on CPU tensors, into the emulated
    library."""
    monkeypatch.setattr(_build, "load", lambda: emulated)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=None))


def _pack():
    """17 pairs of up to 300 bp (most far shorter than n_max) beside b of up
    to 900 bp, n == 0, row m above and below the window."""
    rng = np.random.default_rng(1)

    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [generate.uniform_seeded(int(rng.integers(1, 300)), 0.15, 600 + s)
             for s in range(10)]
    pairs += [(seq(int(rng.integers(1, 200))), seq(int(rng.integers(200, 900))))
              for _ in range(4)]
    pairs += [(b"", seq(90)), (b"ACG", seq(700)), (seq(290), b"ACGTAC")]
    return pack_batch_staggered(pairs, 1, device="cpu")[0]


def _same(got, want, label):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w), label


@pytest.mark.parametrize("sw,q,lanes", [(5, 1, None), (16, 8, None), (16, 8, 64)])
def test_k4_rings_match_plain(on_cpu, sw, q, lanes):
    """K4's cost and checkpoint rings equal K4's plain versions on costs,
    every checkpoint row and top value (checkpoints past a pair's end
    included)."""
    args = _pack()
    n_max, B = args[0].shape
    rng = np.random.default_rng(sw + q)
    sched = np.zeros((n_max, B), np.uint8)
    rows = np.arange(0, n_max, q)
    sched[rows] = rng.random((len(rows), B)) < 0.03 * q
    sched[0, ::3] = 1
    sched[rows, ::5] = 1
    before = dict(bk.LAUNCHES)
    _same(bk._launch_banded_ring_pp(*args, sched, sw, q, lanes=lanes),
          banded.banded_cost_pp_ref(*args, sched, sw, q), "cost")
    _same(bk._launch_banded_ring_pp(*args, sched, sw, q, 24, lanes=lanes),
          banded.banded_ck_pp_ref(*args, sched, sw, 24, q), "ck")
    assert bk.LAUNCHES["banded_ring_pp"] == before["banded_ring_pp"] + 1
    assert bk.LAUNCHES["banded_ring_ck_pp"] == before["banded_ring_ck_pp"] + 1


@pytest.mark.parametrize("sw,lanes", [(5, None), (16, 64)])
def test_fill_ring_matches_plain(on_cpu, sw, lanes):
    """K3's ring equals K3's plain version on costs and both planes on
    every row, stored pair-major (a pair's planes contiguous)."""
    args = _pack()
    n_max, S = args[0].shape[0], args[2].shape[0]
    diag = (n_max, S * 32 - 50)
    got = bk._launch_banded_ring_fill(*args, sw, diag, lanes)
    assert got[1].permute(2, 0, 1).is_contiguous()
    _same(got, banded.banded_fill_ref(*args, sw, diag), "fill")


def test_rings_take_a_shared_shift_at_column_0(on_cpu):
    """K1's and K3's rings on a shared schedule shifted at column 0: word 0
    leaves at once and slot 0 feeds the column codes to the band top below
    it."""
    args = _pack()
    n_max, S = args[0].shape[0], args[2].shape[0]
    col0 = (1, (8 * 32 // 2 + 32) * 2)
    assert banded.shift_at_array(n_max, S, 8, col0)[:2].tolist() == [1, 0]
    _same(bk._launch_banded_ring(*args, 8, col0), banded.banded_cost_ref(*args, 8, col0), "K1")
    _same(bk._launch_banded_ring_fill(*args, 8, col0),
          banded.banded_fill_ref(*args, 8, col0), "K3")


def test_cost_rings_refuse_a_shift_at_column_0(on_cpu, monkeypatch):
    """K7 and the wide ring take a shared schedule shifted at column 0 (on
    the card's route, ``pinned_cost`` and ``striped_cost`` through it):
    slot 0 feeds the column codes to the band top from the first step, as
    in K1's layout, and the costs equal their plain version's; the same
    pack on an unshifted schedule too."""
    monkeypatch.setattr(bk, "_plain", lambda a0: False)  # the card's route
    args = _pack()
    n_max, S = args[0].shape[0], args[2].shape[0]
    col0 = (1, (8 * 32 // 2 + 32) * 2)
    assert banded.shift_at_array(n_max, S, 8, col0)[:2].tolist() == [1, 0]
    before = dict(bk.LAUNCHES)
    want = striped.pinned_cost_ref(*args, 8, col0)
    for label, call in (("K7", lambda: bk.pinned_cost(*args, 8, col0)),
                        ("wide", lambda: bk.pinned_cost(*args, 8, col0, None, 16)),
                        ("striped_cost", lambda: bk.striped_cost(*args, 8, col0))):
        _same(call(), want, label)
    assert bk.LAUNCHES["pinned_cost"] == before["pinned_cost"] + 2
    assert bk.LAUNCHES["ring_cost_wide"] == before["ring_cost_wide"] + 1
    diag = (n_max, S * 32 - 50)
    assert banded.shift_at_array(n_max, S, 8, diag)[0] == 0
    _same(bk.pinned_cost(*args, 8, diag), striped.pinned_cost_ref(*args, 8, diag), "K7")
    assert bk.LAUNCHES["pinned_cost"] == before["pinned_cost"] + 3


def _tall_pack():
    """13 pairs of up to 400 bp, most far shorter than n_max, beside b of
    up to 2600 bp (S = 83 words, off the 8-grain), an n == 0 lane and an
    m == 0 lane."""
    rng = np.random.default_rng(5)

    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [generate.uniform_seeded(int(rng.integers(1, 400)), 0.1, 700 + s)
             for s in range(8)]
    pairs += [(seq(int(rng.integers(100, 400))), seq(int(rng.integers(400, 2600))))
              for _ in range(3)]
    pairs += [(b"", seq(300)), (seq(120), b""), (seq(400), seq(2650))]
    args = pack_batch_staggered(pairs, 1, device="cpu")[0]
    assert args[2].shape[0] % 8 and args[2].shape[0] > 67
    return args


def _skewed_pack():
    """A skewed bucket: a of at most 40 bp against b of up to 3000 bp, so a
    full height S = 94 > n_max."""
    pairs = [(generate.uniform_seeded(40 - 7 * s, 0.1, 800 + s)[0],
              generate.uniform_seeded(3000 - 450 * s, 0.1, 810 + s)[0]) for s in range(5)]
    return pack_batch_staggered(pairs, 1, device="cpu")[0]


_COL0 = (1, (8 * 32 // 2 + 32) * 2)  # a diagonal whose only shift is at column 0

#: Ring K8's cases: (pack, SW, CB, diag, ring_words); "S" is the full
#: height, ring_words 512 a two-warp ring.
K8_CASES = [("small", 13, 13, None, None), ("small", 8, 24, _COL0, None),
            ("small", "S", 40, None, 512), ("tall", 67, 70, "diag", None),
            ("tall", "S", 100, None, None), ("tall", 13, 4096, "diag", 512),
            ("skewed", "S", 4096, None, None)]


@pytest.mark.parametrize("pack,sw,cb,diag,ring_words", K8_CASES)
def test_ring_k8_matches_plain(on_cpu, pack, sw, cb, diag, ring_words):
    """Ring K8 (``ring_ck_exact_kernel``) equals K8's plain version bit for
    bit on costs, every checkpoint row (past each pair's end too) and top
    value: SW 8, 13, 67 and full heights of 22 and 83 words off the
    8-grain, CB = SW and larger, with and without a diagonal, a shift at
    column 0, a skewed bucket's single capture window (CB = n_max < SW),
    one- and two-warp rings; through ``pinned_ck``'s launch."""
    args = {"small": _pack, "tall": _tall_pack, "skewed": _skewed_pack}[pack]()
    n_max, S = args[0].shape[0], args[2].shape[0]
    sw = S if sw == "S" else sw
    diag = (n_max, S * 32 - 70) if diag == "diag" else diag
    if diag == _COL0:
        assert banded.shift_at_array(n_max, S, sw, diag)[:2].tolist() == [1, 0]
    if pack == "skewed":
        assert min(cb, n_max) < sw and n_max // min(cb, n_max) + 1 == 2
    before = bk.LAUNCHES["ring_ck_exact"]
    got = bk._launch_ring_ck_exact(*args, sw, cb, diag, ring_words)
    _same(got, striped.pinned_ck_ref(*args, sw, cb, diag), (pack, sw, cb))
    assert bk.LAUNCHES["ring_ck_exact"] == before + 1


#: K2's ring cases: (pack, SW, CB, diag, lanes); lanes 64 a two-warp ring.
K2_CASES = [("small", 5, 24, None, None), ("small", 13, 13, "diag", None),
            ("small", 16, 24, None, 64), ("small", "S", 64, None, None),
            ("small", 8, 24, _COL0, None), ("tall", 67, 70, "diag", None),
            ("small", 16, 15, None, None), ("skewed", "S", 4096, None, None)]


@pytest.mark.parametrize("pack,sw,cb,diag,lanes", K2_CASES)
def test_ring_k2_matches_plain(on_cpu, pack, sw, cb, diag, lanes):
    """K2's ring (``banded_ring_ck_kernel``) equals K2's plain version bit
    for bit on costs (K1's rule at n == 0), every checkpoint row and top
    value, past each pair's end too: sub-warp rings (1-16 lanes a pair,
    several pairs a warp) and a two-warp ring, SW 5, 13, 67 and a full
    height of 22 words, CB = SW and larger, one capture window below SW
    (CB = 15 < SW = 16 on the pack cut to 30 columns), a skewed bucket's single
    checkpoint (CB = n_max), a shift at column 0; through ``banded_ck``'s
    launch."""
    args = {"small": _pack, "tall": _tall_pack, "skewed": _skewed_pack}[pack]()
    n_max, S = args[0].shape[0], args[2].shape[0]
    sw = S if sw == "S" else sw
    diag = (n_max, S * 32 - 70) if diag == "diag" else diag
    if cb < sw:  # the pack cut to 30 columns: one capture window
        n_max = 30
        args = tuple(x[:n_max].contiguous() for x in args[:2]) + args[2:4] + (
            np.minimum(args[4], n_max), args[5])
        assert -(-n_max // cb) == 2
    assert bk.k2_kernel(n_max, min(sw, S), cb) == "banded_ring_ck"
    before = bk.LAUNCHES["banded_ring_ck"]
    got = bk._launch_banded_ring_ck(*args, sw, cb, diag, lanes)
    _same(got, banded.banded_ck_ref(*args, sw, cb, diag), (pack, sw, cb))
    assert bk.LAUNCHES["banded_ring_ck"] == before + 1
