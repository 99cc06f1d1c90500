"""The cost rings' split word step (``csrc/pinned.cu``'s ``word_step_split``)
against ``word_step``: the same outputs bit for bit.

The split step moves part of the Myers word step to multiply-adds: the add
as ``x * 1 + v`` and the h- word's funnel shift as ``x * 2 + c`` for ``(x <<
1) | c`` with ``c`` in {0, 1}.  The full split, measured slower on the card
and not built, also takes the carry bits as ``hi(x * 2)`` for ``x >> 31`` and
the h+ word's shift as a multiply-add.  A numpy model of each, in uint64
with the products' low and high words, must agree with ``word_step``'s
formulas over random inputs whose carry words' top bits take every pair of
values; then both functions, compiled from the source by the host C++
compiler against ``tests/cuda_emu/cuda_runtime.h``, must agree the same
way.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from astarpa_tpu_torch.ops import _build

N = 1 << 17
M32 = np.uint64(0xFFFFFFFF)


def _inputs(seed: int) -> dict[str, np.ndarray]:
    """Random uint32 inputs; the carry words' top bits take every pair of
    values, a quarter of the tuples each."""
    rng = np.random.default_rng(seed)
    x = {k: rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
         for k in ("a0", "a1", "p0", "p1", "hp_up", "hm_up", "vp", "vm")}
    # The char masks are all-ones or zero in the rings; half the tuples so.
    for k in ("a0", "a1"):
        x[k][: N // 2] = np.where(x[k][: N // 2] & 1, np.uint32(0xFFFFFFFF), np.uint32(0))
    top = np.arange(N) % 4
    for k, bit in (("hp_up", 1), ("hm_up", 2)):
        x[k] = np.where(top & bit, x[k] | np.uint32(1 << 31), x[k] & np.uint32(0x7FFFFFFF))
    return x


def word_step(a0, a1, p0, p1, hp_up, hm_up, vp, vm):
    """``word_step``: shifts and the add on uint32."""
    eq = (a0 ^ p0) & (a1 ^ p1)
    v = vp
    vx = eq | vm
    eq2 = eq | (hm_up >> np.uint32(31))
    hx = (((eq2 & v) + v) ^ v) | eq2
    hpo = vm | ~(hx | v)
    hmo = v & hx
    hps = (hpo << np.uint32(1)) | (hp_up >> np.uint32(31))
    hms = (hmo << np.uint32(1)) | (hm_up >> np.uint32(31))
    return hms | ~(vx | hps), hps & vx, hpo, hmo


def _lo(x):
    return (x & M32).astype(np.uint32)


def _hi(x, y):
    return ((x.astype(np.uint64) * y) >> np.uint64(32)).astype(np.uint32)


def _mad(x, y, z):
    return _lo(x.astype(np.uint64) * y + z.astype(np.uint64))


def word_step_split(a0, a1, p0, p1, hp_up, hm_up, vp, vm, one=1, two=2):
    """``word_step_split``: the add and the h- word's shift as 64-bit
    multiply-adds, low words."""
    one, two = np.uint64(one), np.uint64(two)
    eq = (a0 ^ p0) & (a1 ^ p1)
    v = vp
    vx = eq | vm
    cm = hm_up >> np.uint32(31)
    eq2 = eq | cm
    hx = (_mad(eq2 & v, one, v) ^ v) | eq2
    hpo = vm | ~(hx | v)
    hmo = v & hx
    hps = (hpo << np.uint32(1)) | (hp_up >> np.uint32(31))
    hms = _mad(hmo, two, cm)
    return hms | ~(vx | hps), hps & vx, hpo, hmo


def word_step_full_split(a0, a1, p0, p1, hp_up, hm_up, vp, vm, one=1, two=2):
    """The full split: also the carry bits as the products' high words and
    the h+ word's shift as a multiply-add."""
    one, two = np.uint64(one), np.uint64(two)
    eq = (a0 ^ p0) & (a1 ^ p1)
    v = vp
    vx = eq | vm
    cm = _hi(hm_up, two)
    cp = _hi(hp_up, two)
    eq2 = eq | cm
    hx = (_mad(eq2 & v, one, v) ^ v) | eq2
    hpo = vm | ~(hx | v)
    hmo = v & hx
    hps = _mad(hpo, two, cp)
    hms = _mad(hmo, two, cm)
    return hms | ~(vx | hps), hps & vx, hpo, hmo


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("model", [word_step_split, word_step_full_split])
def test_split_step_model_equals_word_step(seed, model):
    x = _inputs(seed)
    want = word_step(**x)
    got = model(**x)
    for name, w, g in zip(("vp", "vm", "hp_out", "hm_out"), want, got):
        assert w.dtype == g.dtype == np.uint32, name
        assert np.array_equal(w, g), name
    # Every pair of carry top bits was drawn, and each carry changed an output.
    tops = (x["hp_up"] >> np.uint32(31)) * 2 + (x["hm_up"] >> np.uint32(31))
    assert set(np.unique(tops).tolist()) == {0, 1, 2, 3}
    flipped = word_step(**{**x, "hp_up": x["hp_up"] ^ np.uint32(1 << 31)})
    assert not np.array_equal(flipped[0], want[0])


def test_split_step_identities():
    """The three identities the split rests on, over every top bit and low
    bit of x."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    x64 = x.astype(np.uint64)
    assert np.array_equal(((x64 * np.uint64(2)) >> np.uint64(32)).astype(np.uint32),
                          x >> np.uint32(31))
    for c in (0, 1):
        got = ((x64 * np.uint64(2) + np.uint64(c)) & M32).astype(np.uint32)
        assert np.array_equal(got, (x << np.uint32(1)) | np.uint32(c)), c
    y = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(((x64 * np.uint64(1) + y.astype(np.uint64)) & M32).astype(np.uint32),
                          x + y)


def _function(src: str, name: str) -> str:
    """The text of ``__device__ ... name(...) {...}`` in ``src``."""
    m = re.search(r"__device__ __forceinline__ void " + name + r"\(", src)
    assert m, name
    end = src.index("\n}\n", m.start()) + 3
    return src[m.start():end]


_HARNESS = """
#include <cstdint>
#include "cuda_runtime.h"
constexpr int kW = 32;
%s
%s
extern "C" void run(const uint32_t* in, uint32_t* out, int n, uint32_t one, uint32_t two) {
  for (int i = 0; i < n; ++i) {
    const uint32_t* x = in + 8 * i;
    uint32_t* y = out + 8 * i;
    y[0] = x[6];
    y[1] = x[7];
    word_step(x[0], x[1], x[2], x[3], x[4], x[5], y[0], y[1], y[2], y[3]);
    y[4] = x[6];
    y[5] = x[7];
    word_step_split(x[0], x[1], x[2], x[3], x[4], x[5], one, two, y[4], y[5], y[6], y[7]);
  }
}
"""


def test_compiled_split_step_equals_word_step(tmp_path):
    """Both functions as ``csrc/pinned.cu`` writes them, compiled for the
    host, over the same random inputs: equal outputs, and equal to the
    numpy model."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the word steps")
    src = (_build.CSRC / "pinned.cu").read_text()
    cpp = tmp_path / "steps.cpp"
    cpp.write_text(_HARNESS % (_function(src, "word_step"), _function(src, "word_step_split")))
    lib = tmp_path / "steps.so"
    emu = Path(__file__).resolve().parent / "cuda_emu"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(emu), "-o", str(lib),
                    str(cpp)], check=True, capture_output=True)
    x = _inputs(3)
    keys = ("a0", "a1", "p0", "p1", "hp_up", "hm_up", "vp", "vm")
    packed = np.ascontiguousarray(np.stack([x[k] for k in keys], 1))
    out = np.zeros_like(packed)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                    ctypes.c_uint32]
    run(packed.ctypes.data, out.ctypes.data, N, 1, 2)
    assert np.array_equal(out[:, :4], out[:, 4:])
    model = np.stack(word_step(**x), 1)
    assert np.array_equal(out[:, :4], model)
