"""Time the shared cost ring's step on the card against variants of it.

    python -m astarpa_tpu_torch.ops.ring_step [--n 500000] [--sw 2048]

Writes variants of ``csrc/pinned.cu`` into ``build/ring_step/`` (each with
one entry, ``astarpa_ring_variant``, taking ``astarpa_pinned_cost``'s
arguments), builds each with ``nvcc`` as :mod:`._build` does, and times
them in turns (CUDA events over chained launches) on config #5's rung
geometry with random data: B = 128 pairs of n = 500 000 columns and m =
503 744 rows (S = 15 742 words), band ``--sw``.  The variants:

- ``pinned_ring``: K7 as ``pinned_ring_kernel<false, false>`` runs it (the
  previous design of K7, still in the file for ring K6 and ring K9);
- ``pinned_ring_noevent``: without its enter, absorb, top and capture code;
- ``pinned_ring_nomove``: also without passing the char masks down the
  slots (every slot reads slot 0's);
- ``pinned_ring_floor``: also without the link and the barrier (each
  thread alone);
- ``ring_cost``: K7 as ``ring_cost_kernel<0>`` runs it (its word step
  split across the ALU and FMA pipes, ``word_step_split``);
- ``ring_cost_notop``: without the band top's inputs;
- ``ring_cost_nohandler``: without any event code;
- ``ring_cost_nohandler_nobar``: also without the cross-warp link and
  the barrier;
- ``ring_cost_alu``, ``ring_cost_alu_nohandler``,
  ``ring_cost_alu_nohandler_nobar``: the same three with the word step on
  the ALU pipe alone (``word_step``, K7's step before the split);
- ``ring_cost_full``, ``ring_cost_full_nohandler_nobar``: the whole step
  and its floor with the full split (both carry bits as ``IMAD.HI``, both
  shifts as multiply-adds: 10 ALU-pipe instructions a word step).

All but the whole kernels (:data:`WHOLE`) compute wrong costs: they are
for time only (their state is folded into the output so the compiler keeps
the word steps).  Each line gives a variant's SASS step split
(:func:`.sass_count.step_split`) and its time a step; the whole kernels
are checked against K5's stripes on the same inputs, and ``near_full`` is
the share of steps whose live words leave less than one thread's 8 slots
of the ring free.  Needs a GPU and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from . import _build, banded_kernel, sass_count, striped
from .words import to_tensor

OUT_DIR = _build.BUILD_DIR.parent / "ring_step"
#: The variants that compute K7's costs, checked against K5's stripes.
WHOLE = ("pinned_ring", "ring_cost", "ring_cost_alu", "ring_cost_full")

_OLD_LOOP = "  for (int t = 0; t < t_end; ++t) {"
_OLD_END = "  if (cap) atomicAdd(&s_cap, cap);"
_LINK_IN = """    uint32_t up;
    if (solo) {
      up = __shfl_sync(kFull, last_aux, (lane + 31) & 31);
    } else {
      up = __shfl_up_sync(kFull, last_aux, 1);
      if (lane == 0) up = s_aux[(t - 1) & 1][warp > 0 ? warp - 1 : last_warp];
    }
"""
_UNPACK = """    uint32_t in_a0 = 0u - (up & 1u);
    uint32_t in_a1 = 0u - ((up >> 1) & 1u);
    uint32_t in_hp = (up >> 2) & 1u;
    uint32_t in_hm = (up >> 3) & 1u;
"""
_SLOTS = """#pragma unroll
    for (int j = kK - 1; j >= 0; --j) {
      const uint32_t a0 = %s;
      const uint32_t a1 = %s;
      const uint32_t hp = j ? xhp[j - 1] : in_hp;
      const uint32_t hm = j ? xhm[j - 1] : in_hm;
      const uint32_t eq = (a0 ^ p0[j]) & (a1 ^ p1[j]);
      const uint32_t v = vp[j];
      const uint32_t vx = eq | vm[j];
      const uint32_t eq2 = eq | hm;
      const uint32_t hx = (((eq2 & v) + v) ^ v) | eq2;
      uint32_t hpo = vm[j] | ~(hx | v);
      uint32_t hmo = v & hx;
      xhp[j] = hpo >> (kW - 1);
      xhm[j] = hmo >> (kW - 1);
      hpo = (hpo << 1) | hp;
      hmo = (hmo << 1) | hm;
      vp[j] = hmo | ~(vx | hpo);
      vm[j] = hpo & vx;
      %s
    }
"""
_LINK_OUT = """    last_aux = pack_aux(%s, %s, xhp[kK - 1], xhm[kK - 1]);
    if (!solo && lane == 31) s_aux[t & 1][warp] = last_aux;
"""
_SYNC = "    if (solo) { __syncwarp(); } else { __syncthreads(); }\n"
_OLD_KEEP = """#pragma unroll
  for (int j = 0; j < kK; ++j) cap += __popc(vp[j]) - __popc(vm[j]) + (int)(xa0[j] & 1) + (int)xhp[j];
"""
_NEW_CHECK = ("      if (tt >= ev_next) {\n"
              "        if (kMode == kRingCk && tt - 1 == ck_next && tt < ev_rest) {")
_NEW_TOP = "          const bool top = tt >= top_next && tt < abs_next && tt - abs_w < n_lim;"
_NEW_MULTI = "  const bool multi = NT > 32;  // a one-warp ring wraps by shuffle alone"
_NEW_TAIL = "  // The capture of the last computed step, if due."
_NEW_SPLIT = "  constexpr bool kSplit = kMode == kRingCost;"
_CM = "  const uint32_t cm = hm_up >> (kW - 1);\n"
_HPS = "  const uint32_t hps = __funnelshift_l(hp_up, hpo, 1);\n"
_FULL = {_CM: "  const uint32_t cm = __umulhi(hm_up, two);\n",
         _HPS: "  const uint32_t cp = __umulhi(hp_up, two);\n"
               "  const uint32_t hps = hpo * two + cp;\n"}
_NEW_KEEP = ("#pragma unroll\n  for (int j = 0; j < kK; ++j) acc += __popc(vp[j]) - __popc(vm[j])"
             " + (int)(A0[j] & 1) + (int)(xhp[j] >> 31);\n")
_ENTRY = """
extern "C" int astarpa_ring_variant(const void* code, const void* pb0, const void* pb1,
                                    const void* n, const void* m, const void* loend,
                                    const void* ev, void* out, int n_max, int B, int S,
                                    int SW, int nw_pad, int n_lim, int threads, void* stream) {
  return %s;
}
"""
_OLD_CALL = ("launch<false, false>(code, pb0, pb1, n, m, loend, ev, out, nullptr, nullptr, "
             "nullptr, nullptr, n_max, B, S, SW, nw_pad, n_lim, threads, 1, 0, stream)")
_NEW_CALL = ("launch_cost<0>(code, pb0, pb1, n, m, loend, ev, out, n_max, B, S, SW, nw_pad, "
             "n_lim, threads, stream)")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"csrc/pinned.cu no longer holds {old[:60]!r}")
    return text.replace(old, new)


def _old_loop(src: str, body: str) -> str:
    """``src`` with pinned_ring_kernel's step loop replaced by ``body``."""
    head, rest = src.split(_OLD_LOOP, 1)
    _, tail = rest.split(_OLD_END, 1)
    return head + _OLD_LOOP + "\n" + body + "  }\n" + _OLD_KEEP + _OLD_END + tail


def variants(src: str) -> dict[str, str]:
    """The variant sources of :data:`__doc__`, from ``csrc/pinned.cu``'s
    text, each with the entry ``astarpa_ring_variant`` appended."""
    slots = _SLOTS % ("j ? xa0[j - 1] : in_a0", "j ? xa1[j - 1] : in_a1",
                      "xa0[j] = a0; xa1[j] = a1;")
    slots_nomove = _SLOTS % ("in_a0", "in_a1", "")
    old = {
        "pinned_ring": src,
        "pinned_ring_noevent": _old_loop(src, _LINK_IN + _UNPACK + slots + _LINK_OUT % (
            "xa0[kK - 1]", "xa1[kK - 1]") + _SYNC),
        "pinned_ring_nomove": _old_loop(src, _LINK_IN + _UNPACK + slots_nomove + _LINK_OUT % (
            "in_a0", "in_a1") + _SYNC),
        "pinned_ring_floor": _old_loop(src, "    uint32_t up = last_aux;\n" + _UNPACK
                                       + slots_nomove + "    last_aux = pack_aux(in_a0, in_a1, "
                                       "xhp[kK - 1], xhm[kK - 1]);\n"),
    }
    nohandler = _sub(_sub(src, _NEW_CHECK, _NEW_CHECK.replace("(tt >= ev_next)", "(false)")),
                     _NEW_TAIL, _NEW_KEEP + _NEW_TAIL)
    new = {
        "ring_cost": src,
        "ring_cost_notop": _sub(src, _NEW_TOP, _NEW_TOP.replace(
            "tt >= top_next && tt < abs_next && tt - abs_w < n_lim", "false")),
        "ring_cost_nohandler": nohandler,
        "ring_cost_nohandler_nobar": _sub(nohandler, _NEW_MULTI, "  const bool multi = false;"),
    }
    for name in ("ring_cost", "ring_cost_nohandler", "ring_cost_nohandler_nobar"):
        new[name.replace("ring_cost", "ring_cost_alu")] = _sub(
            new[name], _NEW_SPLIT, "  constexpr bool kSplit = false;")
    for name in ("ring_cost", "ring_cost_nohandler_nobar"):
        head, step = new[name].split("void word_step_split(", 1)
        for old_line, new_lines in _FULL.items():
            step = _sub(step, old_line, new_lines)
        new[name.replace("ring_cost", "ring_cost_full")] = head + "void word_step_split(" + step
    return {**{k: v + _ENTRY % _OLD_CALL for k, v in old.items()},
            **{k: v + _ENTRY % _NEW_CALL for k, v in new.items()}}


def _build_variant(name: str, text: str):
    cu = OUT_DIR / f"{name}.cu"
    cu.write_text(text)
    so = OUT_DIR / f"{name}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    return so, proc.stderr


def _split(so: Path, name: str, log: str) -> dict:
    """The timed K7 instance's ptxas resources and SASS step split."""
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    key, steps = (("ring_cost_kernelILi0E", 8) if name.startswith("ring_cost")
                  else ("pinned_ring_kernelILb0ELb0E", 1))
    lines = next(v for k, v in sass_count.functions(sass).items() if key in k)
    split = sass_count.step_split(lines, steps, 8)
    split.pop("opcodes")
    log_lines = log.splitlines()
    at = next(i for i, ln in enumerate(log_lines) if "Compiling entry" in ln and key in ln)
    ptxas = " ".join(ln.split("info    :")[-1].strip() for ln in log_lines[at + 1:at + 4])
    return {"ptxas": ptxas, **split}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=500_000, help="columns of every pair")
    ap.add_argument("--sw", type=int, default=2048, help="band words")
    ap.add_argument("--launches", type=int, default=2, help="chained launches a turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ring_step needs a CUDA device")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    texts = variants((_build.CSRC / "pinned.cu").read_text())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(texts)) as ex:
        built = dict(zip(texts, ex.map(lambda kv: _build_variant(*kv), texts.items())))
    print(f"[build] {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    B, n, m = 128, args.n, args.n + 3744
    n_max = -(-n // 2048) * 2048
    S, sw = -(-m // 32), args.sw
    g = torch.Generator(device="cuda").manual_seed(5)
    code = torch.randint(0, 4, (n_max, B), dtype=torch.int32, device="cuda", generator=g)
    pb0, pb1 = (torch.randint(-2**31, 2**31 - 1, (S, B), dtype=torch.int32, device="cuda",
                              generator=g) for _ in range(2))
    nn, mm = np.full(B, n, np.int64), np.full(B, m, np.int64)
    planes = (code & 1, code & 2, pb0, pb1, nn, mm)
    diag = (n_max, m)
    plan = striped.plan_striped(n_max, S, sw, diag)
    span = striped.ring_span(plan, n)
    threads = banded_kernel.ring_threads(span)
    ev = to_tensor(banded_kernel.ring_events(plan, threads * 8), "cuda")
    codes = torch.zeros(B * n_max + banded_kernel.CODE_PAD, dtype=torch.uint8, device="cuda")
    codes[:B * n_max].view(B, n_max).copy_(code.T)
    n_t, m_t = to_tensor(nn.astype(np.int32), "cuda"), to_tensor(mm.astype(np.int32), "cuda")
    loend = to_tensor(striped.loend_of(plan["lo"], nn), "cuda")
    steps = int(n + int(loend[0]) + sw - 1)
    # Live words at every step (each word from its entry to its end): the
    # share of steps whose live run leaves less than a thread's 8 slots of
    # the ring free, where a thread can hold two laps' words.
    ab = plan["abs_t"].astype(np.int64)
    end = np.minimum(np.where(ab < striped.NEVER, ab + 1, striped.NEVER),
                     n + np.arange(len(ab)))
    live = np.zeros(steps + 1, np.int64)
    np.add.at(live, np.minimum(plan["ent_t"].astype(np.int64), steps), 1)
    np.add.at(live, np.minimum(end, steps), -1)
    near_full = float((np.cumsum(live)[:steps] > threads * 8 - 8).mean())
    fns = {}
    for name, (so, _) in built.items():
        fn = ctypes.CDLL(str(so)).astarpa_ring_variant
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fns[name] = fn

    def launch(name):
        out = torch.empty(B, dtype=torch.int32, device="cuda")
        rc = fns[name](codes.data_ptr(), pb0.data_ptr(), pb1.data_ptr(), n_t.data_ptr(),
                       m_t.data_ptr(), loend.data_ptr(), ev.data_ptr(), out.data_ptr(), n_max, B,
                       S, sw, ev.shape[1], n, threads, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        return out

    want = banded_kernel.striped_cost(*planes, sw, diag, 8 * banded_kernel.striped_threads(sw))
    for name in WHOLE:
        if not torch.equal(launch(name), want):
            raise SystemExit(f"{name} != K5's stripes")
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        launch(name)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.launches):
            launch(name)
        b.record()
        b.synchronize()
        times[name].append(a.elapsed_time(b) / args.launches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"shape": {"B": B, "n_max": n_max, "S": S, "SW": sw, "ring": threads * 8,
                                "span": span, "steps": steps, "near_full": near_full},
                      "card": smi,
                      "checked": f"{', '.join(WHOLE)} == K5's stripes"}), flush=True)
    for name, ts in times.items():
        print(json.dumps({"variant": name, "ms": ts, "ns_a_step": min(ts) / steps * 1e6,
                          **_split(built[name][0], name, built[name][1])}), flush=True)


if __name__ == "__main__":
    main()
