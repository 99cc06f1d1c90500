#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases, one output line each (any failure exits non-zero):

0. card and tools (nvidia-smi, torch, CUDA, nvcc, Triton);
1. build the CUDA kernel library and the native C++ runtime, timed;
2. the banded cost kernel against its plain torch version on a grid of
   shapes, bit for bit;
3. main path, cost: ``BatchAligner(device="cuda").cost_with_stats`` on
   4096 pairs of 10 kbp at e=5%, twice (the first warms the band hints),
   16 costs against the oracle, aligned Gbp/s of the second call and its
   time split by layer; a third call under ``torch.profiler`` gives the
   card's idle share;
4. main path, align: ``align_iter`` over 6 batches of 512 such pairs,
   every CIGAR verified, steady ms/pair from the mid-stream periods;
5. the kernel against the plain version on the main path's own packs (the
   4096-pair cost pack at SW=32, a 512-pair align pack at its ladder's
   SW, each with the main path's diagonal), bit for bit, and timed (CUDA
   events; turns plain, kernel, kernel, plain on 2 kbp pairs when the
   plain version would take over a minute at 10 kbp);

then the kernels' JSON line, and last ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.  Exits 1 without a usable GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import astarpa_tpu_torch as att  # noqa: E402
from astarpa_tpu_torch.ops import _build, banded, banded_kernel  # noqa: E402
from astarpa_tpu_torch.ops.pack import pack_batch_staggered  # noqa: E402
from astarpa_tpu_torch.parallel import runner  # noqa: E402
from astarpa_tpu_torch.parallel.runner import BatchAligner  # noqa: E402

PAIRS, LENGTH, ERR, SEED = 4096, 10_000, 0.05, 42
STREAM_BATCHES, STREAM_PAIRS = 6, 512
TIMED_SW = 32
PLAIN_LIMIT_S = 60.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def phase0_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_ver = triton.__version__
    except ImportError:
        triton_ver = "not installed"
    say(f"[0 tools] torch {torch.__version__} cuda {torch.version.cuda} "
        f"nvcc '{nvcc_ver}' triton {triton_ver} gpus {torch.cuda.device_count()}")
    return smi


def phase1_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    t1 = time.perf_counter()
    if not att.native.available():
        fail("native C++ runtime did not build")
    t2 = time.perf_counter()
    say(f"[1 build] cuda kernels {lib.name} {t1 - t0:.3f} s; "
        f"native runtime {t2 - t1:.3f} s")


def _random_pairs(rng, count, n_hi, m_hi):
    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [(seq(int(rng.integers(1, n_hi + 1))), seq(int(rng.integers(1, m_hi + 1))))
             for _ in range(count)]
    pairs[1] = (b"", seq(37))  # an n == 0 lane: cost m
    pairs[2] = (seq(n_hi), seq(m_hi))  # pins n_max and S
    return pairs


def phase2_grid() -> int:
    """Kernel == plain on B in {33, 1024}, n in [0, 600], every SW of the
    grid with and without a diagonal; returns the max abs difference."""
    rng = np.random.default_rng(7)
    pairs = _random_pairs(rng, 1024, 600, 2600)
    args, _ = pack_batch_staggered(pairs, 1, device="cuda")
    n_max, S = args[0].shape[0], args[2].shape[0]
    small = tuple(x[:, :33].contiguous() for x in args[:4]) + (args[4][:33], args[5][:33])
    worst, cases = 0, 0
    t0 = time.perf_counter()
    for sw in (1, 5, 32, 33, 64, 72, S):
        for diag in (None, (n_max, S * 32 - 50)):
            for planes in (small, args):
                got = banded_kernel.banded_cost(*planes, sw, diag)
                ref = banded.banded_cost_ref(*planes, sw, diag)
                torch.cuda.synchronize()
                diff = int((got.long() - ref.long()).abs().max())
                if diff:
                    fail(f"kernel != plain at B={planes[0].shape[1]} SW={sw} diag={diag}")
                worst, cases = max(worst, diff), cases + 1
    say(f"[2 kernel=plain] {cases}/{cases} cases equal (B 33/1024, n_max {n_max}, "
        f"S {S}, SW 1..{S}, diag None/set), max_abs_err {worst}, "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


class LayerSpy:
    """Times the runner's layers inside its own calls and keeps the last
    kernel launch per batch size.

    Wraps the runner module's pack, kernel launch and readback wait: the
    host clock around each, and CUDA events around each launch for the
    kernel's time on the card.  The launch count stays with the kernel's
    wrapper; this only passes calls through."""

    def __init__(self):
        self._orig = (runner.pack_batch_staggered, runner.banded_cost,
                      runner._Readback.numpy)
        self.last: dict[int, dict] = {}
        self.reset()

    def reset(self):
        self.pack_s = self.launch_s = self.wait_s = 0.0
        self.events = []

    def kernel_ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)

    def install(self):
        pack, launch, wait = self._orig

        def timed_pack(*args, **kw):
            t0 = time.perf_counter()
            out = pack(*args, **kw)
            self.pack_s += time.perf_counter() - t0
            return out

        def timed_launch(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            out = launch(*args)
            b.record()
            self.launch_s += time.perf_counter() - t0
            self.events.append((a, b))
            planes, sw, diag = args[:6], args[6], args[7]
            self.last[planes[0].shape[1]] = dict(args=planes, sw=sw, diag=diag)
            return out

        def timed_wait(readback):
            t0 = time.perf_counter()
            out = wait(readback)
            self.wait_s += time.perf_counter() - t0
            return out

        runner.pack_batch_staggered = timed_pack
        runner.banded_cost = timed_launch
        runner._Readback.numpy = timed_wait

    def remove(self):
        (runner.pack_batch_staggered, runner.banded_cost,
         runner._Readback.numpy) = self._orig


def phase3_cost(ba: BatchAligner, pairs, spy: LayerSpy) -> None:
    costs1, st1 = ba.cost_with_stats(pairs)
    torch.cuda.synchronize()
    spy.reset()
    t0 = time.perf_counter()
    costs2, st2 = ba.cost_with_stats(pairs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    split = (spy.pack_s, spy.launch_s, spy.wait_s, spy.kernel_ms(), len(spy.events))
    if st2.kernel != "cuda-banded":
        fail(f"stats.kernel is {st2.kernel!r}")
    if not (costs1 == costs2).all() or (costs2 < 0).any():
        fail("cost runs disagree or left a pair uncertified")
    picks = np.linspace(0, len(pairs) - 1, 16).astype(int)
    agree = sum(int(costs2[i]) == att.oracle.levenshtein(*pairs[i]) for i in picks)
    if agree != 16:
        fail(f"{agree}/16 costs equal the oracle")
    say(f"[3 cost] {len(pairs)} x {LENGTH} bp e={ERR}: {st2.aligned_bp / dt / 1e9:.4f} "
        f"Gbp/s aligned ({dt:.4f} s, 2nd call); oracle 16/16; retries "
        f"{st1.band_retries}->{st2.band_retries}, cells {st2.cells_computed}, "
        f"kernel {st2.kernel}")
    pack_s, launch_s, wait_s, k_ms, k_n = split
    say(f"[3 split] 2nd call, host clock: pack+upload+unpack {pack_s:.4f} s, "
        f"kernel launch {launch_s:.4f} s, readback wait {wait_s:.4f} s, "
        f"certify/ladder/other {dt - pack_s - launch_s - wait_s:.4f} s; "
        f"kernel on the card {k_ms:.3f} ms over {k_n} launches (CUDA events)")
    say(f"[3 trace] {_profiled_call(ba, pairs)}")


def _profiled_call(ba: BatchAligner, pairs) -> str:
    """One more cost call under torch.profiler: the share of its wall time
    in which the card ran nothing (union of kernel and copy intervals)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ba.cost_with_stats(pairs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return f"3rd call under torch.profiler: {wall:.4f} s; device idle share not measured (no device events)"
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy = (busy + cur_e - cur_s) / 1e6
    first, last = spans[0][0] / 1e6, max(e for _, e in spans) / 1e6
    k1 = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "banded_cost" in e.name) / 1e3
    return (f"3rd call under torch.profiler: wall {wall:.4f} s, card busy {busy:.4f} s "
            f"({len(spans)} device events, first to last {last - first:.4f} s), idle share "
            f"{1 - busy / wall:.3f}; banded_cost kernel {k1:.3f} ms in the trace")


def phase4_align(ba: BatchAligner, batches) -> float:
    marks = [time.perf_counter()]
    got = []
    for results, stats in ba.align_iter(iter(batches)):
        marks.append(time.perf_counter())
        got.append((results, stats))
    if len(got) != len(batches):
        fail("align_iter lost a batch")
    for pairs, (results, stats) in zip(batches, got):
        costs = ba.cost(pairs)
        for (a, b), (c, cig), want in zip(pairs, results, costs):
            if c != want or cig.verify(a, b) != c:
                fail("align_iter cost or CIGAR wrong")
    periods = np.diff(marks)[1:-2]  # [0] is the fill, [-2:] the drain
    ms_pair = float(np.median(periods)) / STREAM_PAIRS * 1e3
    say(f"[4 align] align_iter {len(batches)} x {STREAM_PAIRS} pairs: "
        f"{sum(len(p) for p in batches)} CIGARs verified, costs == cost(); steady "
        f"{ms_pair:.5f} ms/pair (median of periods "
        f"{', '.join(f'{p:.4f}' for p in periods)} s); direct traces "
        f"{sum(s.direct_traces for _, s in got)}")
    return ms_pair


def _event_ms(fn):
    """(device ms between events around ``fn()``, its result)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _check_equal(planes, sw, diag, label: str) -> tuple[int, float, list[float]]:
    """Kernel == plain on one pack; returns (max_abs_err, plain ms, kernel
    ms of two runs), all CUDA events."""
    plain_ms, ref = _event_ms(lambda: banded.banded_cost_ref(*planes, sw, diag))
    kernel = [_event_ms(lambda: banded_kernel.banded_cost(*planes, sw, diag)) for _ in range(2)]
    err = max(int((got.long() - ref.long()).abs().max()) for _, got in kernel)
    if err:
        fail(f"kernel != plain on {label}")
    return err, plain_ms, [ms for ms, _ in kernel]


def phase5_time(spy: LayerSpy) -> dict:
    """The kernel against plain on the main path's own packs, and timed.
    Returns the kernel's JSON record (without the launch count)."""
    if PAIRS not in spy.last or STREAM_PAIRS not in spy.last:
        fail(f"main path launched no {PAIRS}- or {STREAM_PAIRS}-pair batch")
    cost_l, align_l = spy.last[PAIRS], spy.last[STREAM_PAIRS]
    spy.last.clear()
    args10k = cost_l["args"]
    n_max10, S10 = args10k[0].shape[0], args10k[2].shape[0]
    err_c, plain10, k10 = _check_equal(args10k, TIMED_SW, cost_l["diag"], "the cost pack")
    a512 = align_l["args"]
    err_a, plain512, k512 = _check_equal(a512, align_l["sw"], align_l["diag"],
                                         "the align pack")
    say(f"[5 main shapes] kernel == plain: B={PAIRS} n_max={n_max10} S={S10} "
        f"SW={TIMED_SW} diag={cost_l['diag']} (ladder ran SW {cost_l['sw']}): kernel "
        f"{k10[0]:.3f}/{k10[1]:.3f} ms, plain {plain10:.1f} ms; "
        f"B={a512[0].shape[1]} n_max={a512[0].shape[0]} S={a512[2].shape[0]} "
        f"SW={align_l['sw']} diag={align_l['diag']}: kernel {k512[0]:.3f}/{k512[1]:.3f} ms, "
        f"plain {plain512:.1f} ms; max_abs_err {max(err_c, err_a)} (CUDA events)")

    pairs2k = att.generate.generate_batch(PAIRS, 2000, ERR, seed=SEED + 1)
    args2k, _ = pack_batch_staggered(pairs2k, 32, device="cuda")

    def run(args, plain):
        f = banded.banded_cost_ref if plain else banded_kernel.banded_cost
        return lambda: f(*args, TIMED_SW)

    turns = args10k if plain10 / 1e3 <= PLAIN_LIMIT_S else args2k
    label = "10 kbp" if turns is args10k else "2 kbp"
    times, outs = {True: [], False: []}, {}
    for plain in (True, False, False, True):
        ms, outs[plain] = _event_ms(run(turns, plain))
        times[plain].append(ms)
    err_t = int((outs[True].long() - outs[False].long()).abs().max())
    if err_t:
        fail("timed kernel != plain")
    ms, plain_ms = float(np.mean(times[False])), float(np.mean(times[True]))
    say(f"[5 time] turns on {label} pairs (plain at 10 kbp took {plain10 / 1e3:.1f} s, "
        f"limit {PLAIN_LIMIT_S:.0f} s): B={PAIRS} n_max={turns[0].shape[0]} SW={TIMED_SW}: "
        f"kernel {times[False][0]:.3f}/{times[False][1]:.3f} ms, plain "
        f"{times[True][0]:.1f}/{times[True][1]:.1f} ms (CUDA events), "
        f"speed-up {plain_ms / ms:.1f}x, max_abs_err {err_t}")
    return {
        "max_abs_err": max(err_c, err_a, err_t),
        # The main path's shape: the kernel's mean of two runs, plain's one run.
        "ms": float(np.mean(k10)), "plain_ms": plain10,
        "shape": {"B": PAIRS, "n_max": n_max10, "S": S10, "SW": TIMED_SW},
        # The turns (plain, kernel, kernel, plain): means of two runs each.
        "turns_ms": ms, "turns_plain_ms": plain_ms,
        "turns_shape": {"B": PAIRS, "n_max": turns[0].shape[0],
                        "S": turns[2].shape[0], "SW": TIMED_SW},
    }


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = phase0_card()
    phase1_build()
    grid_err = phase2_grid()

    pairs = att.generate.generate_batch(PAIRS, LENGTH, ERR, seed=SEED)
    batches = [att.generate.generate_batch(STREAM_PAIRS, LENGTH, ERR, seed=SEED + 100 + k)
               for k in range(STREAM_BATCHES)]
    ba = BatchAligner(device="cuda")
    spy = LayerSpy()
    spy.install()
    banded_kernel.LAUNCHES = 0
    phase3_cost(ba, pairs, spy)
    phase4_align(ba, batches)
    launches = banded_kernel.LAUNCHES
    spy.remove()
    if launches == 0:
        fail("the main path never launched the banded cost kernel")
    say(f"[main path] banded_cost kernel launches: {launches}")

    record = phase5_time(spy)
    record["max_abs_err"] = max(record["max_abs_err"], grid_err)
    if "jax" in sys.modules:
        fail("jax was imported")
    say(json.dumps({"kernels": [{
        "name": "banded_cost", "route": "cuda",
        "source": "astarpa_tpu_torch/csrc/banded_cost.cu",
        "replaces": "astarpa_tpu/ops/pallas_banded.py:533",
        "launches": launches, **record,
    }]}))
    say(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
