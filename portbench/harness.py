"""One run of one benchmark cell: set-up, a measured window, the check.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  The cell names a
configuration and a traffic mix in ``BENCHMARK.json``; this module finds
``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``
and, for each metric the cell reports, ``portbench/metrics/<metric>.py``
(a ``read(run)`` that returns a number or None) by those names, so a new
cell, mix or metric is new files and entries only.

The run, in order:

1. Set-up (``setup_s``): imports, the distinct batches (:mod:`.traffic`:
   the configuration's pairs, in the seed's order), the aligner, and a warm-up through the traffic's
   entry over every distinct batch and the first again, which loads or
   builds the program's kernels and settles its band hints.
2. The window: a closed-loop stream through ``cost_iter`` or
   ``align_iter``.  The stream pulls the next batch whenever it wants one,
   the distinct batches in turn, until ``--seconds`` have passed; then it
   drains.  Each batch's pull and yield are timed on the host clock.  With
   ``--trace 1`` the window runs under ``torch.profiler``, and the
   benchmark's own wrappers record host spans around the program's layers
   and the work of every band rung.
3. The check, after the window: the costs of every yielded batch against
   the plain reference (:mod:`.reference`) on the pairs the configuration
   covers, sampled CIGARs replayed over their pairs, and every pulled batch
   yielded whole.  Each number is printed beside its limit.
4. The last line of standard output: ``correct``, ``attempted``,
   ``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
   and last the numbers compared (``checks``).
"""

from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import re
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import reference, traffic

#: Top-level module names that may not be loaded in a run's process: the
#: JAX stack and the JAX package the program was ported from.
BANNED_MODULES = ("jax", "jaxlib", "flax", "astarpa_tpu")

#: Host spans recorded in a traced run, by the program's attribute that is
#: wrapped: methods of the aligner instance, and the kernel wrappers the
#: runner module calls for band rungs.
ALIGNER_SPANS = {
    "_cost_batch": "bucket", "_cost_dispatch": "dispatch", "_cost_finish": "finish",
    "_align_dispatch_start": "dispatch", "_align_dispatch_finish": "finish",
    "_pack": "pack", "_rung_start": "rung_start", "_rung_finish": "rung_finish",
    "_flush_traces": "flush_traces",
}
RUNG_WRAPPERS = ("banded_cost", "pinned_cost", "striped_cost",
                 "banded_ck", "pinned_ck", "striped_ck")

#: Limits of the numbers a run compares (exact comparisons): covered pairs
#: whose cost is wrong or missing, and sampled CIGARs that are not an
#: alignment at the reference's cost.
CHECK_LIMITS = {"cost_wrong": 0, "cigar_wrong": 0}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str):
    """``(bench, cell, config, traffic)`` of a cell named in BENCHMARK.json."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    base = root / "portbench"
    return (bench, cell, load_json(base / "configs" / f"{cell['config']}.json"),
            load_json(base / "traffic" / f"{cell['traffic']}.json"))


def load_reader(root: Path, metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED_MODULES))


# -- what a metric reader gets ------------------------------------------------


@dataclass
class Batch:
    pull: float                 # host clock when the stream pulled it
    batch: int                  # which of the configuration's batches
    bp: int                     # bases of side a
    done: float | None = None   # host clock when its results were yielded
    stats: object = None        # the program's BatchStats


@dataclass
class Run:
    """A finished run as metric readers see it.  Times are host-clock
    seconds (``time.perf_counter``); the window is ``[t0, t_end]``."""

    config: dict
    setup_s: float
    t0: float
    t_end: float
    batches: list
    spans: list = field(default_factory=list)    # (name, start, end, thread)
    rungs: list = field(default_factory=list)    # dicts, see _Spies._rung
    main_thread: int = 0
    trace: dict | None = None                    # see _read_trace
    card: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0


# -- spans and rung work, recorded from outside the program ---------------------


class _Spies:
    """Wraps the aligner's layer methods, the runner's rung kernel
    wrappers and the readback wait, recording host spans and each rung's
    work; :meth:`remove` puts everything back."""

    def __init__(self, aligner, runner_mod):
        self.spans: list = []
        self.rungs: list = []
        self._undo: list = []
        for attr, name in ALIGNER_SPANS.items():
            if hasattr(aligner, attr):
                setattr(aligner, attr, self._span(name, getattr(aligner, attr)))
                self._undo.append(lambda a=attr: delattr(aligner, a))
        for attr in RUNG_WRAPPERS:
            fn = getattr(runner_mod, attr)
            setattr(runner_mod, attr, self._rung(attr, fn))
            self._undo.append(lambda a=attr, f=fn: setattr(runner_mod, a, f))
        rb = runner_mod._Readback
        wait = rb.numpy
        rb.numpy = self._span("readback_wait", wait)
        self._undo.append(lambda: setattr(rb, "numpy", wait))

    def _span(self, name, fn):
        spans, clock = self.spans, time.perf_counter

        def wrapped(*args, **kwargs):
            t = clock()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((name, t, clock(), threading.get_ident()))
        return wrapped

    def _rung(self, name, fn):
        rungs, span = self.rungs, self._span("launch", fn)

        def wrapped(*args, **kwargs):
            out = span(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            rungs.append(dict(
                kernel=name, band_words=int(args[6]), columns=int(np.sum(args[4])),
                in_bytes=sum(int(x.nbytes) for x in args[:6]),
                out_bytes=sum(int(x.nbytes) for x in outs),
            ))
            return out
        return wrapped

    def remove(self):
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


# -- the device trace -------------------------------------------------------------

#: The function of a kernel's name as the profiler shows it, e.g.
#: ``void (anonymous namespace)::ring_cost_kernel<0>(unsigned char const*, ...)``.
_NAME = re.compile(r"^(?:void\s+)?(?:\(anonymous namespace\)::|\w+::)*(\w+)")


def program_kernels() -> set[str]:
    """The ``__global__`` functions of the program's CUDA sources: its
    dynamic-programming kernels, by the names the profiler shows."""
    import astarpa_tpu_torch

    names = set()
    for src in sorted((Path(astarpa_tpu_torch.__file__).parent / "csrc").glob("*.cu")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                src.read_text()))
    return names


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _read_trace(prof, t0: float, t_end: float, dp_names: set[str]) -> dict:
    """Device operations of the profiled stream on the host clock: each
    kernel, copy and fill with its name and interval, the busy seconds
    inside the window, and the seconds of the program's kernels."""
    import torch

    events = prof.events()
    marks = [e for e in events if e.name == "portbench.window"]
    ops = []
    if marks:
        base = t0 - marks[0].time_range.start / 1e6
        # The window's own annotation also shows on the device's timeline.
        ops = [(e.name, base + e.time_range.start / 1e6, base + e.time_range.end / 1e6)
               for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("portbench.")]
    inside = [(max(s, t0), min(e, t_end)) for _, s, e in ops if e > t0 and s < t_end]
    busy = _merge(inside)
    dp = [e - s for name, s, e in ops if (m := _NAME.match(name)) and m.group(1) in dp_names]
    return dict(ops=ops, busy=busy, busy_s=sum(e - s for s, e in busy),
                dp_kernel_s=sum(dp), dp_kernels=len(dp))


def _breakdown(run: Run) -> dict:
    """The device operations that took most time in the window, and the
    idle gaps by the innermost span the main thread was in."""
    by_op: dict[str, float] = {}
    for name, s, e in run.trace["ops"]:
        s, e = max(s, run.t0), min(e, run.t_end)
        if e > s:
            key = name[:96]
            by_op[key] = by_op.get(key, 0.0) + e - s
    gaps, edge = [], run.t0
    for s, e in run.trace["busy"]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if run.t_end > edge:
        gaps.append((edge, run.t_end))
    main = sorted((s, e, n) for n, s, e, th in run.spans if th == run.main_thread)
    starts = [s for s, _, _ in main]
    # Main-thread spans nest: each one's parent is the latest started span
    # still open when it starts.
    parent, open_ = [], []
    for k, (s, e, _) in enumerate(main):
        while open_ and main[open_[-1]][1] <= s:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(k)
    side = _merge((s, e) for n, s, e, th in run.spans if th != run.main_thread)
    side_starts = [s for s, _ in side]
    by_host: dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        # The innermost main-thread span holding the gap's middle: the latest
        # started one that has not ended (main-thread spans nest).
        name = None
        k = bisect.bisect_right(starts, mid) - 1
        while k >= 0:
            if main[k][1] > mid:
                name = main[k][2]
                break
            k = parent[k]
        if name is None:
            k = bisect.bisect_right(side_starts, mid) - 1
            name = ("no span; flush_traces on a side thread"
                    if k >= 0 and side[k][1] > mid else "no span")
        by_host[name] = by_host.get(name, 0.0) + e - s
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def _card() -> dict:
    """Name, SMs, maximum SM clock and power limit of card 0."""
    import torch

    props = torch.cuda.get_device_properties(0)
    card = dict(name=torch.cuda.get_device_name(0), sms=props.multi_processor_count)
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
        clock, limit = (x.strip() for x in out.split(","))
        card.update(max_sm_clock_hz=float(clock) * 1e6, power_limit_w=float(limit))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return card


# -- the run ----------------------------------------------------------------------


def covered_pairs(seed: int, config: dict, pairs_of: list) -> list[np.ndarray]:
    """Indices of the pairs of each distinct batch whose answers a run
    compares: all, or ``reference_pairs`` of each drawn from the seed."""
    n_ref = config.get("reference_pairs")
    return [np.arange(len(p)) if n_ref is None
            else np.sort(traffic.rng_for(seed, 3, i).choice(len(p), n_ref, replace=False))
            for i, p in enumerate(pairs_of)]


def covered_distances(distinct, covered, device) -> list[np.ndarray]:
    """Per distinct batch, the reference's distance of each covered pair
    (-1 elsewhere), each distinct pair computed once."""
    want = [(i, int(j)) for i in range(len(distinct)) for j in covered[i]]
    got = reference.reference_distances([distinct[i][0][j] for i, j in want],
                                        max(k for _, k in distinct), device)
    out = [np.full(len(p), -1, dtype=np.int64) for p, _ in distinct]
    for (i, j), d in zip(want, got):
        out[i][j] = d
    return out


def _results(out) -> tuple[np.ndarray, list | None]:
    """Costs of a yielded batch, and its per-pair results on the align
    path (``(cost, cigar)`` each); -1 marks a pair with no result."""
    if isinstance(out, np.ndarray):
        return out.astype(np.int64, copy=False), None
    return np.array([r[0] if r is not None else -1 for r in out], dtype=np.int64), out


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda") -> tuple[dict, dict]:
    """Run one cell; returns the result line's object and the checks."""
    import torch

    from astarpa_tpu_torch.ops import banded_kernel
    from astarpa_tpu_torch.parallel import runner as runner_mod

    bench, cell, config, mix = load_cell(root, workload)
    t_import = time.perf_counter()
    distinct = traffic.make_batches(seed, config)
    t_made = time.perf_counter()
    aligner = runner_mod.BatchAligner(device=device, **config.get("aligner", {}))
    stream = getattr(aligner, mix["entry"])
    align = mix["entry"] == "align_iter"
    pairs_of = [p for p, _ in distinct]
    t_warm = time.perf_counter()
    # Every distinct batch, then the first again: each hand-over the window
    # makes between batches has been made once.
    for _ in stream(iter(pairs_of + pairs_of[:1])):
        pass
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    setup_split = (f"imports {t_import - t_start:.3f} s, traffic {t_made - t_import:.3f} s, "
                   f"aligner {t_warm - t_made:.3f} s, warm-up {t_start + setup_s - t_warm:.3f} s")

    covered = covered_pairs(seed, config, pairs_of)
    n_cigars = config.get("cigars_per_batch", 0)

    spies = prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        spies = _Spies(aligner, runner_mod)
        launches = sum(banded_kernel.LAUNCHES.values())
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    batches: list[Batch] = []
    kept: list = []
    clock = time.perf_counter

    bp_of = [sum(len(a) for a, _ in p) for p in pairs_of]

    def feed():
        k = 0
        while (now := clock()) < t_end:
            i = k % len(pairs_of)
            batches.append(Batch(pull=now, batch=i, bp=bp_of[i]))
            yield pairs_of[i]
            k += 1

    mark = record_function("portbench.window") if trace else None
    if mark is not None:
        mark.__enter__()
    t0 = clock()
    t_end = t0 + seconds
    for j, (out, stats) in enumerate(stream(feed())):
        batches[j].done = clock()
        batches[j].stats = stats
        costs, per_pair = _results(out)
        cigars = {}
        if align and n_cigars and per_pair is not None:
            pick = traffic.rng_for(seed, 2, j).choice(
                covered[batches[j].batch], min(n_cigars, len(covered[batches[j].batch])),
                replace=False)
            cigars = {int(p): per_pair[p][1] if per_pair[p] is not None else None
                      for p in pick if p < len(per_pair)}
        kept.append((costs, cigars))
    if on_card:
        torch.cuda.synchronize()
    if mark is not None:
        mark.__exit__(None, None, None)
    main_thread = threading.get_ident()
    trace_info = None
    if trace:
        prof.__exit__(None, None, None)
        spies.remove()
        trace_info = _read_trace(prof, t0, t_end, program_kernels())
        trace_info["launches"] = sum(banded_kernel.LAUNCHES.values()) - launches
        del prof
    memory_peak = int(torch.cuda.max_memory_allocated(0)) if on_card else 0
    card = _card() if on_card else {}
    del aligner, stream
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    # The check.
    ref = covered_distances(distinct, covered, device)
    # A covered pair's cost is wrong where it differs from the reference or
    # never came: its batch was not yielded, or not whole, or left it out.
    cost_wrong = cigar_wrong = 0
    for b, (costs, cigars) in zip(batches, kept):
        cov = covered[b.batch]
        if len(costs) != len(pairs_of[b.batch]):
            cost_wrong += len(cov)
            continue
        cost_wrong += int((costs[cov] != ref[b.batch][cov]).sum())
        for p, cig in cigars.items():
            a, bb = pairs_of[b.batch][p]
            got_cost = None if cig is None else reference.check_cigar(str(cig), a, bb)
            if got_cost is None or got_cost != costs[p] or got_cost != ref[b.batch][p]:
                cigar_wrong += 1
    cost_wrong += sum(len(covered[b.batch]) for b in batches[len(kept):])
    checks = {"cost_wrong": cost_wrong, "cigar_wrong": cigar_wrong}
    print(f"portbench: {workload} seed {seed}: setup {setup_s:.3f} s ({setup_split}), {len(kept)} of "
          f"{len(batches)} batches yielded, drain {t_ref - t_end:.3f} s, reference and "
          f"check {time.perf_counter() - t_ref:.3f} s over {sum(map(len, covered))} pairs",
          file=sys.stderr)
    correct = all(checks[k] <= CHECK_LIMITS[k] for k in checks)

    run = Run(config=config, setup_s=setup_s, t0=t0, t_end=t_end,
              batches=[b for b in batches if b.done is not None],
              spans=spies.spans if spies else [], rungs=spies.rungs if spies else [],
              main_thread=main_thread, trace=trace_info, card=card)
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        value = load_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": card.get("name", "cpu"),
           "count": cell["chips"] if on_card else 0,
           "memory_peak_bytes": memory_peak}
    if "power_limit_w" in card:
        dev["power_limit_w"] = card["power_limit_w"]
        dev["max_sm_clock_hz"] = card["max_sm_clock_hz"]
    result = {"correct": correct, "attempted": sum(len(pairs_of[b.batch]) for b in batches),
              "failed": cost_wrong + cigar_wrong, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = trace_info["busy_s"]
        dev["window_s"] = run.window_s
        if trace_info["ops"]:
            result["breakdown"] = _breakdown(run)
    result["checks"] = {k: {"value": v, "limit": CHECK_LIMITS[k]} for k, v in checks.items()}
    return result, checks


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    _, cell, _, _ = load_cell(root, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, checks = run_cell(root, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start)
    bad = banned_modules()
    if bad:
        print(f"portbench: modules loaded that the run may not load: {bad}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for k, v in checks.items():
        print(f"check {k} {v} limit {CHECK_LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
