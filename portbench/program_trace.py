"""The program's own spans and launch records in a traced run, and the three
per-layer readings they give.

A traced run of :mod:`.harness` reads host spans and rung shapes from the
benchmark's wrappers around the program's private methods (``_Spies``).
The program records its own (``astarpa_tpu_torch.utils.spans``):
``astarpa.*`` ranges in the same ``torch.profiler`` trace as its kernels,
and a launch record for each kernel wrapper call.  :func:`run_cell` runs
``harness.run_cell`` with ``--trace 1`` and the recorder on for the traced
stream, takes the program's ranges, kernels and records into
``run.program`` (:func:`program_trace`), and adds the readings of
:data:`METRICS` to the result line.  ``harness.run_cell`` does not turn
the recorder on itself (a benchmark PR moves these steps into it), so this
module reaches it through three of the harness's names: ``_Spies`` (the
recorder on and off with the wrappers), ``_read_trace`` (it gets the
profiler, and a view of its events without the program's ranges, which
would otherwise count as device time where the profiler draws them on the
device's timeline) and ``Run`` (the run the readings read).

    python -m portbench.program_trace --workload <cell> --seed <n> --seconds <s>

prints the traced run's result line with the readings added and, under
``program_trace``, how many kernels were matched to their records.  Times
in ``run.program`` are seconds on the profiler's clock from the window's
start (its ``portbench.window`` mark), without any offset to the host
clock.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from . import harness
from .readers import window_batches
from .roofline import least_seconds

#: What the program's span names start with (``spans.PREFIX``).
PREFIX = "astarpa."


# -- the program's trace ------------------------------------------------------


@dataclass
class Range:
    name: str       # the span's name without PREFIX
    start: float    # seconds from the window's start, profiler clock
    end: float
    thread: int     # the profiler's thread id


@dataclass
class Kernel:
    name: str
    start: float
    end: float
    launched: float | None  # when its runtime launch call started (None: not found)
    thread: int | None      # the profiler's thread id of that call


def is_launch_call(event) -> bool:
    """Whether a profiler event on the host is a CUDA API call
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ...): the profiler gives it
    the correlation id of the device work it queued."""
    return not event.is_user_annotation() and event.name().startswith("cu")


def program_trace(prof, window_s: float, dp_names: set[str]) -> dict | None:
    """The program's ranges and its dynamic-programming kernels in a
    profiler trace, from the profiler's own events, each kernel with the
    CUDA API call that launched it, which the profiler
    correlates with it; None without the window's mark."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    mark = next((e for e in events if e.name() == "portbench.window"
                 and e.device_type() == cpu), None)
    if mark is None:
        return None
    t0 = mark.start_ns()
    sec = lambda ns: (ns - t0) / 1e9  # noqa: E731
    ranges = sorted((Range(e.name()[len(PREFIX):], sec(e.start_ns()), sec(e.end_ns()),
                           e.start_thread_id())
                     for e in events if e.device_type() == cpu and e.name().startswith(PREFIX)),
                    key=lambda r: (r.start, -r.end))
    calls = {e.correlation_id(): e for e in events
             if e.device_type() == cpu and is_launch_call(e)}
    kernels = []
    for e in events:
        if e.device_type() == cuda and (m := harness._NAME.match(e.name())) \
                and m.group(1) in dp_names:
            call = calls.get(e.correlation_id())
            kernels.append(Kernel(m.group(1), sec(e.start_ns()), sec(e.end_ns()),
                                  None if call is None else sec(call.start_ns()),
                                  None if call is None else call.start_thread_id()))
    kernels.sort(key=lambda k: k.start)
    return dict(window_s=window_s, main_thread=mark.start_thread_id(), ranges=ranges,
                kernels=kernels, launches=[])


def matches(prog: dict) -> list | None:
    """Each program kernel of the trace with the ``launch`` range its
    launch call ran in, on the same thread, and that range's launch record:
    ``[(kernel, range, record)]``; None where a kernel has no such range.
    Records pair with the ``launch`` ranges in launch order, which needs
    one launching thread (the stream's), else None."""
    launch = [r for r in prog["ranges"] if r.name == "launch"]
    records = prog["launches"]
    if (len(launch) != len(records) or len({r.thread for r in launch}) > 1
            or len({x["thread"] for x in records}) > 1):
        return None
    starts = [r.start for r in launch]
    got = []
    for k in prog["kernels"]:
        j = bisect.bisect_right(starts, k.launched) - 1 if k.launched is not None else -1
        if j < 0 or k.launched > launch[j].end or k.thread != launch[j].thread:
            return None
        got.append((k, launch[j], records[j]))
    return got


# -- interval arithmetic ------------------------------------------------------


def _union(intervals, lo: float, hi: float) -> list:
    """The union of ``intervals`` clipped to ``[lo, hi]``, merged, sorted."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a: list, b: list) -> float:
    """Seconds that two merged, sorted interval lists share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


# -- the readings -------------------------------------------------------------


def pack_span_share_pct(run):
    """Host seconds in the program's ``pack`` spans (any thread, overlaps
    merged), clipped to the window, over the window: the program-side twin
    of ``pack_share``."""
    prog = getattr(run, "program", None)
    if not prog:
        return None
    w = prog["window_s"]
    packs = _union(((r.start, r.end) for r in prog["ranges"] if r.name == "pack"), 0.0, w)
    return 100.0 * _length(packs) / w


def launch_roofline_pct(run):
    """The least time of every launch record whose kernel ran (its band's
    word steps or its bytes, :func:`.roofline.least_seconds`), over the
    device seconds of the program's kernels, each matched to the record
    its launch call made; None unless every program kernel of the trace is
    matched.  The twin of ``ring_roofline``, over the same traced stream."""
    prog, card = getattr(run, "program", None), run.card
    if not (prog and prog["kernels"] and "max_sm_clock_hz" in card):
        return None
    got = matches(prog)
    if got is None:
        return None
    records = {id(rec): rec for _, _, rec in got}.values()
    if any(rec["columns"] is None for rec in records):
        return None
    least = sum(least_seconds(rec["band_words"], rec["columns"], rec["in_bytes"],
                              rec["out_bytes"], card["sms"], card["max_sm_clock_hz"])
                for rec in records)
    return 100.0 * least / sum(k.end - k.start for k, _, _ in got)


def host_ms_per_batch(run):
    """Main-thread seconds in the program's ``dispatch`` and ``finish``
    spans, less the ``readback_wait`` spans inside them, clipped to the
    window, over the batches yielded in it, in ms: the host's own work a
    batch."""
    prog = getattr(run, "program", None)
    batches = len(window_batches(run))
    if not (prog and batches):
        return None
    w, main = prog["window_s"], prog["main_thread"]
    mine = [r for r in prog["ranges"] if r.thread == main]
    host = _union(((r.start, r.end) for r in mine if r.name in ("dispatch", "finish")), 0.0, w)
    wait = _union(((r.start, r.end) for r in mine if r.name == "readback_wait"), 0.0, w)
    return 1e3 * (_length(host) - _overlap(host, wait)) / batches


#: The readings: name -> (unit, reader of a run).
METRICS = {
    "pack_span_share.cost": ("%", pack_span_share_pct),
    "launch_roofline.cost": ("%", launch_roofline_pct),
    "host_ms_per_batch.cost": ("ms", host_ms_per_batch),
}


# -- a traced run with the recorder on ------------------------------------------


class _WithoutProgramRanges:
    """A profiler's events without the program's ranges, for
    ``harness._read_trace``, which takes every device-side event but its
    own window's as device work."""

    def __init__(self, prof):
        self._prof = prof

    def events(self):
        return [e for e in self._prof.events() if not e.name.startswith(PREFIX)]


@contextlib.contextmanager
def _recorder_in_traced_runs(got: dict):
    """``harness.run_cell``'s traced stream with the program's recorder on
    (from the wrappers' start to their removal, which enclose the
    profiler), its program trace and launch records in ``got``, and the
    run it builds in ``got["run"]``."""
    from astarpa_tpu_torch.utils import spans

    spies, read_trace, run_cls = harness._Spies, harness._read_trace, harness.Run
    window = contextlib.ExitStack()

    class Spies(spies):
        def __init__(self, *args):
            super().__init__(*args)
            got["launches"] = window.enter_context(spans.recording())

        def remove(self):
            window.close()
            super().remove()

    def read(prof, t0, t_end, dp_names):
        got["program"] = program_trace(prof, t_end - t0, dp_names)
        return read_trace(_WithoutProgramRanges(prof), t0, t_end, dp_names)

    @dataclass
    class Run(run_cls):
        def __post_init__(self):
            got["run"] = self

    harness._Spies, harness._read_trace, harness.Run = Spies, read, Run
    try:
        yield
    finally:
        window.close()
        harness._Spies, harness._read_trace, harness.Run = spies, read_trace, run_cls


def run_cell(root: Path, workload: str, seed: int, seconds: float, t_start: float,
             device: str = "cuda") -> tuple[dict, dict]:
    """``harness.run_cell`` with ``--trace 1`` and the program's recorder on
    for the traced stream; the result line gains the readings of
    :data:`METRICS` and ``program_trace``: the program's kernels, how many
    are matched to a launch record, how many start before their ``launch``
    range does, and the batches yielded in the window."""
    got: dict = {}
    with _recorder_in_traced_runs(got):
        result, checks = harness.run_cell(root, workload, seed, seconds, True, t_start, device)
    run = got["run"]
    run.program = got.get("program")
    if run.program is not None:
        run.program["launches"] = got.get("launches", [])
    for name, (unit, read) in METRICS.items():
        value = read(run)
        if value is not None:
            result["metrics"][name] = {"value": float(value), "unit": unit}
    prog = run.program or dict(kernels=[], launches=[])
    pairs = matches(prog) if run.program else None
    result["program_trace"] = dict(
        kernels=len(prog["kernels"]), launch_records=len(prog["launches"]),
        matched=len(pairs) if pairs is not None else 0,
        started_before_launch=sum(k.start < r.start for k, r, _ in pairs or []),
        window_batches=len(window_batches(run)))
    result["checks"] = result.pop("checks")
    return result, checks


def main(argv) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python -m portbench.program_trace")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    # Kernel and extension caches stay inside the checkout, as run.py keeps them.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / sub)
    import torch

    if not torch.cuda.is_available():
        print("portbench.program_trace: needs a CUDA device", file=sys.stderr)
        return 3
    result, _ = run_cell(root, args.workload, args.seed, args.seconds, t_start)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
