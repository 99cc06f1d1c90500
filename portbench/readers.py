"""What the metric readers under ``portbench/metrics/`` share.

Each reader is ``read(run) -> float | None`` on a :class:`.harness.Run`;
None leaves the metric out of the run's line (nothing to read)."""

from __future__ import annotations

from .roofline import least_seconds


def window_batches(run):
    """Batches yielded inside the window."""
    return [b for b in run.batches if run.t0 < b.done <= run.t_end]


def window_rate_mbp_s(run):
    """Bases of side a aligned in the window, over the window's seconds, in
    Mbp/s: the batches yielded inside it, and of the first batch yielded
    after it the share of its bases that the time from the last yield (or
    the window's start) to the window's end covers, so that the rate does
    not step by whole batches."""
    done = window_batches(run)
    later = sorted((b for b in run.batches if b.done > run.t_end), key=lambda b: b.done)
    bp = sum(b.bp for b in done)
    if later:
        last = max((b.done for b in done), default=run.t0)
        bp += later[0].bp * (run.t_end - last) / (later[0].done - last)
    return bp / run.window_s / 1e6


def span_share_pct(run, name: str):
    """Host seconds inside spans ``name`` (on any thread, overlaps merged),
    clipped to the window, as a share of the window's seconds."""
    if not run.spans:
        return None
    cut = sorted((max(s, run.t0), min(e, run.t_end)) for n, s, e, _ in run.spans
                 if n == name and e > run.t0 and s < run.t_end)
    total, edge = 0.0, run.t0
    for s, e in cut:
        s = max(s, edge)
        if e > s:
            total += e - s
            edge = e
    return 100.0 * total / run.window_s


def cells_per_bp(run):
    """The band ladder's cells over the bases aligned, window batches."""
    got = window_batches(run)
    bp = sum(b.bp for b in got)
    return sum(b.stats.cells_computed for b in got) / bp if bp else None


def rung_roofline_pct(run):
    """The least time the card needs for every rung of the traced stream,
    over the device seconds of the program's kernels in the trace (rungs
    and kernels of the whole traced stream, its drain included)."""
    card, tr = run.card, run.trace
    if not (tr and run.rungs and tr["dp_kernel_s"] > 0 and "max_sm_clock_hz" in card):
        return None
    # One kernel a rung: the rungs counted, the program's launch counter and
    # the program's kernels in the trace must agree, or the two sides of the
    # ratio cover different work.
    if not len(run.rungs) == tr["launches"] == tr["dp_kernels"]:
        return None
    least = sum(least_seconds(r["band_words"], r["columns"], r["in_bytes"], r["out_bytes"],
                              card["sms"], card["max_sm_clock_hz"]) for r in run.rungs)
    return 100.0 * least / tr["dp_kernel_s"]


def device_idle_pct(run):
    """The share of the window in which no kernel, copy or fill ran on
    the card."""
    if not (run.trace and run.trace["ops"]):
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.window_s)
