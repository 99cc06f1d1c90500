"""Batch/streaming alignment runtime of the port: the performance product.

Counterpart of ``astarpa_tpu/parallel/runner.py`` for the main path.  Pairs
are bucketed by shape, packed into pair-minor planes on the device, run
through the banded cost kernel (:mod:`..ops.banded_kernel`) and certified
per pair; uncertified pairs retry at the band their banded upper bound
predicts.  CIGARs come from direct whole-pair DT traces on the host
(native ``trace_direct_batch``), computed from the certified costs.

The ladder arithmetic (rounding, repack rule, cell counts, warm band
hints, sticky diagonal, full-height clamp) is the reference's, verbatim,
so ``BatchStats`` match it field for field.

Not ported yet, each raising ``NotImplementedError``: per-pair domain
ladders (``domain_mode`` resolving to "gap"/"gcsh"), ``mesh``,
``direct_dt=False`` and align rungs whose certified costs may exceed the
direct-trace budget (both need the checkpoint kernel), and the host trace
fallbacks without the native library.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from astarpa_tpu import native
from astarpa_tpu.ops.bitpack import W
from astarpa_tpu.types import Cigar, CigarOp

from ..device import resolve_device
from ..ops import banded
from ..ops.banded_kernel import banded_cost, route
from ..ops.pack import pack_batch_staggered

INF = 1 << 30

_TODO_DOMAIN = "ROADMAP.md queue 1 item 11 (per-pair schedules and domains)"
_TODO_MESH = "ROADMAP.md queue 1 item 12 (multi-GPU and multi-host)"
_TODO_CK = "ROADMAP.md queue 1 item 9 (checkpoint path, kernel K2)"


@dataclass
class BatchStats:
    pairs: int = 0
    buckets: int = 0
    band_retries: int = 0
    cells_computed: int = 0
    aligned_bp: int = 0
    # Pairs whose CIGAR came from the direct whole-pair DT trace.
    direct_traces: int = 0
    # What ran the cost rungs ("cuda-banded" or "torch-ref"), set when a
    # rung is dispatched.
    kernel: str | None = None


@dataclass
class BatchAligner:
    """Aligns many pairs data-parallel on one device.

    Args:
      band_words: first band height in uint32 words (warm hints replace it).
      lane_multiple: batch padding granularity (a warp of pairs).
      mesh: not supported yet (must be None).
      max_band_doublings: rungs before the ladder clamps to full height.
      domain_mode / domain_min_bp: the reference's per-pair domain policy;
        buckets it would send to a domain ladder raise for now.
      direct_dt: CIGARs by direct DT traces (the only CIGAR path ported).
      shape_quantum: padded-geometry quantum ("auto" as the reference).
      device: "cuda", "cpu" or None (the GPU when there is one).
    """

    band_words: int = 8
    lane_multiple: int = 32
    mesh: object = None
    max_band_doublings: int = 8
    domain_mode: str = "auto"
    domain_min_bp: int = 32768
    direct_dt: bool = True
    shape_quantum: object = "auto"
    device: object = None
    # Warm-start band hints: bucket class -> the tightest band the last
    # bucket of that class needed.
    _band_hints: dict = field(default_factory=dict, repr=False)
    # Sticky diagonal aims per packed geometry (see _diag).
    _diag_hints: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(f"mesh: see {_TODO_MESH}")
        self.device = resolve_device(self.device)

    @staticmethod
    def _bucket_class(bucket_pairs) -> int:
        n_top = max(len(a) for a, _ in bucket_pairs)
        ncls, size = 0, 64
        while size < n_top:
            size = int(size * 1.5) + 1
            ncls += 1
        return ncls

    @staticmethod
    def _note_need(need_max: int, costs, slots, n, m, B0: int, diag) -> int:
        """Running max of the tight band the certified pairs needed (the
        band_for_cost inverse), quantized to the rung grid (powers of two to
        64, then multiples of 64) so the hint does not drift per batch."""
        if not slots:
            return need_max
        sel = np.asarray(slots)
        need = banded.band_for_cost(
            np.asarray(costs)[sel], np.asarray(n)[:B0][sel],
            np.asarray(m)[:B0][sel], *diag,
        )
        b = int(need.max()) + 1
        if b <= 64:
            p = 4
            while p < b:
                p *= 2
            b = p
        else:
            b = -(-b // 64) * 64
        return max(need_max, b)

    def _shape_quantum(self, bucket_pairs) -> int | None:
        if self.shape_quantum != "auto":
            return self.shape_quantum or None
        n_top = max(len(a) for a, _ in bucket_pairs)
        if n_top <= 4096:
            return None
        return 512 if n_top <= 32768 else 2048

    def _diag(self, n, m, B0: int, n_max: int, S: int) -> tuple:
        """Sticky quantized bucket diagonal for schedules and thresholds:
        aim the band at the pairs' real max (n, m), remembered per packed
        geometry while a new batch's aim stays within ~n/128 of it.
        band_threshold's dev term prices the overshoot."""
        n_arr = np.asarray(n)[:B0]
        m_arr = np.asarray(m)[:B0]
        n_top = max(1, int(n_arr.max()))
        m_top = int(m_arr.max())
        cand = -(-(m_top * n_max) // n_top)  # rescale slope to padded cols
        cand = min(-(-cand // 32) * 32, S * W)
        budget = max(64, n_top >> 7)
        key = (n_max, S)
        prev = self._diag_hints.get(key)
        if prev is not None and abs(cand - prev) <= budget:
            return (n_max, prev)
        self._diag_hints[key] = cand
        return (n_max, cand)

    def _resolve_domain_mode(self, pairs, idxs) -> str | None:
        """"gap"/"gcsh" where the reference would run the per-pair domain
        ladder on this bucket, else None (the plain shared ladder)."""
        if self.domain_mode == "off":
            return None
        big = max(len(pairs[i][0]) for i in idxs) >= self.domain_min_bp
        if not big and self.domain_mode == "auto":
            return None
        mode = self.domain_mode
        if mode == "auto":
            mode = (
                "gcsh"
                if native.available() and (os.cpu_count() or 1) >= 8
                else "gap"
            )
            if mode == "gap":
                ns = np.array([len(pairs[i][0]) for i in idxs], np.int64)
                ms = np.array([len(pairs[i][1]) for i in idxs], np.int64)
                n_max = max(int(ns.max()), 1)
                m_max = int(ms.max())
                g = np.abs(ms - ns)
                dev = np.abs(m_max * ns // n_max - ms)
                skew = int((g + 2 * dev).max())
                if skew < (n_max // 16) * 3 // 2:
                    return None
        if mode == "gcsh" and not native.available():
            mode = "gap"
        return mode

    def _require_shared_ladder(self, pairs, idxs) -> None:
        mode = self._resolve_domain_mode(pairs, idxs)
        if mode:
            raise NotImplementedError(
                f"domain_mode {mode!r} for a bucket of pairs >= "
                f"{self.domain_min_bp} bp: see {_TODO_DOMAIN}"
            )

    # -- cost path -------------------------------------------------------------

    def cost(self, pairs) -> np.ndarray:
        costs, _ = self.cost_with_stats(pairs)
        return costs

    def cost_with_stats(self, pairs) -> tuple[np.ndarray, BatchStats]:
        """Exact edit distances for a list of byte pairs.  Buckets run one
        after another, so a bucket starts from the hints the previous one
        left (:meth:`cost_iter` dispatches a batch's buckets together)."""
        stats, out, buckets = self._cost_batch(pairs)
        for bucket in buckets:
            rung = self._rung_start(pairs, self._new_ladder(pairs, bucket), stats)
            while rung is not None:
                rung = self._rung_finish(pairs, out, stats, rung)
        return self._cost_finish(pairs, stats, out, [])

    def cost_iter(self, batches):
        """Pipelined streaming costs: yields one ``(costs, stats)`` per input
        batch, in order.  Batch k+1 packs and launches its first rung while
        batch k's kernel runs; the sync happens at certification."""
        pending = None
        for pairs in batches:
            cur = self._cost_dispatch(pairs)
            if pending is not None:
                yield self._cost_finish(*pending)
            pending = cur
        if pending is not None:
            yield self._cost_finish(*pending)

    def _cost_batch(self, pairs):
        """Stats, the cost vector with the trivial pairs (an empty side)
        filled in, and the shape buckets of the others."""
        stats = BatchStats(pairs=len(pairs))
        out = np.full(len(pairs), -1, dtype=np.int64)
        todo: list[int] = []
        for idx, (a, b) in enumerate(pairs):
            if len(a) == 0 or len(b) == 0:
                out[idx] = len(a) + len(b)
            else:
                todo.append(idx)
        buckets = _buckets(pairs, todo)
        for bucket in buckets:
            self._require_shared_ladder(pairs, bucket)
        stats.buckets = len(buckets)
        return stats, out, buckets

    def _cost_dispatch(self, pairs):
        stats, out, buckets = self._cost_batch(pairs)
        rungs = [self._rung_start(pairs, self._new_ladder(pairs, bucket), stats)
                 for bucket in buckets]
        return pairs, stats, out, rungs

    def _cost_finish(self, pairs, stats, out, rungs):
        for rung in rungs:
            while rung is not None:
                rung = self._rung_finish(pairs, out, stats, rung)
        stats.aligned_bp = sum(len(a) for a, _ in pairs)
        assert (out >= 0).all()
        return out, stats

    def _new_ladder(self, pairs, idxs: list[int]) -> dict:
        """Fresh band-ladder state for one bucket; the warm-start hint
        replaces the configured start band."""
        cls = self._bucket_class([pairs[i] for i in idxs])
        return dict(
            cls=cls,
            band=self._band_hints.get(cls) or self.band_words,
            need_max=1,
            pending=list(idxs),
            attempt=0,
            # (args, B0, members): reused across rungs while the padded
            # batch would not shrink by half.
            packed=None,
        )

    def _pack_rung(self, pairs, lad: dict):
        """Repack when the pending set shrank to half the packed batch;
        returns ``(args, B0, members, n_max, S, diag)``."""
        if lad["packed"] is None or 2 * len(lad["pending"]) <= len(
            lad["packed"][2]
        ):
            bucket_pairs = [pairs[i] for i in lad["pending"]]
            args, B0 = pack_batch_staggered(
                bucket_pairs, self.lane_multiple,
                shape_quantum=self._shape_quantum(bucket_pairs),
                device=self.device,
            )
            lad["packed"] = (args, B0, list(lad["pending"]))
        args, B0, members = lad["packed"]
        n_max, S = args[0].shape[0], args[2].shape[0]
        diag = self._diag(args[4], args[5], B0, n_max, S)
        return args, B0, members, n_max, S, diag

    def _rung_start(self, pairs, lad: dict, stats: BatchStats,
                    trace_jobs: list | None = None) -> dict:
        """Dispatch one band rung without synchronising: the kernel and the
        copy of its result to the host are queued; :meth:`_rung_finish`
        waits and certifies.  With ``trace_jobs`` (the align path) the
        pairs the rung certifies are staged for direct traces, so every
        cost it can certify must fit the native direct-trace budget."""
        args, B0, members, n_max, S, diag = self._pack_rung(pairs, lad)
        n, m = np.asarray(args[4])[:B0], np.asarray(args[5])[:B0]
        sw = min(lad["band"], S)
        # Skewed buckets (m_max > W * n_max) have no valid <=1-word/column
        # schedule; the last rung clamps to the always-exact full height.
        if S > max(n_max, 1) or lad["attempt"] >= self.max_band_doublings:
            sw = S
        # The reference's grouped word loop runs multiples of 8 words above
        # 64.  Kept so the ladder and its cell counts match it exactly: its
        # align rungs count and certify at the rounded height, its cost
        # rungs at the ladder's.
        run_sw = min(-(-sw // 8) * 8, S) if sw > 64 else sw
        if trace_jobs is not None:
            sw = run_sw
        thr = None if sw >= S else banded.band_threshold(sw, n, m, *diag)
        if trace_jobs is not None:
            # A full-height rung is exact, so n+m bounds what it certifies.
            direct_cap = int(thr.max()) if thr is not None else int(n.max() + m.max())
            if direct_cap > native.DIRECT_DT_MAX:
                raise NotImplementedError(
                    f"align rung with certified costs up to {direct_cap} > "
                    f"{native.DIRECT_DT_MAX} needs checkpoint traces: see {_TODO_CK}"
                )
        costs = _Readback(banded_cost(*args, run_sw, diag))
        stats.cells_computed += n_max * sw * W * len(members)
        stats.kernel = route(self.device)
        return dict(lad=lad, costs=costs, sw=sw, S=S, thr=thr, diag=diag,
                    trace_jobs=trace_jobs)

    def _rung_finish(self, pairs, out, stats: BatchStats, rung: dict):
        """Wait for and certify one rung (staging its direct traces on the
        align path); returns the next in-flight rung (retry at a wider
        band) or None when the bucket is done."""
        lad = rung["lad"]
        args, B0, members = lad["packed"]
        n, m = args[4], args[5]
        sw, S, thr, diag = rung["sw"], rung["S"], rung["thr"], rung["diag"]
        costs = rung["costs"].numpy()[:B0]
        # A full-height window (no threshold) is always exact.
        ok = np.ones(B0, dtype=bool) if thr is None else costs <= thr
        pending_set = set(lad["pending"])
        nxt = []
        fail_slots = []
        ok_slots = []
        for slot, i in enumerate(members):
            if i not in pending_set:
                continue
            if ok[slot]:
                out[i] = int(costs[slot])
                ok_slots.append(slot)
            else:
                nxt.append(i)
                fail_slots.append(slot)
        trace_jobs = rung["trace_jobs"]
        if trace_jobs is not None and ok_slots:
            shift = banded.shift_at_array(args[0].shape[0], S, sw, diag)
            stats.direct_traces += len(ok_slots)
            trace_jobs.extend(
                _TraceJob(pair=members[slot], shift=shift, s_words=S, sw=sw,
                          want=int(costs[slot]))
                for slot in ok_slots
            )
        lad["need_max"] = self._note_need(
            lad["need_max"], costs, ok_slots, n, m, B0, diag
        )
        lad["pending"] = nxt
        if not nxt:
            self._band_hints[lad["cls"]] = lad["need_max"]
            return None
        assert sw < S, "full-height window must certify every pair"
        stats.band_retries += 1
        lad["band"] = self._next_band(lad["band"], costs, fail_slots, n, m,
                                      B0, diag)
        lad["attempt"] += 1
        return self._rung_start(pairs, lad, stats, trace_jobs)

    def _next_band(self, band, costs, fail_slots, n, m, B0, diag) -> int:
        """Jump to the band the failed pairs' banded upper bounds certify at
        (band_for_cost), doubling where a result is the INF sentinel; +1
        word absorbs the skew drift a repack can introduce."""
        sel = np.asarray(fail_slots)
        c = np.asarray(costs)[sel]
        finite = c < INF // 2
        floor = band * 2 if not finite.all() else band + 1
        if not finite.any():
            return floor
        sel = sel[finite]
        need = banded.band_for_cost(
            c[finite], np.asarray(n)[:B0][sel], np.asarray(m)[:B0][sel],
            *diag,
        )
        return max(floor, int(need.max()) + 1)

    # -- CIGAR path ------------------------------------------------------------

    def align(self, pairs) -> list[tuple[int, Cigar]]:
        return self.align_with_stats(pairs)[0]

    def align_with_stats(self, pairs) -> tuple[list[tuple[int, Cigar]], BatchStats]:
        """Costs and CIGARs: the cost ladder runs on the device and each
        rung's certified pairs are traced on the host from their certified
        costs (direct whole-pair DT traces)."""
        results, stats, trace_jobs = self._align_dispatch_finish(
            self._align_dispatch_start(pairs)
        )
        self._flush_traces(trace_jobs, pairs, results)
        return results, stats

    def align_iter(self, batches):
        """Pipelined streaming alignment: yields one ``(results, stats)`` per
        input batch, in order.  Batch k+1 is dispatched before batch k is
        certified, and batch k's traces run on a side thread while batch
        k+1 certifies and k+2 dispatches; yields trail the input by up to
        two batches."""
        started = None    # (pairs, state) dispatched, not certified
        flushing = None   # (results, stats, future)
        it = iter(batches)
        sentinel = object()
        with ThreadPoolExecutor(1) as ex:
            nxt = next(it, sentinel)
            while nxt is not sentinel:
                cur = (nxt, self._align_dispatch_start(nxt))
                nxt = next(it, sentinel)
                if started is not None:
                    p_pairs, p_state = started
                    results, stats, trace_jobs = self._align_dispatch_finish(
                        p_state
                    )
                    if flushing is not None:
                        flushing[2].result()
                        yield flushing[0], flushing[1]
                    flushing = (results, stats, ex.submit(
                        self._flush_traces, trace_jobs, p_pairs, results
                    ))
                started = cur
            if started is not None:
                p_pairs, p_state = started
                results, stats, trace_jobs = self._align_dispatch_finish(
                    p_state
                )
                if flushing is not None:
                    flushing[2].result()
                    yield flushing[0], flushing[1]
                self._flush_traces(trace_jobs, p_pairs, results)
                yield results, stats

    def _align_dispatch_start(self, pairs):
        """Pack and dispatch the first rung of every bucket, nothing
        synchronised; :meth:`_align_dispatch_finish` certifies."""
        if not self.direct_dt:
            raise NotImplementedError(f"direct_dt=False: see {_TODO_CK}")
        if not native.available():
            raise NotImplementedError(
                f"CIGARs without the native library: see {_TODO_CK}"
            )
        stats, out, buckets = self._cost_batch(pairs)
        results: list = [None] * len(pairs)
        for idx in np.flatnonzero(out >= 0):
            a, b = pairs[idx]
            results[idx] = (int(out[idx]), _trivial_cigar(a, b))
        trace_jobs: list = []
        rungs = [self._rung_start(pairs, self._new_ladder(pairs, bucket), stats,
                                  trace_jobs)
                 for bucket in buckets]
        return pairs, out, results, stats, trace_jobs, rungs

    def _align_dispatch_finish(self, state):
        """Certify every in-flight rung (running retries synchronously) and
        stage the certified pairs' traces; returns ``(results, stats,
        trace_jobs)`` and leaves the flush to the caller."""
        pairs, out, results, stats, trace_jobs, rungs = state
        self._cost_finish(pairs, stats, out, rungs)
        return results, stats, trace_jobs

    def _flush_traces(self, trace_jobs: list, pairs, results) -> None:
        """Run the staged direct traces, one multi-threaded native call per
        rung (the jobs of a rung share its schedule).  Clears ``trace_jobs``."""
        groups: dict[int, list] = {}
        for job in trace_jobs:
            groups.setdefault(id(job.shift), []).append(job)
        for jobs in groups.values():
            res = native.trace_direct_batch(
                [pairs[j.pair] for j in jobs], jobs[0].s_words,
                jobs[0].shift, jobs[0].sw, [j.want for j in jobs],
            )
            for job, (cost, cigar) in zip(jobs, res):
                results[job.pair] = (cost, cigar)
        trace_jobs.clear()


class _Readback:
    """A (B,) device result on its way to the host: the copy into pinned
    memory is queued without synchronising, and :meth:`numpy` waits for an
    event recorded after it.  CPU results are already there."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


@dataclass
class _TraceJob:
    """One direct whole-pair DT trace: the pair, its certifying rung's
    schedule and the certified cost it is traced from."""

    pair: int
    shift: np.ndarray
    s_words: int
    sw: int
    want: int


def _trivial_cigar(a: bytes, b: bytes) -> Cigar:
    cigar = Cigar()
    if len(a):
        cigar.push(CigarOp.DEL, len(a))
    if len(b):
        cigar.push(CigarOp.INS, len(b))
    return cigar


def _buckets(pairs, idxs: list[int], growth: float = 1.5) -> list[list[int]]:
    """Group pair indices into shape buckets: geometric n-classes bound the
    padding waste by ``growth``; pairs with m > W*n (no one-shift-per-column
    schedule) go to singleton buckets that run at full height."""
    by_class: dict[tuple[int, int], list[int]] = {}
    for i in idxs:
        a, b = pairs[i]
        ncls = 0
        size = 64
        while size < len(a):
            size = int(size * growth) + 1
            ncls += 1
        skew = 0 if len(b) <= W * max(1, len(a)) else 1
        by_class.setdefault((ncls, skew), []).append(i)
    out = []
    for (_, skew), members in sorted(by_class.items()):
        if skew:
            out.extend([[i] for i in members])
        else:
            out.append(members)
    return out
