"""Batch/streaming alignment runtime of the port: the performance product.

Counterpart of ``astarpa_tpu/parallel/runner.py``.  Pairs are bucketed by
shape, packed into pair-minor planes on the device, run through the banded
kernels (:mod:`..ops.banded_kernel`) and certified per pair; uncertified
pairs retry at the band their banded upper bound predicts.

- Shared band ladder (buckets below ``domain_min_bp``, or every bucket
  with ``domain_mode="off"``): K1 for costs (on the card a ring of
  resident words, a few lanes a pair); on the align path K1 when
  every cost a rung can certify fits the native direct-trace budget
  (CIGARs by direct whole-pair DT traces), else K2 (on the card K1's
  ring writing K2's checkpoint rows), whose window checkpoints feed the
  native ``trace_banded_ck``.  Bands of at least
  :data:`STRIPED_MIN_SW` words run the big-band kernels instead.  For
  costs (and the direct-trace align rungs) that is one pass over a ring
  of resident words up to the ring's 16384 words
  (:func:`..ops.banded_kernel.pinned_cost_takes`): K7, whose slots are
  all in registers, up to 4096 live words, the wide ring (further slots
  in shared memory) past them; K5, whose stripes take any height, runs
  taller bands, which no configuration reaches (K7 beat K5 at every band
  of 64 to 4096 words measured on the card, so the reference's
  ``PINNED_MIN_SW`` and ``PINNED_MAX_SW`` band range is not copied).  For checkpoints it is K6 when ``SW % 8 ==
  0`` and ``CB >= SW + 8`` (their planes have SW+8 rows, which the
  native trace reads as they are; ring K6 up to the ring's 4096 words,
  the stripe kernel past them), else K8, K5's DP writing K2's plane
  contract at any SW (a full height S off the 8-grain; a skewed bucket's
  ``CB = n_max < SW``; ring K8 up to the ring's 4096 words, the stripe
  kernel past them).
- Per-pair domain ladder (``domain_mode`` resolving to "gap"/"gcsh"): an f
  ladder over per-pair schedules that follow each pair's domain hull.  A
  round of at least :data:`PINNED_PP_MIN_SW` words runs the pinned
  per-pair kernels (K9 for costs, ring K9 up to the ring's 4096 words;
  K10 for checkpoint traces, ring K10 up to the ring's 4096 words), a
  smaller one K4 (cost mode, or ck mode; on the card K1's ring on
  per-pair event rows, the old K4 for an interval the ring refuses).

CIGARs take one of two routes, chosen by :attr:`BatchAligner.combined`
(the reference chooses by backend, ``runner.py:962-985``):

- ``combined=True`` (the default; the reference's ``_align_combined``, its
  TPU route): the align rungs and rounds above, each certifying costs and
  staging its certified pairs' traces (direct DT traces, or checkpoint
  traces from K2/K4/K6/K8/K10).
- ``combined=False`` (the reference's route on every other backend): the
  cost ladder, then :meth:`BatchAligner._trace_bucket` per bucket: direct
  DT traces for certified costs within the native burst budget; for bands
  of more than 64 words the host arm (native A* at moderate divergence, the
  block aligner :mod:`..aligners.astarpa2` above it); else the fill arm, K3
  (:func:`..ops.banded_kernel.banded_fill`: every column's window planes)
  and a native ``trace_banded`` per pair (on the card K3 is K1's ring
  storing every column's window, pair-major, so the planes are read back
  without a transpose).  The reference's checkpoint arm
  of ``_trace_bucket`` is not ported: it runs only on the reference's TPU
  backend (or in interpret mode), where the port's combined route serves.

Without the native library both routes end in
:meth:`BatchAligner._align_host_fallback` (the block aligner on every pair,
after the cost ladder), as the reference's do.

The ladder arithmetic (rounding, repack rule, cell counts, warm band
hints, sticky diagonal, full-height clamp, f feedback) is the reference's,
verbatim, so ``BatchStats`` match it field for field.

Port decision: the reference gates the ck and per-pair kernels on TPU
VMEM models (``_select_pp``, ``_striped_ck_ok``'s backend and lane
checks, the ``PINNED_*`` VMEM and ``B % 128`` conditions, the domain
ladder's ``pp < 128`` break and its ``except ValueError`` fallbacks).  The
CUDA kernels keep their state in device memory and have no such ceiling,
so none of those gates is copied: the routing rules are
:data:`STRIPED_MIN_SW` and :data:`PINNED_PP_MIN_SW`, both measured on the
card, and K7's ring capacity; a kernel that fails raises, and the domain
ladder breaks only when its band reaches full height or its rounds run
out.

Several devices (:attr:`BatchAligner.mesh`, the reference's 1-D ``batch``
mesh): each bucket is packed once on the host, padded so that every shard
gets the same whole number of ``lane_multiple`` lanes (pad pairs ``n = m =
1``), and cut into contiguous lane ranges, one a device, as the
reference's ``P(None, "batch")`` does.  The shared schedule and the
diagonal come from the whole bucket, so every shard runs the same rung or
round through the same wrapper and routing, each on its own CUDA stream;
per-pair schedules and checkpoints split with their pairs, and the results
are joined on the pair axis on the host.  The reference's VMEM gates for a
mesh (``_mesh_ck_kind``, ``_select_pp``'s per-shard batch) are not copied,
for the reason above.  The fill arm of ``combined=False`` runs on the
first device, unsharded, as the reference's does.
"""

from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from .. import native
from ..aligners.astarpa2 import AstarPa2Params
from ..device import resolve_device
from ..domain import domain_schedule, gap_domain
from ..ops import banded, striped
from ..ops.banded_kernel import (banded_ck, banded_ck_pp, banded_cost,
                                 banded_cost_pp, banded_fill, k2_kernel, k4_kernel,
                                 pinned_ck, pinned_ck_kernel, pinned_ck_pp, pinned_cost,
                                 pinned_cost_kernel, pinned_cost_words,
                                 pinned_cost_pp, pinned_cost_takes, ring_takes, route,
                                 striped_ck, striped_cost)
from ..ops.bitpack import W, n_words
from ..ops.pack import HostPack, pack_batch_staggered
from ..ops.words import to_tensor
from ..types import Cigar, CigarOp
from ..utils.spans import span

INF = 1 << 30

#: Shared-ladder rungs of at least this many words run the striped
#: kernels (K5 costs, K6 or K8 checkpoints) instead of the sliding ones
#: (K1, K2).
#: Set from the K1/K5 crossover that ``chip_smoke.py`` phase 12 measures on
#: the card (``PERF.md``); the reference's 640 is fitted to TPU VMEM.
#: Tests patch it to drive the striped arms at small sizes.
STRIPED_MIN_SW = 64

#: Domain-ladder rounds of at least this many words run the pinned
#: per-pair kernels (K9 costs, K10 checkpoints) instead of K4.  Set from
#: the K4/K9 crossover that ``chip_smoke.py`` measures on the card
#: (``PERF.md``); the reference's 512 is fitted to TPU VMEM.  Tests patch
#: it to drive either arm at small sizes.
PINNED_PP_MIN_SW = 64


@dataclass
class BatchStats:
    pairs: int = 0
    buckets: int = 0
    band_retries: int = 0
    cells_computed: int = 0
    aligned_bp: int = 0
    # Pairs whose CIGAR came from the direct whole-pair DT trace.
    direct_traces: int = 0
    # What ran the last rung, round or fill (a label of
    # ``banded_kernel.route``: "cuda-banded", "cuda-banded-ck",
    # "cuda-banded-fill", "cuda-banded-fill-pp", "cuda-banded-pp",
    # "cuda-banded-ck-pp", "cuda-striped", "cuda-striped-ck", "cuda-pinned",
    # "cuda-pinned-ck", "cuda-pinned-pp", "cuda-pinned-pp-ck", "cuda-ring-ck",
    # "cuda-ring-pp", "cuda-banded-ring", "cuda-ring-pp-ck",
    # "cuda-banded-ring-pp", "cuda-banded-ring-ck-pp", "cuda-banded-ring-fill",
    # or "torch-ref" on the CPU), set at dispatch.
    kernel: str | None = None


@dataclass
class BatchAligner:
    """Aligns many pairs data-parallel on one device, or split over the
    devices of :attr:`mesh`.

    Args:
      band_words: first band height in uint32 words (warm hints replace it).
      lane_multiple: batch padding granularity (a warp of pairs).
      mesh: None (one device), or a non-empty sequence of devices
        (``torch.device`` or strings), all CUDA or all ``"cpu"``; an entry
        may repeat (two ``"cuda:0"`` split a batch in two on one card, each
        shard on its own stream).  Every bucket's lanes split evenly over
        them; ``device`` defaults to the first and must equal it.
      max_band_doublings: rungs before the ladder clamps to full height.
      domain_mode: per-pair domain ladder for buckets of pairs >=
        ``domain_min_bp``: "gap" (the cost-f parallelogram), "gcsh" (the
        native fwd+rev GCSH hull), "auto" (gcsh with the native library on
        a host of >= 8 cores, else gap where the bucket is skewed) or "off".
      domain_k / domain_r: GCSH seed length and match cost of the hulls.
      max_f_rounds: domain-ladder rounds before the stragglers finish on
        the shared ladder.
      ck_col_block: checkpoint interval (columns) of the ck rungs and
        rounds; None = ``max(4096, band, n_max // 32)`` (see :meth:`_cb`).
      direct_dt: CIGARs by direct DT traces where the certified costs fit
        the native burst budget; False pins the checkpoint path (or, with
        ``combined=False``, the fill and host arms).
      combined: CIGARs from the align rungs themselves (True), or from the
        cost ladder followed by :meth:`_trace_bucket` (False): the
        reference's two routes, which it picks by backend
        (``runner.py:962-985``).  False is the reference-parity route
        that gives K3 its caller, not a faster choice.  Without the
        native library both end in :meth:`_align_host_fallback`.
      shape_quantum: padded-geometry quantum ("auto" as the reference).
      device: None or "cuda" (the card; raises without one) or "cpu" (the
        kernels' plain torch versions).

    Under a mesh every shard of a rung or round runs the kernel the whole
    bucket routes to, which ``BatchStats.kernel`` names.
    """

    band_words: int = 8
    lane_multiple: int = 32
    mesh: object = None
    max_band_doublings: int = 8
    domain_mode: str = "auto"
    domain_min_bp: int = 32768
    domain_k: int = 12
    domain_r: int = 2
    max_f_rounds: int = 10
    ck_col_block: int | None = None
    direct_dt: bool = True
    combined: bool = True
    shape_quantum: object = "auto"
    device: object = None
    # Warm-start band hints: bucket class -> the tightest band the last
    # bucket of that class needed.
    _band_hints: dict = field(default_factory=dict, repr=False)
    # Sticky diagonal aims per packed geometry (see _diag).
    _diag_hints: dict = field(default_factory=dict, repr=False)
    # Prefetched gcsh domain builds: (id(pairs), bucket) -> Future of the
    # handle list, submitted by the streaming runners at dispatch so the
    # builds (GIL-released native calls) overlap the previous batch.
    _domain_prefetch: dict = field(default_factory=dict, repr=False)
    _prefetch_ex: object = field(default=None, repr=False)

    def __post_init__(self):
        # (device, stream) of each shard: one device is a mesh of one that
        # runs on the device's current stream (stream None).
        if self.mesh is None:
            self.device = resolve_device(self.device)
            self._shards = [(self.device, None)]
            return
        devs = _mesh_devices(self.mesh)
        if self.device is not None:
            dev = torch.device(self.device)
            if dev.type != devs[0].type or resolve_device(dev) != devs[0]:
                raise ValueError(f"device {self.device!r} is not the mesh's first "
                                 f"device {devs[0]}")
        self.device = devs[0]
        self._shards = [(d, torch.cuda.Stream(device=d) if d.type == "cuda" else None)
                        for d in devs]

    def _pack(self, bucket_pairs) -> tuple["_Packed", int]:
        """Pack a bucket once on the host and split it into equal lane
        ranges, each uploaded and unpacked on its shard's device and
        stream (one range on :attr:`device` without a mesh)."""
        with span("pack"):
            quantum = self._shape_quantum(bucket_pairs)
            host = HostPack(bucket_pairs, len(self._shards) * self.lane_multiple, quantum)
            step = host.B // len(self._shards)
            parts, shards = [], []
            for k, (dev, stream) in enumerate(self._shards):
                shard = _Shard(dev, stream, k * step, (k + 1) * step)
                with shard.on():
                    parts.append(host.planes(shard.lo, shard.hi, dev)
                                 + (host.ns[shard.lo:shard.hi], host.ms[shard.lo:shard.hi]))
                shards.append(shard)
        return _Packed(parts, shards, host.ns, host.ms, host.n_max, host.S), len(bucket_pairs)

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

    def _cb(self, sw: int, n_max: int) -> int:
        """Checkpoint interval of a ck rung or round: ``ck_col_block``, or
        by default ``max(4096, sw, n_max // 32)``.  n_max/32 keeps the
        checkpoint count ~32 whatever the pair length: the readback
        shrinks as 1/CB while the native DT bursts stay flat in CB, and a
        certified distance d <= ~16*sw keeps each segment's distance
        d*CB/n <= sw/2 inside the burst budget.  At least sw+8 (K6's
        capture windows), rounded to 512 unless n_max clamps it (the
        reference's rounding, kept so CB matches)."""
        base = self.ck_col_block or max(4096, sw, n_max // 32)
        cb = max(base, sw + 8)
        cb = -(-cb // 512) * 512
        return min(cb, max(n_max, 1))

    def _resolve_domain_mode(self, pairs, idxs, want_cigars: bool) -> str | None:
        """"gap"/"gcsh" when the bucket runs the per-pair domain ladder, else
        None (the shared ladder).  "auto": gcsh on a host with the native
        library and >= 8 cores; gap otherwise, and only where the bucket's
        skew terms (what per-pair gap bands save) rival a ~6% divergence
        prior.  CIGARs need the native traces."""
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
        # The reference also asks for a TPU (or interpret mode) here; the
        # port's per-pair kernels run on the card and on the CPU route.
        if want_cigars and not native.available():
            return None
        return mode

    def _build_gcsh_handles(self, bucket_pairs):
        """Native fwd+rev GCSH domain builds for one bucket (GIL-released
        ctypes calls, parallel across pairs)."""
        workers = min(len(bucket_pairs), os.cpu_count() or 1)

        def build(ab):
            return native.DomainHandle(ab[0], ab[1], k=self.domain_k,
                                       r=self.domain_r)

        if workers > 1:
            with ThreadPoolExecutor(workers) as ex:
                return list(ex.map(build, bucket_pairs))
        return [build(ab) for ab in bucket_pairs]

    def _prefetch_domains(self, pairs, want_cigars: bool) -> None:
        """Submit the gcsh domain builds of ``pairs``' buckets to a
        background thread; :meth:`_domain_ladder` pops the matching future.
        The streaming runners call this at dispatch, so a batch's builds run
        while the previous batch's ladder and traces do."""
        todo = [i for i, (a, b) in enumerate(pairs) if len(a) and len(b)]
        for bucket in _buckets(pairs, todo):
            if self._resolve_domain_mode(pairs, bucket, want_cigars) != "gcsh":
                continue
            key = (id(pairs), tuple(bucket))
            if key in self._domain_prefetch:
                continue
            if self._prefetch_ex is None:
                self._prefetch_ex = ThreadPoolExecutor(1)
            self._domain_prefetch[key] = self._prefetch_ex.submit(
                self._build_gcsh_handles, [pairs[i] for i in bucket]
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
            mode = self._resolve_domain_mode(pairs, bucket, want_cigars=False)
            if mode:
                self._domain_ladder(pairs, bucket, out, stats, mode)
            else:
                self._run_bucket(pairs, bucket, out, stats)
        return self._cost_finish(pairs, stats, out, [])

    def cost_iter(self, batches):
        """Pipelined streaming costs: yields one ``(costs, stats)`` per input
        batch, in order.  Batch k+1 packs and launches its first rung (and
        starts its gcsh builds) while batch k's kernel runs; the sync happens
        at certification.  Domain ladders run at finish time."""
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
        with span("bucket"):
            stats = BatchStats(pairs=len(pairs))
            out = np.full(len(pairs), -1, dtype=np.int64)
            todo: list[int] = []
            for idx, (a, b) in enumerate(pairs):
                if len(a) == 0 or len(b) == 0:
                    out[idx] = len(a) + len(b)
                else:
                    todo.append(idx)
            buckets = _buckets(pairs, todo)
            stats.buckets = len(buckets)
        return stats, out, buckets

    def _dispatch_jobs(self, pairs, buckets, stats, trace_jobs=None) -> list:
        """Per bucket, ``(mode, bucket, rung)``: the first rung of a shared
        ladder dispatched now, or a domain ladder deferred to finish time
        with its gcsh builds started."""
        want_cigars = trace_jobs is not None
        jobs = []
        for bucket in buckets:
            mode = self._resolve_domain_mode(pairs, bucket, want_cigars)
            if mode:
                if mode == "gcsh":
                    self._prefetch_domains(pairs, want_cigars)
                jobs.append((mode, bucket, None))
            else:
                jobs.append((None, bucket, self._rung_start(
                    pairs, self._new_ladder(pairs, bucket), stats, trace_jobs
                )))
        return jobs

    def _cost_dispatch(self, pairs):
        with span("dispatch"):
            stats, out, buckets = self._cost_batch(pairs)
            return pairs, stats, out, self._dispatch_jobs(pairs, buckets, stats)

    def _cost_finish(self, pairs, stats, out, jobs, trace_jobs=None):
        with span("finish"):
            for mode, bucket, rung in jobs:
                if mode:
                    self._domain_ladder(pairs, bucket, out, stats, mode, trace_jobs)
                while rung is not None:
                    rung = self._rung_finish(pairs, out, stats, rung)
            stats.aligned_bp = sum(len(a) for a, _ in pairs)
        assert (out >= 0).all()
        return out, stats

    def _run_bucket(self, pairs, idxs, out, stats, trace_jobs=None) -> None:
        """The whole shared ladder of one bucket, synchronously; with
        ``trace_jobs`` its align form (the reference's ``_align_bucket_ck``):
        the certified pairs' traces are staged there."""
        rung = self._rung_start(pairs, self._new_ladder(pairs, idxs), stats,
                                trace_jobs)
        while rung is not None:
            rung = self._rung_finish(pairs, out, stats, rung)

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
        returns ``(packed, B0, members, n_max, S, diag)``."""
        if lad["packed"] is None or 2 * len(lad["pending"]) <= len(
            lad["packed"][2]
        ):
            packed, B0 = self._pack([pairs[i] for i in lad["pending"]])
            lad["packed"] = (packed, B0, list(lad["pending"]))
        packed, B0, members = lad["packed"]
        n_max, S = packed.n_max, packed.S
        diag = self._diag(packed.n, packed.m, B0, n_max, S)
        return packed, B0, members, n_max, S, diag

    def _rung_start(self, pairs, lad: dict, stats: BatchStats,
                    trace_jobs: list | None = None) -> dict:
        """Dispatch one band rung without synchronising: the kernel and the
        copy of its result to the host are queued; :meth:`_rung_finish`
        waits and certifies.  With ``trace_jobs`` (the align path) the rung
        runs the cost kernel when every cost it can certify fits the native
        direct-trace budget, else a ck kernel, whose checkpoints of every
        lane start streaming to the host now when they are small (the
        common case certifies them all).  Bands of at least
        :data:`STRIPED_MIN_SW` words run the big-band kernels, smaller ones
        K1/K2.  A cost rung of such a band runs K7 up to the ring's 4096
        words, K5 past it; a ck rung runs K6 (ring K6 up to the ring's 4096
        words, the stripe kernel past it), or K8 where K6 cannot take
        it (``sw % 8``, as at a full height S that is not a multiple of 8,
        or ``CB < sw + 8``, as where n_max clamps CB), whose interval
        contract (:func:`..ops.striped.pinned_ck_fits`) ``_cb`` always
        meets."""
        with span("rung_start"):
            packed, B0, members, n_max, S, diag = self._pack_rung(pairs, lad)
            n, m = packed.n[:B0], packed.m[:B0]
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
            ck = CB = opt_chunks = None
            if trace_jobs is not None:
                # A full-height rung is exact, so n+m bounds what it certifies.
                direct_cap = int(thr.max()) if thr is not None else int(n.max() + m.max())
                if not (self.direct_dt and direct_cap <= native.DIRECT_DT_MAX):
                    CB = self._cb(sw, n_max)
                    if sw >= STRIPED_MIN_SW and sw % 8 == 0 and CB >= sw + 8:
                        # The wrapper runs ring K6 where the ring holds the band.
                        kernel = striped_ck
                        name = "ring_ck" if ring_takes(sw) else "striped_ck"
                    elif sw >= STRIPED_MIN_SW and striped.pinned_ck_fits(n_max, sw, CB):
                        # The wrapper runs ring K8 where the ring holds the band.
                        kernel, name = pinned_ck, pinned_ck_kernel(sw)
                    else:
                        # The wrapper runs K2's ring where its cursor takes CB.
                        kernel, name = banded_ck, k2_kernel(n_max, sw, CB)
                    got = packed.each(lambda args, _: _split_ck(kernel(*args, sw, CB, diag)))
                    stats.kernel = route(self.device, name)
                    costs, ck = _Cat([c for c, _ in got]), [x for _, x in got]
                    if _ck_bytes(ck[0]) * len(members) <= _OPT_READBACK_BYTES:
                        opt_chunks = packed.stage_lanes(ck, len(members))
            if ck is None:
                ring = ()
                if run_sw >= STRIPED_MIN_SW and pinned_cost_takes(run_sw):
                    # Every shard runs the ring design of the whole bucket (K7
                    # or the wide ring), whatever its own pairs' span, so the
                    # label names what ran: (ring_words, thread_words).
                    ring = (None, pinned_cost_words(n_max, S, run_sw, diag, packed.n))
                    kernel = pinned_cost
                    name = pinned_cost_kernel(n_max, S, run_sw, diag, packed.n)
                elif run_sw >= STRIPED_MIN_SW:
                    kernel, name = striped_cost, "striped_cost"
                else:
                    kernel, name = banded_cost, "banded_ring"
                costs = _Cat(packed.each(
                    lambda args, _: _Readback(kernel(*args, run_sw, diag, *ring))))
                stats.kernel = route(self.device, name)
            stats.cells_computed += n_max * sw * W * len(members)
            return dict(lad=lad, costs=costs, sw=sw, S=S, thr=thr, diag=diag,
                        trace_jobs=trace_jobs, ck=ck, CB=CB, opt_chunks=opt_chunks)

    def _rung_finish(self, pairs, out, stats: BatchStats, rung: dict):
        """Wait for and certify one rung, staging its certified pairs'
        traces on the align path; returns the next in-flight rung (retry at
        a wider band) or None when the bucket is done."""
        with span("rung_finish"):
            lad = rung["lad"]
            packed, B0, members = lad["packed"]
            n, m = packed.n, packed.m
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
                shift = banded.shift_at_array(packed.n_max, S, sw, diag)
                if rung["ck"] is None:
                    stats.direct_traces += len(ok_slots)
                    trace_jobs.extend(
                        _TraceJob(pair=members[slot], slices=None, pos=0,
                                  shift=shift, s_words=S, sw=sw, cb=0,
                                  want=int(costs[slot]))
                        for slot in ok_slots
                    )
                else:
                    # Without the optimistic copies, gather only the certified
                    # lanes on the device before they cross to the host.
                    chunks = rung["opt_chunks"] or packed.stage_slots(rung["ck"], ok_slots)
                    for pos, slot in enumerate(ok_slots):
                        p = slot if rung["opt_chunks"] else pos
                        c0, sl = _chunk_of(chunks, p)
                        trace_jobs.append(_TraceJob(
                            pair=members[slot], slices=sl, pos=p - c0, shift=shift,
                            s_words=S, sw=sw, cb=rung["CB"], want=int(costs[slot]),
                        ))
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

    # -- per-pair domain ladder ------------------------------------------------

    def _domain_ladder(self, pairs, idxs, out, stats, mode: str = "gcsh",
                       trace_jobs: list | None = None) -> None:
        """f ladder over domain-restricted per-pair bands: sample each
        pair's domain hull at its own f, run one per-pair kernel pass for
        the bucket (:meth:`_domain_kernel`), accept pairs whose banded
        result is <= their f (the doubling certificate), and feed the
        rejected pairs' banded upper bounds back as their next f.  With
        ``trace_jobs`` (the align path) a round whose f all fit the
        direct-trace budget runs the cost kernel and stages direct traces,
        else the ck kernel and stages checkpoint traces.  Stragglers finish
        on the shared ladder."""
        bucket_pairs = [pairs[i] for i in idxs]
        packed, B0 = self._pack(bucket_pairs)
        n_max, S, B = packed.n_max, packed.S, packed.B
        step = 64 if n_max <= 200_000 else 128
        if mode == "gcsh":
            fut = self._domain_prefetch.pop((id(pairs), tuple(idxs)), None)
            handles = fut.result() if fut is not None else (
                self._build_gcsh_handles(bucket_pairs))
        else:
            handles = [_GapDomainProvider(a, b) for a, b in bucket_pairs]
        ck_mode = trace_jobs is not None
        try:
            # First-round f: h0 plus ~25% for gcsh (unpruned GCSH
            # underestimates d by ~10-20% at high divergence, and the hull
            # at 1.25*h0 is about as wide as the exact-f hull); gap domains
            # carry their own divergence allowance in h0.
            pad = (lambda h0: h0 + h0 // 4) if mode == "gcsh" else (lambda h0: h0)
            f = np.array([max(pad(h.h0), 2 * W) for h in handles], np.int64)
            pending = list(range(B0))
            for _ in range(self.max_f_rounds):
                with span("domain_round"):
                    scheds = {}
                    sw_need = 1
                    quantum = 32
                    for slot in pending:
                        ps = None
                        while ps is None:
                            ps = domain_schedule(handles[slot].sample(int(f[slot]), step))
                            if ps is None:
                                # Empty domain: certainly dist > f.
                                f[slot] += max(f[slot] // 4, 64)
                        scheds[slot] = ps
                        sw_need = max(sw_need, ps.band_words)
                        quantum = min(quantum, ps.quantum)
                    # Quantize the band (pow2 up to 64, then multiples of 64).
                    sw = sw_need
                    if sw <= 64:
                        p = 4
                        while p < sw:
                            p *= 2
                        sw = p
                    else:
                        sw = -(-sw // 64) * 64
                    sw = min(sw, S)
                    # Direct round: every pair it certifies costs <= f <= the
                    # burst budget, so K4 runs in cost mode.
                    direct_rnd = (
                        ck_mode and self.direct_dt
                        and int(max(f[slot] for slot in pending)) <= native.DIRECT_DT_MAX
                    )
                    if sw >= S:
                        break  # band no longer thin; the shared ladder is better
                    sched_arr = np.zeros((n_max, B), np.uint8)
                    for slot in pending:
                        sc = scheds[slot].sched
                        sched_arr[: len(sc), slot] = sc
                    # Idle lanes (padding and certified pairs) take a live
                    # pair's schedule, as the reference does; their results are
                    # ignored.
                    fill = scheds[pending[0]].sched
                    idle = np.ones(B, bool)
                    idle[np.asarray(pending)] = False
                    if idle.any():
                        sched_arr[: len(fill), idle] = fill[:, None]
                    want_ck = ck_mode and not direct_rnd
                    got, name = self._domain_kernel(packed, sw, sched_arr, quantum,
                                                    want_ck)
                    stats.kernel = route(self.device, name)
                    costs = _Cat([c for c, _ in got]).numpy()[:B0]
                    ck = [x for _, x in got]
                    stats.cells_computed += n_max * sw * W * len(pending)
                    done = [
                        slot for slot in pending
                        if costs[slot] <= f[slot] and costs[slot] < INF // 2
                    ]
                    if done and direct_rnd:
                        stats.direct_traces += len(done)
                        for slot in done:
                            sc = np.ascontiguousarray(scheds[slot].sched, np.int32)
                            trace_jobs.append(_TraceJob(
                                pair=idxs[slot], slices=None, pos=0, shift=sc,
                                s_words=S, sw=sw, cb=0, want=int(costs[slot]),
                            ))
                    elif done and want_ck:
                        chunks = packed.stage_slots(ck, done)
                        CB = banded.ck_col_block(self._cb(sw, n_max), n_max, quantum)
                        for pos, slot in enumerate(done):
                            sc = np.ascontiguousarray(scheds[slot].sched, np.int32)
                            c0, sl = _chunk_of(chunks, pos)
                            trace_jobs.append(_TraceJob(
                                pair=idxs[slot], slices=sl, pos=pos - c0, shift=sc,
                                s_words=S, sw=sw, cb=CB, want=int(costs[slot]),
                            ))
                    for slot in done:
                        out[idxs[slot]] = int(costs[slot])
                    done_set = set(done)
                    pending = [s for s in pending if s not in done_set]
                    if not pending:
                        return
                    stats.band_retries += 1
                    for slot in pending:
                        ub = int(costs[slot])
                        nxt = max(int(f[slot] * 5 // 4) + 1, f[slot] + 64)
                        if ub < INF // 2:
                            nxt = max(nxt, ub)
                        f[slot] = nxt
            # Rounds exhausted or the band reached full height: finish the
            # stragglers on the always-converging shared ladder.
            self._run_bucket(pairs, [idxs[s] for s in pending], out, stats,
                             trace_jobs)
        finally:
            for h in handles:
                h.close()

    def _domain_kernel(self, packed, sw: int, sched_arr, quantum: int,
                       want_ck: bool):
        """One domain round on every shard: ``(got, name)``, ``got`` a
        ``(costs, ck)`` a shard (the costs' :class:`_Readback`; with
        ``want_ck`` the shard's ``(ck_vp, ck_vm, ck_tv)`` with checkpoints
        every :meth:`_cb` columns rounded to whole quantum groups, K4's
        contract, which K10 keeps, else None); ``name`` is the kernel that
        ran (its launch key).  Each shard takes its pairs' columns of
        ``sched_arr``.  Rounds of
        at least :data:`PINNED_PP_MIN_SW` words run K9 (ring K9 up to the
        ring's 4096 words, the stripe kernel past it) or K10 (ring K10 up
        to the ring's 4096 words, the stripe kernel past it), smaller ones
        K4 (its ring, or the old K4 for an interval the ring refuses:
        :func:`..ops.banded_kernel.k4_kernel`)."""
        n_max = packed.n_max
        pinned = sw >= PINNED_PP_MIN_SW
        if want_ck:
            CB = self._cb(sw, n_max)
            extra = (sw, CB, quantum)
            if pinned:
                # The wrapper runs ring K10 where the ring holds the band.
                kernel = pinned_ck_pp
                name = "ring_ck_pp" if ring_takes(sw) else "pinned_ck_pp"
            else:
                kernel, name = banded_ck_pp, k4_kernel(n_max, sw, CB, quantum)
        else:
            extra = (sw, quantum)
            if pinned:
                # The wrapper runs ring K9 where the ring holds the band.
                kernel = pinned_cost_pp
                name = "ring_cost_pp" if ring_takes(sw) else "pinned_cost_pp"
            else:
                kernel, name = banded_cost_pp, k4_kernel(n_max, sw)

        def launch(args, shard):
            got = kernel(*args, np.ascontiguousarray(sched_arr[:, shard.lo:shard.hi]),
                         *extra)
            return _split_ck(got) if want_ck else (_Readback(got), None)

        return packed.each(launch), name

    # -- CIGAR path ------------------------------------------------------------

    def align(self, pairs) -> list[tuple[int, Cigar]]:
        return self.align_with_stats(pairs)[0]

    def align_with_stats(self, pairs) -> tuple[list[tuple[int, Cigar]], BatchStats]:
        """Costs and CIGARs.  With :attr:`combined` each rung or domain
        round certifies costs on the device, and its certified pairs are
        traced on the host (direct DT traces from the certified costs, or
        checkpoint traces).  Otherwise the cost ladder runs first and
        :meth:`_trace_bucket` traces each bucket from the certified costs.
        Without the native library: :meth:`_align_host_fallback`."""
        if native.available() and self.combined:
            results, stats, trace_jobs = self._align_dispatch_finish(
                self._align_dispatch_start(pairs)
            )
            self._flush_traces(trace_jobs, pairs, results)
            return results, stats

        costs, stats = self.cost_with_stats(pairs)
        if not native.available():
            return self._align_host_fallback(pairs, costs), stats
        results: list = [None] * len(pairs)
        todo = []
        for idx, (a, b) in enumerate(pairs):
            if len(a) == 0 or len(b) == 0:
                results[idx] = (int(costs[idx]), _trivial_cigar(a, b))
            else:
                todo.append(idx)
        for bucket in _buckets(pairs, todo):
            self._trace_bucket(pairs, bucket, costs, results, stats)
        return results, stats

    def align_iter(self, batches):
        """Pipelined streaming alignment: yields one ``(results, stats)`` per
        input batch, in order.  Batch k+1 is dispatched before batch k is
        certified, and batch k's traces run on a side thread while batch
        k+1 certifies and k+2 dispatches; yields trail the input by up to
        two batches.  Without :attr:`combined` or the native library, each
        batch runs :meth:`align_with_stats` in turn."""
        if not (native.available() and self.combined):
            for pairs in batches:
                yield self.align_with_stats(pairs)
            return
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
        """Pack and dispatch the first rung of every shared-ladder bucket,
        nothing synchronised, and start the gcsh builds of the domain
        buckets; :meth:`_align_dispatch_finish` certifies."""
        with span("dispatch"):
            stats, out, buckets = self._cost_batch(pairs)
            results: list = [None] * len(pairs)
            for idx in np.flatnonzero(out >= 0):
                a, b = pairs[idx]
                results[idx] = (int(out[idx]), _trivial_cigar(a, b))
            trace_jobs: list = []
            jobs = self._dispatch_jobs(pairs, buckets, stats, trace_jobs)
        return pairs, out, results, stats, trace_jobs, jobs

    def _align_dispatch_finish(self, state):
        """Certify every in-flight rung (running retries and domain ladders
        synchronously) and stage the certified pairs' traces; returns
        ``(results, stats, trace_jobs)`` and leaves the flush to the
        caller."""
        pairs, out, results, stats, trace_jobs, jobs = state
        self._cost_finish(pairs, stats, out, jobs, trace_jobs)
        return results, stats, trace_jobs

    def _flush_traces(self, trace_jobs: list, pairs, results) -> None:
        """Run the staged traces on a thread pool of the host's cores.
        Direct jobs run one native batch call per schedule (a shared rung's
        jobs share theirs; a domain round's jobs each have their own);
        checkpoint jobs run one native call each once their chunk's copy
        has arrived (chunks are taken in staging order, and the native
        calls and the waits release the GIL).  Clears ``trace_jobs``."""
        if not trace_jobs:
            return

        def run(job: _TraceJob, vp, vm, tv):
            a, b = pairs[job.pair]
            # known_cost: the device ladder certified this pair's distance,
            # so the trace skips its final-stripe recompute; the segment
            # landing checks against the checkpoints still verify the path.
            with span("trace"):
                cost, cigar = native.trace_banded_ck(
                    a, b, job.s_words, vp[:, :, job.pos], vm[:, :, job.pos],
                    tv[:, job.pos], job.shift, job.sw, job.cb,
                    known_cost=job.want,
                )
            return [(job.pair, cost, cigar)]

        def run_direct(jobs: list):
            with span("trace"):
                res = native.trace_direct_batch(
                    [pairs[j.pair] for j in jobs], jobs[0].s_words,
                    jobs[0].shift, jobs[0].sw, [j.want for j in jobs],
                )
            return [(j.pair, c, cig) for j, (c, cig) in zip(jobs, res)]

        with span("flush_traces"):
            groups: dict[int, list] = {}
            for job in trace_jobs:
                key = id(job.shift) if job.slices is None else id(job.slices)
                groups.setdefault(key, []).append(job)
            futures = []
            with ThreadPoolExecutor(max(1, min(len(trace_jobs), os.cpu_count() or 1))) as ex:
                for jobs in groups.values():
                    if jobs[0].slices is None:
                        futures.append(ex.submit(run_direct, jobs))
                        continue
                    vp, vm, tv = jobs[0].slices.numpy()
                    vp, vm = vp.view(np.uint32), vm.view(np.uint32)
                    futures.extend(ex.submit(run, job, vp, vm, tv) for job in jobs)
                for fut in futures:
                    for i, cost, cigar in fut.result():
                        results[i] = (cost, cigar)
            trace_jobs.clear()

    def _trace_bucket(self, pairs, idxs, costs, results, stats: BatchStats) -> None:
        """CIGARs of one bucket from its certified costs (the reference's
        ``_trace_bucket``, ``runner.py:1579-1704``, without its TPU-only
        checkpoint arm).  Costs within the native burst budget trace
        directly; the rest repack at the least band that certifies them
        all: above 64 words each pair runs on the host (native A* when
        ``cost * 12 < min(n, m)``, else the block aligner), else K3 fills
        every column's window planes, which cross to the host once, and
        ``native.trace_banded`` traces each pair from them.  A trace whose
        cost differs from the certified one raises."""
        if self.direct_dt:
            direct_idx = [i for i in idxs if costs[i] <= native.DIRECT_DT_MAX]
            if direct_idx:
                ns = np.array([len(pairs[i][0]) for i in direct_idx], np.int32)
                ms = np.array([len(pairs[i][1]) for i in direct_idx], np.int32)
                n_max = max(8, int(ns.max()))
                S = max(1, n_words(int(ms.max())))
                diag = self._diag(ns, ms, len(direct_idx), n_max, S)
                sw = self._certifying_band([costs[i] for i in direct_idx], ns, ms, S, diag)
                if sw > 64:
                    sw = min(-(-sw // 8) * 8, S)
                shift = banded.shift_at_array(n_max, S, sw, diag)
                jobs = [
                    _TraceJob(pair=i, slices=None, pos=0, shift=shift,
                              s_words=S, sw=sw, cb=0, want=int(costs[i]))
                    for i in direct_idx
                ]
                self._flush_traces(jobs, pairs, results)
                idxs = [i for i in idxs if costs[i] > native.DIRECT_DT_MAX]
                if not idxs:
                    return

        bucket_pairs = [pairs[i] for i in idxs]
        args, B0 = pack_batch_staggered(
            bucket_pairs, self.lane_multiple,
            shape_quantum=self._shape_quantum(bucket_pairs), device=self.device,
        )
        n, m = args[4], args[5]
        n_max, S = args[0].shape[0], args[2].shape[0]
        diag = self._diag(n, m, B0, n_max, S)
        sw = self._certifying_band([costs[i] for i in idxs], n[:B0], m[:B0], S, diag)
        if sw > 64:
            # Too tall for the fill's planes: exact per-pair traces on the
            # host, native A* at moderate divergence, the band-doubling
            # block aligner where A*'s open set would explode.
            block_aligner = None
            for i in idxs:
                a, b = pairs[i]
                if int(costs[i]) * 12 >= min(len(a), len(b)):
                    if block_aligner is None:
                        block_aligner = replace(AstarPa2Params.simple(),
                                                device=self.device).make_aligner(True)
                    cost, cigar = block_aligner.align(a, b)
                else:
                    cost, cigar = native.astarpa_native(a, b)
                _check_trace(cost, costs[i])
                results[i] = (cost, cigar)
            return
        shift = banded.shift_at_array(n_max, S, sw, diag)
        _, vp_cols, vm_cols = banded_fill(*args, sw, diag)
        stats.kernel = route(self.device, "banded_ring_fill")
        # The real lanes only, pair-major so that each pair's planes are
        # one contiguous block, into pinned host memory in one copy (the
        # card's fill stores them so: no transpose there).
        vp_h, vm_h = (x.view(np.uint32) for x in _Readback(*(
            x[:, :, :B0].permute(2, 0, 1).contiguous() for x in (vp_cols, vm_cols)
        )).numpy())
        del vp_cols, vm_cols
        lo = np.cumsum(shift).astype(np.int32)  # top word after col i's shift

        def run(slot: int, i: int):
            a, b = pairs[i]
            cost, cigar = native.trace_banded(a, b, vp_h[slot, :len(a)],
                                              vm_h[slot, :len(a)], lo[:len(a)], sw)
            _check_trace(cost, costs[i])
            return i, cost, cigar

        with ThreadPoolExecutor(max(1, min(len(idxs), os.cpu_count() or 1))) as ex:
            for i, cost, cigar in ex.map(run, range(len(idxs)), idxs):
                results[i] = (cost, cigar)

    def _certifying_band(self, want, n, m, S: int, diag) -> int:
        """The least doubling of the start band whose threshold certifies
        every cost in ``want`` (at most the full height S)."""
        want = np.asarray(want)
        sw = min(self.band_words, S)
        while sw < S and not (want <= banded.band_threshold(sw, n, m, *diag)).all():
            sw *= 2
        return min(sw, S)

    def _align_host_fallback(self, pairs, costs) -> list[tuple[int, Cigar]]:
        """CIGARs without the native library: the block aligner
        (``AstarPa2Params.simple()``, its block DP in torch on this
        aligner's device) on every pair, held to the certified costs."""
        aligner = replace(AstarPa2Params.simple(), device=self.device).make_aligner(True)
        results = []
        for (a, b), c in zip(pairs, costs):
            cost, cigar = aligner.align(a, b)
            _check_trace(cost, c)
            results.append((cost, cigar))
        return results


def _mesh_devices(mesh) -> list[torch.device]:
    """The mesh's devices, checked: a non-empty sequence, all CUDA (each
    resolved as :func:`..device.resolve_device` does) or all CPU."""
    try:
        devs = [torch.device(d) for d in mesh]
    except (TypeError, RuntimeError) as e:
        raise ValueError(f"mesh must be a sequence of devices, got {mesh!r}") from e
    if not devs:
        raise ValueError("mesh: no devices")
    kinds = {d.type for d in devs}
    if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError(f"mesh devices must be all CUDA or all 'cpu', got {sorted(kinds)}")
    return [resolve_device(d) for d in devs]


@dataclass
class _Shard:
    """One device's share of a packed bucket: lanes ``lo:hi`` on ``device``,
    run on ``stream`` (None: the device's current stream)."""

    device: torch.device
    stream: object
    lo: int
    hi: int

    @contextlib.contextmanager
    def on(self):
        """The shard's device and stream as the current ones: uploads,
        launches and readbacks queue on its stream, and the caching
        allocator keeps its tensors to that stream."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield


@dataclass
class _Packed:
    """A packed bucket: host lengths ``n``/``m`` (B,) and the geometry, and
    the planes as one part a shard, ``parts[k] = (a0, a1, pb0, pb1, n, m)``
    holding lanes ``shards[k].lo:hi``."""

    parts: list
    shards: list
    n: np.ndarray
    m: np.ndarray
    n_max: int
    S: int

    @property
    def B(self) -> int:
        return len(self.n)

    def each(self, fn) -> list:
        """``fn(args, shard)`` on every shard, on its device and stream."""
        out = []
        for args, shard in zip(self.parts, self.shards):
            with shard.on():
                out.append(fn(args, shard))
        return out

    def stage_lanes(self, cks, lanes: int) -> list:
        """:func:`_stage_ck_chunks` of the bucket's first ``lanes`` lanes,
        each shard's on its stream; chunk ranges are bucket lanes."""
        chunks = []
        for ck, shard in zip(cks, self.shards):
            k = min(shard.hi, lanes) - shard.lo
            if k > 0:
                with shard.on():
                    chunks += [(c0 + shard.lo, c1 + shard.lo, sl)
                               for c0, c1, sl in _stage_ck_chunks(*ck, k)]
        return chunks

    def stage_slots(self, cks, slots) -> list:
        """The checkpoints of lanes ``slots`` (ascending) only, gathered on
        each shard's device and staged; chunk ranges are positions in
        ``slots``."""
        slots = np.asarray(slots, np.int64)
        chunks, base = [], 0
        for ck, shard in zip(cks, self.shards):
            local = slots[(slots >= shard.lo) & (slots < shard.hi)] - shard.lo
            if len(local):
                with shard.on():
                    part = _stage_ck_chunks(*_gather_lanes(ck, local), len(local))
                chunks += [(c0 + base, c1 + base, sl) for c0, c1, sl in part]
                base += len(local)
        return chunks


def _split_ck(got) -> tuple:
    """A ck wrapper's ``(costs, ck_vp, ck_vm, ck_tv)`` as the costs'
    :class:`_Readback` and the checkpoint set."""
    return _Readback(got[0]), tuple(got[1:])


class _Cat:
    """One result's shard readbacks, joined on the pair axis (the last)
    on the host."""

    def __init__(self, parts: list):
        self.parts = parts

    def numpy(self):
        arrs = [p.numpy() for p in self.parts]
        return arrs[0] if len(arrs) == 1 else np.concatenate(arrs, axis=-1)


def _check_trace(cost: int, certified) -> None:
    """A trace must land on the certified cost (the reference asserts it)."""
    if cost != certified:
        raise RuntimeError(f"device cost {certified} != trace cost {cost}")


class _Readback:
    """Device results on their way to the host: the copies into pinned
    memory are queued without synchronising, and :meth:`numpy` waits for
    one event recorded after them.  CPU results are already there."""

    def __init__(self, *ts: torch.Tensor):
        self.event = None
        if ts[0].device.type == "cuda":
            self.host = [_pinned_like(t) for t in ts]
            for h, t in zip(self.host, ts):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(ts[0].device))
        else:
            self.host = list(ts)

    def numpy(self):
        """The array, or the list of arrays when several were copied."""
        with span("readback_wait"):
            if self.event is not None:
                self.event.synchronize()
        arrs = [h.numpy() for h in self.host]
        return arrs[0] if len(arrs) == 1 else arrs


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    """An empty pinned host tensor of ``t``'s shape and dtype (torch's
    caching host allocator hands back freed blocks)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


@dataclass
class _TraceJob:
    """One staged trace: the pair, its certifying rung's or round's
    schedule, and the certified cost it is traced from.  ``slices`` is the
    checkpoint chunk (a :class:`_Readback` of ``(ck_vp, ck_vm, ck_tv)``)
    holding the pair's checkpoints at lane ``pos``; ``None`` marks a direct
    whole-pair DT trace."""

    pair: int
    slices: _Readback | None
    pos: int
    shift: np.ndarray
    s_words: int
    sw: int
    cb: int
    want: int


# Chunks of ~2 MB let the traces of chunk k overlap the copy of chunk k+1.
_CHUNK_TARGET_BYTES = 2 * 2**20
# Ceiling for the optimistic readback of every lane's checkpoints before
# certification; a failed rung wastes at most this many bytes of copy.
_OPT_READBACK_BYTES = 8 * 2**20


# Checkpoint sets ``(ck_vp, ck_vm, ck_tv)`` share one shape rule, whatever
# kernel wrote them: the lane (pair) axis is the last axis of each array;
# planes are (n_ck, rows, B) with rows = SW (K2, K4, K8, K10) or SW + 8
# (K6's 8-aligned-top rows), top values (n_ck, B).  The helpers below only ever
# cut that axis, and the native trace infers the row layout from the rows.


def _ck_bytes(ck) -> int:
    """Checkpoint bytes per lane of a checkpoint set."""
    return 4 * sum(x.numel() for x in ck) // max(1, ck[0].shape[-1])


def _gather_lanes(ck, slots) -> tuple:
    """The checkpoints of lanes ``slots`` only, gathered on the device."""
    idx = to_tensor(np.asarray(slots, np.int64), ck[0].device)
    return tuple(x.index_select(x.dim() - 1, idx) for x in ck)


def _stage_ck_chunks(ckvp, ckvm, cktv, lanes: int):
    """Split the first ``lanes`` lanes of a checkpoint set into lane ranges
    and queue each range's copy to pinned host memory, one event per
    chunk; returns ``[(c0, c1, chunk), ...]``.  Queueing every copy up front
    lets the traces of the first chunks run while the later ones arrive."""
    ck = (ckvp, ckvm, cktv)
    per_lane = _ck_bytes(ck)
    n_chunks = int(max(1, min(8, per_lane * lanes // _CHUNK_TARGET_BYTES)))
    step = -(-lanes // n_chunks)
    chunks = []
    for c0 in range(0, lanes, step):
        c1 = min(lanes, c0 + step)
        chunks.append((c0, c1, _Readback(*(x[..., c0:c1] for x in ck))))
    return chunks


def _chunk_of(chunks, p: int):
    for c0, c1, sl in chunks:
        if c0 <= p < c1:
            return c0, sl
    raise AssertionError(f"position {p} outside staged chunks")


class _GapDomainProvider:
    """Heuristic-free domain provider: the cost-f parallelogram (closed
    form, no host build).  Same interface as ``native.DomainHandle``."""

    def __init__(self, a: bytes, b: bytes):
        self.n, self.m = len(a), len(b)
        # First-round f: the gap bound plus a ~6% divergence allowance.
        self.h0 = abs(self.m - self.n) + max(self.n, 1) // 16

    def sample(self, f_max: int, step: int = 64):
        return gap_domain(self.n, self.m, f_max, step)

    def close(self) -> None:
        pass


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
