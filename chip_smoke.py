#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases, one output line each (any failure exits non-zero):

0. card and tools (nvidia-smi, torch, CUDA, nvcc, Triton);
1. build the CUDA kernel library and the native C++ runtime, timed;
2. the banded cost kernel (K1's ring kernel) against its plain torch version
   (K1's staggered twin) on a grid of shapes, bit for bit;
3. main path, cost: ``BatchAligner(device="cuda").cost_with_stats`` on
   4096 pairs of 10 kbp at e=5%, twice (the first warms the band hints),
   16 costs against the oracle, aligned Gbp/s of the second call and its
   time split by layer; a third call under ``torch.profiler`` gives the
   card's idle share;
4. main path, align: ``align_iter`` over 6 batches of 512 such pairs,
   every CIGAR verified, steady ms/pair from the mid-stream periods;
5. the kernel against the plain version on the main path's own packs (the
   4096-pair cost pack at SW=32, a 512-pair align pack at its ladder's
   SW, each with the main path's diagonal, cut to their first 1024
   columns), bit for bit, and timed (CUDA events; the kernel also on the
   whole cost pack);
6. the checkpoint and per-pair kernels (K2: K2's ring at its layout and
   as a 64-lane ring, one capture window below SW, the old K2 once; K4
   cost, K4 ck: K4's rings) against their plain versions on a grid (B
   33/1024, n <= 300, SW 1 to full height, CB 64/512, Q 32/8/1, gap, gcsh
   and random schedules), bit for bit on costs and every checkpoint plane;
7. main path, config #4: ``BatchAligner(device="cuda")`` at its default
   settings on 128 pairs of 100 kbp at e=10% (gcsh domain ladder; rounds
   of at least ``runner.PINNED_PP_MIN_SW`` words run K9/K10, smaller ones
   K4): cost twice (the second timed), 8 costs against the oracle, align
   with direct traces and with ``direct_dt=False`` (ck rounds), every
   CIGAR verified; f-rounds, SW and kernel ms per round, gcsh build
   seconds, Mbp/s; then 128 pairs of 40 kbp at e=5%, whose gcsh rounds
   stay below that band (K4 cost and ck, on K4's rings; the old K4 must
   not run): cost, 4 costs against the oracle, align with
   ``direct_dt=False``, every CIGAR verified;
8. main path, checkpoint rungs: ``align_with_stats(direct_dt=False)`` on
   512 pairs of 10 kbp at e=5% (K2's ring; the old K2 must not run), every
   CIGAR verified;
9. K2 and K4 (its rings and the old K4) against their plain versions at
   the main path's own shapes (K4 and K4 ck on the pack and gcsh schedules
   of K4's last main-path round cut to the first 256 columns; K4's ring on
   K1's shared schedule against K1 at that round's full shape; K2's ring
   and the old K2 on phase 8's pack cut to 1024 columns, in turns), bit
   for bit; K2's ring against the old K2 in turns on phase 8's whole pack
   at its path's SW and CB;

10. the striped kernels K5 and K6 against their plain versions on a grid
    (B 33/160, n <= 1500, SW 8 to full height, bands taller than one
    block's stripe of words, CB 64/512), bit for bit on costs, every
    checkpoint row and top value;
11. main path, config #5: ``BatchAligner(device="cuda", band_words=2048,
    domain_mode="off")`` on 128 pairs of 500 kbp at e=15% (seeds 7 and 8,
    as ``bench.py:239-253``): cost twice (the second timed and split by
    layer), ``cost_iter`` over 4 batches, then cost once from
    ``band_words=8192``, a band past K7's 4096-word ring (the wide ring),
    its costs equal to the 2048-word ladder's, ``align_iter`` with
    ``ck_col_block=16384`` over 5 batches (ring K6), then align once from
    ``band_words=8192`` (the stripe K6), 128 more CIGARs verified; every
    cost rung checked against the runner's routing (K7 up to 4096 live
    words, the wide ring up to 16384, K5's stripes past it); 8 costs
    against ``oracle.levenshtein_myers``, all 640 CIGARs verified; rung
    SWs, K7/wide ring/K6 ms per rung, peak device memory, Mbp/s;
12. K5's stripes, K7 and K6 (ring and stripe) against their plain versions at config #5's own shapes
    (its pack cut to the first 4096 columns, at the ladder's SW), timed in
    turns (plain, kernels, kernels);
13. the pinned per-pair kernels K9 and K10 (their stripe kernels; phases 27
    and 32 hold the rings against the same plain results) against their plain versions on
    a grid (B 33/160, n <= 1500, SW 8 to full height, bands taller than one
    block's stripe, gap, gcsh, random and broadcast-shared schedules, Q
    32/8/1, CB 64/512), bit for bit on costs, every checkpoint row and top
    value;
14. main path, config #5 at its default settings: ``BatchAligner(device=
    "cuda")`` (gcsh domain ladder: ring K9 costs, ring K10 checkpoints) on phase
    11's seed-7 batch: align once (the aligner's first call), all 128
    CIGARs verified, then cost (its second call, timed and split by layer:
    gcsh builds, hull samples and schedules, event tables, K9, readback),
    8 costs against ``oracle.levenshtein_myers`` and all 128 equal to
    phase 11's and the align call's; f-rounds, SW,
    K9/K10 ms per round, peak device memory, Mbp/s; K4 and the stripe
    kernels must not run;
15. K9 and K10 (ring and stripe each) against their plain versions at that path's own shapes (its
    last round cut to the first 4096 columns), timed in turns;
16. the full-rectangle NW kernel K11 against its plain version on a grid
    (B 33/1024, n <= 1500 with n == 0 and m == 0 lanes, S 1 to 47 words
    and 313, ten stripes), bit for bit on both planes and the costs;
17. main path, config #1 (``BASELINE.json``: cost-only edit distance of
    1 kbp pairs at e=1%): ``nw_cost_pairs`` on the card on 65 536 pairs
    (``generate_batch`` seed 1), twice, the second timed and split by
    layer (native pack, upload and unpack, K11, readback), 1024 costs
    against ``oracle.levenshtein_myers``, aligned Gbp/s and peak device
    memory; then the reference's shape (its 8 seed-1 pairs tiled to 1024,
    ``scripts/bench_configs.py:41-67``), K11 alone over chained launches;
    then the same pairs through ``BatchAligner(device="cuda").cost`` (K1
    ladder), its costs equal to K11's;
18. K11 against its plain version on phase 17's pack cut to its first 512
    pairs, timed in turns (plain, kernel, kernel); K11 alone over
    chained launches on the whole pack and on it with one word more (S =
    33, a partial second stripe);
19. the shared-schedule checkpoint kernel K8 (ring K8 and the stripe K8)
    against its plain version on a grid (B 1/37/128, n <= 1500 with n == 0
    and m == 0 lanes, SW 8, 13, 64, 67, 1152 and a full height S = 1188 off
    the 8-grain, CB = SW, SW + 3, 4096 and n_max, a skewed bucket's single
    capture window, four windows at SW 1188 on pairs of up to 3.6 kbp, and
    ring K8 forced to 256 words wrapping >= 3 times at SW 64), bit for bit
    on costs, every checkpoint row and top value, and against K2 on every
    checkpoint a trace reads;
20. main path, the exact full-height rungs on config #4's pairs of phase
    7: ``BatchAligner(device="cuda", domain_mode="off",
    max_band_doublings=0)`` first ``.cost_with_stats`` (one cost rung at SW
    = S = 3149 words on K7), costs equal to phase 7's; then
    ``.align_with_stats`` (one ck rung, CB = 4096, ring K8; the stripe K8
    must not run), costs equal to
    phase 7's and its 8 ``levenshtein_myers`` costs, all 128 CIGARs
    verified on a process pool, the call split by layer, peak device
    memory;
21. ring K8 and the stripe K8 in turns on phase 20's whole rung, each over
    chained launches; both against their plain version and against K2 on
    that rung cut to its first 1024 columns, in turns, each beside its
    bound;
22. the resident-ring cost kernel K7 against its plain version on a grid
    (B 1/33/160, n <= 1500 with n == 0 and m == 0 lanes, SW 8, 13, 64, 67,
    256 and a full height S ~ 280 off the 8-grain, a skewed bucket, rings
    forced to 256 words on pairs of up to 2 kbp beside a tall one so that
    they wrap at least 3 times), bit for bit, and K7 (forced) refusing a
    band whose live words exceed its 4096-word ring (no launch);
23. K7 and K5's stripes alone over chained launches on config #5's whole SW = 2048
    rung, each beside its bound, their costs equal;
24. the banded fill kernel K3 against its plain versions in both schedule
    modes on a grid (B 1/37/128, n <= 100 with n == 0 and m == 0 lanes, SW 1,
    8, 28, 32, 64 and a full height of 72 words, a diagonal whose only
    shift is at column 0, the shared mode on K3's ring; per-pair schedules
    with Q 32/8/1 shifting at column 0
    and at the last column on the old K3), bit for bit on costs and both
    planes;
25. main path, the cost-then-trace align route on phase 8's 512 pairs of
    10 kbp at e=5%: ``BatchAligner(device="cuda", combined=False,
    direct_dt=False).align_with_stats`` (K1 cost rungs, one K3 fill on K3's
    ring, the planes read back once, a native ``trace_banded`` per pair;
    the old K3 must not run), costs equal
    to phase 8's, all 512 CIGARs verified, split by layer, peak device
    memory; the same pairs with ``direct_dt=True`` (the direct arm);
    ``align_iter`` over three of phase 4's batches; then K3 alone on the
    whole pack over chained launches against its bound, and K3 (both modes)
    against its plain versions on the pack cut to its first 1024 columns;
26. the host arm and the fallback: a 30 kbp pair at e=3% with 1100 bp cut
    from b (native A*) and a 10 kbp pair at e=30% (the block aligner)
    through ``combined=False, direct_dt=False``; the block aligner with its
    block DP in torch on the card on three 2 kbp pairs, and
    ``BatchAligner(device="cuda").align`` on them with the native library
    reported missing (``_align_host_fallback``); costs against
    ``oracle.levenshtein_myers``, CIGARs verified;
27. the resident-ring kernels ring K6 (checkpoints) and ring K9 (per-pair
    costs) against their plain versions and their stripe kernels on a grid
    (phase 10's and 13's 160- and 33-lane packs with n == 0 and m == 0
    lanes and a skewed pair making S ~ 280; 33 pairs of up to 3.5 kbp beside
    a 38 kbp one, where rings forced to 256 words wrap at least 3 times;
    33 pairs of up to 3 kbp beside a 70 kbp one for SW 2048; K6 at SW 8 to
    2048 with CB = SW + 8 and larger and a checkpoint at a shifting column;
    K9 on gap, random, gcsh and broadcast-shared schedules at Q 32, 8, 4
    and 1), bit for bit on costs, every checkpoint row and top value; both
    refusing, without a launch, a ring forced on more than 4096 live words;
28. ring against stripe kernels on whole main-path shapes, once each,
    each beside its bound, their results equal: K6 on config #5's align
    rung (SW 2048, CB 16384) over chained launches, K9 on config #5
    default's round (SW 1152) and config #4's round (SW 192), kernel from
    the end of its event tables with the tables timed apart;
29. the redesigned K7 and the wide ring against their plain version and
    K5's stripes on a grid (phase 10's packs with n == 0 and m == 0 lanes
    and rings forced to both designs; 33 pairs of up to 2 kbp beside a
    tall one with K7 rings forced to 256 words wrapping >= 3 times; the
    full height beside a skewed 4200 x 160 kbp pair, more than 4096 live
    words on the wide ring by default, wrapping; SW 4352 with a forced wide
    ring of 1024 words wrapping >= 3 times beside a 500 x 150 kbp pair; config #5's pack cut to 2048 columns at SW 8192 on the wide
    ring, timed against plain), bit for bit, and the refusal, without a
    launch, of more than 16384 live words;
30. the cost ring against K5's stripes on whole main-path rungs, once
    each over chained launches, each beside its bound: K7 on config #4's
    full-height rung, the wide ring on config #5's SW = 8192 rung (config
    #5's SW = 2048 rung: phase 23);
31. K1's ring kernel (the main path's K1 since the redesign) against its
    plain version on a grid (SW 1, 2, 31, 32, 33 and 63 with and without a
    diagonal, pairs covered by the window, above and below it and n == 0,
    both layouts: the runner's ring with a spare slot and a full one), bit
    for bit; against the old K1 (old, then ring) on phase 3's whole pack
    and its 1024-column cut;
32. ring K10 against its plain version and the stripe K10 on a grid
    (phase 13's checkpoint cases at its own ring and a forced 256-word one;
    pairs of up to 0.8 and 4.2 kbp beside a 10 kbp b with random schedules
    at Q 1 and 8, CB = SW and larger, 256-word rings wrapping >= 3 times), bit
    for bit on costs, every checkpoint row and top value, and its refusal,
    without a launch, of more than 4096 live words; then ring K10 against
    the stripe K10, once each, on config #5 default's and config #4's whole
    checkpoint rounds (phases 14 and 7);
33. K4's rings (cost and checkpoints, the main path's K4)
    against K4's plain versions on a grid (44 pairs of up to 200 bp beside
    b of up to 500 bp, most far shorter than n_max so that checkpoints lie
    past their end, n == 0, row m covered, above and below the window;
    random per-pair schedules at Q 1 and 8 shifting at column 0 and sliding
    past the last word, the pairs' gcsh schedules; SW 1, 4, 16 and full
    height, CB = max(SW, 24); the runner's layout and 64-lane rings), bit
    for bit on costs, every checkpoint row and top value; an interval below
    SW on the old K4; K1's, K3's and K2's rings, ring K8 and the cost rings
    (K7, the wide ring) on a shared schedule shifted at column 0; then K4's rings against the old K4 in turns on phase 7's whole
    40 kbp cost and checkpoint rounds (the kernel alone, its event tables
    and codes alone, both in the wrapper's call), and K3's ring (alone and
    with the trace route's transpose) against the old K3 on phase 25's
    whole pack and its 1024-column cut;

34. main path split over two shards on the one card
    (``mesh=("cuda:0", "cuda:0")``, each shard on its own stream): phase
    3's cost (a fresh aligner of each kind called twice, the second call
    timed beside one device's), phase 4's ``align_iter`` and phase 8's
    checkpoint rungs (``direct_dt=False``): costs equal phases 3, 4 and 8,
    CIGARs and ``BatchStats`` equal one device's, every CIGAR verified, and
    each kernel launched twice as often; a bucket whose first pair alone
    fits K7's ring and whose second needs the wide ring, both shards
    launching the wide ring the label names, costs equal one device's and
    the oracle; ``mesh=("cuda:0",)`` equal to ``mesh=None``;
    ``parallel.dryrun.dryrun_multichip(2, ["cuda:0"] * 2)``;
35. multi-host streaming at config #5's shape: phase 11's seed-7 batch
    written once to a ``.seq`` file (``pairs_io``), two processes on the card
    joining one gloo group on 127.0.0.1, each running
    ``MultiHostRunner(BatchAligner(band_words=2048, domain_mode="off"),
    batch_size=32).run(..., with_cigars=True)`` on its stripe: the shards'
    union equal to phase 11's costs, every CIGAR verified, the merged counts
    (128 pairs, the batch's bases) on both, each process's Mbp/s;
36. the CLI on the card (``python -m astarpa_tpu_torch.cli``): 64 pairs of
    10 kbp at e=5% through ``--aligner batch --chunk 32``, and 3 pairs of 2
    kbp through ``astarpa2-full`` and ``astarpa-native``, every line's cost
    equal to ``levenshtein_myers`` and its CIGAR verified;
37. the fuzzer on the card (``python -m astarpa_tpu_torch.fuzz``): 50
    iterations of each batch mode (batch, batch-ck, batch-domain,
    batch-bigband) at ``--max-n 400`` with a fixed seed, no failure, and the
    kernels each mode launched; phases 36 and 37 run their seven processes
    at once, each with a time limit of its own (180 s, as phase 35's);
38. the modules ported last, on the card host: ``testing.check_aligner``
    (its 10 tricky pairs, empty ones included, and 40 samples up to 300
    bp, seed 1234) through ``BatchAligner(device="cuda")`` one pair a call,
    then the 50 pairs as one ``align`` and one ``cost`` call, then with
    ``direct_dt=False``, every cost equal to ``oracle.levenshtein`` and
    every CIGAR verified, K1's ring among the launches; the semi-global
    ``search`` of a 150 bp pattern (5% planted edits, one ``N``) cut from
    a 10 kbp text, its best cost at most the planted edits and its trace
    verified on its window; ``DiagonalTransition`` (both modes) and
    ``NwAffine`` at unit cost on a 1 kbp e=5% pair against
    ``levenshtein_myers``; the five ``ops.layouts`` orders on CUDA int32
    tensors of a 96 x 3-word pair, bit-equal and at the oracle distance;
    and the figure suite (``python -m astarpa_tpu_torch.figures --small``,
    an eighth process of phases 36-37's batch), every family written;

then the host seconds of each phase, the kernels' JSON line (each
kernel's time, its plain version's, its bound from this run's inputs, its
launches on the main path), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
Timing that no kernel's record needs is left out (the 500 bp turns of
phases 5 and 9, the band sweeps of phases 12, 15, 23 and 31, ring K8
against ring K6 in phase 21, K7 again in phase 28); the comparisons of a
kernel with its replacement on whole shapes run once each.  The plain
sweeps of phases 5, 9, 12, 15, 21 and 25 run on their packs' first
columns, those of phase 27 on packs of at most 3.5 kbp (and reuse
phases 10's and 13's), the grids of phases 2 and 6 hold a few cases each, and the pairs
are generated and the CIGARs verified on one pool of the host's cores,
started once for the whole run, to keep the run short.  Launch counts are
reset just before each main-path phase (3-4, 7, 8, 11, 14, 17, both calls
of 20, 25, 34, each call of 38) and read just after it, and the workers of phase 35 print
their own; phases 3-4 and 25 launch K1's ring
kernel (the old K1 none), phase 8 K2's ring (the old K2 none), phase 20
ring K8 (the stripe K8 none), phase 25 K3's ring (the old K3 none), phase 7
K4's rings for its 40 kbp rounds (the old K4 none), phases 7 and 14 ring
K9 for their cost rounds and ring K10 for their checkpoint rounds (the
stripe K10 none), phase 11
ring K6 for its 2048-word checkpoint rungs and the wide ring for its cost
call from 8192 words.  Imports nothing of JAX and nothing of the
JAX package.  Exits 1 without a usable GPU.
"""

from __future__ import annotations

import json
import multiprocessing
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import astarpa_tpu_torch as att  # noqa: E402
from astarpa_tpu_torch.ops import (  # noqa: E402
    _build, banded, banded_kernel, myers, nw_kernel, pinned, striped)
from astarpa_tpu_torch.ops.pack import pack_batch_staggered  # noqa: E402
from astarpa_tpu_torch.ops.words import value_to_window  # noqa: E402
from astarpa_tpu_torch.parallel import runner  # noqa: E402
from astarpa_tpu_torch.parallel.runner import BatchAligner  # noqa: E402
from astarpa_tpu_torch.types import Cigar  # noqa: E402

PAIRS, LENGTH, ERR, SEED = 4096, 10_000, 0.05, 42
STREAM_BATCHES, STREAM_PAIRS = 6, 512
TIMED_SW = 32
C4_PAIRS, C4_LENGTH, C4_ERR, C4_SEED = 128, 100_000, 0.10, 100
C4_ORACLE = 8
C40_PAIRS, C40_LENGTH, C40_ERR, C40_SEED = 128, 40_000, 0.05, 400
CK_PAIRS = 512
CUT_COLS = 1024
GRID_PAIRS = 1024
GRID_N, GRID_M = 300, 1300  # the K1/K2/K4 grids' longest a and b
C5_PAIRS, C5_LENGTH, C5_ERR, C5_SEEDS = 128, 500_000, 0.15, (7, 8)
C5_BAND, C5_CB = 2048, 16384
C5_K5_BAND = 8192  # phase 11: two doublings above C5_BAND, past K7's ring
C5_CUT = 4096
C1_PAIRS, C1_LENGTH, C1_ERR, C1_SEED = 65_536, 1000, 0.01, 1
C1_ORACLE, C1_REF_PAIRS, C1_REF_LAUNCHES = 1024, 1024, 8
NW_GRID_N = 1500  # the K11 grid's longest a and b
NW_CUT_PAIRS = 512
K8_CUT_CB = CUT_COLS * 3 // 4  # one capture window in the cut for K8 and K2
K8_GRID_N, K8_TALL_M, K8_BIG_SW = 1500, 38_000, 1152  # phase 19: S = 1188 words
K8_LONG_N = 3600  # phase 19: several capture windows at full height (1188)
K8_CHAINED = 3
K7_CHAINED = 2
K7_GRID_LONG_N, K7_GRID_TALL_M = 2000, 38_000  # phases 22, 29: ~1188 words, 4.6 rings of 256
K3_GRID_PAIRS, K3_GRID_N, K3_COL0_SW = 128, 100, 8  # phase 24
K3_CHAINED = 2
K3_STREAM_BATCHES = 3  # phase 25's align_iter, over phase 4's batches
K3_BLOCK_N, K3_BLOCK_ERRS = 2000, (0.05, 0.15, 0.1)  # phase 26's torch block DP
RING_LONG_N, RING_TALL_M = 3500, 38_000  # phase 27: S = 1188, 256-word rings wrap
RING_BIG_N, RING_BIG_M = 3000, 70_000  # phase 27: S = 2188, SW 2048
RING_CHAINED = 1
WIDE_GRID_N, WIDE_GRID_TALL_M = 4200, 160_000  # phase 29: S = 5000, 4200 > 4096 live words
C5_WIDE_CUT = 2048  # phase 29: config #5's pack cut for the wide ring at SW 8192
WIDE_LOW_N, WIDE_LOW_TALL_M = 500, 150_000  # phase 29: S = 4688, forced wide rings wrap
WORKERS = 8
_LAPS = None  # the run's Laps, printed by fail()

# The card's limits for each kernel's bound (the least time the card could
# take for the same work): the int32 rate of 132 SMs x 64 lanes at the SM
# clock nvidia-smi reads (set in phase 0), and 3.35 TB/s of device memory
# (H100 SXM data sheet).  One Myers word step, as every kernel here runs
# it, takes at least 14 int32 instructions on sm_90: the match word from
# the sign masks (an XOR and a three-input LOP3), the h-carry-in bit
# (a shift), eq | hm_in, its AND with vp, the add, the step's four
# three-input logicals (hx, hp_out, hm_out, vx) and the two new vertical
# words, and each shifted h word with the bit of the word above in one
# funnel shift (two).  That is the least on the ALU pipe alone, which the
# bound counts: K7 and the wide ring run 12 of them there and 2 on the FMA
# pipe (``csrc/pinned.cu``'s ``word_step_split``).
# ``python -m astarpa_tpu_torch.ops.sass_count`` counts what K11's compiled
# column loop runs a word step.
SMS, INT32_LANES, HBM_BYTES_S = 132, 64, 3.35e12
OPS_PER_WORD_STEP = 14
SM_CLOCK_HZ = None


def bound(word_steps: int, in_bytes: int, out_bytes: int) -> dict:
    """``bound_ms`` and ``bound_by`` of one call: the larger of the
    operations over the card's int32 rate and the bytes (each input read
    once, each output written once) over its memory rate."""
    ops_ms = word_steps * OPS_PER_WORD_STEP / (SMS * INT32_LANES * SM_CLOCK_HZ) * 1e3
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def plane_bound(planes, sw: int, outs, extra_in: int = 0) -> dict:
    """Bound of a banded or striped call on ``planes``: SW word steps for
    every column of every pair (the band has SW words at each of a pair's
    n columns; columns past n are not needed), the planes and lengths in,
    ``outs`` (tensors) out."""
    n = np.asarray(planes[4], np.int64)
    sw = min(sw, planes[2].shape[0])
    in_bytes = sum(x.numel() * x.element_size() for x in planes[:4]) + 8 * len(n)
    out_bytes = sum(x.numel() * x.element_size() for x in outs)
    return bound(int(n.sum()) * sw, in_bytes + extra_in, out_bytes)


def _uniform(args):
    return att.generate.uniform_seeded(*args)


# The run's WORKERS spawned processes, started once (each start imports
# torch and the port) and shut down when main() returns or fails.
_POOL: ProcessPoolExecutor | None = None


def _pool(fn, jobs):
    """``[fn(job) for job in jobs]`` on the run's worker processes."""
    return list(_POOL.map(fn, jobs, chunksize=max(1, len(jobs) // (4 * WORKERS))))


def _generate(count: int, n: int, e: float, seed: int):
    """``generate.generate_batch(count, n, e, seed=seed)`` on the run's
    worker processes: its per-pair jobs, the same bytes."""
    jobs = att.generate._model_jobs(count, n, e, att.generate.ErrorModel.UNIFORM, seed)
    return _pool(att.generate._model_job, jobs)


def _verify_job(job) -> bool:
    a, b, cigar, cost = job
    return Cigar.from_string_lazy(cigar).verify(a, b) == cost


def fail(msg: str) -> None:
    if _LAPS is not None:
        print(f"[timing] host seconds by phase so far: {', '.join(_LAPS.laps)}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def phase0_card() -> str:
    global SM_CLOCK_HZ
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    SM_CLOCK_HZ = float(clock) * 1e6
    say(f"[0 clock] max SM clock {clock} MHz: int32 rate "
        f"{SMS * INT32_LANES * SM_CLOCK_HZ:.4g}/s over {SMS} SMs x {INT32_LANES} lanes")
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
    say(f"[1 build] cuda kernels {lib.name} {t1 - t0:.3f} s (one nvcc per source, "
        f"in parallel); native runtime {t2 - t1:.3f} s")
    # ptxas -v: registers, shared memory and spills of each kernel.
    log = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            props = " ".join(x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                             if "Used" in x or "spill" in x)
            say(f"[1 ptxas] {name}: {props}")


def _random_pairs(rng, count, n_hi, m_hi):
    def seq(k):
        return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), k).tolist())

    pairs = [(seq(int(rng.integers(1, n_hi + 1))), seq(int(rng.integers(1, m_hi + 1))))
             for _ in range(count)]
    pairs[1] = (b"", seq(37))  # an n == 0 lane: cost m
    pairs[2] = (seq(n_hi), seq(m_hi))  # pins n_max and S
    return pairs


def phase2_grid() -> int:
    """Kernel == plain on B in {33, 1024}, n in [0, GRID_N], SW from 1 to full
    height, with and without a diagonal; returns the max abs difference.
    The 33-lane pack is the first lanes of the 1024-lane one (same n_max, S
    and schedule), so one plain sweep of the wide pack serves both.  The
    plain version is K1's staggered twin (the layout K1's ring kernel
    computes in; bit for bit K1's column loop, which phases 5 and 31 hold
    the kernel against too)."""
    rng = np.random.default_rng(7)
    pairs = _random_pairs(rng, GRID_PAIRS, GRID_N, GRID_M)
    args, _ = pack_batch_staggered(pairs, 1, device="cuda")
    n_max, S = args[0].shape[0], args[2].shape[0]
    small = _lanes(args, 33)
    worst, cases = 0, 0
    t0 = time.perf_counter()
    dg = (n_max, S * 32 - 50)
    for sw, diag in ((1, None), (5, dg), (32, None), (33, dg), (72, None), (S, dg)):
        ref = striped.banded_cost_staggered_ref(*args, sw, diag)
        for planes in (small, args):
            got = banded_kernel.banded_cost(*planes, sw, diag)
            torch.cuda.synchronize()
            diff = int((got.long() - ref[: got.shape[0]].long()).abs().max())
            if diff:
                fail(f"kernel != plain at B={planes[0].shape[1]} SW={sw} diag={diag}")
            worst, cases = max(worst, diff), cases + 1
    say(f"[2 kernel=plain] {cases}/{cases} cases equal (B 33/{GRID_PAIRS}, n_max {n_max}, "
        f"S {S}, SW 1..{S}, diag None/set), max_abs_err {worst}, "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


class LayerSpy:
    """Times the runner's layers inside its own calls and keeps the last
    kernel launch per batch size.

    Wraps the runner's pack (``BatchAligner._pack``), kernel launch and
    readback wait: the host clock around each, and CUDA events around each
    launch for the kernel's time on the card.  The launch count stays with
    the kernel's wrapper; this only passes calls through."""

    def __init__(self):
        self._orig = (runner.BatchAligner._pack, runner.banded_cost,
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

        runner.BatchAligner._pack = timed_pack
        runner.banded_cost = timed_launch
        runner._Readback.numpy = timed_wait

    def remove(self):
        (runner.BatchAligner._pack, runner.banded_cost,
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
    if st2.kernel != "cuda-banded-ring":
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
    return costs2


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
             and "banded_ring_kernel" in e.name) / 1e3
    return (f"3rd call under torch.profiler: wall {wall:.4f} s, card busy {busy:.4f} s "
            f"({len(spans)} device events, first to last {last - first:.4f} s), idle share "
            f"{1 - busy / wall:.3f}; K1 (banded_ring_kernel) {k1:.3f} ms in the trace")


def phase4_align(ba: BatchAligner, batches) -> list:
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
    return got


def _event_ms(fn):
    """(device ms between events around ``fn()``, its result)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _ms(times) -> str:
    """Times in ms, one after another."""
    return "/".join(f"{t:.3f}" for t in times)


def _chained_ms(fn, launches: int) -> float:
    """Device ms a call of ``fn`` over ``launches`` chained calls, behind
    one untimed call, so that the card never waits between the events for
    the host to enqueue the next launch."""
    fn()
    return _event_ms(lambda: [fn() for _ in range(launches)])[0] / launches


def _cut(planes, cols: int):
    """A pack cut to its first ``cols`` columns: each pair keeps its first
    min(n, cols) characters of a and the matching share of b's rows (its
    length scaled by the same ratio), as the main path's ladder aims its
    band along the diagonal."""
    n = np.asarray(planes[4])
    cut = min(cols, planes[0].shape[0])
    n_c = np.minimum(n, cut).astype(np.int32)
    m_c = (np.asarray(planes[5]).astype(np.int64) * n_c // np.maximum(n, 1)).astype(np.int32)
    return tuple(x[:cut].contiguous() for x in planes[:2]) + (planes[2], planes[3], n_c, m_c)


def _cut_diag(planes):
    return (planes[0].shape[0], int(np.asarray(planes[5]).max()))


def _check_equal(planes, sw, diag, label: str) -> tuple[int, float, list[float]]:
    """Kernel == plain on one pack; returns (max_abs_err, plain ms, kernel
    ms of two runs), all CUDA events."""
    plain_ms, ref = _event_ms(lambda: banded.banded_cost_ref(*planes, sw, diag))
    kernel = [_event_ms(lambda: banded_kernel.banded_cost(*planes, sw, diag)) for _ in range(2)]
    err = max(int((got.long() - ref.long()).abs().max()) for _, got in kernel)
    if err:
        fail(f"kernel != plain on {label}")
    return err, plain_ms, [ms for ms, _ in kernel]


def phase5_time(spy: LayerSpy) -> tuple[dict, tuple]:
    """The kernel against plain on the main path's own packs (cut to their
    first columns), and timed.  Returns the kernel's JSON record (without
    the launch count) and, for phase 31, the cost pack with its diagonal and
    the plain version's ms on its cut."""
    if PAIRS not in spy.last or STREAM_PAIRS not in spy.last:
        fail(f"main path launched no {PAIRS}- or {STREAM_PAIRS}-pair batch")
    cost_l, align_l = spy.last[PAIRS], spy.last[STREAM_PAIRS]
    spy.last.clear()
    args10k = cost_l["args"]
    n_max10, S10 = args10k[0].shape[0], args10k[2].shape[0]
    full_ms = [_event_ms(lambda: banded_kernel.banded_cost(*args10k, TIMED_SW, cost_l["diag"]))[0]
               for _ in range(2)]
    cut10k = _cut(args10k, CUT_COLS)
    err_c, plain10, k10 = _check_equal(cut10k, TIMED_SW, _cut_diag(cut10k), "the cost pack")
    a512 = _cut(align_l["args"], CUT_COLS)
    err_a, plain512, k512 = _check_equal(a512, align_l["sw"], _cut_diag(a512),
                                         "the align pack")
    say(f"[5 main shapes] kernel on the whole cost pack B={PAIRS} n_max={n_max10} S={S10} "
        f"SW={TIMED_SW} diag={cost_l['diag']} (ladder ran SW {cost_l['sw']}): "
        f"{full_ms[0]:.3f}/{full_ms[1]:.3f} ms; kernel == plain on its first {CUT_COLS} "
        f"columns: kernel {k10[0]:.3f}/{k10[1]:.3f} ms, plain {plain10:.1f} ms; on the "
        f"align pack B={a512[0].shape[1]} cut to {a512[0].shape[0]} columns, S="
        f"{a512[2].shape[0]}, SW={align_l['sw']}: kernel {k512[0]:.3f}/{k512[1]:.3f} ms, "
        f"plain {plain512:.1f} ms; max_abs_err {max(err_c, err_a)} (CUDA events)")

    return {
        "max_abs_err": max(err_c, err_a),
        # The main path's cost pack cut to CUT_COLS columns: the kernel's
        # mean of two runs, plain's one run, the bound of the same inputs.
        "ms": float(np.mean(k10)), "plain_ms": plain10,
        **plane_bound(cut10k, TIMED_SW, [torch.empty(PAIRS, dtype=torch.int32)]),
        "library_ms": None,
        "shape": {"B": PAIRS, "n_max": cut10k[0].shape[0], "S": S10, "SW": TIMED_SW},
        # The whole pack: the kernel's two runs and the bound.
        "full_ms": float(np.mean(full_ms)),
        "full_bound_ms": plane_bound(args10k, TIMED_SW, [])["bound_ms"],
        "full_shape": {"B": PAIRS, "n_max": n_max10, "S": S10, "SW": TIMED_SW},
    }, (args10k, cost_l["diag"], plain10)


def _max_err(got, want) -> int:
    """Largest absolute difference between matching outputs (a cost vector,
    or costs and every checkpoint plane), after checking their shapes."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    worst = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            fail(f"shape {tuple(g.shape)} != plain {tuple(w.shape)}")
        if g.numel():
            worst = max(worst, int((g.long() - w.long()).abs().max()))
    return worst


def _lanes(args, k: int):
    """The first ``k`` lanes of a pack."""
    return tuple(x[:, :k].contiguous() for x in args[:4]) + (args[4][:k], args[5][:k])


def _random_schedule(rng, n_max: int, B: int, quantum: int) -> np.ndarray:
    """Shifts at multiples of ``quantum`` with probability 0.3, every fifth
    lane at all of them (its window slides past the last word, where the
    entering word clamps at S-1)."""
    sched = np.zeros((n_max, B), np.uint8)
    rows = np.arange(0, n_max, quantum)
    sched[rows] = rng.random((len(rows), B)) < 0.3
    sched[rows, ::5] = 1
    return sched


def _gcsh_schedules(pairs, B: int, n_max: int, scale: float):
    """Per-pair schedules from the native gcsh hulls at f = scale * h0 (the
    domain ladder's sampling), with the round's band and quantum."""
    sched = np.zeros((n_max, B), np.uint8)
    sw, quantum = 1, 32
    for slot, (a, b) in enumerate(pairs):
        if not a or not b:
            continue
        h = att.native.DomainHandle(a, b, k=12, r=2)
        f = max(int(h.h0 * scale), 64)
        ps = att.domain.domain_schedule(h.sample(f, 64))
        while ps is None:
            f += max(f // 4, 64)
            ps = att.domain.domain_schedule(h.sample(f, 64))
        h.close()
        sched[: len(ps.sched), slot] = ps.sched
        sw, quantum = max(sw, ps.band_words), min(quantum, ps.quantum)
    return sched, sw, quantum


def phase6_grid() -> int:
    """K2, K4 cost and K4 ck == plain on a grid; returns the max abs
    difference.  K4 cost is held against the costs of the plain ck sweep:
    the plain cost and ck versions are one loop."""
    t0 = time.perf_counter()
    rand_pairs = _random_pairs(np.random.default_rng(7), GRID_PAIRS, GRID_N, GRID_M)  # phase 2's
    rand, _ = pack_batch_staggered(rand_pairs, 1, device="cuda")
    rng = np.random.default_rng(11)
    sim_pairs = [att.generate.uniform_seeded(int(rng.integers(1, GRID_N + 1)),
                                             float(rng.uniform(0, 0.2)), 3000 + s)
                 for s in range(GRID_PAIRS)]
    sim_pairs[1] = (b"", b"ACGTACGT")
    sim, _ = pack_batch_staggered(sim_pairs, 1, device="cuda")
    n_max, S = rand[0].shape[0], rand[2].shape[0]
    diag = (n_max, S * 32 - 50)
    worst, k2_cases = 0, 0
    before = dict(banded_kernel.LAUNCHES)
    # K2's ring (the wrapper's) at its default layout and as a two-warp
    # ring; one capture window below SW at full height on the pack cut to 60
    # columns; the old K2 (its internal launch) on one case.
    cut60 = _cut(rand, 60)
    k2 = [(rand, 1, 64, None, None), (_lanes(rand, 33), 72, 512, diag, None),
          (rand, S, 64, None, None), (rand, 16, 64, diag, 64), (cut60, S, 31, None, None),
          (rand, 16, 64, diag, "old")]
    for planes, sw, cb, dg, lanes in k2:
        if lanes == "old":
            got = banded_kernel._launch("banded_ck", *planes, sw, diag=dg, col_block=cb)
        elif lanes:
            got = banded_kernel._launch_banded_ring_ck(*planes, sw, cb, dg, lanes)
        else:
            got = banded_kernel.banded_ck(*planes, sw, cb, dg)
        err = _max_err(got, banded.banded_ck_ref(*planes, sw, cb, dg))
        if err:
            fail(f"K2 ({lanes or 'ring'}) != plain at B={planes[0].shape[1]} SW={sw} CB={cb} "
                 f"diag={dg}")
        worst, k2_cases = max(worst, err), k2_cases + 1
    ran = {k: banded_kernel.LAUNCHES[k] - before[k] for k in ("banded_ring_ck", "banded_ck")}
    if ran != {"banded_ring_ck": len(k2) - 1, "banded_ck": 1}:
        fail(f"phase 6's K2 cases launched {ran}")

    def gap(planes, sw):
        return banded.pair_gap_schedule(planes[4], planes[5], sw, planes[0].shape[0],
                                        planes[2].shape[0])[0]

    r33, s33 = _lanes(rand, 33), _lanes(sim, 33)
    g125, sw125, q125 = _gcsh_schedules(sim_pairs, GRID_PAIRS, sim[0].shape[0], 1.25)
    g2, sw2, q2 = _gcsh_schedules(sim_pairs[:33], 33, sim[0].shape[0], 2.0)
    k4 = [
        ("gap", r33, gap(r33, 32), 32, 32, 512),
        ("random", rand, _random_schedule(rng, n_max, GRID_PAIRS, 8), 16, 8, 512),
        ("random", r33, _random_schedule(rng, n_max, 33, 1), S, 1, 64),
        ("gcsh 1.25 h0", sim, g125, min(sw125, sim[2].shape[0]), q125, 64),
        ("gcsh 2 h0", s33, g2, min(sw2, sim[2].shape[0]), q2, 512),
    ]
    labels = []
    for label, planes, sched, sw, q, cb in k4:
        want = banded.banded_ck_pp_ref(*planes, sched, sw, cb, q)
        err = max(_max_err(banded_kernel.banded_ck_pp(*planes, sched, sw, cb, q), want),
                  _max_err(banded_kernel.banded_cost_pp(*planes, sched, sw, q), want[0]))
        if err:
            fail(f"K4 != plain on {label} B={planes[0].shape[1]} SW={sw} Q={q} CB={cb}")
        worst = max(worst, err)
        labels.append(f"{label} B={planes[0].shape[1]} SW={sw} Q={q} CB={cb}")
    torch.cuda.synchronize()
    say(f"[6 ck/pp=plain] K2 {k2_cases}/{k2_cases} cases (B 33/{GRID_PAIRS}, n_max {n_max}, "
        f"S {S}, SW 1..{S}, CB 64/512, diag None/set; K2's ring at its layout and 64 lanes, "
        f"CB 31 < SW {S} on {cut60[0].shape[0]} columns, the old K2 once); K4 cost and ck "
        f"{len(k4)}/{len(k4)} cases ({'; '.join(labels)}); max_abs_err {worst}, "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


class RoundSpy:
    """Records, inside the runner's own calls, every launch of the
    checkpoint and per-pair kernels (kernel, SW, quantum and CUDA-event ms)
    and the host clock of the domain ladder's host layers (pack, gcsh
    builds, hull samples, schedules, the per-pair event tables, traces);
    keeps each kernel's last inputs for the timing phases.  The event
    tables of K9/K10 are also timed on the card (CUDA events), and a K9/K10
    launch's kernel time is taken from the end of its tables to the end of
    the call (K4's ring from the end of its tables and codes).  Each
    launch is recorded under the kernel that ran (its
    launch key: ``ring_ck`` for a ``striped_ck`` call the ring took), and
    ``last`` keeps each kernel's last inputs (and a wrapper's whose name is
    no launch key).  The launch counts stay with the wrappers."""

    NAMES = ("banded_ck", "banded_cost_pp", "banded_ck_pp", "pinned_cost_pp",
             "pinned_ck_pp")
    HOST = (("pack", runner.BatchAligner, "_pack"),
            ("pack", runner, "pack_batch_staggered"),
            ("gcsh build", runner.BatchAligner, "_build_gcsh_handles"),
            ("hull sample", att.native.DomainHandle, "sample"),
            ("schedule", runner, "domain_schedule"),
            ("event tables", banded_kernel, "pinned_pp_events"),
            ("event tables", banded_kernel, "ring_pp_events"),
            ("event tables", banded_kernel, "banded_ring_pp_tables"),
            ("readback wait", runner._Readback, "numpy"),
            ("traces", runner.BatchAligner, "_flush_traces"))

    def __init__(self, names=NAMES):
        self._orig = {n: getattr(runner, n) for n in names}
        self._orig_host = [(key, obj, attr, getattr(obj, attr))
                           for key, obj, attr in self.HOST]
        self.last: dict[str, tuple] = {}
        self._tables = None
        self.reset()

    def reset(self):
        # Earlier calls stay in ``history`` (their events are kept).
        self.history = getattr(self, "history", []) + getattr(self, "calls", [])
        self.calls = []
        self.table_events = []
        self.host = {key: 0.0 for key, *_ in self.HOST}

    def install(self):
        for name, fn in self._orig.items():
            setattr(runner, name, self._wrap(name, fn))
        for key, obj, attr, fn in self._orig_host:
            setattr(obj, attr, self._timed(key, fn))

    def _timed(self, key, fn):
        def call(*args, **kw):
            if key == "event tables":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.host[key] += time.perf_counter() - t0
            if key == "event tables":
                b.record()
                self._tables = (a, b)
                self.table_events.append((a, b))
            return out

        return call

    def _wrap(self, name, fn):
        def call(*args):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self._tables = None
            before = dict(banded_kernel.LAUNCHES)
            a.record()
            out = fn(*args)
            b.record()
            # The runner passes a cost rung's ring layout after (planes, SW,
            # diag); on one device it is the default one the timing phases
            # re-run the rung's inputs at.
            args = args[:8] if name == "pinned_cost" else args
            ran = next((k for k, v in banded_kernel.LAUNCHES.items() if v > before[k]), name)
            self.calls.append((ran, args, a, b, self._tables))
            self.last[ran] = args
            if ran == name or name not in banded_kernel.LAUNCHES:
                self.last[name] = args
            return out

        return call

    @staticmethod
    def kernel_ms(call) -> float:
        """CUDA-event ms of one recorded launch: the whole wrapper, or for
        K9/K10 from the end of the event tables to the end of the call."""
        _, _, a, b, tables = call
        return (tables[1] if tables else a).elapsed_time(b)

    def rounds(self) -> list[str]:
        """One summary per launch since the last reset."""
        torch.cuda.synchronize()
        out = []
        for call in self.calls:
            name, args = call[:2]
            pp = name.endswith("_pp")
            sw = args[7] if pp else args[6]
            q = f" Q={args[-1]}" if pp else ""
            tab = (f" (+ event tables {call[4][0].elapsed_time(call[4][1]):.1f} ms)"
                   if call[4] else "")
            out.append(f"{name} SW={sw}{q} {self.kernel_ms(call):.1f} ms{tab}")
        return out

    def split(self, wall: float) -> str:
        """The host layers of the calls since the last reset (host clock,
        summed over threads), what is left of ``wall``, and the kernels'
        time on the card (CUDA events), which overlaps the host layers
        (the readback wait is the host waiting for it)."""
        torch.cuda.synchronize()
        kernel = sum(self.kernel_ms(c) for c in self.calls) / 1e3
        tables = sum(a.elapsed_time(b) for a, b in self.table_events)
        rest = wall - sum(self.host.values())
        return (", ".join(f"{k} {v:.3f} s" for k, v in self.host.items())
                + f", other {rest:.3f} s; event tables on the card {tables:.3f} ms; "
                f"kernels on the card {kernel:.3f} s ({kernel / wall:.3f} of the wall)")

    def remove(self):
        for name, fn in self._orig.items():
            setattr(runner, name, fn)
        for _, obj, attr, fn in self._orig_host:
            setattr(obj, attr, fn)


def _verify(pairs, results, costs=None) -> None:
    for i, ((a, b), (c, cig)) in enumerate(zip(pairs, results)):
        if cig.verify(a, b) != c or (costs is not None and c != costs[i]):
            fail(f"pair {i}: CIGAR does not verify at its cost")


def _pp_route(sw: int, ck: bool) -> str:
    """The kernel the runner sends a domain round of ``sw`` words to (its
    launch key): K4's ring below ``PINNED_PP_MIN_SW`` (the runner's
    intervals are at least SW + 8), else ring K10 (checkpoints) or ring K9
    (costs) where the ring holds the band, the stripe K10 or K9 past it."""
    if sw < runner.PINNED_PP_MIN_SW:
        return "banded_ring_ck_pp" if ck else "banded_ring_pp"
    if ck:
        return "ring_ck_pp" if banded_kernel.ring_takes(sw) else "pinned_ck_pp"
    return "ring_cost_pp" if banded_kernel.ring_takes(sw) else "pinned_cost_pp"


def _last_round(spy: RoundSpy, ck: bool) -> tuple[str, tuple]:
    """(kernel, arguments) of the last domain round since the spy's reset."""
    names = (("ring_ck_pp", "pinned_ck_pp", "banded_ring_ck_pp", "banded_ck_pp") if ck
             else ("ring_cost_pp", "pinned_cost_pp", "banded_ring_pp", "banded_cost_pp"))
    calls = [c for c in spy.calls if c[0] in names]
    if not calls:
        fail(f"no domain round ({' or '.join(names)}) was launched")
    return calls[-1][0], calls[-1][1]


def _check_round(spy: RoundSpy, st, ck: bool, label: str) -> tuple:
    """The last domain round ran the kernel its band routes to, and the
    stats name it; returns its arguments."""
    name, args = _last_round(spy, ck)
    want = _pp_route(args[7], ck)
    if name != want or st.kernel != banded_kernel.route(torch.device("cuda"), name):
        fail(f"{label}: round of SW={args[7]} ran {name} (stats {st.kernel!r}), "
             f"routing says {want} (PINNED_PP_MIN_SW={runner.PINNED_PP_MIN_SW})")
    return args


def phase7_config4(spy: RoundSpy) -> tuple[dict, tuple, tuple, tuple]:
    """Config #4 through the default BatchAligner, then 128 x 40 kbp e=5%
    pairs whose gcsh rounds fall below ``PINNED_PP_MIN_SW`` (K4's place on
    the main path); returns the launch counts of both runs, config #4's
    last cost round's arguments, ``(pairs, costs, {pair:
    levenshtein_myers})`` of config #4 for phase 20 and its last checkpoint
    round's arguments (ring K10's) for phase 32."""
    t0 = time.perf_counter()
    pairs = _pool(_uniform, [(C4_LENGTH, C4_ERR, C4_SEED + s) for s in range(C4_PAIRS)])
    bp = sum(len(a) for a, _ in pairs)
    ba = BatchAligner(device="cuda")
    mode = ba._resolve_domain_mode(pairs, list(range(len(pairs))), want_cigars=False)
    if mode != "gcsh":
        fail(f"config #4 resolved to domain mode {mode!r}, not 'gcsh'")
    say(f"[7 config4] {C4_PAIRS} x {C4_LENGTH} bp e={C4_ERR} generated in "
        f"{time.perf_counter() - t0:.1f} s; domain mode {mode}")
    banded_kernel.reset_launches()
    spy.reset()
    costs1, _ = ba.cost_with_stats(pairs)
    torch.cuda.synchronize()
    first = (spy.rounds(), spy.host["gcsh build"])
    spy.reset()
    t0 = time.perf_counter()
    costs, st = ba.cost_with_stats(pairs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rounds, split = spy.rounds(), spy.split(dt)
    c4_round = _check_round(spy, st, False, "config #4 cost")
    if not (costs == costs1).all() or (costs < 0).any():
        fail("config #4 cost: runs disagree")
    picks = np.linspace(0, C4_PAIRS - 1, C4_ORACLE).astype(int)
    with ThreadPoolExecutor(C4_ORACLE) as ex:
        want = list(ex.map(lambda i: att.oracle.levenshtein_myers(*pairs[i]), picks))
    agree = sum(int(costs[i]) == w for i, w in zip(picks, want))
    if agree != C4_ORACLE:
        fail(f"config #4: {agree}/{C4_ORACLE} costs equal levenshtein_myers")
    c4_costs, c4_oracle = costs, dict(zip(picks.tolist(), want))
    say(f"[7 cost] 1st call rounds [{', '.join(first[0])}], gcsh build {first[1]:.3f} s; "
        f"2nd call {dt:.4f} s = {bp / dt / 1e6:.3f} Mbp/s: f-rounds {len(rounds)} "
        f"[{', '.join(rounds)}] (CUDA events), retries {st.band_retries}, cells "
        f"{st.cells_computed}, kernel {st.kernel}; levenshtein_myers {agree}/{C4_ORACLE}")
    say(f"[7 cost split] 2nd call, host clock and CUDA events: {split}")
    routes = {_pp_route(c4_round[7], False)}
    for label, direct in (("direct", True), ("ck", False)):
        ba.direct_dt = direct
        spy.reset()
        t0 = time.perf_counter()
        res, st = ba.align_with_stats(pairs)
        dt = time.perf_counter() - t0
        rounds, split = spy.rounds(), spy.split(dt)
        _verify(pairs, res, costs)
        if direct == (st.direct_traces == 0):
            fail(f"config #4 align ({label}): direct traces {st.direct_traces}")
        if not direct:
            c4_ck_round = _check_round(spy, st, True, "config #4 align ck")
            routes.add(_pp_route(c4_ck_round[7], True))
        say(f"[7 align {label}] {dt:.4f} s = {bp / dt / 1e6:.3f} Mbp/s cost+CIGAR, "
            f"{C4_PAIRS} CIGARs verified; direct traces {st.direct_traces}; f-rounds "
            f"{len(rounds)} [{', '.join(rounds)}], kernel {st.kernel}; split: {split}")

    t0 = time.perf_counter()
    small = _pool(_uniform, [(C40_LENGTH, C40_ERR, C40_SEED + s) for s in range(C40_PAIRS)])
    bp40 = sum(len(a) for a, _ in small)
    ba = BatchAligner(device="cuda")
    mode = ba._resolve_domain_mode(small, list(range(len(small))), want_cigars=False)
    if mode != "gcsh":
        fail(f"the 40 kbp pairs resolved to domain mode {mode!r}, not 'gcsh'")
    gen_s = time.perf_counter() - t0
    spy.reset()
    t0 = time.perf_counter()
    costs, st = ba.cost_with_stats(small)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rounds = spy.rounds()
    sw40 = _check_round(spy, st, False, "40 kbp cost")[7]
    if (costs < 0).any():
        fail("40 kbp cost left a pair uncertified")
    picks = np.linspace(0, C40_PAIRS - 1, 4).astype(int)
    with ThreadPoolExecutor(len(picks)) as ex:
        want = list(ex.map(lambda i: att.oracle.levenshtein_myers(*small[i]), picks))
    if [int(costs[i]) for i in picks] != want:
        fail("40 kbp costs differ from levenshtein_myers")
    ba.direct_dt = False
    spy.reset()
    t1 = time.perf_counter()
    res, sta = ba.align_with_stats(small)
    dta = time.perf_counter() - t1
    rounds_a = spy.rounds()
    sw40_ck = _check_round(spy, sta, True, "40 kbp align ck")[7]
    _verify(small, res, costs)
    routes |= {_pp_route(sw40, False), _pp_route(sw40_ck, True)}
    say(f"[7 40kbp] {C40_PAIRS} x {C40_LENGTH} bp e={C40_ERR} (generated in {gen_s:.1f} s), "
        f"domain mode {mode}: cost {dt:.4f} s = {bp40 / dt / 1e6:.3f} Mbp/s, f-rounds "
        f"[{', '.join(rounds)}], kernel {st.kernel}, levenshtein_myers 4/4; align "
        f"direct_dt=False {dta:.4f} s, {C40_PAIRS} CIGARs verified, f-rounds "
        f"[{', '.join(rounds_a)}], kernel {sta.kernel}")
    launches = dict(banded_kernel.LAUNCHES)
    for name in routes | {"banded_ring_pp", "banded_ring_ck_pp"}:
        if not launches[name]:
            fail(f"phase 7 never launched {name}")
    if launches["banded_cost_pp"] or launches["banded_ck_pp"]:
        fail(f"phase 7 launched the old K4 {launches['banded_cost_pp']} + "
             f"{launches['banded_ck_pp']} times")
    if launches["pinned_ck_pp"] and "pinned_ck_pp" not in routes:
        fail(f"phase 7 launched the stripe K10 {launches['pinned_ck_pp']} times")
    return launches, c4_round, (pairs, c4_costs, c4_oracle), c4_ck_round


def phase8_ck(spy: RoundSpy) -> tuple[dict, tuple]:
    """K2 on the main path: one 512-pair 10 kbp align with direct_dt=False
    (K2's ring; the old K2 must not run); returns the launch counts of its
    run, and its pairs and costs."""
    pairs = _generate(CK_PAIRS, LENGTH, ERR, SEED + 200)
    ba = BatchAligner(device="cuda", direct_dt=False)
    banded_kernel.reset_launches()
    spy.reset()
    t0 = time.perf_counter()
    res, st = ba.align_with_stats(pairs)
    dt = time.perf_counter() - t0
    launches = dict(banded_kernel.LAUNCHES)
    rounds = spy.rounds()
    if (not launches["banded_ring_ck"] or launches["banded_ck"] or st.direct_traces
            or st.kernel != "cuda-banded-ring-ck"):
        fail(f"ck align: K2's ring launches {launches['banded_ring_ck']}, the old K2's "
             f"{launches['banded_ck']}, direct traces {st.direct_traces}, kernel {st.kernel!r}")
    costs = BatchAligner(device="cuda").cost(pairs)
    _verify(pairs, res, costs)
    say(f"[8 ck align] {CK_PAIRS} x {LENGTH} bp e={ERR}, direct_dt=False: {dt:.4f} s "
        f"({dt / CK_PAIRS * 1e3:.4f} ms/pair), {CK_PAIRS} CIGARs verified at the K1 "
        f"costs; rungs [{', '.join(rounds)}], retries {st.band_retries}, kernel {st.kernel}; "
        f"launches K2's ring {launches['banded_ring_ck']}, the old K2 {launches['banded_ck']}")
    return launches, (pairs, costs)


def _turns(plain, kernels):
    """Plain, each kernel, each kernel again (CUDA events); returns (plain
    ms list, {kernel: ms list}, max_abs_err).  The plain version runs once:
    its time only sets the scale of the kernels' speed-up."""
    plain_ms, kernel_ms, outs = [], {k: [] for k in kernels}, {}
    for turn in ("plain", "kernels", "kernels"):
        if turn == "plain":
            ms, ref = _event_ms(plain)
            plain_ms.append(ms)
            continue
        for name, (fn, pick) in kernels.items():
            ms, outs[name] = _event_ms(fn)
            kernel_ms[name].append(ms)
    err = max(_max_err(outs[name], pick(ref)) for name, (_, pick) in kernels.items())
    return plain_ms, kernel_ms, err


def _old_k4(planes, sched, sw, q, cb=None):
    """The old one-thread-a-pair K4 (``csrc/banded.cu``), which the wrappers
    no longer run for these schedules: its internal launch."""
    if cb is None:
        return banded_kernel._launch("banded_cost_pp", *planes, sw, schedule=sched, quantum=q)
    return banded_kernel._launch("banded_ck_pp", *planes, sw, schedule=sched, quantum=q,
                                 col_block=cb)


def phase9_time(spy: RoundSpy) -> dict:
    """K2/K4 == plain at the main path's shapes (K4's last main-path round,
    the 40 kbp run of phase 7 when config #4 runs K9), and timed: K4's
    rings (the wrappers) and the old K4 (its internal launch); returns each
    kernel's JSON record (without the launch count)."""
    for name in ("banded_ring_ck", "banded_ring_pp", "banded_ring_ck_pp"):
        if name not in spy.last:
            fail(f"the main path never launched {name}")
    # K4 cost and ck on the main path's last K4 ck round, cut to its first
    # columns.
    *planes, sched, sw, cb, q = spy.last["banded_ring_ck_pp"]
    n_max = planes[0].shape[0]
    cut = min(CUT_COLS // 4, n_max)
    n_c = np.minimum(planes[4], cut).astype(np.int32)
    m_c = (planes[5].astype(np.int64) * n_c // np.maximum(planes[4], 1)).astype(np.int32)
    cplanes = tuple(x[:cut].contiguous() for x in planes[:2]) + (planes[2], planes[3], n_c, m_c)
    csched = np.ascontiguousarray(sched[:cut])
    cb = min(cb, cut // 4)  # a few checkpoints inside the cut
    plain_ms, ref = _event_ms(lambda: banded.banded_ck_pp_ref(*cplanes, csched, sw, cb, q))
    fns = {"banded_ring_ck_pp": lambda: banded_kernel.banded_ck_pp(*cplanes, csched, sw, cb, q),
           "banded_ring_pp": lambda: banded_kernel.banded_cost_pp(*cplanes, csched, sw, q),
           "banded_ck_pp": lambda: _old_k4(cplanes, csched, sw, q, cb),
           "banded_cost_pp": lambda: _old_k4(cplanes, csched, sw, q)}
    cut_ms, err_pp = {k: [] for k in fns}, 0
    for _ in range(2):
        for name, fn in fns.items():
            ms, got = _event_ms(fn)
            cut_ms[name].append(ms)
            err_pp = max(err_pp, _max_err(got, ref if name.endswith("ck_pp") else ref[0]))
    if err_pp:
        fail("K4 (ring or old) != plain on its main-path round's cut pack")
    cshape = {"B": planes[0].shape[1], "n_max": cut, "S": planes[2].shape[0], "SW": sw,
              "Q": q, "CB": banded.ck_col_block(cb, cut, q)}
    say(f"[9 K4 cut] K4 == plain on its last main-path round's pack and gcsh schedules, first "
        f"{cut} of {n_max} columns ({cshape}): " + ", ".join(
            f"{k} {v[0]:.3f}/{v[1]:.3f} ms" for k, v in cut_ms.items())
        + f" (ring keys: K4's ring, the wrapper's call; the others the old K4), plain "
        f"{plain_ms:.1f} ms; max_abs_err {err_pp} (CUDA events)")
    # K4 on K1's shared schedule, every pair, against K1 at the full shape.
    *planes, _, sw_c, _ = spy.last["banded_ring_pp"]
    n_max, S, B = planes[0].shape[0], planes[2].shape[0], planes[0].shape[1]
    shared = np.broadcast_to(banded.shift_at_array(n_max, S, sw_c)[:, None], (n_max, B))
    k1_ms, k1 = _event_ms(lambda: banded_kernel.banded_cost(*planes, sw_c))
    k4_ms, k4 = _event_ms(lambda: banded_kernel.banded_cost_pp(*planes, shared, sw_c, 1))
    err_full = _max_err(k4, k1)
    if err_full:
        fail("K4's ring on the shared schedule != K1 at its round's full shape")
    full_shape = {"B": B, "n_max": n_max, "S": S, "SW": sw_c}
    full_bound = plane_bound(planes, sw_c, [k4], n_max * B)["bound_ms"]
    say(f"[9 K4 full] K4's ring with K1's schedule == K1 at {full_shape}: K4 "
        f"{k4_ms:.3f} ms (tables included), K1 {k1_ms:.3f} ms, max_abs_err {err_full} "
        f"(CUDA events)")
    # K2 on phase 8's pack, cut to its first columns: K2's ring (the
    # wrapper's call) and the old K2 (its internal launch) in turns.
    *whole, sw_k2, cb_path, diag_path = spy.last["banded_ring_ck"]
    planes = _cut(whole, CUT_COLS)
    diag_k2 = _cut_diag(planes)
    cb_k2 = min(cb_path, CUT_COLS // 4)  # a few checkpoints inside the cut
    k2_plain_ms, k2_ref = _event_ms(lambda: banded.banded_ck_ref(*planes, sw_k2, cb_k2, diag_k2))

    def k2_fns(pl, cb, dg):
        return {"banded_ck": lambda: banded_kernel._launch("banded_ck", *pl, sw_k2, diag=dg,
                                                           col_block=cb),
                "banded_ring_ck": lambda: banded_kernel.banded_ck(*pl, sw_k2, cb, dg)}

    k2_cut, outs = _in_turns(k2_fns(planes, cb_k2, diag_k2),
                             ("banded_ck", "banded_ring_ck", "banded_ring_ck", "banded_ck"))
    err_k2 = max(_max_err(outs[k], k2_ref) for k in outs)
    if err_k2:
        fail("K2 (ring or old) != plain on the ck align pack")
    k2_shape = {"B": planes[0].shape[1], "n_max": planes[0].shape[0],
                "S": planes[2].shape[0], "SW": sw_k2, "CB": cb_k2}
    say(f"[9 ck pack] K2 == plain on phase 8's pack cut to {CUT_COLS} columns {k2_shape} "
        f"diag={diag_k2}, turns old, ring, ring, old: K2's ring "
        f"{k2_cut['banded_ring_ck'][0]:.3f}/{k2_cut['banded_ring_ck'][1]:.3f} ms, the old K2 "
        f"{k2_cut['banded_ck'][0]:.3f}/{k2_cut['banded_ck'][1]:.3f} ms, plain "
        f"{k2_plain_ms:.1f} ms, max_abs_err {err_k2} (CUDA events)")
    # The whole pack, at the path's CB and diagonal: K2's ring against the
    # old K2 in turns.
    k2_whole, outs = _in_turns(k2_fns(whole, cb_path, diag_path),
                               ("banded_ck", "banded_ring_ck", "banded_ring_ck", "banded_ck"))
    err_whole = _max_err(outs["banded_ring_ck"], outs["banded_ck"])
    if err_whole:
        fail("K2's ring != the old K2 on phase 8's whole pack")
    whole_shape = {"B": whole[0].shape[1], "n_max": whole[0].shape[0], "S": whole[2].shape[0],
                   "SW": sw_k2, "CB": banded.ck_col_block(cb_path, whole[0].shape[0])}
    whole_bound = plane_bound(whole, sw_k2, outs["banded_ck"])
    lay = banded_kernel.banded_ring_layout(
        striped.ring_span(striped.plan_striped(whole[0].shape[0], whole[2].shape[0], sw_k2,
                                               diag_path), int(np.max(whole[4]))),
        whole[0].shape[1], max_words=banded_kernel.RING_K4_MAX_WORDS)
    say(f"[9 ck whole] phase 8's whole pack {whole_shape} (K2's ring: {lay['lanes']} lanes a "
        f"pair, {lay['pairs']} pairs a warp), turns old, ring, ring, old: K2's ring "
        f"{k2_whole['banded_ring_ck'][0]:.3f}/{k2_whole['banded_ring_ck'][1]:.3f} ms "
        f"({min(k2_whole['banded_ring_ck']) / whole_bound['bound_ms']:.1f}x), the old K2 "
        f"{k2_whole['banded_ck'][0]:.3f}/{k2_whole['banded_ck'][1]:.3f} ms "
        f"({min(k2_whole['banded_ck']) / whole_bound['bound_ms']:.1f}x) vs bound "
        f"{whole_bound['bound_ms']:.4f} ms ({whole_bound['bound_by']}); equal on costs, every "
        f"checkpoint row and top value (CUDA events)")
    def record(name, ms, plain, shape, err, bnd, **extra):
        return {"max_abs_err": err, "ms": float(np.mean(ms)), "plain_ms": plain,
                **bnd, "library_ms": None, "shape": shape, **extra}

    sched_bytes = csched.size
    cost_bnd = plane_bound(cplanes, sw, ref[:1], sched_bytes)
    ck_bnd = plane_bound(cplanes, sw, ref, sched_bytes)
    k2_bnd = plane_bound(planes, sw_k2, k2_ref)
    return {
        "banded_ck": record("banded_ck", k2_cut["banded_ck"], k2_plain_ms, k2_shape,
                            max(err_k2, err_whole), k2_bnd, whole_ms=k2_whole["banded_ck"],
                            whole_shape=whole_shape, whole_bound_ms=whole_bound["bound_ms"]),
        "banded_ring_ck": record("banded_ring_ck", k2_cut["banded_ring_ck"], k2_plain_ms,
                                 k2_shape, max(err_k2, err_whole), k2_bnd,
                                 whole_ms=k2_whole["banded_ring_ck"], whole_shape=whole_shape,
                                 whole_bound_ms=whole_bound["bound_ms"], lanes=lay["lanes"]),
        "banded_ring_pp": record("banded_ring_pp", cut_ms["banded_ring_pp"], plain_ms, cshape,
                                 err_pp, cost_bnd, full_ms=k4_ms,
                                 full_shape=full_shape, full_k1_ms=k1_ms,
                                 full_bound_ms=full_bound),
        "banded_ring_ck_pp": record("banded_ring_ck_pp", cut_ms["banded_ring_ck_pp"], plain_ms,
                                    cshape, err_pp, ck_bnd),
        "banded_cost_pp": record("banded_cost_pp", cut_ms["banded_cost_pp"], plain_ms, cshape,
                                 err_pp, cost_bnd),
        "banded_ck_pp": record("banded_ck_pp", cut_ms["banded_ck_pp"], plain_ms, cshape,
                               err_pp, ck_bnd),
    }


def _stripes(planes, sw: int, diag):
    """K5's stripes on a shared cost rung (the cost ring takes bands of up
    to 16384 words by default), at their default stripe height."""
    stripe = 8 * banded_kernel.striped_threads(min(sw, planes[2].shape[0]))
    return banded_kernel.striped_cost(*planes, sw, diag, stripe)


def phase10_grid() -> tuple[int, tuple, tuple, tuple, list]:
    """K5 and K6 == plain on a grid; returns the max abs difference over
    costs, every checkpoint row (the zero rows outside the true windows
    included) and every top value, the grid's 160- and 33-lane packs
    (phase 22 reuses them), its diagonal, and each checkpoint case with
    its plain result (phase 27 holds ring K6 against them).  K5 is held against the costs of the plain ck
    sweep where K6 applies: the plain versions are one loop."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    pairs = [att.generate.uniform_seeded(int(rng.integers(1, 1501)),
                                         float(rng.uniform(0, 0.25)), 5000 + s)
             for s in range(160)]
    pairs[1] = (b"", b"ACGTACGTAC")  # an n == 0 lane
    m_top = max(len(b) for _, b in pairs)
    # A skewed pair makes S ~ 280 words: bands taller than a 256-word stripe.
    pairs[2] = (pairs[2][0][:300] or b"A", att.generate.uniform_seeded(9000, 0.1, 4999)[0])
    wide, _ = pack_batch_staggered(pairs, 1, device="cuda")
    n_max, S = wide[0].shape[0], wide[2].shape[0]
    diag = (n_max, m_top)
    narrow = _lanes(wide, 33)
    s8 = S // 8 * 8
    cases = [(narrow, 8, diag, 64, None), (wide, 16, diag, 64, None),
             (wide, 24, None, 512, None), (narrow, 64, diag, 512, None),
             (wide, 200, diag, 512, None), (wide, s8, None, 512, 256),
             (narrow, s8, diag, 512, 256), (wide, S, None, None, None),
             (narrow, S, None, None, 256)]
    worst, labels, saved = 0, [], []
    for planes, sw, dg, cb, ws in cases:
        sw_eff = min(sw, S)
        if cb is not None:
            # The stripe kernel (ring K6 takes these bands by default: phase 27).
            want = striped.striped_ck_ref(*planes, sw, cb, dg)
            stripe = ws or 8 * banded_kernel.striped_threads(sw_eff)
            err = _max_err(banded_kernel.striped_ck(*planes, sw, cb, dg, stripe), want)
            saved.append((planes, sw_eff, dg, cb, want))
            want = want[0]
        else:
            want = striped.striped_cost_ref(*planes, sw, dg)
            err = 0
        # The stripe kernel (the cost ring takes these bands by default).
        stripe = ws or 8 * banded_kernel.striped_threads(sw_eff)
        err = max(err, _max_err(banded_kernel.striped_cost(*planes, sw, dg, stripe), want))
        label = (f"B={planes[0].shape[1]} SW={sw_eff}{' (full)' if sw_eff == S else ''} "
                 f"CB={cb} stripe={ws or 8 * banded_kernel.striped_threads(sw_eff)} "
                 f"diag={'set' if dg else 'None'}")
        if err:
            fail(f"K5/K6 != plain at {label}")
        worst = max(worst, err)
        labels.append(label)
    torch.cuda.synchronize()
    say(f"[10 striped=plain] {len(cases)}/{len(cases)} cases (n_max {n_max}, S {S}: "
        f"{'; '.join(labels)}); max_abs_err {worst}, {time.perf_counter() - t0:.1f} s")
    return worst, wide, narrow, diag, saved


COST_KEYS = ("banded_ring", "banded_cost", "striped_cost", "pinned_cost", "ring_cost_wide")


def _cost_route(args) -> str:
    """The kernel a shared cost rung runs by the runner's routing, from the
    rung's arguments (planes, SW, diag): K1 (its ring kernel), the ring (K7,
    or the wide ring past 4096 live words) or K5's stripes."""
    *planes, sw, diag = args
    if sw < runner.STRIPED_MIN_SW:
        return "banded_ring"
    if not banded_kernel.pinned_cost_takes(sw):
        return "striped_cost"
    return banded_kernel.pinned_cost_kernel(planes[0].shape[0], planes[2].shape[0], sw, diag,
                                            planes[4])


def _check_cost_rungs(calls, label: str) -> list[str]:
    """Every recorded shared cost rung ran the kernel the routing names;
    returns the kernels that ran."""
    names = []
    for name, args, *_ in calls:
        if name in COST_KEYS:
            want = _cost_route(args)
            if name != want:
                fail(f"{label}: a rung of SW={args[6]} ran {name}, routing says {want} "
                     f"(STRIPED_MIN_SW={runner.STRIPED_MIN_SW}, the cost ring "
                     f"{banded_kernel.RING_COST_MAX_WORDS} words, K7's "
                     f"{banded_kernel.RING_MAX_WORDS})")
            names.append(name)
    if not names:
        fail(f"{label}: no cost rung was recorded")
    return names


def phase11_config5() -> tuple[dict, RoundSpy, tuple]:
    """Config #5 through the big shared band (K7 for costs up to 4096 live
    words, the wide ring past them; for checkpoints ring K6 up to the ring,
    the stripe K6 past it): costs, a cost stream, costs from a band past
    K7's ring, an align stream and an align from a band past the ring;
    returns the
    launch counts of its run, the spy holding each kernel's last inputs,
    and ``(pairs of seed 7, their costs, {pair: levenshtein_myers})`` for
    phase 14."""
    t0 = time.perf_counter()
    sets = {s: _generate(C5_PAIRS, C5_LENGTH, C5_ERR, s) for s in C5_SEEDS}
    p7, p8 = (sets[s] for s in C5_SEEDS)
    bp = sum(len(a) for a, _ in p7)
    say(f"[11 config5] {C5_PAIRS} x {C5_LENGTH} bp e={C5_ERR}, seeds {C5_SEEDS}, "
        f"generated in {time.perf_counter() - t0:.1f} s on {WORKERS} processes")
    spy = RoundSpy(("pinned_cost", "striped_cost", "striped_ck", "banded_cost", "banded_ck"))
    spy.install()
    banded_kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ba = BatchAligner(device="cuda", band_words=C5_BAND, domain_mode="off")
    costs1, st1 = ba.cost_with_stats(p7)
    torch.cuda.synchronize()
    first = spy.rounds()
    spy.reset()
    t0 = time.perf_counter()
    costs, st = ba.cost_with_stats(p7)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rungs, split = spy.rounds(), spy.split(dt)
    ran = _check_cost_rungs(spy.history + spy.calls, "config #5 cost")
    if st.kernel != "cuda-pinned" or not (costs == costs1).all() or (costs < 0).any():
        fail(f"config #5 cost: kernel {st.kernel!r}, or runs disagree")
    say(f"[11 cost] 1st call rungs [{', '.join(first)}], retries {st1.band_retries}; "
        f"2nd call {dt:.4f} s = {bp / dt / 1e6:.3f} Mbp/s: rungs [{', '.join(rungs)}] "
        f"(CUDA events), retries {st.band_retries}, cells {st.cells_computed}, "
        f"kernel {st.kernel}; every cost rung ran the routed wrapper ({', '.join(ran)})")
    say(f"[11 cost split] 2nd call, host clock and CUDA events: {split}")

    spy.reset()
    marks, outs = [time.perf_counter()], []
    for c, _ in ba.cost_iter(iter([p7, p8, p7, p8])):
        outs.append(c)
        marks.append(time.perf_counter())
    diffs = np.diff(marks)
    # bench.py's min over [1:] takes the drain period (the last batch's
    # kernel alone, its pack already done); [1:-1] are the mid-stream ones.
    period, drain_min = float(diffs[1:-1].min()), float(diffs[1:].min())
    median = float(np.median(diffs[1:-1]))
    if not ((outs[0] == costs).all() and (outs[2] == costs).all()
            and (outs[1] == outs[3]).all()):
        fail("config #5 cost_iter disagrees with cost_with_stats")
    ran_iter = _check_cost_rungs(spy.calls, "config #5 cost_iter")
    if "pinned_cost" not in ran_iter:
        fail(f"config #5 cost_iter ran no K7 rung ({ran_iter})")
    say(f"[11 cost_iter] 4 batches (seeds 7, 8, 7, 8): periods "
        f"{', '.join(f'{x:.4f}' for x in diffs)} s; mid-stream min {period:.4f} s = "
        f"{bp / period / 1e6:.3f} Mbp/s, median {median:.4f} s = {bp / median / 1e6:.3f} "
        f"Mbp/s (min over [1:], drain included, {drain_min:.4f} s "
        f"= {bp / drain_min / 1e6:.3f} Mbp/s); rungs [{', '.join(spy.rounds())}]")

    picks = [(p7, i) for i in range(4)] + [(p8, i) for i in range(4)]
    with ThreadPoolExecutor(len(picks)) as ex:
        want = list(ex.map(lambda pi: att.oracle.levenshtein_myers(*pi[0][pi[1]]), picks))
    got = [int(costs[i]) for i in range(4)] + [int(outs[1][i]) for i in range(4)]
    if got != want:
        fail(f"config #5 costs {got} != levenshtein_myers {want}")

    # The wide ring's place on the path: a band past K7's 4096-word ring,
    # which the ladder reaches from 2048 words in two doublings.
    spy.reset()
    t0 = time.perf_counter()
    costs5, st5 = BatchAligner(device="cuda", band_words=C5_K5_BAND,
                               domain_mode="off").cost_with_stats(p7)
    torch.cuda.synchronize()
    dt5 = time.perf_counter() - t0
    ran5 = _check_cost_rungs(spy.calls, "config #5 cost past the ring")
    if set(ran5) != {"ring_cost_wide"} or st5.kernel != "cuda-ring-wide":
        fail(f"config #5 cost at band_words={C5_K5_BAND} ran {ran5} (stats {st5.kernel!r})")
    if not (costs5 == costs).all():
        fail(f"config #5 costs at band_words={C5_K5_BAND} differ from band_words={C5_BAND}'s")
    *w_planes, w_sw, w_dg = spy.last["ring_cost_wide"]
    w_plan = striped.plan_striped(w_planes[0].shape[0], w_planes[2].shape[0], w_sw, w_dg)
    w_span = striped.ring_span(w_plan, int(np.max(w_planes[4], initial=1)))
    w_threads, w_words = banded_kernel.ring_cost_layout(w_span)
    say(f"[11 cost past the ring] BatchAligner(band_words={C5_K5_BAND}, domain_mode='off')"
        f".cost_with_stats, one call: {dt5:.4f} s = {bp / dt5 / 1e6:.3f} Mbp/s (on K5's "
        f"stripes before the wide ring: 64.172 Mbp/s): rungs [{', '.join(spy.rounds())}] (CUDA events), the wide "
        f"ring: {w_span} live words in {w_threads * w_words} ({w_threads} threads of 8 register "
        f"and {w_words - 8} shared slots), {w_plan['n_words_live'] / (w_threads * w_words):.2f} "
        f"laps, retries {st5.band_retries}, kernel {st5.kernel}; costs == "
        f"band_words={C5_BAND}'s on all {len(costs5)} pairs")

    bac = BatchAligner(device="cuda", band_words=C5_BAND, domain_mode="off",
                       ck_col_block=C5_CB)
    stream = [p7, p8, p7, p8, p7]
    spy.reset()
    marks, results = [time.perf_counter()], []
    for res, st_a in bac.align_iter(iter(stream)):
        results.append((res, st_a))
        marks.append(time.perf_counter())
    wall = marks[-1] - marks[0]
    periods = np.diff(marks)[1:-2]  # [0] is the fill, [-2:] the drain
    rungs_a, split_a = spy.rounds(), spy.split(wall)
    if len(results) != len(stream):
        fail("config #5 align_iter lost a batch")
    CK_KEYS = ("ring_ck", "striped_ck", "pinned_ck", "banded_ck", "ring_ck_exact",
               "banded_ring_ck")
    ck_ran = {c[0] for c in spy.calls if c[0] in CK_KEYS}
    if ck_ran != {"ring_ck"} or {st_a.kernel for _, st_a in results} != {"cuda-ring-ck"}:
        fail(f"config #5 align_iter ran {ck_ran} (stats {results[-1][1].kernel!r}), "
             f"not ring K6 alone")
    jobs = []
    for pairs, (res, st_a), want_c in zip(stream, results, [costs, outs[1]] * 2 + [costs]):
        if [c for c, _ in res] != [int(x) for x in want_c] or st_a.direct_traces:
            fail("config #5 align_iter costs differ from the cost path, or traced directly")
        jobs.extend((a, b, cig.to_string(), c) for (a, b), (c, cig) in zip(pairs, res))
    t0 = time.perf_counter()
    # The stream repeats its two batches, and a verification is a function
    # of its job: each distinct (pair, CIGAR, cost) is verified once.
    distinct = list(dict.fromkeys(jobs))
    ok = _pool(_verify_job, distinct)
    if not all(ok):
        fail(f"config #5: {len(ok) - sum(ok)} CIGARs do not verify at their cost")
    say(f"[11 align] align_iter ck_col_block={C5_CB}, 5 batches: {len(jobs)} CIGARs "
        f"verified at the cost path's costs ({len(distinct)} distinct, "
        f"{time.perf_counter() - t0:.1f} s on {WORKERS} processes); periods {', '.join(f'{x:.4f}' for x in np.diff(marks))} s; "
        f"mid-stream [1:-2] min {periods.min():.4f} s = {bp / periods.min() / 1e6:.3f} Mbp/s, "
        f"median {np.median(periods):.4f} s = {bp / np.median(periods) / 1e6:.3f} Mbp/s "
        f"cost+CIGAR; kernel {results[-1][1].kernel}; rungs [{', '.join(rungs_a)}]")
    say(f"[11 align split] whole stream {wall:.3f} s, host clock and CUDA events: {split_a}")
    # The stripe K6's place on the path: a ck rung past the ring, which the
    # ladder reaches from 2048 words in two doublings.
    spy.reset()
    t0 = time.perf_counter()
    res8, st8 = BatchAligner(device="cuda", band_words=C5_K5_BAND, domain_mode="off",
                             ck_col_block=C5_CB).align_with_stats(p7)
    dt8 = time.perf_counter() - t0
    ran8 = [c[0] for c in spy.calls if c[0] in CK_KEYS]
    if ran8 != ["striped_ck"] or st8.kernel != "cuda-striped-ck":
        fail(f"config #5 align at band_words={C5_K5_BAND} ran {ran8} (stats {st8.kernel!r})")
    if [c for c, _ in res8] != [int(x) for x in costs] or st8.direct_traces:
        fail(f"config #5 align at band_words={C5_K5_BAND}: costs differ, or traced directly")
    ok8 = _pool(_verify_job, [(a, b, cig.to_string(), c) for (a, b), (c, cig) in zip(p7, res8)])
    if not all(ok8):
        fail(f"config #5 align at band_words={C5_K5_BAND}: {len(ok8) - sum(ok8)} CIGARs "
             f"do not verify")
    say(f"[11 align past the ring] BatchAligner(band_words={C5_K5_BAND}, domain_mode='off', "
        f"ck_col_block={C5_CB}).align_with_stats, one call: {dt8:.4f} s = "
        f"{bp / dt8 / 1e6:.3f} Mbp/s cost+CIGAR: rungs [{', '.join(spy.rounds())}] (CUDA "
        f"events), stripes of {banded_kernel.striped_threads(C5_K5_BAND) * 8} words, kernel "
        f"{st8.kernel}; costs == the cost path's, {len(ok8)} CIGARs verified; split: "
        f"{spy.split(dt8)}")
    say(f"[11 oracle] levenshtein_myers 8/8 (pairs 0-3 of seeds 7 and 8); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    spy.remove()
    launches = dict(banded_kernel.LAUNCHES)
    for name in ("pinned_cost", "ring_cost_wide", "ring_ck", "striped_ck"):
        if not launches[name]:
            fail(f"config #5 never launched {name}")
    return launches, spy, (p7, costs, dict(zip(range(4), want[:4])))


def phase12_time(spy: RoundSpy) -> dict:
    """K5, K7 and K6 (ring and stripe kernels) == plain at config #5's
    shapes, timed in turns, and K5 against K1 across bands on the cut;
    returns K5's, K7's and both K6 kernels' JSON records (without the
    launch counts; phases 23 and 28 add the whole-rung times)."""
    torch.cuda.synchronize()
    rung_ms = {name: [RoundSpy.kernel_ms(c) for c in spy.history + spy.calls
                      if c[0] == name]
               for name in ("pinned_cost", "ring_cost_wide", "ring_ck", "striped_ck")}
    # The main path's cost rungs ran K7; K5's stripes compute the same
    # function on the same inputs.
    *planes, sw, diag = spy.last["pinned_cost"]
    cut = _cut(planes, C5_CUT)
    dg = _cut_diag(cut)
    shape = {"B": cut[0].shape[1], "n_max": cut[0].shape[0], "S": cut[2].shape[0], "SW": sw}
    p5, k5, e5 = _turns(lambda: striped.striped_cost_ref(*cut, sw, dg), {
        "striped_cost": (lambda: _stripes(cut, sw, dg), lambda r: r),
        "pinned_cost": (lambda: banded_kernel.pinned_cost(*cut, sw, dg), lambda r: r)})
    *ck_planes, sw_ck, cb_path, _ = spy.last["ring_ck"]
    cut_ck = _cut(ck_planes, C5_CUT)
    dg_ck = _cut_diag(cut_ck)
    cb = sw_ck + 8  # the smallest interval K6 takes: a checkpoint inside the cut
    stripe = 8 * banded_kernel.striped_threads(sw_ck)
    p6, k6, e6 = _turns(lambda: striped.striped_ck_ref(*cut_ck, sw_ck, cb, dg_ck), {
        "ring_ck": (lambda: banded_kernel.striped_ck(*cut_ck, sw_ck, cb, dg_ck), lambda r: r),
        "striped_ck": (lambda: banded_kernel.striped_ck(*cut_ck, sw_ck, cb, dg_ck, stripe),
                       lambda r: r)})
    if e5 or e6:
        fail("K5/K7/K6 != plain on config #5's cut pack")
    ck_shape = {"B": cut_ck[0].shape[1], "n_max": cut_ck[0].shape[0],
                "S": cut_ck[2].shape[0], "SW": sw_ck, "CB": cb}
    say(f"[12 config5 cut] first {C5_CUT} columns, turns plain, kernels, kernels: "
        f"K5 {shape} {k5['striped_cost'][0]:.3f}/{k5['striped_cost'][1]:.3f} ms, K7 "
        f"{k5['pinned_cost'][0]:.3f}/{k5['pinned_cost'][1]:.3f} ms vs plain "
        f"{p5[0]:.1f} ms; K6 {ck_shape} ring {k6['ring_ck'][0]:.3f}/"
        f"{k6['ring_ck'][1]:.3f} ms, stripes {k6['striped_ck'][0]:.3f}/"
        f"{k6['striped_ck'][1]:.3f} ms vs plain {p6[0]:.1f} ms; max_abs_err "
        f"{max(e5, e6)} (CUDA events)")
    def record(turns_ms, plain_ms, planes_, sw_, outs, shp):
        return {"max_abs_err": max(e5, e6), "ms": float(np.mean(turns_ms)),
                "plain_ms": float(np.mean(plain_ms)),
                **plane_bound(planes_, sw_, outs), "library_ms": None, "shape": shp}

    def rung(rec, name, full_planes, full_sw):
        # Every launch on the main path at its full shape (the last
        # launch's shape and bound).
        rec.update({"rung_ms": rung_ms[name],
                    "rung_bound_ms": plane_bound(full_planes, full_sw, [])["bound_ms"],
                    "rung_shape": {"B": full_planes[0].shape[1],
                                   "n_max": full_planes[0].shape[0],
                                   "S": full_planes[2].shape[0], "SW": full_sw}})
        return rec

    cost_out = [torch.empty(cut[0].shape[1], dtype=torch.int32)]
    ck_out = banded_kernel.striped_ck(*cut_ck, sw_ck, cb, dg_ck)
    *k6_planes, k6_sw, _, _ = spy.last["striped_ck"]
    *w_planes, w_sw, _ = spy.last["ring_cost_wide"]
    # K5's stripes run no rung of the path (phase 30 times them on the whole
    # rungs beside the rings).
    return {
        "striped_cost": record(k5["striped_cost"], p5, cut, sw, cost_out, shape),
        "ring_cost_wide": rung({}, "ring_cost_wide", w_planes, w_sw),
        "pinned_cost": rung(record(k5["pinned_cost"], p5, cut, sw, cost_out, shape),
                            "pinned_cost", planes, sw),
        "ring_ck": rung(record(k6["ring_ck"], p6, cut_ck, sw_ck, ck_out, ck_shape),
                        "ring_ck", ck_planes, sw_ck),
        "striped_ck": rung(record(k6["striped_ck"], p6, cut_ck, sw_ck, ck_out, ck_shape),
                           "striped_ck", k6_planes, k6_sw),
    }


def _pp_random(rng, n_max: int, B: int, quantum: int) -> np.ndarray:
    """:func:`_random_schedule` with column 0 unshifted (the pinned
    kernels' condition)."""
    sched = _random_schedule(rng, n_max, B, quantum)
    sched[0] = 0
    return sched


def phase13_grid() -> tuple[int, list, list]:
    """K9 and K10 (their stripe kernels) == plain on a grid; returns the max
    abs difference over costs, every checkpoint row and every top value,
    each case with its plain costs, for phase 27 (which holds ring K9
    against them), and each checkpoint case with its plain results, for
    phase 32 (ring K10).  K9 is held against the costs of
    the plain ck sweep where a case has an interval: the plain versions
    are one loop."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    pairs = [att.generate.uniform_seeded(int(rng.integers(1, 1501)),
                                         float(rng.uniform(0, 0.25)), 6000 + s)
             for s in range(160)]
    pairs[1] = (b"", b"ACGTACGTAC")  # an n == 0 lane
    # A skewed pair makes S ~ 280 words: bands taller than a 256-word stripe.
    pairs[2] = (pairs[2][0][:300] or b"A", att.generate.uniform_seeded(9000, 0.1, 5999)[0])
    wide, _ = pack_batch_staggered(pairs, 1, device="cuda")
    n_max, S = wide[0].shape[0], wide[2].shape[0]
    narrow = _lanes(wide, 33)

    def gap(planes, sw):
        return banded.pair_gap_schedule(planes[4], planes[5], sw, n_max, S)[0]

    def shared(sw, B):
        return np.broadcast_to(banded.shift_at_array(n_max, S, sw)[:, None], (n_max, B))

    g, sw_g, q_g = _gcsh_schedules(pairs, len(pairs), n_max, 1.25)
    s8 = S // 8 * 8
    cases = [
        (narrow, "gap", gap(narrow, 8), 8, 32, 64, None),
        (wide, "gap", gap(wide, 24), 24, 32, 512, None),
        (wide, "random", _pp_random(rng, n_max, len(pairs), 8), 16, 8, 64, None),
        (narrow, "random", _pp_random(rng, n_max, 33, 1), 64, 1, 512, 256),
        (wide, "gcsh 1.25 h0", g, min(sw_g, S), q_g, 512, None),
        (wide, "shared", shared(s8, len(pairs)), s8, 1, 512, 256),
        (wide, "random", _pp_random(rng, n_max, len(pairs), 1), S, 1, 512, 256),
    ]
    worst, labels, saved, saved_ck = 0, [], [], []
    for planes, kind, sched, sw, q, cb, ws in cases:
        # The stripe kernels (ring K9 and ring K10 take these bands by
        # default: phases 27 and 32 hold them against the same plain results).
        stripe = ws or 8 * banded_kernel.striped_threads(min(sw, S))
        if cb is not None:
            want_ck = pinned.pinned_ck_pp_ref(*planes, sched, sw, cb, q)
            err = _max_err(banded_kernel.pinned_ck_pp(*planes, sched, sw, cb, q, stripe),
                           want_ck)
            saved_ck.append((planes, kind, sched, min(sw, S), q, cb, want_ck))
            want = want_ck[0]
        else:
            want, err = pinned.pinned_cost_pp_ref(*planes, sched, sw, q), 0
        saved.append((planes, kind, sched, min(sw, S), q, want))
        err = max(err, _max_err(banded_kernel.pinned_cost_pp(*planes, sched, sw, q, stripe),
                                want))
        label = (f"{kind} B={planes[0].shape[1]} SW={sw}{' (full)' if sw == S else ''} Q={q} "
                 f"CB={cb} stripe={ws or 8 * banded_kernel.striped_threads(sw)}")
        if err:
            fail(f"K9/K10 != plain at {label}")
        worst = max(worst, err)
        labels.append(label)
    torch.cuda.synchronize()
    say(f"[13 pinned=plain] {len(cases)}/{len(cases)} cases (n_max {n_max}, S {S}: "
        f"{'; '.join(labels)}); max_abs_err {worst}, {time.perf_counter() - t0:.1f} s")
    return worst, saved, saved_ck


def phase14_config5_default(p7, costs_off, oracle: dict) -> tuple[dict, RoundSpy]:
    """Config #5 at its default settings (gcsh domain ladder: ring K9
    costs, ring K10 checkpoints) on phase 11's first batch; returns the launch
    counts of its run and the spy holding each kernel's last inputs."""
    bp = sum(len(a) for a, _ in p7)
    ba = BatchAligner(device="cuda")
    mode = ba._resolve_domain_mode(p7, list(range(len(p7))), want_cigars=False)
    if mode != "gcsh":
        fail(f"config #5 at default settings resolved to domain mode {mode!r}, not 'gcsh'")
    spy = RoundSpy()
    spy.install()
    banded_kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    # The align call is the aligner's first; the timed cost call its second.
    t0 = time.perf_counter()
    res, sta = ba.align_with_stats(p7)
    dta = time.perf_counter() - t0
    rounds_a, split_a = spy.rounds(), spy.split(dta)
    _check_round(spy, sta, True, "config #5 default align")
    spy.reset()
    t0 = time.perf_counter()
    costs, st = ba.cost_with_stats(p7)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rounds, split = spy.rounds(), spy.split(dt)
    _check_round(spy, st, False, "config #5 default cost")
    if not (costs == costs_off).all():
        fail("config #5 default costs differ from phase 11's")
    if [c for c, _ in res] != [int(x) for x in costs] or sta.direct_traces:
        fail("config #5 default align: costs differ from the cost path, or traced directly")
    picks = [32, 64, 96, C5_PAIRS - 1]
    with ThreadPoolExecutor(len(picks)) as ex:
        oracle = {**oracle, **dict(zip(picks, ex.map(
            lambda i: att.oracle.levenshtein_myers(*p7[i]), picks)))}
    agree = sum(int(costs[i]) == w for i, w in oracle.items())
    if agree != len(oracle):
        fail(f"config #5 default: {agree}/{len(oracle)} costs equal levenshtein_myers")
    t1 = time.perf_counter()
    ok = _pool(_verify_job, [(a, b, cig.to_string(), c) for (a, b), (c, cig) in zip(p7, res)])
    if not all(ok):
        fail(f"config #5 default: {len(ok) - sum(ok)} CIGARs do not verify at their cost")
    say(f"[14 config5 default] BatchAligner(device='cuda'), domain mode {mode}, seed 7's "
        f"{C5_PAIRS} pairs: 2nd call (cost) {dt:.4f} s = {bp / dt / 1e6:.3f} Mbp/s cost: "
        f"f-rounds {len(rounds)} [{', '.join(rounds)}] (CUDA events), retries "
        f"{st.band_retries}, cells {st.cells_computed}, kernel {st.kernel}; costs == phase "
        f"11's; levenshtein_myers {agree}/{len(oracle)} (pairs {sorted(oracle)})")
    say(f"[14 cost split] 2nd call, host clock and CUDA events: {split}")
    say(f"[14 align] 1st call, align_with_stats {dta:.4f} s = {bp / dta / 1e6:.3f} Mbp/s "
        f"cost+CIGAR, {len(ok)} CIGARs verified at the cost path's costs "
        f"({time.perf_counter() - t1:.1f} s on {WORKERS} processes); f-rounds {len(rounds_a)} "
        f"[{', '.join(rounds_a)}], kernel {sta.kernel}; split: {split_a}")
    say(f"[14 memory] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated over the two calls)")
    spy.remove()
    launches = dict(banded_kernel.LAUNCHES)
    if any(launches[k] for k in ("banded_cost_pp", "banded_ck_pp", "banded_ring_pp",
                                 "banded_ring_ck_pp", "pinned_cost_pp", "pinned_ck_pp")):
        fail(f"config #5 default launched K4 or a stripe kernel: {launches}")
    for name in ("ring_cost_pp", "ring_ck_pp"):
        if not launches[name]:
            fail(f"config #5 default never launched {name}")
    return launches, spy


def _cut_round(round_args, cols: int):
    """A domain round's planes and schedule cut to their first ``cols``
    columns: ``(planes, schedule, SW, Q)``."""
    *planes, sched, sw, q = round_args
    return _cut(planes, cols), np.ascontiguousarray(sched[:cols]), sw, q


def phase15_time(spy: RoundSpy) -> dict:
    """K9 and K10 (ring and stripe kernels each) == plain at config #5's
    default shapes, timed in turns; returns both K9 kernels' and both K10
    kernels' JSON records (without the launch counts)."""
    torch.cuda.synchronize()
    round_ms = {name: [RoundSpy.kernel_ms(c) for c in spy.history + spy.calls
                       if c[0] == name]
                for name in ("ring_cost_pp", "ring_ck_pp")}
    full = {name: spy.last[name] for name in round_ms}
    full["pinned_cost_pp"] = full["ring_cost_pp"]
    full["pinned_ck_pp"] = full["ring_ck_pp"]
    # The stripe K9 and K10 run no round of this path (phase 32 times the
    # stripe K10 on the whole rounds beside ring K10).
    round_ms["pinned_cost_pp"] = round_ms["pinned_ck_pp"] = []
    cut, sched, sw, q = _cut_round(full["ring_cost_pp"], C5_CUT)
    cb = sw  # the smallest interval K10 takes: checkpoints inside the cut
    stripe = 8 * banded_kernel.striped_threads(sw)
    p, k, err = _turns(lambda: pinned.pinned_ck_pp_ref(*cut, sched, sw, cb, q), {
        "ring_cost_pp": (lambda: banded_kernel.pinned_cost_pp(*cut, sched, sw, q),
                         lambda r: r[0]),
        "pinned_cost_pp": (lambda: banded_kernel.pinned_cost_pp(*cut, sched, sw, q, stripe),
                           lambda r: r[0]),
        "ring_ck_pp": (lambda: banded_kernel.pinned_ck_pp(*cut, sched, sw, cb, q),
                       lambda r: r),
        "pinned_ck_pp": (lambda: banded_kernel.pinned_ck_pp(*cut, sched, sw, cb, q, stripe),
                         lambda r: r)})
    if err:
        fail("K9/K10 != plain on config #5's cut pack")
    shape = {"B": cut[0].shape[1], "n_max": cut[0].shape[0], "S": cut[2].shape[0],
             "SW": sw, "Q": q, "CB": banded.ck_col_block(cb, cut[0].shape[0], q)}
    say(f"[15 config5 cut] first {C5_CUT} columns of the default path's last K9 round "
        f"{shape}, turns plain, kernels, kernels: K9 ring "
        f"{k['ring_cost_pp'][0]:.3f}/{k['ring_cost_pp'][1]:.3f} ms, stripes "
        f"{k['pinned_cost_pp'][0]:.3f}/{k['pinned_cost_pp'][1]:.3f} ms, K10 ring "
        f"{k['ring_ck_pp'][0]:.3f}/{k['ring_ck_pp'][1]:.3f} ms, stripes "
        f"{k['pinned_ck_pp'][0]:.3f}/{k['pinned_ck_pp'][1]:.3f} ms (event tables "
        f"included) vs plain {p[0]:.1f} ms; max_abs_err {err} (CUDA events)")

    def record(name, outs):
        full_planes, full_sched, full_sw = full[name][:6], full[name][6], full[name][7]
        return {"max_abs_err": err, "ms": float(np.mean(k[name])),
                "plain_ms": float(np.mean(p)),
                **plane_bound(cut, sw, outs, sched.size), "library_ms": None, "shape": shape,
                # Every launch on the main path at its full shape (kernel
                # only: from the end of its event tables), and the last
                # launch's shape and bound.
                "round_ms": round_ms[name],
                "round_bound_ms": plane_bound(full_planes, full_sw, [], full_sched.size)["bound_ms"],
                "round_shape": {"B": full_planes[0].shape[1], "n_max": full_planes[0].shape[0],
                                "S": full_planes[2].shape[0], "SW": full_sw}}

    ck_out = banded_kernel.pinned_ck_pp(*cut, sched, sw, cb, q)
    return {"ring_cost_pp": record("ring_cost_pp", ck_out[:1]),
            "pinned_cost_pp": record("pinned_cost_pp", ck_out[:1]),
            "ring_ck_pp": record("ring_ck_pp", ck_out),
            "pinned_ck_pp": record("pinned_ck_pp", ck_out)}


def phase16_grid() -> int:
    """K11 == plain on B in {33, 1024}, n in [0, NW_GRID_N] (ragged, n == 0
    and m == 0 lanes), S from 1 word to full height and to ten stripes,
    bit for bit on both planes and the costs.  The 33-lane pack is the
    first lanes of the 1024-lane one, so one plain sweep serves both."""
    rng = np.random.default_rng(16)
    pairs = _random_pairs(rng, GRID_PAIRS, NW_GRID_N, NW_GRID_N)
    pairs[3] = (pairs[3][0], b"")  # an m == 0 lane: cost n
    tall = pairs[2][1] + bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 8500).tolist())
    worst, labels = 0, []
    t0 = time.perf_counter()
    for words_ in (1, 8, 32, 33, None, 313):  # None: full height (47 words)
        if words_ == 313:
            sub = pairs[:2] + [(pairs[2][0], tall)] + pairs[3:]
        else:
            sub = [(a, b[: 32 * words_] if words_ else b) for a, b in pairs]
        args, _ = pack_batch_staggered(sub, 1, device="cuda")
        vp, vm = myers.nw_right_edge_ref(*args[:5])
        cost = torch.from_numpy(args[4]).cuda() + value_to_window(
            vp, vm, torch.from_numpy(args[5]).cuda())
        for planes in (_lanes(args, 33), args):
            B = planes[0].shape[1]
            got = nw_kernel.nw_right_edge(*planes[:5])
            got_cost = nw_kernel.nw_cost(*planes)
            torch.cuda.synchronize()
            err = _max_err(got + (got_cost,), (vp[:, :B], vm[:, :B], cost[:B]))
            if err:
                fail(f"K11 != plain at B={B} S={args[2].shape[0]}")
            worst = max(worst, err)
        labels.append(f"S={args[2].shape[0]}")
    say(f"[16 nw=plain] {2 * len(labels)}/{2 * len(labels)} cases equal (B 33/{GRID_PAIRS}, "
        f"n_max {args[0].shape[0]}, {', '.join(labels)}; n == 0 and m == 0 lanes) on both "
        f"planes and the costs, max_abs_err {worst}, {time.perf_counter() - t0:.1f} s")
    return worst


class NwSpy:
    """Splits ``nw_cost_pairs`` by layer inside its own calls: the host
    clock around the native pack and around the whole pack (native pack,
    pinned upload, unpack), CUDA events from the end of the native pack to
    K11's launch (upload and unpack on the card) and around K11; keeps
    K11's last inputs.  The launch count stays with the wrapper."""

    def __init__(self):
        self._orig = (att.native.pack_batch_planes, nw_kernel.pack_batch_staggered,
                      nw_kernel.nw_right_edge)
        self.last = None
        self.reset()

    def reset(self):
        self.native_s = self.pack_s = 0.0
        self.events = {}

    def _event(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name] = ev

    def install(self):
        native_pack, pack, k11 = self._orig

        def timed_native(*args):
            t0 = time.perf_counter()
            out = native_pack(*args)
            self.native_s += time.perf_counter() - t0
            self._event("packed")
            return out

        def timed_pack(*args, **kw):
            t0 = time.perf_counter()
            out = pack(*args, **kw)
            self.pack_s += time.perf_counter() - t0
            return out

        def timed_k11(*args):
            self._event("k11_start")
            out = k11(*args)
            self._event("k11_end")
            self.last = args
            return out

        att.native.pack_batch_planes = timed_native
        nw_kernel.pack_batch_staggered = timed_pack
        nw_kernel.nw_right_edge = timed_k11

    def remove(self):
        (att.native.pack_batch_planes, nw_kernel.pack_batch_staggered,
         nw_kernel.nw_right_edge) = self._orig

    def split(self, wall: float) -> tuple[str, float]:
        """One call's split (after it returned); returns (text, K11 ms)."""
        self._event("end")
        self.events["end"].synchronize()
        ev = self.events
        k11 = ev["k11_start"].elapsed_time(ev["k11_end"])
        return (f"host clock: native pack {self.native_s:.4f} s, pinned upload + unpack "
                f"enqueue {self.pack_s - self.native_s:.4f} s, K11 launch, reduction and "
                f"readback wait {wall - self.pack_s:.4f} s; CUDA events: end of the native "
                f"pack to K11's start (uploads and unpack, paced by the host's enqueue) "
                f"{ev['packed'].elapsed_time(ev['k11_start']):.3f} ms, K11 {k11:.3f} ms (with "
                f"any wait for the host's enqueue of its launch), "
                f"cost reduction + readback {ev['k11_end'].elapsed_time(ev['end']):.3f} ms",
                k11)


def phase17_config1(pairs) -> tuple[int, dict, tuple]:
    """Config #1 through ``nw_cost_pairs`` on the card (twice, the second
    timed and split by layer), 1024 costs against the oracle; the
    reference's 1024-pair shape (K11 alone, CUDA events); the same pairs
    through ``BatchAligner(device="cuda").cost`` (K1 ladder).  Returns
    K11's launches on the main path, its main-path times and its last
    inputs."""
    bp = sum(len(a) for a, _ in pairs)
    spy = NwSpy()
    spy.install()
    banded_kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # earlier phases' tensors
    t0 = time.perf_counter()
    costs1 = nw_kernel.nw_cost_pairs(pairs)
    dt1 = time.perf_counter() - t0
    _, k1_ms = spy.split(dt1)
    spy.reset()
    t0 = time.perf_counter()
    costs = nw_kernel.nw_cost_pairs(pairs)
    dt = time.perf_counter() - t0
    split, k2_ms = spy.split(dt)
    spy.remove()
    launches = dict(banded_kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches["nw_right_edge"] != 2 or sum(launches.values()) != 2:
        fail(f"config #1: expected two K11 launches and nothing else, got {launches}")
    if not (costs == costs1).all() or len(costs) != len(pairs):
        fail("config #1 costs differ between calls")
    t1 = time.perf_counter()
    picks = np.linspace(0, len(pairs) - 1, C1_ORACLE).astype(int)
    agree = sum(int(costs[i]) == att.oracle.levenshtein_myers(*pairs[i]) for i in picks)
    if agree != C1_ORACLE:
        fail(f"config #1: {agree}/{C1_ORACLE} costs equal levenshtein_myers")
    args = spy.last
    say(f"[17 config1] nw_cost_pairs on {len(pairs)} x {C1_LENGTH} bp e={C1_ERR} (B={args[0].shape[1]} "
        f"n_max={args[0].shape[0]} S={args[2].shape[0]}): 1st call {dt1:.4f} s (K11 "
        f"{k1_ms:.3f} ms), 2nd call {dt:.4f} s = {bp / dt / 1e9:.4f} Gbp/s aligned; "
        f"levenshtein_myers {agree}/{C1_ORACLE} ({time.perf_counter() - t1:.1f} s); peak "
        f"device memory {peak:.3f} GiB, {peak - held:.3f} GiB above the {held:.3f} GiB "
        f"that earlier phases still held")
    say(f"[17 split] 2nd call, {split}")

    ref_pairs = att.generate.generate_batch(8, C1_LENGTH, C1_ERR, seed=C1_SEED) * (C1_REF_PAIRS // 8)
    ref_args, _ = pack_batch_staggered(ref_pairs, 1, device="cuda")
    ref_costs = nw_kernel.nw_cost(*ref_args).cpu().numpy()
    if list(ref_costs[:8]) != [att.oracle.levenshtein_myers(*p) for p in ref_pairs[:8]]:
        fail("config #1 reference shape: costs differ from levenshtein_myers")
    ref_ms = _chained_ms(lambda: nw_kernel.nw_right_edge(*ref_args[:5]), C1_REF_LAUNCHES)
    say(f"[17 reference shape] 8 seed-{C1_SEED} pairs tiled to {C1_REF_PAIRS} (as "
        f"scripts/bench_configs.py:41-44): K11 alone {ref_ms:.4f} ms a launch over "
        f"{C1_REF_LAUNCHES} chained launches (CUDA events) = "
        f"{C1_REF_PAIRS * C1_LENGTH / ref_ms / 1e6:.3f} Gbp/s; costs of the 8 == "
        f"levenshtein_myers")

    ba = BatchAligner(device="cuda")
    t0 = time.perf_counter()
    ba.cost(pairs)
    torch.cuda.synchronize()
    ba_dt1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    ba_costs, st = ba.cost_with_stats(pairs)
    torch.cuda.synchronize()
    ba_dt = time.perf_counter() - t0
    if not (ba_costs == costs).all():
        fail("config #1: BatchAligner costs differ from nw_cost_pairs'")
    say(f"[17 batch aligner] BatchAligner(device='cuda').cost on the same pairs: 1st call "
        f"{ba_dt1:.4f} s, 2nd {ba_dt:.4f} s = {bp / ba_dt / 1e9:.4f} Gbp/s (kernel "
        f"{st.kernel}, retries {st.band_retries}); all {len(pairs)} costs == nw_cost_pairs'; "
        f"nw_cost_pairs is {ba_dt / dt:.2f}x faster")
    full = {"full_ms": [k1_ms, k2_ms],
            "full_bound_ms": plane_bound(args, args[2].shape[0], [args[2], args[3]])["bound_ms"],
            "full_shape": {"B": args[0].shape[1], "n_max": args[0].shape[0],
                           "S": args[2].shape[0]},
            "ref_shape_ms": ref_ms}
    return launches["nw_right_edge"], full, args


def phase18_time(args, full: dict) -> dict:
    """K11 == plain on phase 17's pack cut to its first NW_CUT_PAIRS pairs,
    timed in turns (plain, kernel, kernel); returns K11's JSON
    record (without the launch count)."""
    cut = tuple(x[:, :NW_CUT_PAIRS].contiguous() for x in args[:4]) + (args[4][:NW_CUT_PAIRS],)
    p, k, err = _turns(lambda: myers.nw_right_edge_ref(*cut),
                       {"nw_right_edge": (lambda: nw_kernel.nw_right_edge(*cut), lambda r: r)})
    if err:
        fail("K11 != plain on config #1's cut pack")
    shape = {"B": NW_CUT_PAIRS, "n_max": cut[0].shape[0], "S": cut[2].shape[0]}
    # K11 alone on the whole pack (the main path's events around its launch
    # also hold any wait for the host's enqueue), and with one word more (a
    # copy of its last): two stripes of 32 words, 64 word steps a column for
    # 33.
    tall = (*args[:2], *(torch.cat([x, x[-1:]]) for x in args[2:4]), args[4])
    partial = {"alone_ms": _chained_ms(lambda: nw_kernel.nw_right_edge(*args[:5]), 3),
               "partial_stripe_ms": _chained_ms(lambda: nw_kernel.nw_right_edge(*tall), 3),
               "partial_stripe_S": tall[2].shape[0],
               "partial_stripe_bound_ms": plane_bound(tall, tall[2].shape[0],
                                                      [tall[2], tall[3]])["bound_ms"]}
    rec = {"max_abs_err": err, "ms": float(np.mean(k["nw_right_edge"])),
           "plain_ms": float(np.mean(p)),
           **plane_bound(cut, cut[2].shape[0], [cut[2], cut[3]]),
           "library_ms": None, "shape": shape, **full, **partial}
    say(f"[18 nw cut] config #1's pack cut to its first {NW_CUT_PAIRS} pairs {shape}, turns "
        f"plain, kernel, kernel: K11 {k['nw_right_edge'][0]:.3f}/"
        f"{k['nw_right_edge'][1]:.3f} ms vs plain {p[0]:.1f} ms (CUDA events); "
        f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); main path's whole pack, K11 "
        f"alone over 3 chained launches: {partial['alone_ms']:.3f} ms a launch vs bound "
        f"{full['full_bound_ms']:.4f} ms ({partial['alone_ms'] / full['full_bound_ms']:.2f}x); "
        f"the whole pack at S={partial['partial_stripe_S']} (two stripes): "
        f"{partial['partial_stripe_ms']:.3f} ms a launch vs bound "
        f"{partial['partial_stripe_bound_ms']:.4f} ms; max_abs_err {err}")
    return rec


def _k8_vs_k2(k8, k2, n, CB: int) -> int:
    """Largest difference between K8 and K2 on the lanes with n > 0 where
    K8's window covers row m (costs; K2 gives m at n == 0, K8 0), and on
    every checkpoint both have that a trace reads (``k*CB <= n``: K2's
    checkpoint k is the state before column k*CB, K8's the state after
    column k*CB - 1)."""
    n_t = torch.as_tensor(np.asarray(n, np.int64), device=k8[0].device)
    cov = (k8[0] < banded.INF) & (n_t > 0)
    comps = [(k8[0][cov], k2[0][cov])]
    for k in range(min(k8[1].shape[0], k2[1].shape[0])):
        live = n_t >= k * CB
        comps += [(g[k][..., live], w[k][..., live]) for g, w in zip(k8[1:], k2[1:])]
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in comps)


def phase19_grid() -> int:
    """K8 == plain on a grid: SW 8, 13, 64, 67, 1152 and full height S off
    the 8-grain, CB = SW, SW + 3, 4096 and n_max, B 1/37/128, ragged n and
    m with n == 0 and m == 0 lanes, with and without a diagonal, and a
    skewed bucket's single capture window (m > 32 n, CB = n_max < S), and
    four capture windows at full height on 3.6 kbp pairs.
    Every case is also held against K2's kernel (held to its plain version
    by phases 6 and 9) on every readable checkpoint.  Returns the max abs
    difference."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    pairs = [att.generate.uniform_seeded(int(rng.integers(1, K8_GRID_N + 1)),
                                         float(rng.uniform(0, 0.25)), 7000 + s)
             for s in range(128)]
    pairs[1] = (b"", b"ACGTACGTAC")  # an n == 0 lane
    pairs[3] = (pairs[3][0], b"")  # an m == 0 lane
    m_top = max(len(b) for _, b in pairs)
    # A tall pair: a full height off the 8-grain, above the largest band.
    pairs[2] = (att.generate.uniform_seeded(K8_GRID_N, 0.1, 6999)[0],
                att.generate.uniform_seeded(K8_TALL_M, 0.1, 6998)[0])
    wide, _ = pack_batch_staggered(pairs, 1, device="cuda")
    n_max, S = wide[0].shape[0], wide[2].shape[0]
    if S % 8 == 0 or S <= K8_BIG_SW:
        fail(f"phase 19's pack has S = {S}: not a full height off the 8-grain "
             f"above {K8_BIG_SW}")
    diag = (n_max, m_top)
    mid, one = _lanes(wide, 37), _lanes(wide, 1)
    # A skewed bucket: b of 3000 bp against a of at most 60, S = 94 > n_max.
    skew = [(att.generate.uniform_seeded(int(rng.integers(1, 61)), 0.1, 7200 + s)[0],
             att.generate.uniform_seeded(int(rng.integers(1, 3001)), 0.1, 7300 + s)[0])
            for s in range(37)]
    skew[0] = (skew[0][0], att.generate.uniform_seeded(3000, 0.1, 7299)[0])
    skewed, _ = pack_batch_staggered(skew, 1, device="cuda")
    Ss = skewed[2].shape[0]
    # Several capture windows at a large band: a's of up to 3.6 kbp beside
    # the tall pair, so CB = SW + 3 leaves n_max // CB = 3 windows past 0.
    lng = [att.generate.uniform_seeded(int(rng.integers(1, K8_LONG_N + 1)),
                                       float(rng.uniform(0, 0.25)), 7400 + s)
           for s in range(37)]
    lng[0] = (att.generate.uniform_seeded(K8_LONG_N, 0.1, 7399)[0], pairs[2][1])
    long_, _ = pack_batch_staggered(lng, 1, device="cuda")
    Sl = long_[2].shape[0]
    if Sl <= K8_BIG_SW or K8_LONG_N // (Sl + 3) < 3:
        fail(f"phase 19's long pack has S = {Sl}: fewer than 3 windows past 0")
    diag_l = (K8_LONG_N, max(len(b) for _, b in lng))
    cases = [(one, "B=1", 8, 64, diag), (wide, "B=128", 8, 4096, None),
             (mid, "B=37", 13, 13, None), (wide, "B=128", 13, 16, diag),
             (wide, "B=128", 64, 64, diag), (mid, "B=37", 67, 70, None),
             (wide, "B=128", 67, 4096, diag), (wide, "B=128", K8_BIG_SW, K8_BIG_SW, None),
             (mid, "B=37", K8_BIG_SW, K8_BIG_SW + 3, None), (wide, "B=128", S, S + 3, None),
             (one, "B=1", S, S, None), (skewed, "skewed B=37", Ss, 4096, None),
             (long_, "long B=37", Sl, Sl + 3, diag_l)]
    worst, worst_k2, labels = 0, 0, []
    before = dict(banded_kernel.LAUNCHES)
    for planes, label, sw, cb, dg in cases:
        # Ring K8 (the wrapper's default up to 4096 live words) and the
        # stripe K8 (forced), each against the plain version.
        got = banded_kernel.pinned_ck(*planes, sw, cb, dg)
        stripe = 8 * banded_kernel.striped_threads(min(sw, planes[2].shape[0]))
        err = max(_max_err(got, striped.pinned_ck_ref(*planes, sw, cb, dg)),
                  _max_err(banded_kernel.pinned_ck(*planes, sw, cb, dg, stripe), got))
        CB = min(cb, planes[0].shape[0])
        e2 = _k8_vs_k2(got, banded_kernel.banded_ck(*planes, sw, cb, dg), planes[4], CB)
        label = (f"{label} SW={min(sw, planes[2].shape[0])}"
                 f"{' (full)' if sw >= planes[2].shape[0] else ''} CB={CB} "
                 f"n_ck={got[1].shape[0]} diag={'set' if dg else 'None'}")
        if err or e2:
            fail(f"K8 (ring or stripe) != plain ({err}) or K2 ({e2}) at {label}")
        worst, worst_k2 = max(worst, err), max(worst_k2, e2)
        labels.append(label)
    # Ring K8 forced to 256 words on the long pack at SW 64, which wraps the
    # ring at least 3 times.
    plan = striped.plan_striped(long_[0].shape[0], Sl, 64, diag_l)
    if plan["n_words_live"] < 3 * 256:
        fail(f"phase 19's 256-word ring holds {plan['n_words_live']} words in under 3 laps")
    got = banded_kernel.pinned_ck(*long_, 64, 64, diag_l, ring_words=256)
    err = _max_err(got, striped.pinned_ck_ref(*long_, 64, 64, diag_l))
    if err:
        fail("ring K8 forced to 256 words != plain on phase 19's long pack")
    worst = max(worst, err)
    labels.append(f"long B=37 SW=64 CB=64 ring 256 words ({plan['n_words_live']} live)")
    ran = {k: banded_kernel.LAUNCHES[k] - before[k] for k in ("ring_ck_exact", "pinned_ck")}
    if ran != {"ring_ck_exact": len(cases) + 1, "pinned_ck": len(cases)}:
        fail(f"phase 19 launched {ran}")
    torch.cuda.synchronize()
    say(f"[19 pinned ck=plain] {len(cases)}/{len(cases)} cases (n_max {n_max}, S {S}; "
        f"skewed n_max {skewed[0].shape[0]}, S {Ss}; long n_max {long_[0].shape[0]}, "
        f"S {Sl}: {'; '.join(labels)}); ring K8 and the stripe K8, max_abs_err "
        f"{worst}; K8 == K2's kernel on every readable checkpoint, max_abs_err {worst_k2}; "
        f"{time.perf_counter() - t0:.1f} s")
    return max(worst, worst_k2)


def phase20_full_height(c4) -> tuple[int, RoundSpy, int, dict]:
    """The exact full-height rungs on config #4's pairs, ``BatchAligner(
    device="cuda", domain_mode="off", max_band_doublings=0)``: first
    ``.cost_with_stats``, one cost rung at SW = S on K7; then
    ``.align_with_stats``, one ck rung at SW = S off the 8-grain on ring
    K8 (the stripe K8 must not run).  Returns the align call's launches
    (ring K8's and the stripe K8's), the spy holding both kernels' inputs,
    K7's launches in the cost call and K7's rung record (its time in the
    call, bound and shape)."""
    pairs, costs7, oracle = c4
    bp = sum(len(a) for a, _ in pairs)
    ba = BatchAligner(device="cuda", domain_mode="off", max_band_doublings=0)
    spy = RoundSpy(("pinned_ck", "striped_ck", "banded_ck", "pinned_cost", "striped_cost",
                    "banded_cost"))
    spy.install()
    banded_kernel.reset_launches()
    t0 = time.perf_counter()
    costs_c, st_c = ba.cost_with_stats(pairs)
    torch.cuda.synchronize()
    dt_c = time.perf_counter() - t0
    k7_launches = banded_kernel.LAUNCHES["pinned_cost"]
    rungs_c = spy.rounds()
    ran = _check_cost_rungs(spy.calls, "full-height cost")
    if ran != ["pinned_cost"] or st_c.kernel != "cuda-pinned" or k7_launches != 1:
        fail(f"full-height cost ran {ran} (stats {st_c.kernel!r}, K7 launches {k7_launches})")
    if list(costs_c) != [int(x) for x in costs7]:
        fail("full-height cost: costs differ from phase 7's")
    *k7_planes, k7_sw, _ = spy.last["pinned_cost"]
    k7_rung = {"full_height_path_ms": RoundSpy.kernel_ms(spy.calls[-1]),
               "full_height_bound_ms": plane_bound(k7_planes, k7_sw, [])["bound_ms"],
               "full_height_shape": {"B": k7_planes[0].shape[1], "n_max": k7_planes[0].shape[0],
                                     "S": k7_planes[2].shape[0], "SW": k7_sw}}
    say(f"[20 cost] cost_with_stats {dt_c:.4f} s = {bp / dt_c / 1e6:.3f} Mbp/s: one cost rung "
        f"[{', '.join(rungs_c)}] (CUDA events) {k7_rung['full_height_shape']}, kernel "
        f"{st_c.kernel} vs bound {k7_rung['full_height_bound_ms']:.4f} ms; costs == phase 7's "
        f"{len(costs_c)}/{len(costs_c)}")
    spy.reset()
    banded_kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    res, st = ba.align_with_stats(pairs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rounds, split = spy.rounds(), spy.split(dt)
    peak = torch.cuda.max_memory_allocated() / 2**30
    spy.remove()
    launches = dict(banded_kernel.LAUNCHES)
    names = [c[0] for c in spy.calls]
    if (names != ["ring_ck_exact"] or st.kernel != "cuda-ring-ck-exact"
            or launches["ring_ck_exact"] != 1 or launches["pinned_ck"]):
        fail(f"full-height ck path ran {names} (stats {st.kernel!r}, launches {launches})")
    args = spy.last["ring_ck_exact"]
    n_max, S, sw, cb = args[0].shape[0], args[2].shape[0], args[6], args[7]
    if sw != S or S % 8 == 0:
        fail(f"the full-height rung ran SW={sw} of S={S}: not full height off the 8-grain")
    costs = [c for c, _ in res]
    if costs != [int(x) for x in costs7] or st.direct_traces:
        fail("full-height ck costs differ from phase 7's, or traced directly")
    agree = sum(costs[i] == w for i, w in oracle.items())
    if agree != len(oracle):
        fail(f"full-height ck: {agree}/{len(oracle)} costs equal levenshtein_myers")
    t1 = time.perf_counter()
    ok = _pool(_verify_job, [(a, b, cig.to_string(), c) for (a, b), (c, cig) in zip(pairs, res)])
    if not all(ok):
        fail(f"full-height ck: {len(ok) - sum(ok)} CIGARs do not verify at their cost")
    say(f"[20 full height] BatchAligner(device='cuda', domain_mode='off', "
        f"max_band_doublings=0).align_with_stats on config #4's {len(pairs)} pairs: "
        f"{dt:.4f} s = {bp / dt / 1e6:.3f} Mbp/s cost+CIGAR; one ck rung [{', '.join(rounds)}] "
        f"(CUDA events) at n_max {n_max}, S {S} (S % 8 = {S % 8}), CB {cb}, kernel {st.kernel}, "
        f"retries {st.band_retries}, cells {st.cells_computed}; costs == phase 7's "
        f"{len(costs)}/{len(costs)}, levenshtein_myers {agree}/{len(oracle)}; {len(ok)} CIGARs "
        f"verified ({time.perf_counter() - t1:.1f} s on {WORKERS} processes)")
    say(f"[20 split] host clock and CUDA events: {split}")
    say(f"[20 memory] peak device memory {peak:.3f} GiB, {peak - held:.3f} GiB above the "
        f"{held:.3f} GiB that earlier phases still held (torch.cuda.max_memory_allocated over "
        f"the align call)")
    return ({k: launches[k] for k in ("ring_ck_exact", "pinned_ck")}, spy, k7_launches,
            k7_rung)


def phase21_time(spy20: RoundSpy) -> dict:
    """Ring K8 and the stripe K8 in turns (stripe, ring, ring, stripe), each
    over chained launches, on phase 20's whole rung; both against their
    plain version and against K2 on that rung cut to CUT_COLS columns, in
    turns.  Returns ring K8's and
    the stripe K8's JSON records (without the launch counts)."""
    torch.cuda.synchronize()
    path_ms = RoundSpy.kernel_ms(spy20.calls[-1])
    *planes, sw, cb_path, dg = spy20.last["ring_ck_exact"]
    stripe = 8 * banded_kernel.striped_threads(sw)
    k8 = {"ring_ck_exact": lambda pl, cb, d: banded_kernel.pinned_ck(*pl, sw, cb, d),
          "pinned_ck": lambda pl, cb, d: banded_kernel.pinned_ck(*pl, sw, cb, d, stripe)}
    rung_ms, outs = {k: [] for k in k8}, {}
    for name in ("pinned_ck", "ring_ck_exact", "ring_ck_exact", "pinned_ck"):
        rung_ms[name].append(_chained_ms(lambda: k8[name](planes, cb_path, dg), K8_CHAINED))
        outs[name] = k8[name](planes, cb_path, dg)
    err_rung = _max_err(outs["ring_ck_exact"], outs["pinned_ck"])
    if err_rung:
        fail("ring K8 != the stripe K8 on phase 20's whole rung")
    del outs
    rung_bound = plane_bound(planes, sw, [])["bound_ms"]
    rung_shape = {"B": planes[0].shape[1], "n_max": planes[0].shape[0],
                  "S": planes[2].shape[0], "SW": sw, "CB": cb_path,
                  "ring threads": banded_kernel.ring_threads(striped.ring_span(
                      striped.plan_striped(planes[0].shape[0], planes[2].shape[0], sw, dg),
                      planes[0].shape[0]))}
    full = {name: {"rung_alone_ms": float(np.mean(ms)), "rung_turns_ms": ms,
                   "rung_bound_ms": rung_bound, "rung_shape": rung_shape}
            for name, ms in rung_ms.items()}
    full["ring_ck_exact"]["rung_path_ms"] = path_ms
    r, o = rung_ms["ring_ck_exact"], rung_ms["pinned_ck"]
    say(f"[21 rung] phase 20's whole rung {rung_shape}, turns stripe, ring, ring, stripe, each "
        f"over {K8_CHAINED} chained launches behind an untimed one: ring K8 {r[0]:.3f}/{r[1]:.3f} "
        f"ms a launch ({np.mean(r) / rung_bound:.2f}x), the stripe K8 {o[0]:.3f}/{o[1]:.3f} ms "
        f"({np.mean(o) / rung_bound:.2f}x) vs bound {rung_bound:.4f} ms; stripe/ring "
        f"{np.mean(o) / np.mean(r):.3f}; equal on costs, every checkpoint row and top value; "
        f"ring K8 in the path's call {path_ms:.3f} ms (CUDA events around the wrapper)")
    # The rung cut to its first columns, one capture window inside the cut
    # for both kernels.
    cut = _cut(planes, CUT_COLS)
    dg_c = _cut_diag(cut)
    cb = K8_CUT_CB
    plain_ms, ref = _event_ms(lambda: striped.pinned_ck_ref(*cut, sw, cb, dg_c))
    fns = {**{k: (lambda f=f: f(cut, cb, dg_c)) for k, f in k8.items()},
           "banded_ck": lambda: banded_kernel.banded_ck(*cut, sw, cb, dg_c)}
    cut_ms, got = _in_turns(fns, ("pinned_ck", "ring_ck_exact", "banded_ck", "banded_ck",
                                  "ring_ck_exact", "pinned_ck"))
    err = max(_max_err(got["ring_ck_exact"], ref), _max_err(got["pinned_ck"], ref))
    err_k2 = _k8_vs_k2(got["ring_ck_exact"], got["banded_ck"], cut[4], cb)
    if err or err_k2:
        fail(f"K8 != plain ({err}) or K2 ({err_k2}) on the full-height rung's cut")
    shape = {"B": cut[0].shape[1], "n_max": cut[0].shape[0], "S": cut[2].shape[0],
             "SW": sw, "CB": cb}
    bnd = plane_bound(cut, sw, ref)
    k2_bnd = plane_bound(cut, sw, got["banded_ck"])["bound_ms"]
    k2_key = banded_kernel.k2_kernel(cut[0].shape[0], sw, cb)
    k8r, k8s, k2_ms = cut_ms["ring_ck_exact"], cut_ms["pinned_ck"], cut_ms["banded_ck"]
    say(f"[21 cut] phase 20's rung cut to its first {CUT_COLS} columns {shape}, turns stripe, "
        f"ring, K2, K2, ring, stripe: ring K8 {k8r[0]:.3f}/{k8r[1]:.3f} ms, the stripe K8 "
        f"{k8s[0]:.3f}/{k8s[1]:.3f} ms vs bound {bnd['bound_ms']:.4f} ms "
        f"({np.mean(k8r) / bnd['bound_ms']:.2f}x, {np.mean(k8s) / bnd['bound_ms']:.2f}x), K2 "
        f"({k2_key}) {k2_ms[0]:.3f}/{k2_ms[1]:.3f} ms vs bound {k2_bnd:.4f} ms "
        f"({np.mean(k2_ms) / k2_bnd:.1f}x); plain K8 {plain_ms:.1f} ms; both K8 == plain, "
        f"K8 == K2 on every readable checkpoint, max_abs_err {max(err, err_k2)} (CUDA events)")
    common = {"max_abs_err": max(err, err_k2, err_rung), "plain_ms": plain_ms, **bnd,
              "library_ms": None, "shape": shape, "k2_ms": float(np.mean(k2_ms)),
              "k2_kernel": k2_key, "k2_bound_ms": k2_bnd}
    return {"ring_ck_exact": {**common, "ms": float(np.mean(k8r)), **full["ring_ck_exact"]},
            "pinned_ck": {**common, "ms": float(np.mean(k8s)), **full["pinned_ck"]}}


def phase22_grid(wide, narrow) -> tuple[int, int]:
    """K7 == plain on a grid: phase 10's 160- and 33-lane packs (n <= 1500,
    an n == 0 lane, a skewed pair making S ~ 280 off the 8-grain) with an
    m == 0 lane and one lane, SW 8, 13, 64, 67, 256 and full height, with
    and without a diagonal; a skewed bucket (m > 32 n); rings forced to
    256 words on pairs of up to 2 kbp beside a tall one (S = 1188), which
    wrap at least 3 times, also on a shape-quantized pack (n_max past the
    longest a); a skewed bucket at full height whose ring is lower than the
    band (its ended top word's slot reused); and the refusal of a band
    whose live words exceed the 4096-word ring.  Returns (max abs difference, the fewest
    wraps of a forced ring)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(22)
    m0 = (wide[0].clone(), wide[1].clone(), wide[2].clone(), wide[3].clone(),
          wide[4].copy(), wide[5].copy())
    m0[5][3] = 0  # an m == 0 lane: its profile rows are never read
    n_max, S = wide[0].shape[0], wide[2].shape[0]
    if S % 8 == 0 or S <= 256:
        fail(f"phase 22's pack has S = {S}: not a full height off the 8-grain above 256")
    diag = (n_max, int(np.asarray(wide[5])[3:].max()))
    one = _lanes(wide, 1)
    skew = [(att.generate.uniform_seeded(int(rng.integers(1, 61)), 0.1, 8200 + s)[0],
             att.generate.uniform_seeded(int(rng.integers(1, 3001)), 0.1, 8300 + s)[0])
            for s in range(33)]
    skew[0] = (skew[0][0], att.generate.uniform_seeded(3000, 0.1, 8299)[0])
    skewed, _ = pack_batch_staggered(skew, 1, device="cuda")
    lng = [att.generate.uniform_seeded(int(rng.integers(1, K7_GRID_LONG_N + 1)),
                                       float(rng.uniform(0, 0.25)), 8400 + s)
           for s in range(33)]
    lng[0] = (att.generate.uniform_seeded(K7_GRID_LONG_N, 0.1, 8399)[0],
              att.generate.uniform_seeded(K7_GRID_TALL_M, 0.1, 8398)[0])
    long_, _ = pack_batch_staggered(lng, 1, device="cuda")
    diag_l = (long_[0].shape[0], max(len(b) for _, b in lng))
    # The same pairs on a shape-quantized pack (n_max 2048 > the longest a),
    # as the runner packs them: words end at column n_lim - 1 < n_max - 1.
    long_q, _ = pack_batch_staggered(lng, 1, 2048, device="cuda")
    # A skewed bucket taller than its ring: S = 375 words over at most 200
    # columns, so at full height 200 words are live and a 256-word ring
    # wraps while the top word (word 0) has ended.
    tall = [(att.generate.uniform_seeded(int(rng.integers(1, 201)), 0.1, 8600 + s)[0],
             att.generate.uniform_seeded(int(rng.integers(1, 12_001)), 0.1, 8700 + s)[0])
            for s in range(33)]
    tall[0] = (att.generate.uniform_seeded(200, 0.1, 8599)[0],
               att.generate.uniform_seeded(12_000, 0.1, 8598)[0])
    skew_tall, _ = pack_batch_staggered(tall, 1, device="cuda")
    cases = [(one, "B=1", 8, None, None), (narrow, "B=33", 8, diag, None),
             (m0, "B=160", 13, None, None), (narrow, "B=33", 64, diag, 256),
             (m0, "B=160", 67, diag, None), (m0, "B=160", 256, None, 512),
             (m0, "B=160", S, diag, None),
             (skewed, "skewed B=33", skewed[2].shape[0], None, None),
             (long_, "long B=33", 64, diag_l, 256), (long_, "long B=33", 256, None, 256),
             (long_q, "long quantized B=33", 256, diag_l, 256),
             (skew_tall, "skewed tall B=33", skew_tall[2].shape[0], None, None)]
    worst, labels, wraps = 0, [], []
    for planes, label, sw, dg, rw in cases:
        got = banded_kernel.pinned_cost(*planes, sw, dg, rw)
        err = _max_err(got, striped.pinned_cost_ref(*planes, sw, dg))
        sw_eff = min(sw, planes[2].shape[0])
        plan = striped.plan_striped(planes[0].shape[0], planes[2].shape[0], sw_eff, dg)
        span = striped.ring_span(plan, int(np.max(planes[4], initial=1)))
        ring = banded_kernel.ring_threads(span, rw) * 8
        laps = plan["n_words_live"] / ring
        if rw is not None and label.startswith("long B"):
            wraps.append(laps)
        if label.startswith("skewed tall") and ring >= sw_eff:
            fail(f"phase 22's tall skewed case has a ring of {ring} words for SW = {sw_eff}")
        label = (f"{label} SW={sw_eff}{' (full)' if sw_eff == planes[2].shape[0] else ''} "
                 f"diag={'set' if dg else 'None'} span {span} ring {ring} ({laps:.2f} laps)")
        if err:
            fail(f"K7 != plain at {label}")
        worst = max(worst, err)
        labels.append(label)
    if min(wraps) < 3:
        fail(f"phase 22's forced rings wrap only {min(wraps):.2f} times")
    # A band whose live words exceed K7's ring: a full height of > 4096
    # words over 4500 columns (every word stays live), K7 forced (8 slots a
    # thread); the wide ring takes it by default (phase 29).
    big = [(att.generate.uniform_seeded(4500, 0.0, 8500)[0],
            att.generate.uniform_seeded(140_000, 0.1, 8501)[0])]
    bargs, _ = pack_batch_staggered(big, 1, device="cuda")
    before = banded_kernel.LAUNCHES["pinned_cost"]
    try:
        banded_kernel.pinned_cost(*bargs, bargs[2].shape[0], None, None, 8)
        fail("K7 took a band of more live words than its ring holds")
    except ValueError as exc:
        refused = str(exc)
    if banded_kernel.LAUNCHES["pinned_cost"] != before:
        fail("K7 launched past its ring capacity")
    torch.cuda.synchronize()
    say(f"[22 pinned cost=plain] {len(cases)}/{len(cases)} cases (n_max {n_max}, S {S}; "
        f"skewed n_max {skewed[0].shape[0]}, S {skewed[2].shape[0]}; long n_max "
        f"{long_[0].shape[0]} (quantized {long_q[0].shape[0]}), S {long_[2].shape[0]}; tall "
        f"skewed n_max {skew_tall[0].shape[0]}, S {skew_tall[2].shape[0]}: "
        f"{'; '.join(labels)}); max_abs_err "
        f"{worst}; forced rings wrap >= {min(wraps):.2f} times; S = {bargs[2].shape[0]} at "
        f"full height refused without a launch ({refused}); {time.perf_counter() - t0:.1f} s")
    return worst, min(wraps)


def _alone(fn) -> float:
    return _chained_ms(fn, K7_CHAINED)


def phase23_time(c5_spy: RoundSpy) -> dict:
    """K7 and K5 alone on config #5's whole rung; returns K7's whole-rung
    record and K5's."""
    torch.cuda.synchronize()
    *planes, sw, diag = c5_spy.last["pinned_cost"]
    shape = {"B": planes[0].shape[1], "n_max": planes[0].shape[0], "S": planes[2].shape[0],
             "SW": sw}
    bnd = plane_bound(planes, sw, [])["bound_ms"]
    k7 = banded_kernel.pinned_cost(*planes, sw, diag)
    k5 = _stripes(planes, sw, diag)
    err = _max_err(k7, k5)
    if err:
        fail("K7 != K5 on config #5's whole rung")
    k7_ms = _alone(lambda: banded_kernel.pinned_cost(*planes, sw, diag))
    k5_ms = _alone(lambda: _stripes(planes, sw, diag))
    span = striped.ring_span(striped.plan_striped(shape["n_max"], shape["S"], sw, diag),
                             int(np.max(planes[4], initial=1)))
    say(f"[23 rung] config #5's whole rung {shape}, {K7_CHAINED} chained launches behind an "
        f"untimed one: K7 {k7_ms:.3f} ms ({k7_ms / bnd:.2f}x), K5 {k5_ms:.3f} ms "
        f"({k5_ms / bnd:.2f}x) vs bound {bnd:.4f} ms; K5/K7 {k5_ms / k7_ms:.3f}; ring "
        f"{banded_kernel.ring_threads(span) * 8} words for {span} live, K5 stripes of "
        f"{banded_kernel.striped_threads(sw) * 8}; K7 == K5 on all {shape['B']} lanes, "
        f"max_abs_err {err} (CUDA events)")

    return ({"rung_alone_ms": k7_ms, "rung_alone_bound_ms": bnd, "rung_alone_shape": shape,
             "k5_rung_alone_ms": k5_ms},
            {"c5_rung_alone_ms": k5_ms, "c5_rung_bound_ms": bnd, "c5_rung_shape": shape})


def _fill_pack(rng, count: int):
    """Phase 24's 128-lane pack: n <= K3_GRID_N with an n == 0 and an m == 0
    lane, and one tall b (2280 rows, S = 72 words) so that bands of up to 64
    words stay below full height."""
    pairs = _random_pairs(rng, count, K3_GRID_N, K3_GRID_N)
    pairs[3] = (pairs[3][0], b"")
    pairs[4] = (b"GATTACA" * 14, b"TACGGA" * 380)
    return pack_batch_staggered(pairs, 1, device="cuda")[0]


def _fill_schedules(rng, n_max: int, B: int, sw: int, S: int, q: int, args) -> np.ndarray:
    """Per-pair schedules for K3's per-pair mode: the pairs' own gap
    schedules (at Q = 32), or random shifts at multiples of ``q``; every
    lane shifts at column 0 and, where room is left, at the last quantum
    column."""
    if q == banded.SCHEDULE_Q:
        sched, _ = banded.pair_gap_schedule(args[4], args[5], sw, n_max, S)
    else:
        sched = _random_schedule(rng, n_max, B, q)
    if S > sw:
        sched[0] = 1
        sched[n_max - 1 - (n_max - 1) % q] = 1
    return sched


def phase24_grid() -> int:
    """K3 == plain in both schedule modes on a grid: B 1/37/128 (the first
    lanes of one 128-lane pack, so one plain sweep serves all three), SW 1,
    8, 28, 32, 64 and a full height of 72 words, a diagonal whose only shift
    is at column 0 (the shared mode, K3's ring), per-pair schedules (Q
    32/8/1; the old K3)
    shifting at column 0 and at the last column; costs and both planes on
    every row.  Returns the max abs difference."""
    rng = np.random.default_rng(24)
    args = _fill_pack(rng, K3_GRID_PAIRS)
    n_max, S, B = args[0].shape[0], args[2].shape[0], args[0].shape[1]
    packs = [_lanes(args, k) for k in (1, 37)] + [args]
    worst, cases = 0, 0
    t0 = time.perf_counter()
    col0 = (1, (K3_COL0_SW * 32 // 2 + 32) * 2)  # desired word 1 at every column
    shared = [(sw, None) for sw in (1, 8, 28, 32, 64, S)]
    shared.append((K3_COL0_SW, col0))
    for sw, diag in shared:
        if diag == col0 and banded.shift_at_array(n_max, S, sw, diag)[:2].tolist() != [1, 0]:
            fail("phase 24: the column-0 diagonal does not shift at column 0 only")
        ref = banded.banded_fill_ref(*args, sw, diag)
        for planes in packs:
            k = planes[0].shape[1]
            got = banded_kernel.banded_fill(*planes, sw, diag)
            err = _max_err(got, (ref[0][:k], ref[1][:, :, :k], ref[2][:, :, :k]))
            if err:
                fail(f"K3's ring != plain at B={k} SW={sw} diag={diag}")
            worst, cases = max(worst, err), cases + 1
    for sw, q in ((8, 32), (28, 8), (64, 1)):
        sched = _fill_schedules(rng, n_max, B, sw, S, q, args)
        ref = banded.banded_fill_pp_ref(*args, sched, sw, q)
        for planes in packs:
            k = planes[0].shape[1]
            got = banded_kernel.banded_fill_pp(*planes, np.ascontiguousarray(sched[:, :k]),
                                               sw, q)
            err = _max_err(got, (ref[0][:k], ref[1][:, :, :k], ref[2][:, :, :k]))
            if err:
                fail(f"K3 per-pair != plain at B={k} SW={sw} Q={q}")
            worst, cases = max(worst, err), cases + 1
    say(f"[24 K3=plain] {cases}/{cases} cases equal (B 1/37/{B}, n_max {n_max}, S {S}, shared "
        f"SW 1/8/28/32/64/{S} and a column-0 shift on K3's ring, "
        f"per-pair Q 32/8/1 shifting at column 0 "
        f"and the last column, n == 0 and m == 0 lanes), costs and both planes on every "
        f"row, max_abs_err {worst}, {time.perf_counter() - t0:.1f} s")
    return worst


class FillSpy:
    """Splits one call of the cost-then-trace route: the pack (host clock),
    K1 and K3 (CUDA events around each launch), the planes' readback in
    three parts (CUDA events: K3's end to the readback's start is the
    transpose to pair-major; from there to the last pinned allocation is
    the time the card waits on the host allocating the pinned buffers,
    whose host seconds are summed apart; from there to the copies' end is
    the copy), the traces (host clock from the first native
    ``trace_banded`` call's start to the last one's end, and the seconds
    summed over the pool's threads); keeps K3's last inputs."""

    def __init__(self):
        self._orig = (runner.pack_batch_staggered, runner.BatchAligner._pack,
                      runner.banded_cost, runner.banded_fill,
                      runner._Readback.__init__, runner._pinned_like,
                      runner.native.trace_banded)
        self.reset()

    def reset(self):
        self.pack_s = 0.0
        self.k1, self.k3, self.readback = [], [], []
        self.alloc_s = 0.0
        self.trace_span, self.trace_sum = [None, None], 0.0
        self._fill_end = None
        self._alloc_end = None
        self.lock = threading.Lock()

    def install(self):
        pack, bucket_pack, k1, k3, rb_init, pinned, trace = self._orig

        def timed(fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.pack_s += time.perf_counter() - t0
                return out
            return call

        def evented(fn, store: str, fill=False):
            def call(*args):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args)
                b.record()
                getattr(self, store).append((a, b))  # reset() replaces the lists
                if fill:
                    self.last = args
                    self._fill_end = b
                return out
            return call

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed_pinned(t):
            if self._fill_end is None:  # not the fill arm's planes
                return pinned(t)
            t0 = time.perf_counter()
            out = pinned(t)
            self.alloc_s += time.perf_counter() - t0
            self._alloc_end = event()
            return out

        def rb(readback, *ts):
            if self._fill_end is None:
                return rb_init(readback, *ts)
            start = event()  # the transposes were queued before this call
            rb_init(readback, *ts)
            self.readback.append((self._fill_end, start, self._alloc_end, event()))
            self._fill_end = self._alloc_end = None

        def timed_trace(*args, **kw):
            t0 = time.perf_counter()
            out = trace(*args, **kw)
            t1 = time.perf_counter()
            with self.lock:
                self.trace_sum += t1 - t0
                lo, hi = self.trace_span
                self.trace_span = [t0 if lo is None else min(lo, t0), max(hi or t1, t1)]
            return out

        runner.pack_batch_staggered = timed(pack)
        runner.BatchAligner._pack = timed(bucket_pack)
        runner.banded_cost = evented(k1, "k1")
        runner.banded_fill = evented(k3, "k3", fill=True)
        runner._Readback.__init__ = rb
        runner._pinned_like = timed_pinned
        runner.native.trace_banded = timed_trace

    def remove(self):
        (runner.pack_batch_staggered, runner.BatchAligner._pack,
         runner.banded_cost, runner.banded_fill,
         runner._Readback.__init__, runner._pinned_like,
         runner.native.trace_banded) = self._orig

    def split(self, wall: float) -> dict:
        torch.cuda.synchronize()
        ms = lambda evs: sum(a.elapsed_time(b) for a, b in evs)
        parts = lambda k: sum(evs[k].elapsed_time(evs[k + 1]) for evs in self.readback)
        traces = (self.trace_span[1] - self.trace_span[0]) if self.trace_span[0] else 0.0
        out = {"pack_s": self.pack_s, "k1_ms": ms(self.k1), "k1_launches": len(self.k1),
               "k3_ms": ms(self.k3), "k3_launches": len(self.k3),
               "transpose_ms": parts(0), "alloc_wait_ms": parts(1), "copy_ms": parts(2),
               "alloc_host_s": self.alloc_s, "traces_s": traces,
               "traces_thread_s": self.trace_sum}
        out["readback_ms"] = out["transpose_ms"] + out["alloc_wait_ms"] + out["copy_ms"]
        out["other_s"] = wall - self.pack_s - traces - (
            out["k1_ms"] + out["k3_ms"] + out["readback_ms"]) / 1e3
        return out


def _say_split(label: str, split: dict, wall: float, gib: float, traces: bool = True) -> None:
    """Prints a split; ``traces`` False leaves out the traces and the rest,
    whose host spans overlap when the split covers several calls."""
    rest = (f", traces {split['traces_s']:.4f} s ({split['traces_thread_s']:.3f} s over the "
            f"pool's threads), other {split['other_s']:.4f} s of {wall:.4f} s") if traces else ""
    say(f"[{label}] pack {split['pack_s']:.4f} s, K1 {split['k1_ms']:.3f} ms over "
        f"{split['k1_launches']} launches, K3 {split['k3_ms']:.3f} ms over "
        f"{split['k3_launches']}, plane readback ({gib:.3f} GiB) "
        f"{split['readback_ms']:.3f} ms = transpose {split['transpose_ms']:.3f} + card waiting "
        f"on the pinned allocation {split['alloc_wait_ms']:.3f} (host "
        f"{split['alloc_host_s'] * 1e3:.3f} ms allocating) + copy to pinned memory "
        f"{split['copy_ms']:.3f} ms (CUDA events){rest}")


def _plane_gib(args) -> float:
    """GiB of the two uint32 planes a fill of K3 inputs ``args`` writes."""
    *planes, sw, _ = args
    return 2 * 4 * planes[0].shape[0] * sw * planes[0].shape[1] / 2**30


def _plain_then_kernel(plain, kernel) -> tuple[float, list[float], int]:
    """The plain version once, then the kernel twice (CUDA events); returns
    (plain ms, kernel ms of each run, max abs difference)."""
    plain_ms, ref = _event_ms(plain)
    runs = [_event_ms(kernel) for _ in range(2)]
    return plain_ms, [ms for ms, _ in runs], max(_max_err(got, ref) for _, got in runs)


def _verify_all(pairs, results, costs, label: str) -> int:
    """Every CIGAR verified at its cost on the run's processes, and the
    costs equal to ``costs``; returns the count."""
    got = [c for c, _ in results]
    if got != [int(x) for x in costs]:
        fail(f"{label}: {sum(g != int(w) for g, w in zip(got, costs))} costs differ")
    ok = _pool(_verify_job, [(a, b, cig.to_string(), c)
                             for (a, b), (c, cig) in zip(pairs, results)])
    if not all(ok):
        fail(f"{label}: {len(ok) - sum(ok)} CIGARs do not verify at their cost")
    return len(ok)


def phase25_route(p8, batches) -> tuple[dict, FillSpy, dict]:
    """The cost-then-trace route on phase 8's 512 x 10 kbp pairs:
    ``BatchAligner(device="cuda", combined=False, direct_dt=False)
    .align_with_stats`` (K1 cost rungs, one K3 fill, a native trace per
    pair), called twice on one aligner and split by layer; the second call
    is the steady state, the first also pays the process's first pinned
    allocation of the planes' size.  Then the same pairs with
    ``direct_dt=True`` (the direct arm) and ``align_iter`` over three of
    phase 4's batches, split the same way.  Returns the launches of the two
    route calls, the spy and the second call's split."""
    pairs, costs8 = p8
    bp = sum(len(a) for a, _ in pairs)
    ba = BatchAligner(device="cuda", combined=False, direct_dt=False)
    spy = FillSpy()
    spy.install()
    banded_kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    calls = []
    for _ in range(2):
        spy.reset()
        t0 = time.perf_counter()
        res, st = ba.align_with_stats(pairs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        calls.append((res, st, dt, spy.split(dt)))
    launches = dict(banded_kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    spy.remove()
    for res, st, _, split in calls:
        if split["k3_launches"] != 1 or st.kernel != "cuda-banded-ring-fill" or st.direct_traces:
            fail(f"trace route: K3 launches {split['k3_launches']}, kernel {st.kernel!r}, "
                 f"direct traces {st.direct_traces}")
    if launches["banded_ring_fill"] != 2 or launches["banded_fill"]:
        fail(f"trace route: {launches['banded_ring_fill']} launches of K3's ring and "
             f"{launches['banded_fill']} of the old K3 in two calls")
    if not launches["banded_ring"] or launches["banded_cost"]:
        fail(f"trace route: K1's cost rungs ran the ring {launches['banded_ring']} times and "
             f"the old K1 {launches['banded_cost']} times")
    route_args = spy.last
    *planes, sw, diag = route_args
    n_max, S, B = planes[0].shape[0], planes[2].shape[0], planes[0].shape[1]
    n_ok = sum(_verify_all(pairs, res, costs8, f"trace route call {k + 1}")
               for k, (res, *_) in enumerate(calls))
    for k, (res, st, dt, split) in enumerate(calls):
        say(f"[25 route] call {k + 1} of BatchAligner(device='cuda', combined=False, "
            f"direct_dt=False).align_with_stats on phase 8's {len(pairs)} x {LENGTH} bp "
            f"e={ERR} pairs: {dt:.4f} s = {dt / len(pairs) * 1e3:.4f} ms/pair = "
            f"{bp / dt / 1e6:.3f} Mbp/s cost+CIGAR; K3 at n_max {n_max}, S {S}, SW {sw}, "
            f"B {B}, kernel {st.kernel}; costs == phase 8's {len(pairs)}/{len(pairs)}")
        _say_split(f"25 split call {k + 1}", split, dt, _plane_gib(route_args))
    say(f"[25 route] launches over both calls {launches['banded_ring']} K1, "
        f"{launches['banded_ring_fill']} K3 (its ring; the old K3 {launches['banded_fill']}); "
        f"{n_ok} CIGARs verified at their cost")
    say(f"[25 memory] peak device memory {peak:.3f} GiB, {peak - held:.3f} GiB above the "
        f"{held:.3f} GiB that earlier phases still held")

    bd = BatchAligner(device="cuda", combined=False, direct_dt=True)
    banded_kernel.reset_launches()
    t0 = time.perf_counter()
    res_d, st_d = bd.align_with_stats(pairs)
    dt_d = time.perf_counter() - t0
    if banded_kernel.LAUNCHES["banded_ring_fill"] or banded_kernel.LAUNCHES["banded_fill"]:
        fail("the direct arm launched K3")
    n_d = _verify_all(pairs, res_d, costs8, "direct arm")
    say(f"[25 direct] the same pairs with direct_dt=True (the direct arm, no fill): "
        f"{dt_d:.4f} s = {dt_d / len(pairs) * 1e3:.4f} ms/pair; {n_d} CIGARs verified")

    stream = batches[:K3_STREAM_BATCHES]
    spy.reset()
    spy.install()
    t0 = time.perf_counter()
    got = list(ba.align_iter(iter(stream)))
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    split_s = spy.split(dt_s)
    spy.remove()
    iter_gib = _plane_gib(spy.last)
    spy.last = route_args  # phase25_time runs K3 alone on the route's pack
    if len(got) != len(stream):
        fail("align_iter lost a batch on the trace route")
    n_s = 0
    cost_ba = BatchAligner(device="cuda")
    for batch, (r, st_s) in zip(stream, got):
        if st_s.kernel != "cuda-banded-ring-fill":
            fail(f"align_iter batch ran {st_s.kernel!r}")
        n_s += _verify_all(batch, r, cost_ba.cost(batch), "align_iter trace route")
    say(f"[25 align_iter] combined=False, direct_dt=False over {len(stream)} x "
        f"{STREAM_PAIRS} pairs on the same aligner: {dt_s:.4f} s = "
        f"{dt_s / (len(stream) * STREAM_PAIRS) * 1e3:.4f} ms/pair, {n_s} CIGARs verified, "
        f"costs == cost()")
    _say_split("25 split align_iter", split_s, dt_s, iter_gib, traces=False)
    first, steady = calls[0][3], calls[1][3]
    steady.update(wall_s=calls[1][2], first_wall_s=calls[0][2], first=first,
                  shape={"B": B, "n_max": n_max, "S": S, "SW": sw}, peak_gib=peak,
                  direct_s=dt_d, align_iter_s=dt_s, align_iter=split_s)
    return launches, spy, steady


def phase25_time(spy: FillSpy, split: dict) -> tuple[dict, dict]:
    """K3 (its ring, the wrapper) alone on phase 25's whole pack over
    chained launches against its bound (bytes: both planes written once,
    the inputs read once); K3 against its plain version on that pack cut to
    its first CUT_COLS columns (the plain once, then the kernel twice, as
    phase 5), and K3's per-pair mode (the old kernel) on the cut with the
    pairs' gap schedules.  Returns the two JSON records (without
    launches)."""
    torch.cuda.synchronize()
    *planes, sw, diag = spy.last
    outs = banded_kernel.banded_fill(*planes, sw, diag)
    bnd = plane_bound(planes, sw, outs)
    del outs
    alone = _chained_ms(lambda: banded_kernel.banded_fill(*planes, sw, diag), K3_CHAINED)
    shape = split["shape"]
    say(f"[25 K3 alone] K3 on the whole pack {shape}, {K3_CHAINED} chained launches behind "
        f"an untimed one: {alone:.3f} ms a launch vs bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}, {alone / bnd['bound_ms']:.1f}x); in the path's call "
        f"{split['k3_ms']:.3f} ms (CUDA events around the wrapper)")
    cut = _cut(planes, CUT_COLS)
    dg = _cut_diag(cut)
    plain_ms, kernel_ms, err = _plain_then_kernel(
        lambda: banded.banded_fill_ref(*cut, sw, dg),
        lambda: banded_kernel.banded_fill(*cut, sw, dg))
    if err:
        fail("K3 != plain on the path's cut")
    cbnd = plane_bound(cut, sw, banded_kernel.banded_fill(*cut, sw, dg))
    n_max_c, S_c, B_c = cut[0].shape[0], cut[2].shape[0], cut[0].shape[1]
    sched, _ = banded.pair_gap_schedule(cut[4], cut[5], sw, n_max_c, S_c)
    pp_plain, pp_ms, pp_err = _plain_then_kernel(
        lambda: banded.banded_fill_pp_ref(*cut, sched, sw),
        lambda: banded_kernel.banded_fill_pp(*cut, sched, sw))
    if pp_err:
        fail("K3 per-pair != plain on the path's cut")
    cshape = {"B": B_c, "n_max": n_max_c, "S": S_c, "SW": sw}
    say(f"[25 K3 cut] the path's pack cut to its first {CUT_COLS} columns {cshape}, plain once "
        f"then the kernel twice: K3 {kernel_ms[0]:.3f}/{kernel_ms[1]:.3f} ms, plain "
        f"{plain_ms:.1f} ms, bound {cbnd['bound_ms']:.4f} ms; per-pair K3 on the pairs' gap "
        f"schedules {pp_ms[0]:.3f}/{pp_ms[1]:.3f} ms, plain {pp_plain:.1f} ms; both == plain on "
        f"costs and both planes, max_abs_err {max(err, pp_err)} (CUDA events)")
    fill = {"max_abs_err": err, "ms": alone, "plain_ms": plain_ms, **bnd,
            "library_ms": None, "shape": shape, "cut_ms": float(np.mean(kernel_ms)),
            "cut_bound_ms": cbnd["bound_ms"], "cut_shape": cshape,
            "path_ms": split["k3_ms"]}
    fill_pp = {"max_abs_err": pp_err, "ms": float(np.mean(pp_ms)),
               "plain_ms": pp_plain, **cbnd, "library_ms": None,
               "shape": cshape}
    return fill, fill_pp


def _high_div_pairs():
    """Two pairs whose certified band exceeds 64 words: 30 kbp at e=3% with
    1100 bp cut from b (cost * 12 < min(n, m): native A*), and 10 kbp at
    e=30% (cost * 12 >= n: the block aligner)."""
    a, b = att.generate.uniform_seeded(30_000, 0.03, 9)
    return [(a, b[:10_000] + b[11_100:]), att.generate.uniform_seeded(10_000, 0.30, 10)]


def phase26_host() -> dict:
    """The host arm and the fallback on the card: the high-divergence pairs
    through ``combined=False, direct_dt=False`` (both branches of the host
    arm; with direct traces their costs would trace directly); then the
    block aligner with its block DP in torch on the card
    (``BlockKernel.use_native=False``) on pairs of ~2 kbp, and the runner's
    ``_align_host_fallback`` with the native library reported missing.
    Costs equal ``oracle.levenshtein_myers``, CIGARs verify; timed."""
    from dataclasses import replace

    from astarpa_tpu_torch.aligners import astarpa2
    from astarpa_tpu_torch.ops.block_kernel import BlockKernel

    pairs = _high_div_pairs()
    want = [att.oracle.levenshtein_myers(a, b) for a, b in pairs]
    calls = []
    orig = (runner.native.astarpa_native, astarpa2.AstarPa2.align)

    def spy(name, fn):
        def call(*args, **kw):
            calls.append(name)
            return fn(*args, **kw)
        return call

    runner.native.astarpa_native = spy("native A*", orig[0])
    astarpa2.AstarPa2.align = spy("block aligner", orig[1])
    banded_kernel.reset_launches()
    t0 = time.perf_counter()
    try:
        res, st = BatchAligner(device="cuda", combined=False,
                               direct_dt=False).align_with_stats(pairs)
    finally:
        runner.native.astarpa_native, astarpa2.AstarPa2.align = orig
    dt = time.perf_counter() - t0
    k3 = banded_kernel.LAUNCHES["banded_fill"] + banded_kernel.LAUNCHES["banded_ring_fill"]
    if sorted(calls) != ["block aligner", "native A*"] or k3:
        fail(f"host arm ran {calls} (K3 launches {k3})")
    _verify(pairs, res, want)
    say(f"[26 host arm] combined=False on {[(len(a), len(b)) for a, b in pairs]} bp pairs, "
        f"costs {want} (bands past 64 words): {calls} in {dt:.3f} s, costs == "
        f"levenshtein_myers, CIGARs verified")

    small = [att.generate.uniform_seeded(K3_BLOCK_N, e, 260 + k)
             for k, e in enumerate(K3_BLOCK_ERRS)]
    want_s = [att.oracle.levenshtein_myers(a, b) for a, b in small]
    BlockKernel.use_native = False
    try:
        aligner = replace(astarpa2.AstarPa2Params.simple(), device="cuda").make_aligner(True)
        t0 = time.perf_counter()
        res_b = [aligner.align(a, b) for a, b in small]
        torch.cuda.synchronize()
        dt_b = time.perf_counter() - t0
    finally:
        BlockKernel.use_native = None
    _verify(small, res_b, want_s)
    orig_avail = runner.native.available
    runner.native.available = lambda: False
    try:
        t0 = time.perf_counter()
        res_f = BatchAligner(device="cuda").align(small)
        torch.cuda.synchronize()
        dt_f = time.perf_counter() - t0
    finally:
        runner.native.available = orig_avail
    _verify(small, res_f, want_s)
    if [c.to_string() for _, c in res_f] != [c.to_string() for _, c in res_b]:
        fail("the fallback's CIGARs differ from the block aligner's")
    say(f"[26 block] AstarPa2Params.simple().make_aligner(True) with BlockKernel.use_native="
        f"False (the torch block DP on the card) on {len(small)} x {K3_BLOCK_N} bp pairs "
        f"(e {list(K3_BLOCK_ERRS)}, costs {want_s}): {dt_b:.3f} s; BatchAligner(device="
        f"'cuda').align with the native library reported missing (the cost ladder, then "
        f"_align_host_fallback): {dt_f:.3f} s; costs == levenshtein_myers, CIGARs verified "
        f"and equal")
    return {"host_arm_s": dt, "block_torch_s": dt_b, "fallback_s": dt_f}


def _ring_pack(n_hi: int, m_tall: int, seed: int):
    """33 pairs of up to ``n_hi`` bp beside one whose b is ``m_tall`` bp
    (the band's full height), packed on the card; returns the planes and
    the diagonal to the longest b."""
    rng = np.random.default_rng(seed)
    pairs = [att.generate.uniform_seeded(int(rng.integers(1, n_hi + 1)),
                                         float(rng.uniform(0, 0.25)), seed + 1 + s)
             for s in range(33)]
    pairs[0] = (att.generate.uniform_seeded(n_hi, 0.1, seed - 1)[0],
                att.generate.uniform_seeded(m_tall, 0.1, seed - 2)[0])
    planes, _ = pack_batch_staggered(pairs, 1, device="cuda")
    return planes, (planes[0].shape[0], max(len(b) for _, b in pairs))


def phase27_grid(packs, k6_saved, k9_saved) -> tuple[int, int, tuple]:
    """Ring K6 and ring K9 == plain (and == their stripe kernels) on a grid;
    returns the max abs difference of each over costs, every checkpoint row
    (the zero rows outside the true windows included) and every top value.
    On phase 10's and 13's 160- and 33-lane packs (n <= 1500 with an n ==
    0 lane, a skewed pair making S ~ 280) each ring kernel is held against
    the plain results those phases computed, at its own ring size and, up
    to 256 words, at a ring forced to 256.  New cases: ring K6 with CB = SW
    + 8 on the 160-lane pack with an m == 0 lane, and on 33 pairs of up to
    3.5 kbp beside a 38 kbp one (S = 1188), where rings forced to 256 words
    wrap at least 3 times and checkpoint columns shift (the word above the
    window top absorbed the step before it is taken), and at SW 2048 on 33
    pairs of up to 3 kbp beside a 70 kbp one (S = 2188); ring K9 on the
    3.5 kbp pack with forced rings.  Then both refuse a band of more live
    words than their 4096-word ring, without a launch.  Also returns the
    refused band's planes, for phase 32."""
    t0 = time.perf_counter()
    wide, narrow, diag = packs
    m0 = (wide[0], wide[1], wide[2], wide[3], wide[4].copy(), wide[5].copy())
    m0[5][3] = 0  # an m == 0 lane
    long_, diag_l = _ring_pack(RING_LONG_N, RING_TALL_M, 9400)
    big, diag_b = _ring_pack(RING_BIG_N, RING_BIG_M, 9500)
    if big[2].shape[0] < 2048 + 8:
        fail(f"phase 27's big pack has S = {big[2].shape[0]} < 2056")
    k6_cases = [(planes, "phase 10", sw, cb, dg, rw, want)
                for planes, sw, dg, cb, want in k6_saved
                for rw in ((None, 256) if sw <= 256 else (None,))]
    for planes, label, sw, cb, dg, rw in (
            (m0, "m == 0 lane", 64, 72, diag, None), (narrow, "phase 10", 256, 264, diag, 256),
            (long_, "long", 64, 72, diag_l, 256), (big, "big", 2048, 2056, diag_b, None)):
        k6_cases.append((planes, label, sw, cb, dg, rw,
                         striped.striped_ck_ref(*planes, sw, cb, dg)))
    before = dict(banded_kernel.LAUNCHES)
    worst6, labels, wraps, shifted = 0, [], [], 0
    for planes, pack, sw, cb, dg, rw, want in k6_cases:
        got = banded_kernel.striped_ck(*planes, sw, cb, dg, ring_words=rw)
        err = _max_err(got, want)
        nm, S_ = planes[0].shape[0], planes[2].shape[0]
        plan = striped.plan_striped(nm, S_, sw, dg)
        CB, n_ck, _ = striped.ck_layout(nm, sw, cb, plan["lo"])
        span = striped.ring_span(plan, nm)
        ring = banded_kernel.ring_threads(span, rw) * 8
        laps = plan["n_words_live"] / ring
        if pack != "phase 10":
            stripe = banded_kernel.striped_ck(*planes, sw, cb, dg,
                                              8 * banded_kernel.striped_threads(sw))
            err = max(err, _max_err(stripe, want))
        if rw is not None and pack == "long":
            wraps.append(laps)
        sh = sum(int(plan["lo"][k * CB - 1] != plan["lo"][k * CB - 2]) for k in range(1, n_ck))
        shifted += sh
        label = (f"{pack} B={planes[0].shape[1]} SW={sw} CB={CB} ({n_ck} ck, {sh} at a shift) "
                 f"diag={'set' if dg else 'None'} span {span} ring {ring} ({laps:.2f} laps)")
        if err:
            fail(f"ring K6 != plain or stripes at {label}")
        worst6 = max(worst6, err)
        labels.append(label)
    if min(wraps) < 3 or not shifted:
        fail(f"phase 27's ring K6 grid: forced rings wrap {min(wraps):.2f} times, "
             f"{shifted} checkpoints at a shift")
    t6 = time.perf_counter() - t0
    rng = np.random.default_rng(27)
    nl = long_[0].shape[0]
    k9_cases = [(planes, kind, sched, sw, q, rw, want)
                for planes, kind, sched, sw, q, want in k9_saved
                for rw in ((None, 256) if sw <= 256 else (None,))]
    sched_l = _pp_random(rng, nl, 33, 4)
    k9_cases.append((long_, "long random", sched_l, 64, 4, 256,
                     pinned.pinned_cost_pp_ref(*long_, sched_l, 64, 4)))
    worst9, labels9, wraps9 = 0, [], []
    for planes, kind, sched, sw, q, rw, want in k9_cases:
        got = banded_kernel.pinned_cost_pp(*planes, sched, sw, q, ring_words=rw)
        stripe = banded_kernel.pinned_cost_pp(*planes, sched, sw, q,
                                              8 * banded_kernel.striped_threads(sw))
        err = max(_max_err(got, want), _max_err(stripe, want))
        plan, _, threads = banded_kernel.ring_pp_events(
            pinned.check_pp_schedule(sched, planes[0].shape[0], planes[0].shape[1], q),
            np.asarray(planes[4]), sw, "cuda", rw)
        laps = float(plan["nwl"].max()) / (threads * 8)
        if planes is long_:
            wraps9.append(laps)
        label = f"{kind} B={planes[0].shape[1]} SW={sw} Q={q} ring {threads * 8} ({laps:.2f} laps)"
        if err:
            fail(f"ring K9 != plain or stripes at {label}")
        worst9 = max(worst9, err)
        labels9.append(label)
    if min(wraps9) < 3:
        fail(f"phase 27's ring K9 grid: forced rings wrap only {min(wraps9):.2f} times")
    t9 = time.perf_counter() - t0 - t6
    got_ring = {k: banded_kernel.LAUNCHES[k] - before[k] for k in ("ring_ck", "ring_cost_pp")}
    if got_ring != {"ring_ck": len(k6_cases), "ring_cost_pp": len(k9_cases)}:
        fail(f"phase 27 launched the ring kernels {got_ring} times")
    # A band of more live words than the ring holds: a full height of 4376
    # words over 4500 columns (every word stays live).
    bargs, _ = pack_batch_staggered([(att.generate.uniform_seeded(4500, 0.0, 8500)[0],
                                      att.generate.uniform_seeded(140_032, 0.1, 8501)[0])],
                                    1, device="cuda")
    Sb = bargs[2].shape[0]
    sched_b = np.broadcast_to(banded.shift_at_array(bargs[0].shape[0], Sb, Sb)[:, None],
                              (bargs[0].shape[0], 1))
    before = dict(banded_kernel.LAUNCHES)
    refused = []
    for fn in (lambda: banded_kernel.striped_ck(*bargs, Sb, Sb + 8, None, ring_words=4096),
               lambda: banded_kernel.pinned_cost_pp(*bargs, sched_b, Sb, 1, ring_words=4096)):
        try:
            fn()
            fail("a ring kernel took a band of more live words than its ring holds")
        except ValueError as exc:
            refused.append(str(exc))
    if banded_kernel.LAUNCHES != before or Sb % 8 or banded_kernel.ring_takes(Sb):
        fail(f"ring refusal: launches {banded_kernel.LAUNCHES} (before {before}), S = {Sb}")
    torch.cuda.synchronize()
    say(f"[27 ring K6=plain] {len(k6_cases)}/{len(k6_cases)} cases (phase 10's n_max "
        f"{wide[0].shape[0]}, S {wide[2].shape[0]}; long n_max {nl}, S {long_[2].shape[0]}; "
        f"big n_max {big[0].shape[0]}, S {big[2].shape[0]}: {'; '.join(labels)}); the new "
        f"cases also == the stripe kernel; max_abs_err {worst6}; forced rings wrap >= "
        f"{min(wraps):.2f} times; {shifted} checkpoints at a shifting column; {t6:.1f} s")
    say(f"[27 ring K9=plain] {len(k9_cases)}/{len(k9_cases)} cases (phase 13's and long n_max "
        f"{nl}: {'; '.join(labels9)}); == the stripe kernel on each; max_abs_err {worst9}; forced rings wrap >= "
        f"{min(wraps9):.2f} times; {t9:.1f} s")
    say(f"[27 refusal] S = {Sb} at full height over {bargs[0].shape[0]} columns, ring forced: "
        f"both refused without a launch ({refused[0]}); by default the stripe kernels take "
        f"it; {time.perf_counter() - t0:.1f} s")
    return worst6, worst9, bargs


def _pp_kernel_ms(fn) -> tuple[float, float, torch.Tensor]:
    """One call of a per-pair wrapper: (CUDA-event ms from the end of its
    event tables to the end of the call, the tables' ms, its result)."""
    spy = RoundSpy(())
    spy.install()
    try:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        spy._tables = None
        a.record()
        out = fn()
        b.record()
    finally:
        spy.remove()
    b.synchronize()
    t0, t1 = spy._tables
    return t1.elapsed_time(b), t0.elapsed_time(t1), out


def phase28_time(c5_spy: RoundSpy, c5d_spy: RoundSpy, c4_round) -> dict:
    """Ring against stripe kernels on whole main-path shapes, once each
    (stripes, then ring), each with its bound: K6 on config #5's align rung
    over chained launches; K9 on config #5 default's round and on config
    #4's round (kernel from the end of its event tables, tables timed
    apart).  The ring's results
    equal the stripes' on every lane, plane row and top value.  Returns
    the records phase 28 adds to ring K6's and ring K9's."""
    torch.cuda.synchronize()
    *planes, sw, cb, dg = c5_spy.last["ring_ck"]
    stripe = 8 * banded_kernel.striped_threads(sw)
    fns = {"stripe": lambda: banded_kernel.striped_ck(*planes, sw, cb, dg, stripe),
           "ring": lambda: banded_kernel.striped_ck(*planes, sw, cb, dg)}
    outs = {k: fn() for k, fn in fns.items()}
    err6 = _max_err(outs["ring"], outs["stripe"])
    if err6:
        fail("ring K6 != the stripe K6 on config #5's align rung")
    times = {"stripe": [], "ring": []}
    for name in ("stripe", "ring"):
        times[name].append(_chained_ms(fns[name], RING_CHAINED))
    bnd6 = plane_bound(planes, sw, outs["ring"])
    shape6 = {"B": planes[0].shape[1], "n_max": planes[0].shape[0], "S": planes[2].shape[0],
              "SW": sw, "CB": cb}
    span = striped.ring_span(striped.plan_striped(shape6["n_max"], shape6["S"], sw, dg),
                             shape6["n_max"])
    r6, s6 = min(times["ring"]), min(times["stripe"])
    say(f"[28 K6 rung] config #5's align rung {shape6}, {RING_CHAINED} chained launches behind "
        f"an untimed one, stripes then ring: ring K6 "
        f"{_ms(times['ring'])} ms ({r6 / bnd6['bound_ms']:.2f}x), "
        f"stripe K6 {_ms(times['stripe'])} ms "
        f"({s6 / bnd6['bound_ms']:.2f}x) vs bound {bnd6['bound_ms']:.4f} ms "
        f"({bnd6['bound_by']}); stripes/ring {s6 / r6:.3f}; ring {span} live words in "
        f"{banded_kernel.ring_threads(span) * 8}, stripes of {stripe}; ring == stripes on "
        f"all {shape6['B']} lanes, every plane row and top value (CUDA events)")
    rec6 = {"rung_alone_ms": times["ring"], "stripe_rung_alone_ms": times["stripe"],
            "rung_alone_bound_ms": bnd6["bound_ms"], "rung_alone_shape": shape6}

    rec9 = {}
    for label, args in (("config #5 default", c5d_spy.last["ring_cost_pp"]),
                        ("config #4", c4_round)):
        *pl, sched, s_, q = args
        stripe = 8 * banded_kernel.striped_threads(s_)
        fns = {"stripe": lambda: banded_kernel.pinned_cost_pp(*pl, sched, s_, q, stripe),
               "ring": lambda: banded_kernel.pinned_cost_pp(*pl, sched, s_, q)}
        kern, tabs, res = {"stripe": [], "ring": []}, {"stripe": [], "ring": []}, {}
        for name in ("stripe", "ring"):
            ms, tab_ms, res[name] = _pp_kernel_ms(fns[name])
            kern[name].append(ms)
            tabs[name].append(tab_ms)
        if _max_err(res["ring"], res["stripe"]):
            fail(f"ring K9 != the stripe K9 on {label}'s round")
        b9 = plane_bound(pl, s_, [], sched.size)
        shape9 = {"B": pl[0].shape[1], "n_max": pl[0].shape[0], "S": pl[2].shape[0],
                  "SW": s_, "Q": q}
        r9, s9 = min(kern["ring"]), min(kern["stripe"])
        say(f"[28 K9 {label}] round {shape9}, stripes then ring, kernel "
            f"from the end of its event tables: ring K9 {_ms(kern['ring'])} ms ({r9 / b9['bound_ms']:.2f}x), stripe K9 "
            f"{_ms(kern['stripe'])} ms ({s9 / b9['bound_ms']:.2f}x) "
            f"vs bound {b9['bound_ms']:.4f} ms; stripes/ring {s9 / r9:.3f}; event tables on "
            f"the card: ring {_ms(tabs['ring'])} ms (3 rows, ring "
            f"sized on the card), stripes {_ms(tabs['stripe'])} ms; "
            f"ring == stripes on all {shape9['B']} lanes (CUDA events)")
        key = "c5_default" if label.startswith("config #5") else "c4"
        rec9.update({f"{key}_round_ms": kern["ring"], f"{key}_stripe_round_ms": kern["stripe"],
                     f"{key}_tables_ms": tabs["ring"], f"{key}_stripe_tables_ms": tabs["stripe"],
                     f"{key}_round_bound_ms": b9["bound_ms"], f"{key}_round_shape": shape9})

    return {"ring_ck": rec6, "ring_cost_pp": rec9}


def _tall_pack(rng, count: int, n_hi: int, tall: tuple, seed: int):
    """``count`` pairs of up to ``n_hi`` bp at e <= 25%, the first a tall
    pair (``tall`` = (n, m)), the second with n == 0, the third with m ==
    0, packed on the card."""
    pairs = [att.generate.uniform_seeded(int(rng.integers(1, n_hi + 1)),
                                         float(rng.uniform(0, 0.25)), seed + s)
             for s in range(count)]
    pairs[0] = (att.generate.uniform_seeded(tall[0], 0.1, seed - 1)[0],
                att.generate.uniform_seeded(tall[1], 0.1, seed - 2)[0])
    pairs[1] = (b"", pairs[1][1])
    pairs[2] = (pairs[2][0], b"")
    return pack_batch_staggered(pairs, 1, device="cuda")[0]


def phase29_grid(wide, narrow, c5_spy: RoundSpy) -> tuple[int, dict]:
    """The redesigned K7 and the wide ring == plain and == K5's stripes on
    a grid: phase 10's 160- and 33-lane packs (n == 0 and m == 0 lanes, S ~
    280) with rings forced to both designs; 33 pairs of up to 2 kbp beside
    a tall one (S = 1188) with forced rings; the full height of 33 pairs of
    up to 4.2 kbp beside a skewed 4200 x 160 kbp pair (S = 5000, 4200 live
    words: the wide ring by default, wrapping); 33 pairs of up to 500 bp
    beside a 500 x 150 kbp pair (S = 4688) at SW 4352 with a wide ring
    forced to 1024 words, which wraps at least 3 times; config #5's
    pack cut to its first 1024 columns at SW 8192 on the wide ring, timed
    against plain (CUDA events); and the refusal, without a launch, of a
    band of more than 16384 live words.
    Returns (max abs difference, the wide ring's JSON record without its
    launch count)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(29)
    diag = (wide[0].shape[0], int(np.asarray(wide[5])[3:].max()))
    S = wide[2].shape[0]
    lng = _tall_pack(rng, 33, K7_GRID_LONG_N, (K7_GRID_LONG_N, K7_GRID_TALL_M), 29_000)
    dl = (lng[0].shape[0], int(np.asarray(lng[5]).max()))  # aimed at the tall pair
    big = _tall_pack(rng, 33, WIDE_GRID_N, (WIDE_GRID_N, WIDE_GRID_TALL_M), 29_100)
    low = _tall_pack(rng, 33, WIDE_LOW_N, (WIDE_LOW_N, WIDE_LOW_TALL_M), 29_200)
    Sb, Sl = big[2].shape[0], low[2].shape[0]
    # A skewed pack (S > n_max): a band below full height slides a word a
    # column.
    dlo = (low[0].shape[0], 32 * low[0].shape[0])
    # (planes, label, SW, diag, ring_words, thread_words)
    # The plain sweeps take most of the phase: a band of 8192 words runs on
    # config #5's cut below, the wide-band pack only at its full height.
    cases = [(narrow, "B=33", 67, diag, None, None), (wide, "B=160", S, None, 512, 16),
             (narrow, "B=33", 256, diag, 1024, 32), (wide, "B=160", 64, diag, 2048, 16),
             (lng, "long", 64, dl, 256, None), (lng, "long", 256, None, 512, 16),
             (big, "wide band", Sb, None, None, None), (low, "low", 4352, dlo, 1024, 32),
             (low, "low", Sl, None, None, None)]
    worst, labels, wraps, plain_s, by_default = 0, [], {8: [], 16: [], 32: []}, 0.0, 0
    for planes, label, sw, dg, rw, tw in cases:
        t1 = time.perf_counter()
        want = striped.pinned_cost_ref(*planes, sw, dg)
        plain_s += time.perf_counter() - t1
        got = banded_kernel.pinned_cost(*planes, sw, dg, rw, tw)
        err = max(_max_err(got, want), _max_err(_stripes(planes, sw, dg), want))
        sw_eff = min(sw, planes[2].shape[0])
        plan = striped.plan_striped(planes[0].shape[0], planes[2].shape[0], sw_eff, dg)
        span = striped.ring_span(plan, int(np.max(planes[4], initial=1)))
        threads, words = banded_kernel.ring_cost_layout(span, rw, tw)
        laps = plan["n_words_live"] / (threads * words)
        if label in ("long", "wide band", "low") and (rw is not None or words > 8):
            wraps[words].append(laps)
        by_default += rw is None and tw is None and words > 8
        text = (f"{label} SW={sw_eff}{' (full)' if sw_eff == planes[2].shape[0] else ''} "
                f"span {span} ring {threads}x{words} ({laps:.2f} laps)")
        if err:
            fail(f"the cost ring != plain or K5 at {text}")
        worst = max(worst, err)
        labels.append(text)
    if min(wraps[8]) < 3 or min(wraps[16] + wraps[32]) < 1 or max(wraps[16] + wraps[32]) < 3:
        fail(f"phase 29's rings wrap too little: {wraps}")
    if not by_default:
        fail("phase 29's wide band did not take the wide ring by default")
    # Config #5's pack cut to its first columns at SW 8192 on the wide ring.
    *c5_planes, _, _ = c5_spy.last["pinned_cost"]
    cut = _cut(c5_planes, C5_WIDE_CUT)
    dg = _cut_diag(cut)
    p_ms, want = _event_ms(lambda: striped.pinned_cost_ref(*cut, C5_K5_BAND, dg))
    k_ms = []
    for _ in range(2):
        ms, got = _event_ms(lambda: banded_kernel.pinned_cost(*cut, C5_K5_BAND, dg, None, 16))
        k_ms.append(ms)
        worst = max(worst, _max_err(got, want), _max_err(_stripes(cut, C5_K5_BAND, dg), want))
    if worst:
        fail("the wide ring != plain on config #5's cut at SW 8192")
    shape = {"B": cut[0].shape[1], "n_max": cut[0].shape[0], "S": cut[2].shape[0],
             "SW": C5_K5_BAND}
    bnd = plane_bound(cut, C5_K5_BAND, [got])
    # More than 16384 live words: a full height over 16400 columns.
    over = [(att.generate.uniform_seeded(16_400, 0.0, 29_300)[0],
             att.generate.uniform_seeded(530_000, 0.1, 29_301)[0])]
    oargs, _ = pack_batch_staggered(over, 1, device="cuda")
    before = dict(banded_kernel.LAUNCHES)
    try:
        banded_kernel.pinned_cost(*oargs, oargs[2].shape[0])
        fail("the cost ring took more live words than it holds")
    except ValueError as exc:
        refused = str(exc)
    if banded_kernel.LAUNCHES != before:
        fail("the cost ring launched past its capacity")
    torch.cuda.synchronize()
    say(f"[29 cost ring=plain] {len(cases)}/{len(cases)} cases, each also == K5's stripes "
        f"({'; '.join(labels)}); config #5's cut {shape} on the wide ring: "
        f"{k_ms[0]:.3f}/{k_ms[1]:.3f} ms vs plain {p_ms:.1f} ms, bound {bnd['bound_ms']:.4f} "
        f"ms; max_abs_err {worst}; forced K7 rings wrap >= {min(wraps[8]):.2f} times, wide "
        f"rings up to {max(wraps[16] + wraps[32]):.2f}; S = {oargs[2].shape[0]} at full height "
        f"over {oargs[0].shape[0]} columns refused without a launch ({refused}); plain sweeps "
        f"{plain_s:.1f} s; {time.perf_counter() - t0:.1f} s")
    return worst, {"max_abs_err": worst, "ms": float(np.mean(k_ms)), "plain_ms": p_ms, **bnd,
                   "library_ms": None, "shape": shape}


def phase30_time(c5_spy: RoundSpy, c4_spy: RoundSpy) -> dict:
    """The cost ring against K5's stripes on whole main-path rungs, once
    each (stripes, then ring), each over chained launches behind
    an untimed one, with its bound, their costs equal: K7 on config #4's
    full-height rung (SW = 3149), the wide ring on config #5's SW = 8192
    rung.  Returns the records phase 30
    adds to K7's, the wide ring's and K5's."""
    torch.cuda.synchronize()
    rows, recs = [], {"pinned_cost": {}, "ring_cost_wide": {}, "striped_cost": {}}
    # The earlier designs' times on these rungs (PERF.md): K7 in
    # pinned_ring_kernel, K5's stripes in the path's call.
    before = {"config #4 full height": "K7 in pinned_ring_kernel 79.6 ms in the path",
              "config #5 SW=8192": "K5's stripes 973.5 ms in the path"}
    # Config #5's SW=2048 rung: K7 and K5's stripes alone over chained
    # launches in phase 23.
    for label, key, args in (("config #4 full height", "c4", c4_spy.last["pinned_cost"]),
                             ("config #5 SW=8192", "c5_wide", c5_spy.last["ring_cost_wide"])):
        *pl, sw, dg = args
        fns = {"stripes": lambda: _stripes(pl, sw, dg),
               "ring": lambda: banded_kernel.pinned_cost(*pl, sw, dg)}
        if _max_err(fns["ring"](), fns["stripes"]()):
            fail(f"the cost ring != K5's stripes on {label}'s rung")
        times = {"stripes": [], "ring": []}
        for name in ("stripes", "ring"):
            times[name].append(_chained_ms(fns[name], RING_CHAINED))
        b = plane_bound(pl, sw, [])["bound_ms"]
        n_max, S = pl[0].shape[0], pl[2].shape[0]
        plan = striped.plan_striped(n_max, S, min(sw, S), dg)
        span = striped.ring_span(plan, int(np.max(pl[4], initial=1)))
        threads, words = banded_kernel.ring_cost_layout(span)
        kern = "K7" if words == 8 else "the wide ring"
        r, st = min(times["ring"]), min(times["stripes"])
        shape = {"B": pl[0].shape[1], "n_max": n_max, "S": S, "SW": min(sw, S)}
        rows.append(f"{label} {shape}: {kern} {_ms(times['ring'])} ms "
                    f"({r / b:.2f}x), K5's stripes {_ms(times['stripes'])} ms ({st / b:.2f}x) vs bound {b:.4f} ms; "
                    f"stripes/ring {st / r:.3f}; {span} live words in {threads} threads of "
                    f"{words} slots ({plan['n_words_live'] / (threads * words):.2f} laps), "
                    f"stripes of {8 * banded_kernel.striped_threads(min(sw, S))}; before: "
                    f"{before[label]}")
        rec = {f"{key}_turns_ms": times["ring"], f"{key}_bound_ms": b, f"{key}_shape": shape}
        recs["ring_cost_wide" if words > 8 else "pinned_cost"].update(rec)
        recs["striped_cost"].update({f"{key}_turns_ms": times["stripes"], f"{key}_bound_ms": b,
                                     f"{key}_shape": shape})
    say(f"[30 cost ring vs stripes] {RING_CHAINED} chained launches behind an untimed one, "
        f"stripes then ring (CUDA events; ring == stripes on every lane): "
        f"{'; '.join(rows)}")
    return recs


class Laps:
    """Host seconds of each stretch of the run, printed at its end."""

    def __init__(self):
        self.last = time.perf_counter()
        self.laps = []

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        self.laps.append(f"{label} {now - self.last:.1f}")
        self.last = now

K1_GRID_SW = (1, 2, 31, 32, 33, 63)  # phase 31
K10_LONG_N = 4200  # phase 32: at Q 8, SW 256, forced 256-word rings wrap 3+ times


def _full_ring_lanes(span: int) -> int:
    """The other layout phase 31 times: the fewest lanes whose slots the
    live run fills (no spare slot), below a warp."""
    lanes = 1
    while lanes * 8 < span:
        lanes *= 2
    return lanes


def phase31_k1(k1_pack) -> dict:
    """K1's ring kernel against the old K1: == plain on a grid (SW 1, 2, 31,
    32, 33 and 63 with and without a diagonal, both layouts: a spare slot in
    the ring, the runner's, and a full ring; pairs covered by the window,
    above and below it, and n == 0; the plain version is K1's staggered
    twin, itself held to K1's column loop at SW 2), then in turns (old, ring, ring, old) on
    phase 3's whole pack and its 1024-column cut, then a band sweep on the
    whole pack (both layouts) with K7 at SW 64 beside it.  Returns the old
    K1's record and the fields phase 31 adds to the ring kernel's."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(31)
    pairs = _random_pairs(rng, 40, 250, 2200) + [
        (b"", b"ACGT" * 20), (b"ACG", b"ACGT" * 175), (b"ACGT" * 60, b"ACGTAC")]
    grid, _ = pack_batch_staggered(pairs, 1, device="cuda")
    n_max, S, B = grid[0].shape[0], grid[2].shape[0], grid[0].shape[1]
    if S < max(K1_GRID_SW):
        fail(f"phase 31's grid has S = {S} < {max(K1_GRID_SW)}")
    n_lim = int(np.max(grid[4]))
    worst, kinds, labels = 0, set(), []
    for sw in K1_GRID_SW:
        for diag in (None, (n_max, S * 32 - 50)):
            # K1's staggered plain twin (bit for bit K1's column-loop plain
            # version, held to it on the CPU and below at SW 2; a sweep of
            # n_max + S steps where the column loop takes n_max * SW).
            want = striped.banded_cost_staggered_ref(*grid, sw, diag)
            if sw == 2 and _max_err(banded.banded_cost_ref(*grid, sw, diag), want):
                fail(f"K1's staggered plain twin != K1's plain version at SW={sw} diag={diag}")
            plan = striped.plan_striped(n_max, S, sw, diag)
            span = striped.ring_span(plan, n_lim)
            lay = banded_kernel.banded_ring_layout(span, B)["lanes"]
            for lanes in sorted({lay, _full_ring_lanes(span)}):
                err = _max_err(banded_kernel._launch_banded_ring(*grid, sw, diag, lanes), want)
                if err:
                    fail(f"K1's ring kernel != plain at SW={sw} diag={diag} lanes {lanes}")
                worst = max(worst, err)
            rows = np.asarray(grid[5], np.int64) - striped.loend_of(plan["lo"], grid[4]) * 32
            kinds |= {"n == 0" if n == 0 else "above" if r < 0 else "below" if r > sw * 32
                      else "covered" for n, r in zip(np.asarray(grid[4]), rows)}
            labels.append(f"SW={sw}{' diag' if diag else ''} span {span} lanes "
                          f"{lay}/{_full_ring_lanes(span)}")
    if kinds != {"n == 0", "above", "below", "covered"}:
        fail(f"phase 31's grid holds only {sorted(kinds)}")
    say(f"[31 K1=plain] {len(labels)} cases x both layouts (B {B}, n_max {n_max}, S {S}: "
        f"{'; '.join(labels)}); pairs {sorted(kinds)}; max_abs_err {worst}; "
        f"{time.perf_counter() - t0:.1f} s")

    planes, diag, plain_cut_ms = k1_pack
    sw = TIMED_SW
    cut = _cut(planes, CUT_COLS)
    rec = {}
    for label, p_, d_ in (("whole", planes, diag), ("cut", cut, _cut_diag(cut))):
        fns = {"old": lambda: banded_kernel._launch("banded_cost", *p_, sw, diag=d_),
               "ring": lambda: banded_kernel.banded_cost(*p_, sw, d_)}
        times, outs = {"old": [], "ring": []}, {}
        for name in ("old", "ring"):
            ms, outs[name] = _event_ms(fns[name])
            times[name].append(ms)
        err = _max_err(outs["ring"], outs["old"])
        if err:
            fail(f"K1's ring kernel != the old K1 on phase 3's {label} pack")
        bnd = plane_bound(p_, sw, [outs["ring"]])
        shape = {"B": p_[0].shape[1], "n_max": p_[0].shape[0], "S": p_[2].shape[0], "SW": sw}
        o, r = min(times["old"]), min(times["ring"])
        say(f"[31 K1 {label}] phase 3's {label} pack {shape}, old then ring: "
            f"ring {_ms(times['ring'])} ms ({r / bnd['bound_ms']:.2f}x), "
            f"old K1 {_ms(times['old'])} ms ({o / bnd['bound_ms']:.2f}x) "
            f"vs bound {bnd['bound_ms']:.4f} ms; old/ring {o / r:.2f}; equal on all lanes "
            f"(CUDA events, the wrapper's call)")
        rec[label] = (times, bnd, shape)
    times_c, bnd_c, shape_c = rec["cut"]
    times_w, bnd_w, shape_w = rec["whole"]
    old = {"max_abs_err": 0, "ms": float(np.mean(times_c["old"])), "plain_ms": plain_cut_ms,
           **bnd_c, "library_ms": None, "shape": shape_c,
           "full_ms": float(np.mean(times_w["old"])), "full_bound_ms": bnd_w["bound_ms"],
           "full_shape": shape_w}
    ring = {"turns_old_cut_ms": times_c["old"], "turns_ring_cut_ms": times_c["ring"],
            "turns_old_full_ms": times_w["old"], "turns_ring_full_ms": times_w["ring"]}

    ring["max_abs_err"] = worst
    return {"banded_cost": old, "banded_ring": ring}


def phase32_ring_k10(saved_ck, bargs, c4_ck_round, c5d_spy: RoundSpy) -> tuple[int, dict]:
    """Ring K10 == plain and == the stripe K10: on phase 13's checkpoint
    cases (their plain results) at its own ring and, up to 256 words, a
    ring forced to 256; at Q 1 (CB = SW) and Q 8 (CB > SW) on pairs of up
    to 0.8 and 4.2 kbp beside a 10 kbp b, rings forced to 256 words
    wrapping at least 3 times; then its refusal,
    without a launch, of a band of more live words than its 4096-word ring.
    Then ring K10 against the stripe K10 in turns (stripes, ring, ring,
    stripes) on config #5 default's and config #4's whole checkpoint rounds
    (phases 14 and 7), kernel from the end of its event tables.  Returns
    the max abs difference and the fields phase 32 adds to ring K10's and
    the stripe K10's records."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(32)
    cases = [(planes, kind, sched, sw, q, cb, rw, want)
             for planes, kind, sched, sw, q, cb, want in saved_ck
             for rw in ((None, 256) if sw <= 256 else (None,))]
    # Rings forced to 256 words that wrap at least 3 times: at Q = 1 on 12
    # pairs of up to 800 bp (every fifth lane shifts at every column), at
    # Q = 8 on 8 pairs of 4200 bp (every lane shifts at every eighth
    # column); each beside a 10 kbp b (S = 313).
    long_ = None
    for q, sw, cb, count, n_hi in ((1, 64, 64, 12, 800), (8, 256, 264, 8, K10_LONG_N)):
        pairs = [att.generate.uniform_seeded(int(rng.integers(n_hi // 2, n_hi + 1)), 0.1,
                                             9600 + 50 * q + s) for s in range(count)]
        pairs[0] = (att.generate.uniform_seeded(n_hi, 0.1, 9599 + q)[0],
                    att.generate.uniform_seeded(10_000, 0.1, 9598 + q)[0])
        planes, _ = pack_batch_staggered(pairs, 1, device="cuda")
        sched = _pp_random(rng, planes[0].shape[0], count, q)
        if q == 8:
            sched[8::8] = 1
        cases.append((planes, f"wrap Q={q}", sched, sw, q, cb, 256,
                      pinned.pinned_ck_pp_ref(*planes, sched, sw, cb, q)))
    wrap_cases = {id(c[0]) for c in cases[-2:]}
    before = dict(banded_kernel.LAUNCHES)
    worst, labels, wraps = 0, [], []
    for planes, kind, sched, sw, q, cb, rw, want in cases:
        got = banded_kernel.pinned_ck_pp(*planes, sched, sw, cb, q, ring_words=rw)
        stripe = banded_kernel.pinned_ck_pp(*planes, sched, sw, cb, q,
                                            8 * banded_kernel.striped_threads(sw))
        err = max(_max_err(got, want), _max_err(stripe, want))
        plan, _, threads = banded_kernel.ring_pp_events(
            pinned.check_pp_schedule(sched, planes[0].shape[0], planes[0].shape[1], q),
            np.asarray(planes[4]), sw, "cuda", rw, n_lim=planes[0].shape[0])
        laps = float(plan["nwl"].max()) / (threads * 8)
        if id(planes) in wrap_cases:
            wraps.append(laps)
        CB = banded.ck_col_block(cb, planes[0].shape[0], q)
        label = (f"{kind} B={planes[0].shape[1]} SW={sw} Q={q} CB={CB} ring {threads * 8} "
                 f"({laps:.2f} laps)")
        if err:
            fail(f"ring K10 != plain or the stripe K10 at {label}")
        worst = max(worst, err)
        labels.append(label)
    if min(wraps) < 3:
        fail(f"phase 32's forced rings wrap only {min(wraps):.2f} times")
    ran = {k: banded_kernel.LAUNCHES[k] - before[k] for k in ("ring_ck_pp", "pinned_ck_pp")}
    if ran != {"ring_ck_pp": len(cases), "pinned_ck_pp": len(cases)}:
        fail(f"phase 32's grid launched {ran}")
    Sb = bargs[2].shape[0]
    sched_b = np.zeros((bargs[0].shape[0], 1), np.uint8)
    before = dict(banded_kernel.LAUNCHES)
    try:
        banded_kernel.pinned_ck_pp(*bargs, sched_b, Sb, bargs[0].shape[0], 1, ring_words=4096)
        fail("ring K10 took a band of more live words than its ring holds")
    except ValueError as exc:
        refused = str(exc)
    if banded_kernel.LAUNCHES != before or banded_kernel.ring_takes(Sb):
        fail(f"ring K10's refusal launched a kernel (S = {Sb})")
    say(f"[32 ring K10=plain] {len(cases)}/{len(cases)} cases (phase 13's and two wrap packs': "
        f"{'; '.join(labels)}); == the stripe K10 on each; "
        f"max_abs_err {worst}; forced rings wrap >= {min(wraps):.2f} times; a full height of "
        f"{Sb} words refused without a launch ({refused}); {time.perf_counter() - t0:.1f} s")

    recs = {"ring_ck_pp": {}, "pinned_ck_pp": {}}
    for label, args in (("config #5 default", c5d_spy.last["ring_ck_pp"]),
                        ("config #4", c4_ck_round)):
        *pl, sched, s_, cb_, q = args
        stripe = 8 * banded_kernel.striped_threads(s_)
        fns = {"stripe": lambda: banded_kernel.pinned_ck_pp(*pl, sched, s_, cb_, q, stripe),
               "ring": lambda: banded_kernel.pinned_ck_pp(*pl, sched, s_, cb_, q)}
        kern, tabs, res = {"stripe": [], "ring": []}, {"stripe": [], "ring": []}, {}
        for name in ("stripe", "ring"):
            ms, tab_ms, res[name] = _pp_kernel_ms(fns[name])
            kern[name].append(ms)
            tabs[name].append(tab_ms)
        if _max_err(res["ring"], res["stripe"]):
            fail(f"ring K10 != the stripe K10 on {label}'s checkpoint round")
        bnd = plane_bound(pl, s_, res["ring"], sched.size)
        shape = {"B": pl[0].shape[1], "n_max": pl[0].shape[0], "S": pl[2].shape[0], "SW": s_,
                 "Q": q, "CB": banded.ck_col_block(cb_, pl[0].shape[0], q)}
        r, st = min(kern["ring"]), min(kern["stripe"])
        say(f"[32 K10 {label}] checkpoint round {shape}, stripes then ring, "
            f"kernel from the end of its event tables: ring K10 {_ms(kern['ring'])} ms ({r / bnd['bound_ms']:.2f}x), stripe K10 "
            f"{_ms(kern['stripe'])} ms ({st / bnd['bound_ms']:.2f}x) "
            f"vs bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); stripes/ring {st / r:.3f}; "
            f"event tables: ring {_ms(tabs['ring'])} ms, stripes "
            f"{_ms(tabs['stripe'])} ms; ring == stripes on all "
            f"{shape['B']} lanes, every plane row and top value (CUDA events)")
        key = "c5_default" if label.startswith("config #5") else "c4"
        for name, which in (("ring_ck_pp", "ring"), ("pinned_ck_pp", "stripe")):
            recs[name].update({f"{key}_round_turns_ms": kern[which],
                               f"{key}_tables_ms": tabs[which],
                               f"{key}_round_bound_ms": bnd["bound_ms"],
                               f"{key}_round_shape": shape})
    return worst, recs


K33_GRID_N, K33_GRID_M = 200, 500  # phase 33's grid: S ~ 16 words, n_max ~ 200
K33_GRID_SW = (1, 4, 16)  # phase 33, with the full height beside them


def _k4_grid_pack(rng):
    """Phase 33's grid: similar pairs of up to K33_GRID_N bp (most shorter
    than n_max by far), random pairs beside b of up to K33_GRID_M bp, an n
    == 0 pair, a short a against a long b (row m below the window) and a
    long a against a short b (row m above it)."""
    pairs = [att.generate.uniform_seeded(int(rng.integers(1, K33_GRID_N)),
                                         float(rng.uniform(0, 0.3)), 3300 + s) for s in range(36)]
    pairs += _random_pairs(rng, 4, K33_GRID_N // 2, K33_GRID_M)
    pairs += [(b"ACG", b"ACGT" * 120), (b"ACGT" * 48, b"ACGTAC")]
    return pairs, pack_batch_staggered(pairs, 1, device="cuda")[0]


def _in_turns(fns: dict, order) -> tuple[dict, dict]:
    """Each named call in ``order`` (CUDA events around it); returns ({name:
    ms list}, {name: last result})."""
    times, outs = {k: [] for k in fns}, {}
    for name in order:
        ms, outs[name] = _event_ms(fns[name])
        times[name].append(ms)
    return times, outs


def phase33_k4_k3(rspy: RoundSpy, fspy: FillSpy) -> tuple[int, dict]:
    """K4's rings (cost and checkpoints) and K3's ring against their plain
    versions and the old kernels.  Grid (K4 == plain bit for bit on costs,
    every checkpoint row and top value): 44 pairs of up to 200 bp beside b
    of up to 500 bp (pairs far shorter than n_max, so checkpoints lie past
    their end; n == 0; row m covered, above and below the window), random
    per-pair schedules at Q 1 and 8 shifting at column 0 on every third
    lane and at every quantum column on every fifth (the window slides past
    the last word, the entering word clamped at S - 1), the pairs' gcsh
    schedules, SW 1, 4, 16 and full height, CB = max(SW, 24), at the
    runner's layout and rings forced to 64 lanes; an interval below SW runs
    the old K4; K1's, K3's and K2's rings, ring K8, K7 and the wide ring on
    a shared schedule shifted at column 0.  Then in turns on phase 7's whole 40 kbp rounds (old, tables,
    kernel, both, both, kernel, tables, old: the old K4, K4's tables and
    codes alone, its kernel alone on them, the wrapper's call), and K3 on
    phase 25's whole pack and its 1024-column cut (the old K3 and K3's
    ring, each alone and with the trace route's transpose to pair-major,
    forward then backward).  Returns the
    max abs difference and the fields phase 33 adds to the records."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(33)
    pairs, grid = _k4_grid_pack(rng)
    n_max, S, B = grid[0].shape[0], grid[2].shape[0], grid[0].shape[1]
    gc, sw_g, q_g = _gcsh_schedules(pairs, B, n_max, 1.25)
    cases = []
    for q in (1, 8):
        for sw in K33_GRID_SW + (S,):
            sched = _random_schedule(rng, n_max, B, q)
            sched[0, ::3] = 1
            cases.append((f"random Q={q}", sched, sw, q))
    cases.append(("gcsh 1.25 h0", gc, min(sw_g, S), q_g))
    before = dict(banded_kernel.LAUNCHES)
    worst, labels, runs, past_end = 0, [], 0, 0
    n_h, m_h = np.asarray(grid[4], np.int64), np.asarray(grid[5], np.int64)
    kinds = set()
    for label, sched, sw, q in cases:
        cb = -(-max(min(sw, S), 24) // q) * q  # CB >= SW after Q rounding
        want = banded.banded_ck_pp_ref(*grid, sched, sw, cb, q)
        for lanes in (None, 64):
            got = (banded_kernel._launch_banded_ring_pp(*grid, sched, sw, q, lanes=lanes),
                   banded_kernel._launch_banded_ring_pp(*grid, sched, sw, q, cb, lanes=lanes))
            err = max(_max_err(got[0], want[0]), _max_err(got[1], want))
            if err:
                fail(f"K4's ring != plain on {label} SW={sw} CB={cb} lanes {lanes}")
            worst, runs = max(worst, err), runs + 1
        CB = banded.ck_col_block(cb, n_max, q)
        past_end += int(((np.arange(-(-n_max // CB))[:, None] * CB) > n_h[None, :]).sum())
        lo_end = np.cumsum(sched, 0)[np.clip(n_h - 1, 0, n_max - 1), np.arange(B)]
        rows = m_h - lo_end * 32
        kinds |= {"n == 0" if n == 0 else "above" if r < 0 else "below" if r > min(sw, S) * 32
                  else "covered" for n, r in zip(n_h, rows)}
        labels.append(f"{label} SW={min(sw, S)} CB={CB}")
    if kinds != {"n == 0", "above", "below", "covered"}:
        fail(f"phase 33's grid holds only {sorted(kinds)}")
    ran = {k: banded_kernel.LAUNCHES[k] - before[k] for k in
           ("banded_ring_pp", "banded_ring_ck_pp", "banded_cost_pp", "banded_ck_pp")}
    if ran != {"banded_ring_pp": runs, "banded_ring_ck_pp": runs, "banded_cost_pp": 0,
               "banded_ck_pp": 0}:
        fail(f"phase 33's grid launched {ran}")
    # An interval below SW with several checkpoints: the old K4, by the
    # host's test.
    flat = np.zeros((n_max, B), np.uint8)
    if banded_kernel.k4_kernel(n_max, 8, 4, 4) != "banded_ck_pp":
        fail("k4_kernel sends CB = 4 < SW = 8 to the ring")
    err = _max_err(banded_kernel.banded_ck_pp(*grid, flat, 8, 4, 4),
                   banded.banded_ck_pp_ref(*grid, flat, 8, 4, 4))
    if err or banded_kernel.LAUNCHES["banded_ck_pp"] != before["banded_ck_pp"] + 1:
        fail("CB < SW did not run the old K4 to the plain result")
    # K1's, K3's and K2's rings, ring K8 and the cost rings (K7, the wide
    # ring, and striped_cost through them) on a shared schedule shifted at
    # column 0.
    col0 = (1, (8 * 32 // 2 + 32) * 2)
    if banded.shift_at_array(n_max, S, 8, col0)[:2].tolist() != [1, 0]:
        fail("phase 33: the column-0 diagonal does not shift at column 0 only")
    seen = dict(banded_kernel.LAUNCHES)
    cost_ref = striped.pinned_cost_ref(*grid, 8, col0)
    col0_err = {
        "K1": _max_err(banded_kernel.banded_cost(*grid, 8, col0),
                       banded.banded_cost_ref(*grid, 8, col0)),
        "K3": _max_err(banded_kernel.banded_fill(*grid, 8, col0),
                       banded.banded_fill_ref(*grid, 8, col0)),
        "K2": _max_err(banded_kernel.banded_ck(*grid, 8, 24, col0),
                       banded.banded_ck_ref(*grid, 8, 24, col0)),
        "K8": _max_err(banded_kernel.pinned_ck(*grid, 8, 24, col0),
                       striped.pinned_ck_ref(*grid, 8, 24, col0)),
        "K7": _max_err(banded_kernel.pinned_cost(*grid, 8, col0), cost_ref),
        "wide": _max_err(banded_kernel.pinned_cost(*grid, 8, col0, None, 16), cost_ref),
        "striped_cost": _max_err(banded_kernel.striped_cost(*grid, 8, col0), cost_ref)}
    if any(col0_err.values()):
        fail(f"a ring != plain on a schedule shifted at column 0: {col0_err}")
    ran = {k: banded_kernel.LAUNCHES[k] - seen[k] for k in
           ("banded_ring", "banded_ring_fill", "banded_ring_ck", "ring_ck_exact", "pinned_cost",
            "ring_cost_wide")}
    if ran != {"banded_ring": 1, "banded_ring_fill": 1, "banded_ring_ck": 1, "ring_ck_exact": 1,
               "pinned_cost": 2, "ring_cost_wide": 1}:
        fail(f"phase 33's column-0 cases launched {ran}")
    say(f"[33 K4 rings=plain] {len(cases)} schedules x cost and ck x 2 layouts (B {B}, n_max "
        f"{n_max}, S {S}: {'; '.join(labels)}), pairs {sorted(kinds)}, {past_end} checkpoints "
        f"past a pair's end; costs, every checkpoint row and top value equal, max_abs_err "
        f"{worst}; CB < SW on the old K4 == plain; K1's, K3's and K2's rings, ring K8, K7, the "
        f"wide ring and striped_cost == plain on a shift at column 0 ({ran}); "
        f"{time.perf_counter() - t0:.1f} s")

    recs = {k: {} for k in ("banded_ring_pp", "banded_ring_ck_pp", "banded_cost_pp",
                            "banded_ck_pp", "banded_ring_fill", "banded_fill")}
    for ck in (False, True):
        key = "banded_ring_ck_pp" if ck else "banded_ring_pp"
        args = rspy.last[key]
        pl, sched, sw = args[:6], args[6], args[7]
        cb, q = (args[8] if ck else None), args[-1]
        sw_ = min(sw, pl[2].shape[0])

        def tables():
            return banded_kernel.banded_ring_pp_tables(pl[0], pl[1], pl[4], sched, sw_, q, cb)

        tab = tables()
        wrapper = banded_kernel.banded_ck_pp if ck else banded_kernel.banded_cost_pp
        fns = {"old": lambda: _old_k4(pl, sched, sw, q, cb), "tables": tables,
               "kernel": lambda: banded_kernel._launch_banded_ring_pp(*pl, sched, sw, q, cb,
                                                                      tables=tab),
               "both": lambda: wrapper(*pl, sched, sw, *((cb,) if ck else ()), q)}
        times, outs = _in_turns(fns, ("old", "tables", "kernel", "both", "both", "kernel",
                                      "tables", "old"))
        err = max(_max_err(outs["kernel"], outs["old"]), _max_err(outs["both"], outs["old"]))
        if err:
            fail(f"K4's ring != the old K4 on phase 7's 40 kbp {'ck' if ck else 'cost'} round")
        bnd = plane_bound(pl, sw_, outs["old"] if ck else [outs["old"]], sched.size)
        shape = {"B": pl[0].shape[1], "n_max": pl[0].shape[0], "S": pl[2].shape[0], "SW": sw_,
                 "Q": q, "lanes": tab["lay"]["lanes"], "pairs a warp": tab["lay"]["pairs"]}
        if ck:
            shape["CB"] = tab["CB"]
        k, o = min(times["kernel"]), min(times["old"])
        say(f"[33 K4 {'ck' if ck else 'cost'} round] phase 7's 40 kbp round {shape}, turns old, "
            f"tables, kernel, both, both, kernel, tables, old: K4's ring kernel "
            f"{times['kernel'][0]:.3f}/{times['kernel'][1]:.3f} ms ({k / bnd['bound_ms']:.1f}x), "
            f"its tables and codes {times['tables'][0]:.3f}/{times['tables'][1]:.3f} ms, both "
            f"(the wrapper's call) {times['both'][0]:.3f}/{times['both'][1]:.3f} ms; the old K4 "
            f"{times['old'][0]:.3f}/{times['old'][1]:.3f} ms ({o / bnd['bound_ms']:.1f}x) vs "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); old/kernel {o / k:.1f}; equal "
            f"on all lanes{', every checkpoint row and top value' if ck else ''} (CUDA events)")
        old_key = "banded_ck_pp" if ck else "banded_cost_pp"
        recs[key].update(round_kernel_ms=times["kernel"], round_tables_ms=times["tables"],
                         round_call_ms=times["both"], round_old_ms=times["old"],
                         round_bound_ms=bnd["bound_ms"], round_shape=shape)
        recs[old_key].update(round_ms=times["old"], round_bound_ms=bnd["bound_ms"],
                             round_shape=shape)

    *planes, sw, diag = fspy.last
    for label, pl, dg in (("whole", planes, diag),
                          ("cut", _cut(planes, CUT_COLS), _cut_diag(_cut(planes, CUT_COLS)))):
        def t(fn):  # the trace route's transpose of the planes to pair-major
            def call():
                out = fn()
                return (out[0],) + tuple(x.permute(2, 0, 1).contiguous() for x in out[1:])
            return call

        old = lambda: banded_kernel._launch("banded_fill", *pl, sw, diag=dg, fill=True)  # noqa: E731
        ring = lambda: banded_kernel.banded_fill(*pl, sw, dg)  # noqa: E731
        fns = {"old": old, "old+T": t(old), "ring": ring, "ring+T": t(ring)}
        order = ("old", "old+T", "ring", "ring+T")
        times, outs = _in_turns(fns, order + order[::-1])
        err = max(_max_err(outs["ring+T"], outs["old+T"]), _max_err(outs["ring"], outs["old"]))
        if err:
            fail(f"K3's ring != the old K3 on phase 25's {label} pack")
        bnd = plane_bound(pl, sw, outs["old"])
        del outs
        shape = {"B": pl[0].shape[1], "n_max": pl[0].shape[0], "S": pl[2].shape[0], "SW": sw}
        say(f"[33 K3 {label}] phase 25's {label} pack {shape}, turns forward then backward "
            f"(+T: with the trace route's transpose to pair-major): " + ", ".join(
                f"{k} {v[0]:.3f}/{v[1]:.3f} ms" for k, v in times.items())
            + f" (ring: K3's ring, storing pair-major; old: the old K3) vs bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); old+T/ring+T "
            f"{min(times['old+T']) / min(times['ring+T']):.2f}; all equal (CUDA events)")
        recs["banded_ring_fill"][f"{label}_turns_ms"] = times
        recs["banded_ring_fill"][f"{label}_bound_ms"] = bnd["bound_ms"]
        recs["banded_ring_fill"][f"{label}_shape"] = shape
        if label == "whole":
            recs["banded_fill"].update(ms=float(np.mean(times["old"])), **bnd, shape=shape,
                                       with_transpose_ms=times["old+T"])
        else:
            recs["banded_fill"].update(cut_ms=float(np.mean(times["old"])),
                                       cut_bound_ms=bnd["bound_ms"], cut_shape=shape)
    return worst, recs


ROOT = Path(__file__).resolve().parent
MESH2 = ("cuda:0", "cuda:0")  # phase 34: a batch in two shards on the one card
MH_BATCH = 32  # phase 35: MultiHostRunner's batch size
TOOL_TIMEOUT = 180  # seconds, each subprocess of phases 35-37
CLI_N, CLI_E, CLI_CNT, CLI_CHUNK = 10_000, 0.05, 64, 32  # phase 36's batch run
CLI_BLOCK_N, CLI_BLOCK_CNT = 2000, 3  # phase 36's single-pair aligners
FUZZ_MODES = ("batch", "batch-ck", "batch-domain", "batch-bigband")
FUZZ_ITERS, FUZZ_MAX_N, FUZZ_SEED = 50, 400, 20260


def _launched(fn):
    """``(fn(), the LAUNCHES it added)``, the counts set to 0 just before."""
    banded_kernel.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in banded_kernel.LAUNCHES.items() if v}


def _twice(counts: dict, want: dict, label: str) -> None:
    """A 2-shard run launches each kernel twice as often as one device."""
    if counts != {k: 2 * v for k, v in want.items()}:
        fail(f"{label}: the 2-shard run launched {counts}, one device {want}")


def _same_results(got, want, label: str) -> None:
    if [(c, g.to_string()) for c, g in got] != [(c, g.to_string()) for c, g in want]:
        fail(f"{label}: the 2-shard results differ from one device's")


def phase34_mesh(pairs, costs3, batches, results4, p8, smi: str) -> dict:
    """The main path split over ``mesh=MESH2``: phase 3's cost (each
    aligner's second call timed), phase 4's align_iter, phase 8's
    checkpoint rungs, a one-device mesh and the dry run; returns the
    launches of the 2-shard runs."""
    one, two = BatchAligner(device="cuda"), BatchAligner(mesh=MESH2)
    walls, runs = {}, {}
    for label, ba in (("one device", one), ("two shards", two)):
        ba.cost_with_stats(pairs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label] = _launched(lambda: ba.cost_with_stats(pairs))
        walls[label] = time.perf_counter() - t0
    (c1, st1), n1 = runs["one device"]
    (c2, st2), n2 = runs["two shards"]
    if list(c2) != list(c1) or list(c2) != list(costs3) or st2 != st1:
        fail(f"2-shard cost: costs equal one device's {list(c2) == list(c1)}, phase 3's "
             f"{list(c2) == list(costs3)}; stats {st2} against {st1}")
    _twice(n2, n1, "cost")
    total = dict(n2)
    bp = sum(len(a) for a, _ in pairs)
    say(f"[34 cost] {len(pairs)} x {LENGTH} bp on mesh={MESH2}, 2nd call: "
        f"{walls['two shards']:.4f} s = {bp / walls['two shards'] / 1e9:.4f} Gbp/s; one device "
        f"{walls['one device']:.4f} s = {bp / walls['one device'] / 1e9:.4f} Gbp/s; costs == "
        f"phase 3's, stats equal ({st2}); launches {n2} (one device {n1}); {smi}")

    got2, n2 = _launched(lambda: list(two.align_iter(iter(batches))))
    got1, n1 = _launched(lambda: list(one.align_iter(iter(batches))))
    if len(got2) != len(batches):
        fail("2-shard align_iter lost a batch")
    verified = 0
    for k, (bpairs, (r2, s2), (r1, s1), (r4, _)) in enumerate(zip(batches, got2, got1,
                                                                    results4)):
        _same_results(r2, r1, f"align_iter batch {k}")
        if s2 != s1:
            fail(f"align_iter batch {k}: stats {s2} against {s1}")
        verified += _verify_all(bpairs, r2, [c for c, _ in r4], f"2-shard align_iter batch {k}")
    _twice(n2, n1, "align_iter")
    for k, v in n2.items():
        total[k] = total.get(k, 0) + v
    say(f"[34 align] align_iter {len(batches)} x {STREAM_PAIRS} pairs on two shards: costs "
        f"== phase 4's, CIGARs and stats == one device's, {verified} CIGARs verified; "
        f"launches {n2} (one device {n1})")

    pairs8, costs8 = p8
    ck2 = BatchAligner(mesh=MESH2, direct_dt=False)
    (r2, s2), n2 = _launched(lambda: ck2.align_with_stats(pairs8))
    (r1, s1), n1 = _launched(lambda: BatchAligner(device="cuda",
                                                  direct_dt=False).align_with_stats(pairs8))
    _same_results(r2, r1, "checkpoint rungs")
    if s2 != s1 or s2.direct_traces or s2.kernel != "cuda-banded-ring-ck":
        fail(f"2-shard checkpoint rungs: stats {s2} against {s1}")
    _twice(n2, n1, "checkpoint rungs")
    verified = _verify_all(pairs8, r2, costs8, "2-shard checkpoint rungs")
    for k, v in n2.items():
        total[k] = total.get(k, 0) + v
    say(f"[34 ck] phase 8's {len(pairs8)} pairs, direct_dt=False, on two shards: costs == "
        f"phase 8's, {verified} CIGARs verified, == one device's; retries {s2.band_retries}, "
        f"kernel {s2.kernel}; launches {n2} (one device {n1})")

    # A bucket whose first pair alone fits K7's ring and whose second needs
    # the wide ring: both shards run the wide ring the label names.
    wide = [(att.generate.uniform_seeded(n, 0.0, s)[0],
             att.generate.uniform_seeded(m, 0.1, s + 1)[0])
            for n, m, s in ((4000, 120_000, 1), (4500, 140_000, 3))]
    kw = dict(band_words=8, lane_multiple=1, max_band_doublings=0, domain_mode="off")
    (cw2, sw2), n2 = _launched(lambda: BatchAligner(mesh=MESH2, **kw).cost_with_stats(wide))
    (cw1, sw1), n1 = _launched(lambda: BatchAligner(device="cuda", **kw).cost_with_stats(wide))
    want = [att.oracle.levenshtein_myers(a, b) for a, b in wide]
    if (list(cw2) != list(cw1) or list(cw2) != want or sw2 != sw1
            or n2 != {"ring_cost_wide": 2} or sw2.kernel != "cuda-ring-wide"):
        fail(f"2-shard wide ring: costs {list(cw2)} / {list(cw1)} / oracle {want}, "
             f"stats {sw2} / {sw1}, launches {n2} / {n1}")
    for k, v in n2.items():
        total[k] = total.get(k, 0) + v
    say(f"[34 wide] a bucket straddling K7's 4096-word ring on two shards: both run the "
        f"wide ring ({n2}; one device {n1}), costs == one device's and the oracle")

    solo = BatchAligner(mesh=("cuda:0",))
    (cs, ss), ns = _launched(lambda: solo.cost_with_stats(pairs8))
    (cw, sw_), nw_ = _launched(lambda: BatchAligner(device="cuda").cost_with_stats(pairs8))
    if list(cs) != list(cw) or ss != sw_ or ns != nw_:
        fail(f"mesh=('cuda:0',) differs from mesh=None: {ss} / {sw_}, {ns} / {nw_}")
    for k, v in ns.items():
        total[k] = total.get(k, 0) + v
    from astarpa_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(2, devices=list(MESH2))
    say(f"[34 solo+dryrun] mesh=('cuda:0',) == mesh=None on phase 8's pairs (costs, stats, "
        f"launches {ns}); dryrun_multichip(2, devices={list(MESH2)}) passed in "
        f"{time.perf_counter() - t0:.1f} s")
    return total


_MH_WORKER = """
import json, sys, torch
from astarpa_tpu_torch.ops import banded_kernel
from astarpa_tpu_torch.pairs_io import read_pairs
from astarpa_tpu_torch.parallel.multihost import MultiHostRunner, init_distributed
from astarpa_tpu_torch.parallel.runner import BatchAligner
port, rank, seq, out, band, batch = sys.argv[1:7]
rank, size = init_distributed(f"127.0.0.1:{port}", 2, int(rank))
pairs = list(read_pairs(seq))
runner = MultiHostRunner(BatchAligner(device="cuda", band_words=int(band), domain_mode="off"),
                         batch_size=int(batch))
res = runner.run(pairs, out, with_cigars=True)
torch.cuda.synchronize()
print(json.dumps({"rank": rank, "size": size, "local_pairs": res.local_pairs,
                  "global_pairs": res.global_pairs, "local_bp": res.local_bp,
                  "global_bp": res.global_bp, "seconds": res.seconds,
                  "kernel": res.stats.kernel,
                  "launches": {k: v for k, v in banded_kernel.LAUNCHES.items() if v}}))
"""


def _subprocesses(cmds: dict, timeout: float = TOOL_TIMEOUT) -> dict:
    """Run each command (a list of arguments after ``python``) at once from
    the repository's root; returns {name: (rc, stdout, stderr)}.  A command
    past its ``timeout`` fails the run; every process is stopped before
    this returns."""
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT))
    procs = {name: subprocess.Popen([sys.executable, *cmd], cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for name, cmd in cmds.items()}
    out, late = {}, []
    deadline = time.perf_counter() + timeout
    try:
        for name, proc in procs.items():
            try:
                so, se = proc.communicate(timeout=max(1.0, deadline - time.perf_counter()))
                out[name] = (proc.returncode, so, se)
            except subprocess.TimeoutExpired:
                late.append(name)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if late:
        fail(f"{late} ran past {timeout} s")
    return out


def _verify_lines(pairs, lines, costs, label: str) -> int:
    """``{cost},{cigar}`` lines: each cost equal to ``costs``, each CIGAR
    verified at its cost on the run's processes; returns the count."""
    if len(lines) != len(pairs):
        fail(f"{label}: {len(lines)} lines for {len(pairs)} pairs")
    jobs = []
    for (a, b), line, want in zip(pairs, lines, costs):
        cost, cig = line.split(",", 1)
        if int(cost) != int(want):
            fail(f"{label}: cost {cost} != {want}")
        jobs.append((a, b, cig, int(cost)))
    ok = _pool(_verify_job, jobs)
    if not all(ok):
        fail(f"{label}: {len(ok) - sum(ok)} CIGARs do not verify at their cost")
    return len(ok)


def _last_json(name: str, result) -> dict:
    rc, so, se = result
    if rc != 0:
        fail(f"{name} exited {rc}: {se.strip()[-1500:]}")
    return json.loads(so.strip().splitlines()[-1])


def phase35_multihost(p7, costs7) -> dict:
    """Config #5's seed-7 batch through two processes on the card, each
    rank of one gloo group streaming its stripe through
    ``MultiHostRunner`` with CIGARs; returns the workers' launches."""
    from astarpa_tpu_torch.pairs_io import write_pairs_seq
    from astarpa_tpu_torch.parallel.multihost import host_stripe

    work = ROOT / "build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    seq = work / "config5_seed7.seq"
    write_pairs_seq(str(seq), p7)
    with __import__("socket").socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    res = _subprocesses({r: ["-c", _MH_WORKER, str(port), str(r), str(seq),
                             str(work / f"shard{r}.csv"), str(C5_BAND), str(MH_BATCH)]
                         for r in range(2)})
    wall = time.perf_counter() - t0
    reps = [_last_json(f"multi-host rank {r}", res[r]) for r in range(2)]
    bp = sum(len(a) for a, _ in p7)
    lines, total = [None] * len(p7), {}
    for rep in reps:
        if rep["size"] != 2 or rep["global_pairs"] != len(p7) or rep["global_bp"] != bp:
            fail(f"multi-host rank {rep['rank']}: {rep}")
        shard = (work / f"shard{rep['rank']}.csv").read_text().splitlines()
        stripe = host_stripe(len(p7), rep["rank"], 2)
        if len(shard) != len(stripe):
            fail(f"multi-host rank {rep['rank']} wrote {len(shard)} lines for {len(stripe)}")
        for i, line in zip(stripe, shard):
            lines[int(i)] = line
        for k, v in rep["launches"].items():
            total[k] = total.get(k, 0) + v
    verified = _verify_lines(p7, lines, costs7, "multi-host shards")
    rates = ", ".join(f"rank {r['rank']} {r['local_pairs']} pairs {r['local_bp'] / r['seconds'] / 1e6:.3f} "
                      f"Mbp/s ({r['seconds']:.2f} s, kernel {r['kernel']}, launches "
                      f"{r['launches']})" for r in reps)
    say(f"[35 multihost] {len(p7)} x {C5_LENGTH} bp e={C5_ERR} (phase 11's seed 7) in two "
        f"processes on the card, gloo on 127.0.0.1, MultiHostRunner(BatchAligner("
        f"band_words={C5_BAND}, domain_mode='off'), batch_size={MH_BATCH}): {rates}; the "
        f"shards' union == phase 11's costs, {verified} CIGARs verified, global_pairs "
        f"{len(p7)} and global_bp {bp} on both; {wall:.1f} s with start-up")
    seq.unlink()
    return total


def phase36_37_tools() -> None:
    """The CLI and the fuzzer on the card, all their processes at once."""
    cli = ["-m", "astarpa_tpu_torch.cli"]
    cmds = {"batch": cli + ["-n", str(CLI_N), "-e", str(CLI_E), "--cnt", str(CLI_CNT),
                            "--aligner", "batch", "--chunk", str(CLI_CHUNK)],
            **{name: cli + ["-n", str(CLI_BLOCK_N), "--cnt", str(CLI_BLOCK_CNT), "--aligner",
                            name] for name in ("astarpa2-full", "astarpa-native")},
            **{f"fuzz {m}": ["-m", "astarpa_tpu_torch.fuzz", "--aligner", m, "--iters",
                             str(FUZZ_ITERS), "--max-n", str(FUZZ_MAX_N), "--seed",
                             str(FUZZ_SEED)] for m in FUZZ_MODES},
            "figures": ["-m", "astarpa_tpu_torch.figures", "--small", "--out", str(FIGURES_OUT)]}
    if FIGURES_OUT.exists():
        shutil.rmtree(FIGURES_OUT)
    t0 = time.perf_counter()
    res = _subprocesses(cmds)
    wall = time.perf_counter() - t0
    rows = []
    for name, (cnt, n) in (("batch", (CLI_CNT, CLI_N)), ("astarpa2-full", (CLI_BLOCK_CNT, CLI_BLOCK_N)),
                           ("astarpa-native", (CLI_BLOCK_CNT, CLI_BLOCK_N))):
        rc, so, se = res[name]
        if rc != 0:
            fail(f"the CLI with --aligner {name} exited {rc}: {se.strip()[-1500:]}")
        pairs = _generate(cnt, n, CLI_E, 31415)  # the CLI's default seed
        want = [att.oracle.levenshtein_myers(a, b) for a, b in pairs]
        rows.append(f"{name} {_verify_lines(pairs, so.strip().splitlines(), want, name)} lines")
    say(f"[36 cli] python -m astarpa_tpu_torch.cli on the card: {', '.join(rows)} verified "
        f"(costs == levenshtein_myers, CIGARs at their cost); batch with -n {CLI_N} -e {CLI_E} "
        f"--cnt {CLI_CNT} --chunk {CLI_CHUNK}")
    rows = []
    for m in FUZZ_MODES:
        rc, so, se = res[f"fuzz {m}"]
        if rc != 0 or "no failures" not in so:
            fail(f"the fuzzer's {m} mode exited {rc}: {(so + se).strip()[-1500:]}")
        launches = next(l for l in so.splitlines() if l.startswith("launches: "))
        rows.append(f"{m} {launches[len('launches: '):]}")
    say(f"[37 fuzz] python -m astarpa_tpu_torch.fuzz on the card, {FUZZ_ITERS} iterations "
        f"each at --max-n {FUZZ_MAX_N}, seed {FUZZ_SEED}: no failures; launches by mode: "
        f"{'; '.join(rows)}; phases 36-37 took {wall:.1f} s with start-up, at once")
    _check_figures(res["figures"])


def _check_figures(result) -> None:
    """``python -m astarpa_tpu_torch.figures --small`` exited 0, printed
    every family, and every figure it printed holds a PNG."""
    from astarpa_tpu_torch.figures import FIGURES

    rc, so, se = result
    if rc != 0:
        fail(f"the figure suite exited {rc}: {se.strip()[-1500:]}")
    missing = [f for f in FIGURES if f"[{f}]" not in so.splitlines()]
    dirs = [Path(line.rsplit(" -> ", 1)[1]) for line in so.splitlines() if " -> " in line]
    empty = [str(d) for d in dirs if not list(d.glob("*.png"))]
    if missing or empty or not dirs:
        fail(f"the figure suite left out families {missing}, wrote no PNG in {empty}")
    pngs = sum(len(list(d.glob("*.png"))) for d in dirs)
    pages = sum(len(list(d.glob("*.html"))) for d in dirs)
    say(f"[38 figures] python -m astarpa_tpu_torch.figures --small on the card (in phases "
        f"36-37's batch): {len(FIGURES)} families, {len(dirs)} figures, {pngs} PNG frames, "
        f"{pages} HTML pages")


# Phase 38: the modules ported last, on the card host.
CHECK_MAX_N, CHECK_SAMPLES, CHECK_SEED = 300, 40, 1234  # testing.check_aligner's defaults
SEARCH_TEXT, SEARCH_PAT, SEARCH_ERR, SEARCH_SEED = 10_000, 150, 0.05, 38
SEARCH_UNMATCHED = 1.0  # a pattern character left out costs 1, as an insertion
BASE_N, BASE_ERR, BASE_SEED = 1000, 0.05, 38
LAYOUT_N, LAYOUT_SEED = 96, 38  # 96 x 96: three words of b
FIGURES_OUT = ROOT / "build" / "smoke" / "figures"


class _OnePair:
    """``testing``'s aligner: one ``BatchAligner.align`` call a pair; keeps
    the pairs the harness gave it, in order."""

    def __init__(self, ba: BatchAligner):
        self.ba, self.pairs = ba, []

    def align(self, a, b):
        self.pairs.append((a, b))
        return self.ba.align([(a, b)])[0]


def _check_results(pairs, results, costs, want, label: str) -> None:
    """Costs of ``align`` and ``cost`` equal the oracle's, every CIGAR
    verifies at its cost."""
    got = [c for c, _ in results]
    if got != want or list(costs) != want:
        bad = [k for k, (g, c, w) in enumerate(zip(got, costs, want)) if not g == c == w]
        fail(f"{label}: costs differ from oracle.levenshtein at pairs {bad[:10]} "
             f"({[(pairs[k][0][:20], pairs[k][1][:20]) for k in bad[:3]]})")
    bad = [k for k, ((a, b), (c, cig)) in enumerate(zip(pairs, results)) if cig.verify(a, b) != c]
    if bad:
        fail(f"{label}: CIGARs of pairs {bad[:10]} do not verify at their cost")


def _search_verify(res, idx: int) -> tuple:
    """Walk ``res.trace(idx)`` over the text and the pattern (wildcards
    match as the search's profile says): every match op matches, every
    substitution does not, the ops end at the traced end, and their cost is
    ``res.out[idx]``.  Returns the window ``(i0, i1)`` in the text."""
    from astarpa_tpu_torch.types import CigarOp

    cigar, poss = res.trace(idx)
    (i, j), end = (poss[0].i, poss[0].j), (poss[-1].i, poss[-1].j)
    cost = 0
    for el in cigar.ops:
        for _ in range(el.cnt):
            if el.op in (CigarOp.MATCH, CigarOp.SUB):
                if res._is_match(i, j) != (el.op == CigarOp.MATCH):
                    fail(f"search trace: op {el.op.name} at text {i}, pattern {j}")
                i, j = i + 1, j + 1
            elif el.op == CigarOp.DEL:
                i += 1
            else:
                j += 1
            cost += el.op != CigarOp.MATCH
    if (i, j) != end or j != len(res.pattern) or poss[0].j != 0 or cost != res.out[idx]:
        fail(f"search trace ends at {(i, j)} for {end}, cost {cost} for {res.out[idx]}")
    return poss[0].i, end[0]


def phase38_ported_modules(smi: str) -> dict:
    """The modules ported last, on the card host: ``testing.check_aligner``
    through the card's ``BatchAligner`` (one pair a call, the 50 pairs in
    one ``align`` and one ``cost`` call, and with ``direct_dt=False``), the
    semi-global search on a planted pattern, ``DiagonalTransition`` and
    ``NwAffine`` at unit cost, and the five scalar layouts on CUDA
    tensors; returns the launches of the ``BatchAligner`` calls."""
    from astarpa_tpu_torch import testing
    from astarpa_tpu_torch.affine import AffineCost
    from astarpa_tpu_torch.base import DiagonalTransition, NwAffine
    from astarpa_tpu_torch.ops import bitpack, layouts, words
    from astarpa_tpu_torch.search import search

    t0 = time.perf_counter()
    one = _OnePair(BatchAligner(device="cuda"))

    def harness():
        try:
            testing.check_aligner_up_to(one, max_n=CHECK_MAX_N, samples=CHECK_SAMPLES,
                                        fixed_seed=CHECK_SEED)
        except AssertionError as err:
            fail(f"testing.check_aligner on BatchAligner(device='cuda'), one pair a call, "
                 f"pair {len(one.pairs) - 1}: {err}")

    _, n_one = _launched(harness)
    pairs = one.pairs
    if len(pairs) != len(testing.TRICKY_PAIRS) + CHECK_SAMPLES:
        fail(f"the harness gave {len(pairs)} pairs")
    if not n_one.get("banded_ring"):
        fail(f"the harness's calls launched no K1 ring: {n_one}")
    t1 = time.perf_counter()
    say(f"[38 harness] testing.check_aligner(max_n={CHECK_MAX_N}, samples={CHECK_SAMPLES}, "
        f"fixed_seed={CHECK_SEED}) on BatchAligner(device='cuda'), one pair a call: "
        f"{len(pairs)} pairs ({len(testing.TRICKY_PAIRS)} tricky, empty ones included), costs "
        f"== oracle.levenshtein, CIGARs verified; launches {n_one}; {t1 - t0:.2f} s; {smi}")
    want = [att.oracle.levenshtein(a, b) for a, b in pairs]
    ba = BatchAligner(device="cuda")
    (res, costs), n_all = _launched(lambda: (ba.align(pairs), ba.cost(pairs)))
    _check_results(pairs, res, costs, want, "the harness's pairs in one call")
    ck = BatchAligner(device="cuda", direct_dt=False)
    ((res_ck, st_ck), costs_ck), n_ck = _launched(lambda: (ck.align_with_stats(pairs),
                                                           ck.cost(pairs)))
    _check_results(pairs, res_ck, costs_ck, want, "the harness's pairs, direct_dt=False")
    t2 = time.perf_counter()
    say(f"[38 batch] the same {len(pairs)} pairs as one align and one cost call: costs == "
        f"oracle.levenshtein, CIGARs verified, launches {n_all}; with direct_dt=False "
        f"(kernel {st_ck.kernel}, direct traces {st_ck.direct_traces}): the same, launches "
        f"{n_ck}; {t2 - t1:.2f} s; {smi}")

    text = att.generate.uniform_seeded(SEARCH_TEXT, 0.0, SEARCH_SEED)[0]
    rng = np.random.default_rng(SEARCH_SEED)
    at = int(rng.integers(0, len(text) - SEARCH_PAT))
    pattern = bytearray(text[at:at + SEARCH_PAT])
    edits = round(SEARCH_PAT * SEARCH_ERR)
    for k in sorted(rng.choice(SEARCH_PAT, edits, replace=False).tolist(), reverse=True):
        c = b"ACGT"[(b"ACGT".index(pattern[k]) + 1 + int(rng.integers(3))) % 4]
        op = int(rng.integers(3))
        if op == 0:
            pattern[k] = c
        elif op == 1:
            pattern.insert(k, c)
        else:
            del pattern[k]
    pattern[int(rng.integers(0, len(pattern)))] = ord("N")
    res = search(bytes(pattern), text, SEARCH_UNMATCHED)
    best = int(np.argmin(res.out[: len(text) + 1]))
    if res.out[best] > edits:
        fail(f"search: best cost {res.out[best]} above the {edits} planted edits")
    i0, i1 = _search_verify(res, best)
    if abs(i1 - (at + SEARCH_PAT)) > edits:
        fail(f"search: best match ends at {i1}, planted at {at + SEARCH_PAT}")
    t3 = time.perf_counter()
    say(f"[38 search] a {len(pattern)} bp pattern (one N, {edits} planted edits) cut at {at} "
        f"from a {SEARCH_TEXT} bp text, unmatched_cost {SEARCH_UNMATCHED}: best cost {res.out[best]} <= {edits}, match "
        f"[{i0}, {i1}), trace verified; {t3 - t2:.2f} s")

    a, b = att.generate.uniform_seeded(BASE_N, BASE_ERR, BASE_SEED)
    want = att.oracle.levenshtein_myers(a, b)
    unit = AffineCost.unit()
    rows = []
    for name, aligner in (("DiagonalTransition", DiagonalTransition()),
                          ("DiagonalTransition(dc=True)", DiagonalTransition(dc=True)),
                          ("NwAffine", NwAffine(unit))):
        s0 = time.perf_counter()
        cost, cig = aligner.align(a, b)
        if cost != want or cig.verify(unit, a, b) != cost:
            fail(f"{name}: cost {cost}, CIGAR {cig.verify(unit, a, b)}, levenshtein_myers {want}")
        rows.append(f"{name} {time.perf_counter() - s0:.3f} s")
    t4 = time.perf_counter()
    say(f"[38 base] a {BASE_N} bp e={BASE_ERR} pair at unit cost: cost {want} == "
        f"levenshtein_myers, affine CIGARs verified: {', '.join(rows)}")

    a, b = (x[:LAYOUT_N] for x in att.generate.uniform_seeded(LAYOUT_N + 24, 0.1, LAYOUT_SEED))
    planes = [words.to_tensor(x, "cuda") for x in
              bitpack.pack_a(att.types.seq_to_codes(a)) + bitpack.pack_b(att.types.seq_to_codes(b))]
    want = att.oracle.levenshtein(a, b)
    states, rows = {}, []
    for name, fn in layouts.LAYOUTS.items():
        s0 = time.perf_counter()
        states[name] = [words.to_numpy_u32(x) for x in fn(*planes)]
        rows.append(f"{name} {time.perf_counter() - s0:.3f} s")
        first = next(iter(states.values()))
        if any(not np.array_equal(x, y) for x, y in zip(states[name], first)):
            fail(f"layout {name} differs from {next(iter(states))}")
        got = layouts.distance(*(torch.from_numpy(x.view(np.int32)) for x in states[name][2:]),
                               LAYOUT_N)
        if got != want:
            fail(f"layout {name}: distance {got}, oracle {want}")
    say(f"[38 layouts] the five orders on cuda int32 tensors of a {LAYOUT_N} x "
        f"{len(planes[2])}-word pair: bit-equal, distance {want} == oracle: {', '.join(rows)}; "
        f"{time.perf_counter() - t4:.2f} s")
    total = {}
    for counts in (n_one, n_all, n_ck):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    say(f"[38] phase 38 took {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


def main() -> None:
    global _POOL
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    with ProcessPoolExecutor(WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        _POOL = pool
        run()


def run() -> None:
    global _LAPS
    start = time.perf_counter()
    lap = _LAPS = Laps()
    smi = phase0_card()
    phase1_build()
    lap("0-1")
    grid_err = phase2_grid()
    lap("2")

    pairs = _generate(PAIRS, LENGTH, ERR, SEED)
    batches = [_generate(STREAM_PAIRS, LENGTH, ERR, SEED + 100 + k)
               for k in range(STREAM_BATCHES)]
    lap("3-4 generate")
    ba = BatchAligner(device="cuda")
    spy = LayerSpy()
    spy.install()
    banded_kernel.reset_launches()
    costs3 = phase3_cost(ba, pairs, spy)
    results4 = phase4_align(ba, batches)
    launches = banded_kernel.LAUNCHES["banded_ring"]
    old_k1_launches = banded_kernel.LAUNCHES["banded_cost"]
    spy.remove()
    if launches == 0 or banded_kernel.LAUNCHES["banded_cost"]:
        fail(f"the main path launched K1's ring kernel {launches} times and the old K1 "
             f"{banded_kernel.LAUNCHES['banded_cost']} times")
    say(f"[main path] K1 launches: banded_ring {launches}, the old banded_cost "
        f"{banded_kernel.LAUNCHES['banded_cost']}")
    lap("3-4")

    record, k1_pack = phase5_time(spy)
    record["max_abs_err"] = max(record["max_abs_err"], grid_err)
    lap("5")
    new_grid_err = phase6_grid()
    lap("6")

    rounds = RoundSpy()
    rounds.install()
    c4, c4_round, c4_batch, c4_ck_round = phase7_config4(rounds)
    lap("7")
    ck, p8 = phase8_ck(rounds)
    rounds.remove()
    counts = {k: c4[k] + ck[k] for k in c4}
    if not ck["banded_ring_ck"] or ck["banded_ck"]:
        fail(f"the main path launched K2's ring {ck['banded_ring_ck']} times and the old K2 "
             f"{ck['banded_ck']} times")
    say(f"[main path] launches: config #4 {c4}; ck align {ck}")
    lap("8")
    records = phase9_time(rounds)
    lap("9")

    striped_err, grid_wide, grid_narrow, grid_diag, k6_cases = phase10_grid()
    lap("10")
    c5, c5_spy, c5_batch = phase11_config5()
    say(f"[main path] launches: config #5 {c5}")
    lap("11")
    c5_records = phase12_time(c5_spy)
    lap("12")
    pp_err, k9_packs, k10_saved = phase13_grid()
    lap("13")
    c5d, c5d_spy = phase14_config5_default(*c5_batch)
    say(f"[main path] launches: config #5 default {c5d}")
    lap("14")
    pp_records = phase15_time(c5d_spy)
    lap("15")

    nw_grid_err = phase16_grid()
    lap("16")
    t0 = time.perf_counter()
    c1_pairs = _generate(C1_PAIRS, C1_LENGTH, C1_ERR, C1_SEED)
    say(f"[17 generate] {C1_PAIRS} x {C1_LENGTH} bp e={C1_ERR} seed {C1_SEED} in "
        f"{time.perf_counter() - t0:.1f} s on {WORKERS} processes")
    c1_launches, c1_full, c1_args = phase17_config1(c1_pairs)
    say(f"[main path] launches: config #1 {{'nw_right_edge': {c1_launches}}}")
    lap("17")
    nw_record = phase18_time(c1_args, c1_full)
    nw_record["max_abs_err"] = max(nw_record["max_abs_err"], nw_grid_err)
    lap("18")

    k8_grid_err = phase19_grid()
    lap("19")
    k8_launches, k8_spy, k7_launches, k7_fh_rung = phase20_full_height(c4_batch)
    lap("20")
    say(f"[main path] launches: full-height cost path {{'pinned_cost': {k7_launches}}}; "
        f"full-height ck path {k8_launches}")
    k8_records = phase21_time(k8_spy)
    for rec in k8_records.values():
        rec["max_abs_err"] = max(rec["max_abs_err"], k8_grid_err)
    lap("21")

    k7_grid_err, _ = phase22_grid(grid_wide, grid_narrow)
    lap("22")
    k7_rung, k5_c5_rung = phase23_time(c5_spy)
    lap("23")

    k3_grid_err = phase24_grid()
    lap("24")
    k3_counts, fill_spy, fill_split = phase25_route(p8, batches)
    say(f"[main path] launches: trace route {{'banded_ring_fill': "
        f"{k3_counts['banded_ring_fill']}, 'banded_fill': {k3_counts['banded_fill']}, "
        f"'banded_fill_pp': {k3_counts['banded_fill_pp']}}}")
    fill_record, fill_pp_record = phase25_time(fill_spy, fill_split)
    for rec in (fill_record, fill_pp_record):
        rec["max_abs_err"] = max(rec["max_abs_err"], k3_grid_err)
    lap("25")
    phase26_host()
    lap("26")
    ring_k6_err, ring_k9_err, refused_band = phase27_grid((grid_wide, grid_narrow, grid_diag), k6_cases,
                                            k9_packs)
    lap("27")
    ring_records = phase28_time(c5_spy, c5d_spy, c4_round)
    lap("28")
    wide_err, wide_record = phase29_grid(grid_wide, grid_narrow, c5_spy)
    lap("29")
    cost_turns = phase30_time(c5_spy, k8_spy)
    lap("30")
    k1_records = phase31_k1(k1_pack)
    lap("31")
    k10_err, k10_records = phase32_ring_k10(k10_saved, refused_band, c4_ck_round, c5d_spy)
    lap("32")
    k4k3_err, k4k3 = phase33_k4_k3(rounds, fill_spy)
    lap("33")
    mesh_launches = phase34_mesh(pairs, costs3, batches, results4, p8, smi)
    say(f"[main path] launches: the 2-shard mesh {mesh_launches}")
    lap("34")
    mh_launches = phase35_multihost(*c5_batch[:2])
    say(f"[main path] launches: the multi-host workers {mh_launches}")
    lap("35")
    phase36_37_tools()
    lap("36-37")
    ported_launches = phase38_ported_modules(smi)
    say(f"[main path] launches: the ported modules' BatchAligner calls {ported_launches}")
    lap("38")
    # The main path's launches of phases 34 and 38 (in this process) and 35
    # (the workers' own counts) join each kernel's count below.
    path_launches = {}
    for extra in (mesh_launches, mh_launches, ported_launches):
        for k, v in extra.items():
            path_launches[k] = path_launches.get(k, 0) + v
    c5_records["ring_ck"].update(ring_records["ring_ck"])
    c5_records["ring_ck"]["max_abs_err"] = max(c5_records["ring_ck"]["max_abs_err"], ring_k6_err)
    pp_records["ring_cost_pp"].update(ring_records["ring_cost_pp"])
    pp_records["ring_cost_pp"]["max_abs_err"] = max(pp_records["ring_cost_pp"]["max_abs_err"],
                                                    ring_k9_err)
    for name, rec in k10_records.items():
        pp_records[name].update(rec)
    pp_records["ring_ck_pp"]["max_abs_err"] = max(pp_records["ring_ck_pp"]["max_abs_err"],
                                                  k10_err)
    c5_records["pinned_cost"].update({**k7_rung, **k7_fh_rung, **cost_turns["pinned_cost"]})
    c5_records["pinned_cost"]["max_abs_err"] = max(c5_records["pinned_cost"]["max_abs_err"],
                                                   k7_grid_err, wide_err)
    c5_records["striped_cost"].update({**k5_c5_rung, **cost_turns["striped_cost"]})
    c5_records["ring_cost_wide"].update({**wide_record, **cost_turns["ring_cost_wide"]})
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "astarpa_tpu"))
    if loaded:
        fail(f"JAX or the JAX package was imported: {loaded[:5]}")
    replaces = {
        "banded_cost": "astarpa_tpu/ops/pallas_banded.py:533",
        "banded_ring": "astarpa_tpu/ops/pallas_banded.py:533",
        "banded_ck": "astarpa_tpu/ops/pallas_banded.py:828",
        "banded_ring_ck": "astarpa_tpu/ops/pallas_banded.py:828",
        "banded_cost_pp": "astarpa_tpu/ops/pallas_banded.py:447",
        "banded_ck_pp": "astarpa_tpu/ops/pallas_banded.py:447",
        "banded_ring_pp": "astarpa_tpu/ops/pallas_banded.py:447",
        "banded_ring_ck_pp": "astarpa_tpu/ops/pallas_banded.py:447",
        "banded_ring_fill": "astarpa_tpu/ops/pallas_banded.py:811",
        "striped_cost": "astarpa_tpu/ops/striped.py:522",
        "striped_ck": "astarpa_tpu/ops/striped.py:576",
        "pinned_cost": "astarpa_tpu/ops/pinned.py:474",
        "pinned_ck": "astarpa_tpu/ops/pinned.py:1157",
        "ring_ck_exact": "astarpa_tpu/ops/pinned.py:1157",
        "pinned_cost_pp": "astarpa_tpu/ops/pinned.py:944",
        "ring_ck": "astarpa_tpu/ops/striped.py:576",
        "ring_cost_pp": "astarpa_tpu/ops/pinned.py:944",
        "ring_cost_wide": "astarpa_tpu/ops/striped.py:522",
        "pinned_ck_pp": "astarpa_tpu/ops/pinned.py:1316",
        "ring_ck_pp": "astarpa_tpu/ops/pinned.py:1316",
        "nw_right_edge": "astarpa_tpu/ops/pallas_myers.py:98",
        "banded_fill": "astarpa_tpu/ops/pallas_banded.py:811",
        "banded_fill_pp": "astarpa_tpu/ops/pallas_banded.py:811",
    }
    banded_src, striped_src = "astarpa_tpu_torch/csrc/banded.cu", "astarpa_tpu_torch/csrc/striped.cu"
    pinned_src = "astarpa_tpu_torch/csrc/pinned.cu"
    ring = ("pinned_cost", "ring_ck", "ring_cost_pp", "ring_cost_wide", "ring_ck_pp")
    # K1's main path (phases 3-4) ran its ring kernel; the old K1 ran no
    # launch there (phase 31 times it beside the ring).
    record.update(k1_records["banded_ring"])
    record["max_abs_err"] = max(record["max_abs_err"], k1_records["banded_ring"]["max_abs_err"])
    kernels = [{"name": "banded_ring", "route": "cuda", "source": pinned_src,
                "replaces": replaces["banded_ring"], "launches": launches, **record},
               {"name": "banded_cost", "route": "cuda", "source": banded_src,
                "replaces": replaces["banded_cost"], "launches": old_k1_launches,
                **k1_records["banded_cost"]}]
    # K4's main path (phase 7's 40 kbp rounds) runs its rings; the old K4
    # ran no launch there (phases 9 and 33 time it beside them).
    for name in ("banded_ck", "banded_ring_ck", "banded_cost_pp", "banded_ck_pp",
                 "banded_ring_pp", "banded_ring_ck_pp"):
        rec = records[name]
        rec.update(k4k3.get(name, {}))
        rec["max_abs_err"] = max(rec["max_abs_err"], new_grid_err,
                                 k4k3_err if name.startswith("banded_ring") else 0)
        src = pinned_src if name.startswith("banded_ring") else banded_src
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces[name], "launches": counts[name], **rec})
    # K7's main path: config #5's cost rungs (phase 11) and phase 20's
    # full-height cost rung; the wide ring's: phase 11's cost past K7's
    # ring.  K5's stripes run no rung of the path (launches 0).
    c5["pinned_cost"] += k7_launches
    for name, rec in c5_records.items():
        if name not in ring:
            rec["max_abs_err"] = max(rec["max_abs_err"], striped_err)
        src = pinned_src if name in ring else striped_src
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces[name], "launches": c5[name], **rec})
    for name, rec in pp_records.items():
        if name not in ring:
            rec["max_abs_err"] = max(rec["max_abs_err"], pp_err)
        # Launches of both main-path runs: config #4 (phase 7, when its
        # rounds reach PINNED_PP_MIN_SW) and config #5 at default settings.
        # The stripe K9 takes rounds past the ring, which neither reaches.
        kernels.append({"name": name, "route": "cuda",
                        "source": pinned_src if name in ring else striped_src,
                        "replaces": replaces[name], "launches": counts[name] + c5d[name],
                        **rec})
    kernels.append({"name": "nw_right_edge", "route": "cuda",
                    "source": "astarpa_tpu_torch/csrc/nw.cu",
                    "replaces": replaces["nw_right_edge"], "launches": c1_launches, **nw_record})
    # K8's main path (phase 20's full-height ck rung) runs ring K8; the
    # stripe K8 ran no launch there (phases 19 and 21 hold and time it).
    for name, src in (("ring_ck_exact", pinned_src), ("pinned_ck", striped_src)):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces[name], "launches": k8_launches[name],
                        **k8_records[name]})
    # K3's main path is the cost-then-trace route's fill (phase 25, one a
    # call), on its ring; the old K3 ran no launch there (phase
    # 33 times it), and the per-pair mode has no caller there (the grid of
    # phase 24 holds it), so their counts from that run are expected to be
    # 0.
    fill_record.update(k4k3["banded_ring_fill"])
    old_fill = {"max_abs_err": 0, "plain_ms": fill_record["plain_ms"], "library_ms": None,
                **k4k3["banded_fill"]}
    for name, rec, src in (("banded_ring_fill", fill_record, pinned_src),
                           ("banded_fill", old_fill, banded_src),
                           ("banded_fill_pp", fill_pp_record, banded_src)):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces[name], "launches": k3_counts[name], **rec})
    for rec in kernels:
        rec["launches"] += path_launches.get(rec["name"], 0)
    say(f"[timing] host seconds by phase: {', '.join(lap.laps)}")
    say(f"[done] all phases passed in {time.perf_counter() - start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
