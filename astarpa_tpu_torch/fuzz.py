"""Fuzzer with input shrinking (re-design of `pa-bin/examples/fuzz.rs:22-60`).

Counterpart of ``scripts/fuzz.py``, on the card by default.  Loops over
sizes, error rates and error models with fresh random seeds, catches cost
mismatches or exceptions from the aligner under test, then shrinks the
failing input (halving from both ends, dropping chars) and prints a
minimal reproducer.  At the end it prints the CUDA kernels each mode
launched (``ops.banded_kernel.LAUNCHES`` deltas; none on the CPU).

Usage:
    python -m astarpa_tpu_torch.fuzz [--aligner MODE] [--iters N] [--max-n N]
        [--seed S] [--device cuda|cpu]

MODE is one of astarpa, native, astarpa2-simple, astarpa2-full, nw, batch,
batch-ck, batch-domain, batch-bigband.
"""

from __future__ import annotations

import argparse
import random
import sys
import traceback
from dataclasses import replace

from . import generate, oracle
from .ops import banded_kernel

MODES = ("astarpa", "native", "astarpa2-simple", "astarpa2-full", "nw", "batch",
         "batch-ck", "batch-domain", "batch-bigband")

#: batch-bigband's routings, one a call in turn: ``(RING_MAX_WORDS,
#: max_band_doublings)``, with ``runner.STRIPED_MIN_SW`` lowered to 8 so
#: that shared rungs from 8 words run the big-band kernels: ring K6 at SW 8
#: (ring K8 where a retry's band is off the 8-grain), the exact full height
#: (ring K8 where S is off the 8-grain, ring K6 on it), and with the ring's
#: capacity (None: as it is) below the band the stripe K6 and the stripe K8.
BIGBAND_ROUTES = ((None, 8), (2, 8), (None, 0), (2, 0))


def check(aligner, a: bytes, b: bytes):
    cost, cigar = aligner(a, b)
    expected = oracle.levenshtein(a, b)
    if cost != expected:
        raise AssertionError(f"cost {cost} != oracle {expected}")
    if cigar is not None and cigar.verify(a, b) != cost:
        raise AssertionError("CIGAR does not verify at its cost")


def shrink(aligner, a: bytes, b: bytes):
    """Greedy shrinking: repeatedly try halving/removal edits that keep the
    failure (`fuzz.rs` shrink loop)."""

    def fails(a, b):
        try:
            check(aligner, a, b)
            return False
        except Exception:
            return True

    changed = True
    while changed:
        changed = False
        for which in (0, 1):
            s = a if which == 0 else b
            # Try removing large chunks first, then single chars.
            step = max(1, len(s) // 2)
            while step >= 1:
                i = 0
                while i < len(s):
                    cand = s[:i] + s[i + step:]
                    na, nb = (cand, b) if which == 0 else (a, cand)
                    if fails(na, nb):
                        a, b = na, nb
                        s = cand
                        changed = True
                    else:
                        i += step
                step //= 2
    return a, b


def build(name: str, device=None):
    """The aligner under test, ``(a, b) -> (cost, cigar)``, on ``device``
    (None: the card)."""
    if name == "astarpa":
        from .astar import astarpa

        return astarpa
    if name == "native":
        from .native import astarpa_native

        return lambda a, b: astarpa_native(a, b, r=2, k=8)
    if name.startswith("batch"):
        return _batch(name, device)
    from .aligners.astarpa2 import AstarPa2Params

    params = {
        "astarpa2-simple": AstarPa2Params.simple,
        "astarpa2-full": AstarPa2Params.full,
        "nw": AstarPa2Params.nw,
    }[name]()
    return replace(params, device=device).make_aligner(True).align


def _batch(name: str, device):
    """The batch runtime's CIGAR path, one pair a call so shrinking stays
    meaningful.  Each mode pins a path:

    - batch: direct whole-pair DT traces (the default path);
    - batch-ck: the checkpoint rungs, staged readback and native
      per-segment traces (``direct_dt=False``);
    - batch-domain: the per-pair gap-domain ladder's checkpoint rounds;
    - batch-bigband: the big-band checkpoint kernels, routed in turns by
      :data:`BIGBAND_ROUTES`."""
    from .parallel import runner
    from .parallel.runner import BatchAligner

    kw = dict(band_words=2, device=device, domain_mode="off")
    if name == "batch-ck":
        kw["direct_dt"] = False
    elif name == "batch-domain":
        kw.update(domain_mode="gap", domain_min_bp=0, direct_dt=False)
    elif name == "batch-bigband":
        kw.update(band_words=8, direct_dt=False)
        turn = [0]

        def bigband_align(a, b):
            ring_max, doublings = BIGBAND_ROUTES[turn[0]]
            turn[0] = (turn[0] + 1) % len(BIGBAND_ROUTES)
            saved = runner.STRIPED_MIN_SW, banded_kernel.RING_MAX_WORDS
            runner.STRIPED_MIN_SW = 8
            if ring_max is not None:
                banded_kernel.RING_MAX_WORDS = ring_max
            try:
                return BatchAligner(**kw, max_band_doublings=doublings).align([(a, b)])[0]
            finally:
                runner.STRIPED_MIN_SW, banded_kernel.RING_MAX_WORDS = saved

        return bigband_align
    elif name != "batch":
        raise ValueError(f"unknown mode {name!r}")
    ba = BatchAligner(**kw)
    return lambda a, b: ba.align([(a, b)])[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="fuzz an aligner against the oracle")
    p.add_argument("--aligner", default="astarpa", choices=MODES)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--max-n", type=int, default=400)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)

    aligner = build(args.aligner, args.device)
    before = dict(banded_kernel.LAUNCHES)
    rng = random.Random(args.seed)
    models = list(generate.ErrorModel)
    for it in range(args.iters):
        n = rng.randrange(1, args.max_n)
        e = rng.choice([0.0, 0.01, 0.05, 0.1, 0.3, 0.5, 1.0])
        model = rng.choice(models)
        seed = rng.randrange(1 << 30)
        a, b = generate.generate_model(n, e, model, seed)
        try:
            check(aligner, a, b)
        except Exception:
            print(f"FAILURE at iter {it}: n={n} e={e} model={model} seed={seed}")
            traceback.print_exc()
            a, b = shrink(aligner, a, b)
            print(f"shrunk reproducer:\n  a = {a!r}\n  b = {b!r}")
            return 1
        if (it + 1) % 50 == 0:
            print(f"{it + 1}/{args.iters} ok")
    launched = {k: v - before[k] for k, v in banded_kernel.LAUNCHES.items() if v > before[k]}
    print(f"launches: {launched}")
    print("no failures")
    return 0


if __name__ == "__main__":
    sys.exit(main())
