"""The control of a cell's check: the reference put in the program's place,
with one guarantee broken.

The configurations state exact edit distances.  The control computes them
over a fixed band of :data:`HALF_BAND` diagonals either side of the pair's
straight diagonals, and skips the certification that the band holds an
optimal alignment: the step a faster aligner would be tempted to take.

A control run is a run of the cell (:func:`.harness.run_cell`) in which the
control's costs replace the program's in every batch the timed stream
yields; the run's own check decides ``correct``.  On the align path each
yielded CIGAR stays the program's: it fails the CIGAR check just where the
control's cost is not the reference's, as a CIGAR at the control's cost
would.  From the root of a checkout:

    python portbench/control.py --workload cfg5-cost --seconds 10 --seeds 11 12 13

prints one JSON line a seed: ``correct``, the numbers compared beside their
limits, and the seconds the control's distances took.  Runs on the card
where there is one.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    import portbench.run  # noqa: F401  (the program's kernel caches inside the checkout)

from portbench import harness, reference, traffic  # noqa: E402

#: Diagonals either side of a pair's straight diagonals in the control's band.
HALF_BAND = 16


def control_stream(entry, distances: dict):
    """``entry`` (``cost_iter`` or ``align_iter``) with its yielded costs
    replaced by ``distances[first a of the batch]``."""

    def stream(self, batches):
        pulled = []

        def feed():
            for pairs in batches:
                pulled.append(pairs)
                yield pairs

        for j, (out, stats) in enumerate(entry(self, feed())):
            costs = distances[pulled[j][0][0]]
            if isinstance(out, np.ndarray):
                out = costs.astype(out.dtype)
            else:
                out = [(int(c), None if r is None else r[1]) for c, r in zip(costs, out)]
            yield out, stats

    return stream


def control_run(root: Path, workload: str, seed: int, seconds: float, device: str,
                half_band: int = HALF_BAND) -> dict:
    """One run of ``workload`` with the control in the program's place."""
    from astarpa_tpu_torch.parallel.runner import BatchAligner

    _, _, config, mix = harness.load_cell(root, workload)
    t = time.perf_counter()
    distances = {pairs[0][0]: reference.control_distances(pairs, half_band, device)
                 for pairs, _ in traffic.make_batches(seed, config)}
    t_ctl = time.perf_counter() - t
    entry = mix["entry"]
    orig = getattr(BatchAligner, entry)
    setattr(BatchAligner, entry, control_stream(orig, distances))
    try:
        res, checks = harness.run_cell(root, workload, seed, seconds, False,
                                       time.perf_counter(), device=device)
    finally:
        setattr(BatchAligner, entry, orig)
    return {"workload": workload, "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "checks": res["checks"], "control_s": t_ctl,
            "half_band": half_band}


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        print(json.dumps(control_run(ROOT, args.workload, seed, args.seconds, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
