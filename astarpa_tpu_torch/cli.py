"""Command-line interface (mirror of `pa-bin/src/main.rs:9-37`).

Aligns pairs from a file or a generated dataset and writes
``{cost},{cigar}`` CSV lines.  Counterpart of ``astarpa_tpu/cli.py``: the
same flags, subcommands, aligners and lines, plus ``--device`` (the card by
default, or ``cpu``), where the batch aligner and the block aligners' torch
block DP run.

Examples:
    python -m astarpa_tpu_torch.cli --input pairs.seq
    python -m astarpa_tpu_torch.cli --length 1000 --error-rate 0.05 --cnt 10
    python -m astarpa_tpu_torch.cli -n 10000 -e 0.05 --cnt 64 --aligner batch
    python -m astarpa_tpu_torch.cli -n 500 --aligner astarpa -k 8 -r 1 --stats
    python -m astarpa_tpu_torch.cli -n 300 --cnt 5 --aligner batch --device cpu
    python -m astarpa_tpu_torch.cli convert-txt in.txt out.seq
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import generate
from .params import AlignerParams, HeuristicParams, HeuristicType
from .pairs_io import nanosim_to_seq, read_pairs, txt_to_seq


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="astarpa-torch", description="exact global pairwise aligner on PyTorch and CUDA"
    )
    sub = p.add_subparsers(dest="cmd")

    conv = sub.add_parser("convert-txt", help="alternating-lines .txt -> .seq")
    conv.add_argument("src")
    conv.add_argument("dst")
    ns = sub.add_parser("convert-nanosim", help="NanoSim reads + ref -> .seq")
    ns.add_argument("ref")
    ns.add_argument("reads")
    ns.add_argument("dst")

    p.add_argument("--input", "-i", help=".seq, .txt, or FASTA file with sequence pairs")
    p.add_argument("--output", "-o", help="write a .csv of {cost},{cigar} lines")
    p.add_argument(
        "--aligner",
        default="astarpa2-full",
        choices=[
            "astarpa", "astarpa-native", "astarpa2-simple", "astarpa2-full",
            "nw", "batch",
        ],
    )
    p.add_argument("--no-cigar", action="store_true", help="cost only")
    p.add_argument("--stats", action="store_true", help="print timing/search stats")
    # Heuristic knobs (`pa-heuristic/src/cli.rs:50-98`).
    p.add_argument("--heuristic", default=None, choices=[t.value for t in HeuristicType])
    p.add_argument("-k", type=int, default=None, help="seed length")
    p.add_argument("-r", type=int, default=None, help="max match cost + 1 (1|2)")
    p.add_argument("-p", type=int, default=None, help="local pruning look-ahead")
    p.add_argument("--prune", default=None, choices=["none", "start", "end", "both"])
    p.add_argument("--no-dt", action="store_true", help="A* over Pos states (no DT)")
    p.add_argument("--params-json", help="full AlignerParams as JSON (overrides flags)")
    p.add_argument("--band-words", type=int, default=8, help="batch runtime band")
    p.add_argument(
        "--device", default=None,
        help="where the batch aligner and the block DP run: cuda (the "
        "default) or cpu (the kernels' plain versions)",
    )
    p.add_argument(
        "--chunk", type=int, default=0,
        help="batch aligner: stream pairs in chunks of this size through "
        "the pipelined align_iter (chunk k traces while k+1 runs on "
        "device); 0 = one align() call",
    )
    # Generated input (pa-generate DatasetGenerator equivalent).
    p.add_argument("--length", "-n", type=int, help="length of generated sequences")
    p.add_argument("--error-rate", "-e", type=float, default=0.05)
    p.add_argument("--cnt", type=int, default=1, help="number of generated pairs")
    p.add_argument("--seed", type=int, default=31415)
    p.add_argument(
        "--error-model",
        default="uniform",
        choices=[m.value for m in generate.ErrorModel],
    )
    p.add_argument(
        "--rng", default="numpy", choices=["numpy", "chacha8"],
        help="generator backend; chacha8 = the reference corpora's RNG "
             "family, reproducible from (seed, stream) alone",
    )
    return p


def params_from_args(args) -> AlignerParams:
    if args.params_json:
        return AlignerParams.from_json(args.params_json)
    h = HeuristicParams()
    if args.heuristic is not None:
        h.heuristic = HeuristicType(args.heuristic)
    if args.k is not None:
        h.k = args.k
    if args.r is not None:
        h.r = args.r
    if args.p is not None:
        h.p = args.p
    if args.prune is not None:
        h.prune = args.prune
    return AlignerParams(
        aligner=args.aligner,
        dt=not args.no_dt,
        heuristic=h,
        band_words=args.band_words,
    )


class BatchStatsProxy:
    """Minimal stats stand-in for the batch CIGAR path (align() tracks its
    own doubling internally)."""

    def __init__(self, pairs):
        self.pairs = len(pairs)
        self.buckets = 0
        self.band_retries = 0
        self.aligned_bp = sum(len(a) for a, _ in pairs)


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)

    if args.cmd == "convert-txt":
        n = txt_to_seq(args.src, args.dst)
        print(f"wrote {n} pairs to {args.dst}")
        return 0
    if args.cmd == "convert-nanosim":
        n = nanosim_to_seq(args.ref, args.reads, args.dst)
        print(f"wrote {n} pairs to {args.dst}")
        return 0

    if (args.input is None) == (args.length is None):
        print("error: exactly one of --input or --length is required", file=sys.stderr)
        return 2

    if args.input is not None:
        pairs = list(read_pairs(args.input))
    else:
        pairs = generate.generate_batch(
            args.cnt, args.length, args.error_rate,
            generate.ErrorModel(args.error_model), args.seed, rng=args.rng,
        )

    out = open(args.output, "w") if args.output else sys.stdout
    t0 = time.perf_counter()
    try:
        if args.aligner == "batch":
            from .parallel.runner import BatchAligner

            ba = BatchAligner(band_words=args.band_words, device=args.device)
            if args.no_cigar:
                costs, bstats = ba.cost_with_stats(pairs)
                for c in costs:
                    out.write(f"{c},\n")
            elif args.chunk:
                bstats = BatchStatsProxy(pairs)
                chunks = (
                    pairs[i:i + args.chunk]
                    for i in range(0, len(pairs), args.chunk)
                )
                for res, st in ba.align_iter(chunks):
                    bstats.buckets += st.buckets
                    bstats.band_retries += st.band_retries
                    for cost, cigar in res:
                        out.write(f"{cost},{cigar.to_string()}\n")
            else:
                bstats = BatchStatsProxy(pairs)
                for cost, cigar in ba.align(pairs):
                    out.write(f"{cost},{cigar.to_string()}\n")
            if args.stats:
                dt = time.perf_counter() - t0
                print(
                    json.dumps(
                        {
                            "pairs": bstats.pairs,
                            "buckets": bstats.buckets,
                            "band_retries": bstats.band_retries,
                            "aligned_bp": bstats.aligned_bp,
                            "seconds": round(dt, 4),
                            "bp_per_s": round(bstats.aligned_bp / dt, 1),
                        }
                    ),
                    file=sys.stderr,
                )
            return 0

        aligner = params_from_args(args).build(device=args.device)
        for a, b in pairs:
            cost, cigar = aligner.align(a, b)
            out.write(f"{cost},{cigar.to_string() if cigar is not None else ''}\n")
        if args.stats:
            dt = time.perf_counter() - t0
            total_bp = sum(len(a) for a, _ in pairs)
            print(
                json.dumps(
                    {"pairs": len(pairs), "aligned_bp": total_bp,
                     "seconds": round(dt, 4), "bp_per_s": round(total_bp / dt, 1)}
                ),
                file=sys.stderr,
            )
    finally:
        if args.output:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
