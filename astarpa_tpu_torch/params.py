"""Typed, JSON-round-trippable parameter layer.

Re-design of the reference's config system (SURVEY.md §5): serde+clap param
structs — `HeuristicParams` (`pa-heuristic/src/cli.rs:50-98`) and
`AstarPa2Params` (`astarpa2/src/params.rs:10-132`) — and the
`HeuristicMapper` pattern (`cli.rs:160-206`) that turns an untyped enum
config into a typed heuristic factory.  In this framework the equivalent
split is dataclass configs -> factory objects (and, on the device path,
static jit arguments).

The port's copy of ``astarpa_tpu/params.py``; the one change is
:meth:`AlignerParams.build`'s ``device``, where the block aligners' torch
block DP runs (the reference's jnp block kernel runs on JAX's default
backend).  The JSON is the reference's, both ways.
"""

from __future__ import annotations

import enum
import json
from dataclasses import asdict, dataclass, field, fields


class HeuristicType(enum.Enum):
    """`pa-heuristic/src/cli.rs:9-48`."""

    NONE = "none"
    ZERO = "zero"
    GAP = "gap"
    MAX = "max"
    COUNT = "count"
    BICOUNT = "bicount"
    AFFINE_GAP = "affine-gap"
    SH = "sh"
    CSH = "csh"
    GCSH = "gcsh"
    BRUTEFORCE_GCSH = "bruteforce-gcsh"


@dataclass
class HeuristicParams:
    """Untyped heuristic config (`cli.rs:50-98`)."""

    heuristic: HeuristicType = HeuristicType.GCSH
    k: int = 15
    r: int = 2
    p: int = 0  # local pruning look-ahead
    prune: str = "start"  # none | start | end | both
    skip_prune: int | None = None
    max_matches: int | None = None  # variable-k (LengthConfig::Max)

    def build(self):
        """The HeuristicMapper: enum -> typed factory (`cli.rs:160-206`)."""
        from .heuristic import distances as D
        from .heuristic.csh import CSH, GCSH
        from .heuristic.matches import MatchConfig
        from .heuristic.prune import Prune, Pruning
        from .heuristic.sh import SH

        t = self.heuristic
        if t == HeuristicType.NONE:
            return D.NoCost()
        if t == HeuristicType.ZERO:
            return D.ZeroCost()
        if t == HeuristicType.GAP:
            return D.GapCost()
        if t == HeuristicType.MAX:
            return D.MaxCost()
        if t == HeuristicType.COUNT:
            return D.CountCost()
        if t == HeuristicType.BICOUNT:
            return D.BiCountCost()
        if t == HeuristicType.AFFINE_GAP:
            return D.AffineGapCost(self.k)
        mc = MatchConfig(
            k=self.k, r=self.r, local_pruning=self.p, max_matches=self.max_matches
        )
        pruning = Pruning(Prune(self.prune), skip_prune=self.skip_prune)
        if t == HeuristicType.SH:
            return SH(mc, pruning)
        if t == HeuristicType.CSH:
            return CSH(mc, pruning)
        if t == HeuristicType.GCSH:
            return GCSH(mc, pruning)
        if t == HeuristicType.BRUTEFORCE_GCSH:
            from .heuristic.bruteforce import BruteForceGCSH

            return BruteForceGCSH(mc, D.GapCost(), pruning)
        raise ValueError(t)

    def to_json(self) -> str:
        d = asdict(self)
        d["heuristic"] = self.heuristic.value
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "HeuristicParams":
        d = json.loads(s)
        if "heuristic" in d:
            d["heuristic"] = HeuristicType(d["heuristic"])
        known = {f.name for f in fields(HeuristicParams)}
        return HeuristicParams(**{k: v for k, v in d.items() if k in known})


@dataclass
class AlignerParams:
    """Top-level aligner selection + knobs (pa-bin Cli equivalent)."""

    aligner: str = "astarpa2-full"  # astarpa | astarpa-native | astarpa2-* | nw | batch
    dt: bool = True
    heuristic: HeuristicParams = field(default_factory=HeuristicParams)
    # astarpa2 overrides
    block_width: int | None = None
    incremental_doubling: bool | None = None
    # batch runtime
    band_words: int = 8

    def build(self, device=None):
        """Returns an object with ``align(a, b) -> (cost, Cigar)``.
        ``device`` is where the block aligners' torch block DP runs when
        the native one is not used: None = the card, or "cpu"."""
        from .aligners.astarpa2 import AstarPa2Params, Domain

        if self.aligner == "astarpa":
            from .astar import AstarPa

            return AstarPa(dt=self.dt, h=self.heuristic.build())
        if self.aligner == "astarpa-native":
            from .native import astarpa_native

            h = self.heuristic
            # The native runtime implements CSH/GCSH only (use_gap_cost
            # toggles the GCSH transform); reject configs it would silently
            # ignore rather than align with the wrong heuristic.
            if h.heuristic not in (HeuristicType.CSH, HeuristicType.GCSH):
                raise ValueError(
                    f"astarpa-native supports csh/gcsh, not {h.heuristic.value}"
                )
            dt = self.dt
            gap = h.heuristic == HeuristicType.GCSH

            class _Native:
                def align(self, a, b):
                    return astarpa_native(
                        a, b, r=h.r, k=h.k, prune=h.prune, dt=dt,
                        use_gap_cost=gap,
                    )

            return _Native()
        presets = {
            "nw": AstarPa2Params.nw,
            "astarpa2-simple": AstarPa2Params.simple,
            "astarpa2-full": AstarPa2Params.full,
        }
        if self.aligner in presets:
            params = presets[self.aligner]()
            from dataclasses import replace

            overrides = {"device": device}
            if self.block_width is not None:
                overrides["block_width"] = self.block_width
            if self.incremental_doubling is not None:
                overrides["incremental_doubling"] = self.incremental_doubling
            params = replace(params, **overrides)
            return params.make_aligner(True)
        raise ValueError(f"unknown aligner {self.aligner!r}")

    def to_json(self) -> str:
        d = asdict(self)
        d["heuristic"]["heuristic"] = self.heuristic.heuristic.value
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "AlignerParams":
        d = json.loads(s)
        if "heuristic" in d and isinstance(d["heuristic"], dict):
            d["heuristic"] = HeuristicParams.from_json(json.dumps(d["heuristic"]))
        known = {f.name for f in fields(AlignerParams)}
        return AlignerParams(**{k: v for k, v in d.items() if k in known})
