"""Heuristic counters (mirror of the reference's `HeuristicStats`)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class HeuristicStats:
    num_seeds: int = 0
    num_matches: int = 0
    num_filtered_matches: int = 0
    num_pruned: int = 0
    h0: int = 0
    h0_end: int = 0
    h_calls: int = 0
    prune_calls: int = 0
    contours_calls: int = 0
