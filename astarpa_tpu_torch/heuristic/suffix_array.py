"""Variable-k seeds via minimal unique matches (FM-index).

Re-design of `pa-heuristic/src/matches/suffix_array.rs:19-54` +
`minimal_unique_matches`: walk ``a`` right-to-left, prepending characters
(and, for r=2, single edits) to a set of FM-index ranges over ``b`` until
the total number of occurrences drops to ``max_matches``; that prefix
becomes a seed and its occurrences become matches.

The FM-index (suffix array + BWT + Occ) is built with NumPy; ``b`` is
terminated with a sentinel that sorts first.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..types import Pos, seq_to_codes
from .matches import Match, Matches
from .seeds import Seed, Seeds


class FmIndex:
    """Suffix array + BWT + Occ over 2-bit codes (sentinel = 4 sorts last...
    we use -1 mapped to 0 with codes shifted +1 so the sentinel sorts first,
    matching the usual '$' convention)."""

    def __init__(self, b: bytes):
        codes = seq_to_codes(b).astype(np.int64) + 1  # 1..4; 0 = sentinel
        text = np.concatenate([codes, [0]])
        self.n = len(text)
        self.sa = self._suffix_array(text)
        self.bwt = text[(self.sa - 1) % self.n]
        # less[c] = #chars < c; occ[i, c] = #occurrences of c in bwt[:i].
        counts = np.bincount(text, minlength=5)
        self.less = np.concatenate([[0], np.cumsum(counts)[:-1]])
        onehot = np.zeros((self.n + 1, 5), dtype=np.int64)
        onehot[np.arange(1, self.n + 1), self.bwt] = 1
        self.occ = np.cumsum(onehot, axis=0)

    @staticmethod
    def _suffix_array(text: np.ndarray) -> np.ndarray:
        """O(n log^2 n) prefix-doubling suffix array."""
        n = len(text)
        rank = text.copy()
        sa = np.argsort(rank, kind="stable")
        k = 1
        tmp = np.zeros(n, dtype=np.int64)
        while k < n:
            key2 = np.where(np.arange(n) + k < n, np.roll(rank, -k), -1)
            order = np.lexsort((key2, rank))
            sa = order
            tmp[sa[0]] = 0
            prev = (rank[sa[:-1]], key2[sa[:-1]])
            cur = (rank[sa[1:]], key2[sa[1:]])
            newr = np.cumsum(
                (cur[0] != prev[0]) | (cur[1] != prev[1])
            )
            tmp[sa[1:]] = newr
            rank = tmp.copy()
            if rank[sa[-1]] == n - 1:
                break
            k *= 2
        return sa

    def full_range(self) -> tuple[int, int]:
        return (0, self.n)

    def prepend(self, rng: tuple[int, int], code: int) -> tuple[int, int]:
        """Extend the match one char to the left (`suffix_array.rs:41-53`)."""
        c = code + 1
        l, r = rng
        nl = self.less[c] + (self.occ[l, c] if l > 0 else 0)
        nr = self.less[c] + self.occ[r, c]
        return (int(nl), int(nr))


def minimal_unique_matches(
    a: bytes, b: bytes, r: int, max_matches: int
) -> Matches:
    """Seeds as minimal unique (<= max_matches occurrences) matches."""
    assert r in (1, 2)
    ca = seq_to_codes(a)
    n, m = len(a), len(b)
    fm = FmIndex(b)

    def init_ranges():
        out = [(fm.full_range(), 0, 0)]
        if r > 1:
            for c in range(4):
                out.append((fm.prepend(fm.full_range(), c), 1, 1))
        return out

    seeds: list[Seed] = []
    match_list: list[Match] = []
    seed_end = n
    ranges = init_ranges()

    for i in range(n - 1, -1, -1):
        new_ranges = []
        for rng, cost, length in ranges:
            match_range = fm.prepend(rng, int(ca[i]))
            if match_range[0] < match_range[1]:
                new_ranges.append((match_range, cost, length + 1))
            if cost + 1 >= r:
                continue
            # delete (skip a[i])
            new_ranges.append((rng, cost + 1, length))
            # substitutions
            for c in range(4):
                if c != int(ca[i]):
                    rr = fm.prepend(rng, c)
                    if rr[0] < rr[1]:
                        new_ranges.append((rr, cost + 1, length + 1))
            # insertion after the match
            if match_range[0] < match_range[1]:
                for c in range(4):
                    rr = fm.prepend(match_range, c)
                    if rr[0] < rr[1]:
                        new_ranges.append((rr, cost + 1, length + 2))
        new_ranges.sort(key=lambda t: (t[0][0], t[0][1], t[1], t[2]))
        # dedup
        ranges = [
            t for idx, t in enumerate(new_ranges)
            if idx == 0 or t != new_ranges[idx - 1]
        ]
        total = sum(rr[1] - rr[0] for rr, _, _ in ranges)
        if total <= max_matches:
            seeds.append(Seed(i, seed_end, r, 0))
            for rng, cost, length in ranges:
                for sa_idx in range(rng[0], rng[1]):
                    ms = int(fm.sa[sa_idx])
                    if ms + length > m:
                        continue  # match includes the sentinel
                    match_list.append(
                        Match(
                            Pos(i, ms), Pos(seed_end, ms + length), cost, r
                        )
                    )
            seed_end = i
            ranges = init_ranges()

    seeds.reverse()
    seed_objs = Seeds(n, seeds)
    # Sort + dedup like MatchBuilder.finish (`matches.rs:300-332`).
    match_list.sort(
        key=lambda mt: (mt.start.i, mt.start.j, mt.end.i, mt.end.j, mt.match_cost)
    )
    deduped = []
    last = None
    for mt in match_list:
        key = (mt.start, mt.end)
        if key != last:
            deduped.append(mt)
            last = key
    return Matches(seed_objs, deduped)
