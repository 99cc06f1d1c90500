"""Local pruning: kill matches not followed by a good enough path.

Mirror of `pa-heuristic/src/matches/prepruning.rs:95-203`: a small
diagonal-transition run from the match end over the next ``p`` seeds; the
match is kept iff some prefix of those seeds can be crossed with cost below
its potential, or the extension runs into a known future match.
"""

from __future__ import annotations

import numpy as np

from ..types import Pos

INT_MIN = -(1 << 31)
INT_MAX = (1 << 31) - 1


def _extend_right(ca, cb, i: int, j: int, end_i: int) -> tuple[int, bool]:
    """Greedy diagonal extension; returns (new_i, reached_end_i)
    (`prepruning.rs:25-62`, vectorized)."""
    max_len = min(len(ca) - i, len(cb) - j)
    if max_len > 0:
        av = ca[i : i + max_len]
        bv = cb[j : j + max_len]
        neq = av != bv
        nz = np.nonzero(neq)[0]
        cnt = max_len if len(nz) == 0 else int(nz[0])
        i += cnt
    return i, i >= end_i


def preserve_for_local_pruning(
    ca, cb, seeds, m, p: int, next_match_per_diag: dict[int, int]
) -> bool:
    if p == 0:
        return True

    s, e = m.start, m.end
    potential = seeds.potential
    start_pot = int(potential[s.i])
    seed_idx = int(seeds.seed_at_arr[s.i])
    last_seed = seeds.seeds[min(seed_idx + p - 1, len(seeds.seeds) - 1)]
    end_i = last_seed.end
    pd = start_pot - int(potential[end_i])

    # Fronts indexed by diagonal d relative to e (offset pd like the
    # reference's flat vector).
    fr = [INT_MIN] * (2 * pd + 1)
    next_fr = [INT_MIN] * (2 * pd + 1)
    d_lo, d_hi = pd, pd + 1  # exclusive end

    i, reached = _extend_right(ca, cb, e.i, e.j, end_i)
    fr[pd] = i
    if reached:
        return True
    if next_match_per_diag.get(e.i - e.j, INT_MAX) <= fr[pd]:
        return True

    for g in range(1 + m.match_cost, pd):
        # Reset both fronts' boundary diagonals (`prepruning.rs:146-149`).
        fr[d_lo - 1] = INT_MIN
        fr[d_hi] = INT_MIN
        next_fr[d_lo - 1] = INT_MIN
        next_fr[d_hi] = INT_MIN
        # expand (stale next_fr interior values are older fronts, which are
        # always <= the new front, so max keeps correctness)
        for d in range(d_lo, d_hi):
            v = fr[d]
            if next_fr[d - 1] < v:
                next_fr[d - 1] = v
            if next_fr[d] < v + 1:
                next_fr[d] = v + 1
            if next_fr[d + 1] < v + 1:
                next_fr[d + 1] = v + 1
        fr, next_fr = next_fr, fr
        d_lo, d_hi = d_lo - 1, d_hi + 1

        # check & shrink (`prepruning.rs:165-178`)
        while d_lo < d_hi and g + int(potential[min(fr[d_lo], len(potential) - 1)]) >= start_pot:
            d_lo += 1
        while d_lo < d_hi and g + int(potential[min(fr[d_hi - 1], len(potential) - 1)]) >= start_pot:
            d_hi -= 1
        if d_lo >= d_hi:
            return False

        # extend
        for d in range(d_lo, d_hi):
            dd = e.i - e.j + (d - pd)
            j = fr[d] - dd
            old_i = fr[d]
            i, reached = _extend_right(ca, cb, fr[d], j, end_i)
            fr[d] = i
            if reached:
                return True
            nm = next_match_per_diag.get(dd, INT_MAX)
            if old_i <= nm <= fr[d]:
                return True

    return False
