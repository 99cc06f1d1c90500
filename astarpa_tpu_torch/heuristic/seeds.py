"""Seeds, potentials, and the GCSH domain transform.

Mirror of `pa-heuristic/src/seeds.rs`: ``a`` is split into disjoint
length-k seeds; the *potential* at i is the cost of crossing all remaining
seeds with no matches; the GCSH transform maps positions into the cost
domain where gap-chaining becomes plain dominance (`seeds.rs:140-156`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..types import Pos

INT_MAX = (1 << 31) - 1


@dataclass
class Seed:
    start: int
    end: int
    seed_potential: int
    seed_cost: int


class Seeds:
    def __init__(self, n: int, seeds: list[Seed]):
        for s1, s2 in zip(seeds, seeds[1:]):
            assert s1.start <= s1.end <= s2.start
        self.seeds = seeds
        # potential[i] = sum of potentials of seeds starting at >= i.
        potential = np.zeros(n + 1, dtype=np.int64)
        seed_at = np.full(n + 1, -1, dtype=np.int64)
        start_of_potential = [n]
        cur = 0
        it = list(enumerate(seeds))[::-1]
        ptr = 0
        for i in range(n, -1, -1):
            if ptr < len(it):
                idx, s = it[ptr]
                if i < s.end:
                    seed_at[i] = idx
                if i == s.start:
                    cur += s.seed_potential
                    start_of_potential.extend([i] * s.seed_potential)
                    ptr += 1
            potential[i] = cur
        self.n = n
        self.potential = potential
        self.seed_at_arr = seed_at
        self.start_of_potential = np.array(start_of_potential, dtype=np.int64)

    @staticmethod
    def fixed_length(n: int, k: int, r: int) -> "Seeds":
        """Disjoint k-mers of ``a`` (`qgrams.rs:102-112`)."""
        seeds = [Seed(i, i + k, r, r) for i in range(0, n - k + 1, k)]
        return Seeds(n, seeds)

    def pot(self, pos: Pos) -> int:
        return int(self.potential[pos.i])

    def seed_at(self, pos: Pos) -> Seed | None:
        idx = self.seed_at_arr[pos.i] if pos.i <= self.n else -1
        return self.seeds[idx] if idx >= 0 else None

    def seed_ending_at(self, pos: Pos) -> Seed | None:
        if pos.i == 0:
            return None
        idx = self.seed_at_arr[pos.i - 1]
        return self.seeds[idx] if idx >= 0 else None

    def is_seed_start(self, pos: Pos) -> bool:
        s = self.seed_at(pos)
        return s is not None and pos.i == s.start

    def is_seed_end(self, pos: Pos) -> bool:
        s = self.seed_ending_at(pos)
        return s is not None and pos.i == s.end

    def is_seed_start_or_end(self, pos: Pos) -> bool:
        return self.is_seed_start(pos) or self.is_seed_end(pos)

    def potential_distance(self, from_pos: Pos, to_pos: Pos) -> int:
        """Cost to cross the seeds between from and to with no matches
        (`seeds.rs:84-88`)."""
        assert from_pos.i <= to_pos.i
        s = self.seed_at(to_pos)
        end_i = s.start if s is not None else to_pos.i
        return int(self.potential[from_pos.i] - self.potential[end_i])

    def transform(self, pos: Pos) -> Pos:
        """T(i, j) = (i - j - p(i), j - i - p(i)) (`seeds.rs:140-143`)."""
        p = int(self.potential[pos.i])
        return Pos(pos.i - pos.j - p, pos.j - pos.i - p)

    def transform_back(self, pos: Pos) -> Pos:
        if pos == Pos(INT_MAX, INT_MAX):
            return pos
        p = -(pos.i + pos.j) // 2
        i = int(self.start_of_potential[p])
        diff = (pos.i - pos.j) // 2
        j = i - diff
        return Pos(i, j)
