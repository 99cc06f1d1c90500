"""Distance heuristics (mirror of `pa-heuristic/src/heuristic/distances.rs`).

These are stateless lower-bound distance functions used as plug-in
heuristics for the A* domain of the block aligner.  Each instance exposes
the same protocol as the full GCSH instance (:mod:`astarpa_tpu_torch.heuristic.csh`):
``h(pos)``, ``h_with_hint(pos, hint)``, plus no-op pruning hooks.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import Pos


class HeuristicInstance:
    """Protocol default implementations (cf. `heuristic.rs:40-188`)."""

    def h(self, pos: Pos) -> int:
        raise NotImplementedError

    def h_with_hint(self, pos: Pos, hint):
        return self.h(pos), hint

    def root_potential(self) -> int:
        return 0

    def default_hint(self):
        return None

    # Pruning hooks: no-ops for distance heuristics.
    def update_contours(self, pos: Pos) -> None:
        pass

    def prune_block(self, i_range, j_range) -> None:
        pass

    def prune(self, pos: Pos, hint) -> tuple[int, object]:
        """Per-position prune for the A* loop; (shift, order) = no-op."""
        return 0, self.order_zero()

    def explore(self, pos: Pos) -> None:
        pass

    def is_seed_start_or_end(self, pos: Pos) -> bool:
        return False

    # Queue shift order (`heuristic.rs:63-103`); trivial by default.
    def order_of(self, pos: Pos):
        return 0

    def order_zero(self):
        return 0


@dataclass
class NoCostI(HeuristicInstance):
    """h = 0 everywhere (Dijkstra), `distances.rs:24-56`."""

    def h(self, pos: Pos) -> int:
        return 0

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        return 0


@dataclass
class GapCostI(HeuristicInstance):
    """h(u) = |Δi - Δj| to the target, `distances.rs:96-137` (unit costs)."""

    target: Pos

    def h(self, pos: Pos) -> int:
        return abs((self.target.i - pos.i) - (self.target.j - pos.j))

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        return abs((to_pos.i - from_pos.i) - (to_pos.j - from_pos.j))


@dataclass
class MaxCostI(HeuristicInstance):
    """h(u) = max(Δi, Δj), `distances.rs:60-92`."""

    target: Pos

    def h(self, pos: Pos) -> int:
        return max(self.target.i - pos.i, self.target.j - pos.j)

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        return max(to_pos.i - from_pos.i, to_pos.j - from_pos.j)


@dataclass
class ZeroCostI(HeuristicInstance):
    """Like NoCost but not special-cased by the drivers
    (`distances.rs:59-92`)."""

    def h(self, pos: Pos) -> int:
        return 0

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        return 0


class CountCostI(HeuristicInstance):
    """Char-frequency lower bound: surplus chars of ``a`` must be deleted,
    missing ones inserted (`distances.rs:171-232`)."""

    def __init__(self, a: bytes, b: bytes):
        self.a_cnts = _char_counts(a)
        self.b_cnts = _char_counts(b)
        self.target = Pos(len(a), len(b))

    def h(self, pos: Pos) -> int:
        return self.distance(pos, self.target)

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        da = self.a_cnts[to_pos.i] - self.a_cnts[from_pos.i]
        db = self.b_cnts[to_pos.j] - self.b_cnts[from_pos.j]
        delta = da - db
        pos_sum = int(delta[delta > 0].sum())
        neg_sum = int(-delta[delta < 0].sum())
        return max(pos_sum, neg_sum)


class BiCountCostI(HeuristicInstance):
    """2-mer count lower bound; max of CountCost and half the bi-mer
    imbalance.  The reference notes the triangle inequality may not hold
    (`distances.rs:242-246`) — kept for parity, not used in production.
    """

    def __init__(self, a: bytes, b: bytes):
        self.cnt = CountCostI(a, b)
        self.a_cnts = _char_bicounts(a)
        self.b_cnts = _char_bicounts(b)
        self.target = Pos(len(a), len(b))

    def h(self, pos: Pos) -> int:
        return self.distance(pos, self.target)

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        ai = min(from_pos.i + 1, to_pos.i)
        bj = min(from_pos.j + 1, to_pos.j)
        delta = (self.a_cnts[to_pos.i] - self.a_cnts[ai]) - (
            self.b_cnts[to_pos.j] - self.b_cnts[bj]
        )
        pos_sum = int(delta[delta > 0].sum())
        neg_sum = int(-delta[delta < 0].sum())
        return max(self.cnt.distance(from_pos, to_pos), (max(pos_sum, neg_sum) + 1) // 2)


@dataclass
class AffineGapCostI(HeuristicInstance):
    """Gap cost plus the number of whole seeds crossed, assuming unit seed
    cost r=1 (`distances.rs:353-379`)."""

    k: int
    target: Pos

    def h(self, pos: Pos) -> int:
        return self.distance(pos, self.target)

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        d = (to_pos.j - to_pos.i) - (from_pos.j - from_pos.i)
        p = to_pos.i // self.k - -(-from_pos.i // self.k)
        return p + abs(d)


@dataclass(frozen=True)
class SimpleAffineCost:
    """Substitution / gap-open / gap-extend costs (`distances.rs:389-394`)."""

    sub: int
    open: int
    extend: int


@dataclass
class AffineGapSeedCostI(HeuristicInstance):
    """Distance accounting for BOTH the affine gap cost and the seed cost
    of crossing ``p`` seeds over ``d`` diagonals (`distances.rs:383-647`;
    only the `formula` and per-branch arms are live there — the bulk of
    the reference function is commented-out exploration, kept as such).
    Assumes unit-style costs (the reference notes x=1, o=1, e=1, r=1) and
    matchless seeds (each crossed seed costs its full potential ``r``)."""

    params: "AffineGapSeedCost"
    target: Pos

    def h(self, pos: Pos) -> int:
        return self.distance(pos, self.target)

    def distance(self, from_pos: Pos, to_pos: Pos) -> int:
        k, r, c = self.params.k, self.params.r, self.params.c
        # Diagonals to change / whole seeds crossed (`distances.rs:434-441`).
        d = (to_pos.j - to_pos.i) - (from_pos.j - from_pos.i)
        p = max(to_pos.i // k - -(-from_pos.i // k), 0)
        if d == 0:
            return p * r
        if p == 0:
            return c.open + c.extend * abs(d)
        if self.params.formula:
            # `distances.rs:614-619`.
            seeds = c.open + c.extend + (p - 1) * r
            c0 = min(max(p * r, seeds) + c.extend, c.open) - c.extend * d
            c1 = min(max(p * r, seeds - c.extend), p * c.open) + c.extend * d
            return max(c0, c1, max(p * r, seeds))
        if d > 0:
            # Insertions: all in one seed, or spread evenly
            # (`distances.rs:622-637`).
            c1 = c.open + c.extend * d + (p - 1) * r
            d0, count_d1 = divmod(d, p)
            count_d0 = p - count_d1
            c2 = count_d0 * ((0 if d0 == 0 else c.open) + c.extend * d0) + \
                count_d1 * (c.open + c.extend * (d0 + 1))
            return min(c1, c2)
        # Deletions (`distances.rs:640-645`; the reference's own FIXME —
        # the seed term is dropped, keeping only the gap lower bound).
        return c.open + c.extend * (-d)


def _char_counts(a: bytes):
    """Prefix char counts: counts[i][c] = #occurrences of code c in a[:i]."""
    import numpy as np

    from ..types import seq_to_codes

    codes = seq_to_codes(a)
    onehot = np.zeros((len(a) + 1, 4), dtype=np.int64)
    if len(a):
        onehot[np.arange(1, len(a) + 1), codes] = 1
    return np.cumsum(onehot, axis=0)


def _char_bicounts(a: bytes):
    """Prefix 2-mer counts, aligned as in `distances.rs:248-258`:
    counts[i] covers the 2-mers fully inside a[:i]."""
    import numpy as np

    from ..types import seq_to_codes

    n = len(a)
    counts = np.zeros((n + 1, 16), dtype=np.int64)
    if n >= 2:
        codes = seq_to_codes(a).astype(np.int64)
        bimers = codes[:-1] * 4 + codes[1:]
        onehot = np.zeros((n - 1, 16), dtype=np.int64)
        onehot[np.arange(n - 1), bimers] = 1
        counts[2:] = np.cumsum(onehot, axis=0)
    return counts


class NoCost:
    """Heuristic factory for NoCostI (builder-pattern parity)."""

    def build(self, a: bytes, b: bytes) -> NoCostI:
        return NoCostI()

    name = "None"


class ZeroCost:
    def build(self, a: bytes, b: bytes) -> ZeroCostI:
        return ZeroCostI()

    name = "Zero"


class GapCost:
    def build(self, a: bytes, b: bytes) -> GapCostI:
        return GapCostI(Pos(len(a), len(b)))

    name = "Gap"


class MaxCost:
    def build(self, a: bytes, b: bytes) -> MaxCostI:
        return MaxCostI(Pos(len(a), len(b)))

    name = "Max"


class CountCost:
    def build(self, a: bytes, b: bytes) -> CountCostI:
        return CountCostI(a, b)

    name = "Count"


class BiCountCost:
    def build(self, a: bytes, b: bytes) -> BiCountCostI:
        return BiCountCostI(a, b)

    name = "BiCount"


@dataclass
class AffineGapCost:
    k: int

    def build(self, a: bytes, b: bytes) -> AffineGapCostI:
        return AffineGapCostI(self.k, Pos(len(a), len(b)))

    name = "AffineGap"


@dataclass
class AffineGapSeedCost:
    """`distances.rs:395-400` — gap + seed distance for affine costs."""

    k: int
    r: int
    c: SimpleAffineCost
    formula: bool = False

    def build(self, a: bytes, b: bytes) -> AffineGapSeedCostI:
        return AffineGapSeedCostI(self, Pos(len(a), len(b)))

    name = "AffineGap"
