"""k-mer match finding (mirror of `pa-heuristic/src/matches.rs`, `exact.rs`,
`inexact.rs`).

- r=1: hash the disjoint k-mers of ``a``, stream ``b``'s sliding k-mers in
  reverse, emit cost-0 matches (`exact.rs:15-69`).
- r=2: hash all (k-1, k, k+1)-mers of ``b``; for each seed of ``a`` look up
  the exact q-gram and all single-edit mutations -> matches of cost <= 1
  (`inexact.rs:253-344`).

The MatchBuilder applies the GCSH transform filter, local pruning
(look-ahead p), sort/dedup, and the r=2 consistency repair
(`matches.rs:133-333`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..types import Pos, seq_to_codes
from .qgrams import a_qgrams, qgrams_of, to_qgram
from .seeds import Seeds
from .prepruning import preserve_for_local_pruning

INT_MAX = (1 << 31) - 1


class MatchStatus(enum.Enum):
    ACTIVE = 0
    PRUNED = 1
    PREPRUNED = 2
    FILTERED = 3


@dataclass
class Match:
    start: Pos
    end: Pos
    match_cost: int
    seed_potential: int
    pruned: MatchStatus = MatchStatus.ACTIVE

    def score(self) -> int:
        return self.seed_potential - self.match_cost

    def is_active(self) -> bool:
        return self.pruned == MatchStatus.ACTIVE

    def prune(self) -> None:
        self.pruned = MatchStatus.PRUNED


@dataclass(frozen=True)
class MatchConfig:
    """`matches.rs:388-423`.

    Fixed-length seeds of length ``k``, or — when ``max_matches`` is set —
    variable-length minimal-unique-match seeds (`LengthConfig::Max`,
    suffix-array path; ``k`` is then ignored).
    """

    k: int
    r: int
    local_pruning: int = 0
    max_matches: int | None = None


@dataclass
class Matches:
    seeds: Seeds
    matches: list[Match]


def _match_key(m: Match):
    return (m.start.i, m.start.j, m.end.i, m.end.j, m.match_cost)


class MatchBuilder:
    """Collects matches; filters; sorts; repairs consistency
    (`matches.rs:157-333`)."""

    def __init__(self, ca, cb, config: MatchConfig, transform_filter: bool):
        self.ca = ca
        self.cb = cb
        self.config = config
        self.seeds = Seeds.fixed_length(len(ca), config.k, config.r)
        self.matches: list[Match] = []
        self.transform_filter = transform_filter
        self.transform_target = self.seeds.transform(Pos(len(ca), len(cb)))
        # The i of the next (leftmost) match on each (absolute) diagonal.
        self.next_match_per_diag: dict[int, int] = {}

    def push(self, m: Match) -> None:
        if self.transform_filter:
            t = self.seeds.transform(m.start)
            if not (t.i <= self.transform_target.i and t.j <= self.transform_target.j):
                return
        if self.config.local_pruning != 0 and not preserve_for_local_pruning(
            self.ca, self.cb, self.seeds, m, self.config.local_pruning,
            self.next_match_per_diag,
        ):
            return

        seed = self.seeds.seed_at(m.start)
        seed.seed_cost = min(seed.seed_cost, m.match_cost)

        if self.config.local_pruning != 0:
            d = m.start.i - m.start.j
            old = self.next_match_per_diag.get(d, INT_MAX)
            assert old >= m.start.i, (
                "Matches should be added in reverse order on each diagonal."
            )
            self.next_match_per_diag[d] = m.start.i

        self.matches.append(m)

    def sort(self) -> None:
        self.matches.sort(key=_match_key)

    def make_consistent(self) -> None:
        """Re-add +-1-indel shadow matches lost to local pruning
        (`matches.rs:259-298`)."""
        if self.config.local_pruning == 0 or self.config.r == 1:
            return
        assert self.config.r == 2
        keys = {_match_key(m) for m in self.matches}
        new = []
        for m in list(self.matches):
            if m.match_cost + 1 >= m.seed_potential:
                continue
            for dis, die in [(0, 1), (0, -1), (1, 0), (-1, 0)]:
                mm = Match(
                    Pos(m.start.i, m.start.j + dis),
                    Pos(m.end.i, m.end.j + die),
                    m.match_cost + 1,
                    m.seed_potential,
                )
                if _match_key(mm) not in keys:
                    new.append(mm)
        self.matches.extend(new)
        self.sort()

    def finish(self) -> Matches:
        self.sort()
        # Dedup by (start, end), keeping the lowest cost (sorted first).
        deduped = []
        last = None
        for m in self.matches:
            key = (m.start, m.end)
            if key != last:
                deduped.append(m)
                last = key
        self.matches = deduped
        self.make_consistent()
        return Matches(self.seeds, self.matches)


def find_matches(
    a: bytes,
    b: bytes,
    config: MatchConfig,
    transform_filter: bool,
    layout: str = "hash",
) -> Matches:
    """Dispatch on length config and r (`matches.rs:17-39`).

    ``layout`` selects the r=1 exact-match data structure (the reference
    benches these against each other in `exact.rs`): "hash" (per-key
    lists, `hash_a`), "hash_b" (roles swapped, `hash_b`), "csr" (one flat
    qgram-sorted position vector, `hash_a_single`), "qgram_index" (dense
    4^k offset table, `hash_a_qgram_index`), "sliding_window"
    (transform-bounded rolling window, `hash_a_sliding_window`).  All
    layouts produce identical Matches; parity is enforced by
    `tests/test_match_layouts.py`.
    """
    if config.max_matches is not None:
        # Variable-k minimal unique matches; no transform filter, like the
        # reference's MUM path (`suffix_array.rs` MatchBuilder::new(.., false)).
        if layout != "hash":
            raise NotImplementedError(
                "layout variants are r=1 fixed-k only (exact.rs); the "
                "max_matches MUM path has a single FM-index implementation"
            )
        from .suffix_array import minimal_unique_matches

        return minimal_unique_matches(a, b, config.r, config.max_matches)
    ca, cb = seq_to_codes(a), seq_to_codes(b)
    if config.r == 1:
        return EXACT_LAYOUTS[layout](ca, cb, config, transform_filter)
    if layout != "hash":
        raise NotImplementedError("layout variants are r=1 only (exact.rs)")
    if config.r == 2:
        return _find_inexact(ca, cb, config, transform_filter)
    raise NotImplementedError("r must be 1 or 2")


def _find_exact(ca, cb, config: MatchConfig, transform_filter: bool) -> Matches:
    """r=1 hash_a (`exact.rs:15-69`)."""
    k = config.k
    builder = MatchBuilder(ca, cb, config, transform_filter)
    starts, aq = a_qgrams(ca, k)
    table: dict[int, list[int]] = {}
    for i, q in zip(starts.tolist(), aq.tolist()):
        table.setdefault(q, []).append(i)
    bq = qgrams_of(cb, k)
    # Stream b's k-mers in reverse (`exact.rs:20-22` uses b_qgrams_rev).
    for j in range(len(bq) - 1, -1, -1):
        hits = table.get(int(bq[j]))
        if hits:
            for i in hits:
                builder.push(
                    Match(Pos(i, j), Pos(i + k, j + k), 0, 1)
                )
    builder.sort()
    return builder.finish()


def _find_exact_hash_b(ca, cb, config: MatchConfig, transform_filter: bool) -> Matches:
    """r=1 `hash_b` (`exact.rs:27-38`): roles swapped — hash ALL sliding
    k-mers of ``b`` (k times more entries), stream ``a``'s disjoint seeds
    in reverse.  Typically 2-3x slower than hash_a (the reference's module
    comment, `exact.rs:5-7`); kept as the layout A/B."""
    k = config.k
    builder = MatchBuilder(ca, cb, config, transform_filter)
    table: dict[int, list[int]] = {}
    for j, q in enumerate(qgrams_of(cb, k).tolist()):
        table.setdefault(q, []).append(j)
    starts, aq = a_qgrams(ca, k)
    for i, q in zip(starts.tolist()[::-1], aq.tolist()[::-1]):
        hits = table.get(q)
        if hits:
            for j in hits:
                builder.push(Match(Pos(i, j), Pos(i + k, j + k), 0, 1))
    builder.sort()
    return builder.finish()


def _find_exact_csr(ca, cb, config: MatchConfig, transform_filter: bool) -> Matches:
    """r=1 CSR layout (`exact.rs:105-157` `hash_a_single`): instead of a
    per-key list, ONE flat position vector ordered by q-gram plus offset
    ranges (the reference builds it count -> prefix-sum -> fill; the numpy
    idiom is a stable argsort of the seed q-grams, which yields the same
    vector, with b's windows locating their range by binary search)."""
    k = config.k
    builder = MatchBuilder(ca, cb, config, transform_filter)
    starts, aq = a_qgrams(ca, k)
    order = np.argsort(aq, kind="stable")
    sq = aq[order]
    pos = starts[order]
    bq = qgrams_of(cb, k)
    lo = np.searchsorted(sq, bq, side="left")
    hi = np.searchsorted(sq, bq, side="right")
    for j in range(len(bq) - 1, -1, -1):
        for i in pos[lo[j]:hi[j]].tolist():
            builder.push(Match(Pos(i, j), Pos(i + k, j + k), 0, 1))
    builder.sort()
    return builder.finish()


def _find_exact_qgram_index(ca, cb, config: MatchConfig, transform_filter: bool) -> Matches:
    """r=1 dense q-gram index (`exact.rs:193-243`): offsets live in a
    4^k-entry table instead of a hashmap — slower than hashing when 4^k
    exceeds the input size (the reference's own comment, `exact.rs:194`),
    kept as the layout A/B."""
    k = config.k
    # 4^13 + 1 int64 offsets = 512 MiB is already the ceiling this 1-core
    # host can absorb (k=14 would be ~2 GiB plus bincount/argsort
    # temporaries); the layout is an A/B and the reference notes it loses
    # past input size anyway (`exact.rs:194`).
    if 4 ** k > (1 << 26):
        raise ValueError("qgram_index allocates a 4^k offset table; k <= 13")
    builder = MatchBuilder(ca, cb, config, transform_filter)
    starts, aq = a_qgrams(ca, k)
    off = np.zeros(4 ** k + 1, np.int64)
    np.cumsum(np.bincount(aq, minlength=4 ** k), out=off[1:])
    pos = starts[np.argsort(aq, kind="stable")]
    bq = qgrams_of(cb, k)
    for j in range(len(bq) - 1, -1, -1):
        q = int(bq[j])
        for i in pos[off[q]:off[q + 1]].tolist():
            builder.push(Match(Pos(i, j), Pos(i + k, j + k), 0, 1))
    builder.sort()
    return builder.finish()


def _find_exact_sliding_window(ca, cb, config: MatchConfig, transform_filter: bool) -> Matches:
    """r=1 transform-bounded sliding window (`exact.rs:356-472`
    `hash_a_sliding_window`): stream ``b`` right-to-left building its
    q-gram incrementally; the hash table holds only the a-seeds whose
    transformed position can still pass the GCSH filter at the current j
    (an over-approximating i-window, re-checked every 2^6 rows), so the
    table stays O(window) instead of O(n/k).  Requires the transform
    filter (asserted in the reference too) — `MatchBuilder.push` still
    applies the exact filter, the window only bounds table size.
    """
    assert transform_filter, "sliding_window requires the transform filter"
    k = config.k
    builder = MatchBuilder(ca, cb, config, transform_filter)
    t = builder.transform_target
    CHECK_EACH_J_LAYERS = 6

    # The reference derives an approximate i-window from i-per-j slope
    # bounds (`exact.rs:395-405`; `as usize` wrap makes negative target
    # components unbounded, which is what keeps it sound there).  Here
    # each seed's EXACT passing j-interval comes from the potential
    # array instead:  T(i,j) = (i-j-p(i), j-i-p(i)) <= t componentwise
    # <=>  i - p(i) - t.i <= j <= i + p(i) + t.j.  Both bounds are
    # monotone in i (p drops by r per seed while i grows by k > r), so
    # the same two descending-i pointers maintain the window.
    starts, aq = a_qgrams(ca, k)
    pot = builder.seeds.potential[starts]
    jmins = (starts - pot - t.i).tolist()[::-1]
    jmaxs = (starts + pot + t.j).tolist()[::-1]
    seeds_desc = list(zip(starts.tolist()[::-1], aq.tolist()[::-1]))
    ins_ptr = 0  # next seed (descending i) to insert into the table
    rem_ptr = 0  # next inserted seed (descending i) to evict
    table: dict[int, list[int]] = {}
    m = len(cb)
    qb = 0
    slack = (1 << CHECK_EACH_J_LAYERS) - 1  # rows until the next check
    for j in range(m - 1, -1, -1):
        if (m - 1 - j) & ((1 << CHECK_EACH_J_LAYERS) - 1) == 0:
            # Evict seeds whose whole j-interval is above the rows left.
            # Entries in [rem_ptr, ins_ptr) are exactly the table's
            # contents, so the eviction pointer never passes insertion.
            while rem_ptr < ins_ptr and jmins[rem_ptr] > j:
                i, q = seeds_desc[rem_ptr]
                rem_ptr += 1
                v = table[q]
                if len(v) == 1:
                    del table[q]
                else:
                    v.remove(i)
            # Insert seeds whose interval reaches the upcoming rows.
            while ins_ptr < len(seeds_desc) and jmaxs[ins_ptr] >= j - slack:
                i, q = seeds_desc[ins_ptr]
                ins_ptr += 1
                table.setdefault(q, []).append(i)
        qb = (qb >> 2) | (int(cb[j]) << (2 * (k - 1)))
        if j + k > m:
            continue
        hits = table.get(qb)
        if hits:
            for i in hits:
                builder.push(Match(Pos(i, j), Pos(i + k, j + k), 0, 1))
    builder.sort()
    return builder.finish()


EXACT_LAYOUTS = {
    "hash": _find_exact,
    "hash_b": _find_exact_hash_b,
    "csr": _find_exact_csr,
    "qgram_index": _find_exact_qgram_index,
    "sliding_window": _find_exact_sliding_window,
}


def _mutations(k: int, qgram: int) -> tuple[list[int], list[int], list[int]]:
    """All single-edit variants of a 2-bit packed q-gram
    (`inexact.rs:18-58`, dedup=False).  Returns (deletions, substitutions,
    insertions) of lengths k-1, k, k+1 respectively.
    """
    subs = []
    for i in range(k):
        mask = ~(3 << (2 * i))
        for s in range(4):
            q = (qgram & mask) | (s << (2 * i))
            if q != qgram:
                subs.append(q)
    ins = []
    for i in range(k + 1):
        mask = (1 << (2 * i)) - 1
        for s in range(4):
            ins.append((qgram & mask) | (s << (2 * i)) | ((qgram & ~mask) << 2))
    dels = []
    for i in range(k):
        mask = (1 << (2 * i)) - 1
        dels.append((qgram & mask) | ((qgram & (~mask << 2)) >> 2))
    return dels, subs, ins


def _find_inexact(ca, cb, config: MatchConfig, transform_filter: bool) -> Matches:
    """r=2 qgram-hash matcher (`inexact.rs:253-344`)."""
    k = config.k
    builder = MatchBuilder(ca, cb, config, transform_filter)
    # Hash all (k-1, k, k+1)-mers of b, one table per length.
    tables: dict[int, dict[int, list[int]]] = {}
    for kk in (k - 1, k, k + 1):
        t: dict[int, list[int]] = {}
        for j, q in enumerate(qgrams_of(cb, kk).tolist()):
            t.setdefault(q, []).append(j)
        tables[kk] = t

    def push_all(start, end_i, js, dj, cost):
        if js:
            for j in js:
                builder.push(
                    Match(Pos(start, j), Pos(end_i, j + dj), cost, 2)
                )

    # Iterate seeds in reverse (right-to-left) for local-pruning order.
    for seed in reversed(builder.seeds.seeds):
        start, end = seed.start, seed.end
        qgram = to_qgram(ca[start:end])
        before = len(builder.matches)
        push_all(start, end, tables[k].get(qgram), k, 0)
        dels, subs, ins = _mutations(k, qgram)
        for w in dels:
            push_all(start, end, tables[k - 1].get(w), k - 1, 1)
        for w in subs:
            push_all(start, end, tables[k].get(w), k, 1)
        for w in ins:
            push_all(start, end, tables[k + 1].get(w), k + 1, 1)
        builder.matches[before:] = sorted(builder.matches[before:], key=_match_key)
    return builder.finish()
