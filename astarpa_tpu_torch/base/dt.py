"""Diagonal transition (WFA) aligners, unit and affine costs.

The port's own copy of ``astarpa_tpu/base/dt.py`` (pure Python on the
host, the code kept identical).  Re-design of `pa-base-algos/src/dt.rs`
(the reference's WFA/BiWFA reimplementation with affine layers, fwd/bwd
fronts, meet-in-the-middle overlap detection and divide & conquer
linear-memory path reconstruction, `dt.rs:68-116,693-856`).

States are wavefronts indexed by cost g and diagonal ``k = i - j``; each
front stores the farthest-reaching column ``i`` per diagonal, with greedy
match extension along diagonals.  Three modes:

- ``cost``: fronts only, O(d) memory.
- ``align``: stored fronts + parent backtrace, O(d^2) memory.
- ``align_dc`` (unit costs): BiWFA-style meet-in-middle divide & conquer,
  O(d) memory, O(nd) extra time.
"""

from __future__ import annotations

import numpy as np

from ..affine import (
    DEL,
    INS,
    MATCH,
    SUB,
    AffineCigar,
    AffineCost,
    affine_close,
    affine_del,
    affine_ins,
    affine_open,
)

NEG = -(1 << 30)


def _extend(a: bytes, b: bytes, i: int, k: int) -> int:
    """Greedily extend matches along diagonal k starting at column i."""
    j = i - k
    n, m = len(a), len(b)
    while i < n and j < m and a[i] == b[j]:
        i += 1
        j += 1
    return i


class DiagonalTransition:
    """Exact DT/WFA aligner over an :class:`AffineCost` model."""

    def __init__(self, cm: AffineCost | None = None, dc: bool = False):
        self.cm = cm if cm is not None else AffineCost.unit()
        self.dc = dc
        if dc:
            assert self.cm == AffineCost.unit(), "divide&conquer is unit-cost"

    # -- public API -------------------------------------------------------------

    def cost(self, a: bytes, b: bytes) -> int:
        g, _ = self._search(a, b, keep_fronts=False)
        return g

    def align(self, a: bytes, b: bytes) -> tuple[int, AffineCigar]:
        if self.dc:
            return self._align_dc(a, b)
        g, fronts = self._search(a, b, keep_fronts=True)
        return g, self._trace(a, b, g, fronts)

    # -- forward search -----------------------------------------------------------

    def _search(self, a: bytes, b: bytes, keep_fronts: bool):
        """Grow fronts until (n, m) is reached; returns (distance, fronts).

        fronts[g] = dict with 'M' and per-layer keys mapping k -> i.
        """
        cm = self.cm
        n, m = len(a), len(b)
        target_k = n - m
        fronts: list[dict] = []
        g = 0
        while True:
            front = self._next_front(a, b, fronts, g)
            fronts.append(front)
            i = front["M"].get(target_k, NEG)
            if i >= n:
                assert i == n
                return g, fronts if keep_fronts else None
            g += 1
            assert g <= (n + m) * max(
                x for x in (cm.sub, cm.ins, cm.delete, 10**9) if x is not None
            ), "DT did not converge"

    def _next_front(self, a: bytes, b: bytes, fronts: list[dict], g: int) -> dict:
        cm = self.cm
        n, m = len(a), len(b)

        def fr(gg: int, key, k: int) -> int:
            if gg < 0 or gg >= len(fronts):
                return NEG
            return fronts[gg].get(key, {}).get(k, NEG)

        front: dict = {"M": {}}
        ks: set[int] = set()
        if g == 0:
            ks.add(0)
        # Candidate diagonals from all incoming transitions.
        for k in self._candidate_ks(fronts, g):
            ks.add(k)

        # Affine layers first (M may close them this same g).
        for l, lay in enumerate(cm.affine):
            layer: dict = {}
            for k in ks:
                if lay.affine_type.is_insert:
                    v = max(
                        fr(g - lay.open - lay.extend, "M", k + 1),
                        fr(g - lay.extend, l, k + 1),
                    )
                else:
                    pm = fr(g - lay.open - lay.extend, "M", k - 1)
                    pa = fr(g - lay.extend, l, k - 1)
                    v = max(
                        pm + 1 if pm > NEG else NEG,
                        pa + 1 if pa > NEG else NEG,
                    )
                if v > NEG:
                    layer[k] = v
            front[l] = layer

        for k in ks:
            cands = [NEG]
            if cm.sub is not None:
                p = fr(g - cm.sub, "M", k)
                if p > NEG:
                    cands.append(p + 1)
            if cm.ins is not None:
                cands.append(fr(g - cm.ins, "M", k + 1))
            if cm.delete is not None:
                p = fr(g - cm.delete, "M", k - 1)
                if p > NEG:
                    cands.append(p + 1)
            for l in range(cm.n_layers):
                cands.append(front[l].get(k, NEG))
            v = max(cands)
            if g == 0 and k == 0:
                v = max(v, 0)
            if v > NEG:
                j = v - k
                if 0 <= v <= len(a) and 0 <= j <= len(b):
                    front["M"][k] = _extend(a, b, v, k)
                elif v >= 0:
                    # Clamp out-of-rectangle reaches (can arise at borders).
                    pass
        return front

    def _candidate_ks(self, fronts: list[dict], g: int):
        cm = self.cm
        out = set()
        deps = []
        if cm.sub is not None:
            deps.append((cm.sub, 0))
        if cm.ins is not None:
            deps.append((cm.ins, -1))
        if cm.delete is not None:
            deps.append((cm.delete, +1))
        for lay in cm.affine:
            dk = -1 if lay.affine_type.is_insert else +1
            deps.append((lay.open + lay.extend, dk))
            deps.append((lay.extend, dk))
        for cost, _ in deps:
            gg = g - cost
            if 0 <= gg < len(fronts):
                for layer in fronts[gg].values():
                    for k in layer:
                        out.update((k - 1, k, k + 1))
        if g == 0:
            out.add(0)
        return out

    # -- traceback over stored fronts ------------------------------------------------

    def _trace(self, a: bytes, b: bytes, g: int, fronts: list[dict]) -> AffineCigar:
        cm = self.cm
        n, m = len(a), len(b)
        rev: list = []
        k, layer = n - m, None
        i = n

        def fr(gg: int, key, kk: int) -> int:
            if gg < 0 or gg >= len(fronts):
                return NEG
            return fronts[gg].get(key, {}).get(kk, NEG)

        while True:
            if layer is None:
                # Undo the greedy extension for this (g, k) stop point.
                base = NEG
                cands = []
                if cm.sub is not None:
                    cands.append((fr(g - cm.sub, "M", k) + 1, "sub"))
                if cm.ins is not None:
                    cands.append((fr(g - cm.ins, "M", k + 1), "ins"))
                if cm.delete is not None:
                    cands.append((fr(g - cm.delete, "M", k - 1) + 1, "del"))
                for l in range(cm.n_layers):
                    cands.append((fr(g, l, k), ("close", l)))
                if g == 0:
                    cands.append((0, "root"))
                base, how = max(
                    (c for c in cands if c[0] > NEG), key=lambda c: c[0]
                )
                # Matches from base to i.
                assert i >= base, (i, base, g, k)
                if i > base:
                    rev.append((MATCH, i - base))
                i = base
                if how == "root":
                    assert i == 0 and k == 0
                    break
                if how == "sub":
                    rev.append((SUB, 1))
                    i -= 1
                    g -= cm.sub
                elif how == "ins":
                    rev.append((INS, 1))
                    k += 1
                    g -= cm.ins
                elif how == "del":
                    rev.append((DEL, 1))
                    i -= 1
                    k -= 1
                    g -= cm.delete
                else:
                    _, l = how
                    rev.append((affine_close(l), 1))
                    layer = l
            else:
                lay = cm.affine[layer]
                if lay.affine_type.is_insert:
                    pm = fr(g - lay.open - lay.extend, "M", k + 1)
                    pa = fr(g - lay.extend, layer, k + 1)
                    rev.append((affine_ins(layer), 1))
                    if pa == i:
                        g -= lay.extend
                        k += 1
                    else:
                        assert pm == i, (pm, pa, i)
                        rev.append((affine_open(layer), 1))
                        g -= lay.open + lay.extend
                        k += 1
                        layer = None
                else:
                    pm = fr(g - lay.open - lay.extend, "M", k - 1)
                    pa = fr(g - lay.extend, layer, k - 1)
                    rev.append((affine_del(layer), 1))
                    if pa == i - 1:
                        g -= lay.extend
                        k -= 1
                        i -= 1
                    else:
                        assert pm == i - 1, (pm, pa, i)
                        rev.append((affine_open(layer), 1))
                        g -= lay.open + lay.extend
                        k -= 1
                        i -= 1
                        layer = None
        cigar = AffineCigar()
        for op, cnt in reversed(rev):
            cigar.push_op(op, cnt)
        return cigar

    # -- divide & conquer (unit costs, linear memory) -----------------------------

    def _align_dc(self, a: bytes, b: bytes) -> tuple[int, AffineCigar]:
        """Meet-in-the-middle split (`dt.rs:693-856` shape): grow forward
        and backward unit-cost fronts alternately until they overlap on a
        diagonal; recurse on both halves."""
        cigar = AffineCigar()
        total = self._dc_rec(a, b, 0, 0, len(a), len(b), cigar)
        # Middle-snake splits are delicate (cf. the reference's own overlap
        # regression fixes); certify against the O(d)-memory cost search.
        expected = self.cost(a, b)
        assert total == expected, f"d&c cost {total} != {expected}"
        return total, cigar

    def _dc_rec(self, a, b, i0, j0, i1, j1, out: AffineCigar) -> int:
        sa = a[i0:i1]
        sb = b[j0:j1]
        n, m = len(sa), len(sb)
        if n == 0 or m == 0:
            out.push_op(DEL if m == 0 else INS, n + m)
            return n + m
        # Small problems: direct stored-front alignment.
        if n * m <= 64 * 64:
            g, cig = DiagonalTransition(AffineCost.unit()).align(sa, sb)
            out.append(cig)
            return g

        fw = {0: _extend(sa, sb, 0, 0)}
        bw = {n - m: _rextend(sa, sb, n, n - m)}
        gf = gb = 0
        if fw[0] >= bw[n - m] and 0 == n - m:
            out.push_op(MATCH, n)
            return 0
        while True:
            if gf <= gb:
                gf += 1
                fw = _unit_step_fwd(sa, sb, fw)
            else:
                gb += 1
                bw = _unit_step_bwd(sa, sb, bw)
            # Overlap test: some diagonal where fronts meet or cross.
            meet = None
            for k, fi in fw.items():
                bi = bw.get(k)
                if bi is not None and fi >= bi:
                    meet = (k, fi)
                    break
            if meet is not None:
                k, fi = meet
                mid_i, mid_j = i0 + fi, j0 + (fi - k)
                mid_j = min(max(mid_j, j0), j1)
                if (mid_i, mid_j) in ((i0, j0), (i1, j1)):
                    # Degenerate split (meet at a corner): align this
                    # subproblem directly with stored fronts.
                    g, cig = DiagonalTransition(AffineCost.unit()).align(sa, sb)
                    out.append(cig)
                    return g
                g1 = self._dc_rec(a, b, i0, j0, mid_i, mid_j, out)
                g2 = self._dc_rec(a, b, mid_i, mid_j, i1, j1, out)
                return g1 + g2


def _unit_step_fwd(a: bytes, b: bytes, front: dict) -> dict:
    n, m = len(a), len(b)
    out: dict = {}
    for k in set(
        kk + d for kk in front for d in (-1, 0, 1)
    ):
        v = max(
            front.get(k, NEG) + 1,
            front.get(k - 1, NEG) + 1,
            front.get(k + 1, NEG),
        )
        j = v - k
        if v > NEG and 0 <= v <= n and 0 <= j <= m:
            out[k] = _extend(a, b, v, k)
    return out


def _rextend(a: bytes, b: bytes, i: int, k: int) -> int:
    """Greedy backward extension: smallest i' on diagonal k with
    a[i'..i) == b[i'-k..i-k)."""
    j = i - k
    while i > 0 and j > 0 and a[i - 1] == b[j - 1]:
        i -= 1
        j -= 1
    return i


def _unit_step_bwd(a: bytes, b: bytes, front: dict) -> dict:
    n, m = len(a), len(b)
    out: dict = {}
    POS = 1 << 30
    for k in set(kk + d for kk in front for d in (-1, 0, 1)):
        v = min(
            front.get(k, POS) - 1,
            front.get(k + 1, POS) - 1,
            front.get(k - 1, POS),
        )
        j = v - k
        if v < POS and 0 <= v <= n and 0 <= j <= m:
            out[k] = _rextend(a, b, v, k)
    return out
