"""Band-doubling Needleman-Wunsch over affine cost models.

The port's own copy of ``astarpa_tpu/base/nw_affine.py`` (numpy on the
host, the code kept identical).  Re-design of `pa-base-algos/src/nw.rs` +
`nw/affine.rs` (the reference-grade NW with pluggable affine fronts; the
bitpacked production variant lives in :mod:`astarpa_tpu_torch.aligners`).
One front per column holds the main layer M plus one value row per affine
layer; band doubling re-runs with doubled f_max until the target cost is
certified, mirroring `pa-base-algos/src/nw.rs:189-200` + `band.rs`
semantics.

This layer exists for cost-model generality (affine/double-affine/LCS) and
as a differential oracle; it is deliberately simple NumPy, not a kernel.
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

INF = (1 << 30)


class NwAffine:
    """Exact affine-cost global aligner with optional band doubling."""

    def __init__(self, cm: AffineCost, band_doubling: bool = True):
        self.cm = cm
        self.band_doubling = band_doubling

    # -- full DP ---------------------------------------------------------------

    def _dp(self, a: bytes, b: bytes, f_max: int | None):
        """Column DP restricted to |gap-bound| <= f_max; returns the cost
        matrices (M plus per-layer) or None values outside the band."""
        cm = self.cm
        n, m = len(a), len(b)
        L = cm.n_layers
        # M[i][j] and A[l][i][j]; dense here (reference-grade).
        M = np.full((n + 1, m + 1), INF, dtype=np.int64)
        A = np.full((L, n + 1, m + 1), INF, dtype=np.int64)
        M[0][0] = 0
        for j in range(1, m + 1):
            cands = [INF]
            if cm.ins is not None:
                cands.append(M[0][j - 1] + cm.ins)
            for l, lay in enumerate(cm.affine):
                if lay.affine_type.is_insert:
                    prev = min(A[l][0][j - 1], M[0][j - 1] + lay.open)
                    A[l][0][j] = prev + lay.extend
                    cands.append(A[l][0][j])
            M[0][j] = min(cands)
        for i in range(1, n + 1):
            if cm.delete is not None:
                M[i][0] = min(M[i - 1][0] + cm.delete, INF)
            for l, lay in enumerate(cm.affine):
                if lay.affine_type.is_delete:
                    prev = min(A[l][i - 1][0], M[i - 1][0] + lay.open)
                    A[l][i][0] = prev + lay.extend
                    M[i][0] = min(M[i][0], A[l][i][0])
            for j in range(1, m + 1):
                if f_max is not None and abs((i - j) - (n - m)) > f_max and abs(i - j) > f_max:
                    continue
                best = INF
                sc = cm.sub_cost(a[i - 1], b[j - 1])
                if sc is not None and M[i - 1][j - 1] < INF:
                    best = M[i - 1][j - 1] + sc
                if cm.ins is not None and M[i][j - 1] < INF:
                    best = min(best, M[i][j - 1] + cm.ins)
                if cm.delete is not None and M[i - 1][j] < INF:
                    best = min(best, M[i - 1][j] + cm.delete)
                for l, lay in enumerate(cm.affine):
                    if lay.affine_type.is_insert:
                        prev = min(A[l][i][j - 1], M[i][j - 1] + lay.open)
                    else:
                        prev = min(A[l][i - 1][j], M[i - 1][j] + lay.open)
                    if prev < INF:
                        A[l][i][j] = prev + lay.extend
                        best = min(best, A[l][i][j])
                M[i][j] = best
        return M, A

    def cost(self, a: bytes, b: bytes) -> int:
        return self.align(a, b)[0]

    def align(self, a: bytes, b: bytes) -> tuple[int, AffineCigar]:
        n, m = len(a), len(b)
        cm = self.cm
        if not self.band_doubling:
            M, A = self._dp(a, b, None)
            assert M[n][m] < INF
            return int(M[n][m]), self._trace(a, b, M, A)
        # Exponential search over the band bound (`band.rs:100-141` shape).
        f = max(1, abs(n - m) + 1)
        min_extend = min(
            x
            for x in (cm.ins, cm.delete, cm.min_ins_extend, cm.min_del_extend)
            if x is not None and x < INF
        )
        while True:
            M, A = self._dp(a, b, f)
            d = int(M[n][m])
            # Certified exact when any path of cost d cannot deviate past the
            # band: deviating x diagonals costs >= x * min_extend.
            if d < INF and d < f * min_extend:
                return d, self._trace(a, b, M, A)
            if f > n + m:
                assert d < INF
                return d, self._trace(a, b, M, A)
            f *= 2

    def _trace(self, a: bytes, b: bytes, M, A) -> AffineCigar:
        """Greedy parent walk, preferring matches (cf. `nw/affine.rs`
        traceback order)."""
        cm = self.cm
        i, j = len(a), len(b)
        layer = None
        rev: list = []
        while i > 0 or j > 0 or layer is not None:
            if layer is None:
                v = M[i][j]
                sc = cm.sub_cost(a[i - 1], b[j - 1]) if i > 0 and j > 0 else None
                if sc is not None and M[i - 1][j - 1] + sc == v:
                    rev.append(MATCH if a[i - 1] == b[j - 1] else SUB)
                    i -= 1
                    j -= 1
                    continue
                if cm.ins is not None and j > 0 and M[i][j - 1] + cm.ins == v:
                    rev.append(INS)
                    j -= 1
                    continue
                if cm.delete is not None and i > 0 and M[i - 1][j] + cm.delete == v:
                    rev.append(DEL)
                    i -= 1
                    continue
                hit = False
                for l in range(cm.n_layers):
                    if A[l][i][j] == v:
                        rev.append(affine_close(l))
                        layer = l
                        hit = True
                        break
                assert hit, f"no parent at ({i},{j})"
            else:
                lay = cm.affine[layer]
                v = A[layer][i][j]
                if lay.affine_type.is_insert:
                    pa, pm = A[layer][i][j - 1], M[i][j - 1]
                    rev.append(affine_ins(layer))
                    j -= 1
                else:
                    pa, pm = A[layer][i - 1][j], M[i - 1][j]
                    rev.append(affine_del(layer))
                    i -= 1
                if pm + lay.open + lay.extend == v:
                    rev.append(affine_open(layer))
                    layer = None
                else:
                    assert pa + lay.extend == v
        cigar = AffineCigar()
        for op in reversed(rev):
            cigar.push_op(op)
        return cigar
