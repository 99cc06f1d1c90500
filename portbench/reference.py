"""The benchmark's plain reference: edit distances and a CIGAR checker.

``banded_distances`` is the textbook unit-cost DP (Levenshtein), computed
anti-diagonal by anti-diagonal in plain PyTorch for a group of pairs at
once, restricted to a band of diagonals ``j - i``.  Given an upper bound
``U`` on a pair's distance (the generator applied at most ``U`` edits), any
alignment of cost at most ``U`` from diagonal 0 to diagonal ``m - n`` stays
within the diagonals of :func:`certified_band`; the DP over that band is
therefore exact, and no narrower band is ever assumed.

``check_cigar`` replays a CIGAR string over the two sequences in NumPy.

This module imports nothing of the program under test and takes nothing it
made: it gets the generated bytes only.
"""

from __future__ import annotations

import re

import numpy as np
import torch

#: Anti-diagonals a CUDA graph of the reference runs in one replay (even,
#: so that every block starts on the same parity).
GRAPH_STEPS = 128

#: The code of every position outside a sequence: no base, and equal in
#: both sequences, so the cells left of and above the matrix keep
#: ``D = |j - i|``.
_PAD = 4


def certified_band(n: int, m: int, bound: int) -> tuple[int, int]:
    """The diagonals ``[lo, hi]`` (``j - i``) holding every alignment of
    cost at most ``bound``: reaching diagonal ``d`` and ending on ``m - n``
    costs at least ``|d| + |d - (m - n)|``."""
    delta = m - n
    if abs(delta) > bound:
        raise ValueError(f"distance bound {bound} below the length gap {delta}")
    return -((bound - delta) // 2) - 1, (bound + delta + 1) // 2 + 1


def fixed_band(n: int, m: int, half: int) -> tuple[int, int]:
    """An uncertified band: ``half`` diagonals either side of the straight
    diagonals from 0 to ``m - n`` (the control's band)."""
    delta = m - n
    return min(0, delta) - half, max(0, delta) + half


def banded_distances(pairs, bands, device, per_pair: bool = False) -> np.ndarray:
    """Unit-cost edit distance of each pair ``(a, b)`` (bytes) over the
    diagonals of its band ``(lo, hi)``.  The group runs the union of the
    bands; ``per_pair`` also bars each pair from the cells outside its
    own band.  Returns int64 distances.

    The DP runs on differences: each cell of anti-diagonal ``k`` keeps
    ``h = D[i][j] - D[i][j-1]`` and ``v = D[i][j] - D[i-1][j]``, each -1, 0
    or 1, in int8, and a cell's step ``z = D[i][j] - D[i-1][j-1]`` is 1 just
    where its bases differ and neither neighbour's difference is -1.  A cell
    outside the band holds ``h = v = 1``, so no step comes through it.  Cells
    left of or above the matrix hold ``D = |j - i|``, which the recurrence
    keeps where the bases before both sequences are equal.  A pair's
    distance is ``|m - n|`` plus the steps along its end diagonal."""
    P = len(pairs)
    n = np.array([len(a) for a, _ in pairs], dtype=np.int64)
    m = np.array([len(b) for _, b in pairs], dtype=np.int64)
    lo = np.array([b[0] for b in bands], dtype=np.int64)
    hi = np.array([b[1] for b in bands], dtype=np.int64)
    if ((lo > 0) | (hi < 0) | (m - n < lo) | (m - n > hi)).any():
        raise ValueError("a band must hold diagonal 0 and the pair's end diagonal")
    dlo, dhi = int(lo.min()), int(hi.max())
    E = (dhi - dlo) // 2 + 1          # cells of one parity in [dlo, dhi]
    G = dhi - dlo + 4                 # pad margin around each sequence
    La, Lb = 2 * G + int(n.max()), 2 * G + int(m.max())
    A = np.full((P, La), _PAD, dtype=np.uint8)
    B = np.full((P, Lb), _PAD, dtype=np.uint8)
    for p, (a, b) in enumerate(pairs):
        A[p, G:G + len(a)] = np.frombuffer(a, dtype=np.uint8)
        B[p, G:G + len(b)] = np.frombuffer(b, dtype=np.uint8)
    # Along an anti-diagonal i falls as j rises: read a reversed.  Every
    # array keeps the pair axis innermost, so that each step reads and
    # writes whole rows.
    Ar = torch.from_numpy(np.ascontiguousarray(A[:, ::-1].T)).to(device)
    Bt = torch.from_numpy(np.ascontiguousarray(B.T)).to(device)

    def parity_start(k: int) -> int:
        return dlo if (k - dlo) % 2 == 0 else dlo + 1

    starts = (dlo, dlo + 1)
    masks = None
    if per_pair:
        masks = {}
        for d0 in starts:
            d = d0 + 2 * np.arange(E)[:, None]
            masks[d0] = torch.from_numpy(~((d >= lo[None, :]) & (d <= hi[None, :]))).to(device)
    # Pair p's end diagonal m - n is cell e of the anti-diagonals that
    # start on its parity: the steps there add up in acc[d0].
    delta = m - n
    cls = {d0: np.flatnonzero((delta - d0) % 2 == 0) for d0 in starts}
    take = {d0: torch.from_numpy((delta[ps] - d0) // 2 * P + ps).to(device)
            for d0, ps in cls.items() if len(ps)}
    acc = {d0: torch.zeros(len(cls[d0]), dtype=torch.int32, device=device) for d0 in take}
    ends: dict[int, list[int]] = {}
    for p in range(P):
        ends.setdefault(int(n[p] + m[p]), []).append(p)
    end_at = {}
    for k, ps in ends.items():
        d0 = parity_start(k)
        end_at[k] = (d0, torch.tensor(ps, device=device),
                     torch.from_numpy(np.searchsorted(cls[d0], ps)).to(device))
    base = torch.from_numpy(np.abs(delta)).to(device=device, dtype=torch.int32)
    out = torch.zeros((P,), dtype=torch.int32, device=device)

    # h and v of anti-diagonal k - 1 (index 1) and k (index 0), with a pad
    # cell holding 1 at each end; cell e of anti-diagonal k is diagonal
    # parity_start(k) + 2 e.  Anti-diagonal 0 lies left of and above the
    # matrix but for cell (0, 0).
    h = [torch.ones((E + 2, P), dtype=torch.int8, device=device) for _ in range(2)]
    v = [torch.ones((E + 2, P), dtype=torch.int8, device=device) for _ in range(2)]
    d = torch.arange(parity_start(0), parity_start(0) + 2 * E, 2, device=device)
    h[1][1:E + 1] = torch.where(d >= 1, 1, -1).to(torch.int8)[:, None]
    v[1][1:E + 1] = torch.where(d <= -1, 1, -1).to(torch.int8)[:, None]
    if masks is not None:
        h[1][1:E + 1].masked_fill_(masks[parity_start(0)], 1)
        v[1][1:E + 1].masked_fill_(masks[parity_start(0)], 1)

    def a_at(k: int) -> int:     # where anti-diagonal k's bases of a start in Ar
        return La - G - (k - parity_start(k)) // 2

    def b_at(k: int) -> int:     # and its bases of b in Bt
        return G + (k + parity_start(k)) // 2 - 1

    def step(k: int, a_src, a_off: int, b_src, b_off: int) -> None:
        hp, vp, hn, vn = h[1], v[1], h[0], v[0]
        d0 = parity_start(k)
        # x from (i - 1, j), diagonal d + 1 of k - 1; y from (i, j - 1), d - 1.
        s = 1 if d0 == dlo + 1 else 0
        x, y = hp[s + 1:s + E + 1], vp[s:s + E]
        neq = a_src[a_off:a_off + E] != b_src[b_off:b_off + E]
        z = torch.empty((E, P), dtype=torch.int8, device=device)
        torch.logical_and(torch.minimum(x, y).ge_(0), neq, out=z)
        torch.sub(z, y, out=hn[1:E + 1])
        torch.sub(z, x, out=vn[1:E + 1])
        if masks is not None:
            hn[1:E + 1].masked_fill_(masks[d0], 1)
            vn[1:E + 1].masked_fill_(masks[d0], 1)
        if d0 in take:
            acc[d0].add_(torch.take(z, take[d0]))
        h.reverse()
        v.reverse()

    def read_ends(k: int) -> None:
        if k in end_at:
            d0, ps, at = end_at[k]
            out[ps] = base[ps] + (acc[d0][at] if d0 in acc else 0)

    read_ends(0)
    k, last = 1, int((n + m).max())
    # On the card, blocks of GRAPH_STEPS anti-diagonals before the first
    # pair ends replay one CUDA graph of the same steps: the bases they
    # read are copied into fixed buffers first, at the same offsets for
    # every block (each block starts on the same parity).
    first_end = int((n + m).min())
    T = GRAPH_STEPS
    if torch.device(device).type == "cuda" and first_end > 4 * T:
        step(k, Ar, a_at(k), Bt, b_at(k))
        k += 1
        a_lo = [a_at(k + t) for t in range(T)]
        b_lo = [b_at(k + t) for t in range(T)]
        a_buf = torch.empty((a_lo[0] - a_lo[-1] + E, P), dtype=torch.uint8, device=device)
        b_buf = torch.empty((b_lo[-1] - b_lo[0] + E, P), dtype=torch.uint8, device=device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for t in range(T):
                step(k + t, a_buf, a_lo[t] - a_lo[-1], b_buf, b_lo[t] - b_lo[0])
        while k + T <= first_end:
            lo_a, lo_b = a_at(k + T - 1), b_at(k)
            a_buf.copy_(Ar[lo_a:lo_a + a_buf.shape[0]])
            b_buf.copy_(Bt[lo_b:lo_b + b_buf.shape[0]])
            graph.replay()
            k += T
        torch.cuda.synchronize(device)
        del graph
    for k in range(k, last + 1):
        step(k, Ar, a_at(k), Bt, b_at(k))
        read_ends(k)
    return out.cpu().numpy().astype(np.int64)


def reference_distances(pairs, bound: int, device, group_cells: int = 1 << 24) -> np.ndarray:
    """Exact edit distances of pairs that are each at most ``bound`` edits
    apart, over their certified bands, in groups of at most about
    ``group_cells`` cells an anti-diagonal."""
    return _grouped(pairs, [certified_band(len(a), len(b), bound) for a, b in pairs],
                    device, False, group_cells)


def control_distances(pairs, half: int, device, group_cells: int = 1 << 24) -> np.ndarray:
    """The control: the same DP over a fixed band of ``half`` diagonals
    each side, not certified, so its distances may come out too high."""
    return _grouped(pairs, [fixed_band(len(a), len(b), half) for a, b in pairs],
                    device, True, group_cells)


def _grouped(pairs, bands, device, per_pair: bool, group_cells: int) -> np.ndarray:
    width = max(hi - lo for lo, hi in bands) // 2 + 1
    step = max(1, group_cells // width)
    out = [banded_distances(pairs[i:i + step], bands[i:i + step], device, per_pair)
           for i in range(0, len(pairs), step)]
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


_RUN = re.compile(r"([1-9][0-9]*)([=XID])")
_OPS = {"=": 0, "X": 1, "I": 2, "D": 3}


def check_cigar(cigar: str, a: bytes, b: bytes) -> int | None:
    """The cost of the alignment of ``a`` and ``b`` that ``cigar`` spells,
    or None where it spells none: a run that does not parse, a length that
    does not add up, an ``=`` over different bases or an ``X`` over equal
    ones.  ``I`` consumes ``b``, ``D`` consumes ``a``."""
    runs = _RUN.findall(cigar)
    if sum(len(c) + 1 for c, _ in runs) != len(cigar):
        return None
    cnt = np.array([int(c) for c, _ in runs], dtype=np.int64)
    op = np.array([_OPS[o] for _, o in runs], dtype=np.int8)
    use_a = np.where(op != 2, cnt, 0)
    use_b = np.where(op != 3, cnt, 0)
    if use_a.sum() != len(a) or use_b.sum() != len(b):
        return None
    at_a = np.cumsum(use_a) - use_a
    at_b = np.cumsum(use_b) - use_b
    A = np.frombuffer(a, dtype=np.uint8)
    B = np.frombuffer(b, dtype=np.uint8)
    for code, want_equal in ((0, True), (1, False)):
        sel = op == code
        c = cnt[sel]
        if not len(c):
            continue
        run_start = np.cumsum(c) - c
        step = np.arange(int(c.sum())) - np.repeat(run_start, c)
        same = A[np.repeat(at_a[sel], c) + step] == B[np.repeat(at_b[sel], c) + step]
        if not (same.all() if want_equal else not same.any()):
            return None
    return int(cnt[op != 0].sum())
