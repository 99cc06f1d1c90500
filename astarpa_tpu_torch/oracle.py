"""Trivially-correct NumPy edit-distance oracle for tests.

The port's own copy of ``astarpa_tpu/oracle.py`` (numpy and the native
runtime, kept identical in behaviour).

Stand-in for the reference's `triple_accel::levenshtein_exp` oracle
(`pa-test/src/lib.rs:74`): a plain O(nm) row-DP Levenshtein, vectorized with
NumPy, plus a band-doubled variant for longer sequences.  Also provides an
oracle alignment (cost + CIGAR) via full DP + traceback for small inputs.
"""

from __future__ import annotations

import numpy as np

from .types import Cigar, CigarOp, Pos, seq_to_codes


def levenshtein(a: bytes, b: bytes) -> int:
    """Exact edit distance, O(nm) vectorized row DP."""
    ca, cb = seq_to_codes(a), seq_to_codes(b)
    n, m = len(ca), len(cb)
    if n == 0:
        return m
    if m == 0:
        return n
    # prev[j] = D[i][j] for j in 0..m
    prev = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        sub = prev[:-1] + (cb != ca[i - 1])
        # cur[j] = min(prev[j] + 1, sub[j-1], cur[j-1] + 1)
        cur = np.minimum(prev[1:] + 1, sub)
        # Prefix-min for the insertion dependency (cur[j-1] + 1):
        # cur[j] = min over k<=j of cur_nolocal[k] + (j - k); computed via
        # running minimum of cur[k] - k.
        run = np.minimum.accumulate(cur - np.arange(m, dtype=np.int32))
        cur = np.minimum(cur, run + np.arange(m, dtype=np.int32))
        cur = np.minimum(cur, i + 1 + np.arange(m, dtype=np.int32))  # from col 0
        prev = np.concatenate(([np.int32(i)], cur))
    return int(prev[-1])


def levenshtein_exp(a: bytes, b: bytes) -> int:
    """Exact edit distance with band doubling (fast for similar pairs)."""
    ca, cb = seq_to_codes(a), seq_to_codes(b)
    n, m = len(ca), len(cb)
    if n == 0:
        return m
    if m == 0:
        return n
    INF = np.int32(1 << 28)
    band = max(8, abs(n - m) + 1)
    while True:
        # D over rows i with |j - i*m/n|-ish band around the main diagonal;
        # simpler: full j-range but clip by threshold band around diagonal.
        prev = np.where(np.arange(m + 1) <= band, np.arange(m + 1), INF).astype(np.int32)
        for i in range(1, n + 1):
            sub = prev[:-1] + (cb != ca[i - 1])
            cur = np.minimum(prev[1:] + 1, sub)
            run = np.minimum.accumulate(
                np.where(cur < INF, cur, INF) - np.arange(m, dtype=np.int32)
            )
            cur = np.minimum(cur, run + np.arange(m, dtype=np.int32))
            first = np.int32(i) if i <= band else INF
            cur = np.minimum(cur, first + 1 + np.arange(m, dtype=np.int32))
            # Mask out-of-band cells.
            j = np.arange(1, m + 1)
            out = np.abs(j - i) > band
            cur = np.where(out, INF, cur)
            prev = np.concatenate(([first], cur))
        d = int(prev[-1])
        if d <= band:
            return d
        band *= 2


def align(a: bytes, b: bytes) -> tuple[int, Cigar]:
    """Full-DP alignment with the reference traceback preference order.

    Tie-break order matches `astarpa2/src/blocks/trace.rs:145-227`:
    greedy match first, then Ins (vertical), then Del (horizontal), then Sub.
    """
    ca, cb = seq_to_codes(a), seq_to_codes(b)
    n, m = len(ca), len(cb)
    D = np.zeros((n + 1, m + 1), dtype=np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        sub = D[i - 1, :-1] + (cb != ca[i - 1])
        cur = np.minimum(D[i - 1, 1:] + 1, sub)
        run = np.minimum.accumulate(cur - np.arange(m, dtype=np.int32))
        cur = np.minimum(cur, run + np.arange(m, dtype=np.int32))
        cur = np.minimum(cur, i + 1 + np.arange(m, dtype=np.int32))
        D[i, 1:] = cur

    # Traceback with reference tie-break order.
    ops: list[CigarOp] = []
    i, j = n, m
    while i > 0 or j > 0:
        # Greedy match.
        if i > 0 and j > 0 and ca[i - 1] == cb[j - 1] and D[i, j] == D[i - 1, j - 1]:
            ops.append(CigarOp.MATCH)
            i -= 1
            j -= 1
        elif j > 0 and D[i, j] == D[i, j - 1] + 1:
            ops.append(CigarOp.INS)
            j -= 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            ops.append(CigarOp.DEL)
            i -= 1
        else:
            assert i > 0 and j > 0 and D[i, j] == D[i - 1, j - 1] + 1
            ops.append(CigarOp.SUB)
            i -= 1
            j -= 1
    cigar = Cigar()
    for op in reversed(ops):
        cigar.push(op)
    return int(D[n, m]), cigar


def dp_matrix(a: bytes, b: bytes) -> np.ndarray:
    """The full (n+1) x (m+1) unit-cost DP matrix (for kernel self-checks)."""
    ca, cb = seq_to_codes(a), seq_to_codes(b)
    n, m = len(ca), len(cb)
    D = np.zeros((n + 1, m + 1), dtype=np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        sub = D[i - 1, :-1] + (cb != ca[i - 1])
        cur = np.minimum(D[i - 1, 1:] + 1, sub)
        run = np.minimum.accumulate(cur - np.arange(m, dtype=np.int32))
        cur = np.minimum(cur, run + np.arange(m, dtype=np.int32))
        cur = np.minimum(cur, i + 1 + np.arange(m, dtype=np.int32))
        D[i, 1:] = cur
    return D


def levenshtein_myers(a: bytes, b: bytes) -> int:
    """Exact distance via the native full-height Myers block backend
    (`native/astarpa_native.cpp::block_compute`): O(n*m/32) with no
    banding or heuristics, so it stays tractable at 500kbp+ where both
    the numpy DP and the A* oracle do not.  Falls back to
    :func:`levenshtein` when no native toolchain is available."""
    from . import native

    if not native.available() or not a or not b:
        return levenshtein(a, b)
    n, m = len(a), len(b)
    S = (m + 31) // 32
    bc = (np.frombuffer(b, np.uint8) >> 1) & 3
    codes = np.full(S * 32, 3, np.uint8)
    codes[:m] = bc
    shifts = np.arange(32, dtype=np.uint32)
    bits0 = ((codes & 1) ^ 1).astype(np.uint32).reshape(S, 32)
    bits1 = (((codes >> 1) & 1) ^ 1).astype(np.uint32).reshape(S, 32)
    pb0 = np.ascontiguousarray((bits0 << shifts).sum(axis=1, dtype=np.uint32))
    pb1 = np.ascontiguousarray((bits1 << shifts).sum(axis=1, dtype=np.uint32))
    ac = ((np.frombuffer(a, np.uint8) >> 1) & 3).astype(np.uint32)
    a0 = np.ascontiguousarray((np.uint32(0) - (ac & 1)).astype(np.uint32))
    a1 = np.ascontiguousarray(
        (np.uint32(0) - ((ac >> 1) & 1)).astype(np.uint32)
    )
    vp = np.full(S, 0xFFFFFFFF, np.uint32)
    vm = np.zeros(S, np.uint32)
    hp = np.ones(n, np.uint32)
    hm = np.zeros(n, np.uint32)
    native.block_compute(a0, a1, pb0, pb1, vp, vm, hp, hm)
    # D(n, m) from the FINAL COLUMN's vertical deltas masked to row m:
    # D(n, 0) = n, plus the first m v-bits.  Never read the padded bottom
    # row (S*32): pad char 0xFF 2-bit-encodes to code 3 == 'G', so pad
    # rows can MATCH real G's and the bottom-row horizontal deltas then
    # under-report the true distance (found by scripts/profile_direct.py:
    # 12/256 10kbp e=5% pairs off by one; regression test in
    # tests/test_extras.py).  The banded kernels are immune — they mask
    # every capture to row m.
    vpos = int(sum(
        bin(int(vp[w]) & ((1 << min(32, m - w * 32)) - 1)).count("1")
        for w in range((m + 31) // 32)
    ))
    vneg = int(sum(
        bin(int(vm[w]) & ((1 << min(32, m - w * 32)) - 1)).count("1")
        for w in range((m + 31) // 32)
    ))
    return int(n + vpos - vneg)
