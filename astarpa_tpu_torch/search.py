"""Semi-global pattern search: find a short pattern in a long text.

The port's own copy of ``astarpa_tpu/search.py`` (numpy on the host, the
code kept identical, on the port's :mod:`.ops.bitpack` and :mod:`.types`):
the search is a host utility with no device path, as in the reference.
Re-design of `pa-bitpacking/src/search.rs:46-229` (the only function the
reference exposes to Python, `pa_python/src/lib.rs:4-13`) on W=32 words:

- Free start anywhere along the text (top h diffs = 0) and a fractional
  ``unmatched_cost`` per skipped pattern character (cost bits seeded into
  the left column, `search.rs:56-66`).
- The pattern may contain wildcards: ``N``/``*`` match everything, ``Y``
  matches C/T, ``R`` matches A/G (the scatter profile,
  `profile.rs:25-75`); the text must be ACGT (case-insensitive).
- Output: costs along the bottom row then up the right column —
  ``len(text) + len(pattern) + 1`` values; entry ``idx`` is the cost of the
  best semi-global match ending there (plus the unmatched cost of the
  unused pattern suffix for right-column entries).
- ``SearchResult.trace(idx)`` re-fills an exponentially widened window and
  walks Match > Del > Ins > Sub parents to a semi-global CIGAR
  (`search.rs:125-229`).

Pattern rows are padded to a word multiple with match-everything rows, so
outputs simply shift around the bottom-right corner (same trick as the
reference's 64-char padding correction).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ops.bitpack import W, popcount32
from .types import Cigar, CigarOp, Pos

_ONES = np.uint32(0xFFFFFFFF)


def _code(c: int) -> int:
    return (c >> 1) & 3


def scatter_profile(pattern: bytes, num_words: int) -> np.ndarray:
    """(4, num_words) uint32 masks: bit j of plane c is set iff pattern row
    j matches text code c.  Padded rows match everything."""
    m = len(pattern)
    planes = np.zeros((4, num_words), dtype=np.uint32)
    matches_of = {
        ord("A"): (ord("A"),), ord("C"): (ord("C"),),
        ord("G"): (ord("G"),), ord("T"): (ord("T"),),
        ord("N"): (ord("A"), ord("C"), ord("G"), ord("T")),
        ord("*"): (ord("A"), ord("C"), ord("G"), ord("T")),
        ord("Y"): (ord("C"), ord("T")),
        ord("R"): (ord("A"), ord("G")),
    }
    for j, ch in enumerate(pattern.upper()):
        try:
            chars = matches_of[ch]
        except KeyError:
            raise ValueError(f"unsupported pattern char {chr(ch)!r}")
        for cc in chars:
            planes[_code(cc), j // W] |= np.uint32(1) << np.uint32(j % W)
    # Padding rows match everything (free diagonals shifting the outputs).
    for j in range(m, num_words * W):
        planes[:, j // W] |= np.uint32(1) << np.uint32(j % W)
    return planes


def _unmatched_v0(m: int, num_words: int, unmatched_cost: float) -> np.ndarray:
    """Left-column +bits: a fraction `unmatched_cost` of pattern rows cost 1
    (`search.rs:56-66`)."""
    assert 0.0 <= unmatched_cost <= 1.0
    vp0 = np.zeros(num_words, dtype=np.uint32)
    if unmatched_cost > 0.0:
        i = 0
        while True:
            idx = int(np.ceil(i / unmatched_cost))
            if idx >= m:
                break
            vp0[idx // W] |= np.uint32(1) << np.uint32(idx % W)
            i += 1
    return vp0


def _step_words(eq, vp, vm, hp0, hm0):
    """One column over all words, NumPy uint32 (host-side mirror of
    ops.myers.step_word chained through the words)."""
    nw = len(eq)
    out_vp = vp.copy()
    out_vm = vm.copy()
    hp, hm = np.uint32(hp0), np.uint32(hm0)
    with np.errstate(over="ignore"):
        for w in range(nw):
            eqw = eq[w]
            vpw, vmw = out_vp[w], out_vm[w]
            vx = eqw | vmw
            eq2 = eqw | hm
            hx = (((eq2 & vpw) + vpw) ^ vpw) | eq2
            hpo = vmw | ~(hx | vpw)
            hmo = vpw & hx
            hp_next = hpo >> np.uint32(W - 1)
            hm_next = hmo >> np.uint32(W - 1)
            hpo = (hpo << np.uint32(1)) | hp
            hmo = (hmo << np.uint32(1)) | hm
            out_vp[w] = hmo | ~(vx | hpo)
            out_vm[w] = hpo & vx
            hp, hm = hp_next, hm_next
    return out_vp, out_vm, int(hp), int(hm)


def _compute(eqs, vp, vm, free_top: bool, fill: bool):
    """Column loop (host NumPy; the search is a host-side utility).

    Returns (vp, vm, hp_out, hm_out[, vp_cols, vm_cols]).
    """
    hp0 = 0 if free_top else 1
    vp = np.asarray(vp, np.uint32).copy()
    vm = np.asarray(vm, np.uint32).copy()
    hp_out = np.zeros(len(eqs), np.uint32)
    hm_out = np.zeros(len(eqs), np.uint32)
    vp_cols = [] if fill else None
    vm_cols = [] if fill else None
    for i in range(len(eqs)):
        vp, vm, hp, hm = _step_words(eqs[i], vp, vm, hp0, 0)
        hp_out[i] = hp
        hm_out[i] = hm
        if fill:
            vp_cols.append(vp)
            vm_cols.append(vm)
    if fill:
        return (
            vp,
            vm,
            hp_out,
            hm_out,
            np.array(vp_cols, np.uint32).reshape(-1, len(vp)),
            np.array(vm_cols, np.uint32).reshape(-1, len(vp)),
        )
    return vp, vm, hp_out, hm_out


@dataclass
class SearchResult:
    out: list[int]
    pattern: bytes
    text: bytes
    _planes: np.ndarray
    _tcodes: np.ndarray
    _v0p: np.ndarray
    _padding: int

    def idx_to_pos(self, idx: int) -> Pos:
        """Map an output index to its matrix position (i=text, j=pattern)."""
        assert 0 <= idx < len(self.out)
        n, m = len(self.text), len(self.pattern)
        if idx <= n:
            return Pos(idx, m)
        return Pos(n, m - (idx - n))

    def _is_match(self, i: int, j: int) -> bool:
        return bool(
            (self._planes[self._tcodes[i], j // W] >> np.uint32(j % W)) & 1
        )

    def trace(self, idx: int) -> tuple[Cigar, list[Pos]]:
        """Semi-global CIGAR of the match ending at output ``idx``
        (`search.rs:125-229`): re-fill an exponentially widened window and
        walk Match > Del > Ins > Sub parents until the top or left edge.
        """
        pos = self.idx_to_pos(idx)
        m = len(self.pattern)
        nw = self._planes.shape[1]
        target = self.out[idx]
        if pos.i == len(self.text):
            # Remove the unused-pattern-suffix cost from right-column entries.
            target -= _suffix_value(self._v0p, pos.j, m)

        width = max(2 * m, 1)
        end = pos.i
        while True:
            start = max(0, end - width)
            if start == 0:
                vp = self._v0p.copy()
            else:
                vp = np.full(nw, _ONES, np.uint32)
            vm = np.zeros(nw, np.uint32)
            eqs = self._planes[self._tcodes[start:end]]
            # Semi-global: the top edge is free everywhere, even mid-window.
            _, _, _, _, vp_cols, vm_cols = _compute(eqs, vp, vm, True, fill=True)
            vp_cols = np.concatenate([vp[None], np.asarray(vp_cols)], axis=0)
            vm_cols = np.concatenate([vm[None] * 0, np.asarray(vm_cols)], axis=0)

            def cost(p: Pos) -> int:
                return _prefix_value(vp_cols[p.i - start], vm_cols[p.i - start], p.j)

            got = cost(Pos(end, pos.j))
            assert got >= target, f"trace found cheaper path: {got} < {target}"
            if got == target:
                break
            if start == 0:
                raise AssertionError("trace did not reach the target cost")
            width *= 2

        cigar = Cigar()
        poss = [pos]
        g = target
        p = pos
        while p.i > start and p.j > 0:
            cnt = 0
            while p.i > start and p.j > 0 and self._is_match(p.i - 1, p.j - 1):
                cnt += 1
                p = Pos(p.i - 1, p.j - 1)
                poss.append(p)
            if cnt:
                cigar.push(CigarOp.MATCH, cnt)
                continue
            if cost(Pos(p.i - 1, p.j)) == g - 1:
                g -= 1
                p = Pos(p.i - 1, p.j)
                poss.append(p)
                cigar.push(CigarOp.DEL)
                continue
            if cost(Pos(p.i, p.j - 1)) == g - 1:
                g -= 1
                p = Pos(p.i, p.j - 1)
                poss.append(p)
                cigar.push(CigarOp.INS)
                continue
            if cost(Pos(p.i - 1, p.j - 1)) == g - 1:
                g -= 1
                p = Pos(p.i - 1, p.j - 1)
                poss.append(p)
                cigar.push(CigarOp.SUB)
                continue
            raise AssertionError(f"bad trace: stuck at {p}")
        assert p.i == 0 or g == 0, f"trace stopped at {p} with g={g}"
        cigar.reverse()
        poss.reverse()
        return cigar, poss


def _prefix_value(vp, vm, j: int) -> int:
    """Sum of v diffs of rows [0, j)."""
    full = np.clip(j - np.arange(len(vp)) * W, 0, W).astype(np.uint32)
    mask = np.where(full >= W, _ONES, (np.uint32(1) << full) - np.uint32(1))
    return int((popcount32(vp & mask) - popcount32(vm & mask)).sum())


def _suffix_value(vp, j: int, m: int) -> int:
    """Sum of +bits of rows [j, m)."""
    idx = np.arange(len(vp)) * W
    lo = np.clip(j - idx, 0, W).astype(np.uint32)
    hi = np.clip(m - idx, 0, W).astype(np.uint32)
    mask = np.where(hi >= W, _ONES, (np.uint32(1) << hi) - np.uint32(1)) & ~(
        np.where(lo >= W, _ONES, (np.uint32(1) << lo) - np.uint32(1))
    )
    return int(popcount32(vp & mask).sum())


def search(pattern: bytes, text: bytes, unmatched_cost: float = 0.0) -> SearchResult:
    """Search ``pattern`` in ``text`` semi-globally (`search.rs:46-110`).

    Returns a :class:`SearchResult` whose ``out[idx]`` is the best cost of a
    match ending at the bottom row (idx 0..len(text)) or right column
    (idx len(text)+1.. — plus the unmatched cost of the unused pattern
    suffix), and which can :meth:`~SearchResult.trace` any index.
    """
    text = text.upper()
    m = len(pattern)
    nw = max(1, -(-m // W))
    padding = nw * W - m
    planes = scatter_profile(pattern, nw)
    tcodes = np.frombuffer(text, dtype=np.uint8)
    tcodes = ((tcodes >> 1) & 3).astype(np.int64)
    vp0 = _unmatched_v0(m, nw, unmatched_cost)
    vm0 = np.zeros(nw, np.uint32)

    bot_left = int(popcount32(vp0).sum())
    eqs = planes[tcodes]
    vp, vm, hp_out, hm_out = (np.asarray(x) for x in _compute(eqs, vp0, vm0, True, False))

    out = [bot_left]
    b = bot_left
    skipped = 0
    for hp, hm in zip(hp_out.tolist(), hm_out.tolist()):
        b += (hp & 1) - (hm & 1)
        if skipped < padding:
            skipped += 1
        else:
            out.append(b)
    # Up the right column; correct padded rows and re-add unmatched costs
    # (`search.rs:84-99`).
    for w in range(nw - 1, -1, -1):
        for j in range(1, W + 1):
            delta = _suffix_value_word(vp[w], vm[w], j)
            unmatched = _suffix_value_word(vp0[w], 0, j)
            val = b - delta + unmatched
            if skipped < padding:
                skipped += 1
            else:
                out.append(val)
        b -= int(popcount32(vp[w : w + 1]).sum()) - int(popcount32(vm[w : w + 1]).sum())
        b += int(popcount32(vp0[w : w + 1]).sum())
    assert len(out) == len(text) + m + 1
    return SearchResult(out, bytes(pattern), bytes(text), planes, tcodes, vp0, padding)


def _suffix_value_word(vp, vm, j: int) -> int:
    """Value of the last j bits of one word, 0 < j <= W."""
    mask = np.uint32(((1 << j) - 1) << (W - j)) if j < W else _ONES
    return int(popcount32(np.uint32(vp) & mask)) - int(
        popcount32(np.uint32(vm) & mask)
    )
