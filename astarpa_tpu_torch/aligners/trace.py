"""Traceback: DT-trace fast path + block-refill parent stepping.

Mirror of `astarpa2/src/blocks/trace.rs`.  CIGAR parity depends on the exact
preference order, reproduced here:

- `parent` (`trace.rs:145-227`): greedy match run first, then Ins (vertical
  +1 delta), then Del (horizontal), then Sub.
- DT-trace (`trace.rs:231-416`): backward greedy diagonal-transition burst
  bounded by ``max_g`` with x-drop ``fr_drop``; parent priority comes from
  the expansion order Del(d-1 update first? see `trace.rs:351-364`): for
  each diagonal, updates are applied in order (d-1 <- Del), (d <- Sub),
  (d+1 <- Ins), each only improving strictly smaller ``i``, which gives the
  same op preference as the reference.

The port's copy of ``astarpa_tpu/aligners/trace.py``.
"""

from __future__ import annotations

import numpy as np

from ..types import Cigar, CigarElem, CigarOp, Pos, seq_to_codes
from .block import Blocks, round_out


INF = 1 << 30


def trace(blocks: Blocks, a: bytes, b: bytes, from_pos: Pos, to: Pos, params) -> Cigar:
    """Trace the path from ``from_pos`` to ``to`` (`trace.rs:21-135`)."""
    assert blocks.trace
    assert blocks.blocks[blocks.last_block_idx].i_range[1] == to.i
    ca = seq_to_codes(a)
    cb = seq_to_codes(b)
    cigar = Cigar()
    g = blocks.blocks[blocks.last_block_idx].index(to.j)

    while to != from_pos:
        # Remove blocks to the right of `to`.
        while blocks.last_block_idx > 0 and blocks.blocks[blocks.last_block_idx].i_range[0] >= to.i:
            blocks.pop_last_block()

        # DT-trace fast path.
        if params.dt_trace and to.i > 0:
            prev_block = blocks.blocks[blocks.last_block_idx - 1]
            if prev_block.i_range[1] < to.i - 1:
                result = _dt_trace_block(blocks, ca, cb, to, g, prev_block, cigar, params)
                if result is not None:
                    to, g = result
                    continue

        #

        # Fill missing columns by recomputing the block, storing all columns.
        if to.i > 0:
            block = blocks.blocks[blocks.last_block_idx]
            prev_block = blocks.blocks[blocks.last_block_idx - 1]
            assert prev_block.i_range[1] < to.i <= block.i_range[1]
            if prev_block.i_range[1] < to.i - 1 or block.i_range[1] > to.i:
                prev_j_range = prev_block.j_range
                i_range = (prev_block.i_range[1], to.i)
                j_range = (block.j_range[0], to.j)
                blocks.pop_last_block()
                # Exponential search for a sufficient block height
                # (`trace.rs:94-122`).
                height = min(j_range[1] - j_range[0], (i_range[1] - i_range[0]) * 5 // 4)
                while True:
                    jr = round_out((max(j_range[1] - height, prev_j_range[0]), j_range[1]))
                    blocks.fill_with_blocks(i_range, jr)
                    if blocks.blocks[blocks.last_block_idx].index(to.j) == g:
                        break
                    assert jr[0] != 0, f"No trace found through block {i_range} {jr}"
                    for _ in range(i_range[0], i_range[1]):
                        blocks.pop_last_block()
                    height *= 2

        to, elem, g = _parent(blocks, ca, cb, to, g)
        cigar.push_elem(elem)
    assert g == 0
    cigar.reverse()
    return cigar


def _parent(blocks: Blocks, ca, cb, st: Pos, g: int):
    """Find the parent of ``st`` (`trace.rs:145-227`).

    Preference: greedy match > Ins (vertical) > Del (horizontal) > Sub.
    """
    block = blocks.blocks[blocks.last_block_idx]
    assert block.i_range[1] == st.i, f"Parent of {st} but block.i is {block.i_range}"

    # Greedy matching.
    i, j = st
    cnt = 0
    while i > 0 and j > 0 and ca[i - 1] == cb[j - 1]:
        cnt += 1
        i -= 1
        j -= 1
    if cnt > 0:
        return Pos(i, j), CigarElem(CigarOp.MATCH, cnt), g

    # Vertical delta (insert) first: needs only a single delta bit.
    vd = block.get_diff(st.j - 1)
    if vd == 1:
        return Pos(st.i, st.j - 1), CigarElem(CigarOp.INS, 1), g - 1

    prev_block = blocks.blocks[blocks.last_block_idx - 1]
    assert prev_block.i_range[1] == st.i - 1

    # Horizontal delta (delete). Edge case: above the start of the previous
    # block (because of greedy matching) -> always go left.
    if st.j < prev_block.j_range[0]:
        hd = 1
    else:
        hd = g - prev_block.index(st.j)
    if hd == 1:
        return Pos(st.i - 1, st.j), CigarElem(CigarOp.DEL, 1), g - 1

    # Diagonal delta (substitution). Edge case: entering the previous block
    # exactly in the bottom-most row.
    if st.j > prev_block.j_range[1]:
        assert st.j == prev_block.j_range[1] + 1
        dd = 1
    else:
        dd = prev_block.get_diff(st.j - 1) + hd
    if dd == 1:
        return Pos(st.i - 1, st.j - 1), CigarElem(CigarOp.SUB, 1), g - 1

    raise AssertionError(f"Parent of {st} not found in traceback")


def _extend_left(i: int, i0: int, j: int, ca, cb) -> tuple[int, int, int]:
    """Greedy backward extension; returns (new_i, new_j, count)
    (`trace.rs:443-500`, vectorized instead of 8-byte SIMD loads)."""
    max_len = min(i - i0, j)
    if max_len <= 0:
        return i, j, 0
    av = ca[i - max_len : i]
    bv = cb[j - max_len : j]
    neq = av != bv
    nz = np.nonzero(neq)[0]
    cnt = max_len if len(nz) == 0 else max_len - 1 - int(nz[-1])
    return i - cnt, j - cnt, cnt


def _dt_trace_block(blocks: Blocks, ca, cb, st: Pos, g_st: int, prev_block, cigar: Cigar, params):
    """Backward greedy diagonal-transition burst (`trace.rs:231-416`).

    Walks back from ``st`` to the right edge of ``prev_block``; returns the
    new (pos, g) on success, None to fall back to the fill-based trace.
    """
    block_start = prev_block.i_range[1]
    # fr[(g, d)] = (leftmost reachable column i, ext, parent_d).
    elems: dict[tuple[int, int], list] = {}

    def get(g, d):
        return elems.get((g, d), [INF, 0, 0])

    def extend_and_check(elem, j, target_g):
        i, j2, cnt = _extend_left(elem[0], block_start, j, ca, cb)
        elem[0] = i
        elem[1] += cnt
        return i == block_start and prev_block.get(j2) == target_g

    def do_trace(g, d):
        new_st = Pos(block_start, st.j - (st.i - block_start) - d)
        gg, dd = g, d
        ops = []
        while True:
            fr = get(gg, dd)
            if fr[1] > 0:
                ops.append(CigarElem(CigarOp.MATCH, fr[1]))
            if gg == 0:
                break
            gg -= 1
            dd += fr[2]
            op = {-1: CigarOp.INS, 0: CigarOp.SUB, 1: CigarOp.DEL}[fr[2]]
            ops.append(CigarElem(op, 1))
        for e in reversed(ops):
            cigar.push_elem(e)
        return new_st, g_st - g

    elems[(0, 0)] = [st.i, 0, 0]
    if extend_and_check(elems[(0, 0)], st.j, g_st):
        return do_trace(0, 0)

    g = 0
    d_lo, d_hi = 0, 0
    while True:
        ng = g + 1
        for d in range(d_lo - 1, d_hi + 2):
            elems[(ng, d)] = [INF, 0, 0]

        # EXPAND: updates applied in Del, Sub, Ins order per source diagonal,
        # each strictly improving (`trace.rs:351-364`).
        for d in range(d_lo, d_hi + 1):
            fr = get(g, d)
            if fr[0] == INF:
                continue

            def update(gd, y, pd):
                x = elems[gd]
                if y < x[0]:
                    x[0] = y
                    x[2] = pd
            update((ng, d - 1), fr[0] - 1, 1)
            update((ng, d), fr[0] - 1, 0)
            update((ng, d + 1), fr[0], -1)
        g += 1
        d_lo -= 1
        d_hi += 1

        # EXTEND.
        min_fr = INF
        min_i = INF
        for d in range(d_lo, d_hi + 1):
            fr = elems[(g, d)]
            if fr[0] == INF:
                continue
            j = st.j - (st.i - fr[0]) - d
            if extend_and_check(fr, j, g_st - g):
                return do_trace(g, d)
            min_fr = min(min_fr, 2 * fr[0] - d)
            min_i = min(min_i, fr[0])

        if g == params.max_g // 2 and min_i > (block_start + st.i) // 2:
            return None
        if g == params.max_g:
            return None

        # Shrink diagonals more than fr_drop behind (`trace.rs:396-414`).
        if params.fr_drop > 0:
            while d_lo < d_hi and (
                get(g, d_lo)[0] <= block_start
                or 2 * get(g, d_lo)[0] - d_lo > min_fr + params.fr_drop
            ):
                d_lo += 1
            while d_lo < d_hi and (
                get(g, d_hi)[0] <= block_start
                or 2 * get(g, d_hi)[0] - d_hi > min_fr + params.fr_drop
            ):
                d_hi -= 1
            if d_lo > d_hi:
                return None
