"""The plain reference against a textbook DP, the control's band, and the
CIGAR checker against right and wrong CIGARs."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import reference, traffic


def textbook(a: bytes, b: bytes) -> np.ndarray:
    """The full unit-cost DP matrix, cell by cell."""
    D = np.zeros((len(a) + 1, len(b) + 1), dtype=np.int64)
    D[:, 0] = np.arange(len(a) + 1)
    D[0, :] = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                          D[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
    return D


def textbook_cigar(a: bytes, b: bytes) -> str:
    """An optimal CIGAR by a traceback of :func:`textbook`."""
    D = textbook(a, b)
    i, j, ops = len(a), len(b), []
    while i or j:
        if i and j and D[i, j] == D[i - 1, j - 1] + (a[i - 1] != b[j - 1]):
            ops.append("=" if a[i - 1] == b[j - 1] else "X")
            i, j = i - 1, j - 1
        elif i and D[i, j] == D[i - 1, j] + 1:
            ops.append("D")
            i -= 1
        else:
            ops.append("I")
            j -= 1
    runs, out = ops[::-1], []
    for op in runs:
        if out and out[-1][1] == op:
            out[-1][0] += 1
        else:
            out.append([1, op])
    return "".join(f"{c}{o}" for c, o in out)


def some_pairs(seed: int, count: int, n: int, e: float):
    return traffic.uniform_batch(traffic.rng_for(seed, 5), count, n, e)


@pytest.mark.parametrize("n,e", [(1, 1.0), (7, 0.5), (60, 0.2), (150, 0.05), (120, 0.3)])
def test_reference_equals_textbook(n, e):
    pairs, k = some_pairs(n, 12, n, e)
    want = [int(textbook(a, b)[-1, -1]) for a, b in pairs]
    assert reference.reference_distances(pairs, k, "cpu").tolist() == want


def test_reference_edge_pairs_and_groups():
    pairs = [(b"ACGT", b""), (b"", b"AC"), (b"AAAA", b"AAAA"), (b"ACGTACGT", b"TGCA"),
             (b"A", b"T"), (b"GATTACA", b"GCATGCT")]
    want = [int(textbook(a, b)[-1, -1]) for a, b in pairs]
    assert reference.reference_distances(pairs, 8, "cpu").tolist() == want
    # Groups of one pair give the same answers.
    assert reference.reference_distances(pairs, 8, "cpu", group_cells=1).tolist() == want


def test_band_needs_the_length_gap():
    with pytest.raises(ValueError):
        reference.certified_band(10, 20, 9)
    lo, hi = reference.certified_band(100, 104, 10)
    assert lo <= -3 and hi >= 7


def test_control_band_is_not_certified():
    """The control (a fixed band of 16 diagonals each side) reads too high
    on part of config #2's shape, and never below the reference."""
    pairs, k = some_pairs(1, 48, 10_000, 0.05)
    ref = reference.reference_distances(pairs, k, "cpu")
    ctl = reference.control_distances(pairs, 16, "cpu")
    assert (ctl >= ref).all()
    assert (ctl != ref).sum() > 0


def textbook_banded(a: bytes, b: bytes, lo: int, hi: int) -> int:
    """:func:`textbook` with the cells off diagonals ``lo..hi`` (``j - i``)
    barred."""
    big = 10**9
    D = np.full((len(a) + 1, len(b) + 1), big, dtype=np.int64)
    for i in range(len(a) + 1):
        for j in range(len(b) + 1):
            if not lo <= j - i <= hi:
                continue
            if i == 0 or j == 0:
                D[i, j] = i + j
                continue
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                          D[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
    return int(D[-1, -1])


@pytest.mark.parametrize("half", [0, 1, 3])
def test_control_equals_textbook_in_its_band(half):
    """Each pair of a group keeps to its own fixed band, whatever the
    others' end diagonals widen the group's to."""
    pairs, _ = some_pairs(20 + half, 10, 90, 0.25)
    pairs += [(b"ACGTACGTAC", b"ACG"), (b"GA", b"TTGACCA")]
    want = []
    for a, b in pairs:
        lo, hi = reference.fixed_band(len(a), len(b), half)
        want.append(textbook_banded(a, b, lo, hi))
    assert reference.control_distances(pairs, half, "cpu").tolist() == want


def test_check_cigar_accepts_right_cigars():
    pairs, _ = some_pairs(4, 10, 80, 0.2)
    pairs += [(b"", b"ACG"), (b"TT", b""), (b"", b"")]
    for a, b in pairs:
        cig = textbook_cigar(a, b)
        assert reference.check_cigar(cig, a, b) == textbook(a, b)[-1, -1]


@pytest.mark.parametrize("cigar", [
    "4=1X3=",       # right: the base
    "5=3=",         # = over the X
    "4=1=3=",       # = over the X, split
    "3=1X4=",       # a run off by one
    "4=1X2=",       # a base short
    "4=1X4=",       # a base long
    "4=1X3=1I",     # b a base long
    "4=1I1D3=",     # I and D where X is (a valid alignment at cost 2)
    "4=1X3",        # no op
    "4=0X1X3=",     # a zero count
    "4M1X3=",       # M is not spelt
    "4=1X3= ",      # trailing space
])
def test_check_cigar_refuses_wrong_ones(cigar):
    a, b = b"ACGTACGT", b"ACGTTCGT"
    got = reference.check_cigar(cigar, a, b)
    if cigar == "4=1X3=":
        assert got == 1
    elif cigar == "4=1I1D3=":
        assert got == 2
    else:
        assert got is None


@pytest.mark.cuda
def test_graph_blocks_equal_eager_steps_on_the_card(cuda, monkeypatch):
    """The card runs the anti-diagonals before the first pair ends as CUDA
    graph replays; they give what the eager steps and the CPU give."""
    pairs, k = some_pairs(9, 8, 20_000, 0.15)
    got = reference.reference_distances(pairs, k, "cuda")
    ctl = reference.control_distances(pairs, 16, "cuda")
    assert (got[:2] == reference.reference_distances(pairs[:2], k, "cpu")).all()
    monkeypatch.setattr(reference, "GRAPH_STEPS", 10**9)
    assert (got == reference.reference_distances(pairs, k, "cuda")).all()
    assert (ctl == reference.control_distances(pairs, 16, "cuda")).all()
    assert (ctl > got).any()
