"""The benchmark's pair generator: the same seed gives the same bytes,
every seed the same pairs in another order, and the pairs follow the
uniform edit model."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import reference, traffic

CFG = {"pair_bp": 300, "error_rate": 0.1, "batch_pairs": 20, "pair_seeds": [7, 8, 9]}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -9])
def test_same_seed_same_bytes(seed):
    one = traffic.make_batches(seed, CFG)
    two = traffic.make_batches(seed, CFG)
    assert one == two
    assert len(one) == 3 and all(len(p) == 20 and k == 30 for p, k in one)
    # Distinct batches differ.
    assert one[0][0] != one[1][0]
    # Another seed: every batch holds the same pairs, in another order.
    other = traffic.make_batches(seed + 1, CFG)
    for (mine, k), (theirs, k2) in zip(one, other):
        assert sorted(mine) == sorted(theirs) and k == k2
    assert [p for p, _ in other] != [p for p, _ in one]


def test_bytes_do_not_depend_on_the_cores(monkeypatch):
    want = traffic.make_batches(11, CFG)
    monkeypatch.setattr(traffic.os, "cpu_count", lambda: 1)
    assert traffic.make_batches(11, CFG) == want


def test_edit_model_statistics():
    n, e = 2000, 0.15
    pairs, k = traffic.uniform_batch(traffic.rng_for(3, 0), 200, n, e)
    assert k == 300
    assert all(len(a) == n and set(a) <= set(b"ACGT") and set(b) <= set(b"ACGT")
               for a, b in pairs)
    gap = np.array([len(b) - len(a) for a, b in pairs])
    # k/3 insertions against k/3 deletions (a few fall on one position).
    assert abs(gap.mean()) < 6
    assert 8 < gap.std() < 20          # sqrt(2k/3) ~ 14
    # Bases of a: a quarter each.
    counts = np.bincount(np.frombuffer(b"".join(a for a, _ in pairs), np.uint8))[list(b"ACGT")]
    assert (abs(counts / counts.sum() - 0.25) < 0.01).all()
    # Every pair is at most k edits apart, and the edits do not cancel out:
    # ~11/12 of them change the sequence.
    d = reference.reference_distances(pairs[:40], k, "cpu")
    assert (d <= k).all()
    assert 0.75 * k < d.mean() < 0.95 * k
