"""Bucket priority queue with O(1) global shifts.

Mirror of `astarpa/src/bucket_queue.rs`:

- :class:`BucketQueue`: a `list[list]` bucket sort keyed by f, with lazy
  memory reclaim of layers 10 below the current minimum
  (`bucket_queue.rs:27-85`).
- :class:`ShiftQueue`: adds a global ``down_shift`` that is *decreased* when
  pruning raises h below the search tip, so all queued elements effectively
  shift up by the same amount in O(1) (`bucket_queue.rs:111-229`).  The
  reference's optional tip buffer is off by default
  (`astarpa/src/config.rs:14`) and not implemented here; without it a shift
  applies only when the pruned position dominates every pushed position
  (tracked as the running order max).

Orders are totally ordered ints for SH (position ``i``) or component-wise
partially ordered ``(i, j)`` tuples for CSH/GCSH (`heuristic.rs:63-103`).
"""

from __future__ import annotations

_CLEAR_DELAY = 10


class BucketQueue:
    """f-keyed bucket heap; pops are LIFO within a bucket."""

    __slots__ = ("layers", "next", "next_clear", "size")

    def __init__(self):
        self.layers: list[list] = []
        self.next = 0
        self.next_clear = 0
        self.size = 0

    def push(self, f: int, data) -> None:
        assert f >= 0
        while len(self.layers) <= f:
            self.layers.append([])
        if f < self.next:
            self.next = f
        self.layers[f].append(data)
        self.size += 1

    def pop(self):
        if self.size == 0:
            return None
        while not self.layers[self.next]:
            self.next += 1
            # Memory reclaim far below the minimum (`bucket_queue.rs:50-58`);
            # f never drops more than the max match distance (<= 2).
            while self.next_clear + _CLEAR_DELAY < self.next:
                assert not self.layers[self.next_clear]
                self.layers[self.next_clear] = []
                self.next_clear += 1
        f = self.next
        self.size -= 1
        data = self.layers[f].pop()
        if self.size == 0:
            self.next = 0
        return f, data


def order_leq(p, q) -> bool:
    """Partial order on shift orders: ints compare directly; tuples
    component-wise (the CSH `Pos` order, `heuristic.rs:78-89`)."""
    if isinstance(p, tuple):
        return p[0] <= q[0] and p[1] <= q[1]
    return p <= q


def order_max(p, q):
    if isinstance(p, tuple):
        return (max(p[0], q[0]), max(p[1], q[1]))
    return max(p, q)


class ShiftQueue:
    """Bucket queue whose elements can be shifted up en masse.

    ``down_shift`` starts at ``h(root)`` (the maximum total shift) and only
    decreases; stored keys are ``f + down_shift`` so decreasing the shift
    raises every stored element by the same amount.
    """

    __slots__ = ("queue", "tip_start", "down_shift", "missed", "pq_shifts")

    def __init__(self, max_shift: int, zero_order):
        self.queue = BucketQueue()
        self.tip_start = zero_order
        self.down_shift = max_shift
        self.missed = 0
        self.pq_shifts = 0

    def push(self, f: int, data, order) -> None:
        self.tip_start = order_max(self.tip_start, order)
        self.queue.push(f + self.down_shift, data)

    def pop(self):
        e = self.queue.pop()
        if e is None:
            return None
        f, data = e
        return f - self.down_shift, data

    def shift(self, shift: int, below) -> int:
        """Raise all queued f by ``shift``, valid only when every pushed
        order is <= ``below`` (`bucket_queue.rs:181-203`)."""
        if shift == 0:
            return 0
        if not order_leq(self.tip_start, below):
            self.missed += shift
            return 0
        assert shift <= self.down_shift
        self.down_shift -= shift
        self.pq_shifts += 1
        return shift
