"""Path heuristic: simulate pruning up-front along a known path.

The port's own copy of ``astarpa_tpu/experimental/path_pruning.py``.
Re-design of `astarpa-next/src/path_pruning.rs:15-74`: first compute an
optimal path with a fast aligner, then build the wrapped heuristic and
pre-prune every match starting on the path whose h-value is below the
remaining path cost — the pruning the A* run *would* do, done in advance.
The wrapped heuristic should have pruning disabled.

The path comes from the port's :mod:`..aligners.astarpa2` (the simple
preset); ``device`` is its ``AstarPa2Params.device``: where its torch block
DP runs when the native one does not (None = the card, or "cpu").  The
reference needs no such argument (its jnp block kernel runs on JAX's
default backend).

Prototype-grade, like the reference (not on the product path).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from ..types import Pos


@dataclass
class PathHeuristic:
    h: object  # inner heuristic factory (pruning disabled)
    device: object = None

    name = "Path"

    def build(self, a: bytes, b: bytes):
        return self.build_with_cost(a, b)[1]

    def build_with_cost(self, a: bytes, b: bytes):
        from ..aligners.astarpa2 import AstarPa2Params

        params = replace(AstarPa2Params.simple(), device=self.device)
        path_cost, cigar, _ = params.make_aligner(True).cost_or_align(a, b, True)
        # Cost remaining at each path position.
        path = cigar.to_path()
        costs = [0]
        for p, q in zip(path, path[1:]):
            step = 0 if (q.i - p.i, q.j - p.j) == (1, 1) and a[p.i] == b[p.j] else 1
            costs.append(costs[-1] + step)
        assert costs[-1] == path_cost
        cost_at = {p: c for p, c in zip(path, costs)}

        inst = self.h.build(a, b)
        # Pre-prune matches on the path whose h undershoots the remaining
        # path cost (`path_pruning.rs:44-58`).  Decisions go right-to-left
        # against the already-filtered structure (the reference filters
        # during right-to-left construction): pruning raises h for states
        # further left, so once h reaches path_cost - cost(pos) the
        # remaining on-path matches must be kept for admissibility.
        on_path = [
            m
            for m in inst.pruner
            if m.is_active() and m.start in cost_at
        ]
        on_path.sort(key=lambda m: (m.start.i, m.start.j), reverse=True)
        for m in on_path:
            remaining = path_cost - cost_at[m.start]
            hv = inst.h(m.start)
            assert hv <= remaining, (m.start, hv, remaining)
            if hv < remaining:
                m.prune()
                inst._rebuild_contours()
        return path_cost, inst
