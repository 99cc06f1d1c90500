"""Top-level single-pair API (mirror of `astarpa2/src/lib.rs:38-53` and
`astarpa/src/lib.rs:56-129`).

Counterpart of ``astarpa_tpu/api.py``.  The block aligners take
``device``: where their torch block DP runs when the native one is not
used (``ops.block_kernel.BlockKernel.use_native``), None = the card
(raising without one) or "cpu".  The A* entries are a search on the host
(:mod:`.astar`), as the reference's are.
"""

from __future__ import annotations

from dataclasses import replace

from .aligners.astarpa2 import AstarPa2Params
from .types import Cigar


def _block(params: AstarPa2Params, a: bytes, b: bytes, device) -> tuple[int, Cigar]:
    aligner = replace(params, device=device).make_aligner(True)
    cost, cigar, _ = aligner.cost_or_align(a, b, True)
    return cost, cigar


def astarpa2_nw(a: bytes, b: bytes, device=None) -> tuple[int, Cigar]:
    """Full n*m bitpacked NW with traceback."""
    return _block(AstarPa2Params.nw(), a, b, device)


def astarpa2_simple(a: bytes, b: bytes, device=None) -> tuple[int, Cigar]:
    """Gap-heuristic band doubling (A*PA2-simple)."""
    return _block(AstarPa2Params.simple(), a, b, device)


def astarpa2_full(a: bytes, b: bytes, device=None) -> tuple[int, Cigar]:
    """GCSH-guided band doubling with pruning (A*PA2-full)."""
    return _block(AstarPa2Params.full(), a, b, device)


def astarpa(a: bytes, b: bytes) -> tuple[int, Cigar]:
    """Default A*PA alignment (`astarpa/src/lib.rs:56-64`): A* in the
    diagonal-transition state space guided by GCSH (r=2, k=15) with match
    pruning by start."""
    from .astar import astarpa as _astarpa

    return _astarpa(a, b)


def astarpa_gcsh(a: bytes, b: bytes, r: int, k: int, prune) -> tuple[int, Cigar]:
    """A*PA with custom GCSH parameters (`astarpa/src/lib.rs:69-77`)."""
    from .astar import astarpa_gcsh as _gcsh

    return _gcsh(a, b, r, k, prune)
