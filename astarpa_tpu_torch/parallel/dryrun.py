"""A dry run of the batch runtime split over several devices.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: the batch aligner
over a mesh of ``n_devices`` shards on tiny shapes, every cost against the
oracle and every CIGAR verified, then the counts summed through
:func:`.multihost._merge_counts`.
"""

from __future__ import annotations

import contextlib

import torch

from .. import generate, native, oracle
from ..ops import banded_kernel
from . import runner
from .multihost import _merge_counts
from .runner import BatchAligner

#: The runner's checkpoint wrappers of the big band, each recorded as
#: ``(name, ring)`` by :func:`_recording` (``ring``: the band fits the ring).
_BIG_CK = ("striped_ck", "pinned_ck")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the batch runtime over a mesh of ``n_devices`` shards and check
    it; raises ``AssertionError`` on a wrong result.

    ``devices`` is the mesh (``n_devices`` entries, repeats allowed:
    ``["cpu"] * 8`` on the CPU, ``["cuda:0"] * 2`` for two shards on one
    card); by default ``n_devices`` distinct CUDA devices, and a
    ``RuntimeError`` with fewer (there is no fallback to the CPU)."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} CUDA devices, have {have}")
        devices = [f"cuda:{k}" for k in range(n_devices)]
    mesh = list(devices)
    assert len(mesh) == n_devices, f"{len(mesh)} devices given for {n_devices}"
    lanes = 8

    # Costs over the mesh: a batch smaller than one lane group a shard,
    # then one that fills several.
    pairs = generate.generate_batch(2 * n_devices, 48, 0.1, generate.ErrorModel.UNIFORM, seed=2)
    costs = BatchAligner(band_words=2, lane_multiple=lanes, mesh=mesh).cost(pairs)
    _check_costs(pairs, costs, "shared ladder")
    big = generate.generate_batch(16 * n_devices, 40, 0.1, generate.ErrorModel.UNIFORM, seed=3)
    _check_costs(big, BatchAligner(band_words=4, lane_multiple=lanes, mesh=mesh).cost(big),
                 "shared ladder, full shards")

    if native.available():
        ck_pairs = big[:4 * n_devices]
        # The checkpoint path (ck rungs, staged readback, native traces).
        res, st = BatchAligner(band_words=4, lane_multiple=lanes, mesh=mesh,
                               domain_mode="off", direct_dt=False).align_with_stats(ck_pairs)
        _check_cigars(ck_pairs, res, "checkpoint rungs")
        assert st.direct_traces == 0, st
        # The default path: direct traces off the sharded cost rungs.
        res, st = BatchAligner(band_words=4, lane_multiple=lanes, mesh=mesh,
                               domain_mode="off").align_with_stats(ck_pairs)
        _check_cigars(ck_pairs, res, "direct traces")
        assert st.direct_traces == len(ck_pairs), st
        # The gap domain ladder: per-pair schedules split with the pairs.
        dom = generate.generate_batch(2 * n_devices, 300, 0.08, generate.ErrorModel.UNIFORM,
                                      seed=5)
        with _recording(("banded_ck_pp", "pinned_ck_pp")) as seen:
            res = BatchAligner(band_words=4, lane_multiple=lanes, mesh=mesh, domain_mode="gap",
                               domain_min_bp=0, direct_dt=False).align(dom)
        _check_cigars(dom, res, "gap domain ladder")
        assert seen, "the gap domain ladder ran no checkpoint round"
        _big_band(mesh, lanes)

    total = _merge_counts(int(sum(costs)), len(pairs))
    assert total == (sum(oracle.levenshtein(a, b) for a, b in pairs), len(pairs)), total
    print(f"dryrun_multichip OK on {n_devices} devices ({mesh[0]} first): "
          f"{[int(c) for c in costs]}")


def _big_band(mesh, lanes: int) -> None:
    """The big-band checkpoint rungs on every shard, with the routing
    lowered so tiny pairs reach them: ring K6 (SW 8, ``CB >= SW + 8``),
    ring K8 (a full height S off the 8-grain), and with the ring's capacity
    lowered below the band the stripe K6 and the stripe K8."""
    pairs = [generate.uniform_seeded(260 + 17 * s, 0.06, 90 + s) for s in range(4)]
    saved = runner.STRIPED_MIN_SW, banded_kernel.RING_MAX_WORDS
    try:
        runner.STRIPED_MIN_SW = 8
        for ring_max, doublings, want in ((saved[1], 8, ("striped_ck", True)),
                                          (2, 8, ("striped_ck", False)),
                                          (saved[1], 0, ("pinned_ck", True)),
                                          (2, 0, ("pinned_ck", False))):
            banded_kernel.RING_MAX_WORDS = ring_max
            before = dict(banded_kernel.LAUNCHES)
            with _recording(_BIG_CK) as seen:
                res = BatchAligner(band_words=8, lane_multiple=lanes, mesh=mesh,
                                   domain_mode="off", direct_dt=False,
                                   max_band_doublings=doublings).align(pairs)
            _check_cigars(pairs, res, f"big band {want}")
            assert want in seen, (want, seen)
            if torch.device(mesh[0]).type == "cuda":
                key = {("striped_ck", True): "ring_ck", ("striped_ck", False): "striped_ck",
                       ("pinned_ck", True): "ring_ck_exact",
                       ("pinned_ck", False): "pinned_ck"}[want]
                ran = banded_kernel.LAUNCHES[key] - before[key]
                assert ran >= len(mesh), (key, ran)
    finally:
        runner.STRIPED_MIN_SW, banded_kernel.RING_MAX_WORDS = saved


@contextlib.contextmanager
def _recording(names):
    """Record the runner's calls of the wrappers ``names`` as ``(name,
    ring)``, ``ring`` whether the band (the call's SW, at most S) fits the
    ring K6/K8/K9/K10 take (:func:`..ops.banded_kernel.ring_takes`)."""
    seen = set()
    saved = {name: getattr(runner, name) for name in names}

    def spy(name, fn):
        def call(*args):
            sw = args[6] if name in _BIG_CK else args[7]
            seen.add((name, banded_kernel.ring_takes(min(sw, args[2].shape[0]))))
            return fn(*args)
        return call

    for name, fn in saved.items():
        setattr(runner, name, spy(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(runner, name, fn)


def _check_costs(pairs, costs, what: str) -> None:
    want = [oracle.levenshtein(a, b) for a, b in pairs]
    assert [int(c) for c in costs] == want, f"{what}: costs differ from the oracle"


def _check_cigars(pairs, results, what: str) -> None:
    for (a, b), (cost, cigar) in zip(pairs, results):
        assert cigar.verify(a, b) == cost == oracle.levenshtein(a, b), what

