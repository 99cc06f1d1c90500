"""Wrappers of the banded kernels (``csrc/banded.cu``), the striped
big-band kernels (``csrc/striped.cu``) and the resident-ring big-band
kernels (``csrc/pinned.cu``).

Counterparts of ``astarpa_tpu/ops/pallas_banded.py::banded_cost_tpu``,
``banded_fill_tpu`` and ``banded_ck_tpu`` (``_banded_call``), of
``astarpa_tpu/ops/striped.py::striped_cost_tpu`` and ``striped_ck_tpu``
and of ``astarpa_tpu/ops/pinned.py::pinned_cost_tpu``, ``pinned_ck_tpu``,
``pinned_cost_pp_tpu`` and ``pinned_ck_pp_tpu``, one wrapper per kernel:

- :func:`banded_cost` — K1, shared schedule, costs: on the card a ring of
  resident words (8 register slots a lane, a few lanes a pair below 256
  live words, up to :data:`RING_MAX_WORDS`);
- :func:`banded_ck` — K2, shared schedule, costs and checkpoints: on the
  card K1's ring writing K4's checkpoint rows on the shared schedule
  (``banded_ring_ck_kernel``), the old one-thread-a-pair kernel for an
  interval or band the ring refuses (:func:`k2_kernel`);
- :func:`banded_fill` — K3, shared schedule, costs and every column's
  planes: on the card K1's ring storing each word's state after each
  column, in pair-major storage;
- :func:`banded_fill_pp` — K3, per-pair schedules, the same (the old
  one-thread-a-pair kernel);
- :func:`banded_cost_pp` — K4, per-pair schedules, costs: on the card K1's
  ring on per-pair event rows (:func:`banded_ring_pp_tables`);
- :func:`banded_ck_pp` — K4, per-pair schedules, costs and checkpoints: the
  same ring writing K4's checkpoint rows;
- :func:`striped_cost` — K5, shared schedule, any band height, costs: the
  ring kernels of :func:`pinned_cost` up to :data:`RING_COST_MAX_WORDS`
  live words, the stripe kernel past them;
- :func:`striped_ck` — K6, K5 plus 8-aligned-top checkpoints: the ring
  kernel (ring K6) up to :data:`RING_MAX_WORDS` live words, the stripe
  kernel past them;
- :func:`pinned_cost` — K7, K5's costs from a ring of resident words in
  registers (up to :data:`RING_MAX_WORDS`), and past it the wide ring,
  whose further slots are in shared memory (up to
  :data:`RING_COST_MAX_WORDS`);
- :func:`pinned_ck` — K8, K5 plus checkpoints under K2's contract, any SW:
  the ring kernel (ring K8, ring K10's row cursor on the shared schedule)
  up to :data:`RING_MAX_WORDS` live words, the stripe kernel past them;
- :func:`pinned_cost_pp` — K9, K5's DP on per-pair schedules, costs: the
  ring kernel (ring K9) up to :data:`RING_MAX_WORDS` live words, the
  stripe kernel past them;
- :func:`pinned_ck_pp` — K10, K9 plus checkpoints under K4's contract: the
  ring kernel (ring K10) up to :data:`RING_MAX_WORDS` live words, the
  stripe kernel past them.

Each has the contract of its plain version in :mod:`.banded`,
:mod:`.striped` or :mod:`.pinned`.  A tensor on the CPU goes to that plain
version; a CUDA tensor launches the kernel or raises.  Per-pair schedules
are host numpy (n_max, B) 0/1 arrays, checked to shift only at multiples
of their quantum on both routes.
"""

from __future__ import annotations

import functools
import inspect
import threading

import numpy as np
import torch

from ..utils import spans
from . import banded, pinned, striped
from .bitpack import W
from .words import lengths, to_tensor

#: Launches of each CUDA kernel in this process, by wrapper name (callers
#: that need to show a run went through a kernel reset them first).
#: ``nw_right_edge`` is K11's, whose wrapper is in :mod:`.nw_kernel`;
#: ``banded_cost`` counts the old one-thread-a-pair K1, which only the
#: internal ``_launch("banded_cost", ...)`` runs (:func:`banded_cost` runs
#: ``banded_ring``); ``banded_fill`` the old K3 (:func:`banded_fill` runs
#: ``banded_ring_fill``); ``banded_cost_pp`` and ``banded_ck_pp`` the old
#: K4, which only :func:`banded_ck_pp` runs, for an interval its ring
#: refuses (:func:`k4_kernel`); ``banded_ck`` the old K2, which only
#: :func:`banded_ck` runs, for an interval or band its ring refuses
#: (:func:`k2_kernel`); ``pinned_ck`` the stripe K8 (:func:`pinned_ck_kernel`).
LAUNCHES = {"banded_cost": 0, "banded_ck": 0, "banded_fill": 0,
            "banded_fill_pp": 0, "banded_cost_pp": 0, "banded_ck_pp": 0, "striped_cost": 0, "striped_ck": 0,
            "pinned_cost": 0, "pinned_ck": 0, "pinned_cost_pp": 0,
            "pinned_ck_pp": 0, "ring_ck": 0, "ring_cost_pp": 0,
            "ring_cost_wide": 0, "banded_ring": 0, "ring_ck_pp": 0,
            "banded_ring_pp": 0, "banded_ring_ck_pp": 0, "banded_ring_fill": 0,
            "ring_ck_exact": 0, "banded_ring_ck": 0, "nw_right_edge": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The key of the last launch this thread counted, for its wrapper's record.
_RAN = threading.local()


def _count(key: str) -> None:
    """Count one launch of ``key`` in :data:`LAUNCHES`."""
    LAUNCHES[key] += 1
    _RAN.key = key


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def recorded(fn):
    """A public kernel wrapper in a ``launch`` span with its launch record
    (:func:`..utils.spans.note_launch`) while the recorder is on: the
    :data:`LAUNCHES` key that ran, or on the CPU the plain version's name
    (``<wrapper>_ref``); ``band_words`` clamped to S (S where the wrapper
    takes no band); the sum of ``n``; the bytes of the array arguments
    (planes, lengths, a schedule) and of the outputs; the current stream.
    All of it from host shapes and host lengths: nothing waits for the
    card."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not spans.on():
            return fn(*args, **kwargs)
        with spans.span("launch"):
            _RAN.key = None
            out = fn(*args, **kwargs)
            arg = sig.bind(*args, **kwargs).arguments
            a0, n, S = arg["a0"], arg["n"], arg["pb0"].shape[0]
            on_card = a0.device.type == "cuda"
            outs = out if isinstance(out, tuple) else (out,)
            spans.note_launch(
                kernel=_RAN.key or fn.__name__ + "_ref",
                band_words=min(arg.get("band_words", S), S),
                columns=(int(np.sum(n)) if not isinstance(n, torch.Tensor)
                         else None if n.is_cuda else int(n.sum())),
                in_bytes=sum(_nbytes(x) for x in arg.values()
                             if isinstance(x, (torch.Tensor, np.ndarray))),
                out_bytes=sum(_nbytes(x) for x in outs),
                stream=torch.cuda.current_stream(a0.device).cuda_stream if on_card else None)
        return out
    return wrapped


_LABELS = {"banded_cost": "cuda-banded", "banded_ck": "cuda-banded-ck",
           "banded_fill": "cuda-banded-fill", "banded_fill_pp": "cuda-banded-fill-pp",
           "banded_cost_pp": "cuda-banded-pp", "banded_ck_pp": "cuda-banded-ck-pp",
           "striped_cost": "cuda-striped", "striped_ck": "cuda-striped-ck",
           "pinned_cost": "cuda-pinned", "pinned_ck": "cuda-pinned-ck",
           "pinned_cost_pp": "cuda-pinned-pp", "pinned_ck_pp": "cuda-pinned-pp-ck",
           "ring_ck": "cuda-ring-ck", "ring_cost_pp": "cuda-ring-pp",
           "ring_cost_wide": "cuda-ring-wide", "banded_ring": "cuda-banded-ring",
           "ring_ck_pp": "cuda-ring-pp-ck", "banded_ring_pp": "cuda-banded-ring-pp",
           "banded_ring_ck_pp": "cuda-banded-ring-ck-pp",
           "banded_ring_fill": "cuda-banded-ring-fill", "ring_ck_exact": "cuda-ring-ck-exact",
           "banded_ring_ck": "cuda-banded-ring-ck", "nw_right_edge": "cuda-nw"}


def route(device: torch.device, kernel: str = "banded_cost") -> str:
    """Label of what ``kernel``'s wrapper runs for tensors on ``device``."""
    return _LABELS[kernel] if device.type == "cuda" else "torch-ref"


@recorded
def banded_cost(a0, a1, pb0, pb1, n, m, band_words: int,
                diag: tuple | None = None) -> torch.Tensor:
    """Banded edit-distance upper bounds, (B,) int32 on the planes' device.

    a0/a1 (n_max, B), pb0/pb1 (S, B) int32 planes; n/m (B,) lengths (host
    numpy or tensors); ``band_words`` is clamped to S; ``diag`` as in
    :func:`.banded.shift_at_array`.

    On the card the band's live words (:func:`.striped.ring_span`, at most
    the band) run in a ring of resident words (``banded_ring_kernel``,
    :func:`banded_ring_layout`); it raises ``ValueError`` past
    :data:`RING_MAX_WORDS` of them.
    """
    if _plain(a0):
        return banded.banded_cost_ref(a0, a1, pb0, pb1, n, m, band_words, diag)
    return _launch_banded_ring(a0, a1, pb0, pb1, n, m, band_words, diag)


@recorded
def banded_ck(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
              diag: tuple | None = None):
    """Costs plus checkpoints every ``min(col_block, n_max)`` columns on the
    shared schedule: ``(costs, ck_vp, ck_vm, ck_tv)`` as
    :func:`.banded.banded_ck_ref`.

    On the card K1's ring writing K4's checkpoint rows on the shared
    schedule (``banded_ring_ck_kernel``, :func:`_launch_banded_ring_ck`);
    an interval or band it refuses runs the old K2 (:func:`k2_kernel`,
    a test on the host made before the launch)."""
    if _plain(a0):
        return banded.banded_ck_ref(a0, a1, pb0, pb1, n, m, band_words,
                                    col_block, diag)
    if k2_kernel(a0.shape[0], min(band_words, pb0.shape[0]), col_block) == "banded_ck":
        return _launch("banded_ck", a0, a1, pb0, pb1, n, m, band_words, diag=diag,
                       col_block=col_block)
    return _launch_banded_ring_ck(a0, a1, pb0, pb1, n, m, band_words, col_block, diag)


def k2_kernel(n_max: int, SW: int, col_block: int) -> str:
    """The :data:`LAUNCHES` key of what :func:`banded_ck` runs on the card:
    K2's ring (``banded_ring_ck``) where its row cursor takes the interval
    (``CB = min(col_block, n_max) >= SW``, or at most one capture window:
    ``ceil(n_max / CB) <= 2``) and its ring the band (``SW <=``
    :data:`RING_K4_MAX_WORDS`; the live words never outnumber it), else
    the old K2 (``banded_ck``).  The runner's intervals are at least SW + 8
    unless n_max clamps them to one checkpoint, and its K2 bands are below
    ``STRIPED_MIN_SW``, so it always runs the ring."""
    CB = banded.ck_col_block(col_block, n_max)
    takes = CB >= SW or -(-n_max // CB) <= 2
    return "banded_ring_ck" if takes and SW <= RING_K4_MAX_WORDS else "banded_ck"


@recorded
def banded_fill(a0, a1, pb0, pb1, n, m, band_words: int,
                diag: tuple | None = None):
    """Costs plus every column's window planes on the shared schedule:
    ``(costs, vp_cols, vm_cols)`` with (n_max, SW, B) planes, as
    :func:`.banded.banded_fill_ref`.  The planes are checked on both
    routes.

    On the card K1's ring (``banded_ring_fill_kernel``,
    :func:`banded_ring_fill_tables`) stores each word's state after each
    column; it raises ``ValueError`` past :data:`RING_K4_MAX_WORDS` live
    words.  The planes are stored (B, n_max, SW) and returned as an
    (n_max, SW, B) view of that storage, so that ``planes.permute(2, 0,
    1)`` (the trace route's pair-major readback) is contiguous: with that
    transpose counted, pair-major storage beat pair-minor on the route's
    pack (``PERF.md`` §6).  Raises ``ValueError`` when one pair's plane
    holds 2^31 words (:func:`fill_plane_check`)."""
    if _plain(a0):
        _check("banded_fill", a0, a1, pb0, pb1, band_words)
        return banded.banded_fill_ref(a0, a1, pb0, pb1, n, m, band_words, diag)
    return _launch_banded_ring_fill(a0, a1, pb0, pb1, n, m, band_words, diag)


@recorded
def banded_fill_pp(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                   quantum: int = banded.SCHEDULE_Q):
    """:func:`banded_fill` on per-pair schedules, as
    :func:`.banded.banded_fill_pp_ref`."""
    if _plain(a0):
        _check("banded_fill_pp", a0, a1, pb0, pb1, band_words)
        return banded.banded_fill_pp_ref(a0, a1, pb0, pb1, n, m, schedule,
                                         band_words, quantum)
    return _launch("banded_fill_pp", a0, a1, pb0, pb1, n, m, band_words,
                   schedule=schedule, quantum=quantum, fill=True)


@recorded
def banded_cost_pp(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                   quantum: int = banded.SCHEDULE_Q) -> torch.Tensor:
    """Upper bounds with per-pair schedules, as
    :func:`.banded.banded_cost_pp_ref`.

    On the card K1's ring on per-pair event rows
    (``banded_ring_pp_kernel``; :func:`banded_ring_pp_tables`; it raises
    ``ValueError`` past :data:`RING_K4_MAX_WORDS` live words)."""
    if _plain(a0):
        return banded.banded_cost_pp_ref(a0, a1, pb0, pb1, n, m, schedule,
                                         band_words, quantum)
    return _launch_banded_ring_pp(a0, a1, pb0, pb1, n, m, schedule, band_words, quantum)


@recorded
def banded_ck_pp(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                 col_block: int, quantum: int = banded.SCHEDULE_Q):
    """Per-pair costs plus checkpoints, as :func:`.banded.banded_ck_pp_ref`
    (the interval rounded to whole quantum groups).  On the card K1's ring
    writing K4's checkpoint rows (``banded_ring_ck_pp_kernel``), or the
    old K4 for an interval the ring refuses (:func:`k4_kernel`)."""
    if _plain(a0):
        return banded.banded_ck_pp_ref(a0, a1, pb0, pb1, n, m, schedule,
                                       band_words, col_block, quantum)
    SW = min(band_words, pb0.shape[0])
    if k4_kernel(a0.shape[0], SW, col_block, quantum) == "banded_ck_pp":
        return _launch("banded_ck_pp", a0, a1, pb0, pb1, n, m, band_words,
                       schedule=schedule, quantum=quantum, col_block=col_block)
    return _launch_banded_ring_pp(a0, a1, pb0, pb1, n, m, schedule, band_words, quantum,
                                  col_block)


def k4_kernel(n_max: int, SW: int, col_block: int | None = None,
              quantum: int = banded.SCHEDULE_Q) -> str:
    """The :data:`LAUNCHES` key of what :func:`banded_cost_pp` (or, with
    ``col_block``, :func:`banded_ck_pp`) runs on the card: K4's ring
    (``banded_ring_pp``, ``banded_ring_ck_pp``), or, for checkpoints at a
    Q-rounded interval below SW with more than one checkpoint, which the
    ring refuses (:func:`.pinned.k4_ring_takes`), the old K4
    (``banded_ck_pp``), a test on the host made before the launch."""
    if col_block is None:
        return "banded_ring_pp"
    if pinned.k4_ring_takes(n_max, SW, col_block, quantum):
        return "banded_ring_ck_pp"
    return "banded_ck_pp"


@recorded
def striped_cost(a0, a1, pb0, pb1, n, m, band_words: int,
                 diag: tuple | None = None,
                 stripe_words: int | None = None) -> torch.Tensor:
    """Banded costs at any band height (exact at ``band_words >= S``), as
    :func:`.striped.striped_cost_ref`: equal to :func:`banded_cost` where
    the window covers row m at the last column, ``INF`` elsewhere.

    On the card a band the cost ring holds (:func:`pinned_cost_takes`; the
    live words never outnumber the band) runs :func:`pinned_cost`'s ring
    kernels, a taller one the stripe kernel K5.  ``stripe_words`` picks the
    stripe kernel at that stripe height (see :func:`striped_threads`).  The
    results do not depend on either."""
    if _plain(a0):
        return striped.striped_cost_ref(a0, a1, pb0, pb1, n, m, band_words, diag)
    if stripe_words is None and pinned_cost_takes(min(band_words, pb0.shape[0])):
        # The ring's wrapper unrecorded: this call keeps the one record.
        return pinned_cost.__wrapped__(a0, a1, pb0, pb1, n, m, band_words, diag)
    return _launch_striped("striped_cost", a0, a1, pb0, pb1, n, m, band_words,
                           diag, stripe_words=stripe_words)


@recorded
def striped_ck(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
               diag: tuple | None = None, stripe_words: int | None = None,
               ring_words: int | None = None):
    """K5 plus checkpoints: ``(costs, ck_vp, ck_vm, ck_tv)`` with (n_ck,
    SW+8, B) planes as :func:`.striped.striped_ck_ref`.  Raises unless
    ``SW % 8 == 0`` and ``col_block >= SW + 8`` on both routes.

    On the card a band the ring holds (:func:`ring_takes`; the live words,
    :func:`.striped.ring_span` at ``n_max``, never outnumber it) runs ring
    K6, a taller one the stripe kernel.  ``stripe_words`` picks the stripe
    kernel at that stripe height, ``ring_words`` the ring kernel at that
    ring size (as :func:`pinned_cost`; it raises when the ring cannot hold
    the live words; both at once raise on both routes).  The results do
    not depend on either."""
    ring = _takes_ring(min(band_words, pb0.shape[0]), stripe_words, ring_words)
    if _plain(a0):
        return striped.striped_ck_ref(a0, a1, pb0, pb1, n, m, band_words,
                                      col_block, diag)
    SW = _check("striped_ck", a0, a1, pb0, pb1, band_words)
    if not ring:
        return _launch_striped("striped_ck", a0, a1, pb0, pb1, n, m, band_words,
                               diag, col_block, stripe_words)
    plan = striped.plan_striped(a0.shape[0], pb0.shape[0], SW, diag)
    striped.ck_layout(a0.shape[0], SW, col_block, plan["lo"])  # raises first
    threads = ring_threads(striped.ring_span(plan, a0.shape[0]), ring_words)
    return _launch_pinned(a0, a1, pb0, pb1, n, m, SW, plan, threads, col_block)


@recorded
def pinned_cost(a0, a1, pb0, pb1, n, m, band_words: int,
                diag: tuple | None = None, ring_words: int | None = None,
                thread_words: int | None = None) -> torch.Tensor:
    """K5's costs (:func:`striped_cost`) from one pass over a ring of
    resident words, as :func:`.striped.pinned_cost_ref`.  The ring holds
    the most words live at once (:func:`.striped.ring_span`), sized by
    :func:`ring_cost_layout`: K7 (8 register slots a thread) up to 4096
    words, the wide ring (8 register and 8 or 24 shared slots a thread) up
    to 16384; ``ring_words`` and ``thread_words`` force a size and a
    design (the results do not depend on them).  Raises ``ValueError`` on
    both routes when the ring would need more than 16384 words, or the
    forced ring cannot hold the live words.  A schedule shifted at column 0
    (``lo(0) = 1``) is taken: on the card the ring runs the band one word
    down (:func:`_launch_ring_cost`)."""
    SW = _check("pinned_cost", a0, a1, pb0, pb1, band_words)
    n_max, S = a0.shape[0], pb0.shape[0]
    plan = striped.plan_striped(n_max, S, SW, diag)
    threads, words = ring_cost_layout(striped.ring_span(plan, _cost_n_lim(n, n_max)),
                                      ring_words, thread_words)
    if _plain(a0):
        return striped.pinned_cost_ref(a0, a1, pb0, pb1, n, m, band_words, diag)
    return _launch_ring_cost(a0, a1, pb0, pb1, n, m, SW, plan, threads, words)


@recorded
def pinned_ck(a0, a1, pb0, pb1, n, m, band_words: int, col_block: int,
              diag: tuple | None = None, stripe_words: int | None = None,
              ring_words: int | None = None):
    """K5 plus checkpoints under K2's row contract: ``(costs, ck_vp, ck_vm,
    ck_tv)`` with (n_ck, SW, B) planes as :func:`.striped.pinned_ck_ref`,
    any SW.  Raises on both routes when ``min(col_block, n_max) < SW`` with
    more than one capture window (:func:`.striped.pinned_ck_layout`).

    On the card a band the ring holds (:func:`ring_takes`; its live words up
    to column n_max, :func:`.striped.ring_span`, never outnumber it) runs
    ring K8 (``ring_ck_exact_kernel``: ring K10's row cursor and top values
    on the shared schedule's events), a taller one the stripe kernel;
    ``stripe_words`` and ``ring_words`` pick one as in :func:`striped_ck`.
    The results do not depend on either."""
    ring = _takes_ring(min(band_words, pb0.shape[0]), stripe_words, ring_words)
    if _plain(a0):
        return striped.pinned_ck_ref(a0, a1, pb0, pb1, n, m, band_words,
                                     col_block, diag)
    if not ring:
        return _launch_striped("pinned_ck", a0, a1, pb0, pb1, n, m, band_words,
                               diag, col_block, stripe_words)
    return _launch_ring_ck_exact(a0, a1, pb0, pb1, n, m, band_words, col_block, diag,
                                 ring_words)


def pinned_ck_kernel(band_words: int) -> str:
    """The :data:`LAUNCHES` key of what :func:`pinned_ck` runs on the card
    for a band of ``band_words`` words (at most the full height) by
    default: ring K8 (``ring_ck_exact``) where :func:`ring_takes`, else the
    stripe K8 (``pinned_ck``)."""
    return "ring_ck_exact" if ring_takes(band_words) else "pinned_ck"


@recorded
def pinned_cost_pp(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                   quantum: int = 1, stripe_words: int | None = None,
                   ring_words: int | None = None) -> torch.Tensor:
    """Banded costs on per-pair schedules at any band height, as
    :func:`.pinned.pinned_cost_pp_ref`: ``<=`` :func:`banded_cost_pp`'s on
    the same schedule, ``INF`` where the band misses row m at the last
    column.  The schedule is checked on both routes (quantum, column 0
    unshifted).  On the card a band the ring holds (:func:`ring_takes`;
    each pair's live words, :func:`.pinned.ring_span_pp`, never outnumber
    it) runs ring K9, a taller one the stripe kernel; ``stripe_words`` and
    ``ring_words`` pick one as in :func:`striped_ck`."""
    ring = _takes_ring(min(band_words, pb0.shape[0]), stripe_words, ring_words)
    if _plain(a0):
        return pinned.pinned_cost_pp_ref(a0, a1, pb0, pb1, n, m, schedule,
                                         band_words, quantum)
    SW = _check("pinned_cost_pp", a0, a1, pb0, pb1, band_words)
    if ring:
        return _launch_ring_pp(a0, a1, pb0, pb1, n, m, schedule, SW, quantum,
                               ring_words)
    return _launch_pinned_pp("pinned_cost_pp", a0, a1, pb0, pb1, n, m, schedule,
                             band_words, quantum, stripe_words=stripe_words)


@recorded
def pinned_ck_pp(a0, a1, pb0, pb1, n, m, schedule, band_words: int,
                 col_block: int, quantum: int = 1, stripe_words: int | None = None,
                 ring_words: int | None = None):
    """K9 plus checkpoints: ``(costs, ck_vp, ck_vm, ck_tv)`` under K4's
    contract, as :func:`.pinned.pinned_ck_pp_ref`.  Raises on both routes
    when the Q-rounded interval is below ``min(band_words, S)``.  On the
    card a band the ring holds (:func:`ring_takes`; each pair's live words
    up to column n_max, :func:`.pinned.ring_span_pp`, never outnumber it)
    runs ring K10, a taller one the stripe kernel; ``stripe_words`` and
    ``ring_words`` pick one as in :func:`striped_ck`."""
    ring = _takes_ring(min(band_words, pb0.shape[0]), stripe_words, ring_words)
    if _plain(a0):
        return pinned.pinned_ck_pp_ref(a0, a1, pb0, pb1, n, m, schedule,
                                       band_words, col_block, quantum)
    if ring:
        return _launch_ring_ck_pp(a0, a1, pb0, pb1, n, m, schedule, band_words,
                                  col_block, quantum, ring_words)
    return _launch_pinned_pp("pinned_ck_pp", a0, a1, pb0, pb1, n, m, schedule,
                             band_words, quantum, col_block, stripe_words)


def _plain(a0) -> bool:
    if a0.device.type == "cpu":
        return True
    if a0.device.type != "cuda":
        raise ValueError(f"banded kernels: unsupported device {a0.device}")
    return False


def _launch(kernel, a0, a1, pb0, pb1, n, m, band_words, *, diag=None,
            schedule=None, quantum=1, col_block=None, fill=False):
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = _check(kernel, a0, a1, pb0, pb1, band_words)
    n_t = lengths(n, B, dev)
    m_t = lengths(m, B, dev)
    per_pair = schedule is not None
    if per_pair:
        sched = to_tensor(banded.check_schedule(schedule, n_max, B, quantum), dev)
    else:
        shift = banded.shift_at_array(n_max, S, SW, diag)
        if int(shift.sum()) > S - SW:
            raise ValueError(f"{kernel}: schedule slides past the last word")
        sched = to_tensor(shift, dev)
    ring_vp = torch.empty((SW, B), dtype=torch.int32, device=dev)
    ring_vm = torch.empty((SW, B), dtype=torch.int32, device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    head = [a0, a1, pb0, pb1, n_t, m_t, sched, ring_vp, ring_vm, out]
    outs = ()
    if col_block is not None:
        CB = banded.ck_col_block(col_block, n_max, quantum if per_pair else None)
        n_ck = -(-n_max // CB)
        outs = (torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
                torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
                torch.empty((n_ck, B), dtype=torch.int32, device=dev))
    elif fill:
        outs = (torch.empty((n_max, SW, B), dtype=torch.int32, device=dev),
                torch.empty((n_max, SW, B), dtype=torch.int32, device=dev))
    ints = [n_max, B, S, SW] + ([quantum] if per_pair else []) \
        + ([CB] if col_block is not None else [])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"astarpa_{kernel}")(
            *(t.data_ptr() for t in head + list(outs)), *ints, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    _count(kernel)
    return (out,) + outs if outs else out


#: Words a thread of the striped kernel holds (``kK`` in ``csrc/striped.cu``).
STRIPED_WORDS_PER_THREAD = 8


def striped_threads(SW: int, stripe_words: int | None = None) -> int:
    """Block size of the striped kernels.  By default ``ceil(SW / 8)``
    threads rounded up to a warp, 32 to 512: a stripe is ``threads * 8``
    words, so bands up to 4096 words run in stripes at least as tall as
    the band.  ``stripe_words`` (a multiple of 256, at most 4096) sets it."""
    per = STRIPED_WORDS_PER_THREAD
    if stripe_words is None:
        return min(512, max(32, -(-SW // (32 * per)) * 32))
    if stripe_words % (32 * per) or not 0 < stripe_words <= 512 * per:
        raise ValueError(f"stripe_words must be a multiple of {32 * per} up to "
                         f"{512 * per}, got {stripe_words}")
    return stripe_words // per


def striped_events(plan: dict, n_lim: int, threads: int):
    """Device-side event table of a striped launch: ``(ev (4, nw_pad),
    stripe_t (n_stripes, 2))`` int32 host arrays.  ``ev`` rows are the
    plan's ``ent_t``, ``top_t`` and ``abs_t`` and ``end_t``, the step after
    each word's last useful one (its absorb, or its column ``n_lim - 1``),
    padded to whole stripes (pad words never enter; their ``end_t`` repeats
    the last word's, so a warp's end is its last lane's)."""
    ws = threads * STRIPED_WORDS_PER_THREAD
    nwl = plan["n_words_live"]
    n_stripes = -(-nwl // ws)
    nw_pad = n_stripes * ws
    w = np.arange(nwl, dtype=np.int64)
    abs_t = plan["abs_t"].astype(np.int64)
    end_t = np.minimum(np.where(abs_t < striped.NEVER, abs_t + 1, striped.NEVER),
                       n_lim + w)
    ev = np.full((4, nw_pad), striped.NEVER, np.int32)
    ev[0, :nwl] = plan["ent_t"]
    ev[1, :nwl] = plan["top_t"]
    ev[2, :nwl] = plan["abs_t"]
    ev[3, :nwl] = end_t
    ev[3, nwl:] = end_t[-1]
    first = np.arange(n_stripes) * ws
    last = np.minimum(first + ws, nwl) - 1
    stripe_t = np.stack([ev[0, first], ev[3, last]], 1).astype(np.int32)
    return ev, stripe_t


def _launch_striped(kernel, a0, a1, pb0, pb1, n, m, band_words, diag,
                    col_block=None, stripe_words=None):
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = _check(kernel, a0, a1, pb0, pb1, band_words)
    plan = striped.plan_striped(n_max, S, SW, diag)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    loend = _loend(plan, n, n_t, n_max, dev)
    ck = col_block is not None
    # Cost mode stops each word after the longest pair's last column;
    # checkpoints are defined (and compared) up to n_max.
    n_lim = n_max if ck else _cost_n_lim(n, n_max)
    threads = striped_threads(SW, stripe_words)
    ev, stripe_t = striped_events(plan, n_lim, threads)
    T = plan["T"]
    code = ((a0 & 1) | (a1 & 2)).to(torch.uint8).T.contiguous()
    carry = torch.empty((2, B, T + 1), dtype=torch.uint8, device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    head = [code, pb0, pb1, n_t, m_t, loend, to_tensor(ev, dev),
            to_tensor(stripe_t, dev), carry, out]
    ints = [n_max, B, S, SW, ev.shape[1], stripe_t.shape[0], T, threads]
    outs = ()
    if ck:
        # K6's rows start at the 8-aligned window top, K8's at the true one.
        exact = kernel == "pinned_ck"
        layout = striped.pinned_ck_layout if exact else striped.ck_layout
        CB, n_ck, ckw0 = layout(n_max, SW, col_block, plan["lo"])
        rows = SW if exact else SW + 8
        outs = (torch.empty((n_ck, rows, B), dtype=torch.int32, device=dev),
                torch.empty((n_ck, rows, B), dtype=torch.int32, device=dev),
                torch.empty((n_ck, B), dtype=torch.int32, device=dev))
        head += list(outs) + [to_tensor(ckw0, dev)]
        ints += [CB, n_ck]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"astarpa_{kernel}")(
            *(t.data_ptr() for t in head), *ints, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    _count(kernel)
    return (out,) + outs if ck else out


def _cost_n_lim(n, n_max: int) -> int:
    """Columns a cost sweep needs: the longest pair's, from host lengths;
    n_max from lengths on the card (no sync to read them)."""
    return int(np.max(n, initial=1)) if isinstance(n, np.ndarray) else n_max


def _loend(plan, n, n_t, n_max: int, dev) -> torch.Tensor:
    """Each pair's band top at its last column, on ``dev``."""
    if isinstance(n, np.ndarray):
        return to_tensor(striped.loend_of(plan["lo"], n), dev)
    lo = torch.as_tensor(plan["lo"], device=dev)
    return lo[(n_t.long() - 1).clamp(0, n_max - 1)].to(torch.int32)


#: Largest ring of ring K6 and ring K9, and of K7 (``kMaxThreads * kK`` in
#: ``csrc/pinned.cu``: 8 register slots a thread), K5's largest stripe.
RING_MAX_WORDS = 512 * STRIPED_WORDS_PER_THREAD
#: Slots a thread of the shared cost ring holds: K7's 8 in registers, the
#: wide ring's 8 in registers and 8 or 24 in shared memory
#: (``ring_cost_kernel<kS>`` in ``csrc/pinned.cu``).
RING_THREAD_WORDS = (8, 16, 32)
#: Largest ring of the shared cost kernels: 512 threads of 32 slots.
RING_COST_MAX_WORDS = 512 * RING_THREAD_WORDS[-1]


def ring_threads(span: int, ring_words: int | None = None) -> int:
    """Block size of ring K6 or ring K9 (8 register slots a thread) whose
    ring must hold ``span`` words: the least warp multiple whose ``threads *
    8`` slots hold them, or ``ring_words // 8`` (a multiple of 256 words, at
    least ``span``).  Raises ``ValueError`` past :data:`RING_MAX_WORDS`
    (:func:`ring_cost_layout` at 8 slots a thread)."""
    return ring_cost_layout(span, ring_words, STRIPED_WORDS_PER_THREAD)[0]


def ring_takes(band_words: int) -> bool:
    """Whether ring K6 and ring K9 take a band of ``band_words`` words (at
    most the full height): their register ring holds its live words, which
    never outnumber the band (:func:`.striped.ring_span`,
    :func:`.pinned.ring_span_pp`).  Taller bands run the stripe kernels
    (K6, K9), which take any height.  The shared cost ring goes further
    (:func:`pinned_cost_takes`)."""
    return band_words <= RING_MAX_WORDS


def pinned_cost_takes(band_words: int) -> bool:
    """Whether the shared cost ring (:func:`pinned_cost`: K7, or the wide
    ring past 4096 live words) takes a cost rung of ``band_words`` words
    (at most the full height): its live words never outnumber the band,
    and the ring holds :data:`RING_COST_MAX_WORDS`.  Taller bands run K5's
    stripes."""
    return band_words <= RING_COST_MAX_WORDS


def ring_cost_layout(span: int, ring_words: int | None = None,
                     thread_words: int | None = None) -> tuple[int, int]:
    """``(threads, thread_words)`` of a shared cost ring that must hold
    ``span`` live words: the fewest slots a thread (8, 16 or 32, from
    :data:`RING_THREAD_WORDS`) whose 512 threads hold them, then the least
    warp multiple of threads (so K7 takes up to 4096 words and the wide
    ring the rest); or ``ring_words`` (a multiple of 32 threads' slots from
    the live words up to 512 threads' slots) and ``thread_words``, either
    of them forced.  Raises ``ValueError`` past :data:`RING_COST_MAX_WORDS`
    or when the forced ring cannot hold the live words."""
    if thread_words is not None and thread_words not in RING_THREAD_WORDS:
        raise ValueError(f"thread_words must be one of {RING_THREAD_WORDS}, got {thread_words}")
    if thread_words is None:
        if span > RING_COST_MAX_WORDS:
            raise ValueError(f"ring kernel: {span} live words exceed the ring's "
                             f"{RING_COST_MAX_WORDS}; use the striped kernel")
        need = span if ring_words is None else ring_words
        thread_words = next((k for k in RING_THREAD_WORDS if need <= 512 * k),
                            RING_THREAD_WORDS[-1])
    if span > 512 * thread_words:
        raise ValueError(f"ring kernel: {span} live words exceed the ring's "
                         f"{512 * thread_words} at {thread_words} slots a thread")
    if ring_words is None:
        return max(32, -(-span // (32 * thread_words)) * 32), thread_words
    if ring_words % (32 * thread_words) or not span <= ring_words <= 512 * thread_words:
        raise ValueError(f"ring_words must be a multiple of {32 * thread_words} from the "
                         f"{span} live words up to {512 * thread_words}, got {ring_words}")
    return ring_words // thread_words, thread_words


def pinned_cost_words(n_max: int, S: int, band_words: int, diag, n) -> int:
    """Slots a thread of the ring :func:`pinned_cost` runs for these
    planes' shape and lengths ``n`` at its default ring: 8 (K7), 16 or 32
    (the wide ring).  Passed as ``thread_words``, it makes every part of a
    batch run the design the whole batch would."""
    plan = striped.plan_striped(n_max, S, min(band_words, S), diag)
    return ring_cost_layout(striped.ring_span(plan, _cost_n_lim(n, n_max)))[1]


def pinned_cost_kernel(n_max: int, S: int, band_words: int, diag, n) -> str:
    """The :data:`LAUNCHES` key of the ring kernel :func:`pinned_cost` runs
    for these planes' shape at its default ring: ``"pinned_cost"`` (K7) or
    ``"ring_cost_wide"``."""
    words = pinned_cost_words(n_max, S, band_words, diag, n)
    return "pinned_cost" if words == STRIPED_WORDS_PER_THREAD else "ring_cost_wide"


def _takes_ring(SW: int, stripe_words, ring_words) -> bool:
    """Whether a wrapper with a ring and a stripe kernel runs the ring:
    ``ring_words`` asks for it, ``stripe_words`` for the stripes, else the
    band decides (:func:`ring_takes`)."""
    if stripe_words is not None and ring_words is not None:
        raise ValueError("stripe_words picks the stripe kernel and ring_words "
                         "the ring kernel: give at most one")
    return ring_words is not None or (stripe_words is None and ring_takes(SW))


def ring_events(plan: dict, ring_words: int) -> np.ndarray:
    """(3, nw_pad) int32 host event table of a shared ring launch (K7, the
    wide ring, ring K6): the plan's ``ent_t``, ``top_t`` and ``abs_t``, then ``NEVER`` up
    to one ring past the live words, where a thread's event pointers stop
    (``nw_pad`` a multiple of ``ring_words``)."""
    nwl = plan["n_words_live"]
    ev = np.full((3, (-(-nwl // ring_words) + 1) * ring_words), striped.NEVER, np.int32)
    ev[0, :nwl] = plan["ent_t"]
    ev[1, :nwl] = plan["top_t"]
    ev[2, :nwl] = plan["abs_t"]
    return ev


def _launch_ring_ck_exact(a0, a1, pb0, pb1, n, m, band_words, col_block, diag,
                          ring_words=None):
    """Ring K8: the shared schedule's costs and checkpoints under K2's rows
    from one pass over a ring of resident words, swept to column n_max
    (``ring_words`` forces the ring's size, as :func:`ring_threads`)."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = _check("ring_ck_exact", a0, a1, pb0, pb1, band_words)
    plan = striped.plan_striped(n_max, S, SW, diag)
    CB, n_ck, ckw0 = striped.pinned_ck_layout(n_max, SW, col_block, plan["lo"])  # raises first
    # Checkpoints are defined (and compared) up to n_max.
    threads = ring_threads(striped.ring_span(plan, n_max), ring_words)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    ev = ring_events(plan, threads * STRIPED_WORDS_PER_THREAD)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    outs = (torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
            torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
            torch.empty((n_ck, B), dtype=torch.int32, device=dev))
    head = [_ring_codes(a0, a1), pb0, pb1, n_t, m_t, _loend(plan, n, n_t, n_max, dev),
            to_tensor(ev, dev), out, *outs, to_tensor(ckw0, dev)]
    ints = [n_max, B, S, SW, ev.shape[1], threads, CB, n_ck]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_ring_ck_exact(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"ring_ck_exact kernel launch failed: cudaError {rc}")
    _count("ring_ck_exact")
    return (out,) + outs


def _launch_pinned(a0, a1, pb0, pb1, n, m, SW, plan, threads, col_block):
    """Ring K6: the shared schedule's checkpoint ring launch."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    loend = _loend(plan, n, n_t, n_max, dev)
    ev = ring_events(plan, threads * STRIPED_WORDS_PER_THREAD)
    code = ((a0 & 1) | (a1 & 2)).to(torch.uint8).T.contiguous()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    CB, n_ck, ckw0 = striped.ck_layout(n_max, SW, col_block, plan["lo"])
    # Checkpoints are defined (and compared) up to n_max.
    outs = (torch.empty((n_ck, SW + 8, B), dtype=torch.int32, device=dev),
            torch.empty((n_ck, SW + 8, B), dtype=torch.int32, device=dev),
            torch.empty((n_ck, B), dtype=torch.int32, device=dev))
    head = [code, pb0, pb1, n_t, m_t, loend, to_tensor(ev, dev), out, *outs,
            to_tensor(ckw0, dev)]
    ints = [n_max, B, S, SW, ev.shape[1], n_max, threads, CB, n_ck]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_ring_ck(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"ring_ck kernel launch failed: cudaError {rc}")
    _count("ring_ck")
    return (out,) + outs


#: Bytes past the last pair's codes: the top word's code is read a step
#: ahead, one column past the pair's last (``ring_cost_kernel``).
CODE_PAD = 64


def _ring_codes(a0, a1) -> torch.Tensor:
    """The pairs' char codes for ``ring_body``'s kernels: (B, n_max) uint8,
    pair-major (the band top reads its pair's next column from the same
    line), flat with :data:`CODE_PAD` zero bytes after the last pair.  The
    planes narrow to bytes first (their low bits are the codes'), so the
    int32 planes are read once."""
    n_max, B = a0.shape
    code = torch.empty(B * n_max + CODE_PAD, dtype=torch.uint8, device=a0.device)
    code[B * n_max:] = 0
    c = a0.to(torch.uint8).bitwise_and_(1).bitwise_or_(a1.to(torch.uint8).bitwise_and_(2))
    code[:B * n_max].view(B, n_max).copy_(c.T)
    return code


def _launch_ring_cost(a0, a1, pb0, pb1, n, m, SW, plan, threads, thread_words):
    """K7 (8 slots a thread) or the wide ring: the shared cost ring launch.

    Their builds leave out the start a schedule shifted at column 0 needs
    (slot 0 reading the column codes from step 0; with it both wide rings
    spilled, ``csrc/pinned.cu``'s header).  Such a schedule absorbs word 0
    at its entry, step 0, column 0, so the ring runs the band one word down,
    a test on the host before the launch: words 1.. at steps 1.. are words
    0.. at steps 0.. on the profile rows from 32 (the same columns, so the
    same band), with m and each pair's last band top one word less, and
    each pair with a column gets word 0's all-ones value, 32, back."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    loend = _loend(plan, n, n_t, n_max, dev)
    ev = ring_events(plan, threads * thread_words)
    col0 = plan["lo"][0] > 0
    if col0:
        ev = np.concatenate([np.where(ev[:, 1:] < striped.NEVER, ev[:, 1:] - 1, striped.NEVER),
                             np.full((3, 1), striped.NEVER, np.int32)], 1).astype(np.int32)
        pb0, pb1, S = pb0[1:], pb1[1:], S - 1
        m_t, loend = m_t - W, loend - 1
    code = _ring_codes(a0, a1)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    head = [code, pb0, pb1, n_t, m_t, loend, to_tensor(ev, dev), out]
    ints = [n_max, B, S, SW, ev.shape[1], _cost_n_lim(n, n_max), threads]
    wide = thread_words != STRIPED_WORDS_PER_THREAD
    key = "ring_cost_wide" if wide else "pinned_cost"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if wide:
            rc = load().astarpa_ring_cost_wide(*(t.data_ptr() for t in head), *ints,
                                               thread_words, stream)
        else:
            rc = load().astarpa_pinned_cost(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    _count(key)
    if col0:
        return torch.where((n_t > 0) & (out < banded.INF), out + W, out)
    return out


def _pp_event_rows(plan: dict, ring_words: int, dev) -> torch.Tensor:
    """(B, 3, nw_pad) int32 per-pair event rows of a ring of ``ring_words``
    slots: each pair's ``ent_t``, ``top_t`` and ``abs_t``, then ``NEVER``
    up to one ring past the longest pair's live words."""
    B, nw = plan["ent_t"].shape
    ev = torch.full((B, 3, (-(-nw // ring_words) + 1) * ring_words), striped.NEVER,
                    dtype=torch.int32, device=dev)
    for row, key in enumerate(("ent_t", "top_t", "abs_t")):
        ev[:, row, :nw] = plan[key]
    return ev


def ring_pp_events(sched: np.ndarray, n, SW: int, dev, ring_words: int | None = None,
                   n_lim: int | None = None):
    """Device-side event table of a ring K9 or ring K10 launch, built on
    the card from the uploaded schedule (:func:`.pinned.plan_pp`): ``(plan,
    ev (B, 3, nw_pad), threads)``, each pair's rows as :func:`ring_events`
    builds the shared ones (``ent_t``, ``top_t``, ``abs_t``, ``NEVER`` up
    to one ring past the longest pair's live words), and the block size
    whose ring holds every pair's live run (:func:`.pinned.ring_span_pp`
    with each pair's own last column, or column ``n_lim - 1`` for every
    pair when ``n_lim`` is given, as ring K10's ``n_max``; read back once),
    or ``ring_words // 8`` (:func:`ring_threads`).  No ``end_t`` row, no
    stripe ranges."""
    plan = pinned.plan_pp(sched, n, SW, dev)
    n_lim = torch.as_tensor(np.maximum(np.asarray(n, np.int64), 1) if n_lim is None
                            else np.full(len(n), n_lim, np.int64), device=dev)
    span = int(pinned.ring_span_pp(plan, n_lim, SW).max())
    threads = ring_threads(span, ring_words)
    return plan, _pp_event_rows(plan, threads * STRIPED_WORDS_PER_THREAD, dev), threads


def _launch_ring_pp(a0, a1, pb0, pb1, n, m, schedule, SW, quantum, ring_words=None):
    """Ring K9: per-pair costs from one pass over a ring of resident words."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    sched = pinned.check_pp_schedule(schedule, n_max, B, quantum)
    n_host = np.asarray(torch.as_tensor(n).cpu(), np.int64)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    plan, ev, threads = ring_pp_events(sched, n_host, SW, dev, ring_words)
    code = ((a0 & 1) | (a1 & 2)).to(torch.uint8).T.contiguous()
    out = torch.empty(B, dtype=torch.int32, device=dev)
    head = [code, pb0, pb1, n_t, m_t, plan["loend"], ev, out]
    ints = [n_max, B, S, SW, ev.shape[2], threads]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_ring_cost_pp(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"ring_cost_pp kernel launch failed: cudaError {rc}")
    _count("ring_cost_pp")
    return out


def _launch_ring_ck_pp(a0, a1, pb0, pb1, n, m, schedule, band_words, col_block, quantum,
                       ring_words=None):
    """Ring K10: per-pair costs and checkpoints from one pass over a ring
    of resident words, swept to column n_max."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = _check("ring_ck_pp", a0, a1, pb0, pb1, band_words)
    sched = pinned.check_pp_schedule(schedule, n_max, B, quantum)
    CB, n_ck = pinned.ck_layout_pp(col_block, n_max, quantum, SW)
    n_host = np.asarray(torch.as_tensor(n).cpu(), np.int64)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    # Checkpoints are defined (and compared) up to n_max.
    plan, ev, threads = ring_pp_events(sched, n_host, SW, dev, ring_words, n_lim=n_max)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    outs = (torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
            torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
            torch.empty((n_ck, B), dtype=torch.int32, device=dev))
    head = [_ring_codes(a0, a1), pb0, pb1, n_t, m_t, plan["loend"], ev, out, *outs,
            pinned.ck_tops(plan["lo"], CB, n_ck)]
    ints = [n_max, B, S, SW, ev.shape[2], threads, CB, n_ck]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_ring_ck_pp(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"ring_ck_pp kernel launch failed: cudaError {rc}")
    _count("ring_ck_pp")
    return (out,) + outs


def banded_ring_layout(span: int, B: int, lanes: int | None = None,
                       max_words: int | None = None) -> dict:
    """Launch layout of K1's ring kernel for ``B`` pairs whose band keeps
    ``span`` words live (:func:`.striped.ring_span`): ``lanes`` a pair (the
    ring's threads, 8 register slots each), ``pairs`` a block, ``threads``
    a block and ``blocks``.  A ring below a warp takes the fewest lanes, a
    power of two, whose slots hold the span and one slot more, and ``32 // lanes`` pairs
    share a one-warp block (the last block's extra rings repeat the last
    pair and write nothing); a larger one takes the least warp multiple
    (:func:`ring_threads`), a pair a block.  ``lanes`` forces a ring size
    (a power of two below 32 or a warp multiple) that holds the span.
    Raises ``ValueError`` past ``max_words`` live words (default
    :data:`RING_MAX_WORDS`, K1's; K4's and K3's rings take
    :data:`RING_K4_MAX_WORDS`)."""
    most = RING_MAX_WORDS if max_words is None else max_words
    if span > most:
        raise ValueError(f"ring kernel: {span} live words exceed the ring's {most}")
    if lanes is None:
        # One slot to spare: a ring below a warp whose slots the live run
        # fills keeps its top on the slow path (a word of the next lap in
        # the top's lane), which cost more than twice the slots on the card
        # (PERF.md §6).
        lanes = 1
        while lanes < 32 and lanes * STRIPED_WORDS_PER_THREAD <= span:
            lanes *= 2
        if lanes * STRIPED_WORDS_PER_THREAD <= span:
            lanes = ring_threads(span)
    elif not (0 < lanes <= most // STRIPED_WORDS_PER_THREAD
              and (lanes & (lanes - 1) == 0 if lanes < 32 else lanes % 32 == 0)
              and span <= lanes * STRIPED_WORDS_PER_THREAD):
        raise ValueError(f"lanes must be a power of two below 32 or a warp multiple up to "
                         f"{most // STRIPED_WORDS_PER_THREAD} whose 8 slots each hold the "
                         f"{span} live words, got {lanes}")
    pairs = 32 // lanes if lanes < 32 else 1
    return dict(lanes=lanes, pairs=pairs, threads=max(lanes, 32), blocks=-(-B // pairs))


def _launch_banded_ring(a0, a1, pb0, pb1, n, m, band_words, diag, lanes=None):
    """K1 on the card: the shared schedule's costs from one pass over a
    ring of resident words (``lanes`` forces the ring's lanes, as
    :func:`banded_ring_layout`)."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = _check("banded_ring", a0, a1, pb0, pb1, band_words)
    plan = striped.plan_striped(n_max, S, SW, diag)
    n_lim = _cost_n_lim(n, n_max)
    lay = banded_ring_layout(striped.ring_span(plan, n_lim), B, lanes)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    ev = ring_events(plan, lay["lanes"] * STRIPED_WORDS_PER_THREAD)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    head = [_ring_codes(a0, a1), pb0, pb1, n_t, m_t, _loend(plan, n, n_t, n_max, dev),
            to_tensor(ev, dev), out]
    ints = [n_max, B, S, SW, ev.shape[1], n_lim, lay["lanes"]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_banded_ring(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"banded_ring kernel launch failed: cudaError {rc}")
    _count("banded_ring")
    return out


#: Largest ring of K4's and K3's ring kernels (``kMaxRingThreads * kK`` in
#: ``csrc/pinned.cu``): 256 threads of 8 register slots.
RING_K4_MAX_WORDS = 256 * STRIPED_WORDS_PER_THREAD

def banded_ring_pp_tables(a0, a1, n, schedule, SW: int, quantum: int,
                          col_block: int | None = None, lanes: int | None = None) -> dict:
    """What K4's ring launch reads besides the planes, built on the card
    from the uploaded schedule: ``plan`` (:func:`.pinned.plan_pp`), ``ev``
    (B, 3, nw_pad) per-pair event rows (:func:`ring_pp_events`'s), ``lay``
    (:func:`banded_ring_layout` of the most live words of any pair up to
    its own last capture, :func:`.pinned.ring_span_pp` at each pair's n,
    read back once), the pairs' char codes (:func:`_ring_codes`) and, with
    ``col_block``, ``CB``, ``n_ck`` and the window tops ``ckw0`` (n_ck, B).
    The ring stops each pair at its own last capture in ck mode too: K4's
    checkpoints past a pair's end hold its last window, which the capture
    writes.  Checks the schedule (:func:`.pinned.check_pp_schedule`; a
    shift at column 0 is taken) and, with ``col_block``, the interval
    (:func:`.pinned.k4_ring_takes`)."""
    dev = a0.device
    n_max, B = a0.shape
    sched = pinned.check_pp_schedule(schedule, n_max, B, quantum, column0=True)
    tab = {}
    if col_block is not None:
        if not pinned.k4_ring_takes(n_max, SW, col_block, quantum):
            raise ValueError(f"K4 ring: col_block {col_block} < band_words {SW}")
        CB = banded.ck_col_block(col_block, n_max, quantum)
        tab.update(CB=CB, n_ck=-(-n_max // CB))
    n_host = np.asarray(torch.as_tensor(n).cpu(), np.int64)
    plan = pinned.plan_pp(sched, n_host, SW, dev)
    span = int(pinned.ring_span_pp(plan, np.maximum(n_host, 1), SW).max())
    lay = banded_ring_layout(span, B, lanes, RING_K4_MAX_WORDS)
    tab.update(plan=plan, lay=lay, code=_ring_codes(a0, a1),
               ev=_pp_event_rows(plan, lay["lanes"] * STRIPED_WORDS_PER_THREAD, dev))
    if col_block is not None:
        tab["ckw0"] = pinned.ck_tops(plan["lo"], tab["CB"], tab["n_ck"])
    return tab


def _launch_banded_ring_pp(a0, a1, pb0, pb1, n, m, schedule, band_words, quantum,
                           col_block=None, lanes=None, tables=None):
    """K4 on the card: per-pair costs (and, with ``col_block``, K4's
    checkpoints) from one pass over rings of resident words, K1's layout on
    per-pair event rows.  ``tables`` (from :func:`banded_ring_pp_tables`)
    skips building them; ``lanes`` forces the ring's lanes."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    ck = col_block is not None
    key = "banded_ring_ck_pp" if ck else "banded_ring_pp"
    SW = _check(key, a0, a1, pb0, pb1, band_words)
    tab = tables or banded_ring_pp_tables(a0, a1, n, schedule, SW, quantum, col_block, lanes)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    head = [tab["code"], pb0, pb1, n_t, m_t, tab["plan"]["loend"], tab["ev"], out]
    ints = [n_max, B, S, SW, tab["ev"].shape[2], tab["lay"]["lanes"]]
    outs = ()
    if ck:
        n_ck = tab["n_ck"]
        outs = (torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
                torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
                torch.empty((n_ck, B), dtype=torch.int32, device=dev))
        head += list(outs) + [tab["ckw0"]]
        ints += [tab["CB"], n_ck]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"astarpa_{key}")(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")
    _count(key)
    return (out,) + outs if ck else out


def _launch_banded_ring_ck(a0, a1, pb0, pb1, n, m, band_words, col_block, diag,
                           lanes=None):
    """K2 on the card: the shared schedule's costs and checkpoints from one
    pass over rings of resident words, K1's layout (:func:`banded_ring_layout`
    of :func:`.striped.ring_span` at the longest pair's n, each pair stopped
    at its own last capture) writing K4's checkpoint rows: the row cursor
    for the checkpoints at or before a pair's end, each captured word's
    state and value into those past it.  ``lanes`` forces the ring's
    lanes.  Raises ``ValueError`` where :func:`k2_kernel` refuses the
    interval, or past :data:`RING_K4_MAX_WORDS` live words."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = _check("banded_ring_ck", a0, a1, pb0, pb1, band_words)
    CB = banded.ck_col_block(col_block, n_max)
    n_ck = -(-n_max // CB)
    if CB < SW and n_ck > 2:
        raise ValueError(f"K2 ring: col_block {CB} < band_words {SW} with "
                         f"{n_ck - 1} capture windows")
    plan = striped.plan_striped(n_max, S, SW, diag)
    lay = banded_ring_layout(striped.ring_span(plan, _cost_n_lim(n, n_max)), B, lanes,
                             RING_K4_MAX_WORDS)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    ev = ring_events(plan, lay["lanes"] * STRIPED_WORDS_PER_THREAD)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    outs = (torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
            torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
            torch.empty((n_ck, B), dtype=torch.int32, device=dev))
    head = [_ring_codes(a0, a1), pb0, pb1, n_t, m_t, _loend(plan, n, n_t, n_max, dev),
            to_tensor(ev, dev), out, *outs, to_tensor(striped.ck_tops(plan["lo"], CB, n_ck), dev)]
    ints = [n_max, B, S, SW, ev.shape[1], lay["lanes"], CB, n_ck]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_banded_ring_ck(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"banded_ring_ck kernel launch failed: cudaError {rc}")
    _count("banded_ring_ck")
    return (out,) + outs


def banded_ring_fill_tables(a0, a1, n, S: int, SW: int, diag,
                            lanes: int | None = None) -> dict:
    """What K3's ring launch reads besides the planes: ``plan``
    (:func:`.striped.plan_striped`), ``ev`` (:func:`ring_events`), ``lay``
    (:func:`banded_ring_layout` of :func:`.striped.ring_span` at the
    longest pair's n, as K1's), the char codes and ``tab`` (2 * n_max,)
    int32: ``lo(c)`` then ``R(c) = c * SW - lo(c)`` (word W's row after
    column c sits at ``W + R(c)`` in its pair's (n_max, SW) planes).
    Raises ``ValueError`` via :func:`fill_plane_check`."""
    n_max, B = a0.shape
    fill_plane_check(n_max, SW)
    plan = striped.plan_striped(n_max, S, SW, diag)
    n_lim = _cost_n_lim(n, n_max)
    lay = banded_ring_layout(striped.ring_span(plan, n_lim), B, lanes, RING_K4_MAX_WORDS)
    lo = plan["lo"].astype(np.int64)
    tab = np.concatenate([lo, np.arange(n_max, dtype=np.int64) * SW - lo]).astype(np.int32)
    return dict(plan=plan, lay=lay, n_lim=n_lim, code=_ring_codes(a0, a1),
                ev=to_tensor(ring_events(plan, lay["lanes"] * STRIPED_WORDS_PER_THREAD),
                             a0.device),
                tab=to_tensor(tab, a0.device))


def fill_plane_check(n_max: int, SW: int) -> None:
    """K3's ring indexes a pair's (n_max, SW) planes in 32 bits from a
    64-bit pair base: raises ``ValueError`` when one pair's plane holds
    2^31 words or more (the batch's planes may hold any number)."""
    if n_max * SW >= 1 << 31:
        raise ValueError(f"banded_fill: a pair's plane of {n_max * SW} words exceeds 2^31")


def _launch_banded_ring_fill(a0, a1, pb0, pb1, n, m, band_words, diag, lanes=None,
                             tables=None):
    """K3 on the card: K1's ring storing each live word's state after each
    column below its pair's end, then each pair's rows past its end from
    its row n - 1 (``tables`` as :func:`banded_ring_fill_tables`), into
    pair-major (B, n_max, SW) storage, returned as (n_max, SW, B) views."""
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = _check("banded_ring_fill", a0, a1, pb0, pb1, band_words)
    tab = tables or banded_ring_fill_tables(a0, a1, n, S, SW, diag, lanes)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    planes = (torch.empty((B, n_max, SW), dtype=torch.int32, device=dev),
              torch.empty((B, n_max, SW), dtype=torch.int32, device=dev))
    head = [tab["code"], pb0, pb1, n_t, m_t, _loend(tab["plan"], n, n_t, n_max, dev),
            tab["ev"], out, *planes, tab["tab"]]
    ints = [n_max, B, S, SW, tab["ev"].shape[1], tab["n_lim"], tab["lay"]["lanes"]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = load().astarpa_banded_ring_fill(*(t.data_ptr() for t in head), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"banded_ring_fill kernel launch failed: cudaError {rc}")
    _count("banded_ring_fill")
    return (out,) + tuple(x.permute(1, 2, 0) for x in planes)


def pinned_pp_events(sched: np.ndarray, n, SW: int, threads: int, n_lim, dev):
    """Device-side event tables of a per-pair striped launch, built on the
    card from the uploaded schedule (cumsum and a batched searchsorted,
    :func:`.pinned.plan_pp`): ``(plan, ev (B, 4, nw_pad), stripe_t (B,
    n_stripes, 2), nsp (B,))`` int32 tensors, each pair's rows as
    :func:`striped_events` builds the shared ones (``end_t`` stops each
    word after column ``n_lim[p] - 1``); ``nsp`` is each pair's stripe
    count."""
    ws = threads * STRIPED_WORDS_PER_THREAD
    plan = pinned.plan_pp(sched, n, SW, dev, pad_to=ws)
    ent, top, ab = plan["ent_t"], plan["top_t"], plan["abs_t"]
    B, nw_pad = ent.shape
    nwl = to_tensor(plan["nwl"], dev)
    w = torch.arange(nw_pad, dtype=torch.int32, device=dev)[None, :]
    end = torch.minimum(torch.where(ab < striped.NEVER, ab + 1, striped.NEVER),
                        n_lim[:, None] + w)
    # Pad words never enter; their end_t repeats the last word's.
    end = torch.where(w < nwl[:, None], end, end.gather(1, (nwl - 1)[:, None]))
    ev = torch.stack([ent, top, ab, end], 1).contiguous()
    first = torch.arange(0, nw_pad, ws, device=dev)
    stripe_t = torch.stack([ent[:, first], end[:, first + ws - 1]], 2).contiguous()
    nsp = to_tensor(-(-plan["nwl"] // ws), dev).to(torch.int32)
    return plan, ev, stripe_t, nsp


def _launch_pinned_pp(kernel, a0, a1, pb0, pb1, n, m, schedule, band_words,
                      quantum, col_block=None, stripe_words=None):
    from ._build import load

    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    SW = _check(kernel, a0, a1, pb0, pb1, band_words)
    sched = pinned.check_pp_schedule(schedule, n_max, B, quantum)
    ck = col_block is not None
    if ck:
        CB, n_ck = pinned.ck_layout_pp(col_block, n_max, quantum, SW)
    n_host = np.asarray(torch.as_tensor(n).cpu(), np.int64)
    n_t, m_t = lengths(n, B, dev), lengths(m, B, dev)
    # Cost mode stops each pair's words after its own last column;
    # checkpoints are defined (and compared) up to n_max.
    n_lim = torch.full_like(n_t, n_max) if ck else n_t.clamp(min=1)
    threads = striped_threads(SW, stripe_words)
    code = ((a0 & 1) | (a1 & 2)).to(torch.uint8).T.contiguous()
    plan, ev, stripe_t, nsp = pinned_pp_events(sched, n_host, SW, threads, n_lim, dev)
    T = plan["T"]
    carry = torch.empty((2, B, T + 1), dtype=torch.uint8, device=dev)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    head = [code, pb0, pb1, n_t, m_t, plan["loend"], ev, stripe_t, nsp, carry, out]
    ints = [n_max, B, S, SW, ev.shape[2], stripe_t.shape[1], T, threads]
    outs = ()
    if ck:
        outs = (torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
                torch.empty((n_ck, SW, B), dtype=torch.int32, device=dev),
                torch.empty((n_ck, B), dtype=torch.int32, device=dev))
        head += list(outs) + [pinned.ck_tops(plan["lo"], CB, n_ck)]
        ints += [CB, n_ck]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(load(), f"astarpa_{kernel}")(
            *(t.data_ptr() for t in head), *ints, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    _count(kernel)
    return (out,) + outs if ck else out


def _check(kernel, a0, a1, pb0, pb1, band_words) -> int:
    """Validate the planes; returns ``SW = min(band_words, S)``."""
    dev = a0.device
    n_max, B = a0.shape
    S = pb0.shape[0]
    for name, x, shape in (("a0", a0, (n_max, B)), ("a1", a1, (n_max, B)),
                           ("pb0", pb0, (S, B)), ("pb1", pb1, (S, B))):
        if x.device != dev or x.dtype != torch.int32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"{kernel}: {name} must be a contiguous int32 {shape} tensor "
                f"on {dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    SW = min(band_words, S)
    if SW < 1:
        raise ValueError(f"{kernel}: band_words must be >= 1, got {band_words}")
    return SW
