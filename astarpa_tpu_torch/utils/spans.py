"""The port's recorder: named host spans and kernel launch records.

Off by default.  :func:`recording` turns it on for a block::

    from torch.profiler import ProfilerActivity, profile
    from astarpa_tpu_torch.utils import spans

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \\
            spans.recording() as launches:
        for costs, stats in aligner.cost_iter(batches):
            ...

While it is on, :func:`span` opens ``torch.profiler.record_function("astarpa."
+ name)``: each span lands in the same profiler trace as the kernels and
copies, on the profiler's clock, on the thread that ran it (a pool thread's
only where the profiler follows every thread, ``profile_all_threads``), and
under ``torch.autograd.profiler.emit_nvtx()`` as an NVTX range.  Each call of
a kernel wrapper appends a launch record (:func:`note_launch`) to the list
the block yields.  While it is off, a span is one flag check that returns a
shared no-op, and nothing is recorded.

Spans (``parallel/runner.py`` unless named): ``bucket`` (``_cost_batch``),
``dispatch`` (``_cost_dispatch``, ``_align_dispatch_start``), ``pack``
(``_pack``), ``rung_start`` (one rung's routing and launch),
``launch`` (each public wrapper of ``ops/banded_kernel.py`` and
``ops/nw_kernel.py``), ``readback_wait`` (the event wait of
``_Readback.numpy``), ``rung_finish`` (one rung's certification and hint;
a retry's rung is a sibling ``rung_start``), ``finish`` (``_cost_finish``,
which ``_align_dispatch_finish`` runs whole), ``domain_round`` (each round
of ``_domain_ladder``), ``flush_traces`` (``_flush_traces``) and ``trace``
(each native ``trace_direct_batch`` / ``trace_banded_ck`` call).
"""

from __future__ import annotations

import contextlib
import threading

from torch.profiler import record_function

#: What every span's name starts with in a profiler trace.
PREFIX = "astarpa."

_on = False
# The launch records of the innermost recording block (None while off).
_launches: list | None = None
_OFF = contextlib.nullcontext()


def on() -> bool:
    """Whether the recorder is on."""
    return _on


@contextlib.contextmanager
def recording():
    """The recorder on for the block, which gets the list its launch records
    go to; the state before the block comes back after it, also when the
    block raises."""
    global _on, _launches
    before = _on, _launches
    _on, _launches = True, []
    try:
        yield _launches
    finally:
        _on, _launches = before


def span(name: str):
    """A context manager around one piece of host work: ``astarpa.<name>``
    as a ``torch.profiler.record_function`` while the recorder is on, a
    shared no-op while it is off."""
    if not _on:
        return _OFF
    return record_function(PREFIX + name)


def note_launch(kernel: str, band_words: int, columns: int | None, in_bytes: int,
                out_bytes: int, stream: int | None) -> None:
    """Append one launch record while the recorder is on: the
    ``banded_kernel.LAUNCHES`` key that ran (on the CPU the plain version's
    name), the band's words, the columns of the launched pairs (the sum of
    their ``n``; None where ``n`` is on the card, where summing it would
    wait for the device), the bytes of the wrapper's input arrays and of its
    outputs, the calling thread's native id, and the CUDA stream's handle
    (None on the CPU)."""
    if _on:
        _launches.append(dict(kernel=kernel, band_words=band_words, columns=columns,
                              in_bytes=in_bytes, out_bytes=out_bytes,
                              thread=threading.get_native_id(), stream=stream))
