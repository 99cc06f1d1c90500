"""The port's recorder (``utils/spans.py``): nothing while it is off; while
it is on, the runner's spans nest as the layers do, every kernel wrapper
call leaves one launch record of its shape, and the trace pool's spans run
on threads of their own.  This file imports no JAX, so a GPU host runs its
card test with ``--noconftest -m cuda``."""

import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from astarpa_tpu_torch import native
from astarpa_tpu_torch.generate import ErrorModel, generate_model
from astarpa_tpu_torch.ops import banded_kernel, nw_kernel
from astarpa_tpu_torch.ops.pack import pack_batch_staggered
from astarpa_tpu_torch.parallel.runner import BatchAligner
from astarpa_tpu_torch.utils import spans

torch.set_num_threads(1)


def _pairs(seed, count=3, n=60, e=0.15):
    return [generate_model(n + 7 * i, e, ErrorModel.UNIFORM, seed=seed + i)
            for i in range(count)]


#: Two tiny batches; a start band of one word makes their rungs retry.
BATCHES = [_pairs(1), _pairs(11)]


def _ranges(prof):
    """The program's spans in a trace: ``(name, start, end, thread)`` in
    start order, the name without its prefix."""
    return sorted(((e.name()[len(spans.PREFIX):], e.start_ns(), e.end_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(spans.PREFIX)),
                  key=lambda r: (r[1], -r[2]))


def _parent(ranges, k):
    """The innermost range of the same thread that holds range ``k``."""
    name, s, e, th = ranges[k]
    holders = [j for j, (_, s2, e2, th2) in enumerate(ranges)
               if j != k and th2 == th and s2 <= s and e <= e2]
    return max(holders, key=lambda j: ranges[j][1], default=None)


def _cost_stream(aligner, recording: bool):
    """The two batches through ``cost_iter`` under a CPU profiler, the
    recorder on or off; the profiler and the launch records."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if recording:
            with spans.recording() as launches:
                out = list(aligner.cost_iter(iter(BATCHES)))
        else:
            launches = None
            out = list(aligner.cost_iter(iter(BATCHES)))
    assert len(out) == len(BATCHES)
    return prof, launches


def test_off_records_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(spans, "record_function", lambda name: calls.append(name))
    prof, _ = _cost_stream(BatchAligner(device="cpu", band_words=1), recording=False)
    assert not spans.on() and spans._launches is None
    assert calls == [] and _ranges(prof) == []
    assert spans.span("pack") is spans.span("launch")


def test_on_spans_nest_by_layer(monkeypatch):
    aligner = BatchAligner(device="cpu", band_words=1)
    rungs = []
    start = aligner._rung_start

    def spy(pairs, lad, stats, trace_jobs=None):
        rung = start(pairs, lad, stats, trace_jobs)
        rungs.append((min(rung["sw"], rung["S"]), int(np.sum(lad["packed"][0].n))))
        return rung
    monkeypatch.setattr(aligner, "_rung_start", spy)
    prof, launches = _cost_stream(aligner, recording=True)
    assert not spans.on() and spans._launches is None
    r = _ranges(prof)
    main = {th for name, _, _, th in r if name == "dispatch"}
    assert len(main) == 1 and {th for *_, th in r} == main
    parent = {k: (r[p][0] if (p := _parent(r, k)) is not None else None) for k in range(len(r))}
    allowed = {"dispatch": {None}, "finish": {None}, "bucket": {"dispatch"},
               "pack": {"rung_start"}, "launch": {"rung_start"},
               "rung_start": {"dispatch", "finish"}, "rung_finish": {"finish"},
               "readback_wait": {"rung_finish"}}
    for k, (name, *_rest) in enumerate(r):
        assert parent[k] in allowed[name], (name, parent[k])
    names = [name for name, *_ in r]
    assert names.count("dispatch") == names.count("finish") == len(BATCHES)
    # Retries: rungs started inside a finish, siblings of the rung_finish
    # that asked for them.
    retries = sum(1 for k, name in enumerate(names) if name == "rung_start" and parent[k] == "finish")
    assert retries > 0 and names.count("rung_start") == len(rungs) == names.count("launch")
    assert names.count("rung_finish") == names.count("readback_wait") == len(rungs)
    # One record a rung: its run band and its packed pairs' columns.
    assert [(x["band_words"], x["columns"]) for x in launches] == rungs
    assert {x["kernel"] for x in launches} == {"banded_cost_ref"}
    assert {x["thread"] for x in launches} == {threading.get_native_id()}
    assert all(x["stream"] is None and x["in_bytes"] > 0 and x["out_bytes"] > 0
               for x in launches)


def test_switch_comes_back_after_an_exception():
    with pytest.raises(RuntimeError):
        with spans.recording():
            raise RuntimeError("inside the window")
    assert not spans.on() and spans._launches is None
    with spans.recording() as outer:
        with pytest.raises(RuntimeError):
            with spans.recording():
                raise RuntimeError("inside an inner window")
        assert spans.on() and spans._launches is outer
    assert not spans.on()


def _sched(args):
    return np.zeros(args[0].shape, np.uint8)


#: Each public kernel wrapper on a tiny CPU pack: its call and the band it
#: is asked for (None: the full height).
WRAPPERS = {
    "banded_cost": (lambda p: banded_kernel.banded_cost(*p, 4), 4),
    "banded_ck": (lambda p: banded_kernel.banded_ck(*p, 4, 64), 4),
    "banded_fill": (lambda p: banded_kernel.banded_fill(*p, 4), 4),
    "banded_fill_pp": (lambda p: banded_kernel.banded_fill_pp(*p, _sched(p), 4), 4),
    "banded_cost_pp": (lambda p: banded_kernel.banded_cost_pp(*p, _sched(p), 4), 4),
    "banded_ck_pp": (lambda p: banded_kernel.banded_ck_pp(*p, _sched(p), 4, 64), 4),
    "striped_cost": (lambda p: banded_kernel.striped_cost(*p, 8), 8),
    "striped_ck": (lambda p: banded_kernel.striped_ck(*p, 8, 64), 8),
    "pinned_cost": (lambda p: banded_kernel.pinned_cost(*p, 8), 8),
    "pinned_ck": (lambda p: banded_kernel.pinned_ck(*p, 8, 64), 8),
    "pinned_cost_pp": (lambda p: banded_kernel.pinned_cost_pp(*p, _sched(p), 8), 8),
    "pinned_ck_pp": (lambda p: banded_kernel.pinned_ck_pp(*p, _sched(p), 8, 64), 8),
    "nw_right_edge": (lambda p: nw_kernel.nw_right_edge(*p[:5]), None),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_each_wrapper_records_its_launch(wrapper):
    call, band = WRAPPERS[wrapper]
    # Few columns (a short), a band of 8 words (b long).
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pairs = [(rng.choice(acgt, n).tobytes(), rng.choice(acgt, m).tobytes())
             for n, m in ((40, 260), (33, 250))]
    args, _ = pack_batch_staggered(pairs, 4, device="cpu")
    S = args[2].shape[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.recording() as launches:
        out = call(args)
    outs = out if isinstance(out, tuple) else (out,)
    arrays = list(args[:5] if band is None else args) + ([_sched(args)] if "_pp" in wrapper else [])
    assert launches == [dict(
        kernel=wrapper + "_ref", band_words=S if band is None else min(band, S),
        columns=int(np.sum(args[4])),
        in_bytes=sum(x.nbytes if isinstance(x, np.ndarray) else x.numel() * x.element_size()
                     for x in arrays),
        out_bytes=sum(x.numel() * x.element_size() for x in outs),
        thread=threading.get_native_id(), stream=None)]
    assert [name for name, *_ in _ranges(prof)] == ["launch"]


def test_traces_run_in_spans_on_pool_threads():
    if not native.available():
        pytest.skip("needs the native library")
    batches = [_pairs(31), _pairs(41), _pairs(51)]
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof, \
            spans.recording():
        out = list(BatchAligner(device="cpu").align_iter(iter(batches)))
    assert len(out) == len(batches)
    r = _ranges(prof)
    main = {th for name, _, _, th in r if name == "dispatch"}
    assert len(main) == 1
    flush = [th for name, _, _, th in r if name == "flush_traces"]
    trace = [th for name, _, _, th in r if name == "trace"]
    assert len(flush) == len(batches) and set(flush) - main
    assert trace and not set(trace) & main


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_launches_link_to_their_records(gpu):
    """On the card each rung's record names the kernel that ran and its
    stream, and every kernel the program launched is correlated by the
    profiler with a launch call made inside an ``astarpa.launch`` range of
    the same thread, which started before the kernel: one kernel a
    range."""
    aligner = BatchAligner(device="cuda", band_words=1)
    list(aligner.cost_iter(iter(BATCHES)))  # builds the kernels
    torch.cuda.synchronize()
    before = dict(banded_kernel.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            spans.recording() as launches:
        list(aligner.cost_iter(iter(BATCHES)))
        torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in banded_kernel.LAUNCHES.items() if v != before[k]}
    assert sum(ran.values()) == len(launches) > len(BATCHES)
    assert {x["kernel"] for x in launches} == set(ran)
    stream = torch.cuda.current_stream(gpu).cuda_stream
    assert all(x["stream"] == stream and x["columns"] > 0 for x in launches)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = sorted((e.start_ns(), e.end_ns(), e.start_thread_id()) for e in events
                    if e.device_type() == cpu and e.name() == spans.PREFIX + "launch")
    assert len(ranges) == len(launches)
    # CUDA API calls (cudaLaunchKernel, ...) carry the correlation
    # id of the device work they queued.
    calls = {e.correlation_id(): e for e in events if e.device_type() == cpu
             and not e.is_user_annotation() and e.name().startswith("cu")}
    csrc = Path(banded_kernel.__file__).parents[1] / "csrc"
    program = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                             "".join(p.read_text() for p in csrc.glob("*.cu"))))
    kernels = [e for e in events if e.device_type() == cuda
               and any(re.search(rf"\b{k}\b", e.name()) for k in program)]
    assert len(kernels) == len(launches)
    held = []
    for k in kernels:
        call = calls[k.correlation_id()]
        held += [j for j, (s, e, th) in enumerate(ranges) if s <= call.start_ns() <= e
                 and th == call.start_thread_id() and s < k.start_ns()]
    assert sorted(held) == list(range(len(ranges)))
