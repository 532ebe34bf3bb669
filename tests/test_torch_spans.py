"""Program spans (`profiling.span`) in the fused and batch plans on the CPU
tiny model: nothing recorded and nothing allocated while no profiler runs;
under a profiler, one `sopro.synthesize` root per call with its six steps
nested in order, each span on its `record_function` range; a profiler
started on one thread records the spans of a call made on another (the
benchmark's arrangement); `synthesize_batch` under its own root."""

import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sopro_tpu_torch import profiling
from sopro_tpu_torch.codec.mimi_config import MimiConfig
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.tts import SoproTTS

from tests.test_torch_cuda import CFG, SMALL_MIMI

STEPS = ("sopro.prepare", "sopro.condition", "sopro.ar", "sopro.nar", "sopro.mimi",
         "sopro.readback")
TOL_US = 50.0


@pytest.fixture(scope="module")
def tts():
    torch.manual_seed(0)
    return SoproTTS.from_random(SoproTTSConfig(**CFG), mimi_cfg=MimiConfig(**SMALL_MIMI),
                                device="cpu")


@pytest.fixture(scope="module")
def ref(tts):
    return tts.prepare_reference(ref_tokens_tq=np.arange(80, dtype=np.int32).reshape(10, 8) % 32)


def _say(tts, ref, seed=0):
    return tts.synthesize("hello there", ref=ref, max_frames=20, seed=seed, fused=True)


def _calls(spans, root):
    """{call id: [root, children in start order]} of the calls under `root`."""
    roots = {s.call: s for s in spans if s.name == root}
    return {c: [r] + sorted((s for s in spans if s.call == c and s is not r),
                            key=lambda s: s.t0_ns)
            for c, r in roots.items()}


def _check_nested(call, root):
    r, *kids = call
    assert r.name == root and r.parent is None and r.id == r.call
    assert tuple(k.name for k in kids) == STEPS
    for k in kids:
        assert k.call == r.call and k.parent == r.id and k.thread == r.thread
        assert r.t0_ns <= k.t0_ns <= k.t1_ns <= r.t1_ns
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(kids, kids[1:]))


def test_no_profiler_records_nothing_and_allocates_nothing(tts, ref):
    profiling.clear_spans()
    wav = _say(tts, ref)
    assert wav.shape[0] == 1 and profiling.spans() == []
    assert profiling.span("sopro.a") is profiling.span("sopro.b") is profiling._NULL
    tracemalloc.start()
    try:
        with profiling.span("sopro.warm"):
            pass
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("sopro.synthesize"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "lineno")
    assert sum(d.size_diff for d in grown) == 0 and sum(d.count_diff for d in grown) == 0
    assert profiling.spans() == []


def test_each_call_records_its_root_and_six_steps_in_order(tts, ref):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (1, 2):
            _say(tts, ref, seed)
    calls = _calls(profiling.spans(), "sopro.synthesize")
    assert len(calls) == 2 and len(profiling.spans()) == 14
    for call in calls.values():
        _check_nested(call, "sopro.synthesize")
    first, second = sorted(calls.values(), key=lambda c: c[0].t0_ns)
    assert first[0].t1_ns <= second[0].t0_ns


def _misfit_us(spans, events):
    """The largest misfit of the spans on their `record_function` ranges:
    each duration against its range's, and each edge against its range's
    under the one offset that fits all edges best."""
    by_name = {e.name: e for e in events if e.name.startswith("sopro.")}
    assert sorted(by_name) == sorted(s.name for s in spans)
    dur, edge = [], []
    for s in spans:
        tr = by_name[s.name].time_range  # microseconds from the profiler's start
        dur.append(abs((s.t1_ns - s.t0_ns) / 1e3 - (tr.end - tr.start)))
        edge += [s.t0_ns / 1e3 - tr.start, s.t1_ns / 1e3 - tr.end]
    return max(max(dur), (max(edge) - min(edge)) / 2)


def test_spans_lie_on_their_record_function_ranges(tts, ref):
    """The profiler's own enter and exit cost tens of microseconds on a busy
    CPU, the first profiled call more: after one such call, the best of six
    is held to the bar."""
    misfits = []
    for seed in range(7):
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(1).add_(1)  # the profiler's first event on this thread
            _say(tts, ref, seed)
        spans = profiling.spans()
        assert len(spans) == 7
        misfits.append(_misfit_us(spans, prof.events()))
    assert min(misfits[1:]) <= TOL_US, misfits


def test_a_profiler_on_another_thread_records_the_call(tts, ref):
    """The benchmark's arrangement: the profiler runs on the main thread, the
    client calls `synthesize` from its own."""
    profiling.clear_spans()
    seen = {}

    def client():
        seen["thread"] = threading.get_ident()
        seen["wav"] = _say(tts, ref, 3)

    with profile(activities=[ProfilerActivity.CPU]):
        th = threading.Thread(target=client)
        th.start()
        th.join(timeout=120)
    assert not th.is_alive() and seen["wav"].shape[0] == 1
    calls = _calls(profiling.spans(), "sopro.synthesize")
    assert len(calls) == 1
    call = next(iter(calls.values()))
    _check_nested(call, "sopro.synthesize")
    assert call[0].thread == seen["thread"] != threading.get_ident()


def test_synthesize_batch_records_its_root_and_steps(tts, ref):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        outs = tts.synthesize_batch(["hello there", "bye"], ref=ref, max_frames=20, seeds=[4, 5])
    assert len(outs) == 2
    calls = _calls(profiling.spans(), "sopro.synthesize_batch")
    assert len(calls) == 1 and len(profiling.spans()) == 7
    _check_nested(next(iter(calls.values())), "sopro.synthesize_batch")
