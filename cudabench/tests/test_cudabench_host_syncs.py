"""`host_syncs_per_call.synth` on the synthetic trace of
`test_cudabench_spans.py`, with host rows that wait for the card planted
inside each call and in the caller's gaps between calls: it counts the ones
inside a whole call, takes its offset from the harness's closing row and not
the profiler's, and reads nothing without spans, a closing row or a whole
call."""

import pytest

from cudabench import spans
from cudabench.run import load_reader
from cudabench.tests.test_cudabench_spans import (CALL, GAP, OFF, ROOT_DIR, WINDOW, _synthetic,
                                               _whole)

NAME = "host_syncs_per_call.synth"


def _planted(rec, store, inside=(("cudaStreamSynchronize", 0.002),
                                 ("cudaEventSynchronize", 0.0125))):
    """Each call's copy out made synchronous (`cudaMemcpy`), the rows
    `inside` at their offsets into each call, and a `cudaStreamSynchronize`
    and a `cudaDeviceSynchronize` in the caller's gap after each call."""
    host = rec["trace"]["host"]
    starts = [x.t0_ns * 1e-9 - OFF for x in store if x.name == spans.ROOT]
    for t in starts:
        for i, (n, a, b) in enumerate(host):
            if n == "cudaMemcpyAsync" and abs(a - (t + 0.016)) < 1e-9:
                host[i] = ("cudaMemcpy", a, b)
        planted = list(inside) + [("cudaStreamSynchronize", CALL + GAP / 3),
                                  ("cudaDeviceSynchronize", CALL + GAP / 2)]
        # none after the closing row: the profiler stops there
        host.extend((n, t + at, t + at + 1e-5) for n, at in planted if t + at < WINDOW - 0.01)
    host.sort(key=lambda r: r[1])
    return rec, store


def _read(rec, store, monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: list(store))
    return load_reader(ROOT_DIR, NAME)(rec)


def test_counts_the_syncs_inside_each_whole_call(monkeypatch):
    rec, store = _planted(*_synthetic())
    assert _read(rec, store, monkeypatch) == 3  # the two planted and the copy out
    rec, store = _planted(*_synthetic(), inside=())
    assert _read(rec, store, monkeypatch) == 1


def test_an_asynchronous_program_counts_nothing(monkeypatch):
    """No planted rows and the copy out left asynchronous: launches and
    `cudaMemcpyAsync` rows are not syncs."""
    rec, store = _synthetic()
    assert _read(rec, store, monkeypatch) == 0


@pytest.mark.parametrize("kw", [dict(drift=0.02, skew=0.030), dict(unpaired=2)],
                         ids=["fast card clock", "rows before the stretch"])
def test_the_count_follows_the_host_clock(kw, monkeypatch):
    rec, store = _planted(*_synthetic(**kw))
    assert _read(rec, store, monkeypatch) == 3


def test_the_profilers_own_closing_row_is_not_the_harness_s(monkeypatch):
    """The profiler's stop adds a `cudaDeviceSynchronize` row after the
    harness's, which waits for work queued in between (4 ms here): the
    offset comes from the row that ends nearest the stretch's length, where
    the last row's would move each call's first sync out of the call."""
    rec, store = _planted(*_synthetic())
    rec["trace"]["host"].append((spans.SYNC, WINDOW + 0.0003, WINDOW + 0.004))
    assert spans.offset_s(rec) == pytest.approx(OFF, abs=1e-9)
    assert _read(rec, store, monkeypatch) == 3


def test_reads_without_the_device_clock(monkeypatch):
    """Host rows and spans share the host's clock: a trace whose device rows
    fail `spans.split`'s check (K1 before its `sopro.ar`) still counts."""
    rec, store = _planted(*_synthetic(k1_early=True))
    assert spans.split(rec, store) is None
    assert _read(rec, store, monkeypatch) == 3


def test_a_call_whose_rows_left_the_trace_is_not_counted(monkeypatch):
    """Of two calls, the last loses its card rows and is no longer whole:
    the syncs planted in excess there do not count (with it the median
    would read 23)."""
    rec, store = _planted(*_synthetic())
    prev, last = _whole(store)[-2:]
    store = [x for x in store if x.call in (prev.call, last.call)]
    t = last.t0_ns * 1e-9 - OFF
    rec["trace"]["kernels"] = [k for k in rec["trace"]["kernels"] if k[2] < t + 0.05]
    rec["trace"]["host"] += [("cudaStreamSynchronize", t + 0.02 + 1e-4 * i, t + 0.0201 + 1e-4 * i)
                             for i in range(40)]
    rec["trace"]["host"].sort(key=lambda r: r[1])
    assert spans.split(rec, store)["calls"] == 1
    assert _read(rec, store, monkeypatch) == 3


def _partial_calls_only():
    rec, store = _planted(*_synthetic())
    whole = set(_whole(store))
    return rec, [x for x in store if x not in whole]


def _no_closing_row():
    rec, store = _planted(*_synthetic())
    rec["trace"]["host"] = [h for h in rec["trace"]["host"] if h[0] != spans.SYNC]
    return rec, store


@pytest.mark.parametrize("case", [
    _partial_calls_only,
    _no_closing_row,
    lambda: (_planted(*_synthetic())[0], []),  # a program without spans
], ids=["only partial calls", "no closing sync row", "no spans"])
def test_reads_nothing(case, monkeypatch):
    rec, store = case()
    assert _read(rec, store, monkeypatch) is None
