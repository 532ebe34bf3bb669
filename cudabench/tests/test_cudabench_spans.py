"""The span readers (`cudabench/spans.py`, `metrics/*.synth.py`) on a
synthetic trace and span store: the idle split, the clock offset from the
harness's closing `cudaDeviceSynchronize` row, a device clock that drifts against the
host's mapped back through the launches, and nothing read where there is no
whole call, no span, a K1 that starts before its `sopro.ar`, or a launch
without its row."""

import os

import pytest

from cudabench import spans
from cudabench.run import load_reader
from cudabench.trace import union
from sopro_tpu_torch.profiling import Span

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
READERS = {"idle_caller_pct.synth": "caller_pct", "idle_issue_pct.synth": "issue_pct",
           "idle_readback_pct.synth": "readback_pct", "issue_ms_p50.synth": "issue_ms_p50",
           "launches_per_call.synth": "launches_per_call"}
T_A, WINDOW = 1000.0, 3.0  # the stretch's start (perf seconds) and length
OFF = T_A  # perf seconds = host profiler seconds + OFF
CALL, GAP = 0.100, 0.005  # a call's wall and the caller's gap after it
# each step's (start, end) in seconds from the call's start
STEPS = {"sopro.prepare": (0.001, 0.003), "sopro.condition": (0.003, 0.010),
         "sopro.ar": (0.010, 0.012), "sopro.nar": (0.012, 0.014), "sopro.mimi": (0.014, 0.016),
         "sopro.readback": (0.016, 0.095)}
# what the host enqueues (its row's name and start) and the card's row (its
# name, start and end), the same offsets: a copy in, a kernel onto the idle
# card, K1, NAR and Mimi queued behind it, the copy out behind them; the host
# copies out of the staging buffer until 0.095
WORK = (("cudaMemcpyAsync", 0.0015, "Memcpy HtoD (Pageable -> Device)", 0.0015, 0.0016),
        ("cudaLaunchKernel", 0.004, "cond_kernel", 0.004, 0.0041),
        ("cudaLaunchKernelExC", 0.0105, "ar_loop_kernel<float>", 0.0105, 0.070),
        ("cudaLaunchKernel", 0.013, "nar_heads_kernel", 0.070, 0.080),
        ("cuLaunchKernel", 0.015, "mimi_kernel", 0.080, 0.0805),
        ("cudaMemcpyAsync", 0.016, "Memcpy DtoH (Device -> Pageable)", 0.0805, 0.085))
PER_CALL = {"issue": 0.0015 + (0.004 - 0.0016) + (0.0105 - 0.0041) + (CALL - 0.095),
            "readback": 0.095 - 0.085}


def _synthetic(k1_early=False, sync_end=WINDOW, shift=0.0, drift=0.0, skew=0.0, unpaired=0,
               drop_row=None):
    """Calls back to back from 12 ms before the stretch to past its end.
    `shift` moves every host profiler row (the sync row too); the card's
    clock reads `(1 + drift) * host + skew`; the first `unpaired` host rows
    have no row on the card, and the card's row `drop_row` is missing."""
    store, kernels, host, sid = [], [], [], 0
    card = lambda h: (1.0 + drift) * h + skew
    t = -0.012
    while t < WINDOW + 0.05:
        sid += 1
        root = sid
        ns = lambda x: int(round((OFF + t + x) * 1e9))
        for name, (a, b) in STEPS.items():
            sid += 1
            store.append(Span(name, sid, root, root, 7, ns(a), ns(b)))
        store.append(Span("sopro.synthesize", root, root, None, 7, ns(0.0), ns(CALL)))
        for api, at, row, a, b in WORK:
            if k1_early and row.startswith("ar_loop"):
                at, a = at - 0.0015, a - 0.0015
            if t + at >= 0.0:
                host.append((api, t + at + shift, t + at + shift + 5e-6))
                kernels.append((row, card(t + a + shift), card(t + b + shift), 0))
        t += CALL + GAP
    host = host[unpaired:]
    if drop_row is not None:
        del kernels[drop_row]
    host.append((spans.SYNC, sync_end - 0.01 + shift, sync_end + shift))
    rec = {"trace": {"kernels": kernels, "host": host, "window_s": WINDOW},
           "span": (T_A - 10.0, T_A)}
    return rec, store


def _whole(store):
    return [x for x in store if x.name == "sopro.synthesize"
            and T_A <= x.t0_ns * 1e-9 and x.t1_ns * 1e-9 <= T_A + WINDOW]


def test_the_three_idle_shares_add_up_to_the_covered_idle_share():
    rec, store = _synthetic()
    s = spans.split(rec, store)
    whole = _whole(store)
    c0, c1 = whole[0].t0_ns * 1e-9, whole[-1].t1_ns * 1e-9
    n = len(whole)
    assert s["calls"] == n == 27
    busy = union([(max(a + OFF, c0), min(b + OFF, c1)) for _, a, b, _ in rec["trace"]["kernels"]
                  if b + OFF > c0 and a + OFF < c1])
    covered_idle = 100.0 * (1.0 - sum(b - a for a, b in busy) / (c1 - c0))
    total = s["caller_pct"] + s["issue_pct"] + s["readback_pct"]
    assert abs(total - covered_idle) < 1e-9
    assert abs(total - s["idle_pct"]) < 1e-9
    for key in ("issue", "readback"):
        assert s[f"{key}_pct"] == pytest.approx(100.0 * n * PER_CALL[key] / (c1 - c0), rel=1e-6)
    assert s["caller_pct"] == pytest.approx(100.0 * (n - 1) * GAP / (c1 - c0), rel=1e-6)
    assert s["issue_ms_p50"] == pytest.approx(12.0, abs=1e-6)
    assert s["launches_per_call"] == 4
    assert s["residual_s"] == pytest.approx(-0.0005, abs=1e-6)  # K1 0.5 ms into sopro.ar


def test_the_offset_comes_from_the_closing_sync_row():
    rec, _ = _synthetic(sync_end=2.95)
    assert spans.offset_s(rec) == pytest.approx(T_A + WINDOW - 2.95, abs=1e-9)
    rec, store = _synthetic(shift=0.3)
    assert spans.offset_s(rec) == pytest.approx(OFF - 0.3, abs=1e-9)
    shifted, base = spans.split(rec, store), spans.split(*_synthetic())
    for key in READERS.values():
        assert shifted[key] == pytest.approx(base[key], abs=1e-6)


def test_the_offset_comes_from_the_harness_s_row_and_not_the_profiler_s():
    """The profiler's stop adds a `cudaDeviceSynchronize` row that ends 1 ms
    after the harness's (the window closed while K1's launch queue drained):
    the offset comes from the row that ends nearest the stretch's length, and
    the shares read as without the profiler's row. From the last row the
    host's rows would map 1 ms early, K1 before its `sopro.ar`."""
    rec, store = _synthetic()
    base = spans.split(rec, store)
    rec["trace"]["host"].append((spans.SYNC, WINDOW + 0.0002, WINDOW + 0.001))
    assert spans.offset_s(rec) == pytest.approx(OFF, abs=1e-9)
    got = spans.split(rec, store)
    assert got is not None
    for key in READERS.values():
        assert got[key] == pytest.approx(base[key], abs=1e-9)


@pytest.mark.parametrize("kw", [dict(drift=0.02, skew=0.030), dict(drift=-0.01, skew=-0.2),
                                dict(unpaired=2), dict(unpaired=2, drift=0.02)],
                         ids=["fast card clock", "slow card clock", "rows before the stretch",
                              "both"])
def test_the_card_reaches_the_host_clock_through_its_launches(kw):
    """A card clock off in rate and offset (CUPTI's drifted by tens of ms
    over 3 s on an H100), or launches before the stretch whose rows are not
    in it, read as the card on the host's clock does."""
    base = spans.split(*_synthetic())
    got = spans.split(*_synthetic(**kw))
    for key in ("caller_pct", "issue_pct", "readback_pct", "issue_ms_p50", "launches_per_call"):
        assert got[key] == pytest.approx(base[key], rel=1e-6, abs=1e-9)


def test_a_call_whose_rows_left_the_trace_is_not_whole():
    """The profiler keeps no device row stamped past its end: the last calls'
    rows go, and with them those calls."""
    rec, store = _synthetic()
    ends = sorted(b for _, _, b, _ in rec["trace"]["kernels"])
    cut = _whole(store)[-1].t0_ns * 1e-9 - OFF + 0.05
    rec["trace"]["kernels"] = [k for k in rec["trace"]["kernels"] if k[2] < cut]
    assert len(ends) > len(rec["trace"]["kernels"])
    s = spans.split(rec, store)
    assert s["calls"] == len(_whole(store)) - 1
    assert abs(s["caller_pct"] + s["issue_pct"] + s["readback_pct"] - s["idle_pct"]) < 1e-9


def _readers(rec, store, monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: list(store))
    return {name: load_reader(ROOT_DIR, name)(rec) for name in READERS}


def test_each_reader_reads_its_share(monkeypatch):
    rec, store = _synthetic()
    want = spans.split(rec, store)
    got = _readers(rec, store, monkeypatch)
    assert got == {name: want[key] for name, key in READERS.items()}


def _no_whole_call():
    rec, store = _synthetic()
    whole = set(_whole(store))
    return rec, [x for x in store if x not in whole]


def _no_sync_row():
    rec, store = _synthetic()
    rec["trace"]["host"] = [h for h in rec["trace"]["host"] if h[0] != spans.SYNC]
    return rec, store


@pytest.mark.parametrize("case", [
    _no_whole_call,
    lambda: (_synthetic()[0], []),  # an untraced program, or one without spans
    lambda: _synthetic(k1_early=True),
    lambda: _synthetic(drop_row=6 * 14 + 3),  # a copy of a call in mid-stretch
    _no_sync_row,
    lambda: ({"trace": None, "span": (0.0, 1.0)}, _synthetic()[1]),
], ids=["no whole call", "no spans", "K1 before its sopro.ar", "a launch without its row",
        "no closing sync row", "no trace"])
def test_readers_read_nothing(case, monkeypatch):
    rec, store = case()
    assert spans.split(rec, store) is None
    assert _readers(rec, store, monkeypatch) == {name: None for name in READERS}
