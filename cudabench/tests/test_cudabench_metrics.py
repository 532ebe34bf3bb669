"""The end-to-end arithmetic: a p95 over all requests, a rate over the whole
window, and a stall in the window moves both."""

import numpy as np

from cudabench.run import Record, end_to_end
from cudabench.traffic import Session

HOP, SR = 1920, 24000


def _served(stall_at=None, stall=0.0):
    """40 sessions due every 0.5 s from t=0, first chunk 0.1 s after due,
    then a chunk of 16 frames every 0.2 s, 10 chunks; a stall delays
    everything after `stall_at` by `stall` seconds."""
    recs = []
    shift = lambda t: t + stall if stall_at is not None and t >= stall_at else t
    for i in range(40):
        due = 0.5 * i
        r = Record(Session(i, due, np.zeros(8, np.int32), 160, 0, 1, False), "x", due)
        r.start = due
        r.chunk_t = [shift(due + 0.1 + 0.2 * k) for k in range(10)]
        r.chunk_n = [16] * 10
        r.end = r.chunk_t[-1]
        recs.append(r)
    return {"records": recs, "w0": 0.0, "w1": 20.0, "hop": HOP}


def test_serve_metrics_over_all_requests_and_the_whole_window():
    res = _served()
    m = end_to_end(res, {"entry": "serve"}, 20.0, SR)
    assert res["attempted"] == 40 and res["failed"] == 0
    assert abs(m["ttfa_p95_ms"] - 100.0) < 1e-6
    assert abs(m["chunk_gap_p95_ms"] - 200.0) < 1e-6
    inside = sum(1 for r in res["records"] for t in r.chunk_t if t < 20.0)
    assert abs(m["audio_s_per_s"] - inside * 16 * HOP / SR / 20.0) < 1e-9


def test_a_stall_moves_the_tail_and_the_rate():
    base = end_to_end(_served(), {"entry": "serve"}, 20.0, SR)
    stalled = end_to_end(_served(stall_at=10.0, stall=1.5), {"entry": "serve"}, 20.0, SR)
    assert stalled["ttfa_p95_ms"] > base["ttfa_p95_ms"] + 500
    assert stalled["chunk_gap_p95_ms"] > base["chunk_gap_p95_ms"]
    assert stalled["audio_s_per_s"] < base["audio_s_per_s"]


def test_a_failed_session_misses_every_limit():
    res = _served()
    res["records"][3].error = "RuntimeError: boom"
    m = end_to_end(res, {"entry": "serve"}, 20.0, SR)
    assert res["failed"] == 1
    assert m["ttfa_p95_ms"] > 100.0


def _synth(stall=0.0):
    recs, t = [], 0.0
    for i in range(100):
        r = Record(Session(i, 0.0, np.zeros(8, np.int32), 400, 0, 1, False), "x", t)
        r.start = t
        t += 0.1 + (stall if i == 50 else 0.0)
        r.end = t
        r.chunk_t, r.chunk_n = [t], [401]
        recs.append(r)
    return {"records": recs, "w0": 0.0, "w1": 10.0, "hop": HOP}


def test_synth_metrics_and_a_stall():
    res = _synth()
    m = end_to_end(res, {"entry": "synthesize"}, 10.0, SR)
    assert abs(m["request_ms_p95"] - 100.0) < 1e-6
    assert abs(m["audio_s_per_s"] - 401 * HOP / SR / 0.1) < 1e-6
    s = end_to_end(_synth(stall=2.0), {"entry": "synthesize"}, 10.0, SR)
    assert s["audio_s_per_s"] < 0.85 * m["audio_s_per_s"]
    assert _synth(stall=2.0)["records"][50].end - _synth()["records"][50].end > 1.9
