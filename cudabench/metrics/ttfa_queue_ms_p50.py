"""Scheduler: the median wait from a session's request build to its
admission (`stats()["ttfa_queue_p50_ms"]` at the window's close; the
batcher keeps its last 100 sessions)."""


def read(rec):
    s = rec.get("stats_end")
    return None if not s or s.get("ttfa_queue_p50_ms") is None else float(s["ttfa_queue_p50_ms"])
