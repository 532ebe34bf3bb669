"""Scheduler (batch occupancy): audio frames yielded to clients over the
ticks the batcher ran in the same span (both counts; the window, or in a
traced run its part before the profiled stretch)."""


def read(rec):
    s0, s1 = rec.get("stats0"), rec.get("stats_end")
    if not s0 or not s1 or s1["ticks"] <= s0["ticks"]:
        return None
    w0, w1 = rec["span"]
    frames = sum(n for r in rec["records"] for t, n in zip(r.chunk_t, r.chunk_n) if w0 <= t < w1)
    return frames / (s1["ticks"] - s0["ticks"])
