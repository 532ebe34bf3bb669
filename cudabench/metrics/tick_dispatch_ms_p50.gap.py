"""Scheduler: the median host wall of issuing one serve tick
(`stats()["tick_dispatch_ms_p50"]` at the window's close; the batcher keeps
its last 100 ticks)."""


def read(rec):
    s = rec.get("stats_end")
    return None if not s or s.get("tick_dispatch_ms_p50") is None else float(s["tick_dispatch_ms_p50"])
