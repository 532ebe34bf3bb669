"""Mesh: the largest over the shards of the median host wall of issuing
one shard's part of a tick (`stats()["shard_dispatch_ms_p50"]`, last 100
ticks, at the end of the window's unprofiled part)."""


def read(rec):
    s = rec.get("stats_end")
    xs = [x for x in (s or {}).get("shard_dispatch_ms_p50", []) if x is not None]
    return max(xs) if xs else None
