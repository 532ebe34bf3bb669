"""Temporal step, Moshi: the bound of one frame's temporal step (its
weights and text head once, the position's embedding rows, the KV cache
read at the calls' mean context: bytes over 3.35 TB/s, or operations over
the dtype's peak if more) over the mean device time of the rows launched
inside a `moshi.temporal` span (`cudabench/spans_moshi.py`)."""

import numpy as np

from cudabench import spans_moshi


def read(rec):
    got = spans_moshi.frames(rec)
    done = [r for r in rec["records"] if r.end is not None and r.error is None
            and rec["w0"] <= r.start < rec["w1"]]
    if got is None or not done:
        return None
    f, c, dt = rec["flops"], rec["cfg"]["moshi"], rec["cfg"]["compute_dtype"]
    ctx = float(np.mean([len(r.sess.ids) + 1 + r.chunk_n[0] / 2 for r in done]))
    bound = max(f.temporal_bytes(c, int(ctx), dt) / f.PEAK_BYTES,
                f.temporal_step(c, int(ctx)) / f.PEAK_FLOPS[dt])
    spent = float(np.mean([d for *_, d in got[spans_moshi.TEMPORAL]]))
    return 100.0 * bound / spent if spent > 0 else None
