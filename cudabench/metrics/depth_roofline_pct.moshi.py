"""Depformer, Moshi: the bound of one frame's eight depformer steps (each
step's weight set, input projection, head and embedding row once, and its
cache: bytes over 3.35 TB/s, or operations over the dtype's peak if more)
over the mean device time of the rows launched inside the `moshi.depth`
spans of whole frames (`cudabench/spans_moshi.py`)."""

import numpy as np

from cudabench import spans_moshi


def read(rec):
    got = spans_moshi.frames(rec)
    if got is None or not got[spans_moshi.DEPTH]:
        return None
    f, c, dt = rec["flops"], rec["cfg"]["moshi"], rec["cfg"]["compute_dtype"]
    bound = max(f.depth_bytes(c, dt) / f.PEAK_BYTES, f.depth_frame(c) / f.PEAK_FLOPS[dt])
    spent = float(np.mean([d for *_, d in got[spans_moshi.DEPTH]]))
    return 100.0 * bound / spent if spent > 0 else None
