"""Depth decoder, CSM: the bound of one frame's 31 depth passes (the depth
weights, the projector, an embedding row and a head slice once per pass:
bytes over 3.35 TB/s, or operations over the dtype's peak if more) over the
mean device time of the rows launched inside a `csm.depth` span
(`cudabench/spans_csm.py`)."""

import numpy as np

from cudabench import spans_csm


def read(rec):
    got = spans_csm.frames(rec)
    if got is None:
        return None
    f, c, dt = rec["flops"], rec["cfg"]["csm"], rec["cfg"]["compute_dtype"]
    bound = max(f.depth_bytes(c, dt) / f.PEAK_BYTES, f.depth_frame(c) / f.PEAK_FLOPS[dt])
    spent = float(np.mean([d for *_, d in got[spans_csm.DEPTH]]))
    return 100.0 * bound / spent if spent > 0 else None
