"""Backbone step, CSM: the bound of one frame's backbone step (its weights,
head and frame embedding once, the KV cache read at the calls' mean
context: bytes over 3.35 TB/s, or operations over the dtype's peak if more)
over the mean device time of the rows launched inside a `csm.backbone`
span (`cudabench/spans_csm.py`)."""

import numpy as np

from cudabench import spans_csm


def read(rec):
    got = spans_csm.frames(rec)
    done = [r for r in rec["records"] if r.end is not None and r.error is None
            and rec["w0"] <= r.start < rec["w1"]]
    if got is None or not done:
        return None
    f, c, dt = rec["flops"], rec["cfg"]["csm"], rec["cfg"]["compute_dtype"]
    ctx = float(np.mean([f.prompt_len(len(r.sess.ids), rec["mix"]) + r.chunk_n[0] / 2 for r in done]))
    bound = max(f.backbone_bytes(c, int(ctx), dt) / f.PEAK_BYTES,
                f.backbone_step(c, int(ctx)) / f.PEAK_FLOPS[dt])
    spent = float(np.mean([d for *_, d in got[spans_csm.BACKBONE]]))
    return 100.0 * bound / spent if spent > 0 else None
