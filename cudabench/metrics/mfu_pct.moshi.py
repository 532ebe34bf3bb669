"""Engine, Moshi: each call's model operations (`flops_moshi.request`: the
prefill, the temporal steps, the text heads and depformer steps, the Mimi
decode) over its wall time, as a share of the configuration dtype's peak;
the median over the calls that ran within the window (in a traced run,
before the profiled stretch)."""

import numpy as np


def read(rec):
    f, c, m = rec["flops"], rec["cfg"]["moshi"], rec["cfg"]["mimi"]
    peak = f.PEAK_FLOPS[rec["cfg"]["compute_dtype"]]
    shares = [100.0 * f.request(c, m, r.chunk_n[0], len(r.sess.ids)) / (r.end - r.start) / peak
              for r in rec["records"]
              if r.end is not None and r.error is None and rec["span"][0] <= r.start and r.end <= rec["span"][1]]
    return float(np.median(shares)) if shares else None
