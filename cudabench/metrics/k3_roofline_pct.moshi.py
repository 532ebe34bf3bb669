"""Mimi decode, kernel K3 (csrc/seanet.cu, its conv and fused-block
kernels), Moshi: the bound of a call's SEANet decoder over K3's device
time in a whole `moshi.mimi` span (one Mimi decode a call), averaged over
the spans of the traced stretch (`cudabench/spans_moshi.py`)."""

import numpy as np

from cudabench import spans_moshi

NAMES = ('conv_wgmma_kernel', 'resblock_wgmma_kernel')


def read(rec):
    spent = spans_moshi.mimi_rows_s(rec, NAMES)
    done = [r for r in rec["records"] if r.end is not None and r.error is None
            and rec["w0"] <= r.start < rec["w1"]]
    if not spent or not done or float(np.mean(spent)) <= 0:
        return None
    f, m, dt = rec["flops"], rec["cfg"]["mimi"], rec["cfg"]["compute_dtype"]
    bound = float(np.mean([f.k3_bound_s(m, r.chunk_n[0], dt) for r in done]))
    return 100.0 * bound / float(np.mean(spent))
