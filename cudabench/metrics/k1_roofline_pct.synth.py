"""AR decode, kernel K1 (csrc/ar_loop.cu): the bound of a request's AR
decode (401 steps at its text length: operations over the dtype's peak or
bytes over 3.35 TB/s, the larger) over K1's device time per request (one
launch a request)."""

from cudabench import trace

NAMES = ('ar_loop_kernel',)


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    launches = sum(1 for n, *_ in tr["kernels"] if "ar_loop_kernel" in n)
    spent = trace.kernel_s(tr, NAMES)
    done = [r for r in rec["records"] if r.end is not None and r.error is None
            and rec["w0"] <= r.start < rec["w1"]]
    if not launches or spent <= 0 or not done:
        return None
    f, c, m, dt = rec["flops"], rec["cfg"]["sopro"], rec["cfg"]["mimi"], rec["cfg"]["compute_dtype"]
    bound = sum(f.k1_bound_s(c, r.chunk_n[0], 1, len(r.sess.ids), dt) for r in done) / len(done)
    return 100.0 * bound / (spent / launches)
