"""Engine issue: the median over whole traced calls of the host rows that wait
for the card (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`, a synchronous `cudaMemcpy`) that start inside the
call's `sopro.synthesize` span. A whole call is one inside the stretch whose
rows all reached the trace, as `cudabench/spans.py` picks them for
`launches_per_call.synth`.

The rows and the spans are both on the host's clock, so this needs no device
clock and none of `spans.split`'s checks on it: the host's offset is
`spans.offset_s`. Nothing is read from a program without spans, a run with
no closing row or no whole call."""

import bisect
import statistics

from cudabench import spans

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")


def read(rec):
    tr, store = rec.get("trace"), spans.recorded()
    if not tr or not tr["kernels"] or not store:
        return None
    off = spans.offset_s(rec)
    if off is None:
        return None
    work = sorted((a + off, n) for n, a, _ in tr["host"] if n.startswith(spans.WORK))
    dev = sorted((a, b, n) for n, a, b, _ in tr["kernels"])
    s = spans._shift(work, dev)
    starts = [a for a, _ in work]
    t_a = rec["span"][1]
    t_b = t_a + tr["window_s"]
    synced = sorted(a + off for n, a, _ in tr["host"] if n in SYNCS)
    counts = []
    for x in store:
        if x.name != spans.ROOT or x.parent is not None:
            continue
        r0, r1 = x.t0_ns * 1e-9, x.t1_ns * 1e-9
        lo, hi = bisect.bisect_left(starts, r0) + s, bisect.bisect_right(starts, r1) + s
        if t_a <= r0 and r1 <= t_b and 0 <= lo < hi <= len(dev):
            counts.append(bisect.bisect_right(synced, r1) - bisect.bisect_left(synced, r0))
    return statistics.median(counts) if counts else None
