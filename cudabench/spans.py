"""The program's spans on the traced stretch's timeline, and the split of the
card's idle time they give.

While the profiler runs, the program records a span around each step of a
call (`sopro_tpu_torch.profiling.span`: `sopro.synthesize`, its root, then
`sopro.prepare`, `.condition`, `.ar`, `.nar`, `.mimi`, `.readback`), on
`time.perf_counter_ns()`. The trace's rows are on the profiler's clock,
seconds from its start. The host's rows take one constant per run: the
harness's closing `torch.cuda.synchronize()` leaves a `cudaDeviceSynchronize`
row in `trace["host"]` that ends at perf time `rec["span"][1] +
trace["window_s"]`, and so at about `window_s` on the profiler's clock. The
profiler's stop adds a row of its own after it, which waits for whatever the
program queued in between and can end a millisecond or more later (when the
window closes while K1's launch queue drains), so the closing row is the one
that ends nearest `window_s`, not the last.

The card's rows do not: CUPTI's device timestamps drift against the host's,
on an H100 by up to tens of milliseconds over a 3 s stretch, at rates that
change every second or so. They reach the host's clock through their
launches. The card runs one stream in order, so its k-th row was enqueued by
the k-th launch, copy or set on the host, after a shift that the copies and
sets pin: under it each meets its own kind. A kernel that starts after the
card was idle started as its launch arrived, so those pairs, the least lag in
each millisecond, give the device clock's reading of perf time; between them
it is interpolated.

A whole call is one whose root span was recorded and lies inside the
stretch; the covered stretch runs from the first whole call's start to the
last one's end. Each idle instant of the card there goes to the caller (no
call open), the readback (a call's `sopro.readback` open) or the engine's
issue (a call open in any other step), so the three shares add up to the
covered stretch's idle share.

Nothing is read (None) from a program that records no spans, from a run with
no whole call or no closing row, where a whole call's launches do not meet
their rows kind for kind, or where the mapping fails its check: in every
whole call, K1 starts after the mapped start of `sopro.ar`, and the call's
last device row ends before the mapped end of `sopro.readback`, each to
within `TOL_S`.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from cudabench.trace import union

ROOT, AR, READBACK = "sopro.synthesize", "sopro.ar", "sopro.readback"
K1 = "ar_loop_kernel"
SYNC = "cudaDeviceSynchronize"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
WORK = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
TOL_S = 50e-6
MAX_SHIFT = 64  # rows on one side only at the stretch's start
GAP_S = 5e-6  # idle before a kernel that started as its launch arrived
BUCKET_S = 1e-3  # one clock anchor per millisecond of the card

Iv = List[Tuple[float, float]]


def recorded() -> List:
    """The program's recorded spans; none from a program without them."""
    from sopro_tpu_torch import profiling

    get = getattr(profiling, "spans", None)
    return list(get()) if get is not None else []


def offset_s(rec: Dict) -> Optional[float]:
    """Perf seconds minus profiler seconds, from the harness's closing
    `cudaDeviceSynchronize` row: the one that ends nearest `window_s`."""
    tr = rec.get("trace")
    ends = [b for n, _, b in tr["host"] if n == SYNC] if tr else []
    if not ends:
        return None
    return rec["span"][1] + tr["window_s"] - min(ends, key=lambda b: abs(b - tr["window_s"]))


def _kind(name: str) -> str:
    return "copy" if "Memcpy" in name else "set" if "Memset" in name else "kernel"


def _shift(work: List[Tuple[float, str]], dev: List[Tuple[float, float, str]]) -> int:
    """s with device row k enqueued by host row k - s: the one under which
    the most copies and sets meet their own kind."""
    odd = {j: _kind(n) for j, (_, n) in enumerate(work) if _kind(n) != "kernel"}
    kinds = {k: _kind(n) for k, (_, _, n) in enumerate(dev) if _kind(n) != "kernel"}
    return max(range(-MAX_SHIFT, MAX_SHIFT + 1),
               key=lambda s: (sum(kinds.get(j + s) == k for j, k in odd.items()), -abs(s)))


def _device_clock(work, dev, s):
    """Device seconds -> perf seconds, through the kernels that started after
    the card was idle (in each `BUCKET_S` the one with the least lag behind
    its launch), linear between them; None with fewer than two."""
    best: Dict[int, Tuple[float, float]] = {}
    until = dev[0][1]  # the first row may have queued behind rows before the trace
    for k in range(1, len(dev)):
        a, b, n = dev[k]
        j = k - s
        if a - until >= GAP_S and 0 <= j < len(work) and _kind(n) == "kernel":
            at = int(a // BUCKET_S)
            if at not in best or a - work[j][0] < best[at][0] - best[at][1]:
                best[at] = (a, work[j][0])
        until = max(until, b)
    anchors = sorted(best.values())
    if len(anchors) < 2:
        return None
    xs = [a for a, _ in anchors]

    def to_perf(x: float) -> float:
        i = min(max(bisect.bisect_right(xs, x) - 1, 0), len(anchors) - 2)
        (d0, h0), (d1, h1) = anchors[i], anchors[i + 1]
        return h0 + (x - d0) * (h1 - h0) / (d1 - d0)

    return to_perf


def _clip(iv: Iv, lo: float, hi: float) -> Iv:
    return [(max(a, lo), min(b, hi)) for a, b in iv if b > lo and a < hi]


def _complement(iv: Iv, lo: float, hi: float) -> Iv:
    out, at = [], lo
    for a, b in union(_clip(iv, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    return out + ([(at, hi)] if at < hi else [])


def _intersect(x: Iv, y: Iv) -> Iv:
    """Of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(iv: Iv) -> float:
    return sum(b - a for a, b in iv)


def split(rec: Dict, store: Optional[Sequence] = None) -> Optional[Dict[str, float]]:
    """The covered stretch's idle time split three ways (percent of the
    stretch), the median issue time before K1 and the median launch rows of
    a whole call, and the causality check's largest residual (seconds; at
    most `TOL_S`). `store`: the spans (default: the program's)."""
    tr, off = rec.get("trace"), offset_s(rec)
    store = recorded() if store is None else list(store)
    if not tr or not tr["kernels"] or off is None or not store:
        return None
    work = sorted((a + off, n) for n, a, _ in tr["host"] if n.startswith(WORK))
    dev = sorted((a, b, n) for n, a, b, _ in tr["kernels"])
    s = _shift(work, dev)
    to_perf = _device_clock(work, dev, s)
    if to_perf is None:
        return None
    rows = [(to_perf(a), to_perf(b), n) for a, b, n in dev]
    starts = [a for a, _ in work]
    mine = lambda r: range(bisect.bisect_left(starts, r[0]) + s,
                           bisect.bisect_right(starts, r[1]) + s)

    # whole: inside the stretch, and every row it enqueued in the trace (the
    # profiler keeps no device row stamped past its end)
    t_a = rec["span"][1]
    t_b = t_a + tr["window_s"]
    sec = lambda x: (x.t0_ns * 1e-9, x.t1_ns * 1e-9)
    roots = {x.call: sec(x) for x in store if x.name == ROOT and x.parent is None}
    steps = {(x.call, x.name): sec(x) for x in store if x.call in roots}
    whole = sorted((c, r) for c, r in roots.items() if t_a <= r[0] and r[1] <= t_b
                   and mine(r) and mine(r).start >= 0 and mine(r).stop <= len(dev))
    if not whole or any((c, n) not in steps for c, _ in whole for n in (AR, READBACK)):
        return None

    residual = -float("inf")
    for c, r in whole:
        if any(_kind(dev[k][2]) != _kind(work[k - s][1]) for k in mine(r)):
            return None
        k1 = [rows[k][0] for k in mine(r) if K1 in rows[k][2]]
        if not k1:
            return None
        residual = max(residual, steps[c, AR][0] - k1[0],
                       max(rows[k][1] for k in mine(r)) - steps[c, READBACK][1])
    if residual > TOL_S:
        return None

    c0, c1 = min(r[0] for _, r in whole), max(r[1] for _, r in whole)
    idle = _complement([(a, b) for a, b, _ in rows], c0, c1)
    open_ = union(_clip(list(roots.values()), c0, c1))
    reading = union(_clip([t for (_, n), t in steps.items() if n == READBACK], c0, c1))
    caller = _length(_intersect(idle, _complement(open_, c0, c1)))
    readback = _length(_intersect(idle, _intersect(open_, reading)))
    issue = _length(_intersect(idle, _intersect(open_, _complement(reading, c0, c1))))

    launched = [a for a, n in work if n.startswith(LAUNCHES)]
    launches = [bisect.bisect_right(launched, r1) - bisect.bisect_left(launched, r0)
                for _, (r0, r1) in whole]
    pct = 100.0 / (c1 - c0)
    return {"caller_pct": caller * pct, "issue_pct": issue * pct, "readback_pct": readback * pct,
            "idle_pct": _length(idle) * pct,
            "issue_ms_p50": statistics.median((steps[c, AR][1] - r[0]) * 1e3 for c, r in whole),
            "launches_per_call": statistics.median(launches),
            "residual_s": residual, "calls": len(whole)}
