"""The CSM program's per-frame spans on the traced stretch, and the card's
rows their launches enqueued.

`CsmTTS.synthesize` records `csm.synthesize` (its root), `csm.prepare`,
`csm.prefill`, then per frame `csm.backbone` (the step and codebook 0's
sample; frame 0's is in `csm.prefill`) and `csm.depth` (the 31 passes and
their samples), then `csm.mimi` and `csm.readback`. A call's frames far
outnumber the whole calls a 3 s stretch holds, so these readers count
frames: a span inside the stretch whose launches all reached the trace, and
a frame a thread's backbone span and the depth span after it.

Host rows reach perf time by `spans.offset_s`; a span's device rows are
those its launches, copies, sets and graph launches enqueued, so their time
is the card's own. The card runs one stream in order. A launch, copy or set
enqueues one row; a CUDA graph launch (the program's depth passes on the
card, `sopro_tpu_torch/csm_engine.DepthGraph`) enqueues one row for each
kernel, copy and set node of its graph, the same `n` rows in the same order
at every replay. So host row j's first device row is j + (n - 1) * (graph
launches before j) + s. `pairing` finds n and s: the pair under which the
most copies and sets meet their own kind, among the sizes that the distances
between copies and sets on either side of a graph launch vote for, and the
shifts that put a copy or set in the trace's middle on a row of its kind.

Nothing is read (None) from a program without these spans, a run with no
closing row, where a span's rows do not meet their launches kind for kind,
or where a replay's rows do not repeat the first replay's kinds.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np

from cudabench import spans

BACKBONE, DEPTH = "csm.backbone", "csm.depth"
GRAPH = ("cudaGraphLaunch", "cuGraphLaunch")
KERNEL, COPY, SET, REPLAY = 0, 1, 2, 3
VOTE_ROWS = 64  # copies and sets after each one whose distance votes for n
CANDIDATES = 256  # the sizes most voted for that `pairing` scores


def _kinds(names) -> np.ndarray:
    code = {"kernel": KERNEL, "copy": COPY, "set": SET}
    return np.array([REPLAY if n.startswith(GRAPH) else code[spans._kind(n)] for n in names],
                    dtype=np.int64)


def pairing(hk: np.ndarray, dk: np.ndarray) -> Tuple[int, int]:
    """Host kinds hk and device kinds dk (`_kinds`) of a trace with graph
    launches -> (n, s): a graph launch enqueues n rows, and host row j's
    first device row is j + (n - 1) * (graph launches before j) + s (module
    docstring)."""
    graphs = np.cumsum(hk == REPLAY) - (hk == REPLAY)
    oh = np.flatnonzero((hk == COPY) | (hk == SET))
    od = np.flatnonzero((dk == COPY) | (dk == SET))
    # host copies and sets with one graph launch between them: gap and kinds
    one = graphs[oh[1:]] - graphs[oh[:-1]] == 1
    gaps = {(int(b - a), int(hk[a]), int(hk[b])) for a, b in zip(oh[:-1][one], oh[1:][one])}
    votes = [np.zeros(0, np.int64)]
    for m in range(1, min(VOTE_ROWS, len(od) - 1) + 1):
        a, b = od[:-m], od[m:]
        for gap, ka, kb in gaps:
            n = (b - a - gap + 1)[(dk[a] == ka) & (dk[b] == kb)]
            votes.append(n[n >= 1])
    sizes, counts = np.unique(np.concatenate(votes), return_counts=True)
    mid = len(oh) // 2  # a copy or set well inside the trace: its row fixes s for each n
    best, found = None, (1, 0)
    for n in sizes[np.argsort(-counts, kind="stable")][:CANDIDATES]:
        p = oh + (int(n) - 1) * graphs[oh]
        near = od[(od >= p[mid] - spans.MAX_SHIFT) & (od <= p[mid] + n + spans.MAX_SHIFT)]
        for s in near[dk[near] == hk[oh[mid]]] - p[mid]:
            q = p + s
            ok = (q >= 0) & (q < len(dk))
            met = int(np.count_nonzero(dk[q[ok]] == hk[oh[ok]]))
            key = (2 * met - int(np.count_nonzero(ok)), -abs(int(s)), -int(n))
            if best is None or key > best:
                best, found = key, (int(n), int(s))
    return found


def frames(rec: Dict, store=None) -> Optional[Dict[str, List[Tuple[float, float, float]]]]:
    """Per span name (`csm.backbone`, `csm.depth`), each whole span in the
    stretch: (perf start, perf end, device seconds of its rows), and under
    "frame" each frame's (backbone start, depth end, launches) for the
    frames whose two spans are both whole; a graph launch counts as one
    launch."""
    tr, off = rec.get("trace"), spans.offset_s(rec)
    store = spans.recorded() if store is None else list(store)
    if not tr or not tr["kernels"] or off is None or not store:
        return None
    work = sorted((a + off, n) for n, a, _ in tr["host"] if n.startswith(spans.WORK + GRAPH))
    dev = sorted((a, b, n) for n, a, b, _ in tr["kernels"])
    if not work:
        return None
    hk, dk = _kinds(n for _, n in work), _kinds(n for *_, n in dev)
    n, s = pairing(hk, dk) if (hk == REPLAY).any() else (1, spans._shift(work, dev))
    graphs = np.concatenate([[0], np.cumsum(hk == REPLAY)])
    first = lambda j: int(j + (n - 1) * graphs[j] + s)  # host row j's first device row
    whole_replays = [first(j) for j in np.flatnonzero(hk == REPLAY)
                     if 0 <= first(j) and first(j) + n <= len(dk)]
    pattern = dk[whole_replays[0]: whole_replays[0] + n] if whole_replays else None
    starts = [a for a, _ in work]
    launched = [a for a, nm in work if nm.startswith(spans.LAUNCHES + GRAPH)]
    t_a = rec["span"][1]
    t_b = t_a + tr["window_s"]
    out: Dict[str, list] = {BACKBONE: [], DEPTH: [], "frame": []}
    # a call open when the profiler started records its spans under no root:
    # a frame is a thread's whole backbone span and the depth span after it
    backbone_at: Dict[int, Optional[float]] = {}
    for x in sorted(store, key=lambda x: x.t0_ns):
        if x.name not in (BACKBONE, DEPTH):
            continue
        r0, r1 = x.t0_ns * 1e-9, x.t1_ns * 1e-9
        j0, j1 = bisect.bisect_left(starts, r0), bisect.bisect_right(starts, r1)
        lo, hi = first(j0), first(j1)
        whole = t_a <= r0 and r1 <= t_b and 0 <= lo < hi <= len(dev)
        f0 = backbone_at.pop(x.thread, None)
        if x.name == BACKBONE:
            backbone_at[x.thread] = r0 if whole else None
        if not whole:
            continue
        for j in range(j0, j1):
            k = first(j)
            if (hk[j] == REPLAY and not np.array_equal(dk[k: k + n], pattern)) or \
                    (hk[j] != REPLAY and dk[k] != hk[j]):
                return None
        out[x.name].append((r0, r1, sum(dev[k][1] - dev[k][0] for k in range(lo, hi))))
        if x.name == DEPTH and f0 is not None:
            m = bisect.bisect_right(launched, r1) - bisect.bisect_left(launched, f0)
            out["frame"].append((f0, r1, m))
    return out if out[BACKBONE] and out[DEPTH] else None
