"""The Moshi program's per-frame spans on the traced stretch, and the
card's rows their launches enqueued.

`MoshiDuplex.converse` records `moshi.converse` (its root),
`moshi.prepare`, `moshi.prefill` (the prefill and step 0's text sample),
then per step `moshi.temporal` (one cached temporal position and the text
sample; step 0's is in `moshi.prefill`) and `moshi.depth` (the depformer's
steps and their samples), then `moshi.mimi` and `moshi.readback`. A frame
is a thread's `moshi.temporal` span and the `moshi.depth` span after it, so
a call of F frames holds F of them; step 0's depth span, after the prefill,
is in none.

The pairing of spans, launches and rows is `spans_csm.frames`'s, the two
names standing for its two: the program launches no CUDA graph, so host
launch j enqueued device row j + s. Nothing is read (None) where that
reads nothing. `mimi_rows_s` reads the `moshi.mimi` spans (one Mimi
decode a call) the same way.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from cudabench import spans, spans_csm

TEMPORAL, DEPTH, MIMI = "moshi.temporal", "moshi.depth", "moshi.mimi"
_AS = {TEMPORAL: spans_csm.BACKBONE, DEPTH: spans_csm.DEPTH}


def frames(rec: Dict, store=None) -> Optional[Dict[str, List[Tuple[float, float, float]]]]:
    """Per span name (`moshi.temporal`, `moshi.depth`), each whole span in
    the stretch: (perf start, perf end, device seconds of its rows), the
    depth spans only those of a frame; under "frame" each frame's
    (temporal start, depth end, launches)."""
    store = spans.recorded() if store is None else list(store)
    got = spans_csm.frames(rec, [x._replace(name=_AS[x.name]) for x in store if x.name in _AS])
    if got is None or not got["frame"]:
        return None
    ends = {r1 for _, r1, _ in got["frame"]}
    return {TEMPORAL: got[spans_csm.BACKBONE],
            DEPTH: [x for x in got[spans_csm.DEPTH] if x[1] in ends], "frame": got["frame"]}


def mimi_rows_s(rec: Dict, names: Tuple[str, ...], store=None) -> Optional[List[float]]:
    """Each whole `moshi.mimi` span in the stretch: the device seconds of
    its rows whose names hold one of `names`. The pairing is `frames`'s,
    run on the trace with every other row's duration zeroed (the rows,
    their order and kinds unchanged)."""
    tr = rec.get("trace")
    store = spans.recorded() if store is None else list(store)
    if not tr:
        return None
    only = [(n, a, b if any(k in n for k in names) else a, d) for n, a, b, d in tr["kernels"]]
    named = {MIMI: spans_csm.BACKBONE, DEPTH: spans_csm.DEPTH}
    got = spans_csm.frames(dict(rec, trace=dict(tr, kernels=only)),
                           [x._replace(name=named[x.name]) for x in store if x.name in named])
    return [d for *_, d in got[spans_csm.BACKBONE]] if got else None
