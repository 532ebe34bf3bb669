"""`MoshiDuplex.converse`: each closed-loop client calls it back to back,
one turn a call, until the window closes. A call takes its session's
conversation (`s.voice`), a history of the first `len(s.ids)` frames of
it, and the user's next `s.frames` frames as the stream arriving while
Moshi speaks; its wall runs from the history's preparation to the
waveform and text ids on the host. The end-to-end metrics are
`entries/synthesize.py`'s."""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from cudabench import run as harness
from cudabench.entries.synthesize import end_to_end  # noqa: F401
from cudabench.run import Record


def run(duplex, mix, traffic, voices, seconds, hooks) -> Dict:
    hop = duplex.hop_length
    sp = mix["sampling"]

    def call(conv, hist, frames, seed):
        history = duplex.prepare_history(conv.text[:hist], conv.moshi[:hist], conv.user[:hist])
        return duplex.converse(history, conv.user[hist: hist + frames], max_frames=frames, seed=seed,
                               text_temperature=sp["text_temperature"], text_top_k=sp["text_top_k"],
                               audio_temperature=sp["audio_temperature"],
                               audio_top_k=sp["audio_top_k"])

    # a short call at the shortest history and a whole one at the longest:
    # the prefill at both ends, the steps' CUDA graphs at the calls'
    # sampling, the Mimi decode at the calls' length
    lo, hi = (int(x) for x in mix["text_len"])
    call(voices[0], lo, 2, 1)
    call(voices[0], hi, int(mix["frames"][1]), 1)
    hooks["setup_done"]()
    records: List[Record] = []
    stop = threading.Event()

    def client(stream):
        for s in stream:
            if stop.is_set():
                return
            rec = Record(s, "", time.perf_counter())
            records.append(rec)
            rec.start = rec.due
            try:
                wav, text, codes = call(voices[s.voice], len(s.ids), s.frames, s.seed)
            except Exception as e:
                rec.error = f"{type(e).__name__}: {e}"
                continue
            rec.end = time.perf_counter()
            rec.chunk_t, rec.chunk_n = [rec.end], [wav.shape[-1] // hop]
            if s.keep:
                rec.wav = [wav[0]]
                rec.moshi = (text, codes)

    t0 = time.perf_counter()
    w0 = t0 + float(mix.get("lead_s", 0.0))
    w1 = w0 + seconds
    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in traffic.clients]
    for th in threads:
        th.start()
    out = hooks["window"](w0, w1, None)
    stop.set()
    deadline = w1 + harness.WAIT_AFTER_S
    for th in threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    out.update(records=records, t0=t0, w0=w0, w1=w1, hop=hop, batcher=None)
    return out
