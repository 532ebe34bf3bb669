"""`CsmTTS.synthesize`: each closed-loop client calls it back to back, one
whole utterance a call, until the window closes. The end-to-end metrics are
`entries/synthesize.py`'s."""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from cudabench import run as harness
from cudabench.entries.synthesize import end_to_end  # noqa: F401
from cudabench.run import Record


def run(tts, mix, traffic, voices, seconds, hooks) -> Dict:
    hop = tts.hop_length
    refs = [tts.prepare_reference(ref_tokens_tq=v.codes, transcript_ids=v.transcript_ids)
            for v in voices]
    sp = mix["sampling"]
    call = lambda text, ref, frames, seed: tts.synthesize(
        text, ref=ref, max_frames=frames, top_k=sp["top_k"], temperature=sp["temperature"],
        seed=seed)
    # a short call at each text bucket (its prefill, every kernel of a frame),
    # then one whole call (the Mimi decode and K3 at the calls' length)
    keys = harness.bucket_texts(tts, mix)
    for key in keys:
        call(key, refs[0], 2, 1)
    call(keys[-1], refs[0], int(mix["frames"][1]), 1)
    hooks["setup_done"]()
    records: List[Record] = []
    stop = threading.Event()

    def client(stream):
        for s in stream:
            if stop.is_set():
                return
            rec = Record(s, tts.tokenizer.add(s.ids), time.perf_counter())
            records.append(rec)
            rec.start = rec.due
            try:
                wav = call(rec.text, refs[s.voice], s.frames, s.seed)
            except Exception as e:
                rec.error = f"{type(e).__name__}: {e}"
                continue
            rec.end = time.perf_counter()
            rec.chunk_t, rec.chunk_n = [rec.end], [wav.shape[-1] // hop]
            if s.keep:
                rec.wav = [wav[0]]

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
