"""`SoproTTS.synthesize`: each closed-loop client calls it back to back on
the fused plan, one whole utterance a call, until the window closes."""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from cudabench import run as harness
from cudabench.run import Record, p95


def run(tts, mix, traffic, voices, seconds, hooks) -> Dict:
    hop = int(tts.engine.codec.cfg.hop_length)
    refs = [tts.prepare_reference(ref_tokens_tq=v) for v in voices]
    sp = mix["sampling"]
    for key in harness.bucket_texts(tts, mix):
        tts.synthesize(key, ref=refs[0], max_frames=int(mix["frames"][1]), seed=1)
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
                wav = tts.synthesize(rec.text, ref=refs[s.voice], max_frames=s.frames,
                                     top_p=sp["top_p"], temperature=sp["temperature"],
                                     anti_loop=sp["anti_loop"], seed=s.seed)
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


def end_to_end(res: Dict, seconds: float, sr: int) -> Dict:
    """The wall of each call started in the window (p95), and the audio the
    calls returned over the window's length, a call that straddles an edge
    counting the share of its wall inside the window."""
    w0, w1, hop = res["w0"], res["w1"], res["hop"]
    recs = res["records"]
    inside = [r for r in recs if r.start is not None and w0 <= r.start < w1]
    done = [r for r in inside if r.end is not None and r.error is None]
    audio = 0.0
    for r in recs:
        if r.end is None or r.error is not None:
            continue
        overlap = max(0.0, min(r.end, w1) - max(r.start, w0))
        audio += r.chunk_n[0] * hop / sr * overlap / max(r.end - r.start, 1e-9)
    res["attempted"] = len(inside)
    res["failed"] = len(inside) - len(done)
    return {"request_ms_p95": p95([(r.end - r.start) * 1e3 for r in done]),
            "audio_s_per_s": audio / seconds}


def state_frames(mix: Dict) -> int:
    return int(mix["frames"][1]) + 1


def plan(s, ctx: int, state_frames: int):
    """One window over every frame the call conditions."""
    return [(0, state_frames, state_frames, int(s.chunks[0]))]
