"""The toy family's entry: one closed-loop client calling the program's
`generate` back to back until the window closes."""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from cudabench import run as harness
from cudabench.run import Record, p95


def run(program, mix, traffic, voices, seconds, hooks) -> Dict:
    warm = program.tokenizer.add(np.ones((int(mix["text_len"][1]),), np.int32))
    program.generate(warm, voices[0], int(mix["frames"][1]))
    hooks["setup_done"]()
    records: List[Record] = []
    stop = threading.Event()

    def client(stream):
        for s in stream:
            if stop.is_set():
                return
            rec = Record(s, program.tokenizer.add(s.ids), time.perf_counter())
            rec.start = rec.due
            records.append(rec)
            wav = program.generate(rec.text, voices[s.voice], s.frames)
            rec.end = time.perf_counter()
            rec.chunk_t, rec.chunk_n = [rec.end], [len(wav) // program.hop]
            if s.keep:
                rec.wav = [wav]

    t0 = time.perf_counter()
    w0 = t0 + float(mix.get("lead_s", 0.0))
    w1 = w0 + seconds
    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in traffic.clients]
    for th in threads:
        th.start()
    out = hooks["window"](w0, w1, None)
    stop.set()
    for th in threads:
        th.join(harness.WAIT_AFTER_S)
    out.update(records=records, t0=t0, w0=w0, w1=w1, hop=program.hop, batcher=None)
    return out


def end_to_end(res: Dict, seconds: float, sr: int) -> Dict:
    inside = [r for r in res["records"] if res["w0"] <= r.start < res["w1"]]
    done = [r for r in inside if r.end is not None]
    res["attempted"], res["failed"] = len(inside), len(inside) - len(done)
    return {"request_ms_p95": p95([(r.end - r.start) * 1e3 for r in done])}
