"""`ContinuousBatcher.submit` / `SessionHandle.chunks()`: each session is a
client thread blocked on its handle's `chunks()` (an open loop starts it at
its due time; a closed-loop client runs its sessions one after another). A
thread blocked on a queue takes the interpreter lock only when a chunk
arrives; a client that polls every session's queue slows the host-bound
scheduler thread (a 0.5 ms poll stretched the serve tick by a third on the
card)."""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from cudabench import run as harness
from cudabench.run import Record, p95


def consume(batcher, rec: Record, ref, mix: Dict, hop: int) -> None:
    """One client's session: submit, then every chunk `chunks()` yields,
    stamped on the host clock as it arrives."""
    sp = mix["sampling"]
    try:
        rec.start = time.perf_counter()
        h = batcher.submit(rec.text, ref, top_p=sp["top_p"], temperature=sp["temperature"],
                           anti_loop=sp["anti_loop"], max_frames=rec.sess.frames,
                           seed=rec.sess.seed)
        for chunk in h.chunks():
            rec.chunk_t.append(time.perf_counter())
            if rec.shard is None and h.slot is not None:
                rec.shard = h.slot // batcher.per
            rec.chunk_n.append(chunk.shape[-1] // hop)
            if rec.sess.keep:
                rec.wav.append(chunk[0])
        rec.end = time.perf_counter()
    except Exception as e:  # a refused or failed session: counted as failed
        rec.error = f"{type(e).__name__}: {e}"


def run(tts, mix, traffic, voices, seconds, hooks) -> Dict:
    from sopro_tpu_torch.serve.scheduler import ContinuousBatcher

    hop = int(tts.engine.codec.cfg.hop_length)
    refs = [tts.prepare_reference(ref_tokens_tq=v) for v in voices]
    b = dict(mix["batcher"])
    if "mesh" in b:  # the slots split over a dp mesh of the cell's cards, as SOPRO_DP serves
        from sopro_tpu_torch.parallel.mesh import make_mesh

        spec = b.pop("mesh")
        n = int(spec["dp"]) * int(spec["tp"])
        dev = tts.engine.device
        b["mesh"] = make_mesh(n, dp=int(spec["dp"]), tp=int(spec["tp"]),
                              devices=[dev] * n if dev.type == "cpu" else None)
    batcher = ContinuousBatcher(tts, **b)
    batcher.warmup(ref=refs[0])
    # one session per text bucket the traffic reaches, admitted as one group
    warm = [batcher.submit(key, refs[0], max_frames=b["chunk_frames"], seed=1)
            for key in harness.bucket_texts(tts, mix)]
    for h in warm:
        for _ in h.chunks():
            pass
    batcher.reset_stats()
    hooks["setup_done"]()

    records: List[Record] = []
    threads: List[threading.Thread] = []
    stop = threading.Event()
    t0 = time.perf_counter()
    w0 = t0 + float(mix.get("lead_s", 0.0))
    w1 = w0 + seconds

    def session(sess, due):
        rec = Record(sess, tts.tokenizer.add(sess.ids), due)
        records.append(rec)
        consume(batcher, rec, refs[sess.voice], mix, hop)

    if mix["loop"] == "open":
        def generator():
            for s in traffic.sessions:
                due = t0 + s.due_s
                if due >= w1:
                    return
                time.sleep(max(0.0, due - time.perf_counter()))
                th = threading.Thread(target=session, args=(s, due), daemon=True)
                threads.append(th)
                th.start()
        senders = [threading.Thread(target=generator, daemon=True)]
    else:
        def client(stream):
            for s in stream:
                if stop.is_set():
                    return
                session(s, time.perf_counter())
        senders = [threading.Thread(target=client, args=(c,), daemon=True) for c in traffic.clients]
    for d in senders:
        d.start()
    out = hooks["window"](w0, w1, lambda: batcher.stats())
    stop.set()
    deadline = w1 + harness.WAIT_AFTER_S
    for th in senders + threads:
        th.join(max(0.0, deadline - time.perf_counter()))
    out.update(records=records, t0=t0, w0=w0, w1=w1, hop=hop, batcher=batcher)
    return out


def end_to_end(res: Dict, seconds: float, sr: int) -> Dict:
    """TTFA from each session's due time (p95 over the sessions due in the
    window; one that never yields waits until the run gives up), the gaps
    between a session's chunks inside the window (p95), and the audio
    yielded inside the window over its length."""
    w0, w1, hop = res["w0"], res["w1"], res["hop"]
    recs = res["records"]
    due = [r for r in recs if w0 <= r.due < w1]
    give_up = w1 + harness.WAIT_AFTER_S
    ttfa = [((r.chunk_t[0] if r.chunk_t and r.error is None else give_up) - r.due) * 1e3
            for r in due]
    gaps = [(b - a) * 1e3 for r in recs for a, b in zip(r.chunk_t, r.chunk_t[1:])
            if w0 <= a and b < w1]
    audio = sum(n for r in recs for t, n in zip(r.chunk_t, r.chunk_n) if w0 <= t < w1)
    res["attempted"] = len(due)
    res["failed"] = sum(1 for r in due if r.error is not None or r.end is None)
    return {"ttfa_p95_ms": p95(ttfa), "chunk_gap_p95_ms": p95(gaps),
            "audio_s_per_s": audio * hop / sr / seconds}


def state_frames(mix: Dict) -> int:
    return int(mix["batcher"]["max_frames"]) + 1


def plan(s, ctx: int, state_frames: int):
    """[(lo, hi, tail, shipped)] per chunk: its NAR window [lo, hi), the
    frames whose codes it gives (the last `tail`), how many of them the
    client got. A chunk of cf frames starting at frame a is refined over
    [a + cf - (cf + ctx), a + cf); the first is a ramp chunk when it is
    one."""
    out, a = [], 0
    for k, n in enumerate(s.chunks):
        cf = s.ramp if k == 0 and n == s.ramp < s.chunk_frames else s.chunk_frames
        out.append((a + cf - (cf + ctx), a + cf, cf, int(n)))
        a += int(n)
    return out
