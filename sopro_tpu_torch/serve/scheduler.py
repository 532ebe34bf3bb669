"""Continuous batching: N concurrent TTS sessions on one card (counterpart:
sopro_tpu/serve/scheduler.py).

A fixed pool of `slots` batch rows holds each session's decode state on the
device (`engine.ServeState`): the AR carry is per row (step counter, RNG
key, EOS bookkeeping), so sessions of different ages decode in the same
tick; conditioning and the text KV live in batched buffers, in the stacked
[A, B, H, L, hd] layout kernel K1 reads, and a join scatters rows into them.

Every tick advances all rows by `chunk_frames` (`Engine.serve_tick`: K1 for
the AR chunk, K2 for the NAR heads of the window's last frames, K4 for the
Mimi stream step masked to the rows that emit) and ends in one packed
[waveforms | t, first_eos, stopped, n_new] device tensor. The host copy of
tick N goes into pinned memory behind a CUDA event, and tick N+1 is issued
before tick N is read, so the copy and the host's routing hide under the
next tick's device work.

While a live session has not shipped its first chunk, a tick of
`ramp_frames` runs instead (TTFA under load); it emits only for rows that
have not emitted yet, so every established row keeps its chunk grid and a
join never changes a co-resident's waveform. A session alone in a batcher
ships what `SoproTTS.stream` ships with the same chunk, seed and reference,
where the ramp is off (ramp_frames >= chunk_frames).

Over a mesh (`mesh=`, `parallel.make_mesh`) the slots split over its dp
axis: slot i lives on shard i // (slots / dp), each shard a `ServeState` of
slots / dp rows on its dp group's replica engine (`parallel.replicas`), so
K1 runs slots / dp rows a launch. A join group is split by shard; a tick
issues every shard that has a live row (its own device and stream) before
it reads any, and reassembles the [slots] view from the shards' copies.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch.models.sopro import PreparedReference, tile_reference
from sopro_tpu_torch.ops.ar_loop import ARLoopContext
from sopro_tpu_torch.parallel.mesh import replicas

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def _p50(xs: List[float]) -> Optional[float]:
    return round(sorted(xs)[len(xs) // 2], 1) if xs else None


@dataclass
class SessionHandle:
    """Host-side handle: chunks arrive on `out` ([1, S] numpy arrays,
    float32, or int16 PCM when the batcher runs with `pcm16=True`), ended by
    None; `error` is set if the session failed. `cancel()` stops the session
    at the next tick and frees its slot.

    TTFA split (perf_counter stamps): created -> prep_done (host-side
    request build in `submit`) -> admitted (the group's join issued) ->
    first_tick (the first tick carrying the row issued) -> first chunk
    handed to the client (`first_chunk_s`: seconds since created). `slot`:
    the slot the session was admitted to."""

    sid: int
    out: "queue.Queue[Optional[np.ndarray]]" = field(default_factory=queue.Queue)
    error: Optional[BaseException] = None
    created_s: float = field(default_factory=time.perf_counter)
    prep_done_s: Optional[float] = None
    admitted_s: Optional[float] = None
    first_tick_s: Optional[float] = None
    first_chunk_s: Optional[float] = None
    frames: int = 0
    slot: Optional[int] = None
    cancelled: bool = False

    def cancel(self):
        self.cancelled = True

    def chunks(self):
        while True:
            item = self.out.get()
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item


@dataclass
class _Slot:
    handle: SessionHandle
    emitted: int = 0
    max_frames: int = 400
    ramped: bool = False  # a ramp tick has been issued for this row
    last_t: int = 0  # decode cursor from the last processed tick


@dataclass
class _Tick:
    """An issued tick: per shard its packed output (on the host once the
    event has passed), or None for a shard with no live row; the slot list
    when it was issued, and its chunk size."""

    parts: List[Optional[Tuple[torch.Tensor, Optional[torch.cuda.Event]]]]
    snap: List[Optional[_Slot]]
    cf: int


class ContinuousBatcher:
    def __init__(
        self,
        tts,
        *,
        slots: int = 8,
        chunk_frames: int = 16,
        ramp_frames: int = 4,
        text_bucket: int = 256,
        max_frames: int = 400,
        nar_context_frames: Optional[int] = None,
        mesh=None,
        pcm16: bool = False,
        admit_grace_ms: float = 6.0,
    ):
        """`mesh`: a `parallel.Mesh` whose dp axis the slots split over (see
        the module docstring); `slots` must divide by dp.

        `ramp_frames`: the first-chunk ramp (see the module docstring);
        >= chunk_frames disables it. Established rows carry the ramp frames
        as backlog, and ramp ticks are skipped while any established row is
        more than `2 * chunk_frames` frames ahead of its emissions.

        `admit_grace_ms`: burst coalescing. While every slot is free and the
        oldest waiting request is younger than the grace, admission waits, so
        near-simultaneous requests join as one group and share one ramp
        tick. A solo request pays at most the grace; 0 disables."""
        self.tts = tts
        self.eng = tts.engine
        self.cfg = tts.cfg
        self.mesh = mesh
        self.pcm16 = bool(pcm16)
        self.B = int(slots)
        if mesh is not None and self.B % int(mesh.shape["dp"]) != 0:
            raise ValueError(f"slots={self.B} must divide by dp={mesh.shape['dp']}")
        self.engines = [self.eng] if mesh is None else replicas(self.eng, mesh)
        self.per = self.B // len(self.engines)  # slots per shard
        self.cf = int(chunk_frames)
        self.ramp = max(1, min(int(ramp_frames), self.cf))
        self.ramp_backlog_cap = 2 * self.cf
        self.admit_grace_s = max(0.0, float(admit_grace_ms)) / 1000.0
        self.L = int(text_bucket)
        self.S = int(max_frames) + 1
        self.max_frames_cap = int(max_frames)
        self.nar_ctx = int(nar_context_frames if nar_context_frames is not None
                           else tts.cfg.rf_nar())
        self.hop = int(self.eng.codec.cfg.hop_length)
        self.sr = int(self.eng.codec.cfg.sampling_rate)
        self.states = [e.serve_state(self.per, self.L, self.max_frames_cap) for e in self.engines]

        self._slots: List[Optional[_Slot]] = [None] * self.B
        self._waiting: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.reset_stats()

    def reset_stats(self):
        """Zero the counters and percentile windows that `stats` reports
        (after `warmup`, say, so they count traffic only)."""
        self.ticks = 0
        self.ramp_ticks = 0
        self.admit_groups = 0
        self.sessions_done = 0
        self.total_audio_s = 0.0
        # the last 100 sessions / ticks
        self._ttfa_ms: List[float] = []
        self._ttfa_prep_ms: List[float] = []
        self._ttfa_queue_ms: List[float] = []  # prep done -> admitted
        self._ttfa_admit_tick_ms: List[float] = []  # admitted -> first tick issued
        self._ttfa_tick_chunk_ms: List[float] = []  # first tick -> chunk out
        self._dispatch_ms: List[float] = []  # host wall of issuing a tick
        self._read_ms: List[float] = []  # host wall of waiting for a tick's copy
        # per shard: the ticks it ran (one K1 launch each), the host wall of issuing them
        self.shard_ticks = [0] * len(self.engines)
        self._shard_dispatch_ms: List[List[float]] = [[] for _ in self.engines]

    @property
    def state(self):
        """The serving state of a batcher without a mesh (`states` holds one
        per shard)."""
        if len(self.states) != 1:
            raise AttributeError("a batcher over a mesh has one state per shard: use .states")
        return self.states[0]

    # ------------------------------------------------------------- lifecycle

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def warmup(self, ref=None):
        """Pay the first-call costs (kernel builds, packed weights, the
        allocator's pools, both tick sizes) before traffic: one short
        session per entry of `runtime.ref_buckets` (a reference of that
        many frames, as conditioning runs at the reference's bucket), or one
        with the given `ref`. That session runs on shard 0; under a mesh
        every other shard then joins and ticks a scratch state of its own
        (`bench_state`) at both tick sizes, so no card pays its first use
        (module loads, weight packs, library handles) under traffic."""
        rt = self.eng.rt
        if ref is not None:
            refs = [ref]
        else:
            q = int(self.cfg.num_codebooks)
            refs = [self.eng.prepare_reference(np.zeros((int(n), q), np.int32))
                    for n in rt.ref_buckets]
        for r in refs:
            h = self.submit("warmup", r, max_frames=self.cf, min_gen_frames=1)
            for _ in h.chunks():
                pass
            for eng in self.engines[1:]:
                st = self._full_state(eng, r, "warmup")
                with kernels.on_device(eng.device), torch.inference_mode():
                    for cf in sorted({self.ramp, self.cf}):
                        eng.serve_tick(st, chunk=cf, nar_ctx=self.nar_ctx,
                                       first_only=cf < self.cf, pcm16=self.pcm16).cpu()

    def bench_state(self, ref, text: str = "benchmark tick"):
        """Every slot live on `text` (seed 42, the style strength of the
        config, the default row settings): fresh serving states, one per
        shard on its replica's device (a list under a mesh, else the one
        state). The batcher's own state is not touched."""
        states = [self._full_state(eng, ref, text) for eng in self.engines]
        return states if self.mesh is not None else states[0]

    def _full_state(self, eng, ref, text: str):
        """A fresh serving state of one shard on `eng` with every row live
        on `text` (seed 42, default settings)."""
        enc = self.tts.encode_text(text)
        ids = np.zeros((self.per, self.L), np.int32)
        ids[:, : len(enc)] = enc
        mask = np.zeros((self.per, self.L), bool)
        mask[:, : len(enc)] = True
        with kernels.on_device(eng.device):
            st = eng.serve_state(self.per, self.L, self.max_frames_cap)
            eng.serve_join(st, range(self.per), ids, mask, tile_reference(ref, self.per),
                           [float(self.cfg.style_strength)] * self.per, [42] * self.per, {})
        return st

    def measure_tick_device_ms(self, ref, text: str = "benchmark tick", reps: int = 3) -> dict:
        """The device cost of one full tick with every slot live
        (`bench_state`), per shard: 1 + 2 * reps chained ticks on the card,
        the first one a warm-up. `tick_device_ms` is the device time of the
        kernels and copies per tick (torch.profiler's CUDA rows),
        `tick_span_ms` the CUDA-event span per tick (the port's tick is
        bound by the host's issue, so the two differ), `path` "resident"
        when K1 runs the AR chunk ("ar_step": K5), `rows` the tick's rows.
        Under a mesh the two times are the largest over the shards, and
        "shards" lists each shard's keys with its rows and device (shards
        that share a card take turns: there neither time is the tick's).
        Call while no session is live. Raises on a CPU engine:
        a device metric is not taken on the CPU."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        if any(e.device.type != "cuda" for e in self.engines):
            raise RuntimeError("measure_tick_device_ms: the batcher's engines are not on a CUDA "
                               "device; a device time is measured on the card only")
        shards = []
        for eng in self.engines:
            st = self._full_state(eng, ref, text)
            with kernels.on_device(eng.device), torch.inference_mode():
                tick = lambda: eng.serve_tick(st, chunk=self.cf, nar_ctx=self.nar_ctx,
                                              pcm16=self.pcm16)
                tick()
                torch.cuda.synchronize(eng.device)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    start.record()
                    for _ in range(2 * reps):
                        tick()
                    end.record()
                    torch.cuda.synchronize(eng.device)
            device_us = sum(e.self_device_time_total for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                            and not getattr(e, "is_user_annotation", False) and "#" not in e.key)
            shards.append({
                "tick_device_ms": device_us / 1e3 / (2 * reps),
                "tick_span_ms": start.elapsed_time(end) / (2 * reps),
                "path": "resident" if isinstance(st.ctx, ARLoopContext) else "ar_step",
                "rows": self.per, "device": str(eng.device),
            })
        out = {k: max(x[k] for x in shards) for k in ("tick_device_ms", "tick_span_ms")}
        out.update(path=shards[0]["path"], rows=self.B)
        return dict(out, shards=shards) if self.mesh is not None else out

    # ------------------------------------------------------------- interface

    def submit(
        self,
        text: str,
        ref,
        *,
        top_p: float = 0.9,
        temperature: float = 1.05,
        style_strength: Optional[float] = None,
        max_frames: Optional[int] = None,
        min_gen_frames: Optional[int] = None,
        seed: int = 0,
        anti_loop: bool = True,
    ) -> SessionHandle:
        """Queue a session; returns at once with a handle whose `chunks()`
        yields waveform chunks as the batch makes them. Host-only. Raises
        ValueError for text longer than the text bucket and for a seed that
        does not fit int32 (callers answer 400)."""
        ids = self.tts.encode_text(text)
        if len(ids) > self.L:
            raise ValueError(
                f"text encodes to {len(ids)} tokens, over the scheduler bucket of {self.L}; "
                "shorten the text or raise text_bucket"
            )
        if not INT32_MIN <= int(seed) <= INT32_MAX:
            raise ValueError(f"seed {seed} does not fit int32 [{INT32_MIN}, {INT32_MAX}]")
        handle = SessionHandle(sid=id(object()))
        ids_p = np.zeros((1, self.L), np.int32)
        ids_p[0, : len(ids)] = ids
        mask = np.zeros((1, self.L), bool)
        mask[0, : len(ids)] = True
        handle.prep_done_s = time.perf_counter()
        self._waiting.put({
            "handle": handle, "ids": ids_p, "mask": mask, "ref": ref,
            # a group is conditioned as one batch, so it shares the ref shapes
            "ref_sig": tuple(tuple(x.shape) for x in _ref_leaves(ref)),
            "strength": float(style_strength if style_strength is not None
                              else self.cfg.style_strength),
            # anti_loop off = recovery settings equal to the normal ones: the
            # recovery switch is then a no-op, the same tokens as no check
            "settings": {
                "top_p": float(top_p), "temperature": float(temperature),
                "recovery_top_p": 0.85 if anti_loop else float(top_p),
                "recovery_temp": 1.2 if anti_loop else float(temperature),
                "min_gen": int(min_gen_frames or self.cfg.min_gen_frames),
                "max_frames": int(min(max_frames, self.max_frames_cap) if max_frames
                                  else self.max_frames_cap),
            },
            "seed": int(seed),
            "arrived_s": time.perf_counter(),
        })
        self._wake.set()
        self.start()
        return handle

    def stats(self) -> Dict[str, Any]:
        live = sum(1 for s in self._slots if s is not None)
        return {
            "slots": self.B,
            "max_frames_cap": self.max_frames_cap,
            "active_sessions": live,
            "waiting": self._waiting.qsize(),
            "ticks": self.ticks,
            "ramp_ticks": self.ramp_ticks,
            "admit_groups": self.admit_groups,
            "chunk_frames": self.cf,
            "ramp_frames": self.ramp,
            "sessions_done": self.sessions_done,
            "total_audio_s": round(self.total_audio_s, 2),
            "ttfa_p50_ms": _p50(self._ttfa_ms),
            "ttfa_prep_p50_ms": _p50(self._ttfa_prep_ms),
            "ttfa_queue_p50_ms": _p50(self._ttfa_queue_ms),
            "ttfa_admit_tick_p50_ms": _p50(self._ttfa_admit_tick_ms),
            "ttfa_tick_chunk_p50_ms": _p50(self._ttfa_tick_chunk_ms),
            "tick_dispatch_ms_p50": _p50(self._dispatch_ms),
            "tick_read_ms_p50": _p50(self._read_ms),
            "shard_ticks": list(self.shard_ticks),
            "shard_dispatch_ms_p50": [_p50(x) for x in self._shard_dispatch_ms],
        }

    # -------------------------------------------------------------- internals

    def _backlog_ok(self) -> bool:
        return all(s.last_t - s.emitted <= self.ramp_backlog_cap
                   for s in self._slots if s is not None and s.emitted > 0)

    def _admit(self):
        """Fill free slots from the waiting queue (scheduler thread only):
        every waiting session that fits joins in one group. Where the ramp
        is on and no established row is at the backlog cap, the group's
        first (ramp) tick is issued right after the join. Returns
        (deferred, tick): `deferred` when admission waits out the grace,
        `tick` the issued ramp tick or None."""
        while True:
            free = [i for i, s in enumerate(self._slots) if s is None]
            if not free or self._waiting.empty():
                return False, None
            group, requeue = [], []
            while len(group) < len(free) and not self._waiting.empty():
                req = self._waiting.get()
                if req["handle"].cancelled:
                    req["handle"].out.put(None)
                    continue
                if group and req["ref_sig"] != group[0]["ref_sig"]:
                    requeue.append(req)  # mixed reference shapes admit in waves
                    continue
                group.append(req)
            for req in requeue:
                self._waiting.put(req)
            if not group:
                continue
            if (self.admit_grace_s > 0.0 and len(group) < len(free) and len(free) == self.B
                    and time.perf_counter() - min(r["arrived_s"] for r in group)
                    < self.admit_grace_s):
                for req in group:
                    self._waiting.put(req)
                return True, None
            slots = free[: len(group)]
            try:
                for g, eng in enumerate(self.engines):
                    part = [j for j, slot in enumerate(slots) if slot // self.per == g]
                    if not part:
                        continue
                    reqs = [group[j] for j in part]
                    with kernels.on_device(eng.device):
                        eng.serve_join(
                            self.states[g], [slots[j] % self.per for j in part],
                            np.concatenate([r["ids"] for r in reqs]),
                            np.concatenate([r["mask"] for r in reqs]),
                            _cat_refs([r["ref"] for r in reqs]),
                            [r["strength"] for r in reqs], [r["seed"] for r in reqs],
                            {k: [r["settings"][k] for r in reqs] for k in reqs[0]["settings"]},
                        )
                now = time.perf_counter()
                self.admit_groups += 1
                for req, slot in zip(group, slots):
                    req["handle"].admitted_s, req["handle"].slot = now, slot
                    self._slots[slot] = _Slot(handle=req["handle"],
                                              max_frames=req["settings"]["max_frames"])
                if self.ramp < self.cf and self._backlog_ok():
                    return False, self._dispatch_tick(ramp=True)
            except Exception as e:  # deliver the failure to the group's callers
                for req, slot in zip(group, slots):
                    req["handle"].error = e
                    req["handle"].out.put(None)
                    if self._slots[slot] is not None and self._slots[slot].handle is req["handle"]:
                        self._slots[slot] = None

    def _run(self):
        with torch.inference_mode():
            self._loop()

    def _loop(self):
        # tick N+1 is issued before tick N is read: the copy of N and the
        # host's routing run while the device works on N+1
        pending: Optional[_Tick] = None
        while not self._stop.is_set():
            deferred, admitted = self._admit()
            busy = any(s is not None for s in self._slots)
            if not busy and pending is None:
                # under the grace, poll at ~1 ms so the burst joins as its window closes
                self._wake.wait(timeout=0.001 if deferred else 0.05)
                self._wake.clear()
                continue
            try:
                if admitted is not None:
                    # the joiners' first audio: read it before issuing more work
                    if pending is not None:
                        self._process_tick(pending)
                        pending = None
                    self._process_tick(admitted)
                nxt = self._dispatch_tick() if busy else None
                if pending is not None:
                    self._process_tick(pending)
                pending = nxt
            except Exception as e:  # fail every live session rather than spin
                for i, s in enumerate(self._slots):
                    if s is not None:
                        s.handle.error = e
                        s.handle.out.put(None)
                        self._slots[i] = None
                pending = None

    def _dispatch_tick(self, ramp: Optional[bool] = None) -> _Tick:
        """Issue one tick: a ramp tick (`ramp`, or by default while a live
        row awaits its first chunk and the backlog allows it) or a full one.
        Cancelled sessions are stopped and their slots freed first."""
        cancelled = [i for i, s in enumerate(self._slots) if s is not None and s.handle.cancelled]
        for g, eng in enumerate(self.engines):
            rows = [i % self.per for i in cancelled if i // self.per == g]
            if rows:
                eng.serve_stop(self.states[g], rows)
        for i in cancelled:
            self._slots[i].handle.out.put(None)
            self._slots[i] = None
        fresh = [s for s in self._slots if s is not None and s.emitted == 0 and not s.ramped]
        if ramp is None:
            ramp = self.ramp < self.cf and bool(fresh) and self._backlog_ok()
        if ramp:
            # a ramp tick emits for every row still at emitted == 0: it is the
            # first tick of all of them
            for s in self._slots:
                if s is not None and s.emitted == 0:
                    s.ramped = True
        cf = self.ramp if ramp else self.cf
        snap = list(self._slots)
        t0 = time.perf_counter()
        parts = []
        for g, (eng, st) in enumerate(zip(self.engines, self.states)):
            if all(s is None for s in snap[g * self.per: (g + 1) * self.per]):
                parts.append(None)  # only stopped rows: nothing to advance
                continue
            t1 = time.perf_counter()
            with kernels.on_device(eng.device):
                packed = eng.serve_tick(st, chunk=cf, nar_ctx=self.nar_ctx, first_only=ramp,
                                        pcm16=self.pcm16)
                event = None
                if packed.is_cuda:
                    # PyTorch's pinned pool hands this block out again only after the
                    # copy's event has passed and the tick has been read
                    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                    host.copy_(packed, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(eng.device))
                    packed = host
            parts.append((packed, event))
            self.shard_ticks[g] += 1
            self._shard_dispatch_ms[g] = (self._shard_dispatch_ms[g]
                                          + [(time.perf_counter() - t1) * 1000.0])[-100:]
        now = time.perf_counter()
        self._dispatch_ms = (self._dispatch_ms + [(now - t0) * 1000.0])[-100:]
        for s in self._slots:
            if s is not None and s.handle.first_tick_s is None:
                s.handle.first_tick_s = now
        self.ticks += int(any(p is not None for p in parts))
        self.ramp_ticks += int(ramp)
        return _Tick(parts, snap, cf)

    def _process_tick(self, tick: _Tick) -> None:
        """Wait for an issued tick's host copy and route its chunks. A slot
        freed or refilled since the tick was issued gets none of its rows."""
        t0 = time.perf_counter()
        n, per = tick.cf * self.hop, self.per
        wav = np.zeros((self.B, n), np.int16 if self.pcm16 else np.float32)
        info = np.zeros((4, self.B), np.int64)  # t, first_eos, stopped, n_new
        for g, part in enumerate(tick.parts):
            if part is None:
                continue
            packed, event = part
            if event is not None:
                event.synchronize()
            flat = packed.numpy()
            wav[g * per: (g + 1) * per] = flat[: per * n].reshape(per, n)
            info[:, g * per: (g + 1) * per] = flat[per * n:].reshape(4, per)
        self._read_ms = (self._read_ms + [(time.perf_counter() - t0) * 1000.0])[-100:]
        t, first_eos, stopped, n_new = info
        snap = tick.snap
        for i, s in enumerate(snap):
            if s is not None and self._slots[i] is s:
                s.last_t = int(t[i])
        for i, s in enumerate(snap):
            if s is None or s.handle.cancelled or n_new[i] <= 0:
                continue
            s.handle.out.put(wav[i: i + 1, : int(n_new[i]) * self.hop].copy())
            if s.handle.first_chunk_s is None:
                self._first_chunk(s.handle)
            s.emitted += int(n_new[i])
            s.handle.frames = s.emitted
        for i, s in enumerate(snap):
            if s is None or self._slots[i] is not s:
                continue
            done = bool(stopped[i]) or int(t[i]) >= self.S
            if done and s.emitted >= min(int(first_eos[i]), int(t[i]), s.max_frames + 1):
                s.handle.out.put(None)
                self.sessions_done += 1
                self.total_audio_s += s.emitted * self.hop / self.sr
                if s.handle.first_chunk_s is not None:
                    self._ttfa_ms = (self._ttfa_ms + [s.handle.first_chunk_s * 1000.0])[-100:]
                self._slots[i] = None

    def _first_chunk(self, h: SessionHandle) -> None:
        now = time.perf_counter()
        h.first_chunk_s = now - h.created_s
        stamps = (h.created_s, h.prep_done_s, h.admitted_s, h.first_tick_s, now)
        if all(x is not None for x in stamps):
            for name, a, b in (("_ttfa_prep_ms", 0, 1), ("_ttfa_queue_ms", 1, 2),
                               ("_ttfa_admit_tick_ms", 2, 3), ("_ttfa_tick_chunk_ms", 3, 4)):
                setattr(self, name,
                        (getattr(self, name) + [max(stamps[b] - stamps[a], 0.0) * 1000.0])[-100:])


def _ref_leaves(ref) -> list:
    return [ref.sv_ref, ref.ref_seq] + [v for kv in ref.ref_kv for v in kv.values()
                                        if v is not None]


def _cat_refs(refs):
    """One-row references of one shape -> a reference with a row each."""
    dev = refs[0].sv_ref.device if isinstance(refs[0].sv_ref, torch.Tensor) else "cpu"
    cat = lambda xs: torch.cat([torch.as_tensor(x).to(dev) for x in xs])
    return PreparedReference(
        sv_ref=cat([r.sv_ref for r in refs]), ref_seq=cat([r.ref_seq for r in refs]),
        ref_kv=tuple(
            {k: None if kvs[0][k] is None else cat([kv[k] for kv in kvs]) for k in kvs[0]}
            for kvs in zip(*[r.ref_kv for r in refs])
        ),
    )
