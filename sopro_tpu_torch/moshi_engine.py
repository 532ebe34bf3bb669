"""The Moshi plan: the conversation's history through the temporal
transformer in one prefill, then per frame one temporal step, the text
sample, and the depformer's steps each followed by its sample, all on the
device with no host sync; one Mimi decode of Moshi's codebooks and one
readback of the waveform and the text ids.

Positions (`models/moshi.py`): `delay` lays a conversation's frames out
as positions, the acoustic delay applied, in one tensor `seq` [P, 17]
(text, Moshi's codebooks, the user's). A history of H frames fills
positions 0..H, and position H + 1's codebooks 1..7 (those of the
history's last frame). A call of F frames runs steps g = 0..F: step g's
temporal hidden state is that of position H + g (the prefill's last for g
= 0, then one cached position a step) and its decisions fill position H +
g + 1: the text token (Moshi's text for frame H + g), then codebooks 0..7
(codebook 0 of frame H + g, codebooks 1..7 of frame H + g - 1). Step 0
decides the text and codebook 0 only: codebooks 1..7 at position H + 1
are the history's, kept as transformers' delay mask keeps a prompt's.
Step F completes frame H + F - 1; its text and codebook 0 belong to the
frame after the call and only feed its depformer steps. The user's frames
H.. (the call's `user_codes_tq`) are laid into `seq` as it is built, so
step g reads the user's frame H + g - 1 (codebooks 1..7: H + g - 2) from
the device. The call returns frames H..H + F - 1: F text ids, and
Moshi's codes [F, Q] decoded by Mimi's first Q quantizers.

Random bits (Threefry-2x32, `sampling.py`): the call's key is the block
at counters (0, 0) under key (0, seed); step g's key the block at counters
(0, g) under it; decision d's key in step g the block at counters (0, d)
under the step's key, d = 0 for the text token and d = 1 + k for codebook
k; vocab id v's uniform the block at counters (v, 0) under the decision's
key (`sampling.gumbel_for_ids`). All of a call's Gumbel noise is drawn in
`moshi.prepare`, so the frame loop only adds it.

Every step runs on cuBLAS products and SDPA attention in float32 with TF32
off, and the frame loop never waits for the card. The prefill is eager.
Each step after it runs one temporal position and its text sample
(`temporal_step`), the position held on the device and the attention (as
batched products, `models/csm.py` `_attend_at`) reaching the cache's
first `attended` positions, those past it masked;
then the depformer's steps with their samples (`depth_steps`). Both read
static buffers (the position's row, its position, the step's noise, the
temperature), so that on the card they replay as CUDA graphs at one top-k
each: `StepGraphs`, one graph per attended length (a multiple of `BUCKET`,
so at most 6 over the 3,000 positions; ~470 launches in one), and
`DepthGraph` (~700 in one). A call at another top-k makes them anew. While
a profiler runs they run eagerly, the same kernels on the same buffers: a
graph replayed while `torch.profiler` stops in another thread hangs the
stop.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.codec.mimi import MimiCodec
from sopro_tpu_torch.engine import configure_cuda_numerics
from sopro_tpu_torch.models.csm import KVCache
from sopro_tpu_torch.models.moshi import MoshiModel
from sopro_tpu_torch.profiling import profiler_running, span


class MoshiHistory(NamedTuple):
    """A conversation's history on the device, frame by frame: Moshi's text
    ids [H], Moshi's codes [H, Q] and the user's [H, Q]."""

    text: torch.Tensor
    moshi: torch.Tensor
    user: torch.Tensor

    @property
    def frames(self) -> int:
        return int(self.text.shape[0])


BUCKET = 512  # the attended lengths of the temporal steps are its multiples


def attended(pos: int, length: int) -> int:
    """The cache positions a temporal step at position `pos` attends to,
    those past it masked: up to the next multiple of `BUCKET`, at most the
    cache's `length`."""
    return min(length, (pos // BUCKET + 1) * BUCKET)


def temporal_step(model: MoshiModel, cache: KVCache, row: torch.Tensor, where: torch.Tensor,
                  n: int, pick: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The temporal position of `seq`'s row `row` at the position held in
    where [1], attending to the cache's first n positions -> (its text
    token pick(logits [1, Vt]) [1], the hidden state [1, D])."""
    h = model.temporal(model.embed(row[None]), cache, at=(where, n))
    return pick(model.text_logits(h)), h


def depth_steps(model: MoshiModel, cache: KVCache, h: torch.Tensor, row: torch.Tensor, steps: int,
                pick: Callable[[int, torch.Tensor], torch.Tensor]) -> None:
    """The depformer after the temporal hidden state h [1, D], its cache
    started afresh: its first `steps` steps, step k reading row[k] (the
    text token, then codebook k - 1) and writing pick(k, logits [1, Va]) to
    row[1 + k]; `row` is the step's row of `seq`."""
    cache.reset()
    proj = model.depth_projections(h)
    for k in range(steps):
        y = model.depth_step(k, model.depth_input(k, row[k: k + 1], proj[k: k + 1]), cache)
        row[1 + k: 2 + k] = pick(k, model.audio_logits(k, y))


def delay(text: torch.Tensor, moshi: torch.Tensor, user: torch.Tensor, init_text: int,
          init_audio: int) -> torch.Tensor:
    """Frames 0..T-1 (text [T], codes [T, Q] of each audio stream) -> the
    positions 0..T [T + 1, 1 + 2Q] that hold them: position p the text and
    codebook 0 of frame p - 1 and codebooks 1..Q-1 of frame p - 2, the
    initial tokens where the delay leaves no frame (the module docstring of
    `models/moshi.py`)."""
    t, q = moshi.shape
    seq = torch.full((t + 1, 1 + 2 * q), init_audio, dtype=torch.int64, device=text.device)
    seq[0, 0] = init_text
    seq[1:, 0] = text
    for col, codes in ((1, moshi), (1 + q, user)):
        seq[1:, col] = codes[:, 0]
        seq[2:, col + 1: col + q] = codes[:-1, 1:]
    return seq


class MoshiEngine:
    def __init__(self, model: MoshiModel, mimi: MimiCodec):
        self.model = model
        self.cfg = model.cfg
        self.mimi = mimi
        self.device = model.device()
        if self.device.type == "cuda":
            configure_cuda_numerics()
        self._caches: Optional[Tuple[KVCache, KVCache]] = None
        self.graphs = self.device.type == "cuda"  # replay steps as CUDA graphs
        self._steps: Optional[StepGraphs] = None
        self._depths: Optional[DepthGraph] = None

    def caches(self) -> Tuple[KVCache, KVCache]:
        """The temporal transformer's cache (its whole context) and the
        depformer's (one frame's steps), allocated once."""
        if self._caches is None:
            t, d = self.cfg.temporal, self.cfg.depth
            self._caches = (KVCache(t, t.max_position_embeddings, self.device),
                            KVCache(d, d.max_position_embeddings, self.device))
        return self._caches

    def prepare_history(self, text_ids, moshi_codes_tq, user_codes_tq) -> MoshiHistory:
        q = self.cfg.num_codebooks
        text = np.asarray(text_ids, np.int64).reshape(-1)
        codes = [np.asarray(c, np.int64) for c in (moshi_codes_tq, user_codes_tq)]
        if text.shape[0] < 1 or any(c.shape != (text.shape[0], q) for c in codes):
            raise ValueError(f"a history is text ids [H] and two streams of codes [H, {q}], H >= 1; "
                             f"got {text.shape}, {codes[0].shape}, {codes[1].shape}")
        return MoshiHistory(*(torch.from_numpy(x).to(self.device) for x in [text] + codes))

    def sequence(self, history: MoshiHistory, user_codes_tq, frames: int) -> torch.Tensor:
        """`seq` for a call of `frames` frames after `history`: positions
        0..H + frames + 1, Moshi's text and codes past the history initial
        tokens until the steps decide them."""
        q, h = self.cfg.num_codebooks, history.frames
        user = torch.as_tensor(np.asarray(user_codes_tq, np.int64)).to(self.device)
        if user.shape != (frames, q):
            raise ValueError(f"the user's codes for {frames} frames must be [{frames}, {q}], "
                             f"got {tuple(user.shape)}")
        room = self.cfg.temporal.max_position_embeddings - h - 1
        if frames < 1 or frames > room:
            raise ValueError(f"max_frames {frames}: a history of {h} frames leaves room for "
                             f"1..{room} frames of the {room + h + 1}-position context")
        va, vt = self.cfg.audio_vocab_size, self.cfg.text_vocab_size
        pad = lambda n, value: torch.full((n, q), value, dtype=torch.int64, device=self.device)
        text = torch.cat([history.text, torch.full((frames + 1,), vt, dtype=torch.int64,
                                                   device=self.device)])
        moshi = torch.cat([history.moshi, pad(frames + 1, va)])
        user = torch.cat([history.user, user, pad(1, va)])
        return delay(text, moshi, user, vt, va)

    def noise(self, seed: int, steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """([steps, Vt], [steps, Q, Va]): each decision's Gumbel noise over
        its vocabulary, keyed as the module docstring says."""
        dev, q = self.device, self.cfg.num_codebooks
        s = torch.tensor(int(seed) & 0xFFFFFFFF, dtype=torch.int64)
        k0, k1 = S.threefry2x32(0, s, 0, 0)
        g = torch.arange(steps, dtype=torch.int64, device=dev)
        fk = S.threefry2x32(k0, k1, 0, g)
        dk = S.threefry2x32(fk[0][:, None], fk[1][:, None], 0,
                            torch.arange(1 + q, dtype=torch.int64, device=dev)[None])
        keys = torch.stack(dk, -1)  # [steps, 1 + Q, 2]
        return (S.gumbel_for_ids(keys[:, 0], self.cfg.text_vocab_size),
                S.gumbel_for_ids(keys[:, 1:], self.cfg.audio_vocab_size))

    def steppers(self, text_top_k: int, audio_top_k: int) -> Tuple["StepGraphs", "DepthGraph"]:
        """The temporal steps at `text_top_k` and the depformer's at
        `audio_top_k`, made at first use and anew when a top-k changes."""
        if self._steps is None or self._steps.top_k != text_top_k:
            self._steps = None  # its graphs freed before new ones are captured
            self._steps = StepGraphs(self, text_top_k)
        if self._depths is None or self._depths.top_k != audio_top_k:
            self._depths = None
            self._depths = DepthGraph(self, audio_top_k)
        return self._steps, self._depths

    def _frames(self, seq: torch.Tensor, h0: int, steps: int,
                text: Callable[[torch.Tensor], torch.Tensor],
                step: Callable[[int, int, torch.Tensor, torch.Tensor], torch.Tensor],
                depth: Callable[[int, torch.Tensor, torch.Tensor], None]) -> None:
        """The prefill of positions 0..h0 and step 0's text token
        (`text(logits [1, Vt])`), then steps g = 0..steps-1 (the module
        docstring): `step(g, pos, row, out)` runs step g > 0's temporal
        position pos = h0 + g from `seq`'s row of it, writes its text token
        to out (the next row) and gives the hidden state h [1, D]; `depth(g,
        h, out)` runs the step's depformer on out."""
        m, tc = self.model, self.caches()[0]
        tc.reset()
        with span("moshi.prefill"):
            h = m.temporal(m.embed(seq[: h0 + 1]), tc)[-1:]
            seq[h0 + 1, :1] = text(m.text_logits(h))
        for g in range(steps):
            if g > 0:
                with span("moshi.temporal"):
                    h = step(g, h0 + g, seq[h0 + g], seq[h0 + g + 1])
            with span("moshi.depth"):
                depth(g, h, seq[h0 + g + 1])

    def outputs(self, seq: torch.Tensor, h0: int, frames: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frames h0..h0 + frames - 1 of Moshi's streams in `seq`: (text ids
        [frames], codes [frames, Q]), the acoustic delay undone."""
        q = self.cfg.num_codebooks
        codes = torch.cat([seq[h0 + 1: h0 + frames + 1, 1:2], seq[h0 + 2: h0 + frames + 2, 2: 1 + q]], 1)
        return seq[h0 + 1: h0 + frames + 1, 0], codes

    @torch.inference_mode()
    def generate(self, history: MoshiHistory, user_codes_tq, *, max_frames: int, seed: int,
                 text_temperature: float, text_top_k: int, audio_temperature: float,
                 audio_top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (text ids [max_frames], codes [max_frames, Q]) on the device."""
        with span("moshi.prepare"):
            seq = self.sequence(history, user_codes_tq, max_frames)
            nt, na = self.noise(seed, max_frames + 1)
            steps, depths = self.steppers(int(text_top_k), int(audio_top_k))
            steps.temperature.fill_(float(text_temperature))
            depths.temperature.fill_(float(audio_temperature))
        q, h0 = self.cfg.num_codebooks, history.frames
        self._frames(seq, h0, max_frames + 1, lambda logits: steps.pick(logits, nt[:1]),
                     lambda g, pos, row, out: steps(pos, row, nt[g], out),
                     lambda g, h, out: depths(h, out, na[g], 1 if g == 0 else q))
        return self.outputs(seq, h0, max_frames)

    @torch.inference_mode()
    def converse(self, history: MoshiHistory, user_codes_tq, *, max_frames: int, seed: int,
                 text_temperature: float, text_top_k: int, audio_temperature: float,
                 audio_top_k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (wav [1, max_frames * hop] float32, text ids [max_frames],
        codes [max_frames, Q]) on the host."""
        text, codes = self.generate(history, user_codes_tq, max_frames=max_frames, seed=seed,
                                    text_temperature=text_temperature, text_top_k=text_top_k,
                                    audio_temperature=audio_temperature, audio_top_k=audio_top_k)
        with span("moshi.mimi"):
            wav = self.mimi(codes[None])
        with span("moshi.readback"):
            flat = torch.cat([wav[0].float(), text.float(), codes.flatten().float()]).cpu().numpy()
            n, f = wav.shape[-1], int(max_frames)
            return (flat[:n][None], flat[n: n + f].astype(np.int64),
                    flat[n + f:].astype(np.int64).reshape(f, -1))

    @torch.inference_mode()
    def teacher_forced(self, history: MoshiHistory, user_codes_tq, text_ids,
                       codes_tq) -> Tuple[torch.Tensor, torch.Tensor]:
        """The plan's logits with every token given: Moshi's text ids [F] and
        codes [F, Q] of the call's frames -> step g's text logits [F, Vt]
        (the prefill for g = 0, then the temporal cache) and its depformer
        logits [F, Q, Va] (every step, step 0's codebooks 1..Q-1 reading the
        history's), for steps 0..F-1 (step F would need the text and
        codebook 0 of the frame after the call)."""
        f = len(text_ids)
        seq = self.sequence(history, user_codes_tq, f)
        h0, q = history.frames, self.cfg.num_codebooks
        dev = self.device
        seq[h0 + 1: h0 + f + 1, 0] = torch.as_tensor(text_ids).to(dev, torch.int64)
        given = torch.as_tensor(codes_tq).to(dev, torch.int64)
        seq[h0 + 1: h0 + f + 1, 1] = given[:, 0]
        seq[h0 + 2: h0 + f + 2, 2: 1 + q] = given[:, 1:]
        lt = torch.zeros((f, self.cfg.text_vocab_size), device=dev)
        la = torch.zeros((f, q, self.cfg.audio_vocab_size), device=dev)

        def text(g, logits):
            lt[g] = logits[0]
            return seq[h0 + g + 1, :1].clone()

        def code(g, k, logits):
            la[g, k] = logits[0]
            return seq[h0 + g + 1, 1 + k: 2 + k].clone()

        tc, dc = self.caches()
        where = torch.zeros((1,), dtype=torch.int64, device=dev)

        def step(g, pos, row, out):
            where.fill_(pos)
            out[:1], h = temporal_step(self.model, tc, row, where, attended(pos, tc.length),
                                       lambda x: text(g, x))
            return h
        self._frames(seq, h0, f, lambda logits: text(0, logits), step,
                     lambda g, h, out: depth_steps(self.model, dc, h, out, q,
                                                   lambda k, x: code(g, k, x)))
        return lt, la


def capture(run: Callable[[], None], device, pool=None):
    """`run` captured as a CUDA graph on `device` (in `pool`, a
    `torch.cuda.graph_pool_handle()`, if given), after one run on a side
    stream so that cuBLAS and SDPA set themselves up outside the capture."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        run()
    return graph


class StepGraphs:
    """`temporal_step` and its text sample at one top-k over static buffers
    (the row, the position, the noise, the temperature), which each step
    fills: on the card one CUDA graph per attended length, captured at the
    length's first use into one memory pool and replayed after; eager
    elsewhere and while a profiler runs. Nothing here refers back to the
    engine, so dropping the engine frees the model at once, without
    waiting for the garbage collector."""

    def __init__(self, engine: MoshiEngine, top_k: int):
        cfg, dev = engine.cfg, engine.device
        self.model, self.cache, self.device = engine.model, engine.caches()[0], dev
        self.top_k = top_k
        self.row = torch.zeros((1 + 2 * cfg.num_codebooks,), dtype=torch.int64, device=dev)
        self.where = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.noise = torch.zeros((cfg.text_vocab_size,), device=dev)
        self.temperature = torch.ones((1,), device=dev)
        self.tok = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.h = torch.zeros((1, cfg.temporal.hidden_size), device=dev)
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self.graphs: Optional[Dict[int, object]] = {} if engine.graphs else None

    def pick(self, logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """The text token of logits [1, Vt] on noise [1, Vt] -> [1]."""
        return S.sample_topk(logits, noise, self.temperature, self.top_k)

    def _run(self, n: int) -> None:
        tok, h = temporal_step(self.model, self.cache, self.row, self.where, n,
                               lambda logits: self.pick(logits, self.noise[None]))
        self.tok.copy_(tok)
        self.h.copy_(h)

    def __call__(self, pos: int, row: torch.Tensor, noise: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
        """The temporal position `pos` of `seq`'s row `row`, its text token
        sampled on `noise` [Vt] into out[0] -> the hidden state [1, D] (a
        static buffer)."""
        self.where.fill_(pos)
        self.row.copy_(row)
        self.noise.copy_(noise)
        n = attended(pos, self.cache.length)
        if self.graphs is None or profiler_running():
            self._run(n)
        else:
            if n not in self.graphs:
                self.graphs[n] = capture(lambda: self._run(n), self.device, self.pool)
            self.graphs[n].replay()
        out[:1].copy_(self.tok)
        return self.h


class DepthGraph:
    """`depth_steps` over a step's depformer steps with their samples at one
    top-k, over static buffers (the temporal hidden state, the step's text
    token, its noise, the temperature): all of them on the card as one CUDA
    graph, captured when made and replayed once a step; eager elsewhere,
    for step 0 (codebook 0 alone) and while a profiler runs. The depformer
    cache's positions are the same every step, so the captured steps write
    and read it as the eager ones do."""

    def __init__(self, engine: MoshiEngine, top_k: int):
        cfg, dev = engine.cfg, engine.device
        self.q, self.top_k = cfg.num_codebooks, top_k
        self.model, self.cache = engine.model, engine.caches()[1]
        self.h = torch.zeros((1, cfg.temporal.hidden_size), device=dev)
        self.row = torch.zeros((1 + self.q,), dtype=torch.int64, device=dev)
        self.noise = torch.zeros((self.q, cfg.audio_vocab_size), device=dev)
        self.temperature = torch.ones((1,), device=dev)
        self.graph = capture(lambda: self._run(self.q), dev) if engine.graphs else None

    def _run(self, steps: int) -> None:
        pick = lambda k, logits: S.sample_topk(logits, self.noise[k: k + 1], self.temperature,
                                               self.top_k)
        depth_steps(self.model, self.cache, self.h, self.row, steps, pick)

    def __call__(self, h: torch.Tensor, row: torch.Tensor, noise: torch.Tensor, steps: int) -> None:
        """A step's first `steps` depformer steps after h [1, D] with its
        noise [Q, Va]: reads row[0] (the text token) of `seq`'s row, writes
        Moshi's codebooks 0..steps-1 to row[1: 1 + steps]."""
        self.h.copy_(h)
        self.row[:1].copy_(row[:1])
        self.noise.copy_(noise)
        if steps == self.q and self.graph is not None and not profiler_running():
            self.graph.replay()
        else:
            self._run(steps)
        row[1: 1 + steps].copy_(self.row[1: 1 + steps])
