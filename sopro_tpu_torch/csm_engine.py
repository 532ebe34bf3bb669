"""The CSM plan: prompt prefill, then per frame one backbone step and the
codebook-0 sample, 31 depth-decoder passes each followed by its sample, all
on the device; one Mimi decode of the utterance and one readback.

Prompt (Sesame's `generator.py`): the reference segment (its speaker-tagged
transcript as text positions, its Mimi frames as audio positions, then an
all-zero audio frame), then the text to speak as text positions. Frame f's
codes enter the backbone as one position of the next step. A frame whose
codes are all `codebook_eos_token_id` ends the utterance; it and every
frame after it are dropped.

Random bits (Threefry-2x32, `sampling.py`): the call's key is the block at
counters (0, 0) under key (0, seed); frame f's key the block at counters
(0, f) under it; codebook i's key in frame f the block at counters (0, i)
under the frame's key; vocab id v's uniform the block at counters (v, 0)
under the codebook's key (`sampling.gumbel_for_ids`). All of a call's
Gumbel noise is drawn in `csm.prepare`, so the frame loop only adds it.

On the card a frame's 31 depth passes and their samples run as one CUDA
graph (`DepthGraph`, one per temperature and top-k), replayed once a frame;
the backbone step stays eager (its cache grows a position a frame). The CPU
runs the same passes eagerly, and so does the card while torch.profiler
runs: stopping the profiler in one thread while another replays a graph
hung the process in CUPTI on an H100 (CUDA 12.8, torch 2.11; three
traced runs of three, the stop in `_disable_profiler`, the replay in
`CUDAGraph.replay`). Both run the same kernels on the same buffers, so the
codes are the same.

The host reads "an end frame was sampled" once every `EOS_EVERY` frames,
the one wait for the card inside the frame loop: it stops within
`EOS_EVERY` frames of an end frame, and the frames computed past it are
dropped.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.codec.mimi import MimiCodec
from sopro_tpu_torch.engine import configure_cuda_numerics
from sopro_tpu_torch.models.csm import CsmModel, KVCache
from sopro_tpu_torch.profiling import span

NOISE_BLOCK = 64  # frames of Gumbel noise drawn per Threefry call
EOS_EVERY = 8  # frames between the host's reads of the end flag


class CsmReference(NamedTuple):
    """A prepared reference segment on the device: tokens and mask [S, Q + 1]
    (codes in the first Q columns, the text id in the last)."""

    tokens: torch.Tensor
    mask: torch.Tensor


def text_rows(ids: Sequence[int], q: int) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.asarray(ids, np.int64)
    tokens = np.zeros((len(ids), q + 1), np.int64)
    mask = np.zeros((len(ids), q + 1), bool)
    tokens[:, q], mask[:, q] = ids, True
    return tokens, mask


def audio_rows(codes_tq: np.ndarray, q: int, eos_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Mimi frames [T, Q] and the all-end frame after them."""
    codes = np.asarray(codes_tq, np.int64)
    if codes.ndim != 2 or codes.shape[1] != q:
        raise ValueError(f"reference codes must be [frames, {q}], got {codes.shape}")
    tokens = np.zeros((codes.shape[0] + 1, q + 1), np.int64)
    tokens[:-1, :q], tokens[-1, :q] = codes, eos_id
    mask = np.zeros(tokens.shape, bool)
    mask[:, :q] = True
    return tokens, mask


class CsmEngine:
    def __init__(self, model: CsmModel, mimi: MimiCodec):
        self.model = model
        self.cfg = model.cfg
        self.mimi = mimi
        self.device = model.device()
        if self.device.type == "cuda":
            configure_cuda_numerics()
        self._caches: Optional[Tuple[KVCache, KVCache]] = None
        self._graphs: Dict[Tuple[float, int], "DepthGraph"] = {}

    def caches(self) -> Tuple[KVCache, KVCache]:
        """The backbone's cache (its whole context) and the depth decoder's
        (one frame's positions), allocated once."""
        if self._caches is None:
            b, d = self.cfg.backbone, self.cfg.depth
            self._caches = (KVCache(b, b.max_position_embeddings, self.device),
                            KVCache(d, d.max_position_embeddings, self.device))
        return self._caches

    def prepare_reference(self, transcript_ids: Sequence[int], codes_tq: np.ndarray) -> CsmReference:
        q = self.cfg.num_codebooks
        rows = [text_rows(transcript_ids, q), audio_rows(codes_tq, q, self.cfg.codebook_eos_token_id)]
        return CsmReference(*(torch.from_numpy(np.concatenate(x)).to(self.device)
                              for x in zip(*rows)))

    def prompt(self, ids: Sequence[int], ref: Optional[CsmReference]):
        """The call's prompt tokens and mask [S, Q + 1] on the device."""
        tokens, mask = (torch.from_numpy(x).to(self.device)
                        for x in text_rows(ids, self.cfg.num_codebooks))
        if ref is not None:
            tokens, mask = torch.cat([ref.tokens, tokens]), torch.cat([ref.mask, mask])
        return tokens, mask

    def gumbel(self, seed: int, frames: int) -> torch.Tensor:
        """[frames, Q, V]: each decision's noise over the vocabulary, keyed as
        the module docstring says."""
        dev, q, v = self.device, self.cfg.num_codebooks, self.cfg.vocab_size
        s = torch.tensor(int(seed) & 0xFFFFFFFF, dtype=torch.int64)
        k0, k1 = S.threefry2x32(0, s, 0, 0)
        out = torch.empty((frames, q, v), dtype=torch.float32, device=dev)
        for f0 in range(0, frames, NOISE_BLOCK):
            f = torch.arange(f0, min(f0 + NOISE_BLOCK, frames), dtype=torch.int64, device=dev)
            fk = S.threefry2x32(k0, k1, 0, f)
            ck = S.threefry2x32(fk[0][:, None], fk[1][:, None], 0,
                                torch.arange(q, dtype=torch.int64, device=dev)[None])
            out[f0: f0 + len(f)] = S.gumbel_for_ids(torch.stack(ck, -1), v)
        return out

    def _depth(self, h: torch.Tensor, c: torch.Tensor,
               pick: Callable[[int, torch.Tensor], torch.Tensor], out: torch.Tensor) -> None:
        """One frame's depth passes after the backbone's last hidden state h
        [1, D] and codebook 0's code c [1]: `pick(i, logits [1, V])` gives
        codebook i's code; the frame's codes go to `out` [Q]."""
        m, dc = self.model, self.caches()[1]
        frame = [c]
        dc.reset()
        x = torch.cat([h, m.depth_input(0, c)])
        for i in range(1, self.cfg.num_codebooks):
            c = pick(i, m.codebook_logits(i, m.depth(x, dc)))
            frame.append(c)
            x = m.depth_input(i, c)
        torch.cat(frame, out=out)

    def _frames(self, tokens: torch.Tensor, mask: torch.Tensor, max_frames: int,
                pick: Callable[[int, int, torch.Tensor], torch.Tensor],
                stop: Callable[[torch.Tensor, int], bool],
                depth: Optional[Callable] = None) -> Tuple[torch.Tensor, int]:
        """The frame loop over the prompt: `pick(f, i, logits [1, V])` gives
        codebook i's code [1] of frame f, `stop(codes, f)` after frame f says
        whether to end; `depth(f, h, c, out)` runs a frame's depth passes
        (by default `_depth` with `pick`). -> (codes [max_frames, Q] int64,
        frames computed)."""
        m, q, dev = self.model, self.cfg.num_codebooks, self.device
        room = self.cfg.backbone.max_position_embeddings - tokens.shape[0]
        if max_frames < 1 or max_frames > room:
            raise ValueError(f"max_frames {max_frames}: the prompt of {tokens.shape[0]} positions "
                             f"leaves room for 1..{room} frames")
        if depth is None:
            depth = lambda f, h, c, out: self._depth(h, c, lambda i, x: pick(f, i, x), out)
        bc = self.caches()[0]
        bc.reset()
        codes = torch.zeros((max_frames, q), dtype=torch.int64, device=dev)
        with span("csm.prefill"):
            h = m.backbone(m.embed_prompt(tokens, mask), bc)[-1:]
            c = pick(0, 0, m.codebook0_logits(h))
        for f in range(max_frames):
            if f > 0:
                with span("csm.backbone"):
                    h = m.backbone(m.embed_frame(codes[f - 1]), bc)
                    c = pick(f, 0, m.codebook0_logits(h))
            with span("csm.depth"):
                depth(f, h, c, codes[f])
            if stop(codes, f):
                return codes, f + 1
        return codes, max_frames

    def _eos_poll(self):
        """A `stop` that reads "an end frame was sampled" every `EOS_EVERY`
        frames (module docstring)."""
        eos = self.cfg.codebook_eos_token_id
        ended = torch.zeros((), dtype=torch.bool, device=self.device)

        def stop(codes, f):
            ended.logical_or_((codes[f] == eos).all())
            return (f + 1) % EOS_EVERY == 0 and bool(ended)
        return stop

    @torch.inference_mode()
    def generate(self, tokens: torch.Tensor, mask: torch.Tensor, *, max_frames: int, seed: int,
                 temperature: float, top_k: int) -> Tuple[torch.Tensor, int]:
        """Sampled codes [max_frames, Q] and the frames computed (a host
        int); the utterance is the frames before the first end frame."""
        with span("csm.prepare"):
            noise = self.gumbel(seed, max_frames)
        sample = lambda f, i, logits: S.sample_topk(logits, noise[f, i: i + 1], temperature, top_k)
        key = (float(temperature), int(top_k))

        def depth(f, h, c, out):
            if self.device.type != "cuda" or _autograd_profiler._is_profiler_enabled:
                self._depth(h, c, lambda i, x: sample(f, i, x), out)  # module docstring
                return
            if key not in self._graphs:
                self._graphs[key] = DepthGraph(self, *key)
            self._graphs[key](h, c, noise[f], out)
        return self._frames(tokens, mask, max_frames, sample, self._eos_poll(), depth)

    @torch.inference_mode()
    def synthesize(self, ids: Sequence[int], ref: Optional[CsmReference], *, max_frames: int,
                   seed: int, temperature: float, top_k: int) -> Tuple[np.ndarray, int]:
        """-> (wav [1, frames * hop] float32 on the host, frames)."""
        with span("csm.prepare"):
            tokens, mask = self.prompt(ids, ref)
        codes, n = self.generate(tokens, mask, max_frames=max_frames, seed=seed,
                                 temperature=temperature, top_k=top_k)
        with span("csm.mimi"):
            codes = codes[:n]
            ends = (codes == self.cfg.codebook_eos_token_id).all(-1)
            first = torch.where(ends.any(), ends.int().argmax(), n)
            wav = self.mimi(codes[None])
        with span("csm.readback"):
            flat = torch.cat([wav[0].float(), first.float()[None]]).cpu().numpy()
            t = int(flat[-1])
            return flat[:-1][None, : t * int(self.mimi.cfg.hop_length)], t

    @torch.inference_mode()
    def teacher_forced(self, tokens: torch.Tensor, mask: torch.Tensor,
                       codes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The plan's logits with every code given: codes [F, Q] -> codebook
        0's logits [F, V] (prefill, then backbone steps through the cache) and
        codebooks 1..Q-1's [F, Q - 1, V] (depth passes through theirs)."""
        n, q = codes.shape
        logits = torch.zeros((n, q, self.cfg.vocab_size), device=self.device)

        def keep(f, i, x):
            logits[f, i] = x[0]
            return codes[f, i: i + 1]
        self._frames(tokens, mask, n, keep, lambda c, f: False)
        return logits[:, 0], logits[:, 1:]


class DepthGraph:
    """`CsmEngine._depth` with its samples, captured once as a CUDA graph over
    static inputs (the backbone's last hidden state, codebook 0's code, the
    frame's Gumbel noise) at one temperature and top-k, and replayed once a
    frame: the same kernels on the same buffers, one launch in place of
    ~2,300. The depth cache's positions are the same every frame, so the
    captured passes write and read it as the eager ones do."""

    def __init__(self, engine: CsmEngine, temperature: float, top_k: int):
        cfg, dev = engine.cfg, engine.device
        self.h = torch.zeros((1, cfg.backbone.hidden_size), device=dev)
        self.c0 = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.noise = torch.zeros((cfg.num_codebooks, cfg.vocab_size), device=dev)
        self.codes = torch.zeros((cfg.num_codebooks,), dtype=torch.int64, device=dev)
        pick = lambda i, x: S.sample_topk(x, self.noise[i: i + 1], temperature, top_k)
        run = lambda: engine._depth(self.h, self.c0, pick, self.codes)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()  # cuBLAS and SDPA set themselves up outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            run()

    def __call__(self, h: torch.Tensor, c0: torch.Tensor, noise: torch.Tensor,
                 out: torch.Tensor) -> None:
        self.h.copy_(h)
        self.c0.copy_(c0)
        self.noise.copy_(noise)
        self.graph.replay()
        out.copy_(self.codes)
