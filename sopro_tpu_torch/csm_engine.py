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

A frame's backbone step (frames 1.., after the prefill) and codebook 0's
decision are one call of `ops/csm_backbone.csm_backbone`: on the card one
launch of kernel K7, which sums the previous frame's code embeddings,
streams the backbone weights through its layers at the cache's next
position, applies the head and samples in the kernel; on the CPU the same
step eagerly (`ops/csm_backbone.step_plain`: `decoder` at one position,
`codebook0_logits`, `sampling.sample_topk`). Its 31 depth passes and their
samples are one call of `ops/csm_depth.csm_depth`: on the card one launch of
kernel K6, which streams the depth weights through every pass and samples
in the kernel; on the CPU the same passes eagerly (`_depth`,
`ops/csm_depth.depth_plain`) with `sampling.sample_topk`. Both kernels run
the same with or without a profiler. The prefill stays eager.

The host reads "an end frame was sampled" once every `EOS_EVERY` frames,
the one wait for the card inside the frame loop: it stops within
`EOS_EVERY` frames of an end frame, and the frames computed past it are
dropped.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.codec.mimi import MimiCodec
from sopro_tpu_torch.engine import configure_cuda_numerics
from sopro_tpu_torch.models.csm import CsmModel, KVCache
from sopro_tpu_torch.ops.csm_backbone import BackboneKernel, csm_backbone
from sopro_tpu_torch.ops.csm_depth import DepthKernel, csm_depth, depth_plain
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
        self._kernel: Optional[DepthKernel] = None
        self._backbone: Optional[BackboneKernel] = None

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

    def depth_kernel(self) -> Optional[DepthKernel]:
        """K6's launch over the model and the depth cache on a CUDA device
        (made at first use); None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._kernel is None:
            self._kernel = DepthKernel(self.model, self.caches()[1])
        return self._kernel

    def backbone_kernel(self) -> Optional[BackboneKernel]:
        """K7's launch over the model and the backbone cache on a CUDA device
        (made at first use); None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._backbone is None:
            self._backbone = BackboneKernel(self.model, self.caches()[0])
        return self._backbone

    def _depth(self, h: torch.Tensor, c: torch.Tensor,
               pick: Callable[[int, torch.Tensor], torch.Tensor], out: torch.Tensor) -> None:
        """One frame's depth passes eagerly (`depth_plain`) after the
        backbone's last hidden state h [1, D] and codebook 0's code c [1]:
        `pick(i, logits [1, V])` gives codebook i's code; the frame's codes
        go to `out` [Q]."""
        depth_plain(self.model, self.caches()[1], h, c, pick, out)

    def _frames(self, tokens: torch.Tensor, mask: torch.Tensor, max_frames: int,
                pick: Callable[[torch.Tensor], torch.Tensor],
                stop: Callable[[torch.Tensor, int], bool],
                step: Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], None],
                depth: Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], None]
                ) -> Tuple[torch.Tensor, int]:
        """The frame loop over the prompt: `pick(logits [1, V])` gives
        codebook 0's code [1] of frame 0 after the prefill, `step(f, prev, h,
        c)` runs frame f's backbone step on frame f - 1's codes `prev` [Q]
        and writes the final norm's output h [1, D] and codebook 0's code c
        [1], `depth(f, h, c, out)` runs the frame's depth passes and writes
        its codes to `out` [Q], `stop(codes, f)` after frame f says whether
        to end. -> (codes [max_frames, Q] int64, frames computed)."""
        m, q, dev = self.model, self.cfg.num_codebooks, self.device
        room = self.cfg.backbone.max_position_embeddings - tokens.shape[0]
        if max_frames < 1 or max_frames > room:
            raise ValueError(f"max_frames {max_frames}: the prompt of {tokens.shape[0]} positions "
                             f"leaves room for 1..{room} frames")
        bc = self.caches()[0]
        bc.reset()
        codes = torch.zeros((max_frames, q), dtype=torch.int64, device=dev)
        h = torch.empty((1, self.cfg.backbone.hidden_size), device=dev)
        c = torch.empty((1,), dtype=torch.int64, device=dev)
        with span("csm.prefill"):
            h.copy_(m.backbone(m.embed_prompt(tokens, mask), bc)[-1:])
            c.copy_(pick(m.codebook0_logits(h)))
        for f in range(max_frames):
            if f > 0:
                with span("csm.backbone"):
                    step(f, codes[f - 1], h, c)
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
        sample = lambda logits: S.sample_topk(logits, noise[0, :1], temperature, top_k)
        (bc, dc), m = self.caches(), self.model
        backbone, kernel = self.backbone_kernel(), self.depth_kernel()
        step = lambda f, prev, h, c: csm_backbone(m, bc, prev, h, c, noise=noise[f, 0],
                                                  temperature=temperature, top_k=top_k, kernel=backbone)
        depth = lambda f, h, c, out: csm_depth(m, dc, h, c, out, noise=noise[f], temperature=temperature,
                                               top_k=top_k, kernel=kernel)
        return self._frames(tokens, mask, max_frames, sample, self._eos_poll(), step, depth)

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
        codes = codes.to(self.device)
        logits = torch.zeros((n, q, self.cfg.vocab_size), device=self.device)
        (bc, dc), m = self.caches(), self.model
        backbone, kernel = self.backbone_kernel(), self.depth_kernel()

        def keep(x):
            logits[0, 0] = x[0]
            return codes[0, :1]
        step = lambda f, prev, h, c: csm_backbone(m, bc, prev, h, c, forced=codes[f, :1],
                                                  logits=logits[f, 0], kernel=backbone)
        depth = lambda f, h, c, out: csm_depth(m, dc, h, c, out, forced=codes[f, 1:],
                                               logits=logits[f, 1:], kernel=kernel)
        self._frames(tokens, mask, n, keep, lambda c, f: False, step, depth)
        return logits[:, 0], logits[:, 1:]
