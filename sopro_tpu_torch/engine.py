"""Execution engine (counterpart: sopro_tpu/engine.py): padding to the JAX
package's buckets and the device plans, each ending in one device->host
copy:

- the fused synthesize plan: conditioning, AR decode (kernel K1 on CUDA),
  NAR refine over every frame (kernel K2) and the Mimi decode (kernel K3);
- the stream plan, one call per chunk of `cf` frames: `stream_start_fused`
  (conditioning, a K1 chunk, NAR over the chunk, a Mimi stream step whose
  SEANet is kernel K4 over zero history) and `stream_step_fused` (a K1
  chunk, NAR over a window of `cf + nar_ctx` frames with the last stage's
  heads on the chunk only, a Mimi stream step). The state (ARCarry,
  ARLoopContext, cond, MimiStreamState) stays on the device between calls;
  the host gets the chunk's samples with the valid frame count and the done
  flag packed behind them;
- `encode_audio`: Mimi encode of a reference waveform, padded to a ref
  bucket.

Text, reference and frame padding follow the JAX package exactly
(`pick_bucket`, `_pad_axis`, NAR and vocoder over all max_frames+1 frames
with a validity mask), so both packages compute on the same shapes. One
difference: the stream's NAR window always covers original frames
[emitted + cf - w, emitted + cf), zero-padded on both sides, where the JAX
package clamps the window's start and shifts the last chunk of a
max-length stream back by one frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sopro_tpu_torch.codec.mimi import MimiCodec, mimi_encode
from sopro_tpu_torch.codec.streaming import MimiStreamState, init_mimi_stream_state, mimi_decode_step
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig, pick_bucket
from sopro_tpu_torch.models import sopro as M
from sopro_tpu_torch.ops.ar_loop import ARLoopContext


def _pad_axis(x: np.ndarray, axis: int, to: int) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, to - x.shape[axis])
    return np.pad(x, pad)


def configure_cuda_numerics() -> None:
    """Full float32 on the card: TF32 in matmuls or cuDNN convs would break
    the port's fp32 tolerances."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Engine:
    def __init__(
        self,
        model: M.SoproModel,
        mimi: MimiCodec,
        runtime: Optional[RuntimeConfig] = None,
    ):
        self.model = model
        self.cfg: SoproTTSConfig = model.cfg
        self.mimi = mimi
        self.mimi_cfg = mimi.cfg
        self.rt = runtime or RuntimeConfig()
        self.device = model.device()
        if self.device.type == "cuda":
            configure_cuda_numerics()

    def _padded(self, row: np.ndarray, buckets) -> Tuple[torch.Tensor, torch.Tensor]:
        """[T, ...] ints -> ([1, Tb, ...] int32, mask [1, Tb]) on the device."""
        t = int(row.shape[0])
        tb = pick_bucket(t, buckets)
        ids = _pad_axis(np.asarray(row, np.int32), 0, tb)[None]
        mask = np.zeros((1, tb), bool)
        mask[:, :t] = True
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    @torch.inference_mode()
    def encode_audio(self, wav: np.ndarray) -> np.ndarray:
        """Mono wav [S] at the codec rate -> codes [T, Q], T = ceil(S / hop).
        The input is right-padded to a ref bucket of frames: every encoder
        stage is causal, so the first T frames are those of the exact input."""
        hop = int(self.mimi_cfg.hop_length)
        s = int(wav.shape[-1])
        t = -(-s // hop)
        tb = pick_bucket(t, self.rt.ref_buckets)
        wav_p = _pad_axis(np.asarray(wav, np.float32), -1, tb * hop)
        codes = mimi_encode(self.mimi.p, self.mimi_cfg, torch.from_numpy(wav_p)[None].to(self.device))
        return codes[0, :t].cpu().numpy()

    @torch.inference_mode()
    def prepare_reference(self, ref_tokens_tq: np.ndarray) -> M.PreparedReference:
        """[T, Q] tokens -> PreparedReference (padded to a ref bucket; the
        masks keep the numerics exact)."""
        toks, mask = self._padded(ref_tokens_tq, self.rt.ref_buckets)
        return M.prepare_reference(self.model, toks, mask=mask)

    @torch.inference_mode()
    def prepare_conditioning(
        self, text_ids: np.ndarray, ref: M.PreparedReference, *,
        max_frames: int, style_strength: float,
    ) -> Dict[str, torch.Tensor]:
        ids, mask = self._padded(text_ids, self.rt.text_buckets)
        return M.prepare_conditioning(
            self.model, ids, mask, ref, max_frames=max_frames, style_strength=style_strength
        )

    def fused_synth_graph(
        self, ids: torch.Tensor, mask: torch.Tensor, ref: M.PreparedReference,
        strength: float, seed: int, settings: M.ARSettings, *, max_frames: int,
    ):
        """Conditioning + AR decode + NAR over all max_frames+1 frames +
        Mimi decode, on the device. Returns (wav [1, s*hop], t [1], tokens
        [1, s, Q])."""
        s = int(max_frames) + 1
        prep = M.prepare_conditioning(
            self.model, ids, mask, ref, max_frames=max_frames, style_strength=strength
        )
        carry = M.ar_generate(
            self.model, prep["cond_ar"], prep["txt_seq"], mask, seed, settings, s
        )
        t = torch.minimum(carry.first_eos, carry.t)  # [1]
        frame_mask = torch.arange(s, device=t.device)[None, :] < t[:, None]
        toks = M.nar_refine(self.model, prep["cond_ar"], carry.tokens, mask=frame_mask)
        return self.mimi(toks), t, toks

    @torch.inference_mode()
    def synthesize_fused(
        self,
        ids_row: np.ndarray,
        ref: M.PreparedReference,
        *,
        max_frames: int,
        style_strength: float,
        seed: int,
        top_p: float,
        temperature: float,
        anti_loop: bool,
        min_gen: int,
        return_tokens: bool = False,
    ):
        """Whole pipeline with one device->host copy.
        Returns (wav [1, t*hop] float32, t), plus tokens [t, Q] when asked."""
        ids, mask = self._padded(ids_row, self.rt.text_buckets)
        settings = _settings(top_p, temperature, anti_loop, min_gen)
        wav, t, toks = self.fused_synth_graph(
            ids, mask, ref, float(style_strength), int(seed), settings, max_frames=max_frames
        )
        t = int(t.cpu()[0])
        wav = wav.cpu().numpy()[:, : t * int(self.mimi_cfg.hop_length)]
        if return_tokens:
            return wav, t, toks[0, :t].cpu().numpy()
        return wav, t

    # -- the stream plan: one call per chunk --------------------------------

    def _chunk_out(self, wav: torch.Tensor, carry: M.ARCarry):
        """Pack [wav..., valid, done] into one float32 row and copy it to the
        host once -> (wav [1, n] numpy, valid, done)."""
        s = carry.tokens.shape[1]
        valid = torch.minimum(carry.first_eos, carry.t)[:1].float()
        done = (~((carry.t < s) & (carry.stopped == 0)).any()).float()[None]
        flat = torch.cat([wav[0], valid, done]).cpu().numpy()
        return flat[:-2][None], int(flat[-2]), bool(flat[-1])

    @torch.inference_mode()
    def stream_start_fused(
        self,
        ids_row: np.ndarray,
        ref: M.PreparedReference,
        *,
        max_frames: int,
        chunk: int,
        style_strength: float,
        seed: int,
        top_p: float,
        temperature: float,
        anti_loop: bool,
        min_gen: int,
    ) -> Tuple[np.ndarray, int, bool, M.ARCarry, ARLoopContext, torch.Tensor, MimiStreamState]:
        """The first chunk: conditioning, text KV, a K1 chunk of `chunk`
        steps, NAR over those frames, and a Mimi stream step from zero
        history. Returns (wav [1, chunk*hop], valid, done, carry, ctx, cond,
        mstate); the caller ships wav[:, :valid*hop]."""
        cf, s = int(chunk), int(max_frames) + 1
        if not 0 < cf <= s:
            raise ValueError(f"chunk={chunk} must be in [1, max_frames+1={s}]")
        ids, mask = self._padded(ids_row, self.rt.text_buckets)
        prep = M.prepare_conditioning(
            self.model, ids, mask, ref, max_frames=max_frames, style_strength=style_strength
        )
        cond = prep["cond_ar"]
        ctx = M.ar_context(self.model, prep["txt_seq"], mask)
        carry = M.init_ar_carry(self.cfg, 1, s, int(seed), self.device)
        carry = M.ar_chunk(carry, cond, ctx, _settings(top_p, temperature, anti_loop, min_gen), cf)
        valid = torch.minimum(carry.first_eos, carry.t)
        frame_mask = torch.arange(cf, device=self.device)[None, :] < valid[:, None]
        toks = M.nar_refine(self.model, cond[:, :cf], carry.tokens[:, :cf], mask=frame_mask)
        wav, mstate = mimi_decode_step(
            self.mimi.p, self.mimi_cfg, toks, init_mimi_stream_state(self.mimi_cfg, 1, self.device),
            packed=self.mimi.packed_decoder(),
        )
        return (*self._chunk_out(wav, carry), carry, ctx, cond, mstate)

    @torch.inference_mode()
    def stream_step_fused(
        self,
        carry: M.ARCarry,
        ctx: ARLoopContext,
        cond: torch.Tensor,
        mstate: MimiStreamState,
        emitted: int,
        *,
        chunk: int,
        nar_ctx: int,
        top_p: float,
        temperature: float,
        anti_loop: bool,
        min_gen: int,
    ) -> Tuple[np.ndarray, int, bool, M.ARCarry, MimiStreamState]:
        """A K1 chunk, NAR over the window of original frames
        [emitted + cf - w, emitted + cf) (w = cf + nar_ctx; frames outside
        [0, S) are zeros and masked, as are frames at or past `valid`) with
        the last stage's heads on the chunk, and a Mimi stream step of the
        chunk's `cf` frames. Returns (wav [1, cf*hop], valid, done, carry,
        mstate); the caller ships the first valid - emitted frames."""
        cf, w = int(chunk), int(chunk) + int(nar_ctx)
        carry = M.ar_chunk(carry, cond, ctx, _settings(top_p, temperature, anti_loop, min_gen), cf)
        valid = torch.minimum(carry.first_eos, carry.t)
        s = carry.tokens.shape[1]
        lo, hi = int(emitted) + cf - w, int(emitted) + cf
        pad = (max(0, -lo), max(0, hi - s))  # zero frames before 0 and past S-1
        win = F.pad(cond[:, max(lo, 0): min(hi, s)], (0, 0) + pad)
        rvq = F.pad(carry.tokens[:, max(lo, 0): min(hi, s)], pad)
        orig = lo + torch.arange(w, device=self.device)
        mask = ((orig >= 0) & (orig < valid[0]))[None]
        toks = M.nar_refine(self.model, win, rvq, mask=mask, head_tail=cf)
        wav, mstate = mimi_decode_step(
            self.mimi.p, self.mimi_cfg, toks[:, w - cf:], mstate, packed=self.mimi.packed_decoder()
        )
        return (*self._chunk_out(wav, carry), carry, mstate)


def _settings(top_p: float, temperature: float, anti_loop: bool, min_gen: int) -> M.ARSettings:
    return M.ARSettings(
        top_p=top_p, temperature=temperature, min_gen_frames=int(min_gen),
        anti_loop=bool(anti_loop),
    )
