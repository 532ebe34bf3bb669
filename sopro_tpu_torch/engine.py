"""Execution engine (counterpart: sopro_tpu/engine.py): padding to the JAX
package's buckets and the device plans, each ending in one device->host
copy:

- the batch plan (`batch_synth_graph`): conditioning, AR decode, NAR refine
  over every frame (kernel K2) and the Mimi decode (kernel K3) for B rows,
  each row with its own seed and length. `synthesize_batch_dispatch` pads
  the rows to the longest row's text bucket and returns the packed
  [B, S*hop + 1] device tensor (lengths in the last column) without a
  sync; `synthesize_batch_read` copies it to the host. The fused
  synthesize plan is the batch plan at B = 1;
- the adaptive plan: `ar_generate_device`, then `nar_decode_fused` (NAR +
  Mimi decode over the generated length rounded up to `nar_pad_multiple`);
  the single stages `ar_generate`, `nar_refine`, `decode`, `token2sv`;
- the stream plan, one call per chunk of `cf` frames: `stream_start_fused`
  (conditioning, an AR chunk, NAR over the chunk, a Mimi stream step whose
  SEANet is kernel K4 over zero history) and `stream_step_fused` (an AR
  chunk, NAR over a window of `cf + nar_ctx` frames with the last stage's
  heads on the chunk only, a Mimi stream step). The state (ARCarry, the AR
  context, cond, MimiStreamState) stays on the device between calls; the
  host gets the chunk's samples with the valid frame count and the done
  flag packed behind them;
- `encode_audio`: Mimi encode of a reference waveform, padded to a ref
  bucket.

Every plan takes its AR implementation from `_ar_kv`, by the JAX package's
rule (`ar_route`): the whole-loop kernel K1 where `use_pallas_resident`
holds and its shared memory fits, else the per-step kernel K5 where
`use_pallas_ar` holds and B <= 2, else -- on the CPU only -- the plain
per-step loop; on CUDA that last case raises.

Text, reference and frame padding follow the JAX package exactly
(`pick_bucket`, `_pad_axis`, NAR and vocoder over all max_frames+1 frames
with a validity mask), so both packages compute on the same shapes. One
difference: the stream's NAR window always covers original frames
[emitted + cf - w, emitted + cf), zero-padded on both sides, where the JAX
package clamps the window's start and shifts the last chunk of a
max-length stream back by one frame.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.codec.mimi import MimiCodec, mimi_encode
from sopro_tpu_torch.codec.streaming import MimiStreamState, init_mimi_stream_state, mimi_decode_step
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig, pick_bucket
from sopro_tpu_torch.models import sopro as M
from sopro_tpu_torch.ops.ar_loop import SMEM_PER_BLOCK, ARLoopContext, smem_bytes
from sopro_tpu_torch.ops.ar_step import ARStepContext

ARContext = Union[ARLoopContext, ARStepContext]


def _pad_axis(x: np.ndarray, axis: int, to: int) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, to - x.shape[axis])
    return np.pad(x, pad)


def _pcm16(wav: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> int16 on the device, rounded as the JAX package does."""
    return torch.round(torch.clamp(wav.float(), -1.0, 1.0) * 32767.0).to(torch.int16)


def ar_route(device_type: str, *, b: int, resident: bool, eligible: bool, use_step: bool) -> str:
    """The AR implementation of a call, by the JAX package's rule
    (`Engine._ar_kv`): "ar_loop" (K1) for a call site that allows the whole
    loop (`resident`) when `eligible` (`Engine.resident_eligible`: the knob
    and K1's shared memory); else "ar_step" (a loop of K5 steps) when
    `use_step` and b <= 2; else "plain", the plain per-step loop, which
    only a CPU device runs: a CUDA device raises ValueError instead."""
    if resident and eligible:
        return "ar_loop"
    if use_step and b <= 2:
        return "ar_step"
    if device_type == "cuda":
        raise ValueError(
            f"no AR kernel for this call (B={b}): K1 needs use_pallas_resident and a call "
            "that allows it, K5 needs use_pallas_ar and B <= 2; set "
            "RuntimeConfig(use_pallas_resident=...) or RuntimeConfig(use_pallas_ar=...)"
        )
    return "plain"


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
        cuda = self.device.type == "cuda"
        if cuda:
            configure_cuda_numerics()
        knob = lambda v: cuda if v is None else bool(v)  # None: on for a CUDA device
        self.use_pallas_ar = knob(self.rt.use_pallas_ar)
        self.use_pallas_resident = knob(self.rt.use_pallas_resident)

    def _padded(self, rows: Sequence[np.ndarray], buckets) -> Tuple[torch.Tensor, torch.Tensor]:
        """B rows of [T_i, ...] ints -> ([B, Tb, ...] int32, mask [B, Tb]) on
        the device; Tb is the longest row's bucket."""
        tb = pick_bucket(max(int(r.shape[0]) for r in rows), buckets)
        ids = np.stack([_pad_axis(np.asarray(r, np.int32), 0, tb) for r in rows])
        mask = np.arange(tb)[None, :] < np.array([int(r.shape[0]) for r in rows])[:, None]
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def resident_eligible(self, b: int, l: int, max_steps: int = 401) -> bool:
        """True when an AR decode at batch `b`, text bucket `l` and
        `max_steps` steps may run the whole-loop kernel K1: the knob is on
        and K1's shared memory at text length `l` fits the 227 KB a Hopper
        block can have (`ops/ar_loop.py::smem_bytes`, the host mirror of
        `smem_floats` and the cluster loop in csrc/ar_loop.cu). This is K1's
        own limit, not the TPU's VMEM budget of the JAX package: B and the
        step count do not bound it (one cluster per row, the steps loop
        inside the kernel)."""
        smem = smem_bytes(self.cfg, l)
        return self.use_pallas_resident and smem is not None and smem <= SMEM_PER_BLOCK

    def _ar_kv(
        self, txt_seq: torch.Tensor, text_mask: torch.Tensor, resident: bool = True,
        max_steps: int = 401,
    ) -> ARContext:
        """The AR context of a call, as `ar_route` picks it: an
        ARLoopContext (K1, or the plain loop on the CPU) or an ARStepContext
        (K5 steps)."""
        b, l = int(txt_seq.shape[0]), int(txt_seq.shape[1])
        route = ar_route(
            self.device.type, b=b, resident=resident,
            eligible=self.resident_eligible(b, l, max_steps), use_step=self.use_pallas_ar,
        )
        if route == "ar_step":
            return M.ar_step_context(self.model, txt_seq, text_mask)
        return M.ar_context(self.model, txt_seq, text_mask)

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
        toks, mask = self._padded([ref_tokens_tq], self.rt.ref_buckets)
        return M.prepare_reference(self.model, toks, mask=mask)

    @torch.inference_mode()
    def token2sv(self, ref_tokens_tq: np.ndarray) -> np.ndarray:
        """[T, Q] tokens -> speaker embedding [sv_dim] (padded to a ref
        bucket, masked)."""
        toks, mask = self._padded([ref_tokens_tq], self.rt.ref_buckets)
        return self.model.token2sv(toks, mask=mask)[0].cpu().numpy()

    @torch.inference_mode()
    def prepare_conditioning(
        self, text_ids: np.ndarray, ref: M.PreparedReference, *,
        max_frames: int, style_strength: float,
    ) -> Dict[str, torch.Tensor]:
        ids, mask = self._padded([text_ids], self.rt.text_buckets)
        return M.prepare_conditioning(
            self.model, ids, mask, ref, max_frames=max_frames, style_strength=style_strength
        )

    # -- the adaptive plan and its single stages ----------------------------

    @torch.inference_mode()
    def ar_generate_device(
        self, prep: Dict[str, torch.Tensor], *, max_frames: int, seed: int, top_p: float,
        temperature: float, anti_loop: bool, min_gen_frames: Optional[int] = None,
    ) -> Tuple[torch.Tensor, int]:
        """AR decode of one row; the tokens [1, max_frames+1] stay on the
        device, the generated length (EOS excluded) comes to the host."""
        s = int(max_frames) + 1
        min_gen = int(min_gen_frames or self.cfg.min_gen_frames)
        ctx = self._ar_kv(prep["txt_seq"], prep["text_mask"], True, s)
        carry = M.ar_generate(
            self.model, prep["cond_ar"], prep["txt_seq"], prep["text_mask"], int(seed),
            _settings(top_p, temperature, anti_loop, min_gen), s, ctx=ctx,
        )
        first_eos, t = torch.stack([carry.first_eos[0], carry.t[0]]).tolist()  # one copy
        return carry.tokens, min(first_eos, t)

    def ar_generate(self, prep: Dict[str, torch.Tensor], **kwargs) -> Tuple[np.ndarray, int]:
        """`ar_generate_device`, then the tokens [T] on the host."""
        tokens, cut = self.ar_generate_device(prep, **kwargs)
        return tokens[0, :cut].cpu().numpy(), cut

    def _frame_bucket(self, t: int) -> int:
        m = int(self.rt.nar_pad_multiple)
        return max(m, ((t + m - 1) // m) * m)

    @torch.inference_mode()
    def nar_decode_fused(
        self, cond_ar: torch.Tensor, tokens_dev: torch.Tensor, t: int, pcm16: bool = False
    ) -> np.ndarray:
        """NAR refine + Mimi decode over min(frame bucket of t, S) frames,
        one device->host copy -> wav [1, t*hop] (float32, or int16)."""
        tb = min(self._frame_bucket(t), int(cond_ar.shape[1]))
        mask = torch.arange(tb, device=cond_ar.device)[None, :] < int(t)
        toks = M.nar_refine(self.model, cond_ar[:, :tb], tokens_dev[:, :tb], mask=mask)
        wav = self.mimi(toks)
        wav = (_pcm16(wav) if pcm16 else wav).cpu().numpy()
        return wav[:, : t * int(self.mimi_cfg.hop_length)]

    @torch.inference_mode()
    def nar_refine(self, cond_ar: torch.Tensor, rvq1: np.ndarray, t: int) -> np.ndarray:
        """cond [1, S, D] (S >= t), rvq1 [t] -> tokens [t, Q]."""
        tb = min(self._frame_bucket(t), int(cond_ar.shape[1]))
        rvq = torch.from_numpy(_pad_axis(np.asarray(rvq1, np.int32), 0, tb)[None]).to(self.device)
        mask = torch.arange(tb, device=self.device)[None, :] < int(t)
        return M.nar_refine(self.model, cond_ar[:, :tb], rvq, mask=mask)[0, :t].cpu().numpy()

    @torch.inference_mode()
    def decode(self, tokens_tq: np.ndarray) -> np.ndarray:
        """[T, Q] -> wav [1, T*hop], over the frame bucket of T."""
        t = int(tokens_tq.shape[0])
        toks = _pad_axis(np.asarray(tokens_tq, np.int32), 0, self._frame_bucket(t))[None]
        wav = self.mimi(torch.from_numpy(toks).to(self.device))
        return wav[:, : t * int(self.mimi_cfg.hop_length)].cpu().numpy()

    # -- the batch plan (the fused plan is its B = 1 case) -------------------

    def batch_synth_graph(
        self, ids: torch.Tensor, mask: torch.Tensor, ref: M.PreparedReference, strength: float,
        keys: torch.Tensor, settings: M.ARSettings, *, max_frames: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Conditioning + per-row AR decode (row keys [B, 2]) + NAR over all
        max_frames+1 frames + Mimi decode, on the device. Returns
        (wav [B, s*hop], lengths [B])."""
        s = int(max_frames) + 1
        prep = M.prepare_conditioning(
            self.model, ids, mask, ref, max_frames=max_frames, style_strength=strength
        )
        ctx = self._ar_kv(prep["txt_seq"], mask, True, s)
        carry = replace(M.init_ar_carry(self.cfg, ids.shape[0], s, 0, self.device), key=keys)
        carry = M.ar_chunk(carry, prep["cond_ar"], ctx, settings, s)
        lengths = torch.minimum(carry.first_eos, carry.t)
        frame_mask = torch.arange(s, device=self.device)[None, :] < lengths[:, None]
        toks = M.nar_refine(self.model, prep["cond_ar"], carry.tokens, mask=frame_mask)
        return self.mimi(toks), lengths

    def _row_keys(self, seeds: Sequence[int]) -> torch.Tensor:
        """[B, 2]: row i's key is what init_ar_carry(batch=1) gives seed i."""
        return torch.cat([S.split_rows(S.prng_key(int(sd), self.device), 1) for sd in seeds])

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
    ) -> Tuple[np.ndarray, int]:
        """Whole pipeline for one row with one device->host copy.
        Returns (wav [1, t*hop] float32, t)."""
        ids, mask = self._padded([ids_row], self.rt.text_buckets)
        wav, t = self.batch_synth_graph(
            ids, mask, ref, float(style_strength), self._row_keys([seed]),
            _settings(top_p, temperature, anti_loop, min_gen), max_frames=max_frames,
        )
        flat = torch.cat([wav[0], t.float()]).cpu().numpy()
        t = int(flat[-1])
        return flat[:-1][None, : t * int(self.mimi_cfg.hop_length)], t

    @torch.inference_mode()
    def synthesize_batch_dispatch(
        self,
        ids_rows: Sequence[np.ndarray],
        ref_batched: M.PreparedReference,
        *,
        max_frames: int,
        style_strength: float,
        seeds: Sequence[int],
        top_p: float,
        temperature: float,
        anti_loop: bool,
        min_gen: int,
        pcm16: bool = False,
    ) -> torch.Tensor:
        """The batch plan for B rows padded to the longest row's text
        bucket, one mask row each; returns the packed [B, S*hop + 1] device
        tensor (float32, or int16 with `pcm16`) with each row's length in
        the last column, without a sync."""
        ids, mask = self._padded(ids_rows, self.rt.text_buckets)
        wav, lengths = self.batch_synth_graph(
            ids, mask, ref_batched, float(style_strength), self._row_keys(seeds),
            _settings(top_p, temperature, anti_loop, min_gen), max_frames=max_frames,
        )
        if pcm16:
            wav = _pcm16(wav)
        return torch.cat([wav, lengths[:, None].to(wav.dtype)], dim=1)

    def synthesize_batch_read(self, packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """The one device->host copy of a dispatched batch -> (wav [B, S*hop]
        float32 or int16, lengths [B] int64)."""
        flat = packed.cpu().numpy()
        return flat[:, :-1], flat[:, -1].astype(np.int64)

    def synthesize_batch_fused(self, ids_rows, ref_batched, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """`synthesize_batch_dispatch` + `synthesize_batch_read`."""
        return self.synthesize_batch_read(
            self.synthesize_batch_dispatch(ids_rows, ref_batched, **kwargs)
        )

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
    ) -> Tuple[np.ndarray, int, bool, M.ARCarry, ARContext, torch.Tensor, MimiStreamState]:
        """The first chunk: conditioning, the AR context (`_ar_kv`), an AR
        chunk of `chunk` steps, NAR over those frames, and a Mimi stream step
        from zero history. Returns (wav [1, chunk*hop], valid, done, carry,
        ctx, cond, mstate); the caller ships wav[:, :valid*hop]."""
        cf, s = int(chunk), int(max_frames) + 1
        if not 0 < cf <= s:
            raise ValueError(f"chunk={chunk} must be in [1, max_frames+1={s}]")
        ids, mask = self._padded([ids_row], self.rt.text_buckets)
        prep = M.prepare_conditioning(
            self.model, ids, mask, ref, max_frames=max_frames, style_strength=style_strength
        )
        cond = prep["cond_ar"]
        ctx = self._ar_kv(prep["txt_seq"], mask, True, s)
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
        ctx: ARContext,
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
        """An AR chunk, NAR over the window of original frames
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
