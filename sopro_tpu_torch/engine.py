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
- the serving plan (`ContinuousBatcher`, serve/scheduler.py): a
  `ServeState` of B slots on the device, each a session at its own age with
  its own settings and seed; `serve_join` conditions a group of sessions
  and scatters them into free slots, `serve_tick` advances every slot by one
  chunk: an AR chunk for all B rows (K1), NAR per row over a window of
  original frames (K2 on the last `cf`), a Mimi stream step masked to the
  rows that emit (K4), packed into one device tensor for one copy;
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
max-length stream back by one frame (the serving tick likewise).

An engine built without a codec (`SoproTTS.from_random(with_codec=False)`)
runs conditioning, AR decode and NAR refine; its codec calls raise.

The compute dtype (`RuntimeConfig.compute_dtype`, the JAX package's
policy): under "bfloat16" the engine casts every floating parameter of the
model and the codec to bfloat16 when it is built (into copies, so the
caller's model and codec keep their dtype; the small ones too: gates,
mixes, codebook weights), and `self.dtype` is bfloat16: the AR
ring buffers, the conditioning, the Mimi stream state and the serving
state are kept in it, every kernel runs its bfloat16 instantiation, and the
float32 islands are the modules' own (norms, softmaxes, the sampler). The
waveform leaves the device as float32 (exact from bfloat16; the packed
lengths stay exact), int16 PCM when asked for.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from sopro_tpu_torch import kernels
from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.codec.mimi import MimiCodec, mimi_encode
from sopro_tpu_torch.codec.streaming import (
    MimiStreamState, init_mimi_stream_state, mimi_decode_step, reset_stream_rows,
)
from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig, pick_bucket
from sopro_tpu_torch.models import generator as G
from sopro_tpu_torch.models import sopro as M
from sopro_tpu_torch.ops.ar_loop import DEFAULT_BLOCKS, SMEM_PER_BLOCK, ARLoopContext, smem_bytes
from sopro_tpu_torch.ops.ar_step import ARStepContext
from sopro_tpu_torch.profiling import span

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
    the port's fp32 tolerances. The bfloat16 products left to `torch.matmul`
    accumulate in float32, as XLA's do (no reduced-precision reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class Engine:
    def __init__(
        self,
        model: M.SoproModel,
        mimi: Optional[MimiCodec],
        runtime: Optional[RuntimeConfig] = None,
    ):
        self.rt = runtime or RuntimeConfig()
        self.dtype = torch.bfloat16 if self.rt.compute_dtype == "bfloat16" else torch.float32
        if self.dtype != torch.float32:
            # every floating leaf, cast into a copy as the JAX engine casts into new
            # arrays: the caller's model and codec keep their dtype; the kernel caches rebuild
            model = copy.deepcopy(model).to(self.dtype)
            mimi = None if mimi is None else copy.deepcopy(mimi).to(self.dtype)
        self.model = model
        self.cfg: SoproTTSConfig = model.cfg
        self.mimi = mimi
        self.mimi_cfg = mimi.cfg if mimi is not None else None
        self.device = model.device()
        cuda = self.device.type == "cuda"
        if cuda:
            configure_cuda_numerics()
            if self.rt.use_pallas_vocoder is False:
                raise ValueError(
                    "RuntimeConfig(use_pallas_vocoder=False): the SEANet kernels K3/K4 are the "
                    "port's only SEANet route on a CUDA device"
                )
        knob = lambda v: cuda if v is None else bool(v)  # None: on for a CUDA device
        self.use_pallas_ar = knob(self.rt.use_pallas_ar)
        self.use_pallas_resident = knob(self.rt.use_pallas_resident)
        self._replicas: Dict[torch.device, "Engine"] = {}

    def replica(self, device) -> "Engine":
        """This engine on `device`, for a mesh's dp shard: the engine itself
        on its own device, else an Engine over copies of its model and codec
        moved there, built once per device (its kernel packs build on that
        card) from the weights as they are then, with the same runtime and
        compute dtype."""
        dev = torch.device(device)
        if dev == self.device:
            return self
        if dev not in self._replicas:
            model = copy.deepcopy(self.model).to(dev)
            mimi = None if self.mimi is None else copy.deepcopy(self.mimi).to(dev)
            self._replicas[dev] = Engine(model, mimi, self.rt)
        return self._replicas[dev]

    @property
    def codec(self) -> MimiCodec:
        """The Mimi codec; raises for an engine built without one."""
        if self.mimi is None:
            raise RuntimeError(
                "this engine has no Mimi codec (built with with_codec=False): "
                "decoding and reference audio need the codec"
            )
        return self.mimi

    def _padded(self, rows: Sequence[np.ndarray], buckets,
                min_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """B rows of [T_i, ...] ints -> ([B, Tb, ...] int32, mask [B, Tb]) on
        the device; Tb is the bucket of the longest row (or of `min_len`)."""
        tb = pick_bucket(max([int(min_len)] + [int(r.shape[0]) for r in rows]), buckets)
        ids = np.stack([_pad_axis(np.asarray(r, np.int32), 0, tb) for r in rows])
        mask = np.arange(tb)[None, :] < np.array([int(r.shape[0]) for r in rows])[:, None]
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def resident_eligible(self, b: int, l: int, max_steps: int = 401) -> bool:
        """True when an AR decode at batch `b`, text bucket `l` and
        `max_steps` steps may run the whole-loop kernel K1: the knob is on
        and K1's shared memory at text length `l` and `b` rows fits the 227
        KB a Hopper block can have (`ops/ar_loop.py::smem_bytes`, the host
        mirror of `plan` and `carve` in csrc/ar_loop.cu, over one block per
        SM of this device). This is K1's own limit, not the TPU's VMEM budget
        of the JAX package: the step count does not bound it (the steps loop
        inside the kernel), and rows past 32 go through each step in
        groups."""
        blocks = (torch.cuda.get_device_properties(self.device).multi_processor_count
                  if self.device.type == "cuda" else DEFAULT_BLOCKS)
        smem = smem_bytes(self.cfg, l, self.dtype, b, blocks)
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
        codec = self.codec
        hop = int(codec.cfg.hop_length)
        s = int(wav.shape[-1])
        t = -(-s // hop)
        tb = pick_bucket(t, self.rt.ref_buckets)
        wav_p = _pad_axis(np.asarray(wav, np.float32), -1, tb * hop)
        codes = mimi_encode(codec.p, codec.cfg, torch.from_numpy(wav_p)[None].to(self.device))
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
        return self.model.token2sv(toks, mask=mask)[0].float().cpu().numpy()

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
        wav = self.codec(toks)
        wav = (_pcm16(wav) if pcm16 else wav.float()).cpu().numpy()
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
        wav = self.codec(torch.from_numpy(toks).to(self.device))
        return wav[:, : t * int(self.mimi_cfg.hop_length)].float().cpu().numpy()

    # -- the batch plan (the fused plan is its B = 1 case) -------------------

    def batch_synth_graph(
        self, ids: torch.Tensor, mask: torch.Tensor, ref: M.PreparedReference, strength: float,
        keys: torch.Tensor, settings: M.ARSettings, *, max_frames: int,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Conditioning + per-row AR decode (row keys [B, 2]) + NAR over all
        max_frames+1 frames + Mimi decode, on the device. Returns
        (wav [B, s*hop], lengths [B])."""
        s = int(max_frames) + 1
        with span("sopro.condition"):
            prep = M.prepare_conditioning(
                self.model, ids, mask, ref, max_frames=max_frames, style_strength=strength
            )
            ctx = self._ar_kv(prep["txt_seq"], mask, True, s)
            carry = replace(M.init_ar_carry(self.cfg, ids.shape[0], s, 0, self.device, self.dtype),
                            key=keys)
        with span("sopro.ar"):
            carry = M.ar_chunk(carry, prep["cond_ar"], ctx, settings, s)
        with span("sopro.nar"):
            lengths = torch.minimum(carry.first_eos, carry.t)
            frame_mask = torch.arange(s, device=self.device)[None, :] < lengths[:, None]
            toks = M.nar_refine(self.model, prep["cond_ar"], carry.tokens, mask=frame_mask)
        with span("sopro.mimi"):
            wav = self.codec(toks)
        return wav, lengths

    def _row_keys(self, seeds: Sequence[int]) -> torch.Tensor:
        """[B, 2]: row i's key is what init_ar_carry(batch=1) gives seed i,
        `split(PRNGKey(seed), 1)[0]`, the Threefry block at counters (0, 0)
        under key (0, seed); drawn for all rows at once on the host."""
        seeds = torch.tensor([int(sd) for sd in seeds], dtype=torch.int64)
        a, b = S.threefry2x32(torch.zeros_like(seeds), seeds, 0, 0)
        return torch.stack([a, b], dim=-1).to(self.device)

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
        with span("sopro.prepare"):
            ids, mask = self._padded([ids_row], self.rt.text_buckets)
            keys = self._row_keys([seed])
            settings = _settings(top_p, temperature, anti_loop, min_gen)
        wav, t = self.batch_synth_graph(
            ids, mask, ref, float(style_strength), keys, settings, max_frames=max_frames,
        )
        with span("sopro.readback"):
            flat = torch.cat([wav[0].float(), t.float()]).cpu().numpy()
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
        text_len: int = 0,
    ) -> torch.Tensor:
        """The batch plan for B rows padded to the text bucket of the longest
        row (or of `text_len` tokens: a mesh's shards pad to their group's
        bucket), one mask row each; returns the packed [B, S*hop + 1] device
        tensor (float32, or int16 with `pcm16`) with each row's length in
        the last column, without a sync."""
        with span("sopro.prepare"):
            ids, mask = self._padded(ids_rows, self.rt.text_buckets, text_len)
            keys = self._row_keys(seeds)
            settings = _settings(top_p, temperature, anti_loop, min_gen)
        wav, lengths = self.batch_synth_graph(
            ids, mask, ref_batched, float(style_strength), keys, settings, max_frames=max_frames,
        )
        wav = _pcm16(wav) if pcm16 else wav.float()
        return torch.cat([wav, lengths[:, None].to(wav.dtype)], dim=1)

    def synthesize_batch_read(self, packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """The one device->host copy of a dispatched batch -> (wav [B, S*hop]
        float32 or int16, lengths [B] int64)."""
        with span("sopro.readback"):
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
        flat = torch.cat([wav[0].float(), valid, done]).cpu().numpy()
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
        carry = M.init_ar_carry(self.cfg, 1, s, int(seed), self.device, self.dtype)
        carry = M.ar_chunk(carry, cond, ctx, _settings(top_p, temperature, anti_loop, min_gen), cf)
        valid = torch.minimum(carry.first_eos, carry.t)
        frame_mask = torch.arange(cf, device=self.device)[None, :] < valid[:, None]
        toks = M.nar_refine(self.model, cond[:, :cf], carry.tokens[:, :cf], mask=frame_mask)
        codec = self.codec
        wav, mstate = mimi_decode_step(
            codec.p, codec.cfg, toks, init_mimi_stream_state(codec.cfg, 1, self.device, self.dtype),
            packed=codec.packed_decoder(),
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
        codec = self.codec
        wav, mstate = mimi_decode_step(
            codec.p, codec.cfg, toks[:, w - cf:], mstate, packed=codec.packed_decoder()
        )
        return (*self._chunk_out(wav, carry), carry, mstate)

    # -- warmup ----------------------------------------------------------------

    def warmup(self, *, text_len: int = 64, max_frames: int = 400, chunk: int = 6) -> None:
        """Pay the first-call costs before the first request (counterpart:
        the JAX engine's `warmup`): on a CUDA device the kernels' builds and
        library loads, then the weight packs (K1's weight stream, K2's head
        stacks, K3/K4's decoder pack) and one run of each production path at
        its buckets: a 12 s reference (its ref bucket), a text of `text_len`
        tokens, `synthesize`'s fused plan in float32 and the batch plan's
        pcm16 output, a stream's first chunk and one later chunk. A
        `synthesize` or `stream` call at these buckets then builds
        nothing. `text_len` and `max_frames` are capped at what the
        config's position tables hold (`max_text_len`, `pos_emb_max` + 7)."""
        if self.device.type == "cuda":
            kernels.build(kernels.SOPRO_SOURCES)
        ref = self.prepare_reference(
            np.zeros((int(12.0 * self.cfg.mimi_fps), int(self.cfg.num_codebooks)), np.int32))
        ids = np.ones((min(int(text_len), int(self.cfg.max_text_len)),), np.int32)
        n = min(int(max_frames), int(self.cfg.pos_emb_max) + 7)
        kw = dict(top_p=0.9, temperature=1.0, anti_loop=True, min_gen=1)
        self.synthesize_fused(ids, ref, max_frames=n, style_strength=1.0, seed=0, **kw)
        self.synthesize_batch_read(self.synthesize_batch_dispatch(
            [ids], ref, max_frames=n, style_strength=1.0, seeds=[0], pcm16=True, **kw))
        _, valid, _, carry, ctx, cond, mstate = self.stream_start_fused(
            ids, ref, max_frames=n, chunk=chunk, style_strength=1.0, seed=0, **kw)
        self.stream_step_fused(carry, ctx, cond, mstate, int(valid), chunk=chunk,
                               nar_ctx=int(self.cfg.rf_nar()), **kw)

    # -- the serving plan: B slots, each a session at its own age -----------

    @torch.inference_mode()
    def serve_state(self, slots: int, text_bucket: int, max_frames: int) -> "ServeState":
        """Every slot free: stopped rows (frozen by the per-row masks), zero
        conditioning and text KV (every key valid, so no row attends to an
        empty context), default settings, a fresh Mimi stream state."""
        cfg, dev = self.cfg, self.device
        b, s, l, d = int(slots), int(max_frames) + 1, int(text_bucket), int(cfg.d_model)
        a = sum(xp is not None for xp in self.model.ar.p["xattn"])
        carry = M.init_ar_carry(cfg, b, s, 0, dev, self.dtype)
        carry.stopped.fill_(1)
        kv = lambda: torch.zeros((a, b, G.TEXT_HEADS, l, d // G.TEXT_HEADS), dtype=self.dtype,
                                 device=dev)
        f32 = lambda v: torch.full((b,), v, dtype=torch.float32, device=dev)
        i32 = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
        st = ServeState(
            carry=carry, cond=torch.zeros((b, s, d), dtype=self.dtype, device=dev), kv_k=kv(),
            kv_v=kv(),
            text_mask=torch.ones((b, l), dtype=torch.bool, device=dev),
            rows={"top_p": f32(0.9), "temperature": f32(1.05), "recovery_top_p": f32(0.85),
                  "recovery_temp": f32(1.2), "min_gen": i32(cfg.min_gen_frames),
                  "max_frames": i32(int(max_frames))},
            mstate=init_mimi_stream_state(self.codec.cfg, b, dev, self.dtype),
            emitted=torch.zeros((b,), dtype=torch.int32, device=dev), ctx=None,
        )
        route = ar_route(dev.type, b=b, resident=True, eligible=self.resident_eligible(b, l),
                         use_step=self.use_pallas_ar)
        st.ctx = M.ar_context_from_kv(self.model, st.kv_k, st.kv_v, st.text_mask,
                                      step=route == "ar_step")
        return st

    @torch.inference_mode()
    def serve_join(
        self, st: "ServeState", slots: Sequence[int], ids: np.ndarray, mask: np.ndarray,
        ref: M.PreparedReference, strength: Sequence[float], seeds: Sequence[int],
        settings: Dict[str, Sequence],
    ) -> None:
        """Admit a group of G sessions into free `slots`, in place.

        Conditioning runs batched, for the rows of each text bucket together:
        ids / mask [G, L] (L the state's text bucket) are cut to the row's own
        bucket (`pick_bucket` of its length, as the stream pads it), over
        `ref` (batch G) with a style strength per row; the text KV is built
        there and zero-padded to L (K1 reads masked keys as exact zeros, so a
        session decodes as it would alone). Then the scatter into the slots:
        conditioning, text KV and mask, a fresh AR carry row with the row's
        key (`_row_keys`), the row's settings (`settings`: name -> G values,
        names of `ServeState.rows`), a fresh Mimi stream row
        (`reset_stream_rows`) and emitted = 0."""
        dev, l_state = self.device, st.text_mask.shape[1]
        mask = np.asarray(mask, bool)
        buckets = [min(pick_bucket(int(n), self.rt.text_buckets), l_state) for n in mask.sum(1)]
        for lb in sorted(set(buckets)):
            rows = [i for i, x in enumerate(buckets) if x == lb]
            part = torch.tensor(rows, dtype=torch.long)
            sub = lambda x: x[part.to(x.device)].to(dev) if isinstance(x, torch.Tensor) else x
            ref_part = M.PreparedReference(
                sv_ref=sub(ref.sv_ref), ref_seq=sub(ref.ref_seq),
                ref_kv=tuple({k: sub(v) for k, v in kv.items()} for kv in ref.ref_kv),
            )
            ids_t = torch.from_numpy(np.asarray(ids, np.int32)[rows, :lb]).to(dev)
            mask_t = torch.from_numpy(mask[rows, :lb]).to(dev)
            prep = M.prepare_conditioning(
                self.model, ids_t, mask_t, ref_part, max_frames=st.cond.shape[1] - 1,
                style_strength=torch.tensor([strength[i] for i in rows], dtype=torch.float32,
                                            device=dev),
            )
            kv = [c for c in G.build_text_kv_caches(self.model.ar.p, self.cfg, prep["txt_seq"],
                                                    mask_t) if c is not None]
            pad = lambda x: F.pad(x, (0, 0, 0, l_state - lb))  # [A, g, H, lb, hd] -> L keys
            idx = torch.tensor([slots[i] for i in rows], dtype=torch.long, device=dev)
            st.cond[idx] = prep["cond_ar"]
            st.kv_k[:, idx] = pad(torch.stack([c["k"] for c in kv]))
            st.kv_v[:, idx] = pad(torch.stack([c["v"] for c in kv]))
            st.text_mask[idx] = F.pad(mask_t, (0, l_state - lb))
        idx = torch.tensor(list(slots), dtype=torch.long, device=dev)
        c = st.carry
        for leaf, fill in ((c.t, 0), (c.streak, 0), (c.last, 0), (c.tokens, 0), (c.stopped, 0),
                           (c.first_eos, c.tokens.shape[1]), (c.hist, -1), (st.emitted, 0)):
            leaf[idx] = fill
        c.bufs[:, idx] = 0
        c.key[idx] = self._row_keys(seeds)
        for name, vals in settings.items():
            st.rows[name][idx] = torch.tensor(list(vals), dtype=st.rows[name].dtype, device=dev)
        joined = torch.zeros(st.emitted.shape, dtype=torch.bool, device=dev)
        joined[idx] = True
        st.mstate = reset_stream_rows(st.mstate, joined)

    @torch.inference_mode()
    def serve_stop(self, st: "ServeState", slots: Sequence[int]) -> None:
        """Stop rows (a cancelled session): they decode no further."""
        st.carry.stopped[torch.tensor(list(slots), dtype=torch.long, device=self.device)] = 1

    @torch.inference_mode()
    def serve_tick(
        self, st: "ServeState", *, chunk: int, nar_ctx: int, first_only: bool = False,
        pcm16: bool = False,
    ) -> torch.Tensor:
        """Advance every slot by one chunk of `chunk` frames, in place, and
        return the packed [wav [B, chunk*hop] | t, first_eos, stopped, n_new
        [4, B]] device tensor (float32, or int16 with `pcm16`).

        - AR: one `ar_chunk` for all B rows with the per-row settings,
          anti-loop on (a row with it off carries recovery = normal
          settings); a row is stopped at its own max_frames + 1.
        - NAR per row over original frames [emitted + chunk - w, emitted +
          chunk), w = chunk + nar_ctx, sliced per row and zero-padded on both
          sides (frames outside [0, S) or at or past the row's valid length
          are masked), with the last stage's heads on the last `chunk`.
        - A Mimi stream step of those `chunk` frames, masked to the rows with
          n_new > 0 (the others keep their stream state; their output rows
          are not shipped).

        n_new = min(valid - emitted, chunk) per row; `first_only` (a ramp
        tick) keeps it 0 for rows that already emitted, so every row keeps
        its own chunk grid whatever ticks ran while it lived."""
        cf, ctx_frames = int(chunk), int(nar_ctx)
        w = cf + ctx_frames
        rows = st.rows
        settings = M.ARSettings(
            top_p=rows["top_p"], temperature=rows["temperature"],
            recovery_top_p=rows["recovery_top_p"], recovery_temp=rows["recovery_temp"],
            min_gen_frames=rows["min_gen"], anti_loop=True,
        )
        carry = M.ar_chunk(st.carry, st.cond, st.ctx, settings, cf)
        cap = rows["max_frames"] + 1
        carry = replace(carry, stopped=torch.where(carry.t >= cap, torch.ones_like(carry.stopped),
                                                   carry.stopped))
        valid = torch.minimum(torch.minimum(carry.first_eos, carry.t), cap)
        n_new = torch.clamp(torch.minimum(valid - st.emitted, torch.full_like(valid, cf)), min=0)
        if first_only:
            n_new = torch.where(st.emitted == 0, n_new, torch.zeros_like(n_new))
        win, rvq, mask = serve_window(st.cond, carry.tokens, st.emitted, valid, cf, ctx_frames)
        toks = M.nar_refine(self.model, win, rvq, mask=mask, head_tail=cf)
        codec = self.codec
        wav, st.mstate = mimi_decode_step(
            codec.p, codec.cfg, toks[:, w - cf:], st.mstate, mask=n_new > 0,
            packed=codec.packed_decoder(),
        )
        st.carry, st.emitted = carry, st.emitted + n_new
        info = torch.stack([carry.t, carry.first_eos, carry.stopped, n_new])
        if pcm16:
            return torch.cat([_pcm16(wav).reshape(-1), info.to(torch.int16).reshape(-1)])
        return torch.cat([wav.float().reshape(-1), info.float().reshape(-1)])


@dataclass
class ServeState:
    """The serving plan's device state (`Engine.serve_state`): B slots, each
    a session at its own age; a free slot is a stopped row."""

    carry: M.ARCarry  # [B] rows, tokens [B, S]
    cond: torch.Tensor  # [B, S, D]
    kv_k: torch.Tensor  # [A, B, H, L, hd]: the text KV in the layout K1 reads
    kv_v: torch.Tensor
    text_mask: torch.Tensor  # [B, L] bool
    rows: Dict[str, torch.Tensor]  # [B] each: top_p, temperature, recovery_top_p, recovery_temp, min_gen, max_frames
    mstate: MimiStreamState
    emitted: torch.Tensor  # [B] int32: frames shipped per row
    ctx: Optional[ARContext]  # the AR context over kv_k / kv_v / text_mask (views)


def serve_window(
    cond: torch.Tensor, tokens: torch.Tensor, emitted: torch.Tensor, valid: torch.Tensor,
    cf: int, nar_ctx: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The serve tick's NAR input: per row the original frames [emitted + cf
    - w, emitted + cf), w = cf + nar_ctx, of cond [B, S, D] and tokens [B,
    S], gathered across rows with zeros outside [0, S) -> (win [B, w, D],
    rvq [B, w], mask [B, w]: in [0, valid))."""
    b, w = tokens.shape[0], int(cf) + int(nar_ctx)
    lo = emitted - int(nar_ctx)  # = emitted + cf - w, per row
    orig = lo[:, None] + torch.arange(w, device=cond.device)[None]  # [B, w]
    pos = (orig + w).long()  # into arrays padded with w frames before 0 and cf after S-1
    win = F.pad(cond, (0, 0, w, int(cf)))[torch.arange(b, device=cond.device)[:, None], pos]
    rvq = torch.gather(F.pad(tokens, (w, int(cf))), 1, pos)
    return win, rvq, (orig >= 0) & (orig < valid[:, None])


def _settings(top_p: float, temperature: float, anti_loop: bool, min_gen: int) -> M.ARSettings:
    return M.ARSettings(
        top_p=top_p, temperature=temperature, min_gen_frames=int(min_gen),
        anti_loop=bool(anti_loop),
    )
