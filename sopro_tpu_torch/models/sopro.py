"""Sopro model graph (counterpart: sopro_tpu/models/sopro.py): reference
conditioning, the AR decode loop and NAR refinement.

`SoproModel` holds the parameter tree of the JAX package's
`init_sopro_model` as submodules (text encoder, Token2SV, speaker FiLM, AR
generator, NAR refiner) plus the shared tables. The functions below take the
model and mirror the JAX functions of the same names.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models import generator as G
from sopro_tpu_torch.models import nar as N
from sopro_tpu_torch.models.base import ParamModule
from sopro_tpu_torch.models.speaker import SpeakerFiLM, Token2SV
from sopro_tpu_torch.models.text import TextEncoder
from sopro_tpu_torch.ops.ar_loop import STATE_KEYS, ARLoopContext, ar_loop, ar_loop_step
from sopro_tpu_torch.ops.ar_step import ARStepContext
from sopro_tpu_torch.ops.attention import build_kv_cache, ref_xattn
from sopro_tpu_torch.ops.blocks import rmsnorm, ssmlite
from sopro_tpu_torch.ops.embeddings import (
    CodebookEmbeddingSpec,
    cb_sum_embed_subset,
    sinusoidal_table,
)

_SUBMODULES = ("text_enc", "token2sv", "spk_film", "ar", "nar")


class SoproModel(nn.Module):
    def __init__(self, tree: Dict, cfg: SoproTTSConfig):
        super().__init__()
        self.cfg = cfg
        self.text_enc = TextEncoder(tree["text_enc"], cfg)
        self.token2sv = Token2SV(tree["token2sv"], cfg.codebook_size)
        self.spk_film = SpeakerFiLM(tree["spk_film"])
        self.ar = G.ARGenerator(tree["ar"], cfg)
        self.nar = N.NARRefiner(tree["nar"], cfg)
        self.shared = ParamModule({k: v for k, v in tree.items() if k not in _SUBMODULES})

    def device(self) -> torch.device:
        return self.shared.param_device()

    def weights_changed(self) -> None:
        """Drop every cache built from the weights (K1/K5's stacked weights
        and packed streams, the NAR head stacks with K2's packs). Call it
        after the parameters change in place (an optimizer step, a
        restore): serving then rebuilds the caches from the new weights."""
        self.ar.weights_changed()
        self.nar.weights_changed()


class PreparedReference(NamedTuple):
    sv_ref: torch.Tensor  # [B, sv_dim]
    ref_seq: torch.Tensor  # [B, Tr, D]
    ref_kv: Tuple  # per ref-xattn layer: {"k", "v", "mask"}


@functools.lru_cache(maxsize=8)
def _frame_pos_table(d_model: int, max_len: int):
    return sinusoidal_table(d_model, max_len)


def cb_spec(cfg: SoproTTSConfig) -> CodebookEmbeddingSpec:
    return CodebookEmbeddingSpec(cfg.num_codebooks, cfg.codebook_size, use_bos=True)


def encode_reference_seq(
    m: SoproModel, ref_tokens_btq: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """softmax(ref_cb_weights)-mixed codebook embeddings -> SSMLite blocks ->
    RMSNorm."""
    cfg, p = m.cfg, m.shared.p
    x = cb_sum_embed_subset(
        p["cb_embed"], cb_spec(cfg), ref_tokens_btq, list(range(cfg.num_codebooks)),
        cb_weights=p["ref_cb_weights"],
    )
    if mask is not None:
        x = x * mask[..., None].to(x.dtype)
    for bp in p["ref_enc_blocks"]:
        x = ssmlite(bp, x, kernel_size=7, dilation=1, causal=False, mask=mask)
    return rmsnorm(p["ref_enc_norm"], x)


def prepare_reference(
    m: SoproModel, ref_tokens_btq: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> PreparedReference:
    sv_ref = m.token2sv(ref_tokens_btq, mask=mask)
    ref_seq = encode_reference_seq(m, ref_tokens_btq, mask=mask)
    ref_kv = tuple(
        build_kv_cache(xp, ref_seq, heads=m.cfg.ref_xattn_heads, mask=mask)
        for xp in m.shared.p["ref_xattn"]
    )
    return PreparedReference(sv_ref=sv_ref, ref_seq=ref_seq, ref_kv=ref_kv)


def _map_reference(ref: PreparedReference, fn) -> PreparedReference:
    """`fn` applied to every tensor of the reference."""
    f = lambda x: fn(x) if isinstance(x, torch.Tensor) else x
    return PreparedReference(
        sv_ref=f(ref.sv_ref), ref_seq=f(ref.ref_seq),
        ref_kv=tuple({k: f(v) for k, v in kv.items()} for kv in ref.ref_kv),
    )


def tile_reference(ref: PreparedReference, n: int) -> PreparedReference:
    """A one-row reference broadcast to `n` rows (views, no copies)."""
    return _map_reference(ref, lambda x: x.expand(n, *x.shape[1:]) if x.shape[0] == 1 else x)


def reference_to(ref: PreparedReference, device) -> PreparedReference:
    """The reference on `device` (its own tensors where they are there)."""
    return _map_reference(ref, lambda x: x.to(device))


def prepare_conditioning(
    m: SoproModel,
    text_ids: torch.Tensor,
    text_mask: torch.Tensor,
    ref: PreparedReference,
    *,
    max_frames: int,
    style_strength: Union[float, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """Per-frame conditioning for every output frame at once (`style_strength`
    one value, or [B] per row)."""
    cfg, p = m.cfg, m.shared.p
    txt_seq, txt_pool = m.text_enc(text_ids, text_mask)
    tar = int(max_frames) + 1
    if tar > cfg.pos_emb_max + 8:
        raise ValueError(
            f"max_frames={max_frames} needs a positional table of {tar} "
            f"rows but cfg.pos_emb_max={cfg.pos_emb_max}; raise pos_emb_max"
        )
    pos = torch.from_numpy(_frame_pos_table(cfg.d_model, cfg.pos_emb_max + 8)[:tar])
    base = txt_pool[:, None, :] + pos[None].to(device=txt_pool.device, dtype=txt_pool.dtype)
    cond = m.spk_film(base, ref.sv_ref, strength=style_strength)
    for xp, kv in zip(p["ref_xattn"], ref.ref_kv):
        cond = ref_xattn(xp, cond, kv, heads=cfg.ref_xattn_heads, gmax=cfg.ref_xattn_gmax)
    cond = rmsnorm(p["cond_norm"], cond)
    return {"txt_seq": txt_seq, "text_mask": text_mask, "cond_ar": cond.contiguous()}


# --------------------------------------------------------------------------
# AR decode
# --------------------------------------------------------------------------


@dataclass
class ARCarry:
    """Per-row decode state (rows advance and stop independently)."""

    t: torch.Tensor  # [B] int32: next step index
    bufs: torch.Tensor  # [N, B, CTX, D] packed conv ring buffers, in the weights' dtype
    hist: torch.Tensor  # [B, 50] int32 rolling history
    streak: torch.Tensor  # [B] int32 consecutive-repeat count
    last: torch.Tensor  # [B] int32 previous token
    key: torch.Tensor  # [B, 2] int64 per-row Threefry keys (uint32 words)
    tokens: torch.Tensor  # [B, S] int32 sampled tokens
    first_eos: torch.Tensor  # [B] int32, S if none
    stopped: torch.Tensor  # [B] int32 (1: EOS honoured past min_gen)


@dataclass(frozen=True)
class ARSettings:
    """Sampling settings of an AR call: each numeric field is one value for
    every row, or a tensor [B] with one per row (the serving tick's rows
    each carry their own). `anti_loop` is one flag per call."""

    top_p: Union[float, torch.Tensor] = 0.9
    temperature: Union[float, torch.Tensor] = 1.05
    recovery_top_p: Union[float, torch.Tensor] = 0.85
    recovery_temp: Union[float, torch.Tensor] = 1.2
    min_gen_frames: Union[int, torch.Tensor] = 12
    anti_loop: bool = True

    def per_row(self, b: int, device) -> Dict[str, torch.Tensor]:
        def f(v, dtype):
            if isinstance(v, torch.Tensor):
                return v.to(device=device, dtype=dtype).expand(b).contiguous()
            return torch.full((b,), v, dtype=dtype, device=device)

        f32 = torch.float32
        return {
            "top_p": f(self.top_p, f32), "temperature": f(self.temperature, f32),
            "recovery_top_p": f(self.recovery_top_p, f32),
            "recovery_temp": f(self.recovery_temp, f32),
            "min_gen": f(self.min_gen_frames, torch.int32),
        }


def init_ar_carry(
    cfg: SoproTTSConfig, batch: int, max_steps: int, seed: int, device, dtype=torch.float32
) -> ARCarry:
    """Fresh state; row keys are `jax.random.split(PRNGKey(seed), batch)`;
    the ring buffers in `dtype` (the weights')."""
    i32 = dict(dtype=torch.int32, device=device)
    return ARCarry(
        t=torch.zeros(batch, **i32),
        bufs=G.init_ar_conv_state(cfg, batch, device, dtype),
        hist=S.init_history(batch, device),
        streak=torch.zeros(batch, **i32),
        last=torch.zeros(batch, **i32),
        key=S.split_rows(S.prng_key(seed, device), batch),
        tokens=torch.zeros((batch, max_steps), **i32),
        first_eos=torch.full((batch,), max_steps, **i32),
        stopped=torch.zeros(batch, **i32),
    )


def _prev_token_table(m: SoproModel) -> torch.Tensor:
    """[V+1, D]: rows 0..V-1 the codebook-1 embeddings, row V the BOS row."""
    cfg = m.cfg
    emb = m.shared.p["cb_embed"]["emb"]
    bos = int(cfg.num_codebooks) * int(cfg.codebook_size)
    return torch.cat([emb[: cfg.ar_vocab], emb[bos: bos + 1]], dim=0).contiguous()


def ar_context(
    m: SoproModel, txt_seq: torch.Tensor, text_mask: torch.Tensor
) -> ARLoopContext:
    """Text KV caches + the compact previous-token table for the loop (K1 on
    CUDA, the plain per-step loop on the CPU)."""
    kv = G.build_text_kv_caches(m.ar.p, m.cfg, txt_seq, text_mask)
    cuda = txt_seq.device.type == "cuda"
    return ARLoopContext(cfg=m.cfg, p_ar=m.ar.p, stacked=m.ar.stacked() if cuda else None, kv=kv,
                         mask=text_mask, emb=_prev_token_table(m),
                         stream=m.ar.stream if cuda else None)


def ar_context_from_kv(
    m: SoproModel, kv_k: torch.Tensor, kv_v: torch.Tensor, text_mask: torch.Tensor,
    step: bool = False,
):
    """The AR context over a text KV already stacked [A, B, H, L, hd] (the
    serving state keeps it so and scatters joins into it): an ARLoopContext
    whose per-layer caches are views of it, or with `step` an
    ARStepContext (K5 steps)."""
    cuda = kv_k.device.type == "cuda"
    stacked = m.ar.stacked() if cuda else None
    stream = m.ar.stream if cuda else None
    if step:
        return ARStepContext(cfg=m.cfg, p_ar=m.ar.p, stacked=stacked, kv_k=kv_k, kv_v=kv_v,
                             mask=text_mask, emb=_prev_token_table(m), stream=stream)
    kv, a = [], 0
    for xp in m.ar.p["xattn"]:
        kv.append(None if xp is None else {"k": kv_k[a], "v": kv_v[a], "mask": text_mask})
        a += xp is not None
    return ARLoopContext(cfg=m.cfg, p_ar=m.ar.p, stacked=stacked, kv=kv, mask=text_mask,
                         emb=_prev_token_table(m), stream=stream, kv_k=kv_k, kv_v=kv_v)


def ar_step_context(
    m: SoproModel, txt_seq: torch.Tensor, text_mask: torch.Tensor
) -> ARStepContext:
    """The per-step route's context: a loop of K5 steps (`ops/ar_step.py`)
    with the sampler as plain torch between them."""
    kv = [c for c in G.build_text_kv_caches(m.ar.p, m.cfg, txt_seq, text_mask) if c is not None]
    return ARStepContext(
        cfg=m.cfg, p_ar=m.ar.p,
        stacked=m.ar.stacked() if txt_seq.device.type == "cuda" else None,
        kv_k=torch.stack([c["k"] for c in kv]).contiguous(),
        kv_v=torch.stack([c["v"] for c in kv]).contiguous(),
        mask=text_mask, emb=_prev_token_table(m),
        stream=m.ar.stream if txt_seq.device.type == "cuda" else None,
    )


def _state(carry: ARCarry) -> Dict[str, torch.Tensor]:
    return {k: getattr(carry, k) for k in STATE_KEYS}


def ar_row_active(carry: ARCarry) -> torch.Tensor:
    """[B] bool: rows still decoding."""
    return (carry.t < carry.tokens.shape[1]) & (carry.stopped == 0)


def ar_single_step(
    carry: ARCarry, cond_ar: torch.Tensor, ctx: ARStepContext, settings: ARSettings,
) -> ARCarry:
    """One frame for every row (one K5 launch on CUDA, then the sampler);
    rows that stopped or reached the end keep their state."""
    b = carry.tokens.shape[0]
    tok, active, ns = ar_loop_step(
        ctx, cond_ar, _state(carry), settings.per_row(b, cond_ar.device), settings.anti_loop
    )
    rows = torch.arange(b, device=cond_ar.device)
    t_safe = torch.clamp(carry.t, max=carry.tokens.shape[1] - 1).long()
    tokens = carry.tokens.clone()
    tokens[rows, t_safe] = torch.where(active, tok, carry.tokens[rows, t_safe])
    return replace(carry, tokens=tokens, **ns)


def ar_chunk(
    carry: ARCarry,
    cond_ar: torch.Tensor,
    ctx,
    settings: ARSettings,
    n_steps: int,
) -> ARCarry:
    """Advance every row by up to `n_steps` steps and merge the chunk's
    tokens into the absolute buffer. An ARLoopContext runs them in one K1
    launch on CUDA (the plain loop on the CPU); an ARStepContext runs one K5
    step at a time, ending early once every row stopped."""
    if isinstance(ctx, ARStepContext):
        for _ in range(int(n_steps)):
            if not bool(ar_row_active(carry).any()):
                break
            carry = ar_single_step(carry, cond_ar, ctx, settings)
        return carry
    b, s_tok = carry.tokens.shape
    tok_chunk, ns = ar_loop(
        ctx, cond_ar, _state(carry), settings.per_row(b, cond_ar.device), int(n_steps),
        settings.anti_loop,
    )
    pos = torch.arange(s_tok, device=cond_ar.device)[None, :]
    rel = pos - carry.t[:, None]
    in_chunk = (rel >= 0) & (rel < int(n_steps)) & (pos < ns["t"][:, None])
    gath = torch.gather(tok_chunk, 1, torch.clamp(rel, 0, int(n_steps) - 1).long())
    return replace(carry, tokens=torch.where(in_chunk, gath, carry.tokens), **ns)


def ar_generate(
    m: SoproModel,
    cond_ar: torch.Tensor,
    txt_seq: torch.Tensor,
    text_mask: torch.Tensor,
    seed: int,
    settings: ARSettings,
    max_steps: int,
    ctx=None,
) -> ARCarry:
    """Full AR decode of `max_steps` steps through `ctx` (`ar_chunk`); by
    default an ARLoopContext: every step in one K1 launch on CUDA, the plain
    loop (with early exit once every row stopped) on the CPU."""
    if ctx is None:
        ctx = ar_context(m, txt_seq, text_mask)
    carry = init_ar_carry(m.cfg, cond_ar.shape[0], max_steps, seed, cond_ar.device, cond_ar.dtype)
    return ar_chunk(carry, cond_ar, ctx, settings, max_steps)


def nar_refine(
    m: SoproModel,
    cond_seq: torch.Tensor,
    rvq1_bt: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    head_tail: Optional[int] = None,
) -> torch.Tensor:
    p = m.shared.p
    return N.nar_refine(
        m.nar.p, p["cb_embed"], cb_spec(m.cfg), p["nar_prev_cb_weights"], m.cfg,
        cond_seq, rvq1_bt, m.nar.prev_ids(p["cb_embed"]["emb"].device), mask=mask,
        stacks=m.nar.head_stacks(), head_tail=head_tail,
    )
