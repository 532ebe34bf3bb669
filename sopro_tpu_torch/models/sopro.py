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
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from sopro_tpu_torch import sampling as S
from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models import generator as G
from sopro_tpu_torch.models import nar as N
from sopro_tpu_torch.models.base import ParamModule
from sopro_tpu_torch.models.speaker import SpeakerFiLM, Token2SV
from sopro_tpu_torch.models.text import TextEncoder
from sopro_tpu_torch.ops.ar_loop import ARLoopContext, ar_loop
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


def prepare_conditioning(
    m: SoproModel,
    text_ids: torch.Tensor,
    text_mask: torch.Tensor,
    ref: PreparedReference,
    *,
    max_frames: int,
    style_strength: float,
) -> Dict[str, torch.Tensor]:
    """Per-frame conditioning for every output frame at once."""
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
    bufs: torch.Tensor  # [N, B, CTX, D] packed conv ring buffers
    hist: torch.Tensor  # [B, 50] int32 rolling history
    streak: torch.Tensor  # [B] int32 consecutive-repeat count
    last: torch.Tensor  # [B] int32 previous token
    key: torch.Tensor  # [B, 2] int64 per-row Threefry keys (uint32 words)
    tokens: torch.Tensor  # [B, S] int32 sampled tokens
    first_eos: torch.Tensor  # [B] int32, S if none
    stopped: torch.Tensor  # [B] int32 (1: EOS honoured past min_gen)


@dataclass(frozen=True)
class ARSettings:
    top_p: float = 0.9
    temperature: float = 1.05
    recovery_top_p: float = 0.85
    recovery_temp: float = 1.2
    min_gen_frames: int = 12
    anti_loop: bool = True

    def per_row(self, b: int, device) -> Dict[str, torch.Tensor]:
        f = lambda v: torch.full((b,), float(v), dtype=torch.float32, device=device)
        return {
            "top_p": f(self.top_p), "temperature": f(self.temperature),
            "recovery_top_p": f(self.recovery_top_p),
            "recovery_temp": f(self.recovery_temp),
            "min_gen": torch.full((b,), int(self.min_gen_frames), dtype=torch.int32, device=device),
        }


def init_ar_carry(
    cfg: SoproTTSConfig, batch: int, max_steps: int, seed: int, device
) -> ARCarry:
    """Fresh state; row keys are `jax.random.split(PRNGKey(seed), batch)`."""
    i32 = dict(dtype=torch.int32, device=device)
    return ARCarry(
        t=torch.zeros(batch, **i32),
        bufs=G.init_ar_conv_state(cfg, batch, device),
        hist=S.init_history(batch, device),
        streak=torch.zeros(batch, **i32),
        last=torch.zeros(batch, **i32),
        key=S.split_rows(S.prng_key(seed, device), batch),
        tokens=torch.zeros((batch, max_steps), **i32),
        first_eos=torch.full((batch,), max_steps, **i32),
        stopped=torch.zeros(batch, **i32),
    )


def ar_context(
    m: SoproModel, txt_seq: torch.Tensor, text_mask: torch.Tensor
) -> ARLoopContext:
    """Text KV caches + the compact previous-token table for the loop."""
    cfg = m.cfg
    kv = G.build_text_kv_caches(m.ar.p, cfg, txt_seq, text_mask)
    emb = m.shared.p["cb_embed"]["emb"]
    bos = int(cfg.num_codebooks) * int(cfg.codebook_size)
    emb_c = torch.cat([emb[: cfg.ar_vocab], emb[bos: bos + 1]], dim=0).contiguous()
    stacked = m.ar.stacked() if txt_seq.device.type == "cuda" else None
    return ARLoopContext(cfg=cfg, p_ar=m.ar.p, stacked=stacked, kv=kv,
                         mask=text_mask, emb=emb_c)


def ar_chunk(
    carry: ARCarry,
    cond_ar: torch.Tensor,
    ctx: ARLoopContext,
    settings: ARSettings,
    n_steps: int,
) -> ARCarry:
    """Advance every row by up to `n_steps` steps (K1 on CUDA, the plain
    loop on the CPU) and merge the chunk's tokens into the absolute buffer."""
    b, s_tok = carry.tokens.shape
    state = {
        "t": carry.t, "last": carry.last, "streak": carry.streak,
        "stopped": carry.stopped, "first_eos": carry.first_eos,
        "key": carry.key, "hist": carry.hist, "bufs": carry.bufs,
    }
    tok_chunk, ns = ar_loop(
        ctx, cond_ar, state, settings.per_row(b, cond_ar.device), int(n_steps),
        settings.anti_loop,
    )
    pos = torch.arange(s_tok, device=cond_ar.device)[None, :]
    rel = pos - carry.t[:, None]
    in_chunk = (rel >= 0) & (rel < int(n_steps)) & (pos < ns["t"][:, None])
    gath = torch.gather(tok_chunk, 1, torch.clamp(rel, 0, int(n_steps) - 1).long())
    return replace(
        carry, t=ns["t"], bufs=ns["bufs"], hist=ns["hist"], streak=ns["streak"],
        last=ns["last"], key=ns["key"], first_eos=ns["first_eos"],
        stopped=ns["stopped"], tokens=torch.where(in_chunk, gath, carry.tokens),
    )


def ar_generate(
    m: SoproModel,
    cond_ar: torch.Tensor,
    txt_seq: torch.Tensor,
    text_mask: torch.Tensor,
    seed: int,
    settings: ARSettings,
    max_steps: int,
) -> ARCarry:
    """Full AR decode: every step in one K1 launch on CUDA, the plain loop
    (with early exit once every row stopped) on the CPU."""
    ctx = ar_context(m, txt_seq, text_mask)
    carry = init_ar_carry(m.cfg, cond_ar.shape[0], max_steps, seed, cond_ar.device)
    return ar_chunk(carry, cond_ar, ctx, settings, max_steps)


def nar_refine(
    m: SoproModel,
    cond_seq: torch.Tensor,
    rvq1_bt: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    p = m.shared.p
    return N.nar_refine(
        m.nar.p, p["cb_embed"], cb_spec(m.cfg), p["nar_prev_cb_weights"], m.cfg,
        cond_seq, rvq1_bt, mask=mask, stacks=m.nar.head_stacks(),
    )
