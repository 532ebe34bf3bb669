"""Gated cross-attention blocks (counterpart: sopro_tpu/ops/attention.py).

Pre-RMSNorm queries and context, bias-free projections, float32 attention
with a NaN scrub, tanh-gated residual; the "ref" flavour rescales the output
per token to the query's RMS (clamped to [0, 10]) and bounds the gate by
gmax * tanh(gate). KV caches are dicts {"k", "v", "mask"}, mask True=valid.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from sopro_tpu_torch.ops.blocks import Params, linear, rmsnorm


def _to_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = t.shape
    return t.reshape(b, s, heads, d // heads).transpose(1, 2)


def _from_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, h * hd)


def build_kv_cache(
    p: Params,
    context: torch.Tensor,
    *,
    heads: int,
    mask: Optional[torch.Tensor] = None,
) -> Dict[str, Optional[torch.Tensor]]:
    """K/V over a fixed context [B, S, D] -> {"k", "v": [B, H, S, hd], "mask"}."""
    kv = rmsnorm(p["nkv"], context)
    return {
        "k": _to_heads(kv @ p["k"]["w"], heads),
        "v": _to_heads(kv @ p["v"]["w"], heads),
        "mask": mask,
    }


def _attend_fp32(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """Float32 attention; a row with no valid keys attends to key 0."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    if mask is not None:
        keep = mask.bool().clone()  # [B, S]
        keep[:, 0] |= ~torch.any(keep, dim=-1)
        logits = logits.masked_fill(~keep[:, None, None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    a = torch.einsum("bhqk,bhkd->bhqd", w, v32)
    return torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)


def text_xattn(
    p: Params,
    x: torch.Tensor,
    kv: Dict[str, Optional[torch.Tensor]],
    *,
    heads: int = 4,
    mm=linear,
) -> torch.Tensor:
    """Text cross-attention with tanh-gated residual; `mm` computes the
    products, the gate's tanh is taken in float32."""
    q = _to_heads(mm(p["q"], rmsnorm(p["nq"], x)), heads)
    a = _from_heads(_attend_fp32(q, kv["k"], kv["v"], kv["mask"])).to(x.dtype)
    return x + torch.tanh(p["gate"].float()).to(x.dtype) * mm(p["out"], a)


def _rms_per_token(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    return torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)


def ref_xattn(
    p: Params,
    x: torch.Tensor,
    kv: Dict[str, Optional[torch.Tensor]],
    *,
    heads: int = 2,
    gmax: float = 0.35,
) -> torch.Tensor:
    """Reference-audio cross-attention: RMS-matched output, bounded gate."""
    q = _to_heads(rmsnorm(p["nq"], x) @ p["q"]["w"], heads)
    a = _from_heads(_attend_fp32(q, kv["k"], kv["v"], kv["mask"]))
    scale = torch.clamp(_rms_per_token(x) / _rms_per_token(a), 0.0, 10.0)
    a = (a * scale).to(x.dtype) @ p["out"]["w"]
    gate_eff = (gmax * torch.tanh(p["gate"].float())).to(x.dtype)
    return x + gate_eff * a
