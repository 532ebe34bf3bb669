"""Speaker-verification student (Token2SV) and FiLM conditioning
(counterpart: sopro_tpu/models/speaker.py)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sopro_tpu_torch.models.base import ParamModule
from sopro_tpu_torch.ops.blocks import (
    attentive_stats_pool,
    dwconv1d,
    gelu,
    layernorm,
    linear,
)

Params = Dict


def token2sv(
    p: Params,
    tokens_btq: torch.Tensor,
    vocab_size: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [B, T, Q] int, mask [B, T] bool -> L2-normalized [B, out_dim]."""
    b, t, q = tokens_btq.shape
    if mask is None:
        mask = torch.ones((b, t), dtype=torch.bool, device=tokens_btq.device)
    q_idx = torch.arange(q, device=tokens_btq.device)[None, None, :]
    raw = p["emb"]["emb"][q_idx * vocab_size + tokens_btq.long()]  # [B, T, Q, d]
    raw = raw * mask[:, :, None, None].to(raw.dtype)
    w = torch.softmax(p["cb_weights"].float(), dim=0).to(raw.dtype)
    x = torch.einsum("btqd,q->btd", raw, w)
    m = mask[..., None].to(x.dtype)
    x = x * m
    h = gelu(dwconv1d(p["conv1"], x, kernel_size=7, causal=False)) * m
    h = gelu(dwconv1d(p["conv2"], h, kernel_size=7, causal=False)) * m
    e = linear(p["proj"], attentive_stats_pool(p["pool"], h, mask=mask))
    norm = torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-6)
    return e / norm


def speaker_film(
    p: Params, base_btd: torch.Tensor, spk_bd: torch.Tensor, strength: float = 1.0
) -> torch.Tensor:
    """norm(x) * (1 + s*tanh(gamma)) + s*tanh(beta)."""
    film = linear(p["mlp2"], gelu(linear(p["mlp1"], spk_bd)))
    gamma, beta = torch.chunk(film, 2, dim=-1)
    x = layernorm(p["norm"], base_btd)
    s = float(strength)
    return x * (1 + s * torch.tanh(gamma)[:, None, :]) + s * torch.tanh(beta)[:, None, :]


class Token2SV(ParamModule):
    def __init__(self, tree: Params, vocab_size: int):
        super().__init__(tree)
        self.vocab_size = int(vocab_size)

    def forward(self, tokens_btq: torch.Tensor, mask: Optional[torch.Tensor] = None):
        return token2sv(self.p, tokens_btq, self.vocab_size, mask=mask)


class SpeakerFiLM(ParamModule):
    def forward(self, base_btd: torch.Tensor, spk_bd: torch.Tensor, strength: float = 1.0):
        return speaker_film(self.p, base_btd, spk_bd, strength)
