"""Text encoder (counterpart: sopro_tpu/models/text.py): token embeddings +
sinusoidal positions + non-causal SSMLite blocks + RMSNorm, returning the
per-token sequence and a masked mean-pooled vector."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models.base import ParamModule
from sopro_tpu_torch.ops.blocks import rmsnorm, ssmlite
from sopro_tpu_torch.ops.embeddings import sinusoidal_table

Params = Dict


@functools.lru_cache(maxsize=8)
def _pos_table(d_model: int, max_len: int):
    return sinusoidal_table(d_model, max_len)


def text_encoder(
    p: Params, cfg: SoproTTSConfig, text_ids: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """text_ids [B, L] int, mask [B, L] bool (True=valid) ->
    (txt_seq [B, L, D], txt_pool [B, D])."""
    emb = p["embed"]["emb"]
    x = emb[text_ids.long()]
    pos = torch.from_numpy(_pos_table(cfg.d_model, cfg.max_text_len + 8)[: x.shape[1]])
    x = x + pos[None].to(device=x.device, dtype=x.dtype)
    x = x * mask[..., None].to(x.dtype)
    for lp in p["layers"]:
        x = ssmlite(lp, x, kernel_size=7, dilation=1, causal=False, mask=mask)
    x = rmsnorm(p["norm"], x)
    mask_f = mask[..., None].to(x.dtype)
    pooled = torch.sum(x * mask_f, dim=1) / (torch.sum(mask_f, dim=1) + 1e-6)
    return x, pooled


class TextEncoder(ParamModule):
    def __init__(self, tree: Params, cfg: SoproTTSConfig):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, text_ids: torch.Tensor, mask: torch.Tensor):
        return text_encoder(self.p, self.cfg, text_ids, mask)
