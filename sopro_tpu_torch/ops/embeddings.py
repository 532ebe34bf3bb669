"""Embedding tables (counterpart: sopro_tpu/ops/embeddings.py).

The codebook table is one fused embedding of Q*V (+1 BOS) rows indexed as
cb*V + token, as the checkpoint lays it out.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from sopro_tpu_torch.ops.blocks import Params


def sinusoidal_table(d_model: int, max_len: int) -> np.ndarray:
    """[max_len, d] sin/cos table, interleaved (numpy, float32)."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model)
    )
    angles = position * div
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles)
    return pe


class CodebookEmbeddingSpec:
    """Shape bookkeeping for the fused codebook table."""

    def __init__(self, num_codebooks: int, vocab_size: int, use_bos: bool = True):
        self.Q = int(num_codebooks)
        self.V = int(vocab_size)
        self.use_bos = bool(use_bos)
        self.table_size = self.Q * self.V + (1 if use_bos else 0)
        self.bos_id = self.Q * self.V if use_bos else None


def cb_embed_tokens(
    p: Params, spec: CodebookEmbeddingSpec, tokens: torch.Tensor, cb_index: int
) -> torch.Tensor:
    """Embed tokens of one codebook: row = cb*V + token."""
    return p["emb"][cb_index * spec.V + tokens.long()]


def cb_sum_embed_subset(
    p: Params,
    spec: CodebookEmbeddingSpec,
    tokens_btk: torch.Tensor,
    cb_indices: Sequence[int],
    cb_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax(cb_weights)-weighted sum of embeddings over a codebook subset.

    tokens_btk [B, T, K] are tokens of codebooks `cb_indices` (len K);
    cb_weights is [Q] (full) or [K] logits. One fused gather of all K rows,
    then the weighted sum accumulated codebook by codebook (the JAX
    package's summation order)."""
    table = p["emb"]
    cbs = torch.as_tensor(list(cb_indices), dtype=torch.long, device=table.device)
    g = table[cbs * spec.V + tokens_btk.long()]  # [B, T, K, D]
    w = None
    if cb_weights is not None:
        w = cb_weights
        if w.shape[0] == spec.Q:
            w = w[cbs]
        w = torch.softmax(w.float(), dim=0).to(table.dtype)
    out = g[:, :, 0] if w is None else g[:, :, 0] * w[0]
    for j in range(1, len(cb_indices)):
        out = out + (g[:, :, j] if w is None else g[:, :, j] * w[j])
    return out
