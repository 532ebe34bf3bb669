"""Rotary position embeddings in the rotate-half layout (each head's first
half of dims paired with its second half), shared by the Mimi transformer
and CSM's two transformers.

`rope_cos_sin` takes an optional llama3 frequency scaling (Llama 3.1's
`rope_scaling` with "rope_type": "llama3"; transformers'
`_compute_llama3_parameters`): wavelengths longer than
original_max_position_embeddings / low_freq_factor are divided by `factor`,
those shorter than original_max_position_embeddings / high_freq_factor are
kept, and those between are blended linearly in the ratio of the original
context to the wavelength. Without it the frequencies are theta^(-2i/d).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def inv_freq(head_dim: int, theta: float, scaling: Optional[Dict] = None,
             device=None) -> torch.Tensor:
    """[head_dim / 2] float32 frequencies, llama3-scaled where `scaling` says
    so."""
    f = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                         / head_dim))
    if not scaling or scaling.get("rope_type", scaling.get("type")) in (None, "default"):
        return f
    if scaling.get("rope_type", scaling.get("type")) != "llama3":
        raise ValueError(f"unsupported rope_scaling {scaling}")
    factor = float(scaling["factor"])
    low, high = float(scaling["low_freq_factor"]), float(scaling["high_freq_factor"])
    old = float(scaling["original_max_position_embeddings"])
    wavelen = 2 * math.pi / f
    scaled = torch.where(wavelen > old / low, f / factor, f)
    smooth = (old / wavelen - low) / (high - low)
    blended = (1 - smooth) * scaled / factor + smooth * scaled
    medium = ~(wavelen < old / high) & ~(wavelen > old / low)
    return torch.where(medium, blended, scaled)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 scaling: Optional[Dict] = None):
    """positions [T] -> (cos, sin) [T, head_dim]."""
    freqs = positions.float()[:, None] * inv_freq(head_dim, theta, scaling, positions.device)[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE on x [..., hd], with cos and sin (`rope_cos_sin`) broadcast
    against it."""
    return x * cos + rotate_half(x) * sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, hd]; cos/sin [T, hd]."""
    return rotary(x, cos[None, None].to(x.dtype), sin[None, None].to(x.dtype))
