"""Autoregressive RVQ-codebook-1 generator (counterpart:
sopro_tpu/models/generator.py): causal dilated SSMLite blocks with a text
cross-attention after every `ar_text_attn_freq`-th block and a linear head
to codebook_size+1 (EOS).

Conv state: the port keeps every block's ring buffer in ONE packed tensor
[N_layers, B, CTX, D], oldest-first, CTX = (k-1)*max(dilation)+1 (the layout
of the JAX package's fused kernels, `pallas_ar.pack_conv_state`). Each block
reads only its last (k-1)*dilation+1 entries, so the longer buffer holds
older history that no tap reads and the step equals the per-block one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models.base import ParamModule
from sopro_tpu_torch.ops.attention import build_kv_cache, text_xattn
from sopro_tpu_torch.ops.blocks import linear, rmsnorm, ssmlite_step

Params = Dict
TEXT_HEADS = 4


def has_xattn(cfg: SoproTTSConfig, layer_idx: int) -> bool:
    return (layer_idx + 1) % int(cfg.ar_text_attn_freq) == 0


def conv_ctx(cfg: SoproTTSConfig) -> int:
    return (int(cfg.ar_kernel) - 1) * max(cfg.ar_dilations()) + 1


def init_ar_conv_state(
    cfg: SoproTTSConfig, batch: int, device=None, dtype=torch.float32
) -> torch.Tensor:
    """Zero packed ring buffers [N_layers, B, CTX, D]."""
    return torch.zeros(
        (int(cfg.n_layers_ar), batch, conv_ctx(cfg), int(cfg.d_model)),
        dtype=dtype, device=device,
    )


def build_text_kv_caches(
    p: Params,
    cfg: SoproTTSConfig,
    text_emb: torch.Tensor,
    text_mask: Optional[torch.Tensor],
) -> List[Optional[Dict]]:
    """Fixed text KV caches for the cross-attention layers (None elsewhere)."""
    return [
        build_kv_cache(xp, text_emb, heads=TEXT_HEADS, mask=text_mask)
        if xp is not None else None
        for xp in p["xattn"]
    ]


def ar_step(
    p: Params,
    cfg: SoproTTSConfig,
    x_bd: torch.Tensor,
    bufs: torch.Tensor,
    kv_caches: List[Optional[Dict]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step over [B, D] -> (logits [B, V+1], new packed bufs)."""
    dils = cfg.ar_dilations()
    h = x_bd
    new_bufs = []
    for i, bp in enumerate(p["blocks"]):
        h, buf = ssmlite_step(bp, h, bufs[i], kernel_size=cfg.ar_kernel, dilation=dils[i])
        new_bufs.append(buf)
        if p["xattn"][i] is not None and kv_caches[i] is not None:
            h = text_xattn(p["xattn"][i], h[:, None, :], kv_caches[i], heads=TEXT_HEADS)[:, 0]
    h = rmsnorm(p["norm"], h)
    return linear(p["head"], h), torch.stack(new_bufs)


class ARGenerator(ParamModule):
    """AR generator parameters; `stacked()` gives the kernel's weight view."""

    def __init__(self, tree: Params, cfg: SoproTTSConfig):
        super().__init__(tree)
        self.cfg = cfg
        self._stacked = None

    def _apply(self, fn, *args, **kwargs):
        self._stacked = None
        return super()._apply(fn, *args, **kwargs)

    def stacked(self) -> Dict[str, torch.Tensor]:
        """Per-block weights stacked on a leading layer/attn axis, contiguous
        (the AR loop kernel's input layout; built once per device)."""
        if self._stacked is None:
            p = self.p
            blocks = p["blocks"]
            xattn = [x for x in p["xattn"] if x is not None]

            def stack(fn, items):
                return torch.stack([fn(b) for b in items]).contiguous()

            self._stacked = {
                "norm": stack(lambda b: b["norm"]["scale"], blocks),  # [N, D]
                "glu_w": stack(lambda b: b["glu"]["pro"]["w"], blocks),  # [N, D, 2D]
                "glu_b": stack(lambda b: b["glu"]["pro"]["b"], blocks),  # [N, 2D]
                "dw_w": stack(lambda b: b["dw"]["w"][:, 0, :], blocks),  # [N, k, D]
                "dw_b": stack(lambda b: b["dw"]["b"], blocks),  # [N, D]
                "ff_norm": stack(lambda b: b["ff_norm"]["scale"], blocks),
                "ff1_w": stack(lambda b: b["ff1"]["w"], blocks),  # [N, D, 4D]
                "ff1_b": stack(lambda b: b["ff1"]["b"], blocks),
                "ff2_w": stack(lambda b: b["ff2"]["w"], blocks),  # [N, 4D, D]
                "ff2_b": stack(lambda b: b["ff2"]["b"], blocks),
                "x_nq": stack(lambda x: x["nq"]["scale"], xattn),  # [A, D]
                "x_q": stack(lambda x: x["q"]["w"], xattn),  # [A, D, D]
                "x_out": stack(lambda x: x["out"]["w"], xattn),  # [A, D, D]
                "x_gate": stack(lambda x: x["gate"].reshape(()), xattn),  # [A]
                "out_norm": p["norm"]["scale"].contiguous(),  # [D]
                # [D, Vp], [Vp]: zero columns up to a multiple of 4 (16-byte rows)
                "head_w": F.pad(p["head"]["w"], (0, (-p["head"]["w"].shape[1]) % 4)).contiguous(),
                "head_b": F.pad(p["head"]["b"], (0, (-p["head"]["b"].shape[0]) % 4)).contiguous(),
            }
        return self._stacked
