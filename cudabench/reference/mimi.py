"""Mimi's decoder as plain PyTorch, from the `transformers.MimiModel` names
of the kyutai/mimi checkpoint (`modeling_mimi.py`): the split RVQ (one
semantic and 31 acoustic Euclidean codebooks, embed = embed_sum /
cluster_usage, each split summed and then projected by its 1x1 output
conv), the 12.5 -> 25 Hz grouped transpose-conv upsample, the decoder
transformer (RoPE, sliding-window causal attention, LayerScale, GELU MLP)
and the SEANet decoder (causal convs, causal transpose convs trimmed on the
right, residual blocks ELU > conv(k) > ELU > conv(1)).

Every stage is causal, so the waveform of frame f depends on codes of
frames <= f only: the check decodes a session's codes in one pass and
compares it with the chunks the program streamed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from cudabench.reference.precision import Precision


class MimiDecoder:
    def __init__(self, sd: Dict[str, torch.Tensor], cfg: Dict, prec: Precision):
        self.cfg = cfg
        self.prec = prec
        self.sd = {k: prec.weight(v) for k, v in sd.items()
                   if not k.startswith(("encoder.", "encoder_transformer.", "downsample."))
                   and "input_proj" not in k}
        self.q = int(cfg["num_quantizers"])
        self.ns = int(cfg["num_semantic_quantizers"])
        self.hidden = int(cfg["hidden_size"])
        # the decoder's layer list, as MimiDecoder builds it
        self.layers = []
        scale = 2 ** len(cfg["upsampling_ratios"])
        nf = int(cfg["num_filters"])
        self.layers.append(("conv", int(cfg["kernel_size"]), 1, 1))
        for ratio in cfg["upsampling_ratios"]:
            self.layers.append(("elu",))
            self.layers.append(("convt", 2 * int(ratio), int(ratio)))
            for j in range(int(cfg["num_residual_layers"])):
                self.layers.append(("res", int(cfg["residual_kernel_size"]),
                                    int(cfg["dilation_growth_rate"]) ** j))
            scale //= 2
        self.layers.append(("elu",))
        self.layers.append(("conv", int(cfg["last_kernel_size"]), 1, 1))

    def conv(self, name: str, x: torch.Tensor, k: int, dil: int = 1) -> torch.Tensor:
        """Causal stride-1 conv over [B, C, T]."""
        pad = (k - 1) * dil
        return F.conv1d(F.pad(self.prec.act(x), (pad, 0)), self.sd[f"{name}.weight"],
                        self.sd.get(f"{name}.bias"), dilation=dil)

    def convt(self, name: str, x: torch.Tensor, k: int, stride: int, groups: int = 1):
        """Causal transpose conv over [B, C, T]: the k - stride samples past
        the end are trimmed (trim_right_ratio 1)."""
        y = F.conv_transpose1d(self.prec.act(x), self.sd[f"{name}.weight"],
                               self.sd.get(f"{name}.bias"), stride=stride, groups=groups)
        return y[..., : y.shape[-1] - (k - stride)]

    def rvq(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, Q] -> latent [B, hidden, T]."""
        out = 0
        splits = (("semantic", 0, self.ns), ("acoustic", self.ns, self.q))
        for split, lo, hi in splits:
            name = f"quantizer.{split}_residual_vector_quantizer"
            acc = 0
            for i in range(lo, hi):
                cb = f"{name}.layers.{i - lo}.codebook"
                emb = self.sd[f"{cb}.embed_sum"] / self.sd[f"{cb}.cluster_usage"].clamp(min=1e-5)[:, None]
                acc = acc + emb[codes[:, :, i].long()]
            proj = self.sd[f"{name}.output_proj.weight"]  # [hidden, cb_dim, 1]
            out = out + F.conv1d(self.prec.act(acc.transpose(1, 2)), proj)
        return out

    def transformer(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, H] at 25 Hz, positions 0..T-1."""
        cfg = self.cfg
        nh, hd = int(cfg["num_attention_heads"]), int(cfg["head_dim"])
        t = x.shape[1]
        pos = torch.arange(t, device=x.device).float()
        inv = 1.0 / (float(cfg["rope_theta"]) ** (torch.arange(0, hd, 2, device=x.device).float() / hd))
        ang = torch.cat([pos[:, None] * inv[None]] * 2, -1)
        cos, sin = torch.cos(ang), torch.sin(ang)
        rot = lambda z: torch.cat([-z[..., hd // 2:], z[..., : hd // 2]], -1)
        diff = torch.arange(t, device=x.device)[:, None] - torch.arange(t, device=x.device)[None]
        allowed = (diff >= 0) & (diff < int(cfg["sliding_window"]))
        eps = float(cfg["norm_eps"])
        lin = lambda name, z: self.prec.act(z) @ self.sd[f"{name}.weight"].t()

        def ln(name, z):
            mu = z.mean(-1, keepdim=True)
            var = ((z - mu) ** 2).mean(-1, keepdim=True)
            return (z - mu) * torch.rsqrt(var + eps) * self.sd[f"{name}.weight"] + self.sd[f"{name}.bias"]

        split = lambda z: z.reshape(z.shape[0], t, nh, hd).transpose(1, 2)
        for i in range(int(cfg["num_hidden_layers"])):
            p = f"decoder_transformer.layers.{i}"
            h = ln(f"{p}.input_layernorm", x)
            q = split(lin(f"{p}.self_attn.q_proj", h))
            k = split(lin(f"{p}.self_attn.k_proj", h))
            v = split(lin(f"{p}.self_attn.v_proj", h))
            q, k = q * cos + rot(q) * sin, k * cos + rot(k) * sin
            s = (self.prec.act(q) @ self.prec.act(k).transpose(-1, -2)) / math.sqrt(hd)
            a = torch.softmax(s.masked_fill(~allowed, float("-inf")), -1)
            o = (self.prec.act(a) @ self.prec.act(v)).transpose(1, 2).reshape(x.shape)
            x = x + self.sd[f"{p}.self_attn_layer_scale.scale"] * lin(f"{p}.self_attn.o_proj", o)
            h = ln(f"{p}.post_attention_layernorm", x)
            h = lin(f"{p}.mlp.fc2", F.gelu(lin(f"{p}.mlp.fc1", h)))
            x = x + self.sd[f"{p}.mlp_layer_scale.scale"] * h
        return x

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, Q] -> waveform [B, T * hop]."""
        x = self.rvq(codes)
        x = self.convt("upsample.conv", x, 4, 2, groups=int(self.cfg["upsample_groups"]))
        x = self.transformer(x.transpose(1, 2)).transpose(1, 2)
        for i, layer in enumerate(self.layers):
            name = f"decoder.layers.{i}"
            if layer[0] == "conv":
                x = self.conv(f"{name}.conv", x, layer[1], layer[3])
            elif layer[0] == "convt":
                x = self.convt(f"{name}.conv", x, layer[1], layer[2])
            elif layer[0] == "res":
                h = self.conv(f"{name}.block.1.conv", F.elu(x), layer[1], layer[2])
                x = x + self.conv(f"{name}.block.3.conv", F.elu(h), 1)
            else:
                x = F.elu(x)
        return x[:, 0]
