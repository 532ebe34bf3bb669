"""Mimi decode as plain PyTorch functions (counterpart: the decode half of
sopro_tpu/codec/mimi_jax.py), NHC layout [B, T, C].

RVQ dequant through the load-time-folded tables, the 12.5 -> 25 Hz grouped
transpose-conv upsample (polyphase depthwise), the sliding-window causal
decoder transformer with RoPE and LayerScale, and the SEANet decoder
(`seanet_apply`, the plain version of kernel K3; see codec/vocoder.py).
Attention is plain matmul + softmax in float32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sopro_tpu_torch.codec.mimi_config import (
    CONV,
    CONVT,
    ELU,
    RESNET,
    MimiConfig,
    Plan,
    decoder_plan,
    upsample_spec,
)
from sopro_tpu_torch.models.base import ParamModule

Params = Dict[str, Any]


def causal_conv_padding(length: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    """(left, right) padding of Mimi's causal conv."""
    k_eff = (k - 1) * dilation + 1
    padding_total = k_eff - stride
    n_frames = math.ceil((length - k_eff + padding_total) / stride + 1) - 1
    ideal = n_frames * stride + k_eff - padding_total
    return padding_total, max(ideal - length, 0)


def mimi_conv(p: Params, x: torch.Tensor, spec: Dict[str, Any]) -> torch.Tensor:
    """Causal Conv1d over [B, T, C_in] -> [B, T', C_out]; weight [k, Cin/g, Cout]."""
    k, stride, dil = int(spec["k"]), int(spec["stride"]), int(spec.get("dilation", 1))
    left, right = causal_conv_padding(x.shape[1], k, stride, dil)
    mode = "replicate" if spec.get("pad_mode", "constant") == "replicate" else "constant"
    xt = F.pad(x.transpose(1, 2), (left, right), mode=mode)
    w = p["w"].permute(2, 1, 0).to(x.dtype)  # [Cout, Cin/g, k]
    y = F.conv1d(xt, w, stride=stride, dilation=dil, groups=int(spec.get("groups", 1)))
    y = y.transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _convt_polyphase(w: torch.Tensor, x: torch.Tensor, s: int) -> torch.Tensor:
    """k = 2s transpose conv: y[m*s + r] = w[s-1-r] . x[m-1] + w[2s-1-r] . x[m],
    one dense [B*T, 2*Cin] @ [2*Cin, s*Cout] product."""
    k, cin, cout = w.shape
    r = torch.arange(s, device=w.device)
    w_prev = w[s - 1 - r].permute(1, 0, 2).reshape(cin, s * cout)
    w_curr = w[2 * s - 1 - r].permute(1, 0, 2).reshape(cin, s * cout)
    w2 = torch.cat([w_prev, w_curr], dim=0).to(x.dtype)
    b, t, _ = x.shape
    xprev = F.pad(x, (0, 0, 1, 0))[:, :t]
    y = torch.cat([xprev, x], dim=-1) @ w2
    return y.reshape(b, t * s, cout)


def _convt_polyphase_depthwise(w: torch.Tensor, x: torch.Tensor, s: int) -> torch.Tensor:
    """Depthwise (groups == C) k = 2s transpose conv as two multiply-adds:
    y[m*s + r, c] = w[s-1-r, c] * x[m-1, c] + w[2s-1-r, c] * x[m, c]."""
    r = torch.arange(s, device=w.device)
    w_prev = w[s - 1 - r, 0].to(x.dtype)  # [s, C]
    w_curr = w[2 * s - 1 - r, 0].to(x.dtype)
    b, t, c = x.shape
    xprev = F.pad(x, (0, 0, 1, 0))[:, :t]
    y = xprev[:, :, None, :] * w_prev[None, None] + x[:, :, None, :] * w_curr[None, None]
    return y.reshape(b, t * s, c)


def mimi_convt(p: Params, x: torch.Tensor, spec: Dict[str, Any]) -> torch.Tensor:
    """Causal ConvTranspose1d over [B, T, C_in] -> [B, T*stride, C_out]. The
    decoder's upsamplers all have k == 2*stride, dense or fully depthwise."""
    k, stride = int(spec["k"]), int(spec["stride"])
    groups, cin, cout = int(spec.get("groups", 1)), int(spec["in"]), int(spec["out"])
    if stride < 2 or k != 2 * stride:
        raise ValueError(f"mimi_convt: unsupported transpose conv {spec}")
    if groups == 1:
        y = _convt_polyphase(p["w"], x, stride)
    elif groups == cin == cout:
        y = _convt_polyphase_depthwise(p["w"], x, stride)
    else:
        raise ValueError(f"mimi_convt: unsupported grouping {spec}")
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def seanet_apply(params: List[Params], plan: Plan, x: torch.Tensor) -> torch.Tensor:
    """Run a SEANet stack over [B, T, C] (the plain version of kernel K3)."""
    for p, (kind, spec) in zip(params, plan):
        if kind == CONV:
            x = mimi_conv(p, x, spec)
        elif kind == CONVT:
            x = mimi_convt(p, x, spec)
        elif kind == RESNET:
            h = x
            for cp, cs in zip(p["convs"], spec["convs"]):
                h = mimi_conv(cp, F.elu(h), cs)
            x = x + h
        elif kind == ELU:
            x = F.elu(x)
        else:
            raise ValueError(f"unknown plan kind {kind}")
    return x


# --------------------------------------------------------------------------
# transformer (RoPE, sliding-window causal, LayerScale)
# --------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [T] -> (cos, sin) [T, head_dim]."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim)
    )
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, T, hd]; cos/sin [T, hd]."""
    return x * cos[None, None].to(x.dtype) + _rotate_half(x) * sin[None, None].to(x.dtype)


def _layernorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def sliding_causal_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """Additive bias [Tq, Tk]: keys with 0 <= q_pos - k_pos < window."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = (diff >= 0) & (diff < window)
    zero = torch.zeros(ok.shape, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, float("-inf")))


def transformer_layer(
    p: Params, cfg: MimiConfig, x: torch.Tensor, cos, sin, bias: torch.Tensor
) -> torch.Tensor:
    """One pre-LN block with LayerScale residuals."""
    h = _layernorm(p["ln1"], x, cfg.norm_eps)
    q = apply_rope(_split_heads(h @ p["q"]["w"], cfg.num_attention_heads), cos, sin)
    k = apply_rope(_split_heads(h @ p["k"]["w"], cfg.num_key_value_heads), cos, sin)
    v = _split_heads(h @ p["v"]["w"], cfg.num_key_value_heads)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits + bias[None, None], dim=-1).to(x.dtype)
    a = _merge_heads(torch.matmul(w, v.to(x.dtype))) @ p["o"]["w"]
    x = x + p["scale_attn"].to(x.dtype) * a
    h = _layernorm(p["ln2"], x, cfg.norm_eps)
    h = F.gelu(h @ p["fc1"]["w"]) @ p["fc2"]["w"]
    return x + p["scale_mlp"].to(x.dtype) * h


def mimi_transformer(
    p: Params, cfg: MimiConfig, x: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    bias = sliding_causal_bias(positions, positions, cfg.sliding_window)
    for lp in p["layers"]:
        x = transformer_layer(lp, cfg, x, cos, sin, bias)
    return x


def rvq_decode(q: Params, codes_btq: torch.Tensor) -> torch.Tensor:
    """codes [B, T, Q] -> embeddings [B, T, hidden] through the folded
    tables `dec_embed` [Q, V, hidden]; ids are clamped into the vocab."""
    nq = codes_btq.shape[-1]
    dec = q["dec_embed"][:nq]
    codes = torch.clamp(codes_btq.long(), 0, dec.shape[1] - 1)
    out = dec[0][codes[:, :, 0]]
    for i in range(1, nq):
        out = out + dec[i][codes[:, :, i]]
    return out


def decode_embeddings(
    p: Params, cfg: MimiConfig, codes_btq: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RVQ dequant -> upsample -> decoder transformer: [B, T, Q] -> [B, 2T, H]."""
    emb = rvq_decode(p["quantizer"], codes_btq)
    emb = mimi_convt(p["upsample"], emb, upsample_spec(cfg))
    if positions is None:
        positions = torch.arange(emb.shape[1], device=emb.device)
    return mimi_transformer(p["dec_tf"], cfg, emb, positions)


def mimi_decode(
    p: Params, cfg: MimiConfig, codes_btq: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """codes [B, T, Q] -> waveform [B, T*hop] with the plain SEANet."""
    emb = decode_embeddings(p, cfg, codes_btq, positions)
    return seanet_apply(p["decoder"], decoder_plan(cfg), emb)[..., 0]


class MimiDecoder(ParamModule):
    """Mimi decode parameters: {"quantizer": {"dec_embed"}, "upsample",
    "dec_tf", "decoder"} in the JAX package's layout."""

    def __init__(self, tree: Params, cfg: MimiConfig):
        super().__init__(tree)
        self.cfg = cfg
        self._packed = None

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def packed_decoder(self):
        """The SEANet weights in kernel K3's layout (built once per device)."""
        if self._packed is None:
            from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder

            self._packed = pack_seanet_decoder(self.p["decoder"], self.cfg)
        return self._packed

    def forward(self, codes_btq: torch.Tensor) -> torch.Tensor:
        from sopro_tpu_torch.codec.vocoder import mimi_decode_with_slabs

        return mimi_decode_with_slabs(self.p, self.packed_decoder(), self.cfg, codes_btq)
