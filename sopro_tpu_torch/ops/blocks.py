"""Core NN primitives as plain functions on tensors
(counterpart: sopro_tpu/ops/blocks.py).

Parameters are nested dicts of tensors in the JAX package's layouts: linear
weights are [in, out], depthwise conv weights [k, 1, D], activations [B, T, D].
Norms compute in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, not the tanh approximation."""
    return F.gelu(x)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b). Weight layout is [in, out]."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def linear_f32(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b) as the AR kernels K1 and K5 compute it (the TPU kernels'
    `mm`): x rounded to the weights' dtype, the product accumulated in
    float32, the bias added in float32; float32 out. On float32 inputs and
    weights this is `linear`."""
    w = p["w"]
    y = x.to(w.dtype).float() @ w.float()
    if "b" in p:
        y = y + p["b"].float()
    return y


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y32 = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    return y32.to(x.dtype)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def glu(p: Params, x: torch.Tensor, mm=linear) -> torch.Tensor:
    """a * sigmoid(b) gating; `mm` computes the product."""
    a, b = torch.chunk(mm(p["pro"], x), 2, dim=-1)
    return a * torch.sigmoid(b)


def dwconv1d(
    p: Params,
    x: torch.Tensor,
    *,
    kernel_size: int,
    dilation: int = 1,
    causal: bool = False,
) -> torch.Tensor:
    """Depthwise dilated conv over [B, T, D] with same-length padding
    (causal: all-left; centred: the extra sample on the right)."""
    k, d = int(kernel_size), int(dilation)
    total = (k - 1) * d
    left = total if causal else total // 2
    xt = F.pad(x.transpose(1, 2), (left, total - left))  # [B, D, T+total]
    w = p["w"][:, 0, :].t().unsqueeze(1).to(x.dtype)  # [D, 1, k]
    y = F.conv1d(xt, w, dilation=d, groups=x.shape[-1]).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def dwconv_ctx_len(kernel_size: int, dilation: int) -> int:
    return (int(kernel_size) - 1) * int(dilation) + 1


def dwconv1d_step(
    p: Params,
    x_bd: torch.Tensor,
    buf: torch.Tensor,
    *,
    kernel_size: int,
    dilation: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal step. x_bd [B, D]; buf [B, ctx, D] oldest-first with
    ctx >= (k-1)*dilation+1 (a longer buffer only holds older history the
    taps never read). x joins the buffer in the buffer's dtype, and the
    taps are summed in float32. Returns (y float32 [B, D], the shifted
    buffer)."""
    k, d = int(kernel_size), int(dilation)
    buf = torch.cat([buf[:, 1:], x_bd.to(buf.dtype)[:, None, :]], dim=1)
    span = dwconv_ctx_len(k, d)
    taps = buf[:, buf.shape[1] - span :: d, :]  # [B, k, D] oldest-first
    y = torch.einsum("bkd,kd->bd", taps.float(), p["w"].reshape(k, -1).float())
    if "b" in p:
        y = y + p["b"].float()
    return y, buf


def _ssmlite_ff(p: Params, x: torch.Tensor, mm=linear) -> torch.Tensor:
    h = rmsnorm(p["ff_norm"], x)
    return mm(p["ff2"], gelu(mm(p["ff1"], h)))


def ssmlite(
    p: Params,
    x: torch.Tensor,
    *,
    kernel_size: int,
    dilation: int = 1,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x + dwconv(glu(norm(x))); x + FFN(x). `mask` [B, T] (True=valid)
    zeroes the conv input at padded frames."""
    h = glu(p["glu"], rmsnorm(p["norm"], x))
    if mask is not None:
        h = h * mask[..., None].to(h.dtype)
    h = dwconv1d(p["dw"], h, kernel_size=kernel_size, dilation=dilation, causal=causal)
    x = x + h
    return x + _ssmlite_ff(p, x)


def ssmlite_step(
    p: Params,
    x_bd: torch.Tensor,
    buf: torch.Tensor,
    *,
    kernel_size: int,
    dilation: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal step over [B, D] as kernels K1 and K5 compute it in either
    dtype: x in float32, every product through `linear_f32`, the GLU output
    stored in the ring buffer's dtype and the depthwise conv summed in
    float32 over it. On float32 weights and buffer this is the plain step.
    Returns (float32 [B, D], the shifted buffer)."""
    x = x_bd.float()
    h = glu(p["glu"], rmsnorm(p["norm"], x), mm=linear_f32)
    y, buf = dwconv1d_step(p["dw"], h, buf, kernel_size=kernel_size, dilation=dilation)
    x = x + y
    return x + _ssmlite_ff(p, x, mm=linear_f32), buf


def attentive_stats_pool(
    p: Params, h: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Attention-weighted mean||std over time. h [B, T, D] -> [B, 2D]."""
    logits = linear(p["a2"], torch.tanh(linear(p["a1"], h)))[..., 0]  # [B, T]
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    w = torch.softmax(logits, dim=1)[..., None]
    mu = torch.sum(h * w, dim=1)
    var = torch.sum(w * torch.square(h - mu[:, None, :]), dim=1)
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    return torch.cat([mu, std], dim=-1)
