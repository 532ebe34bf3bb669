"""NAR stage heads + greedy argmax: kernel K2 and its plain version.

Replaces sopro_tpu/ops/pallas_nar.py::nar_heads_argmax. Per stage,
ids[b, t, h] = argmax_v((z[b, t] + hid[h]) @ W[h] + b[h]) with float32
accumulation, the bias added in float32, ties to the lowest index. CUDA
tensors go through `csrc/nar_heads.cu`, which never stores the logits; CPU
tensors through `nar_heads_argmax_plain` (einsum + argmax).
"""

from __future__ import annotations

import ctypes

import torch

from sopro_tpu_torch import kernels


def nar_heads_argmax_plain(
    z: torch.Tensor, hid: torch.Tensor, w_stack: torch.Tensor, b_stack: torch.Tensor
) -> torch.Tensor:
    """z [B, T, hd], hid [H, hd], w_stack [H, hd, V], b_stack [H, V] ->
    ids [B, T, H] int32."""
    zh = z[:, :, None, :] + hid[None, None, :, :]
    logits = torch.einsum("bthd,hdv->bthv", zh, w_stack) + b_stack[None, None]
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return torch.argmax(logits, dim=-1).to(torch.int32)


def nar_heads_argmax(
    z: torch.Tensor, hid: torch.Tensor, w_stack: torch.Tensor, b_stack: torch.Tensor
) -> torch.Tensor:
    """argmax_v((z + hid_h) @ W_h + b_h) -> ids [B, T, H] int32: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if z.device.type == "cpu":
        return nar_heads_argmax_plain(z, hid, w_stack, b_stack)
    if z.device.type != "cuda":
        raise ValueError(f"nar_heads_argmax: unsupported device {z.device}")
    b, t, hd = z.shape
    h, _, v = w_stack.shape
    for name, x, shape in (
        ("z", z, (b, t, hd)), ("hid", hid, (h, hd)),
        ("w_stack", w_stack, (h, hd, v)), ("b_stack", b_stack, (h, v)),
    ):
        if x.device != z.device or x.dtype != torch.float32:
            raise ValueError(f"nar_heads_argmax: {name} must be float32 on {z.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"nar_heads_argmax: {name} must be contiguous {shape}, got {tuple(x.shape)}"
            )
    out = torch.empty((b, t, h), dtype=torch.int32, device=z.device)
    keys = torch.empty((b * t * h,), dtype=torch.int64, device=z.device)  # kernel scratch
    fn = kernels.lib("nar_heads").sopro_nar_heads_argmax
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        kernels.ptr(z), kernels.ptr(hid), kernels.ptr(w_stack), kernels.ptr(b_stack),
        kernels.ptr(out), kernels.ptr(keys), b * t, h, hd, v, kernels.stream_ptr(z.device),
    )
    kernels.check(rc, "nar_heads")
    kernels.LAUNCHES["nar_heads"] += 1
    return out
