"""NAR stage heads + greedy argmax: kernel K2 and its plain version.

Replaces sopro_tpu/ops/pallas_nar.py::nar_heads_argmax. Per stage,
ids[b, t, h] = argmax_v((z[b, t] + hid[h]) @ W[h] + b[h]) with float32
accumulation, the bias added in float32, ties to the lowest index. CUDA
tensors go through `csrc/nar_heads.cu` (3-pass TF32 tensor-core products,
one cluster launch per stage), which never stores the logits; CPU tensors
through `nar_heads_argmax_plain` (einsum + argmax).

The kernel reads the weights pre-split: `pack_nar_heads(w_stack)` -> the
TF32 hi and lo parts of W, each [H, kp, vp] with hd padded to kp (a multiple
of 16) and V to vp (a multiple of 256, one cluster block per 256 columns),
zeros in the padding. `NARRefiner.head_stacks()` packs once per device;
a caller without a pack gets one made per call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch.ops.tf32x3 import split_tf32

KP_MULTIPLE, VP_MULTIPLE = 16, 256


def pack_nar_heads(w_stack: torch.Tensor) -> Dict[str, torch.Tensor]:
    """W [H, hd, V] -> {"hi", "lo"}: its TF32 split, [H, kp, vp] each."""
    h, hd, v = w_stack.shape
    kp = -(-hd // KP_MULTIPLE) * KP_MULTIPLE
    vp = -(-v // VP_MULTIPLE) * VP_MULTIPLE
    padded = torch.zeros((h, kp, vp), dtype=torch.float32, device=w_stack.device)
    padded[:, :hd, :v] = w_stack
    hi, lo = split_tf32(padded)
    return {"hi": hi, "lo": lo}


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
    z: torch.Tensor, hid: torch.Tensor, w_stack: torch.Tensor, b_stack: torch.Tensor,
    packed: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """argmax_v((z + hid_h) @ W_h + b_h) -> ids [B, T, H] int32: the kernel
    for CUDA tensors (`packed` = pack_nar_heads(w_stack), made here when
    None), the plain version for CPU tensors."""
    if z.device.type == "cpu":
        return nar_heads_argmax_plain(z, hid, w_stack, b_stack)
    if z.device.type != "cuda":
        raise ValueError(f"nar_heads_argmax: unsupported device {z.device}")
    b, t, hd = z.shape
    h, _, v = w_stack.shape
    if packed is None:
        packed = pack_nar_heads(w_stack)
    kp, vp = packed["hi"].shape[1:]
    for name, x, shape in (
        ("z", z, (b, t, hd)), ("hid", hid, (h, hd)), ("b_stack", b_stack, (h, v)),
        ("packed hi", packed["hi"], (h, kp, vp)), ("packed lo", packed["lo"], (h, kp, vp)),
    ):
        if x.device != z.device or x.dtype != torch.float32:
            raise ValueError(f"nar_heads_argmax: {name} must be float32 on {z.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"nar_heads_argmax: {name} must be contiguous {shape}, got {tuple(x.shape)}"
            )
    out = torch.empty((b, t, h), dtype=torch.int32, device=z.device)
    fn = kernels.lib("nar_heads").sopro_nar_heads_argmax
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        kernels.ptr(z), kernels.ptr(hid), kernels.ptr(packed["hi"]), kernels.ptr(packed["lo"]),
        kernels.ptr(b_stack), kernels.ptr(out), b * t, h, hd, kp, v, vp,
        kernels.stream_ptr(z.device),
    )
    kernels.check(rc, "nar_heads")
    kernels.LAUNCHES["nar_heads"] += 1
    return out
