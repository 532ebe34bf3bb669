"""NAR stage heads + greedy argmax: kernel K2 and its plain version.

Replaces sopro_tpu/ops/pallas_nar.py::nar_heads_argmax. Per stage,
ids[b, t, h] = argmax_v((z[b, t] + hid[h]) @ W[h] + b[h]) with float32
accumulation, the bias added in float32, ties to the lowest index; in
bfloat16 z + hid is rounded to bfloat16 first, as the TPU kernel does. CUDA
tensors go through `csrc/nar_heads.cu` (one cluster launch per stage; TF32
tensor-core products, 3-pass for float32, one pass for bfloat16), which
never stores the logits; CPU tensors through `nar_heads_argmax_plain`
(einsum + argmax, float32 accumulation).

The kernel reads the weights packed: `pack_nar_heads(w_stack)` -> for a
float32 stack the TF32 hi and lo parts of W ({"hi", "lo"}), for a bfloat16
stack W itself ({"hi": W, "lo": None}: a bfloat16 value is exact in TF32,
so its split has no low part), each [H, kp, vp] with hd padded to kp (a
multiple of 16) and V to vp (a multiple of 256, one cluster block per 256
columns), zeros in the padding. `NARRefiner.head_stacks()` packs once per
device; a caller without a pack gets one made per call.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch.ops.tf32x3 import split_tf32

KP_MULTIPLE, VP_MULTIPLE = 16, 256


def pack_nar_heads(w_stack: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
    """W [H, hd, V] -> {"hi", "lo"}, [H, kp, vp] each: its TF32 split
    (float32), or W itself and None (bfloat16)."""
    h, hd, v = w_stack.shape
    kp = -(-hd // KP_MULTIPLE) * KP_MULTIPLE
    vp = -(-v // VP_MULTIPLE) * VP_MULTIPLE
    padded = torch.zeros((h, kp, vp), dtype=w_stack.dtype, device=w_stack.device)
    padded[:, :hd, :v] = w_stack
    if w_stack.dtype == torch.bfloat16:
        return {"hi": padded, "lo": None}
    hi, lo = split_tf32(padded)
    return {"hi": hi, "lo": lo}


def nar_heads_argmax_plain(
    z: torch.Tensor, hid: torch.Tensor, w_stack: torch.Tensor, b_stack: torch.Tensor
) -> torch.Tensor:
    """z [B, T, hd], hid [H, hd], w_stack [H, hd, V], b_stack [H, V] ->
    ids [B, T, H] int32. zh = z + hid in the inputs' dtype, then the
    products and the bias in float32."""
    zh = z[:, :, None, :] + hid[None, None, :, :]
    logits = torch.einsum("bthd,hdv->bthv", zh.float(), w_stack.float()) + b_stack.float()[None, None]
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return torch.argmax(logits, dim=-1).to(torch.int32)


def nar_heads_argmax(
    z: torch.Tensor, hid: torch.Tensor, w_stack: torch.Tensor, b_stack: torch.Tensor,
    packed: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """argmax_v((z + hid_h) @ W_h + b_h) -> ids [B, T, H] int32: the kernel
    for CUDA tensors (`packed` = pack_nar_heads(w_stack), made here when
    None; float32 or bfloat16, all inputs of one dtype), the plain version
    for CPU tensors."""
    if z.device.type == "cpu":
        return nar_heads_argmax_plain(z, hid, w_stack, b_stack)
    if z.device.type != "cuda":
        raise ValueError(f"nar_heads_argmax: unsupported device {z.device}")
    b, t, hd = z.shape
    h, _, v = w_stack.shape
    if packed is None:
        packed = pack_nar_heads(w_stack)
    kp, vp = packed["hi"].shape[1:]
    bf16 = z.dtype == torch.bfloat16
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"nar_heads_argmax: z has dtype {z.dtype}: float32 or bfloat16")
    inputs = [("z", z, (b, t, hd)), ("hid", hid, (h, hd)), ("b_stack", b_stack, (h, v)),
              ("packed hi", packed["hi"], (h, kp, vp))]
    if not bf16:
        inputs.append(("packed lo", packed["lo"], (h, kp, vp)))
    for name, x, shape in inputs:
        if x is None or x.device != z.device or x.dtype != z.dtype:
            raise ValueError(f"nar_heads_argmax: {name} must be {z.dtype} on {z.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"nar_heads_argmax: {name} must be contiguous {shape}, got {tuple(x.shape)}"
            )
    out = torch.empty((b, t, h), dtype=torch.int32, device=z.device)
    ptrs = [kernels.ptr(z), kernels.ptr(hid), kernels.ptr(packed["hi"])]
    if bf16:
        fn = kernels.entry("nar_heads", "sopro_nar_heads_argmax_bf16",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    else:
        fn = kernels.entry("nar_heads", "sopro_nar_heads_argmax",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        ptrs.append(kernels.ptr(packed["lo"]))
    rc = fn(*ptrs, kernels.ptr(b_stack), kernels.ptr(out), b * t, h, hd, kp, v, vp,
            kernels.stream_ptr(z.device))
    kernels.check(rc, "nar_heads")
    kernels.count("nar_heads", z.dtype)
    return out
