"""One AR decode step without sampling: kernel K5 and its plain version.

Replaces sopro_tpu/ops/pallas_ar.py::ar_step_pallas. `ar_step(ctx, x, bufs)`
runs the AR block stack once for B rows: six SSMLite blocks (RMSNorm, GLU,
dilated causal depthwise conv over the packed ring buffers, erf-GELU FFN), a
text cross-attention after every `ar_text_attn_freq`-th block, the output
RMSNorm and the head. CUDA tensors launch `sopro_ar_step` of
`csrc/ar_loop.cu`, the loop kernel K1 in its logits-only mode; CPU tensors
take `ar_step_plain`, the generator's plain step (`models/generator.py`).
The caller samples between steps (`ops/ar_loop.py::ar_loop_step`).

x: [B, D] and bufs: [N, B, CTX, D] oldest-first, in the weights' dtype
(float32, or bfloat16: the kernel's bfloat16 instantiation). Returns
(logits f32 [B, V], bufs shifted by one: oldest dropped, the new GLU output
last).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from sopro_tpu_torch.config import SoproTTSConfig
from sopro_tpu_torch.models.generator import ar_step as generator_step
from sopro_tpu_torch.ops.ar_loop import need, block_args, launch


@dataclass
class ARStepContext:
    """What every K5 step reads besides x and the buffers: the AR parameter
    tree and its stacked kernel view (`ARGenerator.stacked()`, None on the
    CPU), the text KV of the attention layers stacked as [A, B, H, L, hd],
    the text mask, the previous-token table [V+1, D] of the loop around it
    (`ar_loop_step`), and on CUDA the kernel's packed weight stream per
    grid size (`ARGenerator.stream`)."""

    cfg: SoproTTSConfig
    p_ar: Dict
    stacked: Optional[Dict[str, torch.Tensor]]
    kv_k: torch.Tensor  # [A, B, H, L, hd]
    kv_v: torch.Tensor
    mask: torch.Tensor  # [B, L] bool
    emb: torch.Tensor  # [V+1, D]
    stream: Optional[Callable[[int], Dict]] = None  # grid blocks -> packed weights (CUDA)

    def step(self, x: torch.Tensor, bufs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return ar_step(self, x, bufs)


def ar_step_plain(
    ctx: ARStepContext, x: torch.Tensor, bufs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 (same contract)."""
    stacked_kv = iter(zip(ctx.kv_k, ctx.kv_v))
    kv = [None if xp is None else dict(zip(("k", "v"), next(stacked_kv)), mask=ctx.mask)
          for xp in ctx.p_ar["xattn"]]
    return generator_step(ctx.p_ar, ctx.cfg, x, bufs, kv)


def ar_step(
    ctx: ARStepContext, x: torch.Tensor, bufs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: the kernel on a CUDA device, the plain version on the CPU."""
    if x.device.type == "cpu":
        return ar_step_plain(ctx, x, bufs)
    if x.device.type != "cuda":
        raise ValueError(f"ar_step: unsupported device {x.device}")
    return _ar_step_cuda(ctx, x, bufs)


def _ar_step_cuda(ctx, x, bufs):
    b, d = x.shape
    mask = ctx.mask.to(torch.int32).contiguous()
    args = block_args("ar_step", ctx.cfg, ctx.stacked, ctx.kv_k, ctx.kv_v, mask, bufs)
    need("ar_step", x, "x", bufs.dtype, (b, d), bufs.device)
    logits = torch.empty((b, int(ctx.cfg.ar_vocab)), dtype=torch.float32, device=x.device)
    bufs_out = torch.empty_like(bufs)
    args.S = args.n_steps = 1
    args.x_in, args.logits, args.bufs_out = x.data_ptr(), logits.data_ptr(), bufs_out.data_ptr()
    launch("ar_step", "sopro_ar_step", args, x.device, ctx.stream, bufs.dtype)
    return logits, bufs_out
