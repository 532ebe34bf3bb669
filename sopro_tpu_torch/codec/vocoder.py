"""SEANet decoder: kernel K3 and its plain version.

Replaces sopro_tpu/codec/pallas_vocoder.py::seanet_decode_pallas (and its
`mimi_decode_with_slabs`). `seanet_decode` maps post-transformer embeddings
[B, T25, H] to a waveform [B, T25 * 960]: on CUDA tensors through the
hand-written convolution kernels of `csrc/seanet.cu`, one launch per conv of
the decoder plan with activations crossing device memory between them; on
CPU tensors through `mimi.seanet_apply`.

Kernel layout (`pack_seanet_decoder`): a list of conv ops, each
{"w": [taps, Cin, Cout] contiguous (a [taps*Cin, Cout] GEMM operand), "b",
"dil", "phases", "elu_in", "residual"}. The plan's ELU layers fold into the
next conv's `elu_in`; a transpose conv with k = 2s becomes `phases` = s
two-tap convs, phase r using [w[s-1-r], w[2s-1-r]] and writing rows m*s + r;
a residual block is a k3 conv into a hidden buffer and a k1 conv that adds
the block input.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch.codec.mimi import decode_embeddings, seanet_apply
from sopro_tpu_torch.codec.mimi_config import CONV, CONVT, ELU, RESNET, MimiConfig, decoder_plan


def pack_seanet_decoder(dec_params: List[Dict], cfg: MimiConfig) -> Dict[str, Any]:
    """Decoder params (parallel to decoder_plan) -> {"params", "ops"}."""
    ops: List[Dict[str, Any]] = []
    elu_next = False
    for p, (kind, spec) in zip(dec_params, decoder_plan(cfg)):
        if kind == ELU:
            elu_next = True
            continue
        if kind == CONV:
            if int(spec["stride"]) != 1:
                raise ValueError("seanet kernel: strided conv in the decoder plan")
            ops.append({"w": p["w"].contiguous(), "b": p["b"].contiguous(),
                        "dil": int(spec["dilation"]), "phases": 1,
                        "elu_in": elu_next, "residual": False})
        elif kind == CONVT:
            s, w = int(spec["stride"]), p["w"]
            if int(spec["k"]) != 2 * s or int(spec.get("groups", 1)) != 1:
                raise ValueError(f"seanet kernel: unsupported transpose conv {spec}")
            r = torch.arange(s, device=w.device)
            poly = torch.stack([w[s - 1 - r], w[2 * s - 1 - r]], dim=1)  # [s, 2, Cin, Cout]
            ops.append({"w": poly.contiguous(), "b": p["b"].contiguous(), "dil": 1,
                        "phases": s, "elu_in": elu_next, "residual": False})
        elif kind == RESNET:
            (c3, c1), (s3, s1) = p["convs"], spec["convs"]
            ops.append({"w": c3["w"].contiguous(), "b": c3["b"].contiguous(),
                        "dil": int(s3["dilation"]), "phases": 1, "elu_in": True,
                        "residual": False})
            ops.append({"w": c1["w"].contiguous(), "b": c1["b"].contiguous(),
                        "dil": int(s1["dilation"]), "phases": 1, "elu_in": True,
                        "residual": True})
        elu_next = False
    return {"params": dec_params, "ops": ops}


def _conv_cuda(op: Dict[str, Any], x: torch.Tensor, residual) -> torch.Tensor:
    b, t_in, cin = x.shape
    w = op["w"]
    phases = int(op["phases"])
    taps, wcin, cout = (w.shape[1], w.shape[2], w.shape[3]) if phases > 1 else w.shape
    if wcin != cin:
        raise ValueError(f"seanet kernel: input has {cin} channels, weight {wcin}")
    y = torch.empty((b, t_in * phases, cout), dtype=torch.float32, device=x.device)
    fn = kernels.lib("seanet").sopro_seanet_conv
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        kernels.ptr(x), kernels.ptr(w), kernels.ptr(op["b"]),
        None if residual is None else kernels.ptr(residual), kernels.ptr(y),
        b, t_in, cin, cout, int(taps), int(op["dil"]), int(op["elu_in"]), phases,
        kernels.stream_ptr(x.device),
    )
    kernels.check(rc, "seanet")
    return y


def seanet_decode(packed: Dict[str, Any], cfg: MimiConfig, emb: torch.Tensor) -> torch.Tensor:
    """emb [B, T25, H] -> wav [B, T25 * prod(upsampling_ratios)]: the kernel
    on CUDA tensors, `seanet_apply` on CPU tensors."""
    if emb.device.type == "cpu":
        return seanet_apply(packed["params"], decoder_plan(cfg), emb)[..., 0]
    if emb.device.type != "cuda":
        raise ValueError(f"seanet_decode: unsupported device {emb.device}")
    if emb.dtype != torch.float32 or emb.dim() != 3:
        raise ValueError("seanet_decode: emb must be float32 [B, T, H]")
    for op in packed["ops"]:
        if op["w"].device != emb.device or op["w"].dtype != torch.float32:
            raise ValueError("seanet_decode: weights must be float32 on the input's device")
    x = emb.contiguous()
    block_in = None
    for op in packed["ops"]:
        if op["residual"]:
            x = _conv_cuda(op, x, block_in)
        else:
            block_in = x
            x = _conv_cuda(op, x, None)
    kernels.LAUNCHES["seanet"] += 1
    return x[..., 0]


def mimi_decode_with_slabs(
    p: Dict[str, Any], packed: Dict[str, Any], cfg: MimiConfig, codes_btq: torch.Tensor
) -> torch.Tensor:
    """codes [B, T, Q] -> wav [B, T*hop]: RVQ dequant, upsample and decoder
    transformer as plain ops, the SEANet through `seanet_decode`."""
    return seanet_decode(packed, cfg, decode_embeddings(p, cfg, codes_btq))
