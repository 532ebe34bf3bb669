"""SEANet decoder: kernels K3 and K4 and their plain versions.

K3 replaces sopro_tpu/codec/pallas_vocoder.py::seanet_decode_pallas (and its
`mimi_decode_with_slabs`): `seanet_decode` maps post-transformer embeddings
[B, T25, H] to a waveform [B, T25 * 960] from zero history. K4 replaces
`seanet_decode_pallas_chunk`: `seanet_decode_chunk` maps one streaming chunk
with its real left context, ext [B, halo + m25, H], to the chunk's waveform
[B, m25 * 960]. On CUDA tensors K3 runs the tensor-core kernels of
`csrc/seanet.cu` (a causal conv per conv of stages 1-2 and per transpose,
one fused kernel per residual block of the 128- and 64-channel stages, the
last one with the final conv), and K4 the valid-mode per-conv kernel; on CPU
tensors both run `mimi.seanet_apply` (K4 keeping the last m25 * 960
samples, which equal the valid-mode result because the stack's receptive
field is `halo` frames).

Early in a stream the history holds only `n_hist` < halo real frames; the
rows before them are no signal but the causal zero padding of every conv.
`seanet_decode_chunk` takes `n_hist` per batch row: the plain version then
decodes ext[b, halo - n_hist[b]:] causally, and the kernel reads each conv's
input rows before the stream's start as zero (`start_table`). Without it a
zero history would carry the conv biases into the first chunk.

Kernel layout (`pack_seanet_decoder`):
- "ops" (K4): a list of conv ops, each {"w": [taps, Cin, Cout] contiguous
  (a [taps*Cin, Cout] GEMM operand), "b", "dil", "phases", "elu_in",
  "residual"}. The plan's ELU layers fold into the next conv's `elu_in`; a
  transpose conv with k = 2s becomes `phases` = s two-tap convs, phase r
  using [w[s-1-r], w[2s-1-r]] and writing rows m*s + r; a residual block is
  a k3 conv into a hidden buffer and a k1 conv that adds the block input.
- "k3": K3's launches. {"kind": "conv", "hi", "lo": [taps, cinp, np] (the
  TF32 split of the weight, zero-padded to cinp = Cin rounded up to 32 and
  np = N rounded up to 128), "b" [N], "taps", "dil", "elu_in", "cin", "n",
  "phases", "residual"}: a transpose conv is one two-tap conv with N = s * Cout,
  column r * Cout + c holding phase r, its bias repeated s times. {"kind":
  "resblock", "c", "final", "w1hi", "w1lo" [3C, C/2], "b1", "w2hi", "w2lo"
  [C/2, C], "b2", "wf" [3C], "bf" [1]}: a residual block of C = 128 or 64
  channels (k3 dilation 1), with the final ELU + k3 conv to one channel
  when "final" (wf and bf, float32, are then that conv's).
- "start_table" [halo + 1, n_ops] int32: for a chunk whose history starts
  at ext row s0, row s0 holds the first input row of each op that lies at
  or after the stream's start.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, List, Optional

import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch.codec.mimi import decode_embeddings, seanet_apply
from sopro_tpu_torch.codec.mimi_config import (
    CONV, CONVT, ELU, RESNET, MimiConfig, decoder_plan, required_halo,
)
from sopro_tpu_torch.ops.tf32x3 import split_tf32

CIN_MULTIPLE, N_MULTIPLE = 32, 128  # K3 conv kernel: Cin chunks, column tiles
# the fused K3 residual-block kernel: width C -> rows of hidden per time tile
# (csrc/seanet.cu ResTile::BM; a tile with the final conv writes 2 fewer)
RESBLOCK_TILE_ROWS = {128: 32, 64: 64}


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
    return {"params": dec_params, "ops": ops, "k3": _k3_launches(ops),
            "start_table": _start_table(ops, cfg)}


def _k3_conv(op: Dict[str, Any], residual: bool) -> Dict[str, Any]:
    """A per-conv op -> K3's causal conv launch (a transpose as one two-tap
    conv over s * Cout phase-major columns)."""
    w = op["w"]
    phases = int(op["phases"])
    if phases > 1:  # [s, 2, Cin, Cout] -> [2, Cin, s * Cout]
        w = w.permute(1, 2, 0, 3).reshape(w.shape[1], w.shape[2], phases * w.shape[3])
    taps, cin, n = w.shape
    cinp = -(-cin // CIN_MULTIPLE) * CIN_MULTIPLE
    np_ = -(-n // N_MULTIPLE) * N_MULTIPLE
    padded = torch.zeros((taps, cinp, np_), dtype=torch.float32, device=w.device)
    padded[:, :cin, :n] = w
    hi, lo = split_tf32(padded)
    return {"kind": "conv", "hi": hi, "lo": lo, "b": op["b"].repeat(phases).contiguous(),
            "taps": int(taps), "dil": int(op["dil"]), "elu_in": bool(op["elu_in"]),
            "cin": int(cin), "n": int(n), "phases": phases, "residual": residual}


def _fusable(k3: Dict[str, Any], k1: Dict[str, Any]) -> bool:
    taps, c, ch = k3["w"].shape
    return (c in RESBLOCK_TILE_ROWS and taps == 3 and int(k3["dil"]) == 1 and ch == c // 2
            and tuple(k1["w"].shape) == (1, ch, c))


def _k3_launches(ops: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """K3's launch list from the per-conv ops: residual blocks of 128 or 64
    channels fuse (the last one with the final one-channel conv after it);
    every other conv is one causal conv launch."""
    out: List[Dict[str, Any]] = []
    i = 0
    while i < len(ops):
        op = ops[i]
        nxt = ops[i + 1] if i + 1 < len(ops) else None
        if nxt is not None and nxt["residual"] and _fusable(op, nxt):
            c = int(op["w"].shape[1])
            last = ops[i + 2] if i + 3 == len(ops) else None
            final = (last is not None and tuple(last["w"].shape) == (3, c, 1)
                     and int(last["dil"]) == 1 and last["elu_in"] and int(last["phases"]) == 1)
            w1hi, w1lo = split_tf32(op["w"].reshape(3 * c, c // 2).contiguous())
            w2hi, w2lo = split_tf32(nxt["w"].reshape(c // 2, c).contiguous())
            launch = {"kind": "resblock", "c": c, "final": final, "w1hi": w1hi, "w1lo": w1lo,
                      "b1": op["b"], "w2hi": w2hi, "w2lo": w2lo, "b2": nxt["b"],
                      "wf": None, "bf": None}
            if final:
                launch["wf"] = last["w"].reshape(3 * c).contiguous()
                launch["bf"] = last["b"].reshape(1).contiguous()
            out.append(launch)
            i += 3 if final else 2
        else:
            out.append(_k3_conv(op, bool(op["residual"])))
            i += 1
    return out


def _start_table(ops: List[Dict[str, Any]], cfg: MimiConfig) -> torch.Tensor:
    """Row s0 -> each op's first input row at or after the stream's start,
    valid mode: a conv's output row c ends at input row c + (taps-1)*dil,
    a transpose conv's block m at input row m + 1."""
    rows = []
    for s0 in range(required_halo(cfg) + 1):
        s, row = s0, []
        for op in ops:
            row.append(s)
            taps = op["w"].shape[-3]
            if op["phases"] > 1:
                s = max(0, s - 1) * op["phases"]
            else:
                s = max(0, s - (taps - 1) * op["dil"])
        rows.append(row)
    return torch.tensor(rows, dtype=torch.int32, device=ops[0]["w"].device)


def _op_shape(op: Dict[str, Any], cin: int):
    """(taps, Cout) of a packed conv; raises if its input width differs."""
    w = op["w"]
    taps, wcin, cout = w.shape[-3:]
    if wcin != cin:
        raise ValueError(f"seanet kernel: input has {cin} channels, weight {wcin}")
    return int(taps), int(cout)


def _conv_cuda(launch: Dict[str, Any], x: torch.Tensor, residual) -> torch.Tensor:
    """K3's causal tensor-core conv: y [B, T, N] from x [B, T, Cin], returned
    as [B, T * phases, N / phases] (a transpose's phase-major columns are
    its output rows)."""
    b, t, cin = x.shape
    if cin != launch["cin"]:
        raise ValueError(f"seanet kernel: input has {cin} channels, weight {launch['cin']}")
    y = torch.empty((b, t, launch["n"]), dtype=torch.float32, device=x.device)
    fn = kernels.lib("seanet").sopro_seanet_conv_tc
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(
        kernels.ptr(x), kernels.ptr(launch["hi"]), kernels.ptr(launch["lo"]),
        kernels.ptr(launch["b"]), None if residual is None else kernels.ptr(residual),
        kernels.ptr(y), b, t, cin, int(launch["hi"].shape[1]), launch["n"],
        int(launch["hi"].shape[2]), launch["taps"], launch["dil"], int(launch["elu_in"]),
        kernels.stream_ptr(x.device),
    )
    kernels.check(rc, "seanet")
    return y.view(b, t * launch["phases"], launch["n"] // launch["phases"])


def _resblock_cuda(launch: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """K3's fused residual block: [B, T, C] -> [B, T, C], or -> wav [B, T]
    when it carries the final conv."""
    b, t, c = x.shape
    if c != launch["c"]:
        raise ValueError(f"seanet kernel: input has {c} channels, block {launch['c']}")
    y = torch.empty((b, t) if launch["final"] else (b, t, c), dtype=torch.float32, device=x.device)
    fn = kernels.lib("seanet").sopro_seanet_resblock
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    opt = (lambda k: None if launch[k] is None else kernels.ptr(launch[k]))
    rc = fn(
        kernels.ptr(x), kernels.ptr(launch["w1hi"]), kernels.ptr(launch["w1lo"]),
        kernels.ptr(launch["b1"]), kernels.ptr(launch["w2hi"]), kernels.ptr(launch["w2lo"]),
        kernels.ptr(launch["b2"]), opt("wf"), opt("bf"), kernels.ptr(y), b, t, c,
        int(launch["final"]), kernels.stream_ptr(x.device),
    )
    kernels.check(rc, "seanet")
    return y


def run_k3(launches: List[Dict[str, Any]], emb: torch.Tensor) -> torch.Tensor:
    """K3's launches in order over emb [B, T, H] (CUDA) -> wav [B, T * hop]."""
    x = emb.contiguous()
    block_in = None
    for launch in launches:
        if launch["kind"] == "resblock":
            x = _resblock_cuda(launch, x)
        elif launch["residual"]:
            x = _conv_cuda(launch, x, block_in)
        else:
            block_in = x
            x = _conv_cuda(launch, x, None)
    return x if x.dim() == 2 else x[..., 0]


def _conv_valid_cuda(
    op: Dict[str, Any], x: torch.Tensor, residual, start: Optional[torch.Tensor],
    keep: Optional[int] = None,
) -> torch.Tensor:
    """K4's valid-mode conv: output row t reads input rows t + j*dil, so
    T_in - (taps-1)*dil rows come out (times the phase count); `keep` writes
    only the last `keep` of them. A residual adds the block input's last
    rows (those its convs consumed the rows before of). `start` [B] (a
    column of the start table, or None): input rows before it read as 0."""
    b, t_in, cin = x.shape
    taps, cout = _op_shape(op, cin)
    phases, dil = int(op["phases"]), int(op["dil"])
    t_valid = t_in - (taps - 1) * dil
    t_out = t_valid if keep is None else int(keep)
    if t_out <= 0 or t_out > t_valid:
        raise ValueError(f"seanet_decode_chunk: {t_in} input rows give {t_valid} valid rows, "
                         f"{t_out} asked for")
    res_t = 0 if residual is None else int(residual.shape[1])
    y = torch.empty((b, t_out * phases, cout), dtype=torch.float32, device=x.device)
    fn = kernels.lib("seanet").sopro_seanet_conv_valid
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(
        kernels.ptr(x), kernels.ptr(op["w"]), kernels.ptr(op["b"]),
        None if residual is None else kernels.ptr(residual), kernels.ptr(y),
        b, t_in, t_out, t_valid - t_out, cin, cout, taps, dil, int(op["elu_in"]), phases,
        res_t, res_t - t_out, None if start is None else kernels.ptr(start),
        0 if start is None else int(start.stride(0)), kernels.stream_ptr(x.device),
    )
    kernels.check(rc, "seanet_chunk")
    return y


def _check_cuda_inputs(name: str, packed: Dict[str, Any], x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"{name}: input must be float32 [B, T, H]")
    for op in packed["ops"]:
        if op["w"].device != x.device or op["w"].dtype != torch.float32:
            raise ValueError(f"{name}: weights must be float32 on the input's device")


def seanet_decode(packed: Dict[str, Any], cfg: MimiConfig, emb: torch.Tensor) -> torch.Tensor:
    """emb [B, T25, H] -> wav [B, T25 * prod(upsampling_ratios)]: the kernel
    on CUDA tensors, `seanet_apply` on CPU tensors."""
    if emb.device.type == "cpu":
        return seanet_apply(packed["params"], decoder_plan(cfg), emb)[..., 0]
    _check_cuda_inputs("seanet_decode", packed, emb)
    wav = run_k3(packed["k3"], emb)
    kernels.LAUNCHES["seanet"] += 1
    return wav


def seanet_decode_chunk_plain(
    params: List[Dict], cfg: MimiConfig, ext: torch.Tensor, n_hist: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K4's plain version: the last m25 * hop25 samples of `seanet_apply`
    over ext, per batch row over ext[b, halo - n_hist[b]:] when given."""
    n_out = (ext.shape[1] - required_halo(cfg)) * math.prod(int(r) for r in cfg.upsampling_ratios)
    plan = decoder_plan(cfg)
    if n_hist is None:
        return seanet_apply(params, plan, ext)[:, -n_out:, 0]
    first = required_halo(cfg) - torch.clamp(n_hist, 0, required_halo(cfg))
    return torch.cat([seanet_apply(params, plan, ext[i:i + 1, s0:])[:, -n_out:, 0]
                      for i, s0 in enumerate(first.tolist())])


def seanet_decode_chunk(
    packed: Dict[str, Any], cfg: MimiConfig, ext: torch.Tensor,
    n_hist: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ext [B, halo + m25, H] (`halo` = required_halo(cfg) frames of left
    context, then the chunk) -> the chunk's wav [B, m25 * hop25]: the
    valid-mode kernel on CUDA tensors, `seanet_decode_chunk_plain` on CPU
    tensors. `n_hist` [B] int: how many of the halo rows are real (the rest
    precede the stream's start); None: all of them."""
    halo = required_halo(cfg)
    n_out = (ext.shape[1] - halo) * math.prod(int(r) for r in cfg.upsampling_ratios)
    if n_out <= 0:
        raise ValueError(f"seanet_decode_chunk: ext has {ext.shape[1]} frames, "
                         f"needs more than the halo {halo}")
    if ext.device.type == "cpu":
        return seanet_decode_chunk_plain(packed["params"], cfg, ext, n_hist)
    _check_cuda_inputs("seanet_decode_chunk", packed, ext)
    starts = None
    if n_hist is not None:
        first = halo - torch.clamp(n_hist.to(ext.device).long(), 0, halo)
        starts = packed["start_table"][first]  # [B, n_ops]
    x = ext.contiguous()
    block_in = None
    ops = packed["ops"]
    for i, op in enumerate(ops):
        start = None if starts is None else starts[:, i]
        if op["residual"]:
            x = _conv_valid_cuda(op, x, block_in, start)
        else:
            block_in = x
            x = _conv_valid_cuda(op, x, None, start, keep=n_out if i == len(ops) - 1 else None)
    kernels.LAUNCHES["seanet_chunk"] += 1
    return x[..., 0]


def mimi_decode_with_slabs(
    p: Dict[str, Any], packed: Dict[str, Any], cfg: MimiConfig, codes_btq: torch.Tensor
) -> torch.Tensor:
    """codes [B, T, Q] -> wav [B, T*hop]: RVQ dequant, upsample and decoder
    transformer as plain ops, the SEANet through `seanet_decode`."""
    return seanet_decode(packed, cfg, decode_embeddings(p, cfg, codes_btq))
