"""SEANet decoder: kernels K3 and K4 and their plain versions.

K3 replaces sopro_tpu/codec/pallas_vocoder.py::seanet_decode_pallas (and its
`mimi_decode_with_slabs`): `seanet_decode` maps post-transformer embeddings
[B, T25, H] to a waveform [B, T25 * 960] from zero history. K4 replaces
`seanet_decode_pallas_chunk`: `seanet_decode_chunk` maps one streaming chunk
with its real left context, ext [B, halo + m25, H], to the chunk's waveform
[B, m25 * 960]. On CUDA tensors both run the same launch list of the
tensor-core kernels of `csrc/seanet.cu` (`run_launches`: a conv per conv of
stages 1-2 and per transpose, one fused kernel per residual block of the
128- and 64-channel stages, the last one with the final conv), K3 causally
and K4 in valid mode; on CPU tensors both run `mimi.seanet_apply` (K4
keeping the last m25 * 960 samples, which equal the valid-mode result
because the stack's receptive field is `halo` frames).

Early in a stream the history holds only `n_hist` < halo real frames; the
rows before them are no signal but the causal zero padding of every conv.
`seanet_decode_chunk` takes `n_hist` per batch row: the plain version then
decodes ext[b, halo - n_hist[b]:] causally, and the kernels read each
launch's input rows before the stream's start as zero (`start_table`).
Without it a zero history would carry the conv biases into the first chunk.

Kernel layout (`pack_seanet_decoder`, once per device):
- "ops": the per-conv plan, each {"w": [taps, Cin, Cout] contiguous (a
  [taps*Cin, Cout] GEMM operand), "b", "dil", "phases", "elu_in",
  "residual"}. The plan's ELU layers fold into the next conv's `elu_in`; a
  transpose conv with k = 2s becomes `phases` = s two-tap convs, phase r
  using [w[s-1-r], w[2s-1-r]] and writing rows m*s + r; a residual block is
  a k3 conv into a hidden buffer and a k1 conv that adds the block input.
  The bounds and the start table are computed from it.
- "k3": the launch list of K3 and K4. {"kind": "conv", "op", "hi", "lo":
  [taps, np, cinp] (the TF32 split of the weight, K-major -- each tap's
  [Cin, N] transposed, the reduction index contiguous, as `wgmma` reads a
  TF32 operand -- zero-padded to cinp = Cin rounded up to 32 and np = N
  rounded up to 128; for bfloat16 weights "hi" is the weight itself and
  "lo" None), "b" [N], "taps", "dil", "elu_in", "elu_out", "cin", "cinp",
  "n", "np", "phases", "residual"}: a transpose conv is one
  two-tap conv with N = s * Cout, column r * Cout + c holding phase r, its
  bias repeated s times. {"kind": "resblock", "op", "c", "final", "w1hi",
  "w1lo" [3 * C/2, C] (K-major), "b1", "w2hi", "w2lo" [C, C/2] (K-major,
  K in `resblock_k_order`), "b2", "wf" [3C], "bf" [1]}: a residual block of
  C = 128 or 64 channels (k3 dilation 1), with the final ELU + k3 conv to
  one channel when "final" (C = 64 only; wf and bf, in the
  weights' dtype, are then that conv's; bfloat16: "w1hi" / "w2hi" the
  weights, "w1lo" / "w2lo" None). "op": the launch's first op in "ops".
  Where a launch's output is read only through the next conv's ELU (the k7
  conv, the residual convs of stages 1-2, the stage-3 fused block), the
  launch applies the ELU in its epilogue ("elu_out") and the conv reads its
  input as it is ("elu_in" False): the ELU runs once per element, not once
  per column tile of the next conv.

The weights' dtype is the codec's (float32, or bfloat16 under the bf16
compute policy); the kernels take activations of the same dtype and the
bfloat16 instantiations round where the TPU kernel does (csrc/seanet.cu).
- "start_table" [halo + 1, n_ops] int32: for a chunk whose history starts
  at ext row s0, row s0 holds the first input row of each op that lies at
  or after the stream's start.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from sopro_tpu_torch import kernels
from sopro_tpu_torch.codec.mimi import decode_embeddings, seanet_apply
from sopro_tpu_torch.codec.mimi_config import (
    CONV, CONVT, ELU, RESNET, MimiConfig, decoder_plan, required_halo,
)
from sopro_tpu_torch.ops.tf32x3 import split_tf32

CIN_MULTIPLE, N_MULTIPLE = 32, 128  # K3 conv kernels: Cin chunks, column tiles
# the fused K3 residual-block kernel: width C -> rows of hidden per time tile
# (csrc/seanet.cu kWgBM; a tile with the final conv writes 2 fewer)
RESBLOCK_TILE_ROWS = {128: 128, 64: 128}


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
    padded = torch.zeros((taps, np_, cinp), dtype=w.dtype, device=w.device)
    padded[:, :n, :cin] = w.transpose(1, 2)
    hi, lo = _split(padded)
    return {"kind": "conv", "hi": hi, "lo": lo, "b": op["b"].repeat(phases).contiguous(),
            "taps": int(taps), "dil": int(op["dil"]), "elu_in": bool(op["elu_in"]),
            "elu_out": False, "cin": int(cin), "cinp": cinp, "n": int(n), "np": np_,
            "phases": phases, "residual": residual}


def _split(w: torch.Tensor):
    """The kernels' weight operand: (hi, lo), the TF32 split of a float32
    weight, or (w, None) for a bfloat16 one (exact in TF32)."""
    if w.dtype == torch.bfloat16:
        return w.contiguous(), None
    return split_tf32(w)


def resblock_k_order(h: int, dtype) -> torch.Tensor:
    """The fused block's k1-conv K order: float32 feeds the hidden's
    accumulator fragment (columns 2q and 2q + 1 of each 8-column block) as
    the k positions q and q + 4 of a TF32 k8 step, so within each block of 8
    the packed K columns are hidden channels 0, 2, 4, 6, 1, 3, 5, 7; bfloat16
    fragments pair columns as they are (the identity)."""
    if dtype == torch.bfloat16:
        return torch.arange(h)
    block = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    return (torch.arange(0, h, 8)[:, None] + block[None, :]).reshape(-1)


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
            final = (c == 64 and last is not None and tuple(last["w"].shape) == (3, c, 1)
                     and int(last["dil"]) == 1 and last["elu_in"] and int(last["phases"]) == 1)
            # K-major: w1 [3, C/2, C] (tap j's [C, C/2] transposed), w2 [C, C/2] with
            # its K columns in the order the kernel's hidden fragment takes them
            w1hi, w1lo = _split(op["w"].transpose(1, 2).reshape(3 * (c // 2), c).contiguous())
            w2 = nxt["w"][0].t()[:, resblock_k_order(c // 2, nxt["w"].dtype)]
            w2hi, w2lo = _split(w2.contiguous())
            launch = {"kind": "resblock", "op": i, "c": c, "final": final, "elu_out": False,
                      "w1hi": w1hi, "w1lo": w1lo, "b1": op["b"], "w2hi": w2hi, "w2lo": w2lo,
                      "b2": nxt["b"], "wf": None, "bf": None}
            if final:
                launch["wf"] = last["w"].reshape(3 * c).contiguous()
                launch["bf"] = last["b"].reshape(1).contiguous()
            out.append(launch)
            i += 3 if final else 2
        else:
            out.append(dict(_k3_conv(op, bool(op["residual"])), op=i))
            i += 1
    for k, (cur, nxt) in enumerate(zip(out, out[1:])):
        # the next conv's input is kept raw only as a residual block's input
        raw = k + 2 < len(out) and out[k + 2]["kind"] == "conv" and out[k + 2]["residual"]
        if not cur.get("final") and nxt["kind"] == "conv" and nxt["elu_in"] and not raw:
            cur["elu_out"], nxt["elu_in"] = True, False
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


_C_PTR, _C_INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "sopro_seanet_conv_tc": [_C_PTR] * 6 + [_C_INT] * 11 + [_C_PTR, _C_INT, _C_INT, _C_PTR],
    "sopro_seanet_resblock": [_C_PTR] * 10 + [_C_INT] * 5 + [_C_PTR, _C_INT, _C_PTR],
}
MAX_SPLITS = 16  # csrc/seanet.cu kMaxSplits: a short conv splits Cin over up to 16 blocks


def _entry(name: str, dtype):
    """C entry point `name` of seanet.cu, its bfloat16 instantiation for
    bfloat16 tensors."""
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    return kernels.entry("seanet", name + suffix, _ARGTYPES[name])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _start_arg(start: Optional[torch.Tensor]):
    return (None, 0) if start is None else (start.data_ptr(), int(start.stride(0)))


def _conv_cuda(launch: Dict[str, Any], x: torch.Tensor, residual, start=None, t_out=None,
               max_splits: int = MAX_SPLITS, stream=None) -> torch.Tensor:
    """One tensor-core conv launch: y [B, t_out, N] from x [B, T_in, Cin],
    output row t the causal conv at input row T_in - t_out + t (K3: t_out =
    T_in); input rows before `start` [B] (a column of the start table; None:
    row 0) read as zero; a residual adds its last t_out rows. Returned as
    [B, t_out * phases, N / phases] (a transpose's phase-major columns are
    its output rows). `stream`: the ctypes handle of x's device's current
    stream, passed inside `kernels.on_device(x.device)` (None: entered
    here)."""
    if stream is None:
        with kernels.on_device(x.device) as s:
            return _conv_cuda(launch, x, residual, start, t_out, max_splits, s)
    b, t_in, cin = x.shape
    t_out = t_in if t_out is None else int(t_out)
    if cin != launch["cin"]:
        raise ValueError(f"seanet kernel: input has {cin} channels, weight {launch['cin']}")
    per_row = 16 // x.element_size()  # TMA reads x in rows of a multiple of 16 bytes
    if cin % per_row:  # only narrow test configurations; the weights' padding is zero
        cin = -(-cin // per_row) * per_row
        x = F.pad(x, (0, cin - x.shape[2]))
    y = torch.empty((b, t_out, launch["n"]), dtype=x.dtype, device=x.device)
    rc = _entry("sopro_seanet_conv_tc", x.dtype)(
        x.data_ptr(), launch["hi"].data_ptr(), _ptr(launch["lo"]), launch["b"].data_ptr(),
        _ptr(residual), y.data_ptr(), b, t_in, t_out,
        0 if residual is None else int(residual.shape[1]), cin, launch["cinp"],
        launch["n"], launch["np"], launch["taps"], launch["dil"],
        int(launch["elu_in"]) | 2 * int(launch["elu_out"]), *_start_arg(start), max_splits, stream,
    )
    kernels.check(rc, "seanet")
    return y.view(b, t_out * launch["phases"], launch["n"] // launch["phases"])


def _resblock_cuda(launch: Dict[str, Any], x: torch.Tensor, start=None, t_out=None,
                   stream=None) -> torch.Tensor:
    """The fused residual block: [B, T_in, C] -> [B, t_out, C], or -> wav
    [B, t_out] when it carries the final conv; output row t the causal
    result at input row T_in - t_out + t, input rows (and the final conv's
    input rows) before `start` zero. `stream` as for `_conv_cuda`."""
    if stream is None:
        with kernels.on_device(x.device) as s:
            return _resblock_cuda(launch, x, start, t_out, s)
    b, t_in, c = x.shape
    t_out = t_in if t_out is None else int(t_out)
    if c != launch["c"]:
        raise ValueError(f"seanet kernel: input has {c} channels, block {launch['c']}")
    y = torch.empty((b, t_out) if launch["final"] else (b, t_out, c), dtype=x.dtype,
                    device=x.device)
    opt = (lambda k: _ptr(launch[k]))
    rc = _entry("sopro_seanet_resblock", x.dtype)(
        x.data_ptr(), launch["w1hi"].data_ptr(), opt("w1lo"),
        launch["b1"].data_ptr(), launch["w2hi"].data_ptr(), opt("w2lo"),
        launch["b2"].data_ptr(), opt("wf"), opt("bf"), y.data_ptr(), b, t_in, t_out, c,
        int(launch["final"]) | 2 * int(launch["elu_out"]), *_start_arg(start), stream,
    )
    kernels.check(rc, "seanet")
    return y


def valid_rows(launch: Dict[str, Any], t_in: int) -> int:
    """Output rows of a launch in valid mode: its input rows less its
    receptive field (a fused block: the k3 conv's 2, and the final conv's 2)."""
    if launch["kind"] == "resblock":
        return t_in - (4 if launch["final"] else 2)
    return t_in - (launch["taps"] - 1) * launch["dil"]


def run_launches(launches: List[Dict[str, Any]], x: torch.Tensor,
                 starts: Optional[torch.Tensor] = None, keep: Optional[int] = None,
                 valid: bool = False) -> torch.Tensor:
    """The launch list in order over x [B, T, H] (CUDA) -> wav. K3: causal
    (every launch keeps the length). K4 (`valid`): every launch shrinks by
    its receptive field, launch i reads rows before starts[:, launch "op"]
    as zero, and the last one writes only its last `keep` rows."""
    x, block_in = x.contiguous(), None
    with kernels.on_device(x.device) as stream:
        for i, launch in enumerate(launches):
            start = None if starts is None else starts[:, launch["op"]]
            t_out = None
            if valid:
                t_out = valid_rows(launch, int(x.shape[1]))
                if keep is not None and i == len(launches) - 1:
                    if not 0 < keep <= t_out or launch.get("phases", 1) != 1:
                        raise ValueError(f"seanet_decode_chunk: {t_out} valid rows, {keep} asked for")
                    t_out = keep
            if launch["kind"] == "resblock":
                x = _resblock_cuda(launch, x, start, t_out, stream)
            elif launch["residual"]:
                x = _conv_cuda(launch, x, block_in, start, t_out, MAX_SPLITS, stream)
            else:
                block_in = x
                x = _conv_cuda(launch, x, None, start, t_out, MAX_SPLITS, stream)
    return x if x.dim() == 2 else x[..., 0]


def _check_cuda_inputs(name: str, packed: Dict[str, Any], x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 3:
        raise ValueError(f"{name}: input must be float32 or bfloat16 [B, T, H]")
    for op in packed["ops"]:
        if op["w"].device != x.device or op["w"].dtype != x.dtype:
            raise ValueError(f"{name}: weights must be {x.dtype} on the input's device")


def seanet_decode(packed: Dict[str, Any], cfg: MimiConfig, emb: torch.Tensor) -> torch.Tensor:
    """emb [B, T25, H] -> wav [B, T25 * prod(upsampling_ratios)]: the kernel
    on CUDA tensors, `seanet_apply` on CPU tensors."""
    if emb.device.type == "cpu":
        return seanet_apply(packed["params"], decoder_plan(cfg), emb)[..., 0]
    _check_cuda_inputs("seanet_decode", packed, emb)
    wav = run_launches(packed["k3"], emb)
    kernels.count("seanet", emb.dtype)
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


def chunk_starts(packed: Dict[str, Any], cfg: MimiConfig, n_hist: Optional[torch.Tensor],
                 device) -> Optional[torch.Tensor]:
    """[B, n_ops] int32: each op's first input row at or after the stream's
    start, for `n_hist` real history rows per batch row (None: all real)."""
    if n_hist is None:
        return None
    halo = required_halo(cfg)
    first = halo - torch.clamp(n_hist.to(device).long(), 0, halo)
    return packed["start_table"][first]


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
    wav = run_launches(packed["k3"], ext, chunk_starts(packed, cfg, n_hist, ext.device),
                       keep=n_out, valid=True)
    kernels.count("seanet_chunk", ext.dtype)
    return wav


def mimi_decode_with_slabs(
    p: Dict[str, Any], packed: Dict[str, Any], cfg: MimiConfig, codes_btq: torch.Tensor
) -> torch.Tensor:
    """codes [B, T, Q] -> wav [B, T*hop]: RVQ dequant, upsample and decoder
    transformer as plain ops, the SEANet through `seanet_decode`."""
    return seanet_decode(packed, cfg, decode_embeddings(p, cfg, codes_btq))
