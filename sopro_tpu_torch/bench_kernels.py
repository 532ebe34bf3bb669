"""Per-stage timing of kernel K2, per-launch timing of kernels K3 and K4,
in float32 and bfloat16, and (with `--old-src`) the same kernels of an older
`csrc/` beside them, plus K1 and K5 as `bench_ar` compares them, on one
NVIDIA GPU, beside the library calls for the same work and the bounds.

    python -m sopro_tpu_torch.bench_kernels [--old-src DIR] [--out PATH]

Full Sopro v1.5 and Mimi widths, random weights from a numpy seed, TF32 off,
CUDA-event medians with warm caches. K2 at 6, 187, 401 and 1,604 rows per
stage: this tree's kernel, the older one and einsum + argmax. K3 at B = 1
and 4: cuDNN (`F.conv1d` / `F.conv_transpose1d`, the conv alone) per conv
of the decoder plan, this tree's and the older kernels per launch, the whole
stack. K4 at chunks of 6 and 16 AR frames (ext of 8 + 12 and 8 + 32 rows,
B = 1 and 2): both trees' launches one by one and whole, the plain version
and the cuDNN stack. An older `csrc/` (from before K2 and K3's conv moved
to `wgmma`) takes row-major packs ([H, kp, vp] and [taps, cinp, np]):
`old_pack` transposes this tree's K-major ones, and its libraries are built
with this tree's nvcc flags and swapped in for the wrappers' (`swapped`).
bfloat16: the same shapes with the weights and inputs cast. Bounds per row:
FLOP over 67 TFLOP/s (fp32 CUDA cores) and three times the FLOP over
495 TFLOP/s (3-pass TF32 tensor cores), bytes (inputs read once, output
written once) over 3.35 TB/s. `bound(..., bf16=True)` is the bound of a
kernel's bfloat16 instantiation: its bytes at 2 bytes an element, its
products (bfloat16 operands, float32 accumulation) over the card's
989 TFLOP/s bfloat16 tensor-core rate, K1 / K5 included; `design_bound_ms`
keeps the ceiling of the design the kernels took (K2-K4: bfloat16 `wgmma`,
the same; K1 / K5: fp32 FMAs on widened bfloat16 weights at the CUDA-core
rate). `nar_library`
is K2's library yardstick in either dtype (einsum + argmax in the inputs'
dtype; timed only, the port never calls it). Prints tables and writes them
as JSON to PATH (default build/bench_kernels.json).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from sopro_tpu_torch import kernels

PEAK_FP32, PEAK_TF32, PEAK_BF16, HBM = 67e12, 495e12, 989e12, 3.35e12
NAR_ROWS = (6, 187, 401, 1604)


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bounds(flop: float, nbytes: float) -> dict:
    return {"gflop": flop / 1e9, "mbytes": nbytes / 1e6, "fp32_ms": flop / PEAK_FP32 * 1e3,
            "tf32x3_ms": 3 * flop / PEAK_TF32 * 1e3, "bytes_ms": nbytes / HBM * 1e3}


def bound(flop: float, nbytes: float, tf32x3: bool, bf16: bool = False) -> dict:
    """The least time the card could take (ms): the larger of the bytes over
    HBM's rate and the operations over the card's peak rate for their type.
    Float32 (`bf16` false): 3xTF32 on the tensor cores where the kernel uses
    them (`tf32x3`), else the fp32 CUDA cores. Bfloat16: the 989 TFLOP/s
    bfloat16 tensor-core rate whatever the design, whose own ceiling (the
    bfloat16 tensor cores themselves for the `wgmma` kernels, the fp32 cores
    where not `tf32x3`) is `design_bound_ms`.
    `nbytes` counts the instantiation's own element size. `fp32_bound_ms`
    keeps the CUDA-core bound beside it."""
    b = bounds(flop, nbytes)
    if bf16:
        ops_ms, rate = flop / PEAK_BF16 * 1e3, "bf16 tensor cores"
        design_ms = ops_ms if tf32x3 else b["fp32_ms"]
    else:
        ops_ms, rate = ((b["tf32x3_ms"], "3xTF32 tensor cores") if tf32x3
                        else (b["fp32_ms"], "fp32 cores"))
    by_ops = ops_ms >= b["bytes_ms"]
    out = {"bound_ms": max(ops_ms, b["bytes_ms"]), "bound_by": "operations" if by_ops else "bytes",
           "bound_rate": rate if by_ops else "HBM",
           "fp32_bound_ms": max(b["fp32_ms"], b["bytes_ms"])}
    if bf16:
        out["design_bound_ms"] = max(design_ms, b["bytes_ms"])
    return out


def nar_cost(rows: int, h: int, hd: int, v: int, es: int = 4):
    """(FLOP, bytes) of one K2 stage: the products, and z, hid, W, b read
    (`es` bytes an element) and the int32 ids written once."""
    return (2.0 * rows * h * hd * v,
            es * (rows * hd + h * hd + h * hd * v + h * v) + 4.0 * rows * h)


def nar_library(z: torch.Tensor, hid: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """K2's library yardstick: the head product as one einsum in the inputs'
    dtype (cuBLAS; bfloat16 with float32 accumulation under
    `configure_cuda_numerics`), the bias, and argmax."""
    zh = z[:, :, None, :] + hid[None, None]
    return torch.argmax(torch.einsum("bthd,hdv->bthv", zh, w) + b[None, None], dim=-1)


def conv_stack_cost(ops, b: int, t_in: int, causal: bool, keep=None):
    """(FLOP, bytes) of the SEANet over b rows of t_in frames, from the
    per-conv ops (`pack_seanet_decoder(...)["ops"]`): causal convs keep the
    length, valid ones shrink by the receptive field, and the last conv
    computes only `keep` rows when given. Bytes: the embeddings and the
    weights read, the waveform written, at the weights' element size."""
    flop, t, cin0 = 0.0, t_in, int(ops[0]["w"].shape[-2])
    for i, op in enumerate(ops):
        taps, cin, cout = (int(s) for s in op["w"].shape[-3:])
        t_out = t if causal else t - (taps - 1) * int(op["dil"])
        if keep is not None and i == len(ops) - 1:
            t_out = keep
        flop += 2.0 * b * t_out * int(op["phases"]) * taps * cin * cout
        t = t_out * int(op["phases"])
    weights = sum(op["w"].numel() + op["b"].numel() for op in ops)
    return flop, float(ops[0]["w"].element_size()) * (b * t_in * cin0 + weights + b * t)


def ar_cost(stacked, kv_k, steps: int, rows: int):
    """(FLOP, bytes) of `steps` AR steps of `rows` rows on the kernel's
    stacked weights: each weight element one multiply-add per row and step,
    the text attention 4 L D per attention layer; the weights and the text
    KV read once, at their element size."""
    weights = sum(t.numel() for t in stacked.values())
    a, _, heads, l_txt, hd = kv_k.shape
    flop = 2.0 * steps * rows * (weights + 2 * a * l_txt * heads * hd)
    return flop, float(kv_k.element_size()) * (weights + 2 * kv_k.numel())


def seanet_library_weights(params, plan):
    """The decoder's weights in cuDNN's layouts, for `seanet_library`."""
    from sopro_tpu_torch.codec.mimi_config import CONV, CONVT, RESNET

    def conv(p, spec):
        return {"w": p["w"].permute(2, 1, 0).contiguous(), "b": p["b"],
                "pad": (int(spec["k"]) - 1) * int(spec["dilation"]), "dil": int(spec["dilation"])}

    out = []
    for p, (kind, spec) in zip(params, plan):
        if kind == CONV:
            out.append((kind, conv(p, spec)))
        elif kind == CONVT:  # y[i*s + j] += x[i] w[2s-1-j]: the kernel flipped
            out.append((kind, {"w": p["w"].flip(0).permute(1, 2, 0).contiguous(), "b": p["b"],
                               "s": int(spec["stride"])}))
        elif kind == RESNET:
            out.append((kind, [conv(cp, cs) for cp, cs in zip(p["convs"], spec["convs"])]))
        else:
            out.append((kind, None))
    return out


def seanet_library(lib_weights, x: torch.Tensor) -> torch.Tensor:
    """The SEANet as library calls, causal, over x [B, T, H] -> wav [B, T*hop]:
    one cuDNN `F.conv1d` (left-padded) or `F.conv_transpose1d` (its first
    T*s rows) per conv, with the bias, ELU and residual adds between them.
    The yardstick `library_ms` of K3 and K4; the port never calls it."""
    from sopro_tpu_torch.codec.mimi_config import CONV, CONVT, ELU, RESNET

    def conv(c, h):
        return F.conv1d(F.pad(h, (c["pad"], 0)), c["w"], c["b"], dilation=c["dil"])

    h = x.transpose(1, 2)
    for kind, c in lib_weights:
        if kind == CONV:
            h = conv(c, h)
        elif kind == CONVT:
            h = F.conv_transpose1d(h, c["w"], c["b"], stride=c["s"])[..., : h.shape[-1] * c["s"]]
        elif kind == RESNET:
            r = h
            for cc in c:
                r = conv(cc, F.elu(r))
            h = h + r
        elif kind == ELU:
            h = F.elu(h)
    return h[:, 0]


def old_lib(src_dir: Path, name: str) -> ctypes.CDLL:
    """Build `src_dir/name.cu` with this tree's nvcc flags (cached by hash)."""
    src = Path(src_dir) / f"{name}.cu"
    h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for f in [src] + sorted(Path(src_dir).glob("*.cuh")):
        h.update(f.read_bytes())
    out = kernels.BUILD_DIR.parent / "kernels_old" / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True)
    return ctypes.CDLL(str(out))


@contextlib.contextmanager
def swapped(name: str, lib):
    """The wrappers launch `lib` (an older build of source `name`) inside."""
    if lib is None:
        yield
        return
    saved = kernels.lib(name)
    kernels._LIBS[name] = lib
    try:
        yield
    finally:
        kernels._LIBS[name] = saved


def old_pack(packed):
    """This tree's K-major packs in the older sources' layouts: a K2 pack
    {"hi", "lo"} [H, vp, kp] -> row-major [H, kp, vp]; a K3 pack -> its
    launch list with each conv's hi / lo [taps, np, cinp] -> [taps, cinp,
    np] and the ELU back on the input of the conv that reads it (the older
    kernels have no ELU on the output), each fused block's w1 [3 * C/2, C]
    -> [3C, C/2] and w2 [C, C/2] (K in `resblock_k_order`) -> [C/2, C]."""
    from sopro_tpu_torch.codec.vocoder import resblock_k_order

    t = (lambda x: None if x is None else x.transpose(-1, -2).contiguous())
    if "k3" not in packed:
        return {k: t(v) for k, v in packed.items()}
    out = []
    for x in packed["k3"]:
        if x["kind"] == "conv":
            out.append(dict(x, hi=t(x["hi"]), lo=t(x["lo"]), elu_out=False,
                            elu_in=bool(packed["ops"][x["op"]]["elu_in"])))
            continue
        c, h = x["c"], x["c"] // 2
        back = torch.argsort(resblock_k_order(h, x["w2hi"].dtype))
        w1 = (lambda w: None if w is None else w.reshape(3, h, c).transpose(1, 2).reshape(3 * c, h).contiguous())
        w2 = (lambda w: None if w is None else w[:, back].t().contiguous())
        out.append(dict(x, w1hi=w1(x["w1hi"]), w1lo=w1(x["w1lo"]), w2hi=w2(x["w2hi"]),
                        w2lo=w2(x["w2lo"]), elu_out=False))
    return out


def nar_old(lib, z, hid, b, packed_old):
    """An older nar_heads.cu's entry point on its row-major pack."""
    bf16 = z.dtype == torch.bfloat16
    fn = getattr(lib, "sopro_nar_heads_argmax" + ("_bf16" if bf16 else ""))
    fn.argtypes = [ctypes.c_void_p] * (5 if bf16 else 6) + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    h, kp, vp = packed_old["hi"].shape
    out = torch.empty(tuple(z.shape[:2]) + (h,), dtype=torch.int32, device=z.device)
    ptrs = [z, hid, packed_old["hi"]] + ([] if bf16 else [packed_old["lo"]]) + [b, out]
    with kernels.on_device(z.device) as stream:
        rc = fn(*[kernels.ptr(x) for x in ptrs], int(z.shape[0] * z.shape[1]), h, int(z.shape[2]),
                kp, int(b.shape[1]), vp, stream)
    kernels.check(rc, "nar_heads (old)")
    return out


def bench_nar(model, dev, rng, old, dtype) -> list:
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, nar_heads_argmax_plain, pack_nar_heads

    es = torch.finfo(dtype).bits // 8
    rows_out = []
    for rows in NAR_ROWS:
        for stage, stack in model.nar.head_stacks().items():
            hid, w, b = (x.to(dtype) for x in stack[:3])
            packed = stack[3] if dtype == torch.float32 else pack_nar_heads(w)
            h, hd, v = w.shape
            z = torch.from_numpy(rng.standard_normal((1, rows, hd)).astype(np.float32)).to(dev, dtype)
            flop, nbytes = nar_cost(rows, h, hd, v, es)
            row = {"rows": rows, "stage": stage, "H": h, **bounds(flop, nbytes),
                   **bound(flop, nbytes, tf32x3=True, bf16=dtype == torch.bfloat16),
                   "library_ms": cuda_ms(lambda: nar_library(z, hid, w, b)),
                   "ms": cuda_ms(lambda: nar_heads_argmax(z, hid, w, b, packed))}
            want = nar_heads_argmax_plain(z, hid, w, b)
            row["ids_differ"] = int((nar_heads_argmax(z, hid, w, b, packed) != want).sum())
            if old is not None:
                po = old_pack(packed)
                row["old_ms"] = cuda_ms(lambda: nar_old(old, z, hid, b, po))
                row["old_ids_differ"] = int((nar_old(old, z, hid, b, po) != want).sum())
            rows_out.append(row)
    return rows_out


def _library_calls(params, cfg):
    """One cuDNN call per conv of the decoder plan, in the per-conv plan's
    order: (name, its weights as `seanet_library_weights` lays them out)."""
    from sopro_tpu_torch.codec.mimi_config import CONV, CONVT, RESNET, decoder_plan

    plan, calls = decoder_plan(cfg), []
    for (kind, spec), (_, c) in zip(plan, seanet_library_weights(params, plan)):
        if kind == CONV:
            calls.append((f"k{spec['k']} {spec['in']}->{spec['out']}", c))
        elif kind == CONVT:
            calls.append((f"x{spec['stride']} transpose {spec['in']}->{spec['out']}", c))
        elif kind == RESNET:
            calls += [(f"res k{cs['k']} {cs['in']}->{cs['out']}", cc)
                      for cs, cc in zip(spec["convs"], c)]
    return calls


def _decoder(mimi, dtype):
    """(decoder params, their pack) in `dtype`."""
    from sopro_tpu_torch.codec.vocoder import pack_seanet_decoder
    from sopro_tpu_torch.models.base import tree_map

    if dtype == torch.float32:
        return mimi.p["decoder"], mimi.packed_decoder()
    params = tree_map(lambda a: a.to(dtype) if torch.is_floating_point(a) else a, mimi.p["decoder"])
    return params, pack_seanet_decoder(params, mimi.cfg)


def bench_seanet(mimi, dev, rng, b: int, old, dtype) -> dict:
    from sopro_tpu_torch.codec.mimi import decode_embeddings, seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan
    from sopro_tpu_torch.codec.vocoder import run_launches, seanet_decode

    cfg = mimi.cfg
    bf16 = dtype == torch.bfloat16
    params, packed = _decoder(mimi, dtype)
    plan = decoder_plan(cfg)
    codes = torch.from_numpy(rng.integers(0, cfg.codebook_size, (b, 401, cfg.num_quantizers))).to(dev)
    out = {"B": b, "dtype": str(dtype).replace("torch.", ""), "convs": []}
    with torch.inference_mode():
        emb = decode_embeddings(mimi.p, cfg, codes).contiguous().to(dtype)
        if not bf16:  # cuDNN per conv of the plan, inputs from the plain stack
            inputs, x, block_in = [], emb, None
            for op in packed["ops"]:
                res = block_in if op["residual"] else None
                if not op["residual"]:
                    block_in = x
                inputs.append((x, res))
                x = _conv_plain(op, x, res)
            for (x, res), op, (name, c) in zip(inputs, packed["ops"], _library_calls(params, cfg)):
                bb, t, cin = x.shape
                taps, cout, ph = op["w"].shape[-3], op["w"].shape[-1], int(op["phases"])
                flop = 2.0 * bb * t * ph * taps * cin * cout
                nbytes = 4.0 * (x.numel() + op["w"].numel() + bb * t * ph * cout
                                * (2 if res is not None else 1))
                xt = (F.elu(x) if op["elu_in"] else x).transpose(1, 2).contiguous()
                if "s" in c:  # the conv alone, without its bias
                    lib = (lambda xt=xt, c=c: F.conv_transpose1d(xt, c["w"], stride=c["s"]))
                else:
                    xt = F.pad(xt, (c["pad"], 0))
                    lib = (lambda xt=xt, c=c: F.conv1d(xt, c["w"], dilation=c["dil"]))
                out["convs"].append({"conv": name, "M": bb * t, "N": ph * cout, "K": taps * cin,
                                     **bounds(flop, nbytes), "library_ms": cuda_ms(lib, 5)})
        out["launches"] = _bench_k3_launches(packed["k3"], emb)
        want = seanet_apply(params, plan, emb)[..., 0]
        out["plain_ms"] = cuda_ms(lambda: seanet_apply(params, plan, emb), 5)
        lib_w = seanet_library_weights(params, plan)
        out["library_ms"] = cuda_ms(lambda: seanet_library(lib_w, emb), 5)
        out["ms"] = cuda_ms(lambda: seanet_decode(packed, cfg, emb), 5)
        out.update(bound(*conv_stack_cost(packed["ops"], b, emb.shape[1], causal=True),
                         tf32x3=True, bf16=bf16))
        got = seanet_decode(packed, cfg, emb)
        out["err"] = _errors(got, emb, params, plan, want)
        if old is not None:
            launches_old = old_pack(packed)
            with swapped("seanet", old):
                old_rows = _bench_k3_launches(launches_old, emb)
                out["old_ms"] = cuda_ms(lambda: run_launches(launches_old, emb), 5)
                out["old_err"] = float((run_launches(launches_old, emb) - want).abs().max())
            for r, o in zip(out["launches"], old_rows):
                r["old_ms"] = o["ms"]
    return out


def _bench_k3_launches(launches, emb, valid: bool = False, keep=None, reps: int = 5) -> list:
    """K3 (or, `valid`, K4 keeping `keep` rows at the end), launch by launch
    (inputs from running the list), on the libraries the wrappers load."""
    from sopro_tpu_torch.codec.vocoder import MAX_SPLITS, _conv_cuda, _resblock_cuda, valid_rows

    rows, x, block_in = [], emb.contiguous(), None
    es = emb.element_size()
    for i, launch in enumerate(launches):
        t_out = None
        if valid:
            t_out = keep if keep is not None and i == len(launches) - 1 else valid_rows(launch, x.shape[1])
        m = x.shape[0] * (x.shape[1] if t_out is None else t_out)
        if launch["kind"] == "resblock":
            fn = (lambda x=x, launch=launch, t_out=t_out: _resblock_cuda(launch, x, None, t_out))
            c = launch["c"]
            flop = 2.0 * m * (3 * c * c // 2 + c // 2 * c + (3 * c if launch["final"] else 0))
            nbytes = es * (x.numel() + m * (1 if launch["final"] else c) + 2 * c * c)
            name = f"resblock {c}" + (" + final k3" if launch["final"] else "")
        else:
            res = block_in if launch["residual"] else None
            if not launch["residual"]:
                block_in = x
            fn = (lambda x=x, res=res, launch=launch, t_out=t_out:
                  _conv_cuda(launch, x, res, None, t_out, MAX_SPLITS))
            flop = 2.0 * m * launch["taps"] * launch["cin"] * launch["n"]
            nbytes = es * (x.numel() + m * launch["n"] * (2 if res is not None else 1)
                           + launch["taps"] * launch["cin"] * launch["n"])
            name = f"conv k{launch['taps']} {launch['cin']}->{launch['n']}"
        rows.append({"launch": name, "M": m, **bounds(flop, nbytes), "ms": cuda_ms(fn, reps)})
        x = fn()
    return rows


def bench_seanet_chunk(mimi, dev, rng, old, b: int, m25: int, dtype) -> dict:
    """K4 on ext [b, halo + m25, H] (full history): both trees' launches one
    by one and whole, the plain version and the cuDNN stack
    (`seanet_library`)."""
    from sopro_tpu_torch.codec.mimi import decode_embeddings
    from sopro_tpu_torch.codec.mimi_config import decoder_plan, required_halo
    from sopro_tpu_torch.codec.vocoder import seanet_decode_chunk, seanet_decode_chunk_plain

    cfg = mimi.cfg
    params, packed = _decoder(mimi, dtype)
    halo = required_halo(cfg)
    n_out = m25 * int(np.prod(cfg.upsampling_ratios))
    codes = torch.from_numpy(rng.integers(0, cfg.codebook_size,
                                          (b, -(-(halo + m25) // 2), cfg.num_quantizers))).to(dev)
    lib_w = seanet_library_weights(params, decoder_plan(cfg))
    out = {"B": b, "m25": m25, "dtype": str(dtype).replace("torch.", "")}
    with torch.inference_mode():
        ext = decode_embeddings(mimi.p, cfg, codes)[:, -(halo + m25):].contiguous().to(dtype)
        out["launches"] = _bench_k3_launches(packed["k3"], ext, valid=True, keep=n_out, reps=20)
        out["ms"] = cuda_ms(lambda: seanet_decode_chunk(packed, cfg, ext))
        out["plain_ms"] = cuda_ms(lambda: seanet_decode_chunk_plain(params, cfg, ext))
        out["library_ms"] = cuda_ms(lambda: seanet_library(lib_w, ext)[:, -n_out:])
        out.update(bound(*conv_stack_cost(packed["ops"], b, ext.shape[1], causal=False, keep=n_out),
                         tf32x3=True, bf16=dtype == torch.bfloat16))
        want = seanet_decode_chunk_plain(params, cfg, ext)
        out["err"] = float((seanet_decode_chunk(packed, cfg, ext) - want).abs().max())
        if old is not None:
            packed_old = dict(packed, k3=old_pack(packed))
            with swapped("seanet", old):
                old_rows = _bench_k3_launches(packed_old["k3"], ext, valid=True, keep=n_out, reps=20)
                out["old_ms"] = cuda_ms(lambda: seanet_decode_chunk(packed_old, cfg, ext))
                out["old_err"] = float((seanet_decode_chunk(packed_old, cfg, ext) - want).abs().max())
            for r, o in zip(out["launches"], old_rows):
                r["old_ms"] = o["ms"]
    return out


def _conv_plain(op, x, res):
    """One per-conv op in plain torch (the inputs of the next op)."""
    taps, ph, dil = op["w"].shape[-3], int(op["phases"]), int(op["dil"])
    xin = F.elu(x) if op["elu_in"] else x
    b, t, cin = x.shape
    w = op["w"].reshape(ph, taps, cin, -1)
    cols = [F.pad(xin, (0, 0, (taps - 1 - j) * dil, 0))[:, :t] for j in range(taps)]
    a = torch.cat(cols, dim=-1)  # [B, T, taps*Cin]
    y = torch.einsum("btk,pkn->btpn", a, w.reshape(ph, taps * cin, -1)).reshape(b, t * ph, -1)
    y = y + op["b"]
    return y if res is None else y + res


def _errors(got, emb, params, plan, want) -> dict:
    """max|err| against the float32 plain version and a float64 one, over peak."""
    from sopro_tpu_torch.codec.mimi import seanet_apply
    from sopro_tpu_torch.models.base import tree_map

    p64 = tree_map(lambda a: a.double() if torch.is_floating_point(a) else a, params)
    ref64 = seanet_apply(p64, plan, emb.double())[..., 0]
    peak = float(ref64.abs().max())
    return {"vs_plain": float((got - want).abs().max()), "vs_f64": float((got.double() - ref64).abs().max()),
            "plain_vs_f64": float((want.double() - ref64).abs().max()), "peak": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("build/bench_kernels.json"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 2
    from sopro_tpu_torch import weights as W
    from sopro_tpu_torch.codec.mimi_config import MimiConfig
    from sopro_tpu_torch.config import SoproTTSConfig
    from sopro_tpu_torch.engine import configure_cuda_numerics

    configure_cuda_numerics()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    kernels.build()
    old = {name: old_lib(args.old_src, name) for name in ("nar_heads", "seanet")} if args.old_src else {}
    cfg, mcfg = SoproTTSConfig(), MimiConfig()
    tree, mtree = W.init_sopro_params(args.seed, cfg, 259), W.init_mimi_params(args.seed, mcfg)
    W.fill_zero_inits(tree, mtree, args.seed + 1)
    model, mimi = W.sopro_params_from_jax(tree, cfg, dev), W.mimi_params_from_jax(mtree, mcfg, dev)
    rng = np.random.default_rng(args.seed)
    result = {"card": card, "torch": torch.__version__}
    for dtype in (torch.float32, torch.bfloat16):
        key = "" if dtype == torch.float32 else "_bf16"
        result["nar" + key] = bench_nar(model, dev, rng, old.get("nar_heads"), dtype)
        result["seanet" + key] = [bench_seanet(mimi, dev, rng, b, old.get("seanet"), dtype)
                                  for b in (1, 4)]
        result["seanet_chunk" + key] = [
            bench_seanet_chunk(mimi, dev, rng, old.get("seanet"), b, m25, dtype)
            for b, m25 in ((1, 12), (2, 12), (1, 32))]
    if args.old_src is not None:  # K1 and K5: bench_ar's old-vs-new comparison
        from sopro_tpu_torch import bench_ar

        result["ar"] = bench_ar.compare(dev, args.old_src, args.seed)
    report(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


def report(result) -> None:
    nan = math.nan
    print(result["card"])
    for key in ("", "_bf16"):
        dt = "bfloat16" if key else "float32"
        print(f"K2 {dt} per stage: rows stage H | GFLOP MB | bound ms | kernel ms | old ms | "
              "einsum+argmax ms | ids differ (new, old)")
        for r in result["nar" + key]:
            print(f"  {r['rows']:5d} {r['stage']} {r['H']:2d} | {r['gflop']:.3f} {r['mbytes']:.1f} | "
                  f"{r['bound_ms']:.4f} | {r['ms']:.4f} | {r.get('old_ms', nan):.4f} | "
                  f"{r['library_ms']:.4f} | {r['ids_differ']}, {r.get('old_ids_differ', '-')}")
        for s in result["seanet" + key]:
            for r in s["convs"]:
                print(f"  cuDNN {r['conv']:28s} {r['M']:8d} {r['N']:5d} {r['K']:5d} | "
                      f"{r['gflop']:.2f} {r['mbytes']:.1f} | {r['tf32x3_ms']:.4f} {r['bytes_ms']:.4f} | "
                      f"{r['library_ms']:.4f}")
            print(f"K3 {dt} B={s['B']} launches: M | GFLOP MB | 3xTF32 / bytes bound ms | ms | old ms")
            for r in s["launches"]:
                print(f"  {r['launch']:28s} {r['M']:8d} | {r['gflop']:.2f} {r['mbytes']:.1f} | "
                      f"{r['tf32x3_ms']:.4f} {r['bytes_ms']:.4f} | {r['ms']:.4f} | {r.get('old_ms', nan):.4f}")
            print(f"  whole stack: kernel {s['ms']:.3f} ms, old {s.get('old_ms', nan):.3f} ms, plain "
                  f"{s['plain_ms']:.3f} ms, cuDNN stack {s['library_ms']:.3f} ms, bound "
                  f"{s['bound_ms']:.4f} ms ({s['bound_rate']}); errors {s['err']}, old vs plain "
                  f"{s.get('old_err', nan):.3e}")
        for s in result["seanet_chunk" + key]:
            print(f"K4 {dt} B={s['B']} m25={s['m25']}: launch | M | GFLOP MB | 3xTF32 / bytes bound ms "
                  "| ms | old ms")
            for r in s["launches"]:
                print(f"  {r['launch']:28s} {r['M']:7d} | {r['gflop']:.3f} {r['mbytes']:.1f} | "
                      f"{r['tf32x3_ms']:.4f} {r['bytes_ms']:.4f} | {r['ms']:.4f} | {r.get('old_ms', nan):.4f}")
            print(f"  chunk: kernel {s['ms']:.3f} ms, old {s.get('old_ms', nan):.3f} ms, plain "
                  f"{s['plain_ms']:.3f} ms, cuDNN stack {s['library_ms']:.3f} ms, bound "
                  f"{s['bound_ms']:.4f} ms; max|err| new {s['err']:.3e}, old {s.get('old_err', nan):.3e}")
    if "ar" in result:
        from sopro_tpu_torch import bench_ar

        bench_ar.report(result["ar"])


if __name__ == "__main__":
    sys.exit(main())
