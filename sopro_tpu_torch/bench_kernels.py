"""Per-stage timing of kernel K2, per-launch timing of kernels K3 and K4,
in float32 and bfloat16, and (with `--old-src`) the same kernels of an older
`csrc/` beside them, plus K1 and K5 as `bench_ar` compares them, on one
NVIDIA GPU, beside the library calls for the same work and each bound.

    python -m sopro_tpu_torch.bench_kernels [--old-src DIR] [--out PATH]

Full Sopro v1.5 and Mimi widths, random weights from a numpy seed, TF32 off,
CUDA-event medians with warm caches. K2 at 6, 187, 401 and 1,604 rows: per
stage this tree's kernel, the older one and einsum + argmax, and the four
stages together against the bound. K3 at B = 1 and 4: cuDNN
(`F.conv1d` / `F.conv_transpose1d`, the conv alone) per conv of the decoder
plan, both trees' kernels per launch, the whole stack. K4 at chunks of 6 and
16 AR frames (ext of 8 + 12 and 8 + 32 rows, B = 1 and 2): both trees'
launches one by one and whole, the plain version and the cuDNN stack. DIR is
an older `csrc/` with today's packs and entry points: `kernels.build_variant`
builds it with this tree's nvcc flags and `kernels.using` swaps it in for
the wrappers' library. bfloat16: the same shapes with the weights and inputs
cast.

Bounds are the benchmark's (`cudabench/flops.py`), so a share here is what
the cell's `k*_roofline_pct` reads: K2 `k2_bound_s` at the rows, K3
`k3_bound_s` over B x 401 frames, K4 `k3_bound_s` over the chunk's frames;
a single launch its own operations over the dtype's peak or its bytes
(input, weights and output once) over HBM's rate, the larger
(`launch_bound_ms`). `nar_library` is K2's library yardstick in either dtype
(einsum + argmax in the inputs' dtype; timed only, the port never calls it).
Prints tables and writes them as JSON to PATH (default
build/bench_kernels.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from cudabench import flops
from sopro_tpu_torch import kernels

NAR_ROWS = (6, 187, 401, 1604)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of `fn` on the device (CUDA events, one warm-up)."""
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


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def launch_bound_ms(flop: float, nbytes: float, dtype) -> float:
    """One launch's bound at the benchmark's peaks: its operations over the
    dtype's peak or its bytes over HBM's rate, the larger (ms)."""
    return 1e3 * max(flop / flops.PEAK_FLOPS[dtype_name(dtype)], nbytes / flops.PEAK_BYTES)


def roofline(bound_s: float, ms: float) -> dict:
    """A bound from `cudabench.flops` (seconds) in ms, and its share of a
    time `ms` in percent, as the cells' `k*_roofline_pct` read it."""
    return {"bound_ms": 1e3 * bound_s, "share_pct": 1e5 * bound_s / ms}


def _trees(old, source: str, measure) -> dict:
    """`measure()` on this tree's library and, with `old` (another build of
    `source`), again on that build (`kernels.using`), its keys prefixed
    "old_"."""
    out = measure()
    if old is not None:
        with kernels.using(source, old):
            out.update({f"old_{k}": v for k, v in measure().items()})
    return out


def nar_library(z: torch.Tensor, hid: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """K2's library yardstick: the head product as one einsum in the inputs'
    dtype (cuBLAS; bfloat16 with float32 accumulation under
    `configure_cuda_numerics`), the bias, and argmax."""
    zh = z[:, :, None, :] + hid[None, None]
    return torch.argmax(torch.einsum("bthd,hdv->bthv", zh, w) + b[None, None], dim=-1)


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


def bench_nar(model, dev, rng, old, dtype) -> list:
    """K2 at NAR_ROWS rows: per stage both trees' kernels and the library
    call, and the stages' sum against `k2_bound_s` at the rows."""
    from sopro_tpu_torch.ops.nar_heads import nar_heads_argmax, nar_heads_argmax_plain, pack_nar_heads

    c = model.cfg.to_dict()
    rows_out = []
    for rows in NAR_ROWS:
        stages = []
        for stage, stack in model.nar.head_stacks().items():
            hid, w, b = (x.to(dtype) for x in stack[:3])
            packed = stack[3] if dtype == torch.float32 else pack_nar_heads(w)
            z = torch.from_numpy(rng.standard_normal((1, rows, w.shape[1])).astype(np.float32)).to(dev, dtype)
            want = nar_heads_argmax_plain(z, hid, w, b)
            run = (lambda: nar_heads_argmax(z, hid, w, b, packed))
            stages.append({"stage": stage, "H": w.shape[0],
                           "library_ms": cuda_ms(lambda: nar_library(z, hid, w, b)),
                           **_trees(old, "nar_heads", lambda: {
                               "ms": cuda_ms(run), "ids_differ": int((run() != want).sum())})})
        row = {"rows": rows, "stages": stages}
        for key in ("ms", "old_ms", "library_ms"):
            if key in stages[0]:
                row[key] = sum(s[key] for s in stages)
        rows_out.append(dict(row, **roofline(flops.k2_bound_s(c, rows, dtype_name(dtype)), row["ms"])))
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
    """K3 over B x 401 frames: cuDNN per conv (float32), both trees' launches
    and whole stacks, the plain version and the cuDNN stack, against
    `k3_bound_s`."""
    from sopro_tpu_torch.codec.mimi import decode_embeddings, seanet_apply
    from sopro_tpu_torch.codec.mimi_config import decoder_plan
    from sopro_tpu_torch.codec.vocoder import seanet_decode

    cfg = mimi.cfg
    params, packed = _decoder(mimi, dtype)
    plan = decoder_plan(cfg)
    frames = 401
    codes = torch.from_numpy(rng.integers(0, cfg.codebook_size, (b, frames, cfg.num_quantizers))).to(dev)
    out = {"B": b, "dtype": dtype_name(dtype), "convs": []}
    with torch.inference_mode():
        emb = decode_embeddings(mimi.p, cfg, codes).contiguous().to(dtype)
        if dtype == torch.float32:  # cuDNN per conv of the plan, inputs from the plain stack
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
                                     "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
                                     "bound_ms": launch_bound_ms(flop, nbytes, dtype),
                                     "library_ms": cuda_ms(lib, 5)})
        want = seanet_apply(params, plan, emb)[..., 0]
        ref64 = _float64(params, plan, emb)
        out["plain_ms"] = cuda_ms(lambda: seanet_apply(params, plan, emb), 5)
        lib_w = seanet_library_weights(params, plan)
        out["library_ms"] = cuda_ms(lambda: seanet_library(lib_w, emb), 5)
        out.update(_trees(old, "seanet", lambda: {
            "launches": _bench_k3_launches(packed["k3"], emb),
            "ms": cuda_ms(lambda: seanet_decode(packed, cfg, emb), 5),
            "err": _errors(seanet_decode(packed, cfg, emb), want, ref64)}))
    return dict(out, **roofline(flops.k3_bound_s(dataclasses.asdict(cfg), b * frames, dtype_name(dtype)),
                                out["ms"]))


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
        rows.append({"launch": name, "M": m, "gflop": flop / 1e9, "mbytes": nbytes / 1e6,
                     "bound_ms": launch_bound_ms(flop, nbytes, emb.dtype), "ms": cuda_ms(fn, reps)})
        x = fn()
    return rows


def bench_seanet_chunk(mimi, dev, rng, old, b: int, m25: int, dtype) -> dict:
    """K4 on ext [b, halo + m25, H] (full history): both trees' launches one
    by one and whole, the plain version and the cuDNN stack
    (`seanet_library`), against `k3_bound_s` over the chunk's b x m25 / 2
    frames."""
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
    out = {"B": b, "m25": m25, "dtype": dtype_name(dtype)}
    with torch.inference_mode():
        ext = decode_embeddings(mimi.p, cfg, codes)[:, -(halo + m25):].contiguous().to(dtype)
        out["plain_ms"] = cuda_ms(lambda: seanet_decode_chunk_plain(params, cfg, ext))
        out["library_ms"] = cuda_ms(lambda: seanet_library(lib_w, ext)[:, -n_out:])
        want = seanet_decode_chunk_plain(params, cfg, ext)
        out.update(_trees(old, "seanet", lambda: {
            "launches": _bench_k3_launches(packed["k3"], ext, valid=True, keep=n_out, reps=20),
            "ms": cuda_ms(lambda: seanet_decode_chunk(packed, cfg, ext)),
            "err": float((seanet_decode_chunk(packed, cfg, ext) - want).abs().max())}))
    return dict(out, **roofline(flops.k3_bound_s(dataclasses.asdict(cfg), b * m25 // 2, dtype_name(dtype)),
                                out["ms"]))


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


def _float64(params, plan, emb):
    """The plain SEANet in float64 over emb."""
    from sopro_tpu_torch.codec.mimi import seanet_apply
    from sopro_tpu_torch.models.base import tree_map

    p64 = tree_map(lambda a: a.double() if torch.is_floating_point(a) else a, params)
    return seanet_apply(p64, plan, emb.double())[..., 0]


def _errors(got, want, ref64) -> dict:
    """max|err| against the plain version (`want`) and a float64 one, and the peak."""
    return {"vs_plain": float((got - want).abs().max()), "vs_f64": float((got.double() - ref64).abs().max()),
            "plain_vs_f64": float((want.double() - ref64).abs().max()), "peak": float(ref64.abs().max())}


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
    old = ({s: kernels.build_variant(s, src_dir=args.old_src) for s in ("nar_heads", "seanet")}
           if args.old_src else {})
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


def _launch_rows(s) -> None:
    old = s.get("old_launches") or [{}] * len(s["launches"])
    for r, o in zip(s["launches"], old):
        print(f"  {r['launch']:28s} {r['M']:8d} | {r['gflop']:.3f} {r['mbytes']:.1f} | "
              f"{r['bound_ms']:.4f} | {r['ms']:.4f} | {o.get('ms', math.nan):.4f}")


def report(result) -> None:
    nan = math.nan
    print(result["card"])
    for key in ("", "_bf16"):
        dt = "bfloat16" if key else "float32"
        print(f"K2 {dt}: rows | bound ms | kernel ms (share) | old ms | einsum+argmax ms; per stage: "
              "H | ms | old ms | library ms | ids differ (new, old)")
        for r in result["nar" + key]:
            print(f"  {r['rows']:5d} | {r['bound_ms']:.4f} | {r['ms']:.4f} ({r['share_pct']:.1f} %) | "
                  f"{r.get('old_ms', nan):.4f} | {r['library_ms']:.4f}")
            for s in r["stages"]:
                print(f"        {s['stage']} {s['H']:2d} | {s['ms']:.4f} | {s.get('old_ms', nan):.4f} | "
                      f"{s['library_ms']:.4f} | {s['ids_differ']}, {s.get('old_ids_differ', '-')}")
        for s in result["seanet" + key]:
            for r in s["convs"]:
                print(f"  cuDNN {r['conv']:28s} {r['M']:8d} {r['N']:5d} {r['K']:5d} | "
                      f"{r['gflop']:.2f} {r['mbytes']:.1f} | {r['bound_ms']:.4f} | {r['library_ms']:.4f}")
            print(f"K3 {dt} B={s['B']} launches: M | GFLOP MB | bound ms | ms | old ms")
            _launch_rows(s)
            print(f"  whole stack: kernel {s['ms']:.3f} ms, old {s.get('old_ms', nan):.3f} ms, plain "
                  f"{s['plain_ms']:.3f} ms, cuDNN stack {s['library_ms']:.3f} ms, bound "
                  f"{s['bound_ms']:.4f} ms ({s['share_pct']:.1f} %); errors {s['err']}, old "
                  f"{s.get('old_err', '-')}")
        for s in result["seanet_chunk" + key]:
            print(f"K4 {dt} B={s['B']} m25={s['m25']}: launch | M | GFLOP MB | bound ms | ms | old ms")
            _launch_rows(s)
            print(f"  chunk: kernel {s['ms']:.3f} ms, old {s.get('old_ms', nan):.3f} ms, plain "
                  f"{s['plain_ms']:.3f} ms, cuDNN stack {s['library_ms']:.3f} ms, bound "
                  f"{s['bound_ms']:.4f} ms ({s['share_pct']:.1f} %); max|err| new {s['err']:.3e}, "
                  f"old {s.get('old_err', nan):.3e}")
    if "ar" in result:
        from sopro_tpu_torch import bench_ar

        bench_ar.report(result["ar"])


if __name__ == "__main__":
    sys.exit(main())
