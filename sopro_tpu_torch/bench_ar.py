"""The AR kernels K1 and K5 on one NVIDIA GPU: time per step of this tree's
kernels beside an older `ar_loop.cu`, and the clock64 share of each phase
of a K1 step.

    python -m sopro_tpu_torch.bench_ar [--old-src DIR] [--out PATH]

Full Sopro v1.5 width (random weights from seed 0, zero-inits filled),
production settings with the anti-loop; CUDA-event medians. Per kernel
build (the tree's and, with `--old-src`, the `ar_loop.cu` of DIR, an older
`csrc/` with today's packs and entry points, built by
`kernels.build_variant` and launched inside `kernels.using`; timed in turns
new, old, old, new):
- K1 at B = 1 from a fresh state for up to 401 steps at text bucket 64 (the
  row stops at its EOS; the time per step divides by the steps run), K1
  over 6 steps (a stream chunk) from the state at t = 60, K5 for one step,
  and whether K1's tokens equal the tree's;
- K1's µs per step over 64 steps at B = 1, 4, 7, 8, 16 and 32 rows of the
  serving text bucket (256), float32 and bfloat16 (ROWS);
- the phase breakdown: the source built again with -DSOPRO_AR_CLOCKS, whose
  `AR_PHASE(i)` marks make thread 0 of block 0 add clock64() deltas per
  phase (PHASES) into a device array, read after a 401-step run at B = 1
  and after 64 steps at CLOCK_ROWS rows;
- ptxas' registers and spills of each build.
Bounds are the benchmark's (`cudabench.flops.k1_bound_s`, what the cell's
`k1_roofline_pct.synth` reads): K1 over the steps run at the text's length,
K5 at one step, the serving rows at their mean text length (the count is
linear in it). Prints the tables and writes them as JSON to PATH (default
build/bench_ar.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from cudabench import flops
from sopro_tpu_torch import kernels
from sopro_tpu_torch.bench_kernels import cuda_ms, dtype_name

TEXT = "Streaming from a graphics card, one small chunk at a time."
# the AR_PHASE(i) marks of this tree's ar_loop.cu (the phase each one starts)
PHASES = ("embed+norm", "glu", "conv", "xch conv", "ffn norm+ff1", "ff2", "xch ff2",
          "ff2 sum", "xch ffn", "norm (+q)", "xch q", "attn units", "xch attn",
          "attn combine+out", "xch attn out", "head", "xch logits", "sampler prep",
          "xch tokens", "sampler top-k", "sampler top-p", "sampler draw", "bookkeeping")
STEP_SLOT = 31
CLOCKS = ("-DSOPRO_AR_CLOCKS",)
ROWS = (1, 4, 7, 8, 16, 32)
ROW_STEPS, ROW_TEXT = 64, 256
CLOCK_ROWS = (1, 4, 8)  # the phase clocks also at these rows of the serving bucket, fp32


def setup(dev, seed: int):
    from sopro_tpu_torch import weights as W
    from sopro_tpu_torch.codec.mimi_config import MimiConfig
    from sopro_tpu_torch.config import SoproTTSConfig
    from sopro_tpu_torch.engine import Engine
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.tokenizer import SimpleCharTokenizer

    cfg, mcfg = SoproTTSConfig(), MimiConfig()
    tree, mtree = W.init_sopro_params(seed, cfg, 259), W.init_mimi_params(seed, mcfg)
    W.fill_zero_inits(tree, mtree, seed + 1)
    model = W.sopro_params_from_jax(tree, cfg, dev)
    eng = Engine(model, W.mimi_params_from_jax(mtree, mcfg, dev))
    rng = np.random.default_rng(seed)
    ref = eng.prepare_reference(rng.integers(0, cfg.codebook_size, (150, cfg.num_codebooks)).astype(np.int32))
    ids = np.asarray(SimpleCharTokenizer().encode(TEXT), np.int32)
    prep = eng.prepare_conditioning(ids, ref, max_frames=400, style_strength=1.0)
    ctx = M.ar_context(model, prep["txt_seq"], prep["text_mask"])
    step_ctx = M.ar_step_context(model, prep["txt_seq"], prep["text_mask"])
    return cfg, prep["cond_ar"], ctx, step_ctx, model, len(ids)


def _fresh(cfg, b, s, dev, dtype=torch.float32):
    from sopro_tpu_torch.models import sopro as M

    c = M.init_ar_carry(cfg, b, s, 7, dev, dtype)
    return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key",
                                       "hist", "bufs")}


def time_kernels(cfg, cond, ctx, step_ctx, dev) -> dict:
    """K1 over the whole cond and over a 6-step chunk, K5 for one step, on
    the library the wrappers load."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.models.generator import conv_ctx
    from sopro_tpu_torch.ops.ar_loop import ar_loop
    from sopro_tpu_torch.ops.ar_step import ar_step

    s = cond.shape[1]
    per_row = M.ARSettings().per_row(1, dev)
    fresh = lambda: _fresh(cfg, 1, s, dev)  # noqa: E731
    with torch.inference_mode():
        tokens, st = ar_loop(ctx, cond, fresh(), per_row, s, True)
        _, st60 = ar_loop(ctx, cond, fresh(), per_row, 60, True)
        x = (cond[:, 0] + step_ctx.emb[-1]).contiguous()
        bufs = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (cfg.n_layers_ar, 1, conv_ctx(cfg), cfg.d_model)).astype(np.float32) * 0.3).to(dev)
        out = {"k1_401_ms": cuda_ms(lambda: ar_loop(ctx, cond, fresh(), per_row, s, True), 5),
               "k1_chunk6_ms": cuda_ms(lambda: ar_loop(ctx, cond, st60, per_row, 6, True), 20),
               "k5_ms": cuda_ms(lambda: ar_step(step_ctx, x, bufs), 50)}
        torch.cuda.synchronize()
    out["steps"] = int(st["t"][0])  # the row may stop before s steps
    out["tokens"] = tokens[0].cpu().tolist()
    out["launch"] = kernels.LAUNCH_INFO.get("ar_loop")
    return out


def row_contexts(models, dev, seed: int) -> dict:
    """(dtype, B) -> (ctx, cond) at the serving text bucket: B random rows of
    text embeddings (40 + 7 i valid tokens in row i) and conditioning, per
    model."""
    from sopro_tpu_torch.models import sopro as M

    out = {}
    for dtype, model in models.items():
        cfg = model.cfg
        for b in ROWS:
            g = torch.Generator().manual_seed(seed + b)
            txt = (torch.randn(b, ROW_TEXT, cfg.d_model, generator=g) * 0.5).to(dev, dtype)
            mask = torch.stack([torch.arange(ROW_TEXT) < 40 + 7 * i for i in range(b)]).to(dev)
            cond = (torch.randn(b, ROW_STEPS + 1, cfg.d_model, generator=g) * 0.1).to(dev, dtype)
            with torch.inference_mode():
                out[(dtype, b)] = (M.ar_context(model, txt, mask), cond)
    return out


def time_rows(contexts, dev) -> dict:
    """µs per step of K1 over ROW_STEPS steps at each (dtype, B) of
    `contexts`, on the library the wrappers load."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop

    out = {}
    with torch.inference_mode():
        for (dtype, b), (ctx, cond) in contexts.items():
            per_row = M.ARSettings().per_row(b, dev)
            fresh = lambda: _fresh(ctx.cfg, b, cond.shape[1], dev, dtype)  # noqa: E731
            ms = cuda_ms(lambda: ar_loop(ctx, cond, fresh(), per_row, ROW_STEPS, True), 5)
            out[(dtype_name(dtype), b)] = {
                "us_per_step": ms * 1e3 / ROW_STEPS, "launch": kernels.LAUNCH_INFO.get("ar_loop")}
    return out


def phase_clocks(clock_lib, cfg, cond, ctx, dev) -> dict:
    """clock64 cycles per phase of block 0 over a run of cond's length from
    a fresh state of cond's rows, on `clock_lib` (built with CLOCKS)."""
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop

    b, s = cond.shape[0], cond.shape[1]
    per_row = M.ARSettings().per_row(b, dev)
    clk = (ctypes.c_ulonglong * 32)()
    with torch.inference_mode(), kernels.using("ar_loop", clock_lib):
        for _ in range(2):  # the first run's counts are thrown away
            ar_loop(ctx, cond, _fresh(cfg, b, s, dev, cond.dtype), per_row, s, True)
            torch.cuda.synchronize()
            kernels.check(clock_lib.sopro_ar_clocks(clk), "ar_loop clocks")
    steps = max(1, int(clk[STEP_SLOT]))
    total = sum(int(clk[i]) for i in range(len(PHASES)))
    return {"steps": steps, "cycles_per_step": total / steps,
            "phases": {name: {"cycles_per_step": int(clk[i]) / steps,
                              "share": int(clk[i]) / max(1, total)}
                       for i, name in enumerate(PHASES)}}


def compare(dev, old_src=None, seed: int = 0) -> dict:
    """K1 and K5 of this tree (and of `old_src`/ar_loop.cu): times in turns,
    K1 per step at ROWS rows in float32 and bfloat16 with each bound,
    phase clocks, registers and spills."""
    import copy

    libs = {"new": kernels.lib("ar_loop")}
    clock_libs = {"new": kernels.build_variant("ar_loop", defines=CLOCKS)}
    if old_src is not None:
        libs["old"] = kernels.build_variant("ar_loop", src_dir=old_src)
        clock_libs["old"] = kernels.build_variant("ar_loop", src_dir=old_src, defines=CLOCKS)
    cfg, cond, ctx, step_ctx, model, text_len = setup(dev, seed)
    c = cfg.to_dict()
    models = {torch.float32: model, torch.bfloat16: copy.deepcopy(model).to(torch.bfloat16)}
    contexts = row_contexts(models, dev, seed)
    runs = {name: [] for name in libs}
    rows = {name: [] for name in libs}
    for name in list(libs) + list(reversed(libs)):
        with kernels.using("ar_loop", libs[name]):
            runs[name].append(time_kernels(cfg, cond, ctx, step_ctx, dev))
            rows[name].append(time_rows(contexts, dev))
    result = {"kernels": {}}
    for name, rs in runs.items():
        med = {k: statistics.median(r[k] for r in rs) for k in ("k1_401_ms", "k1_chunk6_ms", "k5_ms")}
        med["steps"] = rs[0]["steps"]
        med["k1_us_per_step"] = med["k1_401_ms"] * 1e3 / rs[0]["steps"]
        med["k1_bound_ms"] = 1e3 * flops.k1_bound_s(c, med["steps"], 1, text_len, "float32")
        med["k5_bound_ms"] = 1e3 * flops.k1_bound_s(c, 1, 1, text_len, "float32")
        med["tokens_equal_new"] = rs[0]["tokens"] == runs["new"][0]["tokens"]
        med["launch"] = rs[0]["launch"]
        med["rows"] = {}
        for dt, b in rows[name][0]:
            us = statistics.median(r[(dt, b)]["us_per_step"] for r in rows[name])
            bound = 1e3 * flops.k1_bound_s(c, ROW_STEPS, b, 40 + 3.5 * (b - 1), dt)
            med["rows"][f"{dt} B={b}"] = {"us_per_step": us, "bound_ms": bound,
                                          "share_pct": 100.0 * bound / (us * ROW_STEPS / 1e3),
                                          "launch": rows[name][0][(dt, b)]["launch"]}
        med["clocks"] = phase_clocks(clock_libs[name], cfg, cond, ctx, dev)
        med["row_clocks"] = {b: phase_clocks(clock_libs[name], cfg, contexts[(torch.float32, b)][1],
                                             contexts[(torch.float32, b)][0], dev)
                             for b in CLOCK_ROWS}
        med["ptxas"] = kernels.ptxas(libs[name])
        result["kernels"][name] = med
    return result


def report(result: dict) -> None:
    for name, r in result["kernels"].items():
        print(f"{name}: K1 {r['steps']} steps {r['k1_401_ms']:.3f} ms ({r['k1_us_per_step']:.1f} us/step; "
              f"bound {r['k1_bound_ms']:.4f} ms, {100 * r['k1_bound_ms'] / r['k1_401_ms']:.3f} %), "
              f"K1 6 steps {r['k1_chunk6_ms']:.3f} ms, K5 {r['k5_ms'] * 1e3:.1f} us (bound "
              f"{r['k5_bound_ms'] * 1e3:.2f} us, {100 * r['k5_bound_ms'] / r['k5_ms']:.2f} %); tokens "
              f"equal to new: {r['tokens_equal_new']}; launch {r['launch']}")
        for key, v in r["rows"].items():
            print(f"  K1 {key:16s} {v['us_per_step']:8.1f} us/step over {ROW_STEPS} steps, "
                  f"{v['share_pct']:.4f} % of the bound")
        for line in r["ptxas"]:
            print(f"  ptxas: {line}")
        c = r["clocks"]
        print(f"  clock64: {c['cycles_per_step']:.0f} cycles per step over {c['steps']} steps")
        for ph, v in c["phases"].items():
            if v["cycles_per_step"]:
                print(f"    {ph:16s} {v['cycles_per_step']:9.0f} cycles {100 * v['share']:5.1f} % "
                      f"~{v['share'] * r['k1_us_per_step']:6.1f} us")
        rc = r["row_clocks"]
        print("  clock64 per step at the serving bucket, B = " + " / ".join(str(b) for b in rc) + ":")
        for ph in PHASES:
            print(f"    {ph:16s} " + " ".join(f"{rc[b]['phases'][ph]['cycles_per_step']:9.0f}" for b in rc))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("build/bench_ar.json"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ar: no CUDA device", file=sys.stderr)
        return 2
    from sopro_tpu_torch.engine import configure_cuda_numerics

    configure_cuda_numerics()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    result = dict(compare(dev, args.old_src, args.seed), card=card, torch=torch.__version__)
    report(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
