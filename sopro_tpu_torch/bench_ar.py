"""The AR kernels K1 and K5 on one NVIDIA GPU: time per step of this tree's
kernels beside an older `ar_loop.cu`, the clock64 share of each phase of a
K1 step, and the rate at which one block streams its weights from L2.

    python -m sopro_tpu_torch.bench_ar [--old-src DIR] [--out PATH]

Full Sopro v1.5 width (random weights from seed 0, zero-inits filled), B = 1,
text bucket 64 (a 57-character prompt), production settings with the
anti-loop; CUDA-event medians. Per kernel build (the tree's and, with
`--old-src`, the `ar_loop.cu` in DIR, timed in turns old, new, new, old):
- K1 from a fresh state for up to 401 steps (the row stops at its EOS; the
  time per step divides by the steps run), K1 over 6 steps (a stream chunk)
  from the state at t = 60, K5 for one step, and whether K1's tokens equal
  the tree's;
- the phase breakdown: the source built again with -DSOPRO_AR_CLOCKS, whose
  `AR_PHASE(i)` marks make thread 0 of block 0 add clock64() deltas per
  phase (PHASES; the sampler's bisections and draw on their own where the
  source marks them) into a device array, read after a 401-step run. A source
  without the marks (from before the weight stream) gets them inserted before the lines of
  OLD_MARKS; a missing line fails the run.
- the L2 -> shared memory floor: a block of 1,024 threads streaming a
  2.6 MB slice (one rank's weights per step at cluster size 16) of a
  16-slice, 42 MB buffer through a ring of cp.async or of 1-D bulk copies
  (TMA, completing on mbarriers), as 8, 16 and 132 blocks.
Prints the tables and writes them as JSON to PATH (default
build/bench_ar.json).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from sopro_tpu_torch import kernels
from sopro_tpu_torch.bench_kernels import cuda_ms

TEXT = "Streaming from a graphics card, one small chunk at a time."
PHASES = ("embed", "norm", "glu", "conv", "xch conv", "ffn norm", "ff1+gelu", "ff2", "xch ffn",
          "attn norm+q", "xch q", "attn core", "attn out", "xch attn", "head", "xch logits",
          "sampler", "bookkeeping", "sampler top-k", "sampler top-p", "sampler draw")
EXIT_PHASE, STEP_SLOT = 30, 31
# an ar_loop.cu from before the weight stream: AR_PHASE(i) goes before the line holding OLD_MARKS[i]
OLD_MARKS = (
    "    const int t = kLogitsOnly ? 0 : st[T];",
    "      rmsnorm(h, a.norm + (size_t)li * D, hn, D, red);",
    "      gemv_cols2(a.glu_w + (size_t)li * D * 2 * D, 2 * D, hn, D, c0, D + c0, lay.cw,",
    "      float* rl = ringS + (size_t)li * CTX * lay.cw;",
    "      push(cl, cbuf + c0, yl, lay.cw, cs);",
    "      rmsnorm(h, a.ff_norm + (size_t)li * D, hn, D, red);",
    "      gemv_cols(a.ff1_w + (size_t)li * D * 4 * D, 4 * D, hn, D, f0, lay.fw, loc, part);",
    "      gemv_cols(a.ff2_w + ((size_t)li * 4 * D + f0) * D, D, loc, lay.fw, 0, D, yl, part);",
    "      push(cl, pbuf + (size_t)r * D, yl, D, cs);",
    "        rmsnorm(h, a.x_nq + (size_t)ai * D, hn, D, red);",
    "        push(cl, q + c0, yl, lay.cw, cs);  // q columns [c0, c0 + cw) -> everyone",
    "        for (int hh = c0 / hd; hh <= (c0 + lay.cw - 1) / hd; ++hh) {",
    "        gemv_cols(a.x_out + ((size_t)ai * D + c0) * D, D, cbuf, lay.cw, 0, D, yl, part);",
    "        push(cl, pbuf2 + (size_t)r * D, yl, D, cs);",
    "    rmsnorm(h, a.out_norm, hn, D, red);",
    "    push(cl, lg + v0, loc, max(0, v1r - v0), cs);",
    "    // ---- anti-loop settings ----",
    "    // ---- bookkeeping (ar_single_step semantics; the row is active) ----",
)
OLD_EXIT = "  // ---- exit: tokens of skipped steps, state out, my ring columns ----"
OLD_ENTRY = "  extern __shared__ float smem[];"
# the same instrumentation ar_loop.cu carries under SOPRO_AR_CLOCKS
CLOCKS_PRELUDE = r"""
__device__ unsigned long long g_ar_clk[32];
__shared__ unsigned long long ar_clk_acc[32];
#define AR_CLOCK_INIT long long ar_clk_last = clock64(); int ar_clk_cur = 0; \
  if (threadIdx.x == 0) for (int i_ = 0; i_ < 32; ++i_) ar_clk_acc[i_] = 0;
#define AR_PHASE(n) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
  const long long ar_now = clock64(); ar_clk_acc[ar_clk_cur] += ar_now - ar_clk_last; \
  ar_clk_last = ar_now; ar_clk_cur = (n); if ((n) == 0) ar_clk_acc[31] += 1; \
  if ((n) == 30) for (int i_ = 0; i_ < 32; ++i_) g_ar_clk[i_] += ar_clk_acc[i_]; } } while (0)
extern "C" int sopro_ar_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_ar_clk, sizeof(g_ar_clk));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zeros[32] = {0};
  return (int)cudaMemcpyToSymbol(g_ar_clk, zeros, sizeof(zeros));
}
"""

STREAM_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int STAGES>
__global__ void __launch_bounds__(1024, 1) stream_kernel(const float4* __restrict__ src,
    long long per_block, int chunk, int reps, float* sink) {
  extern __shared__ float4 ring[];
  const float4* s = src + (size_t)blockIdx.x * per_block;
  const int nchunk = (int)(per_block / chunk), total = nchunk * reps;
  float acc = 0.f;
  auto issue = [&](int k) {
    if (k < total) {
      const float4* c = s + (size_t)(k % nchunk) * chunk;
      float4* d = ring + (size_t)(k % STAGES) * chunk;
      for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
        const uint32_t a = (uint32_t)__cvta_generic_to_shared(d + i);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(c + i));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  for (int k = 0; k < total; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    issue(k + STAGES - 1);
    acc += ring[(size_t)(k % STAGES) * chunk + threadIdx.x % chunk].x;
  }
  if (acc == 1234.5f) sink[blockIdx.x] = acc;
}
// the same stream with one 1-D bulk copy (TMA) per chunk, completing on the
// slot's mbarrier with a transaction count
template <int STAGES>
__global__ void __launch_bounds__(1024, 1) bulk_kernel(const float4* __restrict__ src,
    long long per_block, int chunk, int reps, float* sink) {
  extern __shared__ float4 ring[];
  __shared__ __align__(8) unsigned long long bar[STAGES];
  const float4* s = src + (size_t)blockIdx.x * per_block;
  const int nchunk = (int)(per_block / chunk), total = nchunk * reps;
  if (threadIdx.x == 0)
    for (int i = 0; i < STAGES; ++i) {
      const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar[i]);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  auto issue = [&](int k) {
    if (threadIdx.x == 0 && k < total) {
      const int slot = k % STAGES;
      const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar[slot]);
      const uint32_t d = (uint32_t)__cvta_generic_to_shared(ring + (size_t)slot * chunk);
      const uint32_t bytes = (uint32_t)chunk * 16u;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                   ::"r"(d), "l"(s + (size_t)(k % nchunk) * chunk), "r"(bytes), "r"(b) : "memory");
    }
  };
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  float acc = 0.f;
  for (int k = 0; k < total; ++k) {
    const int slot = k % STAGES;
    const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar[slot]);
    const uint32_t parity = (uint32_t)((k / STAGES) & 1);
    uint32_t done = 0;
    while (!done)
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }\n"
                   : "=r"(done) : "r"(b), "r"(parity) : "memory");
    acc += ring[(size_t)slot * chunk + threadIdx.x % chunk].x;
    __syncthreads();  // every thread is done with chunk k - 1's slot
    issue(k + STAGES - 1);
  }
  if (acc == 1234.5f) sink[blockIdx.x] = acc;
}
extern "C" int stream_rate(const float4* src, long long per_block, int chunk, int stages,
                           int reps, int blocks, float* sink, int bulk, void* stream) {
  const size_t smem = (size_t)stages * chunk * sizeof(float4);
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, 1024, smem, (cudaStream_t)stream>>>(src, per_block, chunk, reps, sink);
    return (int)cudaGetLastError();
  };
  if (bulk) {
    if (stages == 3) return run(bulk_kernel<3>);
    if (stages == 4) return run(bulk_kernel<4>);
    if (stages == 6) return run(bulk_kernel<6>);
    return (int)cudaErrorInvalidValue;
  }
  if (stages == 2) return run(stream_kernel<2>);
  if (stages == 3) return run(stream_kernel<3>);
  if (stages == 4) return run(stream_kernel<4>);
  if (stages == 6) return run(stream_kernel<6>);
  return (int)cudaErrorInvalidValue;
}
"""


# variants of this tree's ar_loop.cu (text edits of a copy), timed beside it
VARIANTS = {
    "1,024 threads": [("constexpr int kThreads = 512;", "constexpr int kThreads = 1024;")],
    "top-k counts in int32": [
        ("      float c = 0.f;\n      for (int i = tid; i < V; i += nt) c += xp[i] >= mid ? 1.f : 0.f;\n"
         "      const bool over = block_reduce(c, 0, red) > (float)a.top_k;",
         "      int c = 0;\n      for (int i = tid; i < V; i += nt) c += xp[i] >= mid;\n"
         "      const bool over = block_reduce_i(c, 0, red) > a.top_k;")],
    "ring of 2 x 48 KB": [("constexpr int kRing = 3; ", "constexpr int kRing = 2; "),
                          ("constexpr int kStage = 8192;", "constexpr int kStage = 12288;")],
    "ring of 2 x 40 KB": [("constexpr int kRing = 3; ", "constexpr int kRing = 2; "),
                          ("constexpr int kStage = 8192;", "constexpr int kStage = 10240;")],
}
PTXAS: dict = {}  # library name -> ptxas' register and spill lines


def _build(src_text: str, name: str, defines=()) -> ctypes.CDLL:
    """nvcc with the tree's flags (and the csrc headers) into build/bench_ar/."""
    flags = [*kernels.NVCC_FLAGS, *defines, "-I", str(kernels.CSRC)]
    digest = hashlib.sha256((src_text + " ".join(flags)).encode()).hexdigest()[:16]
    out_dir = kernels.BUILD_DIR.parent / "bench_ar"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}_{digest}.so"
    if not lib.exists():
        src = out_dir / f"{name}_{digest}.cu"
        src.write_text(src_text)
        proc = subprocess.run([kernels._nvcc(), *flags, "-o", str(lib), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
        PTXAS[name] = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
                       if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(lib))


def variant(src_text: str, edits) -> str:
    for old, new in edits:
        if old not in src_text:
            raise RuntimeError(f"bench_ar: variant text not found: {old!r}")
        src_text = src_text.replace(old, new)
    return src_text


class _Entry:
    """A callable with ctypes' `argtypes` slot, so `kernels.entry` takes it."""

    argtypes = restype = ()

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, *args):
        return self._fn(*args)


class _OldEntries:
    """An ar_loop.cu from before the weight stream behind this
    tree's entry points: its launches take (args, &cluster, stream) and pick
    their cluster themselves, and it reads only the prefix of the args it
    knows, so the stream fields go unread."""

    def __init__(self, lib: ctypes.CDLL):
        from sopro_tpu_torch.ops.ar_loop import _Args

        self.sopro_ar_clocks = getattr(lib, "sopro_ar_clocks", None)
        for name in ("sopro_ar_loop", "sopro_ar_step"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            setattr(self, name, _Entry(lambda args, stream, fn=fn: fn(args, ctypes.byref(ctypes.c_int()), stream)))

        def cluster(args, logits_only, cs):
            cs._obj.value = 16  # any size: the old kernel ignores the packed stream
            return 0

        self.sopro_ar_cluster = _Entry(cluster)


def load(src_text: str, name: str, defines=()):
    """Build and load an ar_loop.cu; an old one behind `_OldEntries`."""
    lib = _build(src_text, name, defines)
    return lib if hasattr(lib, "sopro_ar_cluster") else _OldEntries(lib)


def with_clocks(src_text: str) -> str:
    """The source with the phase marks: as it is where it carries them,
    else with OLD_MARKS' lines marked."""
    if "SOPRO_AR_CLOCKS" in src_text:
        return src_text
    lines = src_text.split("\n")
    out, marks = [], {line: i for i, line in enumerate(OLD_MARKS)}
    found = set()
    for line in lines:
        if line in marks:
            out.append(f"    AR_PHASE({marks[line]});")
            found.add(line)
        elif line == OLD_EXIT:
            out.append(f"  AR_PHASE({EXIT_PHASE});")
            found.add(line)
        out.append(line)
        if line == OLD_ENTRY:
            out.append("  AR_CLOCK_INIT")
            found.add(line)
        if line == "#include <stdint.h>":
            out.append(CLOCKS_PRELUDE)
    missing = set(OLD_MARKS) | {OLD_EXIT, OLD_ENTRY}
    if missing - found:
        raise RuntimeError(f"bench_ar: lines not found: {sorted(missing - found)}")
    return "\n".join(out)


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
    return cfg, prep["cond_ar"], ctx, step_ctx


def time_kernels(cfg, cond, ctx, step_ctx, dev) -> dict:
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.models.generator import conv_ctx
    from sopro_tpu_torch.ops.ar_loop import ar_loop
    from sopro_tpu_torch.ops.ar_step import ar_step

    s = cond.shape[1]
    sett = M.ARSettings()
    per_row = sett.per_row(1, dev)

    def fresh():
        c = M.init_ar_carry(cfg, 1, s, 7, dev)
        return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key",
                                           "hist", "bufs")}

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
    out["cluster"] = kernels.LAUNCH_INFO.get("ar_loop")
    return out


def phase_clocks(lib, cfg, cond, ctx, dev) -> dict:
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.ops.ar_loop import ar_loop

    kernels._LIBS["ar_loop"] = lib
    s = cond.shape[1]
    per_row = M.ARSettings().per_row(1, dev)
    c = M.init_ar_carry(cfg, 1, s, 7, dev)
    state = {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key",
                                        "hist", "bufs")}
    clk = (ctypes.c_ulonglong * 32)()
    with torch.inference_mode():
        ar_loop(ctx, cond, state, per_row, s, True)
        torch.cuda.synchronize()
        kernels.check(lib.sopro_ar_clocks(clk), "ar_loop clocks")
        ar_loop(ctx, cond, state, per_row, s, True)
        torch.cuda.synchronize()
        kernels.check(lib.sopro_ar_clocks(clk), "ar_loop clocks")
    steps = max(1, int(clk[STEP_SLOT]))
    total = sum(int(clk[i]) for i in range(len(PHASES)))
    return {"steps": steps, "cycles_per_step": total / steps,
            "phases": {name: {"cycles_per_step": int(clk[i]) / steps,
                              "share": int(clk[i]) / max(1, total)}
                       for i, name in enumerate(PHASES)}}


def stream_floor(dev) -> list:
    lib = _build(STREAM_SRC, "stream_rate")
    fn = lib.stream_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    per_block = 2_636_000 // 16  # float4s: one rank's ~2.6 MB
    src = torch.randn(16 * per_block * 4, device=dev)
    sink = torch.zeros(132, device=dev)
    rows = []
    for blocks in (8, 16, 132):
        big = src if blocks <= 16 else torch.randn(blocks * per_block * 4, device=dev)
        for bulk, chunk_kb, stages in ((0, 24, 4), (0, 32, 3), (1, 24, 4), (1, 32, 3), (1, 16, 6)):
            chunk = chunk_kb * 1024 // 16
            reps = 20

            def run():
                with kernels.on_device(dev) as stream:
                    rc = fn(big.data_ptr(), per_block, chunk, stages, reps, blocks,
                            sink.data_ptr(), bulk, stream)
                kernels.check(rc, "stream_rate")

            ms = cuda_ms(run, 5)
            us = ms * 1e3 / reps
            rows.append({"blocks": blocks, "copy": "bulk" if bulk else "cp.async",
                         "stage_kb": chunk_kb, "stages": stages,
                         "us_per_2.6MB": us, "GBps_per_block": per_block * 16 / (us * 1e-6) / 1e9})
    return rows


def compare(dev, old_src=None, seed: int = 0, variants: bool = False) -> dict:
    """K1 and K5 of this tree (and of `old_src`/ar_loop.cu, and with
    `variants` of VARIANTS): times in turns, phase clocks, registers and
    spills, and the stream floor."""
    new_src = (kernels.CSRC / "ar_loop.cu").read_text()
    libs = {"new": load(new_src, "ar_loop_new")}
    clock_libs = {"new": load(with_clocks(new_src), "ar_loop_clocks", ["-DSOPRO_AR_CLOCKS"])}
    if old_src is not None:
        old_text = (Path(old_src) / "ar_loop.cu").read_text()
        libs["old"] = load(old_text, "ar_loop_old")
        clock_libs["old"] = load(with_clocks(old_text), "ar_loop_old_clocks", ["-DSOPRO_AR_CLOCKS"])
    for i, (name, edits) in enumerate(VARIANTS.items() if variants else ()):
        text = variant(new_src, edits)
        libs[name] = load(text, f"ar_loop_v{i}")
        clock_libs[name] = load(with_clocks(text), f"ar_loop_v{i}_clocks", ["-DSOPRO_AR_CLOCKS"])
    cfg, cond, ctx, step_ctx = setup(dev, seed)
    order = list(libs) + list(reversed(libs))
    runs = {name: [] for name in libs}
    for name in order:
        kernels._LIBS["ar_loop"] = libs[name]
        runs[name].append(time_kernels(cfg, cond, ctx, step_ctx, dev))
    result = {"kernels": {}}
    for name, rs in runs.items():
        med = {k: statistics.median(r[k] for r in rs) for k in ("k1_401_ms", "k1_chunk6_ms", "k5_ms")}
        med["steps"] = rs[0]["steps"]
        med["k1_us_per_step"] = med["k1_401_ms"] * 1e3 / rs[0]["steps"]
        med["tokens_equal_new"] = rs[0]["tokens"] == runs["new"][0]["tokens"]
        med["cluster"] = rs[0]["cluster"]
        med["clocks"] = phase_clocks(clock_libs[name], cfg, cond, ctx, dev)
        med["ptxas"] = PTXAS.get({"new": "ar_loop_new", "old": "ar_loop_old"}.get(
            name, f"ar_loop_v{list(VARIANTS).index(name)}" if name in VARIANTS else ""), [])
        result["kernels"][name] = med
    kernels._LIBS["ar_loop"] = kernels.lib("ar_loop")
    result["stream_floor"] = stream_floor(dev)
    return result


def report(result: dict) -> None:
    for name, r in result["kernels"].items():
        print(f"{name}: K1 {r['steps']} steps {r['k1_401_ms']:.3f} ms ({r['k1_us_per_step']:.1f} us/step), "
              f"K1 6 steps {r['k1_chunk6_ms']:.3f} ms, K5 {r['k5_ms'] * 1e3:.1f} us; tokens equal "
              f"to new: {r['tokens_equal_new']}; launch {r['cluster']}")
        for line in r.get("ptxas", []):
            print(f"  ptxas: {line}")
        c = r["clocks"]
        print(f"  clock64: {c['cycles_per_step']:.0f} cycles per step over {c['steps']} steps")
        for ph, v in c["phases"].items():
            if v["cycles_per_step"]:
                print(f"    {ph:12s} {v['cycles_per_step']:9.0f} cycles {100 * v['share']:5.1f} % "
                      f"~{v['share'] * r['k1_us_per_step']:6.1f} us")
    print("L2 -> shared memory, one rank's 2.6 MB per step:")
    for r in result["stream_floor"]:
        print(f"  {r['blocks']:3d} blocks, {r['copy']:8s} {r['stages']} x {r['stage_kb']} KB: "
              f"{r['us_per_2.6MB']:.2f} us ({r['GBps_per_block']:.1f} GB/s per block)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("build/bench_ar.json"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", action="store_true", help="also time VARIANTS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ar: no CUDA device", file=sys.stderr)
        return 2
    from sopro_tpu_torch.engine import configure_cuda_numerics

    configure_cuda_numerics()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = dict(compare(dev, args.old_src, args.seed, args.variants), card=card,
                  torch=torch.__version__)
    print(card)
    report(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
