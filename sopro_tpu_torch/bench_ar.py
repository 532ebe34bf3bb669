"""The AR kernels K1 and K5 on one NVIDIA GPU: time per step of this tree's
kernels beside an older `ar_loop.cu`, the clock64 share of each phase of a
K1 step, and the probes their design rests on.

    python -m sopro_tpu_torch.bench_ar [--old-src DIR] [--variants] [--probes] [--out PATH]

Full Sopro v1.5 width (random weights from seed 0, zero-inits filled),
production settings with the anti-loop; CUDA-event medians. Per kernel
build (the tree's and, with `--old-src`, the `ar_loop.cu` in DIR driven
through the `ops/ar_loop.py` beside it, timed in turns old, new, new, old):
- K1 at B = 1 from a fresh state for up to 401 steps at text bucket 64 (the
  row stops at its EOS; the time per step divides by the steps run), K1
  over 6 steps (a stream chunk) from the state at t = 60, K5 for one step,
  and whether K1's tokens equal the tree's;
- K1's µs per step over 64 steps at B = 1, 4, 7, 8, 16 and 32 rows of the
  serving text bucket (256), float32 and bfloat16 (ROWS);
- the phase breakdown: the source built again with -DSOPRO_AR_CLOCKS, whose
  `AR_PHASE(i)` marks make thread 0 of block 0 add clock64() deltas per
  phase (PHASES, or OLD_PHASES for a source of one cluster per row) into a
  device array, read after a 401-step run at B = 1;
- ptxas' registers and spills of each build; the L2 -> shared memory floor
  of one block streaming its weights (cp.async against 1-D bulk copies).
With `--probes` only the probes the kernel's layout was chosen by: the
cost of one exchange among the blocks of a persistent grid against a
16-block cluster.sync() (`exchange_probe`), and the time of one product
from resident shared-memory slices at B = 1 and 8 (`product_probe`).
Prints the tables and writes them as JSON to PATH (default
build/bench_ar.json).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import importlib.util
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
# the AR_PHASE(i) marks of this tree's ar_loop.cu (the phase each one starts)
PHASES = ("embed+norm", "glu", "conv", "xch conv", "ffn norm+ff1", "ff2", "xch ff2",
          "ff2 sum", "xch ffn", "norm (+q)", "xch q", "attn units", "xch attn",
          "attn combine+out", "xch attn out", "head", "xch logits", "sampler prep",
          "xch tokens", "sampler top-k", "sampler top-p", "sampler draw", "bookkeeping")
# those of an ar_loop.cu of one 16-block cluster per row (the layout before the whole-card launch)
OLD_PHASES = ("embed", "norm", "glu", "conv", "xch conv", "ffn norm", "ff1+gelu", "ff2", "xch ffn",
              "attn norm+q", "xch q", "attn core", "attn out", "xch attn", "head", "xch logits",
              "sampler", "bookkeeping", "sampler top-k", "sampler top-p", "sampler draw")
EXIT_PHASE, STEP_SLOT = 30, 31
ROWS = (1, 4, 7, 8, 16, 32)
ROW_STEPS, ROW_TEXT = 64, 256
CLOCK_ROWS = (1, 4, 8)  # the phase clocks also at these rows of the serving bucket, fp32

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

# The cost of one exchange among the blocks of a persistent grid, one block
# per SM (512 threads, shared memory that allows one block an SM, launched
# cooperatively so every block is resident): `reps` exchanges in a row, each
# a write of `payload` floats per block into a global buffer, an arrival and
# a wait until every block has arrived, then a read of every block's payload
# (the gather K1 does after each residual update). Arrivals: "counter" (one
# red.release.gpu add on one 64-bit counter, thread 0 spins on it with
# ld.acquire.gpu) or "flags" (each block stores its exchange count to its own
# flag with st.release.gpu; thread i < G spins on flag i). Beside them a
# 16-block cluster.sync() with its payload pushed through DSMEM.
EXCHANGE_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;
__device__ __forceinline__ void arrive_counter(unsigned long long* c) {
  asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(c) : "memory");
}
__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
template <bool kFlags>
__global__ void __launch_bounds__(512, 1) xch_kernel(unsigned long long* sync, float* buf,
    int reps, int payload, float* sink) {
  extern __shared__ float sm[];
  const int G = gridDim.x, j = blockIdx.x, tid = threadIdx.x;
  float acc = 0.f;
  for (int e = 1; e <= reps; ++e) {
    float* half = buf + (size_t)(e & 1) * G * payload;
    for (int i = tid; i < payload; i += blockDim.x) half[(size_t)j * payload + i] = acc + i;
    __syncthreads();
    if (kFlags) {
      if (tid == 0) st_release(sync + j, (unsigned long long)e);
      if (tid < G) while (ld_acquire(sync + tid) < (unsigned long long)e) {}
    } else if (tid == 0) {
      arrive_counter(sync);
      while (ld_acquire(sync) < (unsigned long long)e * G) {}
    }
    __syncthreads();
    for (int i = tid; i < G * payload; i += blockDim.x) acc += __ldcg(half + i);
    sm[tid] = acc;
  }
  if (acc == 1234.5f) sink[j] = acc;
}
__global__ void __launch_bounds__(512, 1) xch_cluster_kernel(int reps, int payload, float* sink) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), r = (int)cl.block_rank(), tid = threadIdx.x;
  float acc = 0.f;
  for (int e = 1; e <= reps; ++e) {
    float* half = sm + (size_t)(e & 1) * cs * payload;
    for (int idx = tid; idx < cs * payload; idx += blockDim.x) {
      const int rr = idx / payload, i = idx - rr * payload;
      cl.map_shared_rank(half, rr)[r * payload + i] = acc + i;
    }
    cl.sync();
    for (int i = tid; i < cs * payload; i += blockDim.x) acc += half[i];
  }
  cl.sync();
  if (acc == 1234.5f) sink[blockIdx.x] = acc;
}
// mode 0 counter, 1 flags, 2 clusters of `blocks` (the grid: 7 clusters)
extern "C" int xch_run(int mode, int blocks, int reps, int payload, unsigned long long* sync,
                       float* buf, float* sink, void* stream) {
  const size_t smem = 150 * 1024;  // one block an SM
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e;
  if (mode == 2) {
    auto k = xch_cluster_kernel;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3(7 * blocks);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    e = cudaLaunchKernelEx(&cfg, k, reps, payload, sink);
  } else {
    auto k = mode == 1 ? xch_kernel<true> : xch_kernel<false>;
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemsetAsync(sync, 0, 256 * sizeof(unsigned long long), (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3(blocks);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    e = cudaLaunchKernelEx(&cfg, k, sync, buf, reps, payload, sink);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
"""


def exchange_probe(dev) -> list:
    """µs per exchange (see EXCHANGE_SRC) at 16, 64, 128 and all SMs' blocks
    with counter and flag arrivals, payloads of 3 and 24 floats per block
    (K1's residual slice at B = 1 and 8), beside 16-block clusters."""
    lib = _build(EXCHANGE_SRC, "exchange_probe")
    fn = lib.xch_run
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sync = torch.zeros(256, dtype=torch.int64, device=dev)
    buf = torch.zeros(2 * 256 * 64, device=dev)
    sink = torch.zeros(256, device=dev)
    reps, rows = 2000, []
    for mode, name in ((0, "counter"), (1, "flags"), (2, "cluster.sync")):
        for blocks in ((16,) if mode == 2 else (16, 64, 128, sms)):
            for payload in (3, 24):

                def run():
                    with kernels.on_device(dev) as stream:
                        kernels.check(fn(mode, blocks, reps, payload, sync.data_ptr(),
                                         buf.data_ptr(), sink.data_ptr(), stream), "exchange probe")

                us = cuda_ms(run, 5) * 1e3 / reps
                rows.append({"arrival": name, "blocks": blocks if mode != 2 else 7 * blocks,
                             "group": blocks, "payload_floats": payload, "us_per_exchange": us})
    return rows



# One product from resident shared-memory slices, as K1 runs it: every block
# of a 132-block grid computes `reps` times the product of its ff1 slice
# (12 columns of D = 384, the largest per layer) with `nb` rows through
# ar_loop.cu's own `dot_slice`, from weights loaded once.
PRODUCT_SRC = r"""
#include "ar_loop.cu"
namespace {
template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __float2bfloat16_rn(v);
}
template <typename T>
__global__ void __launch_bounds__(kConsumers, 1) product_kernel(int rows, int D, int nb, int reps,
                                                                 float* sink) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  T* w = reinterpret_cast<T*>(sm + 16);
  const size_t welems = (size_t)rows * D;
  float* x = sm + 16 + r4((welems * sizeof(T) + 3) / 4);
  float* out = x + (size_t)nb * D;
  int* sched = reinterpret_cast<int*>(out + (size_t)nb * 64);
  for (size_t i = threadIdx.x; i < welems; i += blockDim.x) w[i] = from_f<T>(1e-3f * (float)(i % 97));
  for (int i = threadIdx.x; i < nb * D; i += blockDim.x) x[i] = 1e-2f * (float)(i % 13);
  if (threadIdx.x == 0) {
    sched[0] = 0;
    sched[1] = (int)welems;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
  }
  __syncthreads();
  Stream s{reinterpret_cast<const char*>(w), nullptr, nullptr, nullptr, bar, sched, 1, 1, (int)sizeof(T), 0};
  for (int r = 0; r < reps; ++r) {
    dot_slice<T>(s, rows, D, nb, x, out, 64);
    cbar();
  }
  if (out[0] == 1234.5f) sink[blockIdx.x] = out[1];
}
}  // namespace
extern "C" int product_run(int bf16, int blocks, int rows, int D, int nb, int reps, float* sink, void* stream) {
  const size_t smem = 4 * (16 + (size_t)rows * D + (size_t)nb * D + (size_t)nb * 64 + 16);
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, kConsumers, smem, (cudaStream_t)stream>>>(rows, D, nb, reps, sink);
    return (int)cudaGetLastError();
  };
  return bf16 ? run(product_kernel<__nv_bfloat16>) : run(product_kernel<float>);
}
"""


def product_probe(dev) -> list:
    """µs per resident product (PRODUCT_SRC) at B = 1 and 8 rows, float32
    and bfloat16, over as many blocks as the card has SMs."""
    lib = _build(PRODUCT_SRC, "product_probe")
    fn = lib.product_run
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(sms, device=dev)
    rows, d, reps, out = 12, 384, 2000, []
    for bf16 in (0, 1):
        for nb in (1, 8):

            def run():
                with kernels.on_device(dev) as stream:
                    kernels.check(fn(bf16, sms, rows, d, nb, reps, sink.data_ptr(), stream), "product probe")

            us = cuda_ms(run, 5) * 1e3 / reps
            out.append({"dtype": "bfloat16" if bf16 else "float32", "rows": nb, "columns": rows, "k": d,
                        "us_per_product": us, "gflops_per_block": 2 * rows * d * nb / (us * 1e-6) / 1e9})
    return out


# variants of this tree's ar_loop.cu (text edits of a copy), timed beside it
VARIANTS = {
    "sampler on 4 warps": [("constexpr int kSampWarps = 8; ", "constexpr int kSampWarps = 4; "),
                           ("constexpr int kVpt = 9; ", "constexpr int kVpt = 17; ")],
    "ring of 2 x 48 KB": [("constexpr int kRing = 3; ", "constexpr int kRing = 2; "),
                          ("constexpr int kStage = 8192; ", "constexpr int kStage = 12288; ")],
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
    return cfg, prep["cond_ar"], ctx, step_ctx, model


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



class OldKernel:
    """An `ar_loop.cu` of one 16-block cluster per row (the layout before the
    whole-card launch) with the `ops/ar_loop.py` it came with
    (DIR/../ops/ar_loop.py): its own argument struct, weight-stream packing
    and launch, on this tree's contexts (their `stream` swapped for the old
    packing)."""

    def __init__(self, lib, src_dir: Path):
        path = Path(src_dir).resolve().parent / "ops" / "ar_loop.py"
        spec = importlib.util.spec_from_file_location("sopro_old_ar_loop", path)
        self.mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = self.mod  # its dataclasses look their module up
        spec.loader.exec_module(self.mod)
        self.lib, self._packs = lib, {}

    def _ctx(self, ctx):
        def stream(cs, stacked=ctx.stacked, cfg=ctx.cfg):
            key = (id(stacked["head_w"]), cs)
            if key not in self._packs:
                self._packs[key] = self.mod.pack_ar_stream(stacked, cfg, cs)
            return self._packs[key]

        return dataclasses.replace(ctx, stream=stream)

    def loop(self, ctx, cond, state, settings, n_steps, anti_loop):
        kernels._LIBS["ar_loop"] = self.lib
        return self.mod.ar_loop(self._ctx(ctx), cond, state, settings, n_steps, anti_loop)

    def step(self, ctx, x, bufs):
        kernels._LIBS["ar_loop"] = self.lib
        m, ctx = self.mod, self._ctx(ctx)
        args = m.block_args("ar_step", ctx.cfg, ctx.stacked, ctx.kv_k, ctx.kv_v,
                            ctx.mask.to(torch.int32).contiguous(), bufs)
        logits = torch.empty((x.shape[0], int(ctx.cfg.ar_vocab)), dtype=torch.float32, device=x.device)
        out = torch.empty_like(bufs)
        args.S = args.n_steps = 1
        args.x_in, args.logits, args.bufs_out = x.data_ptr(), logits.data_ptr(), out.data_ptr()
        m.launch("ar_step", "sopro_ar_step", args, x.device, ctx.stream, bufs.dtype)
        return logits, out


class NewKernel:
    """This tree's `ar_loop.cu` (or a variant of it) through this tree's wrappers."""

    def __init__(self, lib):
        self.lib = lib

    def loop(self, ctx, cond, state, settings, n_steps, anti_loop):
        from sopro_tpu_torch.ops.ar_loop import ar_loop

        kernels._LIBS["ar_loop"] = self.lib
        return ar_loop(ctx, cond, state, settings, n_steps, anti_loop)

    def step(self, ctx, x, bufs):
        from sopro_tpu_torch.ops.ar_step import ar_step

        kernels._LIBS["ar_loop"] = self.lib
        return ar_step(ctx, x, bufs)


def load(src_text: str, name: str, defines=(), old_dir=None):
    """Build and load an ar_loop.cu behind its Python wrapper (OldKernel for a
    source of one cluster per row, from `old_dir`)."""
    lib = _build(src_text, name, defines)
    return NewKernel(lib) if hasattr(lib, "sopro_ar_launch_info") else OldKernel(lib, old_dir)


def _fresh(cfg, b, s, dev, dtype=torch.float32):
    from sopro_tpu_torch.models import sopro as M

    c = M.init_ar_carry(cfg, b, s, 7, dev, dtype)
    return {k: getattr(c, k) for k in ("t", "last", "streak", "stopped", "first_eos", "key",
                                       "hist", "bufs")}


def time_kernels(kern, cfg, cond, ctx, step_ctx, dev) -> dict:
    from sopro_tpu_torch.models import sopro as M
    from sopro_tpu_torch.models.generator import conv_ctx

    s = cond.shape[1]
    per_row = M.ARSettings().per_row(1, dev)
    fresh = lambda: _fresh(cfg, 1, s, dev)  # noqa: E731
    with torch.inference_mode():
        tokens, st = kern.loop(ctx, cond, fresh(), per_row, s, True)
        _, st60 = kern.loop(ctx, cond, fresh(), per_row, 60, True)
        x = (cond[:, 0] + step_ctx.emb[-1]).contiguous()
        bufs = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (cfg.n_layers_ar, 1, conv_ctx(cfg), cfg.d_model)).astype(np.float32) * 0.3).to(dev)
        out = {"k1_401_ms": cuda_ms(lambda: kern.loop(ctx, cond, fresh(), per_row, s, True), 5),
               "k1_chunk6_ms": cuda_ms(lambda: kern.loop(ctx, cond, st60, per_row, 6, True), 20),
               "k5_ms": cuda_ms(lambda: kern.step(step_ctx, x, bufs), 50)}
        torch.cuda.synchronize()
    out["steps"] = int(st["t"][0])  # the row may stop before s steps
    out["tokens"] = tokens[0].cpu().tolist()
    out["launch"] = kernels.LAUNCH_INFO.get("ar_loop")
    return out


def row_contexts(models, dev, seed: int) -> dict:
    """(dtype, B) -> (ctx, cond) at the serving text bucket: B random rows of
    text embeddings (different lengths) and conditioning, per model."""
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


def time_rows(kern, contexts, dev) -> dict:
    """µs per step of K1 over ROW_STEPS steps at each (dtype, B) of `contexts`."""
    from sopro_tpu_torch.models import sopro as M

    out = {}
    with torch.inference_mode():
        for (dtype, b), (ctx, cond) in contexts.items():
            per_row = M.ARSettings().per_row(b, dev)
            fresh = lambda: _fresh(ctx.cfg, b, cond.shape[1], dev, dtype)  # noqa: E731
            ms = cuda_ms(lambda: kern.loop(ctx, cond, fresh(), per_row, ROW_STEPS, True), 5)
            out[(str(dtype).replace("torch.", ""), b)] = {
                "us_per_step": ms * 1e3 / ROW_STEPS, "launch": kernels.LAUNCH_INFO.get("ar_loop")}
    return out


def phase_clocks(kern, cfg, cond, ctx, dev, names) -> dict:
    """clock64 cycles per phase of block 0 over a run of cond's length from
    a fresh state of cond's rows."""
    from sopro_tpu_torch.models import sopro as M

    b, s = cond.shape[0], cond.shape[1]
    per_row = M.ARSettings().per_row(b, dev)
    clk = (ctypes.c_ulonglong * 32)()
    with torch.inference_mode():
        for _ in range(2):  # the first run's counts are thrown away
            kern.loop(ctx, cond, _fresh(cfg, b, s, dev, cond.dtype), per_row, s, True)
            torch.cuda.synchronize()
            kernels.check(kern.lib.sopro_ar_clocks(clk), "ar_loop clocks")
    steps = max(1, int(clk[STEP_SLOT]))
    total = sum(int(clk[i]) for i in range(len(names)))
    return {"steps": steps, "cycles_per_step": total / steps,
            "phases": {name: {"cycles_per_step": int(clk[i]) / steps,
                              "share": int(clk[i]) / max(1, total)}
                       for i, name in enumerate(names)}}


def compare(dev, old_src=None, seed: int = 0, variants: bool = False) -> dict:
    """K1 and K5 of this tree (and of `old_src`/ar_loop.cu, and with
    `variants` of VARIANTS): times in turns, K1 per step at ROWS rows in
    float32 and bfloat16, phase clocks, registers and spills, and the
    stream floor."""
    import copy

    new_src = (kernels.CSRC / "ar_loop.cu").read_text()
    builds = {"new": (new_src, "ar_loop_new")}
    if old_src is not None:
        builds["old"] = ((Path(old_src) / "ar_loop.cu").read_text(), "ar_loop_old")
    for i, (name, edits) in enumerate(VARIANTS.items() if variants else ()):
        builds[name] = (variant(new_src, edits), f"ar_loop_v{i}")
    libs, clock_libs = {}, {}
    for name, (text, lib_name) in builds.items():
        libs[name] = load(text, lib_name, old_dir=old_src)
        clock_libs[name] = load(text, lib_name + "_clocks", ["-DSOPRO_AR_CLOCKS"], old_dir=old_src)
    cfg, cond, ctx, step_ctx, model = setup(dev, seed)
    models = {torch.float32: model, torch.bfloat16: copy.deepcopy(model).to(torch.bfloat16)}
    contexts = row_contexts(models, dev, seed)
    order = list(libs) + list(reversed(libs))
    runs = {name: [] for name in libs}
    rows = {name: [] for name in libs}
    for name in order:
        runs[name].append(time_kernels(libs[name], cfg, cond, ctx, step_ctx, dev))
        rows[name].append(time_rows(libs[name], contexts, dev))
    result = {"kernels": {}}
    for name, rs in runs.items():
        med = {k: statistics.median(r[k] for r in rs) for k in ("k1_401_ms", "k1_chunk6_ms", "k5_ms")}
        med["steps"] = rs[0]["steps"]
        med["k1_us_per_step"] = med["k1_401_ms"] * 1e3 / rs[0]["steps"]
        med["tokens_equal_new"] = rs[0]["tokens"] == runs["new"][0]["tokens"]
        med["launch"] = rs[0]["launch"]
        med["rows"] = {f"{dt} B={b}": {"us_per_step": statistics.median(r[(dt, b)]["us_per_step"]
                                                                      for r in rows[name]),
                                      "launch": rows[name][0][(dt, b)]["launch"]}
                       for dt, b in rows[name][0]}
        names = PHASES if isinstance(libs[name], NewKernel) else OLD_PHASES
        med["clocks"] = phase_clocks(clock_libs[name], cfg, cond, ctx, dev, names)
        med["row_clocks"] = {b: phase_clocks(clock_libs[name], cfg, contexts[(torch.float32, b)][1],
                                             contexts[(torch.float32, b)][0], dev, names)
                             for b in CLOCK_ROWS}
        med["ptxas"] = PTXAS.get(builds[name][1], [])
        result["kernels"][name] = med
    kernels._LIBS["ar_loop"] = kernels.lib("ar_loop")
    result["stream_floor"] = stream_floor(dev)
    return result


def report(result: dict) -> None:
    for name, r in result["kernels"].items():
        print(f"{name}: K1 {r['steps']} steps {r['k1_401_ms']:.3f} ms ({r['k1_us_per_step']:.1f} us/step), "
              f"K1 6 steps {r['k1_chunk6_ms']:.3f} ms, K5 {r['k5_ms'] * 1e3:.1f} us; tokens equal "
              f"to new: {r['tokens_equal_new']}; launch {r['launch']}")
        for key, v in r["rows"].items():
            print(f"  K1 {key:16s} {v['us_per_step']:8.1f} us/step over {ROW_STEPS} steps")
        for line in r.get("ptxas", []):
            print(f"  ptxas: {line}")
        c = r["clocks"]
        print(f"  clock64: {c['cycles_per_step']:.0f} cycles per step over {c['steps']} steps")
        for ph, v in c["phases"].items():
            if v["cycles_per_step"]:
                print(f"    {ph:16s} {v['cycles_per_step']:9.0f} cycles {100 * v['share']:5.1f} % "
                      f"~{v['share'] * r['k1_us_per_step']:6.1f} us")
        rc = r["row_clocks"]
        print("  clock64 per step at the serving bucket, B = " + " / ".join(str(b) for b in rc) + ":")
        for ph in rc[CLOCK_ROWS[0]]["phases"]:
            print(f"    {ph:16s} " + " ".join(f"{rc[b]['phases'][ph]['cycles_per_step']:9.0f}" for b in rc))
    print("L2 -> shared memory, one block's 2.6 MB:")
    for r in result["stream_floor"]:
        print(f"  {r['blocks']:3d} blocks, {r['copy']:8s} {r['stages']} x {r['stage_kb']} KB: "
              f"{r['us_per_2.6MB']:.2f} us ({r['GBps_per_block']:.1f} GB/s per block)")


def report_probes(result: dict) -> None:
    for r in result["exchange"]:
        print(f"  exchange {r['arrival']:12s} {r['blocks']:4d} blocks, {r['payload_floats']:2d} "
              f"floats a block: {r['us_per_exchange']:.3f} us")
    for r in result["product"]:
        print(f"  product {r['dtype']:8s} B={r['rows']}: [{r['rows']}, {r['k']}] x [{r['k']}, "
              f"{r['columns']}] {r['us_per_product']:.3f} us ({r['gflops_per_block']:.1f} GFLOP/s a block)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("build/bench_ar.json"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", action="store_true", help="also time VARIANTS")
    ap.add_argument("--probes", action="store_true", help="only the exchange and product probes")
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
    if args.probes:
        result = {"exchange": exchange_probe(dev), "product": product_probe(dev), "card": card}
        report_probes(result)
    else:
        result = dict(compare(dev, args.old_src, args.seed, args.variants), card=card,
                      torch=torch.__version__)
        report(result)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
