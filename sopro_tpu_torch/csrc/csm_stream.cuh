// Pieces shared by CSM's two persistent kernels, K6 (csm_depth.cu, a
// frame's depth passes) and K7 (csm_backbone.cu, a frame's backbone step):
// each streams weight rows into a per-SM ring of 32 KB slots by 1-D bulk
// copies (L2 evict-first), meets the other blocks at grid barriers on one
// 64-bit counter, and samples a codebook as `sampling.sample_topk` does.
//
// The grid barrier (an earlier form let a block through one arrival early,
// which moved K6's logits while every toy-size test passed): after a block
// barrier, thread 0 adds one to the launch's counter with atom.acq_rel.gpu
// (`grid_arrive`; the release is cumulative over the block's writes ordered
// by that barrier) and polls it with ld.acquire.gpu until every block has
// arrived (`grid_wait`); a wait of `spin_ns` traps instead of holding the
// card.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace csm {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// An L2 policy that evicts the streamed weights first, so that the exchange,
// the caches and the embedding rows stay in L2 beside the weight stream.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                          uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(hopper::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(hopper::smem_addr(bar)), "l"(pol)
      : "memory");
}

// 16 bytes global -> shared, asynchronous, through L2 (cp.async.cg); a
// thread's copies are done at its cp_async_wait().
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// One thread of a block whose writes a block barrier has just ordered: its
// arrival on the counter; returns the count before it.
__device__ __forceinline__ unsigned long long grid_arrive(unsigned long long* ctr) {
  unsigned long long v;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;\n" : "=l"(v) : "l"(ctr) : "memory");
  return v;
}

// The same thread: wait until the counter reaches `target` (`v` is what
// grid_arrive returned: the block that arrives last sees so and does not
// poll).
__device__ __forceinline__ void grid_wait(unsigned long long* ctr, unsigned long long target,
                                          unsigned long long v, unsigned long long spin_ns) {
  if (v + 1 >= target) return;
  const unsigned long long t0 = globaltimer();
  for (uint32_t tries = 0;; ++tries) {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(ctr) : "memory");
    if (v >= target) return;
    if ((tries & 255) == 255 && globaltimer() - t0 > spin_ns) __trap();
  }
}

// Ordered bits of a float: larger float, larger key (-0 below +0).
__device__ __forceinline__ uint32_t fkey(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The kThreads consumer threads (kWarps warps, named barrier kBar): one
// codebook's pick from its V logits `lg` (written by other blocks: read
// through L2), as `sampling.sample_topk`: nan_to_num, an IEEE division by
// the temperature, every logit at or above the exact k-th largest, the
// argmax of x + the noise `g` [V] with the lowest id on a tie. The logits
// sit in registers, kPer a thread (V <= kPer kThreads). The k-th largest:
// four rounds of an 8-bit radix select over the ordered bits, each a
// histogram (hist[round], 1,024 ints zeroed before the first call and again
// here after their use) that every warp scans itself, lane L over bins 8 L..
// from the top; `red` holds 2 kWarps floats. With kClocks, thread 0 adds the
// cycles of the radix rounds to clk[1] and of the argmax to clk[2].
template <int kThreads, int kPer, int kWarps, int kBar, bool kClocks>
__device__ long long sample_topk(const float* lg, const float* g, int V, float temperature, int top_k,
                                 int* hist_all, float* red, unsigned long long* clk) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float x[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int v = tid + u * kThreads;
    float l = v < V ? __ldcg(lg + v) : 0.f;
    if (isnan(l)) l = -1e9f;
    else if (isinf(l)) l = l > 0.f ? 1e9f : -1e9f;
    x[u] = __fdiv_rn(l, temperature);
  }
  long long tc = 0;
  if constexpr (kClocks) tc = clock64();
  uint32_t prefix = 0u, mask = 0u;
  int krem = min(top_k, V);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int shift = 24 - 8 * r;
    int* hist = hist_all + 256 * r;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (u * kThreads >= V) break;  // the same in every thread
      const uint32_t key = fkey(x[u]);
      if (tid + u * kThreads < V && (key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    hopper::named_sync(kBar, kThreads);
    const int4 h0 = reinterpret_cast<const int4*>(hist)[2 * lane], h1 = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
    const int cnt[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};  // bins 8 lane + b
    const int tot = ((cnt[0] + cnt[1]) + (cnt[2] + cnt[3])) + ((cnt[4] + cnt[5]) + (cnt[6] + cnt[7]));
    int suf = tot;  // elements in this lane's bins and above
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, suf, o);
      if (lane + o < 32) suf += y;
    }
    const bool here = suf - tot < krem && krem <= suf;
    int digit = 0, left = 0, acc = suf - tot;
    bool found = false;
#pragma unroll
    for (int b = 7; b >= 0; --b) {
      if (here && !found && acc + cnt[b] >= krem) {
        digit = 8 * lane + b;
        left = krem - acc;
        found = true;
      }
      acc += cnt[b];
    }
    const int from = __ffs(__ballot_sync(0xffffffffu, here)) - 1;
    prefix |= (uint32_t)__shfl_sync(0xffffffffu, digit, from) << shift;
    mask |= 255u << shift;
    krem = __shfl_sync(0xffffffffu, left, from);
  }
  const float kth = key_float(prefix);
  if constexpr (kClocks) {
    if (tid == 0) clk[1] += clock64() - tc;
    tc = clock64();
  }
  float best = -INFINITY;
  int bi = V;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int v = tid + u * kThreads;
    if (v < V && x[u] >= kth) {
      const float sc = x[u] + __ldg(g + v);
      if (sc > best) best = sc, bi = v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ob > best || (ob == best && oi < bi)) best = ob, bi = oi;
  }
  if (lane == 0) {
    red[warp] = best;
    red[kWarps + warp] = __int_as_float(bi);
  }
  hopper::named_sync(kBar, kThreads);
  best = red[0];
  bi = __float_as_int(red[kWarps]);
  for (int w = 1; w < kWarps; ++w) {
    const float b = red[w];
    const int i = __float_as_int(red[kWarps + w]);
    if (b > best || (b == best && i < bi)) best = b, bi = i;
  }
  for (int i = tid; i < 1024; i += kThreads) hist_all[i] = 0;  // every warp is past its scans
  if constexpr (kClocks) {
    if (tid == 0) clk[2] += clock64() - tc;
  }
  return bi;
}

}  // namespace csm
