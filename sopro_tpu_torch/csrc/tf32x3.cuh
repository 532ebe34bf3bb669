// Error-compensated TF32 ("3xTF32") on the tensor cores, and cp.async.
//
// Shared by kernels K2 (nar_heads.cu) and K3 (seanet.cu). A float32 x is
// split into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x - hi is exact in
// float32); a product a.b is then accumulated as a_hi.b_lo + a_lo.b_hi +
// a_hi.b_hi in float32 by `mma.sync.m16n8k8.f32.tf32.tf32.f32`. The dropped
// a_lo.b_lo and the rounding of lo are ~2^-22 of |a.b|, so a K-deep dot
// product carries the error of a float32 one; a single TF32 pass carries
// ~2^-11 of each term, which breaks the port's 1e-4-of-peak bar (see
// tests/test_torch_tf32x3.py for both, emulated on the CPU).
//
// Why `mma.sync` and not `wgmma`: `wgmma` reads a TF32 B operand from shared
// memory only K-major (the reduction index contiguous), while both kernels'
// weights are [K, N] row-major and their activations are split per element
// on the way into shared memory; m16n8k8 takes any layout through registers,
// and the error-compensated products need three MMAs per fragment pair
// anyway. `wgmma` with TMA-fed, K-major hi/lo tiles is the next step.
//
// The bfloat16 instantiations of K2 and K3 take one pass instead of three
// (`mma1_tile_bf16`): a bfloat16 value is exact in TF32, so one TF32 MMA on
// bfloat16 operands gives their products exactly, with float32 accumulation.
//
// Fragment layout of m16n8k8 (row.col), lane = 4 * g + q:
//   A (16 x 8):  a0 (g, q)  a1 (g + 8, q)  a2 (g, q + 4)  a3 (g + 8, q + 4)
//   B (8 x 8):   b0 (k = q, n = g)  b1 (k = q + 4, n = g)
//   C (16 x 8):  c0 (g, 2q)  c1 (g, 2q + 1)  c2 (g + 8, 2q)  c3 (g + 8, 2q + 1)

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo) as float bit patterns, stored in float arrays.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  const uint32_t h = to_tf32(x);
  hi = __uint_as_float(h);
  lo = __uint_as_float(to_tf32(x - hi));
}

// Not volatile: the compiler may interleave independent MMAs (three
// dependent ones on one accumulator back to back would stall on latency).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[MT][NT] (16 x 8 tiles) += A[16 MT rows, 8 ksteps] . B[8 ksteps, 8 NT cols]
// in three passes. A: hi/lo row-major with stride lda, pointing at the
// warp's first row and first k; B: hi/lo row-major [k][n] with stride ldb,
// pointing at the first k and the warp's first column. Strides are chosen
// by the callers so that the fragment loads hit 32 distinct banks
// (lda = 4 mod 32, ldb = 8 mod 32). Per k step every fragment is loaded
// first, then each pass runs over all MT x NT tiles, so consecutive MMAs
// write different accumulators; the small terms go first.
template <int MT, int NT>
__device__ __forceinline__ void mma3_tile(float (&acc)[MT][NT][4], const float* __restrict__ ahi,
                                          const float* __restrict__ alo, int lda,
                                          const float* __restrict__ bhi,
                                          const float* __restrict__ blo, int ldb, int ksteps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 8;
    uint32_t bh[NT][2], bl[NT][2], ah[MT][4], al[MT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o0 = (k0 + q) * ldb + nt * 8 + g, o1 = o0 + 4 * ldb;
      bh[nt][0] = __float_as_uint(bhi[o0]);
      bh[nt][1] = __float_as_uint(bhi[o1]);
      bl[nt][0] = __float_as_uint(blo[o0]);
      bl[nt][1] = __float_as_uint(blo[o1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = (mt * 16 + g) * lda + k0 + q, r1 = r0 + 8 * lda;
      ah[mt][0] = __float_as_uint(ahi[r0]);
      ah[mt][1] = __float_as_uint(ahi[r1]);
      ah[mt][2] = __float_as_uint(ahi[r0 + 4]);
      ah[mt][3] = __float_as_uint(ahi[r1 + 4]);
      al[mt][0] = __float_as_uint(alo[r0]);
      al[mt][1] = __float_as_uint(alo[r1]);
      al[mt][2] = __float_as_uint(alo[r0 + 4]);
      al[mt][3] = __float_as_uint(alo[r1 + 4]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], ah[mt], bh[nt]);
  }
}

// acc[MT][NT] += A . B in one TF32 pass: A float (TF32-exact values, here
// bfloat16 ones) row-major with stride lda, at the warp's first row and first
// k; B bfloat16 bits row-major [k][n] with stride ldb, at the first k and the
// warp's first column, each widened to its float bits (a bfloat16 is the top
// half of its float) as the fragment is loaded. With 16-bit B, ldb = 16 mod
// 64 puts the fragment loads on 32 distinct banks.
template <int MT, int NT>
__device__ __forceinline__ void mma1_tile_bf16(float (&acc)[MT][NT][4], const float* __restrict__ a,
                                               int lda, const unsigned short* __restrict__ b,
                                               int ldb, int ksteps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 8;
    uint32_t bf[NT][2], af[MT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o0 = (k0 + q) * ldb + nt * 8 + g, o1 = o0 + 4 * ldb;
      bf[nt][0] = (uint32_t)b[o0] << 16;
      bf[nt][1] = (uint32_t)b[o1] << 16;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = (mt * 16 + g) * lda + k0 + q, r1 = r0 + 8 * lda;
      af[mt][0] = __float_as_uint(a[r0]);
      af[mt][1] = __float_as_uint(a[r1]);
      af[mt][2] = __float_as_uint(a[r0 + 4]);
      af[mt][3] = __float_as_uint(a[r1 + 4]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], af[mt], bf[nt]);
  }
}

// float -> bfloat16 -> float, to nearest even (XLA's convert).
__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// A float or bfloat16 element as float, through the read-only cache.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// float -> the element type (bfloat16: to nearest even).
template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// acc += part in round-to-nearest float32. The tensor cores truncate each
// MMA's float32 sum, so a chain of n MMAs on one accumulator can shrink it
// by up to n ulps; the kernels sum each chunk of K (a few MMAs per pass) in
// a fresh accumulator and add the chunks here, which keeps the chains short.
template <int MT, int NT>
__device__ __forceinline__ void add(float (&acc)[MT][NT][4], const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}

// cp.async: 16 bytes (or 4), zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32x3
