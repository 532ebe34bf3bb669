// Error-compensated TF32 ("3xTF32") and bfloat16 helpers of the tensor-core
// kernels K2 (nar_heads.cu) and K3 (seanet.cu).
//
// A float32 x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// (x - hi is exact in float32); a product a.b is then accumulated as
// a_hi.b_lo + a_lo.b_hi + a_hi.b_hi in float32 by the tensor cores: three
// register-A `wgmma` per k step (hopper.cuh), the weights split at pack time,
// the activations as they are read. The dropped a_lo.b_lo and the rounding of
// lo are ~2^-22 of |a.b|, so a K-deep dot product carries the error of a
// float32 one; a single TF32 pass carries ~2^-11 of each term, which breaks
// the port's 1e-4-of-peak bar (see tests/test_torch_tf32x3.py for both,
// emulated on the CPU). The tensor cores truncate each MMA's float32 sum, so
// the kernels sum each chunk of K in a fresh accumulator and add the chunks
// in round-to-nearest float32, which keeps the truncating chains short.
//
// The bfloat16 instantiations run bfloat16 `wgmma` (exact products, float32
// accumulation) and round where the TPU kernels round (`bf16_round`).

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

}  // namespace tf32x3
