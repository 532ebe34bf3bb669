// Kernel K2: NAR stage heads + greedy argmax, float32.
//
// Replaces sopro_tpu/ops/pallas_nar.py::nar_heads_argmax (its `_kernel`).
// Per stage: ids[row, h] = argmax_v((z[row] + hid[h]) . W[h][:, v] + b[h][v]),
// float32 accumulation, bias added in float32, ties to the lowest index.
// The [rows, H, V] logits are never stored: only the ids leave the kernel.
//
// What bounds it on the H100: at the main path's shape (rows = 401,
// hd = 256, V = 2048, H = 3/4/8/16 over the four stages) the four stages are
// ~13 GFLOP of float32 FMA against ~64 MB of weights, so it is compute-bound
// on the CUDA cores (full fp32 has no tensor-core path), and the small stages
// need enough blocks to fill 132 SMs. Design: an SGEMM-style tile per block
// -- 32 rows of (z + hid[h]) resident in shared memory, W streamed through
// shared memory in 16 x 128 chunks with float4 loads, a 2 x 8 register tile
// per thread -- over one V chunk of 512 columns (grid: row tiles x heads x
// V chunks). Each thread keeps a running (max, lowest index) pair per row;
// 16 lanes fold theirs with shuffles, and the V chunks meet through a 64-bit
// atomicMax on (order-preserving float bits, ~index), so equal logits keep
// the lowest index. A last tiny kernel turns the keys into ids.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTM = 32;        // rows per block
constexpr int kTN = 128;       // columns per tile
constexpr int kBK = 16;        // depth per shared-memory chunk
constexpr int kVChunk = 512;   // columns per block (grid z)
constexpr int kThreads = 256;  // 16 row pairs x 16 column lanes

__device__ __forceinline__ unsigned long long pack(float v, int idx) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // monotone in v
  return ((unsigned long long)ord << 32) | (uint32_t)(~(uint32_t)idx);
}

__global__ void __launch_bounds__(kThreads) nar_heads_kernel(
    const float* __restrict__ z, const float* __restrict__ hid, const float* __restrict__ w,
    const float* __restrict__ bias, unsigned long long* __restrict__ keys, int rows, int H,
    int hd, int V) {
  extern __shared__ float smem[];
  float* As = smem;             // [kTM][hd]: z + hid[h]
  float* Bs = As + kTM * hd;    // [kBK][kTN]
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int vbeg = blockIdx.z * kVChunk, vend = min(V, vbeg + kVChunk);

  for (int i = tid; i < kTM * hd; i += kThreads) {
    const int r = i / hd, k = i - r * hd;
    const int row = row0 + r;
    As[i] = row < rows ? z[(size_t)row * hd + k] + hid[(size_t)h * hd + k] : 0.f;
  }
  const float* wh = w + (size_t)h * hd * V;
  const float* bh = bias + (size_t)h * V;
  const bool vec = (V & 3) == 0;

  float best[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {V, V};
  for (int n0 = vbeg; n0 < vend; n0 += kTN) {
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < hd; k0 += kBK) {
      __syncthreads();  // previous chunk consumed (and As written, first time)
      for (int i = tid; i < kBK * (kTN / 4); i += kThreads) {
        const int kk = i / (kTN / 4), c4 = i - kk * (kTN / 4);
        const int k = k0 + kk, n = n0 + c4 * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < hd) {
          const float* src = wh + (size_t)k * V + n;
          if (vec && n + 3 < vend) {
            v = __ldg(reinterpret_cast<const float4*>(src));
          } else {
            if (n < vend) v.x = __ldg(src);
            if (n + 1 < vend) v.y = __ldg(src + 1);
            if (n + 2 < vend) v.z = __ldg(src + 2);
            if (n + 3 < vend) v.w = __ldg(src + 3);
          }
        }
        *reinterpret_cast<float4*>(Bs + kk * kTN + c4 * 4) = v;
      }
      __syncthreads();
      const int kmax = min(kBK, hd - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float a0 = As[(ty * 2) * hd + k0 + kk];
        const float a1 = As[(ty * 2 + 1) * hd + k0 + kk];
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kTN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kTN + 64 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[0][j] = fmaf(a0, bv[j], acc[0][j]);
          acc[1][j] = fmaf(a1, bv[j], acc[1][j]);
        }
      }
    }
    // this thread's columns, in increasing order: a strict '>' keeps the
    // lowest index among equal logits
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col < vend) {
        const float b = __ldg(bh + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float l = acc[i][j] + b;
          if (l > best[i]) {
            best[i] = l;
            best_i[i] = col;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float bv = best[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {  // the 16 lanes sharing these rows
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int row = row0 + ty * 2 + i;
    if (tx == 0 && row < rows && bi < V) atomicMax(keys + (size_t)row * H + h, pack(bv, bi));
  }
}

__global__ void keys_to_ids(const unsigned long long* __restrict__ keys, int* __restrict__ out,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = keys[i] == 0ull ? 0 : (int)(~(uint32_t)(keys[i] & 0xffffffffull));
}

}  // namespace

// z [rows, hd], hid [H, hd], w [H, hd, V], bias [H, V] (float32, contiguous)
// -> out [rows, H] int32, through the scratch `keys` [rows * H] (uint64).
// Returns cudaGetLastError() after the launches.
extern "C" int sopro_nar_heads_argmax(const float* z, const float* hid, const float* w,
                                      const float* bias, int* out, void* keys, int rows, int H,
                                      int hd, int V, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)kTM * hd + kBK * kTN);
  if (rows <= 0 || H <= 0 || hd <= 0 || V <= 0 || H > 65535 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* k = (unsigned long long*)keys;
  const size_t n = (size_t)rows * H;
  cudaError_t e = cudaMemsetAsync(k, 0, n * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((rows + kTM - 1) / kTM, H, (V + kVChunk - 1) / kVChunk);
  nar_heads_kernel<<<grid, kThreads, smem, s>>>(z, hid, w, bias, k, rows, H, hd, V);
  keys_to_ids<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(k, out, (int)n);
  return (int)cudaGetLastError();
}
