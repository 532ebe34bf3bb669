// Kernel K3: the SEANet decoder's convolutions (Mimi vocoder), float32.
//
// Replaces sopro_tpu/codec/pallas_vocoder.py::seanet_decode_pallas (its
// `_seanet_kernel`). The Python wrapper (codec/vocoder.py) launches one conv
// of this file per conv of the decoder plan: the k7 conv 512->1024, then four
// times a polyphase transpose conv (x8, x6, x5, x4) and a residual block
// (k3 conv into a hidden buffer, k1 conv that adds the block input), then the
// final k3 conv to one channel. ELU layers fold into the next conv's input
// load. Activations cross device memory between launches.
//
// What bounds it on the H100: ~130 GFLOP of float32 FMA for 32 s of audio
// (802 frames at 25 Hz -> 769,920 samples) against ~1 GB of activation
// traffic, so it is compute-bound on the CUDA cores (fp32 has no tensor-core
// path; TF32 would break the 1e-4 tolerance). The TPU kernel's answer -- a
// 64-frame time tile with ~30 MB of weights resident in VMEM -- does not fit
// a 227 KB shared memory, so each conv here is an implicit GEMM:
// M = time rows, N = Cout, K = taps * Cin, with 64x64 output tiles, K in
// chunks of 16 through shared memory, a 4x4 register tile per thread, and the
// causal zero padding and dilation applied in the A-tile gather. A transpose
// conv with k = 2s runs as s two-tap convs (grid z = phase r) writing rows
// m*s + r. The one-channel output conv has its own dot-product kernel. One
// fused kernel for the whole stack, and tensor cores, are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

// y[b, t*phases + r, n] = bias[n] (+ residual[same]) +
//   sum_{tap, ci} act(x[b, t - (taps-1-tap)*dil, ci]) * w[r][tap, ci, n]
__global__ void __launch_bounds__(kThreads) conv_gemm_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ residual, float* __restrict__ y, int B, int T, int Cin, int Cout,
    int taps, int dil, int elu_in, int phases) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  const int r = blockIdx.z;
  const float* wr = w + (size_t)r * taps * Cin * Cout;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int M = B * T, K = taps * Cin;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int mm = i / kBK, kk = i - mm * kBK;  // consecutive threads: consecutive channels
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < K) {
        const int tap = k / Cin, ci = k - tap * Cin;
        const int b = m / T, t = m - b * T;
        const int ts = t - (taps - 1 - tap) * dil;
        if (ts >= 0) {
          v = __ldg(x + ((size_t)b * T + ts) * Cin + ci);
          if (elu_in) v = elu(v);
        }
      }
      As[kk][mm] = v;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, nn = i - kk * kBN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < Cout) ? __ldg(wr + (size_t)k * Cout + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int b = m / T, t = m - b * T;
    const size_t row = (size_t)b * T * phases + (size_t)t * phases + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      float v = acc[i][j] + __ldg(bias + n);
      if (residual != nullptr) v += __ldg(residual + row * Cout + n);
      y[row * Cout + n] = v;
    }
  }
}

// One output channel: one thread per time row.
__global__ void conv_out1_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                 const float* __restrict__ bias, float* __restrict__ y, int B,
                                 int T, int Cin, int taps, int dil, int elu_in) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B * T) return;
  const int b = m / T, t = m - b * T;
  float acc = 0.f;
  for (int tap = 0; tap < taps; ++tap) {
    const int ts = t - (taps - 1 - tap) * dil;
    if (ts < 0) continue;
    const float* xr = x + ((size_t)b * T + ts) * Cin;
    const float* wr = w + (size_t)tap * Cin;
    for (int ci = 0; ci < Cin; ++ci) {
      float v = __ldg(xr + ci);
      if (elu_in) v = elu(v);
      acc = fmaf(v, __ldg(wr + ci), acc);
    }
  }
  y[m] = acc + __ldg(bias);
}

}  // namespace

// One causal conv of the decoder plan. x [B, T, Cin]; w [phases, taps, Cin,
// Cout]; bias [Cout]; residual (nullable) and y [B, T*phases, Cout]; all
// float32 contiguous. Returns cudaGetLastError() after the launch.
extern "C" int sopro_seanet_conv(const float* x, const float* w, const float* bias,
                                 const float* residual, float* y, int B, int T, int Cin,
                                 int Cout, int taps, int dil, int elu_in, int phases,
                                 void* stream) {
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || taps <= 0 || dil <= 0 || phases <= 0 ||
      phases > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long M = (long long)B * T;
  if (Cout == 1 && phases == 1 && residual == nullptr) {
    const int threads = 256;
    conv_out1_kernel<<<(unsigned)((M + threads - 1) / threads), threads, 0, s>>>(
        x, w, bias, y, B, T, Cin, taps, dil, elu_in);
  } else {
    const long long gx = (M + kBM - 1) / kBM, gy = (Cout + kBN - 1) / kBN;
    if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)phases);
    conv_gemm_kernel<<<grid, kThreads, 0, s>>>(x, w, bias, residual, y, B, T, Cin, Cout, taps,
                                                dil, elu_in, phases);
  }
  return (int)cudaGetLastError();
}
