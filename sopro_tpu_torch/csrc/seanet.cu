// Kernels K3 and K4: the SEANet decoder's convolutions (Mimi vocoder), float32.
//
// K3 replaces sopro_tpu/codec/pallas_vocoder.py::seanet_decode_pallas and K4
// its streaming variant seanet_decode_pallas_chunk (both run the TPU's
// `_seanet_kernel`). The Python wrappers (codec/vocoder.py) launch one conv of
// this file per conv of the decoder plan: the k7 conv 512->1024, then four
// times a polyphase transpose conv (x8, x6, x5, x4) and a residual block (k3
// conv into a hidden buffer, k1 conv that adds the block input), then the
// final k3 conv to one channel. ELU layers fold into the next conv's input
// load. Activations cross device memory between launches.
//
// The two entry points differ only in where a conv reads its input:
// - `sopro_seanet_conv` (K3, a whole utterance from zero history): causal, so
//   output row t, tap j reads input row t - (taps-1-j)*dil, zero below row 0;
//   every conv keeps the length of its input.
// - `sopro_seanet_conv_valid` (K4, one streaming chunk whose input starts
//   with `halo` real frames of left context): valid mode, so output row t
//   reads input row skip + t + j*dil with no padding at all, and each conv's
//   output shrinks by its receptive field; a residual adds the block input
//   from row `res_off` on (the rows the block's convs consumed), and the
//   final one-channel conv skips the leading rows so that only the chunk's
//   own samples are written. By the valid-region argument (the whole stack's
//   receptive field is `halo` frames) those samples equal a full causal
//   decode of the stream. Early in a stream the history holds fewer than
//   `halo` real frames; the rows before the stream's start then play the
//   causal zero padding of every conv: the wrapper passes, per batch row,
//   the first row of each conv's input that lies at or after the start
//   (`start`, stride `start_stride`), and rows before it read as zero.
//
// What bounds it on the H100: ~130 GFLOP of float32 FMA for 32 s of audio
// (802 frames at 25 Hz -> 769,920 samples) against ~1 GB of activation
// traffic, so a long input is compute-bound on the CUDA cores (fp32 has no
// tensor-core path; TF32 would break the 1e-4 tolerance). A streaming chunk
// of 6 AR frames (ext [1, 20, 512] -> 11,520 samples) is ~2.1 GFLOP over 14
// small launches, so it is bound by launch latency and by filling 132 SMs
// (the first convs have 13-14 rows: one row tile).
// The TPU kernel's answer -- a 64-frame time tile with ~30 MB of weights
// resident in VMEM -- does not fit a 227 KB shared memory, so each conv is an
// implicit GEMM: M = time rows, N = Cout, K = taps * Cin, with 64x64 output
// tiles, K in chunks of 16 through shared memory, a 4x4 register tile per
// thread, and the padding (or its absence) and dilation applied in the A-tile
// gather. A transpose conv with k = 2s runs as s two-tap convs (grid z =
// phase r) writing rows m*s + r. The one-channel output conv has its own
// dot-product kernel. One fused kernel for the whole stack, and tensor
// cores, are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

// Input row read by computed row c, tap `tap`, or -1 when that row is
// padding: below 0 (causal) or below the row's stream start `lo` (valid).
template <bool kCausal>
__device__ __forceinline__ int src_row(int c, int tap, int taps, int dil, int lo) {
  const int ts = kCausal ? c - (taps - 1 - tap) * dil : c + tap * dil;
  return ts >= lo ? ts : -1;
}

__device__ __forceinline__ int row_start(const int* __restrict__ start, int stride, int b) {
  return start != nullptr ? __ldg(start + (size_t)b * stride) : 0;
}

// y[b, t*phases + r, n] = bias[n] (+ residual[b, t + res_off, n]) +
//   sum_{tap, ci} act(x[b, src_row(skip + t, tap), ci]) * w[r][tap, ci, n]
template <bool kCausal>
__global__ void __launch_bounds__(kThreads) conv_gemm_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ residual, float* __restrict__ y, int B, int Tin, int Tout, int skip,
    int Cin, int Cout, int taps, int dil, int elu_in, int phases, int res_T, int res_off,
    const int* __restrict__ start, int start_stride) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN];
  const int r = blockIdx.z;
  const float* wr = w + (size_t)r * taps * Cin * Cout;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int M = B * Tout, K = taps * Cin;
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
        const int b = m / Tout, t = m - b * Tout;
        const int lo = row_start(start, start_stride, b);
        const int ts = src_row<kCausal>(skip + t, tap, taps, dil, lo);
        if (ts >= 0) {
          v = __ldg(x + ((size_t)b * Tin + ts) * Cin + ci);
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
    const int b = m / Tout, t = m - b * Tout;
    const size_t row = (size_t)b * Tout * phases + (size_t)t * phases + r;
    const size_t res_row = (size_t)b * res_T + t + res_off;  // residual only with phases == 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      float v = acc[i][j] + __ldg(bias + n);
      if (residual != nullptr) v += __ldg(residual + res_row * Cout + n);
      y[row * Cout + n] = v;
    }
  }
}

// One output channel: one thread per output row.
template <bool kCausal>
__global__ void conv_out1_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                 const float* __restrict__ bias, float* __restrict__ y, int B,
                                 int Tin, int Tout, int skip, int Cin, int taps, int dil,
                                 int elu_in, const int* __restrict__ start, int start_stride) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= B * Tout) return;
  const int b = m / Tout, t = m - b * Tout;
  const int lo = row_start(start, start_stride, b);
  float acc = 0.f;
  for (int tap = 0; tap < taps; ++tap) {
    const int ts = src_row<kCausal>(skip + t, tap, taps, dil, lo);
    if (ts < 0) continue;
    const float* xr = x + ((size_t)b * Tin + ts) * Cin;
    const float* wr = w + (size_t)tap * Cin;
    for (int ci = 0; ci < Cin; ++ci) {
      float v = __ldg(xr + ci);
      if (elu_in) v = elu(v);
      acc = fmaf(v, __ldg(wr + ci), acc);
    }
  }
  y[m] = acc + __ldg(bias);
}

template <bool kCausal>
int launch(const float* x, const float* w, const float* bias, const float* residual, float* y,
           int B, int Tin, int Tout, int skip, int Cin, int Cout, int taps, int dil, int elu_in,
           int phases, int res_T, int res_off, const int* start, int start_stride,
           cudaStream_t s) {
  const long long M = (long long)B * Tout;
  if (Cout == 1 && phases == 1 && residual == nullptr) {
    const int threads = 256;
    conv_out1_kernel<kCausal><<<(unsigned)((M + threads - 1) / threads), threads, 0, s>>>(
        x, w, bias, y, B, Tin, Tout, skip, Cin, taps, dil, elu_in, start, start_stride);
  } else {
    const long long gx = (M + kBM - 1) / kBM, gy = (Cout + kBN - 1) / kBN;
    if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)phases);
    conv_gemm_kernel<kCausal><<<grid, kThreads, 0, s>>>(x, w, bias, residual, y, B, Tin, Tout,
                                                        skip, Cin, Cout, taps, dil, elu_in,
                                                        phases, res_T, res_off, start,
                                                        start_stride);
  }
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int T, int Cin, int Cout, int taps, int dil, int phases) {
  return B > 0 && T > 0 && Cin > 0 && Cout > 0 && taps > 0 && dil > 0 && phases > 0 &&
         phases <= 65535;
}

}  // namespace

// K3: one causal conv of the decoder plan. x [B, T, Cin]; w [phases, taps,
// Cin, Cout]; bias [Cout]; residual (nullable) and y [B, T*phases, Cout]; all
// float32 contiguous. Returns cudaGetLastError() after the launch.
extern "C" int sopro_seanet_conv(const float* x, const float* w, const float* bias,
                                 const float* residual, float* y, int B, int T, int Cin,
                                 int Cout, int taps, int dil, int elu_in, int phases,
                                 void* stream) {
  if (!shape_ok(B, T, Cin, Cout, taps, dil, phases) || (residual != nullptr && phases != 1))
    return (int)cudaErrorInvalidValue;
  return launch<true>(x, w, bias, residual, y, B, T, T, 0, Cin, Cout, taps, dil, elu_in, phases,
                      T, 0, nullptr, 0, (cudaStream_t)stream);
}

// K4: one valid-mode conv of the decoder plan. x [B, T_in, Cin]; w [phases,
// taps, Cin, Cout]; bias [Cout]; y [B, T_out*phases, Cout], output row t
// reading input rows skip + t + j*dil for taps j; residual (nullable)
// [B, res_T, Cout], added from row res_off + t; start (nullable) int32,
// start[b * start_stride] the first input row of batch row b that is not
// padding. All float32 contiguous. Returns cudaGetLastError() after the
// launch.
extern "C" int sopro_seanet_conv_valid(const float* x, const float* w, const float* bias,
                                       const float* residual, float* y, int B, int T_in,
                                       int T_out, int skip, int Cin, int Cout, int taps, int dil,
                                       int elu_in, int phases, int res_T, int res_off,
                                       const int* start, int start_stride, void* stream) {
  if (!shape_ok(B, T_out, Cin, Cout, taps, dil, phases) || skip < 0 ||
      (long long)skip + T_out + (long long)(taps - 1) * dil > T_in)
    return (int)cudaErrorInvalidValue;
  if (residual != nullptr && (phases != 1 || res_off < 0 || res_off + T_out > res_T))
    return (int)cudaErrorInvalidValue;
  return launch<false>(x, w, bias, residual, y, B, T_in, T_out, skip, Cin, Cout, taps, dil,
                       elu_in, phases, res_T, res_off, start, start_stride,
                       (cudaStream_t)stream);
}
