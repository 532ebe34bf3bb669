// Kernels K3 and K4: the SEANet decoder's convolutions (Mimi vocoder), float32.
//
// K3 replaces sopro_tpu/codec/pallas_vocoder.py::seanet_decode_pallas and K4
// its streaming variant seanet_decode_pallas_chunk (both run the TPU's
// `_seanet_kernel`). The Python wrappers (codec/vocoder.py) walk the decoder
// plan: the k7 conv 512->1024, then four times a polyphase transpose conv
// (x8, x6, x5, x4) and a residual block (ELU, k3 conv to half the width,
// ELU, k1 conv back, plus the block input), then ELU and the final k3 conv
// to one channel.
//
// K3 (a whole utterance from zero history, causal: output row t, tap j
// reads input row t - (taps-1-j)*dil, zero below row 0) has two kernels,
// both on the tensor cores as 3-pass TF32 (tf32x3.cuh: float32-level error,
// weights split into hi/lo once at pack time, activations as they land in
// shared memory):
// - `conv_tc_kernel` (sopro_seanet_conv_tc): one causal conv as an implicit
//   GEMM, M = time rows of one batch row, N = output columns, K = taps *
//   Cin. A transpose conv with k = 2s is a two-tap conv whose N is s * Cout
//   (phase-major columns: [B*T, s*Cout] is the [B, T*s, Cout] output as it
//   lies in memory). A block owns BM rows x 128 columns and walks Cin in
//   chunks: it loads the chunk's BM + (taps-1)*dil rows (time tile plus the
//   causal halo) once through a cp.async ring, applies the ELU and the
//   split once, and forms every tap from that tile (tap j is the tile
//   shifted by j*dil rows); the chunk's weights for all taps come through
//   the same ring (2-3 stages; two blocks per SM but for the 7-tap conv).
// - `resblock_kernel` (sopro_seanet_resblock): a whole residual block for
//   the 128- and 64-channel stages (3 and 4 of Mimi, whose activations are
//   150-300 MB at B = 1). Per time tile with a 2-row causal halo: ELU ->
//   k3 conv -> hidden in shared memory -> ELU -> k1 conv + block input; the
//   last block also runs ELU -> final k3 conv -> one channel in float32 on
//   the CUDA cores (four threads per output row), recomputing two rows of
//   halo per tile. The hidden and, in the last stage, the block output never
//   reach device memory: the last stage writes only the waveform. C = 128:
//   32-row tiles, weights streamed through a 2-stage cp.async ring in
//   16-row chunks, two blocks per SM. C = 64: all weights resident in shared
//   memory, one persistent 16-warp block per SM walking 64-row tiles with
//   the next tile's input prefetched.
// Every K chunk's products are summed in a fresh accumulator and added in
// float32 (tf32x3::add): on one accumulator through all of K the tensor
// cores' truncation put K3's output ~20x further from the float32 plain
// version (bench_ablation.py on the H100).
//
// K4 (`sopro_seanet_conv_valid`, one streaming chunk whose input starts
// with `halo` real frames of left context) keeps the per-conv float32 kernel
// of its first port: valid mode, so output row t reads input row skip + t +
// j*dil with no padding, each conv's output shrinks by its receptive field;
// a residual adds the block input from row `res_off` on, and the final
// one-channel conv skips the leading rows so that only the chunk's own
// samples are written. By the valid-region argument (the stack's receptive
// field is `halo` frames) those samples equal a full causal decode of the
// stream. Early in a stream the history holds fewer than `halo` real frames;
// the rows before the stream's start then play the causal zero padding of
// every conv: the wrapper passes, per batch row, the first row of each
// conv's input at or after the start (`start`, stride `start_stride`), and
// rows before it read as zero.
//
// What bounds it on the H100: K3 is 132 GFLOP for 32 s of audio (802
// frames at 25 Hz -> 769,920 samples), 0.80 ms at the 3-pass TF32 rate
// (1.98 ms at the float32 CUDA-core rate), against ~0.4 ms of activation
// traffic once the residual blocks of stages 3 and 4 are fused:
// compute-bound. It runs at ~5 ms: each block waits for a chunk, splits
// it, synchronises and only then runs its MMAs, so loads, splits and MMAs
// overlap only across the two blocks of an SM (built without the MMAs the
// launches keep ~60 % of their time, without the conv weight loads ~80 %);
// producer warps feeding `wgmma` consumers through mbarriers are the fix. A streaming chunk of 6 AR frames (ext [1, 20, 512] ->
// 11,520 samples) is ~2.1 GFLOP over 14 small launches: bound by launch
// latency and by filling 132 SMs. K4's kernel: 64x64 output tiles, K in
// chunks of 16, a 4x4 register tile per thread, padding and dilation in the
// A-tile gather, a transpose conv as `phases` two-tap convs (grid z).

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

constexpr int kMaxSmem = 232448;

// ---------------------------------------------------------------------------
// K3 (a): causal conv on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBN = 128, kTcLDB = kTcBN + 8;

// A warp owns 32 rows x 32 columns; BM / 32 x 4 warps per block.
template <int BM, int BKC>
struct ConvTile {
  static constexpr int WGM = BM / 32, WGN = kTcBN / 32;
  static constexpr int THREADS = 32 * WGM * WGN;
  static constexpr int WM = 32, WN = 32;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BKC + 4;  // A fragments on 32 banks
};

template <int BM, int BKC, int STAGES, int TAPS>
size_t conv_tc_smem(int halo) {
  const size_t rows = BM + halo;
  return sizeof(float) * (STAGES * (rows * BKC + 2 * (size_t)TAPS * BKC * kTcLDB) +
                          2 * rows * ConvTile<BM, BKC>::LDA);
}

// y[b, t, n] = bias[n] (+ residual[b, t, n]) +
//   sum_{j, ci} act(x[b, t - (taps-1-j)*dil, ci]) * w[j, ci, n]
// whi / wlo [taps, cinp, np]: the TF32 split of w, zero-padded.
template <int BM, int BKC, int STAGES, int MINB, int TAPS>
__global__ void __launch_bounds__(ConvTile<BM, BKC>::THREADS, MINB) conv_tc_kernel(
    const float* __restrict__ x, const float* __restrict__ whi, const float* __restrict__ wlo,
    const float* __restrict__ bias, const float* __restrict__ residual, float* __restrict__ y,
    int T, int Cin, int cinp, int N, int np, int dil, int elu_in) {
  using Tl = ConvTile<BM, BKC>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int halo = (TAPS - 1) * dil, rows = BM + halo;
  float* araw = smem;                                // [S][rows][BKC]
  float* wring = araw + STAGES * rows * BKC;         // [S][hi, lo][TAPS*BKC][kTcLDB]
  float* a_hi = wring + STAGES * 2 * TAPS * BKC * kTcLDB;  // [rows][LDA]
  float* a_lo = a_hi + rows * Tl::LDA;

  const int tiles = (T + BM - 1) / BM;
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x - b * tiles) * BM;
  const int n0 = blockIdx.y * kTcBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp / Tl::WGN, wn = warp % Tl::WGN;
  const float* xb = x + (size_t)b * T * Cin;
  const bool vec = (Cin & 3) == 0;
  const int nc = cinp / BKC;
  constexpr int wrows = TAPS * BKC;

  auto load = [&](int c, int slot) {
    if (c < nc) {
      const int ci0 = c * BKC;
      float* ad = araw + slot * rows * BKC;
      if (vec) {
        for (int i = tid; i < rows * (BKC / 4); i += Tl::THREADS) {
          const int r = i / (BKC / 4), c4 = (i - r * (BKC / 4)) * 4;
          const int t = t0 - halo + r, ci = ci0 + c4;
          const bool ok = t >= 0 && t < T && ci < Cin;
          tf32x3::cp_async16(ad + r * BKC + c4, ok ? xb + (size_t)t * Cin + ci : x, ok);
        }
      } else {
        for (int i = tid; i < rows * BKC; i += Tl::THREADS) {
          const int r = i / BKC, k = i - r * BKC;
          const int t = t0 - halo + r, ci = ci0 + k;
          const bool ok = t >= 0 && t < T && ci < Cin;
          tf32x3::cp_async4(ad + i, ok ? xb + (size_t)t * Cin + ci : x, ok);
        }
      }
      float* wd = wring + slot * 2 * wrows * kTcLDB;
      for (int i = tid; i < 2 * wrows * (kTcBN / 4); i += Tl::THREADS) {
        const int half = i / (wrows * (kTcBN / 4)), rem = i - half * wrows * (kTcBN / 4);
        const int kk = rem / (kTcBN / 4), c4 = (rem - kk * (kTcBN / 4)) * 4;
        const int j = kk / BKC, ci = ci0 + kk - j * BKC;
        const float* src = (half ? wlo : whi) + ((size_t)j * cinp + ci) * np + n0 + c4;
        tf32x3::cp_async16(wd + (half * wrows + kk) * kTcLDB + c4, src, true);
      }
    }
    tf32x3::cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s, s);

  float acc[Tl::MT][Tl::NT][4];
  tf32x3::zero(acc);
  for (int c = 0; c < nc; ++c) {
    const int slot = c % STAGES;
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c-1
    const float* ad = araw + slot * rows * BKC;
#pragma unroll 4
    for (int i = tid; i < rows * BKC; i += Tl::THREADS) {
      const int r = i / BKC, k = i - r * BKC;
      float v = ad[i];
      if (elu_in) v = elu(v);
      tf32x3::split(v, a_hi[r * Tl::LDA + k], a_lo[r * Tl::LDA + k]);
    }
    __syncthreads();
    load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    const float* wh = wring + slot * 2 * wrows * kTcLDB + wn * Tl::WN;
    float part[Tl::MT][Tl::NT][4];
    tf32x3::zero(part);
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const int ao = (wm * Tl::WM + j * dil) * Tl::LDA;
      tf32x3::mma3_tile<Tl::MT, Tl::NT>(part, a_hi + ao, a_lo + ao, Tl::LDA,
                                        wh + j * BKC * kTcLDB, wh + (wrows + j * BKC) * kTcLDB,
                                        kTcLDB, BKC / 8);
    }
    tf32x3::add(acc, part);
  }

#pragma unroll
  for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = t0 + wm * Tl::WM + mt * 16 + hh * 8 + g;
      if (t >= T) continue;
      const size_t row = ((size_t)b * T + t) * N;
#pragma unroll
      for (int nt = 0; nt < Tl::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * Tl::WN + nt * 8 + 2 * q + e;
          if (n >= N) continue;
          float v = acc[mt][nt][hh * 2 + e] + __ldg(bias + n);
          if (residual != nullptr) v += __ldg(residual + row + n);
          y[row + n] = v;
        }
    }
}

template <int BM, int BKC, int STAGES, int MINB, int TAPS>
int launch_conv_tc(const float* x, const float* whi, const float* wlo, const float* bias,
                   const float* residual, float* y, int B, int T, int Cin, int cinp, int N,
                   int np, int dil, int elu_in, cudaStream_t s) {
  const size_t smem = conv_tc_smem<BM, BKC, STAGES, TAPS>((TAPS - 1) * dil);
  if (smem > kMaxSmem || cinp % BKC != 0) return (int)cudaErrorInvalidValue;
  auto kernel = conv_tc_kernel<BM, BKC, STAGES, MINB, TAPS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long gx = (long long)B * ((T + BM - 1) / BM);
  if (gx > 2147483647LL || np / kTcBN > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (unsigned)(np / kTcBN));
  kernel<<<grid, ConvTile<BM, BKC>::THREADS, smem, s>>>(x, whi, wlo, bias, residual, y, T, Cin, cinp, N, np, dil,
                                        elu_in);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3 (b): fused residual block (and, for the last one, the final conv)
// ---------------------------------------------------------------------------

constexpr int kRbBK = 16;

// C = 64 (stage 4): all the block's weights (64 KB as hi/lo) stay in shared
// memory, and each block (one per SM) walks time tiles grid-stride,
// prefetching the next tile's input window while it computes this one.
// C = 128 (stage 3, 260 KB of weights): the weights stream through a 2-stage
// ring in 16-row chunks, one tile per block, two blocks per SM.
template <int C, bool kFinal>
struct ResTile {
  static constexpr bool RESIDENT = C == 64;
  static constexpr int CH = C / 2;
  static constexpr int BM = C == 128 ? 32 : 64;   // rows of hidden / block output per tile
  static constexpr int STAGES = 2;                // weight ring depth when streamed
  static constexpr int HF = kFinal ? 2 : 0;       // halo rows of the final k3 conv
  static constexpr int BMO = BM - HF;             // output rows per tile
  static constexpr int RX = BM + 2;               // input rows: the k3 conv's halo
  static constexpr int WGM = RESIDENT ? 4 : BM / 32, WGN = RESIDENT ? 4 : 8;
  static constexpr int THREADS = 32 * WGM * WGN;
  static constexpr int WM = BM / WGM, MT = WM / 16;
  static constexpr int WN1 = CH / WGN, NT1 = WN1 / 8;
  static constexpr int WN2 = C / WGN, NT2 = WN2 / 8;
  static constexpr int LDX = C + 4, LDH = CH + 4, LDW = C + 8, LDO = C + 4;
  static constexpr int N1 = 3 * C / kRbBK, N2 = CH / kRbBK;  // weight chunks of each conv
  static constexpr int SLOTS = RESIDENT ? N1 + N2 : STAGES;
  static constexpr int XBUF = RESIDENT ? 2 : 1;   // input windows in flight
  static constexpr size_t SMEM = sizeof(float) * ((size_t)(XBUF + 2) * RX * LDX + 2 * BM * LDH +
                                                  (size_t)SLOTS * 2 * kRbBK * LDW);
  static constexpr int MINB = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;  // blocks per SM
  static_assert(THREADS / 4 >= BMO, "the final conv takes four threads per output row");
};

// x [B, T, C] -> y = x + conv1(elu(conv3(elu(x)))) [B, T, C], or with kFinal
// wav [B, T] = final3(elu(y)). w1hi / w1lo [3*C, C/2] (row j*C + ci: tap j),
// b1 [C/2], w2hi / w2lo [C/2, C], b2 [C], wf [3*C], bf [1]. Tile i of batch
// row b holds times t0 = i * BMO.. of row b; its input window starts at
// t0 - HF - 2.
template <int C, bool kFinal>
__global__ void __launch_bounds__(ResTile<C, kFinal>::THREADS, ResTile<C, kFinal>::MINB) resblock_kernel(
    const float* __restrict__ x, const float* __restrict__ w1hi, const float* __restrict__ w1lo,
    const float* __restrict__ b1, const float* __restrict__ w2hi, const float* __restrict__ w2lo,
    const float* __restrict__ b2, const float* __restrict__ wf, const float* __restrict__ bf,
    float* __restrict__ y, int B, int T) {
  using R = ResTile<C, kFinal>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xbuf = smem;                               // [XBUF][RX][LDX] block input windows
  float* ex_hi = xbuf + R::XBUF * R::RX * R::LDX;   // [RX][LDX] elu(x) split; later the final conv's input
  float* ex_lo = ex_hi + R::RX * R::LDX;
  float* h_hi = ex_lo + R::RX * R::LDX;             // [BM][LDH] elu(hidden) split
  float* h_lo = h_hi + R::BM * R::LDH;
  float* ring = h_lo + R::BM * R::LDH;              // [SLOTS][hi, lo][kRbBK][LDW]

  const int tiles = (T + R::BMO - 1) / R::BMO, ntiles = B * tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp / R::WGN, wn = warp % R::WGN;

  auto load_w = [&](int c, int slot) {  // weight chunk c (16 rows of w1, then of w2)
    if (c < R::N1 + R::N2) {
      const bool first = c < R::N1;
      const int width = first ? R::CH : C, k0 = (first ? c : c - R::N1) * kRbBK;
      const float* hi = first ? w1hi : w2hi;
      const float* lo = first ? w1lo : w2lo;
      float* d = ring + slot * 2 * kRbBK * R::LDW;
      const int per_half = kRbBK * (width / 4);
      for (int i = tid; i < 2 * per_half; i += R::THREADS) {
        const int half = i / per_half, rem = i - half * per_half;
        const int kk = rem / (width / 4), c4 = (rem - kk * (width / 4)) * 4;
        tf32x3::cp_async16(d + (half * kRbBK + kk) * R::LDW + c4,
                           (half ? lo : hi) + (size_t)(k0 + kk) * width + c4, true);
      }
    }
  };
  auto load_x = [&](int tile, float* dst) {  // tile's input window; rows outside [0, T) zero
    if (tile < ntiles) {
      const int b = tile / tiles, tx0 = (tile - b * tiles) * R::BMO - R::HF - 2;
      const float* xb = x + (size_t)b * T * C;
      for (int i = tid; i < R::RX * (C / 4); i += R::THREADS) {
        const int r = i / (C / 4), c4 = (i - r * (C / 4)) * 4, t = tx0 + r;
        const bool ok = t >= 0 && t < T;
        tf32x3::cp_async16(dst + r * R::LDX + c4, ok ? xb + (size_t)t * C + c4 : x, ok);
      }
    }
  };

  int tile = blockIdx.x;
  load_x(tile, xbuf);
  if (R::RESIDENT) {
    for (int c = 0; c < R::N1 + R::N2; ++c) load_w(c, c);
    tf32x3::cp_async_commit();
  } else {
#pragma unroll
    for (int s = 0; s < R::STAGES - 1; ++s) {  // chunk 0 joins the window's group
      load_w(s, s);
      tf32x3::cp_async_commit();
    }
  }

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int b = tile / tiles, t0 = (tile - b * tiles) * R::BMO;
    const float* xraw = xbuf + (it & (R::XBUF - 1)) * R::RX * R::LDX;
    if (R::RESIDENT) {  // the other window was freed by the previous tile's last barrier
      load_x(tile + gridDim.x, xbuf + ((it + 1) & 1) * R::RX * R::LDX);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<R::STAGES - 2>();
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < R::RX * C; i += R::THREADS) {  // rows before t = 0 are zero: elu(0) = 0
      const int r = i / C, k = i - r * C;
      tf32x3::split(elu(xraw[r * R::LDX + k]), ex_hi[r * R::LDX + k], ex_lo[r * R::LDX + k]);
    }
    if (R::RESIDENT) __syncthreads();

    float acc1[R::MT][R::NT1][4], acc2[R::MT][R::NT2][4];
    tf32x3::zero(acc1);
    tf32x3::zero(acc2);
    for (int c = 0; c < R::N1 + R::N2; ++c) {
      if (!R::RESIDENT) {
        tf32x3::cp_async_wait<R::STAGES - 2>();
        __syncthreads();  // chunk c landed; every warp is done with chunk c-1 (and the split)
        load_w(c + R::STAGES - 1, (c + R::STAGES - 1) % R::STAGES);
        tf32x3::cp_async_commit();
      }
      const float* wh = ring + (R::RESIDENT ? c : c % R::STAGES) * 2 * kRbBK * R::LDW;
      if (c < R::N1) {  // hidden row i = sum_j elu(x)[window row i + j] . w1[j]
        const int j = c * kRbBK / C, ci0 = c * kRbBK - j * C;
        const int ao = (wm * R::WM + j) * R::LDX + ci0;
        float part[R::MT][R::NT1][4];
        tf32x3::zero(part);
        tf32x3::mma3_tile<R::MT, R::NT1>(part, ex_hi + ao, ex_lo + ao, R::LDX, wh + wn * R::WN1,
                                         wh + kRbBK * R::LDW + wn * R::WN1, R::LDW, kRbBK / 8);
        tf32x3::add(acc1, part);
      } else {
        const int ao = wm * R::WM * R::LDH + (c - R::N1) * kRbBK;
        tf32x3::mma3_tile<R::MT, R::NT2>(acc2, h_hi + ao, h_lo + ao, R::LDH, wh + wn * R::WN2,
                                         wh + kRbBK * R::LDW + wn * R::WN2, R::LDW, kRbBK / 8);
      }
      if (c == R::N1 - 1) {  // elu(hidden + b1), split, into shared memory
#pragma unroll
        for (int mt = 0; mt < R::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < R::NT1; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = wm * R::WM + mt * 16 + (e >> 1) * 8 + g;
              const int n = wn * R::WN1 + nt * 8 + 2 * q + (e & 1);
              tf32x3::split(elu(acc1[mt][nt][e] + __ldg(b1 + n)), h_hi[i * R::LDH + n],
                            h_lo[i * R::LDH + n]);
            }
        __syncthreads();
      }
    }

    // block output row i (time t0 - HF + i) = acc2 + b2 + x[window row i + 2]
    float* outb = ex_hi;  // [BM][LDO]: elu(block output), the final conv's input
#pragma unroll
    for (int mt = 0; mt < R::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < R::NT2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = wm * R::WM + mt * 16 + (e >> 1) * 8 + g;
          const int n = wn * R::WN2 + nt * 8 + 2 * q + (e & 1);
          const float v = acc2[mt][nt][e] + __ldg(b2 + n) + xraw[(i + 2) * R::LDX + n];
          const int t = t0 - R::HF + i;
          if (kFinal) {
            outb[i * R::LDO + n] = t >= 0 ? elu(v) : 0.f;  // causal zero padding
          } else if (t < T) {
            y[((size_t)b * T + t) * C + n] = v;
          }
        }
    if (kFinal) {  // output row o (time t0 + o): four threads, each a quarter of the 3C terms
      __syncthreads();
      const int o = tid >> 2, sub = tid & 3;
      float s = 0.f;
      if (o < R::BMO) {
#pragma unroll 8
        for (int k = 0; k < 3 * C / 4; ++k) {
          const int p = sub + 4 * k, j = p / C, ci = p - j * C;
          s = fmaf(outb[(o + j) * R::LDO + ci], __ldg(wf + p), s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (sub == 0 && o < R::BMO && t0 + o < T) y[(size_t)b * T + t0 + o] = s + __ldg(bf);
    }
    __syncthreads();  // the tile's buffers are free for the next one
  }
}

template <int C, bool kFinal>
int launch_resblock(const float* x, const float* w1hi, const float* w1lo, const float* b1,
                    const float* w2hi, const float* w2lo, const float* b2, const float* wf,
                    const float* bf, float* y, int B, int T, cudaStream_t s) {
  using R = ResTile<C, kFinal>;
  static_assert(R::SMEM <= kMaxSmem, "resblock tile exceeds shared memory");
  auto kernel = resblock_kernel<C, kFinal>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (long long)B * ((T + R::BMO - 1) / R::BMO);
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  long long grid = ntiles;
  if (R::RESIDENT) {  // as many blocks as fit at once; each walks tiles grid-stride
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, R::THREADS,
                                                           R::SMEM)) != cudaSuccess)
      return (int)e;
    grid = ntiles < (long long)sms * per_sm ? ntiles : (long long)sms * per_sm;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  kernel<<<(unsigned)grid, R::THREADS, R::SMEM, s>>>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y,
                                                     B, T);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: valid-mode per-conv kernel, float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

// Input row read by computed row c, tap `tap`, or -1 when that row is
// before the row's stream start `lo`.
__device__ __forceinline__ int src_row(int c, int tap, int dil, int lo) {
  const int ts = c + tap * dil;
  return ts >= lo ? ts : -1;
}

__device__ __forceinline__ int row_start(const int* __restrict__ start, int stride, int b) {
  return start != nullptr ? __ldg(start + (size_t)b * stride) : 0;
}

// y[b, t*phases + r, n] = bias[n] (+ residual[b, t + res_off, n]) +
//   sum_{tap, ci} act(x[b, src_row(skip + t, tap), ci]) * w[r][tap, ci, n]
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
        const int ts = src_row(skip + t, tap, dil, lo);
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
    const int ts = src_row(skip + t, tap, dil, lo);
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

bool shape_ok(int B, int T, int Cin, int Cout, int taps, int dil, int phases) {
  return B > 0 && T > 0 && Cin > 0 && Cout > 0 && taps > 0 && dil > 0 && phases > 0 &&
         phases <= 65535;
}

}  // namespace

// K3 (a): one causal conv. x [B, T, Cin]; whi / wlo [taps, cinp, np] (the
// TF32 split of w [taps, Cin, N], zero-padded: cinp a multiple of 32, np of
// 128); bias [N]; residual (nullable) and y [B, T, N]; all float32
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int sopro_seanet_conv_tc(const float* x, const float* whi, const float* wlo,
                                    const float* bias, const float* residual, float* y, int B,
                                    int T, int Cin, int cinp, int N, int np, int taps, int dil,
                                    int elu_in, void* stream) {
  if (B <= 0 || T <= 0 || Cin <= 0 || N <= 0 || taps <= 0 || dil <= 0 || cinp < Cin ||
      cinp % 32 != 0 || np < N || np % kTcBN != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // 64-row tiles, taps * BKC weight rows per ring stage (32, 32, 24, 56 for
  // 1, 2, 3, 7 taps); two blocks per SM where the ring fits in half the
  // shared memory, so one block's loads and splits overlap the other's MMAs
  if (taps == 1)
    return launch_conv_tc<64, 32, 2, 2, 1>(x, whi, wlo, bias, residual, y, B, T, Cin, cinp, N,
                                           np, dil, elu_in, s);
  if (taps == 2)
    return launch_conv_tc<64, 16, 2, 2, 2>(x, whi, wlo, bias, residual, y, B, T, Cin, cinp, N,
                                           np, dil, elu_in, s);
  if (taps == 3)
    return launch_conv_tc<64, 8, 3, 2, 3>(x, whi, wlo, bias, residual, y, B, T, Cin, cinp, N,
                                          np, dil, elu_in, s);
  if (taps == 7)
    return launch_conv_tc<64, 8, 3, 1, 7>(x, whi, wlo, bias, residual, y, B, T, Cin, cinp, N,
                                          np, dil, elu_in, s);
  return (int)cudaErrorInvalidValue;
}

// K3 (b): one residual block of C = 128 or 64 channels, causal, k3 conv
// dilation 1. final = 0: y [B, T, C]; final = 1: also the final k3 conv to
// one channel, y [B, T]. Weights as in resblock_kernel. Returns
// cudaGetLastError() after the launch.
extern "C" int sopro_seanet_resblock(const float* x, const float* w1hi, const float* w1lo,
                                     const float* b1, const float* w2hi, const float* w2lo,
                                     const float* b2, const float* wf, const float* bf, float* y,
                                     int B, int T, int C, int final, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 128 && !final) return launch_resblock<128, false>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, B, T, s);
  if (C == 128 && final) return launch_resblock<128, true>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, B, T, s);
  if (C == 64 && !final) return launch_resblock<64, false>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, B, T, s);
  if (C == 64 && final) return launch_resblock<64, true>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, B, T, s);
  return (int)cudaErrorInvalidValue;
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
  const cudaStream_t s = (cudaStream_t)stream;
  const long long M = (long long)B * T_out;
  if (Cout == 1 && phases == 1 && residual == nullptr) {
    const int threads = 256;
    conv_out1_kernel<<<(unsigned)((M + threads - 1) / threads), threads, 0, s>>>(
        x, w, bias, y, B, T_in, T_out, skip, Cin, taps, dil, elu_in, start, start_stride);
  } else {
    const long long gx = (M + kBM - 1) / kBM, gy = (Cout + kBN - 1) / kBN;
    if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)phases);
    conv_gemm_kernel<<<grid, kThreads, 0, s>>>(x, w, bias, residual, y, B, T_in, T_out, skip, Cin,
                                               Cout, taps, dil, elu_in, phases, res_T, res_off,
                                               start, start_stride);
  }
  return (int)cudaGetLastError();
}
