// Kernels K3 and K4: the SEANet decoder's convolutions (Mimi vocoder), float32
// or bfloat16.
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
// K4 (one streaming chunk whose input starts with `halo` real frames of left
// context) runs the same two kernels and the same launch list in valid mode.
// Both kernels take T_in input rows and T_out output rows per batch row, and
// output row t is the causal result at input row a0 + t, a0 = T_in - T_out:
// K3 has a0 = 0; in K4 every conv's output shrinks by its receptive field
// (a0 = (taps-1)*dil), a residual adds the block input's last rows, and the
// last launch keeps only the chunk's own samples. By the valid-region
// argument (the stack's receptive field is `halo` frames) those samples equal
// a full causal decode of the stream. Early in a stream the history holds
// fewer than `halo` real frames; the rows before the stream's start then play
// the causal zero padding of every conv: the wrapper passes, per batch row,
// the first row of each launch's input at or after the start (`start`,
// stride `start_stride`), and rows before it read as zero (K3: row 0). In a
// fused residual block that masks the block input, and the final conv's
// input rows before the same start; the hidden rows before it only feed
// block-output rows that the next launch masks.
//
// A chunk of 6 AR frames has 13-20 rows in its first convs (k7: M = 14, N =
// 1,024, K = 3,584): 8 column tiles of one row tile. So the conv kernel takes
// 16-row tiles where T_out < 128 and splits the Cin chunks over the blocks
// of a thread-block cluster (grid z, up to 16), as many as it takes to give
// every SM a block in one wave; the partial tiles meet through distributed
// shared memory, each rank summing its share of the tile over the ranks in
// rank order (no atomics: a repeated call is bit-identical). K3 passes
// max_splits = 1.
//
// What bounds it on the H100: K3 is 132 GFLOP for 32 s of audio (802
// frames at 25 Hz -> 769,920 samples), 0.80 ms at the 3-pass TF32 rate
// (1.98 ms at the float32 CUDA-core rate), against ~0.4 ms of activation
// traffic once the residual blocks of stages 3 and 4 are fused:
// compute-bound. It runs at ~5 ms: each block waits for a chunk, splits
// it, synchronises and only then runs its MMAs, so loads, splits and MMAs
// overlap only across the two blocks of an SM (built without the MMAs the
// launches keep ~60 % of their time, without the conv weight loads ~80 %);
// producer warps feeding `wgmma` consumers through mbarriers are the fix. A
// streaming chunk of 6 AR frames (ext [1, 20, 512] -> 11,520 samples) is
// ~2.1 GFLOP, 0.013 ms at the 3-pass rate, but ~120 MB of hi/lo weights
// (more than L2 holds, so read from HBM every chunk, ~0.035 ms): K4 is bound
// by those bytes and by the latency of its 11 dependent launches.
//
// The bfloat16 instantiations (sopro_seanet_conv_tc_bf16,
// sopro_seanet_resblock_bf16) compute what the TPU kernel computes on
// bfloat16 inputs: every conv accumulates in float32, adds its bias in float32
// and rounds to bfloat16; every ELU runs in float32 on bfloat16 and rounds;
// a residual add adds two bfloat16 values and rounds; the fused blocks round
// their hidden and their block output (which stay in shared memory) at the
// same points, and the waveform leaves as bfloat16. Design (a): the same TF32
// m16n8k8 MMAs in ONE pass (tf32x3::mma1_tile_bf16) -- a bfloat16 value is
// exact in TF32, so one pass gives the bfloat16 products exactly with float32
// accumulation -- rather than (b), bf16 m16n8k16, whose fragment layouts the
// tiles here do not have. Weights and activations are read as bfloat16 (half
// the float32 bytes, a third of the hi/lo pair's) into shared memory; the
// activations are widened (and ELU'd and rounded) once per chunk into float
// A tiles, the weights as each B fragment is loaded. K3 in bfloat16 is bound
// by its products at the TF32 rate: 132 GFLOP / 495 TF/s = 0.27 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

constexpr int kMaxSmem = 232448;
constexpr int kMaxSplits = 16;

// Per kernel instantiation and device, what a launch asks of the CUDA runtime,
// asked once: the dynamic shared memory allowed so far, the SM count, the
// blocks of one kind that fit an SM, and the clusters of 2, 4, 8 and 16
// blocks that can be resident at once (at `cluster_smem` bytes). A chunk of
// K4 is 11 launches of a few microseconds each.
struct LaunchCache {
  int smem = 0, sms = 0, per_sm = -1, cluster_smem = -1;
  int clusters[5] = {-1, -1, -1, -1, -1};  // index log2(splits)
};
constexpr int kMaxDevices = 16;

template <typename Kernel>
cudaError_t prepare(Kernel kernel, LaunchCache* caches, size_t smem, LaunchCache*& c) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  c = caches + dev;
  if ((int)smem > c->smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    c->smem = (int)smem;
  }
  if (c->sms == 0) e = cudaDeviceGetAttribute(&c->sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

__device__ __forceinline__ int row_start(const int* __restrict__ start, int stride, int b) {
  return start != nullptr ? __ldg(start + (size_t)b * stride) : 0;
}

// ---------------------------------------------------------------------------
// K3 / K4 (a): one conv on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBN = 128, kTcLDB = kTcBN + 8;
constexpr int kTcLDB16 = kTcBN + 16;  // the bfloat16 weight ring's row stride (B fragments on 32 banks)
constexpr int kTcLDR = kTcBN + 4;  // split-K partial tile row stride (float4 rows)

// A warp owns WM = min(BM, 32) rows x 32 columns; BM / WM x 4 warps per block.
template <int BM, int BKC>
struct ConvTile {
  static constexpr int WM = BM < 32 ? BM : 32, WN = 32;
  static constexpr int WGM = BM / WM, WGN = kTcBN / WN;
  static constexpr int THREADS = 32 * WGM * WGN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BKC + 4;  // A fragments on 32 banks
};

// One conv launch. Output row t of batch row b is the causal conv at input
// row a0 + t (a0 = T_in - T_out): tap j reads input row a0 + t - (taps-1-j)*dil,
// and input rows before row_start(start, start_stride, b) or past T_in read
// as zero. The residual (nullable) adds row t + res_T - T_out of [B, res_T, N].
// E: float (whi / wlo the TF32 split of w) or __nv_bfloat16 (whi the weights
// themselves, wlo unused): the element type of x, the weights, bias,
// residual and y.
template <typename E>
struct ConvArgs {
  const E *x, *whi, *wlo, *bias, *residual;
  E* y;
  const int* start;
  int start_stride, B, T_in, T_out, res_T, Cin, cinp, N, np, dil, elu_in;
  int splits;  // blocks of a cluster (grid z) sharing the Cin chunks of one tile
};

template <int BM, int BKC, int STAGES, int TAPS, typename E>
size_t conv_tc_smem(int halo) {
  const size_t rows = BM + halo;
  size_t ring;
  if constexpr (std::is_same<E, float>::value)
    ring = sizeof(float) * (STAGES * (rows * BKC + 2 * (size_t)TAPS * BKC * kTcLDB) +
                            2 * rows * ConvTile<BM, BKC>::LDA);
  else  // [S][rows][BKC] and [S][TAPS*BKC][kTcLDB16] bfloat16, then the float A tile
    ring = sizeof(E) * STAGES * (rows * BKC + (size_t)TAPS * BKC * kTcLDB16) +
           sizeof(float) * rows * ConvTile<BM, BKC>::LDA;
  const size_t red = sizeof(float) * BM * kTcLDR;  // the split-K partial tile, after the ring
  return ring > red ? ring : red;
}

// y[b, t, n] = bias[n] (+ residual) + sum_{j, ci} act(x[b, a0 + t - (taps-1-j)*dil, ci]) * w[j, ci, n]
// whi / wlo [taps, cinp, np]: the TF32 split of w, zero-padded. Grid: (B *
// row tiles, np / 128, splits); the blocks of one cluster (grid z) take
// consecutive ranges of the Cin chunks.
template <int BM, int BKC, int STAGES, int MINB, int TAPS, typename E>
__global__ void __launch_bounds__(ConvTile<BM, BKC>::THREADS, MINB) conv_tc_kernel(const ConvArgs<E> a) {
  using Tl = ConvTile<BM, BKC>;
  constexpr bool kF32 = std::is_same<E, float>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int halo = (TAPS - 1) * a.dil, rows = BM + halo;
  float* araw = smem;                                // [S][rows][BKC]
  float* wring = araw + STAGES * rows * BKC;         // [S][hi, lo][TAPS*BKC][kTcLDB]
  float* a_hi = wring + STAGES * 2 * TAPS * BKC * kTcLDB;  // [rows][LDA]
  float* a_lo = a_hi + rows * Tl::LDA;
  // bfloat16: araw16 [S][rows][BKC], wring16 [S][TAPS*BKC][kTcLDB16], then a_hi
  E* araw16 = reinterpret_cast<E*>(smem);
  unsigned short* wring16 = reinterpret_cast<unsigned short*>(araw16 + STAGES * rows * BKC);
  if constexpr (!kF32) a_hi = reinterpret_cast<float*>(wring16 + STAGES * TAPS * BKC * kTcLDB16);

  const int tiles = (a.T_out + BM - 1) / BM;
  const int b = blockIdx.x / tiles, t0 = (blockIdx.x - b * tiles) * BM;
  const int n0 = blockIdx.y * kTcBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp / Tl::WGN, wn = warp % Tl::WGN;
  const int Cin = a.Cin, np = a.np, cinp = a.cinp;
  const E* xb = a.x + (size_t)b * a.T_in * Cin;
  const int r0 = a.T_in - a.T_out + t0 - halo;        // input row of tile row 0
  const int lo = row_start(a.start, a.start_stride, b);
  const bool vec = kF32 ? (Cin & 3) == 0 : (Cin & 7) == 0;  // 16-byte copies
  const int nc = cinp / BKC, split = blockIdx.z;
  const int c0 = split * nc / a.splits, nloc = (split + 1) * nc / a.splits - c0;
  constexpr int wrows = TAPS * BKC;

  auto load = [&](int i, int slot) {  // chunk c0 + i of this block's range
    if constexpr (!kF32) {
      if (i < nloc) {
        const int ci0 = (c0 + i) * BKC;
        E* ad = araw16 + slot * rows * BKC;
        if (vec) {
          for (int e = tid; e < rows * (BKC / 8); e += Tl::THREADS) {
            const int r = e / (BKC / 8), c8 = (e - r * (BKC / 8)) * 8;
            const int t = r0 + r, ci = ci0 + c8;
            const bool ok = t >= lo && t < a.T_in && ci < Cin;
            tf32x3::cp_async16(ad + r * BKC + c8, ok ? xb + (size_t)t * Cin + ci : a.x, ok);
          }
        } else {  // no 2-byte cp.async: plain loads, visible after the barrier that takes the chunk
          for (int e = tid; e < rows * BKC; e += Tl::THREADS) {
            const int r = e / BKC, k = e - r * BKC;
            const int t = r0 + r, ci = ci0 + k;
            ad[e] = t >= lo && t < a.T_in && ci < Cin ? xb[(size_t)t * Cin + ci] : tf32x3::from_f<E>(0.f);
          }
        }
        unsigned short* wd = wring16 + slot * wrows * kTcLDB16;
        for (int e = tid; e < wrows * (kTcBN / 8); e += Tl::THREADS) {
          const int kk = e / (kTcBN / 8), c8 = (e - kk * (kTcBN / 8)) * 8;
          const int j = kk / BKC, ci = ci0 + kk - j * BKC;
          tf32x3::cp_async16(wd + kk * kTcLDB16 + c8, a.whi + ((size_t)j * cinp + ci) * np + n0 + c8, true);
        }
      }
    } else if (i < nloc) {
      const int ci0 = (c0 + i) * BKC;
      float* ad = araw + slot * rows * BKC;
      if (vec) {
        for (int e = tid; e < rows * (BKC / 4); e += Tl::THREADS) {
          const int r = e / (BKC / 4), c4 = (e - r * (BKC / 4)) * 4;
          const int t = r0 + r, ci = ci0 + c4;
          const bool ok = t >= lo && t < a.T_in && ci < Cin;
          tf32x3::cp_async16(ad + r * BKC + c4, ok ? xb + (size_t)t * Cin + ci : a.x, ok);
        }
      } else {
        for (int e = tid; e < rows * BKC; e += Tl::THREADS) {
          const int r = e / BKC, k = e - r * BKC;
          const int t = r0 + r, ci = ci0 + k;
          const bool ok = t >= lo && t < a.T_in && ci < Cin;
          tf32x3::cp_async4(ad + e, ok ? xb + (size_t)t * Cin + ci : a.x, ok);
        }
      }
      float* wd = wring + slot * 2 * wrows * kTcLDB;
      for (int e = tid; e < 2 * wrows * (kTcBN / 4); e += Tl::THREADS) {
        const int half = e / (wrows * (kTcBN / 4)), rem = e - half * wrows * (kTcBN / 4);
        const int kk = rem / (kTcBN / 4), c4 = (rem - kk * (kTcBN / 4)) * 4;
        const int j = kk / BKC, ci = ci0 + kk - j * BKC;
        const float* src = (half ? a.wlo : a.whi) + ((size_t)j * cinp + ci) * np + n0 + c4;
        tf32x3::cp_async16(wd + (half * wrows + kk) * kTcLDB + c4, src, true);
      }
    }
    tf32x3::cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s, s);

  float acc[Tl::MT][Tl::NT][4];
  tf32x3::zero(acc);
  for (int i = 0; i < nloc; ++i) {
    const int slot = i % STAGES;
    tf32x3::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk i landed; every warp is done with chunk i-1
    if constexpr (kF32) {
      const float* ad = araw + slot * rows * BKC;
#pragma unroll 4
      for (int e = tid; e < rows * BKC; e += Tl::THREADS) {
        const int r = e / BKC, k = e - r * BKC;
        float v = ad[e];
        if (a.elu_in) v = elu(v);
        tf32x3::split(v, a_hi[r * Tl::LDA + k], a_lo[r * Tl::LDA + k]);
      }
    } else {  // widen, ELU in float32 and round, as the TPU kernel's _elu
      const E* ad = araw16 + slot * rows * BKC;
#pragma unroll 4
      for (int e = tid; e < rows * BKC; e += Tl::THREADS) {
        const int r = e / BKC, k = e - r * BKC;
        float v = __bfloat162float(ad[e]);
        if (a.elu_in) v = tf32x3::bf16_round(elu(v));
        a_hi[r * Tl::LDA + k] = v;
      }
    }
    __syncthreads();
    load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    float part[Tl::MT][Tl::NT][4];
    tf32x3::zero(part);
    if constexpr (kF32) {
      const float* wh = wring + slot * 2 * wrows * kTcLDB + wn * Tl::WN;
#pragma unroll
      for (int j = 0; j < TAPS; ++j) {
        const int ao = (wm * Tl::WM + j * a.dil) * Tl::LDA;
        tf32x3::mma3_tile<Tl::MT, Tl::NT>(part, a_hi + ao, a_lo + ao, Tl::LDA,
                                          wh + j * BKC * kTcLDB, wh + (wrows + j * BKC) * kTcLDB,
                                          kTcLDB, BKC / 8);
      }
    } else {
      const unsigned short* wh = wring16 + slot * wrows * kTcLDB16 + wn * Tl::WN;
#pragma unroll
      for (int j = 0; j < TAPS; ++j) {
        const int ao = (wm * Tl::WM + j * a.dil) * Tl::LDA;
        tf32x3::mma1_tile_bf16<Tl::MT, Tl::NT>(part, a_hi + ao, Tl::LDA, wh + j * BKC * kTcLDB16,
                                               kTcLDB16, BKC / 8);
      }
    }
    tf32x3::add(acc, part);
  }

  const int res_off = a.res_T - a.T_out;
  auto store = [&](int r, int n, float v) {  // tile row r, column n: bias, residual, y
    const int t = t0 + r;
    if (t >= a.T_out || n >= a.N) return;
    if constexpr (kF32) {
      v += __ldg(a.bias + n);
      if (a.residual != nullptr) v += __ldg(a.residual + ((size_t)b * a.res_T + t + res_off) * a.N + n);
      a.y[((size_t)b * a.T_out + t) * a.N + n] = v;
    } else {  // the conv rounds, then the residual add rounds
      v = tf32x3::bf16_round(v + tf32x3::ldg_f(a.bias + n));
      if (a.residual != nullptr)
        v += tf32x3::ldg_f(a.residual + ((size_t)b * a.res_T + t + res_off) * a.N + n);
      a.y[((size_t)b * a.T_out + t) * a.N + n] = tf32x3::from_f<E>(v);
    }
  };
  if (a.splits == 1) {
#pragma unroll
    for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int nt = 0; nt < Tl::NT; ++nt)
          store(wm * Tl::WM + mt * 16 + (e >> 1) * 8 + g, n0 + wn * Tl::WN + nt * 8 + 2 * q + (e & 1),
                acc[mt][nt][e]);
    return;
  }

  // split-K: every rank's partial tile into its own shared memory, then rank
  // z sums rows [z*BM/S, (z+1)*BM/S) of the tile over ranks 0..S-1 in order
  cg::cluster_group cl = cg::this_cluster();
  tf32x3::cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* red = smem;  // [BM][kTcLDR]
#pragma unroll
  for (int mt = 0; mt < Tl::MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < Tl::NT; ++nt) {
        const int r = wm * Tl::WM + mt * 16 + hh * 8 + g, c = wn * Tl::WN + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(red + r * kTcLDR + c) =
            make_float2(acc[mt][nt][hh * 2], acc[mt][nt][hh * 2 + 1]);
      }
  cl.sync();
  const int rank = (int)cl.block_rank();
  const int e0 = rank * BM / a.splits * (kTcBN / 4), e1 = (rank + 1) * BM / a.splits * (kTcBN / 4);
  for (int e = e0 + tid; e < e1; e += Tl::THREADS) {
    const int r = e / (kTcBN / 4), c = (e - r * (kTcBN / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(cl.map_shared_rank(red, 0) + r * kTcLDR + c);
    for (int src = 1; src < a.splits; ++src) {
      const float4 p = *reinterpret_cast<const float4*>(cl.map_shared_rank(red, src) + r * kTcLDR + c);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    store(r, n0 + c, s.x);
    store(r, n0 + c + 1, s.y);
    store(r, n0 + c + 2, s.z);
    store(r, n0 + c + 3, s.w);
  }
  cl.sync();  // no block leaves while a peer still reads its tile
}

// The launch: 16-row tiles where T_out < 128, else BM; the fewest splits (a
// power of two up to max_splits, at least one Cin chunk each) that give
// every SM a block, fewer where that many clusters cannot all be resident.
template <int BM, int BKC, int STAGES, int MINB, int TAPS, typename E>
int launch_conv_tc(ConvArgs<E> a, int max_splits, cudaStream_t s) {
  const size_t smem = conv_tc_smem<BM, BKC, STAGES, TAPS, E>((TAPS - 1) * a.dil);
  if (smem > kMaxSmem || a.cinp % BKC != 0) return (int)cudaErrorInvalidValue;
  auto kernel = conv_tc_kernel<BM, BKC, STAGES, MINB, TAPS, E>;
  static LaunchCache caches[kMaxDevices];
  LaunchCache* cache = nullptr;
  cudaError_t e = prepare(kernel, caches, smem, cache);
  if (e != cudaSuccess) return (int)e;
  const long long gx = (long long)a.B * ((a.T_out + BM - 1) / BM), gy = a.np / kTcBN;
  if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidValue;
  int splits = 1, lg = 0;
  while (2 * splits <= max_splits && 2 * splits <= a.cinp / BKC && gx * gy * splits < cache->sms) {
    splits *= 2;
    ++lg;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(ConvTile<BM, BKC>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cache->cluster_smem != (int)smem) {  // the cluster counts below are for this size
    for (int& c : cache->clusters) c = -1;
    cache->cluster_smem = (int)smem;
  }
  for (; splits > 1; splits /= 2, --lg) {  // every cluster resident at once
    cfg.gridDim = dim3((unsigned)gx, (unsigned)gy, (unsigned)splits);
    attr[0].val.clusterDim.z = splits;
    if (cache->clusters[lg] < 0) {
      if (splits > 8 &&
          (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
        return (int)e;
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
        (void)cudaGetLastError();  // clear the refusal: no cluster of this size
        clusters = 0;
      }
      cache->clusters[lg] = clusters;
    }
    if (cache->clusters[lg] >= gx * gy) break;
  }
  a.splits = splits;
  if (splits == 1) {
    kernel<<<dim3((unsigned)gx, (unsigned)gy), ConvTile<BM, BKC>::THREADS, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3 / K4 (b): fused residual block (and, for the last one, the final conv)
// ---------------------------------------------------------------------------

constexpr int kRbBK = 16;

// C = 64 (stage 4): all the block's weights (64 KB as hi/lo) stay in shared
// memory, and each block (one per SM) walks time tiles grid-stride,
// prefetching the next tile's input window while it computes this one.
// C = 128 (stage 3, 260 KB of weights): the weights stream through a 2-stage
// ring in 16-row chunks, one tile per block, two blocks per SM.
template <int C, bool kFinal, typename E = float>
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
  // bfloat16: the input windows [XBUF][RX][LDX16] and the weights [SLOTS][kRbBK][LDW16] as
  // bfloat16 after elu(x) [RX][LDX] and elu(hidden) [BM][LDH] as float (no lo parts)
  static constexpr bool F32 = std::is_same<E, float>::value;
  static constexpr int LDX16 = C + 8, LDW16 = C + 16;
  static constexpr int LDXE = F32 ? LDX : LDX16;                       // input window row stride
  static constexpr int WSLOT = F32 ? 2 * kRbBK * LDW : kRbBK * LDW16;  // ring slot, in W
  using W = typename std::conditional<F32, float, unsigned short>::type;  // the ring's element
  static constexpr size_t SMEM =
      F32 ? sizeof(float) * ((size_t)(XBUF + 2) * RX * LDX + 2 * BM * LDH +
                             (size_t)SLOTS * 2 * kRbBK * LDW)
          : sizeof(float) * ((size_t)RX * LDX + (size_t)BM * LDH) +
                2 * ((size_t)XBUF * RX * LDX16 + (size_t)SLOTS * kRbBK * LDW16);
  static constexpr int MINB = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;  // blocks per SM
  static_assert(THREADS / 4 >= BMO, "the final conv takes four threads per output row");
};

// x [B, T_in, C] -> y = x + conv1(elu(conv3(elu(x)))) [B, T_out, C], or with
// kFinal wav [B, T_out] = final3(elu(y)). w1hi / w1lo [3*C, C/2] (row j*C +
// ci: tap j), b1 [C/2], w2hi / w2lo [C/2, C], b2 [C], wf [3*C], bf [1].
// Output row t of batch row b is the causal result at input row a0 + t,
// a0 = T_in - T_out; input rows before row_start(start, start_stride, b) read
// as zero, and so do the final conv's input rows before it. Tile i of batch
// row b holds output rows t0 = i * BMO..; its input window starts at input
// row a0 + t0 - HF - 2.
// E as for the conv: bfloat16 takes w1hi / w2hi as the weights, w1lo / w2lo unused.
template <typename E>
struct ResArgs {
  const E *x, *w1hi, *w1lo, *b1, *w2hi, *w2lo, *b2, *wf, *bf;
  E* y;
  const int* start;
  int start_stride, B, T_in, T_out;
};

// E = __nv_bfloat16: the same tiles, one TF32 pass on the bfloat16 weights
// (w1hi / w2hi) and on the rounded activations, rounding where the TPU kernel
// rounds: elu(x), the hidden (conv + bias), elu(hidden), the k1 conv + bias,
// the residual add, elu(block output) and the waveform.
template <int C, bool kFinal, typename E>
__global__ void __launch_bounds__(ResTile<C, kFinal, E>::THREADS, ResTile<C, kFinal, E>::MINB)
    resblock_kernel(const ResArgs<E> a) {
  using R = ResTile<C, kFinal, E>;
  using W = typename R::W;
  const E* __restrict__ x = a.x;
  E* __restrict__ y = a.y;
  const int a0 = a.T_in - a.T_out;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // ex_hi [RX][LDX]: elu(x) (its split with ex_lo in float32), later the
  // final conv's input; h_hi [BM][LDH]: elu(hidden) (with h_lo); xbuf
  // [XBUF][RX][LDXE]: the block input windows; ring [SLOTS][WSLOT]: weight
  // chunks ([hi, lo][kRbBK][LDW] in float32, [kRbBK][LDW16] in bfloat16)
  E* xbuf;
  W* ring;
  float *ex_hi, *ex_lo = nullptr, *h_hi, *h_lo = nullptr;
  if constexpr (R::F32) {
    xbuf = smem;
    ex_hi = xbuf + R::XBUF * R::RX * R::LDX;
    ex_lo = ex_hi + R::RX * R::LDX;
    h_hi = ex_lo + R::RX * R::LDX;
    h_lo = h_hi + R::BM * R::LDH;
    ring = h_lo + R::BM * R::LDH;
  } else {
    ex_hi = smem;
    h_hi = ex_hi + R::RX * R::LDX;
    xbuf = reinterpret_cast<E*>(h_hi + R::BM * R::LDH);
    ring = reinterpret_cast<W*>(xbuf + R::XBUF * R::RX * R::LDXE);
  }

  const int tiles = (a.T_out + R::BMO - 1) / R::BMO, ntiles = a.B * tiles;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp / R::WGN, wn = warp % R::WGN;
  constexpr int V = 16 / sizeof(E);  // elements of one 16-byte copy

  auto load_w = [&](int c, int slot) {  // weight chunk c (16 rows of w1, then of w2)
    if (c < R::N1 + R::N2) {
      const bool first = c < R::N1;
      const int width = first ? R::CH : C, k0 = (first ? c : c - R::N1) * kRbBK;
      const E* hi = first ? a.w1hi : a.w2hi;
      W* d = ring + slot * R::WSLOT;
      if constexpr (R::F32) {
        const float* lo = first ? a.w1lo : a.w2lo;
        const int per_half = kRbBK * (width / 4);
        for (int i = tid; i < 2 * per_half; i += R::THREADS) {
          const int half = i / per_half, rem = i - half * per_half;
          const int kk = rem / (width / 4), c4 = (rem - kk * (width / 4)) * 4;
          tf32x3::cp_async16(d + (half * kRbBK + kk) * R::LDW + c4,
                             (half ? lo : hi) + (size_t)(k0 + kk) * width + c4, true);
        }
      } else {
        const int per = kRbBK * (width / 8);
        for (int i = tid; i < per; i += R::THREADS) {
          const int kk = i / (width / 8), c8 = (i - kk * (width / 8)) * 8;
          tf32x3::cp_async16(d + kk * R::LDW16 + c8, hi + (size_t)(k0 + kk) * width + c8, true);
        }
      }
    }
  };
  auto load_x = [&](int tile, E* dst) {  // tile's input window; rows outside [start, T_in) zero
    if (tile < ntiles) {
      const int b = tile / tiles, tx0 = a0 + (tile - b * tiles) * R::BMO - R::HF - 2;
      const int lo = row_start(a.start, a.start_stride, b);
      const E* xb = x + (size_t)b * a.T_in * C;
      for (int i = tid; i < R::RX * (C / V); i += R::THREADS) {
        const int r = i / (C / V), cv = (i - r * (C / V)) * V, t = tx0 + r;
        const bool ok = t >= lo && t < a.T_in;
        tf32x3::cp_async16(dst + r * R::LDXE + cv, ok ? xb + (size_t)t * C + cv : x, ok);
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
    const E* xraw = xbuf + (it & (R::XBUF - 1)) * R::RX * R::LDXE;
    if (R::RESIDENT) {  // the other window was freed by the previous tile's last barrier
      load_x(tile + gridDim.x, xbuf + ((it + 1) & 1) * R::RX * R::LDXE);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
    } else {
      tf32x3::cp_async_wait<R::STAGES - 2>();
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < R::RX * C; i += R::THREADS) {  // rows before the start are zero: elu(0) = 0
      const int r = i / C, k = i - r * C;
      if constexpr (R::F32)
        tf32x3::split(elu(xraw[r * R::LDX + k]), ex_hi[r * R::LDX + k], ex_lo[r * R::LDX + k]);
      else
        ex_hi[r * R::LDX + k] = tf32x3::bf16_round(elu(__bfloat162float(xraw[r * R::LDX16 + k])));
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
      const W* wh = ring + (R::RESIDENT ? c : c % R::STAGES) * R::WSLOT;
      if (c < R::N1) {  // hidden row i = sum_j elu(x)[window row i + j] . w1[j]
        const int j = c * kRbBK / C, ci0 = c * kRbBK - j * C;
        const int ao = (wm * R::WM + j) * R::LDX + ci0;
        float part[R::MT][R::NT1][4];
        tf32x3::zero(part);
        if constexpr (R::F32)
          tf32x3::mma3_tile<R::MT, R::NT1>(part, ex_hi + ao, ex_lo + ao, R::LDX, wh + wn * R::WN1,
                                           wh + kRbBK * R::LDW + wn * R::WN1, R::LDW, kRbBK / 8);
        else
          tf32x3::mma1_tile_bf16<R::MT, R::NT1>(part, ex_hi + ao, R::LDX, wh + wn * R::WN1, R::LDW16,
                                                kRbBK / 8);
        tf32x3::add(acc1, part);
      } else {
        const int ao = wm * R::WM * R::LDH + (c - R::N1) * kRbBK;
        if constexpr (R::F32)
          tf32x3::mma3_tile<R::MT, R::NT2>(acc2, h_hi + ao, h_lo + ao, R::LDH, wh + wn * R::WN2,
                                           wh + kRbBK * R::LDW + wn * R::WN2, R::LDW, kRbBK / 8);
        else
          tf32x3::mma1_tile_bf16<R::MT, R::NT2>(acc2, h_hi + ao, R::LDH, wh + wn * R::WN2, R::LDW16,
                                                kRbBK / 8);
      }
      if (c == R::N1 - 1) {  // elu(hidden + b1) into shared memory: split, or rounded twice
#pragma unroll
        for (int mt = 0; mt < R::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < R::NT1; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = wm * R::WM + mt * 16 + (e >> 1) * 8 + g;
              const int n = wn * R::WN1 + nt * 8 + 2 * q + (e & 1);
              if constexpr (R::F32) {
                tf32x3::split(elu(acc1[mt][nt][e] + __ldg(a.b1 + n)), h_hi[i * R::LDH + n],
                              h_lo[i * R::LDH + n]);
              } else {
                const float hv = tf32x3::bf16_round(acc1[mt][nt][e] + tf32x3::ldg_f(a.b1 + n));
                h_hi[i * R::LDH + n] = tf32x3::bf16_round(elu(hv));
              }
            }
        __syncthreads();
      }
    }

    // block output row i (output row t0 - HF + i, input row a0 + t0 - HF + i)
    // = acc2 + b2 + x[window row i + 2] (bfloat16: the conv rounded, then the sum)
    float* outb = ex_hi;  // [BM][LDO]: elu(block output), the final conv's input
    const int lo = row_start(a.start, a.start_stride, b);
#pragma unroll
    for (int mt = 0; mt < R::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < R::NT2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = wm * R::WM + mt * 16 + (e >> 1) * 8 + g;
          const int n = wn * R::WN2 + nt * 8 + 2 * q + (e & 1);
          float v;
          if constexpr (R::F32) {
            v = acc2[mt][nt][e] + __ldg(a.b2 + n) + xraw[(i + 2) * R::LDX + n];
          } else {
            const float cv = tf32x3::bf16_round(acc2[mt][nt][e] + tf32x3::ldg_f(a.b2 + n));
            v = tf32x3::bf16_round(cv + __bfloat162float(xraw[(i + 2) * R::LDX16 + n]));
          }
          const int t = t0 - R::HF + i;
          if (kFinal) {  // causal zero padding
            outb[i * R::LDO + n] = a0 + t >= lo ? (R::F32 ? elu(v) : tf32x3::bf16_round(elu(v))) : 0.f;
          } else if (t < a.T_out) {
            y[((size_t)b * a.T_out + t) * C + n] = tf32x3::from_f<E>(v);
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
          s = fmaf(outb[(o + j) * R::LDO + ci], tf32x3::ldg_f(a.wf + p), s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (sub == 0 && o < R::BMO && t0 + o < a.T_out)
        y[(size_t)b * a.T_out + t0 + o] = tf32x3::from_f<E>(s + tf32x3::ldg_f(a.bf));
    }
    __syncthreads();  // the tile's buffers are free for the next one
  }
}

template <int C, bool kFinal, typename E>
int launch_resblock(const ResArgs<E>& a, cudaStream_t s) {
  using R = ResTile<C, kFinal, E>;
  static_assert(R::SMEM <= kMaxSmem, "resblock tile exceeds shared memory");
  auto kernel = resblock_kernel<C, kFinal, E>;
  static LaunchCache caches[kMaxDevices];
  LaunchCache* cache = nullptr;
  cudaError_t e = prepare(kernel, caches, R::SMEM, cache);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (long long)a.B * ((a.T_out + R::BMO - 1) / R::BMO);
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  long long grid = ntiles;
  if (R::RESIDENT) {  // as many blocks as fit at once; each walks tiles grid-stride
    if (cache->per_sm < 0 &&
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cache->per_sm, kernel, R::THREADS,
                                                           R::SMEM)) != cudaSuccess)
      return (int)e;
    const long long fit = (long long)cache->sms * cache->per_sm;
    grid = ntiles < fit ? ntiles : fit;
    if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  kernel<<<(unsigned)grid, R::THREADS, R::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename E>
int conv_tc(const E* x, const E* whi, const E* wlo, const E* bias, const E* residual, E* y, int B,
            int T_in, int T_out, int res_T, int Cin, int cinp, int N, int np, int taps, int dil,
            int elu_in, const int* start, int start_stride, int max_splits, void* stream) {
  if (B <= 0 || T_out <= 0 || T_out > T_in || Cin <= 0 || N <= 0 || taps <= 0 || dil <= 0 ||
      cinp < Cin || cinp % 32 != 0 || np < N || np % kTcBN != 0 || max_splits < 1 ||
      max_splits > kMaxSplits || (residual != nullptr && res_T < T_out))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ConvArgs<E> a = {x, whi, wlo, bias, residual, y, start, start_stride, B, T_in, T_out,
                         res_T, Cin, cinp, N, np, dil, elu_in, 1};
  // taps * BKC weight rows per ring stage (32, 32, 24, 56 for 1, 2, 3, 7
  // taps); two blocks per SM where the ring fits in half the shared memory,
  // so one block's loads and splits overlap the other's MMAs
  const bool small = T_out < 128;
  if (taps == 1)
    return small ? launch_conv_tc<16, 32, 2, 2, 1, E>(a, max_splits, s)
                 : launch_conv_tc<64, 32, 2, 2, 1, E>(a, max_splits, s);
  if (taps == 2)
    return small ? launch_conv_tc<16, 16, 2, 2, 2, E>(a, max_splits, s)
                 : launch_conv_tc<64, 16, 2, 2, 2, E>(a, max_splits, s);
  if (taps == 3)
    return small ? launch_conv_tc<16, 8, 3, 2, 3, E>(a, max_splits, s)
                 : launch_conv_tc<64, 8, 3, 2, 3, E>(a, max_splits, s);
  if (taps == 7)
    return small ? launch_conv_tc<16, 8, 3, 1, 7, E>(a, max_splits, s)
                 : launch_conv_tc<64, 8, 3, 1, 7, E>(a, max_splits, s);
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int resblock(const E* x, const E* w1hi, const E* w1lo, const E* b1, const E* w2hi,
             const E* w2lo, const E* b2, const E* wf, const E* bf, E* y, int B, int T_in,
             int T_out, int C, int final, const int* start, int start_stride, void* stream) {
  if (B <= 0 || T_out <= 0 || T_out > T_in) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ResArgs<E> a = {x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, start, start_stride, B,
                        T_in, T_out};
  if (C == 128 && !final) return launch_resblock<128, false, E>(a, s);
  if (C == 128 && final) return launch_resblock<128, true, E>(a, s);
  if (C == 64 && !final) return launch_resblock<64, false, E>(a, s);
  if (C == 64 && final) return launch_resblock<64, true, E>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3 / K4 (a): one conv, output row t the causal conv at input row
// T_in - T_out + t. x [B, T_in, Cin]; whi / wlo [taps, cinp, np] (the TF32
// split of w [taps, Cin, N], zero-padded: cinp a multiple of 32, np of
// 128); bias [N]; residual (nullable) [B, res_T, N], row t + res_T - T_out
// added to output row t; y [B, T_out, N]; start (nullable) int32, input rows
// of batch row b before start[b * start_stride] read as zero; the Cin chunks
// split over up to max_splits blocks of a cluster. All float32 contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int sopro_seanet_conv_tc(const float* x, const float* whi, const float* wlo,
                                    const float* bias, const float* residual, float* y, int B,
                                    int T_in, int T_out, int res_T, int Cin, int cinp, int N,
                                    int np, int taps, int dil, int elu_in, const int* start,
                                    int start_stride, int max_splits, void* stream) {
  return conv_tc<float>(x, whi, wlo, bias, residual, y, B, T_in, T_out, res_T, Cin, cinp, N, np,
                        taps, dil, elu_in, start, start_stride, max_splits, stream);
}

// The bfloat16 instantiation, the same arguments in bfloat16: whi the
// weights [taps, cinp, np] themselves (zero-padded as above), wlo unused.
extern "C" int sopro_seanet_conv_tc_bf16(const __nv_bfloat16* x, const __nv_bfloat16* whi,
                                         const __nv_bfloat16* wlo, const __nv_bfloat16* bias,
                                         const __nv_bfloat16* residual, __nv_bfloat16* y, int B,
                                         int T_in, int T_out, int res_T, int Cin, int cinp, int N,
                                         int np, int taps, int dil, int elu_in, const int* start,
                                         int start_stride, int max_splits, void* stream) {
  return conv_tc<__nv_bfloat16>(x, whi, wlo, bias, residual, y, B, T_in, T_out, res_T, Cin, cinp,
                                N, np, taps, dil, elu_in, start, start_stride, max_splits, stream);
}

// K3 / K4 (b): one residual block of C = 128 or 64 channels, k3 conv
// dilation 1, output row t the causal result at input row T_in - T_out + t.
// x [B, T_in, C]; final = 0: y [B, T_out, C]; final = 1: also the final k3
// conv to one channel, y [B, T_out]; start (nullable) as for the conv.
// Weights as in resblock_kernel. Returns cudaGetLastError() after the launch.
extern "C" int sopro_seanet_resblock(const float* x, const float* w1hi, const float* w1lo,
                                     const float* b1, const float* w2hi, const float* w2lo,
                                     const float* b2, const float* wf, const float* bf, float* y,
                                     int B, int T_in, int T_out, int C, int final,
                                     const int* start, int start_stride, void* stream) {
  return resblock<float>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, B, T_in, T_out, C, final,
                         start, start_stride, stream);
}

// The bfloat16 instantiation, the same arguments in bfloat16: w1hi / w2hi the
// weights themselves, w1lo / w2lo unused.
extern "C" int sopro_seanet_resblock_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* w1hi, const __nv_bfloat16* w1lo,
    const __nv_bfloat16* b1, const __nv_bfloat16* w2hi, const __nv_bfloat16* w2lo,
    const __nv_bfloat16* b2, const __nv_bfloat16* wf, const __nv_bfloat16* bf, __nv_bfloat16* y,
    int B, int T_in, int T_out, int C, int final, const int* start, int start_stride,
    void* stream) {
  return resblock<__nv_bfloat16>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, B, T_in, T_out, C,
                                 final, start, start_stride, stream);
}
