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
// weights split into hi/lo once at pack time, activations as they are read):
// - `conv_wgmma_kernel` (sopro_seanet_conv_tc): one causal conv as an
//   implicit GEMM on Hopper's own path (hopper.cuh), M = time rows of one
//   batch row, N = output columns, K = taps * Cin. A transpose conv with
//   k = 2s is a two-tap conv whose N is s * Cout (phase-major columns:
//   [B*T, s*Cout] is the [B, T*s, Cout] output as it lies in memory). One
//   persistent block per SM walks 128-row x 128-column tiles. A producer
//   warp TMA-loads, per Cin chunk of 128 bytes, the activation tile with its
//   causal halo (128 + (taps-1)*dil rows; TMA's zero fill below row 0 is the
//   causal padding) and each tap's K-major weight tiles (pack_seanet_decoder:
//   [taps, np, cinp], hi and lo) into two mbarrier rings; the producer's
//   other three warps apply the ELU and the stream-start mask to each
//   activation tile in place; two consumer warpgroups read their rows of it
//   shifted by j*dil for tap j into registers, split them into hi/lo there,
//   and issue register-A `wgmma` m64n128k8 against the weight tiles, a fresh
//   accumulator per (Cin chunk, tap) added to the running sum in float32;
//   the epilogue stages each finished tile in shared memory and TMA-stores
//   it, so the next tile's MMAs run while the stores drain.
//   Where only the next conv's ELU reads a launch's output, the ELU runs in
//   that launch's epilogue instead (once per element, not once per column
//   tile of the next conv).
// - `resblock_wgmma_kernel` (sopro_seanet_resblock): a whole residual block
//   for the 128- and 64-channel stages (3 and 4 of Mimi, whose activations
//   are 150-300 MB at B = 1), on the same path: per 128-row tile with a 2-row
//   causal halo, ELU -> k3 conv (`wgmma`, w1 tiles streamed) -> hidden in
//   registers -> ELU -> k1 conv (`wgmma`, the hidden as the register A
//   operand, w2 resident in shared memory) + block input; the last block
//   also runs ELU -> final k3 conv -> one channel in float32 on the CUDA
//   cores (four threads per output row), recomputing two rows of halo per
//   tile. The hidden and, in the last stage, the block output never reach
//   device memory: the last stage writes only the waveform.
// Every K chunk's products are summed in a fresh accumulator and added in
// float32: on one accumulator through all of K the tensor cores' truncation
// put K3's output ~20x further from the float32 plain version
// (bench_ablation.py on the H100).
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
// fused residual block that masks the k3 conv's input and the final conv's
// input rows before the same start; the rows before it only feed
// block-output rows that the next launch masks.
//
// A chunk of 6 AR frames has 13-20 rows in its first convs (k7: M = 14, N =
// 1,024, K = 3,584): 8 column tiles of one row tile, far from filling the
// card (K3 at B = 1 has 56 tiles in its k7 conv). So where the tiles leave
// SMs idle, the conv kernel splits the Cin chunks over the blocks of a
// thread-block cluster (grid z, up to max_splits = 16), as many as it takes
// to give every SM a block in one wave; the partial tiles meet through
// distributed shared memory, each rank summing its share of the tile over
// the ranks in rank order (no atomics: a repeated call is bit-identical).
// TMA reads x in 16-byte rows: the wrapper pads the channels of an x that
// has other rows (only the small test configurations do).
//
// What bounds it on the H100: K3 is 132 GFLOP for 32 s of audio (802
// frames at 25 Hz -> 769,920 samples), 0.80 ms at the 3-pass TF32 rate
// (1.98 ms at the float32 CUDA-core rate), against ~0.4 ms of activation
// traffic once the residual blocks of stages 3 and 4 are fused:
// compute-bound. Both kernels keep the tensor cores fed from rings that TMA
// fills while the consumers compute, and move every ELU off the consumers'
// path (transform warps, or the producing launch's epilogue). Built without
// their MMAs they keep ~70 % of their time: what is left is set by each
// tile's serial steps (a drained `wgmma` group per weight tile, the fused
// blocks' epilogue and final conv), not by the weight bytes (reading half of
// them changes nothing: bench_ablation.py, PERF.md). A
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
// same points, and the waveform leaves as bfloat16. Both kernels run
// bfloat16 `wgmma` k16 products (exact, float32 accumulation) on the weights
// as they are, read as bfloat16 (half the float32 bytes, a third of the
// hi/lo pair's). K3 in bfloat16 is bound by its products at the bfloat16
// rate: 132 GFLOP / 989 TF/s = 0.13 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

constexpr int kMaxSmem = 232448;
constexpr int kMaxSplits = 16;

// Per kernel instantiation and device, what a launch asks of the CUDA runtime,
// asked once: the dynamic shared memory allowed so far, the SM count, and the
// clusters of 2, 4, 8 and 16 blocks that can be resident at once (at
// `cluster_smem` bytes). A chunk of K4 is 11 launches of a few microseconds
// each.
struct LaunchCache {
  int smem = 0, sms = 0, cluster_smem = -1;
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
// K3 / K4 (a): one conv on Hopper's own path, TMA-fed `wgmma`
// ---------------------------------------------------------------------------

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
  int start_stride, B, T_in, T_out, res_T, Cin, cinp, N, np, dil;
  int elu;     // bit 0: ELU on the input; bit 1: ELU on the output (after bias and residual)
  int splits;  // blocks of a cluster (grid z) sharing the Cin chunks of one tile
  int store_tma;  // the epilogue stages each tile in shared memory and TMA-stores it
};

// A block computes tiles of 128 output rows x 128 columns: two consumer
// warpgroups of 64 rows each, then the producer warpgroup: its warp 0 lane 0
// issues the copies, its warps 1-3 apply the ELU and the stream-start mask to
// each activation tile, and its registers go to the consumers (setmaxnreg 40
// and 232 a thread). 384 threads, one persistent block per SM walking the
// tiles (column tile slowest, so the blocks running at once share weights),
// its rings running on from one tile to the next.
constexpr int kWgBM = 128, kWgBN = 128, kWgThreads = 384;
constexpr int kWgLDR = kWgBN + 4;  // split-K partial tile row stride (floats)

template <typename E>
struct WgConv {
  static constexpr bool F32 = std::is_same<E, float>::value;
  static constexpr int BK = 128 / (int)sizeof(E);  // Cin per chunk: one 128-byte row
  static constexpr int B_BYTES = kWgBN * 128;      // one weight tile of one tap
  static constexpr int BSTAGE = (F32 ? 2 : 1) * B_BYTES;
  static constexpr int A_STAGES = 3, B_STAGES = F32 ? 3 : 8;
  // a consumer warpgroup's output stage: 64 rows as boxes of 128 bytes of columns
  static constexpr int OBOX = kWgBN / BK, OUT_BYTES = OBOX * 64 * 128;
};

struct ConvMaps {
  CUtensorMap x, whi, wlo, y;
};

__host__ __device__ inline int wg_astage(int halo) { return ((kWgBM + halo) * 128 + 1023) / 1024 * 1024; }

template <typename E>
size_t wg_smem(int halo) {
  using W = WgConv<E>;
  return 1024 + (size_t)W::A_STAGES * wg_astage(halo) + (size_t)W::B_STAGES * W::BSTAGE +
         2 * (size_t)W::OUT_BYTES + 8 * (size_t)(3 * W::A_STAGES + 2 * W::B_STAGES);
}

// y[b, t, n] = bias[n] (+ residual) + sum_{j, ci} act(x[b, a0 + t - (taps-1-j)*dil, ci]) * w[j, ci, n]
// with whi / wlo [taps, np, cinp] the TF32 split of w, K-major, zero-padded.
// Per tile and Cin chunk of 128 bytes the producer TMA-loads the activation
// tile [128 + halo rows, chunk] (x as a [B, T_in, Cin] tensor map: rows
// before 0 or past T_in arrive as zeros, the causal padding) into a 3-stage
// ring ("full"), and for each tap the K-major weight tiles [128 columns,
// chunk] (hi and lo for float32) into a 5-8-stage ring. The transform warps
// take each activation tile, apply the ELU and zero the rows before the
// stream's start in place (bfloat16 rounds as the TPU kernel does), and hand
// it on ("ready"). The consumers read their rows of it shifted by j * dil for
// tap j into registers (float32: split into hi/lo there) and issue
// register-A `wgmma` m64n128 into a fresh accumulator per (chunk, tap), added
// to the running sum in float32 when it completes. The epilogue (bias,
// residual, ELU) writes each warpgroup's 64 rows into its output stage in
// TMA's layout and one thread TMA-stores it (where y's rows are 16-byte
// multiples). With splits > 1 (grid z, one tile per cluster) rank z takes a
// range of the Cin chunks and the ranks' partial tiles meet through
// distributed shared memory, the owner of each row range storing it.
template <int TAPS, typename E>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ ConvMaps maps, const ConvArgs<E> a) {
  using W = WgConv<E>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* aring = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const int halo = (TAPS - 1) * a.dil, rows = kWgBM + halo, astage = wg_astage(halo);
  uint8_t* bring = aring + W::A_STAGES * astage;
  uint8_t* outs = bring + W::B_STAGES * W::BSTAGE;  // [2 warpgroups][OUT_BYTES]
  uint64_t* afull = reinterpret_cast<uint64_t*>(outs + 2 * W::OUT_BYTES);
  uint64_t* aready = afull + W::A_STAGES;
  uint64_t* aempty = aready + W::A_STAGES;
  uint64_t* bfull = aempty + W::A_STAGES;
  uint64_t* bempty = bfull + W::B_STAGES;

  const int tiles_t = (a.T_out + kWgBM - 1) / kWgBM, tiles_bt = a.B * tiles_t;
  const int ntiles = tiles_bt * (a.np / kWgBN);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (a.Cin + W::BK - 1) / W::BK;
  // split-K (a.splits > 1, one tile per cluster): rank z takes Cin chunks [c_lo, c_hi)
  const int rank = blockIdx.z, c_lo = rank * nc / a.splits, c_hi = (rank + 1) * nc / a.splits;
  // tile -> batch row, first output row, first column, first input row (halo included)
  auto tile_at = [&](int tile, int& b, int& t0, int& n0, int& r0) {
    const int bt = tile % tiles_bt;
    b = bt / tiles_t;
    t0 = (bt - b * tiles_t) * kWgBM;
    n0 = tile / tiles_bt * kWgBN;
    r0 = a.T_in - a.T_out + t0 - halo;
  };

  if (tid == 0) {
    for (int s = 0; s < W::A_STAGES; ++s) {
      hopper::mbar_init(&afull[s], 1);
      hopper::mbar_init(&aready[s], 3);  // one arrival per transform warp
      hopper::mbar_init(&aempty[s], 8);  // one per consumer warp
    }
    for (int s = 0; s < W::B_STAGES; ++s) {
      hopper::mbar_init(&bfull[s], 1);
      hopper::mbar_init(&bempty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    hopper::regs_dec<40>();
    int ic = 0, ib = 0;  // activation and weight tiles so far
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      int b, t0, n0, r0;
      tile_at(tile, b, t0, n0, r0);
      const int lo = row_start(a.start, a.start_stride, b);
      const bool mask = lo > 0 && lo > r0;
      for (int c = c_lo; c < c_hi; ++c, ++ic) {
        const int sa = ic % W::A_STAGES;
        uint8_t* at = aring + sa * astage;
        if (warp == 8) {  // the copies
          if (lane == 0) {
            if (ic >= W::A_STAGES) hopper::mbar_wait(&aempty[sa], (ic / W::A_STAGES - 1) & 1);
            hopper::mbar_expect_tx(&afull[sa], rows * 128);
            hopper::tma_load_3d(at, &maps.x, &afull[sa], c * W::BK, r0, b);
            for (int j = 0; j < TAPS; ++j, ++ib) {
              const int sb = ib % W::B_STAGES;
              if (ib >= W::B_STAGES) hopper::mbar_wait(&bempty[sb], (ib / W::B_STAGES - 1) & 1);
              uint8_t* d = bring + sb * W::BSTAGE;
              hopper::mbar_expect_tx(&bfull[sb], W::BSTAGE);
              hopper::tma_load_2d(d, &maps.whi, &bfull[sb], c * W::BK, j * a.np + n0);
              if constexpr (W::F32)
                hopper::tma_load_2d(d + W::B_BYTES, &maps.wlo, &bfull[sb], c * W::BK, j * a.np + n0);
            }
          }
          __syncwarp();
          continue;
        }
        // the transform warps: 16-byte chunks (the swizzle moves them within their row)
        hopper::mbar_wait(&afull[sa], (ic / W::A_STAGES) & 1);
        if ((a.elu & 1) || mask) {
          for (int v = tid - 288; v < rows * 8; v += 96) {
            const bool zero = r0 + (v >> 3) < lo;
            if constexpr (W::F32) {
              float4* p = reinterpret_cast<float4*>(at + 16 * v);
              float4 x = *p;
              if (zero) {
                x = make_float4(0.f, 0.f, 0.f, 0.f);
              } else if (a.elu & 1) {
                x.x = elu(x.x);
                x.y = elu(x.y);
                x.z = elu(x.z);
                x.w = elu(x.w);
              }
              *p = x;
            } else {
              __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(at + 16 * v);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const __nv_bfloat162 x = p[i];
                p[i] = zero ? __floats2bfloat162_rn(0.f, 0.f)
                            : a.elu & 1 ? __floats2bfloat162_rn(elu(__low2float(x)), elu(__high2float(x))) : x;
              }
            }
          }
          hopper::fence_proxy_async();  // the in-place writes before TMA refills the stage
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&aready[sa]);
      }
    }
    __syncwarp();
    if (a.splits > 1) {  // the consumers' two cluster barriers, met here without rejoining them
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  hopper::regs_inc<232>();
  const int g = lane >> 2, q = lane & 3;
  const int rw = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's tile rows rw and rw + 8
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int ic = 0, ib = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int b, t0, n0, r0;
    tile_at(tile, b, t0, n0, r0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int c = c_lo; c < c_hi; ++c, ++ic) {
      const int sa = ic % W::A_STAGES;
      const uint8_t* at = aring + sa * astage;
      hopper::mbar_wait(&aready[sa], (ic / W::A_STAGES) & 1);
      for (int j = 0; j < TAPS; ++j, ++ib) {
        const int sb = ib % W::B_STAGES;
        hopper::mbar_wait(&bfull[sb], (ib / W::B_STAGES) & 1);
        const uint8_t* bt = bring + sb * W::BSTAGE;
        const uint64_t dhi = hopper::desc_k128(bt);
        const int ra = rw + j * a.dil;  // tap j reads the tile shifted by j * dil rows
        if constexpr (W::F32) {
          const uint64_t dlo = hopper::desc_k128(bt + W::B_BYTES);
          uint32_t ahi[4][4], alo[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // a_i: row ra + 8 (i & 1), column 8 ks + q + 4 (i >> 1)
              const int k = ks * 8 + q + 4 * (i >> 1);
              float hi, lo;
              tf32x3::split(*reinterpret_cast<const float*>(at + hopper::sw128(ra + 8 * (i & 1), 4 * k)), hi, lo);
              ahi[ks][i] = __float_as_uint(hi);
              alo[ks][i] = __float_as_uint(lo);
            }
          hopper::fence_regs(part);
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {  // a fresh accumulator (scale-d 0), the small terms first
            hopper::wgmma_tf32_n128(part, alo[ks], dhi + 2 * ks, ks > 0);
            hopper::wgmma_tf32_n128(part, ahi[ks], dlo + 2 * ks, 1);
            hopper::wgmma_tf32_n128(part, ahi[ks], dhi + 2 * ks, 1);
          }
        } else {
          uint32_t av[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // a_i: row ra + 8 (i & 1), columns 16 ks + 2q (+ 8 (i >> 1)), +1
              const int k = ks * 16 + 2 * q + 8 * (i >> 1);
              av[ks][i] = *reinterpret_cast<const uint32_t*>(at + hopper::sw128(ra + 8 * (i & 1), 2 * k));
            }
          hopper::fence_regs(part);
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) hopper::wgmma_bf16_n128(part, av[ks], dhi + 2 * ks, ks > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(part);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&bempty[sb]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&aempty[sa]);
    }

    // output row t, columns n and n + 1 (v.x, v.y): bias, residual, ELU
    // (bfloat16: the conv rounds, then the residual add rounds, then the ELU)
    const int res_off = a.res_T - a.T_out;
    auto finish2 = [&](int t, int n, float2 v) {  // t < T_out, n + 1 < N
      const size_t ro = ((size_t)b * a.res_T + t + res_off) * a.N + n;
      if constexpr (W::F32) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.bias + n));
        v.x += bb.x;
        v.y += bb.y;
        if (a.residual != nullptr) {
          const float2 r = __ldg(reinterpret_cast<const float2*>(a.residual + ro));
          v.x += r.x;
          v.y += r.y;
        }
      } else {
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.bias + n));
        v.x = tf32x3::bf16_round(v.x + bb.x);
        v.y = tf32x3::bf16_round(v.y + bb.y);
        if (a.residual != nullptr) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.residual + ro));
          v.x = tf32x3::bf16_round(v.x + r.x);
          v.y = tf32x3::bf16_round(v.y + r.y);
        }
      }
      return a.elu & 2 ? make_float2(elu(v.x), elu(v.y)) : v;
    };
    const bool pairs = (a.N & 1) == 0;  // n even: 8-byte aligned pairs
    auto store2 = [&](int t, int n, float2 v) {  // straight to y
      if (t >= a.T_out || n >= a.N) return;
      const size_t o = ((size_t)b * a.T_out + t) * a.N + n;
      if (pairs) {
        v = finish2(t, n, v);
        if constexpr (W::F32)
          *reinterpret_cast<float2*>(a.y + o) = v;
        else
          *reinterpret_cast<__nv_bfloat162*>(a.y + o) = __floats2bfloat162_rn(v.x, v.y);
        return;
      }
      const size_t ro = ((size_t)b * a.res_T + t + res_off) * a.N + n;
      for (int e = 0; e < 2 && n + e < a.N; ++e) {
        float x = e ? v.y : v.x;
        if constexpr (W::F32) {
          x += __ldg(a.bias + n + e);
          if (a.residual != nullptr) x += __ldg(a.residual + ro + e);
        } else {
          x = tf32x3::bf16_round(x + tf32x3::ldg_f(a.bias + n + e));
          if (a.residual != nullptr) x = tf32x3::bf16_round(x + tf32x3::ldg_f(a.residual + ro + e));
        }
        a.y[o + e] = tf32x3::from_f<E>(a.elu & 2 ? elu(x) : x);
      }
    };
    // d[i]: row rw + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2q + (i & 1)
    if (a.splits == 1 && a.store_tma) {
      // the warpgroup's 64 rows into its output stage (the TMA load layout:
      // boxes of 128 bytes of columns, swizzled), then one TMA store a box;
      // the next tile's MMAs run while the stores drain
      const int wg = warp >> 2, rg = rw - 64 * wg;
      uint8_t* ob = outs + wg * W::OUT_BYTES;
      const bool issuer = (warp & 3) == 0 && lane == 0;
      if (issuer) hopper::bulk_wait_read<0>();  // the previous tile's stores have read the stage
      hopper::named_sync(2 + wg, 128);
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = rg + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * q;
        const int t = t0 + 64 * wg + r, n = n0 + col;
        float2 v = make_float2(acc[i], acc[i + 1]);
        if (t < a.T_out && n < a.N) v = finish2(t, n, v);  // elsewhere TMA writes nothing
        uint8_t* p = ob + (col / W::BK) * (64 * 128) + hopper::sw128(r, (col % W::BK) * (int)sizeof(E));
        if constexpr (W::F32)
          *reinterpret_cast<float2*>(p) = v;
        else
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
      }
      hopper::fence_proxy_async();  // the stage's writes before TMA reads them
      hopper::named_sync(2 + wg, 128);
      if (issuer) {
        for (int box = 0; box < W::OBOX; ++box)
          hopper::tma_store_3d(&maps.y, ob + box * (64 * 128), n0 + box * W::BK, t0 + 64 * wg, b);
        hopper::bulk_commit();
      }
      continue;
    }
    if (a.splits == 1) {
#pragma unroll
      for (int i = 0; i < 64; i += 2)
        store2(t0 + rw + 8 * ((i >> 1) & 1), n0 + 8 * (i >> 2) + 2 * q, make_float2(acc[i], acc[i + 1]));
      continue;
    }
    // split-K: every rank's partial tile into its own shared memory (over the
    // weight ring, which both warpgroups are done with), then rank z sums rows
    // [z*128/S, (z+1)*128/S) of the tile over ranks 0..S-1 in order
    cg::cluster_group cl = cg::this_cluster();
    hopper::named_sync(1, 256);
    float* red = reinterpret_cast<float*>(bring);  // [128][kWgLDR]
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      *reinterpret_cast<float2*>(red + (rw + 8 * ((i >> 1) & 1)) * kWgLDR + 8 * (i >> 2) + 2 * q) =
          make_float2(acc[i], acc[i + 1]);
    cl.sync();
    const int e0 = rank * kWgBM / a.splits * (kWgBN / 2), e1 = (rank + 1) * kWgBM / a.splits * (kWgBN / 2);
    for (int e = e0 + tid; e < e1; e += 256) {
      const int r = e / (kWgBN / 2), c = (e - r * (kWgBN / 2)) * 2;
      float2 sum = *reinterpret_cast<const float2*>(cl.map_shared_rank(red, 0) + r * kWgLDR + c);
      for (int src = 1; src < a.splits; ++src) {
        const float2 p = *reinterpret_cast<const float2*>(cl.map_shared_rank(red, src) + r * kWgLDR + c);
        sum.x += p.x;
        sum.y += p.y;
      }
      store2(t0 + r, n0 + c, sum);
    }
    cl.sync();  // no block leaves while a peer still reads its tile
  }
  if (a.store_tma && (warp & 3) == 0 && lane == 0) hopper::bulk_wait<0>();  // the stage outlives its stores
}

// The launch: without splits (K3, and any conv whose tiles fill the card),
// one persistent block per SM up to the tiles; else the fewest splits (a
// power of two up to max_splits, at least one Cin chunk each) that give every
// SM a block, one tile per cluster, fewer where that many clusters cannot all
// be resident.
template <int TAPS, typename E>
int launch_conv_wgmma(ConvArgs<E> a, int max_splits, cudaStream_t s) {
  using W = WgConv<E>;
  constexpr bool bf16 = !W::F32;
  const int halo = (TAPS - 1) * a.dil;
  const size_t smem = wg_smem<E>(halo);
  if (kWgBM + halo > 256 || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  ConvMaps maps;
  const uint64_t es = sizeof(E);
  const uint64_t xd[3] = {(uint64_t)a.Cin, (uint64_t)a.T_in, (uint64_t)a.B};
  const uint64_t xs[2] = {a.Cin * es, (uint64_t)a.T_in * a.Cin * es};
  const uint32_t xb[3] = {(uint32_t)W::BK, (uint32_t)(kWgBM + halo), 1};
  const uint64_t wd[2] = {(uint64_t)a.cinp, (uint64_t)TAPS * a.np}, ws[1] = {a.cinp * es};
  const uint32_t wb[2] = {(uint32_t)W::BK, (uint32_t)kWgBN};
  cudaError_t e = hopper::make_map(&maps.x, bf16, 3, a.x, xd, xs, xb);
  if (e == cudaSuccess) e = hopper::make_map(&maps.whi, bf16, 2, a.whi, wd, ws, wb);
  if (e == cudaSuccess) e = hopper::make_map(&maps.wlo, bf16, 2, W::F32 ? a.wlo : a.whi, wd, ws, wb);
  if (e != cudaSuccess) return (int)e;
  // y through TMA stores where its rows are 16-byte multiples
  const uint64_t yd[3] = {(uint64_t)a.N, (uint64_t)a.T_out, (uint64_t)a.B};
  const uint64_t ys[2] = {a.N * es, (uint64_t)a.T_out * a.N * es};
  const uint32_t yb[3] = {(uint32_t)W::BK, 64, 1};
  a.store_tma = (a.N * es) % 16 == 0 && hopper::make_map(&maps.y, bf16, 3, a.y, yd, ys, yb) == cudaSuccess;
  auto kernel = conv_wgmma_kernel<TAPS, E>;
  static LaunchCache caches[kMaxDevices];
  LaunchCache* cache = nullptr;
  e = prepare(kernel, caches, smem, cache);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (long long)a.B * ((a.T_out + kWgBM - 1) / kWgBM) * (a.np / kWgBN);
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int nc = (a.Cin + W::BK - 1) / W::BK;
  int splits = 1, lg = 0;
  while (2 * splits <= max_splits && 2 * splits <= nc && ntiles * splits < cache->sms) {
    splits *= 2;
    ++lg;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kWgThreads);
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
    cfg.gridDim = dim3((unsigned)ntiles, 1, (unsigned)splits);
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
    if (cache->clusters[lg] >= ntiles) break;
  }
  a.splits = splits;
  a.store_tma = a.store_tma && splits == 1;
  if (splits == 1) {
    kernel<<<(unsigned)(ntiles < cache->sms ? ntiles : cache->sms), kWgThreads, smem, s>>>(maps, a);
    return (int)cudaGetLastError();
  }
  e = cudaLaunchKernelEx(&cfg, kernel, maps, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3 / K4 (b): fused residual block (and, for the last one, the final conv)
// ---------------------------------------------------------------------------

// A tile is 128 rows of hidden (two consumer warpgroups of 64; 126 output
// rows with the final conv, whose 2-row halo it recomputes), from a window of
// 130 input rows (the k3 conv's halo). Per tile the producer TMA-loads the
// window as boxes of 128 bytes of channels; the transform warps apply the ELU
// and the stream-start mask to it in place; the consumers run the k3 conv
// (C -> C/2) with A from the window rows shifted by the tap and B the K-major
// w1 tiles streamed through a ring, a fresh accumulator per (channel box,
// tap); the hidden, ELU'd in registers, is the A operand of the k1 conv (C/2
// -> C) straight from the accumulator fragment -- float32 pairs its columns
// 2q, 2q+1 as the k positions q, q+4 of a k8 step, so w2 is packed with K in
// that order (`resblock_k_order`); bfloat16 fragments line up as they are --
// against w2 resident in shared memory; the epilogue adds b2 and the block
// input (read from global memory, where the window was) and stores y, or
// ELUs it into shared memory for the final k3 conv to one channel on the
// CUDA cores (four threads per output row).
template <int C, typename E>
struct WgRes {
  static constexpr bool F32 = std::is_same<E, float>::value;
  static constexpr int H = C / 2;
  static constexpr int BK = 128 / (int)sizeof(E);  // channels per 128-byte box row
  static constexpr int XBOX = C / BK;              // boxes per window (the k3 conv's K chunks)
  static constexpr int RX = kWgBM + 2;
  static constexpr int XBOX_BYTES = (RX * 128 + 1023) / 1024 * 1024;
  static constexpr int XSTAGE = XBOX * XBOX_BYTES;
  static constexpr int X_STAGES = F32 && C == 128 ? 1 : 2;
  static constexpr int W1_BYTES = H * 128;  // a w1 tile [H][BK]: hi, lo or bfloat16
  static constexpr int W1STAGE = (F32 ? 2 : 1) * W1_BYTES;
  static constexpr int W1_STAGES = 4;
  static constexpr int W2BOX = (H + BK - 1) / BK;  // w2 [C][H] as boxes of BK of K
  static constexpr int W2_BYTES = W2BOX * C * 128;
  static constexpr int LDO = C + 4;  // the final conv's input rows (floats)
  static constexpr int KSTEP = F32 ? 8 : 16;
};

template <int C, bool kFinal, typename E>
size_t wg_res_smem() {
  using R = WgRes<C, E>;
  return 1024 + (size_t)R::X_STAGES * R::XSTAGE + (size_t)R::W1_STAGES * R::W1STAGE +
         (R::F32 ? 2 : 1) * (size_t)R::W2_BYTES + (kFinal ? sizeof(float) * kWgBM * R::LDO : 0) +
         8 * (size_t)(3 * R::X_STAGES + 2 * R::W1_STAGES + 1);
}

// x [B, T_in, C] -> y = x + conv1(elu(conv3(elu(x)))) [B, T_out, C] (with
// elu_out: elu of it), or with kFinal wav [B, T_out] = final3(elu(y)). w1hi /
// w1lo [3 * C/2, C] (row j * C/2 + h: tap j, K-major), b1 [C/2], w2hi / w2lo
// [C, C/2] (K-major, K in `resblock_k_order`), b2 [C], wf [3*C], bf [1].
// Output row t of batch row b is the causal result at input row a0 + t,
// a0 = T_in - T_out; input rows before row_start(start, start_stride, b) read
// as zero, and so do the final conv's input rows before it. Tile i of batch
// row b holds output rows t0 = i * BMO..; its window starts at input row
// a0 + t0 - HF - 2.
// E as for the conv: bfloat16 takes w1hi / w2hi as the weights, w1lo / w2lo unused.
template <typename E>
struct ResArgs {
  const E *x, *w1hi, *w1lo, *b1, *w2hi, *w2lo, *b2, *wf, *bf;
  E* y;
  const int* start;
  int start_stride, B, T_in, T_out;
  int elu_out;  // without the final conv: y = elu(block output)
};

struct ResMaps {
  CUtensorMap x, w1hi, w1lo, w2hi, w2lo;
};

// E = __nv_bfloat16: bfloat16 `wgmma` products, rounding where the TPU kernel
// rounds: elu(x), the hidden (conv + bias), elu(hidden), the k1 conv + bias,
// the residual add, elu(block output) and the waveform.
template <int C, bool kFinal, typename E>
__global__ void __launch_bounds__(kWgThreads, 1)
    resblock_wgmma_kernel(const __grid_constant__ ResMaps maps, const ResArgs<E> a) {
  using R = WgRes<C, E>;
  constexpr int H = R::H, HF = kFinal ? 2 : 0, BMO = kWgBM - HF;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* xring = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* w1ring = xring + R::X_STAGES * R::XSTAGE;
  uint8_t* w2s = w1ring + R::W1_STAGES * R::W1STAGE;  // [hi | lo][W2BOX][C][BK]
  float* outb = reinterpret_cast<float*>(w2s + (R::F32 ? 2 : 1) * R::W2_BYTES);  // [128][LDO]
  uint64_t* xfull = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(outb) +
                                                (kFinal ? sizeof(float) * kWgBM * R::LDO : 0));
  uint64_t* xready = xfull + R::X_STAGES;
  uint64_t* xempty = xready + R::X_STAGES;
  uint64_t* wfull = xempty + R::X_STAGES;
  uint64_t* wempty = wfull + R::W1_STAGES;
  uint64_t* w2bar = wempty + R::W1_STAGES;

  const int a0 = a.T_in - a.T_out;
  const int tiles_t = (a.T_out + BMO - 1) / BMO, ntiles = a.B * tiles_t;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < R::X_STAGES; ++s) {
      hopper::mbar_init(&xfull[s], 1);
      hopper::mbar_init(&xready[s], 3);  // one arrival per transform warp
      hopper::mbar_init(&xempty[s], 8);  // one per consumer warp
    }
    for (int s = 0; s < R::W1_STAGES; ++s) {
      hopper::mbar_init(&wfull[s], 1);
      hopper::mbar_init(&wempty[s], 8);
    }
    hopper::mbar_init(w2bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    hopper::regs_dec<40>();
    int it = 0, ib = 0;
    if (warp == 8) {  // the copies
      if (lane == 0) {
        hopper::mbar_expect_tx(w2bar, (R::F32 ? 2 : 1) * R::W2_BYTES);
        for (int k = 0; k < R::W2BOX; ++k) {
          hopper::tma_load_2d(w2s + k * C * 128, &maps.w2hi, w2bar, k * R::BK, 0);
          if constexpr (R::F32)
            hopper::tma_load_2d(w2s + R::W2_BYTES + k * C * 128, &maps.w2lo, w2bar, k * R::BK, 0);
        }
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
          const int b = tile / tiles_t, tx0 = a0 + (tile - b * tiles_t) * BMO - HF - 2;
          const int sx = it % R::X_STAGES;
          if (it >= R::X_STAGES) hopper::mbar_wait(&xempty[sx], (it / R::X_STAGES - 1) & 1);
          hopper::mbar_expect_tx(&xfull[sx], R::XBOX * R::RX * 128);
          for (int c = 0; c < R::XBOX; ++c)
            hopper::tma_load_3d(xring + sx * R::XSTAGE + c * R::XBOX_BYTES, &maps.x, &xfull[sx],
                                c * R::BK, tx0, b);
          for (int c = 0; c < R::XBOX; ++c)
            for (int j = 0; j < 3; ++j, ++ib) {
              const int sb = ib % R::W1_STAGES;
              if (ib >= R::W1_STAGES) hopper::mbar_wait(&wempty[sb], (ib / R::W1_STAGES - 1) & 1);
              uint8_t* d = w1ring + sb * R::W1STAGE;
              hopper::mbar_expect_tx(&wfull[sb], R::W1STAGE);
              hopper::tma_load_2d(d, &maps.w1hi, &wfull[sb], c * R::BK, j * H);
              if constexpr (R::F32)
                hopper::tma_load_2d(d + R::W1_BYTES, &maps.w1lo, &wfull[sb], c * R::BK, j * H);
            }
        }
      }
      __syncwarp();
      return;
    }
    // the transform warps: ELU and the stream-start mask on each window, in place
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
      const int b = tile / tiles_t, tx0 = a0 + (tile - b * tiles_t) * BMO - HF - 2;
      const int lo = row_start(a.start, a.start_stride, b);
      const int sx = it % R::X_STAGES;
      uint8_t* xs = xring + sx * R::XSTAGE;
      hopper::mbar_wait(&xfull[sx], (it / R::X_STAGES) & 1);
      for (int v = tid - 288; v < R::XBOX * R::RX * 8; v += 96) {  // 16-byte chunks
        const int box = v / (R::RX * 8), rem = v - box * (R::RX * 8);
        const bool zero = tx0 + (rem >> 3) < lo;
        if constexpr (R::F32) {
          float4* p = reinterpret_cast<float4*>(xs + box * R::XBOX_BYTES + 16 * rem);
          const float4 x = *p;
          *p = zero ? make_float4(0.f, 0.f, 0.f, 0.f) : make_float4(elu(x.x), elu(x.y), elu(x.z), elu(x.w));
        } else {
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(xs + box * R::XBOX_BYTES + 16 * rem);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[i] = zero ? __floats2bfloat162_rn(0.f, 0.f)
                        : __floats2bfloat162_rn(elu(__low2float(p[i])), elu(__high2float(p[i])));
        }
      }
      hopper::fence_proxy_async();  // the in-place writes before TMA refills the stage
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&xready[sx]);
    }
    return;
  }

  hopper::regs_inc<232>();
  const int g = lane >> 2, q = lane & 3;
  const int rw = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's tile rows rw and rw + 8
  float acc1[H / 2], part1[H / 2], acc2[C / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) part1[i] = 0.f;
  hopper::mbar_wait(w2bar, 0);
  int it = 0, ib = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int b = tile / tiles_t, t0 = (tile - b * tiles_t) * BMO;
    const int sx = it % R::X_STAGES;
    const uint8_t* xs = xring + sx * R::XSTAGE;
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc1[i] = 0.f;
    hopper::mbar_wait(&xready[sx], (it / R::X_STAGES) & 1);
    // k3 conv: hidden row i = sum_j elu(x)[window row i + j] . w1[j]
    for (int c = 0; c < R::XBOX; ++c) {
      const uint8_t* xb = xs + c * R::XBOX_BYTES;
#pragma unroll
      for (int j = 0; j < 3; ++j, ++ib) {
        const int sb = ib % R::W1_STAGES;
        hopper::mbar_wait(&wfull[sb], (ib / R::W1_STAGES) & 1);
        const uint8_t* wt = w1ring + sb * R::W1STAGE;
        const uint64_t dhi = hopper::desc_k128(wt);
        const int ra = rw + j;
        if constexpr (R::F32) {
          const uint64_t dlo = hopper::desc_k128(wt + R::W1_BYTES);
          uint32_t ahi[4][4], alo[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = ks * 8 + q + 4 * (i >> 1);
              float hi, lo;
              tf32x3::split(*reinterpret_cast<const float*>(xb + hopper::sw128(ra + 8 * (i & 1), 4 * k)), hi, lo);
              ahi[ks][i] = __float_as_uint(hi);
              alo[ks][i] = __float_as_uint(lo);
            }
          hopper::fence_regs(part1);
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            hopper::wgmma_tf32<H>(part1, alo[ks], dhi + 2 * ks, ks > 0);
            hopper::wgmma_tf32<H>(part1, ahi[ks], dlo + 2 * ks, 1);
            hopper::wgmma_tf32<H>(part1, ahi[ks], dhi + 2 * ks, 1);
          }
        } else {
          uint32_t av[4][4];
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = ks * 16 + 2 * q + 8 * (i >> 1);
              av[ks][i] = *reinterpret_cast<const uint32_t*>(xb + hopper::sw128(ra + 8 * (i & 1), 2 * k));
            }
          hopper::fence_regs(part1);
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) hopper::wgmma_bf16<H>(part1, av[ks], dhi + 2 * ks, ks > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(part1);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&wempty[sb]);
#pragma unroll
        for (int i = 0; i < H / 2; ++i) acc1[i] += part1[i];
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&xempty[sx]);  // the window is done with

    // elu(hidden + b1) in registers (bfloat16: the hidden rounded, then its ELU)
#pragma unroll
    for (int i = 0; i < H / 2; ++i) {
      const int ch = 8 * (i >> 2) + 2 * q + (i & 1);
      if constexpr (R::F32)
        acc1[i] = elu(acc1[i] + __ldg(a.b1 + ch));
      else
        acc1[i] = tf32x3::bf16_round(elu(tf32x3::bf16_round(acc1[i] + tf32x3::ldg_f(a.b1 + ch))));
    }
    // k1 conv: the hidden fragment is the A operand, w2 resident
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc2[i] = 0.f;
    hopper::fence_regs(acc2);
    hopper::wgmma_fence();
    if constexpr (R::F32) {
      uint32_t ahi[H / 8][4], alo[H / 8][4];
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // k positions q, q + 4 of step j: hidden columns 8j + 2q, 8j + 2q + 1
          float hi, lo;
          tf32x3::split(acc1[4 * j + ((i & 1) << 1) + (i >> 1)], hi, lo);
          ahi[j][i] = __float_as_uint(hi);
          alo[j][i] = __float_as_uint(lo);
        }
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int box = j * 8 / R::BK, off = (j * 8 - box * R::BK) * 4;  // bytes into the box row
        const uint64_t dhi = hopper::desc_k128(w2s + box * C * 128) + (off >> 4);
        const uint64_t dlo = hopper::desc_k128(w2s + R::W2_BYTES + box * C * 128) + (off >> 4);
        hopper::wgmma_tf32<C>(acc2, alo[j], dhi, 1);
        hopper::wgmma_tf32<C>(acc2, ahi[j], dlo, 1);
        hopper::wgmma_tf32<C>(acc2, ahi[j], dhi, 1);
      }
    } else {
      uint32_t av[H / 16][4];
#pragma unroll
      for (int j = 0; j < H / 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // pairs (8j + 2i, 8j + 2i + 1) of the fragment
          const __nv_bfloat162 pr = __floats2bfloat162_rn(acc1[8 * j + 2 * i], acc1[8 * j + 2 * i + 1]);
          av[j][i] = *reinterpret_cast<const uint32_t*>(&pr);
        }
#pragma unroll
      for (int j = 0; j < H / 16; ++j)
        hopper::wgmma_bf16<C>(acc2, av[j], hopper::desc_k128(w2s) + ((j * 32) >> 4), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc2);

    // block output row i (output row t = t0 - HF + i, input row a0 + t) = acc2 + b2 + x
    const int lo = row_start(a.start, a.start_stride, b);
    const E* xrow = a.x + (size_t)b * a.T_in * C;
#pragma unroll
    for (int i = 0; i < C / 2; i += 2) {
      const int r = rw + 8 * ((i >> 1) & 1), n = 8 * (i >> 2) + 2 * q, t = t0 - HF + r;
      float2 v = make_float2(acc2[i], acc2[i + 1]);
      float2 xr = make_float2(0.f, 0.f);
      if (a0 + t >= 0 && a0 + t < a.T_in) {
        if constexpr (R::F32)
          xr = __ldg(reinterpret_cast<const float2*>(xrow + (size_t)(a0 + t) * C + n));
        else
          xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xrow + (size_t)(a0 + t) * C + n));
      }
      if constexpr (R::F32) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(a.b2 + n));
        v = make_float2(v.x + bb.x + xr.x, v.y + bb.y + xr.y);
      } else {  // the conv rounds, then the residual add rounds
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b2 + n));
        v = make_float2(tf32x3::bf16_round(tf32x3::bf16_round(v.x + bb.x) + xr.x),
                        tf32x3::bf16_round(tf32x3::bf16_round(v.y + bb.y) + xr.y));
      }
      if constexpr (kFinal) {  // causal zero padding of the final conv
        const bool ok = a0 + t >= lo;
        const float ex = ok ? elu(v.x) : 0.f, ey = ok ? elu(v.y) : 0.f;
        outb[r * R::LDO + n] = R::F32 ? ex : tf32x3::bf16_round(ex);
        outb[r * R::LDO + n + 1] = R::F32 ? ey : tf32x3::bf16_round(ey);
      } else if (t < a.T_out) {
        if (a.elu_out) v = make_float2(elu(v.x), elu(v.y));
        E* yo = a.y + ((size_t)b * a.T_out + t) * C + n;
        if constexpr (R::F32)
          *reinterpret_cast<float2*>(yo) = v;
        else
          *reinterpret_cast<__nv_bfloat162*>(yo) = __floats2bfloat162_rn(v.x, v.y);
      }
    }
    if constexpr (kFinal) {  // output row o (time t0 + o): four threads, each a quarter of the 3C terms
      hopper::named_sync(1, 256);
      for (int o0 = 0; o0 < BMO; o0 += 64) {  // the whole warp in step for the shuffles
        const int o = o0 + (tid >> 2), sub = tid & 3;
        float s = 0.f;
        if (o < BMO) {
#pragma unroll 8
          for (int k = 0; k < 3 * C / 4; ++k) {
            const int p = sub + 4 * k, j = p / C, ci = p - j * C;
            s = fmaf(outb[(o + j) * R::LDO + ci], tf32x3::ldg_f(a.wf + p), s);
          }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (sub == 0 && o < BMO && t0 + o < a.T_out)
          a.y[(size_t)b * a.T_out + t0 + o] = tf32x3::from_f<E>(s + tf32x3::ldg_f(a.bf));
      }
      hopper::named_sync(1, 256);  // outb is free for the next tile
    }
  }
}

template <int C, bool kFinal, typename E>
int launch_resblock(const ResArgs<E>& a, cudaStream_t s) {
  using R = WgRes<C, E>;
  constexpr bool bf16 = !R::F32;
  const size_t smem = wg_res_smem<C, kFinal, E>();
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const uint64_t es = sizeof(E);
  ResMaps maps;
  const uint64_t xd[3] = {(uint64_t)C, (uint64_t)a.T_in, (uint64_t)a.B};
  const uint64_t xs[2] = {C * es, (uint64_t)a.T_in * C * es};
  const uint32_t xb[3] = {(uint32_t)R::BK, (uint32_t)R::RX, 1};
  const uint64_t w1d[2] = {(uint64_t)C, 3 * (uint64_t)R::H}, w1s[1] = {C * es};
  const uint32_t w1b[2] = {(uint32_t)R::BK, (uint32_t)R::H};
  const uint64_t w2d[2] = {(uint64_t)R::H, (uint64_t)C}, w2s[1] = {R::H * es};
  const uint32_t w2b[2] = {(uint32_t)R::BK, (uint32_t)C};
  cudaError_t e = hopper::make_map(&maps.x, bf16, 3, a.x, xd, xs, xb);
  if (e == cudaSuccess) e = hopper::make_map(&maps.w1hi, bf16, 2, a.w1hi, w1d, w1s, w1b);
  if (e == cudaSuccess) e = hopper::make_map(&maps.w1lo, bf16, 2, R::F32 ? a.w1lo : a.w1hi, w1d, w1s, w1b);
  if (e == cudaSuccess) e = hopper::make_map(&maps.w2hi, bf16, 2, a.w2hi, w2d, w2s, w2b);
  if (e == cudaSuccess) e = hopper::make_map(&maps.w2lo, bf16, 2, R::F32 ? a.w2lo : a.w2hi, w2d, w2s, w2b);
  if (e != cudaSuccess) return (int)e;
  auto kernel = resblock_wgmma_kernel<C, kFinal, E>;
  static LaunchCache caches[kMaxDevices];
  LaunchCache* cache = nullptr;
  e = prepare(kernel, caches, smem, cache);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (long long)a.B * ((a.T_out + kWgBM - (kFinal ? 2 : 0) - 1) / (kWgBM - (kFinal ? 2 : 0)));
  if (ntiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(ntiles < cache->sms ? ntiles : cache->sms), kWgThreads, smem, s>>>(maps, a);
  return (int)cudaGetLastError();
}

template <typename E>
int conv_tc(const E* x, const E* whi, const E* wlo, const E* bias, const E* residual, E* y, int B,
            int T_in, int T_out, int res_T, int Cin, int cinp, int N, int np, int taps, int dil,
            int elu, const int* start, int start_stride, int max_splits, void* stream) {
  if (B <= 0 || T_out <= 0 || T_out > T_in || Cin <= 0 || N <= 0 || taps <= 0 || dil <= 0 ||
      cinp < Cin || cinp % 32 != 0 || np < N || np % kWgBN != 0 || max_splits < 1 ||
      max_splits > kMaxSplits || (residual != nullptr && res_T < T_out))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ConvArgs<E> a = {x, whi, wlo, bias, residual, y, start, start_stride, B, T_in, T_out,
                         res_T, Cin, cinp, N, np, dil, elu, 1, 0};
  if ((Cin * sizeof(E)) % 16 != 0) return (int)cudaErrorInvalidValue;  // TMA reads 16-byte rows
  if (taps == 1) return launch_conv_wgmma<1, E>(a, max_splits, s);
  if (taps == 2) return launch_conv_wgmma<2, E>(a, max_splits, s);
  if (taps == 3) return launch_conv_wgmma<3, E>(a, max_splits, s);
  if (taps == 7) return launch_conv_wgmma<7, E>(a, max_splits, s);
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int resblock(const E* x, const E* w1hi, const E* w1lo, const E* b1, const E* w2hi,
             const E* w2lo, const E* b2, const E* wf, const E* bf, E* y, int B, int T_in,
             int T_out, int C, int mode, const int* start, int start_stride, void* stream) {
  const int final = mode & 1;
  if (B <= 0 || T_out <= 0 || T_out > T_in || mode == 3) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const ResArgs<E> a = {x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, start, start_stride, B,
                        T_in, T_out, (mode >> 1) & 1};
  if (C == 128 && !final) return launch_resblock<128, false, E>(a, s);
  if (C == 128 && final) return launch_resblock<128, true, E>(a, s);
  if (C == 64 && !final) return launch_resblock<64, false, E>(a, s);
  if (C == 64 && final) return launch_resblock<64, true, E>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3 / K4 (a): one conv, output row t the causal conv at input row
// T_in - T_out + t. x [B, T_in, Cin]; whi / wlo [taps, np, cinp] (the TF32
// split of w [taps, Cin, N], K-major, zero-padded: cinp a multiple of 32, np
// of 128); bias [N]; residual (nullable) [B, res_T, N], row t + res_T - T_out
// added to output row t; y [B, T_out, N]; elu: bit 0 the ELU on the input,
// bit 1 on the output (after bias and residual); start (nullable) int32,
// input rows of batch row b before start[b * start_stride] read as zero; the
// Cin chunks of a conv with few tiles split over up to max_splits blocks of a
// cluster. All float32 contiguous, 16-byte
// aligned. Returns cudaGetLastError() after the launch.
extern "C" int sopro_seanet_conv_tc(const float* x, const float* whi, const float* wlo,
                                    const float* bias, const float* residual, float* y, int B,
                                    int T_in, int T_out, int res_T, int Cin, int cinp, int N,
                                    int np, int taps, int dil, int elu, const int* start,
                                    int start_stride, int max_splits, void* stream) {
  return conv_tc<float>(x, whi, wlo, bias, residual, y, B, T_in, T_out, res_T, Cin, cinp, N, np,
                        taps, dil, elu, start, start_stride, max_splits, stream);
}

// The bfloat16 instantiation, the same arguments in bfloat16: whi the
// weights [taps, np, cinp] themselves (K-major, zero-padded as above), wlo
// unused.
extern "C" int sopro_seanet_conv_tc_bf16(const __nv_bfloat16* x, const __nv_bfloat16* whi,
                                         const __nv_bfloat16* wlo, const __nv_bfloat16* bias,
                                         const __nv_bfloat16* residual, __nv_bfloat16* y, int B,
                                         int T_in, int T_out, int res_T, int Cin, int cinp, int N,
                                         int np, int taps, int dil, int elu, const int* start,
                                         int start_stride, int max_splits, void* stream) {
  return conv_tc<__nv_bfloat16>(x, whi, wlo, bias, residual, y, B, T_in, T_out, res_T, Cin, cinp,
                                N, np, taps, dil, elu, start, start_stride, max_splits, stream);
}

// K3 / K4 (b): one residual block of C = 128 or 64 channels, k3 conv
// dilation 1, output row t the causal result at input row T_in - T_out + t.
// x [B, T_in, C]; mode 0: y [B, T_out, C]; mode 2: y = elu(block output);
// mode 1: also the final k3 conv to one channel, y [B, T_out]; start
// (nullable) as for the conv. Weights as in resblock_wgmma_kernel. Returns
// cudaGetLastError() after the launch.
extern "C" int sopro_seanet_resblock(const float* x, const float* w1hi, const float* w1lo,
                                     const float* b1, const float* w2hi, const float* w2lo,
                                     const float* b2, const float* wf, const float* bf, float* y,
                                     int B, int T_in, int T_out, int C, int mode,
                                     const int* start, int start_stride, void* stream) {
  return resblock<float>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, B, T_in, T_out, C, mode,
                         start, start_stride, stream);
}

// The bfloat16 instantiation, the same arguments in bfloat16: w1hi / w2hi the
// weights themselves, w1lo / w2lo unused.
extern "C" int sopro_seanet_resblock_bf16(
    const __nv_bfloat16* x, const __nv_bfloat16* w1hi, const __nv_bfloat16* w1lo,
    const __nv_bfloat16* b1, const __nv_bfloat16* w2hi, const __nv_bfloat16* w2lo,
    const __nv_bfloat16* b2, const __nv_bfloat16* wf, const __nv_bfloat16* bf, __nv_bfloat16* y,
    int B, int T_in, int T_out, int C, int mode, const int* start, int start_stride,
    void* stream) {
  return resblock<__nv_bfloat16>(x, w1hi, w1lo, b1, w2hi, w2lo, b2, wf, bf, y, B, T_in, T_out, C,
                                 mode, start, start_stride, stream);
}
