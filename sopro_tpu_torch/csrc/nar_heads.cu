// Kernel K2: NAR stage heads + greedy argmax, float32 or bfloat16 in, int32 ids out.
//
// Replaces sopro_tpu/ops/pallas_nar.py::nar_heads_argmax (its `_kernel`).
// Per stage: ids[row, h] = argmax_v((z[row] + hid[h]) . W[h][:, v] + b[h][v]),
// float32 accumulation, bias added in float32, ties to the lowest index.
// The [rows, H, V] logits are never stored: only the ids leave the kernel.
//
// What bounds it on the H100: at the main path's shape (rows = 401,
// hd = 256, V = 2048, H = 3/4/8/16 over the four stages) the four stages are
// 13.0 GFLOP against 65 MB of float32 weights: compute-bound. Full float32
// on the CUDA cores is bounded at 0.195 ms (67 TF/s); the design runs the
// products on the tensor cores as 3-pass TF32 (tf32x3.cuh), bounded at
// 0.079 ms (3 x 13.0 GFLOP / 495 TF/s), with float32-level error.
//
// Design: one launch per stage, no scratch and no second kernel. A thread
// block cluster of CN = ceil(V / 256) <= 8 blocks (grid x) splits V; grid y
// is the row tile, grid z the head, so the blocks running at one time share
// one head's weights in L2. Row tiles of BM = 16, 32 or 64 rows (the host picks
// the one with the fewest waves of blocks, so the stream's 6-row stage E
// runs one 16-row tile). Each block:
// - forms (z + hid[h]) for its BM rows once, split into TF32 hi/lo, in
//   shared memory;
// - streams its [hd, 256] slice of the pre-split weights (pack_nar_heads:
//   hi and lo arrays [H, kp, vp], zero-padded) through a cp.async ring of
//   3-4 stages, BK rows per stage, and runs m16n8k8 TF32 MMAs on it, three
//   per fragment pair;
// - adds the bias in registers and keeps, per row, a (max, lowest index)
//   pair: per thread over its columns in increasing order, then over the 4
//   lanes sharing the rows (shuffles), then over the warps (shared memory).
// The cluster's blocks meet through distributed shared memory: rank 0 reads
// every rank's pairs in rank order (columns in increasing order) and writes
// the int32 ids. Near-ties (a top-2 margin of a few 1e-6) may resolve
// differently from a float32 einsum, as between any two float32 orders.
//
// The bfloat16 instantiation (sopro_nar_heads_argmax_bf16) computes what the
// TPU kernel computes on bfloat16 inputs: zh = z + hid rounded to bfloat16,
// products accumulated in float32, the bias added in float32. Design (a) of
// the two that fit: the same TF32 m16n8k8 MMAs in ONE pass, no hi/lo split. A
// bfloat16 value is exact in TF32 (8 mantissa bits against 10), so one pass on
// bfloat16 operands gives the bfloat16 products exactly, with float32
// accumulation; (b), bf16 m16n8k16, runs twice the rate but needs other
// fragment layouts than this kernel's, for a compute share that one pass
// already cuts by three. The weights are read as bfloat16 (pack_nar_heads of a
// bfloat16 stack: one array [H, kp, vp], half the fp32 bytes, a third of the
// hi/lo pair's), staged in shared memory as 16-bit values and widened to TF32
// (a 16-bit shift) as each B fragment is loaded; zh is rounded once per tile
// into shared memory as float. Bound at the main path's shape by the products
// at the TF32 rate: 13.0 GFLOP / 495 TF/s = 0.026 ms.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 256;       // columns per block
constexpr int kLDB = kBN + 8;  // ring row stride (B fragments on 32 banks)
constexpr int kLDB16 = kBN + 16;  // the bfloat16 ring's row stride: 136 words, B fragments on 32 banks
constexpr int kMaxCluster = 8;

template <int BM>
struct Tile {
  static constexpr int WGM = BM == 64 ? 2 : 1;  // warps along rows
  static constexpr int WGN = 8 / WGM;           // warps along columns
  static constexpr int WM = BM / WGM, WN = kBN / WGN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int BK = BM == 64 ? 8 : 16;      // weight rows per ring stage
  static constexpr int STAGES = BM == 64 ? 4 : 3;  // ring depth
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int BM, typename E>
size_t smem_bytes(int kp) {
  using T = Tile<BM>;
  if constexpr (std::is_same<E, float>::value)
    return sizeof(float) * ((size_t)2 * BM * (kp + 4) + (size_t)T::STAGES * 2 * T::BK * kLDB +
                            (size_t)2 * T::WGN * BM + 2 * BM);
  else  // zh [BM][kp + 4] as float, the ring [STAGES][BK][kLDB16] as bfloat16
    return sizeof(float) * ((size_t)BM * (kp + 4) + (size_t)2 * T::WGN * BM + 2 * BM) +
           sizeof(__nv_bfloat16) * (size_t)T::STAGES * T::BK * kLDB16;
}


// E: float (the 3-pass kernel: whi / wlo the TF32 split) or __nv_bfloat16
// (one pass: whi the bfloat16 weights, wlo unused).
template <int BM, typename E>
__global__ void __launch_bounds__(kThreads) nar_heads_kernel(
    const E* __restrict__ z, const E* __restrict__ hid, const E* __restrict__ whi,
    const E* __restrict__ wlo, const E* __restrict__ bias, int* __restrict__ ids,
    int rows, int H, int hd, int kp, int V, int vp) {
  using T = Tile<BM>;
  constexpr bool kF32 = std::is_same<E, float>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lda = kp + 4;
  float* a_hi = smem;                       // [BM][lda]
  float* a_lo = a_hi + BM * lda;            // [BM][lda] (float32 only)
  float* ring = kF32 ? a_lo + BM * lda : a_lo;  // [STAGES][hi, lo][BK][kLDB]
  unsigned short* ring16 = reinterpret_cast<unsigned short*>(a_lo);  // [STAGES][BK][kLDB16]
  float* red_v = kF32 ? ring + T::STAGES * 2 * T::BK * kLDB
                      : reinterpret_cast<float*>(ring16 + T::STAGES * T::BK * kLDB16);  // [WGN][BM]
  int* red_i = reinterpret_cast<int*>(red_v + T::WGN * BM);
  float* best_v = reinterpret_cast<float*>(red_i + T::WGN * BM);  // [BM], read by rank 0
  int* best_i = reinterpret_cast<int*>(best_v + BM);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cn = (int)cluster.num_blocks();
  const int h = blockIdx.z, row0 = blockIdx.y * BM, n0 = rank * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp / T::WGN, wn = warp % T::WGN;
  const E* wh = whi + (size_t)h * kp * vp + n0;
  const E* wl = kF32 ? wlo + (size_t)h * kp * vp + n0 : nullptr;
  const int nk = kp / T::BK;

  auto load_w = [&](int chunk, int slot) {
    if (chunk < nk) {
      if constexpr (kF32) {
        constexpr int kPerHalf = T::BK * (kBN / 4);
        for (int i = tid; i < 2 * kPerHalf; i += kThreads) {
          const int half = i / kPerHalf, rem = i - half * kPerHalf;
          const int kk = rem / (kBN / 4), c4 = rem - kk * (kBN / 4);
          const float* src = (half ? wl : wh) + (size_t)(chunk * T::BK + kk) * vp + c4 * 4;
          float* dst = ring + ((slot * 2 + half) * T::BK + kk) * kLDB + c4 * 4;
          tf32x3::cp_async16(dst, src, true);
        }
      } else {  // 16 bytes = 8 bfloat16 a copy
        constexpr int kPer = T::BK * (kBN / 8);
        for (int i = tid; i < kPer; i += kThreads) {
          const int kk = i / (kBN / 8), c8 = i - kk * (kBN / 8);
          tf32x3::cp_async16(ring16 + (slot * T::BK + kk) * kLDB16 + c8 * 8,
                             wh + (size_t)(chunk * T::BK + kk) * vp + c8 * 8, true);
        }
      }
    }
    tf32x3::cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) load_w(s, s);

  // (z + hid[h]) for this tile, split once (bfloat16: rounded to bfloat16)
  for (int i = tid; i < BM * kp; i += kThreads) {
    const int r = i / kp, k = i - r * kp, row = row0 + r;
    if constexpr (kF32) {
      const float v = (row < rows && k < hd) ? __ldg(z + (size_t)row * hd + k) + __ldg(hid + (size_t)h * hd + k) : 0.f;
      tf32x3::split(v, a_hi[r * lda + k], a_lo[r * lda + k]);
    } else {
      const float v = (row < rows && k < hd) ? tf32x3::ldg_f(z + (size_t)row * hd + k) + tf32x3::ldg_f(hid + (size_t)h * hd + k) : 0.f;
      a_hi[r * lda + k] = __bfloat162float(__float2bfloat16_rn(v));
    }
  }

  float acc[T::MT][T::NT][4];
  tf32x3::zero(acc);
  const int a_off = wm * T::WM * lda;
  for (int c = 0; c < nk; ++c) {
    tf32x3::cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // chunk c landed for all; the slot refilled below is free
    load_w(c + T::STAGES - 1, (c + T::STAGES - 1) % T::STAGES);
    if constexpr (kF32) {
      const float* bh = ring + ((c % T::STAGES) * 2) * T::BK * kLDB + wn * T::WN;
      tf32x3::mma3_tile<T::MT, T::NT>(acc, a_hi + a_off + c * T::BK, a_lo + a_off + c * T::BK, lda,
                                      bh, bh + T::BK * kLDB, kLDB, T::BK / 8);
    } else {
      tf32x3::mma1_tile_bf16<T::MT, T::NT>(acc, a_hi + a_off + c * T::BK, lda,
                                   ring16 + (c % T::STAGES) * T::BK * kLDB16 + wn * T::WN, kLDB16,
                                   T::BK / 8);
    }
  }

  // bias in registers: this thread's columns, increasing
  float bcol[T::NT][2];
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn * T::WN + nt * 8 + 2 * q + e;
      bcol[nt][e] = col < V ? tf32x3::ldg_f(bias + (size_t)h * V + col) : -INFINITY;
    }
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * T::WN + nt * 8 + 2 * q + e;
          const float l = acc[mt][nt][hh * 2 + e] + bcol[nt][e];
          if (col < V && better(l, col, bv, bi)) {
            bv = l;
            bi = col;
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (q == 0) {
        const int r = wm * T::WM + mt * 16 + hh * 8 + g;
        red_v[wn * BM + r] = bv;
        red_i[wn * BM + r] = bi;
      }
    }
  __syncthreads();
  if (tid < BM) {
    float bv = red_v[tid];
    int bi = red_i[tid];
    for (int w = 1; w < T::WGN; ++w)
      if (better(red_v[w * BM + tid], red_i[w * BM + tid], bv, bi)) {
        bv = red_v[w * BM + tid];
        bi = red_i[w * BM + tid];
      }
    best_v[tid] = bv;
    best_i[tid] = bi;
  }
  cluster.sync();  // every rank's pairs visible to rank 0
  if (rank == 0 && tid < BM && row0 + tid < rows) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int r = 0; r < cn; ++r) {
      const float v = cluster.map_shared_rank(best_v, r)[tid];
      const int i = cluster.map_shared_rank(best_i, r)[tid];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    ids[(size_t)(row0 + tid) * H + h] = bi < V ? bi : 0;
  }
  cluster.sync();  // rank 0 done reading the others' shared memory
}

template <int BM, typename E>
int launch(const E* z, const E* hid, const E* whi, const E* wlo,
           const E* bias, int* out, int rows, int H, int hd, int kp, int V, int vp,
           cudaStream_t s) {
  const size_t smem = smem_bytes<BM, E>(kp);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(nar_heads_kernel<BM, E>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int cn = vp / kBN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cn, (rows + BM - 1) / BM, H);  // heads slowest: a head's slice stays in L2
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nar_heads_kernel<BM, E>, z, hid, whi, wlo, bias, out, rows, H, hd,
                         kp, V, vp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The row tile the launch takes: fewest waves of (row tiles x H x CN)
// blocks at one block per SM, weighted by the tile's rows plus a fixed cost
// for streaming the block's weight slice.
int row_tile(int rows, int H, int V) {
  const long long cn = (V + kBN - 1) / kBN;
  int best = 16;
  long long best_cost = -1;
  const int tiles[3] = {16, 32, 64};
  for (int bm : tiles) {
    const long long blocks = (rows + bm - 1) / bm * (long long)H * cn;
    const long long cost = (blocks + 131) / 132 * (bm + 16);
    if (best_cost < 0 || cost <= best_cost) {
      best = bm;
      best_cost = cost;
    }
  }
  return best;
}

template <typename E>
int dispatch(const E* z, const E* hid, const E* whi, const E* wlo, const E* bias, int* out,
             int rows, int H, int hd, int kp, int V, int vp, void* stream) {
  if (rows <= 0 || H <= 0 || hd <= 0 || V <= 0 || H > 65535 || kp < hd || kp % 16 != 0 ||
      vp != kBN * ((V + kBN - 1) / kBN) || vp / kBN > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int bm = row_tile(rows, H, V);
  if ((rows + bm - 1) / bm > 65535) return (int)cudaErrorInvalidValue;
  if (bm == 16) return launch<16, E>(z, hid, whi, wlo, bias, out, rows, H, hd, kp, V, vp, s);
  if (bm == 32) return launch<32, E>(z, hid, whi, wlo, bias, out, rows, H, hd, kp, V, vp, s);
  return launch<64, E>(z, hid, whi, wlo, bias, out, rows, H, hd, kp, V, vp, s);
}

}  // namespace

// z [rows, hd], hid [H, hd], bias [H, V] float32; whi / wlo [H, kp, vp]
// (pack_nar_heads: the TF32 hi / lo split of W [H, hd, V], zero-padded to kp
// = hd rounded up to 16 and vp = 256 * ceil(V / 256)); out [rows, H] int32.
// All contiguous. Returns cudaGetLastError() after the launch.
extern "C" int sopro_nar_heads_argmax(const float* z, const float* hid, const float* whi,
                                      const float* wlo, const float* bias, int* out, int rows,
                                      int H, int hd, int kp, int V, int vp, void* stream) {
  return dispatch<float>(z, hid, whi, wlo, bias, out, rows, H, hd, kp, V, vp, stream);
}

// The bfloat16 instantiation: z, hid, bias and w [H, kp, vp] (pack_nar_heads
// of a bfloat16 stack, zero-padded as above) bfloat16; out [rows, H] int32.
extern "C" int sopro_nar_heads_argmax_bf16(const __nv_bfloat16* z, const __nv_bfloat16* hid,
                                           const __nv_bfloat16* w, const __nv_bfloat16* bias,
                                           int* out, int rows, int H, int hd, int kp, int V,
                                           int vp, void* stream) {
  if (w == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<__nv_bfloat16>(z, hid, w, nullptr, bias, out, rows, H, hd, kp, V, vp, stream);
}
