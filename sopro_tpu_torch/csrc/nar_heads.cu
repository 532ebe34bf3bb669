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
// 0.079 ms (3 x 13.0 GFLOP / 495 TF/s), with float32-level error. Each block
// also streams its head's [256 columns, hd] hi/lo weight slice from L2 once
// per row tile: the weight bytes per product fall with the rows a block
// holds, which is why a block takes 128 rows where the grid still fills the
// card.
//
// Design (Hopper's own path, hopper.cuh): one launch per stage, no scratch
// and no second kernel. A thread-block cluster of CN = ceil(V / 256) <= 8
// blocks (grid x) splits V; grid y is the row tile, grid z the head, so the
// blocks running at one time share one head's weights in L2. A block holds
// BM = 64 or 128 rows (the host picks the one with the fewest waves of
// blocks; the stream's 6-row stage E runs one 64-row tile, zero-padded by
// TMA) and 256 columns:
// - one producer warp(group): its lane 0 walks K in chunks of 128 bytes (32 floats
//   or 64 bfloat16 values) and, per chunk, TMA-loads the z tile [BM, chunk]
//   and the weight tiles [256, chunk] (pack_nar_heads: K-major [H, vp, kp],
//   float32 as TF32 hi and lo, bfloat16 as is) into a ring of 2-4 stages, a
//   full and an empty mbarrier each;
// - BM / 64 consumer warpgroups, each 64 rows x all 256 columns: per chunk
//   they form zh = z + hid[h] in registers from the z tile, split it into
//   TF32 hi/lo (bfloat16: round it and pair it), and issue register-A
//   `wgmma` m64n256k8 TF32 -- a_lo.b_hi, a_hi.b_lo, a_hi.b_hi per k step --
//   (bfloat16: one m64n256k16 per k step) on one float32 accumulator through
//   all of K, then wait for them and release the stage;
// - the epilogue adds the bias to the accumulator fragment and keeps, per
//   row, a (max, lowest index) pair: per thread over its columns in
//   increasing order, then over the 4 lanes sharing the row (shuffles).
// The cluster's blocks meet through distributed shared memory: rank 0 reads
// every rank's pairs in rank order (columns in increasing order) and writes
// the int32 ids. Near-ties (a top-2 margin of a few 1e-6) may resolve
// differently from a float32 einsum, as between any two float32 orders.
//
// The bfloat16 instantiation (sopro_nar_heads_argmax_bf16) computes what the
// TPU kernel computes on bfloat16 inputs: zh = z + hid rounded to bfloat16,
// products accumulated in float32, the bias added in float32, on the
// bfloat16 tensor cores (exact products). Bound at the main path's shape by
// its products: 13.0 GFLOP / 989 TF/s = 0.013 ms.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBN = 256;  // columns per block: one wgmma N
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;

// NC consumer warpgroups of 64 rows, then the producer warpgroup (whose
// first lane issues the copies). With NC = 2 the producer gives its registers
// to the consumers (setmaxnreg: 24 and 240 a thread).
template <int NC, typename E>
struct Tile {
  static constexpr bool F32 = std::is_same<E, float>::value;
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int BK = 128 / (int)sizeof(E);  // K per chunk: one 128-byte row
  static constexpr int A_BYTES = BM * 128;         // the z tile
  static constexpr int B_BYTES = kBN * 128;        // one weight tile (hi, lo or bfloat16)
  static constexpr int STAGE = A_BYTES + (F32 ? 2 : 1) * B_BYTES;
  static constexpr int FIT = 221184 / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
};

struct Maps {
  CUtensorMap z, whi, wlo;
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <int NC, typename E>
size_t smem_bytes(int kp) {
  using T = Tile<NC, E>;
  const size_t kpad = (size_t)(kp + T::BK - 1) / T::BK * T::BK;
  return 1024 + (size_t)T::STAGES * T::STAGE + sizeof(float) * kpad + 8 * (size_t)T::BM +
         16 * (size_t)T::STAGES;
}

// E: float (the 3-pass kernel: whi / wlo the TF32 split) or __nv_bfloat16
// (one pass: whi the bfloat16 weights, wlo unused).
template <int NC, typename E>
__global__ void __launch_bounds__(Tile<NC, E>::THREADS, 1)
    nar_heads_kernel(const __grid_constant__ Maps maps, const E* __restrict__ hid,
                     const E* __restrict__ bias, int* __restrict__ ids, int rows, int H, int hd,
                     int kp, int V, int vp) {
  using T = Tile<NC, E>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const int nk = (kp + T::BK - 1) / T::BK;
  float* hidf = reinterpret_cast<float*>(ring + T::STAGES * T::STAGE);  // [nk * BK], zero past hd
  float* best_v = hidf + nk * T::BK;                                     // [BM], read by rank 0
  int* best_i = reinterpret_cast<int*>(best_v + T::BM);
  uint64_t* full = reinterpret_cast<uint64_t*>(best_i + T::BM);  // [STAGES]
  uint64_t* empty = full + T::STAGES;                            // [STAGES]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cn = (int)cluster.num_blocks();
  const int h = blockIdx.z, row0 = blockIdx.y * T::BM, n0 = rank * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * NC);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  for (int k = tid; k < nk * T::BK; k += T::THREADS)
    hidf[k] = k < hd ? tf32x3::ldg_f(hid + (size_t)h * hd + k) : 0.f;
  __syncthreads();

  if (warp >= 4 * NC) {  // the producer warpgroup
    if constexpr (NC == 2) hopper::regs_dec<24>();
    if (warp == 4 * NC && lane == 0) {
      for (int c = 0; c < nk; ++c) {
        const int s = c % T::STAGES;
        if (c >= T::STAGES) hopper::mbar_wait(&empty[s], (c / T::STAGES - 1) & 1);
        uint8_t* st = ring + s * T::STAGE;
        hopper::mbar_expect_tx(&full[s], T::STAGE);
        hopper::tma_load_2d(st, &maps.z, &full[s], c * T::BK, row0);
        hopper::tma_load_2d(st + T::A_BYTES, &maps.whi, &full[s], c * T::BK, h * vp + n0);
        if constexpr (T::F32)
          hopper::tma_load_2d(st + T::A_BYTES + T::B_BYTES, &maps.wlo, &full[s], c * T::BK, h * vp + n0);
      }
    }
    __syncwarp();
    cluster.sync();  // the consumers' two cluster barriers, met here without rejoining them
    cluster.sync();
    return;
  }
  {  // consumer warpgroup wg: tile rows 64 wg .. 64 wg + 63
    if constexpr (NC == 2) hopper::regs_inc<240>();
    const int g = lane >> 2, q = lane & 3;
    const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's rows r0 and r0 + 8
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int c = 0; c < nk; ++c) {
      const int s = c % T::STAGES;
      hopper::mbar_wait(&full[s], (c / T::STAGES) & 1);
      const uint8_t* st = ring + s * T::STAGE;
      const uint64_t dhi = hopper::desc_k128(st + T::A_BYTES);
      const float* hk = hidf + c * T::BK;
      if constexpr (T::F32) {
        const uint64_t dlo = hopper::desc_k128(st + T::A_BYTES + T::B_BYTES);
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // a_i: row r0 + 8 (i & 1), column 8 ks + q + 4 (i >> 1)
            const int r = r0 + 8 * (i & 1), k = ks * 8 + q + 4 * (i >> 1);
            const float v = *reinterpret_cast<const float*>(st + hopper::sw128(r, 4 * k)) + hk[k];
            float hi, lo;
            tf32x3::split(v, hi, lo);
            ahi[ks][i] = __float_as_uint(hi);
            alo[ks][i] = __float_as_uint(lo);
          }
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {  // the small terms first
          hopper::wgmma_tf32_n256(acc, alo[ks], dhi + 2 * ks, 1);
          hopper::wgmma_tf32_n256(acc, ahi[ks], dlo + 2 * ks, 1);
          hopper::wgmma_tf32_n256(acc, ahi[ks], dhi + 2 * ks, 1);
        }
      } else {
        uint32_t a[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {  // a_i: row r0 + 8 (i & 1), columns 16 ks + 2q (+ 8 (i >> 1)), +1
            const int r = r0 + 8 * (i & 1), k = ks * 16 + 2 * q + 8 * (i >> 1);
            const __nv_bfloat162 zz = *reinterpret_cast<const __nv_bfloat162*>(st + hopper::sw128(r, 2 * k));
            const __nv_bfloat162 zh = __floats2bfloat162_rn(__low2float(zz) + hk[k], __high2float(zz) + hk[k + 1]);
            a[ks][i] = *reinterpret_cast<const uint32_t*>(&zh);
          }
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) hopper::wgmma_bf16_n256(acc, a[ks], dhi + 2 * ks, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // bias, then per row the best (value, lowest column): this thread's columns increasing
    float bv[2] = {-INFINITY, -INFINITY};
    int bi[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * q + e;
        if (col < V) {
          const float bcol = tf32x3::ldg_f(bias + (size_t)h * V + col);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float l = acc[4 * j + 2 * hh + e] + bcol;
            if (better(l, col, bv[hh], bi[hh])) {
              bv[hh] = l;
              bi[hh] = col;
            }
          }
        }
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv[hh], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi[hh], off);
        if (better(ov, oi, bv[hh], bi[hh])) {
          bv[hh] = ov;
          bi[hh] = oi;
        }
      }
      if (q == 0) {
        best_v[r0 + 8 * hh] = bv[hh];
        best_i[r0 + 8 * hh] = bi[hh];
      }
    }
  }
  cluster.sync();  // every rank's pairs visible to rank 0
  if (rank == 0 && tid < T::BM && row0 + tid < rows) {
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

template <int NC, typename E>
int launch(const E* z, const E* hid, const E* whi, const E* wlo, const E* bias, int* out, int rows,
           int H, int hd, int kp, int V, int vp, cudaStream_t s) {
  using T = Tile<NC, E>;
  constexpr bool bf16 = !T::F32;
  const size_t smem = smem_bytes<NC, E>(kp);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Maps maps;
  const uint64_t zd[2] = {(uint64_t)hd, (uint64_t)rows}, zs[1] = {(uint64_t)hd * sizeof(E)};
  const uint64_t wd[2] = {(uint64_t)kp, (uint64_t)H * vp}, ws[1] = {(uint64_t)kp * sizeof(E)};
  const uint32_t zb[2] = {(uint32_t)T::BK, (uint32_t)T::BM}, wb[2] = {(uint32_t)T::BK, (uint32_t)kBN};
  cudaError_t e = hopper::make_map(&maps.z, bf16, 2, z, zd, zs, zb);
  if (e == cudaSuccess) e = hopper::make_map(&maps.whi, bf16, 2, whi, wd, ws, wb);
  if (e == cudaSuccess) e = hopper::make_map(&maps.wlo, bf16, 2, T::F32 ? wlo : whi, wd, ws, wb);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(nar_heads_kernel<NC, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int cn = vp / kBN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cn, (rows + T::BM - 1) / T::BM, H);  // heads slowest: a head's slice stays in L2
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cn;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nar_heads_kernel<NC, E>, maps, hid, bias, out, rows, H, hd, kp, V, vp);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The row tile the launch takes (64 or 128 rows): fewest waves of (row tiles
// x H x CN) blocks at one block per SM, weighted by the tile's rows plus a
// fixed cost for streaming the block's weight slice.
int row_tile(int rows, int H, int V) {
  const long long cn = (V + kBN - 1) / kBN;
  int best = 64;
  long long best_cost = -1;
  for (int bm : {64, 128}) {
    const long long blocks = (rows + bm - 1) / bm * (long long)H * cn;
    const long long cost = (blocks + 131) / 132 * (bm + 64);
    if (best_cost < 0 || cost <= best_cost) {
      best = bm;
      best_cost = cost;
    }
  }
  return best;
}

template <typename E>
int dispatch(const E* z, const E* hid, const E* whi, const E* wlo, const E* bias, int* out, int rows,
             int H, int hd, int kp, int V, int vp, void* stream) {
  if (rows <= 0 || H <= 0 || hd <= 0 || V <= 0 || H > 65535 || kp < hd || kp % 16 != 0 ||
      vp != kBN * ((V + kBN - 1) / kBN) || vp / kBN > kMaxCluster || (long long)H * vp > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int bm = row_tile(rows, H, V);
  if ((rows + bm - 1) / bm > 65535) return (int)cudaErrorInvalidValue;
  if (bm == 64) return launch<1, E>(z, hid, whi, wlo, bias, out, rows, H, hd, kp, V, vp, s);
  return launch<2, E>(z, hid, whi, wlo, bias, out, rows, H, hd, kp, V, vp, s);
}

}  // namespace

// z [rows, hd], hid [H, hd], bias [H, V] float32; whi / wlo [H, vp, kp]
// (pack_nar_heads: the TF32 hi / lo split of W [H, hd, V], K-major, zero-padded
// to kp = hd rounded up to 16 and vp = 256 * ceil(V / 256)); out [rows, H]
// int32. All contiguous; z's rows 16-byte aligned (hd a multiple of 4).
// Returns cudaGetLastError() after the launch.
extern "C" int sopro_nar_heads_argmax(const float* z, const float* hid, const float* whi,
                                      const float* wlo, const float* bias, int* out, int rows,
                                      int H, int hd, int kp, int V, int vp, void* stream) {
  return dispatch<float>(z, hid, whi, wlo, bias, out, rows, H, hd, kp, V, vp, stream);
}

// The bfloat16 instantiation: z, hid, bias and w [H, vp, kp] (pack_nar_heads
// of a bfloat16 stack, K-major and zero-padded as above) bfloat16 (hd a
// multiple of 8); out [rows, H] int32.
extern "C" int sopro_nar_heads_argmax_bf16(const __nv_bfloat16* z, const __nv_bfloat16* hid,
                                           const __nv_bfloat16* w, const __nv_bfloat16* bias,
                                           int* out, int rows, int H, int hd, int kp, int V,
                                           int vp, void* stream) {
  if (w == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<__nv_bfloat16>(z, hid, w, nullptr, bias, out, rows, H, hd, kp, V, vp, stream);
}
