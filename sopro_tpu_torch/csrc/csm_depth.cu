// Kernel K6: one frame of CSM's depth decoder in one launch, float32.
//
// Replaces no TPU kernel: CSM runs on the port alone (sopro_tpu/ has no
// CSM). It takes the place of the chain of library kernels that
// `ops/csm_depth.py::depth_plain` runs for a frame (~72 a pass: RMSNorm,
// cuBLAS GEMVs, RoPE, cache writes, SDPA over <= 33 positions, SiLU, the
// head GEMV, the top-k sample). From the backbone's last hidden state h
// [D] and codebook 0's code, the launch runs the frame's Q - 1 passes:
// pass p projects its inputs from the backbone's width (pass 1: h and
// codebook 0's embedding at positions 0 and 1; pass p > 1: codebook p - 1's
// embedding at position p), runs the L decoder layers over the depth
// cache, the final norm and codebook p's head on the last position, and
// samples codebook p's code as `sampling.sample_topk` does: nan_to_num, an
// IEEE division by the temperature, every logit at or above the exact k-th
// largest (a radix select on the ordered float bits), the argmax of x + the
// frame's Gumbel noise with the lowest id on a tie. With forced codes the
// passes take those codes as their inputs (teacher forcing) and the logits
// can be written out [Q - 1, V].
//
// What bounds it on the H100: every pass reads the depth weights once, 461
// MB at CSM-1B's widths (4 layers of qkv 6 MB, o 4 MB, gate/up 64 MB, down
// 32 MB; the projector 8 MB; one head slice 8 MB), 14.3 GB a frame: 4.27 ms
// at 3.35 TB/s. Its 7 GFLOP take ~0.1 ms on the CUDA cores, so the kernel is
// bandwidth-bound while the weight stream runs. But the passes are a chain
// of dependent phases (18 a pass: the projector, each layer's qkv,
// attention + o, gate/up, down, and the head, each needing the whole
// previous output), and each phase boundary costs a grid barrier and the
// next phase's input, each an L2 round trip of ~1.4 us under the stream's
// load: 558 boundaries a frame.
//
// Design (the persistent shape of hopper-kernels' guide, as K1):
//   * One block per SM, launched cooperatively so every block is resident.
//     Every phase's weight rows are split over all blocks (a rotation per
//     phase spreads the remainder rows, so no block reads more than ~1 %
//     over the mean a pass). A block's rows of a phase are contiguous in the
//     weight's own [out, in] layout, the heads' in [Q - 1, V, d], the rows
//     the model holds them in (`models/csm.py`).
//   * A producer warp streams the block's rows, 32 KB at a time by 1-D bulk
//     copies (cp.async.bulk, L2 evict-first), into a ring of kRing slots
//     with a full and an empty mbarrier each. The weights do not depend on
//     the activations, so the producer walks the whole frame's schedule and
//     runs ahead across the grid barriers: the ring fills while the grid
//     waits. It keeps one slot in flight: more bytes queued at HBM lengthen
//     every L2 round trip on the consumers' path more than they add rate.
//   * 16 consumer warps take each slot in units of one row, or of a 512-float
//     segment of a longer row: float32 FMAs on the CUDA cores against the
//     phase's input vector (one position, or two in pass 1, against one
//     read of the weights) in shared memory. The warp that finishes an
//     output's last unit sums its partials in a fixed order and writes it:
//     the residual added (o, down), SiLU(gate) * up (a block owns gate row
//     j with up row F + j), or the logits.
//   * Phases meet through a small exchange in global memory (L2): each block
//     writes its rows, arrives on one 64-bit counter (atom.acq_rel.gpu) and
//     waits for every block (ld.acquire.gpu, bounded: a wait of seconds
//     traps; the block that arrives last sees so in the count it added to).
//     The counter and the exchange are scratch from the caller's caching
//     allocator on the launch's stream, the counter zeroed on that stream.
//   * What every block needs whole is recomputed in every block, which
//     spends no barrier: the RMSNorms (from the 1,024-float residual),
//     RoPE and attention over the <= 33 cached positions (the layer's keys
//     and values copied into shared memory under the qkv phase; block 0
//     writes the new positions' keys and values into the depth cache), and
//     the sampler over the V logits (the frame's noise prefetched into L2
//     at launch). Every block draws the same code.
//   * Reductions run in a fixed order and the only atomics count integers,
//     so a frame's logits and codes repeat bit for bit.
//   * The ring's bulk copies, the grid barrier's two halves and the sampler
//     are `csm_stream.cuh`'s, shared with K7 (csm_backbone.cu).
//
// On an H100 (700 W) a frame at CSM-1B's widths takes 7.6-7.9 ms, 54-56 %
// of the 4.27 ms bound (the library chain replayed as a CUDA graph: 11.5-12.6
// ms); PERF.md, K6, has the phases' times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "csm_stream.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 16;                 // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStage = 8192;               // floats a ring slot (32 KB)
constexpr int kRing = 4;
constexpr int kInflight = 1;               // slots in flight from HBM at a time (of the ring's kRing)
constexpr int kSeg = 512;                  // floats of a row a unit takes, for rows longer than it
constexpr int kResv = 128;                 // residual values a block adds to in a phase (2 ceil(d / G))
constexpr int kMaxLayers = 8;
constexpr int kMaxPos = 64;
constexpr int kNormPer = 8;                // residual values a lane normalises: d <= kWarps / 2 * 32 kNormPer
constexpr int kVPer = 8;                   // logits a thread samples: V <= kVPer kConsumers
constexpr int kMinGrid = 32;               // so a block's residual rows of a phase (2 ceil(d / G)) fit kResv
constexpr int kRot = 41;                   // the row split's rotation from one phase to the next
constexpr int kBarrier = 1;                // the consumers' named barrier
constexpr size_t kMaxSmem = 232448;
constexpr unsigned long long kSpinNs = 4000000000ull;  // a grid barrier waiting longer traps

enum Kind { PROJ, QKV, ATTN_O, GATE_UP, DOWN, HEAD };

}  // namespace

// Built with -DSOPRO_CSM_CLOCKS (bench_csm.py --clocks), thread 0 of every
// block adds clock64() cycles into g_csm_clk: [4 kind + part] for the phase
// kinds and the sampler (kind 6), part 0 the phase's input, 1 the waits for
// a landed slot, 2 the rest of its products and epilogue, 3 the grid
// barrier (the sampler's: 0 its logits, 1 the radix rounds, 2 the argmax);
// [28] the producer's waits for a free slot, [29] the launch, [30] the
// barrier waits of the block that arrived last, [31] their number; the
// attention's input [32..35]: its wait for the prefetched cache, its q/k/v
// and RoPE, the barrier after, its scores and values.
// sopro_csm_depth_clocks reads and zeroes them.
#ifdef SOPRO_CSM_CLOCKS
__device__ unsigned long long g_csm_clk[40];
__shared__ unsigned long long csm_clk[40];
#define CSM_CLK(x) x
#define CSM_ADD(i, t0) do { if (threadIdx.x == 0) csm_clk[i] += clock64() - (t0); } while (0)
#define CSM_SAMPLER_CLK (csm_clk + 4 * 6)
constexpr bool kClocks = true;
extern "C" int sopro_csm_depth_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_csm_clk, sizeof(g_csm_clk));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zeros[40] = {0};
  return (int)cudaMemcpyToSymbol(g_csm_clk, zeros, sizeof(zeros));
}
#else
#define CSM_CLK(x)
#define CSM_ADD(i, t0)
#define CSM_SAMPLER_CLK nullptr
constexpr bool kClocks = false;
#endif

// Mirrored field for field by `_Args` in ops/csm_depth.py. Every weight and
// table is float32 and contiguous, 16-byte aligned.
struct CsmDepthArgs {
  int D, d, F, H, KVH, hd, L, V, Q, P;  // P: the cache's positions
  int top_k;
  float eps, temperature;
  const float* proj;         // [d, D]
  const float* norm;         // [d]
  const float* heads;        // [Q - 1, V, d]
  const float* audio_embed;  // [Q V, D]
  const float* cos;          // [P, hd]
  const float* sin;          // [P, hd]
  float* cache_k;            // [L, KVH, P, hd]
  float* cache_v;
  const float* ln1[kMaxLayers];      // [d]
  const float* ln2[kMaxLayers];      // [d]
  const float* qkv[kMaxLayers];      // [(H + 2 KVH) hd, d]
  const float* o[kMaxLayers];        // [d, H hd]
  const float* gate_up[kMaxLayers];  // [2 F, d]
  const float* down[kMaxLayers];     // [d, F]
  const float* h;            // [D]: the backbone's last hidden state
  const long long* c0;       // [1]: codebook 0's code
  const float* noise;        // [Q, V] Gumbel noise, or null (forced codes, no sampling)
  const long long* forced;   // [Q - 1] codes fed to passes 2.., or null
  long long* codes;          // [Q] out: c0, then each pass's pick (its forced code without noise)
  float* logits;             // [Q - 1, V] out, or null
  float* work;               // scratch (`work_floats`): the counter, then the exchange
};

namespace {

__host__ __device__ inline int qkv_width(const CsmDepthArgs& a) { return (a.H + 2 * a.KVH) * a.hd; }

// Offsets (floats) in the activation area while the attention runs: the
// output a [2][H hd] first (the o product's input), then the current
// positions' q, k, v [2][qkv], the layer's keys [KVH][Q][hd + 4] (a row
// padded by 16 bytes, so that lanes reading a key each hit other banks) and
// values [KVH][Q][hd], and a score row per warp.
struct AttnLayout {
  int q, k, v, sc, end;
};

__host__ __device__ inline AttnLayout attn_layout(const CsmDepthArgs& a) {
  AttnLayout x;
  x.q = 2 * a.H * a.hd;
  x.k = x.q + 2 * qkv_width(a);
  x.v = x.k + a.KVH * a.Q * (a.hd + 4);
  x.sc = x.v + a.KVH * a.Q * a.hd;
  x.end = x.sc + kWarps * kMaxPos;
  return x;
}

__host__ __device__ inline int imax(int x, int y) { return x > y ? x : y; }

// Floats of the activation area: the largest phase input (two positions of
// the projector's, the gate/up's and the down product's inputs) or the
// attention's layout.
__host__ __device__ inline int xs_floats(const CsmDepthArgs& a) {
  const int n = imax(imax(2 * a.D, 2 * a.F), attn_layout(a).end);
  return (n + 3) & ~3;
}

// Units a slot holds at most: rows of K <= kSeg floats, or kSeg-float
// segments of longer rows (a multiple of 4, for alignment).
__host__ __device__ inline int units_of(int K) { return K <= kSeg ? kStage / K : kStage / kSeg; }

__host__ __device__ inline int max_units(const CsmDepthArgs& a) {
  const int u = imax(imax(units_of(a.D), units_of(a.d)), imax(units_of(a.F), units_of(a.H * a.hd)));
  return (u + 3) & ~3;
}

// Shared memory: the ring, the activation area, per ring slot its unit
// partials (two positions each) and its rows' finished-unit counts, the
// residual values of the block's rows, reduction slots, the sampler's four
// histograms, the mbarriers.
__host__ __device__ inline size_t smem_bytes(const CsmDepthArgs& a) {
  const size_t um = max_units(a);
  return 4 * ((size_t)kRing * kStage + xs_floats(a) + kRing * 3 * um + kResv + 64 + 1024) + 16 * kRing;
}

struct Smem {
  float *ring, *xs, *part, *resv, *red;
  int *done, *hist;
  uint64_t *full, *empty;
};

__device__ inline Smem carve(const CsmDepthArgs& a, unsigned char* base) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  s.ring = f;
  s.xs = s.ring + (size_t)kRing * kStage;
  const int um = max_units(a);
  s.part = s.xs + xs_floats(a);
  s.done = reinterpret_cast<int*>(s.part + kRing * 2 * um);
  s.resv = reinterpret_cast<float*>(s.done + kRing * um);
  s.red = s.resv + kResv;
  s.hist = reinterpret_cast<int*>(s.red + 64);
  s.full = reinterpret_cast<uint64_t*>(s.hist + 1024);
  s.empty = s.full + kRing;
  return s;
}

// ---- the schedule: phases of a pass, and a block's rows of each ----------------

__host__ __device__ inline int split(int n, int G, int j) { return (int)(((long long)n * j) / G); }

struct Phase {
  const float* w;  // the phase's weight, [rows, K]
  int K, r0, n;    // row length; this block's first row and row count
  int kind, layer;
  size_t pair;     // gate/up: floats from gate row j to up row F + j; else 0
};

__device__ inline Phase phase(const CsmDepthArgs& a, int p, int ph, int G, int j) {
  const int nph = 2 + 4 * a.L;
  Phase f;
  f.layer = 0;
  f.pair = 0;
  int rows;
  if (ph == 0) {
    f.kind = PROJ, f.w = a.proj, f.K = a.D, rows = a.d;
  } else if (ph == nph - 1) {
    f.kind = HEAD, f.w = a.heads + (size_t)(p - 1) * a.V * a.d, f.K = a.d, rows = a.V;
  } else {
    const int l = (ph - 1) / 4;
    f.layer = l;
    switch ((ph - 1) % 4) {
      case 0: f.kind = QKV, f.w = a.qkv[l], f.K = a.d, rows = qkv_width(a); break;
      case 1: f.kind = ATTN_O, f.w = a.o[l], f.K = a.H * a.hd, rows = a.d; break;
      case 2:
        f.kind = GATE_UP, f.w = a.gate_up[l], f.K = a.d, rows = a.F;
        f.pair = (size_t)a.F * a.d;
        break;
      default: f.kind = DOWN, f.w = a.down[l], f.K = a.F, rows = a.d; break;
    }
  }
  const int jj = (int)((j + (long long)ph * kRot) % G);
  f.r0 = split(rows, G, jj);
  f.n = split(rows, G, jj + 1) - f.r0;
  return f;
}

// Rows a slot holds (gate/up: pairs of rows).
__device__ inline int slot_rows(const Phase& f) { return kStage / (f.K * (f.pair ? 2 : 1)); }

// ---- small helpers ---------------------------------------------------------------

__device__ __forceinline__ void cbar() { hopper::named_sync(kBarrier, kConsumers); }

__device__ __forceinline__ void l2_prefetch(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

// Every consumer thread: this block's writes of the phase are done; wait
// until every block's are (the `n`-th barrier of the launch). Thread 0
// arrives and polls; the block that arrives last sees so in the count it
// added to, and does not poll.
__device__ __forceinline__ void grid_sync(unsigned long long* ctr, unsigned long long n) {
  cbar();  // the release below is cumulative over the block's writes ordered by this barrier
  if (threadIdx.x == 0) {
    CSM_CLK(const long long c0 = clock64();)
    const unsigned long long target = n * gridDim.x;
    const unsigned long long v = csm::grid_arrive(ctr);
    CSM_CLK(if (v + 1 == target) { csm_clk[30] += clock64() - c0; csm_clk[31] += 1; })
    csm::grid_wait(ctr, target, v, kSpinNs);
  }
  cbar();
}

// ---- the producer --------------------------------------------------------------

// Lane 0 of the producer warp: the block's rows of every phase of the frame,
// in the consumers' order, slot after slot. A slot is issued once the
// consumers have released it and the slot kInflight before it has landed:
// the ring holds kRing slots for a grid barrier to fill, but no more than
// kInflight of them a block queue at HBM and in L2, where every load on the
// consumers' path (the exchange, the cache, the barrier's counter) waits
// behind them (one slot in flight measured best: PERF.md, K6).
__device__ void produce(const CsmDepthArgs& a, const Smem& s, int G, int j) {
  const int nph = 2 + 4 * a.L;
  const uint64_t pol = csm::evict_first();
  uint32_t k = 0;  // slot uses so far
  for (int p = 1; p < a.Q; ++p)
    for (int ph = 0; ph < nph; ++ph) {
      const Phase f = phase(a, p, ph, G, j);
      const int R = slot_rows(f);
      for (int c = 0; c < f.n; c += R, ++k) {
        const int slot = k % kRing;
        CSM_CLK(const long long t0 = clock64();)
        if (k >= kRing) hopper::mbar_wait(&s.empty[slot], ((k / kRing) - 1) & 1);
        if (k >= kInflight) hopper::mbar_wait(&s.full[(k - kInflight) % kRing], ((k - kInflight) / kRing) & 1);
        CSM_CLK(csm_clk[28] += clock64() - t0;)
        const int nr = min(R, f.n - c);
        const uint32_t bytes = (uint32_t)nr * f.K * 4;
        float* dst = s.ring + (size_t)slot * kStage;
        const float* src = f.w + (size_t)(f.r0 + c) * f.K;
        hopper::mbar_expect_tx(&s.full[slot], f.pair ? 2 * bytes : bytes);
        csm::bulk_load(dst, src, bytes, &s.full[slot], pol);
        if (f.pair) csm::bulk_load(dst + (size_t)nr * f.K, src + f.pair, bytes, &s.full[slot], pol);
      }
    }
}

// ---- the consumers: phase inputs ------------------------------------------------

// xs[m][i] = RMSNorm(res row r0 + m)[i] * w[i] for m < nrows (eps as the
// config says). kWarps / nrows warps take a row, each a slice of it in
// registers; a row's sum of squares is its slices' in warp order, which every
// thread adds up itself. One consumer barrier.
__device__ void rms_rows(const float* res, int r0, int nrows, int d, const float* __restrict__ w, float eps,
                         const Smem& s) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = kWarps / nrows, m = min(warp / per, nrows - 1), part = warp - m * per;
  const int w0 = part < per ? split(d, per, part) : 0, w1 = part < per ? split(d, per, part + 1) : 0;
  const float* src = res + (size_t)(r0 + m) * d;
  float v[kNormPer];
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kNormPer; ++u) {
    const int i = w0 + lane + 32 * u;
    v[u] = i < w1 ? __ldcg(src + i) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kNormPer; ++u) ss = fmaf(v[u], v[u], ss);
  ss = csm::warp_sum(ss);
  if (lane == 0 && part < per) s.red[m * per + part] = ss;
  cbar();
  float t = 0.f;
  for (int q = 0; q < per; ++q) t += s.red[m * per + q];
  const float rs = rsqrtf(t / (float)d + eps);
#pragma unroll
  for (int u = 0; u < kNormPer; ++u) {
    const int i = w0 + lane + 32 * u;
    if (i < w1) s.xs[m * d + i] = v[u] * rs * __ldg(w + i);
  }
}

// The layer's cached keys and values of positions < pos0 (written in earlier
// passes) into ks, vs [KVH][Q][hd], asynchronously: issued with the qkv
// phase's input, waited for in the attention's.
__device__ void prefetch_kv(const CsmDepthArgs& a, const Smem& s, int l, int pos0) {
  const AttnLayout X = attn_layout(a);
  const int n4 = pos0 * a.hd / 4;
  for (int i = threadIdx.x; i < a.KVH * n4; i += kConsumers) {
    const int g = i / n4, r = i - g * n4;
    const int t = r / (a.hd / 4), col = 4 * r - t * a.hd;
    const size_t at = (((size_t)l * a.KVH + g) * a.P) * a.hd / 4 + r;
    csm::cp_async16(s.xs + X.k + ((size_t)g * a.Q + t) * (a.hd + 4) + col,
               reinterpret_cast<const float4*>(a.cache_k) + at);
    csm::cp_async16(s.xs + X.v + (size_t)g * a.Q * a.hd + 4 * r, reinterpret_cast<const float4*>(a.cache_v) + at);
  }
}

// The attention of layer l for the M positions pos0.. into xs[m][H hd]: the
// current q, k, v from the exchange, RoPE on q and k, beside the cached keys
// and values of positions < pos0 (`prefetch_kv`), then per (position, head)
// one warp: scores (8 lanes a key), softmax, the weighted values. Block 0
// writes the current keys and values into the cache.
__device__ void attention(const CsmDepthArgs& a, const Smem& s, const float* qg, int l, int M, int pos0,
                          bool writer) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = a.hd, hf = hd / 2, qw = qkv_width(a), nh = a.H + a.KVH;
  const AttnLayout X = attn_layout(a);
  float* xq = s.xs + X.q;
  float* ks = s.xs + X.k;
  float* vs = s.xs + X.v;
  CSM_CLK(long long ta = clock64();)
  csm::cp_async_wait();
  CSM_CLK(if (tid == 0) csm_clk[32] += clock64() - ta; ta = clock64();)
  // RoPE (rotate-half) pairs of the q and k heads, then the v values
  const int npair = M * nh * hf, nv = M * a.KVH * hd;
  for (int i = tid; i < npair + nv; i += kConsumers) {
    if (i < npair) {
      const int m = i / (nh * hf), r = i - m * nh * hf, hh = r / hf, c = r - hh * hf;
      const float* x = qg + (size_t)m * qw + hh * hd;
      const float* cs = a.cos + (size_t)(pos0 + m) * hd;
      const float* sn = a.sin + (size_t)(pos0 + m) * hd;
      const float x1 = __ldcg(x + c), x2 = __ldcg(x + c + hf);
      const float y1 = x1 * __ldg(cs + c) - x2 * __ldg(sn + c);
      const float y2 = x2 * __ldg(cs + c + hf) + x1 * __ldg(sn + c + hf);
      if (hh < a.H) {
        xq[m * qw + hh * hd + c] = y1;
        xq[m * qw + hh * hd + c + hf] = y2;
      } else {
        const int g = hh - a.H;
        float* kr = ks + ((size_t)g * a.Q + pos0 + m) * (hd + 4);
        kr[c] = y1;
        kr[c + hf] = y2;
        if (writer) {
          float* kc = a.cache_k + (((size_t)l * a.KVH + g) * a.P + pos0 + m) * hd;
          kc[c] = y1;
          kc[c + hf] = y2;
        }
      }
    } else {
      const int j = i - npair, m = j / (a.KVH * hd), r = j - m * a.KVH * hd, g = r / hd, c = r - g * hd;
      const float vv = __ldcg(qg + (size_t)m * qw + (a.H + a.KVH + g) * hd + c);
      vs[((size_t)g * a.Q + pos0 + m) * hd + c] = vv;
      if (writer) a.cache_v[(((size_t)l * a.KVH + g) * a.P + pos0 + m) * hd + c] = vv;
    }
  }
  CSM_CLK(if (tid == 0) csm_clk[33] += clock64() - ta; ta = clock64();)
  cbar();
  CSM_CLK(if (tid == 0) csm_clk[34] += clock64() - ta; ta = clock64();)
  const float scale = 1.0f / sqrtf((float)hd);
  const int group = a.H / a.KVH, hdp = hd + 4;
  float* sc = s.xs + X.sc + warp * kMaxPos;
  for (int pr = warp; pr < M * a.H; pr += kWarps) {
    const int m = pr / a.H, hh = pr - m * a.H, g = hh / group, n = pos0 + m + 1;
    const float* q = xq + m * qw + hh * hd;
    const float* kb = ks + (size_t)g * a.Q * hdp;
    const float* vb = vs + (size_t)g * a.Q * hd;
    float e0 = -INFINITY, e1 = -INFINITY;  // the scores of keys lane and lane + 32
    for (int t = lane; t < n; t += 32) {
      const float* kr = kb + (size_t)t * hdp;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c = 0; c < hd; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
        const float4 qv = *reinterpret_cast<const float4*>(q + c);
        acc.x = fmaf(qv.x, kv.x, acc.x);
        acc.y = fmaf(qv.y, kv.y, acc.y);
        acc.z = fmaf(qv.z, kv.z, acc.z);
        acc.w = fmaf(qv.w, kv.w, acc.w);
      }
      const float sv = ((acc.x + acc.y) + (acc.z + acc.w)) * scale;
      if (t < 32) e0 = sv;
      else e1 = sv;
    }
    const float mx = csm::warp_max(fmaxf(e0, e1));
    e0 = lane < n ? expf(e0 - mx) : 0.f;
    e1 = lane + 32 < n ? expf(e1 - mx) : 0.f;
    if (lane < n) sc[lane] = e0;
    if (lane + 32 < n) sc[lane + 32] = e1;
    const float inv = 1.0f / csm::warp_sum(e0 + e1);
    __syncwarp();
    for (int c = 4 * lane; c < hd; c += 128) {
      float4 acc[4];  // keys t = 4 i + q into acc[q], summed in q order
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t0 = 0; t0 < n; t0 += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = t0 + q;
          if (t < n) {
            const float pt = sc[t];
            const float4 vv = *reinterpret_cast<const float4*>(vb + (size_t)t * hd + c);
            acc[q].x = fmaf(pt, vv.x, acc[q].x);
            acc[q].y = fmaf(pt, vv.y, acc[q].y);
            acc[q].z = fmaf(pt, vv.z, acc[q].z);
            acc[q].w = fmaf(pt, vv.w, acc[q].w);
          }
        }
      }
      const float ox = (acc[0].x + acc[1].x) + (acc[2].x + acc[3].x);
      const float oy = (acc[0].y + acc[1].y) + (acc[2].y + acc[3].y);
      const float oz = (acc[0].z + acc[1].z) + (acc[2].z + acc[3].z);
      const float ow = (acc[0].w + acc[1].w) + (acc[2].w + acc[3].w);
      *reinterpret_cast<float4*>(s.xs + (size_t)m * a.H * hd + hh * hd + c) =
          make_float4(ox * inv, oy * inv, oz * inv, ow * inv);
    }
    __syncwarp();
  }
  CSM_CLK(if (tid == 0) csm_clk[35] += clock64() - ta;)
}

// ---- the consumers: a phase's slots ---------------------------------------------

// Output i of a slot holding the block's rows c.. of phase f, position m:
// its units' partials summed in order, and the phase's epilogue into the
// exchange (or the logits output).
__device__ void finish(const CsmDepthArgs& a, const Smem& s, const Phase& f, const float* part, int i, int m,
                       int c, int nr, int segs, int p, float* res, float* qg, float* act, float* lg) {
  const int row = f.r0 + c + i;
  float v = part[2 * (i * segs) + m];
  for (int sg = 1; sg < segs; ++sg) v += part[2 * (i * segs + sg) + m];
  switch (f.kind) {
    case PROJ: res[(size_t)m * a.d + row] = v; break;
    case QKV: qg[(size_t)m * qkv_width(a) + row] = v; break;
    case ATTN_O:
    case DOWN: res[(size_t)m * a.d + row] = s.resv[m * f.n + c + i] + v; break;
    case GATE_UP: {
      float up = part[2 * ((nr + i) * segs) + m];
      for (int sg = 1; sg < segs; ++sg) up += part[2 * ((nr + i) * segs + sg) + m];
      act[(size_t)m * a.F + row] = v / (1.0f + expf(-v)) * up;
      break;
    }
    default:
      lg[row] = v;
      if (a.logits != nullptr) a.logits[(size_t)(p - 1) * a.V + row] = v;
      break;
  }
}

// Every consumer warp: the block's rows of phase f against xs [Mx][K], slot
// by slot, each warp at its own pace (the ring keeps them within kRing
// slots of each other). A unit's partials go to the slot's part; the warp
// that finishes an output's last unit adds them up and writes it (`finish`).
// `k` counts slot uses over the launch.
__device__ void run_rows(const CsmDepthArgs& a, const Smem& s, const Phase& f, int Mx, int p, uint32_t& k,
                         float* res, float* qg, float* act, float* lg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = slot_rows(f), segs = f.K > kSeg ? f.K / kSeg : 1, seg = f.K > kSeg ? kSeg : f.K;
  const int mult = f.pair ? 2 : 1, um = max_units(a);
  for (int c = 0; c < f.n; c += R, ++k) {
    const int slot = k % kRing, nr = min(R, f.n - c), units = nr * mult * segs;
    float* part = s.part + slot * 2 * um;
    int* done = s.done + slot * um;
    CSM_CLK(const long long t0 = clock64();)
    hopper::mbar_wait(&s.full[slot], (k / kRing) & 1);
    CSM_ADD(4 * f.kind + 1, t0);
    const float* wt = s.ring + (size_t)slot * kStage;
    for (int u = warp; u < units; u += kWarps) {
      const int r = u / segs, sg = u - r * segs;
      const float4* w4 = reinterpret_cast<const float4*>(wt + (size_t)r * f.K + sg * seg);
      const float4* x0 = reinterpret_cast<const float4*>(s.xs + sg * seg);
      const float4* x1 = reinterpret_cast<const float4*>(s.xs + f.K + sg * seg);
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
#pragma unroll 4
      for (int q = lane; q < seg / 4; q += 32) {
        const float4 wv = w4[q];
        const float4 xv = x0[q];
        a0.x = fmaf(wv.x, xv.x, a0.x);
        a0.y = fmaf(wv.y, xv.y, a0.y);
        a0.z = fmaf(wv.z, xv.z, a0.z);
        a0.w = fmaf(wv.w, xv.w, a0.w);
        if (Mx == 2) {
          const float4 yv = x1[q];
          a1.x = fmaf(wv.x, yv.x, a1.x);
          a1.y = fmaf(wv.y, yv.y, a1.y);
          a1.z = fmaf(wv.z, yv.z, a1.z);
          a1.w = fmaf(wv.w, yv.w, a1.w);
        }
      }
      const float v0 = csm::warp_sum((a0.x + a0.y) + (a0.z + a0.w));
      const float v1 = Mx == 2 ? csm::warp_sum((a1.x + a1.y) + (a1.z + a1.w)) : 0.f;
      const int out = r < nr ? r : r - nr;  // gate/up: gate row i and up row nr + i make output i
      int last = 0;
      if (lane == 0) {
        part[2 * u] = v0;
        part[2 * u + 1] = v1;
        __threadfence_block();
        last = atomicAdd(&done[out], 1) == mult * segs - 1;
      }
      if (__shfl_sync(0xffffffffu, last, 0)) {
        __threadfence_block();
        if (lane < Mx) finish(a, s, f, part, out, lane, c, nr, segs, p, res, qg, act, lg);
        if (lane == 0) done[out] = 0;
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&s.empty[slot]);  // the slot's last read by this warp
  }
}

// Every consumer thread: codebook p's pick from the exchange's logits, as
// `sampling.sample_topk` (module comment; `csm::sample_topk`). Every block
// computes the same.
__device__ long long sample(const CsmDepthArgs& a, const Smem& s, const float* lg, int p) {
  return csm::sample_topk<kConsumers, kVPer, kWarps, kBarrier, kClocks>(
      lg, a.noise + (size_t)p * a.V, a.V, a.temperature, a.top_k, s.hist, s.red, CSM_SAMPLER_CLK);
}

// The residual values the block's rows of phase f add to, [M][f.n].
__device__ void load_resv(const CsmDepthArgs& a, const Smem& s, const Phase& f, int M, const float* res) {
  for (int i = threadIdx.x; i < M * f.n; i += kConsumers) {
    const int m = i / f.n;
    s.resv[i] = __ldcg(res + (size_t)m * a.d + f.r0 + (i - m * f.n));
  }
}

__device__ void consume(const CsmDepthArgs& a, const Smem& s, int G, int j) {
  const int tid = threadIdx.x, nph = 2 + 4 * a.L, qw = qkv_width(a);
  unsigned long long* ctr = reinterpret_cast<unsigned long long*>(a.work);
  float* res = a.work + 4;          // the residual [2][d]
  float* qg = res + 2 * a.d;        // q, k, v [2][qkv]
  float* act = qg + 2 * qw;         // SiLU(gate) * up [2][F]
  float* lg = act + 2 * a.F;        // the logits [V]
  unsigned long long bars = 0;
  uint32_t k = 0;
  long long code = *a.c0;
  if (j == 0 && tid == 0) a.codes[0] = code;
  for (int p = 1; p < a.Q; ++p) {
    const int M = p == 1 ? 2 : 1, pos0 = p == 1 ? 0 : p;
    for (int ph = 0; ph < nph; ++ph) {
      const Phase f = phase(a, p, ph, G, j);
      CSM_CLK(const long long t0 = clock64();)
      int Mx = M;
      switch (f.kind) {
        case PROJ: {
          const float* rows[2] = {a.h, a.h};
          rows[M - 1] = a.audio_embed + ((size_t)(p - 1) * a.V + (size_t)code) * a.D;
          float4* x4 = reinterpret_cast<float4*>(s.xs);
          const int n4 = a.D / 4;
          for (int i = tid; i < M * n4; i += kConsumers) {
            const int m = i / n4;
            x4[i] = __ldg(reinterpret_cast<const float4*>(rows[m]) + (i - m * n4));
          }
          break;
        }
        case QKV:
          rms_rows(res, 0, M, a.d, a.ln1[f.layer], a.eps, s);
          prefetch_kv(a, s, f.layer, pos0);  // behind the norm's loads, under the qkv rows
          break;
        case ATTN_O:
          attention(a, s, qg, f.layer, M, pos0, j == 0);
          load_resv(a, s, f, M, res);
          break;
        case GATE_UP: rms_rows(res, 0, M, a.d, a.ln2[f.layer], a.eps, s); break;
        case DOWN: {
          load_resv(a, s, f, M, res);
          const float4* src = reinterpret_cast<const float4*>(act);
          float4* x4 = reinterpret_cast<float4*>(s.xs);
          for (int i = tid; i < M * a.F / 4; i += kConsumers) x4[i] = __ldcg(src + i);
          break;
        }
        default:
          Mx = 1;  // the head reads the last position alone
          rms_rows(res, M - 1, 1, a.d, a.norm, a.eps, s);
          break;
      }
      cbar();
      CSM_ADD(4 * f.kind, t0);
      CSM_CLK(const long long t1 = clock64(); const long long w0 = csm_clk[4 * f.kind + 1];)
      run_rows(a, s, f, Mx, p, k, res, qg, act, lg);
      CSM_CLK(if (tid == 0) csm_clk[4 * f.kind + 2] += clock64() - t1 - (csm_clk[4 * f.kind + 1] - w0);)
      CSM_CLK(const long long t2 = clock64();)
      grid_sync(ctr, ++bars);
      CSM_ADD(4 * f.kind + 3, t2);
    }
    long long next = a.forced != nullptr ? a.forced[p - 1] : 0;
    long long pick = next;
    CSM_CLK(const long long t3 = clock64(); const long long r0 = csm_clk[25] + csm_clk[26];)
    if (a.noise != nullptr) pick = sample(a, s, lg, p);
    CSM_CLK(if (tid == 0) csm_clk[24] += clock64() - t3 - (csm_clk[25] + csm_clk[26] - r0);)
    if (a.forced == nullptr) next = pick;
    if (j == 0 && tid == 0) a.codes[p] = pick;
    code = next;
  }
}

__global__ void __launch_bounds__(kThreads, 1) csm_depth_kernel(const CsmDepthArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s = carve(a, smem_raw);
  const int G = gridDim.x, j = blockIdx.x;
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s.hist[i] = 0;
  for (int i = threadIdx.x; i < kRing * max_units(a); i += blockDim.x) s.done[i] = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      hopper::mbar_init(&s.full[i], 1);
      hopper::mbar_init(&s.empty[i], kWarps);
    }
    hopper::fence_barrier_init();
  }
  if (a.noise != nullptr && (reinterpret_cast<uintptr_t>(a.noise) & 15) == 0 && threadIdx.x == kConsumers) {
    // the frame's noise into L2, a slice a block
    const int n16 = a.Q * a.V / 4, b0 = split(n16, G, j), b1 = split(n16, G, j + 1);
    if (b1 > b0) l2_prefetch(a.noise + 4 * (size_t)b0, 16u * (b1 - b0));
  }
  CSM_CLK(if (threadIdx.x < 40) csm_clk[threadIdx.x] = 0; const long long t_start = clock64();)
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(a, s, G, j);
    CSM_CLK(if (threadIdx.x == kConsumers) atomicAdd(&g_csm_clk[28], csm_clk[28]);)
    return;
  }
  consume(a, s, G, j);
  CSM_CLK(if (threadIdx.x == 0) {
    csm_clk[29] = clock64() - t_start;
    for (int i = 0; i < 40; ++i)
      if (i != 28) atomicAdd(&g_csm_clk[i], csm_clk[i]);
  })
}

// A row length K6's products take: a multiple of 4 floats, at least 32, and
// at most one unit (kSeg) or whole units up to one slot.
bool row_ok(int K) { return K % 4 == 0 && K >= 32 && (K <= kSeg || (K % kSeg == 0 && K <= kStage)); }

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int check_args(const CsmDepthArgs& a) {
  if (a.L < 1 || a.L > kMaxLayers || a.Q < 2 || a.Q > a.P || a.Q > kMaxPos || a.H < 1 || a.KVH < 1 ||
      a.H % a.KVH != 0 || a.hd < 4 || a.hd % 4 != 0 || a.V < 1 || a.top_k < 1 || !(a.eps >= 0.f) ||
      !row_ok(a.D) || !row_ok(a.d) || !row_ok(a.F) || !row_ok(a.H * a.hd) || 2 * a.d > kStage ||
      a.d > kWarps / 2 * 32 * kNormPer || a.V > kVPer * kConsumers || smem_bytes(a) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (a.noise == nullptr && a.forced == nullptr) return (int)cudaErrorInvalidValue;
  if (a.noise != nullptr && !(a.temperature > 0.f)) return (int)cudaErrorInvalidValue;
  if (a.c0 == nullptr || a.codes == nullptr) return (int)cudaErrorInvalidValue;
  const void* wide[] = {a.proj, a.norm, a.heads, a.audio_embed, a.cos, a.sin, a.cache_k, a.cache_v, a.h,
                        a.work};  // read 16 bytes at a time
  for (const void* p : wide)
    if (p == nullptr || !aligned(p)) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < a.L; ++l) {
    const void* w[] = {a.ln1[l], a.ln2[l], a.qkv[l], a.o[l], a.gate_up[l], a.down[l]};
    for (const void* p : w)
      if (p == nullptr || !aligned(p)) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// The shared memory a launch of K6 takes for these widths, or 0 where it
// does not take them.
extern "C" long long sopro_csm_depth_smem(const CsmDepthArgs* args) {
  const CsmDepthArgs& a = *args;
  if (a.L < 1 || a.L > kMaxLayers || a.Q > kMaxPos) return 0;
  return (long long)smem_bytes(a);
}

// K6: one frame's depth passes (module comment) on `stream`, one block per
// SM. `work` holds work_floats(widths) floats (the counter in its first 8
// bytes, zeroed here on the stream). Returns cudaGetLastError() after the
// launch, or an error code for widths or pointers it does not take.
extern "C" int sopro_csm_depth(const CsmDepthArgs* args, void* stream) {
  const CsmDepthArgs a = *args;
  int rc = check_args(a);
  if (rc != 0) return rc;
  int dev = 0, G = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&G, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (G < kMinGrid) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_bytes(a);
  e = cudaFuncSetAttribute(csm_depth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csm_depth_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3((unsigned)G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeCooperative;  // every block resident at once, or no launch
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaMemsetAsync(a.work, 0, sizeof(unsigned long long), cfg.stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, csm_depth_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
