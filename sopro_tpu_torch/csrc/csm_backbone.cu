// Kernel K7: one step of CSM's backbone in one launch, float32.
//
// Replaces no TPU kernel: CSM runs on the port alone (sopro_tpu/ has no
// CSM). It takes the place of the chain of library kernels that a frame's
// backbone step ran eagerly (~360 launches: the summed frame embedding,
// per layer RMSNorm, cuBLAS GEMVs, RoPE, the cache writes, SDPA over the
// cache, SiLU; the final norm, codebook 0's head and the top-k sample; the
// plain version is `ops/csm_backbone.py::step_plain`). From the previous
// frame's Q codes, the launch sums their Q audio-embedding rows into the
// input, runs the L decoder layers at the cache's next position (writing
// its keys and values into the cache), the final norm (the hidden state h
// the depth passes start from) and codebook 0's head, and samples codebook
// 0's code as `sampling.sample_topk` does (`csm::sample_topk`), or takes a
// forced code and writes the logits out (teacher forcing).
//
// What bounds it on the H100: a step reads every backbone weight once,
// 3.94 GB at CSM-1B's widths (16 layers of qkv 25 MB, o 17 MB, gate/up 134
// MB, down 67 MB; the head 17 MB), 1.18 ms at 3.35 TB/s with the cache; its
// 2 GFLOP take ~30 us on the CUDA cores. The layers are a chain of
// dependent phases, each needing the whole previous output, but long ones:
// 82 grid barriers a step (K6 has 558 a frame).
//
// Design (K6's persistent shape, `csm_stream.cuh`):
//   * One block per SM, launched cooperatively. Phases per layer: (1) norm1
//     and qkv; (2) attention, split over (kv head x chunk of positions) as
//     flash-decoding partials, RoPE and the cache write of this position in
//     it; (3) the partials combined in o's input, o plus the residual;
//     (4) norm2 and gate/up, SiLU(gate) * up in the epilogue; (5) down plus
//     the residual. Then the final norm, the head, and block 0's sample.
//   * A producer warp streams the weight rows as the model holds them
//     ([out, in]; no second copy) into a ring of kRing 32 KB slots by bulk
//     copies, one slot in flight (two or three in flight measured slower,
//     five slots 2.4 % faster than four). Rows are claimed, not assigned: per phase
//     the producers take a slot's rows at a time from one counter (the next
//     claim in flight while the current slot loads), so a block that gets
//     its bytes slower takes fewer rows, and no block waits at the barrier
//     for a share fixed in advance. A claim past the phase's rows puts an
//     end mark in the ring. The weights do not depend on the activations, so
//     the producer runs ahead across the grid barriers.
//   * 16 consumer warps take each slot in units of one row, or of a
//     512-float segment of a longer row, against the phase's input vector in
//     shared memory; the warp that finishes an output's last unit sums its
//     partials in a fixed order and writes the epilogue.
//   * The residual stream alternates between two buffers (o writes the
//     second from the first, down the first from the second), so that a
//     block's epilogue never overwrites a value another block still reads.
//   * Attention reads the cache's `pos + 1` positions only (pos = the
//     cache's filled positions): chunks of kChunkFloats / hd positions, K and
//     V copied into shared memory (cp.async) beside the current position's
//     roped key and value; the chunk's (max, sum, weighted values) per query
//     head go to the exchange and o's input combines them. The cached rows
//     do not depend on the step, so a block's first chunk is copied while
//     the qkv rows stream, and the combine issues all its loads in one
//     round: on the card each had cost ~7 us a layer of L2 round trips
//     under the weight stream's load.
//   * Reductions run in a fixed order and the only atomics count integers:
//     a step's logits, cache rows and pick repeat bit for bit whichever block
//     claims which rows.
//
// On an H100 (700 W) a step at CSM-1B's widths at positions 300-459 takes
// 1.48-1.50 ms, 78-79 % of the ~1.175 ms bound (the eager step replayed as
// one CUDA graph: 2.60-2.64 ms); PERF.md, K7, has what the rest goes to.

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
constexpr int kRing = 5;
constexpr int kInflight = 1;               // slots in flight from HBM at a time (of the ring's kRing)
constexpr int kSeg = 512;                  // floats of a row a unit takes, for rows longer than it
constexpr int kMaxLayers = 32;
constexpr int kMaxQ = 64;
constexpr int kNormPer = 8;                // values a lane normalises: D <= kWarps 32 kNormPer
constexpr int kVPer = 8;                   // logits a thread samples: V <= kVPer kConsumers
constexpr int kChunkFloats = 4096;         // a chunk's keys: kChunkFloats / hd positions
constexpr int kHdLane = 2;                 // head_dim <= 32 kHdLane
constexpr int kMaxChunks = 32;             // attention chunks a step: one a lane in the combine
constexpr int kCombC = 8;                  // chunks' partials a lane loads in one round
constexpr int kBarrier = 1;                // the consumers' named barrier
constexpr size_t kMaxSmem = 232448;
constexpr unsigned long long kSpinNs = 4000000000ull;  // a grid barrier waiting longer traps

enum Kind { QKV, O, GATE_UP, DOWN, HEAD };

}  // namespace

// Mirrored field for field by `_Args` in ops/csm_backbone.py. Every weight
// and table is float32 and contiguous, 16-byte aligned.
struct CsmBackboneArgs {
  int D, F, H, KVH, hd, L, V, Q, P;  // P: the cache's positions
  int pos;                           // the position this step writes
  int top_k;
  float eps, temperature;
  const float* audio_embed;  // [Q V, D]
  const float* norm;         // [D]
  const float* lm_head;      // [V, D]
  const float* cos;          // [>= P, hd]
  const float* sin;          // [>= P, hd]
  float* cache_k;            // [L, KVH, P, hd]
  float* cache_v;
  const float* ln1[kMaxLayers];      // [D]
  const float* ln2[kMaxLayers];      // [D]
  const float* qkv[kMaxLayers];      // [(H + 2 KVH) hd, D]
  const float* o[kMaxLayers];        // [D, H hd]
  const float* gate_up[kMaxLayers];  // [2 F, D]
  const float* down[kMaxLayers];     // [D, F]
  const long long* prev;     // [Q]: the previous frame's codes
  const float* noise;        // [V] codebook 0's Gumbel noise, or null (forced)
  const long long* forced;   // [1] codebook 0's code given, or null (sampled)
  float* h;                  // [D] out: the final norm's output
  long long* c0;             // [1] out: codebook 0's code
  float* logits;             // [V] out, or null
  float* work;               // scratch (`work_floats`): counters, then the exchange
};

namespace {

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int imax(int x, int y) { return x > y ? x : y; }
__host__ __device__ inline int qkv_width(const CsmBackboneArgs& a) { return (a.H + 2 * a.KVH) * a.hd; }

// Attention chunks: kChunkFloats / hd positions each, C = ceil(n / that)
// for n attended positions, at most max_chunks (<= kMaxChunks) for the
// cache's P.
__host__ __device__ inline int chunk_pos(const CsmBackboneArgs& a) { return kChunkFloats / a.hd; }
__host__ __device__ inline int max_chunks(const CsmBackboneArgs& a) {
  return (a.P + chunk_pos(a) - 1) / chunk_pos(a);
}

// The exchange in `work` (floats): the barrier counter (8 bytes) and the
// claim counters (one a weight phase, 4 L + 1 ints), zeroed before each
// launch (`header_floats`); then the residual's two buffers [D], q/k/v
// [qkv], SiLU(gate) * up [F], the logits [V], the attention partials'
// weighted values [H][max_chunks][hd], maxima and sums [H][max_chunks].
struct Work {
  unsigned long long* ctr;
  unsigned* claims;
  float *res0, *res1, *qkv, *act, *lg, *pacc, *pm, *pl;
};

__host__ __device__ inline int header_floats(const CsmBackboneArgs& a) { return 4 + r4(4 * a.L + 1); }

__host__ __device__ inline size_t work_floats(const CsmBackboneArgs& a) {
  const size_t hc = (size_t)a.H * max_chunks(a);
  return header_floats(a) + 2 * (size_t)r4(a.D) + r4(qkv_width(a)) + r4(a.F) + r4(a.V) + hc * a.hd +
         2 * r4((int)hc);
}

__device__ inline Work work_of(const CsmBackboneArgs& a) {
  Work w;
  w.ctr = reinterpret_cast<unsigned long long*>(a.work);
  w.claims = reinterpret_cast<unsigned*>(a.work + 2);
  const int hc = a.H * max_chunks(a);
  w.res0 = a.work + header_floats(a);
  w.res1 = w.res0 + r4(a.D);
  w.qkv = w.res1 + r4(a.D);
  w.act = w.qkv + r4(qkv_width(a));
  w.lg = w.act + r4(a.F);
  w.pacc = w.lg + r4(a.V);
  w.pm = w.pacc + (size_t)hc * a.hd;
  w.pl = w.pm + r4(hc);
  return w;
}

// The attention's scratch in the activation area (floats), after the qkv
// phase's input [D] (a block's first chunk of cached keys and values lands
// under the qkv products): the chunk's keys [chunk][hd + 4] (a row padded by
// 16 bytes, so that threads reading a key each hit other banks) and values
// [chunk][hd], the group's roped queries [group][hd], their scores
// [group][chunk].
struct AttnLayout {
  int k, v, q, sc, end;
};

__host__ __device__ inline AttnLayout attn_layout(const CsmBackboneArgs& a) {
  const int cp = chunk_pos(a), grp = a.H / a.KVH;
  AttnLayout x;
  x.k = r4(a.D);
  x.v = x.k + cp * (a.hd + 4);
  x.q = x.v + cp * a.hd;
  x.sc = x.q + grp * a.hd;
  x.end = x.sc + grp * cp;
  return x;
}

// Floats of the activation area: the largest phase input (F, or the
// combined attention H hd) or the qkv input with the attention's scratch.
__host__ __device__ inline int xs_floats(const CsmBackboneArgs& a) {
  return r4(imax(imax(a.F, a.H * a.hd), attn_layout(a).end));
}

// Units a slot holds at most: rows of K <= kSeg floats, or kSeg-float
// segments of longer rows (a multiple of 4, for alignment).
__host__ __device__ inline int units_of(int K) { return K <= kSeg ? kStage / K : kStage / kSeg; }

__host__ __device__ inline int max_units(const CsmBackboneArgs& a) {
  return r4(imax(imax(units_of(a.D), units_of(a.F)), units_of(a.H * a.hd)));
}

// Shared memory: the ring, the activation area, the residual [D], per ring
// slot its unit partials and its outputs' finished-unit counts, reduction
// slots, the sampler's four histograms, the frame's codes, per slot its
// first row and row count (the producer's claim), the mbarriers.
__host__ __device__ inline size_t smem_bytes(const CsmBackboneArgs& a) {
  const size_t um = max_units(a);
  return 4 * ((size_t)kRing * kStage + xs_floats(a) + r4(a.D) + kRing * 2 * um + 64 + 1024 + kMaxQ +
              2 * kRing) +
         16 * kRing;
}

struct Smem {
  float *ring, *xs, *resd, *part, *red;
  int *done, *hist, *codes, *meta;
  uint64_t *full, *empty;
};

__device__ inline Smem carve(const CsmBackboneArgs& a, unsigned char* base) {
  Smem s;
  const int um = max_units(a);
  s.ring = reinterpret_cast<float*>(base);
  s.xs = s.ring + (size_t)kRing * kStage;
  s.resd = s.xs + xs_floats(a);
  s.part = s.resd + r4(a.D);
  s.done = reinterpret_cast<int*>(s.part + kRing * um);
  s.red = reinterpret_cast<float*>(s.done + kRing * um);
  s.hist = reinterpret_cast<int*>(s.red + 64);
  s.codes = s.hist + 1024;
  s.meta = s.codes + kMaxQ;
  s.full = reinterpret_cast<uint64_t*>(s.meta + 2 * kRing);
  s.empty = s.full + kRing;
  return s;
}

// ---- the schedule: weight phases, 4 a layer and the head ----------------------

struct Phase {
  const float* w;  // the phase's weight, [rows, K]
  int K, rows, kind;
  size_t pair;     // gate/up: floats from gate row j to up row F + j; else 0
};

__device__ inline Phase phase(const CsmBackboneArgs& a, int idx) {
  Phase f;
  f.pair = 0;
  if (idx == 4 * a.L) {
    f.kind = HEAD, f.w = a.lm_head, f.K = a.D, f.rows = a.V;
    return f;
  }
  const int l = idx / 4;
  switch (idx % 4) {
    case 0: f.kind = QKV, f.w = a.qkv[l], f.K = a.D, f.rows = qkv_width(a); break;
    case 1: f.kind = O, f.w = a.o[l], f.K = a.H * a.hd, f.rows = a.D; break;
    case 2:
      f.kind = GATE_UP, f.w = a.gate_up[l], f.K = a.D, f.rows = a.F;
      f.pair = (size_t)a.F * a.D;
      break;
    default: f.kind = DOWN, f.w = a.down[l], f.K = a.F, f.rows = a.D; break;
  }
  return f;
}

// Rows a slot holds (gate/up: pairs of rows): one claim.
__device__ inline int slot_rows(const Phase& f) { return kStage / (f.K * (f.pair ? 2 : 1)); }

__device__ __forceinline__ void cbar() { hopper::named_sync(kBarrier, kConsumers); }

// Every consumer thread: this block's writes of the phase are done; wait
// until every block's are (the `n`-th barrier of the launch).
__device__ __forceinline__ void grid_sync(unsigned long long* ctr, unsigned long long n) {
  cbar();
  if (threadIdx.x == 0) {
    const unsigned long long target = n * gridDim.x;
    csm::grid_wait(ctr, target, csm::grid_arrive(ctr), kSpinNs);
  }
  cbar();
}

// ---- the producer --------------------------------------------------------------

// Lane 0 of the producer warp: every weight phase of the step in the
// consumers' order, a claimed slot of rows at a time (module comment). A
// slot is issued once the consumers have released it and the slot
// kInflight before it has landed.
__device__ void produce(const CsmBackboneArgs& a, const Smem& s, unsigned* claims) {
  const uint64_t pol = csm::evict_first();
  uint32_t k = 0;  // slot uses so far
  for (int idx = 0; idx <= 4 * a.L; ++idx) {
    const Phase f = phase(a, idx);
    const int R = slot_rows(f);
    const unsigned nch = (unsigned)((f.rows + R - 1) / R);
    unsigned next = atomicAdd(&claims[idx], 1u);
    for (;; ++k) {
      const unsigned mine = next;
      if (mine < nch) next = atomicAdd(&claims[idx], 1u);  // in flight while this slot loads
      const int slot = k % kRing;
      if (k >= kRing) hopper::mbar_wait(&s.empty[slot], ((k / kRing) - 1) & 1);
      if (mine >= nch) {  // the phase's end mark
        s.meta[2 * slot] = -1;
        hopper::mbar_arrive(&s.full[slot]);
        ++k;
        break;
      }
      if (k >= kInflight) hopper::mbar_wait(&s.full[(k - kInflight) % kRing], ((k - kInflight) / kRing) & 1);
      const int r0 = (int)mine * R, nr = min(R, f.rows - r0);
      s.meta[2 * slot] = r0;
      s.meta[2 * slot + 1] = nr;
      const uint32_t bytes = (uint32_t)nr * f.K * 4;
      float* dst = s.ring + (size_t)slot * kStage;
      const float* src = f.w + (size_t)r0 * f.K;
      hopper::mbar_expect_tx(&s.full[slot], f.pair ? 2 * bytes : bytes);
      csm::bulk_load(dst, src, bytes, &s.full[slot], pol);
      if (f.pair) csm::bulk_load(dst + (size_t)nr * f.K, src + f.pair, bytes, &s.full[slot], pol);
    }
  }
}

// ---- the consumers: phase inputs ------------------------------------------------

// xs[i] = RMSNorm(x)[i] * w[i] over x [d] (eps as the config says): each
// warp a slice of the row in registers; the sum of squares is the slices'
// in warp order, which every thread adds up itself. One consumer barrier;
// the caller's next barrier publishes xs.
__device__ void rms_row(const float* x, int d, const float* __restrict__ w, float eps, float* out,
                        const Smem& s) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w0 = (d * warp) / kWarps, w1 = (d * (warp + 1)) / kWarps;
  float v[kNormPer];
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kNormPer; ++u) {
    const int i = w0 + lane + 32 * u;
    v[u] = i < w1 ? __ldcg(x + i) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kNormPer; ++u) ss = fmaf(v[u], v[u], ss);
  ss = csm::warp_sum(ss);
  if (lane == 0) s.red[warp] = ss;
  cbar();
  float t = 0.f;
  for (int q = 0; q < kWarps; ++q) t += s.red[q];
  const float rs = rsqrtf(t / (float)d + eps);
#pragma unroll
  for (int u = 0; u < kNormPer; ++u) {
    const int i = w0 + lane + 32 * u;
    if (i < w1) out[i] = v[u] * rs * __ldg(w + i);
  }
}

// The step's input: the sum of the previous frame's Q audio-embedding rows
// (codebook q's code c at row q V + c), in codebook order; block j writes
// its slice of the columns into res0.
__device__ void embed(const CsmBackboneArgs& a, const Smem& s, const Work& w, int G, int j) {
  const int tid = threadIdx.x;
  if (tid < a.Q) s.codes[tid] = (int)a.prev[tid];
  cbar();
  const int n4 = a.D / 4, b0 = (int)(((long long)n4 * j) / G), b1 = (int)(((long long)n4 * (j + 1)) / G);
  for (int i = b0 + tid; i < b1; i += kConsumers) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int q = 0; q < a.Q; ++q) {
      const float4 e = __ldg(reinterpret_cast<const float4*>(a.audio_embed + ((size_t)q * a.V + s.codes[q]) * a.D) + i);
      acc.x += e.x;
      acc.y += e.y;
      acc.z += e.z;
      acc.w += e.w;
    }
    reinterpret_cast<float4*>(w.res0)[i] = acc;
  }
}

// Attention item `it` of C: kv head g, chunk c of positions t0..t0 + nc - 1.
__device__ inline void item_of(const CsmBackboneArgs& a, int it, int C, int& g, int& c, int& t0, int& nc) {
  const int cp = chunk_pos(a);
  g = it / C, c = it - g * C, t0 = c * cp, nc = min(a.pos + 1, t0 + cp) - t0;
}

// Item it's cached keys and values of layer l (its positions before pos)
// into the attention's scratch, asynchronously (cp.async; waited for in
// `attention`). A block's first item is issued with the qkv phase's input.
__device__ void load_chunk(const CsmBackboneArgs& a, const Smem& s, int l, int it, int C) {
  int g, c, t0, nc;
  item_of(a, it, C, g, c, t0, nc);
  const int hd = a.hd, n4 = hd / 4, cached = min(nc, a.pos - t0);
  const AttnLayout X = attn_layout(a);
  const size_t base = (((size_t)l * a.KVH + g) * a.P + t0) * hd;
  for (int i = threadIdx.x; i < cached * n4; i += kConsumers) {
    const int t = i / n4, col = 4 * (i - t * n4);
    csm::cp_async16(s.xs + X.k + t * (hd + 4) + col, a.cache_k + base + (size_t)t * hd + col);
    csm::cp_async16(s.xs + X.v + t * hd + col, a.cache_v + base + (size_t)t * hd + col);
  }
}

// Layer l's attention at position pos over positions 0..pos, one item per
// (kv head g, chunk c): the chunk's cached keys and values (`load_chunk`),
// the group's queries and, in the chunk holding pos, this position's key
// (both roped) and value from the exchange, which that item also writes
// into the cache; then per query head the chunk's max score, sum of
// exponentials and weighted values, into the exchange's partials.
__device__ void attention(const CsmBackboneArgs& a, const Smem& s, const Work& w, int l, int G, int j) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = a.hd, hf = hd / 2, grp = a.H / a.KVH, cp = chunk_pos(a), n = a.pos + 1;
  const int C = (n + cp - 1) / cp, Cm = max_chunks(a), hdp = hd + 4;
  const AttnLayout X = attn_layout(a);
  float* ks = s.xs + X.k;
  float* vs = s.xs + X.v;
  float* xq = s.xs + X.q;
  float* sc = s.xs + X.sc;
  const float scale = 1.0f / sqrtf((float)hd);
  const float* cs = a.cos + (size_t)a.pos * hd;
  const float* sn = a.sin + (size_t)a.pos * hd;
  for (int it = j; it < a.KVH * C; it += G) {
    int g, c, t0, nc;
    item_of(a, it, C, g, c, t0, nc);
    const bool here = t0 + nc == n;  // the chunk that holds pos
    if (it != j) load_chunk(a, s, l, it, C);
    const size_t at = (((size_t)l * a.KVH + g) * a.P + a.pos) * hd;
    const int nq = grp * hf, nk = here ? hf : 0, nv = here ? hd : 0;
    for (int i = tid; i < nq + nk + nv; i += kConsumers) {
      if (i < nq + nk) {  // rotate-half RoPE pairs (cc, cc + hf)
        const int r = i / hf, cc = i - r * hf;
        const float* x = w.qkv + (size_t)(r < grp ? g * grp + r : a.H + g) * hd;
        const float x1 = __ldcg(x + cc), x2 = __ldcg(x + cc + hf);
        const float y1 = x1 * __ldg(cs + cc) - x2 * __ldg(sn + cc);
        const float y2 = x2 * __ldg(cs + cc + hf) + x1 * __ldg(sn + cc + hf);
        if (r < grp) {
          xq[r * hd + cc] = y1;
          xq[r * hd + cc + hf] = y2;
        } else {
          ks[(nc - 1) * hdp + cc] = y1;
          ks[(nc - 1) * hdp + cc + hf] = y2;
          a.cache_k[at + cc] = y1;
          a.cache_k[at + cc + hf] = y2;
        }
      } else {
        const int cc = i - nq - nk;
        const float vv = __ldcg(w.qkv + (size_t)(a.H + a.KVH + g) * hd + cc);
        vs[(nc - 1) * hd + cc] = vv;
        a.cache_v[at + cc] = vv;
      }
    }
    csm::cp_async_wait();
    cbar();
    for (int i = tid; i < grp * nc; i += kConsumers) {  // scores
      const int r = i / nc, t = i - r * nc;
      const float4* q4 = reinterpret_cast<const float4*>(xq + r * hd);
      const float4* k4 = reinterpret_cast<const float4*>(ks + t * hdp);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c4 = 0; c4 < hd / 4; ++c4) {
        const float4 qv = q4[c4], kv = k4[c4];
        acc.x = fmaf(qv.x, kv.x, acc.x);
        acc.y = fmaf(qv.y, kv.y, acc.y);
        acc.z = fmaf(qv.z, kv.z, acc.z);
        acc.w = fmaf(qv.w, kv.w, acc.w);
      }
      sc[r * cp + t] = ((acc.x + acc.y) + (acc.z + acc.w)) * scale;
    }
    cbar();
    for (int r = warp; r < grp; r += kWarps) {  // per query head: max, exponentials, their sum
      float mx = -INFINITY;
      for (int t = lane; t < nc; t += 32) mx = fmaxf(mx, sc[r * cp + t]);
      mx = csm::warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < nc; t += 32) {
        const float e = expf(sc[r * cp + t] - mx);
        sc[r * cp + t] = e;
        sum += e;
      }
      sum = csm::warp_sum(sum);
      if (lane == 0) {
        w.pm[(size_t)(g * grp + r) * Cm + c] = mx;
        w.pl[(size_t)(g * grp + r) * Cm + c] = sum;
      }
    }
    cbar();
    for (int i = tid; i < grp * hd; i += kConsumers) {  // weighted values
      const int r = i / hd, d = i - r * hd;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // positions t = 4 m + q into acc[q], summed in q order
      for (int t0q = 0; t0q < nc; t0q += 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (t0q + q < nc) acc[q] = fmaf(sc[r * cp + t0q + q], vs[(t0q + q) * hd + d], acc[q]);
      }
      w.pacc[((size_t)(g * grp + r) * Cm + c) * hd + d] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    cbar();  // the scratch is free for the next item
  }
}

// o's input: per query head the chunks' partials combined, each weighted by
// exp(its max - the head's max), over the combined sum; the residual into
// resd. Warp w takes heads w and w + kWarps (then w + 2 kWarps, ..): lane c
// holds chunk c's max and sum, and its dims' weighted values of kCombC
// chunks at a time are all loaded before any is used, so that up to kCombC
// chunks (512 positions at head_dim 64) a warp's loads are one round trip
// through L2.
__device__ void combine(const CsmBackboneArgs& a, const Smem& s, const Work& w, const float* res) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, hd = a.hd;
  const int cp = chunk_pos(a), C = (a.pos + cp) / cp, Cm = max_chunks(a);
  for (int i = tid; i < a.D / 4; i += kConsumers)
    reinterpret_cast<float4*>(s.resd)[i] = __ldcg(reinterpret_cast<const float4*>(res) + i);
  for (int h0 = warp; h0 < a.H; h0 += 2 * kWarps) {
    const int nh = h0 + kWarps < a.H ? 2 : 1;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, v[2][kCombC][kHdLane];
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (k < nh && lane < C) {
        m[k] = __ldcg(w.pm + (size_t)(h0 + k * kWarps) * Cm + lane);
        l[k] = __ldcg(w.pl + (size_t)(h0 + k * kWarps) * Cm + lane);
      }
    auto load = [&](int c0) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int u = 0; u < kCombC; ++u)
#pragma unroll
          for (int q = 0; q < kHdLane; ++q) {
            const int c = c0 + u, d = lane + 32 * q;
            v[k][u][q] = k < nh && c < C && d < hd
                             ? __ldcg(w.pacc + ((size_t)(h0 + k * kWarps) * Cm + c) * hd + d)
                             : 0.f;
          }
    };
    load(0);
    float e[2], den[2], num[2][kHdLane];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float mx = csm::warp_max(m[k]);
      e[k] = lane < C ? expf(m[k] - mx) : 0.f;
      den[k] = csm::warp_sum(e[k] * l[k]);
#pragma unroll
      for (int q = 0; q < kHdLane; ++q) num[k][q] = 0.f;
    }
    for (int c0 = 0; c0 < C; c0 += kCombC) {
      if (c0 > 0) load(c0);
#pragma unroll
      for (int u = 0; u < kCombC; ++u)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float ew = __shfl_sync(0xffffffffu, e[k], (c0 + u) & 31);
#pragma unroll
          for (int q = 0; q < kHdLane; ++q)
            if (c0 + u < C) num[k][q] = fmaf(ew, v[k][u][q], num[k][q]);
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int q = 0; q < kHdLane; ++q)
        if (k < nh && lane + 32 * q < hd) s.xs[(h0 + k * kWarps) * hd + lane + 32 * q] = num[k][q] / den[k];
  }
}

// ---- the consumers: a phase's slots ---------------------------------------------

// Output i of a slot holding rows r0.. of phase f: its units' partials
// summed in order, and the phase's epilogue into the exchange.
__device__ void finish(const CsmBackboneArgs& a, const Smem& s, const Work& w, const Phase& f, const float* part,
                       int i, int r0, int nr, int segs) {
  const int row = r0 + i;
  float v = part[i * segs];
  for (int sg = 1; sg < segs; ++sg) v += part[i * segs + sg];
  switch (f.kind) {
    case QKV: w.qkv[row] = v; break;
    case O: w.res1[row] = s.resd[row] + v; break;
    case DOWN: w.res0[row] = s.resd[row] + v; break;
    case GATE_UP: {
      float up = part[(nr + i) * segs];
      for (int sg = 1; sg < segs; ++sg) up += part[(nr + i) * segs + sg];
      w.act[row] = v / (1.0f + expf(-v)) * up;
      break;
    }
    default:
      w.lg[row] = v;
      if (a.logits != nullptr) a.logits[row] = v;
      break;
  }
}

// Every consumer warp: the block's slots of phase f against xs, until the
// phase's end mark, each warp at its own pace (the ring keeps them within
// kRing slots of each other). `k` counts slot uses over the launch.
__device__ void run_rows(const CsmBackboneArgs& a, const Smem& s, const Work& w, const Phase& f, uint32_t& k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int segs = f.K > kSeg ? f.K / kSeg : 1, seg = f.K > kSeg ? kSeg : f.K;
  const int mult = f.pair ? 2 : 1, um = max_units(a);
  for (;; ++k) {
    const int slot = k % kRing;
    hopper::mbar_wait(&s.full[slot], (k / kRing) & 1);
    const int r0 = s.meta[2 * slot], nr = s.meta[2 * slot + 1];
    if (r0 < 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&s.empty[slot]);
      ++k;
      return;
    }
    const int units = nr * mult * segs;
    float* part = s.part + slot * um;
    int* done = s.done + slot * um;
    const float* wt = s.ring + (size_t)slot * kStage;
    for (int u = warp; u < units; u += kWarps) {
      const int r = u / segs, sg = u - r * segs;
      const float4* w4 = reinterpret_cast<const float4*>(wt + (size_t)r * f.K + sg * seg);
      const float4* x4 = reinterpret_cast<const float4*>(s.xs + sg * seg);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int q = lane; q < seg / 4; q += 32) {
        const float4 wv = w4[q];
        const float4 xv = x4[q];
        acc.x = fmaf(wv.x, xv.x, acc.x);
        acc.y = fmaf(wv.y, xv.y, acc.y);
        acc.z = fmaf(wv.z, xv.z, acc.z);
        acc.w = fmaf(wv.w, xv.w, acc.w);
      }
      const float v = csm::warp_sum((acc.x + acc.y) + (acc.z + acc.w));
      const int out = r < nr ? r : r - nr;  // gate/up: gate row i and up row nr + i make output i
      if (lane == 0) {
        part[u] = v;
        __threadfence_block();
        if (atomicAdd(&done[out], 1) == mult * segs - 1) {
          __threadfence_block();
          finish(a, s, w, f, part, out, r0, nr, segs);
          done[out] = 0;
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&s.empty[slot]);  // the slot's last read by this warp
  }
}

__device__ void consume(const CsmBackboneArgs& a, const Smem& s, int G, int j) {
  const int tid = threadIdx.x;
  const Work w = work_of(a);
  const int C = (a.pos + chunk_pos(a)) / chunk_pos(a);  // attention chunks
  unsigned long long bars = 0;
  uint32_t k = 0;
  embed(a, s, w, G, j);
  grid_sync(w.ctr, ++bars);
  for (int l = 0; l < a.L; ++l) {
    rms_row(w.res0, a.D, a.ln1[l], a.eps, s.xs, s);
    if (j < a.KVH * C) load_chunk(a, s, l, j, C);  // lands under the qkv rows
    cbar();
    run_rows(a, s, w, phase(a, 4 * l), k);
    grid_sync(w.ctr, ++bars);
    attention(a, s, w, l, G, j);
    grid_sync(w.ctr, ++bars);
    combine(a, s, w, w.res0);
    cbar();
    run_rows(a, s, w, phase(a, 4 * l + 1), k);
    grid_sync(w.ctr, ++bars);
    rms_row(w.res1, a.D, a.ln2[l], a.eps, s.xs, s);
    cbar();
    run_rows(a, s, w, phase(a, 4 * l + 2), k);
    grid_sync(w.ctr, ++bars);
    for (int i = tid; i < a.D / 4; i += kConsumers)
      reinterpret_cast<float4*>(s.resd)[i] = __ldcg(reinterpret_cast<const float4*>(w.res1) + i);
    for (int i = tid; i < a.F / 4; i += kConsumers)
      reinterpret_cast<float4*>(s.xs)[i] = __ldcg(reinterpret_cast<const float4*>(w.act) + i);
    cbar();
    run_rows(a, s, w, phase(a, 4 * l + 3), k);
    grid_sync(w.ctr, ++bars);
  }
  rms_row(w.res0, a.D, a.norm, a.eps, s.xs, s);
  cbar();
  if (j == 0)
    for (int i = tid; i < a.D; i += kConsumers) a.h[i] = s.xs[i];
  run_rows(a, s, w, phase(a, 4 * a.L), k);
  if (j != 0) {  // arrive for block 0, which samples
    cbar();
    if (tid == 0) csm::grid_arrive(w.ctr);
    return;
  }
  grid_sync(w.ctr, ++bars);
  long long pick = 0;
  if (a.noise != nullptr)
    pick = csm::sample_topk<kConsumers, kVPer, kWarps, kBarrier, false>(w.lg, a.noise, a.V, a.temperature, a.top_k,
                                                                        s.hist, s.red, nullptr);
  else
    pick = *a.forced;
  if (tid == 0) *a.c0 = pick;
}

__global__ void __launch_bounds__(kThreads, 1) csm_backbone_kernel(const CsmBackboneArgs a) {
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
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) produce(a, s, work_of(a).claims);
    return;
  }
  consume(a, s, G, j);
}

// A row length K7's products take: a multiple of 4 floats, at least 32, and
// at most one unit (kSeg) or whole units up to one slot.
bool row_ok(int K) { return K % 4 == 0 && K >= 32 && (K <= kSeg || (K % kSeg == 0 && K <= kStage)); }

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool widths_ok(const CsmBackboneArgs& a) {
  return a.L >= 1 && a.L <= kMaxLayers && a.Q >= 1 && a.Q <= kMaxQ && a.H >= 1 && a.KVH >= 1 &&
         a.H % a.KVH == 0 && a.hd >= 4 && a.hd % 4 == 0 && a.hd <= 32 * kHdLane && a.V >= 1 &&
         a.V <= kVPer * kConsumers && a.P >= 1 && max_chunks(a) <= kMaxChunks && row_ok(a.D) &&
         row_ok(a.F) && row_ok(a.H * a.hd) &&
         a.D <= kWarps * 32 * kNormPer && smem_bytes(a) <= kMaxSmem;
}

int check_args(const CsmBackboneArgs& a) {
  if (!widths_ok(a) || a.pos < 0 || a.pos >= a.P || !(a.eps >= 0.f)) return (int)cudaErrorInvalidValue;
  if ((a.noise == nullptr) == (a.forced == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.noise != nullptr && (!(a.temperature > 0.f) || a.top_k < 1)) return (int)cudaErrorInvalidValue;
  if (a.prev == nullptr || a.c0 == nullptr) return (int)cudaErrorInvalidValue;
  const void* wide[] = {a.audio_embed, a.norm, a.lm_head, a.cos, a.sin, a.cache_k, a.cache_v, a.h,
                        a.work};  // read or written 16 bytes at a time
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

// The shared memory and the scratch floats a launch of K7 takes for these
// widths, or 0 where it does not take them.
extern "C" long long sopro_csm_backbone_smem(const CsmBackboneArgs* args) {
  return widths_ok(*args) ? (long long)smem_bytes(*args) : 0;
}

extern "C" long long sopro_csm_backbone_work(const CsmBackboneArgs* args) {
  return widths_ok(*args) ? (long long)work_floats(*args) : 0;
}

// K7: one backbone step (module comment) on `stream`, one block per SM.
// `work` holds work_floats(widths) floats (its counters zeroed here on the
// stream). Returns cudaGetLastError() after the launch, or an error code for
// widths or pointers it does not take.
extern "C" int sopro_csm_backbone(const CsmBackboneArgs* args, void* stream) {
  const CsmBackboneArgs a = *args;
  int rc = check_args(a);
  if (rc != 0) return rc;
  int dev = 0, G = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&G, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(a);
  e = cudaFuncSetAttribute(csm_backbone_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csm_backbone_kernel, kThreads, smem);
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
  e = cudaMemsetAsync(a.work, 0, sizeof(float) * header_floats(a), cfg.stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, csm_backbone_kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
