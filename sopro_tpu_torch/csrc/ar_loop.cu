// Kernel K1: the AR decode loop, n_steps steps in one launch, float32 or bfloat16.
//
// Replaces sopro_tpu/ops/pallas_ar_loop.py::ar_loop_pallas (its
// `_ar_loop_kernel`), with the same state-in / state-out contract: per row
// t, last, streak, stopped, first_eos, Threefry key, 50-token history and
// the packed conv ring buffers [N, B, CTX, D] come in and go out, and the
// tokens of the steps come back as [B, n_steps]. Each step: previous-token
// embedding + conditioning row -> N SSMLite blocks (RMSNorm, GLU, dilated
// causal depthwise conv over the ring buffer, erf-GELU FFN) with a text
// cross-attention after every `freq`-th block -> RMSNorm -> V-way head ->
// the full `sample_full_vocab` sampler (repetition-penalty count grid, 26-step
// snapped top-k and top-p bisections, Threefry-2x32 Gumbel-max keyed by vocab
// id, degenerate fallback) -> cycle / streak anti-loop, EOS gated on
// min_gen, first_eos, per-row freeze.
//
// What bounds it on the H100: a step reads every AR weight once (~42 MB in
// fp32 at d = 384: six blocks of 5.9 MB, the attention projections, the
// 3.1 MB head) for ~21 MFLOP, and the weights stay resident in the 50 MB L2
// across steps. Each row runs on a thread-block cluster of CS blocks (16
// where the card schedules it, else 8, ...) that split every product across
// CS SMs and exchange the pieces through distributed shared memory:
//   * GLU columns and the depthwise conv by channel: block r owns channels
//     [r*D/CS, (r+1)*D/CS), their ring-buffer columns (in shared memory
//     behind a rotating head, written back oldest-first at exit), their
//     biases and taps, and their conv output, which it pushes to every block;
//   * FFN: block r computes its 4D/CS hidden columns, applies GELU, and
//     multiplies them by its rows of ff2 -- a partial [D] sum that every
//     block adds up in rank order (no hidden-vector exchange);
//   * attention: block r computes its D/CS query columns (pushed to every
//     block), the softmax over the text for the head its channels belong
//     to, the attention output for its own channels only, and multiplies it
//     by its rows of the output projection: again a partial [D] sum;
//   * head: block r computes V/CS logits and pushes them.
// That is two cluster barriers per SSMLite block, two per attention and one
// for the head. RMSNorms and the sampler run redundantly in every block on
// identical data, so every block holds the same state; rank 0 writes the
// outputs. The count grid is rebuilt from the history at entry, as the TPU
// kernel does. The sampler mirrors the JAX op sequence op for op, so tokens
// equal the plain path except at genuine near-ties.
//
// A step is a chain of ~40 dependent phases; the first design started every
// product's weight loads only when the product started (an L2 round trip
// per phase, 236 us per step on the H100). Here the sequence of weight
// slices a rank reads in a step is fixed, so the host packs each rank's
// slices contiguously in that order once per device (ops/ar_loop.py
// `pack_ar_stream`, mirroring `stream_schedule`), and the block streams
// them through a ring of kRing x 32 KB in shared memory, one 1-D bulk copy
// (TMA) per chunk of whole rows, issued by one thread and completing on the
// slot's mbarrier: every chunk taken frees a slot that is refilled with the
// chunk kRing - 1 ahead, so loads run ahead across phases and across steps
// (the next step's first GLU chunks land during the sampler). The floor of
// that stream is one SM's L2 -> shared memory rate (bench_ar.py, 16 blocks
// at once: ~65 GB/s with bulk copies in 3 x 32 KB, ~50 GB/s with per-thread
// cp.async, whose issue also stalls the threads). Further: 512 threads a block (at
// 1,024 the 64-register cap spilled in the hot loops); each RMSNorm's sum
// of squares is taken in the pass that writes h; the attention output is
// formed only for the block's own channels.
//
// Kernel K5, the same kernel in its logits-only mode (`kLogitsOnly`),
// replaces sopro_tpu/ops/pallas_ar.py::ar_step_pallas: ONE step for B rows
// from x [B, D] and the ring buffers [N, B, CTX, D] in device memory, with no
// sampler. Each rank writes its real logit columns straight to logits[b, :]
// and the shifted buffers go back oldest-first (the JAX `shifted` layout);
// the count grid, the bisections, Threefry and the state scalars are
// skipped. The block stack is K1's own code, so K1 and K5 compute the same
// step. K5 is bound like one step of K1, plus a launch and the cluster's
// set-up per step; the caller samples between launches.
//
// The bfloat16 instantiations (sopro_ar_loop_bf16, sopro_ar_step_bf16) take
// every weight, the conditioning, the embeddings, the text KV and the ring
// buffers in bfloat16 and compute what the TPU kernel computes on them
// (pallas_ar_loop.py `mm` and its step): the residual stream h stays float32;
// x_t = cond + emb is rounded to bfloat16 first; each product's input (the
// normed h, the GELU output, the attention output) is rounded to bfloat16 and
// multiplied by the bfloat16 weights in float32 FMAs on the CUDA cores, the
// bias added in float32; the GLU output is stored in the ring as bfloat16 and
// the conv runs in float32 over it; the text K/V are widened to float32 in the
// attention; the logits and the sampler are float32, as in float32. The
// weight stream is bfloat16 (`pack_ar_stream` of the bfloat16 stacked
// weights): a 32 KB ring stage carries twice the rows, and a step streams
// half the bytes (~21 MB at d = 384).
//
// Built with -DSOPRO_AR_CLOCKS (bench_ar.py), thread 0 of block 0 adds
// clock64() deltas per phase of a step (AR_PHASE marks, the phases of
// bench_ar.PHASES) into g_ar_clk, read by sopro_ar_clocks.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

constexpr int kThreads = 512;   // 128 registers a thread (1,024 threads spill at 64)
constexpr int kMaxLayers = 16;
constexpr int kBisect = 26;
constexpr int kRing = 3;        // weight ring stages
constexpr int kStage = 8192;    // floats per stage (32 KB)

// Elements of type T a ring stage holds, and the stream slices' width
// multiple: each chunk a whole number of 16-byte units (TMA bulk copies).
template <typename T>
constexpr int kStageElems = kStage * 4 / (int)sizeof(T);
template <typename T>
constexpr int kAlign = 16 / (int)sizeof(T);

#ifdef SOPRO_AR_CLOCKS
// per phase in shared memory while the kernel runs, into g_ar_clk at exit
__device__ unsigned long long g_ar_clk[32];
__shared__ unsigned long long ar_clk_acc[32];
#define AR_CLOCK_INIT long long ar_clk_last = clock64(); int ar_clk_cur = 0; \
  if (threadIdx.x == 0) for (int i_ = 0; i_ < 32; ++i_) ar_clk_acc[i_] = 0;
#define AR_PHASE(n) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
  const long long ar_now = clock64(); ar_clk_acc[ar_clk_cur] += ar_now - ar_clk_last; \
  ar_clk_last = ar_now; ar_clk_cur = (n); if ((n) == 0) ar_clk_acc[31] += 1; \
  if ((n) == 30) for (int i_ = 0; i_ < 32; ++i_) g_ar_clk[i_] += ar_clk_acc[i_]; } } while (0)
extern "C" int sopro_ar_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_ar_clk, sizeof(g_ar_clk));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zeros[32] = {0};
  return (int)cudaMemcpyToSymbol(g_ar_clk, zeros, sizeof(zeros));
}
#else
#define AR_CLOCK_INIT
#define AR_PHASE(n)
#endif

// Mirrored field for field by `_Args` in ops/ar_loop.py. The weights,
// conditioning, embeddings, text KV, ring buffers, x_in and the stream are
// float32, or all bfloat16 in the bfloat16 instantiations (the kernel reads
// them through pointers of its element type).
struct ArLoopArgs {
  int B, S, n_steps, L, D, N, K, CTX, A, H, V, Vp, freq, anti_loop, eos, hist_len, top_k,
      loop_streak;  // Vp: head_w row stride, V rounded up to a multiple of 4
  int dils[kMaxLayers];
  float rep_pen;
  const float *top_p, *temp, *rtp, *rtemp;
  const int* min_gen;
  const int *t_in, *last_in, *streak_in, *stopped_in, *feos_in;
  const long long* key_in;
  const int* hist_in;
  const float *bufs_in, *cond, *emb;
  const float *norm, *glu_w, *glu_b, *dw_w, *dw_b, *ff_norm, *ff1_w, *ff1_b, *ff2_w, *ff2_b;
  const float *x_nq, *x_q, *x_out, *x_gate, *kv_k, *kv_v;
  const int* mask;
  const float *out_norm, *head_w, *head_b;
  int* tokens;
  int *t_out, *last_out, *streak_out, *stopped_out, *feos_out;
  long long* key_out;
  int* hist_out;
  float* bufs_out;
  const float* x_in;  // K5 only: [B, D] step input
  float* logits;      // K5 only: [B, V]
  const float* wstream;  // [cs][stream_len]: each rank's weight slices in the order read
  int stream_len, cs;    // floats per rank; the cluster size the stream was packed for
};

namespace {

// ---- Threefry-2x32 (20 rounds), as sopro_tpu/sampling.py ------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1, uint32_t& o0,
                             uint32_t& o1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// ---- element types --------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// A value of element type T read as float, through the read-only cache.
template <typename T>
__device__ __forceinline__ float ldf(const float* p, size_t i) {
  return to_f(__ldg(reinterpret_cast<const T*>(p) + i));
}

// v rounded to T (the TPU kernel's `astype(w.dtype)`), as float.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive elements of type T (16-byte aligned for float, 8 for
// bfloat16) as a float4.
template <typename T>
__device__ __forceinline__ float4 ld4(const float* base, size_t i) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(base + i);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(base) + i);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
}

template <typename T>
__device__ __forceinline__ float4 ldg4(const float* base, size_t i) {
  if constexpr (std::is_same<T, float>::value) {
    return __ldg(reinterpret_cast<const float4*>(base + i));
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(base) + i));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
}

// ---- block reductions (every thread gets the result) ----------------------

__device__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions with one barrier: warps publish partials into one of
// two alternating buffers, then every warp folds the same partials with the
// same shuffle tree, so every thread gets the same value. A buffer is
// rewritten only two reductions later, after a barrier every reader passed.
struct Red {
  float* f;  // [2][32]
  int* i;    // [2][32]
  int k;     // reductions done (identical in every thread)
};

// op: 0 sum, 1 max, 2 min
__device__ __forceinline__ float warp_op(float v, int op) {
  return op == 0 ? warp_sum(v) : (op == 1 ? warp_max(v) : warp_min(v));
}

__device__ float block_reduce(float v, int op, Red& R) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_op(v, op);
  float* buf = R.f + (R.k++ & 1) * 32;
  if (lane == 0) buf[wid] = v;
  __syncthreads();
  const float ident = op == 0 ? 0.f : (op == 1 ? -INFINITY : INFINITY);
  return warp_op(lane < (int)(blockDim.x >> 5) ? buf[lane] : ident, op);
}

// op: 0 sum, 2 min
__device__ int block_reduce_i(int v, int op, Red& R) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = op == 0 ? warp_sum_i(v) : warp_min_i(v);
  int* buf = R.i + (R.k++ & 1) * 32;
  if (lane == 0) buf[wid] = v;
  __syncthreads();
  const int u = lane < (int)(blockDim.x >> 5) ? buf[lane] : (op == 0 ? 0 : 0x7fffffff);
  return op == 0 ? warp_sum_i(u) : warp_min_i(u);
}

// hn = scale * h * rsqrt(mean(h^2) + 1e-6) over n entries, from each
// thread's sum of squares `ss` over its own entries i = tid, tid + nt, ...,
// taken in the pass that wrote them: each thread normalises its own
// entries, then a barrier publishes hn (and h).
// The scale: elements off.. of `scale`, of element type T.
template <typename T>
__device__ void norm_from(const float* h, float ss, const float* __restrict__ scale, size_t off,
                          float* hn, int n, Red& red) {
  ss = block_reduce(ss, 0, red);
  const float inv = rsqrtf(ss / (float)n + 1e-6f);
  for (int i = threadIdx.x; i < n; i += blockDim.x) hn[i] = h[i] * inv * ldf<T>(scale, off + i);
  __syncthreads();
}

// ---- the weight stream ------------------------------------------------------

struct Layout {
  int cs, cw, fw, vw;  // cluster size; channels, FFN columns, logits per block
};

// vw: a multiple of kAlign<T> (16-byte rows of the head's slice).
template <typename T>
__host__ __device__ Layout layout(const ArLoopArgs& a, int cs) {
  Layout l;
  l.cs = cs;
  l.cw = a.D / cs;
  l.fw = 4 * a.D / cs;
  l.vw = ((a.Vp + cs - 1) / cs + kAlign<T> - 1) / kAlign<T> * kAlign<T>;
  return l;
}

// One slice [rows][width] of a rank's stream: chunks of kStageElems<T> / width
// whole rows, each (offset, elements) into sched (nullable).
template <typename T>
__host__ __device__ inline void add_slice(int rows, int width, int* sched, int& n, int& off) {
  const int rpc = kStageElems<T> / width;
  for (int r0 = 0; r0 < rows; r0 += rpc) {
    const int nr = rows - r0 < rpc ? rows - r0 : rpc;
    if (sched != nullptr) {
      sched[2 * n] = off;
      sched[2 * n + 1] = nr * width;
    }
    ++n;
    off += nr * width;
  }
}

// The slices a rank reads in one step, in order: per layer its GLU columns
// [D][2cw] (a then b), ff1 columns [D][fw], ff2 rows [fw][D], after every
// freq-th layer its x_q columns [D][cw] and x_out rows [cw][D]; then its head
// columns [D][vw] (zero past Vp). Returns the chunks per step; *len the
// elements per rank. Mirrored by ops/ar_loop.py `stream_schedule`.
template <typename T>
__host__ __device__ int stream_schedule(const ArLoopArgs& a, const Layout& l, int* sched, int* len) {
  int n = 0, off = 0;
  for (int li = 0; li < a.N; ++li) {
    add_slice<T>(a.D, 2 * l.cw, sched, n, off);
    add_slice<T>(a.D, l.fw, sched, n, off);
    add_slice<T>(l.fw, a.D, sched, n, off);
    if ((li + 1) % a.freq == 0) {
      add_slice<T>(a.D, l.cw, sched, n, off);
      add_slice<T>(l.cw, a.D, sched, n, off);
    }
  }
  add_slice<T>(a.D, l.vw, sched, n, off);
  if (len != nullptr) *len = off;
  return n;
}

// The ring: this rank's stream, taken in schedule order. Chunk k (counted
// over the whole launch) sits in slot k % kRing and is one 1-D bulk copy
// (TMA) issued by one thread, completing on the slot's mbarrier with its byte
// count; its use of the slot is phase (k / kRing) & 1 of that mbarrier.
// sched holds the step's (offset, floats) per chunk, the same every step.
// esize: the stream's element size in bytes (4 or 2).
struct Ring {
  float* buf;         // [kRing][kStage]
  uint64_t* bar;      // [kRing] one mbarrier per slot
  const char* src;    // this rank's stream
  const int* sched;   // [2 * nchunk]
  int nchunk, k;      // chunks per step; chunks taken (identical in every thread)
  int esize;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0: chunk k into its slot, whose previous chunk every thread read
// before the barrier that precedes this call.
__device__ void ring_issue(const Ring& rg, int k) {
  if (threadIdx.x != 0) return;
  const int c = k % rg.nchunk, slot = k % kRing;
  const uint32_t bytes = (uint32_t)rg.esize * (uint32_t)rg.sched[2 * c + 1];
  const uint32_t bar = smem_addr(rg.bar + slot);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(rg.buf + slot * kStage)),
      "l"(rg.src + (size_t)rg.esize * rg.sched[2 * c]), "r"(bytes), "r"(bar)
      : "memory");
}

// Every thread: wait until chunk k has landed in its slot.
__device__ void ring_wait(const Ring& rg, int k) {
  const uint32_t bar = smem_addr(rg.bar + k % kRing), parity = (uint32_t)((k / kRing) & 1);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// The next chunk, landed. The barrier says every thread is done with the
// chunk before, whose slot then takes the chunk kRing - 1 ahead.
__device__ const float* ring_take(Ring& rg) {
  ring_wait(rg, rg.k);
  __syncthreads();
  ring_issue(rg, rg.k + kRing - 1);
  return rg.buf + (rg.k++ % kRing) * kStage;
}

// Every thread: the chunks issued ahead land before the block exits.
__device__ void ring_drain(const Ring& rg) {
  for (int k = rg.k; k < rg.k + kRing - 1; ++k) ring_wait(rg, k);
}

// out[c] = sum_{i < n_in} x[i] * S[i][c] for c < width (a multiple of 4),
// S [n_in][width] the next slice of the stream, elements of type T (x and out
// in shared memory; x[i] rounded to T first, the TPU kernel's `mm`).
// Thread (g, c4) takes columns 4c4..4c4+3 of rows g, g + G, ... of every
// chunk (G = blockDim / (width / 4) groups); the G partial sums per column
// (`part`, >= 4 * blockDim floats) are folded by up to 32 lanes per column
// with shuffles, in a fixed order.
template <typename T>
__device__ void gemv_stream(Ring& rg, int width, int n_in, const float* x, float* out, float* part) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ngrp = width / 4, G = max(1, nt / ngrp), rpc = kStageElems<T> / width;
  const int g = tid / ngrp, c4 = tid - g * ngrp;
  const bool active = g < G;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r0 = 0; r0 < n_in; r0 += rpc) {
    const float* w = ring_take(rg);
    const int nr = min(rpc, n_in - r0);
    if (active) {
#pragma unroll 4
      for (int i = g; i < nr; i += G) {
        const float xv = rnd<T>(x[r0 + i]);
        const float4 wv = ld4<T>(w, (size_t)i * width + 4 * c4);
        acc.x = fmaf(xv, wv.x, acc.x);
        acc.y = fmaf(xv, wv.y, acc.y);
        acc.z = fmaf(xv, wv.z, acc.z);
        acc.w = fmaf(xv, wv.w, acc.w);
      }
    }
  }
  if (active) {
    float* dst = (G == 1 ? out : part + (size_t)g * width) + 4 * c4;
    dst[0] = acc.x;
    dst[1] = acc.y;
    dst[2] = acc.z;
    dst[3] = acc.w;
  }
  __syncthreads();
  if (G > 1) {
    int tpc = 1;  // lanes per output column: a power of two <= 32
    while (tpc < 32 && width * tpc * 2 <= nt) tpc *= 2;
    const int rounds = (width * tpc + nt - 1) / nt;
    for (int rd = 0; rd < rounds; ++rd) {
      const int idx = rd * nt + tid;
      const int c = idx / tpc, lane = idx % tpc;
      float s = 0.f;
      if (c < width)
        for (int gg = lane; gg < G; gg += tpc) s += part[(size_t)gg * width + c];
      for (int o = tpc >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (c < width && lane == 0) out[c] = s;
    }
    __syncthreads();
  }
}

// Write src[0..n) to dst[0..n) in the shared memory of every block of the
// cluster (this one included); the caller's cluster barrier publishes it.
__device__ void push(cg::cluster_group& cl, float* dst, const float* src, int n, int cs) {
  for (int idx = threadIdx.x; idx < cs * n; idx += blockDim.x) {
    const int rr = idx / n, i = idx - rr * n;
    cl.map_shared_rank(dst, rr)[i] = src[i];
  }
}

// floats: the ring's mbarriers [kRing] (8 bytes each, padded to 32 floats),
// the ring, h, hn, gab [2D], cbuf, yl, q, loc [max(fw, vw)], pbuf [cs][D],
// att [L], lg [V], p [V], part [4 * kThreads] (one of these two also holds
// the sampler's penalized logits), my ring columns, GLU biases, conv taps
// and biases, FFN biases, reduction partials [2][32]
__host__ __device__ size_t smem_floats(const ArLoopArgs& a, const Layout& l) {
  const size_t loc = (size_t)(l.fw > l.vw ? l.fw : l.vw);
  const size_t mine = (size_t)a.N * (a.CTX + 3 + a.K) * l.cw + (size_t)a.N * l.fw;
  return 32 + (size_t)kRing * kStage + 7 * (size_t)a.D + loc + (size_t)l.cs * a.D + (size_t)a.L +
         2 * (size_t)a.V + 4 * (size_t)kThreads + mine + 64;
}

// ints: the count grid [V], the history, reduction partials [2][32], the
// state scalars [16], the step's chunk schedule [2 * nchunk]
__host__ __device__ size_t smem_ints(const ArLoopArgs& a, int nchunk) {
  return (size_t)a.V + a.hist_len + 64 + 16 + 2 * (size_t)nchunk;
}

// kLogitsOnly: K5, one step from a.x_in, logits out, no sampler or state.
// E: the element type of the weights, cond, emb, KV, ring buffers and x_in.
template <typename E, bool kLogitsOnly>
__global__ void __launch_bounds__(kThreads, 1) ar_loop_kernel(const ArLoopArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  AR_CLOCK_INIT
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int r = (int)cl.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int D = a.D, V = a.V, L = a.L, CTX = a.CTX;
  const int hd = D / a.H;
  const Layout lay = layout<E>(a, cs);
  const int c0 = r * lay.cw;                            // my channels
  const int f0 = r * lay.fw;                            // my FFN columns
  const int v0 = min(a.Vp, r * lay.vw), v1 = min(a.Vp, v0 + lay.vw);  // my logits (padded)
  const int v1r = min(V, v1);                                        // ... of which real
  const int nchunk = stream_schedule<E>(a, lay, nullptr, nullptr);

  // ---- shared memory (identical layout in every block of the cluster) ----
  uint64_t* ringbar = reinterpret_cast<uint64_t*>(smem);  // [kRing] the ring's mbarriers
  float* ringbuf = smem + 32;      // [kRing][kStage] weight ring (128-byte aligned)
  float* h = ringbuf + kRing * kStage;  // [D] residual stream
  float* hn = h + D;               // [D] normed
  float* gab = hn + D;             // [2D] GLU a then b columns (mine)
  float* cbuf = gab + 2 * D;       // [D] conv output, gathered; my channels of the attention output
  float* yl = cbuf + D;            // [D] my partial / my slice before a push
  float* q = yl + D;               // [D] attention query, gathered
  float* loc = q + D;              // [max(fw, vw)] my FFN hidden / my logits
  float* pbuf = loc + max(lay.fw, lay.vw);  // [cs][D] FFN / attention partials, by rank
  float* att = pbuf + (size_t)cs * D;       // [L] attention weights of one head
  float* lg = att + L;             // [V] logits -> x (tempered)
  float* p = lg + V;               // [V] probabilities, then scores
  float* part = p + V;             // [4 * kThreads] gemv partial sums
  // [V] the sampler's penalized logits, in a buffer idle then: pbuf (no
  // peer pushes into it before this block reaches the next step's first
  // cluster barrier) where it is large enough, else part
  float* xp = (size_t)cs * D >= (size_t)V ? pbuf : part;
  float* ringS = part + 4 * kThreads;                    // [N][CTX][cw] my ring columns
  float* glubS = ringS + (size_t)a.N * CTX * lay.cw;      // [N][2][cw] my GLU biases
  float* dwS = glubS + (size_t)a.N * 2 * lay.cw;          // [N][K][cw] my conv taps
  float* dwbS = dwS + (size_t)a.N * a.K * lay.cw;         // [N][cw] my conv biases
  float* ff1bS = dwbS + (size_t)a.N * lay.cw;             // [N][fw] my FFN hidden biases
  Red red;
  red.f = ff1bS + (size_t)a.N * lay.fw;  // [2][32] reduction partials
  int* cnt = (int*)(red.f + 64);   // [V] penalty count grid
  int* hist = cnt + V;             // [hist_len]
  red.i = hist + a.hist_len;       // [2][32]
  red.k = 0;
  int* st = red.i + 64;            // [16] scalar state
  int* sched = st + 16;            // [2 * nchunk] the step's weight chunks
  enum { T = 0, LAST, STREAK, STOPPED, FEOS, K0, K1, HEAD, REC, NONE_VALID };

  const size_t layer_stride = (size_t)a.B * CTX * D;  // one layer of [N, B, CTX, D]
  const size_t row_off = (size_t)b * CTX * D;          // this row's [CTX, D] in a layer

  // ---- entry: state, count grid, my ring columns, the weight schedule ----
  if constexpr (!kLogitsOnly) {
    for (int i = tid; i < V; i += nt) cnt[i] = 0;
    if (tid == 0) {
      st[T] = a.t_in[b];
      st[LAST] = a.last_in[b];
      st[STREAK] = a.streak_in[b];
      st[STOPPED] = a.stopped_in[b];
      st[FEOS] = a.feos_in[b];
      st[K0] = (int)(uint32_t)(a.key_in[2 * b] & 0xffffffffLL);
      st[K1] = (int)(uint32_t)(a.key_in[2 * b + 1] & 0xffffffffLL);
    }
    for (int i = tid; i < a.hist_len; i += nt) hist[i] = a.hist_in[(size_t)b * a.hist_len + i];
  }
  if (tid == 0) {
    st[HEAD] = 0;
    int any = 0;
    for (int l = 0; l < L; ++l) any |= a.mask[(size_t)b * L + l] != 0;
    st[NONE_VALID] = !any;
    stream_schedule<E>(a, lay, sched, nullptr);
    for (int i = 0; i < kRing; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(ringbar + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int li = 0; li < a.N; ++li) {
    for (int i = tid; i < CTX * lay.cw; i += nt) {
      const int j = i / lay.cw, c = i - j * lay.cw;
      ringS[((size_t)li * CTX + j) * lay.cw + c] =
          ldf<E>(a.bufs_in, li * layer_stride + row_off + (size_t)j * D + c0 + c);
    }
    for (int c = tid; c < lay.cw; c += nt) {
      glubS[(li * 2) * lay.cw + c] = ldf<E>(a.glu_b, (size_t)li * 2 * D + c0 + c);
      glubS[(li * 2 + 1) * lay.cw + c] = ldf<E>(a.glu_b, (size_t)li * 2 * D + D + c0 + c);
      dwbS[li * lay.cw + c] = ldf<E>(a.dw_b, (size_t)li * D + c0 + c);
    }
    for (int i = tid; i < a.K * lay.cw; i += nt) {
      const int j = i / lay.cw, c = i - j * lay.cw;
      dwS[((size_t)li * a.K + j) * lay.cw + c] = ldf<E>(a.dw_w, ((size_t)li * a.K + j) * D + c0 + c);
    }
    for (int c = tid; c < lay.fw; c += nt) ff1bS[li * lay.fw + c] = ldf<E>(a.ff1_b, (size_t)li * 4 * D + f0 + c);
  }
  __syncthreads();
  if constexpr (!kLogitsOnly)
    for (int i = tid; i < a.hist_len; i += nt)
      if (hist[i] >= 0 && hist[i] < V) atomicAdd(&cnt[hist[i]], 1);
  Ring rg{ringbuf, ringbar,
          reinterpret_cast<const char*>(a.wstream) + sizeof(E) * (size_t)r * a.stream_len, sched,
          nchunk, 0, (int)sizeof(E)};
  for (int k = 0; k < kRing - 1; ++k) ring_issue(rg, k);
  cl.sync();  // every block has started before any shared memory is pushed

  const float pen = a.rep_pen;
  const float scale_att = 1.f / sqrtf((float)hd);
  int step = 0;
  for (; step < a.n_steps; ++step) {
    AR_PHASE(0);
    const int t = kLogitsOnly ? 0 : st[T];
    float ss = 0.f;  // this thread's sum of squares of the h entries it wrote
    if constexpr (kLogitsOnly) {
      for (int i = tid; i < D; i += nt) {
        const float v = ldf<E>(a.x_in, (size_t)b * D + i);
        h[i] = v;
        ss += v * v;
      }
    } else {
      if (!(t < a.S && st[STOPPED] == 0)) break;  // identical in every block

      // ---- x_t = cond[b, t] + emb[prev] ----
      const int prev = t == 0 ? V : st[LAST];
      const int tc = t < a.S - 1 ? t : a.S - 1;
      for (int i = tid; i < D; i += nt) {  // bfloat16: the sum rounded first, as the TPU kernel
        const float v = rnd<E>(ldf<E>(a.cond, ((size_t)b * a.S + tc) * D + i) +
                               ldf<E>(a.emb, (size_t)prev * D + i));
        h[i] = v;
        ss += v * v;
      }
    }
    const int head = st[HEAD];
    AR_PHASE(1);
    norm_from<E>(h, ss, a.norm, 0, hn, D, red);

    for (int li = 0; li < a.N; ++li) {
      // GLU (my channels) -> ring buffer -> dilated depthwise conv
      AR_PHASE(2);
      gemv_stream<E>(rg, 2 * lay.cw, D, hn, gab, part);
      AR_PHASE(3);
      float* rl = ringS + (size_t)li * CTX * lay.cw;
      const float* gbias = glubS + li * 2 * lay.cw;
      const int dil = a.dils[li];
      const int span = (a.K - 1) * dil + 1;
      for (int c = tid; c < lay.cw; c += nt) {
        const float av = gab[c] + gbias[c];
        const float bv = gab[lay.cw + c] + gbias[lay.cw + c];
        rl[head * lay.cw + c] = rnd<E>(av * (1.f / (1.f + expf(-bv))));  // newest -> oldest slot
      }
      __syncthreads();
      for (int idx = tid; idx < lay.cw * a.K; idx += nt) {  // one product per (channel, tap)
        const int c = idx / a.K, j = idx - c * a.K;
        const int phys = (head + 1 + CTX - span + j * dil) % CTX;  // oldest sits at head + 1
        part[idx] = dwS[((size_t)li * a.K + j) * lay.cw + c] * rl[phys * lay.cw + c];
      }
      __syncthreads();
      for (int c = tid; c < lay.cw; c += nt) {
        float acc = 0.f;
        for (int j = 0; j < a.K; ++j) acc += part[c * a.K + j];
        yl[c] = acc + dwbS[li * lay.cw + c];
      }
      __syncthreads();
      AR_PHASE(4);
      push(cl, cbuf + c0, yl, lay.cw, cs);
      cl.sync();
      ss = 0.f;
      for (int i = tid; i < D; i += nt) {
        const float v = h[i] + cbuf[i];
        h[i] = v;
        ss += v * v;
      }
      AR_PHASE(5);
      norm_from<E>(h, ss, a.ff_norm, (size_t)li * D, hn, D, red);

      // FFN: my hidden columns -> GELU -> my rows of ff2, summed over ranks
      AR_PHASE(6);
      gemv_stream<E>(rg, lay.fw, D, hn, loc, part);
      for (int c = tid; c < lay.fw; c += nt) {
        const float v = loc[c] + ff1bS[li * lay.fw + c];
        loc[c] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      }
      __syncthreads();
      AR_PHASE(7);
      gemv_stream<E>(rg, D, lay.fw, loc, yl, part);
      AR_PHASE(8);
      push(cl, pbuf + (size_t)r * D, yl, D, cs);
      cl.sync();
      ss = 0.f;
      for (int i = tid; i < D; i += nt) {
        float s = 0.f;
        for (int rr = 0; rr < cs; ++rr) s += pbuf[(size_t)rr * D + i];
        const float v = h[i] + (s + ldf<E>(a.ff2_b, (size_t)li * D + i));
        h[i] = v;
        ss += v * v;
      }
      const bool last = li + 1 == a.N;
      const float* next_norm = last ? a.out_norm : a.norm;
      const size_t next_off = last ? 0 : (size_t)(li + 1) * D;
      if ((li + 1) % a.freq != 0) {
        AR_PHASE(last ? 14 : 1);
        norm_from<E>(h, ss, next_norm, next_off, hn, D, red);
        continue;
      }

      // text cross-attention, sliced like the channels
      const int ai = li / a.freq;
      AR_PHASE(9);
      norm_from<E>(h, ss, a.x_nq, (size_t)ai * D, hn, D, red);
      gemv_stream<E>(rg, lay.cw, D, hn, yl, part);
      AR_PHASE(10);
      push(cl, q + c0, yl, lay.cw, cs);  // q columns [c0, c0 + cw) -> everyone
      cl.sync();
      AR_PHASE(11);
      for (int hh = c0 / hd; hh <= (c0 + lay.cw - 1) / hd; ++hh) {
        const size_t kv0 = (((size_t)ai * a.B + b) * a.H + hh) * L * hd;  // head hh's [L, hd]
        const float* qh = q + hh * hd;
        const int sub = tid & 7;  // eight lanes per key row
        for (int l0 = 0; l0 < L; l0 += nt / 8) {
          const int l = l0 + (tid >> 3);
          float s = 0.f;
          if (l < L)
            for (int d4 = sub; d4 < hd / 4; d4 += 8) {
              const float4 kv = ldg4<E>(a.kv_k, kv0 + (size_t)l * hd + 4 * d4);
              const float4 qv = *reinterpret_cast<const float4*>(qh + 4 * d4);
              s = fmaf(qv.x, kv.x, s);
              s = fmaf(qv.y, kv.y, s);
              s = fmaf(qv.z, kv.z, s);
              s = fmaf(qv.w, kv.w, s);
            }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          if (l < L && sub == 0) {
            const bool keep = a.mask[(size_t)b * L + l] != 0 || (l == 0 && st[NONE_VALID]);
            att[l] = keep ? s * scale_att : -INFINITY;
          }
        }
        __syncthreads();
        float mloc = -INFINITY;
        for (int l = tid; l < L; l += nt) mloc = fmaxf(mloc, att[l]);
        const float m = block_reduce(mloc, 1, red);
        float sloc = 0.f;
        for (int l = tid; l < L; l += nt) {
          const float e = expf(att[l] - m);
          att[l] = e;
          sloc += e;
        }
        const float ssum = block_reduce(sloc, 0, red);
        // the attention output for my channels of head hh: (dim, key chunk) threads
        const int e0 = max(c0, hh * hd) - hh * hd, e1 = min(c0 + lay.cw, (hh + 1) * hd) - hh * hd;
        const int nd = e1 - e0, nsplit = max(1, nt / nd);
        for (int idx = tid; idx < nd * nsplit; idx += nt) {
          const int sidx = idx / nd, d = e0 + idx - sidx * nd;
          float s = 0.f;
#pragma unroll 4
          for (int l = sidx; l < L; l += nsplit) s = fmaf(att[l] / ssum, ldf<E>(a.kv_v, kv0 + (size_t)l * hd + d), s);
          part[idx] = s;
        }
        __syncthreads();
        for (int i = tid; i < nd; i += nt) {
          float s = 0.f;
          for (int sidx = 0; sidx < nsplit; ++sidx) s += part[sidx * nd + i];
          cbuf[hh * hd + e0 + i - c0] = isfinite(s) ? s : 0.f;  // NaN scrub
        }
        __syncthreads();
      }
      AR_PHASE(12);
      gemv_stream<E>(rg, D, lay.cw, cbuf, yl, part);
      AR_PHASE(13);
      push(cl, pbuf + (size_t)r * D, yl, D, cs);
      cl.sync();
      const float gate = tanhf(ldf<E>(a.x_gate, ai));
      ss = 0.f;
      for (int i = tid; i < D; i += nt) {
        float s = 0.f;
        for (int rr = 0; rr < cs; ++rr) s += pbuf[(size_t)rr * D + i];
        const float v = h[i] + gate * s;
        h[i] = v;
        ss += v * v;
      }
      AR_PHASE(last ? 14 : 1);
      norm_from<E>(h, ss, next_norm, next_off, hn, D, red);
    }

    // ---- head (hn is the output norm of h): my logits, pushed to every block ----
    gemv_stream<E>(rg, lay.vw, D, hn, loc, part);
    if constexpr (kLogitsOnly) {  // K5: my real logit columns out, the ring head on
      for (int c = tid; c < v1r - v0; c += nt)
        a.logits[(size_t)b * V + v0 + c] = loc[c] + ldf<E>(a.head_b, v0 + c);
      if (tid == 0) st[HEAD] = (head + 1) % CTX;
      __syncthreads();
      continue;
    }
    for (int c = tid; c < v1r - v0; c += nt) loc[c] += ldf<E>(a.head_b, v0 + c);
    __syncthreads();
    AR_PHASE(15);
    push(cl, lg + v0, loc, max(0, v1r - v0), cs);
    cl.sync();

    // ---- anti-loop settings ----
    AR_PHASE(16);
    if (tid == 0) {
      int rec = 0;
      if (a.anti_loop) {
        const int hl = a.hist_len;
        for (int n = 3; n <= 16 && !rec; ++n) {
          if (t < 2 * n) continue;
          int eq = 1;
          for (int j = 0; j < n && eq; ++j) eq = hist[hl - n + j] == hist[hl - 2 * n + j];
          rec = eq;
        }
        rec |= (t > 0) && (st[STREAK] >= a.loop_streak);
      }
      st[REC] = rec;
    }
    __syncthreads();
    const float top_p = st[REC] ? a.rtp[b] : a.top_p[b];
    const float temp = st[REC] ? a.rtemp[b] : a.temp[b];

    // ---- key chain: next key at counters (0,0), subkey at (1,0) ----
    uint32_t nk0, nk1, sk0, sk1;
    threefry2x32((uint32_t)st[K0], (uint32_t)st[K1], 0u, 0u, nk0, nk1);
    threefry2x32((uint32_t)st[K0], (uint32_t)st[K1], 1u, 0u, sk0, sk1);

    // ---- sampler (sampling.sample_full_vocab, op for op) ----
    float vmin = INFINITY, vmax = -INFINITY;
    for (int i = tid; i < V; i += nt) {
      float l = lg[i];
      if (isnan(l)) l = -1e9f;
      else if (isinf(l)) l = l > 0.f ? 1e9f : -1e9f;
      const float x = l / temp;
      lg[i] = x;
      const float v = cnt[i] > 0 ? (x < 0.f ? x * pen : x / pen) : x;
      xp[i] = v;
      vmin = fminf(vmin, v);
      vmax = fmaxf(vmax, v);
    }
    AR_PHASE(18);
    float lo = block_reduce(vmin, 2, red) - 1.f;
    float hi = block_reduce(vmax, 1, red);
    for (int it = 0; it < kBisect; ++it) {  // top-k; the counts are exact in float32
      const float mid = 0.5f * (lo + hi);
      float c = 0.f;
      for (int i = tid; i < V; i += nt) c += xp[i] >= mid ? 1.f : 0.f;
      const bool over = block_reduce(c, 0, red) > (float)a.top_k;
      lo = over ? mid : lo;
      hi = over ? hi : mid;
    }
    float tmin = INFINITY;
    for (int i = tid; i < V; i += nt) tmin = fminf(tmin, xp[i] >= hi ? xp[i] : INFINITY);
    const float thr = block_reduce(tmin, 2, red);
    float tmax = -INFINITY;
    for (int i = tid; i < V; i += nt) tmax = fmaxf(tmax, xp[i] >= thr ? xp[i] : -INFINITY);
    const float m = block_reduce(tmax, 1, red);
    bool degenerate = !isfinite(m);
    float zs = 0.f;
    for (int i = tid; i < V; i += nt) {
      const float e = xp[i] >= thr ? expf(xp[i] - m) : 0.f;
      p[i] = e;
      zs += e;
    }
    const float z = fmaxf(block_reduce(zs, 0, red), 1e-30f);
    for (int i = tid; i < V; i += nt) p[i] = p[i] / z;
    __syncthreads();
    AR_PHASE(19);
    lo = 0.f;
    hi = 1.f;
    for (int it = 0; it < kBisect; ++it) {  // top-p
      const float mid = 0.5f * (lo + hi);
      float s = 0.f;
      for (int i = tid; i < V; i += nt) s += p[i] > mid ? p[i] : 0.f;
      const bool over = block_reduce(s, 0, red) > top_p;
      lo = over ? mid : lo;
      hi = over ? hi : mid;
    }
    AR_PHASE(20);
    float cmin = INFINITY;
    for (int i = tid; i < V; i += nt) cmin = fminf(cmin, (xp[i] >= thr && p[i] > lo) ? p[i] : INFINITY);
    const float cthr = block_reduce(cmin, 2, red);
    float mass2 = 0.f, smax = -INFINITY, xmax = -INFINITY;
    for (int i = tid; i < V; i += nt) {
      const bool keep2 = xp[i] >= thr && (p[i] >= cthr || xp[i] == m);
      mass2 += keep2 ? p[i] : 0.f;
      uint32_t bits, unused;
      threefry2x32(sk0, sk1, (uint32_t)i, 0u, bits, unused);
      const float u = ((float)(int)(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
      const float score = keep2 ? xp[i] + (-logf(-logf(u))) : -INFINITY;
      p[i] = score;  // p is dead past here: reuse it for the scores
      smax = fmaxf(smax, score);
      xmax = fmaxf(xmax, lg[i]);
    }
    degenerate = degenerate || block_reduce(mass2, 0, red) <= 1e-12f;
    const float ms = block_reduce(smax, 1, red);
    const float mg = block_reduce(xmax, 1, red);
    int is = V, ig = V;
    for (int i = tid; i < V; i += nt) {
      if (p[i] == ms) is = min(is, i);
      if (lg[i] == mg) ig = min(ig, i);
    }
    const int tok_s = block_reduce_i(is, 2, red);
    const int tok_g = block_reduce_i(ig, 2, red);
    const int tok = degenerate ? tok_g : tok_s;

    // ---- bookkeeping (ar_single_step semantics; the row is active) ----
    AR_PHASE(17);
    if (tid == 0) {
      const int hl = a.hist_len;
      const int expiring = hist[0];
      for (int i = 0; i < hl - 1; ++i) hist[i] = hist[i + 1];
      hist[hl - 1] = tok;
      if (tok >= 0 && tok < V) cnt[tok] += 1;
      if (expiring >= 0 && expiring < V) cnt[expiring] -= 1;
      st[STREAK] = (tok == st[LAST] && t > 0) ? st[STREAK] + 1 : 0;
      st[LAST] = tok;
      const bool is_eos = tok == a.eos;
      if (is_eos && st[FEOS] >= a.S) st[FEOS] = t;
      if (is_eos && t + 1 >= a.min_gen[b]) st[STOPPED] = 1;
      st[K0] = (int)nk0;
      st[K1] = (int)nk1;
      st[T] = t + 1;
      st[HEAD] = (head + 1) % CTX;
      if (r == 0) a.tokens[(size_t)b * a.n_steps + step] = tok;
    }
    __syncthreads();
  }
  AR_PHASE(30);
  ring_drain(rg);

  // ---- exit: tokens of skipped steps, state out, my ring columns ----
  if (!kLogitsOnly && r == 0) {
    for (int i = step + tid; i < a.n_steps; i += nt) a.tokens[(size_t)b * a.n_steps + i] = 0;
    if (tid == 0) {
      a.t_out[b] = st[T];
      a.last_out[b] = st[LAST];
      a.streak_out[b] = st[STREAK];
      a.stopped_out[b] = st[STOPPED];
      a.feos_out[b] = st[FEOS];
      a.key_out[2 * b] = (long long)(uint32_t)st[K0];
      a.key_out[2 * b + 1] = (long long)(uint32_t)st[K1];
    }
    for (int i = tid; i < a.hist_len; i += nt) a.hist_out[(size_t)b * a.hist_len + i] = hist[i];
  }
  const int head = st[HEAD];
  E* bufs_out = reinterpret_cast<E*>(a.bufs_out) + row_off;
  for (int li = 0; li < a.N; ++li)
    for (int i = tid; i < CTX * lay.cw; i += nt) {
      const int j = i / lay.cw, c = i - j * lay.cw;
      const float v = ringS[((size_t)li * CTX + (head + j) % CTX) * lay.cw + c];
      if constexpr (std::is_same<E, float>::value) bufs_out[li * layer_stride + (size_t)j * D + c0 + c] = v;
      else bufs_out[li * layer_stride + (size_t)j * D + c0 + c] = __float2bfloat16_rn(v);  // exact: v is a bfloat16
    }
  cl.sync();  // no block leaves while a peer could still address its shared memory
}

constexpr size_t kMaxSmem = 232448;

// The launch of `kernel` at cluster size cs, one cluster per row: false
// (cfg untouched) where cs does not divide D, its conv products do not fit
// `part`, a stream slice is not a multiple of 4 floats wide, or the card
// cannot schedule the cluster; an error where the shared memory does not fit.
template <typename T, bool kLogitsOnly>
cudaError_t configure(const ArLoopArgs& a, int cs, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute* attr, bool& ok) {
  ok = false;
  if (a.D % cs != 0) return cudaSuccess;
  const Layout lay = layout<T>(a, cs);
  if (lay.cw * a.K > 4 * kThreads || ((lay.cw | lay.fw | lay.vw | a.D) & (kAlign<T> - 1)) != 0 ||
      lay.vw > kStageElems<T> || a.D > kStageElems<T> || lay.fw > kStageElems<T> ||
      lay.vw > 4 * kThreads ||
      lay.fw > 4 * kThreads || a.D > 4 * kThreads || (cs * a.D < a.V && a.V > 4 * kThreads))
    return cudaSuccess;
  const int nchunk = stream_schedule<T>(a, lay, nullptr, nullptr);
  const size_t smem = (smem_floats(a, lay) + smem_ints(a, nchunk)) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ar_loop_kernel<T, kLogitsOnly>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3((unsigned)(a.B * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess || clusters <= 0) {
    (void)cudaGetLastError();  // clear the refusal: the caller tries a smaller cluster
    return cudaSuccess;
  }
  ok = true;
  return cudaSuccess;
}

template <typename T, bool kLogitsOnly>
int check_args(const ArLoopArgs& a) {
  if (a.B <= 0 || a.N <= 0 || a.N > kMaxLayers || a.H <= 0 || a.D % a.H != 0 ||
      (a.D / a.H) % 4 != 0 || a.V <= 0 || a.Vp < a.V || a.Vp % 4 != 0 ||
      a.L <= 0 || a.S <= 0 || a.freq <= 0 || a.CTX <= 0 || a.hist_len < 32 || a.hist_len > 64)
    return (int)cudaErrorInvalidValue;
  for (int li = 0; li < a.N; ++li)
    if ((a.K - 1) * a.dils[li] + 1 > a.CTX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ar_loop_kernel<T, kLogitsOnly>,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)e;
}

// The cluster size a launch takes: the largest of 16, 8, ... that qualifies
// (see `configure`) and that the card schedules.
template <typename T, bool kLogitsOnly>
int choose_cluster(const ArLoopArgs& a, int* cs_out) {
  int rc = check_args<T, kLogitsOnly>(a);
  if (rc != 0) return rc;
  for (int cs = 16; cs >= 1; cs /= 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    bool ok = false;
    cudaError_t e = configure<T, kLogitsOnly>(a, cs, cfg, attr, ok);
    if (e != cudaSuccess) return (int)e;
    if (ok) {
      *cs_out = cs;
      return 0;
    }
  }
  return (int)cudaErrorInvalidConfiguration;
}

// Launches `kernel` for a.B rows, one cluster of a.cs blocks per row (the
// size a.wstream was packed for). Returns cudaGetLastError() after the
// launch, or an error code for unsupported shapes.
template <typename T, bool kLogitsOnly>
int launch(const ArLoopArgs& a, void* stream) {
  int rc = check_args<T, kLogitsOnly>(a);
  if (rc != 0) return rc;
  if (a.cs <= 0 || a.cs > 16 || a.wstream == nullptr) return (int)cudaErrorInvalidValue;
  int len = 0;
  stream_schedule<T>(a, layout<T>(a, a.cs), nullptr, &len);
  if (len != a.stream_len) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  bool ok = false;
  cudaError_t e = configure<T, kLogitsOnly>(a, a.cs, cfg, attr, ok);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  cfg.stream = (cudaStream_t)stream;
  e = cudaLaunchKernelEx(&cfg, ar_loop_kernel<T, kLogitsOnly>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of a.cs blocks the card holds at once for this launch:
// a cluster must fit inside one GPC, so rows past the count run in waves.
template <typename T, bool kLogitsOnly>
int active_clusters(const ArLoopArgs& a, int* out) {
  int rc = check_args<T, kLogitsOnly>(a);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  bool ok = false;
  cudaError_t e = configure<T, kLogitsOnly>(a, a.cs, cfg, attr, ok);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaOccupancyMaxActiveClusters(out, ar_loop_kernel<T, kLogitsOnly>, &cfg);
}

// mode: bit 0 K5 (logits only) else K1, bit 1 the bfloat16 instantiation.
template <template <typename, bool> class F, typename... Args>
int by_mode(int mode, Args... args) {
  switch (mode) {
    case 0: return F<float, false>::run(args...);
    case 1: return F<float, true>::run(args...);
    case 2: return F<__nv_bfloat16, false>::run(args...);
    case 3: return F<__nv_bfloat16, true>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}
template <typename T, bool L>
struct ActiveClusters {
  static int run(const ArLoopArgs& a, int* out) { return active_clusters<T, L>(a, out); }
};
template <typename T, bool L>
struct ChooseCluster {
  static int run(const ArLoopArgs& a, int* out) { return choose_cluster<T, L>(a, out); }
};

}  // namespace

// cudaOccupancyMaxActiveClusters for K1 or K5 (`mode`: bit 0 K5, bit 1
// bfloat16) at cluster size a.cs and these shapes. Returns 0 or an error code.
extern "C" int sopro_ar_active_clusters(const ArLoopArgs* args, int mode, int* out) {
  return by_mode<ActiveClusters>(mode, *args, out);
}

// The cluster size K1 or K5 (`mode` as above) takes for these args (the
// weight stream is then packed for it). Returns 0 or an error code.
extern "C" int sopro_ar_cluster(const ArLoopArgs* args, int mode, int* cs_out) {
  return by_mode<ChooseCluster>(mode, *args, cs_out);
}

// K1: runs a.n_steps decode steps for a.B rows.
extern "C" int sopro_ar_loop(const ArLoopArgs* args, void* stream) {
  return launch<float, false>(*args, stream);
}

// K5: one step for a.B rows, a.x_in [B, D] and a.bufs_in -> a.logits [B, V]
// and a.bufs_out; the sampler and state fields are not read.
extern "C" int sopro_ar_step(const ArLoopArgs* args, void* stream) {
  ArLoopArgs a = *args;
  if (a.x_in == nullptr || a.logits == nullptr) return (int)cudaErrorInvalidValue;
  a.n_steps = 1;
  return launch<float, true>(a, stream);
}

// K1 and K5 on bfloat16 weights, cond, emb, text KV, ring buffers and x_in
// (the logits, settings and state stay float32 / int32).
extern "C" int sopro_ar_loop_bf16(const ArLoopArgs* args, void* stream) {
  return launch<__nv_bfloat16, false>(*args, stream);
}

extern "C" int sopro_ar_step_bf16(const ArLoopArgs* args, void* stream) {
  ArLoopArgs a = *args;
  if (a.x_in == nullptr || a.logits == nullptr) return (int)cudaErrorInvalidValue;
  a.n_steps = 1;
  return launch<__nv_bfloat16, true>(a, stream);
}
