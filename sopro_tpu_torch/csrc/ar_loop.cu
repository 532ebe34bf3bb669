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
// fp32 at d = 384, ~21 MB in bf16) for ~21 MFLOP per row, and the step is a
// chain of dependent phases. The TPU kernel keeps the weights resident in
// VMEM for the whole launch and runs all B rows through each product. Here
// the same idea is spread over the card: one persistent launch of G blocks,
// one per SM (G = the SM count, launched cooperatively so every block is
// resident before any waits on another), decodes every row of the call.
//   * Each block owns a fixed slice of every product: channels [c0, c1) of
//     D (the GLU's a and b columns, the depthwise conv, the x_q and x_out
//     columns, and the residual stream h for those channels), hidden columns
//     [f0, f1) of 4D (ff1's columns and ff2's rows), and logits [v0, v1) of
//     the head. Block j's slices are packed once per device, row by row with
//     D contiguous (`pack_ar_stream`), in the order the step reads them
//     (`stream_schedule`). The longest prefix that fits the shared memory
//     left over is loaded once per launch and stays (all of it in bfloat16 at
//     B <= 16: ~164 KB a block); the rest streams each step through a ring
//     of kRing x 32 KB in shared memory, 1-D bulk copies (TMA) issued by a
//     producer warp that refills a slot as soon as the consumers release it
//     (an mbarrier per slot each way), outside the consumers' barriers.
//   * All rows of a group (up to kMaxGroup; larger B runs its rows through
//     each step in groups) go through each weight slice together: a product
//     is [rows, K] x [K, cols] from shared memory, so the weight bytes of a
//     step do not grow with B and a launch has no waves.
//   * Exchanges between blocks go through a small buffer in global memory
//     (L2): each block writes its part, arrives on one 64-bit counter
//     (fence, red.release.gpu) and thread 0 spins with ld.acquire.gpu until
//     every block has arrived; data is read back with ld.global.cg. Two
//     halves alternate, so an exchange's data is never overwritten while a
//     block may still read it (a block writes exchange e + 2 only after every
//     block arrived at e + 1). The counter is zeroed on the launch's stream
//     before the launch and only grows during it. A step has 3 exchanges per
//     SSMLite block (the residual after the conv; ff2's partial sums, summed
//     by the owner of each channel in block order; the residual after the
//     FFN), 3 per attention (q, the attention partials, the residual), the
//     logits and the tokens: 29 at full width. Every sum across blocks is
//     taken in a fixed order (never float atomics), so repeated calls are
//     bit-identical.
//   * RMSNorms: after each residual exchange every block gathers h for all
//     rows and normalises it (one warp a row), identically in every block.
//   * Text attention: units (row, head, key chunk) over the blocks, each
//     writing its chunk's max, sum and unnormalised output; every block
//     combines the units (flash-decoding style) into the x_out product's
//     input.
//   * Sampler: row b's sampler runs in block b % G on kSampWarps warps
//     with its logits in registers (kVpt a thread), so rows sample side by
//     side. Its reductions are warp shuffles plus one fold of the warps'
//     values on the sampler's own named barrier (bench_ar: 8 warps beat 4
//     and 15, and one bisection level a reduction beats evaluating 2 or 3
//     levels of the bisection tree at once). The token and the row's state
//     reach every block through the last exchange.
//   * The conv ring buffers live in bufs_out (copied from bufs_in at entry,
//     a rotating head per row, rotated back to oldest-first at exit); each
//     block reads its channels' taps for the next iteration while it waits
//     for the tokens.
//
// Kernel K5, the same kernel in its logits-only mode (`kLogitsOnly`),
// replaces sopro_tpu/ops/pallas_ar.py::ar_step_pallas: ONE step for B rows
// from x [B, D] and the ring buffers [N, B, CTX, D], with no sampler: the
// head's owners write logits[b, v0:v1] and the shifted buffers go back
// oldest-first (the JAX `shifted` layout). Its per-launch cost beyond the
// step is loading the resident slices (the whole stream once, from L2).
//
// The bfloat16 instantiations (sopro_ar_loop_bf16, sopro_ar_step_bf16) take
// every weight, the conditioning, the embeddings, the text KV and the ring
// buffers in bfloat16 and compute what the TPU kernel computes on them
// (pallas_ar_loop.py `mm` and its step): the residual stream h stays float32;
// x_t = cond + emb is rounded to bfloat16 first; each product's input (the
// normed h, the GELU output, the attention output) is rounded to bfloat16 and
// multiplied by the bfloat16 weights in float32 FMAs on the CUDA cores; the
// GLU output is stored in the ring as bfloat16 and the conv runs in float32
// over it; the text K/V are widened to float32 in the attention; the logits
// and the sampler are float32.
//
// Built with -DSOPRO_AR_CLOCKS (bench_ar.py), thread 0 of block 0 adds
// clock64() deltas per phase of a step (AR_PHASE marks, the phases of
// bench_ar.PHASES) into g_ar_clk, read by sopro_ar_clocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

constexpr int kConsumers = 480;             // the compute threads: 15 warps
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;   // + the producer warp: 512, 128 registers a thread
constexpr int kMaxLayers = 16;
constexpr int kBisect = 26;
constexpr int kRing = 3;                    // streamed weight ring stages
constexpr int kStage = 8192;                // floats per stage (32 KB)
constexpr int kMaxGroup = 32;               // rows per group
constexpr int kSampWarps = 8;               // a row's sampler: two warpgroups
constexpr int kSampThreads = 32 * kSampWarps;
constexpr int kVpt = 9;                     // sampler logits per thread: V <= kVpt * kSampThreads
constexpr int kMaxOwn = 4;                  // sampler rows per block: B <= kMaxOwn * G
constexpr int kOwnInts = 80;                // per sampler row: history [64] + scalars [16]
constexpr int kResL = 2048;                 // residency is sized at this text length (or L)
constexpr size_t kMaxSmem = 232448;

template <typename T>
constexpr int kStageElems = kStage * 4 / (int)sizeof(T);

#ifdef SOPRO_AR_CLOCKS
// per phase in shared memory while the kernel runs, into g_ar_clk at exit
__device__ unsigned long long g_ar_clk[32];
__shared__ unsigned long long ar_clk_acc[32];
__shared__ long long ar_clk_last;
__shared__ int ar_clk_cur;
#define AR_CLOCK_INIT if (threadIdx.x == 0) { \
  for (int i_ = 0; i_ < 32; ++i_) ar_clk_acc[i_] = 0; ar_clk_last = clock64(); ar_clk_cur = 0; }
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
// them through pointers of its element type). The last block of fields is
// the launch plan, filled by the C side (`plan`), not by the caller.
struct ArLoopArgs {
  int B, S, n_steps, L, D, N, K, CTX, A, H, V, Vp, freq, anti_loop, eos, hist_len, top_k,
      loop_streak;  // Vp: head_w row stride (the stacked view; the stream holds V columns)
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
  const float* x_in;     // K5 only: [B, D] step input
  float* logits;         // K5 only: [B, V]
  const float* wstream;  // [grid][stream_len]: each block's weight slices in the order read
  int stream_len, grid;  // elements per block (the longest block's); the blocks it was packed for
  float* xch;                 // exchange buffer: two halves of xch_half floats
  unsigned long long* sync;   // the arrival counter (zeroed on the stream before each launch)
  // the plan (`plan`)
  int rg, nc, res_elems, streamed, nchunk_max;
  long long xch_half;
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

// A value of element type T written by this launch, read from L2.
template <typename T>
__device__ __forceinline__ float ldcgf(const float* p, size_t i) {
  if constexpr (std::is_same<T, float>::value) return __ldcg(p + i);
  else return __bfloat162float(__ldcg(reinterpret_cast<const __nv_bfloat16*>(p) + i));
}

template <typename T>
__device__ __forceinline__ void stf(float* p, size_t i, float v) {
  if constexpr (std::is_same<T, float>::value) p[i] = v;
  else reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);  // exact: v is a bfloat16
}

// v rounded to T (the TPU kernel's `astype(w.dtype)`), as float.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

// Four consecutive elements of type T (16-byte aligned for float, 8 for
// bfloat16) as a float4, from shared or global memory.
template <typename T>
__device__ __forceinline__ float4 ld4(const void* base, size_t i) {
  if constexpr (std::is_same<T, float>::value) {
    return reinterpret_cast<const float4*>(base)[i / 4];
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ---- barriers and reductions among the consumer threads -------------------

// The consumers' own barrier (named barrier 1): the producer warp never joins.
__device__ __forceinline__ void cbar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ float op3(float a, float b, int op) {
  return op == 0 ? a + b : (op == 1 ? fmaxf(a, b) : fminf(a, b));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One value over the consumers (op: 0 sum, 1 max, 2 min): every warp folds
// its lanes with shuffles, lane 0 publishes, one barrier, then every warp
// folds the warps' values the same way, so every thread gets the same
// result. The two halves of `red` [2][kWarps] alternate, so a half is
// rewritten only after a barrier every reader passed.
__device__ __forceinline__ float breduce1(float v, int op, float* red, int& rk) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op3(v, __shfl_xor_sync(0xffffffffu, v, o), op);
  float* buf = red + (rk++ & 1) * kWarps;
  if (lane == 0) buf[w] = v;
  cbar();
  v = lane < kWarps ? buf[lane] : (op == 0 ? 0.f : (op == 1 ? -INFINITY : INFINITY));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op3(v, __shfl_xor_sync(0xffffffffu, v, o), op);
  return v;
}

// The sampler's warps: their own barrier (named barrier 2) and reductions:
// shuffles within each warp, then every thread folds the kSampWarps warps'
// values in a fixed order (pairs, then pairs of pairs). `red`
// [2][8][kSampWarps] alternates as `breduce1`'s does.
__device__ __forceinline__ void sbar() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kSampThreads) : "memory");
}

template <int NV>
__device__ __forceinline__ void sreduce(float (&v)[NV], const int (&op)[NV], float* red, int& rk) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = op3(v[k], __shfl_xor_sync(0xffffffffu, v[k], o), op[k]);
  float* buf = red + (rk++ & 1) * 8 * kSampWarps;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < NV; ++k) buf[k * kSampWarps + w] = v[k];
  sbar();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float f[kSampWarps];
#pragma unroll
    for (int i = 0; i < kSampWarps; ++i) f[i] = buf[k * kSampWarps + i];
#pragma unroll
    for (int n = kSampWarps / 2; n > 0; n >>= 1)
#pragma unroll
      for (int i = 0; i < n; ++i) f[i] = op3(f[i], f[i + n], op[k]);
    v[k] = f[0];
  }
}

__device__ __forceinline__ float sreduce1(float v, int op, float* red, int& rk) {
  float a[1] = {v};
  const int o[1] = {op};
  sreduce<1>(a, o, red, rk);
  return a[0];
}


// ---- mbarriers and bulk copies --------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_test(bar, parity)) {
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

// ---- the block layout and the plan ----------------------------------------

__host__ __device__ inline int part(int n, int G, int j) { return (int)(((long long)n * j) / G); }

struct Lay {
  int c0, cw, f0, fw, v0, vw;  // channels of D, hidden columns of 4D, logits of V
};

__host__ __device__ inline Lay layout(const ArLoopArgs& a, int G, int j) {
  Lay l;
  l.c0 = part(a.D, G, j);
  l.cw = part(a.D, G, j + 1) - l.c0;
  l.f0 = part(4 * a.D, G, j);
  l.fw = part(4 * a.D, G, j + 1) - l.f0;
  l.v0 = part(a.V, G, j);
  l.vw = part(a.V, G, j + 1) - l.v0;
  return l;
}

__host__ __device__ inline int ceil_div(int n, int d) { return (n + d - 1) / d; }

// One slice [rows][D] of a block's stream: chunks of kStageElems<T> / D whole
// rows, each (offset, elements) into sched (nullable).
template <typename T>
__host__ __device__ inline void add_slice(int rows, int D, int* sched, int& n, int& off) {
  const int rpc = kStageElems<T> / D;
  for (int r0 = 0; r0 < rows; r0 += rpc) {
    const int nr = rows - r0 < rpc ? rows - r0 : rpc;
    if (sched != nullptr) {
      sched[2 * n] = off;
      sched[2 * n + 1] = nr * D;
    }
    ++n;
    off += nr * D;
  }
}

// The slices a block reads in one pass over the rows, in order, each [rows][D]
// with D contiguous: per layer its GLU columns (2cw: a then b), ff1 columns
// (fw), ff2 rows (fw); after every freq-th layer its x_q columns (cw) and
// x_out columns (cw); then its head columns (vw). Returns the chunks; *len
// the elements. Mirrored by ops/ar_loop.py `stream_slices` / `stream_schedule`.
template <typename T>
__host__ __device__ int stream_schedule(const ArLoopArgs& a, const Lay& l, int* sched, int* len) {
  int n = 0, off = 0;
  for (int li = 0; li < a.N; ++li) {
    add_slice<T>(2 * l.cw, a.D, sched, n, off);
    add_slice<T>(l.fw, a.D, sched, n, off);
    add_slice<T>(l.fw, a.D, sched, n, off);
    if ((li + 1) % a.freq == 0) {
      add_slice<T>(l.cw, a.D, sched, n, off);
      add_slice<T>(l.cw, a.D, sched, n, off);
    }
  }
  add_slice<T>(l.vw, a.D, sched, n, off);
  if (len != nullptr) *len = off;
  return n;
}

__host__ __device__ inline size_t r4(size_t n) { return (n + 3) / 4 * 4; }

// The widest product output of a block: its GLU (2cw), ff1 (fw) or head (vw) columns.
__host__ __device__ inline int out_width(const ArLoopArgs& a, int G) {
  const int g2 = 2 * ceil_div(a.D, G), f = ceil_div(4 * a.D, G), v = ceil_div(a.V, G);
  const int m = g2 > f ? g2 : f;
  return m > v ? m : v;
}

// Shared memory in 4-byte words, region by region (offsets from the base);
// mirrored by ops/ar_loop.py `smem_bytes`.
struct Carve {
  size_t bars, wbuf, ring, x, hown, y, taps, rpart, att, qh, scale, consts, red, sred, lgx, cnt,
      own, rows, sched, misc, total;
};

__host__ __device__ inline Carve carve(const ArLoopArgs& a, int G, int rg, int L, size_t res_words,
                                       bool streamed, int nchunk_max) {
  const int cwm = ceil_div(a.D, G), ym = out_width(a, G);
  Carve c;
  size_t o = 0;
  c.bars = o; o += 16;                                   // 2 * kRing + 1 mbarriers
  c.wbuf = o; o += res_words;                            // the resident prefix
  c.ring = o; o += streamed ? (size_t)kRing * kStage : 0;  // the streamed ring
  c.x = o; o += r4((size_t)rg * a.D);                    // product input [rg][D]
  c.hown = o; o += r4((size_t)rg * cwm);                 // my channels of h [rg][cw]
  c.y = o; o += r4((size_t)rg * ym);                     // my product output [rg][ym]
  c.taps = o; o += r4((size_t)a.N * (a.K - 1) * rg * cwm);  // the conv taps [N][K-1][rg][cw]
  c.rpart = o; o += kConsumers;                          // partial sums
  c.att = o; o += r4((size_t)L);                         // attention weights of a key chunk
  c.qh = o; o += r4((size_t)a.D);                        // one head's query
  c.scale = o; o += r4((size_t)a.D);                     // a norm's scale
  c.consts = o; o += r4((size_t)a.N * (cwm * (a.K + 4) + ceil_div(4 * a.D, G)) + ceil_div(a.V, G) + a.A);
  c.red = o; o += 2 * kWarps;                            // reduction partials
  c.sred = o; o += 2 * 8 * kSampWarps;                   // the sampler's reduction partials
  c.lgx = o; o += r4((size_t)a.V);                       // the sampler's tempered logits
  c.cnt = o; o += r4((size_t)(a.V + 31) / 32);           // (int) the history's tokens, a bit each
  c.own = o; o += (size_t)kMaxOwn * kOwnInts;            // (int) my sampler rows' state
  c.rows = o; o += r4((size_t)5 * a.B);                  // (int) t, last, stopped, head, none-valid
  c.sched = o; o += r4((size_t)2 * nchunk_max);          // (int) my chunks (offset, elements)
  c.misc = o; o += 16;                                   // (int) scalars
  c.total = o;
  return c;
}

// The attention's key chunks per (row, head): as many as spread the units
// over the blocks, of at least 32 keys.
__host__ __device__ inline int key_chunks(int G, int rg, int H, int L) {
  int nc = G / (rg * H);
  const int by_len = ceil_div(L, 32);
  nc = nc < by_len ? nc : by_len;
  return nc > 1 ? nc : 1;
}

// The launch plan for grid G (host): rows per group, key chunks, the
// resident prefix and the exchange buffer. The largest group of min(B, 32),
// 16, 8, ... rows whose shared memory fits 227 KB with the ring at text
// length max(L, kResL); resident: all of the longest stream where it fits, else the ring
// plus the longest prefix that fits. Returns false where nothing fits.
template <typename T>
bool plan(ArLoopArgs& a, int G, int* len_out = nullptr) {
  int len_max = 0, nchunk_max = 0;
  for (int j = 0; j < G; ++j) {
    int len = 0;
    const int n = stream_schedule<T>(a, layout(a, G, j), nullptr, &len);
    len_max = len > len_max ? len : len_max;
    nchunk_max = n > nchunk_max ? n : nchunk_max;
  }
  const int lres = a.L > kResL ? a.L : kResL;
  const int first = a.B < kMaxGroup ? a.B : kMaxGroup;
  for (int rg = first; rg >= 1; rg = rg == first && rg > 16 ? 16 : rg / 2) {
    if (rg > first) continue;
    const size_t fixed = carve(a, G, rg, lres, 0, false, nchunk_max).total;
    if (fixed * 4 > kMaxSmem) continue;
    const size_t avail = kMaxSmem - fixed * 4;
    const size_t all = r4(((size_t)len_max * sizeof(T) + 3) / 4) * 4;
    size_t res_bytes;
    int streamed;
    if (all <= avail) {
      res_bytes = all;
      streamed = 0;
    } else {
      const size_t ring = (size_t)kRing * kStage * 4;
      if (avail < ring) continue;
      res_bytes = (avail - ring) / 16 * 16;
      streamed = 1;
    }
    a.rg = rg;
    a.streamed = streamed;
    a.res_elems = streamed ? (int)(res_bytes / sizeof(T)) : len_max;
    a.nchunk_max = nchunk_max;
    a.nc = key_chunks(G, rg, a.H, a.L);
    const int hd = a.D / a.H;
    long long half = (long long)G * rg * a.D;
    const long long others[3] = {(long long)rg * a.V, (long long)rg * a.H * a.nc * (hd + 2),
                                 (long long)rg * 4};
    for (long long o : others) half = o > half ? o : half;
    a.xch_half = (half + 3) / 4 * 4;
    if (len_out != nullptr) *len_out = len_max;
    return true;
  }
  return false;
}

template <typename T>
__host__ __device__ inline size_t res_words(const ArLoopArgs& a) {
  return r4(((size_t)a.res_elems * sizeof(T) + 3) / 4);
}

// ---- the weight stream, consumer side ---------------------------------------

// Chunk uses are counted over the launch (k); chunk c = k % nchunk of the
// block's pass. Chunks c < nres sit resident at their stream offset (one
// mbarrier, phase 0, for all of them); the others are streamed: use ks of
// the ring sits in slot ks % kRing, phase (ks / kRing) & 1 of its full and
// empty mbarriers.
struct Stream {
  const char* res;    // the resident prefix
  const char* ring;   // [kRing][kStage * 4 bytes]
  uint64_t* full;     // [kRing]
  uint64_t* empty;    // [kRing]
  uint64_t* resbar;
  const int* sched;   // [2 * nchunk]
  int nchunk, nres, esize;
  long long k;        // chunk uses so far (identical in every consumer thread)
};

// Every consumer thread: the next chunk, landed.
__device__ __forceinline__ const void* take(Stream& s) {
  const int c = (int)(s.k % s.nchunk);
  if (c < s.nres) {
    mbar_wait(s.resbar, 0u);
    return s.res + (size_t)s.esize * s.sched[2 * c];
  }
  const long long ks = (s.k / s.nchunk) * (s.nchunk - s.nres) + (c - s.nres);
  const int slot = (int)(ks % kRing);
  mbar_wait(s.full + slot, (uint32_t)((ks / kRing) & 1));
  return s.ring + (size_t)slot * kStage * 4;
}

// Every consumer thread, after its last read of the chunk taken: release a
// streamed chunk's slot (one arrival a warp), count the use.
__device__ __forceinline__ void release(Stream& s) {
  const int c = (int)(s.k % s.nchunk);
  if (c >= s.nres) {
    const long long ks = (s.k / s.nchunk) * (s.nchunk - s.nres) + (c - s.nres);
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(s.empty + ks % kRing))
                   : "memory");
  }
  ++s.k;
}

// ---- products ---------------------------------------------------------------

// Column slice (rows of the stream = output columns, D weights each):
// out[b * ostride + c] = sum_k x[b][k] * W[c][k] for the nrow rows of the
// slice and b < nb, x [nb][D] in shared memory (already rounded to T). One
// warp a column, lanes along k (four elements a lane, one accumulator per
// element position), up to 4 rows at once, folded with shuffles.
template <typename T>
__device__ __forceinline__ void dot_slice(Stream& s, int nrow, int D, int nb, const float* x, float* out,
                                          int ostride) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rpc = kStageElems<T> / D, nq = D / 4;
  for (int r0 = 0; r0 < nrow; r0 += rpc) {
    const void* wt = take(s);
    const int nr = min(rpc, nrow - r0);
    for (int c = w; c < nr; c += kWarps) {
      for (int b0 = 0; b0 < nb; b0 += 4) {
        float4 acc[4];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) acc[bb] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
        for (int q = lane; q < nq; q += 32) {
          const float4 wv = ld4<T>(wt, (size_t)c * D + 4 * q);
#pragma unroll
          for (int bb = 0; bb < 4; ++bb)
            if (b0 + bb < nb) {
              const float4 xv = *reinterpret_cast<const float4*>(x + (size_t)(b0 + bb) * D + 4 * q);
              acc[bb].x = fmaf(wv.x, xv.x, acc[bb].x);
              acc[bb].y = fmaf(wv.y, xv.y, acc[bb].y);
              acc[bb].z = fmaf(wv.z, xv.z, acc[bb].z);
              acc[bb].w = fmaf(wv.w, xv.w, acc[bb].w);
            }
        }
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          if (b0 + bb >= nb) break;  // uniform over the block
          const float v = warp_sum((acc[bb].x + acc[bb].y) + (acc[bb].z + acc[bb].w));
          if (lane == 0) out[(size_t)(b0 + bb) * ostride + r0 + c] = v;
        }
      }
    }
    release(s);
  }
}

// Row slice (ff2: rows f of the stream, D outputs each): part[b][n] =
// sum_{f < nrow} hid[b * hstride + f] * W[f][n] for every n < D, b < nb,
// written to global memory (this block's partial sums; zeros where the
// block owns no rows). Thread (bs, q) takes columns 4q..4q+3 of rows
// b = bs, bs + nbs, ..., two rows at a time; a slice of several chunks adds
// each chunk onto the partial it stored.
template <typename T>
__device__ __forceinline__ void axpy_slice(Stream& s, int nrow, int D, int nb, const float* hid,
                                           int hstride, float* part) {
  const int tid = threadIdx.x, nq = D / 4;
  const int nbs = max(1, kConsumers / nq);
  const int bs = tid / nq, q = tid - bs * nq;
  const bool on = bs < nbs;
  const int rpc = kStageElems<T> / D;
  for (int r0 = 0; r0 == 0 || r0 < nrow; r0 += rpc) {
    const void* wt = nrow > 0 ? take(s) : nullptr;
    const int nr = max(0, min(rpc, nrow - r0));
    if (on)
      for (int b = bs; b < nb; b += 2 * nbs) {
        const int b2 = b + nbs;
        const bool two = b2 < nb;
        float4* p0 = reinterpret_cast<float4*>(part + (size_t)b * D) + q;
        float4* p1 = reinterpret_cast<float4*>(part + (size_t)(two ? b2 : b) * D) + q;
        float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
        if (r0 > 0) {
          a0 = __ldcg(p0);
          a1 = __ldcg(p1);
        }
#pragma unroll 4
        for (int f = 0; f < nr; ++f) {
          const float4 wv = ld4<T>(wt, (size_t)f * D + 4 * q);
          const float h0 = hid[(size_t)b * hstride + r0 + f];
          const float h1 = two ? hid[(size_t)b2 * hstride + r0 + f] : 0.f;
          a0.x = fmaf(h0, wv.x, a0.x);
          a0.y = fmaf(h0, wv.y, a0.y);
          a0.z = fmaf(h0, wv.z, a0.z);
          a0.w = fmaf(h0, wv.w, a0.w);
          a1.x = fmaf(h1, wv.x, a1.x);
          a1.y = fmaf(h1, wv.y, a1.y);
          a1.z = fmaf(h1, wv.z, a1.z);
          a1.w = fmaf(h1, wv.w, a1.w);
        }
        __stcg(p0, a0);
        if (two) __stcg(p1, a1);
      }
    if (nrow > 0) release(s);
  }
}

// ---- exchanges ----------------------------------------------------------------

struct Xch {
  float* buf;                // [2][half]
  long long half;
  unsigned long long* ctr;
  int G, e;                  // exchanges so far (identical in every block)
};

// The buffer the next exchange writes.
__device__ __forceinline__ float* xout(const Xch& x) { return x.buf + (size_t)(x.e & 1) * x.half; }

// Every consumer thread: this block's writes are done; arrive.
__device__ __forceinline__ void xarrive(const Xch& x) {
  cbar();  // the release below is cumulative over the block's writes ordered by this barrier
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;\n" ::"l"(x.ctr) : "memory");
}

// Every consumer thread: wait until every block arrived; returns the
// exchange's buffer (read it with ld.global.cg).
__device__ __forceinline__ const float* xwait(Xch& x) {
  if (threadIdx.x == 0) {
    const unsigned long long target = (unsigned long long)(x.e + 1) * (unsigned long long)x.G;
    unsigned long long v;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(x.ctr) : "memory");
    } while (v < target);
  }
  cbar();
  return x.buf + (size_t)(x.e++ & 1) * x.half;
}

// ---- row norms -----------------------------------------------------------------

// A norm's scale into sc [D], each thread its elements; called before the
// wait that precedes the norm, so the loads overlap it (the wait's barrier
// publishes sc).
template <typename T>
__device__ __forceinline__ void prefetch_scale(const float* __restrict__ scale, size_t soff, int D,
                                               float* sc) {
  for (int k = threadIdx.x; k < D; k += kConsumers) sc[k] = ldf<T>(scale, soff + k);
}

// x[b][k] = rnd<T>(h[b][k] * rsqrt(mean_k h[b][k]^2 + 1e-6) * sc[k]) for
// b < nb; h[b][k] = src(b, k), gathered by every consumer thread at once
// (four loads in flight a thread); then one warp a row. Every block computes
// the same. Also keeps h[b][c0 + c] in hown[b][c] (the channels this block
// owns) when `own` is set. Ends with a consumer barrier.
template <typename T, typename Src>
__device__ __forceinline__ void norm_rows(int nb, int D, float* x, const float* sc, float* hown,
                                          int c0, int cw, int cwm, bool own, Src src) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, n = nb * D;
  for (int i0 = tid; i0 < n; i0 += 4 * kConsumers) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kConsumers;
      v[u] = i < n ? src(i / D, i % D) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * kConsumers < n) x[i0 + u * kConsumers] = v[u];
  }
  cbar();
  for (int b = w; b < nb; b += kWarps) {
    float ss = 0.f;
    for (int k = lane; k < D; k += 32) ss = fmaf(x[(size_t)b * D + k], x[(size_t)b * D + k], ss);
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)D + 1e-6f);
    for (int k = lane; k < D; k += 32) {
      const float v = x[(size_t)b * D + k];
      if (own && k >= c0 && k < c0 + cw) hown[(size_t)b * cwm + k - c0] = v;
      x[(size_t)b * D + k] = rnd<T>(v * inv * sc[k]);
    }
  }
  cbar();
}

// ---- the sampler (sampling.sample_full_vocab, op for op) -------------------------

enum { T_ = 0, LAST_, STREAK_, STOPPED_, FEOS_, K0_, K1_ };  // own-row scalars (after the history)

// Row b's token from its logits lg (global, [V]), its state `own` (history
// [64], then the scalars) and the count grid as a bitmap cnt [V / 32] (the
// penalty only asks whether a token's count is above zero; zero on entry
// and exit),
// by the first kSampThreads threads (the others return -1 at once); x [V]
// keeps the tempered logits, red [2][8][kSampWarps] the reductions.
__device__ __forceinline__ int sample_row(const ArLoopArgs& a, int b, const float* lg, int* own,
                                          int* cnt, float* x, float* red, int* misc) {
  const int tid = threadIdx.x, V = a.V, hl = a.hist_len;
  if (tid >= kSampThreads) return -1;
  int rk = 0;
  int* hist = own;
  int* st = own + 64;
  const int t = st[T_];
  if (tid < hl && hist[tid] >= 0 && hist[tid] < V) atomicOr(&cnt[hist[tid] >> 5], (int)(1u << (hist[tid] & 31)));
  if (a.anti_loop) {  // anti-loop settings: a cycle of any length n in 3..16, or a streak
    const int n = tid;  // misc[1] is 0 here: set at entry and after every draw
    if (n >= 3 && n <= 16 && t >= 2 * n) {
      int eq = 1;
      for (int jj = 0; jj < n && eq; ++jj) eq = hist[hl - n + jj] == hist[hl - 2 * n + jj];
      if (eq) misc[1] = 1;
    }
    if (tid == 0 && t > 0 && st[STREAK_] >= a.loop_streak) misc[1] = 1;
  }
  sbar();
  const bool rec = misc[1] != 0;
  const float top_p = rec ? a.rtp[b] : a.top_p[b];
  const float temp = rec ? a.rtemp[b] : a.temp[b];
  const float pen = a.rep_pen;

  // ---- key chain: next key at counters (0,0), subkey at (1,0) ----
  uint32_t nk0, nk1, sk0, sk1;
  threefry2x32((uint32_t)st[K0_], (uint32_t)st[K1_], 0u, 0u, nk0, nk1);
  threefry2x32((uint32_t)st[K0_], (uint32_t)st[K1_], 1u, 0u, sk0, sk1);

  float xp[kVpt], p[kVpt];
  float mm[2] = {INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < kVpt; ++e) {
    const int i = tid + e * kSampThreads;
    xp[e] = -INFINITY;
    if (i < V) {
      float l = __ldcg(lg + i);
      if (isnan(l)) l = -1e9f;
      else if (isinf(l)) l = l > 0.f ? 1e9f : -1e9f;
      const float xv = l / temp;
      x[i] = xv;
      xp[e] = (cnt[i >> 5] >> (i & 31)) & 1 ? (xv < 0.f ? xv * pen : xv / pen) : xv;
      mm[0] = fminf(mm[0], xp[e]);
      mm[1] = fmaxf(mm[1], xp[e]);
    }
  }
  AR_PHASE(19);
  {
    const int ops[2] = {2, 1};
    sreduce<2>(mm, ops, red, rk);
  }
  if (tid == 0) misc[1] = 0;  // every thread read it before that reduction's barrier
  float lo = mm[0] - 1.f, hi = mm[1];
  for (int it = 0; it < kBisect; ++it) {  // top-k; the counts are exact in float32
    const float mid = 0.5f * (lo + hi);
    float c = 0.f;
#pragma unroll
    for (int e = 0; e < kVpt; ++e) c += xp[e] >= mid ? 1.f : 0.f;
    const bool over = sreduce1(c, 0, red, rk) > (float)a.top_k;
    lo = over ? mid : lo;
    hi = over ? hi : mid;
  }
  float tmin = INFINITY;
#pragma unroll
  for (int e = 0; e < kVpt; ++e) tmin = fminf(tmin, xp[e] >= hi ? xp[e] : INFINITY);
  const float thr = sreduce1(tmin, 2, red, rk);
  float tmax = -INFINITY;
#pragma unroll
  for (int e = 0; e < kVpt; ++e) tmax = fmaxf(tmax, xp[e] >= thr ? xp[e] : -INFINITY);
  const float m = sreduce1(tmax, 1, red, rk);
  bool degenerate = !isfinite(m);
  float zs = 0.f;
#pragma unroll
  for (int e = 0; e < kVpt; ++e) {
    p[e] = xp[e] >= thr ? expf(xp[e] - m) : 0.f;
    zs += p[e];
  }
  const float z = fmaxf(sreduce1(zs, 0, red, rk), 1e-30f);
#pragma unroll
  for (int e = 0; e < kVpt; ++e) p[e] = p[e] / z;
  AR_PHASE(20);
  lo = 0.f;
  hi = 1.f;
  for (int it = 0; it < kBisect; ++it) {  // top-p
    const float mid = 0.5f * (lo + hi);
    float sm = 0.f;
#pragma unroll
    for (int e = 0; e < kVpt; ++e) sm += p[e] > mid ? p[e] : 0.f;
    const bool over = sreduce1(sm, 0, red, rk) > top_p;
    lo = over ? mid : lo;
    hi = over ? hi : mid;
  }
  AR_PHASE(21);
  float cmin = INFINITY;
#pragma unroll
  for (int e = 0; e < kVpt; ++e) cmin = fminf(cmin, (xp[e] >= thr && p[e] > lo) ? p[e] : INFINITY);
  const float cthr = sreduce1(cmin, 2, red, rk);
  float r3[3] = {0.f, -INFINITY, -INFINITY};  // mass2, max score, max tempered logit
#pragma unroll
  for (int e = 0; e < kVpt; ++e) {
    const int i = tid + e * kSampThreads;
    if (i < V) {
      const bool keep2 = xp[e] >= thr && (p[e] >= cthr || xp[e] == m);
      r3[0] += keep2 ? p[e] : 0.f;
      uint32_t bits, unused;
      threefry2x32(sk0, sk1, (uint32_t)i, 0u, bits, unused);
      const float u = ((float)(int)(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
      p[e] = keep2 ? xp[e] + (-logf(-logf(u))) : -INFINITY;  // p is dead past here: the scores
      r3[1] = fmaxf(r3[1], p[e]);
      r3[2] = fmaxf(r3[2], x[i]);
    }
  }
  {
    const int ops[3] = {0, 1, 1};
    sreduce<3>(r3, ops, red, rk);
  }
  degenerate = degenerate || r3[0] <= 1e-12f;
  float ix[2] = {(float)V, (float)V};  // first index of the max score / of the max logit
#pragma unroll
  for (int e = 0; e < kVpt; ++e) {
    const int i = tid + e * kSampThreads;
    if (i < V) {
      if (p[e] == r3[1]) ix[0] = fminf(ix[0], (float)i);
      if (x[i] == r3[2]) ix[1] = fminf(ix[1], (float)i);
    }
  }
  {
    const int ops[2] = {2, 2};
    sreduce<2>(ix, ops, red, rk);
  }
  const int tok = (int)(degenerate ? ix[1] : ix[0]);
  if (tid < hl && hist[tid] >= 0 && hist[tid] < V) atomicAnd(&cnt[hist[tid] >> 5], (int)~(1u << (hist[tid] & 31)));
  const int shifted = tid < hl - 1 ? hist[tid + 1] : tok;
  sbar();  // every sampler thread read the history and the scalars
  AR_PHASE(22);
  // bookkeeping (ar_single_step semantics; the row is active)
  if (tid < hl) hist[tid] = shifted;
  if (tid == 0) {
    st[STREAK_] = (tok == st[LAST_] && t > 0) ? st[STREAK_] + 1 : 0;
    st[LAST_] = tok;
    const bool is_eos = tok == a.eos;
    if (is_eos && st[FEOS_] >= a.S) st[FEOS_] = t;
    if (is_eos && t + 1 >= a.min_gen[b]) st[STOPPED_] = 1;
    st[K0_] = (int)nk0;
    st[K1_] = (int)nk1;
    st[T_] = t + 1;
  }
  return tok;
}

// ---- the conv taps ------------------------------------------------------------------

// taps [N][K-1][rg][cwm]: taps j < K-1 of group g's rows for my channels,
// read from the ring buffers in bufs_out at each row's head.
template <typename E>
__device__ __forceinline__ void load_taps(const ArLoopArgs& a, int g, int rg, const Lay& ly, int cwm,
                                          const int* r_head, float* taps) {
  const int Kt = a.K, CTX = a.CTX, D = a.D;
  const int b0 = g * rg, nb = min(rg, a.B - b0);
  const int per = (Kt - 1) * nb * ly.cw;
  const size_t layer_stride = (size_t)a.B * CTX * D;
  for (int i = threadIdx.x; i < a.N * per; i += kConsumers) {
    const int li = i / per, r = i - li * per;
    const int jj = r / (nb * ly.cw), r2 = r - jj * nb * ly.cw;
    const int bl = r2 / ly.cw, c = r2 - bl * ly.cw;
    const int b = b0 + bl, dil = a.dils[li], span = (Kt - 1) * dil + 1;
    const int phys = (r_head[b] + 1 + CTX - span + jj * dil) % CTX;
    taps[(((size_t)li * (Kt - 1) + jj) * rg + bl) * cwm + c] =
        ldcgf<E>(a.bufs_out, li * layer_stride + ((size_t)b * CTX + phys) * D + ly.c0 + c);
  }
}

// ---- the producer warp ------------------------------------------------------------

// One thread: the resident prefix once, then the streamed chunks in order,
// each slot refilled once the consumers released its previous use; at
// `stop` (set by the consumers when they leave) it waits for the copies in
// flight and returns.
__device__ void produce(const char* src, char* res, char* ring, uint64_t* full, uint64_t* empty,
                        uint64_t* resbar, const int* sched, int nchunk, int nres, int esize,
                        volatile int* stop) {
  uint32_t total = 0;
  for (int c = 0; c < nres; ++c) total += (uint32_t)(esize * sched[2 * c + 1]);
  expect_tx(resbar, total);
  for (int c = 0; c < nres; ++c)
    bulk_copy(res + (size_t)esize * sched[2 * c], src + (size_t)esize * sched[2 * c],
              (uint32_t)(esize * sched[2 * c + 1]), resbar);
  const int nstream = nchunk - nres;
  long long ks = 0;
  if (nstream > 0) {
    for (;; ++ks) {
      const int slot = (int)(ks % kRing);
      if (ks >= kRing) {
        const uint32_t parity = (uint32_t)(((ks / kRing) - 1) & 1);
        bool done = false;
        while (!(done = mbar_test(empty + slot, parity)) && !*stop) __nanosleep(64);
        if (!done) break;
      } else if (*stop) {
        break;
      }
      const int c = nres + (int)(ks % nstream);
      const uint32_t bytes = (uint32_t)(esize * sched[2 * c + 1]);
      expect_tx(full + slot, bytes);
      bulk_copy(ring + (size_t)slot * kStage * 4, src + (size_t)esize * sched[2 * c], bytes, full + slot);
    }
  }
  for (long long k = ks > kRing ? ks - kRing : 0; k < ks; ++k)
    mbar_wait(full + k % kRing, (uint32_t)((k / kRing) & 1));
  mbar_wait(resbar, 0u);
}

// ---- the kernel -----------------------------------------------------------------

// kLogitsOnly: K5, one step from a.x_in, logits out, no sampler or state.
// E: the element type of the weights, cond, emb, KV, ring buffers and x_in.
template <typename E, bool kLogitsOnly>
__global__ void __launch_bounds__(kThreads, 1) ar_loop_kernel(const ArLoopArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = gridDim.x, j = blockIdx.x, tid = threadIdx.x;
  const int D = a.D, V = a.V, L = a.L, CTX = a.CTX, B = a.B, N = a.N, Kt = a.K;
  const int hd = D / a.H, rg = a.rg, ng = ceil_div(B, rg);
  const int cwm = ceil_div(D, G), ym = out_width(a, G);
  const Lay ly = layout(a, G, j);
  const Carve cv = carve(a, G, rg, L, res_words<E>(a), a.streamed != 0, a.nchunk_max);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + cv.bars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kRing;
  uint64_t* resbar = bars + 2 * kRing;
  float* xs = smem + cv.x;
  float* hown = smem + cv.hown;
  float* ys = smem + cv.y;
  float* taps = smem + cv.taps;
  float* rpart = smem + cv.rpart;
  float* att = smem + cv.att;
  float* qh = smem + cv.qh;
  float* sc = smem + cv.scale;
  const int fwm = ceil_div(4 * D, G);
  // my biases and taps, loaded once: GLU [N][2][cwm], conv taps [N][K][cwm] and
  // biases [N][cwm], ff1 [N][fwm], ff2 [N][cwm], head [vwm], tanh(gate) [A]
  float* cg = smem + cv.consts;
  float* cdw = cg + (size_t)N * 2 * cwm;
  float* cdwb = cdw + (size_t)N * Kt * cwm;
  float* cf1 = cdwb + (size_t)N * cwm;
  float* cf2 = cf1 + (size_t)N * fwm;
  float* chead = cf2 + (size_t)N * cwm;
  float* cgate = chead + ceil_div(V, G);
  float* red = smem + cv.red;
  float* sred = smem + cv.sred;
  float* lgx = smem + cv.lgx;
  int* cnt = reinterpret_cast<int*>(smem + cv.cnt);
  int* own = reinterpret_cast<int*>(smem + cv.own);
  int* r_t = reinterpret_cast<int*>(smem + cv.rows);
  int* r_last = r_t + B;
  int* r_stop = r_last + B;
  int* r_head = r_stop + B;
  int* r_none = r_head + B;
  int* sched = reinterpret_cast<int*>(smem + cv.sched);
  int* misc = reinterpret_cast<int*>(smem + cv.misc);
  volatile int* stop = misc + 8;
  AR_CLOCK_INIT

  const int nchunk = stream_schedule<E>(a, ly, nullptr, nullptr);
  int nres = 0;
  if (tid == 0) {
    stream_schedule<E>(a, ly, sched, nullptr);
    for (int i = 0; i < 2 * kRing + 1; ++i) {
      const uint32_t count = (i >= kRing && i < 2 * kRing) ? (uint32_t)kWarps : 1u;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bars + i)), "r"(count)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    misc[1] = 0;
    misc[8] = 0;
  }
  __syncthreads();  // the only barrier of all kThreads threads
  for (int tot = 0; nres < nchunk && tot + sched[2 * nres + 1] <= a.res_elems;)  // resident prefix
    tot += sched[2 * nres++ + 1];
  const char* src = reinterpret_cast<const char*>(a.wstream) + sizeof(E) * (size_t)j * a.stream_len;
  if (tid >= kConsumers) {
    if (tid == kConsumers)
      produce(src, reinterpret_cast<char*>(smem + cv.wbuf), reinterpret_cast<char*>(smem + cv.ring),
              full, empty, resbar, sched, nchunk, nres, (int)sizeof(E), stop);
    return;
  }

  // ---- entry (consumers): row facts, my sampler rows, my ring columns ----
  Stream sw{reinterpret_cast<const char*>(smem + cv.wbuf), reinterpret_cast<const char*>(smem + cv.ring),
            full, empty, resbar, sched, nchunk, nres, (int)sizeof(E), 0};
  Xch xc{a.xch, a.xch_half, a.sync, G, 0};
  int rk = 0;
  for (int i = tid; i < (V + 31) / 32; i += kConsumers) cnt[i] = 0;
  for (int b = tid; b < B; b += kConsumers) {
    r_head[b] = 0;
    if constexpr (kLogitsOnly) {
      r_t[b] = 0;
      r_last[b] = 0;
      r_stop[b] = 0;
    } else {
      r_t[b] = a.t_in[b];
      r_last[b] = a.last_in[b];
      r_stop[b] = a.stopped_in[b];
    }
  }
  {
    const int lane = tid & 31, w = tid >> 5;
    for (int b = w; b < B; b += kWarps) {
      int any = 0;
      for (int l = lane; l < L; l += 32) any |= a.mask[(size_t)b * L + l] != 0;
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) r_none[b] = !any;
    }
  }
  if constexpr (!kLogitsOnly) {
    for (int s = 0; s * G + j < B; ++s) {
      const int b = s * G + j;
      int* o = own + s * kOwnInts;
      for (int i = tid; i < a.hist_len; i += kConsumers) o[i] = a.hist_in[(size_t)b * a.hist_len + i];
      if (tid == 0) {
        o[64 + T_] = a.t_in[b];
        o[64 + LAST_] = a.last_in[b];
        o[64 + STREAK_] = a.streak_in[b];
        o[64 + STOPPED_] = a.stopped_in[b];
        o[64 + FEOS_] = a.feos_in[b];
        o[64 + K0_] = (int)(uint32_t)(a.key_in[2 * b] & 0xffffffffLL);
        o[64 + K1_] = (int)(uint32_t)(a.key_in[2 * b + 1] & 0xffffffffLL);
      }
      for (int i = tid; i < a.n_steps; i += kConsumers) a.tokens[(size_t)b * a.n_steps + i] = 0;
    }
  }
  for (int i = tid; i < N * ly.cw; i += kConsumers) {
    const int li = i / ly.cw, c = i - li * ly.cw;
    cg[(li * 2) * cwm + c] = ldf<E>(a.glu_b, (size_t)li * 2 * D + ly.c0 + c);
    cg[(li * 2 + 1) * cwm + c] = ldf<E>(a.glu_b, (size_t)li * 2 * D + D + ly.c0 + c);
    cdwb[li * cwm + c] = ldf<E>(a.dw_b, (size_t)li * D + ly.c0 + c);
    cf2[li * cwm + c] = ldf<E>(a.ff2_b, (size_t)li * D + ly.c0 + c);
  }
  for (int i = tid; i < N * Kt * ly.cw; i += kConsumers) {
    const int lj = i / ly.cw, c = i - lj * ly.cw;
    cdw[lj * cwm + c] = ldf<E>(a.dw_w, (size_t)lj * D + ly.c0 + c);
  }
  for (int i = tid; i < N * ly.fw; i += kConsumers) {
    const int li = i / ly.fw, f = i - li * ly.fw;
    cf1[li * fwm + f] = ldf<E>(a.ff1_b, (size_t)li * 4 * D + ly.f0 + f);
  }
  for (int v = tid; v < ly.vw; v += kConsumers) chead[v] = ldf<E>(a.head_b, ly.v0 + v);
  for (int ai = tid; ai < a.A; ai += kConsumers) cgate[ai] = tanhf(ldf<E>(a.x_gate, ai));
  const size_t layer_stride = (size_t)B * CTX * D;  // one layer of [N, B, CTX, D]
  for (size_t i = tid; i < (size_t)N * B * CTX * ly.cw; i += kConsumers) {
    const size_t row = i / ly.cw;  // (layer, b, slot)
    const size_t g = row * D + ly.c0 + (i - row * ly.cw);
    stf<E>(a.bufs_out, g, ldf<E>(a.bufs_in, g));
  }
  cbar();

  int tap_group = -1;  // the group whose taps `taps` holds

  const float scale_att = 1.f / sqrtf((float)hd);
  const int H = a.H, nc = a.nc;
  int step = 0;
  for (; step < a.n_steps; ++step) {
    if constexpr (!kLogitsOnly) {
      int any = 0;
      for (int b = 0; b < B; ++b) any |= r_t[b] < a.S && r_stop[b] == 0;
      if (!any) break;  // identical in every block
    }
    for (int g = 0; g < ng; ++g) {
      const int b0 = g * rg, nb = min(rg, B - b0);
      if constexpr (!kLogitsOnly) {
        int any = 0;
        for (int bl = 0; bl < nb; ++bl) any |= r_t[b0 + bl] < a.S && r_stop[b0 + bl] == 0;
        if (!any) continue;
      }
      AR_PHASE(0);
      if (tap_group != g) {
        load_taps<E>(a, g, rg, ly, cwm, r_head, taps);
        tap_group = g;
        cbar();
      }
      // ---- x_t = cond[b, t] + emb[prev] (K5: x_in), normed ----
      prefetch_scale<E>(a.norm, 0, D, sc);  // norm_rows' barrier publishes it
      if constexpr (kLogitsOnly) {
        norm_rows<E>(nb, D, xs, sc, hown, ly.c0, ly.cw, cwm, true,
                     [&](int bl, int k) { return ldf<E>(a.x_in, (size_t)(b0 + bl) * D + k); });
      } else {
        norm_rows<E>(nb, D, xs, sc, hown, ly.c0, ly.cw, cwm, true, [&](int bl, int k) {
          const int b = b0 + bl, t = r_t[b];
          const int prev = t == 0 ? V : r_last[b];
          const int tc = t < a.S - 1 ? t : a.S - 1;
          // bfloat16: the sum rounded first, as the TPU kernel
          return rnd<E>(ldf<E>(a.cond, ((size_t)b * a.S + tc) * D + k) + ldf<E>(a.emb, (size_t)prev * D + k));
        });
      }

      for (int li = 0; li < N; ++li) {
        // GLU (my channels) -> ring buffer -> dilated depthwise conv -> h
        AR_PHASE(1);
        dot_slice<E>(sw, 2 * ly.cw, D, nb, xs, ys, ym);
        cbar();
        AR_PHASE(2);
        for (int i = tid; i < nb * ly.cw; i += kConsumers) {
          const int bl = i / ly.cw, c = i - bl * ly.cw, b = b0 + bl;
          const float av = ys[(size_t)bl * ym + c] + cg[(li * 2) * cwm + c];
          const float bv = ys[(size_t)bl * ym + ly.cw + c] + cg[(li * 2 + 1) * cwm + c];
          const float gv = rnd<E>(av * (1.f / (1.f + expf(-bv))));
          const bool act = kLogitsOnly || (r_t[b] < a.S && r_stop[b] == 0);
          if (act)  // the newest value over the oldest slot
            stf<E>(a.bufs_out, li * layer_stride + ((size_t)b * CTX + r_head[b]) * D + ly.c0 + c, gv);
          float acc = 0.f;
#pragma unroll 4
          for (int jj = 0; jj < Kt - 1; ++jj)
            acc = fmaf(cdw[(li * Kt + jj) * cwm + c], taps[(((size_t)li * (Kt - 1) + jj) * rg + bl) * cwm + c], acc);
          acc = fmaf(cdw[(li * Kt + Kt - 1) * cwm + c], gv, acc);
          const float v = hown[(size_t)bl * cwm + c] + (acc + cdwb[li * cwm + c]);
          hown[(size_t)bl * cwm + c] = v;
          xout(xc)[(size_t)bl * D + ly.c0 + c] = v;
        }
        AR_PHASE(3);
        xarrive(xc);
        prefetch_scale<E>(a.ff_norm, (size_t)li * D, D, sc);
        const float* hx = xwait(xc);
        AR_PHASE(4);
        norm_rows<E>(nb, D, xs, sc, hown, 0, 0, cwm, false,
                     [&](int bl, int k) { return __ldcg(hx + (size_t)bl * D + k); });

        // FFN: my hidden columns -> GELU -> my rows of ff2, summed over blocks
        dot_slice<E>(sw, ly.fw, D, nb, xs, ys, ym);
        cbar();
        for (int i = tid; i < nb * ly.fw; i += kConsumers) {
          const int bl = i / ly.fw, c = i - bl * ly.fw;
          const float v = ys[(size_t)bl * ym + c] + cf1[li * fwm + c];
          ys[(size_t)bl * ym + c] = rnd<E>(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
        }
        cbar();
        AR_PHASE(5);
        axpy_slice<E>(sw, ly.fw, D, nb, ys, ym, xout(xc) + (size_t)j * rg * D);
        AR_PHASE(6);
        xarrive(xc);
        const float* px = xwait(xc);
        AR_PHASE(7);
        {  // my channels: the G blocks' partials. An output takes lpo lanes of a warp (as many
           // outputs a warp as spread them over the warps); lane l adds blocks l, l + lpo, ...
           // in turn, then the lanes' butterfly
          const int no = nb * ly.cw, lane = tid & 31, w = tid >> 5;
          int opw = 1;
          while (opw < 32 && opw * kWarps < no) opw *= 2;
          const int lpo = 32 / opw, sub = lane / lpo, l = lane - sub * lpo;
          for (int o0 = w * opw; o0 < no; o0 += kWarps * opw) {
            const int o = o0 + sub, bl = o / max(1, ly.cw), c = o - bl * ly.cw;
            float s = 0.f;
            if (o < no)
#pragma unroll 8
              for (int gg = l; gg < G; gg += lpo) s += __ldcg(px + ((size_t)gg * rg + bl) * D + ly.c0 + c);
            for (int off = lpo / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            if (o < no && l == 0) {
              const float v = hown[(size_t)bl * cwm + c] + (s + cf2[li * cwm + c]);
              hown[(size_t)bl * cwm + c] = v;
              xout(xc)[(size_t)bl * D + ly.c0 + c] = v;
            }
          }
        }
        AR_PHASE(8);
        const bool last = li + 1 == N;
        const bool attn = (li + 1) % a.freq == 0;
        const int ai = li / a.freq;
        xarrive(xc);
        if (attn) prefetch_scale<E>(a.x_nq, (size_t)ai * D, D, sc);
        else prefetch_scale<E>(last ? a.out_norm : a.norm, last ? 0 : (size_t)(li + 1) * D, D, sc);
        hx = xwait(xc);
        AR_PHASE(9);
        if (!attn) {
          norm_rows<E>(nb, D, xs, sc, hown, 0, 0, cwm, false,
                       [&](int bl, int k) { return __ldcg(hx + (size_t)bl * D + k); });
          continue;
        }

        // text cross-attention: q columns, units (row, head, key chunk), combine, x_out
        norm_rows<E>(nb, D, xs, sc, hown, 0, 0, cwm, false,
                     [&](int bl, int k) { return __ldcg(hx + (size_t)bl * D + k); });
        dot_slice<E>(sw, ly.cw, D, nb, xs, ys, ym);
        cbar();
        for (int i = tid; i < nb * ly.cw; i += kConsumers) {
          const int bl = i / ly.cw, c = i - bl * ly.cw;
          xout(xc)[(size_t)bl * D + ly.c0 + c] = ys[(size_t)bl * ym + c];
        }
        AR_PHASE(10);
        xarrive(xc);
        const float* qx = xwait(xc);
        AR_PHASE(11);
        const int lc = ceil_div(L, nc);
        const int units = nb * H * nc;
        float* ax = xout(xc);
        for (int u = j; u < units; u += G) {
          const int bl = u / (H * nc), hh = (u / nc) % H, ci = u % nc, b = b0 + bl;
          const int l0 = ci * lc, l1 = min(L, l0 + lc);
          for (int d = tid; d < hd; d += kConsumers) qh[d] = __ldcg(qx + (size_t)bl * D + hh * hd + d);
          cbar();
          const size_t kv0 = (((size_t)ai * B + b) * H + hh) * L * hd;  // head hh's [L, hd]
          const int sub = tid & 7;  // eight lanes per key row
          for (int lb = l0; lb < l1; lb += kConsumers / 8) {
            const int l = lb + (tid >> 3);
            float s = 0.f;
            if (l < l1)
#pragma unroll 4
              for (int d4 = sub; d4 < hd / 4; d4 += 8)
                s = dot4(*reinterpret_cast<const float4*>(qh + 4 * d4),
                         ldg4<E>(a.kv_k, kv0 + (size_t)l * hd + 4 * d4), s);
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            if (l < l1 && sub == 0) {
              const bool keep = a.mask[(size_t)b * L + l] != 0 || (l == 0 && r_none[b]);
              att[l - l0] = keep ? s * scale_att : -INFINITY;
            }
          }
          cbar();
          float mloc = -INFINITY;
          for (int l = tid; l < l1 - l0; l += kConsumers) mloc = fmaxf(mloc, att[l]);
          const float mx = breduce1(mloc, 1, red, rk);
          float sloc = 0.f;
          for (int l = tid; l < l1 - l0; l += kConsumers) {
            const float e = mx == -INFINITY ? 0.f : expf(att[l] - mx);
            att[l] = e;
            sloc += e;
          }
          const float ssum = breduce1(sloc, 0, red, rk);  // its barrier publishes att
          const int nsplit = max(1, kConsumers / hd);
          for (int idx = tid; idx < hd * nsplit; idx += kConsumers) {
            const int sidx = idx / hd, d = idx - sidx * hd;
            float s = 0.f;
#pragma unroll 8
            for (int l = l0 + sidx; l < l1; l += nsplit)
              s = fmaf(att[l - l0], ldf<E>(a.kv_v, kv0 + (size_t)l * hd + d), s);
            rpart[idx] = s;
          }
          cbar();
          float* dst = ax + (size_t)u * (hd + 2);
          for (int d = tid; d < hd; d += kConsumers) {
            float s = 0.f;
            for (int sidx = 0; sidx < nsplit; ++sidx) s += rpart[sidx * hd + d];
            dst[2 + d] = s;
          }
          if (tid == 0) {
            dst[0] = mx;
            dst[1] = ssum;
          }
          cbar();  // qh, att and rpart are rewritten by the next unit
        }
        AR_PHASE(12);
        xarrive(xc);
        const float* ux = xwait(xc);
        AR_PHASE(13);
        // combine the key chunks of every head: up to 4 chunks, each output loads its chunks' (max,
        // sum, output) in one round; more (long texts, few rows), each (row, head)'s weights and sum
        // are formed once, then every output takes one round of loads
        if (nc <= 4) {
          for (int i = tid; i < nb * D; i += kConsumers) {
            const int bl = i / D, dd = i - bl * D, hh = dd / hd, d = dd - hh * hd;
            const float* up = ux + (size_t)((bl * H + hh) * nc) * (hd + 2);
            float mc[4], sc4[4], oc[4], mx = -INFINITY, ssum = 0.f, o = 0.f;
#pragma unroll
            for (int ci = 0; ci < 4; ++ci)
              if (ci < nc) {
                mc[ci] = __ldcg(up + (size_t)ci * (hd + 2));
                sc4[ci] = __ldcg(up + (size_t)ci * (hd + 2) + 1);
                oc[ci] = __ldcg(up + (size_t)ci * (hd + 2) + 2 + d);
                mx = fmaxf(mx, mc[ci]);
              }
#pragma unroll
            for (int ci = 0; ci < 4; ++ci)
              if (ci < nc) {
                const float w = mc[ci] == -INFINITY ? 0.f : expf(mc[ci] - mx);
                ssum = fmaf(sc4[ci], w, ssum);
                o = fmaf(oc[ci], w, o);
              }
            const float v = o / ssum;
            xs[i] = rnd<E>(isfinite(v) ? v : 0.f);  // NaN scrub
          }
        } else {
          float* cwt = rpart;              // [nb * H * nc] exp(m_c - max)
          float* csum = rpart + nb * H * nc;  // [nb * H]
          for (int t = tid; t < nb * H; t += kConsumers) {
            const float* up = ux + (size_t)t * nc * (hd + 2);
            float mx = -INFINITY, ssum = 0.f;
            if (nc <= 8) {  // one round of loads
              float m8[8], s8[8];
#pragma unroll
              for (int ci = 0; ci < 8; ++ci)
                if (ci < nc) {
                  m8[ci] = __ldcg(up + (size_t)ci * (hd + 2));
                  s8[ci] = __ldcg(up + (size_t)ci * (hd + 2) + 1);
                  mx = fmaxf(mx, m8[ci]);
                }
#pragma unroll
              for (int ci = 0; ci < 8; ++ci)
                if (ci < nc) {
                  const float w = m8[ci] == -INFINITY ? 0.f : expf(m8[ci] - mx);
                  cwt[t * nc + ci] = w;
                  ssum = fmaf(s8[ci], w, ssum);
                }
            } else {
              for (int ci = 0; ci < nc; ++ci) mx = fmaxf(mx, __ldcg(up + (size_t)ci * (hd + 2)));
              for (int ci = 0; ci < nc; ++ci) {
                const float mc = __ldcg(up + (size_t)ci * (hd + 2));
                const float w = mc == -INFINITY ? 0.f : expf(mc - mx);
                cwt[t * nc + ci] = w;
                ssum = fmaf(__ldcg(up + (size_t)ci * (hd + 2) + 1), w, ssum);
              }
            }
            csum[t] = ssum;
          }
          cbar();
          for (int i = tid; i < nb * D; i += kConsumers) {
            const int bl = i / D, dd = i - bl * D, hh = dd / hd, d = dd - hh * hd, t = bl * H + hh;
            const float* up = ux + (size_t)t * nc * (hd + 2) + 2 + d;
            float o = 0.f;
#pragma unroll 8
            for (int ci = 0; ci < nc; ++ci) o = fmaf(__ldcg(up + (size_t)ci * (hd + 2)), cwt[t * nc + ci], o);
            const float v = o / csum[t];
            xs[i] = rnd<E>(isfinite(v) ? v : 0.f);  // NaN scrub
          }
        }
        cbar();
        dot_slice<E>(sw, ly.cw, D, nb, xs, ys, ym);
        cbar();
        {
          const float gate = cgate[ai];
          for (int i = tid; i < nb * ly.cw; i += kConsumers) {
            const int bl = i / ly.cw, c = i - bl * ly.cw;
            const float v = hown[(size_t)bl * cwm + c] + gate * ys[(size_t)bl * ym + c];
            hown[(size_t)bl * cwm + c] = v;
            xout(xc)[(size_t)bl * D + ly.c0 + c] = v;
          }
        }
        AR_PHASE(14);
        xarrive(xc);
        prefetch_scale<E>(last ? a.out_norm : a.norm, last ? 0 : (size_t)(li + 1) * D, D, sc);
        hx = xwait(xc);
        AR_PHASE(9);
        norm_rows<E>(nb, D, xs, sc, hown, 0, 0, cwm, false,
                     [&](int bl, int k) { return __ldcg(hx + (size_t)bl * D + k); });
      }

      // ---- head (xs is the output norm of h): my logits ----
      AR_PHASE(15);
      dot_slice<E>(sw, ly.vw, D, nb, xs, ys, ym);
      cbar();
      if constexpr (kLogitsOnly) {  // K5: my logit columns out
        for (int i = tid; i < nb * ly.vw; i += kConsumers) {
          const int bl = i / ly.vw, c = i - bl * ly.vw;
          a.logits[(size_t)(b0 + bl) * V + ly.v0 + c] = ys[(size_t)bl * ym + c] + chead[c];
        }
        for (int bl = tid; bl < nb; bl += kConsumers) r_head[b0 + bl] = (r_head[b0 + bl] + 1) % CTX;
        cbar();
        continue;
      } else {
        for (int i = tid; i < nb * ly.vw; i += kConsumers) {
          const int bl = i / ly.vw, c = i - bl * ly.vw;
          xout(xc)[(size_t)bl * V + ly.v0 + c] = ys[(size_t)bl * ym + c] + chead[c];
        }
        AR_PHASE(16);
        xarrive(xc);
        const float* lx = xwait(xc);
        AR_PHASE(17);
        // ---- my rows of the group: sample, publish (t, last, stopped) ----
        for (int s = 0; s * G + j < B; ++s) {
          const int b = s * G + j;
          if (b < b0 || b >= b0 + nb) continue;
          int* o = own + s * kOwnInts;
          const bool act = o[64 + T_] < a.S && o[64 + STOPPED_] == 0;
          if (act) {
            const int tok = sample_row(a, b, lx + (size_t)(b - b0) * V, o, cnt, lgx, sred, misc);
            if (tid == 0) a.tokens[(size_t)b * a.n_steps + step] = tok;
          }
          if (tid == 0) {
            int* tx = reinterpret_cast<int*>(xout(xc)) + (size_t)(b - b0) * 4;
            tx[0] = o[64 + T_];
            tx[1] = o[64 + LAST_];
            tx[2] = o[64 + STOPPED_];
          }
        }
        AR_PHASE(18);
        xarrive(xc);
        // the ring heads move on for the rows that ran; then the next group's taps
        for (int b = b0 + tid; b < b0 + nb; b += kConsumers)
          if (r_t[b] < a.S && r_stop[b] == 0) r_head[b] = (r_head[b] + 1) % CTX;
        cbar();
        load_taps<E>(a, (g + 1) % ng, rg, ly, cwm, r_head, taps);
        tap_group = (g + 1) % ng;
        const int* tx = reinterpret_cast<const int*>(xwait(xc));
        for (int bl = tid; bl < nb; bl += kConsumers) {
          r_t[b0 + bl] = __ldcg(tx + (size_t)bl * 4);
          r_last[b0 + bl] = __ldcg(tx + (size_t)bl * 4 + 1);
          r_stop[b0 + bl] = __ldcg(tx + (size_t)bl * 4 + 2);
        }
        cbar();
      }
    }
  }
  AR_PHASE(30);
  if (tid == 0) *stop = 1;

  // ---- exit: state out (my sampler rows), my ring columns oldest-first ----
  if constexpr (!kLogitsOnly) {
    for (int s = 0; s * G + j < B; ++s) {
      const int b = s * G + j;
      const int* o = own + s * kOwnInts;
      for (int i = tid; i < a.hist_len; i += kConsumers) a.hist_out[(size_t)b * a.hist_len + i] = o[i];
      if (tid == 0) {
        a.t_out[b] = o[64 + T_];
        a.last_out[b] = o[64 + LAST_];
        a.streak_out[b] = o[64 + STREAK_];
        a.stopped_out[b] = o[64 + STOPPED_];
        a.feos_out[b] = o[64 + FEOS_];
        a.key_out[2 * b] = (long long)(uint32_t)o[64 + K0_];
        a.key_out[2 * b + 1] = (long long)(uint32_t)o[64 + K1_];
      }
    }
  }
  if (ly.cw > 0) {
    const int col = CTX * ly.cw;  // one (layer, row): CTX slots of my channels
    const int np = max(1, rg * D / col);
    for (int p0 = 0; p0 < N * B; p0 += np) {
      const int pn = min(np, N * B - p0);
      for (int i = tid; i < pn * col; i += kConsumers) {
        const int pp = i / col, r = i - pp * col, slot = r / ly.cw, c = r - slot * ly.cw;
        const int li = (p0 + pp) / B, b = (p0 + pp) - li * B;
        xs[i] = ldcgf<E>(a.bufs_out, li * layer_stride + ((size_t)b * CTX + slot) * D + ly.c0 + c);
      }
      cbar();
      for (int i = tid; i < pn * col; i += kConsumers) {
        const int pp = i / col, r = i - pp * col, slot = r / ly.cw, c = r - slot * ly.cw;
        const int li = (p0 + pp) / B, b = (p0 + pp) - li * B;
        const int from = (r_head[b] + slot) % CTX;
        stf<E>(a.bufs_out, li * layer_stride + ((size_t)b * CTX + slot) * D + ly.c0 + c,
               xs[(size_t)pp * col + from * ly.cw + c]);
      }
      cbar();
    }
  }
}

// The kernel's launch for these args: checks, the plan, and the launch
// configuration (G = the SM count, cooperative). false (cfg untouched)
// where the shapes do not fit.
template <typename T, bool kLogitsOnly>
cudaError_t configure(ArLoopArgs& a, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int& G,
                      bool& ok, int* len_max = nullptr) {
  ok = false;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&G, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (a.B > kMaxOwn * G) return cudaSuccess;
  if (!plan<T>(a, G, len_max)) return cudaSuccess;
  if ((size_t)a.CTX * ceil_div(a.D, G) > (size_t)a.rg * a.D) return cudaSuccess;  // the exit's rotation
  if ((size_t)a.rg * a.H * (a.nc + 1) > kConsumers) return cudaSuccess;  // the combine's weights
  const size_t smem = carve(a, G, a.rg, a.L, res_words<T>(a), a.streamed != 0, a.nchunk_max).total * 4;
  if (smem > kMaxSmem) return cudaSuccess;
  auto kernel = ar_loop_kernel<T, kLogitsOnly>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaSuccess;
  cfg.gridDim = dim3((unsigned)G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeCooperative;  // every block resident at once, or no launch
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  ok = true;
  return cudaSuccess;
}

template <typename T>
int check_args(const ArLoopArgs& a) {
  if (a.B <= 0 || a.N <= 0 || a.N > kMaxLayers || a.H <= 0 || a.D % a.H != 0 ||
      (a.D / a.H) % 4 != 0 || a.D / a.H > kConsumers || a.D % 8 != 0 || a.D > 1024 || a.D > kStageElems<T> ||
      a.V <= 0 || a.V > kVpt * kSampThreads || a.Vp < a.V || a.L <= 0 || a.S <= 0 || a.freq <= 0 ||
      a.CTX <= 0 || a.K < 2 || a.hist_len < 32 || a.hist_len > 64 || a.n_steps < 0)
    return (int)cudaErrorInvalidValue;
  for (int li = 0; li < a.N; ++li)
    if ((a.K - 1) * a.dils[li] + 1 > a.CTX) return (int)cudaErrorInvalidValue;
  return 0;
}

// Launches the kernel for a.B rows over the card (the stream packed for
// a.grid blocks). Returns cudaGetLastError() after the launch, or an error
// code for unsupported shapes.
template <typename T, bool kLogitsOnly>
int launch(const ArLoopArgs& in, void* stream) {
  int rc = check_args<T>(in);
  if (rc != 0) return rc;
  if (in.wstream == nullptr || in.xch == nullptr || in.sync == nullptr) return (int)cudaErrorInvalidValue;
  ArLoopArgs a = in;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int G = 0, len_max = 0;
  bool ok = false;
  cudaError_t e = configure<T, kLogitsOnly>(a, cfg, attr, G, ok, &len_max);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  if (a.grid != G || a.stream_len != len_max || a.xch_half > in.xch_half) return (int)cudaErrorInvalidValue;
  cfg.stream = (cudaStream_t)stream;
  e = cudaMemsetAsync(a.sync, 0, sizeof(unsigned long long), cfg.stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, ar_loop_kernel<T, kLogitsOnly>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch facts for these args: out = [grid blocks, rows per group,
// groups, waves (1: every block resident), shared memory bytes a block,
// resident chunks of block 0, chunks of block 0, exchange floats a half,
// streamed (0/1), key chunks].
template <typename T, bool kLogitsOnly>
int launch_info(const ArLoopArgs& in, int* out) {
  int rc = check_args<T>(in);
  if (rc != 0) return rc;
  ArLoopArgs a = in;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int G = 0;
  bool ok = false;
  cudaError_t e = configure<T, kLogitsOnly>(a, cfg, attr, G, ok);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  int sched[2 * 256];
  const Lay l0 = layout(a, G, 0);
  int len = 0;
  const int n0 = stream_schedule<T>(a, l0, nullptr, &len);
  int nres = 0;
  if (n0 <= 256) {
    stream_schedule<T>(a, l0, sched, nullptr);
    int tot = 0;
    while (nres < n0 && tot + sched[2 * nres + 1] <= a.res_elems) tot += sched[2 * nres++ + 1];
  }
  out[0] = G;
  out[1] = a.rg;
  out[2] = ceil_div(a.B, a.rg);
  out[3] = 1;
  out[4] = (int)cfg.dynamicSmemBytes;
  out[5] = nres;
  out[6] = n0;
  out[7] = (int)a.xch_half;
  out[8] = a.streamed;
  out[9] = a.nc;
  return 0;
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
struct LaunchInfo {
  static int run(const ArLoopArgs& a, int* out) { return launch_info<T, L>(a, out); }
};

}  // namespace

// The launch facts of K1 or K5 (`mode`: bit 0 K5, bit 1 bfloat16) for these
// shapes on the current device (see `launch_info`, 10 ints). Returns 0 or an
// error code.
extern "C" int sopro_ar_launch_info(const ArLoopArgs* args, int mode, int* out) {
  return by_mode<LaunchInfo>(mode, *args, out);
}

// The number of blocks K1 or K5 (`mode` as above) launches for these args on
// the current device: the weight stream is packed for it. Returns 0 or an
// error code.
extern "C" int sopro_ar_cluster(const ArLoopArgs* args, int mode, int* blocks_out) {
  int out[10];
  const int rc = sopro_ar_launch_info(args, mode, out);
  if (rc == 0) *blocks_out = out[0];
  return rc;
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
