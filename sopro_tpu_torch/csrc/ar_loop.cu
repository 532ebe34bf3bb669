// Kernel K1: the AR decode loop, n_steps steps in one launch, float32.
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
// 3.1 MB head) for ~21 MFLOP, so it is bound by how fast the weights come out
// of L2 (they stay resident in the 50 MB L2 across steps), then by the
// barriers between the dependent matrix-vector products and by the ~60
// block-wide reductions of the sampler. One block per row would stream the
// weights through a single SM; instead each row runs on a thread-block
// cluster of CS blocks (16 where the card schedules it, else 8, ...) that
// split every product across CS SMs and exchange the pieces through
// distributed shared memory:
//   * GLU columns and the depthwise conv by channel: block r owns channels
//     [r*D/CS, (r+1)*D/CS), their ring-buffer columns (in shared memory
//     behind a rotating head, written back oldest-first at exit), their
//     biases and taps, and their conv output, which it pushes to every block;
//   * FFN: block r computes its 4D/CS hidden columns, applies GELU, and
//     multiplies them by its rows of ff2 -- a partial [D] sum that every
//     block adds up in rank order (no hidden-vector exchange);
//   * attention: block r computes its D/CS query columns (pushed to every
//     block), then the softmax over the text for the head(s) its rows of the
//     output projection belong to, and multiplies its slice of the attention
//     output by those rows: again a partial [D] sum;
//   * head: block r computes V/CS logits and pushes them.
// That is two cluster barriers per SSMLite block, two per attention and one
// for the head. RMSNorms and the sampler run redundantly in every block on
// identical data, so every block holds the same state; rank 0 writes the
// outputs. The count grid is rebuilt from the history at entry, as the TPU
// kernel does. The sampler mirrors the JAX op sequence op for op, so tokens
// equal the plain path except at genuine near-ties.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kMaxLayers = 16;
constexpr int kBisect = 26;

// Mirrored field for field by `_Args` in ops/ar_loop.py.
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
__device__ float block_reduce(float v, int op, Red& R) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = op == 0 ? warp_sum(v) : (op == 1 ? warp_max(v) : warp_min(v));
  float* buf = R.f + (R.k++ & 1) * 32;
  if (lane == 0) buf[wid] = v;
  __syncthreads();
  const float ident = op == 0 ? 0.f : (op == 1 ? -INFINITY : INFINITY);
  const float u = lane < (int)(blockDim.x >> 5) ? buf[lane] : ident;
  return op == 0 ? warp_sum(u) : (op == 1 ? warp_max(u) : warp_min(u));
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

// y = scale * x * rsqrt(mean(x^2) + 1e-6), over n entries in shared memory
__device__ void rmsnorm(const float* x, const float* __restrict__ scale, float* y, int n,
                        Red& red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += x[i] * x[i];
  s = block_reduce(s, 0, red);
  const float inv = rsqrtf(s / (float)n + 1e-6f);
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = x[i] * inv * __ldg(scale + i);
  __syncthreads();
}

// out[c] = sum_{i < n_in} x[i] * W[i * ldw + col(c)] for c < ncols (x and
// out in shared memory), where columns c < split start at col0 and the rest
// at col1 (one product over two column ranges); WIDTH columns per thread
// (4: float4 loads).
// Neighbouring threads take neighbouring columns (coalesced rows); the input
// range is split over G thread groups whose partial sums (`part`, >= 4 *
// blockDim.x floats) are folded by up to 32 lanes per column with shuffles,
// in a fixed order.
template <int WIDTH>
__device__ void gemv_impl(const float* __restrict__ W, int ldw, const float* x, int n_in,
                          int col0, int col1, int split, int ncols, float* out, float* part) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ngrp = ncols / WIDTH, gsplit = split / WIDTH;
  const int G = max(1, nt / ngrp);
  for (int idx = tid; idx < ngrp * G; idx += nt) {
    const int g = idx / ngrp, c = idx - g * ngrp;
    const float* wp = W + (c < gsplit ? col0 + c * WIDTH : col1 + (c - gsplit) * WIDTH);
    float acc[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int i = g; i < n_in; i += G) {
      const float xv = x[i];
      if constexpr (WIDTH == 4) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(wp + (size_t)i * ldw));
        acc[0] = fmaf(xv, w.x, acc[0]);
        acc[1] = fmaf(xv, w.y, acc[1]);
        acc[2] = fmaf(xv, w.z, acc[2]);
        acc[3] = fmaf(xv, w.w, acc[3]);
      } else {
        acc[0] = fmaf(xv, __ldg(wp + (size_t)i * ldw), acc[0]);
      }
    }
    float* dst = (G == 1 ? out : part + (size_t)g * ncols) + c * WIDTH;
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) dst[k] = acc[k];
  }
  __syncthreads();
  if (G > 1) {
    int tpc = 1;  // lanes per output column: a power of two <= 32
    while (tpc < 32 && ncols * tpc * 2 <= nt) tpc *= 2;
    const int rounds = (ncols * tpc + nt - 1) / nt;
    for (int rd = 0; rd < rounds; ++rd) {
      const int idx = rd * nt + tid;
      const int c = idx / tpc, lane = idx % tpc;
      float s = 0.f;
      if (c < ncols)
        for (int g = lane; g < G; g += tpc) s += part[(size_t)g * ncols + c];
      for (int o = tpc >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (c < ncols && lane == 0) out[c] = s;
    }
    __syncthreads();
  }
}

__device__ void gemv_cols2(const float* __restrict__ W, int ldw, const float* x, int n_in,
                           int col0, int col1, int split, int ncols, float* out, float* part) {
  if (ncols <= 0) return;  // block-uniform
  if (((ldw | col0 | col1 | split | ncols) & 3) == 0)
    gemv_impl<4>(W, ldw, x, n_in, col0, col1, split, ncols, out, part);
  else
    gemv_impl<1>(W, ldw, x, n_in, col0, col1, split, ncols, out, part);
}

__device__ void gemv_cols(const float* __restrict__ W, int ldw, const float* x, int n_in,
                          int col0, int ncols, float* out, float* part) {
  gemv_cols2(W, ldw, x, n_in, col0, col0 + ncols, ncols, ncols, out, part);
}

// Write src[0..n) to dst[0..n) in the shared memory of every block of the
// cluster (this one included); the caller's cluster barrier publishes it.
__device__ void push(cg::cluster_group& cl, float* dst, const float* src, int n, int cs) {
  for (int idx = threadIdx.x; idx < cs * n; idx += blockDim.x) {
    const int rr = idx / n, i = idx - rr * n;
    cl.map_shared_rank(dst, rr)[i] = src[i];
  }
}

struct Layout {
  int cs, cw, fw, vw;  // cluster size; channels, FFN columns, logits per block
};

__host__ __device__ Layout layout(const ArLoopArgs& a, int cs) {
  Layout l;
  l.cs = cs;
  l.cw = a.D / cs;
  l.fw = 4 * a.D / cs;
  l.vw = ((a.Vp + cs - 1) / cs + 3) / 4 * 4;
  return l;
}

__host__ __device__ size_t smem_floats(const ArLoopArgs& a, const Layout& l) {
  const size_t loc = (size_t)(l.fw > l.vw ? l.fw : l.vw);
  const size_t mine = (size_t)a.N * (a.CTX + 3 + a.K) * l.cw + (size_t)a.N * l.fw;
  return 7 * (size_t)a.D + loc + 2 * (size_t)l.cs * a.D + (size_t)a.L + 3 * (size_t)a.V +
         4 * (size_t)kThreads + 64 + mine;
}

__global__ void __launch_bounds__(kThreads, 1) ar_loop_kernel(const ArLoopArgs a) {
  extern __shared__ float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks();
  const int r = (int)cl.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int D = a.D, V = a.V, L = a.L, CTX = a.CTX;
  const int hd = D / a.H;
  const Layout lay = layout(a, cs);
  const int c0 = r * lay.cw;                            // my channels
  const int f0 = r * lay.fw;                            // my FFN columns
  const int v0 = min(a.Vp, r * lay.vw), v1 = min(a.Vp, v0 + lay.vw);  // my logits (padded)
  const int v1r = min(V, v1);                                        // ... of which real

  // ---- shared memory (identical layout in every block of the cluster) ----
  float* h = smem;                 // [D] residual stream
  float* hn = h + D;               // [D] normed
  float* gab = hn + D;             // [2D] GLU a then b columns (mine)
  float* cbuf = gab + 2 * D;       // [D] conv output, gathered; my rows of the attention output
  float* yl = cbuf + D;            // [D] my partial / my slice before a push
  float* q = yl + D;               // [D] attention query, gathered
  float* loc = q + D;              // [max(fw, vw)] my FFN hidden / my logits
  float* pbuf = loc + max(lay.fw, lay.vw);  // [cs][D] FFN partials, by rank
  float* pbuf2 = pbuf + (size_t)cs * D;     // [cs][D] attention partials, by rank
  float* att = pbuf2 + (size_t)cs * D;      // [L] attention weights of one head
  float* lg = att + L;             // [V] logits -> x (tempered)
  float* xp = lg + V;              // [V] penalized
  float* p = xp + V;               // [V] probabilities, then scores
  float* part = p + V;             // [4 * kThreads] gemv partial sums
  float* ringS = part + 4 * kThreads;                    // [N][CTX][cw] my ring columns
  float* glubS = ringS + (size_t)a.N * CTX * lay.cw;      // [N][2][cw] my GLU biases
  float* dwS = glubS + (size_t)a.N * 2 * lay.cw;          // [N][K][cw] my conv taps
  float* dwbS = dwS + (size_t)a.N * a.K * lay.cw;         // [N][cw] my conv biases
  float* ff1bS = dwbS + (size_t)a.N * lay.cw;             // [N][fw] my FFN hidden biases
  Red red;
  red.f = ff1bS + (size_t)a.N * lay.fw;  // [64] reduction partials
  int* cnt = (int*)(red.f + 64);   // [V] penalty count grid
  int* hist = cnt + V;             // [hist_len]
  red.i = hist + a.hist_len;       // [64]
  red.k = 0;
  int* st = red.i + 64;            // scalar state
  enum { T = 0, LAST, STREAK, STOPPED, FEOS, K0, K1, HEAD, REC, NONE_VALID };

  const size_t layer_stride = (size_t)a.B * CTX * D;  // one layer of [N, B, CTX, D]
  const float* bufs_in = a.bufs_in + (size_t)b * CTX * D;
  float* bufs_out = a.bufs_out + (size_t)b * CTX * D;

  // ---- entry: state, count grid, my ring columns ----
  for (int i = tid; i < V; i += nt) cnt[i] = 0;
  if (tid == 0) {
    st[T] = a.t_in[b];
    st[LAST] = a.last_in[b];
    st[STREAK] = a.streak_in[b];
    st[STOPPED] = a.stopped_in[b];
    st[FEOS] = a.feos_in[b];
    st[K0] = (int)(uint32_t)(a.key_in[2 * b] & 0xffffffffLL);
    st[K1] = (int)(uint32_t)(a.key_in[2 * b + 1] & 0xffffffffLL);
    st[HEAD] = 0;
    int any = 0;
    for (int l = 0; l < L; ++l) any |= a.mask[(size_t)b * L + l] != 0;
    st[NONE_VALID] = !any;
  }
  for (int i = tid; i < a.hist_len; i += nt) hist[i] = a.hist_in[(size_t)b * a.hist_len + i];
  for (int li = 0; li < a.N; ++li) {
    for (int i = tid; i < CTX * lay.cw; i += nt) {
      const int j = i / lay.cw, c = i - j * lay.cw;
      ringS[((size_t)li * CTX + j) * lay.cw + c] = bufs_in[li * layer_stride + (size_t)j * D + c0 + c];
    }
    for (int c = tid; c < lay.cw; c += nt) {
      glubS[(li * 2) * lay.cw + c] = a.glu_b[(size_t)li * 2 * D + c0 + c];
      glubS[(li * 2 + 1) * lay.cw + c] = a.glu_b[(size_t)li * 2 * D + D + c0 + c];
      dwbS[li * lay.cw + c] = a.dw_b[(size_t)li * D + c0 + c];
    }
    for (int i = tid; i < a.K * lay.cw; i += nt) {
      const int j = i / lay.cw, c = i - j * lay.cw;
      dwS[((size_t)li * a.K + j) * lay.cw + c] = a.dw_w[((size_t)li * a.K + j) * D + c0 + c];
    }
    for (int c = tid; c < lay.fw; c += nt) ff1bS[li * lay.fw + c] = a.ff1_b[(size_t)li * 4 * D + f0 + c];
  }
  __syncthreads();
  for (int i = tid; i < a.hist_len; i += nt)
    if (hist[i] >= 0 && hist[i] < V) atomicAdd(&cnt[hist[i]], 1);
  cl.sync();  // every block has started before any shared memory is pushed

  const float pen = a.rep_pen;
  const float scale_att = 1.f / sqrtf((float)hd);
  int step = 0;
  for (; step < a.n_steps; ++step) {
    const int t = st[T];
    if (!(t < a.S && st[STOPPED] == 0)) break;  // identical in every block

    // ---- x_t = cond[b, t] + emb[prev] ----
    const int prev = t == 0 ? V : st[LAST];
    const int tc = t < a.S - 1 ? t : a.S - 1;
    for (int i = tid; i < D; i += nt)
      h[i] = a.cond[((size_t)b * a.S + tc) * D + i] + a.emb[(size_t)prev * D + i];
    const int head = st[HEAD];
    __syncthreads();

    for (int li = 0; li < a.N; ++li) {
      // GLU (my channels) -> ring buffer -> dilated depthwise conv
      rmsnorm(h, a.norm + (size_t)li * D, hn, D, red);
      gemv_cols2(a.glu_w + (size_t)li * D * 2 * D, 2 * D, hn, D, c0, D + c0, lay.cw,
                 2 * lay.cw, gab, part);
      float* rl = ringS + (size_t)li * CTX * lay.cw;
      const float* gbias = glubS + li * 2 * lay.cw;
      const int dil = a.dils[li];
      const int span = (a.K - 1) * dil + 1;
      for (int c = tid; c < lay.cw; c += nt) {
        const float av = gab[c] + gbias[c];
        const float bv = gab[lay.cw + c] + gbias[lay.cw + c];
        rl[head * lay.cw + c] = av * (1.f / (1.f + expf(-bv)));  // newest -> oldest slot
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
      push(cl, cbuf + c0, yl, lay.cw, cs);
      cl.sync();
      for (int i = tid; i < D; i += nt) h[i] += cbuf[i];
      __syncthreads();

      // FFN: my hidden columns -> GELU -> my rows of ff2, summed over ranks
      rmsnorm(h, a.ff_norm + (size_t)li * D, hn, D, red);
      gemv_cols(a.ff1_w + (size_t)li * D * 4 * D, 4 * D, hn, D, f0, lay.fw, loc, part);
      for (int c = tid; c < lay.fw; c += nt) {
        const float v = loc[c] + ff1bS[li * lay.fw + c];
        loc[c] = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      }
      __syncthreads();
      gemv_cols(a.ff2_w + ((size_t)li * 4 * D + f0) * D, D, loc, lay.fw, 0, D, yl, part);
      push(cl, pbuf + (size_t)r * D, yl, D, cs);
      cl.sync();
      for (int i = tid; i < D; i += nt) {
        float s = 0.f;
        for (int rr = 0; rr < cs; ++rr) s += pbuf[(size_t)rr * D + i];
        h[i] += s + __ldg(a.ff2_b + (size_t)li * D + i);
      }
      __syncthreads();

      if ((li + 1) % a.freq == 0) {  // text cross-attention, sliced like the channels
        const int ai = li / a.freq;
        rmsnorm(h, a.x_nq + (size_t)ai * D, hn, D, red);
        gemv_cols(a.x_q + (size_t)ai * D * D, D, hn, D, c0, lay.cw, yl, part);
        push(cl, q + c0, yl, lay.cw, cs);  // q columns [c0, c0 + cw) -> everyone
        cl.sync();
        // attention output for the heads my rows of x_out belong to
        for (int hh = c0 / hd; hh <= (c0 + lay.cw - 1) / hd; ++hh) {
          const float* kk = a.kv_k + (((size_t)ai * a.B + b) * a.H + hh) * L * hd;
          const float* vv = a.kv_v + (((size_t)ai * a.B + b) * a.H + hh) * L * hd;
          const float* qh = q + hh * hd;
          const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
          for (int l = wid; l < L; l += nw) {  // one warp per key row
            float s = 0.f;
            for (int d = lane; d < hd; d += 32) s = fmaf(qh[d], __ldg(kk + (size_t)l * hd + d), s);
            s = warp_sum(s);
            const bool keep = a.mask[(size_t)b * L + l] != 0 || (l == 0 && st[NONE_VALID]);
            if (lane == 0) att[l] = keep ? s * scale_att : -INFINITY;
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
          const int nsplit = max(1, nt / hd);  // (dim, key chunk) threads
          for (int idx = tid; idx < hd * nsplit; idx += nt) {
            const int sidx = idx / hd, d = idx - sidx * hd;
            float s = 0.f;
#pragma unroll 4
            for (int l = sidx; l < L; l += nsplit)
              s = fmaf(att[l] / ssum, __ldg(vv + (size_t)l * hd + d), s);
            part[idx] = s;
          }
          __syncthreads();
          for (int i = tid; i < lay.cw; i += nt) {  // my rows that belong to head hh
            const int row = c0 + i;
            if (row / hd != hh) continue;
            float s = 0.f;
            for (int sidx = 0; sidx < nsplit; ++sidx) s += part[sidx * hd + row - hh * hd];
            cbuf[i] = isfinite(s) ? s : 0.f;  // NaN scrub
          }
          __syncthreads();
        }
        gemv_cols(a.x_out + ((size_t)ai * D + c0) * D, D, cbuf, lay.cw, 0, D, yl, part);
        push(cl, pbuf2 + (size_t)r * D, yl, D, cs);
        cl.sync();
        const float gate = tanhf(__ldg(a.x_gate + ai));
        for (int i = tid; i < D; i += nt) {
          float s = 0.f;
          for (int rr = 0; rr < cs; ++rr) s += pbuf2[(size_t)rr * D + i];
          h[i] += gate * s;
        }
        __syncthreads();
      }
    }

    // ---- head: my logits, pushed to every block ----
    rmsnorm(h, a.out_norm, hn, D, red);
    gemv_cols(a.head_w, a.Vp, hn, D, v0, v1 - v0, loc, part);
    for (int c = tid; c < v1r - v0; c += nt) loc[c] += __ldg(a.head_b + v0 + c);
    __syncthreads();
    push(cl, lg + v0, loc, max(0, v1r - v0), cs);
    cl.sync();

    // ---- anti-loop settings ----
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
    float lo = block_reduce(vmin, 2, red) - 1.f;
    float hi = block_reduce(vmax, 1, red);
    for (int it = 0; it < kBisect; ++it) {
      const float mid = 0.5f * (lo + hi);
      int c = 0;
      for (int i = tid; i < V; i += nt) c += xp[i] >= mid;
      const bool over = block_reduce_i(c, 0, red) > a.top_k;
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
    lo = 0.f;
    hi = 1.f;
    for (int it = 0; it < kBisect; ++it) {
      const float mid = 0.5f * (lo + hi);
      float s = 0.f;
      for (int i = tid; i < V; i += nt) s += p[i] > mid ? p[i] : 0.f;
      const bool over = block_reduce(s, 0, red) > top_p;
      lo = over ? mid : lo;
      hi = over ? hi : mid;
    }
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

  // ---- exit: tokens of skipped steps, state out, my ring columns ----
  if (r == 0) {
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
  for (int li = 0; li < a.N; ++li)
    for (int i = tid; i < CTX * lay.cw; i += nt) {
      const int j = i / lay.cw, c = i - j * lay.cw;
      bufs_out[li * layer_stride + (size_t)j * D + c0 + c] =
          ringS[((size_t)li * CTX + (head + j) % CTX) * lay.cw + c];
    }
  cl.sync();  // no block leaves while a peer could still address its shared memory
}

}  // namespace

// Runs a.n_steps decode steps for a.B rows, one thread-block cluster per row.
// Returns cudaGetLastError() after the launch (or an error code for
// unsupported shapes). `cluster_out` (nullable) receives the cluster size.
extern "C" int sopro_ar_loop(const ArLoopArgs* args, int* cluster_out, void* stream) {
  const ArLoopArgs& a = *args;
  if (a.B <= 0 || a.N <= 0 || a.N > kMaxLayers || a.H <= 0 || a.D % a.H != 0 || a.V <= 0 ||
      a.Vp < a.V || a.Vp % 4 != 0 ||
      a.L <= 0 || a.S <= 0 || a.freq <= 0 || a.CTX <= 0 || a.hist_len < 32 || a.hist_len > 64)
    return (int)cudaErrorInvalidValue;
  for (int li = 0; li < a.N; ++li)
    if ((a.K - 1) * a.dils[li] + 1 > a.CTX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ar_loop_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  for (int cs = 16; cs >= 1; cs /= 2) {
    if (a.D % cs != 0) continue;
    const Layout lay = layout(a, cs);
    if (lay.cw * a.K > 4 * kThreads) continue;  // conv products must fit `part`
    const size_t ints = (size_t)a.V + a.hist_len + 64 + 16;
    const size_t smem = (smem_floats(a, lay) + ints) * 4;
    e = cudaFuncSetAttribute(ar_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(a.B * cs));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, ar_loop_kernel, &cfg) != cudaSuccess ||
        clusters <= 0) {
      (void)cudaGetLastError();  // clear the refusal and try a smaller cluster
      continue;
    }
    if (cluster_out != nullptr) *cluster_out = cs;
    e = cudaLaunchKernelEx(&cfg, ar_loop_kernel, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidConfiguration;
}
