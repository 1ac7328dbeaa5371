// Fused 3D window attention, forward (inference): local windows (K1) and
// GC-ViT's global-query windows (K6).
//
// K1 replaces the TPU kernel medicalsemseg_tpu/ops/pallas/window_attention.py:
// fused_window_attention (_kernel, _window_mask). Per window of N = ws^3
// tokens: optional fp32 LayerNorm -> QKV projection (fp32 accumulation,
// + bias in fp32, then bf16) -> per head q.k^T * hd^-0.5 in fp32 + relative
// position bias + shifted-window mask (-100 where pre-shift region labels
// differ) -> fp32 softmax -> bf16 -> .V -> bf16 -> output projection
// (+ bias in fp32, then bf16) -> optional bf16 shortcut add. The rounding
// points are the TPU kernel's. The element type T of the activations and
// weights is bf16, fp16 or fp32, as the JAX kernel takes its input's dtype:
// "bf16" above stands for T, and in fp32 the roundings are the identity.
//
// Design. Two launches:
//  1. the heads launch: one block per (window, head). It LN-normalises its
//     window's tokens, projects only its head's q/k/v, and runs scores,
//     bias, mask, softmax and .V. The (N, N) score matrix never leaves the
//     SM. It writes its head's slice of the (T, N, C) attention output.
//  2. the projection launch: the output projection + bias + shortcut, a
//     GEMM over token tiles.
// Each launch has two routes, picked by the wrapper from the dtype and the
// shape alone: the projection launch's by gemm_route (tensor cores,
// window_attention_proj_tc, for bf16 and fp16 with C in column parts of at
// most 96; CUDA cores, window_attention_proj, for fp32 and other widths:
// fp32 products from shared memory over 32-row tiles, 16 channels staged at
// a time), the heads launch's by attention_route
// (ops/kernels/window_attention.py):
//  * tensor cores (window_attention_heads_tc; bf16 and fp16, head dim 16,
//    N <= 224): 4 warps, each owning up to four strips of 16 query rows of
//    the window padded to 224 = 14 x 16 tokens (mma_tile.cuh). The LN'd window
//    is staged in T in chunks of 64 channels (a whole window at C = 384 is
//    166 KB) and projected with mma.sync m16n8k16 into q, k and v
//    ([token][d] tiles in shared memory; q's comes back through ldmatrix as
//    the A fragment of the scores); bias in fp32, then T. Head dim 16 is one k-step: a strip's
//    16 x 224 scores are 28 mma into registers, where scale, the fp32 bias
//    (read from L2), the -100 mask and the exact two-step softmax (quad
//    shuffles for the row max and sum) run; p / sum is rounded to T and the
//    score registers are the A operand of p . v (14 k-steps x 2 n-tiles).
//    No online softmax: the JAX kernel rounds the normalised p before the
//    product, and a whole row fits the registers. ~74 KB of shared memory
//    and <= 168 registers a thread: three blocks an SM, so one block's
//    staging runs under the others' softmax. LayerNorm statistics take a
//    row a thread and the staging four 16-byte loads in flight a thread:
//    with a warp a row, the block waited a load's latency per row.
//  * CUDA cores (window_attention_heads; fp32, any other head dim up to
//    16, and up to 32 where the wrapper asks): the block projects in
//    chunks of 32 channels with fp32 FMAs from shared memory and walks the
//    scores one query row per warp. TF32 would
//    cost the fp32 forms their agreement with the fp32 plain path. Where
//    the wrapper hands a scratch buffer (head dims above 16, up to 96) the
//    wide form runs (window_attention_heads_wide, attn_wide.cuh): a block
//    owns a head and a run of windows, keeps q, k, v in scratch slots of
//    device memory and walks the head dim in chunks of 32 channels.
//
// What bounds it on the card: the tensor-core route does 2 x 216 x 216 x 16
// x 2 FLOP of attention and 216 x 48 x C x 2 of projection per (window,
// head) at the tensor-core rate, so its floor is the elementwise work of
// the softmax (an exp and an fp32 bias load per score; the bias table,
// nh x N x N fp32, 186 KB a head, is read from L2 by every block): at C = 48
// the heads launch took 4.2 ms, 0.95 with that work compiled out
// (chip_smoke.py --phases attn_parts, PERF.md).
// The CUDA-core route is bound by shared-memory bandwidth and FMA issue.
// The projection launch is bound by bytes at every stage (C = 48, batch 16:
// attn and the shortcut in, the output out, 510 MB, against 8 GFLOP); its
// tensor-core form streams 64-token tiles with every copy in flight and
// keeps the products (10x under the bytes' time) off the critical path.
//
// K6 replaces fused_global_window_attention (_global_kernel) of the same
// file. Per window: optional fp32 LayerNorm -> KV projection (C -> 2C: the
// first C columns K, the last C columns V, head-major) -> bf16; the queries
// are not projected: they are the ws^3 grid q_global[b] of the window's batch
// element b = window / (windows per volume), scaled by hd^-0.5 in fp32 and
// rounded to bf16 before the dot, and never LayerNorm'ed; per head q.k^T in
// fp32 + relative position bias (no mask) -> fp32 softmax -> bf16 -> .V ->
// bf16 -> output projection -> optional add of the raw window. It is K1's
// two launches with three differences inside the heads launch: two projected
// column groups instead of three, the q slot of the block's [q | k | v] tile
// filled from q_global, and the scale folded into q. The TPU kernel's tile
// of windows per grid step and its rule that a tile must not straddle batch
// elements have no counterpart: a block is one (window, head).
// K6 takes the same two routes: on the tensor cores the q fragment of a
// strip is loaded from q_global, scaled in fp32 and rounded, and only the
// k and v column groups are projected. What bounds K6: as K1. By its counts
// it is bound by bytes at C = 48 (batch 16: 170 MB of windows in, 170 MB
// out against 36 GFLOP) and by operations from C = 96 on; q_global
// (B x N x C) and the bias stay in L2.

#include <math.h>
#include <stdint.h>

#include "attn_wide.cuh"
#include "common.cuh"
#include "mlp_tile.cuh"

namespace medseg {
namespace {

constexpr int kKC = 32;      // input channels staged per QKV chunk
constexpr int kMaxHD = 32;   // largest head dim of the one-pass CUDA-core form
constexpr int kRows = 32;    // token rows per projection block
constexpr int kPK = 16;      // input channels staged per projection chunk

template <class T>
struct HeadsParams {
  const T* x;                 // (T, N, C) windows, raw (LN applied here)
  const float* ln;            // (2, C) scale/bias or nullptr
  const T* wqkv;              // (3C, C) [out, in]
  const float* bqkv;          // (3C) or nullptr
  const float* bias;          // (nh, N, N)
  // K6: (B, N, C) global queries, wqkv is then (2C, C) = [K | V] and bqkv
  // (2C); nullptr for K1
  const T* qg;
  T* attn;                    // (T, N, C) attention output, heads concatenated
  int n, c, hd;
  int nwin;                   // windows per volume (K6: batch element of a window)
  int w0, w1, w2, s0, s1, s2;
  int nwd, nwh, nww;
  int shifted;
  float eps, scale;
};

template <class T>
__global__ void __launch_bounds__(kThreads)
    window_attention_heads(HeadsParams<T> p) {
  extern __shared__ float smem[];
  const int win = blockIdx.x, h = blockIdx.y;
  const int n = p.n, c = p.c, hd = p.hd, q3 = 3 * hd;
  const int xs_stride = kKC + 1, qkv_stride = q3 + 1;
  float* mu = smem;                          // n
  float* rs = mu + n;                        // n
  float* xs = rs + n;                        // n x (kKC + 1)
  float* wsm = xs + n * xs_stride;           // kKC x q3
  float* qkv = wsm + kKC * q3;               // n x (3hd + 1)
  float* prow = qkv + n * qkv_stride;        // kWarps x n
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xw = p.x + (size_t)win * n * c;
  // columns [j0, 3hd) of the [q | k | v] tile are projected from the window:
  // all three groups for K1, k and v for K6
  const int j0 = p.qg != nullptr ? hd : 0, np = q3 - j0;

  if (p.ln != nullptr) {
    for (int t = warp; t < n; t += kWarps) {
      float m, r;
      row_stats(xw + (size_t)t * c, c, p.eps, &m, &r);
      if (lane == 0) {
        mu[t] = m;
        rs[t] = r;
      }
    }
  }
  for (int o = tid; o < n * qkv_stride; o += kThreads) qkv[o] = 0.f;

  // this head's projected columns: jj in [0, np) -> row (jj / hd) * C +
  // h * hd + jj % hd of wqkv, tile column j0 + jj
  for (int c0 = 0; c0 < c; c0 += kKC) {
    __syncthreads();
    for (int e = tid; e < n * kKC; e += kThreads) {
      const int t = e / kKC, kk = e - t * kKC, ch = c0 + kk;
      float v = 0.f;
      if (ch < c) {
        v = ld(xw + (size_t)t * c + ch);
        if (p.ln != nullptr)
          v = round_to<T>((v - mu[t]) * (rs[t] * p.ln[ch]) + p.ln[c + ch]);
      }
      xs[t * xs_stride + kk] = v;
    }
    for (int e = tid; e < np * kKC; e += kThreads) {
      const int j = e / kKC, kk = e - j * kKC, ch = c0 + kk;
      const int col = (j / hd) * c + h * hd + j % hd;
      wsm[kk * q3 + j] = ch < c ? ld(p.wqkv + (size_t)col * c + ch) : 0.f;
    }
    __syncthreads();
    // token index fastest across lanes: xs reads are conflict-free (odd
    // stride) and wsm reads broadcast
    for (int e = tid; e < n * np; e += kThreads) {
      const int j = e / n, t = e - j * n;
      const float* xr = xs + t * xs_stride;
      float acc = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) acc += xr[kk] * wsm[kk * q3 + j];
      qkv[t * qkv_stride + j0 + j] += acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < n * np; e += kThreads) {
    const int j = e / n, t = e - j * n;
    const int col = (j / hd) * c + h * hd + j % hd;
    const float b = p.bqkv != nullptr ? p.bqkv[col] : 0.f;
    qkv[t * qkv_stride + j0 + j] = round_to<T>(qkv[t * qkv_stride + j0 + j] + b);
  }
  if (p.qg != nullptr) {
    // the batch element's query grid, scaled in fp32, then rounded
    const T* qb = p.qg + ((size_t)(win / p.nwin) * n) * c + h * hd;
    for (int e = tid; e < n * hd; e += kThreads) {
      const int t = e / hd, d = e - t * hd;
      qkv[t * qkv_stride + d] = round_to<T>(ld(qb + (size_t)t * c + d) * p.scale);
    }
  }
  __syncthreads();

  // window grid coordinates in batch-major order g = ((b*nwd + i)*nwh + j)*nww + k
  const int wk = win % p.nww, wj = (win / p.nww) % p.nwh,
            wi = (win / (p.nww * p.nwh)) % p.nwd;
  const bool ld = wi == p.nwd - 1, lh = wj == p.nwh - 1, lw = wk == p.nww - 1;
  const float* bias_h = p.bias + (size_t)h * n * n;
  const float scale = p.qg != nullptr ? 1.f : p.scale;  // K6: already in q
  const float* K = qkv + hd;
  const float* V = qkv + 2 * hd;
  float* pr = prow + warp * n;

  for (int t = warp; t < n; t += kWarps) {
    float qv[kMaxHD];
#pragma unroll
    for (int d = 0; d < kMaxHD; ++d) qv[d] = d < hd ? qkv[t * qkv_stride + d] : 0.f;
    const int lab_t = p.shifted ? token_label(t, p.w1, p.w2, p.w0, p.s0, p.s1,
                                              p.s2, ld, lh, lw)
                                : 0;
    float mx = -INFINITY;
    for (int m = lane; m < n; m += 32) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxHD; ++d)
        if (d < hd) s += qv[d] * K[m * qkv_stride + d];
      s = s * scale + bias_h[(size_t)t * n + m];
      if (p.shifted &&
          token_label(m, p.w1, p.w2, p.w0, p.s0, p.s1, p.s2, ld, lh, lw) != lab_t)
        s += -100.f;
      pr[m] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < n; m += 32) {
      const float e = expf(pr[m] - mx);
      pr[m] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float acc[kMaxHD];
#pragma unroll
    for (int d = 0; d < kMaxHD; ++d) acc[d] = 0.f;
    for (int m = lane; m < n; m += 32) {
      const float pm = round_to<T>(pr[m] / sum);
#pragma unroll
      for (int d = 0; d < kMaxHD; ++d)
        if (d < hd) acc[d] += pm * V[m * qkv_stride + d];
    }
    float mine = 0.f;
#pragma unroll
    for (int d = 0; d < kMaxHD; ++d) {
      if (d < hd) {
        const float v = warp_sum(acc[d]);
        if (lane == d) mine = v;
      }
    }
    if (lane < hd)
      p.attn[((size_t)win * n + t) * c + h * hd + lane] = from_f32<T>(mine);
  }
}

// The CUDA-core heads launch at head dims above 16 (attn_wide.cuh): a block
// owns head h and windows [chunk * wins_per_chunk, ...). Per window: the
// head's q, k, v (K6: k, v, and q from q_global) go to the block's three
// (N, hd) slots of scratch in T; then a group of kR query rows at a time,
// the logits over the head-dim chunks, the softmax a row a warp, and P . V
// a chunk of output channels at a time.
template <class T>
__global__ void __launch_bounds__(kThreads)
    window_attention_heads_wide(HeadsParams<T> p, T* scratch, int t_total,
                                int wins_per_chunk) {
  using namespace wide;
  extern __shared__ float smem[];
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int n = p.n, c = p.c, hd = p.hd;
  float* mu = smem;                  // n
  float* rs = mu + n;                // n
  float* xs = rs + n;                // projection: n x (kKC + 1)
  float* wsm = xs + n * (kKC + 1);   //   kKC x kD
  float* tile = wsm + kKC * kD;      //   n x kS
  float* S = rs + n;                 // attention: kR x n logits, then p
  float* qc = S + kR * n;            //   kR x kS
  float* kc = qc + kR * kS;          //   n x kS: k, then v
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* q = scratch + (size_t)(chunk * gridDim.y + h) * 3 * n * hd;
  T* k = q + (size_t)n * hd;
  T* v = k + (size_t)n * hd;
  // column groups [p0, 3) of [q | k | v] are projected: K6 takes q from
  // q_global, and its weight is [K | V]
  const int p0 = p.qg != nullptr ? 1 : 0;
  const float* bias_h = p.bias + (size_t)h * n * n;
  const float scale = p.qg != nullptr ? 1.f : p.scale;  // K6: already in q
  const int w_begin = chunk * wins_per_chunk;
  const int w_end = min(t_total, w_begin + wins_per_chunk);

  for (int win = w_begin; win < w_end; ++win) {
    const T* xw = p.x + (size_t)win * n * c;
    __syncthreads();  // the previous window's readers are done
    if (p.ln != nullptr) {
      for (int t = warp; t < n; t += kWarps) {
        float m, r;
        row_stats(xw + (size_t)t * c, c, p.eps, &m, &r);
        if (lane == 0) {
          mu[t] = m;
          rs[t] = r;
        }
      }
    }
    for (int g = p0; g < 3; ++g) {
      const int row0 = (g - p0) * c + h * hd;
      project_head<T>(
          xw, n, c, hd, p.ln, mu, rs, p.wqkv,
          [=](int j) { return (size_t)(row0 + j) * c; }, 1,
          q + (size_t)g * n * hd, xs, wsm, tile, [&](int j, float a) {
            return a + (p.bqkv != nullptr ? p.bqkv[row0 + j] : 0.f);
          });
    }
    if (p.qg != nullptr) {
      // the batch element's query grid, scaled in fp32, then rounded
      const T* qb = p.qg + ((size_t)(win / p.nwin) * n) * c + h * hd;
      for (int e = tid; e < n * hd; e += kThreads) {
        const int t = e / hd, d = e - t * hd;
        q[e] = from_f32<T>(ld(qb + (size_t)t * c + d) * p.scale);
      }
    }

    const int wk = win % p.nww, wj = (win / p.nww) % p.nwh,
              wi = (win / (p.nww * p.nwh)) % p.nwd;
    const bool ld_ = wi == p.nwd - 1, lh = wj == p.nwh - 1,
               lw = wk == p.nww - 1;
    for (int r0 = 0; r0 < n; r0 += kR) {
      const int rows = min(kR, n - r0);
      __syncthreads();  // q written; the previous group's readers are done
      for (int o = tid; o < rows * n; o += kThreads) S[o] = 0.f;
      for (int d0 = 0; d0 < hd; d0 += kD) {
        const int dw = min(kD, hd - d0);
        __syncthreads();
        stage_chunk(q, hd, r0, rows, d0, dw, qc);
        stage_chunk(k, hd, 0, n, d0, dw, kc);
        __syncthreads();
        chunk_products(qc, rows, kc, n, dw, S);
      }
      __syncthreads();
      // the softmax, a row a warp, as the one-pass form
      for (int i = warp; i < rows; i += kWarps) {
        const int t = r0 + i;
        float* sr = S + (size_t)i * n;
        const int lab_t = p.shifted ? token_label(t, p.w1, p.w2, p.w0, p.s0,
                                                  p.s1, p.s2, ld_, lh, lw)
                                    : 0;
        float mx = -INFINITY;
        for (int m = lane; m < n; m += 32) {
          float s = sr[m] * scale + bias_h[(size_t)t * n + m];
          if (p.shifted && token_label(m, p.w1, p.w2, p.w0, p.s0, p.s1, p.s2,
                                       ld_, lh, lw) != lab_t)
            s += -100.f;
          sr[m] = s;
          mx = fmaxf(mx, s);
        }
        mx = warp_max(mx);
        float sum = 0.f;
        for (int m = lane; m < n; m += 32) {
          const float e = expf(sr[m] - mx);
          sr[m] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int m = lane; m < n; m += 32) sr[m] = round_to<T>(sr[m] / sum);
      }
      for (int d0 = 0; d0 < hd; d0 += kD) {
        const int dw = min(kD, hd - d0);
        __syncthreads();
        stage_chunk(v, hd, 0, n, d0, dw, kc);
        __syncthreads();
        T* out = p.attn + ((size_t)win * n + r0) * c + h * hd + d0;
        times_chunk(S, rows, n, kc, dw, [&](int i, int d, float a) {
          out[(size_t)i * c + d] = from_f32<T>(a);
        });
      }
    }
  }
}

// The tensor-core heads block: 4 warps, each owning up to 4 of the 14 query
// strips, three blocks an SM (168 registers a thread: the 112 of a score
// strip, the o accumulators and the addressing).
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcStrips = 4;             // query strips a warp owns, at most
constexpr int kTcChunk = 64;             // channels a projection chunk
constexpr int kTcXS = mmatile::xs_stride<kTcChunk>();

// The tensor-core heads launch (bf16 / fp16, head dim 16, N <= 224): the
// same function as window_attention_heads, on mma.sync (see the header).
template <class T>
__global__ void __launch_bounds__(kTcThreads, 3)
    window_attention_heads_tc(HeadsParams<T> p) {
  using namespace mmatile;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  float* mu = reinterpret_cast<float*>(smem_tc);  // kMaxNP
  float* rs = mu + kMaxNP;                         // kMaxNP
  int* lab = reinterpret_cast<int*>(rs + kMaxNP);  // kMaxNP: mask labels
  T* qs = reinterpret_cast<T*>(lab + kMaxNP);      // kMaxNP x kHS each:
  T* ks = qs + kMaxNP * kHS;                       // q, k, v
  T* vs = ks + kMaxNP * kHS;
  T* xs = vs + kMaxNP * kHS;                       // kMaxNP x kTcXS
  T* ws = xs + kMaxNP * kTcXS;                     // 3 kHD x kTcXS
  const int win = blockIdx.x, h = blockIdx.y;
  const int n = p.n, c = p.c, np = (n + 15) & ~15, nt = np / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const T* xw = p.x + (size_t)win * n * c;
  // column groups [p0, 3) of [q | k | v] are projected: K6 takes q from
  // q_global, and its weight is [K | V]
  const int p0 = p.qg != nullptr ? 1 : 0;
  const float* ln = p.ln;

  if (ln != nullptr && !(MEDSEG_ATTN_SKIP & 1))
    window_stats(xw, n, c, p.eps, mu, rs);
  // the shifted-window mask: only a window last along some axis has tokens
  // of two regions
  const int wk = win % p.nww, wj = (win / p.nww) % p.nwh,
            wi = (win / (p.nww * p.nwh)) % p.nwd;
  const bool last_d = wi == p.nwd - 1, last_h = wj == p.nwh - 1,
             last_w = wk == p.nww - 1;
  const bool masked = p.shifted && (last_d || last_h || last_w);
  if (masked) {
    for (int r = tid; r < n; r += kTcThreads)
      lab[r] = token_label(r, p.w1, p.w2, p.w0, p.s0, p.s1, p.s2, last_d,
                           last_h, last_w);
  }

  float acc[kTcStrips][6][4];
#pragma unroll
  for (int si = 0; si < kTcStrips; ++si)
#pragma unroll
    for (int j = 0; j < 6; ++j) zero(acc[si][j]);
  for (int c0 = 0; c0 < c; c0 += kTcChunk) {
    const int kc = min(kTcChunk, c - c0);
    __syncthreads();  // statistics written, the previous chunk's readers done
    if (!(MEDSEG_ATTN_SKIP & 1))
      stage_rows<kTcChunk>(xw, n, np, c, c0, kc, xs,
                           [&](float v, int r, int ch) {
        return ln != nullptr ? (v - mu[r]) * (rs[r] * ln[ch]) + ln[c + ch]
                             : v;
      });
    stage_weight_rows<kTcChunk>(p.wqkv, c, c0, kc, 3 * kHD, ws, [&](int j) {
      const int grp = j / kHD;
      return grp < p0 ? -1 : (grp - p0) * c + h * kHD + j % kHD;
    });
    __syncthreads();
#pragma unroll
    for (int si = 0; si < kTcStrips; ++si) {
      const int s = warp + si * kTcWarps;
      if (16 * s < np)
        project_strip<kTcChunk, T, 6>(acc[si], xs, ws, s, kc, p0);
    }
  }

  // + bias in fp32, then T, into the [token][d] tiles of q, k and v
#pragma unroll
  for (int si = 0; si < kTcStrips; ++si) {
    const int s = warp + si * kTcWarps;
    if (16 * s >= np) continue;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j < 2 * p0) continue;
      const int d = (j & 1) * 8 + 2 * t4, col = (j / 2 - p0) * c + h * kHD + d;
      const float b0 = p.bqkv != nullptr ? p.bqkv[col] : 0.f;
      const float b1 = p.bqkv != nullptr ? p.bqkv[col + 1] : 0.f;
      acc[si][j][0] += b0;
      acc[si][j][1] += b1;
      acc[si][j][2] += b0;
      acc[si][j][3] += b1;
    }
    if (p.qg != nullptr) {
      // the batch element's query grid, scaled in fp32, then rounded
      const T* qb = p.qg + ((size_t)(win / p.nwin) * n) * c + h * kHD + 2 * t4;
      const int r0 = 16 * s + g, r1 = r0 + 8;
      auto q = [&](int r, int d) {
        return r < n ? ld(qb + (size_t)r * c + d) * p.scale : 0.f;
      };
      const float lo[4] = {q(r0, 0), q(r0, 1), q(r1, 0), q(r1, 1)};
      const float hi[4] = {q(r0, 8), q(r0, 9), q(r1, 8), q(r1, 9)};
      store_head_tile<T>(qs, s, lo, hi);
    } else {
      store_head_tile<T>(qs, s, acc[si][0], acc[si][1]);
    }
    store_head_tile<T>(ks, s, acc[si][2], acc[si][3]);
    store_head_tile<T>(vs, s, acc[si][4], acc[si][5]);
  }
  __syncthreads();

  const float* bias_h = p.bias + (size_t)h * n * n;
  const float scale = p.qg != nullptr ? 1.f : p.scale;  // K6: already in q
  T* out = p.attn + (size_t)win * n * c;
#pragma unroll 1
  for (int s = warp; 16 * s < np; s += kTcWarps) {
    uint32_t qa[4];
    ldsm_x4(qa, qs + (16 * s + (lane & 15)) * kHS + (lane >> 4) * 8);
    float sc[kNT][4];
    softmax_strip<T>(sc, qa, ks, s, nt, bias_h, masked ? lab : nullptr, n,
                     scale);
    float o[2][4];
    times_head_tile<T>(o, vs, nt, [&](int i, uint32_t(&a)[4]) {
      c_to_a<T>(a, sc[2 * i], sc[2 * i + 1]);
    });
    write_rows<T>(out, c, h * kHD, s, n, o[0], o[1]);
  }
}

// out = bf16(attn . Wproj^T + bproj) [+ x], over tiles of kRows token rows.
template <class T>
__global__ void __launch_bounds__(kThreads)
    window_attention_proj(const T* __restrict__ attn,
                          const T* __restrict__ wproj,
                          const float* __restrict__ bproj,
                          const T* __restrict__ x,
                          T* __restrict__ out, long long m_total,
                          int c, int residual) {
  extern __shared__ float smem[];
  const int acc_stride = kRows + 1, as_stride = kPK + 1;
  float* acc = smem;                     // c x (kRows + 1)
  float* as = acc + c * acc_stride;      // kRows x (kPK + 1)
  float* wsm = as + kRows * as_stride;   // kPK x c
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, m_total - r0);

  for (int e = tid; e < c * kRows; e += kThreads) acc[(e / kRows) * acc_stride + e % kRows] = 0.f;
  for (int c0 = 0; c0 < c; c0 += kPK) {
    __syncthreads();
    for (int e = tid; e < kRows * kPK; e += kThreads) {
      const int r = e / kPK, kk = e - r * kPK, ch = c0 + kk;
      as[r * as_stride + kk] =
          (r < rows && ch < c) ? ld(attn + (r0 + r) * c + ch) : 0.f;
    }
    for (int e = tid; e < kPK * c; e += kThreads) {
      const int o = e / kPK, kk = e - o * kPK, ch = c0 + kk;
      wsm[kk * c + o] = ch < c ? ld(wproj + (size_t)o * c + ch) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < c * kRows; e += kThreads) {
      const int j = e / kRows, r = e - j * kRows;
      const float* ar = as + r * as_stride;
      float a = 0.f;
#pragma unroll
      for (int kk = 0; kk < kPK; ++kk) a += ar[kk] * wsm[kk * c + j];
      acc[j * acc_stride + r] += a;
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * c; e += kThreads) {
    const int r = e / c, j = e - r * c;
    float y = round_to<T>(acc[j * acc_stride + r] + bproj[j]);
    if (residual) y += ld(x + (r0 + r) * c + j);
    out[(r0 + r) * c + j] = from_f32<T>(y);
  }
}

// The tensor-core projection launch (bf16 / fp16, C in column parts:
// mlptile::gemm_route_takes): out = T(attn . Wproj^T + bproj) [+ x], the
// same function as window_attention_proj. Grid (64-token tiles, C / w
// column tiles), w = gemm_width(C) (48 at C = 48, 96 from C = 96 on), four
// warps, a 16-row strip a warp. The tile's attn rows and the column tile's
// Wproj rows are copied by cp.async in k chunks of w channels (two slots
// when C > w: the next chunk is in flight during the current one's
// products; one chunk, all of Wproj's rows a block needs, at C <= 96) and
// multiplied with mma.sync from ldmatrix fragments. The epilogue adds the
// fp32 bias in registers, rounds to T into the warp's own rows of the attn
// slot, and writes each row out in 16-byte pieces, adding the shortcut read
// likewise in 16-byte pieces in fp32 and rounding again.
template <class T, int kMaxW>
__global__ void __launch_bounds__(mlptile::kMlpThreads, 4)
    window_attention_proj_tc(const T* __restrict__ attn,
                             const T* __restrict__ wproj,
                             const float* __restrict__ bproj,
                             const T* __restrict__ x, T* __restrict__ out,
                             long long m_total, int c, int w, int residual) {
  using namespace mmatile;
  using namespace mlptile;
  extern __shared__ __align__(16) unsigned char smem_proj[];
  T* slots = reinterpret_cast<T*>(smem_proj);
  const int sd = w + 8;                   // row stride of a chunk
  const int slot = (kMlpRows + w) * sd;   // [attn rows | Wproj rows]
  const int nch = c / w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long r0 = (long long)blockIdx.x * kMlpRows;
  const int rows = (int)min((long long)kMlpRows, m_total - r0);
  const int col0 = blockIdx.y * w;
  if (MEDSEG_ATTN_SKIP & 32) {  // what a skipped load leaves is zero
    zero_smem(slots, sizeof(T) * (nch > 1 ? 2 : 1) * slot);
    __syncthreads();
  }
  auto stage = [&](int k, int s) {
    if (MEDSEG_ATTN_SKIP & 32) return;
    T* as = slots + s * slot;
    copy_rows_async(attn + r0 * c + k * w, c, rows, w, as, sd);
    copy_rows_async(wproj + (size_t)col0 * c + k * w, c, w, w,
                    as + kMlpRows * sd, sd);
  };
  stage(0, 0);
  cp_async_commit();
  float acc[kMaxW / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxW / 8; ++j) zero(acc[j]);
  const int a_off = (16 * warp + (lane & 15)) * sd + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * sd +
                    ((lane >> 3) & 1) * 8;
  for (int k = 0; k < nch; ++k) {
    if (k + 1 < nch) {
      stage(k + 1, (k + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* as = slots + (k & 1) * slot;
    const T* ws = as + kMlpRows * sd;
    if (16 * warp < rows) {  // rows past the end are stale: never written
      for (int ks = 0; ks < w / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, as + a_off + 16 * ks);
#pragma unroll
        for (int q = 0; q < kMaxW / 16; ++q) {
          if (16 * q < w) {
            uint32_t b[4];
            ldsm_x4(b, ws + b_off + 16 * q * sd + 16 * ks);
            mma<T>(acc[2 * q], a, b[0], b[1]);
            mma<T>(acc[2 * q + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the slot's readers are done before it is refilled
  }
  if ((MEDSEG_ATTN_SKIP & 256) || 16 * warp >= rows) return;

  // T(acc + bias) into the warp's own 16 rows of the last attn chunk
  T* ost = slots + ((nch - 1) & 1) * slot + 16 * warp * sd;
#pragma unroll
  for (int j = 0; j < kMaxW / 8; ++j) {
    if (8 * j < w) {
      const int col = 8 * j + 2 * t4;
      const float2 bb = *reinterpret_cast<const float2*>(bproj + col0 + col);
      *reinterpret_cast<uint32_t*>(ost + g * sd + col) =
          pack<T>(acc[j][0] + bb.x, acc[j][1] + bb.y);
      *reinterpret_cast<uint32_t*>(ost + (g + 8) * sd + col) =
          pack<T>(acc[j][2] + bb.x, acc[j][3] + bb.y);
    }
  }
  __syncwarp();
  const int vecs = w / 8, live = min(16, rows - 16 * warp);
  for (int e = lane; e < live * vecs; e += 32) {
    const int r = e / vecs, v8 = (e - r * vecs) * 8;
    const long long at = (r0 + 16 * warp + r) * c + col0 + v8;
    uint4 y = *reinterpret_cast<const uint4*>(ost + r * sd + v8);
    if (residual) {
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + at));
      const T* yi = reinterpret_cast<const T*>(&y);
      const T* xi = reinterpret_cast<const T*>(&xv);
      uint4 sum;
      uint32_t* so = reinterpret_cast<uint32_t*>(&sum);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        so[i] = pack<T>(to_f32(yi[2 * i]) + to_f32(xi[2 * i]),
                        to_f32(yi[2 * i + 1]) + to_f32(xi[2 * i + 1]));
      y = sum;
    }
    *reinterpret_cast<uint4*>(out + at) = y;
  }
}

}  // namespace
}  // namespace medseg

namespace medseg {
namespace {

// The two launches of K1 and K6: heads, then projection (+ shortcut).
template <class T>
cudaError_t launch_heads_tc(const HeadsParams<T>& p, int t, int nh,
                            cudaStream_t st) {
  using namespace mmatile;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = 3 * sizeof(float) * kMaxNP +
                        sizeof(T) * (3 * kMaxNP * kHS + kMaxNP * kTcXS +
                                     3 * kHD * kTcXS);
    cudaError_t err = cudaFuncSetAttribute(
        window_attention_heads_tc<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    window_attention_heads_tc<T><<<dim3(t, nh), kTcThreads, smem, st>>>(p);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // fp32 keeps the CUDA cores
  }
}

template <class T>
cudaError_t launch_heads_cuda_core(const HeadsParams<T>& p, int t, int nh,
                                   T* scratch, int nchunk, cudaStream_t st) {
  const int n = p.n, hd = p.hd;
  if (scratch != nullptr) {
    const int wpc = (t + nchunk - 1) / nchunk;
    const size_t smem = sizeof(float) *
        (2 * n + max(wide::project_floats(n),
                     wide::kR * n + wide::kR * wide::kS + n * wide::kS));
    cudaError_t err = cudaFuncSetAttribute(
        window_attention_heads_wide<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    window_attention_heads_wide<T><<<dim3(nchunk, nh), kThreads, smem, st>>>(
        p, scratch, t, wpc);
    return cudaGetLastError();
  }
  const size_t heads_smem = sizeof(float) *
      (2 * n + n * (kKC + 1) + kKC * 3 * hd + n * (3 * hd + 1) + kWarps * n);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_heads<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)heads_smem);
  if (err != cudaSuccess) return err;
  window_attention_heads<T><<<dim3(t, nh), kThreads, heads_smem, st>>>(p);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_proj_tc(const T* attn, const T* wproj, const float* bproj,
                           const T* x, T* out, long long m_total, int c,
                           int residual, cudaStream_t st) {
  using namespace mlptile;
  if constexpr (sizeof(T) == 2) {
    const int w = gemm_width(c), nch = c / w;
    const size_t smem =
        sizeof(T) * (nch > 1 ? 2 : 1) * (kMlpRows + w) * (w + 8);
    auto kernel = w <= 48 ? window_attention_proj_tc<T, 48>
                          : window_attention_proj_tc<T, 96>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((m_total + kMlpRows - 1) / kMlpRows), c / w);
    kernel<<<grid, kMlpThreads, smem, st>>>(attn, wproj, bproj, x, out,
                                            m_total, c, w, residual);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // fp32 keeps the CUDA cores
  }
}

template <class T>
int launch_attention(HeadsParams<T> p, const void* wproj, const void* bproj,
                     void* out, void* scratch, int t, int nh, int nchunk,
                     int residual, int route, int gemm_route,
                     cudaStream_t st) {
  const int n = p.n, c = p.c;
  cudaError_t err = (MEDSEG_ATTN_SKIP & 1024) ? cudaSuccess
                    : route == kRouteTensorCore
                        ? launch_heads_tc(p, t, nh, st)
                        : launch_heads_cuda_core(p, t, nh,
                                                 static_cast<T*>(scratch),
                                                 nchunk, st);
  if (err != cudaSuccess || (MEDSEG_ATTN_SKIP & 4)) return static_cast<int>(err);

  const long long m_total = (long long)t * n;
  if (gemm_route == kRouteTensorCore)
    return static_cast<int>(launch_proj_tc(
        p.attn, static_cast<const T*>(wproj), static_cast<const float*>(bproj),
        p.x, static_cast<T*>(out), m_total, c, residual, st));
  const size_t proj_smem =
      sizeof(float) * (c * (kRows + 1) + kRows * (kPK + 1) + kPK * c);
  err = cudaFuncSetAttribute(window_attention_proj<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)proj_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)((m_total + kRows - 1) / kRows);
  window_attention_proj<T><<<blocks, kThreads, proj_smem, st>>>(
      p.attn, static_cast<const T*>(wproj), static_cast<const float*>(bproj),
      p.x, static_cast<T*>(out), m_total, c, residual);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace medseg

// x, wqkv, wproj, attn, out of the element type named by dtype (kBf16,
// kF16, kF32); ln, bqkv, bproj, bias fp32. route, of the heads launch:
// kRouteTensorCore (bf16 or fp16, head dim 16, n <= 224) or kRouteCudaCore
// (any dtype, head dim up to 96); gemm_route, of the projection launch:
// kRouteTensorCore (bf16 or fp16, C as mlptile::gemm_route_takes says; x and
// wproj on 16-byte boundaries) or kRouteCudaCore. scratch and nchunk: the
// wide form's (the wrapper hands them at head dims above 16;
// wide::plan_takes), else NULL and unread.
extern "C" int medseg_window_attention_fwd(
    const void* x, const void* ln, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* bias, void* attn,
    void* out, void* scratch, int t, int n, int c, int nh, int nchunk,
    int w0, int w1, int w2, int s0, int s1, int s2, int nwd, int nwh,
    int nww, int shifted, int residual, int gemm_route, int route, int dtype,
    float ln_eps, float scale, void* stream) {
  using namespace medseg;
  const int hd = nh > 0 ? c / nh : 0;
  if (hd * nh != c || hd > wide::kMaxHD || hd < 1 || n < 1 || t < 1 ||
      !route_takes(route, dtype, n, c, hd) ||
      !mlptile::gemm_route_takes(gemm_route, dtype, c) ||
      !wide::plan_takes(hd, t, nchunk, scratch, kMaxHD))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    HeadsParams<T> p;
    p.x = static_cast<const T*>(x);
    p.ln = static_cast<const float*>(ln);
    p.wqkv = static_cast<const T*>(wqkv);
    p.bqkv = static_cast<const float*>(bqkv);
    p.bias = static_cast<const float*>(bias);
    p.qg = nullptr;
    p.attn = static_cast<T*>(attn);
    p.n = n; p.c = c; p.hd = hd; p.nwin = nwd * nwh * nww;
    p.w0 = w0; p.w1 = w1; p.w2 = w2; p.s0 = s0; p.s1 = s1; p.s2 = s2;
    p.nwd = nwd; p.nwh = nwh; p.nww = nww;
    p.shifted = shifted; p.eps = ln_eps; p.scale = scale;
    return launch_attention(p, wproj, bproj, out, scratch, t, nh, nchunk,
                            residual, route, gemm_route,
                            static_cast<cudaStream_t>(stream));
  });
}

// K6. x (T, N, C) windows in batch-major order, T = B * nwin; q (B, N, C);
// wkv (2C, C) [out, in]; bkv (2C) or nullptr; dtype, routes, scratch and
// nchunk as for K1.
extern "C" int medseg_global_window_attention_fwd(
    const void* x, const void* ln, const void* q, const void* wkv,
    const void* bkv, const void* wproj, const void* bproj, const void* bias,
    void* attn, void* out, void* scratch, int t, int n, int c, int nh,
    int nwin, int nchunk, int residual, int gemm_route, int route, int dtype,
    float ln_eps, float scale, void* stream) {
  using namespace medseg;
  const int hd = nh > 0 ? c / nh : 0;
  if (hd * nh != c || hd > wide::kMaxHD || hd < 1 || n < 1 || t < 1 ||
      nwin < 1 || t % nwin != 0 || q == nullptr ||
      !route_takes(route, dtype, n, c, hd) ||
      !mlptile::gemm_route_takes(gemm_route, dtype, c) ||
      !wide::plan_takes(hd, t, nchunk, scratch, kMaxHD))
    return static_cast<int>(cudaErrorInvalidValue);
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    HeadsParams<T> p;
    p.x = static_cast<const T*>(x);
    p.ln = static_cast<const float*>(ln);
    p.wqkv = static_cast<const T*>(wkv);
    p.bqkv = static_cast<const float*>(bkv);
    p.bias = static_cast<const float*>(bias);
    p.qg = static_cast<const T*>(q);
    p.attn = static_cast<T*>(attn);
    p.n = n; p.c = c; p.hd = hd; p.nwin = nwin;
    p.w0 = p.w1 = p.w2 = 1; p.s0 = p.s1 = p.s2 = 0;
    p.nwd = p.nwh = p.nww = 1;
    p.shifted = 0; p.eps = ln_eps; p.scale = scale;
    return launch_attention(p, wproj, bproj, out, scratch, t, nh, nchunk,
                            residual, route, gemm_route,
                            static_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* medseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
