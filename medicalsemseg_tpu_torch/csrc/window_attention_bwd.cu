// Fused 3D window attention, backward (training).
//
// Replaces the TPU kernels medicalsemseg_tpu/ops/pallas/window_attention.py:
// _fused_bwd_windows (_bwd_kernel) and _fused_bwd_windows_hsplit
// (_bwd_kernel_hsplit, the same function cut into head groups for the TPU's
// scoped memory). For out = proj(softmax(q k^T * scale + bias + mask) v)
// [+ x] with q, k, v = qkv(LN(x)) and the gradient dy it recomputes the
// LayerNorm, qkv and the softmax per window and produces, with the TPU
// kernel's rounding points,
//   dout = bf16(dy . Wproj), o = bf16(p v) (for dWproj = dy^T . o),
//   dp = dout v^T, dv = p^T dout, ds = p32 * (dp - sum(dp * p32)),
//   dbias += ds, dq = bf16(ds * scale) k, dk = bf16(ds * scale)^T q,
//   dqkv = bf16(dq | dk | dv), dWqkv = dqkv^T . xn, dbqkv = sum dqkv,
//   dbproj = sum dy, dx = LN backward of dqkv . Wqkv [+ dy], dLN.
// No (N, N) matrix and no LayerNorm output reaches device memory. The element
// type T of the activations, weights, o and dqkv is bf16, fp16 or fp32 (the
// JAX kernel takes its input's dtype): "bf16" above stands for T. Shared
// memory holds fp32 whatever T is.
//
// Design. The TPU kernels walk the window tiles in order on one core, with
// all weight gradients and the (nh, N, N) bias gradient in scratch memory
// from the first tile to the last. Here blocks run side by side:
//  1. the heads launch: a block owns one head and a run of windows. Per
//     window it projects its head's q, k, v and dout, runs the attention
//     backward of that head and writes o and dqkv in T. ds is added into the
//     block's own (N, N) slab of bias-gradient partials in device memory
//     (nobody else touches the slab: a plain read-modify-write on the CUDA
//     cores, reductions in L2 on the tensor cores).
//  2. the dx launch: dxn = dqkv . Wqkv over token tiles, LN backward, + dy;
//     per-block partial sums for dLN.
//  3. the dw launch: a block owns rows of (dWqkv | dWproj) in registers and
//     walks a strided share of the token tiles; one slab of partials per
//     share.
//  4. sum_partials adds the slabs of 1-3 in a fixed order: results do not
//     change from run to run.
// The dx and dw launches have two routes, picked by the wrapper from the
// dtype and the width alone (gemm_route):
//  * tensor cores (bf16 and fp16, C in column parts of at most 96;
//    mma.sync m16n8k16, the tiles and copies of mlp_tile.cuh):
//    window_attention_bwd_dx_tc walks 64 / parts token rows a tile with
//    dqkv and Wqkv streamed by cp.async in k chunks of 64, the LayerNorm
//    backward on its accumulators (row sums across the column parts
//    through shared memory), and hands each row's (mu, rstd) to
//    window_attention_bwd_dw_tc. That block owns 192 dW rows at C = 48 (all
//    of [dWqkv | dWproj]: 72 fp32 a thread) or 128 rows x a slice of <= 96
//    channels above, copies each 64-token tile once (the dqkv / dy columns
//    of its rows, the x / o slices; the LayerNorm applied in place), runs
//    the products with the tokens as the k dimension (A through
//    ldmatrix.trans) and the bias sums as the same A times ones, and adds
//    its fragments into fp32 every 32 tiles (mma.sync adds by truncation).
//    Both launches take the blocks resident on the card at once.
//  * CUDA cores (fp32, other widths): window_attention_bwd_dx over 32-row
//    tiles with dqkv staged 16 columns at a time as fp32;
//    window_attention_bwd_dw with 16 dW rows a block and fp32 outer
//    products from shared memory, each tile staged and normalised again by
//    every one of the 4C / 16 blocks of a share.
// The heads launch has two routes, picked by the wrapper from the dtype and
// the shape alone, as K1's:
//  * tensor cores (window_attention_bwd_heads_tc; bf16 and fp16, head dim
//    16, N <= 224): blocks of 7 warps, one an SM, over the window padded to
//    224 tokens (mma_tile.cuh). q, k, v and dout = T(dy . Wproj) are
//    projected with mma.sync m16n8k16 from chunks of 64 staged channels
//    into [token][d] tiles; q and dout come back through ldmatrix as the A
//    fragments of S = q k^T and dP = dout v^T (head dim 16 is one k-step).
//    The 14 query strips of 16 rows go in two phases of 7, a strip a warp:
//    the warp holds its strip's 16 x 224 p32 in registers and recomputes dP
//    one n-tile pair at a time (one mma each) for delta = sum dp p32 and
//    then for ds = p32 (dp - delta). T(p32) and T(ds * scale) go to two
//    half-window tiles in shared memory; o = T(T(p) v) and dq =
//    T(ds * scale) k take their A from the warp's own rows, and after a
//    block barrier each warp adds the phase's share of dv = T(p)^T dout and
//    dk = T(ds * scale)^T q for its two key strips (A through
//    ldmatrix.trans) to fp32 accumulators that are rounded once after the
//    second phase. One pass over the scores; no transposed bias. ~150 KB of
//    shared memory. LayerNorm statistics take a row a thread and the
//    staging four 16-byte loads in flight a thread; only a window last
//    along some axis builds the mask; ds goes to the block's slab of bias
//    partials as 8-byte reductions in L2 that no thread waits for (the slab
//    starts at zero; each entry is added to by one thread, in program
//    order, so the order of the sums is fixed).
//  * CUDA cores (window_attention_bwd_heads; fp32, any other head dim): one
//    query row per warp (softmax statistics, o, dq, ds), then one key row
//    per warp (p and ds recomputed from the saved row statistics and the
//    transposed bias; dk, dv), so that every sum is taken by one warp.
// One head per block keeps shared memory bounded for any C, so the same
// kernel serves the widest stage, for which the TPU needed the head-split
// variant.
//
// What bounds it on the card: the tensor-core route's products are a small
// share of its time at the tensor-core rate (1.15 of 9.6 ms for the heads
// launch at C = 48, batch 8, when everything else is compiled out); the
// elementwise softmax backward per score (exp, the fp32 bias load) and the
// bias partials in L2 bound it, with one block of 7 warps an SM to hide
// their latency (chip_smoke.py --phases attn_parts, PERF.md). The CUDA-core
// route computes the scores twice on FMA units from shared memory (8 N^2 hd
// multiply-adds per head against 6) and is bound by FMA issue and
// shared-memory bandwidth. The dx and dw launches are bound by bytes on the
// tensor cores (C = 48, batch 8: each reads or writes 6 M C values, 510 MB,
// against 10 and 14 GFLOP); their CUDA-core form by FMA throughput from shared
// memory.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mlp_tile.cuh"

namespace medseg {
namespace {

constexpr int kKC = 32;     // input channels staged per projection chunk
constexpr int kPK = 16;     // dqkv columns staged per dx chunk
// widest C of the CUDA-core dw launch: its rows of dW sit in registers,
// kJB * kMaxC / kThreads a thread; C above 512 (stage 4 at --hidden_dim 96)
// takes the wider instance, so narrower widths keep their register budget
constexpr int kNarrowC = 512;
constexpr int kMaxC = 768;

template <class T>
struct BwdHeadsParams {
  const T* x;                  // (T, N, C) raw windows
  const float* ln;             // (2, C) or nullptr
  const T* wqkv;               // (3C, C)
  const float* bqkv;           // (3C) or nullptr
  const T* wproj;              // (C, C)
  const float* bias;           // (nh, N, N)
  const float* bias_t;         // (nh, N, N), each head transposed
  const T* dy;                 // (T, N, C)
  T* attn;                     // (T, N, C) o, heads concatenated
  T* dqkv;                     // (T, N, 3C)
  float* dbias_part;           // (chunks, nh, N, N)
  int t, n, c, hd, wins_per_chunk;
  int w0, w1, w2, s0, s1, s2;
  int nwd, nwh, nww;
  int shifted;
  float eps, scale;
};

// dst[t][j] = sum_ch src'[t][ch] * w[base(j) + ch * kstride] for the n rows
// of one window and ncols columns; src' is src, LayerNorm-ed and rounded to
// T when ln is given. Staged through xs / wsm in chunks of kKC channels.
// Ends with a __syncthreads().
template <class T, class BaseFn>
__device__ void project_cols(const T* src, int n, int c,
                             const float* ln, const float* mu, const float* rs,
                             const T* w, BaseFn base, int kstride,
                             int ncols, float* xs, float* wsm, float* dst,
                             int dstride) {
  const int tid = threadIdx.x, xs_stride = kKC + 1;
  for (int o = tid; o < n * dstride; o += kThreads) dst[o] = 0.f;
  for (int c0 = 0; c0 < c; c0 += kKC) {
    __syncthreads();
    for (int e = tid; e < n * kKC; e += kThreads) {
      const int t = e / kKC, kk = e - t * kKC, ch = c0 + kk;
      float v = 0.f;
      if (ch < c) {
        v = ld(src + (size_t)t * c + ch);
        if (ln != nullptr)
          v = round_to<T>((v - mu[t]) * rs[t] * ln[ch] + ln[c + ch]);
      }
      xs[t * xs_stride + kk] = v;
    }
    for (int e = tid; e < ncols * kKC; e += kThreads) {
      const int j = e / kKC, kk = e - j * kKC, ch = c0 + kk;
      wsm[kk * ncols + j] =
          ch < c ? ld(w + base(j) + (size_t)ch * kstride) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < n * ncols; e += kThreads) {
      const int j = e / n, t = e - j * n;
      const float* xr = xs + t * xs_stride;
      float acc = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) acc += xr[kk] * wsm[kk * ncols + j];
      dst[t * dstride + j] += acc;
    }
  }
  __syncthreads();
}

template <class T, int HD>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_heads(BwdHeadsParams<T> p) {
  extern __shared__ float smem[];
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int n = p.n, c = p.c, hd = p.hd, q3 = 3 * hd;
  const int qs = q3 + 1, dstr = hd + 1;
  float* mu = smem;                      // n
  float* rs = mu + n;                    // n
  float* rmax = rs + n;                  // n: softmax row maximum
  float* rsum = rmax + n;                // n: softmax row sum
  float* delta = rsum + n;               // n: sum_m dp * p32
  float* xs = delta + n;                 // n x (kKC + 1)
  float* wsm = xs + n * (kKC + 1);       // kKC x q3
  float* qkv = wsm + kKC * q3;           // n x (3hd + 1)
  float* dos = qkv + n * qs;             // n x (hd + 1): dout of this head
  float* prow = dos + n * dstr;          // kWarps x n
  float* dprow = prow + kWarps * n;      // kWarps x n
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* bias_h = p.bias + (size_t)h * n * n;
  const float* bias_th = p.bias_t + (size_t)h * n * n;
  float* part = p.dbias_part + ((size_t)chunk * gridDim.y + h) * n * n;
  const float* K = qkv + hd;
  const float* V = qkv + 2 * hd;
  float* pr = prow + warp * n;
  float* dpr = dprow + warp * n;
  const int w_begin = chunk * p.wins_per_chunk;
  const int w_end = min(p.t, w_begin + p.wins_per_chunk);

  for (int win = w_begin; win < w_end; ++win) {
    const T* xw = p.x + (size_t)win * n * c;
    const T* dyw = p.dy + (size_t)win * n * c;
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
    // this head's q, k, v columns: j -> row (j / hd) * C + h * hd + j % hd
    project_cols(
        xw, n, c, p.ln, mu, rs, p.wqkv,
        [=](int j) { return (size_t)((j / hd) * c + h * hd + j % hd) * c; }, 1,
        q3, xs, wsm, qkv, qs);
    for (int e = tid; e < n * q3; e += kThreads) {
      const int j = e / n, t = e - j * n;
      const int col = (j / hd) * c + h * hd + j % hd;
      const float b = p.bqkv != nullptr ? p.bqkv[col] : 0.f;
      qkv[t * qs + j] = round_to<T>(qkv[t * qs + j] + b);
    }
    // dout[t][d] = bf16(sum_o dy[t][o] * Wproj[o][h * hd + d])
    project_cols(
        dyw, n, c, static_cast<const float*>(nullptr), nullptr, nullptr, p.wproj,
        [=](int j) { return (size_t)(h * hd + j); }, c, hd, xs, wsm, dos, dstr);
    for (int e = tid; e < n * hd; e += kThreads) {
      const int j = e / n, t = e - j * n;
      dos[t * dstr + j] = round_to<T>(dos[t * dstr + j]);
    }
    __syncthreads();

    // window grid coordinates, batch-major: g = ((b*nwd + i)*nwh + j)*nww + k
    const int wk = win % p.nww, wj = (win / p.nww) % p.nwh,
              wi = (win / (p.nww * p.nwh)) % p.nwd;
    const bool ld = wi == p.nwd - 1, lh = wj == p.nwh - 1, lw = wk == p.nww - 1;
    const bool first = win == w_begin;

    // pass 1, one query row per warp: softmax statistics, o, ds, dq
    for (int t = warp; t < n; t += kWarps) {
      float qv[HD], dov[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        qv[d] = d < hd ? qkv[t * qs + d] : 0.f;
        dov[d] = d < hd ? dos[t * dstr + d] : 0.f;
      }
      const int lab_t = p.shifted ? token_label(t, p.w1, p.w2, p.w0, p.s0,
                                                p.s1, p.s2, ld, lh, lw)
                                  : 0;
      float mx = -INFINITY;
      for (int m = lane; m < n; m += 32) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d)
          if (d < hd) s += qv[d] * K[m * qs + d];
        s = s * p.scale + bias_h[(size_t)t * n + m];
        if (p.shifted && token_label(m, p.w1, p.w2, p.w0, p.s0, p.s1, p.s2, ld,
                                     lh, lw) != lab_t)
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
      float oacc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) oacc[d] = 0.f;
      float dl = 0.f;
      for (int m = lane; m < n; m += 32) {
        const float p32 = pr[m] / sum;
        const float pb = round_to<T>(p32);
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          if (d < hd) {
            const float v = V[m * qs + d];
            oacc[d] += pb * v;
            dp += dov[d] * v;
          }
        }
        pr[m] = p32;
        dpr[m] = dp;
        dl += dp * p32;
      }
      dl = warp_sum(dl);
      float dqacc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) dqacc[d] = 0.f;
      for (int m = lane; m < n; m += 32) {
        const float ds = pr[m] * (dpr[m] - dl);
        float* pp = part + (size_t)t * n + m;
        *pp = first ? ds : *pp + ds;
        const float dsl = round_to<T>(ds * p.scale);
#pragma unroll
        for (int d = 0; d < HD; ++d)
          if (d < hd) dqacc[d] += dsl * K[m * qs + d];
      }
      float mo = 0.f, mq = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        if (d < hd) {
          const float vo = warp_sum(oacc[d]);
          const float vq = warp_sum(dqacc[d]);
          if (lane == d) {
            mo = vo;
            mq = vq;
          }
        }
      }
      if (lane < hd) {
        const size_t row = (size_t)win * n + t;
        p.attn[row * c + h * hd + lane] = from_f32<T>(mo);
        p.dqkv[row * 3 * c + h * hd + lane] = from_f32<T>(mq);
      }
      if (lane == 0) {
        rmax[t] = mx;
        rsum[t] = sum;
        delta[t] = dl;
      }
    }
    __syncthreads();

    // pass 2, one key row per warp: p and ds again from the row statistics
    // (the same operations in the same order as pass 1), dk and dv
    for (int m = warp; m < n; m += kWarps) {
      float kv[HD], vv[HD], dkacc[HD], dvacc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        kv[d] = d < hd ? K[m * qs + d] : 0.f;
        vv[d] = d < hd ? V[m * qs + d] : 0.f;
        dkacc[d] = dvacc[d] = 0.f;
      }
      const int lab_m = p.shifted ? token_label(m, p.w1, p.w2, p.w0, p.s0,
                                                p.s1, p.s2, ld, lh, lw)
                                  : 0;
      for (int t = lane; t < n; t += 32) {
        const float* qr = qkv + t * qs;
        const float* dr = dos + t * dstr;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          if (d < hd) {
            s += qr[d] * kv[d];
            dp += dr[d] * vv[d];
          }
        }
        s = s * p.scale + bias_th[(size_t)m * n + t];
        if (p.shifted && token_label(t, p.w1, p.w2, p.w0, p.s0, p.s1, p.s2, ld,
                                     lh, lw) != lab_m)
          s += -100.f;
        const float p32 = expf(s - rmax[t]) / rsum[t];
        const float pb = round_to<T>(p32);
        const float dsl = round_to<T>(p32 * (dp - delta[t]) * p.scale);
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          if (d < hd) {
            dvacc[d] += pb * dr[d];
            dkacc[d] += dsl * qr[d];
          }
        }
      }
      float mk = 0.f, mv = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        if (d < hd) {
          const float vk = warp_sum(dkacc[d]);
          const float vd = warp_sum(dvacc[d]);
          if (lane == d) {
            mk = vk;
            mv = vd;
          }
        }
      }
      if (lane < hd) {
        const size_t row = ((size_t)win * n + m) * 3 * c;
        p.dqkv[row + c + h * hd + lane] = from_f32<T>(mk);
        p.dqkv[row + 2 * c + h * hd + lane] = from_f32<T>(mv);
      }
    }
  }
}

// The tensor-core heads block: 7 warps. A window's 14 query strips go in
// two phases of 7 (a warp takes strip w, then w + 7), so the staged tiles of
// T(p) and T(ds * scale) hold half a window each; a warp owns key strips w
// and w + 7 of dv and dk, accumulated in fp32 over both phases. One block an
// SM (its shared memory): a thread may take up to 255 registers. (Blocks of
// 4 warps, two an SM with phases of 4 strips, spilled at 255 registers and
// were 14 % slower: PERF.md.)
constexpr int kTcWarps = 7;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcStrips = (mmatile::kMaxStrips + kTcWarps - 1) / kTcWarps;
constexpr int kPhaseRows = 16 * kTcWarps;  // query rows of a phase
constexpr int kTcChunk = 64;               // channels a projection chunk
constexpr int kTcXS = mmatile::xs_stride<kTcChunk>();

// The tensor-core heads launch (bf16 / fp16, head dim 16, N <= 224): the
// same function as window_attention_bwd_heads, on mma.sync (see the header).
template <class T>
__global__ void __launch_bounds__(kTcThreads, 1)
    window_attention_bwd_heads_tc(BwdHeadsParams<T> p) {
  using namespace mmatile;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  float* mu = reinterpret_cast<float*>(smem_tc);  // kMaxNP
  float* rs = mu + kMaxNP;                         // kMaxNP
  int* lab = reinterpret_cast<int*>(rs + kMaxNP);  // kMaxNP: mask labels
  T* qs = reinterpret_cast<T*>(lab + kMaxNP);      // kMaxNP x kHS each:
  T* ks = qs + kMaxNP * kHS;                       // q, k, v, dout
  T* vs = ks + kMaxNP * kHS;
  T* dos = vs + kMaxNP * kHS;
  T* pt = dos + kMaxNP * kHS;                      // kPhaseRows x kPS: T(p)
  T* pd = pt + kPhaseRows * kPS;                   // kPhaseRows x kPS:
                                                   // T(ds * scale)
  // the projection's staging shares pt's and pd's space
  T* xs = pt;                                      // kMaxNP x kTcXS
  T* dys = xs + kMaxNP * kTcXS;                    // kMaxNP x kTcXS
  T* wq = dys + kMaxNP * kTcXS;                    // 3 kHD x kTcXS
  T* wp = wq + 3 * kHD * kTcXS;                    // kTcChunk x kHS
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int n = p.n, c = p.c, np = (n + 15) & ~15, nt = np / 8;
  const int nstrips = np / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float* ln = p.ln;
  const float* bias_h = p.bias + (size_t)h * n * n;
  float* part = p.dbias_part + ((size_t)chunk * gridDim.y + h) * n * n;
  const int w_begin = chunk * p.wins_per_chunk;
  const int w_end = min(p.t, w_begin + p.wins_per_chunk);
  // the warp's strip of phase i (and its i-th key strip)
  auto strip = [&](int i) { return warp + i * kTcWarps; };
  auto mine = [&](int i) { return strip(i) < nstrips; };

  for (int win = w_begin; win < w_end; ++win) {
    const T* xw = p.x + (size_t)win * n * c;
    const T* dyw = p.dy + (size_t)win * n * c;
    __syncthreads();  // the previous window's readers are done
    if (ln != nullptr && !(MEDSEG_ATTN_SKIP & 1))
      window_stats(xw, n, c, p.eps, mu, rs);
    // the shifted-window mask: only a window last along some axis has
    // tokens of two regions
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

    // q | k | v and dout of the warp's strips
    float acc[kTcStrips][6][4], dacc[kTcStrips][2][4];
#pragma unroll
    for (int i = 0; i < kTcStrips; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) zero(acc[i][j]);
      zero(dacc[i][0]);
      zero(dacc[i][1]);
    }
    for (int c0 = 0; c0 < c; c0 += kTcChunk) {
      const int kc = min(kTcChunk, c - c0);
      __syncthreads();  // statistics written, the previous chunk's readers done
      if (!(MEDSEG_ATTN_SKIP & 1)) {
        stage_rows<kTcChunk>(xw, n, np, c, c0, kc, xs,
                             [&](float v, int r, int ch) {
          return ln != nullptr ? (v - mu[r]) * rs[r] * ln[ch] + ln[c + ch]
                               : v;
        });
        stage_rows<kTcChunk>(dyw, n, np, c, c0, kc, dys,
                             [](float v, int, int) { return v; });
      }
      stage_weight_rows<kTcChunk>(p.wqkv, c, c0, kc, 3 * kHD, wq, [&](int j) {
        return (j / kHD) * c + h * kHD + j % kHD;
      });
      // wp[o][d] = Wproj[c0 + o][h * hd + d]: B of dout = dy . Wproj[:, head]
      for (int e = tid; e < kc * 2; e += kTcThreads) {
        const int o = e >> 1, v8 = (e & 1) * 8;
        *reinterpret_cast<uint4*>(wp + o * kHS + v8) =
            *reinterpret_cast<const uint4*>(p.wproj + (size_t)(c0 + o) * c +
                                            h * kHD + v8);
      }
      __syncthreads();
      const T* b_row = wp + ((lane & 7) + ((lane >> 3) & 1) * 8) * kHS +
                       (lane >> 4) * 8;
#pragma unroll
      for (int i = 0; i < kTcStrips; ++i) {
        if (!mine(i)) continue;
        project_strip<kTcChunk, T, 6>(acc[i], xs, wq, strip(i), kc, 0);
        const T* a_row = dys + (16 * strip(i) + (lane & 15)) * kTcXS +
                         (lane >> 4) * 8;
        for (int k16 = 0; k16 < kc / 16; ++k16) {
          uint32_t a[4], b[4];
          ldsm_x4(a, a_row + 16 * k16);
          ldsm_x4_t(b, b_row + 16 * k16 * kHS);
          mma<T>(dacc[i][0], a, b[0], b[1]);
          mma<T>(dacc[i][1], a, b[2], b[3]);
        }
      }
    }
    // + bias in fp32, then T, into the [token][d] tiles
#pragma unroll
    for (int i = 0; i < kTcStrips; ++i) {
      if (!mine(i)) continue;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int col = (j / 2) * c + h * kHD + (j & 1) * 8 + 2 * t4;
        const float b0 = p.bqkv != nullptr ? p.bqkv[col] : 0.f;
        const float b1 = p.bqkv != nullptr ? p.bqkv[col + 1] : 0.f;
        acc[i][j][0] += b0;
        acc[i][j][1] += b1;
        acc[i][j][2] += b0;
        acc[i][j][3] += b1;
      }
      store_head_tile<T>(qs, strip(i), acc[i][0], acc[i][1]);
      store_head_tile<T>(ks, strip(i), acc[i][2], acc[i][3]);
      store_head_tile<T>(vs, strip(i), acc[i][4], acc[i][5]);
      store_head_tile<T>(dos, strip(i), dacc[i][0], dacc[i][1]);
    }

    const size_t row0 = (size_t)win * n;
    // dP = dout v^T one n-tile pair at a time (B: v as [key][d])
    const T* v_row = vs + ((lane & 7) + ((lane >> 4) << 3)) * kHS +
                     ((lane >> 3) & 1) * 8;
    // A of dv and dk: the staged tiles read transposed (rows: the phase's
    // queries, columns: keys)
    const int at_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * kPS +
                       ((lane >> 3) & 1) * 8;
    // the warp's rows of the staged tiles
    const int l0 = (16 * warp + g) * kPS + 2 * t4, l1 = l0 + 8 * kPS;
    const int own = (16 * warp + (lane & 15)) * kPS + (lane >> 4) * 8;
    float dv[kTcStrips][2][4], dk[kTcStrips][2][4];  // [key strip i][n-tile]
#pragma unroll
    for (int i = 0; i < kTcStrips; ++i) {
      zero(dv[i][0]);
      zero(dv[i][1]);
      zero(dk[i][0]);
      zero(dk[i][1]);
    }

#pragma unroll 1
    for (int ph = 0; ph * kTcWarps < nstrips; ++ph) {
      // the tiles are written and the staging read (phase 0), the previous
      // phase's T(p) and T(ds) tiles are read (later phases)
      __syncthreads();
      if (mine(ph)) {
        const int s = strip(ph);
        const int a_off = (16 * s + (lane & 15)) * kHS + (lane >> 4) * 8;
        uint32_t qa[4], da[4];
        ldsm_x4(qa, qs + a_off);
        ldsm_x4(da, dos + a_off);
        float sc[kNT][4];
        softmax_strip<T>(sc, qa, ks, s, nt, bias_h, masked ? lab : nullptr,
                         n, p.scale);
        auto dp_pair = [&](int q, float (&d)[2][4]) {
          uint32_t b[4];
          ldsm_x4(b, v_row + 16 * q * kHS);
          zero(d[0]);
          zero(d[1]);
          mma<T>(d[0], da, b[0], b[1]);
          mma<T>(d[1], da, b[2], b[3]);
        };
        float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
        for (int q = 0; q < kNT / 2; ++q) {
          if (2 * q < nt) {
            float d[2][4];
            dp_pair(q, d);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              dl0 += d[u][0] * sc[2 * q + u][0] + d[u][1] * sc[2 * q + u][1];
              dl1 += d[u][2] * sc[2 * q + u][2] + d[u][3] * sc[2 * q + u][3];
            }
          }
        }
        dl0 += __shfl_xor_sync(0xffffffffu, dl0, 1);
        dl0 += __shfl_xor_sync(0xffffffffu, dl0, 2);
        dl1 += __shfl_xor_sync(0xffffffffu, dl1, 1);
        dl1 += __shfl_xor_sync(0xffffffffu, dl1, 2);
        // ds = p32 (dp - delta): T(p) and T(ds * scale) to the tiles, ds to
        // the bias partials
        const int r0 = 16 * s + g, r1 = r0 + 8;
#pragma unroll
        for (int q = 0; q < kNT / 2; ++q) {
          if (2 * q < nt) {
            float d[2][4];
            dp_pair(q, d);
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int j = 2 * q + u, col = 8 * j + 2 * t4;
              const float* pr = sc[j];
              const float ds0 = pr[0] * (d[u][0] - dl0);
              const float ds1 = pr[1] * (d[u][1] - dl0);
              const float ds2 = pr[2] * (d[u][2] - dl1);
              const float ds3 = pr[3] * (d[u][3] - dl1);
              *reinterpret_cast<uint32_t*>(pt + l0 + 8 * j) =
                  pack<T>(pr[0], pr[1]);
              *reinterpret_cast<uint32_t*>(pt + l1 + 8 * j) =
                  pack<T>(pr[2], pr[3]);
              *reinterpret_cast<uint32_t*>(pd + l0 + 8 * j) =
                  pack<T>(ds0 * p.scale, ds1 * p.scale);
              *reinterpret_cast<uint32_t*>(pd + l1 + 8 * j) =
                  pack<T>(ds2 * p.scale, ds3 * p.scale);
              if (!(MEDSEG_ATTN_SKIP & 8)) {
                add_pair(part, r0, col, n, ds0, ds1);
                add_pair(part, r1, col, n, ds2, ds3);
              }
            }
          }
        }
        __syncwarp();
        // o = T(T(p) v) and dq = T(ds * scale) k, A from the warp's own
        // rows of the tiles
        float o[2][4];
        times_head_tile<T>(o, vs, nt, [&](int i, uint32_t(&a)[4]) {
          ldsm_x4(a, pt + own + 16 * i);
        });
        write_rows<T>(p.attn + row0 * c, c, h * kHD, s, n, o[0], o[1]);
        times_head_tile<T>(o, ks, nt, [&](int i, uint32_t(&a)[4]) {
          ldsm_x4(a, pd + own + 16 * i);
        });
        write_rows<T>(p.dqkv + row0 * 3 * c, 3 * c, h * kHD, s, n, o[0],
                      o[1]);
      }
      __syncthreads();  // the phase's T(p) and T(ds) rows are in the tiles

      // dv += T(p)^T dout, dk += T(ds * scale)^T q over the phase's queries
      const int ksteps = min(kTcWarps, nstrips - ph * kTcWarps);
      const int qrow = ph * kPhaseRows;
#pragma unroll
      for (int i = 0; i < kTcStrips; ++i) {
        if (!mine(i) || (MEDSEG_ATTN_SKIP & 16)) continue;
        const int key = strip(i);
        accum_head_tile<T>(dv[i], dos + qrow * kHS, ksteps,
                           [&](int k, uint32_t(&a)[4]) {
                             ldsm_x4_t(a, pt + at_off + 16 * k * kPS + 16 * key);
                           });
        accum_head_tile<T>(dk[i], qs + qrow * kHS, ksteps,
                           [&](int k, uint32_t(&a)[4]) {
                             ldsm_x4_t(a, pd + at_off + 16 * k * kPS + 16 * key);
                           });
      }
    }
#pragma unroll
    for (int i = 0; i < kTcStrips; ++i) {
      if (!mine(i)) continue;
      write_rows<T>(p.dqkv + row0 * 3 * c, 3 * c, c + h * kHD, strip(i), n,
                    dk[i][0], dk[i][1]);
      write_rows<T>(p.dqkv + row0 * 3 * c, 3 * c, 2 * c + h * kHD, strip(i),
                    n, dv[i][0], dv[i][1]);
    }
  }
}

// dx = LN backward of (dqkv . Wqkv) [+ dy] over tiles of kTile rows (strided
// over the grid); part (grid, 2c) takes the block's dLN sums.
template <class T>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_dx(const T* __restrict__ x,
                            const float* __restrict__ ln,
                            const T* __restrict__ wqkv,
                            const T* __restrict__ dqkv,
                            const T* __restrict__ dy,
                            T* __restrict__ dx,
                            float* __restrict__ part, long long m_total, int c,
                            int residual, float eps) {
  extern __shared__ float smem[];
  const int dstride = kTile + 1, as_stride = kPK + 1;
  float* mu = smem;                      // kTile
  float* rs = mu + kTile;                // kTile
  float* accs = rs + kTile;              // 2c
  float* dxn = accs + 2 * c;             // c x (kTile + 1)
  float* as = dxn + c * dstride;         // kTile x (kPK + 1)
  float* wsm = as + kTile * as_stride;   // kPK x c
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ntiles = (m_total + kTile - 1) / kTile;
  const int c3 = 3 * c;

  for (int e = tid; e < 2 * c; e += kThreads) accs[e] = 0.f;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * kTile;
    const int rows = (int)min((long long)kTile, m_total - r0);
    __syncthreads();  // the previous tile's readers are done
    if (ln != nullptr) {
      for (int r = warp; r < rows; r += kWarps) {
        float m, v;
        row_stats(x + (r0 + r) * c, c, eps, &m, &v);
        if (lane == 0) {
          mu[r] = m;
          rs[r] = v;
        }
      }
    }
    for (int e = tid; e < c * dstride; e += kThreads) dxn[e] = 0.f;
    for (int j0 = 0; j0 < c3; j0 += kPK) {
      __syncthreads();
      for (int e = tid; e < kTile * kPK; e += kThreads) {
        const int r = e / kPK, kk = e - r * kPK;
        as[r * as_stride + kk] = (r < rows && j0 + kk < c3)
                                     ? ld(dqkv + (r0 + r) * c3 + j0 + kk)
                                     : 0.f;
      }
      for (int e = tid; e < kPK * c; e += kThreads) {
        const int kk = e / c;
        wsm[e] = j0 + kk < c3 ? ld(wqkv + (size_t)j0 * c + e) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < c * kTile; e += kThreads) {
        const int ch = e / kTile, r = e - ch * kTile;
        const float* ar = as + r * as_stride;
        float a = 0.f;
#pragma unroll
        for (int kk = 0; kk < kPK; ++kk) a += ar[kk] * wsm[kk * c + ch];
        dxn[ch * dstride + r] += a;
      }
    }
    __syncthreads();
    ln_backward_tile(x, dy, ln, mu, rs, dxn, r0, rows, c, residual, dx, accs);
  }
  __syncthreads();
  for (int e = tid; e < 2 * c; e += kThreads)
    part[(size_t)blockIdx.x * 2 * c + e] = accs[e];
}

// grid (4c / kJB row groups, shares). Rows [0, 3c) are dWqkv = dqkv^T . xn
// with dbqkv, rows [3c, 4c) dWproj = dy^T . o with dbproj. Partials per
// share: (4c x c) weights | (4c) biases. kJB, the rows a block owns, is 16,
// or 8 where C is an odd multiple of 8 (C = 24), so that no block straddles
// the border of the two products at row 3C. kWide: C up to kMaxC, else up to
// kNarrowC.
template <class T, int kJB, bool kWide>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_dw(const T* __restrict__ x,
                            const float* __restrict__ ln,
                            const T* __restrict__ attn,
                            const T* __restrict__ dqkv,
                            const T* __restrict__ dy,
                            float* __restrict__ part, long long m_total, int c,
                            float eps) {
  extern __shared__ float smem[];
  const int stride = c + 1, lstride = kJB + 1;
  float* mu = smem;                 // kTile
  float* rs = mu + kTile;           // kTile
  float* xs = rs + kTile;           // kTile x (c + 1)
  float* ls = xs + kTile * stride;  // kTile x (kJB + 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kJB, c3 = 3 * c, ne = kJB * c;
  const bool qkv_side = j0 < c3;
  const T* left = qkv_side ? dqkv + j0 : dy + (j0 - c3);
  const int left_stride = qkv_side ? c3 : c;
  const T* right = qkv_side ? x : attn;
  const float* lnr = qkv_side ? ln : nullptr;
  const long long ntiles = (m_total + kTile - 1) / kTile;

  constexpr int kMaxE = kJB * (kWide ? kMaxC : kNarrowC) / kThreads;
  float acc[kMaxE];
#pragma unroll
  for (int i = 0; i < kMaxE; ++i) acc[i] = 0.f;
  float accb = 0.f;

  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long r0 = tile * kTile;
    const int rows = (int)min((long long)kTile, m_total - r0);
    __syncthreads();
    if (lnr != nullptr) {
      for (int r = warp; r < rows; r += kWarps) {
        float m, v;
        row_stats(x + (r0 + r) * c, c, eps, &m, &v);
        if (lane == 0) {
          mu[r] = m;
          rs[r] = v;
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < kTile * c; e += kThreads) {
      const int r = e / c, ch = e - r * c;
      float v = 0.f;
      if (r < rows) {
        v = ld(right + (r0 + r) * c + ch);
        if (lnr != nullptr)
          v = round_to<T>((v - mu[r]) * rs[r] * lnr[ch] + lnr[c + ch]);
      }
      xs[r * stride + ch] = v;
    }
    for (int e = tid; e < kTile * kJB; e += kThreads) {
      const int r = e / kJB, j = e - r * kJB;
      ls[r * lstride + j] =
          r < rows ? ld(left + (r0 + r) * left_stride + j) : 0.f;
    }
    __syncthreads();
    outer_accumulate<kMaxE>(ls, lstride, xs, stride, c, ne, acc);
    if (tid < kJB) {
      float a = 0.f;
      for (int r = 0; r < kTile; ++r) a += ls[r * lstride + tid];
      accb += a;
    }
  }

  float* p = part + (size_t)blockIdx.y * (4 * (size_t)c * c + 4 * c);
#pragma unroll
  for (int i = 0; i < kMaxE; ++i) {
    const int e = tid + i * kThreads;
    if (e < ne) p[(size_t)j0 * c + e] = acc[i];
  }
  if (tid < kJB) p[4 * (size_t)c * c + j0 + tid] = accb;
}

// ---- tensor-core dx and dw launches

template <class T>
struct GemmBwdParams {
  const T* x;            // (M, C) raw tokens
  const float* ln;       // (2, C) or nullptr
  const T* wqkv;         // (3C, C)
  const T* dqkv;         // (M, 3C)
  const T* dy;           // (M, C)
  const T* attn;         // (M, C) o
  T* dx;                 // (M, C)
  float* part_ln;        // (dx blocks, 2C): dscale | dbias_ln
  float* part_w;         // (shares, 4C * C + 4C), as out_w
  float2* stats;         // (M): the dx launch's (mu, rstd) for the dw launch
  long long m;
  int c, residual, parts, cs;
  float eps;
};

// grid: blocks strided over the token tiles (kMlpRows / parts rows each),
// as fused_mlp_bwd_dx_tc (mlp_bwd.cu): dxn = dqkv . Wqkv with A the dqkv
// rows of the tile and B the rows of Wqkv ([k][channel], ldmatrix.trans),
// both copied by cp.async in chunks of 64 of the 3C k rows into two slots;
// at C <= 96 a warp owns a 16-row strip and all C columns, at C = 192, 384
// the warps split the columns into parts and add the LayerNorm's row sums
// through shared memory. Then the LayerNorm backward on the accumulators, dx
// [+ dy], the block's dLN sums, and each row's (mu, rstd) to p.stats for
// the dw launch.
template <class T, int kMaxP>
__global__ void __launch_bounds__(mlptile::kMlpThreads, 3)
    window_attention_bwd_dx_tc(GemmBwdParams<T> p, int nslots) {
  using namespace mmatile;
  using namespace mlptile;
  extern __shared__ __align__(16) unsigned char smem_dx[];
  const int c = p.c, c3 = 3 * c, xsd = c + 8, parts = p.parts;
  const int strips = kMlpWarps / parts, rows_t = 16 * strips, cp = c / parts;
  constexpr int dsd = kChunk + 8;  // stride of a dqkv chunk [token][k]
  float* mu = reinterpret_cast<float*>(smem_dx);  // kMlpRows
  float* rs = mu + kMlpRows;                      // kMlpRows
  float* red = rs + kMlpRows;                     // kMlpWarps x 16 x 2
  float* accs = red + kMlpWarps * 32;             // strips x 2c
  T* wbuf = reinterpret_cast<T*>(accs + strips * 2 * c);
  const int slot = kChunk * xsd + rows_t * dsd;   // [Wqkv rows | dqkv chunk]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int sw = warp % strips, q = warp / strips, col0 = q * cp;
  const long long ntiles = (p.m + rows_t - 1) / rows_t;
  const int nch = (c3 + kChunk - 1) / kChunk;
  const float* ls = (MEDSEG_ATTN_SKIP & 64) ? nullptr : p.ln;

  if (MEDSEG_ATTN_SKIP & 96)  // what a skipped load leaves is zero
    zero_smem(smem_dx, (char*)(wbuf + nslots * slot) - (char*)smem_dx);
  __syncthreads();
  for (int e = threadIdx.x; e < strips * 2 * c; e += kMlpThreads) accs[e] = 0.f;
  auto stage_chunk = [&](int k, long long r0, int rows, int s) {
    if (MEDSEG_ATTN_SKIP & 32) return;
    T* ws = wbuf + s * slot;
    const int j0 = k * kChunk, units = min(kChunk, c3 - j0);
    copy_rows_async(p.wqkv + (size_t)j0 * c, c, units, c, ws, xsd);
    copy_rows_async(p.dqkv + r0 * c3 + j0, c3, rows, units, ws + kChunk * xsd,
                    dsd);
  };
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * rows_t;
    const int rows = (int)min((long long)rows_t, p.m - r0);
    __syncthreads();  // the previous tile's readers of the slots, mu, red
    stage_chunk(0, r0, rows, 0);
    cp_async_commit();
    if (ls != nullptr) window_stats(p.x + r0 * c, rows, c, p.eps, mu, rs);
    float acc[kMaxP / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) zero(acc[j]);
    for (int k = 0; k < nch; ++k) {
      if (nslots > 1 && k + 1 < nch) {
        stage_chunk(k + 1, r0, rows, (k + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (k == 0 && ls != nullptr && p.stats != nullptr)
        for (int r = threadIdx.x; r < rows; r += kMlpThreads)
          p.stats[r0 + r] = make_float2(mu[r], rs[r]);
      const T* ws = wbuf + (nslots > 1 ? (k & 1) : 0) * slot;
      const T* dqs = ws + kChunk * xsd;
      const int np = min(kChunk, c3 - k * kChunk) / 16;
      const T* a_row = dqs + (16 * sw + (lane & 15)) * dsd + (lane >> 4) * 8;
      const T* b_row = ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * xsd + col0 +
                       (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < np) {
          uint32_t a[4];
          ldsm_x4(a, a_row + 16 * kk);
#pragma unroll
          for (int o0 = 0; o0 < kMaxP / 16; o0 += 3) {  // three pairs in flight
            uint32_t b[3][4];
#pragma unroll
            for (int u = 0; u < 3; ++u)
              if (o0 + u < kMaxP / 16 && 16 * (o0 + u) < cp)
                ldsm_x4_t(b[u], b_row + 16 * kk * xsd + 16 * (o0 + u));
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              if (o0 + u < kMaxP / 16 && 16 * (o0 + u) < cp) {
                mma<T>(acc[2 * (o0 + u)], a, b[u][0], b[u][1]);
                mma<T>(acc[2 * (o0 + u) + 1], a, b[u][2], b[u][3]);
              }
            }
          }
        }
      }
      __syncthreads();  // the slot's readers are done
      if (nslots == 1 && k + 1 < nch) {
        stage_chunk(k + 1, r0, rows, 0);
        cp_async_commit();
      }
    }
    if (MEDSEG_ATTN_SKIP & 256) continue;

    // LayerNorm backward: the row sums of dxh = dxn * scale and dxh * xhat
    // over the warp's columns, then across the parts through shared memory
    const int lr[2] = {16 * sw + g, 16 * sw + g + 8};
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
    if (ls != nullptr) {
#pragma unroll
      for (int j = 0; j < kMaxP / 8; ++j) {
        if (8 * j < cp) {
          const int ch = col0 + 8 * j + 2 * t4;
          const float2 sc = *reinterpret_cast<const float2*>(ls + ch);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            if (lr[hf] < rows) {
              const T* xr = p.x + (r0 + lr[hf]) * c + ch;
              const float xh0 = (to_f32(xr[0]) - mu[lr[hf]]) * rs[lr[hf]];
              const float xh1 = (to_f32(xr[1]) - mu[lr[hf]]) * rs[lr[hf]];
              const float d0 = acc[j][2 * hf] * sc.x,
                          d1 = acc[j][2 * hf + 1] * sc.y;
              m1[hf] += d0 + d1;
              m2[hf] += d0 * xh0 + d1 * xh1;
            }
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        m1[hf] += __shfl_xor_sync(0xffffffffu, m1[hf], 1);
        m1[hf] += __shfl_xor_sync(0xffffffffu, m1[hf], 2);
        m2[hf] += __shfl_xor_sync(0xffffffffu, m2[hf], 1);
        m2[hf] += __shfl_xor_sync(0xffffffffu, m2[hf], 2);
        if (t4 == 0) {
          red[warp * 32 + 2 * (g + 8 * hf)] = m1[hf];
          red[warp * 32 + 2 * (g + 8 * hf) + 1] = m2[hf];
        }
      }
      __syncthreads();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float a = 0.f, b = 0.f;
        for (int qq = 0; qq < parts; ++qq) {  // in order: reruns bit-equal
          a += red[(sw + qq * strips) * 32 + 2 * (g + 8 * hf)];
          b += red[(sw + qq * strips) * 32 + 2 * (g + 8 * hf) + 1];
        }
        m1[hf] = a / c;
        m2[hf] = b / c;
      }
    }
    float* acc_s = accs + sw * 2 * c;
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) {
      if (8 * j < cp) {
        const int ch = col0 + 8 * j + 2 * t4;
        const float2 sc = ls != nullptr
                              ? *reinterpret_cast<const float2*>(ls + ch)
                              : make_float2(1.f, 1.f);
        // column sums over the thread's two rows: dxn * xhat, dxn
        float su[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (lr[hf] < rows) {
            const long long row = r0 + lr[hf];
            const float n0 = acc[j][2 * hf], n1 = acc[j][2 * hf + 1];
            float o0 = n0, o1 = n1;
            if (ls != nullptr) {
              const T* xr = p.x + row * c + ch;
              const float r = rs[lr[hf]], mm = mu[lr[hf]];
              const float xh0 = (to_f32(xr[0]) - mm) * r;
              const float xh1 = (to_f32(xr[1]) - mm) * r;
              o0 = (n0 * sc.x - m1[hf] - xh0 * m2[hf]) * r;
              o1 = (n1 * sc.y - m1[hf] - xh1 * m2[hf]) * r;
              su[0] += n0 * xh0;
              su[1] += n1 * xh1;
              su[2] += n0;
              su[3] += n1;
            }
            if (p.residual) {
              const T* dr = p.dy + row * c + ch;
              o0 += to_f32(dr[0]);
              o1 += to_f32(dr[1]);
            }
            *reinterpret_cast<uint32_t*>(p.dx + row * c + ch) = pack<T>(o0, o1);
          }
        }
        if (ls != nullptr) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            su[i] += __shfl_xor_sync(0xffffffffu, su[i], 4);
            su[i] += __shfl_xor_sync(0xffffffffu, su[i], 8);
            su[i] += __shfl_xor_sync(0xffffffffu, su[i], 16);
          }
          if (g == 0) {  // one lane a column pair, in tile order
            acc_s[ch] += su[0];
            acc_s[ch + 1] += su[1];
            acc_s[c + ch] += su[2];
            acc_s[c + ch + 1] += su[3];
          }
        }
      }
    }
  }
  if (p.ln == nullptr) return;  // no dLN: part_ln is not read
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * c; e += kMlpThreads) {
    float a = 0.f;
    for (int s = 0; s < strips; ++s) a += accs[s * 2 * c + e];
    p.part_ln[(size_t)blockIdx.x * 2 * c + e] = a;
  }
}

// token tiles between two flushes of the dw launch: 2048 tokens, 128
// k-steps of its products
constexpr int kFlushTiles = 32;

// grid (row groups x channel slices, token shares). The 4C rows of
// [dWqkv | dWproj] (each 16-row m-tile on one side of 3C) are cut into
// groups of kRB = 64 kMT rows, a warp owning kMT m-tiles, and the C columns
// into slices of cs; a block owns a group x slice in mma fragments and walks
// its share of the 64-token tiles. Per tile it copies by cp.async the
// columns of dqkv (rows < 3C) and dy (rows >= 3C) that its rows take ([token]
// [row] tile: A = its transpose through ldmatrix.trans, the tokens the k
// dimension) and the slice of x (with the LayerNorm applied in place from
// the dx launch's statistics) and of o (B, [token][channel] through
// ldmatrix.trans). The bias gradients are the same A times a B of ones. The
// fragments are added, rounding to nearest, into the share's fp32 slab
// every kFlushTiles tiles (mma.sync adds by truncation); slice 0 adds the
// bias sums. The wrapper's sum_partials adds the slabs in a fixed order.
template <class T, int kMaxS, int kMT>
__global__ void __launch_bounds__(mlptile::kMlpThreads, kMT == 3 ? 3 : 2)
    window_attention_bwd_dw_tc(GemmBwdParams<T> p) {
  using namespace mmatile;
  using namespace mlptile;
  constexpr int kRB = 16 * kMT * kMlpWarps;  // dW rows a block owns
  constexpr int kLS = kRB + 8, kXS = kMaxS + 8;
  extern __shared__ __align__(16) unsigned char smem_dw[];
  float* mu = reinterpret_cast<float*>(smem_dw);  // kMlpRows
  float* rs = mu + kMlpRows;                      // kMlpRows
  T* left = reinterpret_cast<T*>(rs + kMlpRows);  // kMlpRows x kLS
  T* xs = left + kMlpRows * kLS;                  // kMlpRows x kXS: T(LN(x))
  T* os = xs + kMlpRows * kXS;                    // kMlpRows x kXS: o
  const int c = p.c, c3 = 3 * c, c4 = 4 * c, cs = p.cs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int ngroups = (c4 + kRB - 1) / kRB;
  const int grp = blockIdx.x % ngroups, sl = blockIdx.x / ngroups;
  const int rlo = grp * kRB, rhi = min(rlo + kRB, c4), c0 = sl * cs;
  const bool has_x = rlo < c3, has_o = rhi > c3;
  const int wr0 = rlo + 16 * kMT * warp;  // the warp's first dW row
  bool live[kMT], side[kMT];              // side: a dWproj m-tile
  bool warp_x = false, warp_o = false;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    live[mi] = wr0 + 16 * mi < rhi;
    side[mi] = wr0 + 16 * mi >= c3;
    warp_x |= live[mi] && !side[mi];
    warp_o |= live[mi] && side[mi];
  }
  const long long ntiles = (p.m + kMlpRows - 1) / kMlpRows;
  float* slab = p.part_w + (size_t)blockIdx.y * (4 * (size_t)c * c + c4);
  const float* ln = (MEDSEG_ATTN_SKIP & 64) ? nullptr : p.ln;
  if (MEDSEG_ATTN_SKIP & 32) {  // what a skipped load leaves is zero
    zero_smem(smem_dw, sizeof(float) * 2 * kMlpRows +
                           sizeof(T) * kMlpRows * (kLS + 2 * kXS));
    __syncthreads();
  }

  float acc[kMT][kMaxS / 8][4], db[kMT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    zero(db[mi]);
#pragma unroll
    for (int j = 0; j < kMaxS / 8; ++j) zero(acc[mi][j]);
  }
  bool flushed = false;
  // add the fragments (rounding to nearest) into the slab, an n-tile at a
  // time with its loads in flight together, then zero them; the first flush
  // stores
  auto flush = [&]() {
    if (MEDSEG_ATTN_SKIP & 128) return;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      if (!live[mi]) continue;
      const int row0 = wr0 + 16 * mi + g, row1 = row0 + 8;
#pragma unroll
      for (int j = 0; j < kMaxS / 8; ++j) {
        if (8 * j < cs) {
          const int ch = c0 + 8 * j + 2 * t4;
          float2* at0 = reinterpret_cast<float2*>(slab + (size_t)row0 * c + ch);
          float2* at1 = reinterpret_cast<float2*>(slab + (size_t)row1 * c + ch);
          const float2 o0 = flushed ? *at0 : make_float2(0.f, 0.f);
          const float2 o1 = flushed ? *at1 : make_float2(0.f, 0.f);
          *at0 = make_float2(o0.x + acc[mi][j][0], o0.y + acc[mi][j][1]);
          *at1 = make_float2(o1.x + acc[mi][j][2], o1.y + acc[mi][j][3]);
          zero(acc[mi][j]);
        }
      }
      if (sl == 0 && t4 == 0) {  // column 0 of the sums against ones
        float* b = slab + 4 * (size_t)c * c;
        b[row0] = (flushed ? b[row0] : 0.f) + db[mi][0];
        b[row1] = (flushed ? b[row1] : 0.f) + db[mi][2];
      }
      zero(db[mi]);
    }
    flushed = true;
  };

  const uint32_t ones = pack<T>(1.f, 1.f);
  // A: the tile's [token][row] columns read transposed; B: [token][channel]
  // read transposed (as K4's dW products)
  const int a_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * kLS +
                    ((lane >> 3) & 1) * 8 + (wr0 - rlo);
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kXS +
                    (lane >> 4) * 8;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  int pending = 0;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long r0 = tile * kMlpRows;
    const int rows = (int)min((long long)kMlpRows, p.m - r0);
    __syncthreads();  // the previous tile's readers are done
    if (!(MEDSEG_ATTN_SKIP & 32)) {
      if (has_x) {
        copy_rows_async(p.dqkv + r0 * c3 + rlo, c3, rows, min(rhi, c3) - rlo,
                        left, kLS);
        copy_rows_async(p.x + r0 * c + c0, c, rows, cs, xs, kXS);
      }
      if (has_o) {
        const int o_lo = max(rlo, c3);
        copy_rows_async(p.dy + r0 * c + (o_lo - c3), c, rows, rhi - o_lo,
                        left + (o_lo - rlo), kLS);
        copy_rows_async(p.attn + r0 * c + c0, c, rows, cs, os, kXS);
      }
      cp_async_commit();
      // rows past the end add nothing: zero
      for (int e = threadIdx.x; e < (kMlpRows - rows) * (kLS / 8);
           e += kMlpThreads)
        reinterpret_cast<uint4*>(left + rows * kLS)[e] = zero4;
      for (int e = threadIdx.x; e < (kMlpRows - rows) * (kXS / 8);
           e += kMlpThreads) {
        reinterpret_cast<uint4*>(xs + rows * kXS)[e] = zero4;
        reinterpret_cast<uint4*>(os + rows * kXS)[e] = zero4;
      }
      if (has_x && ln != nullptr)
        for (int r = threadIdx.x; r < rows; r += kMlpThreads) {
          const float2 st = p.stats[r0 + r];
          mu[r] = st.x;
          rs[r] = st.y;
        }
      cp_async_wait<0>();
    }
    __syncthreads();
    if (has_x && ln != nullptr) {  // xs = T(LN(x)) in place
      const int vecs = cs / 8;
      for (int e = threadIdx.x; e < rows * vecs; e += kMlpThreads) {
        const int r = e / vecs, v8 = (e - r * vecs) * 8;
        uint4* at = reinterpret_cast<uint4*>(xs + r * kXS + v8);
        const uint4 in = *at;
        const T* iv = reinterpret_cast<const T*>(&in);
        uint4 o;
        uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
        const float m = mu[r], rr = rs[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ch = c0 + v8 + 2 * i;
          ov[i] = pack<T>(
              (to_f32(iv[2 * i]) - m) * rr * ln[ch] + ln[c + ch],
              (to_f32(iv[2 * i + 1]) - m) * rr * ln[ch + 1] + ln[c + ch + 1]);
        }
        *at = o;
      }
      __syncthreads();
    }
    for (int ks = 0; ks < kMlpRows / 16; ++ks) {
      if (16 * ks >= rows) break;
      uint32_t a[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        if (live[mi]) {
          ldsm_x4_t(a[mi], left + a_off + 16 * ks * kLS + 16 * mi);
          if (sl == 0) mma<T>(db[mi], a[mi], ones, ones);
        }
      }
#pragma unroll
      for (int q = 0; q < kMaxS / 16; ++q) {
        if (16 * q < cs) {
          uint32_t bx[4] = {0u, 0u, 0u, 0u}, bo[4] = {0u, 0u, 0u, 0u};
          if (warp_x) ldsm_x4_t(bx, xs + b_off + 16 * ks * kXS + 16 * q);
          if (warp_o) ldsm_x4_t(bo, os + b_off + 16 * ks * kXS + 16 * q);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            if (live[mi]) {
              const uint32_t b0 = side[mi] ? bo[0] : bx[0];
              const uint32_t b1 = side[mi] ? bo[1] : bx[1];
              const uint32_t b2 = side[mi] ? bo[2] : bx[2];
              const uint32_t b3 = side[mi] ? bo[3] : bx[3];
              mma<T>(acc[mi][2 * q], a[mi], b0, b1);
              mma<T>(acc[mi][2 * q + 1], a[mi], b2, b3);
            }
          }
        }
      }
    }
    if (++pending == kFlushTiles) {
      flush();
      pending = 0;
    }
  }
  flush();  // the rest; a block with no tile stores zeros
}

// The sums of the three kinds of partials, each in a fixed order: dbias
// over nchunk slabs, dLN over the dx launch's blocks (with ln), the weight
// gradients over the dw launch's shares.
int sum_all(const float* dbias_part, void* dbias, const void* part_ln,
            void* out_ln, const void* part_w, void* out_w, bool ln, int nchunk,
            int dx_blocks, int nshare, long long bias_len, int c,
            cudaStream_t st) {
  cudaError_t err = sum_partials(dbias_part, static_cast<float*>(dbias),
                                 nchunk, bias_len, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ln) {
    err = sum_partials(static_cast<const float*>(part_ln),
                       static_cast<float*>(out_ln), dx_blocks,
                       2 * (long long)c, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = sum_partials(static_cast<const float*>(part_w),
                     static_cast<float*>(out_w), nshare,
                     4 * (long long)c * c + 4 * c, st);
  return static_cast<int>(err);
}

template <class T, int HD>
cudaError_t launch_heads(const BwdHeadsParams<T>& p, int nchunk, int nh,
                         cudaStream_t st) {
  const int n = p.n, q3 = 3 * p.hd;
  const size_t smem = sizeof(float) * (5 * n + n * (kKC + 1) + kKC * q3 +
                                       n * (q3 + 1) + n * (p.hd + 1) +
                                       2 * kWarps * n);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd_heads<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_bwd_heads<T, HD><<<dim3(nchunk, nh), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_heads_tc(const BwdHeadsParams<T>& p, int nchunk, int nh,
                            cudaStream_t st) {
  using namespace mmatile;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = 3 * sizeof(float) * kMaxNP +
                        sizeof(T) * (4 * kMaxNP * kHS + 2 * kPhaseRows * kPS);
    static_assert(2 * kMaxNP * kTcXS + 3 * kHD * kTcXS + kTcChunk * kHS <=
                      2 * kPhaseRows * kPS,
                  "the projection's staging must fit the T(p), T(ds) tiles");
    cudaError_t err = cudaFuncSetAttribute(
        window_attention_bwd_heads_tc<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    window_attention_bwd_heads_tc<T>
        <<<dim3(nchunk, nh), kTcThreads, smem, st>>>(p);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // fp32 keeps the CUDA cores
  }
}

// The tensor-core dx and dw launches: dx over at most grid_dx blocks (the
// rows of part_ln), dw over at most nsplit token shares (the slabs of
// part_w), each cut to the blocks resident on the card at once; the blocks
// and shares launched come back in *dx_blocks and *nshare.
template <class T>
cudaError_t launch_gemm_tc(const GemmBwdParams<T>& p, int grid_dx, int nsplit,
                           int* dx_blocks, int* nshare, cudaStream_t st) {
  using namespace mlptile;
  if constexpr (sizeof(T) == 2) {
    const int c = p.c, strips = kMlpWarps / p.parts, xsd = c + 8;
    const size_t base = sizeof(float) * (2 * kMlpRows + kMlpWarps * 32 +
                                         strips * 2 * c);
    const size_t slot =
        sizeof(T) * (kChunk * xsd + 16 * strips * (kChunk + 8));
    const int cands[2] = {2, 1};
    auto dx_kernel = c / p.parts <= 48 ? window_attention_bwd_dx_tc<T, 48>
                                       : window_attention_bwd_dx_tc<T, 96>;
    int nslots = 0;
    size_t smem = 0;
    cudaError_t err =
        pick_slots(dx_kernel, base, slot, cands, 2, &nslots, &smem);
    if (err != cudaSuccess) return err;
    if (nslots == 0) return cudaErrorInvalidValue;
    err = resident_grid(dx_kernel, kMlpThreads, smem, grid_dx, dx_blocks);
    if (err != cudaSuccess) return err;
    dx_kernel<<<*dx_blocks, kMlpThreads, smem, st>>>(p, nslots);
    err = cudaGetLastError();
    if (err != cudaSuccess || (MEDSEG_ATTN_SKIP & 512)) return err;

    const bool narrow = c <= 48;
    const int rb = narrow ? 3 * 16 * kMlpWarps : 2 * 16 * kMlpWarps;
    const int groups = (4 * c + rb - 1) / rb * (c / p.cs);
    const size_t smem_dw =
        sizeof(float) * 2 * kMlpRows +
        sizeof(T) * kMlpRows * (rb + 8 + 2 * ((narrow ? 48 : 96) + 8));
    auto dw_kernel = narrow ? window_attention_bwd_dw_tc<T, 48, 3>
                            : window_attention_bwd_dw_tc<T, 96, 2>;
    err = cudaFuncSetAttribute(
        dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dw);
    if (err != cudaSuccess) return err;
    int total = 0;
    err = resident_grid(dw_kernel, kMlpThreads, smem_dw, nsplit * groups,
                        &total);
    if (err != cudaSuccess) return err;
    *nshare = max(1, min(nsplit, total / groups));
    dw_kernel<<<dim3(groups, *nshare), kMlpThreads, smem_dw, st>>>(p);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;  // fp32 keeps the CUDA cores
  }
}

template <class T, int kJB, bool kWide>
cudaError_t launch_dw(const BwdHeadsParams<T>& p, void* part_w,
                      long long m_total, int c, int nsplit, float ln_eps,
                      cudaStream_t st) {
  const size_t smem_dw =
      sizeof(float) * (2 * kTile + kTile * (c + 1) + kTile * (kJB + 1));
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd_dw<T, kJB, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dw);
  if (err != cudaSuccess) return err;
  window_attention_bwd_dw<T, kJB, kWide>
      <<<dim3(4 * c / kJB, nsplit), kThreads, smem_dw, st>>>(
      p.x, p.ln, p.attn, p.dqkv, p.dy, static_cast<float*>(part_w), m_total,
      c, ln_eps);
  return cudaGetLastError();
}

template <class T>
int launch_bwd(BwdHeadsParams<T> p, const void* ln, void* dx, void* dbias,
               void* part_ln, void* out_ln, void* part_w, void* out_w,
               void* ln_stats, int nh, int residual, int nchunk, int grid_dx,
               int nsplit, int route, int gemm_route, float ln_eps,
               cudaStream_t st) {
  const int t = p.t, n = p.n, c = p.c;
  cudaError_t err = (MEDSEG_ATTN_SKIP & 1024) ? cudaSuccess
                    : route == kRouteTensorCore
                        ? launch_heads_tc(p, nchunk, nh, st)
                    : p.hd <= 16 ? launch_heads<T, 16>(p, nchunk, nh, st)
                                 : launch_heads<T, 32>(p, nchunk, nh, st);
  if (err != cudaSuccess || (MEDSEG_ATTN_SKIP & 4)) return static_cast<int>(err);

  const long long m_total = (long long)t * n;
  if (gemm_route == kRouteTensorCore) {
    GemmBwdParams<T> g;
    g.x = p.x;
    g.ln = static_cast<const float*>(ln);
    g.wqkv = p.wqkv;
    g.dqkv = p.dqkv;
    g.dy = p.dy;
    g.attn = p.attn;
    g.dx = static_cast<T*>(dx);
    g.part_ln = static_cast<float*>(part_ln);
    g.part_w = static_cast<float*>(part_w);
    g.stats = static_cast<float2*>(ln_stats);
    g.m = m_total;
    g.c = c; g.residual = residual; g.parts = mlptile::mlp_dx_parts(c);
    g.cs = mlptile::gemm_width(c); g.eps = ln_eps;
    err = launch_gemm_tc(g, grid_dx, nsplit, &grid_dx, &nsplit, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return sum_all(p.dbias_part, dbias, part_ln, out_ln, part_w, out_w,
                   ln != nullptr, nchunk, grid_dx, nsplit, nh * n * n, c, st);
  }
  const size_t smem_dx =
      sizeof(float) * (2 * kTile + 2 * c + c * (kTile + 1) +
                       kTile * (kPK + 1) + kPK * c);
  err = cudaFuncSetAttribute(window_attention_bwd_dx<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dx);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd_dx<T><<<grid_dx, kThreads, smem_dx, st>>>(
      p.x, p.ln, p.wqkv, p.dqkv, p.dy, static_cast<T*>(dx),
      static_cast<float*>(part_ln), m_total, c, residual, ln_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dw = [&](auto wide) {
    constexpr bool kWide = decltype(wide)::value;
    return c % 16 == 0
               ? launch_dw<T, 16, kWide>(p, part_w, m_total, c, nsplit, ln_eps,
                                         st)
               : launch_dw<T, 8, kWide>(p, part_w, m_total, c, nsplit, ln_eps,
                                        st);
  };
  err = c > kNarrowC ? dw(std::true_type{}) : dw(std::false_type{});
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_all(p.dbias_part, dbias, part_ln, out_ln, part_w, out_w,
                 ln != nullptr, nchunk, grid_dx, nsplit, nh * n * n, c, st);
}

}  // namespace
}  // namespace medseg

// Pointers as in BwdHeadsParams; dx (T, N, C) and the activations, weights,
// attn and dqkv of the element type named by dtype. Scratch: dbias_part
// (nchunk, nh, N, N; zero-filled by the caller for kRouteTensorCore), part_ln
// (grid_dx, 2c), part_w (nsplit, 4c*c + 4c), ln_stats (T * N float2; with ln
// on the tensor-core GEMM route, else unused and may be NULL).
// Results (fp32): dbias (nh, N, N), out_ln (2c) = dscale | dbias_ln, out_w =
// dWqkv (3c x c) | dWproj (c x c) | dbqkv (3c) | dbproj (c). c must be a
// multiple of 8 up to 768. route, of the heads launch: kRouteTensorCore
// (bf16 or fp16, head dim 16, n <= 224; bias_t unused, may be NULL) or
// kRouteCudaCore.
// gemm_route, of the dx and dw launches: kRouteTensorCore (bf16 or fp16, c
// as mlptile::gemm_route_takes says; x, wqkv, dy on 16-byte boundaries;
// grid_dx and nsplit are then the most blocks and token shares the two
// launches may take) or kRouteCudaCore (grid_dx blocks, nsplit shares).
extern "C" int medseg_window_attention_bwd(
    const void* x, const void* ln, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bias, const void* bias_t, const void* dy,
    void* attn, void* dqkv, void* dx, void* dbias_part, void* dbias,
    void* part_ln, void* out_ln, void* part_w, void* out_w, void* ln_stats,
    int t, int n, int c, int nh, int w0, int w1, int w2, int s0, int s1,
    int s2, int nwd, int nwh, int nww, int shifted, int residual, int nchunk,
    int grid_dx, int nsplit, int gemm_route, int route, int dtype,
    float ln_eps, float scale, void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = c / nh;
  if (hd * nh != c || hd > 32 || hd < 1 || n < 1 || t < 1 || c % 8 != 0 ||
      c > kMaxC || nchunk < 1 || grid_dx < 1 || nsplit < 1 ||
      !route_takes(route, dtype, n, c, hd) ||
      (route == kRouteCudaCore && bias_t == nullptr) ||
      !mlptile::gemm_route_takes(gemm_route, dtype, c) ||
      (gemm_route == kRouteTensorCore && ln != nullptr && ln_stats == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // every chunk must hold a window, or its slab of partials stays unwritten
  const int wins_per_chunk = (t + nchunk - 1) / nchunk;
  if ((long long)(nchunk - 1) * wins_per_chunk >= t)
    return static_cast<int>(cudaErrorInvalidValue);

  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    BwdHeadsParams<T> p;
    p.x = static_cast<const T*>(x);
    p.ln = static_cast<const float*>(ln);
    p.wqkv = static_cast<const T*>(wqkv);
    p.bqkv = static_cast<const float*>(bqkv);
    p.wproj = static_cast<const T*>(wproj);
    p.bias = static_cast<const float*>(bias);
    p.bias_t = static_cast<const float*>(bias_t);
    p.dy = static_cast<const T*>(dy);
    p.attn = static_cast<T*>(attn);
    p.dqkv = static_cast<T*>(dqkv);
    p.dbias_part = static_cast<float*>(dbias_part);
    p.t = t; p.n = n; p.c = c; p.hd = hd;
    p.wins_per_chunk = wins_per_chunk;
    p.w0 = w0; p.w1 = w1; p.w2 = w2; p.s0 = s0; p.s1 = s1; p.s2 = s2;
    p.nwd = nwd; p.nwh = nwh; p.nww = nww;
    p.shifted = shifted; p.eps = ln_eps; p.scale = scale;
    return launch_bwd(p, ln, dx, dbias, part_ln, out_ln, part_w, out_w,
                      ln_stats, nh, residual, nchunk, grid_dx, nsplit, route,
                      gemm_route, ln_eps, st);
  });
}
