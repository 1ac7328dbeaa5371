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
// No (N, N) matrix and no LayerNorm output reaches device memory.
//
// Design. The TPU kernels walk the window tiles in order on one core, with
// all weight gradients and the (nh, N, N) bias gradient in scratch memory
// from the first tile to the last. Here blocks run side by side:
//  1. window_attention_bwd_heads: a block owns one head and a run of
//     windows. Per window it projects its head's q, k, v and dout into shared
//     memory, then makes two passes over the (N, N) scores, one query row per
//     warp (softmax statistics, o, dq, ds) and one key row per warp (p and ds
//     recomputed from the saved row statistics; dk, dv), so that every sum is
//     taken by one warp and no atomics are needed. ds is added into the
//     block's own (N, N) slab of bias-gradient partials in device memory
//     (plain read-modify-write: nobody else touches the slab). It writes o
//     and dqkv in bf16.
//  2. window_attention_bwd_dx: tiles of 32 token rows: dxn = dqkv . Wqkv,
//     LN backward, + dy; per-block partial sums for dLN.
//  3. window_attention_bwd_dw: a block owns 16 rows of (dWqkv | dWproj) in
//     registers and walks a strided share of the token tiles; one slab of
//     partials per share.
//  4. sum_partials adds the slabs of 1-3 in a fixed order: results do not
//     change from run to run.
// One head per block keeps shared memory at ~110 KB for any C (head dim 16),
// so the same kernel serves the widest stage, for which the TPU needed the
// head-split variant.
//
// What bounds it on the card: the products run on CUDA cores in fp32 from
// shared memory: FMA throughput and shared-memory bandwidth. The scores are
// computed twice (8 N^2 hd multiply-adds per head against 6). The bias
// partials cost one 8-byte read-modify-write per score in L2 / device
// memory. Tensor cores are left to a later change.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int kKC = 32;     // input channels staged per projection chunk
constexpr int kPK = 16;     // dqkv columns staged per dx chunk
constexpr int kJB = 16;     // weight-gradient rows owned by a dw block
constexpr int kMaxC = 512;  // widest C the dw launch holds in registers
constexpr int kMaxE = kJB * kMaxC / kThreads;

struct BwdHeadsParams {
  const __nv_bfloat16* x;      // (T, N, C) raw windows
  const float* ln;             // (2, C) or nullptr
  const __nv_bfloat16* wqkv;   // (3C, C)
  const float* bqkv;           // (3C) or nullptr
  const __nv_bfloat16* wproj;  // (C, C)
  const float* bias;           // (nh, N, N)
  const float* bias_t;         // (nh, N, N), each head transposed
  const __nv_bfloat16* dy;     // (T, N, C)
  __nv_bfloat16* attn;         // (T, N, C) o, heads concatenated
  __nv_bfloat16* dqkv;         // (T, N, 3C)
  float* dbias_part;           // (chunks, nh, N, N)
  int t, n, c, hd, wins_per_chunk;
  int w0, w1, w2, s0, s1, s2;
  int nwd, nwh, nww;
  int shifted;
  float eps, scale;
};

// dst[t][j] = sum_ch src'[t][ch] * w[base(j) + ch * kstride] for the n rows
// of one window and ncols columns; src' is src, LayerNorm-ed and rounded to
// bf16 when ln is given. Staged through xs / wsm in chunks of kKC channels.
// Ends with a __syncthreads().
template <class BaseFn>
__device__ void project_cols(const __nv_bfloat16* src, int n, int c,
                             const float* ln, const float* mu, const float* rs,
                             const __nv_bfloat16* w, BaseFn base, int kstride,
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
        v = ld_bf16(src + (size_t)t * c + ch);
        if (ln != nullptr)
          v = bf16_round((v - mu[t]) * rs[t] * ln[ch] + ln[c + ch]);
      }
      xs[t * xs_stride + kk] = v;
    }
    for (int e = tid; e < ncols * kKC; e += kThreads) {
      const int j = e / kKC, kk = e - j * kKC, ch = c0 + kk;
      wsm[kk * ncols + j] =
          ch < c ? ld_bf16(w + base(j) + (size_t)ch * kstride) : 0.f;
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_heads(BwdHeadsParams p) {
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
    const __nv_bfloat16* xw = p.x + (size_t)win * n * c;
    const __nv_bfloat16* dyw = p.dy + (size_t)win * n * c;
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
      qkv[t * qs + j] = bf16_round(qkv[t * qs + j] + b);
    }
    // dout[t][d] = bf16(sum_o dy[t][o] * Wproj[o][h * hd + d])
    project_cols(
        dyw, n, c, nullptr, nullptr, nullptr, p.wproj,
        [=](int j) { return (size_t)(h * hd + j); }, c, hd, xs, wsm, dos, dstr);
    for (int e = tid; e < n * hd; e += kThreads) {
      const int j = e / n, t = e - j * n;
      dos[t * dstr + j] = bf16_round(dos[t * dstr + j]);
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
        const float pb = bf16_round(p32);
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
        const float dsl = bf16_round(ds * p.scale);
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
        p.attn[row * c + h * hd + lane] = __float2bfloat16(mo);
        p.dqkv[row * 3 * c + h * hd + lane] = __float2bfloat16(mq);
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
        const float pb = bf16_round(p32);
        const float dsl = bf16_round(p32 * (dp - delta[t]) * p.scale);
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
        p.dqkv[row + c + h * hd + lane] = __float2bfloat16(mk);
        p.dqkv[row + 2 * c + h * hd + lane] = __float2bfloat16(mv);
      }
    }
  }
}

// dx = LN backward of (dqkv . Wqkv) [+ dy] over tiles of kTile rows (strided
// over the grid); part (grid, 2c) takes the block's dLN sums.
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_dx(const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ ln,
                            const __nv_bfloat16* __restrict__ wqkv,
                            const __nv_bfloat16* __restrict__ dqkv,
                            const __nv_bfloat16* __restrict__ dy,
                            __nv_bfloat16* __restrict__ dx,
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
                                     ? ld_bf16(dqkv + (r0 + r) * c3 + j0 + kk)
                                     : 0.f;
      }
      for (int e = tid; e < kPK * c; e += kThreads) {
        const int kk = e / c;
        wsm[e] = j0 + kk < c3 ? ld_bf16(wqkv + (size_t)j0 * c + e) : 0.f;
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
// share: (4c x c) weights | (4c) biases.
__global__ void __launch_bounds__(kThreads)
    window_attention_bwd_dw(const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ ln,
                            const __nv_bfloat16* __restrict__ attn,
                            const __nv_bfloat16* __restrict__ dqkv,
                            const __nv_bfloat16* __restrict__ dy,
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
  const __nv_bfloat16* left = qkv_side ? dqkv + j0 : dy + (j0 - c3);
  const int left_stride = qkv_side ? c3 : c;
  const __nv_bfloat16* right = qkv_side ? x : attn;
  const float* lnr = qkv_side ? ln : nullptr;
  const long long ntiles = (m_total + kTile - 1) / kTile;

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
        v = ld_bf16(right + (r0 + r) * c + ch);
        if (lnr != nullptr)
          v = bf16_round((v - mu[r]) * rs[r] * lnr[ch] + lnr[c + ch]);
      }
      xs[r * stride + ch] = v;
    }
    for (int e = tid; e < kTile * kJB; e += kThreads) {
      const int r = e / kJB, j = e - r * kJB;
      ls[r * lstride + j] =
          r < rows ? ld_bf16(left + (r0 + r) * left_stride + j) : 0.f;
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

template <int HD>
cudaError_t launch_heads(const BwdHeadsParams& p, int nchunk, int nh,
                         cudaStream_t st) {
  const int n = p.n, q3 = 3 * p.hd;
  const size_t smem = sizeof(float) * (5 * n + n * (kKC + 1) + kKC * q3 +
                                       n * (q3 + 1) + n * (p.hd + 1) +
                                       2 * kWarps * n);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd_heads<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  window_attention_bwd_heads<HD><<<dim3(nchunk, nh), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medseg

// Pointers as in BwdHeadsParams; dx (T, N, C) bf16. Scratch: dbias_part
// (nchunk, nh, N, N), part_ln (grid_dx, 2c), part_w (nsplit, 4c*c + 4c).
// Results: dbias (nh, N, N), out_ln (2c) = dscale | dbias_ln, out_w =
// dWqkv (3c x c) | dWproj (c x c) | dbqkv (3c) | dbproj (c). c must be a
// multiple of 16.
extern "C" int medseg_window_attention_bwd(
    const void* x, const void* ln, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bias, const void* bias_t, const void* dy,
    void* attn, void* dqkv, void* dx, void* dbias_part, void* dbias,
    void* part_ln, void* out_ln, void* part_w, void* out_w, int t, int n,
    int c, int nh, int w0, int w1, int w2, int s0, int s1, int s2, int nwd,
    int nwh, int nww, int shifted, int residual, int nchunk, int grid_dx,
    int nsplit, float ln_eps, float scale, void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = c / nh;
  if (hd * nh != c || hd > 32 || hd < 1 || n < 1 || t < 1 || c % kJB != 0 ||
      c > kMaxC || nchunk < 1 || grid_dx < 1 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);

  BwdHeadsParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.ln = static_cast<const float*>(ln);
  p.wqkv = static_cast<const __nv_bfloat16*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.wproj = static_cast<const __nv_bfloat16*>(wproj);
  p.bias = static_cast<const float*>(bias);
  p.bias_t = static_cast<const float*>(bias_t);
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.attn = static_cast<__nv_bfloat16*>(attn);
  p.dqkv = static_cast<__nv_bfloat16*>(dqkv);
  p.dbias_part = static_cast<float*>(dbias_part);
  p.t = t; p.n = n; p.c = c; p.hd = hd;
  p.wins_per_chunk = (t + nchunk - 1) / nchunk;
  p.w0 = w0; p.w1 = w1; p.w2 = w2; p.s0 = s0; p.s1 = s1; p.s2 = s2;
  p.nwd = nwd; p.nwh = nwh; p.nww = nww;
  p.shifted = shifted; p.eps = ln_eps; p.scale = scale;
  // every chunk must hold a window, or its slab of partials stays unwritten
  if ((long long)(nchunk - 1) * p.wins_per_chunk >= t)
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = hd <= 16 ? launch_heads<16>(p, nchunk, nh, st)
                             : launch_heads<32>(p, nchunk, nh, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long m_total = (long long)t * n;
  const size_t smem_dx =
      sizeof(float) * (2 * kTile + 2 * c + c * (kTile + 1) +
                       kTile * (kPK + 1) + kPK * c);
  err = cudaFuncSetAttribute(window_attention_bwd_dx,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dx);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd_dx<<<grid_dx, kThreads, smem_dx, st>>>(
      p.x, p.ln, p.wqkv, p.dqkv, p.dy, static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(part_ln), m_total, c, residual, ln_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_dw =
      sizeof(float) * (2 * kTile + kTile * (c + 1) + kTile * (kJB + 1));
  err = cudaFuncSetAttribute(window_attention_bwd_dw,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dw);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd_dw<<<dim3(4 * c / kJB, nsplit), kThreads, smem_dw, st>>>(
      p.x, p.ln, p.attn, p.dqkv, p.dy, static_cast<float*>(part_w), m_total, c,
      ln_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = sum_partials(p.dbias_part, static_cast<float*>(dbias), nchunk,
                     (long long)nh * n * n, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ln != nullptr) {
    err = sum_partials(static_cast<const float*>(part_ln),
                       static_cast<float*>(out_ln), grid_dx, 2 * (long long)c,
                       st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = sum_partials(static_cast<const float*>(part_w),
                     static_cast<float*>(out_w), nsplit,
                     4 * (long long)c * c + 4 * c, st);
  return static_cast<int>(err);
}
