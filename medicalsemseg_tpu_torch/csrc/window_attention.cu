// Fused 3D window attention, forward (inference).
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/window_attention.py:
// fused_window_attention (_kernel, _window_mask). Per window of N = ws^3
// tokens: optional fp32 LayerNorm -> QKV projection (fp32 accumulation,
// + bias in fp32, then bf16) -> per head q.k^T * hd^-0.5 in fp32 + relative
// position bias + shifted-window mask (-100 where pre-shift region labels
// differ) -> fp32 softmax -> bf16 -> .V -> bf16 -> output projection
// (+ bias in fp32, then bf16) -> optional bf16 shortcut add. The rounding
// points are the TPU kernel's.
//
// Design. Two launches:
//  1. window_attention_heads: one block per (window, head). It LN-normalises
//     its window's tokens chunk by chunk, projects only its head's q/k/v
//     (N x 3hd, kept in shared memory), and runs scores, bias, mask, softmax
//     and .V one query row per warp. The (N, N) score matrix never leaves
//     the SM: a warp holds one row of it at a time. It writes its head's
//     slice of the (T, N, C) bf16 attention output.
//  2. window_attention_proj: the output projection + bias + shortcut over
//     tiles of 32 token rows.
//  Splitting by head keeps the shared-memory footprint at ~85 KB for every
//  flagship stage (head dim 16): a whole window's LN'd tile at C = 384 is
//  166 KB alone, so tile and attention output of a window do not fit one
//  block together.
//
// What bounds it on the card: the products run on CUDA cores in fp32 with
// both operands read from shared memory, so the kernel is bound by
// shared-memory bandwidth and FMA issue, not by device memory: the window
// tile is read once per head (an L2 hit after the first) and the bias table
// (nh x N x N fp32) is shared by all windows and stays in L2. Moving the
// three products onto the tensor cores (mma.sync / wgmma with head dim 16
// as the k-step) is the next step and is left to a later change.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int kKC = 32;      // input channels staged per QKV chunk
constexpr int kMaxHD = 32;   // largest head dim the kernel takes
constexpr int kRows = 32;    // token rows per projection block
constexpr int kPK = 16;      // input channels staged per projection chunk

struct HeadsParams {
  const __nv_bfloat16* x;     // (T, N, C) windows, raw (LN applied here)
  const float* ln;            // (2, C) scale/bias or nullptr
  const __nv_bfloat16* wqkv;  // (3C, C) [out, in]
  const float* bqkv;          // (3C) or nullptr
  const float* bias;          // (nh, N, N)
  __nv_bfloat16* attn;        // (T, N, C) attention output, heads concatenated
  int n, c, hd;
  int w0, w1, w2, s0, s1, s2;
  int nwd, nwh, nww;
  int shifted;
  float eps, scale;
};

__global__ void __launch_bounds__(kThreads)
    window_attention_heads(HeadsParams p) {
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
  const __nv_bfloat16* xw = p.x + (size_t)win * n * c;

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

  // this head's q, k, v columns: j in [0, 3hd) -> (j / hd) * C + h * hd + j % hd
  for (int c0 = 0; c0 < c; c0 += kKC) {
    __syncthreads();
    for (int e = tid; e < n * kKC; e += kThreads) {
      const int t = e / kKC, kk = e - t * kKC, ch = c0 + kk;
      float v = 0.f;
      if (ch < c) {
        v = ld_bf16(xw + (size_t)t * c + ch);
        if (p.ln != nullptr)
          v = bf16_round((v - mu[t]) * (rs[t] * p.ln[ch]) + p.ln[c + ch]);
      }
      xs[t * xs_stride + kk] = v;
    }
    for (int e = tid; e < q3 * kKC; e += kThreads) {
      const int j = e / kKC, kk = e - j * kKC, ch = c0 + kk;
      const int col = (j / hd) * c + h * hd + j % hd;
      wsm[kk * q3 + j] = ch < c ? ld_bf16(p.wqkv + (size_t)col * c + ch) : 0.f;
    }
    __syncthreads();
    // token index fastest across lanes: xs reads are conflict-free (odd
    // stride) and wsm reads broadcast
    for (int e = tid; e < n * q3; e += kThreads) {
      const int j = e / n, t = e - j * n;
      const float* xr = xs + t * xs_stride;
      float acc = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) acc += xr[kk] * wsm[kk * q3 + j];
      qkv[t * qkv_stride + j] += acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < n * q3; e += kThreads) {
    const int j = e / n, t = e - j * n;
    const int col = (j / hd) * c + h * hd + j % hd;
    const float b = p.bqkv != nullptr ? p.bqkv[col] : 0.f;
    qkv[t * qkv_stride + j] = bf16_round(qkv[t * qkv_stride + j] + b);
  }
  __syncthreads();

  // window grid coordinates in batch-major order g = ((b*nwd + i)*nwh + j)*nww + k
  const int wk = win % p.nww, wj = (win / p.nww) % p.nwh,
            wi = (win / (p.nww * p.nwh)) % p.nwd;
  const bool ld = wi == p.nwd - 1, lh = wj == p.nwh - 1, lw = wk == p.nww - 1;
  const float* bias_h = p.bias + (size_t)h * n * n;
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
      s = s * p.scale + bias_h[(size_t)t * n + m];
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
      const float pm = bf16_round(pr[m] / sum);
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
      p.attn[((size_t)win * n + t) * c + h * hd + lane] = __float2bfloat16(mine);
  }
}

// out = bf16(attn . Wproj^T + bproj) [+ x], over tiles of kRows token rows.
__global__ void __launch_bounds__(kThreads)
    window_attention_proj(const __nv_bfloat16* __restrict__ attn,
                          const __nv_bfloat16* __restrict__ wproj,
                          const float* __restrict__ bproj,
                          const __nv_bfloat16* __restrict__ x,
                          __nv_bfloat16* __restrict__ out, long long m_total,
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
          (r < rows && ch < c) ? ld_bf16(attn + (r0 + r) * c + ch) : 0.f;
    }
    for (int e = tid; e < kPK * c; e += kThreads) {
      const int o = e / kPK, kk = e - o * kPK, ch = c0 + kk;
      wsm[kk * c + o] = ch < c ? ld_bf16(wproj + (size_t)o * c + ch) : 0.f;
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
    float y = bf16_round(acc[j * acc_stride + r] + bproj[j]);
    if (residual) y += ld_bf16(x + (r0 + r) * c + j);
    out[(r0 + r) * c + j] = __float2bfloat16(y);
  }
}

}  // namespace
}  // namespace medseg

extern "C" int medseg_window_attention_fwd(
    const void* x, const void* ln, const void* wqkv, const void* bqkv,
    const void* wproj, const void* bproj, const void* bias, void* attn,
    void* out, int t, int n, int c, int nh, int w0, int w1, int w2, int s0,
    int s1, int s2, int nwd, int nwh, int nww, int shifted, int residual,
    float ln_eps, float scale, void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = c / nh;
  if (hd * nh != c || hd > kMaxHD || hd < 1 || n < 1 || t < 1)
    return static_cast<int>(cudaErrorInvalidValue);

  HeadsParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.ln = static_cast<const float*>(ln);
  p.wqkv = static_cast<const __nv_bfloat16*>(wqkv);
  p.bqkv = static_cast<const float*>(bqkv);
  p.bias = static_cast<const float*>(bias);
  p.attn = static_cast<__nv_bfloat16*>(attn);
  p.n = n; p.c = c; p.hd = hd;
  p.w0 = w0; p.w1 = w1; p.w2 = w2; p.s0 = s0; p.s1 = s1; p.s2 = s2;
  p.nwd = nwd; p.nwh = nwh; p.nww = nww;
  p.shifted = shifted; p.eps = ln_eps; p.scale = scale;

  const size_t heads_smem = sizeof(float) *
      (2 * n + n * (kKC + 1) + kKC * 3 * hd + n * (3 * hd + 1) + kWarps * n);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_heads, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)heads_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_heads<<<dim3(t, nh), kThreads, heads_smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long m_total = (long long)t * n;
  const size_t proj_smem =
      sizeof(float) * (c * (kRows + 1) + kRows * (kPK + 1) + kPK * c);
  err = cudaFuncSetAttribute(window_attention_proj,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)proj_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)((m_total + kRows - 1) / kRows);
  window_attention_proj<<<blocks, kThreads, proj_smem, st>>>(
      static_cast<const __nv_bfloat16*>(attn),
      static_cast<const __nv_bfloat16*>(wproj),
      static_cast<const float*>(bproj), static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(out), m_total, c, residual);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* medseg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
