// Fused SegFormer spatial-reduction attention, forward (inference): K7.
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/sr_attention.py:
// fused_sr_attention (_kernel). Per token of x (B, N, C), already
// LayerNorm'ed by the block: q = x . Wq^T (fp32 accumulation, + bq in fp32,
// then bf16) -> per head logits q . k^T in fp32, scaled AFTER the dot by
// hd^-0.5 -> fp32 softmax over the M reduced keys -> bf16 -> . V -> heads
// concatenated, bf16 -> output projection (+ bproj in fp32, then bf16) ->
// optional bf16 add of the block's raw input. K and V (B, M, C) come in
// precomputed (the spatial-reduction conv, its LayerNorm and the kv dense
// over M tokens stay outside, as in the TPU kernel). The rounding points are
// the TPU kernel's.
//
// Design. One block owns a tile of 32 tokens of one batch element
// (grid = tiles x B). K and V of that element sit in shared memory as bf16
// for the whole block; the token tile and its q sit there in fp32. Wq and
// Wproj do not fit (295 KB each at C = 384), so both projections walk their
// output columns in chunks of 32: a chunk's 32 x C weight rows are staged,
// thread (column, token) takes one full dot product, and the chunk of outputs
// goes through a 32 x 32 tile so that device memory sees whole rows. Between
// the projections a warp takes one (token, head) pair at a time: lanes run
// over the keys for the logits and the softmax (the (N, M) matrix never
// leaves the SM: a warp holds one row of one head), then over the head's
// channels for . V. The attention output overwrites the token tile, which the
// second projection then reads. N is never padded: the last tile masks its
// tail (the TPU wrapper pads N to a multiple of 256). Shared memory is
// 32 (2C + 2) fp32 + 32 C bf16 + 2 M (C + 2) bf16 + (8 M + 32 * 33) fp32:
// 170 KB at C = 384, M = 27.
//
// What bounds it on the card: by its counts, bytes at the first stage (C =
// 48, N = 13,824, batch 16: x, the shortcut and the output are 21 MB each
// against 2.6 GFLOP) and operations from C = 192 on. As written the products
// run on CUDA cores in fp32 from shared memory, so shared-memory bandwidth
// and FMA issue bound it, as K1 and K2; the weights are re-read from L2 by
// every tile. Tensor cores for the two projections are left to a later
// change.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int kRows = 32;    // tokens per block (one per lane in the products)
constexpr int kOC = 32;      // output columns per projection chunk
constexpr int kMaxHD = 32;   // largest head dim (one lane per channel in . V)

struct SrParams {
  const __nv_bfloat16* x;      // (B, N, C) LayerNorm'ed tokens
  const __nv_bfloat16* k;      // (B, M, C), head-major hd blocks
  const __nv_bfloat16* v;      // (B, M, C)
  const __nv_bfloat16* wq;     // (C, C) [out, in]
  const float* bq;             // (C) or nullptr
  const __nv_bfloat16* wproj;  // (C, C) [out, in]
  const float* bproj;          // (C)
  const __nv_bfloat16* res;    // (B, N, C) or nullptr
  __nv_bfloat16* out;          // (B, N, C)
  int n, m, c, nh;
  float scale;
};

// dst[r][j0 + j] (or global rows) = round_bf16(src[r] . w[j0 + j] + b) for a
// chunk of kOC output columns: stage the weight rows, one dot per thread.
// ``src`` is the fp32 tile (kRows x (c + 1)); the result lands in ``tile``
// (kRows x (kOC + 1)) and the caller moves it on.
__device__ __forceinline__ void project_chunk(const float* src, int c,
                                              const __nv_bfloat16* w,
                                              const float* b, int j0,
                                              __nv_bfloat16* ws, float* tile) {
  const int tid = threadIdx.x;
  const int s_stride = c + 1, t_stride = kOC + 1;
  for (int e = tid; e < kOC * c; e += kThreads) {
    const int j = e / c;
    ws[e] = j0 + j < c ? w[(size_t)j0 * c + e] : __float2bfloat16(0.f);
  }
  __syncthreads();
  // token index across lanes: conflict-free src rows (odd stride), the
  // weight read is a broadcast
  for (int e = tid; e < kOC * kRows; e += kThreads) {
    const int j = e / kRows, r = e - j * kRows;
    float a = 0.f;
    if (j0 + j < c) {
      const float* sr = src + r * s_stride;
      const __nv_bfloat16* wr = ws + j * c;
#pragma unroll 8
      for (int ch = 0; ch < c; ++ch) a += sr[ch] * __bfloat162float(wr[ch]);
      a = bf16_round(a + (b != nullptr ? b[j0 + j] : 0.f));
    }
    tile[r * t_stride + j] = a;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) sr_attention_kernel(SrParams p) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, c = p.c, nh = p.nh, hd = c / nh;
  const int xs_stride = c + 1, kv_stride = c + 2, t_stride = kOC + 1;
  float* xs = smem;                          // kRows x (c + 1): x, then attn out
  float* qs = xs + kRows * xs_stride;        // kRows x (c + 1)
  float* tile = qs + kRows * xs_stride;      // kRows x (kOC + 1)
  float* prow = tile + kRows * t_stride;     // kWarps x m
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(prow + kWarps * m);  // kOC x c
  __nv_bfloat16* ks = ws + kOC * c;          // m x (c + 2)
  __nv_bfloat16* vs = ks + m * kv_stride;    // m x (c + 2)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - r0);
  const size_t tok0 = (size_t)b * n + r0;

  for (int e = tid; e < kRows * c; e += kThreads) {
    const int r = e / c, ch = e - r * c;
    xs[r * xs_stride + ch] = r < rows ? ld_bf16(p.x + (tok0 + r) * c + ch) : 0.f;
  }
  for (int e = tid; e < m * c; e += kThreads) {
    const int mm = e / c, ch = e - mm * c;
    ks[mm * kv_stride + ch] = p.k[((size_t)b * m + mm) * c + ch];
    vs[mm * kv_stride + ch] = p.v[((size_t)b * m + mm) * c + ch];
  }
  __syncthreads();

  // q = bf16(x . Wq^T + bq)
  for (int j0 = 0; j0 < c; j0 += kOC) {
    project_chunk(xs, c, p.wq, p.bq, j0, ws, tile);
    for (int e = tid; e < kRows * kOC; e += kThreads) {
      const int r = e / kOC, j = e - r * kOC;
      if (j0 + j < c) qs[r * xs_stride + j0 + j] = tile[r * t_stride + j];
    }
  }
  __syncthreads();

  // one (token, head) pair per warp at a time; the attention output
  // overwrites the token tile (x is no longer needed)
  float* pr = prow + warp * m;
  for (int pair = warp; pair < rows * nh; pair += kWarps) {
    const int r = pair / nh, h = pair - r * nh;
    const float* qr = qs + r * xs_stride + h * hd;
    float mx = -INFINITY;
    for (int mm = lane; mm < m; mm += 32) {
      const __nv_bfloat16* kr = ks + mm * kv_stride + h * hd;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qr[d] * __bfloat162float(kr[d]);
      s *= p.scale;
      pr[mm] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int mm = lane; mm < m; mm += 32) {
      const float e = expf(pr[mm] - mx);
      pr[mm] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int mm = lane; mm < m; mm += 32) pr[mm] = bf16_round(pr[mm] / sum);
    __syncwarp();
    if (lane < hd) {
      const __nv_bfloat16* vc = vs + h * hd + lane;
      float a = 0.f;
      for (int mm = 0; mm < m; ++mm)
        a += pr[mm] * __bfloat162float(vc[mm * kv_stride]);
      xs[r * xs_stride + h * hd + lane] = bf16_round(a);
    }
    __syncwarp();
  }
  __syncthreads();

  // out = bf16(attn . Wproj^T + bproj) [+ res]
  for (int j0 = 0; j0 < c; j0 += kOC) {
    project_chunk(xs, c, p.wproj, p.bproj, j0, ws, tile);
    for (int e = tid; e < rows * kOC; e += kThreads) {
      const int r = e / kOC, j = e - r * kOC;
      if (j0 + j < c) {
        float y = tile[r * t_stride + j];
        const size_t o = (tok0 + r) * c + j0 + j;
        if (p.res != nullptr) y += ld_bf16(p.res + o);
        p.out[o] = __float2bfloat16(y);
      }
    }
  }
}

size_t sr_smem_bytes(int m, int c) {
  return sizeof(float) * (2 * kRows * (c + 1) + kRows * (kOC + 1) + kWarps * m) +
         sizeof(__nv_bfloat16) * (kOC * c + 2 * m * (c + 2));
}

}  // namespace
}  // namespace medseg

// Shared memory of one block in bytes for M reduced tokens of width C (the
// wrapper raises where it exceeds the card's limit).
extern "C" long long medseg_sr_attention_smem_bytes(int m, int c) {
  return (long long)medseg::sr_smem_bytes(m, c);
}

extern "C" int medseg_sr_attention_fwd(const void* x, const void* k,
                                       const void* v, const void* wq,
                                       const void* bq, const void* wproj,
                                       const void* bproj, const void* res,
                                       void* out, int b, int n, int m, int c,
                                       int nh, float scale, void* stream) {
  using namespace medseg;
  const int hd = nh > 0 ? c / nh : 0;
  if (b < 1 || n < 1 || m < 1 || nh < 1 || hd * nh != c || hd > kMaxHD ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  SrParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.wq = static_cast<const __nv_bfloat16*>(wq);
  p.bq = static_cast<const float*>(bq);
  p.wproj = static_cast<const __nv_bfloat16*>(wproj);
  p.bproj = static_cast<const float*>(bproj);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.n = n; p.m = m; p.c = c; p.nh = nh; p.scale = scale;
  const size_t smem = sr_smem_bytes(m, c);
  cudaError_t err = cudaFuncSetAttribute(
      sr_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sr_attention_kernel<<<dim3((n + kRows - 1) / kRows, b), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
