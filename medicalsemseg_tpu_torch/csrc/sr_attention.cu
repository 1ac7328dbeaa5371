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
// the TPU kernel's. The element type T of the tokens, K, V and the weights
// is bf16, fp16 or fp32 (the JAX kernel takes its input's dtype): "bf16"
// above stands for T.
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
// 170 KB at C = 384, M = 27 in bf16. K, V and the weight chunk are staged in
// T; where 32 columns would not fit (fp32 at C = 384, or M > 66 in bf16) a
// chunk is kOC = 16 columns.
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
constexpr int kMaxHD = 32;   // largest head dim (one lane per channel in . V)

template <class T>
struct SrParams {
  const T* x;                  // (B, N, C) LayerNorm'ed tokens
  const T* k;                  // (B, M, C), head-major hd blocks
  const T* v;                  // (B, M, C)
  const T* wq;                 // (C, C) [out, in]
  const float* bq;             // (C) or nullptr
  const T* wproj;              // (C, C) [out, in]
  const float* bproj;          // (C)
  const T* res;                // (B, N, C) or nullptr
  T* out;                      // (B, N, C)
  int n, m, c, nh;
  float scale;
};

// dst[r][j0 + j] (or global rows) = round_T(src[r] . w[j0 + j] + b) for a
// chunk of kOC output columns: stage the weight rows, one dot per thread.
// ``src`` is the fp32 tile (kRows x (c + 1)); the result lands in ``tile``
// (kRows x (kOC + 1)) and the caller moves it on.
template <class T, int kOC>
__device__ __forceinline__ void project_chunk(const float* src, int c,
                                              const T* w, const float* b,
                                              int j0, T* ws, float* tile) {
  const int tid = threadIdx.x;
  const int s_stride = c + 1, t_stride = kOC + 1;
  for (int e = tid; e < kOC * c; e += kThreads) {
    const int j = e / c;
    ws[e] = j0 + j < c ? w[(size_t)j0 * c + e] : from_f32<T>(0.f);
  }
  __syncthreads();
  // token index across lanes: conflict-free src rows (odd stride), the
  // weight read is a broadcast
  for (int e = tid; e < kOC * kRows; e += kThreads) {
    const int j = e / kRows, r = e - j * kRows;
    float a = 0.f;
    if (j0 + j < c) {
      const float* sr = src + r * s_stride;
      const T* wr = ws + j * c;
#pragma unroll 8
      for (int ch = 0; ch < c; ++ch) a += sr[ch] * to_f32(wr[ch]);
      a = round_to<T>(a + (b != nullptr ? b[j0 + j] : 0.f));
    }
    tile[r * t_stride + j] = a;
  }
  __syncthreads();
}

template <class T, int kOC>
__global__ void __launch_bounds__(kThreads)
    sr_attention_kernel(SrParams<T> p) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, c = p.c, nh = p.nh, hd = c / nh;
  const int xs_stride = c + 1, kv_stride = c + 2, t_stride = kOC + 1;
  float* xs = smem;                          // kRows x (c + 1): x, then attn out
  float* qs = xs + kRows * xs_stride;        // kRows x (c + 1)
  float* tile = qs + kRows * xs_stride;      // kRows x (kOC + 1)
  float* prow = tile + kRows * t_stride;     // kWarps x m
  T* ws = reinterpret_cast<T*>(prow + kWarps * m);  // kOC x c
  T* ks = ws + kOC * c;                      // m x (c + 2)
  T* vs = ks + m * kv_stride;                // m x (c + 2)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - r0);
  const size_t tok0 = (size_t)b * n + r0;

  for (int e = tid; e < kRows * c; e += kThreads) {
    const int r = e / c, ch = e - r * c;
    xs[r * xs_stride + ch] = r < rows ? ld(p.x + (tok0 + r) * c + ch) : 0.f;
  }
  for (int e = tid; e < m * c; e += kThreads) {
    const int mm = e / c, ch = e - mm * c;
    ks[mm * kv_stride + ch] = p.k[((size_t)b * m + mm) * c + ch];
    vs[mm * kv_stride + ch] = p.v[((size_t)b * m + mm) * c + ch];
  }
  __syncthreads();

  // q = bf16(x . Wq^T + bq)
  for (int j0 = 0; j0 < c; j0 += kOC) {
    project_chunk<T, kOC>(xs, c, p.wq, p.bq, j0, ws, tile);
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
      const T* kr = ks + mm * kv_stride + h * hd;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qr[d] * to_f32(kr[d]);
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
    for (int mm = lane; mm < m; mm += 32) pr[mm] = round_to<T>(pr[mm] / sum);
    __syncwarp();
    if (lane < hd) {
      const T* vc = vs + h * hd + lane;
      float a = 0.f;
      for (int mm = 0; mm < m; ++mm) a += pr[mm] * to_f32(vc[mm * kv_stride]);
      xs[r * xs_stride + h * hd + lane] = round_to<T>(a);
    }
    __syncwarp();
  }
  __syncthreads();

  // out = bf16(attn . Wproj^T + bproj) [+ res]
  for (int j0 = 0; j0 < c; j0 += kOC) {
    project_chunk<T, kOC>(xs, c, p.wproj, p.bproj, j0, ws, tile);
    for (int e = tid; e < rows * kOC; e += kThreads) {
      const int r = e / kOC, j = e - r * kOC;
      if (j0 + j < c) {
        float y = tile[r * t_stride + j];
        const size_t o = (tok0 + r) * c + j0 + j;
        if (p.res != nullptr) y += ld(p.res + o);
        p.out[o] = from_f32<T>(y);
      }
    }
  }
}

size_t sr_smem_bytes(int m, int c, int oc, size_t elem) {
  return sizeof(float) * (2 * kRows * (c + 1) + kRows * (oc + 1) + kWarps * m) +
         elem * (oc * c + 2 * m * (c + 2));
}

// Output columns per projection chunk: 32, or 16 where 32 does not fit.
int sr_chunk(int m, int c, size_t elem) {
  return sr_smem_bytes(m, c, 32, elem) <= 232448 ? 32 : 16;
}

size_t elem_size(int dtype) { return dtype == kF32 ? 4 : 2; }

template <class T, int kOC>
int launch_sr(const SrParams<T>& p, int b, cudaStream_t st) {
  const size_t smem = sr_smem_bytes(p.m, p.c, kOC, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      sr_attention_kernel<T, kOC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sr_attention_kernel<T, kOC><<<dim3((p.n + kRows - 1) / kRows, b), kThreads,
                                smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace medseg

// Shared memory of one block in bytes for M reduced tokens of width C and the
// element type named by dtype (the wrapper raises where it exceeds the card's
// limit).
extern "C" long long medseg_sr_attention_smem_bytes(int m, int c, int dtype) {
  using namespace medseg;
  const size_t elem = elem_size(dtype);
  return (long long)sr_smem_bytes(m, c, sr_chunk(m, c, elem), elem);
}

// x, k, v, wq, wproj, res, out of the element type named by dtype; bq,
// bproj fp32.
extern "C" int medseg_sr_attention_fwd(const void* x, const void* k,
                                       const void* v, const void* wq,
                                       const void* bq, const void* wproj,
                                       const void* bproj, const void* res,
                                       void* out, int b, int n, int m, int c,
                                       int nh, int dtype, float scale,
                                       void* stream) {
  using namespace medseg;
  const int hd = nh > 0 ? c / nh : 0;
  if (b < 1 || n < 1 || m < 1 || nh < 1 || hd * nh != c || hd > kMaxHD ||
      b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    SrParams<T> p;
    p.x = static_cast<const T*>(x);
    p.k = static_cast<const T*>(k);
    p.v = static_cast<const T*>(v);
    p.wq = static_cast<const T*>(wq);
    p.bq = static_cast<const float*>(bq);
    p.wproj = static_cast<const T*>(wproj);
    p.bproj = static_cast<const float*>(bproj);
    p.res = static_cast<const T*>(res);
    p.out = static_cast<T*>(out);
    p.n = n; p.m = m; p.c = c; p.nh = nh; p.scale = scale;
    return sr_chunk(m, c, sizeof(T)) == 32 ? launch_sr<T, 32>(p, b, st)
                                           : launch_sr<T, 16>(p, b, st);
  });
}
