// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace medseg {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The element types of the kernels that take their activations' dtype, as
// the JAX kernels do (K1-K4, K6, K7): the dtype argument of their C entry
// points. Loads widen to fp32, products and sums are fp32, and each point
// where a JAX kernel writes `.astype(x_ref.dtype)` rounds to T (round_to<T>;
// the identity for fp32).
constexpr int kBf16 = 0, kF16 = 1, kF32 = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <class T>
__device__ __forceinline__ float ld(const T* p) {
  return to_f32(*p);
}

// f(T{}) for the element type of a dtype code; an unknown code is an error.
template <class F>
int with_dtype(int dtype, F f) {
  switch (dtype) {
    case kBf16: return f(__nv_bfloat16{});
    case kF16: return f(__half{});
    case kF32: return f(0.f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// fp32 LayerNorm statistics of one row with the fast variance
// var = max(0, E[x^2] - E[x]^2), as flax.linen.LayerNorm computes them.
// Called by a whole warp; every lane gets the result.
template <class T>
__device__ __forceinline__ void row_stats(const T* row, int c, float eps,
                                          float* mu, float* rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int ch = lane; ch < c; ch += 32) {
    float v = ld(row + ch);
    s += v;
    ss += v * v;
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  float m = s / c;
  float var = fmaxf(0.f, ss / c - m * m);
  *mu = m;
  *rstd = 1.0f / sqrtf(var + eps);
}

// Pre-shift region label of a token along one axis: 0 unless the window is
// the last along the axis; there, tokens at or past ws - ss were wrapped
// from the volume start by the cyclic roll.
__device__ __forceinline__ int region(int pos, bool last, int w, int s) {
  return last ? (pos < w - s ? 1 : 2) : 0;
}

__device__ __forceinline__ int token_label(int t, int w1, int w2, int w0,
                                           int s0, int s1, int s2, bool ld,
                                           bool lh, bool lw) {
  const int pd = t / (w1 * w2), ph = (t / w2) % w1, pw = t % w2;
  return region(pd, ld, w0, s0) * 9 + region(ph, lh, w1, s1) * 3 +
         region(pw, lw, w2, s2);
}

// out[i] = sum over p < nparts of part[p * len + i], in that order
// (csrc/reduce.cu).
cudaError_t sum_partials(const float* part, float* out, int nparts,
                         long long len, cudaStream_t st);

// Phi(h) = 0.5 * (1 + erf(h / sqrt 2)), the exact-GELU gate, with erf from
// Abramowitz & Stegun 7.1.26 (abs err <= 1.5e-7): the polynomial the JAX
// MLP kernels evaluate.
__device__ __forceinline__ float gelu_cdf(float h) {
  const float x = h * 0.7071067811865476f;
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf_a = 1.0f - poly * expf(-a * a);
  return 0.5f * (1.0f + (x < 0.f ? -erf_a : erf_a));
}

// Tiles of the backward kernels: kTile token rows at a time.
constexpr int kTile = 32;

// acc[i] += sum_r ls[r][j] * xs[r][ch] over the kTile rows of a tile, for
// the entries e = tid + i * kThreads = j * c + ch (e < ne) that this thread
// owns. Lanes run along ch: the xs reads are conflict-free, ls broadcasts.
template <int kMaxE>
__device__ __forceinline__ void outer_accumulate(const float* ls, int lstride,
                                                 const float* xs, int xstride,
                                                 int c, int ne,
                                                 float (&acc)[kMaxE]) {
#pragma unroll
  for (int i = 0; i < kMaxE; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e < ne) {
      const int j = e / c, ch = e - j * c;
      float a = 0.f;
#pragma unroll 8
      for (int r = 0; r < kTile; ++r)
        a += ls[r * lstride + j] * xs[r * xstride + ch];
      acc[i] += a;
    }
  }
}

// The end of a dx tile, shared by the attention and the MLP backward. dxn
// (c x (kTile + 1) fp32 in shared memory, dxn[ch * (kTile + 1) + r]) is the
// gradient with respect to the LayerNorm's output for rows r0 .. r0 + rows.
// With ln: dx = LN backward of dxn (xhat and rstd recomputed from x, mu, rs),
// and accs[0..c) += sum_r dxn * xhat, accs[c..2c) += sum_r dxn. Without:
// dx = dxn. With residual, + dy. Called by the whole block.
template <class T>
__device__ __forceinline__ void ln_backward_tile(
    const T* x, const T* dy, const float* ln, const float* mu, const float* rs,
    const float* dxn, long long r0, int rows, int c, int residual, T* dx,
    float* accs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ds = kTile + 1;
  for (int r = warp; r < rows; r += kWarps) {
    const long long row = (r0 + r) * c;
    float m1 = 0.f, m2 = 0.f;
    if (ln != nullptr) {
      for (int ch = lane; ch < c; ch += 32) {
        const float xh = (ld(x + row + ch) - mu[r]) * rs[r];
        const float dxh = dxn[ch * ds + r] * ln[ch];
        m1 += dxh;
        m2 += dxh * xh;
      }
      m1 = warp_sum(m1) / c;
      m2 = warp_sum(m2) / c;
    }
    for (int ch = lane; ch < c; ch += 32) {
      float v = dxn[ch * ds + r];
      if (ln != nullptr) {
        const float xh = (ld(x + row + ch) - mu[r]) * rs[r];
        v = (v * ln[ch] - m1 - xh * m2) * rs[r];
      }
      if (residual) v += ld(dy + row + ch);
      dx[row + ch] = from_f32<T>(v);
    }
  }
  if (ln != nullptr) {
    for (int ch = tid; ch < c; ch += kThreads) {
      float a0 = 0.f, a1 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float d = dxn[ch * ds + r];
        a0 += d * ((ld(x + (r0 + r) * c + ch) - mu[r]) * rs[r]);
        a1 += d;
      }
      accs[ch] += a0;
      accs[c + ch] += a1;
    }
  }
}

}  // namespace medseg
