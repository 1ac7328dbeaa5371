// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace medseg {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Round an fp32 value through bf16, the rounding point of a `.astype(bf16)`
// in the JAX kernels.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float ld_bf16(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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
__device__ __forceinline__ void row_stats(const __nv_bfloat16* row, int c,
                                          float eps, float* mu, float* rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f, ss = 0.f;
  for (int ch = lane; ch < c; ch += 32) {
    float v = ld_bf16(row + ch);
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

}  // namespace medseg
