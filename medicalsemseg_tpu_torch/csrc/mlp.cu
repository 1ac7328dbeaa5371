// Fused token MLP, forward (inference).
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/mlp.py: fused_mlp
// (_kernel). Per token: optional fp32 LayerNorm (fast variance) -> bf16 ->
// fc1 (fp32 accumulation, + b1) -> exact GELU in fp32 -> bf16 -> fc2 (fp32
// accumulation, + b2) -> bf16 -> optional bf16 shortcut add. The rounding
// points are the TPU kernel's; GELU uses erff, which differs from the TPU
// kernel's Abramowitz-Stegun polynomial by at most 1.5e-7.
//
// Design. One block per tile of 32 tokens. The block LN-normalises its tile
// once into shared memory, then walks the hidden dimension in chunks of 32:
// h = gelu(x^ . W1[chunk]^T + b1) is computed into shared memory and at once
// folded into the fp32 output accumulator y += h . W2[:, chunk]^T, which
// stays on chip for the whole walk. The (M, 4C) hidden activations never
// reach device memory, which is what the TPU kernel buys. Shared memory is
// ~150 KB at C = 384 (the flagship's widest stage).
//
// What bounds it on the card: the products run on CUDA cores in fp32 with
// operands from shared memory, so it is bound by shared-memory bandwidth and
// FMA issue. Device memory sees one read of x and one write of y per token;
// the weights (2 x C x 4C bf16) are re-read from L2 by every tile. Tensor
// cores (mma.sync / wgmma on the x^ tile and the weight chunks) are the next
// step and are left to a later change.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int kRows = 32;  // tokens per block (one per lane in the products)
constexpr int kHC = 32;    // hidden units per chunk

__global__ void __launch_bounds__(kThreads)
    fused_mlp_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ ln,
                     const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ w2,
                     const float* __restrict__ b2,
                     __nv_bfloat16* __restrict__ out, long long m, int c,
                     int hdim, int co, int residual, float eps) {
  extern __shared__ float smem[];
  const int xs_stride = c + 1, hs_stride = kHC + 1, ys_stride = kRows + 1;
  float* mu = smem;                         // kRows
  float* rs = mu + kRows;                   // kRows
  float* xs = rs + kRows;                   // kRows x (c + 1)
  float* hs = xs + kRows * xs_stride;       // kRows x (kHC + 1)
  float* ys = hs + kRows * hs_stride;       // co x (kRows + 1)
  __nv_bfloat16* w1s =
      reinterpret_cast<__nv_bfloat16*>(ys + co * ys_stride);  // kHC x c
  __nv_bfloat16* w2s = w1s + kHC * c;                         // co x kHC
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, m - r0);

  if (ln != nullptr) {
    for (int r = warp; r < rows; r += kWarps) {
      float mm, rr;
      row_stats(x + (r0 + r) * c, c, eps, &mm, &rr);
      if (lane == 0) {
        mu[r] = mm;
        rs[r] = rr;
      }
    }
  }
  for (int e = tid; e < co * kRows; e += kThreads)
    ys[(e / kRows) * ys_stride + e % kRows] = 0.f;
  __syncthreads();
  for (int e = tid; e < kRows * c; e += kThreads) {
    const int r = e / c, ch = e - r * c;
    float v = 0.f;
    if (r < rows) {
      v = ld_bf16(x + (r0 + r) * c + ch);
      if (ln != nullptr)
        v = bf16_round((v - mu[r]) * (rs[r] * ln[ch]) + ln[c + ch]);
    }
    xs[r * xs_stride + ch] = v;
  }

  for (int j0 = 0; j0 < hdim; j0 += kHC) {
    __syncthreads();  // xs ready / previous chunk's hs, w2s consumed
    for (int e = tid; e < kHC * c; e += kThreads) {
      const int j = e / c, ch = e - j * c;
      w1s[e] = j0 + j < hdim ? w1[(size_t)(j0 + j) * c + ch]
                             : __float2bfloat16(0.f);
    }
    for (int e = tid; e < co * kHC; e += kThreads) {
      const int o = e / kHC, j = e - o * kHC;
      w2s[e] = j0 + j < hdim ? w2[(size_t)o * hdim + j0 + j]
                             : __float2bfloat16(0.f);
    }
    __syncthreads();
    // hidden chunk: token index across lanes (conflict-free xs rows with an
    // odd stride), the w1s read is a broadcast
    for (int e = tid; e < kHC * kRows; e += kThreads) {
      const int j = e / kRows, r = e - j * kRows;
      float hv = 0.f;
      if (j0 + j < hdim) {
        const float* xr = xs + r * xs_stride;
        const __nv_bfloat16* wr = w1s + j * c;
        float a = 0.f;
#pragma unroll 8
        for (int ch = 0; ch < c; ++ch) a += xr[ch] * __bfloat162float(wr[ch]);
        a += b1[j0 + j];
        hv = bf16_round(a * (0.5f * (1.0f + erff(a * 0.70710678118654752f))));
      }
      hs[r * hs_stride + j] = hv;
    }
    __syncthreads();
    for (int e = tid; e < co * kRows; e += kThreads) {
      const int o = e / kRows, r = e - o * kRows;
      const float* hr = hs + r * hs_stride;
      const __nv_bfloat16* wr = w2s + o * kHC;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kHC; ++j) a += hr[j] * __bfloat162float(wr[j]);
      ys[o * ys_stride + r] += a;
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * co; e += kThreads) {
    const int r = e / co, o = e - r * co;
    float y = bf16_round(ys[o * ys_stride + r] + b2[o]);
    if (residual) y += ld_bf16(x + (r0 + r) * c + o);
    out[(r0 + r) * co + o] = __float2bfloat16(y);
  }
}

}  // namespace
}  // namespace medseg

extern "C" int medseg_fused_mlp_fwd(const void* x, const void* ln,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out,
                                    int m, int c, int hdim,
                                    int co, int residual, float ln_eps,
                                    void* stream) {
  using namespace medseg;
  if (m < 1 || c < 1 || hdim < 1 || co < 1 || (residual && co != c))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (2 * kRows + kRows * (c + 1) + kRows * (kHC + 1) +
                       co * (kRows + 1)) +
      sizeof(__nv_bfloat16) * (kHC * c + co * kHC);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)(((long long)m + kRows - 1) / kRows);
  fused_mlp_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), (long long)m, c, hdim, co, residual,
      ln_eps);
  return static_cast<int>(cudaGetLastError());
}
