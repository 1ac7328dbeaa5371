// Fused DiceCE loss: the sums of the forward and the logits' gradient, each
// in one pass over the logits.
//
// Replaces the TPU kernels of medicalsemseg_tpu/ops/pallas/dice_ce.py:
// _fwd_sums (_fwd_kernel) and the backward call of _fused_for (_bwd_kernel).
// For logits (B, M, C) fp32 and labels (B, M), with p = softmax over C and t
// the one-hot target:
//   sums[b] = [ sum_m p.t | sum_m p^2 | sum_m t | sum_m -log(p).t ]  (4, C)
//   dlogits = p . (g - sum_c g.p) + ce . (p - t),  g = ca[b].t + cp[b].p
// The softmax is recomputed in the backward; the one-hot target exists only
// as a comparison against the label. The scalar algebra around the two
// (Dice ratio, means, the coefficients ca, cp, ce) is left to the caller.
//
// Design. The TPU kernels walk M in tiles on a sequential grid with one small
// accumulator, and pad M to the tile with label -1. Here a block stages a
// tile of 256 voxels (256 . C contiguous floats) in shared memory with
// coalesced reads (a row is C = 14 floats, 56 bytes: a thread per voxel
// reading device memory directly would touch a new sector with every load),
// one thread per voxel computes the row's softmax in registers and writes p
// back to the tile, and the tail is bounds-checked: no padding.
//  - forward: the block then turns the tile on its side: thread (class, slice)
//    adds up its class over every 16th (C <= 16) or 8th voxel of the tile and
//    keeps four running sums over all the block's tiles. At the end the
//    slices are added in order and written to one slab per block; sum_partials
//    adds the slabs in a fixed order (no atomics: a second run is bit-equal).
//  - backward: elementwise; the tile goes back to device memory coalesced.
// What bounds both: device-memory bytes (forward reads logits and labels,
// backward reads them and writes dlogits); neither has a product to speak of.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int kMaxCls = 32;     // classes held in a thread's registers
constexpr int kVox = kThreads;  // voxels per tile, one per thread

__device__ __forceinline__ int load_label(const void* labels, long long i,
                                          int lab64) {
  return lab64 ? (int)static_cast<const long long*>(labels)[i]
               : static_cast<const int*>(labels)[i];
}

__device__ __forceinline__ void stage_tile(const float* src, float* ps, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) ps[e] = src[e];
}

// Softmax of one staged row: z[k] = exp(x_k - max), returns their sum; *mx is
// the max. Entries at or past c are 0.
__device__ __forceinline__ float row_exp(const float* row, int c,
                                         float (&z)[kMaxCls], float* mx) {
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxCls; ++k) {
    z[k] = k < c ? row[k] : -INFINITY;
    m = fmaxf(m, z[k]);
  }
  float se = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxCls; ++k) {
    z[k] = k < c ? expf(z[k] - m) : 0.f;
    se += z[k];
  }
  *mx = m;
  return se;
}

// grid (blocks, B). part: (blocks, B, 4, c).
__global__ void __launch_bounds__(kThreads)
    dice_ce_sums_kernel(const float* __restrict__ logits,
                        const void* __restrict__ labels, int lab64,
                        float* __restrict__ part, long long m, int c) {
  __shared__ float ps[kVox * kMaxCls];  // the tile, row stride c
  __shared__ float nll[kVox];           // -log p of the voxel's own class
  __shared__ int labs[kVox];
  __shared__ float red[4 * kThreads];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.y * m;
  const long long ntiles = (m + kVox - 1) / kVox;
  const int cp = c <= 16 ? 16 : 32;  // threads per slice
  const int k = tid % cp, slice = tid / cp, nslice = kThreads / cp;
  float a_int = 0.f, a_psq = 0.f, a_cnt = 0.f, a_ce = 0.f;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long v0 = tile * kVox;
    const int nv = (int)min((long long)kVox, m - v0);
    __syncthreads();  // the previous tile's readers are done
    stage_tile(logits + (base + v0) * c, ps, nv * c);
    __syncthreads();
    if (tid < nv) {
      float* row = ps + tid * c;
      float z[kMaxCls], mx;
      const float se = row_exp(row, c, z, &mx);
      const int lab = load_label(labels, base + v0 + tid, lab64);
      const bool in = lab >= 0 && lab < c;
      nll[tid] = in ? logf(se) - (row[in ? lab : 0] - mx) : 0.f;
      labs[tid] = in ? lab : -1;
#pragma unroll
      for (int q = 0; q < kMaxCls; ++q)
        if (q < c) row[q] = z[q] / se;
    }
    __syncthreads();
    if (k < c) {
      for (int v = slice; v < nv; v += nslice) {
        const float pv = ps[v * c + k];
        a_psq += pv * pv;
        if (labs[v] == k) {
          a_int += pv;
          a_cnt += 1.f;
          a_ce += nll[v];
        }
      }
    }
  }

  red[tid] = a_int;
  red[kThreads + tid] = a_psq;
  red[2 * kThreads + tid] = a_cnt;
  red[3 * kThreads + tid] = a_ce;
  __syncthreads();
  if (tid < 4 * c) {
    const int q = tid / c, kk = tid - q * c;
    float a = 0.f;
    for (int s = 0; s < nslice; ++s) a += red[q * kThreads + s * cp + kk];
    part[(((size_t)blockIdx.x * gridDim.y + blockIdx.y) * 4 + q) * c + kk] = a;
  }
}

// grid (tiles, B): one tile per block.
__global__ void __launch_bounds__(kThreads)
    dice_ce_dlogits_kernel(const float* __restrict__ logits,
                           const void* __restrict__ labels, int lab64,
                           const float* __restrict__ ca,
                           const float* __restrict__ cp,
                           const float* __restrict__ ce,
                           float* __restrict__ dlogits, long long m, int c) {
  __shared__ float ps[kVox * kMaxCls];
  __shared__ float coef[2 * kMaxCls];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.y * m;
  const long long v0 = (long long)blockIdx.x * kVox;
  const int nv = (int)min((long long)kVox, m - v0);
  if (tid < c) {
    coef[tid] = ca[blockIdx.y * c + tid];
    coef[kMaxCls + tid] = cp[blockIdx.y * c + tid];
  }
  stage_tile(logits + (base + v0) * c, ps, nv * c);
  __syncthreads();
  if (tid < nv) {
    float* row = ps + tid * c;
    float z[kMaxCls], mx;
    const float se = row_exp(row, c, z, &mx);
    const int lab = load_label(labels, base + v0 + tid, lab64);
    const float w_ce = ce[0];
    float gsum = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCls; ++q) {
      if (q < c) {
        z[q] = z[q] / se;  // p
        const float g = (q == lab ? coef[q] : 0.f) + coef[kMaxCls + q] * z[q];
        gsum += g * z[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxCls; ++q) {
      if (q < c) {
        const float t = q == lab ? 1.f : 0.f;
        const float g = t * coef[q] + coef[kMaxCls + q] * z[q];
        row[q] = z[q] * (g - gsum) + w_ce * (z[q] - t);
      }
    }
  }
  __syncthreads();
  float* dst = dlogits + (base + v0) * c;
  for (int e = tid; e < nv * c; e += kThreads) dst[e] = ps[e];
}

}  // namespace
}  // namespace medseg

// logits (b, m, c) fp32, labels (b, m) int32 or int64 (lab64), contiguous.
// part (blocks, b * 4 * c) is scratch; out (b, 4, c) fp32.
extern "C" int medseg_dice_ce_sums(const void* logits, const void* labels,
                                   void* part, void* out, int b, long long m,
                                   int c, int blocks, int lab64,
                                   void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || m < 1 || c < 1 || c > kMaxCls || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dice_ce_sums_kernel<<<dim3(blocks, b), kThreads, 0, st>>>(
      static_cast<const float*>(logits), labels, lab64,
      static_cast<float*>(part), m, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sum_partials(static_cast<const float*>(part), static_cast<float*>(out),
                     blocks, 4LL * b * c, st);
  return static_cast<int>(err);
}

// ca, cp (b, c) and ce (1) fp32 on the device; dlogits (b, m, c) fp32.
extern "C" int medseg_dice_ce_dlogits(const void* logits, const void* labels,
                                      const void* ca, const void* cp,
                                      const void* ce, void* dlogits, int b,
                                      long long m, int c, int lab64,
                                      void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (m + kVox - 1) / kVox;
  if (b < 1 || b > 65535 || m < 1 || tiles > 2147483647LL || c < 1 ||
      c > kMaxCls)
    return static_cast<int>(cudaErrorInvalidValue);
  dice_ce_dlogits_kernel<<<dim3((unsigned)tiles, b), kThreads, 0, st>>>(
      static_cast<const float*>(logits), labels, lab64,
      static_cast<const float*>(ca), static_cast<const float*>(cp),
      static_cast<const float*>(ce), static_cast<float*>(dlogits), m, c);
  return static_cast<int>(cudaGetLastError());
}
