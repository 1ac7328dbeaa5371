// Tiles of the tensor-core token-MLP kernels (K2 forward in mlp.cu, K4
// backward in mlp_bwd.cu) for bf16 and fp16 with C, Co and the hidden width
// H multiples of 16: mma.sync m16n8k16 with fp32 accumulation (mma_tile.cuh).
// The window-attention GEMM launches (K1's and K6's projection, K3's dx and
// dw in window_attention*.cu) take the same 64-token tiles, copies and
// column parts.
//
// A block of four warps takes token tiles of 64 rows, one 16-row strip a
// warp, and walks H in chunks of 64 hidden units. Token tiles are staged in
// T as [row][channel] with the row stride C + 8 (an odd number of 16-byte
// units, so the eight rows of an ldmatrix fall in eight bank groups); weight
// chunks are copied with cp.async: W1 rows [unit][channel] (stride C + 8)
// and W2 columns [out][unit] (stride kW2Stride = 72).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_tile.cuh"

// MEDSEG_MLP_SKIP: parts of the tensor-core MLP kernels compiled out, for
// chip_smoke.py's mlp_parts phase only (0, nothing skipped, in the library;
// the results of a variant are wrong by design): 1 the LayerNorm statistics
// and the token-tile staging loads (x, dy, K4's dhb chunks), 2 the GELU /
// GELU' elementwise work, 4 the weight staging, 8 K4's dW flushes and
// partials, 16 K4's store of dhb, 32 K4's dx launch.
#ifndef MEDSEG_MLP_SKIP
#define MEDSEG_MLP_SKIP 0
#endif

namespace medseg {
namespace mlptile {

constexpr int kMlpWarps = 4;
constexpr int kMlpThreads = 32 * kMlpWarps;
constexpr int kMlpRows = 16 * kMlpWarps;  // token rows a tile
constexpr int kChunk = 64;                // hidden units a chunk
constexpr int kW2Stride = kChunk + 8;     // stride of a staged [out][unit] chunk
constexpr int kMaxSmem = 232448;          // dynamic shared memory of a block
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   mmatile::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n committed groups of this thread are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Copy rows [0, nrows) x columns [0, ncols) of a row-major matrix (row
// stride ld elements; src already offset to the first element) into dst with
// the row stride dld, in 16-byte pieces (ncols, ld and the offsets multiples
// of 8). The caller commits and waits.
template <class T>
__device__ __forceinline__ void copy_rows_async(const T* src, long long ld,
                                                int nrows, int ncols, T* dst,
                                                int dld) {
  const int vecs = ncols / 8;
  for (int e = threadIdx.x; e < nrows * vecs; e += blockDim.x) {
    const int r = e / vecs, v8 = (e - r * vecs) * 8;
    cp_async16(dst + r * dld + v8, src + (long long)r * ld + v8);
  }
}

// Stage a token tile of `rows` valid rows and c channels (a multiple of 8):
// the raw rows of x into xs and, with dy != nullptr, of dy into ds (row
// stride c + 8), all by cp.async, so that every load of the tile is in
// flight at once; rows >= rows are zero, so they add nothing to any product
// or gradient. With ln, the LayerNorm statistics (fast variance) a row a
// thread from shared memory into mu / rs, then xs = T(LN(x)) in place.
// Waits for every cp.async group of the thread; starts and ends with a
// __syncthreads().
template <class T>
__device__ __forceinline__ void stage_tiles(const T* x, const T* dy, int rows,
                                            int c, const float* ln, float eps,
                                            float* mu, float* rs, T* xs,
                                            T* ds) {
  __syncthreads();  // the previous readers of mu, rs, xs and ds are done
  if (MEDSEG_MLP_SKIP & 1) return;  // xs and ds stay as zero_smem left them
  const int xsd = c + 8, vecs = c / 8;
  copy_rows_async(x, c, rows, c, xs, xsd);
  if (dy != nullptr) copy_rows_async(dy, c, rows, c, ds, xsd);
  cp_async_commit();
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < (kMlpRows - rows) * vecs; e += blockDim.x) {
    const int r = rows + e / vecs, v8 = (e % vecs) * 8;
    *reinterpret_cast<uint4*>(xs + r * xsd + v8) = zero4;
    if (dy != nullptr) *reinterpret_cast<uint4*>(ds + r * xsd + v8) = zero4;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (ln == nullptr) return;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const uint4* row = reinterpret_cast<const uint4*>(xs + r * xsd);
    float s = 0.f, ss = 0.f;
    for (int v = 0; v < vecs; ++v) {
      const uint4 in = row[v];
      const T* iv = reinterpret_cast<const T*>(&in);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float f = to_f32(iv[i]);
        s += f;
        ss += f * f;
      }
    }
    const float m = s / c;
    mu[r] = m;
    rs[r] = 1.0f / sqrtf(fmaxf(0.f, ss / c - m * m) + eps);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * vecs; e += blockDim.x) {
    const int r = e / vecs, v8 = (e - r * vecs) * 8;
    uint4* at = reinterpret_cast<uint4*>(xs + r * xsd + v8);
    const uint4 in = *at;
    const T* iv = reinterpret_cast<const T*>(&in);
    uint4 out;
    uint32_t* ov = reinterpret_cast<uint32_t*>(&out);
    const float m = mu[r], rr = rs[r];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = v8 + 2 * i;
      ov[i] = mmatile::pack<T>(
          (to_f32(iv[2 * i]) - m) * (rr * ln[ch]) + ln[c + ch],
          (to_f32(iv[2 * i + 1]) - m) * (rr * ln[ch + 1]) + ln[c + ch + 1]);
    }
    *at = out;
  }
  __syncthreads();
}

// Zero `bytes` (a multiple of 16) of shared memory from p: the parts
// variants (MEDSEG_MLP_SKIP) start from it, so that a skipped load leaves
// zeros rather than stale bits that could send the arithmetic down its slow
// paths. The caller synchronises.
__device__ __forceinline__ void zero_smem(void* p, size_t bytes) {
  uint4* v = static_cast<uint4*>(p);
  for (size_t e = threadIdx.x; e < bytes / 16; e += blockDim.x)
    v[e] = make_uint4(0u, 0u, 0u, 0u);
}

// Phi(h) (gelu_cdf in common.cuh: the Abramowitz-Stegun erf of the JAX
// kernels) and, with phi != nullptr, the density phi(h) = exp(-h^2 / 2) /
// sqrt(2 pi), from one exponential; the polynomial's 1 / (1 + p a) by the
// fast division (2 ulp: the polynomial itself is 1.5e-7 off erf).
__device__ __forceinline__ float gelu_parts(float h, float* phi) {
  const float e = expf(-0.5f * h * h);
  const float a = fabsf(h) * 0.7071067811865476f;
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf_a = 1.0f - poly * e;
  if (phi != nullptr) *phi = e * kInvSqrt2Pi;
  return 0.5f * (1.0f + (h < 0.f ? -erf_a : erf_a));
}

// Of the slot counts cands[0] > cands[1] > ... (chunks of weights a block
// stages at a time), the largest that keeps the most blocks of `kernel` on
// an SM, with its dynamic shared memory base + slots * slot bytes; the
// kernel's shared-memory limit is raised to the card's. *nslots = 0 where
// none fits.
template <class K>
cudaError_t pick_slots(K kernel, size_t base, size_t slot, const int* cands,
                       int ncand, int* nslots, size_t* smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  int best = 0;
  *nslots = 0;
  for (int i = 0; i < ncand && err == cudaSuccess; ++i) {
    const size_t bytes = base + cands[i] * slot;
    int blocks = 0;
    if (bytes > (size_t)kMaxSmem) continue;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kMlpThreads, bytes);
    if (blocks > best) {
      best = blocks;
      *nslots = cands[i];
      *smem = bytes;
    }
  }
  return err;
}

// Whether a K2 launch of this dtype and shape can take the route: the
// tensor cores take bf16 and fp16 with C, Co and H multiples of 16 and
// C <= 768 (a 64-row token tile and a W1 chunk in one block's shared
// memory); the CUDA cores take every dtype and shape.
inline bool mlp_route_takes(int route, int dtype, int c, int co, int hdim) {
  if (route == kRouteCudaCore) return true;
  return route == kRouteTensorCore && (dtype == kBf16 || dtype == kF16) &&
         c % 16 == 0 && co % 16 == 0 && hdim % 16 == 0 && c <= 768;
}

// K4's dx launch on the tensor cores splits C into `parts` column parts of
// at most 96 channels, a multiple of 16 each, over the four warps: 1, 2 or
// 4 (0: the route does not take C).
inline int mlp_dx_parts(int c) {
  for (int parts = 1; parts <= 4; parts *= 2)
    if (c % (16 * parts) == 0 && c / parts <= 96) return parts;
  return 0;
}

// Whether a K4 launch can take the route: the tensor cores take bf16 and
// fp16 with C and H multiples of 16 and C in parts as above (C <= 384);
// the CUDA cores take every dtype with C <= 512.
inline bool mlp_bwd_route_takes(int route, int dtype, int c, int hdim) {
  if (route == kRouteCudaCore) return true;
  return route == kRouteTensorCore && (dtype == kBf16 || dtype == kF16) &&
         hdim % 16 == 0 && mlp_dx_parts(c) > 0;
}

// Columns of the attention GEMM launches' tiles on the tensor cores: C
// itself up to 96, else the widest multiple of 16 up to 96 dividing C. It is
// the projection's column tile and k chunk, and the channel slice of K3's
// dw launch.
inline int gemm_width(int c) {
  if (c <= 96) return c;
  for (int w = 96; w >= 16; w -= 16)
    if (c % w == 0) return w;
  return 0;
}

// Whether an attention GEMM launch (K1's and K6's projection, K3's dx and
// dw) of this dtype and width can take the route: the tensor cores take
// bf16 and fp16 with C in column parts as K4's dx launch (mlp_dx_parts:
// every multiple of 16 up to 96, of 32 up to 192, of 64 up to 384); the
// CUDA cores take every dtype and width.
inline bool gemm_route_takes(int route, int dtype, int c) {
  if (route == kRouteCudaCore) return true;
  return route == kRouteTensorCore && (dtype == kBf16 || dtype == kF16) &&
         mlp_dx_parts(c) > 0;
}

// The blocks of a launch that walks its tiles in a strided loop: `want`,
// cut to the number of blocks of `kernel` that are resident on the card at
// once (so that no second, partial wave runs), and at least 1.
template <class K>
cudaError_t resident_grid(K kernel, int threads, size_t smem, int want,
                          int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  *grid = max(1, min(want, per_sm * sms));
  return err;
}

}  // namespace mlptile
}  // namespace medseg
