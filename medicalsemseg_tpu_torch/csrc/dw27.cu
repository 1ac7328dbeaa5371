// Weight gradient of the 3x3x3 / stride-1 / SAME convolution in one pass.
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/dw27.py: dw27_pallas
// (_kernel). For x (B, D, H, W, C) and dy (B, D, H, W, Co), channels last,
//   dw[kd, kh, kw, ci, co] = sum_{b,d,h,w} xpad[b, d+kd, h+kh, w+kw, ci]
//                                          * dy[b, d, h, w, co]
// with one voxel of zero padding around x: 27 matrix products (C, M) . (M, Co)
// over the M = B.D.H.W voxels. Products of the inputs as they are (bf16 or
// fp32), sums in fp32, result fp32.
//
// Design. The TPU kernel makes three W-shifted, lane-padded copies of x in
// device memory and walks a sequential grid over (b, d, h-chunk) with one
// (27, C, Co) accumulator in scratch memory. Here x is read from its own
// layout, and nothing is copied or padded beforehand:
//  - the accumulator (27.C.Co fp32: 249 KB at 48 -> 48) is larger than a
//    block's registers or shared memory, so a block owns a part of it: the
//    three taps kw = 0..2 of one (kd, kh) for a tile of kCT input and kCT
//    output channels, 27 sums per thread in registers;
//  - the voxels are cut into tiles of one W-row (up to kWT voxels). For a tile
//    a block stages the matching row of x, shifted by (kd - 1, kh - 1) and one
//    voxel longer at either end, and the row of dy in shared memory as fp32;
//    rows of x outside the volume are the zero padding and are skipped. Along
//    the row the three kw taps share every x value, which slides through
//    registers;
//  - `shares` blocks per output tile each walk a strided share of the voxel
//    tiles and write their sums to a slab of partials; sum_partials adds the
//    slabs in a fixed order, so a second run gives the same bits (no atomics).
// Blocks that differ only in (kd, kh) or the channel tile are neighbours in
// the grid and read the same rows at about the same time, so x and dy come
// from device memory about once and from L2 otherwise.
//
// Two kernels share this tiling. dw27_mma_kernel takes bf16 inputs whose
// channel counts are multiples of 8: the tile stays bf16 in shared memory and
// nine warps, one per (kw, 16 input channels), run mma.sync m16n8k16 over the
// voxel axis with fp32 accumulators; ldmatrix.trans turns the voxel-major
// rows into the operand fragments, and a tap's shift is a row offset of the
// same tile. dw27_kernel takes everything else (fp32 inputs, odd channel
// counts) on CUDA cores from an fp32 tile.
//
// What bounds them on the card: dw27_kernel, FMA throughput and shared-
// memory bandwidth (6 loads for 27 multiply-adds per voxel and thread).
// dw27_mma_kernel, shared-memory bandwidth (every warp loads the dy
// fragments again: 4 ldmatrix.x4 for 6 mma) and, behind it, L2 bandwidth
// (x and dy are staged once per (kd, kh)); both far under the tensor cores'
// rate that the function's bound assumes. Sharing fragments between taps
// and keeping x rows across h are the next steps.

#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int kCT = 48;        // input / output channels per block tile
constexpr int kWT = 96;        // voxels along W per spatial tile
constexpr int kPer = kCT / 16; // channels per thread along either axis

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid (9 . nci . nco, shares). part: (shares, 27, C, Co).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    dw27_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                float* __restrict__ part, int B, int D, int H, int W, int C,
                int Co, int nci, int nco) {
  __shared__ float xs[(kWT + 2) * kCT];  // xs[s][cc] = x[w0 + s - 1][ci0 + cc]
  __shared__ float ds[kWT * kCT];        // ds[s][cc] = dy[w0 + s][co0 + cc]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int o = blockIdx.x;
  const int co0 = (o % nco) * kCT;
  o /= nco;
  const int ci0 = (o % nci) * kCT;
  o /= nci;
  const int kd = o / 3, kh = o % 3;

  float acc[3][kPer][kPer];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[k][i][j] = 0.f;

  const int nwt = (W + kWT - 1) / kWT;
  const long long ntiles = (long long)B * D * H * nwt;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long row = tile / nwt;  // (b, d, h) of the dy row
    const int w0 = (int)(tile - row * nwt) * kWT;
    const int wt = min(kWT, W - w0);
    const int h = (int)(row % H);
    const int d = (int)((row / H) % D);
    const long long b = row / ((long long)H * D);
    const int sd = d + kd - 1, sh = h + kh - 1;
    if (sd < 0 || sd >= D || sh < 0 || sh >= H) continue;  // zero padding
    const T* xrow = x + ((b * D + sd) * H + sh) * (long long)W * C;
    const T* drow = dy + (row * W + w0) * (long long)Co;

    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < (wt + 2) * kCT; e += kThreads) {
      const int s = e / kCT, cc = e - s * kCT;
      const int gw = w0 + s - 1, ci = ci0 + cc;
      xs[e] = (gw >= 0 && gw < W && ci < C)
                  ? to_f32(xrow[(long long)gw * C + ci])
                  : 0.f;
    }
    for (int e = tid; e < wt * kCT; e += kThreads) {
      const int s = e / kCT, cc = e - s * kCT;
      const int co = co0 + cc;
      ds[e] = co < Co ? to_f32(drow[(long long)s * Co + co]) : 0.f;
    }
    __syncthreads();

    // lanes run along co: the ds reads are conflict-free, xs broadcasts
    float xa[kPer], xb[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      xa[i] = xs[ty + 16 * i];
      xb[i] = xs[kCT + ty + 16 * i];
    }
#pragma unroll 4
    for (int w = 0; w < wt; ++w) {
      float xc[kPer], dv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) xc[i] = xs[(w + 2) * kCT + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) dv[j] = ds[w * kCT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          acc[0][i][j] += xa[i] * dv[j];
          acc[1][i][j] += xb[i] * dv[j];
          acc[2][i][j] += xc[i] * dv[j];
        }
        xa[i] = xb[i];
        xb[i] = xc[i];
      }
    }
  }

  float* p = part + (size_t)blockIdx.y * 27 * C * Co;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int ci = ci0 + ty + 16 * i, co = co0 + tx + 16 * j;
        if (ci < C && co < Co)
          p[((size_t)((kd * 3 + kh) * 3 + k) * C + ci) * Co + co] =
              acc[k][i][j];
      }
}

constexpr int kMmaThreads = 288;   // 9 warps: (kw, 16-channel tile of ci)
constexpr int kStride = kCT + 8;   // bf16 per staged row: 112 bytes, so the 8
                                   // rows of an ldmatrix fall in 8 bank groups

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kFlush = 4;          // tiles between two flushes of the mma sums
constexpr size_t kMmaSmem =
    sizeof(__nv_bfloat16) * (2 * kWT + 2) * kStride +
    sizeof(float) * (kCT / 8) * 4 * kMmaThreads;

// Same grid and partials as dw27_kernel. C and Co are multiples of 8, so a
// row of x or dy is a run of 16-byte chunks, each inside or outside the tile.
//
// The tensor cores add into their fp32 accumulator by truncation, and a long
// chain of such additions drifts (1.8e-4 of the result after 5,000 of them,
// measured). So the mma accumulators hold the sum of kFlush tiles only and
// are then added, rounding to nearest, into the thread's own fp32 sums in
// shared memory (no thread reads another's, so no barrier is needed).
__global__ void __launch_bounds__(kMmaThreads, 3)
    dw27_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dy,
                    float* __restrict__ part, int B, int D, int H, int W, int C,
                    int Co, int nci, int nco) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ds = xs + (kWT + 2) * kStride;
  float* sums = reinterpret_cast<float*>(ds + kWT * kStride);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp / 3, m0 = (warp % 3) * 16;
  int o = blockIdx.x;
  const int co0 = (o % nco) * kCT;
  o /= nco;
  const int ci0 = (o % nci) * kCT;
  o /= nci;
  const int kd = o / 3, kh = o % 3;

  float acc[kCT / 8][4];
#pragma unroll
  for (int n = 0; n < kCT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[n][i] = 0.f;
      sums[(n * 4 + i) * kMmaThreads + tid] = 0.f;
    }

  // this lane's row and column inside the four 8x8 matrices of an ldmatrix:
  // A (ci x voxel) from xs: matrices (ci 0-7 | 8-15) x (voxel 0-7 | 8-15);
  // B (voxel x co) from ds: matrices (voxel 0-7 | 8-15) x (co 0-7 | 8-15)
  const int lj = lane >> 3, lr = lane & 7;
  const int a_off = (kw + lr + ((lj >> 1) << 3)) * kStride + m0 + ((lj & 1) << 3);
  const int b_off = (lr + ((lj & 1) << 3)) * kStride + ((lj >> 1) << 3);

  constexpr int kChunks = kCT / 8;  // 16-byte chunks per staged row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int nwt = (W + kWT - 1) / kWT;
  const long long ntiles = (long long)B * D * H * nwt;
  int pending = 0;  // tiles in the mma accumulators
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long row = tile / nwt;
    const int w0 = (int)(tile - row * nwt) * kWT;
    const int wt = min(kWT, W - w0);
    const int h = (int)(row % H);
    const int d = (int)((row / H) % D);
    const long long b = row / ((long long)H * D);
    const int sd = d + kd - 1, sh = h + kh - 1;
    if (sd < 0 || sd >= D || sh < 0 || sh >= H) continue;  // zero padding
    const __nv_bfloat16* xrow = x + ((b * D + sd) * H + sh) * (long long)W * C;
    const __nv_bfloat16* drow = dy + (row * W + w0) * (long long)Co;
    const int ksteps = (wt + 15) / 16;
    const int nrows = ksteps * 16;  // rows at or past wt are zero

    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < (nrows + 2) * kChunks; e += kMmaThreads) {
      const int s = e / kChunks, cc = (e - s * kChunks) * 8;
      const int gw = w0 + s - 1, ci = ci0 + cc;
      uint4 v = zero;
      if (gw >= 0 && gw < W && s < wt + 2 && ci < C)
        v = __ldg(reinterpret_cast<const uint4*>(xrow + (long long)gw * C + ci));
      *reinterpret_cast<uint4*>(xs + s * kStride + cc) = v;
    }
    for (int e = tid; e < nrows * kChunks; e += kMmaThreads) {
      const int s = e / kChunks, cc = (e - s * kChunks) * 8;
      const int co = co0 + cc;
      uint4 v = zero;
      if (s < wt && co < Co)
        v = __ldg(reinterpret_cast<const uint4*>(drow + (long long)s * Co + co));
      *reinterpret_cast<uint4*>(ds + s * kStride + cc) = v;
    }
    __syncthreads();

    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, xs + ks * 16 * kStride + a_off);
#pragma unroll
      for (int n = 0; n < kCT / 16; ++n) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, ds + ks * 16 * kStride + b_off + n * 16);
        mma_bf16(acc[2 * n], a, bq[0], bq[1]);
        mma_bf16(acc[2 * n + 1], a, bq[2], bq[3]);
      }
    }
    if (++pending == kFlush) {
      pending = 0;
#pragma unroll
      for (int n = 0; n < kCT / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sums[(n * 4 + i) * kMmaThreads + tid] += acc[n][i];
          acc[n][i] = 0.f;
        }
    }
  }

  // accumulator fragment: rows g and g + 8, columns 2t and 2t + 1
  float* p = part + (size_t)blockIdx.y * 27 * C * Co +
             (size_t)((kd * 3 + kh) * 3 + kw) * C * Co;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < kCT / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = ci0 + m0 + g + (i >> 1) * 8;
      const int co = co0 + n * 8 + t2 + (i & 1);
      if (ci < C && co < Co)
        p[(size_t)ci * Co + co] =
            sums[(n * 4 + i) * kMmaThreads + tid] + acc[n][i];
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* part, int b, int d,
                   int h, int w, int c, int co, int shares, cudaStream_t st) {
  const int nci = (c + kCT - 1) / kCT, nco = (co + kCT - 1) / kCT;
  cudaError_t err = cudaFuncSetAttribute(
      dw27_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dw27_kernel<T><<<dim3(9 * nci * nco, shares), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, b, d, h, w, c,
      co, nci, nco);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medseg

// x (b, d, h, w, c) and dy (b, d, h, w, co), contiguous. route 0: both fp32,
// CUDA cores; 1: both bf16, CUDA cores; 2: both bf16 with c and co multiples
// of 8, tensor cores. part (shares, 27 * c * co) is scratch; out
// (3, 3, 3, c, co) fp32.
extern "C" int medseg_dw27(const void* x, const void* dy, void* part,
                           void* out, int b, int d, int h, int w, int c,
                           int co, int shares, int route, void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || d < 1 || h < 1 || w < 1 || c < 1 || co < 1 || shares < 1 ||
      shares > 65535 || route < 0 || route > 2 ||
      (route == 2 && (c % 8 != 0 || co % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* partf = static_cast<float*>(part);
  cudaError_t err;
  if (route == 2) {
    const int nci = (c + kCT - 1) / kCT, nco = (co + kCT - 1) / kCT;
    err = cudaFuncSetAttribute(dw27_mma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(dw27_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw27_mma_kernel<<<dim3(9 * nci * nco, shares), kMmaThreads, kMmaSmem,
                      st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), partf, b, d, h, w, c, co, nci,
        nco);
    err = cudaGetLastError();
  } else if (route == 1) {
    err = launch<__nv_bfloat16>(x, dy, partf, b, d, h, w, c, co, shares, st);
  } else {
    err = launch<float>(x, dy, partf, b, d, h, w, c, co, shares, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sum_partials(partf, static_cast<float*>(out), shares,
                     27LL * c * co, st);
  return static_cast<int>(err);
}
