// Tiling shared by the two 3x3x3 / stride-1 / SAME convolution kernels
// (winograd3d.cu, conv3d.cu): a block owns kTD x kTH x kTW output voxels of
// one sample and kCoB output channels, stages the input tile with its
// one-voxel halo in shared memory once per chunk of kCK input channels
// (positions outside the volume are zero: that is all the border handling),
// multiplies on tensor cores and writes its outputs through shared memory in
// 16-byte rows. K10 streams its weights in slices with cp.async and
// multiplies with mma.sync m16n8k16 (bf16 in, fp32 out); K9 takes the tile
// shape and order and the output from here.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace convtile {

constexpr int kTD = 4, kTH = 8, kTW = 16;          // output voxels per block
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHalo = kHD * kHH * kHW;             // staged input voxels
constexpr int kVox = kTD * kTH * kTW;
constexpr int kCK = 48;            // input channels per staged chunk
constexpr int kCoB = 48;           // output channels per block
constexpr int kRow = kCK + 8;      // bf16 per staged row: 112 bytes, so the 8
                                   // rows of an ldmatrix fall in 8 bank groups
constexpr int kConvThreads = 384;  // 12 warps: 4 row groups x 3 column groups
constexpr size_t kXsBytes = sizeof(__nv_bfloat16) * kHalo * kRow;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[0..3] += a (16 x 16, row major) . b (16 x 8, column major)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage channels c0 .. c0 + ckp (ckp a multiple of 16, zero past C) of the
// halo tile whose first output voxel is (d0, h0, w0):
//   xs[v * kRow + cc], v = (hd * kHH + hh) * kHW + hw  <-  x[d0 + hd - 1, ...]
// x is the sample's (D, H, W, C) block. With ep (2 x C fp32: scale row, shift
// row) the staged value is lrelu?(x * scale + shift), computed in fp32 and
// rounded to bf16; positions outside the volume stay 0 either way, as the
// zero padding comes after the activation. vec: C is a multiple of 8, so a
// run of 8 channels is one aligned 16-byte load.
__device__ __forceinline__ void stage_input(
    __nv_bfloat16* xs, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ ep, int lrelu, float slope, int D, int H, int W,
    int C, int d0, int h0, int w0, int c0, int ckp, bool vec) {
  const int nchunk = ckp >> 3;
  for (int e = threadIdx.x; e < kHalo * nchunk; e += blockDim.x) {
    const int v = e / nchunk, cc = (e - v * nchunk) << 3;
    const int hw = v % kHW, hh = (v / kHW) % kHH, hd = v / (kHW * kHH);
    const int gd = d0 + hd - 1, gh = h0 + hh - 1, gw = w0 + hw - 1;
    __align__(16) __nv_bfloat16 vals[8];
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W) {
      const int ci0 = c0 + cc;
      const long long base = (((long long)gd * H + gh) * W + gw) * C + ci0;
      if (vec && ci0 + 8 <= C) {
        *reinterpret_cast<uint4*>(vals) =
            __ldg(reinterpret_cast<const uint4*>(x + base));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          vals[i] = ci0 + i < C ? x[base + i] : __float2bfloat16(0.f);
      }
      if (ep != nullptr) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ci = ci0 + i;
          if (ci < C) {
            float f = __fadd_rn(
                __fmul_rn(__bfloat162float(vals[i]), __ldg(ep + ci)),
                __ldg(ep + C + ci));
            if (lrelu && !(f >= 0.f)) f = __fmul_rn(f, slope);
            vals[i] = __float2bfloat16(f);
          }
        }
      }
      out = *reinterpret_cast<const uint4*>(vals);
    }
    *reinterpret_cast<uint4*>(xs + v * kRow + cc) = out;
  }
}

// Start the copy of np weight matrices, first p0, into ws:
//   ws[(p * kCoB + co) * kRow + k]  <-  wg[((p0 + p) * CoP + co0 + co) * CP
//                                          + c0 + k],  k < ckp.
// wg is (points, CoP, CP) bf16, zero padded by the wrapper so that CP is a
// multiple of 16 and CoP one of kCoB: no bounds to check here.
__device__ __forceinline__ void stage_weights_async(
    __nv_bfloat16* ws, const __nv_bfloat16* __restrict__ wg, int p0, int np,
    int CoP, int CP, int co0, int c0, int ckp) {
  const int nchunk = ckp >> 3;
  for (int e = threadIdx.x; e < np * kCoB * nchunk; e += blockDim.x) {
    const int r = e / nchunk, k = (e - r * nchunk) << 3;
    const int p = r / kCoB, co = r - p * kCoB;
    cp_async16(ws + r * kRow + k,
               wg + ((long long)(p0 + p) * CoP + co0 + co) * CP + c0 + k);
  }
  cp_async_commit();
}

// Write the block's outputs, staged as os[v * kCoB + col] with
// v = (od * kTH + oh) * kTW + ow, to y, the sample's (D, H, W, Co) block.
// vec: Co is a multiple of 8. Threads tid of nthr do it.
__device__ __forceinline__ void store_output(const __nv_bfloat16* os,
                                             __nv_bfloat16* __restrict__ y,
                                             int D, int H, int W, int Co,
                                             int d0, int h0, int w0, int co0,
                                             bool vec, int tid = threadIdx.x,
                                             int nthr = blockDim.x) {
  constexpr int nchunk = kCoB / 8;
  for (int e = tid; e < kVox * nchunk; e += nthr) {
    const int v = e / nchunk, cc = (e - v * nchunk) << 3;
    const int ow = v % kTW, oh = (v / kTW) % kTH, od = v / (kTW * kTH);
    const int gd = d0 + od, gh = h0 + oh, gw = w0 + ow, co = co0 + cc;
    if (gd >= D || gh >= H || gw >= W || co >= Co) continue;
    __nv_bfloat16* dst = y + (((long long)gd * H + gh) * W + gw) * Co + co;
    const __nv_bfloat16* src = os + v * kCoB + cc;
    if (vec && co + 8 <= Co) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && co + i < Co; ++i) dst[i] = src[i];
    }
  }
}

// The block's tile of the volume from blockIdx.x (W tiles fastest).
__device__ __forceinline__ void tile_origin(int nht, int nwt, int* d0, int* h0,
                                            int* w0) {
  int t = blockIdx.x;
  *w0 = (t % nwt) * kTW;
  t /= nwt;
  *h0 = (t % nht) * kTH;
  *d0 = (t / nht) * kTD;
}

}  // namespace convtile
}  // namespace medseg
