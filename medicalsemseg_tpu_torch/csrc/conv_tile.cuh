// Tiling of the Winograd 3x3x3 / stride-1 / SAME convolution kernel
// (winograd3d.cu): a block owns kTD x kTH x kTW output voxels of one sample
// and kCoB output channels, stages the input tile with its one-voxel halo in
// shared memory once per chunk of kCK input channels (positions outside the
// volume are zero: that is all the border handling), multiplies on tensor
// cores and writes its outputs through shared memory in 16-byte rows. (K10,
// conv3d.cu, has a tile and chunk of its own.) The tensor-core route stages
// 16-bit values (bf16 or fp16); the CUDA-core route (fp32) walks the same
// block tile.
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
constexpr int kRow = kCK + 8;      // 16-bit values per staged row: 112 bytes, so
                                   // the 8 rows of an ldmatrix fall in 8 bank
                                   // groups
constexpr size_t kXsBytes = 2 * kHalo * kRow;

// Write the block's outputs, staged as os[v * kCoB + col] with
// v = (od * kTH + oh) * kTW + ow, to y, the sample's (D, H, W, Co) block.
// vec: Co is a multiple of 8. Threads tid of nthr do it. T: a 16-bit type.
template <class T>
__device__ __forceinline__ void store_output(const T* os, T* __restrict__ y,
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
    T* dst = y + (((long long)gd * H + gh) * W + gw) * Co + co;
    const T* src = os + v * kCoB + cc;
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
