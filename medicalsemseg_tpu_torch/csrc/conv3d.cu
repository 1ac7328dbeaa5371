// 3x3x3 / stride-1 / SAME convolution as one matrix product over an im2col
// tile that exists only as addresses (an implicit GEMM).
//
// Replaces the TPU kernels medicalsemseg_tpu/ops/pallas/conv3d.py: _conv_fwd
// (_fwd_kernel), which is also its input gradient (the same conv on dy with
// the flipped, in / out swapped weights). Its weight gradient _conv_dw
// (_dw_kernel) computes the function of dw27.cu, which serves it.
// For x (B, D, H, W, C) bf16 and w (27 taps, Co, C) bf16 (kd-major taps, laid
// out and zero padded by the wrapper),
//   y[b, d, h, w, co] = sum_{tap, ci} xpad[b, d + kd, h + kh, w + kw, ci]
//                                     * w[tap, co, ci],
// products of the bf16 values, sums in fp32, one rounding to bf16.
//
// Design. The TPU kernel copies 27 shifted (TH.W, C) blocks into a
// (TH.W, 27 C) scratch (lane-misaligned stores, which bound it there), from
// an input that the host padded and cut into overlapping H chunks. Here the
// block stages the 6 x 10 x 18 halo tile of its 4 x 8 x 16 output voxels once
// per 48 input channels (conv_tile.cuh), and a tap's column block of the
// im2col matrix is the same tile at a row offset: ldmatrix takes any row
// address, so nothing is copied. The weights (124 KB at 48 -> 48) stream in
// slices of 3 taps (one (kd, kh), 16 KB, double buffered with cp.async). 12
// warps: warp (od, ns) owns the 8 rows of 16 voxels of its depth slice and 16
// output channels, 64 fp32 sums a thread; per tap and 16 input channels one
// ldmatrix.x4 of weights serves 8 of voxels and 16 mma.sync m16n8k16.
//
// What bounds it on the card: the function's bound is operations (27 taps);
// the kernel is bound by shared-memory bandwidth (288 bytes of ldmatrix per
// mma) and one block of 12 warps per SM. wgmma and TMA are the next steps.

#include "conv_tile.cuh"

namespace medseg {
namespace {

using namespace convtile;

constexpr int kWsElems = 3 * kCoB * kRow;   // the weights of one (kd, kh)
constexpr size_t kSmemBytes =
    kXsBytes + sizeof(__nv_bfloat16) * 2 * kWsElems;

// grid (tiles of the volume, B, ceil(Co / kCoB)).
__global__ void __launch_bounds__(kConvThreads, 1)
    conv3_im2col_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wg,
                        __nv_bfloat16* __restrict__ y, int D, int H, int W,
                        int C, int Co, int CP, int CoP, int nht, int nwt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = xs + kHalo * kRow;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int od = warp / 3, ns = warp % 3;
  int d0, h0, w0;
  tile_origin(nht, nwt, &d0, &h0, &w0);
  const int b = blockIdx.y, co0 = blockIdx.z * kCoB;
  const long long vox = (long long)D * H * W;

  // this lane's row and column in the four 8 x 8 matrices of an ldmatrix:
  // A (voxel x ci): (ow 0-7 | 8-15) x (ci 0-7 | 8-15);
  // B (co x ci):    (ci 0-7 | 8-15) x (co 0-7 | 8-15)
  const int lj = lane >> 3, lr = lane & 7;
  const int a_off = (lr + ((lj & 1) << 3)) * kRow + ((lj >> 1) << 3);
  const int b_off = (ns * 16 + lr + ((lj >> 1) << 3)) * kRow + ((lj & 1) << 3);

  float acc[kTH][8];
#pragma unroll
  for (int oh = 0; oh < kTH; ++oh)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[oh][r] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCK) {
    const int ckp = (min(kCK, C - c0) + 15) & ~15;
    const int ksteps = ckp >> 4;
    __syncthreads();  // the previous chunk's readers are done
    stage_input(xs, x + b * vox * C, nullptr, 0, 0.f, D, H, W, C, d0, h0, w0,
                c0, ckp, (C & 7) == 0);
    stage_weights_async(ws, wg, 0, 3, CoP, CP, co0, c0, ckp);

#pragma unroll 1
    for (int g = 0; g < 9; ++g) {   // (kd, kh)
      const int kd = g / 3, kh = g - kd * 3;
      cp_async_wait_all();
      // this slice (and at g = 0 the input tile) is in place, and every warp
      // is done with the slice before, whose buffer the next copy takes
      __syncthreads();
      if (g + 1 < 9)
        stage_weights_async(ws + ((g + 1) & 1) * kWsElems, wg, (g + 1) * 3, 3,
                            CoP, CP, co0, c0, ckp);
      const __nv_bfloat16* wb = ws + (g & 1) * kWsElems + b_off;
      const __nv_bfloat16* xa = xs + ((od + kd) * kHH + kh) * kHW * kRow + a_off;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t bf[4];
          ldmatrix_x4(bf, wb + kw * kCoB * kRow + ks * 16);
#pragma unroll
          for (int oh = 0; oh < kTH; ++oh) {
            uint32_t af[4];
            ldmatrix_x4(af, xa + (oh * kHW + kw) * kRow + ks * 16);
            mma_bf16(acc[oh], af, bf[0], bf[1]);
            mma_bf16(acc[oh] + 4, af, bf[2], bf[3]);
          }
        }
      }
    }
  }

  // accumulator fragment: voxels ow = g and g + 8 of row (od, oh), columns
  // 2t and 2t + 1 of either 8-column half
  __syncthreads();  // every warp is done with the input tile
  __nv_bfloat16* os = xs;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int oh = 0; oh < kTH; ++oh)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* f = &acc[oh][nt * 4 + half * 2];
        *reinterpret_cast<__nv_bfloat162*>(
            os + ((od * kTH + oh) * kTW + g + 8 * half) * kCoB + ns * 16 +
            nt * 8 + t2) = __floats2bfloat162_rn(f[0], f[1]);
      }
  __syncthreads();
  store_output(os, y + b * vox * Co, D, H, W, Co, d0, h0, w0, co0,
               (Co & 7) == 0);
}

}  // namespace
}  // namespace medseg

// x (b, d, h, w, c) bf16; wg (27, cop, cp) bf16, zero padded, cp a multiple
// of 16 and cop one of 48; y (b, d, h, w, co) bf16.
extern "C" int medseg_conv3x3x3(const void* x, const void* wg, void* y, int b,
                                int d, int h, int w, int c, int co, int cp,
                                int cop, void* stream) {
  using namespace medseg;
  using namespace medseg::convtile;
  if (b < 1 || b > 65535 || d < 1 || h < 1 || w < 1 || c < 1 || co < 1 ||
      cp < c || cp % 16 != 0 || cop < co || cop % kCoB != 0 ||
      cop / kCoB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ndt = (d + kTD - 1) / kTD, nht = (h + kTH - 1) / kTH,
            nwt = (w + kTW - 1) / kTW;
  if ((long long)ndt * nht * nwt > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3_im2col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3_im2col_kernel<<<dim3(ndt * nht * nwt, b, cop / kCoB), kConvThreads,
                        kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wg), static_cast<__nv_bfloat16*>(y),
      d, h, w, c, co, cp, cop, nht, nwt);
  return static_cast<int>(cudaGetLastError());
}
