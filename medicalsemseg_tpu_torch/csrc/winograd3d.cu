// 3x3x3 / stride-1 / SAME convolution as Winograd F(2^3, 3^3), with an
// optional scale / shift / LeakyReLU pass over the input folded in.
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/winograd3d.py:
// winograd_conv3d_f23 (_kernel). For x (B, D, H, W, C) bf16 and the
// Winograd-domain weights u (64 points, Co, C) bf16 (transformed by the
// wrapper, point (a, b, c) = d, h, w index, a-major), every 2^3 tile of
// outputs comes from the 4^3 tile of inputs around it:
//   V[abc] = B^T_a B^T_b B^T_c x      (input transform, per channel)
//   M[abc] = V[abc] (tiles, C) . u[abc] (C, Co)     64 products, not 216
//   y      = A^T_a A^T_b A^T_c M      (output transform, per channel)
// With ep (B, 2, C) fp32 the conv's input is lrelu?(x * scale + shift), the
// folded form of an InstanceNorm (+ LeakyReLU) before the conv, with the SAME
// padding still zero. Rounding points are the TPU kernel's: the activation
// and each of the three input-transform stages (w, then h, then d) round to
// bf16, products add in fp32, the output transform is fp32 and y rounds once.
//
// Design. The TPU kernel splits W into even / odd phase arrays on the host,
// lane-pads C to 128, walks (4, 4, whole W row) blocks and so needs D % 4,
// H % 4, (W / 2) % 8. Here x is read from its own layout and the border is a
// bounds check, so any D, H, W runs (an odd size is a masked tail of a tile):
//  - a block owns 4 x 8 x 16 output voxels = 64 Winograd tiles of one sample
//    and 48 output channels; it stages the 6 x 10 x 18 halo tile of 48 input
//    channels once (conv_tile.cuh), applying ep there;
//  - V is 8 values per output voxel and u is 295 KB at 48 -> 48, neither
//    fits: the block walks the 16 (a, b) pairs; while its warps multiply the
//    4 points of one pair they build V of the next pair (29 KB, packed bf16
//    adds on the staged tile) and cp.async brings that pair's u slice (21
//    KB), both double buffered, one barrier per pair;
//  - 12 warps, each 16 tiles x 16 output channels: per point and 16 input
//    channels one ldmatrix.x4 of V, one of u and two mma.sync m16n8k16. The
//    output transform is folded progressively, as the TPU body does: over c
//    into 2 sums, over b into 4, over a into the 8 outputs, so a thread
//    keeps 120 fp32 sums and the 64 M tiles are never all live;
//  - more input channels than 48 are further chunks added into the same
//    outputs, more output channels further blocks (grid z).
//
// What bounds it on the card: the function's bound is bytes (x read once, y
// written once); the kernel is bound by shared-memory bandwidth (512 bytes of
// ldmatrix per mma, and the V build reads each staged value 4 times per (a,
// b) pair) and by one block of 12 warps per SM. wgmma with V in registers
// and a deeper pipeline are the next steps.

#include "conv_tile.cuh"

// The card's machine has no kernel profiler, so the kernel's parts can be
// compiled out to time the rest (chip_smoke.py --phases k9_parts; the result
// is then wrong): bit 1 the V build, 2 ldmatrix + mma (and with them the
// folds, which become sums of zeros), 4 the u copies, 8 the staging of x.
// Undefined in every other build.
#ifndef MEDSEG_K9_SKIP
#define MEDSEG_K9_SKIP 0
#endif

namespace medseg {
namespace {

using namespace convtile;

constexpr int kTiles = kVox / 8;   // 64 Winograd tiles: 2 x 4 x 8
constexpr int kVsElems = 4 * kTiles * kRow;       // V of one (a, b) pair
constexpr int kUsElems = 4 * kCoB * kRow;         // u of one (a, b) pair
constexpr size_t kSmemBytes =
    kXsBytes + sizeof(__nv_bfloat16) * 2 * (kVsElems + kUsElems);

// Row r of B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] as
// first + sign * second.
__device__ __forceinline__ void bt_row(int r, int* first, int* second,
                                       float* sign) {
  *first = r == 0 ? 0 : (r == 2 ? 2 : 1);
  *second = r == 0 ? 2 : (r == 1 ? 2 : (r == 2 ? 1 : 3));
  *sign = r == 1 ? 1.f : -1.f;
}

// Entry r of the rows of A^T = [[1,1,1,0],[0,1,-1,-1]].
__device__ __forceinline__ float at0(int r) { return r < 3 ? 1.f : 0.f; }
__device__ __forceinline__ float at1(int r) {
  return r == 0 ? 0.f : (r == 1 ? 1.f : -1.f);
}

__device__ __forceinline__ __nv_bfloat162 ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}

// vs[(c * kTiles + t) * kRow + ci] = V[a, b, c] of tile t = (td * 4 + th) * 8
// + tw for the staged channels; a thread takes a pair of channels of a tile
// and adds in packed bf16, which rounds once per stage as the TPU body does.
__device__ __forceinline__ void build_v(__nv_bfloat16* vs,
                                        const __nv_bfloat16* xs, int a, int b,
                                        int ckp) {
  int i[2], j[2];
  float sa, sb;
  bt_row(a, &i[0], &i[1], &sa);
  bt_row(b, &j[0], &j[1], &sb);
  const __nv_bfloat162 sa2 = __float2bfloat162_rn(sa),
                       sb2 = __float2bfloat162_rn(sb);
  const int npair = ckp >> 1;
  for (int e = threadIdx.x; e < kTiles * npair; e += blockDim.x) {
    const int t = e / npair, pr = e - t * npair;
    const int tw = t & 7, th = (t >> 3) & 3, td = t >> 5;
    const __nv_bfloat16* base =
        xs + ((2 * td * kHH + 2 * th) * kHW + 2 * tw) * kRow + 2 * pr;
    __nv_bfloat162 h[2][4];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      __nv_bfloat162 wv[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const __nv_bfloat16* row = base + ((i[ii] * kHH + j[jj]) * kHW) * kRow;
        const __nv_bfloat162 x0 = ld2(row), x1 = ld2(row + kRow),
                             x2 = ld2(row + 2 * kRow), x3 = ld2(row + 3 * kRow);
        wv[jj][0] = __hsub2(x0, x2);
        wv[jj][1] = __hadd2(x1, x2);
        wv[jj][2] = __hsub2(x2, x1);
        wv[jj][3] = __hsub2(x1, x3);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) h[ii][c] = __hfma2(sb2, wv[1][c], wv[0][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<__nv_bfloat162*>(vs + (c * kTiles + t) * kRow +
                                         2 * pr) =
          __hfma2(sa2, h[1][c], h[0][c]);
  }
}

// grid (tiles of the volume, B, ceil(Co / kCoB)).
__global__ void __launch_bounds__(kConvThreads, 1)
    winograd_f23_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ u,
                        const float* __restrict__ ep,
                        __nv_bfloat16* __restrict__ y, int D, int H, int W,
                        int C, int Co, int CP, int CoP, int lrelu, float slope,
                        int nht, int nwt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = xs + kHalo * kRow;
  __nv_bfloat16* us = vs + 2 * kVsElems;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp / 3, ns = warp % 3;  // 16 tiles x 16 output channels
  int d0, h0, w0;
  tile_origin(nht, nwt, &d0, &h0, &w0);
  const int b = blockIdx.y, co0 = blockIdx.z * kCoB;
  const long long vox = (long long)D * H * W;
  const __nv_bfloat16* xb = x + b * vox * C;
  const float* epb = ep == nullptr ? nullptr : ep + (long long)b * 2 * C;

  // this lane's row and column in the four 8 x 8 matrices of an ldmatrix:
  // A (tile x ci): (tiles 0-7 | 8-15) x (ci 0-7 | 8-15);
  // B (co x ci):   (ci 0-7 | 8-15) x (co 0-7 | 8-15)
  const int lj = lane >> 3, lr = lane & 7;
  const int a_off = (mt * 16 + lr + ((lj & 1) << 3)) * kRow + ((lj >> 1) << 3);
  const int b_off = (ns * 16 + lr + ((lj >> 1) << 3)) * kRow + ((lj & 1) << 3);

  float yacc[2][2][2][8];
#pragma unroll
  for (int iu = 0; iu < 2; ++iu)
#pragma unroll
    for (int iv = 0; iv < 2; ++iv)
#pragma unroll
      for (int iw = 0; iw < 2; ++iw)
#pragma unroll
        for (int r = 0; r < 8; ++r) yacc[iu][iv][iw][r] = 0.f;

  float q[2][2][8];
#pragma unroll
  for (int iv = 0; iv < 2; ++iv)
#pragma unroll
    for (int iw = 0; iw < 2; ++iw)
#pragma unroll
      for (int r = 0; r < 8; ++r) q[iv][iw][r] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCK) {
    const int ckp = (min(kCK, C - c0) + 15) & ~15;
    const int ksteps = ckp >> 4;
    __syncthreads();  // the previous chunk's readers are done
    if (!(MEDSEG_K9_SKIP & 8))
      stage_input(xs, xb, epb, lrelu, slope, D, H, W, C, d0, h0, w0, c0, ckp,
                  (C & 7) == 0);
    stage_weights_async(us, u, 0, 4, CoP, CP, co0, c0, ckp);
    __syncthreads();
    if (!(MEDSEG_K9_SKIP & 1)) build_v(vs, xs, 0, 0, ckp);

#pragma unroll 1
    for (int ab = 0; ab < 16; ++ab) {
      const int a = ab >> 2, bb = ab & 3;
      cp_async_wait_all();
      // V and u of this pair are in place, and every warp is done with the
      // pair before, whose buffers the next pair's take
      __syncthreads();
      if (ab + 1 < 16) {
        if (!(MEDSEG_K9_SKIP & 4))
          stage_weights_async(us + ((ab + 1) & 1) * kUsElems, u, (ab + 1) * 4,
                              4, CoP, CP, co0, c0, ckp);
        if (!(MEDSEG_K9_SKIP & 1))
          build_v(vs + ((ab + 1) & 1) * kVsElems, xs, (ab + 1) >> 2,
                  (ab + 1) & 3, ckp);
      }
      const __nv_bfloat16* vb = vs + (ab & 1) * kVsElems + a_off;
      const __nv_bfloat16* ub = us + (ab & 1) * kUsElems + b_off;

      float p0[8], p1[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float m[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) m[r] = 0.f;
        for (int ks = 0; ks < ((MEDSEG_K9_SKIP & 2) ? 0 : ksteps); ++ks) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, vb + c * kTiles * kRow + ks * 16);
          ldmatrix_x4(bf, ub + c * kCoB * kRow + ks * 16);
          mma_bf16(m, af, bf[0], bf[1]);
          mma_bf16(m + 4, af, bf[2], bf[3]);
        }
        // over c: N0 = M0 + M1 + M2, N1 = M1 - M2 - M3
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          if (c == 0) {
            p0[r] = m[r];
          } else if (c == 1) {
            p0[r] += m[r];
            p1[r] = m[r];
          } else if (c == 2) {
            p0[r] += m[r];
            p1[r] -= m[r];
          } else {
            p1[r] -= m[r];
          }
        }
      }
      // over b into q (fresh at b = 0), then at b = 3 over a into the outputs
      const float b0 = at0(bb), b1 = at1(bb);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        q[0][0][r] = (bb == 0 ? 0.f : q[0][0][r]) + b0 * p0[r];
        q[0][1][r] = (bb == 0 ? 0.f : q[0][1][r]) + b0 * p1[r];
        q[1][0][r] = (bb == 0 ? 0.f : q[1][0][r]) + b1 * p0[r];
        q[1][1][r] = (bb == 0 ? 0.f : q[1][1][r]) + b1 * p1[r];
      }
      if (bb == 3) {
        const float a0 = at0(a), a1 = at1(a);
#pragma unroll
        for (int iv = 0; iv < 2; ++iv)
#pragma unroll
          for (int iw = 0; iw < 2; ++iw)
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              yacc[0][iv][iw][r] += a0 * q[iv][iw][r];
              yacc[1][iv][iw][r] += a1 * q[iv][iw][r];
            }
      }
    }
  }

  // accumulator fragment: tiles (rows) g and g + 8, columns 2t and 2t + 1 of
  // either 8-column half; tile row r of this warp is tw = r % 8, th = 2 (mt
  // % 2) + r / 8, td = mt / 2. Output voxel (2 td + iu, 2 th + iv, 2 tw + iw).
  __syncthreads();  // every warp is done with the input tile
  __nv_bfloat16* os = xs;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int iu = 0; iu < 2; ++iu)
#pragma unroll
    for (int iv = 0; iv < 2; ++iv)
#pragma unroll
      for (int iw = 0; iw < 2; ++iw)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int od = 2 * (mt >> 1) + iu;
            const int oh = 2 * (2 * (mt & 1) + half) + iv;
            const int ow = 2 * g + iw;
            const float* f = &yacc[iu][iv][iw][nt * 4 + half * 2];
            *reinterpret_cast<__nv_bfloat162*>(
                os + ((od * kTH + oh) * kTW + ow) * kCoB + ns * 16 + nt * 8 +
                t2) = __floats2bfloat162_rn(f[0], f[1]);
          }
  __syncthreads();
  store_output(os, y + b * vox * Co, D, H, W, Co, d0, h0, w0, co0,
               (Co & 7) == 0);
}

}  // namespace
}  // namespace medseg

// x (b, d, h, w, c) bf16; u (64, cop, cp) bf16, zero padded, cp a multiple of
// 16 and cop one of 48; ep (b, 2, c) fp32 or NULL; y (b, d, h, w, co) bf16.
extern "C" int medseg_winograd_f23(const void* x, const void* u,
                                   const void* ep, void* y, int b, int d,
                                   int h, int w, int c, int co, int cp,
                                   int cop, int lrelu, float slope,
                                   void* stream) {
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
      winograd_f23_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  winograd_f23_kernel<<<dim3(ndt * nht * nwt, b, cop / kCoB), kConvThreads,
                        kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(u), static_cast<const float*>(ep),
      static_cast<__nv_bfloat16*>(y), d, h, w, c, co, cp, cop, lrelu, slope,
      nht, nwt);
  return static_cast<int>(cudaGetLastError());
}
