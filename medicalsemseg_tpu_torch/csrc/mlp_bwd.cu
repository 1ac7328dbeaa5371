// Fused token MLP, backward (training).
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/mlp.py: _fm_bwd
// (_bwd_kernel). For y = fc2(gelu(fc1(LN(x)))) [+ x] and the gradient dy it
// recomputes, per tile of tokens, the LayerNorm (fast variance), h = xn.W1^T
// + b1, Phi(h) (the erf polynomial of the forward) and hb = bf16(h * Phi),
// and produces
//   dW2 = dy^T . hb, db2 = sum dy, da = dy . W2,
//   dh = da * (Phi + h * phi(h)) in fp32, dhb = bf16(dh),
//   dW1 = dhb^T . xn, db1 = sum dh, dxn = dhb . W1,
//   dx = LN backward of dxn [+ dy], dLN = (sum dxn * xhat, sum dxn).
// The (M, 4C) hidden activations and their gradient never reach device
// memory. The rounding points are the TPU kernel's. The element type T of x,
// dy, dx and the weights is bf16, fp16 or fp32 (the JAX kernel takes its
// input's dtype): "bf16" above stands for T. The weight chunks are staged in
// T, so fp32 takes 16 hidden units per chunk of the dx launch where 32 would
// not fit a block (C = 384).
//
// Design. The TPU kernel walks its token tiles in order on one core and keeps
// every weight gradient in scratch memory from the first tile to the last.
// Here blocks run side by side, so the work is cut twice:
//  1. fused_mlp_bwd_dx: a block owns token tiles (32 rows, strided over the
//     grid) and walks the hidden dimension in chunks of 32, as the forward
//     does: dxn stays in shared memory for the walk, then the LN backward
//     writes dx. The block's sums for dLN and db2 go to one row of partials.
//  2. fused_mlp_bwd_dw: a block owns 16 hidden units (the matching 16 rows of
//     dW1 and 16 columns of dW2, held in registers) and walks a strided share
//     of the token tiles, recomputing h and da for its units only. Each
//     (unit group, share) writes one slab of partials.
//  3. sum_partials adds the slabs in a fixed order, so the result does not
//     change from run to run (no atomics anywhere).
// The price is that h and da are computed twice (7 products of M.C.4C
// multiply-adds against the 5 of the TPU kernel).
//
// What bounds it on the card: as in the forward, the products run on CUDA
// cores in fp32 with operands from shared memory: shared-memory bandwidth and
// FMA throughput, not device memory (x and dy are read once per launch 1 and
// once per unit group in launch 2, the latter from L2). Tensor cores are the
// next step and are left to a later change.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int kHB = 16;     // hidden units owned by a block of the dw launch
constexpr int kMaxC = 512;  // widest C the dw launch holds in registers
constexpr int kMaxE = kHB * kMaxC / kThreads;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// LN statistics of the tile's rows, then xs = bf16(xhat * g + b) and
// ds = dy as fp32, both kTile x (c + 1); rows past the end are zero (they
// then add nothing to any gradient). Ends with a __syncthreads().
template <class T>
__device__ void load_tile(const T* x, const T* dy,
                          const float* ln, long long r0, int rows, int c,
                          float eps, float* mu, float* rs, float* xs,
                          float* ds) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stride = c + 1;
  for (int r = warp; r < rows; r += kWarps) {
    float m, v;
    row_stats(x + (r0 + r) * c, c, eps, &m, &v);
    if (lane == 0) {
      mu[r] = m;
      rs[r] = v;
    }
  }
  __syncthreads();
  for (int e = tid; e < kTile * c; e += kThreads) {
    const int r = e / c, ch = e - r * c;
    float xv = 0.f, dv = 0.f;
    if (r < rows) {
      const float xh = (ld(x + (r0 + r) * c + ch) - mu[r]) * rs[r];
      xv = round_to<T>(xh * ln[ch] + ln[c + ch]);
      dv = ld(dy + (r0 + r) * c + ch);
    }
    xs[r * stride + ch] = xv;
    ds[r * stride + ch] = dv;
  }
  __syncthreads();
}

// For the tile in xs / ds and the nj hidden units whose weights are staged in
// w1s (nj x c: W1 rows) and w2t (nj x c: W2 columns): hs = bf16(h * Phi),
// dhs = dh (fp32), dhbs = bf16(dh), each kTile x (nj + 1). Units at or past
// hdim give zeros. The caller synchronises.
template <class T>
__device__ void hidden_chunk(const float* xs, const float* ds,
                             const T* w1s, const T* w2t, const float* b1, int j0,
                             int hdim, int nj, int c, float* hs, float* dhs,
                             float* dhbs) {
  const int stride = c + 1, hstride = nj + 1;
  for (int e = threadIdx.x; e < nj * kTile; e += kThreads) {
    const int j = e / kTile, r = e - j * kTile;
    float hb = 0.f, dh = 0.f;
    if (j0 + j < hdim) {
      const float* xr = xs + r * stride;
      const float* dr = ds + r * stride;
      const T* w1r = w1s + j * c;
      const T* w2r = w2t + j * c;
      float a = 0.f, da = 0.f;
#pragma unroll 8
      for (int ch = 0; ch < c; ++ch) {
        a += xr[ch] * to_f32(w1r[ch]);
        da += dr[ch] * to_f32(w2r[ch]);
      }
      a += b1[j0 + j];
      const float Phi = gelu_cdf(a);
      const float phi = expf(-0.5f * a * a) * kInvSqrt2Pi;
      hb = round_to<T>(a * Phi);
      dh = da * (Phi + a * phi);
    }
    hs[r * hstride + j] = hb;
    dhs[r * hstride + j] = dh;
    dhbs[r * hstride + j] = round_to<T>(dh);
  }
}

// Stage the weights of hidden units j0 .. j0 + nj: w1s[j][ch] = W1[j0+j][ch],
// w2t[j][ch] = W2[ch][j0+j]. The caller synchronises.
template <class T>
__device__ void load_units(const T* w1, const T* w2, int j0, int nj, int hdim,
                           int c, T* w1s, T* w2t) {
  for (int e = threadIdx.x; e < nj * c; e += kThreads) {
    const int j = e / c, ch = e - j * c;
    const bool in = j0 + j < hdim;
    w1s[e] = in ? w1[(size_t)(j0 + j) * c + ch] : from_f32<T>(0.f);
    w2t[e] = in ? w2[(size_t)ch * hdim + j0 + j] : from_f32<T>(0.f);
  }
}

// kHC hidden units per chunk
template <class T, int kHC>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_dx(const T* __restrict__ x,
                     const float* __restrict__ ln,
                     const T* __restrict__ w1,
                     const float* __restrict__ b1,
                     const T* __restrict__ w2,
                     const T* __restrict__ dy,
                     T* __restrict__ dx, float* __restrict__ part,
                     long long m, int c, int hdim, int residual, float eps) {
  extern __shared__ float smem[];
  const int stride = c + 1, hstride = kHC + 1, dstride = kTile + 1;
  float* mu = smem;                        // kTile
  float* rs = mu + kTile;                  // kTile
  float* accs = rs + kTile;                // 3c: dscale | dbias | db2
  float* xs = accs + 3 * c;                // kTile x (c + 1)
  float* ds = xs + kTile * stride;         // kTile x (c + 1)
  float* dxn = ds + kTile * stride;        // c x (kTile + 1)
  float* hs = dxn + c * dstride;           // kTile x (kHC + 1)
  float* dhs = hs + kTile * hstride;       // kTile x (kHC + 1)
  float* dhbs = dhs + kTile * hstride;     // kTile x (kHC + 1)
  T* w1s = reinterpret_cast<T*>(dhbs + kTile * hstride);
  T* w2t = w1s + kHC * c;                  // kHC x c each
  const int tid = threadIdx.x;
  const long long ntiles = (m + kTile - 1) / kTile;

  for (int e = tid; e < 3 * c; e += kThreads) accs[e] = 0.f;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * kTile;
    const int rows = (int)min((long long)kTile, m - r0);
    __syncthreads();  // the previous tile's readers are done
    load_tile(x, dy, ln, r0, rows, c, eps, mu, rs, xs, ds);
    for (int e = tid; e < c * dstride; e += kThreads) dxn[e] = 0.f;
    for (int j0 = 0; j0 < hdim; j0 += kHC) {
      __syncthreads();
      load_units(w1, w2, j0, kHC, hdim, c, w1s, w2t);
      __syncthreads();
      hidden_chunk(xs, ds, w1s, w2t, b1, j0, hdim, kHC, c, hs, dhs, dhbs);
      __syncthreads();
      // dxn[r][ch] += sum_j dhb[r][j] * W1[j0+j][ch]; r along the lanes
      for (int e = tid; e < c * kTile; e += kThreads) {
        const int ch = e / kTile, r = e - ch * kTile;
        const float* dr = dhbs + r * hstride;
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < kHC; ++j)
          a += dr[j] * to_f32(w1s[j * c + ch]);
        dxn[ch * dstride + r] += a;
      }
    }
    __syncthreads();
    ln_backward_tile(x, dy, ln, mu, rs, dxn, r0, rows, c, residual, dx, accs);
    for (int ch = tid; ch < c; ch += kThreads) {
      float a = 0.f;
      for (int r = 0; r < rows; ++r) a += ds[r * stride + ch];
      accs[2 * c + ch] += a;
    }
  }
  __syncthreads();
  for (int e = tid; e < 3 * c; e += kThreads)
    part[(size_t)blockIdx.x * 3 * c + e] = accs[e];
}

// grid (unit groups, shares). Partials per share: dW1 (hdim x c) | dW2
// (c x hdim) | db1 (hdim).
template <class T>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_bwd_dw(const T* __restrict__ x,
                     const float* __restrict__ ln,
                     const T* __restrict__ w1,
                     const float* __restrict__ b1,
                     const T* __restrict__ w2,
                     const T* __restrict__ dy,
                     float* __restrict__ part, long long m, int c, int hdim,
                     float eps) {
  extern __shared__ float smem[];
  const int stride = c + 1, hstride = kHB + 1;
  float* mu = smem;                     // kTile
  float* rs = mu + kTile;               // kTile
  float* xs = rs + kTile;               // kTile x (c + 1)
  float* ds = xs + kTile * stride;      // kTile x (c + 1)
  float* hs = ds + kTile * stride;      // kTile x (kHB + 1)
  float* dhs = hs + kTile * hstride;
  float* dhbs = dhs + kTile * hstride;
  T* w1s = reinterpret_cast<T*>(dhbs + kTile * hstride);
  T* w2t = w1s + kHB * c;               // kHB x c each
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kHB;
  const long long ntiles = (m + kTile - 1) / kTile;
  const int ne = kHB * c;

  float acc1[kMaxE], acc2[kMaxE];
#pragma unroll
  for (int i = 0; i < kMaxE; ++i) acc1[i] = acc2[i] = 0.f;
  float accb = 0.f;

  load_units(w1, w2, j0, kHB, hdim, c, w1s, w2t);
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long r0 = tile * kTile;
    const int rows = (int)min((long long)kTile, m - r0);
    __syncthreads();
    load_tile(x, dy, ln, r0, rows, c, eps, mu, rs, xs, ds);
    hidden_chunk(xs, ds, w1s, w2t, b1, j0, hdim, kHB, c, hs, dhs, dhbs);
    __syncthreads();
    outer_accumulate<kMaxE>(dhbs, hstride, xs, stride, c, ne, acc1);
    outer_accumulate<kMaxE>(hs, hstride, ds, stride, c, ne, acc2);
    if (tid < kHB) {
      float a = 0.f;
      for (int r = 0; r < kTile; ++r) a += dhs[r * hstride + tid];
      accb += a;
    }
  }

  float* p = part + (size_t)blockIdx.y * (2 * (size_t)hdim * c + hdim);
#pragma unroll
  for (int i = 0; i < kMaxE; ++i) {
    const int e = tid + i * kThreads;
    if (e < ne) {
      const int j = e / c, ch = e - j * c;
      if (j0 + j < hdim) {
        p[(size_t)(j0 + j) * c + ch] = acc1[i];
        p[(size_t)hdim * c + (size_t)ch * hdim + j0 + j] = acc2[i];
      }
    }
  }
  if (tid < kHB && j0 + tid < hdim) p[2 * (size_t)hdim * c + j0 + tid] = accb;
}

template <class T>
size_t dx_smem_bytes(int c, int hc) {
  return sizeof(float) * (2 * kTile + 3 * c + 2 * kTile * (c + 1) +
                          c * (kTile + 1) + 3 * kTile * (hc + 1)) +
         sizeof(T) * 2 * hc * c;
}

template <class T, int kHC>
cudaError_t launch_dx(const T* x, const float* ln, const T* w1,
                      const float* b1, const T* w2, const T* dy, T* dx,
                      float* part, int m, int c, int hdim, int grid_a,
                      int residual, float eps, cudaStream_t st) {
  const size_t smem = dx_smem_bytes<T>(c, kHC);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_dx<T, kHC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_mlp_bwd_dx<T, kHC><<<grid_a, kThreads, smem, st>>>(
      x, ln, w1, b1, w2, dy, dx, part, (long long)m, c, hdim, residual, eps);
  return cudaGetLastError();
}

template <class T>
int launch_bwd(const T* xb, const float* lnf, const T* w1b, const float* b1f,
               const T* w2b, const T* dyb, T* dx, void* part_a, void* out_a,
               void* part_w, void* out_w, int m, int c, int hdim, int grid_a,
               int nsplit, int residual, float ln_eps, cudaStream_t st) {
  cudaError_t err =
      dx_smem_bytes<T>(c, 32) <= 232448
          ? launch_dx<T, 32>(xb, lnf, w1b, b1f, w2b, dyb, dx,
                             static_cast<float*>(part_a), m, c, hdim, grid_a,
                             residual, ln_eps, st)
          : launch_dx<T, 16>(xb, lnf, w1b, b1f, w2b, dyb, dx,
                             static_cast<float*>(part_a), m, c, hdim, grid_a,
                             residual, ln_eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_w =
      sizeof(float) * (2 * kTile + 2 * kTile * (c + 1) +
                       3 * kTile * (kHB + 1)) +
      sizeof(T) * 2 * kHB * c;
  err = cudaFuncSetAttribute(fused_mlp_bwd_dw<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_w);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mlp_bwd_dw<T><<<dim3((hdim + kHB - 1) / kHB, nsplit), kThreads,
                        smem_w, st>>>(xb, lnf, w1b, b1f, w2b, dyb,
                                      static_cast<float*>(part_w),
                                      (long long)m, c, hdim, ln_eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = sum_partials(static_cast<const float*>(part_a),
                     static_cast<float*>(out_a), grid_a, 3 * (long long)c, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sum_partials(static_cast<const float*>(part_w),
                     static_cast<float*>(out_w), nsplit,
                     2 * (long long)hdim * c + hdim, st);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace medseg

// x, dy, dx (m, c), w1 (hdim, c), w2 (c, hdim) of the element type named by
// dtype; ln (2, c), b1 fp32. part_a (grid_a, 3c) and part_w (nsplit,
// 2*hdim*c + hdim) are scratch; out_a (3c) = dscale | dbias | db2, out_w =
// dW1 | dW2 | db1.
extern "C" int medseg_fused_mlp_bwd(const void* x, const void* ln,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* dy, void* dx,
                                    void* part_a, void* out_a, void* part_w,
                                    void* out_w, int m, int c, int hdim,
                                    int grid_a, int nsplit, int residual,
                                    int dtype, float ln_eps, void* stream) {
  using namespace medseg;
  if (m < 1 || c < 1 || c > kMaxC || hdim < 1 || grid_a < 1 || nsplit < 1 ||
      ln == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch_bwd<T>(
        static_cast<const T*>(x), static_cast<const float*>(ln),
        static_cast<const T*>(w1), static_cast<const float*>(b1),
        static_cast<const T*>(w2), static_cast<const T*>(dy),
        static_cast<T*>(dx), part_a, out_a, part_w, out_w, m, c, hdim, grid_a,
        nsplit, residual, ln_eps, static_cast<cudaStream_t>(stream));
  });
}
