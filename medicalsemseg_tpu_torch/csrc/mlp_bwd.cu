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
// The rounding points are the TPU kernel's. The element type T of x, dy, dx
// and the weights is bf16, fp16 or fp32 (the JAX kernel takes its input's
// dtype): "bf16" above stands for T.
//
// The TPU kernel walks its token tiles in order on one core and keeps every
// weight gradient in scratch memory from the first tile to the last. Here
// blocks run side by side, so each block writes the sums over its own share
// of the tokens to a slab of partials and sum_partials (csrc/reduce.cu) adds
// the slabs in a fixed order: the result does not change from run to run
// (no atomics anywhere). Two routes, picked by the wrapper from the dtype and
// the shape alone (ops/kernels/mlp.py, mlp_bwd_route):
//
// Tensor cores (bf16 and fp16, C and H multiples of 16, C <= 384; mma.sync
// m16n8k16, mlp_tile.cuh), two launches:
//  1. fused_mlp_bwd_w_tc, grid (H / 64 hidden chunks, C / cs channel slices,
//     token shares): a block keeps its chunk's W1 rows and W2 columns in
//     shared memory and walks its share of 64-token tiles. Each warp owns 16
//     hidden units and computes the transposed products h^T = W1c . xn^T and
//     da^T = W2c^T . dy^T (16 units x 16 tokens, A from the weights, B from
//     the staged tiles), Phi, phi, hb and dh in registers; their C fragments
//     rounded to T are the A fragments (units x tokens) of dW1c += dhb^T . xn
//     and dW2c^T += hb^T . dy, so the weight gradients accumulate in mma
//     fragments (16 x cs each) with the tokens as the k dimension. The
//     tensor cores add by truncation (PERF.md, PR 3), so every kFlushTiles
//     tiles the fragments are added, rounding to nearest, into the block's
//     fp32 slab (dW2 transposed, so that each thread's adds are 8-byte
//     pairs). At C > 96 the block owns a slice of cs channels of the
//     weight gradients and computes h and da again per slice. The blocks of
//     slice 0 also write dhb (T, [unit][token]) to a scratch of H x M.
//  2. fused_mlp_bwd_dx_tc: dxn = dhb . W1 over 64-token tiles (C <= 96: a
//     16-row strip a warp; C = 192, 384: the warps split the columns),
//     A = dhb through ldmatrix.trans from the scratch, B = W1 chunks; then
//     the LayerNorm backward on the accumulators (row sums across warps
//     through shared memory), dx [+ dy], and the block's dLN and db2 sums.
// Storing dhb (2 x M x H bytes written and read again) instead of
// recomputing h, da and the GELU derivative a third time is the trade
// ROADMAP R5 names; chip_smoke.py --phases mlp_parts times both sides of it.
//
// CUDA cores (fp32 and any other shape, C <= 768):
//  1. fused_mlp_bwd_dx: a block owns token tiles (32 rows, strided over the
//     grid; 16 rows above C = 384, so that the three fp32 tiles of C values
//     fit a block up to C = 768) and walks the hidden dimension in chunks of
//     as many units as the tile has rows, as the forward does: dxn stays in
//     shared memory for the walk, then the LN backward writes dx. The
//     block's sums for dLN and db2 go to one row of partials. The weight
//     chunks are staged in T, so fp32 takes half the units per chunk where
//     a full chunk would not fit a block (C = 384; C = 768).
//  2. fused_mlp_bwd_dw: a block owns 16 hidden units (the matching 16 rows of
//     dW1 and 16 columns of dW2, held in registers) and walks a strided share
//     of the token tiles, recomputing h and da for its units only. Each
//     (unit group, share) writes one slab of partials.
//  It computes h and da twice (7 products of M.C.4C multiply-adds against
//  the 5 of the TPU kernel), with fp32 FMAs from shared memory.
//
// What bounds it on the card: by its counts the function is bound by bytes
// at C = 48 and by operations from C = 96 on. The tensor-core route is held
// back by the staging of the token tiles (every block of a token share
// stages each tile: half its time at C = 384, where one block fits an SM),
// the flushes, the elementwise work of the GELU and its derivative on
// M x H values, and the dhb scratch (chip_smoke.py --phases mlp_parts,
// PERF.md); the CUDA-core route by shared-memory bandwidth and FMA
// throughput.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mlp_tile.cuh"

namespace medseg {
namespace {

constexpr int kHB = 16;     // hidden units owned by a block of the dw launch
// Token rows a tile: kTile (32) up to C = kNarrowC, 16 above, up to kMaxC
// (stage 4 at --hidden_dim 96), where three 32-row fp32 tiles of C values
// would not fit a block's shared memory.
constexpr int kNarrowC = 384;
constexpr int kMaxC = 768;
constexpr int kWideRows = 16;
// dW1 / dW2 entries a thread of the dw launch holds in registers: its share
// of the block's kHB rows at the widest C of the tile height
template <int kR>
struct DwEntries {
  static constexpr int value = kHB * (kR == kTile ? 512 : kMaxC) / kThreads;
};
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

// LN statistics of the tile's rows, then xs = bf16(xhat * g + b) and
// ds = dy as fp32, both kR x (c + 1); rows past the end are zero (they
// then add nothing to any gradient). Ends with a __syncthreads().
template <class T, int kR>
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
  for (int e = tid; e < kR * c; e += kThreads) {
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
// dhs = dh (fp32), dhbs = bf16(dh), each kR x (nj + 1). Units at or past
// hdim give zeros. The caller synchronises.
template <class T, int kR>
__device__ void hidden_chunk(const float* xs, const float* ds,
                             const T* w1s, const T* w2t, const float* b1, int j0,
                             int hdim, int nj, int c, float* hs, float* dhs,
                             float* dhbs) {
  const int stride = c + 1, hstride = nj + 1;
  for (int e = threadIdx.x; e < nj * kR; e += kThreads) {
    const int j = e / kR, r = e - j * kR;
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

// kHC hidden units per chunk, kR token rows a tile
template <class T, int kHC, int kR>
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
  const int stride = c + 1, hstride = kHC + 1, dstride = kR + 1;
  float* mu = smem;                        // kR
  float* rs = mu + kR;                     // kR
  float* accs = rs + kR;                   // 3c: dscale | dbias | db2
  float* xs = accs + 3 * c;                // kR x (c + 1)
  float* ds = xs + kR * stride;            // kR x (c + 1)
  float* dxn = ds + kR * stride;           // c x (kR + 1)
  float* hs = dxn + c * dstride;           // kR x (kHC + 1)
  float* dhs = hs + kR * hstride;          // kR x (kHC + 1)
  float* dhbs = dhs + kR * hstride;        // kR x (kHC + 1)
  T* w1s = reinterpret_cast<T*>(dhbs + kR * hstride);
  T* w2t = w1s + kHC * c;                  // kHC x c each
  const int tid = threadIdx.x;
  const long long ntiles = (m + kR - 1) / kR;

  for (int e = tid; e < 3 * c; e += kThreads) accs[e] = 0.f;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * kR;
    const int rows = (int)min((long long)kR, m - r0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, kR>(x, dy, ln, r0, rows, c, eps, mu, rs, xs, ds);
    for (int e = tid; e < c * dstride; e += kThreads) dxn[e] = 0.f;
    for (int j0 = 0; j0 < hdim; j0 += kHC) {
      __syncthreads();
      load_units(w1, w2, j0, kHC, hdim, c, w1s, w2t);
      __syncthreads();
      hidden_chunk<T, kR>(xs, ds, w1s, w2t, b1, j0, hdim, kHC, c, hs, dhs,
                          dhbs);
      __syncthreads();
      // dxn[r][ch] += sum_j dhb[r][j] * W1[j0+j][ch]; r along the lanes
      for (int e = tid; e < c * kR; e += kThreads) {
        const int ch = e / kR, r = e - ch * kR;
        const float* dr = dhbs + r * hstride;
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < kHC; ++j)
          a += dr[j] * to_f32(w1s[j * c + ch]);
        dxn[ch * dstride + r] += a;
      }
    }
    __syncthreads();
    ln_backward_tile<T, kR>(x, dy, ln, mu, rs, dxn, r0, rows, c, residual, dx,
                            accs);
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
// (c x hdim) | db1 (hdim). kR token rows a tile.
template <class T, int kR>
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
  float* mu = smem;                     // kR
  float* rs = mu + kR;                  // kR
  float* xs = rs + kR;                  // kR x (c + 1)
  float* ds = xs + kR * stride;         // kR x (c + 1)
  float* hs = ds + kR * stride;         // kR x (kHB + 1)
  float* dhs = hs + kR * hstride;
  float* dhbs = dhs + kR * hstride;
  T* w1s = reinterpret_cast<T*>(dhbs + kR * hstride);
  T* w2t = w1s + kHB * c;               // kHB x c each
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kHB;
  const long long ntiles = (m + kR - 1) / kR;
  const int ne = kHB * c;

  constexpr int kMaxE = DwEntries<kR>::value;
  float acc1[kMaxE], acc2[kMaxE];
#pragma unroll
  for (int i = 0; i < kMaxE; ++i) acc1[i] = acc2[i] = 0.f;
  float accb = 0.f;

  load_units(w1, w2, j0, kHB, hdim, c, w1s, w2t);
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long r0 = tile * kR;
    const int rows = (int)min((long long)kR, m - r0);
    __syncthreads();
    load_tile<T, kR>(x, dy, ln, r0, rows, c, eps, mu, rs, xs, ds);
    hidden_chunk<T, kR>(xs, ds, w1s, w2t, b1, j0, hdim, kHB, c, hs, dhs, dhbs);
    __syncthreads();
    outer_accumulate<kMaxE, kR>(dhbs, hstride, xs, stride, c, ne, acc1);
    outer_accumulate<kMaxE, kR>(hs, hstride, ds, stride, c, ne, acc2);
    if (tid < kHB) {
      float a = 0.f;
      for (int r = 0; r < kR; ++r) a += dhs[r * hstride + tid];
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

template <class T, int kR>
size_t dx_smem_bytes(int c, int hc) {
  return sizeof(float) * (2 * kR + 3 * c + 2 * kR * (c + 1) + c * (kR + 1) +
                          3 * kR * (hc + 1)) +
         sizeof(T) * 2 * hc * c;
}

template <class T, int kHC, int kR>
cudaError_t launch_dx(const T* x, const float* ln, const T* w1,
                      const float* b1, const T* w2, const T* dy, T* dx,
                      float* part, int m, int c, int hdim, int grid_a,
                      int residual, float eps, cudaStream_t st) {
  const size_t smem = dx_smem_bytes<T, kR>(c, kHC);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_dx<T, kHC, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fused_mlp_bwd_dx<T, kHC, kR><<<grid_a, kThreads, smem, st>>>(
      x, ln, w1, b1, w2, dy, dx, part, (long long)m, c, hdim, residual, eps);
  return cudaGetLastError();
}

// Both CUDA-core launches at kR token rows a tile: the dx launch with
// hidden chunks of kR units where they fit a block, else of kR / 2.
template <class T, int kR>
cudaError_t launch_dx_dw(const T* xb, const float* lnf, const T* w1b,
                         const float* b1f, const T* w2b, const T* dyb, T* dx,
                         void* part_a, void* part_w, int m, int c, int hdim,
                         int grid_a, int nsplit, int residual, float ln_eps,
                         cudaStream_t st) {
  float* pa = static_cast<float*>(part_a);
  cudaError_t err =
      dx_smem_bytes<T, kR>(c, kR) <= (size_t)mlptile::kMaxSmem
          ? launch_dx<T, kR, kR>(xb, lnf, w1b, b1f, w2b, dyb, dx, pa, m, c,
                                 hdim, grid_a, residual, ln_eps, st)
          : launch_dx<T, kR / 2, kR>(xb, lnf, w1b, b1f, w2b, dyb, dx, pa, m,
                                     c, hdim, grid_a, residual, ln_eps, st);
  if (err != cudaSuccess) return err;

  const size_t smem_w =
      sizeof(float) * (2 * kR + 2 * kR * (c + 1) + 3 * kR * (kHB + 1)) +
      sizeof(T) * 2 * kHB * c;
  err = cudaFuncSetAttribute(fused_mlp_bwd_dw<T, kR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_w);
  if (err != cudaSuccess) return err;
  fused_mlp_bwd_dw<T, kR><<<dim3((hdim + kHB - 1) / kHB, nsplit), kThreads,
                            smem_w, st>>>(xb, lnf, w1b, b1f, w2b, dyb,
                                          static_cast<float*>(part_w),
                                          (long long)m, c, hdim, ln_eps);
  return cudaGetLastError();
}

template <class T>
int launch_bwd(const T* xb, const float* lnf, const T* w1b, const float* b1f,
               const T* w2b, const T* dyb, T* dx, void* part_a, void* out_a,
               void* part_w, void* out_w, int m, int c, int hdim, int grid_a,
               int nsplit, int residual, float ln_eps, cudaStream_t st) {
  cudaError_t err =
      c <= kNarrowC
          ? launch_dx_dw<T, kTile>(xb, lnf, w1b, b1f, w2b, dyb, dx, part_a,
                                   part_w, m, c, hdim, grid_a, nsplit,
                                   residual, ln_eps, st)
          : launch_dx_dw<T, kWideRows>(xb, lnf, w1b, b1f, w2b, dyb, dx,
                                       part_a, part_w, m, c, hdim, grid_a,
                                       nsplit, residual, ln_eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = sum_partials(static_cast<const float*>(part_a),
                     static_cast<float*>(out_a), grid_a, 3 * (long long)c, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sum_partials(static_cast<const float*>(part_w),
                     static_cast<float*>(out_w), nsplit,
                     2 * (long long)hdim * c + hdim, st);
  return static_cast<int>(err);
}


// ---- tensor-core route

template <class T>
struct MlpBwdTcParams {
  const T* x;
  const float* ln;
  const T* w1;
  const float* b1;
  const T* w2;
  const T* dy;
  T* dx;
  T* dhb;         // (H, mp): T(dh) [unit][token]
  float* part_a;  // (blocks of the dx launch, 3C): dscale | dbias | db2
  float* part_w;  // (shares, 2HC + H): dW1 | dW2^T | db1
  long long m, mp;
  int c, hdim, cs, residual, parts;
  float eps;
};

// token tiles between two flushes: 2048 tokens, 128 k-steps of the dW
// products
constexpr int kFlushTiles = 32;

// grid (hidden chunks, channel slices, token shares); see the header.
template <class T, int kMaxS>
__global__ void __launch_bounds__(mlptile::kMlpThreads, kMaxS > 48 ? 2 : 3)
    fused_mlp_bwd_w_tc(MlpBwdTcParams<T> p) {
  using namespace mmatile;
  using namespace mlptile;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int c = p.c, xsd = c + 8, hdim = p.hdim, cs = p.cs;
  float* mu = reinterpret_cast<float*>(smem_tc);  // kMlpRows
  float* rs = mu + kMlpRows;                      // kMlpRows
  T* w1s = reinterpret_cast<T*>(rs + kMlpRows);   // kChunk x xsd: W1 rows
  T* w2s = w1s + kChunk * xsd;                    // c x kW2Stride: W2 columns
  T* xs = w2s + c * kW2Stride;                    // kMlpRows x xsd: T(LN(x))
  T* ds = xs + kMlpRows * xsd;                    // kMlpRows x xsd: dy
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int j0 = blockIdx.x * kChunk, units = min(kChunk, hdim - j0);
  const int c0 = blockIdx.y * cs;
  const bool live = 16 * warp < units;  // the warp's 16 units exist
  const int u0 = j0 + 16 * warp + g, u1 = u0 + 8;
  const long long ntiles = (p.m + kMlpRows - 1) / kMlpRows;
  float* slab = p.part_w + (size_t)blockIdx.z * (2 * (size_t)hdim * c + hdim);
  if (MEDSEG_MLP_SKIP & 5) {  // what a skipped load leaves is zero
    zero_smem(smem_tc, sizeof(float) * 2 * kMlpRows +
                           sizeof(T) * (kChunk * xsd + c * kW2Stride +
                                        2 * kMlpRows * xsd));
    __syncthreads();
  }

  if (!(MEDSEG_MLP_SKIP & 4)) {
    copy_rows_async(p.w1 + (size_t)j0 * c, c, units, c, w1s, xsd);
    copy_rows_async(p.w2 + j0, hdim, c, units, w2s, kW2Stride);
    cp_async_commit();
    cp_async_wait<0>();  // published by the first tile's barriers
  }
  const float bu0 = live ? p.b1[u0] : 0.f, bu1 = live ? p.b1[u1] : 0.f;
  float dw1[kMaxS / 8][4], dw2[kMaxS / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxS / 8; ++j) {
    zero(dw1[j]);
    zero(dw2[j]);
  }
  float db0 = 0.f, db1 = 0.f;
  bool flushed = false;
  // add the fragments (rounding to nearest) into the slab, an n-tile at a
  // time with its four loads in flight together, then zero them; the first
  // flush stores. dW2 lies in the slab transposed ([unit][channel], as dW1),
  // so every access is an 8-byte pair; the wrapper transposes the sum.
  auto flush = [&]() {
    if (!live || (MEDSEG_MLP_SKIP & 8)) return;
    float* w2p = slab + (size_t)hdim * c;
#pragma unroll
    for (int j = 0; j < kMaxS / 8; ++j) {
      if (8 * j < cs) {
        const int ch = c0 + 8 * j + 2 * t4;
        float2* at[4] = {reinterpret_cast<float2*>(slab + (size_t)u0 * c + ch),
                         reinterpret_cast<float2*>(slab + (size_t)u1 * c + ch),
                         reinterpret_cast<float2*>(w2p + (size_t)u0 * c + ch),
                         reinterpret_cast<float2*>(w2p + (size_t)u1 * c + ch)};
        const float add[4][2] = {{dw1[j][0], dw1[j][1]}, {dw1[j][2], dw1[j][3]},
                                 {dw2[j][0], dw2[j][1]}, {dw2[j][2], dw2[j][3]}};
        float2 old[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          old[i] = flushed ? *at[i] : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *at[i] = make_float2(old[i].x + add[i][0], old[i].y + add[i][1]);
        zero(dw1[j]);
        zero(dw2[j]);
      }
    }
    flushed = true;
  };

  // operand rows: A of h^T (W1 rows of the warp's units), A of da^T (W2
  // columns of the units, through ldmatrix.trans), B of both from the token
  // tiles (non-transposed), B of the dW products (transposed)
  const T* a_w1 = w1s + (16 * warp + (lane & 15)) * xsd + (lane >> 4) * 8;
  const T* a_w2 = w2s + ((lane & 7) + ((lane >> 4) << 3)) * kW2Stride +
                  16 * warp + ((lane >> 3) & 1) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * xsd +
                    ((lane >> 3) & 1) * 8;
  const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * xsd + c0 +
                    (lane >> 4) * 8;
  int pending = 0;
  for (long long tile = blockIdx.z; tile < ntiles; tile += gridDim.z) {
    const long long r0 = tile * kMlpRows;
    const int rows = (int)min((long long)kMlpRows, p.m - r0);
    stage_tiles(p.x + r0 * c, p.dy + r0 * c, rows, c, p.ln, p.eps, mu, rs, xs,
                ds);
    for (int s = 0; s < kMlpRows / 16 && live; ++s) {
      if (16 * s >= rows) break;
      float ht[2][4], dt[2][4];
      zero(ht[0]);
      zero(ht[1]);
      zero(dt[0]);
      zero(dt[1]);
      const T* bx = xs + 16 * s * xsd + b_off;
      const T* bd = ds + 16 * s * xsd + b_off;
      for (int ks = 0; ks < c / 16; ++ks) {  // the loads in flight together
        uint32_t a[4], b[4], a2[4], b2[4];
        ldsm_x4(a, a_w1 + 16 * ks);
        ldsm_x4(b, bx + 16 * ks);
        ldsm_x4_t(a2, a_w2 + 16 * ks * kW2Stride);
        ldsm_x4(b2, bd + 16 * ks);
        mma<T>(ht[0], a, b[0], b[1]);
        mma<T>(ht[1], a, b[2], b[3]);
        mma<T>(dt[0], a2, b2[0], b2[1]);
        mma<T>(dt[1], a2, b2[2], b2[3]);
      }
      // rows: units u0 (e < 2), u1; columns: tokens
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = ht[n][e] + (e < 2 ? bu0 : bu1);
          float hb = h, dh = dt[n][e];
          if (!(MEDSEG_MLP_SKIP & 2)) {
            float phi;
            const float cdf = gelu_parts(h, &phi);
            hb = h * cdf;
            dh = dt[n][e] * (cdf + h * phi);
          }
          ht[n][e] = hb;
          dt[n][e] = dh;
          if (e < 2) db0 += dh;
          else db1 += dh;
        }
      }
      uint32_t ah[4], ad[4];
      c_to_a<T>(ah, ht[0], ht[1]);  // T(hb): units x tokens
      c_to_a<T>(ad, dt[0], dt[1]);  // T(dh)
      if (blockIdx.y == 0 && !(MEDSEG_MLP_SKIP & 16)) {
        T* d0 = p.dhb + (size_t)u0 * p.mp + r0 + 16 * s + 2 * t4;
        T* d1 = p.dhb + (size_t)u1 * p.mp + r0 + 16 * s + 2 * t4;
        *reinterpret_cast<uint32_t*>(d0) = ad[0];
        *reinterpret_cast<uint32_t*>(d1) = ad[1];
        *reinterpret_cast<uint32_t*>(d0 + 8) = ad[2];
        *reinterpret_cast<uint32_t*>(d1 + 8) = ad[3];
      }
      const T* tx = xs + 16 * s * xsd + t_off;
      const T* td = ds + 16 * s * xsd + t_off;
#pragma unroll
      for (int q0 = 0; q0 < kMaxS / 16; q0 += 2) {  // two pairs in flight
        uint32_t b[2][4], e[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (q0 + u < kMaxS / 16 && 16 * (q0 + u) < cs) {
            ldsm_x4_t(b[u], tx + 16 * (q0 + u));
            ldsm_x4_t(e[u], td + 16 * (q0 + u));
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (q0 + u < kMaxS / 16 && 16 * (q0 + u) < cs) {
            const int q = q0 + u;
            mma<T>(dw1[2 * q], ad, b[u][0], b[u][1]);
            mma<T>(dw1[2 * q + 1], ad, b[u][2], b[u][3]);
            mma<T>(dw2[2 * q], ah, e[u][0], e[u][1]);
            mma<T>(dw2[2 * q + 1], ah, e[u][2], e[u][3]);
          }
        }
      }
    }
    if (++pending == kFlushTiles) {
      flush();
      pending = 0;
    }
  }
  flush();  // the rest; a block with no tile stores zeros
  if (blockIdx.y == 0 && live && !(MEDSEG_MLP_SKIP & 8)) {
    db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
    db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
    db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
    db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
    if (t4 == 0) {
      slab[2 * (size_t)hdim * c + u0] = db0;
      slab[2 * (size_t)hdim * c + u1] = db1;
    }
  }
}

// grid: blocks strided over the token tiles (kMlpRows / parts rows each);
// see the header. Shared memory: mu, rs; the row sums of the LayerNorm
// backward a warp; the block's dLN and db2 sums a strip; the chunk slots.
template <class T, int kMaxP>
__global__ void __launch_bounds__(mlptile::kMlpThreads, 3)
    fused_mlp_bwd_dx_tc(MlpBwdTcParams<T> p, int nslots) {
  using namespace mmatile;
  using namespace mlptile;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int c = p.c, xsd = c + 8, parts = p.parts;
  const int strips = kMlpWarps / parts, rows_t = 16 * strips, cp = c / parts;
  const int dsd = rows_t + 8;  // stride of a dhb chunk [unit][token]
  float* mu = reinterpret_cast<float*>(smem_tc);  // kMlpRows
  float* rs = mu + kMlpRows;                      // kMlpRows
  float* red = rs + kMlpRows;                     // kMlpWarps x 16 x 2
  float* accs = red + kMlpWarps * 32;             // strips x 3c
  T* wbuf = reinterpret_cast<T*>(accs + strips * 3 * c);
  const int slot = kChunk * xsd + kChunk * dsd;   // [W1c | dhb chunk]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int sw = warp % strips, q = warp / strips, col0 = q * cp;
  const long long ntiles = (p.m + rows_t - 1) / rows_t;
  const int nch = (p.hdim + kChunk - 1) / kChunk;
  const float* ls = p.ln;

  if (MEDSEG_MLP_SKIP & 5)  // what a skipped load leaves is zero
    zero_smem(smem_tc, (char*)(wbuf + nslots * slot) - (char*)smem_tc);
  __syncthreads();
  for (int e = threadIdx.x; e < strips * 3 * c; e += kMlpThreads) accs[e] = 0.f;
  auto stage_chunk = [&](int k, long long r0, int s) {
    T* w1s = wbuf + s * slot;
    const int j0 = k * kChunk, units = min(kChunk, p.hdim - j0);
    if (!(MEDSEG_MLP_SKIP & 4))
      copy_rows_async(p.w1 + (size_t)j0 * c, c, units, c, w1s, xsd);
    if (!(MEDSEG_MLP_SKIP & 1))
      copy_rows_async(p.dhb + (size_t)j0 * p.mp + r0, p.mp, units, rows_t,
                      w1s + kChunk * xsd, dsd);
  };
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * rows_t;
    const int rows = (int)min((long long)rows_t, p.m - r0);
    __syncthreads();  // the previous tile's readers of the slots, mu, red
    stage_chunk(0, r0, 0);
    cp_async_commit();
    if (!(MEDSEG_MLP_SKIP & 1)) window_stats(p.x + r0 * c, rows, c, p.eps, mu, rs);
    float acc[kMaxP / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) zero(acc[j]);
    for (int k = 0; k < nch; ++k) {
      if (nslots > 1 && k + 1 < nch) {
        stage_chunk(k + 1, r0, (k + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* w1s = wbuf + (nslots > 1 ? (k & 1) : 0) * slot;
      const T* dhs = w1s + kChunk * xsd;
      const int np = min(kChunk, p.hdim - k * kChunk) / 16;
      const T* a_row = dhs + ((lane & 7) + ((lane >> 4) << 3)) * dsd + 16 * sw +
                       ((lane >> 3) & 1) * 8;
      const T* b_row = w1s + ((lane & 7) + ((lane >> 3) & 1) * 8) * xsd + col0 +
                       (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < np) {
          uint32_t a[4];
          ldsm_x4_t(a, a_row + 16 * kk * dsd);
#pragma unroll
          for (int o0 = 0; o0 < kMaxP / 16; o0 += 3) {  // three pairs in flight
            uint32_t b[3][4];
#pragma unroll
            for (int u = 0; u < 3; ++u)
              if (o0 + u < kMaxP / 16 && 16 * (o0 + u) < cp)
                ldsm_x4_t(b[u], b_row + 16 * kk * xsd + 16 * (o0 + u));
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              if (o0 + u < kMaxP / 16 && 16 * (o0 + u) < cp) {
                mma<T>(acc[2 * (o0 + u)], a, b[u][0], b[u][1]);
                mma<T>(acc[2 * (o0 + u) + 1], a, b[u][2], b[u][3]);
              }
            }
          }
        }
      }
      __syncthreads();  // the slot's readers are done
      if (nslots == 1 && k + 1 < nch) {
        stage_chunk(k + 1, r0, 0);
        cp_async_commit();
      }
    }

    // LayerNorm backward: the row sums of dxh = dxn * scale and dxh * xhat
    // over the warp's columns, then across the parts through shared memory
    const int lr[2] = {16 * sw + g, 16 * sw + g + 8};
    float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) {
      if (8 * j < cp) {
        const int ch = col0 + 8 * j + 2 * t4;
        const float2 sc = *reinterpret_cast<const float2*>(ls + ch);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (lr[hf] < rows) {
            const T* xr = p.x + (r0 + lr[hf]) * c + ch;
            const float xh0 = (to_f32(xr[0]) - mu[lr[hf]]) * rs[lr[hf]];
            const float xh1 = (to_f32(xr[1]) - mu[lr[hf]]) * rs[lr[hf]];
            const float d0 = acc[j][2 * hf] * sc.x, d1 = acc[j][2 * hf + 1] * sc.y;
            m1[hf] += d0 + d1;
            m2[hf] += d0 * xh0 + d1 * xh1;
          }
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m1[hf] += __shfl_xor_sync(0xffffffffu, m1[hf], 1);
      m1[hf] += __shfl_xor_sync(0xffffffffu, m1[hf], 2);
      m2[hf] += __shfl_xor_sync(0xffffffffu, m2[hf], 1);
      m2[hf] += __shfl_xor_sync(0xffffffffu, m2[hf], 2);
      if (t4 == 0) {
        red[warp * 32 + 2 * (g + 8 * hf)] = m1[hf];
        red[warp * 32 + 2 * (g + 8 * hf) + 1] = m2[hf];
      }
    }
    __syncthreads();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float a = 0.f, b = 0.f;
      for (int qq = 0; qq < parts; ++qq) {  // in order: reruns bit-equal
        a += red[(sw + qq * strips) * 32 + 2 * (g + 8 * hf)];
        b += red[(sw + qq * strips) * 32 + 2 * (g + 8 * hf) + 1];
      }
      m1[hf] = a / c;
      m2[hf] = b / c;
    }
    float* acc_s = accs + sw * 3 * c;
#pragma unroll
    for (int j = 0; j < kMaxP / 8; ++j) {
      if (8 * j < cp) {
        const int ch = col0 + 8 * j + 2 * t4;
        const float2 sc = *reinterpret_cast<const float2*>(ls + ch);
        // column sums over the thread's two rows: dxn * xhat, dxn, dy
        float su[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (lr[hf] < rows) {
            const long long row = r0 + lr[hf];
            const T* xr = p.x + row * c + ch;
            const T* dr = p.dy + row * c + ch;
            const float r = rs[lr[hf]], mm = mu[lr[hf]];
            const float xh0 = (to_f32(xr[0]) - mm) * r;
            const float xh1 = (to_f32(xr[1]) - mm) * r;
            const float n0 = acc[j][2 * hf], n1 = acc[j][2 * hf + 1];
            const float y0 = to_f32(dr[0]), y1 = to_f32(dr[1]);
            float o0 = (n0 * sc.x - m1[hf] - xh0 * m2[hf]) * r;
            float o1 = (n1 * sc.y - m1[hf] - xh1 * m2[hf]) * r;
            if (p.residual) {
              o0 += y0;
              o1 += y1;
            }
            *reinterpret_cast<uint32_t*>(p.dx + row * c + ch) = pack<T>(o0, o1);
            su[0] += n0 * xh0;
            su[1] += n1 * xh1;
            su[2] += n0;
            su[3] += n1;
            su[4] += y0;
            su[5] += y1;
          }
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          su[i] += __shfl_xor_sync(0xffffffffu, su[i], 4);
          su[i] += __shfl_xor_sync(0xffffffffu, su[i], 8);
          su[i] += __shfl_xor_sync(0xffffffffu, su[i], 16);
        }
        if (g == 0) {  // one lane a column pair, in tile order
          acc_s[ch] += su[0];
          acc_s[ch + 1] += su[1];
          acc_s[c + ch] += su[2];
          acc_s[c + ch + 1] += su[3];
          acc_s[2 * c + ch] += su[4];
          acc_s[2 * c + ch + 1] += su[5];
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * c; e += kMlpThreads) {
    float a = 0.f;
    for (int s = 0; s < strips; ++s) a += accs[s * 3 * c + e];
    p.part_a[(size_t)blockIdx.x * 3 * c + e] = a;
  }
}

template <class T, int kMaxS>
cudaError_t launch_w_tc(const MlpBwdTcParams<T>& p, int nshare,
                        cudaStream_t st) {
  using namespace mlptile;
  const int xsd = p.c + 8;
  const size_t smem = sizeof(float) * 2 * kMlpRows +
                      sizeof(T) * (kChunk * xsd + p.c * kW2Stride +
                                   2 * kMlpRows * xsd);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_w_tc<T, kMaxS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.hdim + kChunk - 1) / kChunk, p.c / p.cs, nshare);
  fused_mlp_bwd_w_tc<T, kMaxS><<<grid, kMlpThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <class T, int kMaxP>
cudaError_t launch_dx_tc(const MlpBwdTcParams<T>& p, int blocks,
                         cudaStream_t st) {
  using namespace mlptile;
  const int xsd = p.c + 8, strips = kMlpWarps / p.parts;
  const size_t base = sizeof(float) * (2 * kMlpRows + kMlpWarps * 32 +
                                       strips * 3 * p.c);
  const size_t slot = sizeof(T) * kChunk * (xsd + 16 * strips + 8);
  const int cands[2] = {2, 1};
  int nslots = 0;
  size_t smem = 0;
  cudaError_t err = pick_slots(fused_mlp_bwd_dx_tc<T, kMaxP>, base, slot,
                               cands, 2, &nslots, &smem);
  if (err != cudaSuccess) return err;
  if (nslots == 0) return cudaErrorInvalidValue;
  fused_mlp_bwd_dx_tc<T, kMaxP><<<blocks, kMlpThreads, smem, st>>>(p, nslots);
  return cudaGetLastError();
}

template <class T>
int launch_bwd_tc(const MlpBwdTcParams<T>& p, void* out_a, void* out_w,
                  int grid_a, int nshare, cudaStream_t st) {
  cudaError_t err = p.cs <= 48 ? launch_w_tc<T, 48>(p, nshare, st)
                               : launch_w_tc<T, 96>(p, nshare, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(MEDSEG_MLP_SKIP & 32)) {
    err = p.c / p.parts <= 48 ? launch_dx_tc<T, 48>(p, grid_a, st)
                              : launch_dx_tc<T, 96>(p, grid_a, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = sum_partials(p.part_a, static_cast<float*>(out_a), grid_a,
                     3 * (long long)p.c, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sum_partials(p.part_w, static_cast<float*>(out_w), nshare,
                     2 * (long long)p.hdim * p.c + p.hdim, st);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace medseg

// x, dy, dx (m, c), w1 (hdim, c), w2 (c, hdim) of the element type named by
// dtype; ln (2, c), b1 fp32. part_a (grid_a, 3c) and part_w (nsplit,
// 2*hdim*c + hdim) are scratch; out_a (3c) = dscale | dbias | db2, out_w =
// dW1 | dW2 | db1, dW2 (c, hdim) on the CUDA-core route and transposed,
// (hdim, c), on the tensor-core route. route: kRouteTensorCore (bf16 or fp16; C and H multiples
// of 16, C <= 384, as mlp_bwd_route_takes says) or kRouteCudaCore (any
// dtype, C <= 768). The tensor-core route takes grid_a blocks for its dx
// launch, nsplit token shares and channel slices of `slice` channels (a
// multiple of 16 dividing C, <= 96) for its weight-gradient launch, and dhb,
// a scratch of hdim x (M rounded up to 64) elements; the CUDA-core route
// reads neither slice nor dhb.
extern "C" int medseg_fused_mlp_bwd(const void* x, const void* ln,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* dy, void* dx,
                                    void* dhb, void* part_a, void* out_a,
                                    void* part_w, void* out_w, int m, int c,
                                    int hdim, int grid_a, int nsplit, int slice,
                                    int residual, int route, int dtype,
                                    float ln_eps, void* stream) {
  using namespace medseg;
  if (m < 1 || c < 1 || c > kMaxC || hdim < 1 || grid_a < 1 || nsplit < 1 ||
      ln == nullptr || !mlptile::mlp_bwd_route_takes(route, dtype, c, hdim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteTensorCore) {
    if (slice < 16 || slice % 16 != 0 || c % slice != 0 || slice > 96 ||
        dhb == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    auto run = [&](auto tag) {
      using T = decltype(tag);
      MlpBwdTcParams<T> p;
      p.x = static_cast<const T*>(x);
      p.ln = static_cast<const float*>(ln);
      p.w1 = static_cast<const T*>(w1);
      p.b1 = static_cast<const float*>(b1);
      p.w2 = static_cast<const T*>(w2);
      p.dy = static_cast<const T*>(dy);
      p.dx = static_cast<T*>(dx);
      p.dhb = static_cast<T*>(dhb);
      p.part_a = static_cast<float*>(part_a);
      p.part_w = static_cast<float*>(part_w);
      p.m = m;
      p.mp = ((long long)m + mlptile::kMlpRows - 1) / mlptile::kMlpRows *
             mlptile::kMlpRows;
      p.c = c; p.hdim = hdim; p.cs = slice; p.residual = residual;
      p.parts = mlptile::mlp_dx_parts(c); p.eps = ln_eps;
      return launch_bwd_tc<T>(p, out_a, out_w, grid_a, nsplit, st);
    };
    return dtype == kBf16 ? run(__nv_bfloat16{}) : run(__half{});
  }
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
