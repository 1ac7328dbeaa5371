// Fused token MLP, forward (inference).
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/mlp.py: fused_mlp
// (_kernel). Per token: optional fp32 LayerNorm (fast variance) -> bf16 ->
// fc1 (fp32 accumulation, + b1) -> exact GELU in fp32 -> bf16 -> fc2 (fp32
// accumulation, + b2) -> bf16 -> optional bf16 shortcut add. The rounding
// points are the TPU kernel's. The element type T of the tokens and weights
// is bf16, fp16 or fp32 (the JAX kernel takes its input's dtype): "bf16"
// above stands for T. The (M, H) hidden activations never reach device
// memory, which is what the TPU kernel buys.
//
// Two routes, picked by the wrapper from the dtype and the shape alone
// (ops/kernels/mlp.py, mlp_route):
//  * tensor cores (fused_mlp_tc; bf16 and fp16 with C, Co and H multiples of
//    16, C <= 768): mma.sync m16n8k16 (mlp_tile.cuh). A block of 4 warps
//    takes tiles of 64 tokens, a 16-row strip a warp, stages the raw tile
//    by cp.async (every load in flight at once), takes the LayerNorm's
//    statistics a row a thread from shared memory and writes T(LN(x)) in
//    place, then walks H in chunks of 64 hidden units:
//    fc1 is 16 x 64 accumulators a warp, b1 and the GELU run on them in
//    registers, and the C fragments rounded to T are the A fragments of fc2
//    (c_to_a), so h never passes through shared memory. y accumulates in
//    registers as 16 x cot a warp: a block computes a tile of cot <= 192
//    output columns (C = 384: two column tiles, each computing fc1 again).
//    Weight chunks come by cp.async: all of them once per block where they
//    fit (C = 48: persistent blocks keep W1 and W2 resident), else two
//    chunks in flight or one, whichever keeps more blocks on an SM (C = 96
//    and 384: two; 192: one). Where the token tiles
//    cannot fill the card (the deep stages), blocks split H: each writes
//    fp32 partials of y and mlp_tc_finish adds them in a fixed order with
//    the b2 / round / shortcut epilogue, so reruns stay bit-equal. The GELU
//    is the JAX kernel's Abramowitz-Stegun erf (gelu_cdf, abs err <= 1.5e-7).
//  * CUDA cores (fused_mlp_kernel; fp32 and any other shape): one block per
//    tile of 32 tokens walks H in chunks of 32 with fp32 FMAs from shared
//    memory, erff for the GELU. TF32 would cost the fp32 forms their
//    agreement with the fp32 plain path. Shared memory is ~150 KB at C = 384
//    in bf16; the weight chunks are staged in T, so fp32 takes 16 hidden
//    units per chunk where 32 would not fit a block (C or Co above 384).
//    Where Co's fp32 accumulators and W2 chunk do not fit beside the token
//    tile either (C = Co = 768: ViT-B, the flagship's stage 4 at hidden
//    96), a second grid dimension cuts Co into column tiles, each of which
//    computes fc1 again (mlp_cc_plan); each output's sum keeps its order.
//
// What bounds it on the card: by its counts K2 is bound by bytes at C = 48
// (one read of x and one write of y per token) and by operations from
// C = 96 on. The tensor-core route is ~10x off that bound: at C = 48 the
// GELU's elementwise work on the M x H hidden values is a third of its time
// and the products with their ldmatrix reads, output stores and barriers
// the rest (chip_smoke.py --phases mlp_parts, PERF.md). The CUDA-core route
// is bound by shared-memory bandwidth and FMA issue.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mlp_tile.cuh"

namespace medseg {
namespace {

constexpr int kRows = 32;  // tokens per block (one per lane in the products)

// kHC hidden units per chunk; grid (token tiles, column tiles of cot
// outputs: Co in one tile where it fits, else each tile computes fc1 again)
template <class T, int kHC>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_kernel(const T* __restrict__ x,
                     const float* __restrict__ ln,
                     const T* __restrict__ w1,
                     const float* __restrict__ b1,
                     const T* __restrict__ w2,
                     const float* __restrict__ b2,
                     T* __restrict__ out, long long m, int c,
                     int hdim, int co, int cot, int residual, float eps) {
  extern __shared__ float smem[];
  const int xs_stride = c + 1, hs_stride = kHC + 1, ys_stride = kRows + 1;
  float* mu = smem;                         // kRows
  float* rs = mu + kRows;                   // kRows
  float* xs = rs + kRows;                   // kRows x (c + 1)
  float* hs = xs + kRows * xs_stride;       // kRows x (kHC + 1)
  float* ys = hs + kRows * hs_stride;       // cot x (kRows + 1)
  T* w1s = reinterpret_cast<T*>(ys + cot * ys_stride);  // kHC x c
  T* w2s = w1s + kHC * c;                               // cot x kHC
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, m - r0);
  const int o0 = blockIdx.y * cot, cols = min(cot, co - o0);

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
  for (int e = tid; e < cols * kRows; e += kThreads)
    ys[(e / kRows) * ys_stride + e % kRows] = 0.f;
  __syncthreads();
  for (int e = tid; e < kRows * c; e += kThreads) {
    const int r = e / c, ch = e - r * c;
    float v = 0.f;
    if (r < rows) {
      v = ld(x + (r0 + r) * c + ch);
      if (ln != nullptr)
        v = round_to<T>((v - mu[r]) * (rs[r] * ln[ch]) + ln[c + ch]);
    }
    xs[r * xs_stride + ch] = v;
  }

  for (int j0 = 0; j0 < hdim; j0 += kHC) {
    __syncthreads();  // xs ready / previous chunk's hs, w2s consumed
    for (int e = tid; e < kHC * c; e += kThreads) {
      const int j = e / c, ch = e - j * c;
      w1s[e] = j0 + j < hdim ? w1[(size_t)(j0 + j) * c + ch] : from_f32<T>(0.f);
    }
    for (int e = tid; e < cols * kHC; e += kThreads) {
      const int o = e / kHC, j = e - o * kHC;
      w2s[e] = j0 + j < hdim ? w2[(size_t)(o0 + o) * hdim + j0 + j]
                             : from_f32<T>(0.f);
    }
    __syncthreads();
    // hidden chunk: token index across lanes (conflict-free xs rows with an
    // odd stride), the w1s read is a broadcast
    for (int e = tid; e < kHC * kRows; e += kThreads) {
      const int j = e / kRows, r = e - j * kRows;
      float hv = 0.f;
      if (j0 + j < hdim) {
        const float* xr = xs + r * xs_stride;
        const T* wr = w1s + j * c;
        float a = 0.f;
#pragma unroll 8
        for (int ch = 0; ch < c; ++ch) a += xr[ch] * to_f32(wr[ch]);
        a += b1[j0 + j];
        hv = round_to<T>(a * (0.5f * (1.0f + erff(a * 0.70710678118654752f))));
      }
      hs[r * hs_stride + j] = hv;
    }
    __syncthreads();
    for (int e = tid; e < cols * kRows; e += kThreads) {
      const int o = e / kRows, r = e - o * kRows;
      const float* hr = hs + r * hs_stride;
      const T* wr = w2s + o * kHC;
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kHC; ++j) a += hr[j] * to_f32(wr[j]);
      ys[o * ys_stride + r] += a;
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * cols; e += kThreads) {
    const int r = e / cols, o = e - r * cols;
    float y = round_to<T>(ys[o * ys_stride + r] + b2[o0 + o]);
    if (residual) y += ld(x + (r0 + r) * c + o0 + o);
    out[(r0 + r) * co + o0 + o] = from_f32<T>(y);
  }
}

template <class T>
size_t mlp_smem_bytes(int c, int cot, int hc) {
  return sizeof(float) * (2 * kRows + kRows * (c + 1) + kRows * (hc + 1) +
                          cot * (kRows + 1)) +
         sizeof(T) * (hc * c + cot * hc);
}

// The CUDA-core plan: the fewest column tiles of cot = ceil(Co / tiles)
// outputs, and for them 32 hidden units a chunk, else 16, whose shared
// memory fits a block (one tile up to C = Co = 512; two at 768). False
// where none fits.
template <class T>
bool mlp_cc_plan(int c, int co, int* cot, int* hc) {
  for (int tiles = 1; tiles <= co; ++tiles) {
    const int t = (co + tiles - 1) / tiles;
    for (int h = 32; h >= 16; h /= 2) {
      if (mlp_smem_bytes<T>(c, t, h) <= (size_t)mlptile::kMaxSmem) {
        *cot = t;
        *hc = h;
        return true;
      }
    }
  }
  return false;
}

template <class T, int kHC>
int launch_mlp(const void* x, const void* ln, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int m, int c,
               int hdim, int co, int cot, int residual, float ln_eps,
               cudaStream_t st) {
  const size_t smem = mlp_smem_bytes<T>(c, cot, kHC);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T, kHC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks((unsigned)(((long long)m + kRows - 1) / kRows),
                    (unsigned)((co + cot - 1) / cot));
  fused_mlp_kernel<T, kHC><<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2),
      static_cast<T*>(out), (long long)m, c, hdim, co, cot, residual, ln_eps);
  return static_cast<int>(cudaGetLastError());
}


// ---- tensor-core route

template <class T>
struct MlpTcParams {
  const T* x;
  const float* ln;
  const T* w1;
  const float* b1;
  const T* w2;
  const float* b2;
  T* out;
  float* part;   // (hsplit, m, co) fp32 partials of y when H is split
  long long m;
  int c, hdim, co, cot, residual;
  int chunks;    // hidden chunks a split owns (the last may own fewer)
  int nslots;    // weight chunks staged at a time
  float eps;
};

// One hidden chunk for the warp's strip: y += T(gelu(x^ . W1c^T + b1)) .
// W2c^T, with w1s [unit][channel] (stride c + 8) and w2s [out][unit] (stride
// kW2Stride) the staged chunk of `units` hidden units starting at j0.
template <class T, int kMaxY>
__device__ __forceinline__ void mlp_chunk(float (&y)[kMaxY / 8][4],
                                          const T* xs, const T* w1s,
                                          const T* w2s, const float* b1,
                                          int j0, int units, int c, int cot) {
  using namespace mmatile;
  using mlptile::kW2Stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t4 = lane & 3;
  const int xsd = c + 8, np = units / 16;
  float h[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) zero(h[j]);
  const T* a_row = xs + (16 * warp + (lane & 15)) * xsd + (lane >> 4) * 8;
  const T* b_row = w1s + ((lane & 7) + ((lane >> 4) << 3)) * xsd +
                   ((lane >> 3) & 1) * 8;
  // a k-step's fragments are all loaded before its products, so their
  // loads are in flight together (the asm statements keep their order)
  for (int ks = 0; ks < c / 16; ++ks) {
    uint32_t a[4], b[4][4];
    ldsm_x4(a, a_row + 16 * ks);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < np) ldsm_x4(b[q], b_row + 16 * q * xsd + 16 * ks);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < np) {
        mma<T>(h[2 * q], a, b[q][0], b[q][1]);
        mma<T>(h[2 * q + 1], a, b[q][2], b[q][3]);
      }
    }
  }
  // + b1 and the GELU in fp32 on the accumulators; rounded to T they are
  // the A fragments of fc2
  uint32_t ha[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < np) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(
            b1 + j0 + 16 * q + 8 * u + 2 * t4));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = h[2 * q + u][e] + ((e & 1) ? bb.y : bb.x);
          h[2 * q + u][e] =
              (MEDSEG_MLP_SKIP & 2) ? v : v * mlptile::gelu_parts(v, nullptr);
        }
      }
      c_to_a<T>(ha[q], h[2 * q], h[2 * q + 1]);
    }
  }
  const T* w_row = w2s + ((lane & 7) + ((lane >> 4) << 3)) * kW2Stride +
                   ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < np) {
#pragma unroll
      for (int o0 = 0; o0 < kMaxY / 16; o0 += 4) {  // four pairs in flight
        uint32_t b[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (o0 + u < kMaxY / 16 && 16 * (o0 + u) < cot)
            ldsm_x4(b[u], w_row + 16 * (o0 + u) * kW2Stride + 16 * q);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (o0 + u < kMaxY / 16 && 16 * (o0 + u) < cot) {
            mma<T>(y[2 * (o0 + u)], ha[q], b[u][0], b[u][1]);
            mma<T>(y[2 * (o0 + u) + 1], ha[q], b[u][2], b[u][3]);
          }
        }
      }
    }
  }
}

// grid (token-tile blocks, Co / cot column tiles, hidden splits); persistent
// over the token tiles (see the header).
template <class T, int kMaxY>
__global__ void __launch_bounds__(mlptile::kMlpThreads, kMaxY > 96 ? 2 : 3)
    fused_mlp_tc(MlpTcParams<T> p) {
  using namespace mmatile;
  using namespace mlptile;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int c = p.c, xsd = c + 8, cot = p.cot;
  float* mu = reinterpret_cast<float*>(smem_tc);  // kMlpRows
  float* rs = mu + kMlpRows;                          // kMlpRows
  T* xs = reinterpret_cast<T*>(rs + kMlpRows);        // kMlpRows x xsd
  T* wbuf = xs + kMlpRows * xsd;  // slots of [W1c kChunk x xsd | W2c cot x kW2Stride]
  const int slot = kChunk * xsd + cot * kW2Stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int co0 = blockIdx.y * cot;
  const int nch = (p.hdim + kChunk - 1) / kChunk;
  const int k0 = blockIdx.z * p.chunks, k1 = min(nch, k0 + p.chunks);
  const bool resident = p.nslots >= k1 - k0;
  const long long ntiles = (p.m + kMlpRows - 1) / kMlpRows;

  auto stage_chunk = [&](int k, int s) {
    if (MEDSEG_MLP_SKIP & 4) return;
    T* w1s = wbuf + s * slot;
    const int j0 = k * kChunk, units = min(kChunk, p.hdim - j0);
    copy_rows_async(p.w1 + (size_t)j0 * c, c, units, c, w1s, xsd);
    copy_rows_async(p.w2 + (size_t)co0 * p.hdim + j0, p.hdim, cot, units,
                    w1s + kChunk * xsd, kW2Stride);
  };
  if (MEDSEG_MLP_SKIP & 5) {  // what a skipped load leaves is zero
    zero_smem(smem_tc, sizeof(float) * 2 * kMlpRows +
                           sizeof(T) * (kMlpRows * xsd + p.nslots * slot));
    __syncthreads();
  }
  if (resident) {
    for (int k = k0; k < k1; ++k) stage_chunk(k, k - k0);
    cp_async_commit();
  }

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = tile * kMlpRows;
    const int rows = (int)min((long long)kMlpRows, p.m - r0);
    // the previous tile's last chunk ended with a barrier: slot 0 is free
    if (!resident) {
      stage_chunk(k0, 0);
      cp_async_commit();
    }
    stage_tiles(p.x + r0 * c, static_cast<const T*>(nullptr), rows, c, p.ln,
                p.eps, mu, rs, xs, static_cast<T*>(nullptr));
    float y[kMaxY / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxY / 8; ++j) zero(y[j]);
    for (int k = k0; k < k1; ++k) {
      const int i = k - k0;
      if (!resident && p.nslots > 1 && k + 1 < k1) {
        stage_chunk(k + 1, (i + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk k has landed for every thread's copies
      const T* w1s =
          wbuf + (resident ? i : (p.nslots > 1 ? (i & 1) : 0)) * slot;
      if (16 * warp < rows)
        mlp_chunk<T, kMaxY>(y, xs, w1s, w1s + kChunk * xsd, p.b1, k * kChunk,
                            min(kChunk, p.hdim - k * kChunk), c, cot);
      if (!resident) {
        __syncthreads();  // the slot's readers are done
        if (p.nslots == 1 && k + 1 < k1) {
          stage_chunk(k + 1, 0);
          cp_async_commit();
        }
      }
    }

    // epilogue: fp32 partials of a hidden split, or + b2, T, + shortcut
    if (16 * warp < rows) {
#pragma unroll
      for (int j = 0; j < kMaxY / 8; ++j) {
        if (8 * j < cot) {
          const int col = co0 + 8 * j + 2 * t4;
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(p.b2 + col));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * warp + g + 8 * half;
            if (r >= rows) continue;
            const long long row = r0 + r;
            const float v0 = y[j][2 * half], v1 = y[j][2 * half + 1];
            if (gridDim.z > 1) {
              *reinterpret_cast<float2*>(
                  p.part + ((long long)blockIdx.z * p.m + row) * p.co + col) =
                  make_float2(v0, v1);
              continue;
            }
            float o0 = round_to<T>(v0 + bb.x), o1 = round_to<T>(v1 + bb.y);
            if (p.residual) {
              const T* xr = p.x + row * c + col;
              o0 += to_f32(xr[0]);
              o1 += to_f32(xr[1]);
            }
            *reinterpret_cast<uint32_t*>(p.out + row * p.co + col) =
                pack<T>(o0, o1);
          }
        }
      }
    }
  }
}

// out = T(sum over the splits of the partials, in order, + b2) [+ x], two
// columns a thread.
template <class T>
__global__ void __launch_bounds__(kThreads)
    mlp_tc_finish(const float* __restrict__ part, int nparts,
                  const float* __restrict__ b2, const T* __restrict__ x,
                  T* __restrict__ out, long long m, int co, int residual) {
  const long long len = m * co;
  const long long i = 2 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= len) return;
  float v0 = 0.f, v1 = 0.f;
  for (int z = 0; z < nparts; ++z) {
    const float2 pv = *reinterpret_cast<const float2*>(part + z * len + i);
    v0 += pv.x;
    v1 += pv.y;
  }
  const int col = (int)(i % co);
  float o0 = round_to<T>(v0 + b2[col]), o1 = round_to<T>(v1 + b2[col + 1]);
  if (residual) {  // Co == C: x has the output's layout
    o0 += to_f32(x[i]);
    o1 += to_f32(x[i + 1]);
  }
  *reinterpret_cast<uint32_t*>(out + i) = mmatile::pack<T>(o0, o1);
}

template <class T, int kMaxY>
int launch_mlp_tc(MlpTcParams<T> p, int hsplit, cudaStream_t st) {
  using namespace mlptile;
  const int xsd = p.c + 8;
  const size_t base = sizeof(float) * 2 * kMlpRows + sizeof(T) * kMlpRows * xsd;
  const size_t slot = sizeof(T) * (kChunk * xsd + p.cot * kW2Stride);
  // all of a split's chunks (resident), else two in flight, else one: the
  // most that keep the most blocks on an SM
  int cands[3], ncand = 0;
  cands[ncand++] = p.chunks;
  if (p.chunks > 2) cands[ncand++] = 2;
  if (p.chunks > 1) cands[ncand++] = 1;
  size_t smem = 0;
  cudaError_t err = pick_slots(fused_mlp_tc<T, kMaxY>, base, slot, cands,
                               ncand, &p.nslots, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.nslots == 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_mlp_tc<T, kMaxY>, kMlpThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ntiles = (p.m + kMlpRows - 1) / kMlpRows;
  const int other = (p.co / p.cot) * hsplit;
  const long long fill = max(1LL, (long long)max(per_sm, 1) * sms / other);
  const dim3 grid((unsigned)min(ntiles, fill), p.co / p.cot, hsplit);
  fused_mlp_tc<T, kMaxY><<<grid, kMlpThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || hsplit == 1) return static_cast<int>(err);
  const long long pairs = p.m * p.co / 2;
  mlp_tc_finish<T><<<(unsigned)((pairs + medseg::kThreads - 1) / medseg::kThreads),
                     medseg::kThreads,
                     0, st>>>(p.part, hsplit, p.b2, p.x, p.out, p.m, p.co,
                              p.residual);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_mlp_tc_any(MlpTcParams<T> p, int hsplit, cudaStream_t st) {
  if (p.cot <= 48) return launch_mlp_tc<T, 48>(p, hsplit, st);
  if (p.cot <= 96) return launch_mlp_tc<T, 96>(p, hsplit, st);
  return launch_mlp_tc<T, 192>(p, hsplit, st);
}

}  // namespace
}  // namespace medseg

// x, w1, w2, out of the element type named by dtype; ln, b1, b2 fp32.
// route: kRouteTensorCore (bf16 or fp16, C, Co, H multiples of 16, C <= 768)
// or kRouteCudaCore (any dtype, C and Co up to 768). The tensor-core
// route computes column tiles of co_tile outputs (a multiple of 16 dividing
// Co, <= 192) and splits H hsplit ways, the splits' fp32 partials of y in
// part (hsplit, m, co); the CUDA-core route reads neither.
extern "C" int medseg_fused_mlp_fwd(const void* x, const void* ln,
                                    const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out,
                                    void* part, int m, int c, int hdim, int co,
                                    int residual, int route, int co_tile,
                                    int hsplit, int dtype, float ln_eps,
                                    void* stream) {
  using namespace medseg;
  if (m < 1 || c < 1 || hdim < 1 || co < 1 || (residual && co != c) ||
      !mlptile::mlp_route_takes(route, dtype, c, co, hdim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteTensorCore) {
    const int nch = (hdim + mlptile::kChunk - 1) / mlptile::kChunk;
    const int chunks = hsplit >= 1 ? (nch + hsplit - 1) / hsplit : 0;
    if (co_tile < 16 || co_tile % 16 != 0 || co % co_tile != 0 ||
        co_tile > 192 || hsplit < 1 || (hsplit - 1) * chunks >= nch ||
        (hsplit > 1 && part == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    auto run = [&](auto tag) {
      using T = decltype(tag);
      MlpTcParams<T> p;
      p.x = static_cast<const T*>(x);
      p.ln = static_cast<const float*>(ln);
      p.w1 = static_cast<const T*>(w1);
      p.b1 = static_cast<const float*>(b1);
      p.w2 = static_cast<const T*>(w2);
      p.b2 = static_cast<const float*>(b2);
      p.out = static_cast<T*>(out);
      p.part = static_cast<float*>(part);
      p.m = m; p.c = c; p.hdim = hdim; p.co = co; p.cot = co_tile;
      p.residual = residual; p.chunks = chunks; p.nslots = 1; p.eps = ln_eps;
      return launch_mlp_tc_any<T>(p, hsplit, st);
    };
    return dtype == kBf16 ? run(__nv_bfloat16{}) : run(__half{});
  }
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    int cot = 0, hc = 0;
    if (!mlp_cc_plan<T>(c, co, &cot, &hc))
      return static_cast<int>(cudaErrorInvalidValue);
    if (hc == 32)
      return launch_mlp<T, 32>(x, ln, w1, b1, w2, b2, out, m, c, hdim, co,
                               cot, residual, ln_eps, st);
    return launch_mlp<T, 16>(x, ln, w1, b1, w2, b2, out, m, c, hdim, co, cot,
                             residual, ln_eps, st);
  });
}
