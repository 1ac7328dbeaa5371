// Tensor-core tiles of the window-attention kernels (K1 and K6 forward,
// K3 backward) for bf16 and fp16 windows with head dim 16: mma.sync
// m16n8k16 with fp32 accumulation, operands through ldmatrix.
//
// A window's N <= 224 tokens are padded to np = 16 * ceil(N / 16) rows and
// cut into strips of 16 query rows. Head dim 16 is exactly one k-step, so a
// strip's scores q . k^T are one mma per 8 keys, and the 16 x np score strip
// stays in a warp's registers (kNT = 28 n-tiles, 112 fp32 a thread): its
// C fragments are the A fragments of p . v with no trip through shared
// memory (the accumulator of keys 16i..16i+15 is the A operand of k-step i).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 / .f16), g = lane / 4,
// t = lane % 4: A regs (row g, cols 2t..2t+1), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8); B regs (k rows 2t..2t+1, col g), (2t + 8, g); C floats
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
//
// Shared-memory tiles are row-major T with padded strides (kHS, the chunk
// stride xs_stride<KC>, kPS): every row is a 16-byte multiple and the 8
// rows of an 8 x 8 ldmatrix matrix fall in 8 distinct 16-byte bank groups.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

// MEDSEG_ATTN_SKIP: parts of the tensor-core attention kernels compiled out,
// for chip_smoke.py's attn_parts phase only (0, nothing skipped, in the
// library; the results of a variant are wrong by design): 1 the LayerNorm
// statistics and the staging loads, 2 the softmax's elementwise work (bias,
// mask, exp, sums), 4 the launches after the heads launch (K1's projection,
// K3's dx and dw), 8 K3's bias partials, 16 K3's dv and dk products; in the
// tensor-core GEMM launches (K1's projection, K3's dx and dw): 32 the
// staging loads of the token tiles and weight chunks, 64 the LayerNorm
// (dx: statistics and the backward's arithmetic; dw: applying it in
// place), 128 dw's flushes into the slab, 256 the epilogues (the
// projection's bias, shortcut and stores; dx's LayerNorm backward, stores
// and dLN sums), 512 the dw launch (dx alone), 1024 the heads launch (the
// GEMM launches alone, on whatever attn and dqkv hold). A variant starts
// from zeroed shared memory.
#ifndef MEDSEG_ATTN_SKIP
#define MEDSEG_ATTN_SKIP 0
#endif

namespace medseg {

// The routes of the attention launches (K1, K3, K6; the heads launches and,
// as a second argument, the GEMM launches) and of K2, K4: the route
// arguments of their C entry points, picked by the wrappers from the dtype
// and the shape alone.
constexpr int kRouteCudaCore = 0, kRouteTensorCore = 1;

namespace mmatile {

constexpr int kHD = 16;              // the head dim of the tensor-core route
constexpr int kMaxNP = 224;          // padded tokens of a window: 14 strips
constexpr int kMaxStrips = kMaxNP / 16;
constexpr int kNT = kMaxNP / 8;      // n-tiles of a score strip
constexpr int kHS = kHD + 8;         // stride of the per-head [token][d] tiles
// a chunk of KC staged channels has the row stride KC + 8 (KC a multiple
// of 16): an odd number of 16-byte units
template <int KC>
__host__ __device__ constexpr int xs_stride() { return KC + 8; }
constexpr int kPS = kMaxNP + 8;      // stride of a staged [query][key] tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row major) . b (16 x 8, column major), fp32 accumulate
template <class T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two values rounded to T (round to nearest even, one paired conversion),
// lo at the lower address
template <class T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ void zero(float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
}

// Stage rows [0, np) x channels [c0, c0 + kc) (kc <= KC) of a window of n
// rows and C channels into dst (stride xs_stride<KC>) as T, in 16-byte
// vectors (C, c0 and kc multiples of 8); value(v, row, channel) maps each
// loaded value (the LayerNorm, or the identity); rows n .. np are zero. A
// thread keeps four loads in flight.
template <int KC, class T, class F>
__device__ __forceinline__ void stage_rows(const T* src, int n, int np, int c,
                                           int c0, int kc, T* dst, F value) {
  constexpr int kXS = xs_stride<KC>();
  constexpr int kInFlight = 4;
  const int vecs = kc / 8, total = np * vecs, step = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += kInFlight * step) {
    uint4 in[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * step, r = e / vecs, v8 = (e - r * vecs) * 8;
      in[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < total && r < n)
        in[u] = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * c +
                                                     c0 + v8));
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * step, r = e / vecs, v8 = (e - r * vecs) * 8;
      if (e >= total) break;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (r < n) {
        const T* iv = reinterpret_cast<const T*>(&in[u]);
        uint32_t* ov = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ov[i] = pack<T>(value(to_f32(iv[2 * i]), r, c0 + v8 + 2 * i),
                          value(to_f32(iv[2 * i + 1]), r, c0 + v8 + 2 * i + 1));
      }
      *reinterpret_cast<uint4*>(dst + r * kXS + v8) = out;
    }
  }
}

// fp32 LayerNorm statistics of the n rows of a window (C channels, a
// multiple of 8), one row a thread: mu[r] and rstd[r] with the fast variance
// max(0, E[x^2] - E[x]^2), as row_stats in common.cuh computes them (the
// sums in another order). A thread keeps four 16-byte loads in flight, so
// the block is not bound by one load's latency per row.
template <class T>
__device__ __forceinline__ void window_stats(const T* xw, int n, int c,
                                             float eps, float* mu,
                                             float* rstd) {
  constexpr int kInFlight = 4;
  const int vecs = c / 8;
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const uint4* row = reinterpret_cast<const uint4*>(xw + (size_t)r * c);
    float s = 0.f, ss = 0.f;
    for (int v0 = 0; v0 < vecs; v0 += kInFlight) {
      uint4 in[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        in[u] = v0 + u < vecs ? __ldg(row + v0 + u)
                              : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const T* iv = reinterpret_cast<const T*>(&in[u]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = to_f32(iv[i]);
          s += v;
          ss += v * v;
        }
      }
    }
    const float m = s / c;
    mu[r] = m;
    rstd[r] = 1.0f / sqrtf(fmaxf(0.f, ss / c - m * m) + eps);
  }
}

// Stage rows of a weight: dst[j][0..kc) = w[row(j)][c0 .. c0 + kc) for j in
// [0, nrows), stride xs_stride<KC>; row(j) < 0 leaves the row unwritten.
template <int KC, class T, class RowFn>
__device__ __forceinline__ void stage_weight_rows(const T* w, int c, int c0,
                                                  int kc, int nrows, T* dst,
                                                  RowFn row) {
  constexpr int kXS = xs_stride<KC>();
  const int vecs = kc / 8;
  for (int e = threadIdx.x; e < nrows * vecs; e += blockDim.x) {
    const int j = e / vecs, v8 = (e - j * vecs) * 8;
    const int src = row(j);
    if (src >= 0)
      *reinterpret_cast<uint4*>(dst + j * kXS + v8) =
          *reinterpret_cast<const uint4*>(w + (size_t)src * c + c0 + v8);
  }
}

// acc[j] += X(strip s of a staged chunk, kc channels) . W^T(n-tile j), for
// the n-tile pairs [p0, NJ / 2); W staged [out column][channel]; both with
// the stride xs_stride<KC>.
template <int KC, class T, int NJ>
__device__ __forceinline__ void project_strip(float (&acc)[NJ][4],
                                              const T* xs, const T* ws, int s,
                                              int kc, int p0) {
  constexpr int kXS = xs_stride<KC>();
  const int lane = threadIdx.x & 31;
  const T* a_row = xs + (16 * s + (lane & 15)) * kXS + (lane >> 4) * 8;
  const T* b_row = ws + ((lane & 7) + ((lane >> 4) << 3)) * kXS +
                   ((lane >> 3) & 1) * 8;
  for (int ks = 0; ks < kc / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_row + 16 * ks);
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      if (p < p0) continue;
      uint32_t b[4];
      ldsm_x4(b, b_row + 16 * p * kXS + 16 * ks);
      mma<T>(acc[2 * p], a, b[0], b[1]);
      mma<T>(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// The A fragment of a 16 x 16 tile held as two C fragments (columns 0-7 and
// 8-15), rounded to T.
template <class T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack<T>(lo[0], lo[1]);
  a[1] = pack<T>(lo[2], lo[3]);
  a[2] = pack<T>(hi[0], hi[1]);
  a[3] = pack<T>(hi[2], hi[3]);
}

// Store a 16 x 16 C fragment pair (rows 16s.., columns 0-15), rounded to
// T, into a [token][d] tile (stride kHS).
template <class T>
__device__ __forceinline__ void store_head_tile(T* dst, int s,
                                                const float (&lo)[4],
                                                const float (&hi)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t* r0 = reinterpret_cast<uint32_t*>(dst + (16 * s + g) * kHS + 2 * t);
  uint32_t* r1 = reinterpret_cast<uint32_t*>(dst + (16 * s + g + 8) * kHS +
                                             2 * t);
  r0[0] = pack<T>(lo[0], lo[1]);
  r1[0] = pack<T>(lo[2], lo[3]);
  r0[4] = pack<T>(hi[0], hi[1]);
  r1[4] = pack<T>(hi[2], hi[3]);
}

// Write a 16 x 16 C fragment pair (rows 16s.. of a window, head columns
// col0 .. col0 + 16 of a row of `stride` elements), rounded to T, to device
// memory; rows >= n are padding and are not written.
template <class T>
__device__ __forceinline__ void write_rows(T* dst, int stride, int col0,
                                           int s, int n, const float (&lo)[4],
                                           const float (&hi)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * s + g, r1 = r0 + 8;
  if (r0 < n) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + (size_t)r0 * stride +
                                              col0 + 2 * t);
    d[0] = pack<T>(lo[0], lo[1]);
    d[4] = pack<T>(hi[0], hi[1]);
  }
  if (r1 < n) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + (size_t)r1 * stride +
                                              col0 + 2 * t);
    d[0] = pack<T>(lo[2], lo[3]);
    d[4] = pack<T>(hi[2], hi[3]);
  }
}

// bias[row][col], bias[row][col + 1] (fp32; 0 outside the row's n keys,
// and for a padded row: valid false); one 8-byte load when n is even.
__device__ __forceinline__ float2 bias_pair(const float* bias, int row,
                                           int col, int n, bool valid) {
  float2 b = make_float2(0.f, 0.f);
  if (!valid || col >= n) return b;
  const float* p = bias + (size_t)row * n + col;
  if ((n & 1) == 0) return __ldg(reinterpret_cast<const float2*>(p));
  b.x = __ldg(p);
  if (col + 1 < n) b.y = __ldg(p + 1);
  return b;
}

// part[row][col], part[row][col + 1] of an n x n fp32 slab += a, b (the
// bias partials a block adds a window's ds to; entries outside the slab
// are skipped), as reductions in L2 that the thread does not wait for: one
// 8-byte one when n is even. A block's slab is its own and an entry is
// always added to by the same thread, in program order, so the sums are
// taken in a fixed order and reruns are bit-equal.
__device__ __forceinline__ void add_pair(float* part, int row, int col, int n,
                                         float a, float b) {
  if (row >= n || col >= n) return;
  float* p = part + (size_t)row * n + col;
  if ((n & 1) == 0) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
    return;
  }
  atomicAdd(p, a);
  if (col + 1 < n) atomicAdd(p + 1, b);
}

// The softmax of one strip s of 16 query rows against all keys, in
// registers: sc = q . k^T (one mma per n-tile, q the strip's A fragment, k
// the [key][d] tile), then sc * scale + bias[row][key] (fp32, rows >= n
// take 0) - 100 where the shifted-window labels differ (lab != nullptr),
// keys >= n excluded; sc <- p32 = exp(s - max) * (1 / sum), fp32: the JAX
// kernel's exact two-step softmax (the product by the reciprocal is within
// an fp32 ulp of the quotient, and p32 is rounded to T only afterwards).
// nt = np / 8 n-tiles are live; lab == nullptr: no mask. The bias is loaded
// into the score registers before any product, so all of a strip's loads
// are in flight at once.
template <class T>
__device__ __forceinline__ void softmax_strip(float (&sc)[kNT][4],
                                              const uint32_t (&qa)[4],
                                              const T* ks, int s, int nt,
                                              const float* bias, const int* lab,
                                              int n, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * s + g, r1 = r0 + 8;
  const bool v0 = r0 < n, v1 = r1 < n;
  if (MEDSEG_ATTN_SKIP & 2) {  // the products alone
    const T* k_row = ks + ((lane & 7) + ((lane >> 4) << 3)) * kHS +
                     ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p) {
      if (2 * p < nt) {
        uint32_t b[4];
        ldsm_x4(b, k_row + 16 * p * kHS);
        zero(sc[2 * p]);
        zero(sc[2 * p + 1]);
        mma<T>(sc[2 * p], qa, b[0], b[1]);
        mma<T>(sc[2 * p + 1], qa, b[2], b[3]);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j < nt && 8 * j < n) {
      const float2 bb0 = bias_pair(bias, r0, 8 * j + 2 * t, n, v0);
      const float2 bb1 = bias_pair(bias, r1, 8 * j + 2 * t, n, v1);
      sc[j][0] = bb0.x;
      sc[j][1] = bb0.y;
      sc[j][2] = bb1.x;
      sc[j][3] = bb1.y;
    }
  }
  const T* b_row = ks + ((lane & 7) + ((lane >> 4) << 3)) * kHS +
                   ((lane >> 3) & 1) * 8;
  const int l0 = lab != nullptr ? lab[r0] : 0, l1 = lab != nullptr ? lab[r1] : 0;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int p = 0; p < kNT / 2; ++p) {
    if (2 * p < nt) {
      uint32_t b[4];
      ldsm_x4(b, b_row + 16 * p * kHS);
      float d[2][4];
      zero(d[0]);
      zero(d[1]);
      mma<T>(d[0], qa, b[0], b[1]);
      mma<T>(d[1], qa, b[2], b[3]);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * p + u;
        if (8 * j + 8 <= n && lab == nullptr) {
          // every key of the tile exists and there is no mask: the common
          // case, with no test per score (the branch is the warp's)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = d[u][e] * scale + sc[j][e];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cc = 8 * j + 2 * t + (e & 1);
            float v = -INFINITY;
            if (cc < n) {
              v = d[u][e] * scale + sc[j][e];
              if (lab != nullptr && lab[cc] != (e >= 2 ? l1 : l0)) v += -100.f;
            }
            sc[j][e] = v;
          }
        }
        m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
        m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
      }
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (8 * j >= n) {  // a tile of padding keys only
      zero(sc[j]);
    } else if (j < nt) {
      sc[j][0] = expf(sc[j][0] - m0);
      sc[j][1] = expf(sc[j][1] - m0);
      sc[j][2] = expf(sc[j][2] - m1);
      sc[j][3] = expf(sc[j][3] - m1);
      s0 += sc[j][0] + sc[j][1];
      s1 += sc[j][2] + sc[j][3];
    }
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  const float i0 = 1.f / s0, i1 = 1.f / s1;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j < nt) {
      sc[j][0] *= i0;
      sc[j][1] *= i0;
      sc[j][2] *= i1;
      sc[j][3] *= i1;
    }
  }
}

// o[0..1] += A . B over k-steps 0 .. ksteps with B a [k][d] tile (stride
// kHS, through ldmatrix.trans) and A's k-step i given by a_of(i, a).
template <class T, class AFn>
__device__ __forceinline__ void accum_head_tile(float (&o)[2][4], const T* kd,
                                                int ksteps, AFn a_of) {
  const int lane = threadIdx.x & 31;
  const T* b_row = kd + ((lane & 7) + ((lane >> 3) & 1) * 8) * kHS +
                   (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < kNT / 2; ++i) {
    if (i < ksteps) {
      uint32_t a[4], b[4];
      a_of(i, a);
      ldsm_x4_t(b, b_row + 16 * i * kHS);
      mma<T>(o[0], a, b[0], b[1]);
      mma<T>(o[1], a, b[2], b[3]);
    }
  }
}

// o[0..1] = A . B over the nt / 2 k-steps of a window (see accum_head_tile)
template <class T, class AFn>
__device__ __forceinline__ void times_head_tile(float (&o)[2][4],
                                                const T* kd, int nt,
                                                AFn a_of) {
  zero(o[0]);
  zero(o[1]);
  accum_head_tile<T>(o, kd, nt / 2, a_of);
}

}  // namespace mmatile

// Whether a heads launch of this dtype and shape can take the route: the
// tensor cores take bf16 and fp16 at head dim 16 with at most 224 tokens a
// window; the CUDA cores take everything.
inline bool route_takes(int route, int dtype, int n, int c, int hd) {
  if (route == kRouteCudaCore) return true;
  return route == kRouteTensorCore && (dtype == kBf16 || dtype == kF16) &&
         hd == mmatile::kHD && n <= mmatile::kMaxNP && c % 16 == 0;
}

}  // namespace medseg
