// Window attention on the CUDA cores at the head dims where the one-pass
// heads blocks lose or cannot run: the pieces of the heads launches' wide
// forms (K1 and K6 in csrc/window_attention.cu, K3 in
// csrc/window_attention_bwd.cu).
//
// The one-pass CUDA-core heads blocks keep a window's q, k, v (and K3's
// dout) in shared memory as fp32 and give a lane one output channel; at
// head dim 96 the tiles alone are N x (3 hd + 1) floats, 250 KB at N = 216,
// over the 227 KB of a block, and a lane per channel stops at 32. The wide
// forms walk the head dim in chunks of kD channels instead:
//  * a block owns one head and a run of windows (as K3's blocks do). Per
//    window it projects its head's columns kD at a time (project_head) into
//    its own slots of a scratch buffer in device memory, rounded to T there
//    as the one-pass form rounds them: exact in T, read back from L2;
//  * a group of kR query rows accumulates its (kR, N) fp32 logits over the
//    chunks of q and k (chunk_products); the softmax runs a row a warp over
//    that tile; P . V then fills kD output channels at a time (times_chunk),
//    a thread one (row, channel) pair summing over the keys in order;
//  * K3's key rows do the same with the roles of q and k (v and dout)
//    swapped, from the row statistics of the query pass.
// Only the order of the fp32 sums inside the logits and P . V changes
// against the one-pass form; the rounding points are the same. Shared
// memory grows as ~66 N floats (~130 N for K3): 98 KB at N = 343, 125 KB for
// K3 at N = 216, whatever the head dim. The wrapper picks the form: the
// wide form of K1 and K6 runs above head dim 16, where it beat the one-pass
// form at the stages with many windows (head dim 32), K3's above 32, where
// the one-pass form cannot run (it won at 16 and 32).

#pragma once

#include "common.cuh"

namespace medseg {
namespace wide {

constexpr int kMaxHD = 96;   // largest head dim of the wide forms
constexpr int kD = 32;       // head channels a chunk
constexpr int kR = 32;       // query (or key) rows a group
constexpr int kKC = 32;      // input channels a projection stage
constexpr int kS = kD + 1;   // row stride of a chunk tile (odd: no conflicts)

// Whether an entry point takes the plan of its CUDA-core heads launch. The
// wrapper picks the form: with a scratch buffer (nchunk x nh x slots x n x
// hd elements) the wide form runs, over nchunk runs of ceil(t / nchunk)
// windows, each holding a window; without one the one-pass form, which
// takes head dims up to one_pass_hd.
inline bool plan_takes(int hd, int t, int nchunk, const void* scratch,
                       int one_pass_hd) {
  if (scratch == nullptr) return hd <= one_pass_hd;
  if (hd > kMaxHD || nchunk < 1 || nchunk > t) return false;
  const int wpc = (t + nchunk - 1) / nchunk;
  return (long long)(nchunk - 1) * wpc < t;
}

// fp32 floats of the projection's staging: x (n x (kKC + 1)), the weight
// chunk (kKC x kD) and the output tile (n x kS).
__host__ __device__ constexpr int project_floats(int n) {
  return n * (kKC + 1) + kKC * kD + n * kS;
}

// dst[t * hd + j] = T(fin(j, sum_ch src'[t][ch] * w[base(j) + ch * kstride]))
// for the n rows of one window and the hd columns of a head, kD columns at
// a time; src' is src LayerNorm-ed (mu, rs, ln) and rounded to T when ln is
// given. xs, wsm and tile are the staging of project_floats. Begins and
// ends with __syncthreads().
template <class T, class BaseFn, class FinFn>
__device__ void project_head(const T* src, int n, int c, int hd,
                             const float* ln, const float* mu,
                             const float* rs, const T* w, BaseFn base,
                             int kstride, T* dst, float* xs, float* wsm,
                             float* tile, FinFn fin) {
  const int tid = threadIdx.x, xstr = kKC + 1;
  for (int d0 = 0; d0 < hd; d0 += kD) {
    const int dw = min(kD, hd - d0);
    __syncthreads();  // the previous chunk's readers of tile are done
    for (int o = tid; o < n * kS; o += kThreads) tile[o] = 0.f;
    for (int c0 = 0; c0 < c; c0 += kKC) {
      __syncthreads();
      for (int e = tid; e < n * kKC; e += kThreads) {
        const int t = e / kKC, kk = e - t * kKC, ch = c0 + kk;
        float v = 0.f;
        if (ch < c) {
          v = ld(src + (size_t)t * c + ch);
          if (ln != nullptr)
            v = round_to<T>((v - mu[t]) * rs[t] * ln[ch] + ln[c + ch]);
        }
        xs[t * xstr + kk] = v;
      }
      for (int e = tid; e < kD * kKC; e += kThreads) {
        const int j = e / kKC, kk = e - j * kKC, ch = c0 + kk;
        wsm[kk * kD + j] = (ch < c && j < dw)
                               ? ld(w + base(d0 + j) + (size_t)ch * kstride)
                               : 0.f;
      }
      __syncthreads();
      // token index fastest across lanes: xs reads are conflict-free (odd
      // stride) and wsm reads broadcast
      for (int e = tid; e < n * dw; e += kThreads) {
        const int j = e / n, t = e - j * n;
        const float* xr = xs + t * xstr;
        float acc = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < kKC; ++kk) acc += xr[kk] * wsm[kk * kD + j];
        tile[t * kS + j] += acc;
      }
    }
    __syncthreads();
    for (int e = tid; e < n * dw; e += kThreads) {
      const int t = e / dw, j = e - t * dw;
      dst[(size_t)t * hd + d0 + j] = from_f32<T>(fin(d0 + j, tile[t * kS + j]));
    }
  }
  __syncthreads();
}

// Rows [r0, r0 + rows) of an (n x hd) slot, channels [d0, d0 + dw), as fp32
// into tile (rows x kS).
template <class T>
__device__ __forceinline__ void stage_chunk(const T* slot, int hd, int r0,
                                            int rows, int d0, int dw,
                                            float* tile) {
  for (int e = threadIdx.x; e < rows * dw; e += kThreads) {
    const int r = e / dw, d = e - r * dw;
    tile[r * kS + d] = ld(slot + (size_t)(r0 + r) * hd + d0 + d);
  }
}

// acc[i * rb + m] += sum_{d < dw} a[i][d] * b[m][d] for i < ra, m < rb;
// a (ra x kS) and b (rb x kS) are chunk tiles. Lanes run along m: b's reads
// are conflict-free, a's broadcast. The same products in the same order
// whichever of the two tiles is a.
__device__ __forceinline__ void chunk_products(const float* a, int ra,
                                               const float* b, int rb, int dw,
                                               float* acc) {
  for (int e = threadIdx.x; e < ra * rb; e += kThreads) {
    const int i = e / rb, m = e - i * rb;
    const float* ar = a + i * kS;
    const float* br = b + m * kS;
    float s = 0.f;
    for (int d = 0; d < dw; ++d) s += ar[d] * br[d];
    acc[e] += s;
  }
}

// wr(i, d, sum_{m < nk} p[i * nk + m] * v[m][d]) for i < ra, d < dw; v
// (nk x kS) is a chunk tile. A thread sums one (row, channel) pair over the
// keys in order.
template <class Fn>
__device__ __forceinline__ void times_chunk(const float* p, int ra, int nk,
                                            const float* v, int dw, Fn wr) {
  for (int e = threadIdx.x; e < ra * dw; e += kThreads) {
    const int i = e / dw, d = e - i * dw;
    const float* pr = p + (size_t)i * nk;
    float a = 0.f;
    for (int m = 0; m < nk; ++m) a += pr[m] * v[m * kS + d];
    wr(i, d, a);
  }
}

}  // namespace wide
}  // namespace medseg
