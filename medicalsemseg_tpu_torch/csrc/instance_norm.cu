// The UNETR decoder's InstanceNorm -> residual -> LeakyReLU chain, forward
// and backward (kernel K11).
//
// Replaces no TPU kernel: the JAX package leaves its InstanceNorm
// (medicalsemseg_tpu/models/layers.py:349) and the LeakyReLU and residual add
// of UnetResBlock to XLA's fusion. It replaces the library passes the port
// ran for them: a cast to fp32, var_mean, four fp32 broadcast passes, the
// cast back, the LeakyReLU and the residual add, and in the backward one pass
// per op through fp32 intermediates that autograd had saved.
//
// For channels-last a (B, N, C), N = D.H.W voxels, per-(b, c) fp32
// statistics mean and rstd = 1 / sqrt(var + eps) (population variance), and
// IN(a) = (a - mean) . rstd . gamma + beta, computed as a . s + h with
// s = rstd . gamma and h = beta - mean . s:
//   form 0  y = lrelu(IN(a))              (norm1 of a UnetResBlock)
//   form 1  y = lrelu(IN(a) + r)          (norm2 and the block's input)
//   form 2  y = lrelu(IN(a) + IN'(r))     (norm2 and norm3 of the shortcut)
// the LeakyReLU of slope 0.01, all in fp32, the output rounded once to the
// input's type (bf16, fp16 or fp32). Backward, with pre (the LeakyReLU's
// input) recomputed from the inputs and the statistics, g = dy where pre > 0
// and 0.01 dy elsewhere, ahat = (a - mean) . rstd and means over the N voxels:
//   da = s . (g - mean(g) - ahat . mean(g . ahat)),
//   dgamma = sum_{b, n} g . ahat,  dbeta = sum_{b, n} g,
//   dr = g (form 1), or the same norm backward for r (form 2).
// Without y (the forward's `y` NULL) the forward computes the statistics
// alone: the fused decoder's norm1, folded into kernel K9's input.
//
// What bounds it on the card: device-memory bytes, at a few operations a
// value. Forward: the statistics launch reads a (and r in form 2) once, the
// apply launch reads a and r and writes y: 6 bytes a bf16 value in form 0, 8
// in form 1, 10 in form 2 (the library chain moved ~53). Backward: the
// reduction reads a, dy (and r), the apply reads them again and writes da
// (and dr): 10 bytes a value in form 0, 16 in forms 1 and 2 (the library
// chain ~100). The (B, C) statistics and sums are small beside them. The
// design meets the bound so:
//  - every streaming launch has one geometry, grid (chunks, B, groups): a
//    block of 256 threads owns a run of voxels of one sample and a group of
//    at most 32 channel vectors; thread t owns vector t % gw of the group
//    (16 bytes: 8 bf16 / fp16 or 4 fp32 channels where C allows it and the
//    tensors start on 16-byte boundaries, one channel otherwise) in rows
//    t / gw, t / gw + 256 / gw, ..., so the block's loads cover whole
//    consecutive rows, and the thread keeps its channels' coefficients in
//    registers for the whole run; rows in flight a thread: 8 in the
//    statistics launch, which reads one stream, 2 in the launches that read
//    two or three (4 there made the backward 35 % slower at 96^3 x 48 on an
//    H100);
//  - the plan (ops/kernels/instance_norm.py `plan`) takes the vector width
//    from C and the alignment, the groups from C, and the chunks from B, N
//    and the groups: small tensors run one block a (sample, group), large
//    ones about four blocks an SM;
//  - statistics: Welford's update per value in fp32 (count, mean, M2) in
//    each thread, over the values less the chunk's first, Chan's merge of a
//    block's threads in a fixed order, then of the chunks in a fixed order
//    (the merge launch): a rerun is bit-equal, and no E[x^2] - E[x]^2
//    cancellation enters the variance;
//  - backward sums: fp32 in each thread, per block and over the chunks in a
//    fixed order (the finish launch, which also adds dgamma and dbeta over
//    the batch); no atomics;
//  - pre is one function (pre_act) in the forward and the backward, built
//    from intrinsics that round as written, so the backward's LeakyReLU mask
//    is the forward's to the bit.

#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr float kSlope = 0.01f;
constexpr int kMaxGroup = 32;   // channel vectors of a group
constexpr int kMaxVec = 8;      // channels of a vector
constexpr int kUnrollStats = 8; // rows a thread has in flight: statistics
constexpr int kUnroll = 2;      // ... the launches with more streams

struct Geo {
  long long n;       // voxels of a sample
  long long csize;   // voxels of a chunk
  int b, c, gw, groups, rows, chunks;
};

// V values at p (16 bytes in one load where V spans them), widened to fp32
template <class T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  }
}

template <class T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// Where this thread works: its row slot, its first channel, whether it owns
// a vector, and the voxels [v0, v1) of its block's chunk.
struct Pos {
  int r, ch0;
  bool on;
  long long v0, v1;
};

template <int V>
__device__ __forceinline__ Pos position(const Geo& g, int group) {
  Pos p;
  p.r = threadIdx.x / g.gw;
  p.ch0 = (group * g.gw + (threadIdx.x - p.r * g.gw)) * V;
  p.on = p.r < g.rows && p.ch0 < g.c;
  p.v0 = (long long)blockIdx.x * g.csize;
  p.v1 = min(g.n, p.v0 + g.csize);
  return p;
}

// (n, mean, m2) += (nb, mb, m2b): Chan et al.'s merge of two sets
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - mean;
  const float w = nb / nn;
  mean = fmaf(d, w, mean);
  m2 = m2 + m2b + d * d * n * w;
  n = nn;
}

__device__ __forceinline__ void affine(float mean, float rstd, float gamma,
                                       float beta, float& s, float& h) {
  s = __fmul_rn(rstd, gamma);
  h = __fmaf_rn(-mean, s, beta);
}

// the LeakyReLU's input, the same bits in the forward and the backward
template <int kForm>
__device__ __forceinline__ float pre_act(float a, float r, float sa, float ha,
                                         float sr, float hr) {
  float p = __fmaf_rn(a, sa, ha);
  if (kForm == 1) p = __fadd_rn(p, r);
  if (kForm == 2) p = __fadd_rn(p, __fmaf_rn(r, sr, hr));
  return p;
}

// mean, rstd, s and h of channels ch0 .. ch0 + V - 1 of sample b, tensor
// `tens` of the statistics (tens, 2, B, C)
template <int V>
__device__ __forceinline__ void load_affine(
    const float* stats, const float* gamma, const float* beta, int tens,
    const Geo& g, int b, int ch0, float (&mu)[V], float (&rs)[V],
    float (&s)[V], float (&h)[V]) {
  const float* st = stats + ((long long)tens * 2 * g.b + b) * g.c + ch0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mu[i] = st[i];
    rs[i] = st[(long long)g.b * g.c + i];
    affine(mu[i], rs[i], gamma[ch0 + i], beta[ch0 + i], s[i], h[i]);
  }
}

// Per (chunk, b, c) of x0 (blockIdx.z < groups) or x1: the chunk's mean and
// M2, into part (tens, chunks, B, 2, C).
template <class T, int V>
__global__ void __launch_bounds__(kThreads)
    instance_norm_stats_kernel(const T* __restrict__ x0,
                               const T* __restrict__ x1,
                               float* __restrict__ part, Geo g) {
  __shared__ float s_mean[kThreads * kMaxVec], s_m2[kThreads * kMaxVec];
  __shared__ float s_n[kThreads];
  const int tens = blockIdx.z / g.groups;
  const int group = blockIdx.z - tens * g.groups;
  const int b = blockIdx.y;
  const Pos p = position<V>(g, group);
  // the sums run over x - k, k the chunk's first row: no rounding of a mean
  // far from 0 enters M2 before the chunks are merged
  const T* xs0 = (tens ? x1 : x0) + (long long)b * g.n * g.c;
  float n = 0.f, mean[V], m2[V], k[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = k[i] = 0.f;
  if (p.on && p.v0 + p.r < p.v1) {
    const T* x = xs0 + p.ch0;
    const long long step = (long long)g.rows;
    load_vec<T, V>(x + p.v0 * g.c, k);
    for (long long v = p.v0 + p.r; v < p.v1; v += kUnrollStats * step) {
      float xv[kUnrollStats][V];
#pragma unroll
      for (int u = 0; u < kUnrollStats; ++u)
        if (v + u * step < p.v1) load_vec<T, V>(x + (v + u * step) * g.c, xv[u]);
#pragma unroll
      for (int u = 0; u < kUnrollStats; ++u) {
        if (v + u * step < p.v1) {
          n += 1.f;
          const float rn = __frcp_rn(n);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float xs = xv[u][i] - k[i];
            const float d = xs - mean[i];
            mean[i] = fmaf(d, rn, mean[i]);
            m2[i] = fmaf(d, xs - mean[i], m2[i]);
          }
        }
      }
    }
  }
  const int t = threadIdx.x;
  s_n[t] = n;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s_mean[t * V + i] = mean[i];
    s_m2[t * V + i] = m2[i];
  }
  __syncthreads();
  // one thread a channel of the group merges the row slots in order
  const int ch = group * g.gw * V + t;
  if (t < g.gw * V && ch < g.c) {
    const int j = t / V, i = t - j * V;
    float cn = 0.f, cm = 0.f, cq = 0.f;
    for (int r = 0; r < g.rows; ++r) {
      const int s = r * g.gw + j;
      chan_merge(cn, cm, cq, s_n[s], s_mean[s * V + i], s_m2[s * V + i]);
    }
    float* out =
        part + (((long long)tens * g.chunks + blockIdx.x) * g.b + b) * 2 * g.c +
        ch;
    out[0] = cn > 0.f ? to_f32(xs0[p.v0 * g.c + ch]) + cm : 0.f;
    out[g.c] = cq;
  }
}

// Per (tens, b, c): the chunks merged in a fixed order, mean and rstd into
// stats (tens, 2, B, C). Blocks of (32 channels, 8 lanes), grid (channel
// blocks, B, tens): lane l merges chunks l, l + 8, ..., then lane 0 the
// lanes in order.
__global__ void __launch_bounds__(kThreads)
    instance_norm_merge_kernel(const float* __restrict__ part,
                               float* __restrict__ stats, Geo g, float eps) {
  __shared__ float s_n[8][32], s_mean[8][32], s_m2[8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * 32 + tx;
  const int b = blockIdx.y, tens = blockIdx.z;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (ch < g.c) {
    for (int k = ty; k < g.chunks; k += 8) {
      const long long nk = min(g.csize, g.n - (long long)k * g.csize);
      if (nk <= 0) break;
      const float* pk =
          part + (((long long)tens * g.chunks + k) * g.b + b) * 2 * g.c + ch;
      chan_merge(n, mean, m2, (float)nk, pk[0], pk[g.c]);
    }
  }
  s_n[ty][tx] = n;
  s_mean[ty][tx] = mean;
  s_m2[ty][tx] = m2;
  __syncthreads();
  if (ty != 0 || ch >= g.c) return;
  n = mean = m2 = 0.f;
  for (int l = 0; l < 8; ++l)
    chan_merge(n, mean, m2, s_n[l][tx], s_mean[l][tx], s_m2[l][tx]);
  float* st = stats + ((long long)tens * 2 * g.b + b) * g.c + ch;
  st[0] = mean;
  st[(long long)g.b * g.c] = 1.0f / sqrtf(m2 / n + eps);
}

template <class T, int V, int kForm>
__global__ void __launch_bounds__(kThreads)
    instance_norm_act_kernel(const T* __restrict__ a, const T* __restrict__ r,
                             const float* __restrict__ stats,
                             const float* __restrict__ ga,
                             const float* __restrict__ ba,
                             const float* __restrict__ gr,
                             const float* __restrict__ br, T* __restrict__ y,
                             Geo g) {
  const int b = blockIdx.y;
  const Pos p = position<V>(g, blockIdx.z);
  if (!p.on) return;
  float mu[V], rs[V], sa[V], ha[V], sr[V], hr[V];
  load_affine<V>(stats, ga, ba, 0, g, b, p.ch0, mu, rs, sa, ha);
  if (kForm == 2) {
    load_affine<V>(stats, gr, br, 1, g, b, p.ch0, mu, rs, sr, hr);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) sr[i] = hr[i] = 0.f;
  }
  const long long off = (long long)b * g.n * g.c + p.ch0;
  const long long step = (long long)g.rows;
  for (long long v = p.v0 + p.r; v < p.v1; v += kUnroll * step) {
    float av[kUnroll][V], rv[kUnroll][V] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = off + (v + u * step) * g.c;
      if (v + u * step < p.v1) {
        load_vec<T, V>(a + e, av[u]);
        if (kForm != 0) load_vec<T, V>(r + e, rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * step < p.v1) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float x =
              pre_act<kForm>(av[u][i], rv[u][i], sa[i], ha[i], sr[i], hr[i]);
          o[i] = x > 0.f ? x : x * kSlope;
        }
        store_vec<T, V>(y + off + (v + u * step) * g.c, o);
      }
    }
  }
}

// Backward, first pass: per (chunk, b, c) the sums of g, g . ahat (and
// g . rhat in form 2), into part (chunks, B, kSums, C).
template <class T, int V, int kForm>
__global__ void __launch_bounds__(kThreads)
    instance_norm_bwd_reduce_kernel(
        const T* __restrict__ a, const T* __restrict__ r,
        const T* __restrict__ dy, const float* __restrict__ stats,
        const float* __restrict__ ga, const float* __restrict__ ba,
        const float* __restrict__ gr, const float* __restrict__ br,
        float* __restrict__ part, Geo g) {
  constexpr int kSums = kForm == 2 ? 3 : 2;
  __shared__ float s_sum[kSums][kThreads * kMaxVec];
  const int b = blockIdx.y, group = blockIdx.z;
  const Pos p = position<V>(g, group);
  float acc[kSums][V] = {};
  if (p.on) {
    float mu[V], rs[V], sa[V], ha[V], mr[V], rr[V], sr[V], hr[V];
    load_affine<V>(stats, ga, ba, 0, g, b, p.ch0, mu, rs, sa, ha);
    if (kForm == 2) {
      load_affine<V>(stats, gr, br, 1, g, b, p.ch0, mr, rr, sr, hr);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) mr[i] = rr[i] = sr[i] = hr[i] = 0.f;
    }
    const long long off = (long long)b * g.n * g.c + p.ch0;
    const long long step = (long long)g.rows;
    for (long long v = p.v0 + p.r; v < p.v1; v += kUnroll * step) {
      float av[kUnroll][V], dv[kUnroll][V], rv[kUnroll][V] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long e = off + (v + u * step) * g.c;
        if (v + u * step < p.v1) {
          load_vec<T, V>(a + e, av[u]);
          load_vec<T, V>(dy + e, dv[u]);
          if (kForm != 0) load_vec<T, V>(r + e, rv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v + u * step < p.v1) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float x =
                pre_act<kForm>(av[u][i], rv[u][i], sa[i], ha[i], sr[i], hr[i]);
            const float gg = x > 0.f ? dv[u][i] : dv[u][i] * kSlope;
            acc[0][i] += gg;
            acc[1][i] = fmaf(gg, (av[u][i] - mu[i]) * rs[i], acc[1][i]);
            if (kForm == 2)
              acc[kSums - 1][i] =
                  fmaf(gg, (rv[u][i] - mr[i]) * rr[i], acc[kSums - 1][i]);
          }
        }
      }
    }
  }
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s_sum[k][t * V + i] = acc[k][i];
  __syncthreads();
  const int ch = group * g.gw * V + t;
  if (t < g.gw * V && ch < g.c) {
    const int j = t / V, i = t - j * V;
    float* out =
        part + ((long long)blockIdx.x * g.b + b) * kSums * g.c + ch;
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float s = 0.f;
      for (int r = 0; r < g.rows; ++r) s += s_sum[k][(r * g.gw + j) * V + i];
      out[(long long)k * g.c] = s;
    }
  }
}

// Backward, second pass, blocks of (32 channels, 8 samples): the chunks'
// sums added in order into sums (B, nsums, C), then over the batch in order
// into dparams (3, C): dgamma, dbeta, and dgamma of r's norm in form 2 (its
// dbeta is dbeta).
__global__ void __launch_bounds__(kThreads)
    instance_norm_bwd_finish_kernel(const float* __restrict__ part,
                                    float* sums, float* __restrict__ dparams,
                                    int nsums, Geo g) {
  const int ch = blockIdx.x * 32 + threadIdx.x;
  const bool on = ch < g.c;
  if (on) {
    for (int b = threadIdx.y; b < g.b; b += 8) {
      for (int k = 0; k < nsums; ++k) {
        float s = 0.f;
        for (int q = 0; q < g.chunks; ++q)
          s += part[(((long long)q * g.b + b) * nsums + k) * g.c + ch];
        sums[((long long)b * nsums + k) * g.c + ch] = s;
      }
    }
  }
  __syncthreads();
  if (on && threadIdx.y == 0) {
    float d[3] = {0.f, 0.f, 0.f};
    for (int b = 0; b < g.b; ++b)
      for (int k = 0; k < nsums; ++k)
        d[k] += sums[((long long)b * nsums + k) * g.c + ch];
    dparams[ch] = d[1];
    dparams[g.c + ch] = d[0];
    if (nsums == 3) dparams[2 * g.c + ch] = d[2];
  }
}

// Backward, third pass: da (and dr) from the per-(b, c) sums.
template <class T, int V, int kForm>
__global__ void __launch_bounds__(kThreads)
    instance_norm_bwd_apply_kernel(
        const T* __restrict__ a, const T* __restrict__ r,
        const T* __restrict__ dy, const float* __restrict__ stats,
        const float* __restrict__ ga, const float* __restrict__ ba,
        const float* __restrict__ gr, const float* __restrict__ br,
        const float* __restrict__ sums, T* __restrict__ da,
        T* __restrict__ dr, Geo g) {
  constexpr int kSums = kForm == 2 ? 3 : 2;
  const int b = blockIdx.y;
  const Pos p = position<V>(g, blockIdx.z);
  if (!p.on) return;
  float mu[V], rs[V], sa[V], ha[V], mr[V], rr[V], sr[V], hr[V];
  float mg[V], qa[V], qr[V];
  load_affine<V>(stats, ga, ba, 0, g, b, p.ch0, mu, rs, sa, ha);
  if (kForm == 2) {
    load_affine<V>(stats, gr, br, 1, g, b, p.ch0, mr, rr, sr, hr);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) mr[i] = rr[i] = sr[i] = hr[i] = 0.f;
  }
  const float nf = (float)g.n;
  const float* sm = sums + (long long)b * kSums * g.c + p.ch0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mg[i] = sm[i] / nf;
    qa[i] = rs[i] * (sm[g.c + i] / nf);
    qr[i] = kForm == 2 ? rr[i] * (sm[2 * g.c + i] / nf) : 0.f;
  }
  const long long off = (long long)b * g.n * g.c + p.ch0;
  const long long step = (long long)g.rows;
  for (long long v = p.v0 + p.r; v < p.v1; v += kUnroll * step) {
    float av[kUnroll][V], dv[kUnroll][V], rv[kUnroll][V] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = off + (v + u * step) * g.c;
      if (v + u * step < p.v1) {
        load_vec<T, V>(a + e, av[u]);
        load_vec<T, V>(dy + e, dv[u]);
        if (kForm != 0) load_vec<T, V>(r + e, rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = off + (v + u * step) * g.c;
      if (v + u * step < p.v1) {
        float oa[V], orr[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float x =
              pre_act<kForm>(av[u][i], rv[u][i], sa[i], ha[i], sr[i], hr[i]);
          const float gg = x > 0.f ? dv[u][i] : dv[u][i] * kSlope;
          oa[i] = sa[i] * (gg - mg[i] - (av[u][i] - mu[i]) * qa[i]);
          orr[i] = kForm == 2
                       ? sr[i] * (gg - mg[i] - (rv[u][i] - mr[i]) * qr[i])
                       : gg;
        }
        store_vec<T, V>(da + e, oa);
        if (kForm != 0) store_vec<T, V>(dr + e, orr);
      }
    }
  }
}

// The geometry of a plan, or false where the plan does not fit the shape.
bool make_geo(int b, long long n, int c, int dtype, int vec, int gw,
              int chunks, int ntens, Geo* g) {
  if (dtype != kBf16 && dtype != kF16 && dtype != kF32) return false;
  const int width = dtype == kF32 ? 4 : 8;
  if (b < 1 || b > 65535 || n < 1 || c < 1 || chunks < 1 || gw < 1 ||
      gw > kMaxGroup || (vec != 1 && vec != width) || c % vec != 0)
    return false;
  const int vpr = c / vec;
  g->n = n;
  g->b = b;
  g->c = c;
  g->gw = gw;
  g->groups = (vpr + gw - 1) / gw;
  g->rows = kThreads / gw;
  g->chunks = chunks;
  g->csize = (n + chunks - 1) / chunks;
  return (long long)g->groups * ntens <= 65535;
}

template <class T, int V>
cudaError_t forward(const void* a, const void* r, const float* ga,
                    const float* ba, const float* gr, const float* br,
                    float* part, float* stats, void* y, int form,
                    const Geo& g, float eps, cudaStream_t st) {
  const int ntens = form == 2 ? 2 : 1;
  const T* ta = static_cast<const T*>(a);
  const T* tr = static_cast<const T*>(r);
  instance_norm_stats_kernel<T, V>
      <<<dim3(g.chunks, g.b, g.groups * ntens), kThreads, 0, st>>>(
          ta, tr, part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_norm_merge_kernel<<<dim3((g.c + 31) / 32, g.b, ntens), dim3(32, 8),
                               0, st>>>(part, stats, g, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || y == nullptr) return err;
  const dim3 grid(g.chunks, g.b, g.groups);
  T* ty = static_cast<T*>(y);
  if (form == 0)
    instance_norm_act_kernel<T, V, 0>
        <<<grid, kThreads, 0, st>>>(ta, tr, stats, ga, ba, gr, br, ty, g);
  else if (form == 1)
    instance_norm_act_kernel<T, V, 1>
        <<<grid, kThreads, 0, st>>>(ta, tr, stats, ga, ba, gr, br, ty, g);
  else
    instance_norm_act_kernel<T, V, 2>
        <<<grid, kThreads, 0, st>>>(ta, tr, stats, ga, ba, gr, br, ty, g);
  return cudaGetLastError();
}

template <class T, int V, int kForm>
cudaError_t backward_form(const T* a, const T* r, const T* dy,
                          const float* stats, const float* ga,
                          const float* ba, const float* gr, const float* br,
                          float* part, float* sums, float* dparams, T* da,
                          T* dr, const Geo& g, cudaStream_t st) {
  constexpr int kSums = kForm == 2 ? 3 : 2;
  const dim3 grid(g.chunks, g.b, g.groups);
  instance_norm_bwd_reduce_kernel<T, V, kForm>
      <<<grid, kThreads, 0, st>>>(a, r, dy, stats, ga, ba, gr, br, part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_norm_bwd_finish_kernel<<<(g.c + 31) / 32, dim3(32, 8), 0, st>>>(
      part, sums, dparams, kSums, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  instance_norm_bwd_apply_kernel<T, V, kForm><<<grid, kThreads, 0, st>>>(
      a, r, dy, stats, ga, ba, gr, br, sums, da, dr, g);
  return cudaGetLastError();
}

template <class T, int V>
cudaError_t backward(const void* a, const void* r, const void* dy,
                     const float* stats, const float* ga, const float* ba,
                     const float* gr, const float* br, float* part,
                     float* sums, float* dparams, void* da, void* dr,
                     int form, const Geo& g, cudaStream_t st) {
  const T* ta = static_cast<const T*>(a);
  const T* tr = static_cast<const T*>(r);
  const T* td = static_cast<const T*>(dy);
  T* tda = static_cast<T*>(da);
  T* tdr = static_cast<T*>(dr);
  if (form == 0)
    return backward_form<T, V, 0>(ta, tr, td, stats, ga, ba, gr, br, part,
                                  sums, dparams, tda, tdr, g, st);
  if (form == 1)
    return backward_form<T, V, 1>(ta, tr, td, stats, ga, ba, gr, br, part,
                                  sums, dparams, tda, tdr, g, st);
  return backward_form<T, V, 2>(ta, tr, td, stats, ga, ba, gr, br, part,
                                sums, dparams, tda, tdr, g, st);
}

}  // namespace
}  // namespace medseg

// Forward of `form` (0, 1, 2; above) for a, r (B, N, C) of `dtype`, gamma,
// beta, r_gamma, r_beta (C) fp32 (r's only in form 2): part (ntens, chunks,
// B, 2, C) fp32 scratch, stats (ntens, 2, B, C) fp32 out (mean, rstd of a,
// then of r in form 2), y (B, N, C) out; y NULL: the statistics alone (form
// 0). vec, gw, chunks: the plan.
extern "C" int medseg_instance_norm_fwd(
    const void* a, const void* r, const void* gamma, const void* beta,
    const void* r_gamma, const void* r_beta, void* part, void* stats, void* y,
    int form, int b, long long n, int c, int dtype, int vec, int gw,
    int chunks, float eps, void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geo g;
  if (form < 0 || form > 2 || a == nullptr || part == nullptr ||
      stats == nullptr || (form != 0 && (r == nullptr || y == nullptr)) ||
      (y != nullptr && (gamma == nullptr || beta == nullptr)) ||
      (form == 2 && (r_gamma == nullptr || r_beta == nullptr)) ||
      !make_geo(b, n, c, dtype, vec, gw, chunks, form == 2 ? 2 : 1, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* ga = static_cast<const float*>(gamma);
  const float* ba = static_cast<const float*>(beta);
  const float* gr = static_cast<const float*>(r_gamma);
  const float* br = static_cast<const float*>(r_beta);
  float* pf = static_cast<float*>(part);
  float* sf = static_cast<float*>(stats);
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    constexpr int kW = 16 / sizeof(T);
    return static_cast<int>(
        vec == 1 ? forward<T, 1>(a, r, ga, ba, gr, br, pf, sf, y, form, g,
                                 eps, st)
                 : forward<T, kW>(a, r, ga, ba, gr, br, pf, sf, y, form, g,
                                  eps, st));
  });
}

// Backward of `form` for the forward's a, r, stats and parameters and dy
// (B, N, C): part (chunks, B, 3, C) and sums (B, 3, C) fp32 scratch, dparams
// (3, C) fp32 out (dgamma, dbeta, r's dgamma in form 2), da and (forms 1, 2)
// dr (B, N, C) out.
extern "C" int medseg_instance_norm_bwd(
    const void* a, const void* r, const void* dy, const void* stats,
    const void* gamma, const void* beta, const void* r_gamma,
    const void* r_beta, void* part, void* sums, void* dparams, void* da,
    void* dr, int form, int b, long long n, int c, int dtype, int vec, int gw,
    int chunks, void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geo g;
  if (form < 0 || form > 2 || a == nullptr || dy == nullptr ||
      stats == nullptr || gamma == nullptr || beta == nullptr ||
      part == nullptr || sums == nullptr || dparams == nullptr ||
      da == nullptr || (form != 0 && (r == nullptr || dr == nullptr)) ||
      (form == 2 && (r_gamma == nullptr || r_beta == nullptr)) ||
      !make_geo(b, n, c, dtype, vec, gw, chunks, 1, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sf = static_cast<const float*>(stats);
  const float* ga = static_cast<const float*>(gamma);
  const float* ba = static_cast<const float*>(beta);
  const float* gr = static_cast<const float*>(r_gamma);
  const float* br = static_cast<const float*>(r_beta);
  float* pf = static_cast<float*>(part);
  float* smf = static_cast<float*>(sums);
  float* dpf = static_cast<float*>(dparams);
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    constexpr int kW = 16 / sizeof(T);
    return static_cast<int>(
        vec == 1 ? backward<T, 1>(a, r, dy, sf, ga, ba, gr, br, pf, smf, dpf,
                                  da, dr, form, g, st)
                 : backward<T, kW>(a, r, dy, sf, ga, ba, gr, br, pf, smf, dpf,
                                   da, dr, form, g, st));
  });
}
