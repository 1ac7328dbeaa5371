// Fused SegFormer spatial-reduction attention, forward (inference): K7.
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/sr_attention.py:
// fused_sr_attention (_kernel). Per token of x (B, N, C), already
// LayerNorm'ed by the block: q = x . Wq^T (fp32 accumulation, + bq in fp32,
// then bf16) -> per head logits q . k^T in fp32, scaled AFTER the dot by
// hd^-0.5 -> fp32 softmax over the M reduced keys -> bf16 -> . V -> heads
// concatenated, bf16 -> output projection (+ bproj in fp32, then bf16) ->
// optional bf16 add of the block's raw input. K and V (B, M, C) come in
// precomputed (the spatial-reduction conv, its LayerNorm and the kv dense
// over M tokens stay outside, as in the TPU kernel). The rounding points are
// the TPU kernel's. The element type T of the tokens, K, V and the weights
// is bf16, fp16 or fp32 (the JAX kernel takes its input's dtype): "bf16"
// above stands for T.
//
// Two routes, picked by the wrapper from the dtype and the shape alone
// (ops/kernels/sr_attention.py sr_route):
//
// * Tensor cores (sr_attention_tc; bf16 and fp16 at head dim 16 with
//   M <= 64 reduced keys and C <= 384: every SegFormer3D stage).
//   mma.sync m16n8k16 with fp32 accumulation (mma_tile.cuh). Four warps, a
//   16-token strip a warp, token tiles of up to 64 rows. Per strip and head
//   h: q_h = x . Wq[h]^T is one 16-column product; its fp32 C fragments,
//   + bq and rounded to T, are the A operand of S = q_h . K_h^T (head dim 16
//   is one k-step; M padded to 16s, padded keys at -inf); the softmax runs
//   in registers and P, rounded to T, is the A operand of P . V_h; o_h,
//   rounded to T, is kept as an A fragment: exactly one k-step of the output
//   projection. So out += o_h . Wproj[:, h]^T accumulates in fp32 registers
//   (column chunks of <= 96) and the attention output never goes to shared
//   or device memory. The epilogue adds bproj, rounds once, adds the
//   shortcut in T and stores whole rows in 16-byte pieces.
//   A block owns a group of heads (groups divide the nh heads as evenly as
//   they can, at most 6 heads a group), and the groups of one token tile are
//   the blocks of one thread-block cluster. With one group the clusters are
//   single blocks. With several (the narrow stages: N <= one tile at stage 4,
//   four tiles at stage 3, so that B x tiles blocks could not fill the card)
//   each block writes its heads' partial projection (fp32, no bias) to its
//   shared memory; after a cluster barrier block r adds the partials of
//   columns [r C / G, (r + 1) C / G) over the G blocks in rank order through
//   distributed shared memory, then bproj, the single rounding and the
//   shortcut. The sum order inside the projection changes with G, the
//   function does not, and a rerun is bit-equal.
//   Clusters are persistent: as many as are resident at once, each walking a
//   contiguous run of (batch element, token tile) items, so that Wq's rows
//   and Wproj's columns of the group are copied once a block (cp.async), K_h
//   and V_h once per batch element, and, where two token tiles fit, the next
//   tile is in flight (cp.async) while the current one is computed.
//   ops/kernels/sr_attention.py sr_plan picks the tile rows, the groups and
//   the slots; the entry point checks them.
// * CUDA cores (sr_attention_kernel; fp32, other head dims, M > 64 or
//   C > 384). One block owns a tile of 32 (or 16) tokens of one batch
//   element (grid = tiles x B); the token tile and its q sit in shared
//   memory in fp32. Wq and Wproj do not fit (295 KB each at C = 384), so
//   both projections walk their output columns in chunks of 32 (or 16): a
//   chunk's weight rows are staged, thread (column, token) takes one full
//   dot product, and the chunk of outputs goes through a small tile so that
//   device memory sees whole rows. K and V stream through shared memory in
//   chunks of up to 128 reduced keys (sr_cc_plan picks rows, keys and
//   columns so that a block fits the card's 227 KB whatever M is). Between the projections a warp takes one
//   (token, head) pair at a time, lanes over the keys for the logits and
//   the softmax, then over the head's channels for . V. Where one chunk
//   holds every key (M = 27 at every stage, up to M = 66 at C = 384 in
//   bf16) that is one pass. Otherwise a first sweep over the chunks keeps
//   each pair's running max and sum (online softmax, fp32); a second stages
//   K and V again, recomputes the logits, forms p = T(exp(s - max) / sum) at
//   the rounding point of the one-pass form and adds p . V, in key order,
//   into an fp32 accumulator that overwrites the token tile; it is rounded
//   to T once all chunks are in. So only the order of the softmax's fp32
//   sum changes with the chunking; the logits are computed twice.
// N is never padded on either route: the last tile masks its tail (the TPU
// wrapper pads N to a multiple of 256).
//
// What bounds it on the card: by its counts, bytes at the first stage (C =
// 48, N = 13,824, batch 16: x, the shortcut and the output are 21 MB each
// against 2.6 GFLOP) and operations from C = 192 on, where the weights and
// the small grids make fixed costs (one tile of 27 tokens a batch element at
// stage 4) the floor. The CUDA-core route runs its products in fp32 from
// shared memory and re-reads the weights from L2 for every 32 tokens: at
// stage 4 it ran 16 blocks on 132 SMs and lost to its plain version
// (PERF.md, its K7 row). The tensor-core route answers with the products on
// mma.sync, the weights staged once a block, and the head split.

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mlp_tile.cuh"
#include "mma_tile.cuh"

// MEDSEG_SR_SKIP: parts of the tensor-core route compiled out, for
// chip_smoke.py's sr_parts phase only (0, nothing skipped, in the library;
// the results of a variant are wrong by design): 1 the copies of the token
// tiles, K and V, 2 the softmax's elementwise work, 4 the output
// projection's products, 8 the epilogue (stores, and with several groups
// the cluster's sum of partials). A variant starts from zeroed shared
// memory.
#ifndef MEDSEG_SR_SKIP
#define MEDSEG_SR_SKIP 0
#endif

namespace medseg {
namespace {

constexpr int kMaxHD = 32;   // largest head dim (one lane per channel in . V)
constexpr int kMaxKeys = 128;  // reduced keys of a K/V chunk

template <class T>
struct SrParams {
  const T* x;                  // (B, N, C) LayerNorm'ed tokens
  const T* k;                  // (B, M, C), head-major hd blocks
  const T* v;                  // (B, M, C)
  const T* wq;                 // (C, C) [out, in]
  const float* bq;             // (C) or nullptr
  const T* wproj;              // (C, C) [out, in]
  const float* bproj;          // (C)
  const T* res;                // (B, N, C) or nullptr
  T* out;                      // (B, N, C)
  int n, m, c, nh;
  int keys;                    // reduced keys of a K/V chunk
  float scale;
};

// dst[r][j0 + j] (or global rows) = round_T(src[r] . w[j0 + j] + b) for a
// chunk of kOC output columns: stage the weight rows, one dot per thread.
// ``src`` is the fp32 tile (kR x (c + 1)); the result lands in ``tile``
// (kR x (kOC + 1)) and the caller moves it on.
template <class T, int kOC, int kR>
__device__ __forceinline__ void project_chunk(const float* src, int c,
                                              const T* w, const float* b,
                                              int j0, T* ws, float* tile) {
  const int tid = threadIdx.x;
  const int s_stride = c + 1, t_stride = kOC + 1;
  for (int e = tid; e < kOC * c; e += kThreads) {
    const int j = e / c;
    ws[e] = j0 + j < c ? w[(size_t)j0 * c + e] : from_f32<T>(0.f);
  }
  __syncthreads();
  // token index across lanes: conflict-free src rows (odd stride), the
  // weight read is a broadcast
  for (int e = tid; e < kOC * kR; e += kThreads) {
    const int j = e / kR, r = e - j * kR;
    float a = 0.f;
    if (j0 + j < c) {
      const float* sr = src + r * s_stride;
      const T* wr = ws + j * c;
#pragma unroll 8
      for (int ch = 0; ch < c; ++ch) a += sr[ch] * to_f32(wr[ch]);
      a = round_to<T>(a + (b != nullptr ? b[j0 + j] : 0.f));
    }
    tile[r * t_stride + j] = a;
  }
  __syncthreads();
}

// Keys [k0, k0 + kk) of batch element b into ks (and, with vs, vs), rows of
// c + 2 elements.
template <class T>
__device__ __forceinline__ void stage_keys(const SrParams<T>& p, int b, int k0,
                                           int kk, T* ks, T* vs) {
  const int c = p.c, kv_stride = c + 2;
  for (int e = threadIdx.x; e < kk * c; e += kThreads) {
    const int mm = e / c, ch = e - mm * c;
    const size_t at = ((size_t)b * p.m + k0 + mm) * c + ch;
    ks[mm * kv_stride + ch] = p.k[at];
    if (vs != nullptr) vs[mm * kv_stride + ch] = p.v[at];
  }
}

// The scaled logits of query row q (hd channels, fp32) against the staged
// keys of head h, one key a lane, into pr; returns the lane's largest.
template <class T>
__device__ __forceinline__ float chunk_logits(const float* qr, const T* ks,
                                              int kv_stride, int h, int hd,
                                              int kk, float scale, float* pr) {
  float mx = -INFINITY;
  for (int mm = threadIdx.x & 31; mm < kk; mm += 32) {
    const T* kr = ks + mm * kv_stride + h * hd;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s += qr[d] * to_f32(kr[d]);
    s *= scale;
    pr[mm] = s;
    mx = fmaxf(mx, s);
  }
  return mx;
}

// Grid (token tiles of kR, B). With one K/V chunk (keys >= M) the chunk's
// logits, softmax and . V run as one pass a (token, head) pair. With more,
// the first sweep over the chunks keeps each pair's running max and sum in
// shared memory (online softmax, fp32), and the second stages K and V again,
// forms p = T(exp(s - max) / sum) (the logits recomputed as in the first)
// and adds p . V into an fp32 accumulator in the token tile, in key order.
template <class T, int kOC, int kR>
__global__ void __launch_bounds__(kThreads)
    sr_attention_kernel(SrParams<T> p) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, c = p.c, nh = p.nh, hd = c / nh;
  const int keys = p.keys, chunks = (m + keys - 1) / keys;
  const int xs_stride = c + 1, kv_stride = c + 2, t_stride = kOC + 1;
  float* xs = smem;                          // kR x (c + 1): x, then attn out
  float* qs = xs + kR * xs_stride;           // kR x (c + 1)
  float* tile = qs + kR * xs_stride;         // kR x (kOC + 1)
  float* prow = tile + kR * t_stride;        // kWarps x keys
  float* stats = prow + kWarps * keys;       // kR x nh x (max, sum), chunks > 1
  T* ws = reinterpret_cast<T*>(stats + (chunks > 1 ? 2 * kR * nh : 0));
  T* ks = ws + kOC * c;                      // keys x (c + 2)
  T* vs = ks + keys * kv_stride;             // keys x (c + 2)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kR;
  const int rows = min(kR, n - r0);
  const size_t tok0 = (size_t)b * n + r0;

  for (int e = tid; e < kR * c; e += kThreads) {
    const int r = e / c, ch = e - r * c;
    xs[r * xs_stride + ch] = r < rows ? ld(p.x + (tok0 + r) * c + ch) : 0.f;
  }
  if (chunks == 1) stage_keys(p, b, 0, m, ks, vs);
  __syncthreads();

  // q = bf16(x . Wq^T + bq)
  for (int j0 = 0; j0 < c; j0 += kOC) {
    project_chunk<T, kOC, kR>(xs, c, p.wq, p.bq, j0, ws, tile);
    for (int e = tid; e < kR * kOC; e += kThreads) {
      const int r = e / kOC, j = e - r * kOC;
      if (j0 + j < c) qs[r * xs_stride + j0 + j] = tile[r * t_stride + j];
    }
  }
  __syncthreads();

  // one (token, head) pair per warp at a time; the attention output
  // overwrites the token tile (x is no longer needed)
  float* pr = prow + warp * keys;
  if (chunks == 1) {
    for (int pair = warp; pair < rows * nh; pair += kWarps) {
      const int r = pair / nh, h = pair - r * nh;
      const float mx = warp_max(chunk_logits(qs + r * xs_stride + h * hd, ks,
                                             kv_stride, h, hd, m, p.scale,
                                             pr));
      float sum = 0.f;
      for (int mm = lane; mm < m; mm += 32) {
        const float e = expf(pr[mm] - mx);
        pr[mm] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int mm = lane; mm < m; mm += 32) pr[mm] = round_to<T>(pr[mm] / sum);
      __syncwarp();
      if (lane < hd) {
        const T* vc = vs + h * hd + lane;
        float a = 0.f;
        for (int mm = 0; mm < m; ++mm) a += pr[mm] * to_f32(vc[mm * kv_stride]);
        xs[r * xs_stride + h * hd + lane] = round_to<T>(a);
      }
      __syncwarp();
    }
  } else {
    for (int e = tid; e < rows * nh; e += kThreads) {
      stats[2 * e] = -INFINITY;
      stats[2 * e + 1] = 0.f;
    }
    for (int e = tid; e < kR * c; e += kThreads)
      xs[(e / c) * xs_stride + e % c] = 0.f;
    // sweep 1: the running max and sum of every pair
    for (int k0 = 0; k0 < m; k0 += keys) {
      const int kk = min(keys, m - k0);
      __syncthreads();
      stage_keys<T>(p, b, k0, kk, ks, nullptr);
      __syncthreads();
      for (int pair = warp; pair < rows * nh; pair += kWarps) {
        const int r = pair / nh, h = pair - r * nh;
        const float cm = warp_max(chunk_logits(qs + r * xs_stride + h * hd,
                                               ks, kv_stride, h, hd, kk,
                                               p.scale, pr));
        float cs = 0.f;
        for (int mm = lane; mm < kk; mm += 32) cs += expf(pr[mm] - cm);
        cs = warp_sum(cs);
        if (lane == 0) {
          const float m0 = stats[2 * pair], mn = fmaxf(m0, cm);
          stats[2 * pair + 1] =
              stats[2 * pair + 1] * expf(m0 - mn) + cs * expf(cm - mn);
          stats[2 * pair] = mn;
        }
        __syncwarp();
      }
    }
    // sweep 2: p and p . V
    for (int k0 = 0; k0 < m; k0 += keys) {
      const int kk = min(keys, m - k0);
      __syncthreads();
      stage_keys(p, b, k0, kk, ks, vs);
      __syncthreads();
      for (int pair = warp; pair < rows * nh; pair += kWarps) {
        const int r = pair / nh, h = pair - r * nh;
        chunk_logits(qs + r * xs_stride + h * hd, ks, kv_stride, h, hd, kk,
                     p.scale, pr);
        const float mx = stats[2 * pair], sum = stats[2 * pair + 1];
        for (int mm = lane; mm < kk; mm += 32)
          pr[mm] = round_to<T>(expf(pr[mm] - mx) / sum);
        __syncwarp();
        if (lane < hd) {
          const T* vc = vs + h * hd + lane;
          float* acc = xs + r * xs_stride + h * hd + lane;
          float a = *acc;
          for (int mm = 0; mm < kk; ++mm)
            a += pr[mm] * to_f32(vc[mm * kv_stride]);
          *acc = a;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int e = tid; e < kR * c; e += kThreads) {
      float* a = xs + (e / c) * xs_stride + e % c;
      *a = round_to<T>(*a);
    }
  }
  __syncthreads();

  // out = bf16(attn . Wproj^T + bproj) [+ res]
  for (int j0 = 0; j0 < c; j0 += kOC) {
    project_chunk<T, kOC, kR>(xs, c, p.wproj, p.bproj, j0, ws, tile);
    for (int e = tid; e < rows * kOC; e += kThreads) {
      const int r = e / kOC, j = e - r * kOC;
      if (j0 + j < c) {
        float y = tile[r * t_stride + j];
        const size_t o = (tok0 + r) * c + j0 + j;
        if (p.res != nullptr) y += ld(p.res + o);
        p.out[o] = from_f32<T>(y);
      }
    }
  }
}

// Dynamic shared memory of a CUDA-core block in bytes: the token tile and
// q (rows x (C + 1) fp32 each), a projection chunk's outputs (rows x
// (cols + 1) fp32), a logit row a warp, with several K/V chunks the running
// max and sum of each (token, head) pair (fp32), the chunk's weight rows
// (cols x C) and K and V (keys x (C + 2) each) in elements of elem bytes.
size_t sr_smem_bytes(int rows, int keys, int cols, int m, int c, int nh,
                     size_t elem) {
  const bool streamed = keys < m;
  return sizeof(float) * (2 * (size_t)rows * (c + 1) + rows * (cols + 1) +
                          kWarps * keys + (streamed ? 2 * rows * nh : 0)) +
         elem * ((size_t)cols * c + 2 * (size_t)keys * (c + 2));
}

size_t elem_size(int dtype) { return dtype == kF32 ? 4 : 2; }

// The CUDA-core plan: the most token rows (32, 16), then the most reduced
// keys a K/V chunk (all M up to 128 where they fit: one pass; else 64, 32,
// 16, 8), then the widest projection chunk (32, 16 columns) whose block fits
// the card's shared memory. *smem is that block's size; where no plan fits
// (C above ~900 in fp32) it is the smallest plan's and the result false.
bool sr_cc_plan(int m, int c, int nh, size_t elem, int* rows, int* keys,
                int* cols, size_t* smem) {
  const int top = m < kMaxKeys ? m : kMaxKeys;
  const int fewer[] = {64, 32, 16, 8};
  for (int r = 32; r >= 16; r /= 2) {
    for (int i = -1; i < 4; ++i) {
      const int k = i < 0 ? top : fewer[i];
      if (i >= 0 && k >= top) continue;
      for (int oc = 32; oc >= 16; oc /= 2) {
        *rows = r;
        *keys = k;
        *cols = oc;
        *smem = sr_smem_bytes(r, k, oc, m, c, nh, elem);
        if (*smem <= (size_t)mlptile::kMaxSmem) return true;
      }
    }
  }
  return false;
}

template <class T, int kOC, int kR>
int launch_sr(const SrParams<T>& p, int b, cudaStream_t st) {
  const size_t smem = sr_smem_bytes(kR, p.keys, kOC, p.m, p.c, p.nh,
                                    sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      sr_attention_kernel<T, kOC, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sr_attention_kernel<T, kOC, kR><<<dim3((p.n + kR - 1) / kR, b), kThreads,
                                    smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_sr_any(const SrParams<T>& p, int b, int rows, int cols,
                  cudaStream_t st) {
  if (rows == 32)
    return cols == 32 ? launch_sr<T, 32, 32>(p, b, st)
                      : launch_sr<T, 16, 32>(p, b, st);
  return cols == 32 ? launch_sr<T, 32, 16>(p, b, st)
                    : launch_sr<T, 16, 16>(p, b, st);
}

// ---- the tensor-core route ----

constexpr int kTcThreads = 128;   // four warps, a 16-token strip each
constexpr int kTcMaxRows = 64;    // token rows of a tile
constexpr int kTcMaxM = 64;       // reduced keys (padded to 16s)
constexpr int kTcMaxGroupHeads = 6;   // heads of a block
constexpr int kTcMaxGroups = 8;       // blocks of a cluster (portable size)
constexpr int kTcMaxC = 384;

template <class T>
struct SrTcParams {
  const T* x;
  const T* k;
  const T* v;
  const T* wq;
  const float* bq;
  const T* wproj;
  const float* bproj;
  const T* res;
  T* out;
  int n, m, c, nh;
  int rows;     // token rows of a tile: 16, 32, 48 or 64
  int groups;   // head groups = blocks of a cluster
  int slots;    // token tiles in shared memory (2: the next is in flight)
  int tiles;    // token tiles of a batch element
  int cw;       // output columns of a projection chunk (gemm_width(C))
  long long items;  // B x tiles
  float scale;
};

// Heads of group r of G over nh heads: [nh r / G, nh (r + 1) / G), at most
// ceil(nh / G) of them.
__host__ __device__ inline int group_head0(int nh, int g, int r) {
  return nh * r / g;
}

inline int round16(int v) { return (v + 15) / 16 * 16; }

// Whether the shortcut's tile is copied with the token tile (one group: its
// epilogue reads the shortcut from shared memory) or read in the cluster's
// sum (several groups).
__host__ __device__ inline bool res_staged(int groups, bool residual) {
  return groups == 1 && residual;
}

// Dynamic shared memory of a tensor-core block in bytes (elements of 2
// bytes): the token slots (rows x (C + 8)) and, where res_staged, as many
// shortcut slots, the group's Wq rows (16 hg x (C + 8)), its Wproj columns
// (C x (16 hg + 8)), K and V of its heads (Mp x (16 hg + 8) each) and, with
// several groups, the fp32 partial projection (rows x (C + 8)).
// ops/kernels/sr_attention.py sr_tc_smem_bytes computes the same.
size_t sr_tc_smem_bytes(int rows, int c, int nh, int groups, int m, int slots,
                        bool residual) {
  const int hg = (nh + groups - 1) / groups, xs = c + 8, ps = 16 * hg + 8;
  const int tiles = res_staged(groups, residual) ? 2 * slots : slots;
  const size_t t = (size_t)tiles * rows * xs + (size_t)16 * hg * xs +
                   (size_t)c * ps + (size_t)2 * round16(m) * ps;
  return 2 * t + (groups > 1 ? sizeof(float) * rows * xs : 0);
}

// Whether the tensor-core route takes this launch (the wrapper's sr_route
// and sr_plan give only such).
bool sr_tc_takes(int dtype, int n, int m, int c, int nh, int rows, int groups,
                 int slots, bool residual) {
  return (dtype == kBf16 || dtype == kF16) && nh >= 1 && c == 16 * nh &&
         c <= kTcMaxC && m >= 1 && m <= kTcMaxM && n >= 1 && rows >= 16 &&
         rows <= kTcMaxRows && rows % 16 == 0 && groups >= 1 &&
         groups <= kTcMaxGroups && groups <= nh &&
         (nh + groups - 1) / groups <= kTcMaxGroupHeads &&
         (slots == 1 || slots == 2) &&
         sr_tc_smem_bytes(rows, c, nh, groups, m, slots, residual) <=
             (size_t)mlptile::kMaxSmem;
}

// The (row, 16-byte piece) pairs of a rows x vecs tile that a thread visits
// when the pairs are dealt out `step` at a time from `first`, with no
// division a pair: the next pair follows from the last one.
struct PieceWalk {
  int r, v, dr, dv, vecs;
  __device__ __forceinline__ PieceWalk(int first, int step, int vecs_)
      : vecs(vecs_) {
    r = first / vecs;
    v = first - r * vecs;
    dr = step / vecs;
    dv = step - dr * vecs;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    v += dv;
    if (v >= vecs) {
      v -= vecs;
      ++r;
    }
  }
};

// mlptile::copy_rows_async (rows [0, nrows) x ncols columns into dst with
// row stride dld, 16-byte pieces by cp.async) with a PieceWalk.
template <class T>
__device__ __forceinline__ void copy_tile_async(const T* src, long long ld,
                                                int nrows, int ncols, T* dst,
                                                int dld) {
  for (PieceWalk w(threadIdx.x, blockDim.x, ncols / 8); w.r < nrows; w.next())
    mlptile::cp_async16(dst + w.r * dld + 8 * w.v, src + w.r * ld + 8 * w.v);
}

// Grid (groups, clusters), clusters of (groups, 1, 1) blocks; block rank r
// owns the heads of group r. See the header for the design. kMaxCW: the
// widest projection chunk; kNT: the key n-tiles a score strip holds (M up to
// 8 kNT), so that the main path (M = 27) keeps 16 scores a thread, not 32.
// The narrowest form (stage 1: C = 48, M = 27) is held to 128 registers, four
// blocks an SM: 144 registers on its own, three an SM, and 5 % slower
// (chip_smoke.py --phases sr_parts); the others spill at that cap and keep two.
template <class T, int kMaxCW, int kNT>
__global__ void __launch_bounds__(kTcThreads,
                                  kMaxCW == 48 && kNT == 4 ? 4 : 2)
    sr_attention_tc(SrTcParams<T> p) {
  using namespace mmatile;
  using namespace mlptile;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_sr[];
  const int c = p.c, nh = p.nh, m = p.m, rows = p.rows, G = p.groups;
  const int rank = blockIdx.x;
  const int h0 = group_head0(nh, G, rank);
  const int nhl = group_head0(nh, G, rank + 1) - h0;  // heads of this block
  const int hgmax = (nh + G - 1) / G;
  const int XS = c + 8, PS = 16 * hgmax + 8, mp = (m + 15) / 16 * 16;
  const int nt = mp / 8;
  const int cw = p.cw;
  const bool rstage = res_staged(G, p.res != nullptr);
  T* xs = reinterpret_cast<T*>(smem_sr);   // slots x rows x XS
  T* rs = xs + p.slots * rows * XS;        // as many shortcut slots (rstage)
  T* wq = rs + (rstage ? p.slots : 0) * rows * XS;  // 16 hgmax x XS: Wq rows
  T* wp = wq + 16 * hgmax * XS;            // c x PS: Wproj columns of the group
  T* ks = wp + c * PS;                     // mp x PS
  T* vs = ks + mp * PS;                    // mp x PS
  float* part = reinterpret_cast<float*>(vs + mp * PS);  // rows x XS (G > 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  if (MEDSEG_SR_SKIP) {
    zero_smem(smem_sr, reinterpret_cast<unsigned char*>(part) - smem_sr);
    __syncthreads();
  }
  // this cluster's items: a contiguous run of (batch element, token tile)
  const long long i0 = p.items * blockIdx.y / gridDim.y;
  const long long i1 = p.items * (blockIdx.y + 1) / gridDim.y;

  // the token tile of an item into a slot (and, where rstage, the
  // shortcut's); token rows past its end are zero
  auto stage_x = [&](long long item, int slot) {
    if (MEDSEG_SR_SKIP & 1) return;
    const int bi = (int)(item / p.tiles), r0 = (int)(item % p.tiles) * rows;
    const int nr = min(rows, p.n - r0);
    T* dst = xs + slot * rows * XS;
    const size_t at = ((size_t)bi * p.n + r0) * c;
    copy_tile_async(p.x + at, c, nr, c, dst, XS);
    if (rstage)
      copy_tile_async(p.res + at, c, nr, c, rs + slot * rows * XS, XS);
    const int vecs = c / 8, pad = (nr + 15) / 16 * 16 - nr;
    for (int e = tid; e < pad * vecs; e += blockDim.x) {
      const int r = nr + e / vecs, v8 = (e % vecs) * 8;
      *reinterpret_cast<uint4*>(dst + r * XS + v8) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // K_h and V_h of the group's heads for batch element bi; keys past m are
  // zero (P is 0 there, and 0 . V must stay 0)
  auto stage_kv = [&](int bi) {
    if (MEDSEG_SR_SKIP & 1) return;
    const size_t at = (size_t)bi * m * c + 16 * h0;
    copy_tile_async(p.k + at, c, m, 16 * nhl, ks, PS);
    copy_tile_async(p.v + at, c, m, 16 * nhl, vs, PS);
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    for (int e = tid; e < (mp - m) * 2 * nhl; e += blockDim.x) {
      const int key = m + e / (2 * nhl), v8 = (e % (2 * nhl)) * 8;
      *reinterpret_cast<uint4*>(ks + key * PS + v8) = zero4;
      *reinterpret_cast<uint4*>(vs + key * PS + v8) = zero4;
    }
  };

  // the group's weights, once a block: Wq rows 16 h0 .., all Wproj rows at
  // the group's columns; with the first item's token tile, K and V
  copy_tile_async(p.wq + (size_t)16 * h0 * c, c, 16 * nhl, c, wq, XS);
  copy_tile_async(p.wproj + 16 * h0, c, c, 16 * nhl, wp, PS);
  int kv_b = -1;
  if (i0 < i1) {
    stage_x(i0, 0);
    kv_b = (int)(i0 / p.tiles);
    stage_kv(kv_b);
  }
  cp_async_commit();

  for (long long it = i0; it < i1; ++it) {
    const int slot = p.slots == 2 ? (int)((it - i0) & 1) : 0;
    if (p.slots == 2 && it + 1 < i1) {
      stage_x(it + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int bi = (int)(it / p.tiles), r0 = (int)(it % p.tiles) * rows;
    const int nr = min(rows, p.n - r0);
    if (bi != kv_b) {   // a block's run of items crosses a batch element
      stage_kv(bi);
      cp_async_commit();
      cp_async_wait<0>();
      kv_b = bi;
    }
    __syncthreads();

    T* xt = xs + slot * rows * XS;
    if (16 * warp < nr) {
      // attention of every head of the group: o_h as A fragments
      uint32_t oa[kTcMaxGroupHeads][4];
      const T* a_row = xt + (16 * warp + (lane & 15)) * XS + (lane >> 4) * 8;
      const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * XS +
                        ((lane >> 3) & 1) * 8;
      const int kb_off = ((lane & 7) + ((lane >> 4) << 3)) * PS +
                         ((lane >> 3) & 1) * 8;
      const int vb_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PS +
                         (lane >> 4) * 8;
#pragma unroll
      for (int hl = 0; hl < kTcMaxGroupHeads; ++hl) {
        if (hl < nhl) {
          // q_h = T(x . Wq[h]^T + bq), the k-steps in two chains (even,
          // odd) so that the dependent mma are half as many in a row
          float q[2][4], q2[2][4];
          zero(q[0]);
          zero(q[1]);
          zero(q2[0]);
          zero(q2[1]);
          const T* b_row = wq + 16 * hl * XS + b_off;
          const int ksteps = c / 16;
#pragma unroll 2
          for (int kk = 0; kk + 1 < ksteps; kk += 2) {
            uint32_t a[4], b[4], a2[4], b2[4];
            ldsm_x4(a, a_row + 16 * kk);
            ldsm_x4(b, b_row + 16 * kk);
            ldsm_x4(a2, a_row + 16 * kk + 16);
            ldsm_x4(b2, b_row + 16 * kk + 16);
            mma<T>(q[0], a, b[0], b[1]);
            mma<T>(q[1], a, b[2], b[3]);
            mma<T>(q2[0], a2, b2[0], b2[1]);
            mma<T>(q2[1], a2, b2[2], b2[3]);
          }
          if (ksteps & 1) {
            uint32_t a[4], b[4];
            ldsm_x4(a, a_row + 16 * (ksteps - 1));
            ldsm_x4(b, b_row + 16 * (ksteps - 1));
            mma<T>(q[0], a, b[0], b[1]);
            mma<T>(q[1], a, b[2], b[3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            q[0][e] += q2[0][e];
            q[1][e] += q2[1][e];
          }
          if (p.bq != nullptr) {
            const float* bqh = p.bq + 16 * (h0 + hl) + 2 * t4;
            const float2 b0 = *reinterpret_cast<const float2*>(bqh);
            const float2 b1 = *reinterpret_cast<const float2*>(bqh + 8);
            q[0][0] += b0.x; q[0][1] += b0.y; q[0][2] += b0.x; q[0][3] += b0.y;
            q[1][0] += b1.x; q[1][1] += b1.y; q[1][2] += b1.x; q[1][3] += b1.y;
          }
          uint32_t qa[4];
          c_to_a<T>(qa, q[0], q[1]);
          // logits in fp32, scaled after the dot; keys past m at -inf
          float sc[kNT][4];
          const T* k_row = ks + 16 * hl + kb_off;
#pragma unroll
          for (int pp = 0; pp < kNT / 2; ++pp) {
            if (2 * pp < nt) {
              uint32_t b[4];
              ldsm_x4(b, k_row + 16 * pp * PS);
              zero(sc[2 * pp]);
              zero(sc[2 * pp + 1]);
              mma<T>(sc[2 * pp], qa, b[0], b[1]);
              mma<T>(sc[2 * pp + 1], qa, b[2], b[3]);
            }
          }
          if (!(MEDSEG_SR_SKIP & 2)) {
            // the exact two-step softmax of rows g and g + 8 in fp32 over
            // the scaled logits s * scale: the max over s (scale > 0), then
            // exp(s scale - max scale) = 2^(s sl - max sl), sl = scale log2 e
            float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              if (j < nt) {
                if (8 * j + 8 > m) {  // the tile holds keys past m
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    if (8 * j + 2 * t4 + (e & 1) >= m) sc[j][e] = -INFINITY;
                }
                m0 = fmaxf(m0, fmaxf(sc[j][0], sc[j][1]));
                m1 = fmaxf(m1, fmaxf(sc[j][2], sc[j][3]));
              }
            }
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
            m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
            m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
            const float sl = p.scale * 1.4426950408889634f;
            const float o0 = -m0 * sl, o1 = -m1 * sl;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              if (j < nt) {
                sc[j][0] = exp2f(fmaf(sc[j][0], sl, o0));
                sc[j][1] = exp2f(fmaf(sc[j][1], sl, o0));
                sc[j][2] = exp2f(fmaf(sc[j][2], sl, o1));
                sc[j][3] = exp2f(fmaf(sc[j][3], sl, o1));
                s0 += sc[j][0] + sc[j][1];
                s1 += sc[j][2] + sc[j][3];
              }
            }
            s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
            s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
            s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
            s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
            const float i0s = 1.f / s0, i1s = 1.f / s1;
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              if (j < nt) {
                sc[j][0] *= i0s;
                sc[j][1] *= i0s;
                sc[j][2] *= i1s;
                sc[j][3] *= i1s;
              }
            }
          }
          // o_h = T(T(P) . V_h): P's C fragments are the A operand
          float o[2][4];
          zero(o[0]);
          zero(o[1]);
          const T* v_row = vs + 16 * hl + vb_off;
#pragma unroll
          for (int i = 0; i < kNT / 2; ++i) {
            if (2 * i < nt) {
              uint32_t a[4], b[4];
              c_to_a<T>(a, sc[2 * i], sc[2 * i + 1]);
              ldsm_x4_t(b, v_row + 16 * i * PS);
              mma<T>(o[0], a, b[0], b[1]);
              mma<T>(o[1], a, b[2], b[3]);
            }
          }
          c_to_a<T>(oa[hl], o[0], o[1]);
        }
      }

      // out = o . Wproj^T over the group's heads (one k-step a head), in
      // column chunks of cw; with one group the epilogue takes it from
      // here, with several the fp32 partial goes to shared memory
      T* ost = xt + 16 * warp * XS;   // the warp's own rows: x is spent
      const int w_off = ((lane & 7) + ((lane >> 4) << 3)) * PS +
                        ((lane >> 3) & 1) * 8;
      for (int j0 = 0; j0 < c; j0 += cw) {
        float acc[kMaxCW / 8][4];
#pragma unroll
        for (int j = 0; j < kMaxCW / 8; ++j) zero(acc[j]);
        if (!(MEDSEG_SR_SKIP & 4)) {
          const T* w_row = wp + j0 * PS + w_off;
#pragma unroll
          for (int hl = 0; hl < kTcMaxGroupHeads; ++hl) {
            if (hl < nhl) {
#pragma unroll
              for (int qq = 0; qq < kMaxCW / 16; ++qq) {
                if (16 * qq < cw) {
                  uint32_t b[4];
                  ldsm_x4(b, w_row + 16 * qq * PS + 16 * hl);
                  mma<T>(acc[2 * qq], oa[hl], b[0], b[1]);
                  mma<T>(acc[2 * qq + 1], oa[hl], b[2], b[3]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxCW / 8; ++j) {
          if (8 * j < cw) {
            const int col = j0 + 8 * j + 2 * t4;
            if (G == 1) {
              const float2 bb =
                  *reinterpret_cast<const float2*>(p.bproj + col);
              *reinterpret_cast<uint32_t*>(ost + g * XS + col) =
                  pack<T>(acc[j][0] + bb.x, acc[j][1] + bb.y);
              *reinterpret_cast<uint32_t*>(ost + (g + 8) * XS + col) =
                  pack<T>(acc[j][2] + bb.x, acc[j][3] + bb.y);
            } else {
              float* pr = part + (16 * warp + g) * XS + col;
              *reinterpret_cast<float2*>(pr) =
                  make_float2(acc[j][0], acc[j][1]);
              *reinterpret_cast<float2*>(pr + 8 * XS) =
                  make_float2(acc[j][2], acc[j][3]);
            }
          }
        }
      }
      if (G == 1 && !(MEDSEG_SR_SKIP & 8)) {
        // whole rows out in 16-byte pieces, + the shortcut in T
        __syncwarp();
        const int live = min(16, nr - 16 * warp);
        for (PieceWalk w(lane, 32, c / 8); w.r < live; w.next()) {
          const int r = w.r, v8 = 8 * w.v;
          const size_t at = ((size_t)bi * p.n + r0 + 16 * warp + r) * c + v8;
          uint4 y = *reinterpret_cast<const uint4*>(ost + r * XS + v8);
          if (p.res != nullptr) {
            const uint4 xv = *reinterpret_cast<const uint4*>(
                rs + (slot * rows + 16 * warp + r) * XS + v8);
            const T* yi = reinterpret_cast<const T*>(&y);
            const T* xi = reinterpret_cast<const T*>(&xv);
            uint4 sum;
            uint32_t* so = reinterpret_cast<uint32_t*>(&sum);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              so[i] = pack<T>(to_f32(yi[2 * i]) + to_f32(xi[2 * i]),
                              to_f32(yi[2 * i + 1]) + to_f32(xi[2 * i + 1]));
            y = sum;
          }
          *reinterpret_cast<uint4*>(p.out + at) = y;
        }
      }
    }

    if (G > 1) {
      // the partials of the cluster's blocks, added in rank order: block r
      // finishes the columns [r C / G, (r + 1) C / G) (in 8s) of the tile
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (!(MEDSEG_SR_SKIP & 8)) {
        const int vecs = c / 8;
        const int v0 = vecs * rank / G, nv = vecs * (rank + 1) / G - v0;
        for (int e = tid; e < nr * nv; e += blockDim.x) {
          const int r = e / nv, col = 8 * (v0 + e - r * nv);
          float s[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) s[i] = 0.f;
          for (int q = 0; q < G; ++q) {
            const float4* src = reinterpret_cast<const float4*>(
                cluster.map_shared_rank(part + r * XS + col, q));
            const float4 lo = src[0], hi = src[1];
            s[0] += lo.x; s[1] += lo.y; s[2] += lo.z; s[3] += lo.w;
            s[4] += hi.x; s[5] += hi.y; s[6] += hi.z; s[7] += hi.w;
          }
          const size_t at = ((size_t)bi * p.n + r0 + r) * c + col;
          uint4 y;
          uint32_t* yo = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            yo[i] = pack<T>(s[2 * i] + p.bproj[col + 2 * i],
                            s[2 * i + 1] + p.bproj[col + 2 * i + 1]);
          if (p.res != nullptr) {
            const uint4 xv = __ldg(reinterpret_cast<const uint4*>(p.res + at));
            const T* yi = reinterpret_cast<const T*>(&y);
            const T* xi = reinterpret_cast<const T*>(&xv);
            uint4 sum;
            uint32_t* so = reinterpret_cast<uint32_t*>(&sum);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              so[i] = pack<T>(to_f32(yi[2 * i]) + to_f32(xi[2 * i]),
                              to_f32(yi[2 * i + 1]) + to_f32(xi[2 * i + 1]));
            y = sum;
          }
          *reinterpret_cast<uint4*>(p.out + at) = y;
        }
      }
      cluster.sync();   // the partials are read before they are rewritten
    } else {
      __syncthreads();  // the slot and K, V are read before they are refilled
    }
    if (p.slots == 1 && it + 1 < i1) {
      stage_x(it + 1, 0);
      cp_async_commit();
    }
  }
}

// The clusters of (groups, 1, 1) blocks resident at once, per device,
// kernel, shared memory and cluster size, asked of the runtime once, when the
// kernel's dynamic shared memory limit is also raised to the card's: a call
// costs the host nothing more after the first.
template <class K>
cudaError_t resident_clusters(K kernel, cudaLaunchConfig_t* cfg,
                              int* clusters) {
  struct Entry {
    int dev;
    const void* fn;
    size_t smem;
    unsigned groups;
    int clusters;
  };
  static thread_local Entry cache[32];   // a launching thread's own
  static thread_local int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < used; ++i) {
    if (cache[i].dev == dev && cache[i].fn == fn &&
        cache[i].smem == cfg->dynamicSmemBytes &&
        cache[i].groups == cfg->gridDim.x) {
      *clusters = cache[i].clusters;
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mlptile::kMaxSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, kernel, cfg);
  if (err == cudaSuccess && used < 32)
    cache[used++] = {dev, fn, cfg->dynamicSmemBytes, cfg->gridDim.x,
                     *clusters};
  return err;
}

template <class T, int kMaxCW, int kNT>
cudaError_t launch_sr_tc_width(const SrTcParams<T>& p, cudaStream_t st) {
  auto kernel = sr_attention_tc<T, kMaxCW, kNT>;
  const size_t smem = sr_tc_smem_bytes(p.rows, p.c, p.nh, p.groups, p.m,
                                       p.slots, p.res != nullptr);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.groups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.groups, 1, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = resident_clusters(kernel, &cfg, &clusters);
  if (err != cudaSuccess) return err;
  cfg.gridDim.y = (unsigned)max(1LL, min(p.items, (long long)clusters));
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class T>
int launch_sr_tc(const SrTcParams<T>& p, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    const bool narrow = p.m <= 32;   // 4 key n-tiles
    return static_cast<int>(
        p.cw <= 48 ? (narrow ? launch_sr_tc_width<T, 48, 4>(p, st)
                             : launch_sr_tc_width<T, 48, 8>(p, st))
                   : (narrow ? launch_sr_tc_width<T, 96, 4>(p, st)
                             : launch_sr_tc_width<T, 96, 8>(p, st)));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // fp32: CUDA cores
  }
}

}  // namespace
}  // namespace medseg

// Shared memory of one CUDA-core block in bytes, for M reduced tokens of
// width C over nh heads and the element type named by dtype: that of the
// plan sr_cc_plan picks, or where none fits the card, the smallest plan's
// (over the limit).
extern "C" long long medseg_sr_attention_smem_bytes(int m, int c, int nh,
                                                    int dtype) {
  using namespace medseg;
  int rows, keys, cols;
  size_t smem = 0;
  sr_cc_plan(m, c, nh, elem_size(dtype), &rows, &keys, &cols, &smem);
  return (long long)smem;
}

// x, k, v, wq, wproj, res, out of the element type named by dtype; bq,
// bproj fp32. route: kRouteTensorCore (bf16 or fp16, C = 16 nh <= 384,
// m <= 64, and rows, groups, slots as ops/kernels/sr_attention.py sr_plan
// gives them; every pointer on a 16-byte boundary) or kRouteCudaCore (any
// dtype, head dim <= 32, any M, C where sr_cc_plan fits a block; rows,
// groups and slots are not read).
extern "C" int medseg_sr_attention_fwd(const void* x, const void* k,
                                       const void* v, const void* wq,
                                       const void* bq, const void* wproj,
                                       const void* bproj, const void* res,
                                       void* out, int b, int n, int m, int c,
                                       int nh, int rows, int groups, int slots,
                                       int route, int dtype, float scale,
                                       void* stream) {
  using namespace medseg;
  const int hd = nh > 0 ? c / nh : 0;
  int cc_rows = 0, keys = 0, cols = 0;
  size_t smem = 0;
  if (b < 1 || n < 1 || m < 1 || nh < 1 || hd * nh != c || hd > kMaxHD ||
      b > 65535 ||
      (route == kRouteTensorCore &&
       !sr_tc_takes(dtype, n, m, c, nh, rows, groups, slots,
                    res != nullptr)) ||
      (route == kRouteCudaCore &&
       !sr_cc_plan(m, c, nh, elem_size(dtype), &cc_rows, &keys, &cols,
                   &smem)) ||
      (route != kRouteTensorCore && route != kRouteCudaCore))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (route == kRouteTensorCore) {
      SrTcParams<T> p;
      p.x = static_cast<const T*>(x);
      p.k = static_cast<const T*>(k);
      p.v = static_cast<const T*>(v);
      p.wq = static_cast<const T*>(wq);
      p.bq = static_cast<const float*>(bq);
      p.wproj = static_cast<const T*>(wproj);
      p.bproj = static_cast<const float*>(bproj);
      p.res = static_cast<const T*>(res);
      p.out = static_cast<T*>(out);
      p.n = n; p.m = m; p.c = c; p.nh = nh;
      p.rows = rows; p.groups = groups; p.slots = slots;
      p.tiles = (n + rows - 1) / rows;
      p.cw = mlptile::gemm_width(c);
      p.items = (long long)b * p.tiles;
      p.scale = scale;
      return launch_sr_tc(p, st);
    }
    SrParams<T> p;
    p.x = static_cast<const T*>(x);
    p.k = static_cast<const T*>(k);
    p.v = static_cast<const T*>(v);
    p.wq = static_cast<const T*>(wq);
    p.bq = static_cast<const float*>(bq);
    p.wproj = static_cast<const T*>(wproj);
    p.bproj = static_cast<const float*>(bproj);
    p.res = static_cast<const T*>(res);
    p.out = static_cast<T*>(out);
    p.n = n; p.m = m; p.c = c; p.nh = nh; p.keys = keys; p.scale = scale;
    return launch_sr_any(p, b, cc_rows, cols, st);
  });
}
