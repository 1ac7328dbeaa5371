// Fused DiceCE loss: the sums of the forward and the logits' gradient, each
// in one pass over the logits.
//
// Replaces the TPU kernels of medicalsemseg_tpu/ops/pallas/dice_ce.py:
// _fwd_sums (_fwd_kernel) and the backward call of _fused_for (_bwd_kernel).
// For logits (B, M, C) fp32 and labels (B, M), with p = softmax over C, t
// the one-hot target (all zero where the label is outside [0, C)) and
// valid = label >= 0:
//   sums[b] = [ sum_m p.t | sum_m p^2.valid | sum_m t | sum_m -log(p).t ]
//   dlogits = p . (g - sum_c g.p) + ce . (p - t),  g = ca[b].t + cp[b].p
// as the JAX kernels compute them (their padding voxels carry label -1, so
// p^2 of a negative label is left out; a label of C or more still counts).
// The softmax is recomputed in the backward; the one-hot target exists only
// as a comparison against the label. The scalar algebra around the two
// (Dice ratio, means, the coefficients ca, cp, ce) is left to the caller.
//
// What bounds both: device-memory bytes (the forward reads the logits and
// the labels, the backward reads them and writes dlogits); neither has a
// product to speak of, in any dtype. The design keeps the memory system busy
// all the time:
//  - persistent blocks: grid (blocks, B), as many as are resident at once;
//    a block walks every blocks-th tile of 256 voxels of its batch element;
//  - a ring of kSlots = 3 tiles a block in shared memory, each filled by
//    Hopper's bulk asynchronous copy (cp.async.bulk, one thread issues it)
//    completing on the slot's mbarrier: while the block works on tile i,
//    tiles i + 1 and i + 2 are in flight. A tile's logits (256 C floats) and
//    labels are contiguous; the bulk copy needs 16-byte aligned ends, so it
//    copies the 16-byte aligned span around them (at most 15 bytes more on
//    either side, within the same aligned 16 bytes as a byte of the tensor)
//    and the readers skip the lead. So the labels arrive in 16-byte pieces
//    too;
//  - one thread a voxel: its row of C classes is read from shared memory
//    into registers sized by the template kC (16 or 32), softmax in fp32
//    with one FFMA and one ex2 a class (exp(x - max) = 2^(x log2 e - max
//    log2 e));
//  - forward: each thread keeps sum p^2 per class in registers over all its
//    voxels, and the three sums of its voxels' own classes (p.t, t, -log
//    p.t) in shared memory at [sum][class][thread] (conflict-free whatever
//    the label; a predicated add for every class would cost four
//    instructions a class); at the end the block adds them up (warp
//    shuffles, then the warps in order; the threads in order) into one slab
//    per block, and sum_partials adds the slabs in a fixed order (no
//    atomics: a second run is bit-equal);
//  - backward: each thread writes its row of dlogits over its logits in the
//    slot, dl_k = p_k (cp_k p_k - sum_j g_j p_j + ce) and, at the label,
//    + p ca - ce; then the block stores the tile with 16-byte vector
//    stores.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mlp_tile.cuh"

namespace medseg {
namespace {

constexpr int kVox = kThreads;   // voxels a tile, one a thread
constexpr int kSlots = 3;        // tiles in flight a block
constexpr int kMaxCls = 32;      // the widest register row
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) & ~(size_t)15;
}

// Bytes of a slot: the tile's logits, then its labels, each with room for
// the 16-byte aligned span around them.
__host__ __device__ inline size_t logits_bytes(int c) {
  return align16((size_t)kVox * c * 4 + 16);
}
__host__ __device__ inline size_t slot_bytes(int c, int lab_bytes) {
  return logits_bytes(c) + align16((size_t)kVox * lab_bytes + 16);
}

// The 16-byte aligned span [start, start + bytes) around `len` bytes at p.
__device__ __forceinline__ const char* span(const void* p, size_t len,
                                            uint32_t* bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t a0 = a & ~(uintptr_t)15;
  *bytes = (uint32_t)align16(a + len - a0);
  return reinterpret_cast<const char*>(a0);
}

// Elements of `size` bytes by which the data at p lies past its aligned span.
__device__ __forceinline__ int lead(const void* p, int size) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15) / size;
}

struct Tile {
  long long v0;   // first voxel of the tile within the batch element
  int nv;         // voxels in the tile
};

__device__ __forceinline__ Tile tile_of(long long k, long long m) {
  const long long v0 = ((long long)blockIdx.x + k * gridDim.x) * kVox;
  return {v0, (int)min((long long)kVox, m - v0)};
}

// Thread 0: the bulk copies of tile k of the block into slot s.
__device__ __forceinline__ void issue_tile(const float* logits,
                                           const void* labels, int lb,
                                           long long base, long long m, int c,
                                           long long k, unsigned char* slot,
                                           uint64_t* bar) {
  const Tile t = tile_of(k, m);
  uint32_t bl = 0, bb = 0;
  const char* sl = span(logits + (base + t.v0) * c, (size_t)t.nv * c * 4, &bl);
  const char* sb = span(static_cast<const char*>(labels) + (base + t.v0) * lb,
                        (size_t)t.nv * lb, &bb);
  hopper::mbar_arrive_tx(bar, bl + bb);
  hopper::bulk_copy(slot, sl, bl, bar);
  hopper::bulk_copy(slot + logits_bytes(c), sb, bb, bar);
}

__device__ __forceinline__ int slot_label(const unsigned char* slot, int c,
                                          int lab64, int i) {
  const unsigned char* b = slot + logits_bytes(c);
  return lab64 ? (int)reinterpret_cast<const long long*>(b)[i]
               : reinterpret_cast<const int*>(b)[i];
}

// exp(x - m) as 2^(x log2 e - m log2 e), with ml = m log2 e
__device__ __forceinline__ float exp_from(float x, float ml) {
  return exp2f(fmaf(x, kLog2e, -ml));
}

// Softmax of one row: z[k] = exp(x_k - max) for k < c, 0 past it; returns
// their sum, *mx the max.
template <int kC>
__device__ __forceinline__ float row_exp(const float* row, int c,
                                         float (&z)[kC], float* mx) {
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    z[k] = k < c ? row[k] : -INFINITY;
    m = fmaxf(m, z[k]);
  }
  const float ml = m * kLog2e;
  float se = 0.f;
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    z[k] = k < c ? exp_from(z[k], ml) : 0.f;
    se += z[k];
  }
  *mx = m;
  return se;
}

// The ring's barriers, initialised by thread 0, and the first kSlots tiles
// in flight. Returns the number of tiles of the block.
__device__ __forceinline__ long long start_ring(
    const float* logits, const void* labels, int lb, long long base,
    long long m, int c, unsigned char* ring, size_t sbytes, uint64_t* bars) {
  const long long ntiles = (m + kVox - 1) / kVox;
  const long long mine =
      blockIdx.x < ntiles ? (ntiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::mbar_init_fence();
    for (int s = 0; s < kSlots && s < mine; ++s)
      issue_tile(logits, labels, lb, base, m, c, s, ring + s * sbytes,
                 &bars[s]);
  }
  __syncthreads();
  return mine;
}

// grid (blocks, B). part: (blocks, B, 4, c). Dynamic shared memory: the
// ring, then the label sums (3 x kC x kThreads fp32).
template <int kC>
__global__ void __launch_bounds__(kThreads, 2)
    dice_ce_sums_kernel(const float* __restrict__ logits,
                        const void* __restrict__ labels, int lab64,
                        float* __restrict__ part, long long m, int c) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kSlots];
  __shared__ float red[kWarps][kC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lb = lab64 ? 8 : 4;
  const long long base = (long long)blockIdx.y * m;
  const size_t sbytes = slot_bytes(c, lb);
  // [sum][class][thread]: p.t, t, -log(p).t of the thread's voxels
  float* lsum = reinterpret_cast<float*>(ring + kSlots * sbytes);
  for (int e = tid; e < 3 * kC * kThreads; e += kThreads) lsum[e] = 0.f;
  const long long mine =
      start_ring(logits, labels, lb, base, m, c, ring, sbytes, bars);
  float a_psq[kC];
#pragma unroll
  for (int q = 0; q < kC; ++q) a_psq[q] = 0.f;

  for (long long k = 0; k < mine; ++k) {
    const int s = (int)(k % kSlots);
    unsigned char* slot = ring + s * sbytes;
    const Tile t = tile_of(k, m);
    hopper::mbar_wait(&bars[s], (int)((k / kSlots) & 1));
    if (tid < t.nv) {
      const float* row = reinterpret_cast<const float*>(slot) +
                         lead(logits + (base + t.v0) * c, 4) + tid * c;
      const int lab = slot_label(
          slot, c, lab64,
          lead(static_cast<const char*>(labels) + (base + t.v0) * lb, lb) +
              tid);
      float z[kC], mx;
      const float se = row_exp<kC>(row, c, z, &mx);
      const float inv = 1.f / se;
      if (lab >= 0) {
#pragma unroll
        for (int q = 0; q < kC; ++q) {
          const float pv = z[q] * inv;
          a_psq[q] += pv * pv;
        }
      }
      if (lab >= 0 && lab < c) {
        const float xl = row[lab];
        float* at = lsum + lab * kThreads + tid;
        at[0] += exp_from(xl, mx * kLog2e) * inv;
        at[kC * kThreads] += 1.f;
        at[2 * kC * kThreads] += logf(se) - (xl - mx);
      }
    }
    __syncthreads();  // every reader of the slot is done
    if (tid == 0 && k + kSlots < mine)
      issue_tile(logits, labels, lb, base, m, c, k + kSlots, slot, &bars[s]);
  }

  // the block's sums, in a fixed order: sum p^2 over the lanes (a fixed
  // tree), then over the warps; the label sums over the threads in order
#pragma unroll
  for (int q = 0; q < kC; ++q) {
    const float v = warp_sum(a_psq[q]);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  float* slab = part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * 4 * c;
  if (tid < c) {
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w) a += red[w][tid];
    slab[c + tid] = a;
  } else if (tid >= 32 && tid < 32 + 3 * c) {
    const int r = (tid - 32) / c, q = tid - 32 - r * c;
    const float* src = lsum + (r * kC + q) * kThreads;
    float a = 0.f;
    for (int i = 0; i < kThreads; ++i) a += src[i];
    slab[(r == 0 ? 0 : r + 1) * c + q] = a;
  }
}

// grid (blocks, B).
template <int kC>
__global__ void __launch_bounds__(kThreads, 2)
    dice_ce_dlogits_kernel(const float* __restrict__ logits,
                           const void* __restrict__ labels, int lab64,
                           const float* __restrict__ ca,
                           const float* __restrict__ cp,
                           const float* __restrict__ ce,
                           float* __restrict__ dlogits, long long m, int c) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kSlots];
  __shared__ float coef[2 * kC];
  const int tid = threadIdx.x;
  const int lb = lab64 ? 8 : 4;
  const long long base = (long long)blockIdx.y * m;
  const size_t sbytes = slot_bytes(c, lb);
  if (tid < kC) {   // classes past c: 0, so they add nothing to gsum
    coef[tid] = tid < c ? ca[blockIdx.y * c + tid] : 0.f;
    coef[kC + tid] = tid < c ? cp[blockIdx.y * c + tid] : 0.f;
  }
  const long long mine =
      start_ring(logits, labels, lb, base, m, c, ring, sbytes, bars);
  const float w_ce = ce[0];

  for (long long k = 0; k < mine; ++k) {
    const int s = (int)(k % kSlots);
    unsigned char* slot = ring + s * sbytes;
    const Tile t = tile_of(k, m);
    float* tile = reinterpret_cast<float*>(slot) +
                  lead(logits + (base + t.v0) * c, 4);
    hopper::mbar_wait(&bars[s], (int)((k / kSlots) & 1));
    if (tid < t.nv) {
      float* row = tile + tid * c;
      const int lab = slot_label(
          slot, c, lab64,
          lead(static_cast<const char*>(labels) + (base + t.v0) * lb, lb) +
              tid);
      float z[kC], mx;
      const float inv = 1.f / row_exp<kC>(row, c, z, &mx);
      const bool in = lab >= 0 && lab < c;
      // g_k = t_k ca_k + cp_k p_k; sum_k g_k p_k
      const float pl = in ? exp_from(row[lab], mx * kLog2e) * inv : 0.f;
      float gsum = in ? coef[lab] * pl : 0.f;
#pragma unroll
      for (int q = 0; q < kC; ++q) {
        z[q] *= inv;  // p
        gsum += coef[kC + q] * z[q] * z[q];
      }
#pragma unroll
      for (int q = 0; q < kC; ++q)
        if (q < c) row[q] = z[q] * (coef[kC + q] * z[q] - gsum + w_ce);
      if (in) row[lab] += pl * coef[lab] - w_ce;
    }
    __syncthreads();
    // the tile out: scalars up to the first 16-byte boundary of dlogits,
    // then 16-byte vectors, then the tail
    float* dst = dlogits + (base + t.v0) * c;
    const int n = t.nv * c;
    const int lead_bytes =
        (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
    const int head = min(n, lead_bytes / 4);
    const int nvec = (n - head) / 4;
    for (int e = tid; e < head; e += kThreads) dst[e] = tile[e];
    for (int e = tid; e < nvec; e += kThreads) {
      const float* sv = tile + head + 4 * e;
      *reinterpret_cast<float4*>(dst + head + 4 * e) =
          make_float4(sv[0], sv[1], sv[2], sv[3]);
    }
    for (int e = head + 4 * nvec + tid; e < n; e += kThreads) dst[e] = tile[e];
    // the slot's generic reads and writes before the bulk copy refills it
    hopper::fence_proxy_async();
    __syncthreads();
    if (tid == 0 && k + kSlots < mine)
      issue_tile(logits, labels, lb, base, m, c, k + kSlots, slot, &bars[s]);
  }
}

// The blocks of a (blocks, b) grid: at most `want` a batch element and the
// blocks resident on the card at once, shared among the b elements.
template <class K>
cudaError_t ring_grid(K kernel, size_t smem, int b, long long want,
                      int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int resident = 0;
  if (err == cudaSuccess)
    err = mlptile::resident_grid(kernel, kThreads, smem, 1 << 30, &resident);
  *blocks = (int)max(1LL, min(want, (long long)(resident / b)));
  return err;
}

template <int kC>
int launch_sums(const float* logits, const void* labels, float* part,
                float* out, int b, long long m, int c, int blocks, int lab64,
                cudaStream_t st) {
  const size_t smem = kSlots * slot_bytes(c, lab64 ? 8 : 4) +
                      sizeof(float) * 3 * kC * kThreads;
  int grid = 0;
  cudaError_t err = ring_grid(dice_ce_sums_kernel<kC>, smem, b,
                              min((long long)blocks, (m + kVox - 1) / kVox),
                              &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dice_ce_sums_kernel<kC><<<dim3(grid, b), kThreads, smem, st>>>(
      logits, labels, lab64, part, m, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(sum_partials(part, out, grid, 4LL * b * c, st));
}

template <int kC>
int launch_dlogits(const float* logits, const void* labels, const float* ca,
                   const float* cp, const float* ce, float* dlogits, int b,
                   long long m, int c, int lab64, cudaStream_t st) {
  const size_t smem = kSlots * slot_bytes(c, lab64 ? 8 : 4);
  int grid = 0;
  cudaError_t err = ring_grid(dice_ce_dlogits_kernel<kC>, smem, b,
                              (m + kVox - 1) / kVox, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dice_ce_dlogits_kernel<kC><<<dim3(grid, b), kThreads, smem, st>>>(
      logits, labels, lab64, ca, cp, ce, dlogits, m, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace medseg

// logits (b, m, c) fp32, labels (b, m) int32 or int64 (lab64), contiguous.
// part (blocks, b * 4 * c) is scratch for at most `blocks` blocks a batch
// element (the launch takes no more than are resident); out (b, 4, c) fp32.
extern "C" int medseg_dice_ce_sums(const void* logits, const void* labels,
                                   void* part, void* out, int b, long long m,
                                   int c, int blocks, int lab64,
                                   void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || m < 1 || c < 1 || c > kMaxCls || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* lg = static_cast<const float*>(logits);
  float* pt = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  return c <= 16
             ? launch_sums<16>(lg, labels, pt, o, b, m, c, blocks, lab64, st)
             : launch_sums<32>(lg, labels, pt, o, b, m, c, blocks, lab64, st);
}

// ca, cp (b, c) and ce (1) fp32 on the device; dlogits (b, m, c) fp32.
extern "C" int medseg_dice_ce_dlogits(const void* logits, const void* labels,
                                      const void* ca, const void* cp,
                                      const void* ce, void* dlogits, int b,
                                      long long m, int c, int lab64,
                                      void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || m < 1 || c < 1 || c > kMaxCls)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* lg = static_cast<const float*>(logits);
  const float* a = static_cast<const float*>(ca);
  const float* p = static_cast<const float*>(cp);
  const float* e = static_cast<const float*>(ce);
  float* d = static_cast<float*>(dlogits);
  return c <= 16
             ? launch_dlogits<16>(lg, labels, a, p, e, d, b, m, c, lab64, st)
             : launch_dlogits<32>(lg, labels, a, p, e, d, b, m, c, lab64, st);
}
