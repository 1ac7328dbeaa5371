// 3x3x3 / stride-1 / SAME convolution as one matrix product over an im2col
// tile that exists only as addresses (an implicit GEMM).
//
// Replaces the TPU kernels medicalsemseg_tpu/ops/pallas/conv3d.py: _conv_fwd
// (_fwd_kernel), which is also its input gradient (the same conv on dy with
// the flipped, in / out swapped weights). Its weight gradient _conv_dw
// (_dw_kernel) computes the function of dw27.cu, which serves it.
// For x (B, D, H, W, C) and the weights of 27 taps (kd-major),
//   y[b, d, h, w, co] = sum_{tap, ci} xpad[b, d + kd, h + kh, w + kw, ci]
//                                     * w[tap, co, ci],
// products of the input values as they are, sums in fp32, one rounding to
// x's dtype (bf16, fp16 or fp32, as the JAX function computes in x.dtype).
//
// The TPU kernel copies 27 shifted (TH.W, C) blocks into a (TH.W, 27 C)
// scratch (lane-misaligned stores, which bound it there), from an input that
// the host padded and cut into overlapping H chunks. Here a tap's column
// block of the im2col matrix is the staged halo tile at a row offset, and
// nothing is copied.
//
// Two routes, picked by the wrapper from the dtype (ops/kernels/conv3d.py):
//
// conv3_wgmma_kernel (bf16, fp16: the tensor cores). The first design
// (mma.sync, 12 warps each owning 16 output channels, 48 output channels a
// block, every (kd, kh) weight slice behind a block-wide barrier) ran at
// 20-23 % of the bound, held by shared-memory reads: 288 bytes of ldmatrix
// per mma, the same im2col rows read by its three column warps and, at
// Co = 96, the halo staged and read again by a second block. This design:
//  - One block owns every output channel up to 128 (N = Co padded to a
//    multiple of 16, one of the widths of wgmma_rs.cuh; wider Co is further
//    blocks) and 2 x 8 x 16 = 256 output voxels. Two consumer warpgroups
//    each hold two 64-voxel m-tiles of wgmma m64nNk16 accumulators.
//  - A from registers: one ldmatrix.x4 per warp, m-tile, tap and 16 input
//    channels, at the tap's row offset in the staged halo tile, feeds all N
//    output channels (3x fewer A reads a product than the first design at
//    Co = 48, 6x at Co = 96).
//  - B from shared memory through a descriptor: a tap's (16 x N) weight
//    slices, laid out by the wrapper in the K-major core-matrix order wgmma
//    reads (kernel_weights in the wrapper). One thread of the producer
//    warpgroup streams one tap of one input-channel chunk at a time with TMA
//    bulk copies into a ring of slots with full / empty mbarriers: no
//    block-wide barrier per slice.
//  - Persistent blocks (one per SM) walk (tile, Co block) items and, inside
//    an item, chunks of 48 input channels. The halo tile (4 x 10 x 18 voxels
//    x 56 channels, the chunk's 48 and 8 of padding that keep ldmatrix
//    conflict-free: 80.6 KB) has two buffers, filled by one TMA tensor copy
//    of x's tensor map per chunk (its box is exactly a buffer; the border
//    and the channels past C come in as zeros), started by the producer
//    warpgroup's stager warps while the consumers multiply the other
//    buffer. The consumers round a tile's accumulators into its buffer; the
//    stagers write them to y in 16-byte rows before they refill it. Two
//    buffers and the ring fit the 227 KB (5 slots at N = 128, 7 at 96, 8
//    below). Where no tensor map describes x (C no multiple of 8, x not
//    16-byte aligned) the stagers load the halo themselves.
// Registers: ptxas gives the kernel 168 (the cap of 384 threads a block),
// no spills; setmaxnreg then hands the consumers 224 (N accumulators, 48 for
// two sets of a tap's A fragments, addresses) and the producer warpgroup 56.
//
// What bounds it (NVIDIA H100 80GB HBM3, batch 4 of 96^3; parts compiled out
// with MEDSEG_K10_SKIP, chip_smoke.py --phases k10_parts): the products.
// At 48 -> 48 the whole kernel takes 0.97 ms and its products alone 0.88 ms,
// half the tensor-core rate: at N = 48 a tap is six m64n48k16 wgmmas a
// warpgroup, each reading 1.5 KB of B and 2 KB of A for 49k multiply-adds.
// At N = 96 (dx 48 -> 96) the products alone run at 73 % of the rate.
// Tried: the consumers staging the next halo with cp.async (their
// products then waited while they started the copies: staging and
// products added up, 1.87 ms), then 96 stager threads with cp.async (the stagers bound
// it, 1.41 ms); the TMA tensor copy takes the staging off both.
//
// conv3_cuda_core_kernel (fp32): CUDA cores with fp32 FMA, no TF32, a simple
// kernel that is right. A block owns 256 voxels (the same tile) and 32
// output channels, a thread one voxel; per chunk of 8 input channels the halo
// tile (channel-major, fp32) and the chunk's 27 x 8 x 32 weights sit in
// shared memory, the weights read as broadcast float4. Its bound is the
// fp32 rate (67 TFLOP/s).

#include <cuda.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_rs.cuh"

// The card's machine has no kernel profiler, so the tensor-core kernel's
// parts can be compiled out to time the rest (chip_smoke.py --phases
// k10_parts; the result is then wrong): bit 1 the staging of x (the halo
// copies), 2 the products (ldmatrix and wgmma), 4 the epilogue, 8 the
// weight copies. Undefined in every other build.
#ifndef MEDSEG_K10_SKIP
#define MEDSEG_K10_SKIP 0
#endif

namespace medseg {
namespace {

using namespace hopper;

// The routes of the C entry point (kRouteCudaCore, kRouteTensorCore in
// mma_tile.cuh; ops/kernels/__init__.py ROUTES).
constexpr int kCudaCore = 0, kTensorCore = 1;

// output voxels a block, their halo tile
constexpr int kTD = 2, kTH = 8, kTW = 16;
constexpr int kHD = kTD + 2, kHH = kTH + 2, kHW = kTW + 2;
constexpr int kHalo = kHD * kHH * kHW;  // 720
constexpr int kVox = kTD * kTH * kTW;   // 256

// ---- the tensor-core route ------------------------------------------------

constexpr int kCK = 48;            // input channels a staged chunk
constexpr int kRow = kCK + 8;      // 16-bit values a staged voxel: 112 bytes,
                                   // so the 8 rows of an ldmatrix fall in 8
                                   // bank groups
constexpr int kHaloBytes = kHalo * kRow * 2;  // 80,640
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kTcThreads = kConsumers + 128;  // and the producer warpgroup:
constexpr int kStagers = 96;                  // its warps 1-3 stage
// registers a thread after setmaxnreg (2 x 128 x 224 + 128 x 56 <= 65,536)
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kMaxSmem = 232448;
constexpr int kMaxSlots = 8;

template <int N>
struct TcShape {
  // one tap of a whole chunk: 3 k steps of [2 halves][N][8 channels]
  static constexpr int kSlotBytes = (kCK / 16) * 32 * N;
  static constexpr int kFit = (kMaxSmem - 2 * kHaloBytes - 256) / kSlotBytes;
  static constexpr int kSlots = kFit < kMaxSlots ? kFit : kMaxSlots;
  static constexpr int kAcc = N / 2;  // fp32 a thread per m-tile
  static constexpr int kOutRow = N + 8;  // staged output row: conflict-free
  static constexpr size_t kSmem = (size_t)2 * kHaloBytes +
                                  (size_t)kSlots * kSlotBytes +
                                  (2 * kSlots + 4) * sizeof(uint64_t);
  static_assert(kSlots >= 4, "the ring needs four slots");
  static_assert(kVox * kOutRow * 2 <= kHaloBytes,
                "the outputs are staged in a halo buffer");
};

template <class T>
struct Vec2;
template <>
struct Vec2<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
};
template <>
struct Vec2<__half> {
  using type = __half2;
  static __device__ __forceinline__ type make(float a, float b) {
    return __floats2half2_rn(a, b);
  }
};

// The consumers' own barrier and the stagers' (the other warps never join).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kStagers) : "memory");
}

// TMA copy of the halo box (kRow channels from c0, kHW x kHH x kHD voxels
// from (w, h, d), sample b) of x's tensor map into xs, zero outside x,
// completing on bar.
__device__ __forceinline__ void tma_load_halo(uint32_t xs, const CUtensorMap* map,
                                              int c0, int w, int h, int d,
                                              int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(xs),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(w), "r"(h), "r"(d),
      "r"(b), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// K-major B without swizzle: core matrices of 8 output channels x 8 input
// channels (128 contiguous bytes); the next 8 input channels (leading) N rows
// of 16 bytes on, the next 8 output channels (stride) 128 bytes on.
template <int N>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, N * 16, 128);
}

// The work of a block: items (tile of the volume, Co block) strided over
// the grid, each in chunks of kCK input channels.
struct Walk {
  int D, H, W, C, Co, CP, nchunk, ndt, nht, nwt, tiles, nitems;

  // the origin of an item's tile, its sample and Co block
  __device__ void origin(int item, int* b, int* z, int* d0, int* h0,
                         int* w0) const {
    *z = item / tiles;
    int t = item - *z * tiles;
    *w0 = (t % nwt) * kTW;
    t /= nwt;
    *h0 = (t % nht) * kTH;
    t /= nht;
    *d0 = (t % ndt) * kTD;
    *b = t / ndt;
  }
  // 16-bit values of chunk ch that the kernel stages and multiplies
  __device__ int ckp(int ch) const { return min(kCK, CP - ch * kCK); }
};

// Stage channels c0 .. c0 + ckp of the halo tile at (d0, h0, w0) of sample
// plane xb into xs (xs[v * kRow + cc], v = (hd * kHH + hh) * kHW + hw), zero
// outside the volume and past C, by the stagers' threads, and wait for it:
// the form for x that no tensor map describes (C no multiple of 8, or x not
// 16-byte aligned), with plain loads and stores.
template <class T>
__device__ __forceinline__ void stage_halo(uint32_t xs, const T* __restrict__ xb,
                                           const Walk& wk, int d0, int h0,
                                           int w0, int c0, int ckp, int ts) {
  if (MEDSEG_K10_SKIP & 1) return;
  const int nck = ckp >> 3;
  for (int e = ts; e < kHalo * nck; e += kStagers) {
    const int v = e / nck, k = e - v * nck;
    const int hw = v % kHW, hh = (v / kHW) % kHH, hd = v / (kHW * kHH);
    const int gd = d0 + hd - 1, gh = h0 + hh - 1, gw = w0 + hw - 1;
    const int ci0 = c0 + 8 * k;
    const bool in = gd >= 0 && gd < wk.D && gh >= 0 && gh < wk.H && gw >= 0 &&
                    gw < wk.W && ci0 < wk.C;
    const long long src =
        in ? (((long long)gd * wk.H + gh) * wk.W + gw) * wk.C + ci0 : 0;
    const uint32_t dst = xs + (v * kRow + 8 * k) * 2;
    __align__(16) T vals[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      vals[i] = in && ci0 + i < wk.C ? xb[src + i] : from_f32<T>(0.f);
    const uint4 u = *reinterpret_cast<const uint4*>(vals);
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
                 : "memory");
  }
}

// Write an item's outputs, staged in its halo buffer as os[v * (N + 8) +
// col] (v = (od * kTH + oh) * kTW + ow), to y in 16-byte rows (vec: Co is a
// multiple of 8 and y 16-byte aligned), by the stagers' threads.
template <int N, class T>
__device__ __forceinline__ void store_outputs(const T* os, T* __restrict__ y,
                                              const Walk& wk, int item,
                                              bool vec, int ts) {
  if (MEDSEG_K10_SKIP & 4) return;
  int b, z, d0, h0, w0;
  wk.origin(item, &b, &z, &d0, &h0, &w0);
  T* yb = y + (long long)b * wk.D * wk.H * wk.W * wk.Co;
  constexpr int nchk = N / 8;
  for (int e = ts; e < kVox * nchk; e += kStagers) {
    const int v = e / nchk, cc = (e - v * nchk) * 8;
    const int ow = v % kTW, oh = (v / kTW) % kTH, od = v / (kTW * kTH);
    const int gd = d0 + od, gh = h0 + oh, gw = w0 + ow, co = z * N + cc;
    if (gd >= wk.D || gh >= wk.H || gw >= wk.W || co >= wk.Co) continue;
    T* dst = yb + (((long long)gd * wk.H + gh) * wk.W + gw) * wk.Co + co;
    const T* src = os + v * (N + 8) + cc;
    if (vec && co + 8 <= wk.Co) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && co + i < wk.Co; ++i) dst[i] = src[i];
    }
  }
}

// grid: min(items, SMs) persistent blocks. wk: per Co block z, per chunk ch
// (c0 = 48 ch, nks = ckp / 16 k steps), per tap, per k step, [2 halves of 8
// input channels][N output channels][8], zero padded (kernel_weights in
// ops/kernels/conv3d.py).
//
// A block's work is a sequence of uses n = 0, 1, ... of (item, chunk), use n
// in halo buffer n & 1. Its mbarriers: full / empty per weight slot (the
// producer thread's TMA copies; the eight consumer warps), hfull per buffer
// (the stagers have staged use n: one TMA copy of x's tensor map tmx where
// use_tma, else the stagers' loads), hdone per buffer (the consumer warps are
// done with use n: products read, and at a tile's last chunk its outputs
// written into the buffer, which the stagers store before they stage use
// n + 2 there).
template <int N, class T>
__global__ void __launch_bounds__(kTcThreads, 1)
    conv3_wgmma_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                       T* __restrict__ y, Walk wk,
                       const __grid_constant__ CUtensorMap tmx, int use_tma,
                       int vec_y) {
  using S = TcShape<N>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + 2 * kHaloBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::kSlots * S::kSlotBytes);
  uint64_t* empty = full + S::kSlots;
  uint64_t* hfull = empty + S::kSlots;
  uint64_t* hdone = hfull + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t halo0 = smem_u32(smem_raw);
  const long long plane = (long long)wk.D * wk.H * wk.W * wk.C;

  if (tid == 0) {
    for (int s = 0; s < S::kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&hfull[i], use_tma ? 1 : kStagers);
      mbar_init(&hdone[i], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32) {
      // one thread streams the weights, tap by tap
      if (lane != 0) return;
      int seq = 0;
      for (int item = blockIdx.x; item < wk.nitems; item += gridDim.x) {
        const int z = item / wk.tiles;
        for (int ch = 0; ch < wk.nchunk; ++ch) {
          const int nks = wk.ckp(ch) >> 4;
          const uint32_t bytes = nks * 32 * N;
          const T* src = wg + ((size_t)z * 27 * wk.CP + 27 * ch * kCK) * N;
          for (int tap = 0; tap < 27; ++tap, ++seq) {
            const int s = seq % S::kSlots;
            mbar_wait(&empty[s], ((seq / S::kSlots) & 1) ^ 1);
            if (MEDSEG_K10_SKIP & 8) {
              mbar_arrive(&full[s]);
            } else {
              mbar_arrive_tx(&full[s], bytes);
              bulk_copy(ring + s * S::kSlotBytes, src + (size_t)tap * nks * 16 * N,
                        bytes, &full[s]);
            }
          }
        }
      }
      return;
    }
    // the stagers: each use's halo into its buffer once the buffer's use
    // before is done, storing that use's outputs first where it ended a tile
    const int ts = tid - kConsumers - 32;
    // the item whose outputs buffer 0 / 1 holds for the stagers, or -1
    int n = 0, last0 = -1, last1 = -1;
    for (int item = blockIdx.x; item < wk.nitems; item += gridDim.x) {
      int b, z, d0, h0, w0;
      wk.origin(item, &b, &z, &d0, &h0, &w0);
      for (int ch = 0; ch < wk.nchunk; ++ch, ++n) {
        const int buf = n & 1, done = buf ? last1 : last0;
        mbar_wait(&hdone[buf], ((n >> 1) & 1) ^ 1);
        if (done >= 0) {
          store_outputs<N>(reinterpret_cast<const T*>(smem_raw + buf * kHaloBytes),
                           y, wk, done, vec_y, ts);
          stagers_sync();  // every output row is read before it is overwritten
        }
        if (!use_tma) {
          stage_halo(halo0 + buf * kHaloBytes, x + b * plane, wk, d0, h0, w0,
                     ch * kCK, wk.ckp(ch), ts);
          mbar_arrive(&hfull[buf]);
        } else if (ts == 0) {
          if (MEDSEG_K10_SKIP & 1) {
            mbar_arrive(&hfull[buf]);
          } else {
            fence_proxy_async();  // the buffer's reads and writes before
            mbar_arrive_tx(&hfull[buf], kHaloBytes);
            tma_load_halo(halo0 + buf * kHaloBytes, &tmx, ch * kCK, w0 - 1,
                          h0 - 1, d0 - 1, b, &hfull[buf]);
          }
        }
        (buf ? last1 : last0) = ch == wk.nchunk - 1 ? item : -1;
      }
    }
    // the last two uses' outputs
    for (int m = max(n - 2, 0); m < n; ++m) {
      const int buf = m & 1, done = buf ? last1 : last0;
      if (done < 0) continue;
      mbar_wait(&hdone[buf], (m >> 1) & 1);
      store_outputs<N>(reinterpret_cast<const T*>(smem_raw + buf * kHaloBytes), y,
                       wk, done, vec_y, ts);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg4 = tid >> 7, wq = warp & 3;
  const uint32_t ring0 = smem_u32(ring);
  // this warp's rows of its warpgroup's two m-tiles: m-tile j = 2 wg4 + mt
  // is rows 4 j .. 4 j + 3 of the tile's 16 rows of 16 voxels (row r is
  // od = r / 8, oh = r % 8); warp wq owns row 4 j + wq. The ldmatrix lane
  // address: rows (voxels ow) lr + 8 (lj & 1), channels 8 (lj >> 1)
  const int lj = lane >> 3, lr = lane & 7;
  int a_off[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = 4 * (2 * wg4 + mt) + wq;
    a_off[mt] = (((r >> 3) * kHH + (r & 7)) * kHW + lr + 8 * (lj & 1)) * kRow +
                8 * (lj >> 1);
  }

  float acc[2][S::kAcc];
  int n = 0, seq = 0;
  for (int item = blockIdx.x; item < wk.nitems; item += gridDim.x) {
    for (int ch = 0; ch < wk.nchunk; ++ch, ++n) {
      const int buf = n & 1;
      const uint32_t xs = halo0 + buf * kHaloBytes;
      mbar_wait(&hfull[buf], (n >> 1) & 1);
      if (ch == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < S::kAcc; ++i) acc[mt][i] = 0.f;
      }
      const int nks = wk.ckp(ch) >> 4;
      // A tap is one wgmma group: its A fragments (k steps x m-tiles) in one
      // of two register sets, taps alternating between them, so that a
      // tap's loads run while the tap before it is on the tensor cores; the
      // wait after a commit leaves only that group in flight, so the set the
      // next tap takes and the slot of the tap before are free.
      uint32_t af[2][kCK / 16][2][4];
      int prev = -1;
      auto tap_products = [&](int tap, uint32_t(&a)[kCK / 16][2][4]) {
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        const int s = seq % S::kSlots;
        const uint32_t xa = xs + (((kd * kHH + kh) * kHW + kw) * kRow) * 2;
        const uint32_t slot = ring0 + s * S::kSlotBytes;
        mbar_wait(&full[s], (seq / S::kSlots) & 1);
        if (!(MEDSEG_K10_SKIP & 2)) {
#pragma unroll
          for (int ks = 0; ks < kCK / 16; ++ks)
            if (ks < nks)
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                ldsm_x4(a[ks][mt], xa + (a_off[mt] + ks * 16) * 2);
                fence_regs(a[ks][mt]);
              }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) fence_regs(acc[mt]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kCK / 16; ++ks)
            if (ks < nks) {
              const uint64_t db = kmajor_desc<N>(slot + ks * 32 * N);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                WgmmaRS<N, T>::mma(acc[mt], a[ks][mt], db, 1);
            }
          wgmma_commit();
          wgmma_wait<1>();
        }
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
        ++seq;
      };
#pragma unroll 1
      for (int tap = 0; tap < 27; tap += 2) {
        tap_products(tap, af[0]);
        if (tap + 1 < 27) tap_products(tap + 1, af[1]);
      }
      // the chunk's last group (and so its slot) is done before the next
      // chunk loads into its register set, and before the epilogue
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) fence_regs(acc[mt]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);

      if (ch == wk.nchunk - 1) {
        // the outputs into this use's buffer, rows of N + 8, for the stagers
        consumers_sync();  // every warp is done reading it
        typename Vec2<T>::type* os =
            reinterpret_cast<typename Vec2<T>::type*>(smem_raw + buf * kHaloBytes);
        const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = 4 * (2 * wg4 + mt) + wq;
#pragma unroll
          for (int i = 0; i < S::kAcc; i += 2) {
            const int v = r * kTW + g + 8 * ((i >> 1) & 1);
            const int col = 8 * (i >> 2) + 2 * t4;
            os[(v * S::kOutRow + col) >> 1] =
                Vec2<T>::make(acc[mt][i], acc[mt][i + 1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&hdone[buf]);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime (no
// link to libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// x (b, d, h, w, c) as a 5-d tensor map whose box is one halo buffer: kRow
// channels (the chunk's 48 and the row's 8 of padding) of kHW x kHH x kHD
// voxels; positions outside x (the border, channels past C) read as zero.
// Needs c a multiple of 8 and x 16-byte aligned (the map's strides).
template <class T>
cudaError_t halo_tensor_map(CUtensorMap* map, const void* x, int b, int d,
                            int h, int w, int c) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t e = sizeof(T);
  const cuuint64_t dims[5] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)d, (cuuint64_t)b};
  const cuuint64_t strides[4] = {c * e, (cuuint64_t)w * c * e,
                                 (cuuint64_t)h * w * c * e,
                                 (cuuint64_t)d * h * w * c * e};
  const cuuint32_t box[5] = {kRow, kHW, kHH, kHD, 1};
  const cuuint32_t steps[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      5, const_cast<void*>(x), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N, class T>
cudaError_t launch_tc(const void* x, const void* wg, void* y, int b,
                      const Walk& wk, cudaStream_t st) {
  using S = TcShape<N>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3_wgmma_kernel<N, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const int use_tma =
      wk.C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_y = wk.Co % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  CUtensorMap tmx;
  memset(&tmx, 0, sizeof(tmx));
  if (use_tma) {
    err = halo_tensor_map<T>(&tmx, x, b, wk.D, wk.H, wk.W, wk.C);
    if (err != cudaSuccess) return err;
  }
  const int grid = wk.nitems < sms ? wk.nitems : sms;
  conv3_wgmma_kernel<N, T><<<grid, kTcThreads, S::kSmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<T*>(y),
      wk, tmx, use_tma, vec_y);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_tc_n(int n, const void* x, const void* wg, void* y, int b,
                        const Walk& wk, cudaStream_t st) {
  switch (n) {
    case 16: return launch_tc<16, T>(x, wg, y, b, wk, st);
    case 32: return launch_tc<32, T>(x, wg, y, b, wk, st);
    case 48: return launch_tc<48, T>(x, wg, y, b, wk, st);
    case 64: return launch_tc<64, T>(x, wg, y, b, wk, st);
    case 96: return launch_tc<96, T>(x, wg, y, b, wk, st);
    case 128: return launch_tc<128, T>(x, wg, y, b, wk, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the CUDA-core route --------------------------------------------------

constexpr int kCcCo = 32;   // output channels a block
constexpr int kCcCK = 8;    // input channels a staged chunk
constexpr size_t kCcSmem =
    sizeof(float) * ((size_t)kCcCK * kHalo + 27 * kCcCK * kCcCo);

// grid (tiles of the volume x B, ceil(Co / 32)), 256 threads, a thread one
// voxel. w: (27 taps, C, Co).
__global__ void __launch_bounds__(kVox)
    conv3_cuda_core_kernel(const float* __restrict__ x,
                           const float* __restrict__ w, float* __restrict__ y,
                           int D, int H, int W, int C, int Co, int ndt,
                           int nht, int nwt) {
  extern __shared__ __align__(16) float smem_f[];
  float* xs = smem_f;                    // xs[ci * kHalo + v]
  float* ws = smem_f + kCcCK * kHalo;    // ws[(tap * kCcCK + ci) * kCcCo + co]
  const int tid = threadIdx.x;
  int t = blockIdx.x;
  const int w0 = (t % nwt) * kTW;
  t /= nwt;
  const int h0 = (t % nht) * kTH;
  t /= nht;
  const int d0 = (t % ndt) * kTD;
  const long long b = t / ndt;
  const int co0 = blockIdx.y * kCcCo;
  const float* xb = x + b * D * H * W * C;
  const int ow = tid % kTW, oh = (tid / kTW) % kTH, od = tid / (kTW * kTH);
  const int vbase = (od * kHH + oh) * kHW + ow;

  float acc[kCcCo];
#pragma unroll
  for (int j = 0; j < kCcCo; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCcCK) {
    __syncthreads();  // the last chunk's readers are done
    for (int e = tid; e < kHalo * kCcCK; e += kVox) {
      const int v = e / kCcCK, ci = e - v * kCcCK;
      const int hw = v % kHW, hh = (v / kHW) % kHH, hd = v / (kHW * kHH);
      const int gd = d0 + hd - 1, gh = h0 + hh - 1, gw = w0 + hw - 1;
      const bool in = gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 &&
                      gw < W && c0 + ci < C;
      xs[ci * kHalo + v] =
          in ? xb[(((long long)gd * H + gh) * W + gw) * C + c0 + ci] : 0.f;
    }
    for (int e = tid; e < 27 * kCcCK * kCcCo; e += kVox) {
      const int co = e % kCcCo, ci = (e / kCcCo) % kCcCK, tap = e / (kCcCo * kCcCK);
      ws[e] = c0 + ci < C && co0 + co < Co
                  ? w[((long long)tap * C + c0 + ci) * Co + co0 + co]
                  : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 27; ++tap) {
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      const float* xv = xs + vbase + (kd * kHH + kh) * kHW + kw;
      const float4* wv = reinterpret_cast<const float4*>(ws + tap * kCcCK * kCcCo);
#pragma unroll
      for (int ci = 0; ci < kCcCK; ++ci) {
        const float a = xv[ci * kHalo];
#pragma unroll
        for (int j = 0; j < kCcCo / 4; ++j) {
          const float4 q = wv[ci * (kCcCo / 4) + j];
          acc[4 * j] = fmaf(a, q.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(a, q.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(a, q.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(a, q.w, acc[4 * j + 3]);
        }
      }
    }
  }

  const int gd = d0 + od, gh = h0 + oh, gw = w0 + ow;
  if (gd >= D || gh >= H || gw >= W) return;
  float* dst = y + (((b * D + gd) * H + gh) * (long long)W + gw) * Co + co0;
#pragma unroll
  for (int j = 0; j < kCcCo; ++j)
    if (co0 + j < Co) dst[j] = acc[j];
}

cudaError_t launch_cc(const void* x, const void* w, void* y, int b, int d,
                      int h, int wd, int c, int co, cudaStream_t st) {
  const int ndt = (d + kTD - 1) / kTD, nht = (h + kTH - 1) / kTH,
            nwt = (wd + kTW - 1) / kTW;
  cudaError_t err = cudaFuncSetAttribute(
      conv3_cuda_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kCcSmem);
  if (err != cudaSuccess) return err;
  conv3_cuda_core_kernel<<<dim3(b * ndt * nht * nwt, (co + kCcCo - 1) / kCcCo),
                           kVox, kCcSmem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), d, h, wd, c, co, ndt, nht, nwt);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medseg

// x (b, d, h, w, c) and y (b, d, h, w, co) of the dtype (kBf16, kF16, kF32),
// contiguous. route 1, the tensor cores (bf16, fp16): wg in the layout of
// conv3_wgmma_kernel, zero padded, cp = c padded to a multiple of 16, n the
// output channels a block (16, 32, 48, 64, 96 or 128; ceil(co / n) blocks
// along Co). route 0, the CUDA cores (fp32): wg (27, c, co), cp = c and
// n = co.
extern "C" int medseg_conv3x3x3(const void* x, const void* wg, void* y, int b,
                                int d, int h, int w, int c, int co, int cp,
                                int n, int dtype, int route, void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || d < 1 || h < 1 || w < 1 || c < 1 || co < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)b * ((d + kTD - 1) / kTD) *
                          ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
  if (route == kCudaCore) {
    if (dtype != kF32 || cp != c || n != co || tiles > 2147483647LL ||
        (co + kCcCo - 1) / kCcCo > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_cc(x, wg, y, b, d, h, w, c, co, st));
  }
  if (route != kTensorCore || (dtype != kBf16 && dtype != kF16) || cp < c ||
      cp % 16 != 0 || n < 16 || n > 128 || n % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk wk;
  wk.D = d; wk.H = h; wk.W = w; wk.C = c; wk.Co = co; wk.CP = cp;
  wk.nchunk = (cp + kCK - 1) / kCK;
  wk.ndt = (d + kTD - 1) / kTD;
  wk.nht = (h + kTH - 1) / kTH;
  wk.nwt = (w + kTW - 1) / kTW;
  const long long nz = (co + n - 1) / n;
  if (tiles * nz > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  wk.tiles = static_cast<int>(tiles);
  wk.nitems = static_cast<int>(tiles * nz);
  cudaError_t err = dtype == kBf16
                        ? launch_tc_n<__nv_bfloat16>(n, x, wg, y, b, wk, st)
                        : launch_tc_n<__half>(n, x, wg, y, b, wk, st);
  return static_cast<int>(err);
}
