// Weight gradient of the 3x3x3 / stride-1 / SAME convolution in one pass.
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/dw27.py: dw27_pallas
// (_kernel). For x (B, D, H, W, C) and dy (B, D, H, W, Co), channels last,
//   dw[kd, kh, kw, ci, co] = sum_{b,d,h,w} xpad[b, d+kd, h+kh, w+kw, ci]
//                                          * dy[b, d, h, w, co]
// with one voxel of zero padding around x: 27 matrix products (C, M) . (M, Co)
// over the M = B.D.H.W voxels. Products of the inputs as they are (bf16, fp16
// or fp32), sums in fp32, result fp32.
//
// The TPU kernel makes three W-shifted, lane-padded copies of x in device
// memory and walks a sequential grid over (b, d, h-chunk) with one (27, C,
// Co) accumulator in scratch memory. Here x is read from its own layout and
// nothing is copied or padded beforehand. The accumulator (27.C.Co fp32: 249
// KB at 48 -> 48) fits no block, so blocks own parts of it and `shares`
// blocks per part each walk a strided share of the voxels, writing their sums
// to a slab of partials that sum_partials adds in a fixed order: a second run
// gives the same bits (no atomics).
//
// dw27_wgmma_kernel (bf16, C and Co multiples of 8), the Hopper design:
//  - A block owns all nine (kh, kw) taps of one kd for a tile of 48 input x
//    48 output channels, in three consumer warpgroups, one per kh; each
//    holds its three kw taps as wgmma accumulators (64 x 48 fp32: 24 a
//    thread each, 72 in all).
//  - It walks rows of dy (b, d, h; up to 96 voxels of w) along h in runs of
//    kHRun rows and keeps a ring of x rows of depth d + kd - 1 (rows h - 1,
//    h, h + 1 in use, the next ones in flight) in shared memory, so each x
//    row and each dy row is staged once per kd: a third of what a block per
//    (kd, kh) staged through L2 (12.2 GB at 96 -> 48, batch 4).
//  - dy is the operand all nine taps share: A = dy^T (co x voxel), B = x
//    (voxel x ci). Both are staged MN-major (channels contiguous, as they lie
//    in memory) in the no-swizzle layout of 8 x 8 core matrices, [channel /
//    8][voxel][8 channels]. B goes to wgmma from shared memory (bf16 wgmma
//    takes it MN-major): a tap's kw shift is its descriptor's start moved by
//    kw rows of 16 bytes. A goes through registers: one ldmatrix.trans per
//    warp and k step serves the three taps of the warpgroup, where an A read
//    from shared memory by every wgmma made the operand traffic (3.5 KB a
//    product, 1.5 of it B) as long as the products themselves.
//  - The voxel axis is wgmma's K: 16 voxels a step, 6 steps for a row of 96.
//    M = 64 rows of co hold 48 channels; rows 48-63 read zeros and are
//    dropped (a quarter of the tensor work is wasted).
//  - Rows stream in with cp.async (16-byte chunks scattered into the
//    core-matrix layout, zero-filled outside the volume) kAhead steps ahead
//    of the products: three dy slots and nine x slots, one barrier per row.
//  - The tensor cores add into fp32 by truncation, and a long chain drifts
//    (1.8e-4 of the result after 5,000 additions, measured on the card): the
//    accumulators hold kFlush rows and are then added, rounding to nearest,
//    into the thread's own fp32 sums in shared memory.
// At 96 -> 48 the two input-channel tiles are two blocks, each staging dy: a
// block with both (N = 96) would hold 144 accumulators a thread and 166 KB of
// sums, over the register file and beside the rings over shared memory.
//
// dw27_kernel takes everything else (fp32 and fp16 inputs, channel counts that
// are no multiple of 8) on CUDA cores: a block owns the three kw taps of one
// (kd, kh) for 48 x 48 channels and stages one W-row of x and dy at a time.
//
// What bounds them on the card: the function is bound by its operations at
// the bf16 tensor-core rate. dw27_wgmma_kernel's parts, timed with each
// compiled out (MEDSEG_K5_SKIP, below), are the products, the row copies and
// the flushes; they add up rather than overlap, since one block runs per SM
// and synchronises once per row. dw27_kernel, FMA throughput and
// shared-memory bandwidth (6 loads for 27 multiply-adds per voxel and
// thread).

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

// As in winograd3d.cu, the tensor-core kernel's parts can be compiled out to
// time the rest (chip_smoke.py --phases k5_parts; the result is then wrong):
// bit 1 the products (ldmatrix and wgmma), 2 the row copies, 4 the flushes
// into the sums. Undefined in every other build.
#ifndef MEDSEG_K5_SKIP
#define MEDSEG_K5_SKIP 0
#endif

namespace medseg {
namespace {

using namespace hopper;

constexpr int kCT = 48;        // input / output channels per block tile
constexpr int kWT = 96;        // voxels along W per spatial tile
constexpr int kPer = kCT / 16; // channels per thread along either axis

// grid (9 . nci . nco, shares). part: (shares, 27, C, Co).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    dw27_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                float* __restrict__ part, int B, int D, int H, int W, int C,
                int Co, int nci, int nco) {
  __shared__ float xs[(kWT + 2) * kCT];  // xs[s][cc] = x[w0 + s - 1][ci0 + cc]
  __shared__ float ds[kWT * kCT];        // ds[s][cc] = dy[w0 + s][co0 + cc]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int o = blockIdx.x;
  const int co0 = (o % nco) * kCT;
  o /= nco;
  const int ci0 = (o % nci) * kCT;
  o /= nci;
  const int kd = o / 3, kh = o % 3;

  float acc[3][kPer][kPer];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[k][i][j] = 0.f;

  const int nwt = (W + kWT - 1) / kWT;
  const long long ntiles = (long long)B * D * H * nwt;
  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const long long row = tile / nwt;  // (b, d, h) of the dy row
    const int w0 = (int)(tile - row * nwt) * kWT;
    const int wt = min(kWT, W - w0);
    const int h = (int)(row % H);
    const int d = (int)((row / H) % D);
    const long long b = row / ((long long)H * D);
    const int sd = d + kd - 1, sh = h + kh - 1;
    if (sd < 0 || sd >= D || sh < 0 || sh >= H) continue;  // zero padding
    const T* xrow = x + ((b * D + sd) * H + sh) * (long long)W * C;
    const T* drow = dy + (row * W + w0) * (long long)Co;

    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < (wt + 2) * kCT; e += kThreads) {
      const int s = e / kCT, cc = e - s * kCT;
      const int gw = w0 + s - 1, ci = ci0 + cc;
      xs[e] = (gw >= 0 && gw < W && ci < C)
                  ? to_f32(xrow[(long long)gw * C + ci])
                  : 0.f;
    }
    for (int e = tid; e < wt * kCT; e += kThreads) {
      const int s = e / kCT, cc = e - s * kCT;
      const int co = co0 + cc;
      ds[e] = co < Co ? to_f32(drow[(long long)s * Co + co]) : 0.f;
    }
    __syncthreads();

    // lanes run along co: the ds reads are conflict-free, xs broadcasts
    float xa[kPer], xb[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      xa[i] = xs[ty + 16 * i];
      xb[i] = xs[kCT + ty + 16 * i];
    }
#pragma unroll 4
    for (int w = 0; w < wt; ++w) {
      float xc[kPer], dv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) xc[i] = xs[(w + 2) * kCT + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) dv[j] = ds[w * kCT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          acc[0][i][j] += xa[i] * dv[j];
          acc[1][i][j] += xb[i] * dv[j];
          acc[2][i][j] += xc[i] * dv[j];
        }
        xa[i] = xb[i];
        xb[i] = xc[i];
      }
    }
  }

  float* p = part + (size_t)blockIdx.y * 27 * C * Co;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int ci = ci0 + ty + 16 * i, co = co0 + tx + 16 * j;
        if (ci < C && co < Co)
          p[((size_t)((kd * 3 + kh) * 3 + k) * C + ci) * Co + co] =
              acc[k][i][j];
      }
}

// ---- the wgmma kernel ------------------------------------------------------

constexpr int kWgThreads = 384;    // three consumer warpgroups, one per kh
constexpr int kHRun = 24;          // dy rows a block walks along h in one run
constexpr int kFlush = 4;          // rows between two flushes into the sums
constexpr int kAhead = 2;          // steps whose rows are loaded ahead
constexpr int kXSlots = 9;         // x rows in the ring: 3 in use and up to
                                   // 6 for the kAhead steps ahead
constexpr int kDySlots = kAhead + 1;
constexpr int kXRows = kWT + 2;    // staged voxels of an x row (a halo each side)
constexpr int kGroups = kCT / 8;   // 16-byte channel groups of a tile
constexpr int kXSlotBytes = kGroups * kXRows * 16;
constexpr int kDyGroups = 8;       // wgmma M = 64: groups 6, 7 stay zero
constexpr int kDySlotBytes = kDyGroups * kWT * 16;
constexpr int kAcc = kCT / 2;      // fp32 accumulators of one tap a thread
constexpr int kSumThreads = 96;    // threads of the warps whose rows are
                                   // channels (warps 0-2 of a warpgroup)
constexpr size_t kWgSmem = (size_t)kXSlots * kXSlotBytes +
                           (size_t)kDySlots * kDySlotBytes +
                           sizeof(float) * 3 * 3 * kAcc * kSumThreads;

// 16 bytes from global to shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// d (64 x 48, fp32) [+]= A (64 x 16, bf16 registers) . B (16 x 48, bf16,
// MN-major in shared memory).
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[kAcc],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
      "%28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The copies of a row: x's kXRows x kGroups and dy's kWT x kGroups 16-byte
// chunks, a thread taking chunks tid and tid + kWgThreads. Chunk e is
// channel group e % kGroups of voxel e / kGroups, so that the lanes of a warp
// read whole voxels' channels, contiguous in memory (lanes a voxel apart
// would each take half of a 32-byte sector and read every sector twice);
// in the slot it goes to the core-matrix place of its group and voxel.
constexpr int kXChunks = kGroups * kXRows, kDyChunks = kGroups * kWT;
static_assert(kXChunks <= 2 * kWgThreads && kDyChunks <= 2 * kWgThreads,
              "a thread copies at most two chunks of a row");

// The runs of a block: kHRun dy rows (b, d, h .. hend) of one w tile, strided
// over the shares; runs whose x depth d + kd - 1 is padding are skipped. A
// run's row planes and this thread's chunk offsets in a row are worked out
// once a run (32-bit), so that a step's copies cost a few adds.
struct Run {
  const __nv_bfloat16* xp;   // x plane (b, d + kd - 1)
  const __nv_bfloat16* dyp;  // dy plane (b, d)
  int h, hend, ks;           // the next dy row to load, the run's end, and
                             // the k steps of its rows
  int xoff[2], dyoff[2];     // this thread's chunks in a row, -1 outside
};

// Byte offset in a slot of chunk e of a row of n voxels.
__device__ __forceinline__ int chunk_slot_offset(int e, int n) {
  const int s = e / kGroups;
  return ((e - s * kGroups) * n + s) * 16;
}

struct Walk {
  int D, H, W, C, Co, nht, nwt, kd, ci0, co0, nruns, stride;

  __device__ bool valid(int r) const {
    const int d = (r / (nht * nwt)) % D;
    return d + kd - 1 >= 0 && d + kd - 1 < D;
  }
  // the first valid run at or after r on this block's stride, or nruns
  __device__ int next(int r) const {
    while (r < nruns && !valid(r)) r += stride;
    return r < nruns ? r : nruns;
  }
  __device__ void open(int r, const __nv_bfloat16* x,
                       const __nv_bfloat16* dy, Run& run) const {
    const int w0 = (r % nwt) * kWT;
    int t = r / nwt;
    run.h = (t % nht) * kHRun;
    run.hend = min(H, run.h + kHRun);
    t /= nht;
    const int d = t % D, b = t / D;
    run.xp = x + (long long)(b * D + d + kd - 1) * H * W * C;
    run.dyp = dy + (long long)(b * D + d) * H * W * Co;
    const int wt = min(kWT, W - w0);
    run.ks = (wt + 15) >> 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = threadIdx.x + j * kWgThreads;
      const int s = e / kGroups, g = e - s * kGroups;
      const int gw = w0 + s - 1, ci = ci0 + g * 8;
      run.xoff[j] = e < kXChunks && gw >= 0 && gw < W && ci < C
                        ? gw * C + ci
                        : -1;
      run.dyoff[j] = e < kDyChunks && s < wt && co0 + g * 8 < Co
                         ? (w0 + s) * Co + co0 + g * 8
                         : -1;
    }
  }
};

// Start the copies of x row xh of the run (zero outside the volume) into
// xs and, when ds is given, of dy row h into ds: channel groups past C or Co
// and voxels past the row are zero.
__device__ __forceinline__ void stage_row(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
    const Walk& wk, const Run& run, int xh, int h, unsigned char* xs,
    unsigned char* ds) {
  if (MEDSEG_K5_SKIP & 2) return;
  const bool xin = xh >= 0 && xh < wk.H;
  const __nv_bfloat16* xrow = run.xp + (long long)(xin ? xh : 0) * wk.W * wk.C;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = threadIdx.x + j * kWgThreads;
    const bool ok = xin && run.xoff[j] >= 0;
    if (e < kXChunks)
      cp_async16_zfill(xs + chunk_slot_offset(e, kXRows),
                       ok ? xrow + run.xoff[j] : x, ok);
  }
  if (ds == nullptr) return;
  const __nv_bfloat16* drow = run.dyp + (long long)h * wk.W * wk.Co;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = threadIdx.x + j * kWgThreads;
    const bool ok = run.dyoff[j] >= 0;
    if (e < kDyChunks)
      cp_async16_zfill(ds + chunk_slot_offset(e, kWT),
                       ok ? drow + run.dyoff[j] : dy, ok);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// grid (3 . nci . nco, shares). part: (shares, 27, C, Co). C and Co are
// multiples of 8, so every 16-byte chunk of a row is inside or outside.
__global__ void __launch_bounds__(kWgThreads, 1)
    dw27_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ dy,
                      float* __restrict__ part, int B, int D, int H, int W,
                      int C, int Co, int nci, int nco) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* xring = smem_raw;
  unsigned char* dyring = xring + kXSlots * kXSlotBytes;
  float* sums = reinterpret_cast<float*>(dyring + kDySlots * kDySlotBytes);
  const int tid = threadIdx.x, kh = tid >> 7, t128 = tid & 127;
  const int wwarp = t128 >> 5, lane = tid & 31;
  int o = blockIdx.x;
  const int co0 = (o % nco) * kCT;
  o /= nco;
  const int ci0 = (o % nci) * kCT;
  const int kd = o / nci;

  Walk wk;
  wk.D = D; wk.H = H; wk.W = W; wk.C = C; wk.Co = Co; wk.kd = kd;
  wk.ci0 = ci0; wk.co0 = co0;
  wk.nht = (H + kHRun - 1) / kHRun;
  wk.nwt = (W + kWT - 1) / kWT;
  wk.nruns = B * D * wk.nht * wk.nwt;  // < 2^31 - 65535, checked by the host
  wk.stride = gridDim.y;

  // dy groups 6 and 7 (rows 48-63 of M) stay zero; the sums start at 0
  for (int e = tid; e < kDySlots * kDyGroups * kWT; e += blockDim.x)
    if ((e / kWT) % kDyGroups >= kGroups)
      *reinterpret_cast<uint4*>(dyring + e * 16) = make_uint4(0, 0, 0, 0);
  const bool owns_sums = wwarp < 3;
  float* my_sums = sums + kh * 3 * kAcc * kSumThreads + t128;
  if (owns_sums)
    for (int i = 0; i < 3 * kAcc; ++i) my_sums[i * kSumThreads] = 0.f;

  float acc[3][kAcc];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[k][i] = 0.f;

  // The steps: run r, dy row h in [h0, h1). The x rows stream through the
  // ring: a run brings its rows h0 - 1 .. h1 (h1 - h0 + 2 of them), and step
  // h reads the three at stream positions xpos .. xpos + 2. The loads run
  // kAhead steps ahead of the products; each step's ring position and k
  // steps wait in a queue.
  int lr = wk.next(blockIdx.y), xhead = 0, loaded = 0;
  Run run;
  if (lr < wk.nruns) wk.open(lr, x, dy, run);
  bool lfresh = true;
  int q_xpos[kAhead + 1], q_ks[kAhead + 1];
  auto load_step = [&]() {
    if (lr >= wk.nruns) return;
    const int q = loaded % (kAhead + 1);
    unsigned char* dslot = dyring + (loaded % kDySlots) * kDySlotBytes;
    if (lfresh) {
      for (int i = 0; i < 3; ++i)
        stage_row(x, dy, wk, run, run.h - 1 + i, run.h,
                  xring + ((xhead + i) % kXSlots) * kXSlotBytes,
                  i == 0 ? dslot : nullptr);
      q_xpos[q] = xhead;
      xhead += 3;
    } else {
      stage_row(x, dy, wk, run, run.h + 1, run.h,
                xring + (xhead % kXSlots) * kXSlotBytes, dslot);
      q_xpos[q] = xhead - 2;
      xhead += 1;
    }
    q_ks[q] = run.ks;
    ++loaded;
    lfresh = ++run.h >= run.hend;
    if (lfresh) {
      lr = wk.next(lr + wk.stride);
      if (lr < wk.nruns) wk.open(lr, x, dy, run);
    }
  };
  for (int i = 0; i < kAhead; ++i) {
    load_step();
    cp_async_commit();
  }

  const uint32_t xring_s = smem_u32(xring), dyring_s = smem_u32(dyring);
  int pending = 0;
  for (int step = 0; step < loaded; ++step) {
    // this step's rows are in (the kAhead - 1 later steps' may still fly)
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    fence_proxy_async();  // this thread's copies, seen by the tensor cores
    __syncthreads();      // everyone's copies are in; the last step's reads done
    load_step();          // kAhead steps on, into slots no product reads
    cp_async_commit();

    // this warpgroup's three taps on x row h + kh - 1
    const int q = step % (kAhead + 1);
    const int ksteps = q_ks[q];
    const uint32_t a0 = dyring_s + (step % kDySlots) * kDySlotBytes;
    const uint32_t b0 = xring_s + ((q_xpos[q] + kh) % kXSlots) * kXSlotBytes;
    const int fresh = pending == 0;  // the first step after a flush
    // dy^T fragments: four 8 x 8 core matrices (co groups 2w, 2w + 1 x
    // voxels 0-7, 8-15 of the k step), transposed by ldmatrix, so that one
    // load serves the three taps
    const uint32_t a_lane = a0 + (2 * wwarp + ((lane >> 3) & 1)) * kWT * 16 +
                            ((lane >> 4) * 8 + (lane & 7)) * 16;
    uint32_t af[2][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) fence_regs(acc[k]);
#pragma unroll
    for (int ks = 0; ks < kWT / 16; ++ks) {
      if (ks < ksteps && !(MEDSEG_K5_SKIP & 1)) {
        uint32_t(&a)[4] = af[ks & 1];
        ldmatrix_x4_trans(a, a_lane + ks * 256);
        fence_regs(a);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 3; ++k)
          wgmma_m64n48k16_rs(
              acc[k], a, smem_desc(b0 + k * 16 + ks * 256, 128, kXRows * 16),
              !fresh || ks > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the fragments of the step before are free
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < 3; ++k) fence_regs(acc[k]);
    if (++pending == kFlush) {
      pending = 0;
      if (owns_sums && !(MEDSEG_K5_SKIP & 4)) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int i = 0; i < kAcc; ++i)
            my_sums[(k * kAcc + i) * kSumThreads] += acc[k][i];
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  wgmma_wait<0>();
#pragma unroll
  for (int k = 0; k < 3; ++k) fence_regs(acc[k]);

  // accumulator fragment of warp w: rows (co) 16w + g and + 8, columns (ci)
  // 8j + 2t and + 1, in accumulators 4j .. 4j + 3
  if (!owns_sums) return;
  float* p = part + (size_t)blockIdx.y * 27 * C * Co;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int co = co0 + wwarp * 16 + g + ((i >> 1) & 1) * 8;
      const int ci = ci0 + (i >> 2) * 8 + t2 + (i & 1);
      float v = my_sums[(k * kAcc + i) * kSumThreads];
      if (pending > 0) v += acc[k][i];
      if (ci < C && co < Co)
        p[((size_t)((kd * 3 + kh) * 3 + k) * C + ci) * Co + co] = v;
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* part, int b, int d,
                   int h, int w, int c, int co, int shares, cudaStream_t st) {
  const int nci = (c + kCT - 1) / kCT, nco = (co + kCT - 1) / kCT;
  cudaError_t err = cudaFuncSetAttribute(
      dw27_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dw27_kernel<T><<<dim3(9 * nci * nco, shares), kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, b, d, h, w, c,
      co, nci, nco);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medseg

// x (b, d, h, w, c) and dy (b, d, h, w, co), contiguous. route 0: both fp32,
// CUDA cores; 1: both bf16, CUDA cores; 2: both bf16 with c and co multiples
// of 8, tensor cores (3 . nci . nco blocks a share); 3: both fp16, CUDA
// cores. part (shares, 27 * c * co) is scratch; out (3, 3, 3, c, co) fp32.
extern "C" int medseg_dw27(const void* x, const void* dy, void* part,
                           void* out, int b, int d, int h, int w, int c,
                           int co, int shares, int route, void* stream) {
  using namespace medseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || d < 1 || h < 1 || w < 1 || c < 1 || co < 1 || shares < 1 ||
      shares > 65535 || route < 0 || route > 3 ||
      (route == 2 &&
       (c % 8 != 0 || co % 8 != 0 ||
        (long long)b * d * ((h + kHRun - 1) / kHRun) * ((w + kWT - 1) / kWT) >
            2147483647LL - 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* partf = static_cast<float*>(part);
  cudaError_t err;
  if (route == 2) {
    const int nci = (c + kCT - 1) / kCT, nco = (co + kCT - 1) / kCT;
    err = cudaFuncSetAttribute(dw27_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kWgSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dw27_wgmma_kernel<<<dim3(3 * nci * nco, shares), kWgThreads, kWgSmem,
                        st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), partf, b, d, h, w, c, co, nci,
        nco);
    err = cudaGetLastError();
  } else if (route == 1) {
    err = launch<__nv_bfloat16>(x, dy, partf, b, d, h, w, c, co, shares, st);
  } else if (route == 3) {
    err = launch<__half>(x, dy, partf, b, d, h, w, c, co, shares, st);
  } else {
    err = launch<float>(x, dy, partf, b, d, h, w, c, co, shares, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sum_partials(partf, static_cast<float*>(out), shares,
                     27LL * c * co, st);
  return static_cast<int>(err);
}
