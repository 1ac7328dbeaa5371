// 3x3x3 / stride-1 / SAME convolution as Winograd F(2^3, 3^3), with an
// optional scale / shift / LeakyReLU pass over the input folded in.
//
// Replaces the TPU kernel medicalsemseg_tpu/ops/pallas/winograd3d.py:
// winograd_conv3d_f23 (_kernel). For x (B, D, H, W, C) and the
// Winograd-domain weights u (64 points, Co, C) (transformed by the wrapper,
// point (a, b, c) = d, h, w index, a-major), every 2^3 tile of outputs comes
// from the 4^3 tile of inputs around it:
//   V[abc] = B^T_a B^T_b B^T_c x      (input transform, per channel)
//   M[abc] = V[abc] (tiles, C) . u[abc] (C, Co)     64 products, not 216
//   y      = A^T_a A^T_b A^T_c M      (output transform, per channel)
// With ep (B, 2, C) fp32 the conv's input is lrelu?(x * scale + shift), the
// folded form of an InstanceNorm (+ LeakyReLU) before the conv, with the SAME
// padding still zero. Rounding points are the TPU kernel's, which computes
// in x's dtype: the activation and each of the three input-transform stages
// (w, then h, then d) round to x's dtype, the weights are transformed in fp32
// and rounded once, products add in fp32, the output transform is fp32 and y
// rounds once.
//
// Two routes, picked by the wrapper from the dtype (ops/kernels/winograd3d.py):
// winograd_f23_kernel<T> for bf16 and fp16 on the tensor cores (below), and
// winograd_f23_fp32_kernel for fp32 on the CUDA cores (at the end of the
// file; fp32 FMA, no TF32, which would change the function).
//
// The TPU kernel splits W into even / odd phase arrays on the host, lane-pads
// C to 128, walks (4, 4, whole W row) blocks and so needs D % 4, H % 4,
// (W / 2) % 8. Here x is read from its own layout and the border is a bounds
// check, so any D, H, W runs (an odd size is a masked tail of a tile).
//
// Design for Hopper (the tensor-core route; T is __nv_bfloat16 or __half,
// K9Type<T> carries the packed type, its conversions and the wgmma string,
// and nothing else differs between the two). A block owns 4 x 8 x 16 output voxels = 64 Winograd
// tiles of one sample (wgmma's M) and a tile of 48 output channels (its N),
// stages the 6 x 10 x 18 halo tile of 48 input channels once per chunk
// (conv_tile.cuh, with ep applied there) and runs two consumer warpgroups
// and one producer warp:
//  - A = V from registers. Each thread builds the wgmma A fragments it
//    multiplies (2 tiles x 4 channels a point and 16 channels) straight from
//    the staged tile with packed 16-bit adds, so V never goes through shared
//    memory (the old design's V build, 3.1 ms of 10.7 at 16 x 96^3, wrote V
//    and read it back with ldmatrix three times over). The staged tile is
//    swizzled (8-channel chunks XOR bit 3 of the voxel's w) so that the
//    eight tiles a warp's lanes read at once fall in distinct banks.
//  - B = u from shared memory, K-major, laid out by the wrapper in the
//    core-matrix order wgmma reads. A producer warpgroup (one thread of it
//    busy, its registers handed to the consumers with setmaxnreg) streams it
//    with TMA bulk copies, one 18 KB slab per (a, b) point pair (its 4 c points x 48 input
//    channels x 48 output channels), into a ring of 4 slots with full / empty
//    mbarriers: no block-wide barrier per pair.
//  - The register reckoning of the output fold. A thread of a warpgroup
//    holds 24 fp32 values of every 64 x 48 accumulator. The progressive fold
//    (over c into 2 sums, over b into 4, over a into 8) would keep 15 of them
//    live, 360 registers: over the 255 a thread may have. So the fold is cut
//    three ways: the c fold runs inside the tensor cores (p0 = M0 + M1 + M2
//    and p1 = M1 - M2 - M3 as chains of three products each, the minus signs
//    as wgmma's scale-a = -1), and the a fold is split between the two
//    warpgroups, one per output row iu: warpgroup iu takes the three a with
//    A^T[iu][a] != 0 and folds b and a straight into its four outputs
//    y[iu][iv][iw] (96 registers) from p0, p1 (48): ~200 a thread, no q.
//    The price: 6 products per (a, b) pair instead of 4 and 12 pairs per
//    warpgroup instead of 8 (2.25 times the tensor work, still fewer than the
//    216 of the direct conv), and the V of a = 1, 2 built by both
//    warpgroups. 232 registers a consumer thread hold it without spilling
//    (the producer keeps 40).
//  - Why no wider block: at 96 output channels the 8 fp32 outputs of 64
//    tiles are 196 KB, three quarters of the SM's register file, so a block
//    owning all of them cannot exist; more output channels than 48 are
//    further blocks (grid z), each building its V again.
//  - More input channels than 48 are further chunks added into the same
//    outputs (the fold is linear).
// The epilogue is applied where the tile is staged and only inside the
// volume, so the halo stays 0.
//
// What bounds it on the card: the function's bound is bytes (x read once, y
// written once). Timed with its parts compiled out (MEDSEG_K9_SKIP; 16 x 96^3,
// 48 -> 48 on an H100, 7.8 ms in all): the products and folds take ~3.5 ms,
// 2.9 times their time at the tensor-core rate, the staging of x 2.2 and the
// V build 1.7 (64 shared-memory loads and ~112 packed adds per thread per
// (a, b) pair and 16 channels). The register file allows one block of two
// consumer warpgroups per SM, so a block's staging and its products do not
// overlap.

#include "conv_tile.cuh"
#include "hopper.cuh"

// The card's machine has no kernel profiler, so the kernel's parts can be
// compiled out to time the rest (chip_smoke.py --phases k9_parts; the result
// is then wrong): bit 1 the V build, 2 the products and the folds, 4 the u
// copies, 8 the staging of x. Undefined in every other build.
#ifndef MEDSEG_K9_SKIP
#define MEDSEG_K9_SKIP 0
#endif

namespace medseg {
namespace {

using namespace convtile;
using namespace hopper;

// The routes of the C entry point (ops/kernels/__init__.py ROUTES).
constexpr int kCudaCore = 0, kTensorCore = 1;

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kWinoThreads = kConsumers + 128;  // and the producer's
// registers a thread after setmaxnreg: the producer gives up what the
// consumers take (2 x 128 x 232 + 128 x 40 <= 65,536)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kN = kCoB;                    // 48 output channels a block
constexpr int kSteps = kCK / 16;            // k steps of a staged chunk
constexpr int kStepBytes = 2 * kN * 16;     // u of one point and k step
constexpr int kSlabBytes = 4 * kSteps * kStepBytes;  // one (a, b) pair
constexpr int kSlots = 4;
constexpr int kAcc = kN / 2;                // fp32 a thread per accumulator
constexpr size_t kSmemBytes = kXsBytes + (size_t)kSlots * kSlabBytes +
                              2 * kSlots * sizeof(uint64_t) +
                              2 * kCK * sizeof(float);  // a chunk's ep rows

// The consumers' own barrier (the producer warp never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  // K-major, no swizzle: core matrices of 8 output channels x 8 input
  // channels; the next 8 input channels (leading) kN rows of 16 bytes on, the
  // next 8 output channels (stride) 128 bytes on
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((kN * 16) >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// The element types of the tensor-core route: the packed pair, its
// conversions, and d (64 x 48 fp32) [+]= sign * A (64 x 16, T in registers)
// . B (16 x 48, T, K-major in shared memory) as the wgmma of the type.
template <class T>
struct K9Type;

template <>
struct K9Type<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ T2 splat(float v) {
    return __float2bfloat162_rn(v);
  }
  static __device__ __forceinline__ T2 pack(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  // a bf16 is the top half of the fp32 of the same value
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xFFFF0000u));
  }
  template <int kSign>
  static __device__ __forceinline__ void mma(float (&d)[kAcc],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
        "%28, p, %30, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kSign));
  }
};

template <>
struct K9Type<__half> {
  using T2 = __half2;
  static __device__ __forceinline__ T2 splat(float v) {
    return __float2half2_rn(v);
  }
  static __device__ __forceinline__ T2 pack(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t v) {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  }
  template <int kSign>
  static __device__ __forceinline__ void mma(float (&d)[kAcc],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
        "%28, p, %30, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate), "n"(kSign));
  }
};

// Row r of B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] as
// first + sign * second.
__device__ __forceinline__ void bt_row(int r, int* first, int* second,
                                       float* sign) {
  *first = r == 0 ? 0 : (r == 2 ? 2 : 1);
  *second = r == 0 ? 2 : (r == 1 ? 2 : (r == 2 ? 1 : 3));
  *sign = r == 1 ? 1.f : -1.f;
}

// Entry r of row i of A^T = [[1,1,1,0],[0,1,-1,-1]].
__device__ __forceinline__ float at(int i, int r) {
  return i == 0 ? (r < 3 ? 1.f : 0.f) : (r == 0 ? 0.f : (r == 1 ? 1.f : -1.f));
}

template <class T2, class T>
__device__ __forceinline__ T2 ld2(const T* p) {
  return *reinterpret_cast<const T2*>(p);
}

template <class T2>
__device__ __forceinline__ uint32_t as_u32(T2 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The four c points of V[a, b] for one tile and channel pair, packed pairs
// rounded to T after each stage (w, then h, then d) as the TPU body does;
// base is the tile's corner voxel in the staged halo tile, chan[k] the
// pair's (swizzled) place in the rows of the corner's w + k.
template <class T, class T2 = typename K9Type<T>::T2>
__device__ __forceinline__ void build_v4(const T* base, const int (&chan)[4],
                                         int i0, int i1, T2 sa2, int j0,
                                         int j1, T2 sb2, T2 (&v)[4]) {
  T2 hrow[2][4];
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    T2 wv[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const T* row =
          base + (((ii ? i1 : i0) * kHH + (jj ? j1 : j0)) * kHW) * kRow;
      const T2 x0 = ld2<T2>(row + chan[0]), x1 = ld2<T2>(row + kRow + chan[1]),
               x2 = ld2<T2>(row + 2 * kRow + chan[2]),
               x3 = ld2<T2>(row + 3 * kRow + chan[3]);
      wv[jj][0] = __hsub2(x0, x2);
      wv[jj][1] = __hadd2(x1, x2);
      wv[jj][2] = __hsub2(x2, x1);
      wv[jj][3] = __hsub2(x1, x3);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) hrow[ii][c] = __hfma2(sb2, wv[1][c], wv[0][c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = __hfma2(sa2, hrow[1][c], hrow[0][c]);
}

// The staged tile's layout: xs[v * kRow + 8 (k ^ s) + i] holds channel 8k + i
// of halo voxel v = (hd * kHH + hh) * kHW + hw, with s = bit 3 of hw. The
// swizzle spreads the eight tiles (tw = 0..7) that the lanes g of a warp read
// at once over all 32 banks; without it tiles g and g + 4 share banks.
__device__ __forceinline__ int swz(int hw) { return (hw >> 3) & 1; }

// lrelu?(v * scale + shift) on the two values of a word (channels 2i,
// 2i + 1 of a chunk), in fp32 and rounded to T.
template <class T>
__device__ __forceinline__ uint32_t act2(uint32_t v, float2 scale,
                                         float2 shift, int lrelu,
                                         float slope) {
  const float2 in = K9Type<T>::unpack(v);
  float lo = __fadd_rn(__fmul_rn(in.x, scale.x), shift.x);
  float hi = __fadd_rn(__fmul_rn(in.y, scale.y), shift.y);
  if (lrelu && !(lo >= 0.f)) lo = __fmul_rn(lo, slope);
  if (lrelu && !(hi >= 0.f)) hi = __fmul_rn(hi, slope);
  return as_u32(K9Type<T>::pack(lo, hi));
}

// Stage channels c0 .. c0 + ckp of the halo tile in that layout, zero
// outside the volume and past C (with ep (2 x ckp fp32, this chunk's scale
// and shift rows, in shared memory, zero past C) applied inside the volume
// only), by the consumers' threads: kBatch 16-byte loads in flight a thread
// before the first store.
constexpr int kBatch = 4;

template <class T>
__device__ __forceinline__ void stage_swizzled(
    T* xs, const T* __restrict__ x,
    const float* eps, int lrelu, float slope, int D, int H, int W, int C,
    int d0, int h0, int w0, int c0, int ckp, bool vec, int tid) {
  const int nchunk = ckp >> 3, total = kHalo * nchunk;
  for (int e0 = tid; e0 < total; e0 += kBatch * kConsumers) {
    uint4 raw[kBatch];
    bool in[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kConsumers;
      const int v = e / nchunk, k = e - v * nchunk;
      const int hw = v % kHW, hh = (v / kHW) % kHH, hd = v / (kHW * kHH);
      const int gd = d0 + hd - 1, gh = h0 + hh - 1, gw = w0 + hw - 1;
      in[j] = e < total && gd >= 0 && gd < D && gh >= 0 && gh < H &&
              gw >= 0 && gw < W;
      raw[j] = make_uint4(0u, 0u, 0u, 0u);
      if (in[j]) {
        const int ci0 = c0 + 8 * k;
        const long long base = (((long long)gd * H + gh) * W + gw) * C + ci0;
        if (vec && ci0 + 8 <= C) {
          raw[j] = __ldg(reinterpret_cast<const uint4*>(x + base));
        } else {
          __align__(16) T vals[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            vals[i] = ci0 + i < C ? x[base + i] : from_f32<T>(0.f);
          raw[j] = *reinterpret_cast<const uint4*>(vals);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kConsumers;
      if (e >= total) break;
      const int v = e / nchunk, k = e - v * nchunk;
      if (in[j] && eps != nullptr) {
        // channels past C load as 0 and their scale and shift are 0
        const float2* sc = reinterpret_cast<const float2*>(eps + 8 * k);
        const float2* sh = reinterpret_cast<const float2*>(eps + kCK + 8 * k);
        raw[j].x = act2<T>(raw[j].x, sc[0], sh[0], lrelu, slope);
        raw[j].y = act2<T>(raw[j].y, sc[1], sh[1], lrelu, slope);
        raw[j].z = act2<T>(raw[j].z, sc[2], sh[2], lrelu, slope);
        raw[j].w = act2<T>(raw[j].w, sc[3], sh[3], lrelu, slope);
      }
      *reinterpret_cast<uint4*>(xs + v * kRow + 8 * (k ^ swz(v % kHW))) =
          raw[j];
    }
  }
}

// The point pair of the producer's n-th slab: a = 1, 2 first (both
// warpgroups take them), then a = 0 and a = 3 in turns (one each).
__device__ __forceinline__ void pair_of(int n, int* a, int* b) {
  if (n < 8) {
    *a = 1 + (n >> 2);
    *b = n & 3;
  } else {
    *a = (n & 1) ? 3 : 0;
    *b = (n - 8) >> 1;
  }
}

// grid (tiles of the volume, B, Co tiles of 48). u: (Co tiles, C chunks of 48,
// 64 points, 3 k steps, 2 halves of 8 input channels, 48 output channels, 8).
template <class T>
__global__ void __launch_bounds__(kWinoThreads, 1)
    winograd_f23_kernel(const T* __restrict__ x, const T* __restrict__ u,
                        const float* __restrict__ ep, T* __restrict__ y, int D,
                        int H, int W, int C, int Co, int CP, int lrelu,
                        float slope, int nht, int nwt) {
  using T2 = typename K9Type<T>::T2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  unsigned char* ring = smem_raw + kXsBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSlots * kSlabBytes);
  uint64_t* empty = full + kSlots;
  float* eps = reinterpret_cast<float*>(empty + kSlots);  // 2 x kCK
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int d0, h0, w0;
  tile_origin(nht, nwt, &d0, &h0, &w0);
  const int b = blockIdx.y, cot = blockIdx.z;
  const long long vox = (long long)D * H * W;
  const int nchunk = CP / kCK;

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer warpgroup: one thread streams the u slabs, 16 per chunk
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const unsigned char* ub = reinterpret_cast<const unsigned char*>(u) +
                                (size_t)cot * nchunk * 16 * kSlabBytes;
      int seq = 0;
      for (int ch = 0; ch < nchunk; ++ch)
        for (int n = 0; n < 16; ++n, ++seq) {
          const int s = seq % kSlots;
          mbar_wait(&empty[s], ((seq / kSlots) & 1) ^ 1);
          int a, bb;
          pair_of(n, &a, &bb);
          if (MEDSEG_K9_SKIP & 4) {
            mbar_arrive(&full[s]);
          } else {
            mbar_arrive_tx(&full[s], kSlabBytes);
            bulk_copy(ring + s * kSlabBytes,
                      ub + ((size_t)ch * 16 + a * 4 + bb) * kSlabBytes,
                      kSlabBytes, &full[s]);
          }
        }
    }
    return;
  }

  // the consumers: warpgroup iu folds the three a with A^T[iu][a] != 0 into
  // its outputs y[iu][iv][iw]
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int iu = tid >> 7, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const T* xb = x + b * vox * C;
  const float* epb = ep == nullptr ? nullptr : ep + (long long)b * 2 * C;
  // this thread's tiles: rows g and g + 8 of warp wq are tiles (td, th, tw)
  // = (wq / 2, 2 (wq % 2) + {0, 1}, g); their corner in the halo tile
  const int corner0 = ((2 * (wq >> 1) * kHH + 2 * (2 * (wq & 1))) * kHW +
                       2 * g) * kRow;
  const int corner1 = corner0 + 2 * kHW * kRow;

  float yacc[2][2][kAcc];
#pragma unroll
  for (int iv = 0; iv < 2; ++iv)
#pragma unroll
    for (int iw = 0; iw < 2; ++iw)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) yacc[iv][iw][i] = 0.f;

  int seq = 0;
  for (int ch = 0; ch < nchunk; ++ch) {
    const int c0 = ch * kCK;
    const int ckp = (min(kCK, C - c0) + 15) & ~15;
    const int nks = ckp >> 4;
    if (epb != nullptr && tid < 2 * kCK) {
      // this chunk's scale and shift rows (zero past C)
      const int row = tid / kCK, cc = tid - row * kCK;
      eps[tid] = c0 + cc < C ? epb[row * C + c0 + cc] : 0.f;
    }
    consumers_sync();  // every V build of the last chunk is done, eps set
    if (!(MEDSEG_K9_SKIP & 8))
      stage_swizzled(xs, xb, epb == nullptr ? nullptr : eps, lrelu, slope, D,
                     H, W, C, d0, h0, w0, c0, ckp, (C & 7) == 0, tid);
    consumers_sync();

    for (int n = 0; n < 16; ++n, ++seq) {
      const int s = seq % kSlots;
      int a, bb;
      pair_of(n, &a, &bb);
      const float sa_out = at(iu, a);
      mbar_wait(&full[s], (seq / kSlots) & 1);
      if (sa_out != 0.f && !(MEDSEG_K9_SKIP & 2)) {
        int i0, i1, j0, j1;
        float sa, sb;
        bt_row(a, &i0, &i1, &sa);
        bt_row(bb, &j0, &j1, &sb);
        const T2 sa2 = K9Type<T>::splat(sa), sb2 = K9Type<T>::splat(sb);
        const uint32_t slab = smem_u32(ring + s * kSlabBytes);
        float p0[kAcc], p1[kAcc];
        uint32_t va[2][4][4];  // two sets of the four points' A fragments
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          if (ks < nks) {
            uint32_t(&v)[4][4] = va[ks & 1];
            if (!(MEDSEG_K9_SKIP & 1)) {
              // fragment registers: (tile g, ch 2t), (tile g + 8, ch 2t),
              // (tile g, ch 2t + 8), (tile g + 8, ch 2t + 8)
              // the two 8-channel chunks 2 ks and 2 ks + 1, swizzled by
              // the w of each of the four taps
              int lo[4], hi[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int s = swz(2 * g + k);
                lo[k] = 8 * ((2 * ks) ^ s) + 2 * t4;
                hi[k] = 8 * ((2 * ks + 1) ^ s) + 2 * t4;
              }
              T2 q[4][4];
              build_v4(xs + corner0, lo, i0, i1, sa2, j0, j1, sb2, q[0]);
              build_v4(xs + corner1, lo, i0, i1, sa2, j0, j1, sb2, q[1]);
              build_v4(xs + corner0, hi, i0, i1, sa2, j0, j1, sb2, q[2]);
              build_v4(xs + corner1, hi, i0, i1, sa2, j0, j1, sb2, q[3]);
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int r = 0; r < 4; ++r) v[c][r] = as_u32(q[r][c]);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int r = 0; r < 4; ++r) v[c][r] = 0u;
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) fence_regs(v[c]);
            fence_regs(p0);
            fence_regs(p1);
            wgmma_fence();
            const uint32_t st = slab + ks * kStepBytes;
            const int acc = ks > 0;
            // p0 = M0 + M1 + M2, p1 = M1 - M2 - M3, over this k step
            using K = K9Type<T>;
            K::template mma<1>(p0, v[0], kmajor_desc(st + 0 * kSteps * kStepBytes), acc);
            K::template mma<1>(p0, v[1], kmajor_desc(st + 1 * kSteps * kStepBytes), 1);
            K::template mma<1>(p0, v[2], kmajor_desc(st + 2 * kSteps * kStepBytes), 1);
            K::template mma<1>(p1, v[1], kmajor_desc(st + 1 * kSteps * kStepBytes), acc);
            K::template mma<-1>(p1, v[2], kmajor_desc(st + 2 * kSteps * kStepBytes), 1);
            K::template mma<-1>(p1, v[3], kmajor_desc(st + 3 * kSteps * kStepBytes), 1);
            wgmma_commit();
            // the set before this one is free once its group is done
            wgmma_wait<1>();
          }
        }
        wgmma_wait<0>();
        fence_regs(p0);
        fence_regs(p1);
        // over b and a into this warpgroup's outputs
        const float s0 = sa_out * at(0, bb), s1 = sa_out * at(1, bb);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          yacc[0][0][i] += s0 * p0[i];
          yacc[0][1][i] += s0 * p1[i];
          yacc[1][0][i] += s1 * p0[i];
          yacc[1][1][i] += s1 * p1[i];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // outputs: accumulator element i of warp wq is row g + 8 ((i >> 1) & 1),
  // column 8 (i >> 2) + 2t + (i & 1); row r is tile (wq / 2, 2 (wq % 2) + r
  // / 8, r % 8), output voxel (2 td + iu, 2 th + iv, 2 tw + iw)
  consumers_sync();  // every warp is done with the input tile
  T* os = xs;
  const int od = 2 * (wq >> 1) + iu;
#pragma unroll
  for (int iv = 0; iv < 2; ++iv)
#pragma unroll
    for (int iw = 0; iw < 2; ++iw)
#pragma unroll
      for (int i = 0; i < kAcc; i += 2) {
        const int oh = 2 * (2 * (wq & 1) + ((i >> 1) & 1)) + iv;
        const int ow = 2 * g + iw;
        *reinterpret_cast<T2*>(
            os + ((od * kTH + oh) * kTW + ow) * kCoB + 8 * (i >> 2) + 2 * t4) =
            K9Type<T>::pack(yacc[iv][iw][i], yacc[iv][iw][i + 1]);
      }
  consumers_sync();
  store_output(os, y + b * vox * Co, D, H, W, Co, d0, h0, w0, cot * kN,
               (Co & 7) == 0, tid, kConsumers);
}

template <class T>
cudaError_t launch_tc(const void* x, const void* u, const void* ep, void* y,
                      int b, int d, int h, int w, int c, int co, int cp,
                      int cop, int lrelu, float slope, cudaStream_t st) {
  const int ndt = (d + kTD - 1) / kTD, nht = (h + kTH - 1) / kTH,
            nwt = (w + kTW - 1) / kTW;
  cudaError_t err = cudaFuncSetAttribute(
      winograd_f23_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  winograd_f23_kernel<T><<<dim3(ndt * nht * nwt, b, cop / kCoB), kWinoThreads,
                           kSmemBytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(u),
      static_cast<const float*>(ep), static_cast<T*>(y), d, h, w, c, co, cp,
      lrelu, slope, nht, nwt);
  return cudaGetLastError();
}

// ---- the CUDA-core route (fp32) --------------------------------------------
//
// winograd_f23_fp32_kernel: fp32 FMA, no TF32, every value in fp32 (the TPU
// kernel's rounding points are the identity there), a simple kernel that is
// right. A block owns the tensor-core route's tile of the volume (64
// Winograd tiles) and 16 output channels; a thread one tile and 8 of them,
// the four warps' lanes on distinct tiles of the same 8 channels, so that
// their weight loads are broadcasts. Per chunk of 4 input channels the halo
// tile (channel-major, the epilogue applied inside the volume) and the
// chunk's 64 x 4 x 16 Winograd-domain weights sit in shared memory (40 KB: a
// few blocks an SM hide each other's load latency). A thread
// walks the 16 (a, b) point pairs: it builds the four V[a, b, c] of its tile
// from 16 halo values per channel, adds V . u over the chunk's channels into
// M[c] (4 x 8 sums), and folds c, b and a into its 8 outputs x 8 channels,
// as the tensor-core route does. Its bound is the fp32 rate (67 TFLOP/s) on
// the 64 products a tile. The channel loop stays rolled: unrolled, ptxas
// hoisted the loads of all its steps and spilled (255 registers, 1.4 KB of
// spill stores; 213 ms at 16 x 96^3, 48 -> 48, on an H100 80GB HBM3 at
// 700 W). Rolled it takes 72.7 ms there, 10.7 % of its bound (cuDNN's fp32
// conv without TF32: 82.1 ms); unrolling by 2, 8 channels a chunk or a
// 128-register cap did not make it faster. Its instruction count and its
// shared-memory wavefronts (24 a warp, point pair and channel) each predict
// ~30 ms: what holds it at 72.7 is not known.

constexpr int kCcCK = 4;     // input channels a staged chunk
constexpr int kCcCo = 16;    // output channels a block
constexpr int kCcCoT = 8;    // output channels a thread
constexpr int kCcTiles = (kTD / 2) * (kTH / 2) * (kTW / 2);   // 64
constexpr int kCcThreads = kCcTiles * (kCcCo / kCcCoT);       // 128
// a staged halo row of 18 voxels is 24 floats apart from the next: the two
// h rows a half-warp's lanes read at once (th, th + 1) then fall 48 words
// apart, in the other half of the banks, so an 8-byte load takes two
// wavefronts, not four
constexpr int kCcHW = 24;
constexpr int kCcHalo = kHD * kHH * kCcHW;
constexpr size_t kCcSmem =
    sizeof(float) * ((size_t)kCcCK * kCcHalo + 64 * kCcCK * kCcCo + 2 * kCcCK);

// grid (tiles of the volume, B, Co / 16). u: (64 points, C, Co) fp32.
__global__ void __launch_bounds__(kCcThreads, 3)
    winograd_f23_fp32_kernel(const float* __restrict__ x,
                             const float* __restrict__ u,
                             const float* __restrict__ ep,
                             float* __restrict__ y, int D, int H, int W, int C,
                             int Co, int lrelu, float slope, int nht,
                             int nwt) {
  extern __shared__ __align__(16) float smem_f[];
  float* xs = smem_f;    // xs[ci * kCcHalo + (hd * kHH + hh) * kCcHW + hw]
  float* us = xs + kCcCK * kCcHalo;  // us[(p * kCcCK + ci) * kCcCo + co]
  float* eps = us + 64 * kCcCK * kCcCo;      // the chunk's scale, shift rows
  const int tid = threadIdx.x;
  int d0, h0, w0;
  tile_origin(nht, nwt, &d0, &h0, &w0);
  const int b = blockIdx.y, co0 = blockIdx.z * kCcCo;
  const long long vox = (long long)D * H * W;
  const float* xb = x + b * vox * C;
  const float* epb = ep == nullptr ? nullptr : ep + (long long)b * 2 * C;
  // this thread's tile (tw fastest) and output channels cog * 8 .. + 8
  const int tile = tid % kCcTiles, cog = tid / kCcTiles;
  const int tw = tile % (kTW / 2), th = (tile / (kTW / 2)) % (kTH / 2),
            td = tile / ((kTW / 2) * (kTH / 2));
  const int corner = (2 * td * kHH + 2 * th) * kCcHW + 2 * tw;

  float yacc[2][2][2][kCcCoT];
#pragma unroll
  for (int iu = 0; iu < 2; ++iu)
#pragma unroll
    for (int iv = 0; iv < 2; ++iv)
#pragma unroll
      for (int iw = 0; iw < 2; ++iw)
#pragma unroll
        for (int j = 0; j < kCcCoT; ++j) yacc[iu][iv][iw][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCcCK) {
    __syncthreads();  // the last chunk's readers are done
    if (epb != nullptr && tid < 2 * kCcCK) {
      const int row = tid / kCcCK, cc = tid - row * kCcCK;
      eps[tid] = c0 + cc < C ? epb[row * C + c0 + cc] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kHalo * kCcCK; e += kCcThreads) {
      const int v = e / kCcCK, ci = e - v * kCcCK;
      const int hw = v % kHW, hh = (v / kHW) % kHH, hd = v / (kHW * kHH);
      const int gd = d0 + hd - 1, gh = h0 + hh - 1, gw = w0 + hw - 1;
      float val = 0.f;
      if (gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W &&
          c0 + ci < C) {
        val = xb[(((long long)gd * H + gh) * W + gw) * C + c0 + ci];
        if (epb != nullptr) {
          val = __fadd_rn(__fmul_rn(val, eps[ci]), eps[kCcCK + ci]);
          if (lrelu && !(val >= 0.f)) val = __fmul_rn(val, slope);
        }
      }
      xs[ci * kCcHalo + (hd * kHH + hh) * kCcHW + hw] = val;
    }
    for (int e = tid; e < 64 * kCcCK * kCcCo; e += kCcThreads) {
      const int co = e % kCcCo, ci = (e / kCcCo) % kCcCK,
                p = e / (kCcCo * kCcCK);
      us[e] = c0 + ci < C && co0 + co < Co
                  ? u[((long long)p * C + c0 + ci) * Co + co0 + co]
                  : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        int i0, i1, j0, j1;
        float sa, sb;
        bt_row(a, &i0, &i1, &sa);
        bt_row(bb, &j0, &j1, &sb);
        float m[4][kCcCoT];
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < kCcCoT; ++j) m[c][j] = 0.f;
#pragma unroll 1
        for (int ci = 0; ci < kCcCK; ++ci) {
          const float* xc = xs + ci * kCcHalo + corner;
          // V[a, b, c] of this tile and channel: w, then h, then d
          float hrow[2][4];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            float wv[2][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float* row =
                  xc + ((ii ? i1 : i0) * kHH + (jj ? j1 : j0)) * kCcHW;
              const float2 lo = *reinterpret_cast<const float2*>(row),
                           hi = *reinterpret_cast<const float2*>(row + 2);
              wv[jj][0] = lo.x - hi.x;
              wv[jj][1] = lo.y + hi.x;
              wv[jj][2] = hi.x - lo.y;
              wv[jj][3] = lo.y - hi.y;
            }
#pragma unroll
            for (int c = 0; c < 4; ++c)
              hrow[ii][c] = fmaf(sb, wv[1][c], wv[0][c]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v = fmaf(sa, hrow[1][c], hrow[0][c]);
            const float4* uq = reinterpret_cast<const float4*>(
                us + (((a * 4 + bb) * 4 + c) * kCcCK + ci) * kCcCo +
                cog * kCcCoT);
            const float4 q0 = uq[0], q1 = uq[1];
            m[c][0] = fmaf(v, q0.x, m[c][0]);
            m[c][1] = fmaf(v, q0.y, m[c][1]);
            m[c][2] = fmaf(v, q0.z, m[c][2]);
            m[c][3] = fmaf(v, q0.w, m[c][3]);
            m[c][4] = fmaf(v, q1.x, m[c][4]);
            m[c][5] = fmaf(v, q1.y, m[c][5]);
            m[c][6] = fmaf(v, q1.z, m[c][6]);
            m[c][7] = fmaf(v, q1.w, m[c][7]);
          }
        }
        // over c (p0 = M0 + M1 + M2, p1 = M1 - M2 - M3), then b and a
#pragma unroll
        for (int j = 0; j < kCcCoT; ++j) {
          const float p0 = m[0][j] + m[1][j] + m[2][j];
          const float p1 = m[1][j] - m[2][j] - m[3][j];
#pragma unroll
          for (int iu = 0; iu < 2; ++iu)
#pragma unroll
            for (int iv = 0; iv < 2; ++iv) {
              const float s = at(iu, a) * at(iv, bb);
              if (s != 0.f) {
                yacc[iu][iv][0][j] = fmaf(s, p0, yacc[iu][iv][0][j]);
                yacc[iu][iv][1][j] = fmaf(s, p1, yacc[iu][iv][1][j]);
              }
            }
        }
      }
    }
  }

#pragma unroll
  for (int iu = 0; iu < 2; ++iu)
#pragma unroll
    for (int iv = 0; iv < 2; ++iv)
#pragma unroll
      for (int iw = 0; iw < 2; ++iw) {
        const int gd = d0 + 2 * td + iu, gh = h0 + 2 * th + iv,
                  gw = w0 + 2 * tw + iw;
        if (gd >= D || gh >= H || gw >= W) continue;
        float* dst = y + b * vox * Co + (((long long)gd * H + gh) * W + gw) * Co +
                     co0 + cog * kCcCoT;
#pragma unroll
        for (int j = 0; j < kCcCoT; ++j)
          if (co0 + cog * kCcCoT + j < Co) dst[j] = yacc[iu][iv][iw][j];
      }
}

cudaError_t launch_cc(const void* x, const void* u, const void* ep, void* y,
                      int b, int d, int h, int w, int c, int co, int lrelu,
                      float slope, cudaStream_t st) {
  const int ndt = (d + kTD - 1) / kTD, nht = (h + kTH - 1) / kTH,
            nwt = (w + kTW - 1) / kTW;
  cudaError_t err = cudaFuncSetAttribute(
      winograd_f23_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kCcSmem);
  if (err != cudaSuccess) return err;
  winograd_f23_fp32_kernel<<<dim3(ndt * nht * nwt, b, (co + kCcCo - 1) / kCcCo),
                             kCcThreads, kCcSmem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(ep), static_cast<float*>(y), d, h, w, c, co,
      lrelu, slope, nht, nwt);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medseg

// x (b, d, h, w, c) and y (b, d, h, w, co) of the dtype (kBf16, kF16, kF32),
// contiguous; ep (b, 2, c) fp32 or NULL. route 1, the tensor cores (bf16,
// fp16): u (cop / 48, cp / 48, 64, 3, 2, 48, 8) of x's type, the
// Winograd-domain weights zero padded and in the kernel's order (cp and cop
// multiples of 48). route 0, the CUDA cores (fp32): u (64, c, co) fp32,
// cp = c and cop = co.
extern "C" int medseg_winograd_f23(const void* x, const void* u,
                                   const void* ep, void* y, int b, int d,
                                   int h, int w, int c, int co, int cp,
                                   int cop, int lrelu, float slope, int dtype,
                                   int route, void* stream) {
  using namespace medseg;
  using namespace medseg::convtile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || d < 1 || h < 1 || w < 1 || c < 1 || co < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)((d + kTD - 1) / kTD) *
                          ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
  if (tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kCudaCore) {
    if (dtype != kF32 || cp != c || cop != co ||
        (co + kCcCo - 1) / kCcCo > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch_cc(x, u, ep, y, b, d, h, w, c, co, lrelu, slope, st));
  }
  if (route != kTensorCore || (dtype != kBf16 && dtype != kF16) || cp < c ||
      cp % kCK != 0 || cop < co || cop % kCoB != 0 || cop / kCoB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      dtype == kBf16
          ? launch_tc<__nv_bfloat16>(x, u, ep, y, b, d, h, w, c, co, cp, cop,
                                     lrelu, slope, st)
          : launch_tc<__half>(x, u, ep, y, b, d, h, w, c, co, cp, cop, lrelu,
                              slope, st);
  return static_cast<int>(err);
}
