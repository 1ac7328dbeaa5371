// Sum of per-block partial results, the second pass of the backward kernels.
//
// The TPU kernels carry their weight-gradient sums in scratch memory from one
// grid step to the next; CUDA blocks run side by side, so each block writes
// the sum over its own share of the tokens to a slab of partials and this
// kernel adds the slabs. The order of the additions is fixed, so a result
// does not change from run to run as it would with atomics.

#include "common.cuh"

namespace medseg {
namespace {

__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int nparts,
                                    long long len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float a = 0.f;
  for (int p = 0; p < nparts; ++p) a += part[(size_t)p * len + i];
  out[i] = a;
}

}  // namespace

cudaError_t sum_partials(const float* part, float* out, int nparts,
                         long long len, cudaStream_t st) {
  const unsigned blocks = (unsigned)((len + kThreads - 1) / kThreads);
  sum_partials_kernel<<<blocks, kThreads, 0, st>>>(part, out, nparts, len);
  return cudaGetLastError();
}

}  // namespace medseg
