// The second pass of a kernel that splits its contraction across blocks:
// each split wrote a partial slab of `size` f32 values, and the output is
// their sum, taken in split order. One writer per output and one order per
// sum, so two launches are bit-equal. K3 (pcache.cu, column splits of P) and
// the t2 body of K2/K7 (bbt_pair.cu, row splits of B) both end with it.
#pragma once

#include <cuda_runtime.h>

namespace igcn {
namespace {

// out[i] = part[0][i] + part[1][i] + ... + part[splits - 1][i].
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long long size,
                                  int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < size; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(size_t)k * size + i];
    out[i] = s;
  }
}

// Launch the sum over `splits` slabs of `size` values on `stream`.
inline cudaError_t sum_splits(const float* part, float* out, long long size,
                              int splits, cudaStream_t stream) {
  long long blocks = (size + 255) / 256;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) return cudaGetLastError();
  sum_splits_kernel<<<(int)blocks, 256, 0, stream>>>(part, out, size, splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace igcn
