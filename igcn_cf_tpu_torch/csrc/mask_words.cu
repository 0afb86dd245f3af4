// Counterpart of K8: the dropout-masked copy of the bit-packed matrix B.
//
// Replaces the training path's igcn_cf_tpu/kernels/bitpack.py::mask_words
// (bitpack.py:592-606), an XLA-fused elementwise pass; the TPU kernel K8
// (bitpack.py:609 mask_words_hw) drew its bits from the TPU's hardware PRNG
// and was never wired in. This kernel computes exactly mask_words:
//
//   out[r, w] = wp[r, w] & keepword(seed, r, w, thr)        (keepword.cuh)
//
// bit for bit, so the CUDA and CPU paths drop the same edges.
//
// What bounds it on the H100: at the training slice B is 30,208 x 1,408
// words (42.5M, 170 MB); reading and writing them is 340 MB, ~0.1 ms at the
// data sheet's 3.35 TB/s. The hash is 8 rounds of two multiplies and two
// xor-shifts per word, ~5e9 integer operations for the whole grid. But ~98%
// of B's words are zero, and 0 & anything is 0, so the kernel hashes only
// the non-zero words: the result is unchanged and the pass is bound by the
// word stream. One thread per word in a grid-stride loop; neighbouring
// threads read neighbouring words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keepword.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
mask_words_kernel(const uint32_t* __restrict__ wp, uint32_t* __restrict__ out,
                  long long n_words, int kw, uint32_t seed, int thr) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_words; i += stride) {
    const uint32_t w = wp[i];
    out[i] = w ? (w & igcn::keepword(seed, (uint32_t)(i / kw),
                                     (uint32_t)(i % kw), thr))
               : 0u;
  }
}

}  // namespace

extern "C" {

// wp, out: (m, kw) uint32 words; thr = round(p * 256) in [0, 255].
int igcn_mask_words(const void* wp, void* out, int m, int kw,
                    unsigned int seed, int thr, void* stream) {
  if (m < 0 || kw < 0 || thr < 0 || thr > 255)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)m * kw;
  if (n == 0) return (int)cudaGetLastError();
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 per SM
  mask_words_kernel<<<(int)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wp), static_cast<uint32_t*>(out), n, kw,
      (uint32_t)seed, thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
