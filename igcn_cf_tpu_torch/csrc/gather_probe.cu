// T5: the on-chip gather probe of the gather microbenchmark.
//
// Replaces the TPU kernel tools/microbench_gather.py::gather_chain (its
// kernel from make_gather_kernel): reps gathers of rows out of fast memory,
//
//   out[r, c] = sum_{i < reps} x[(idx[r, c] + i) mod N, c]
//
// for x (N, 128) f32 or bf16 and idx (N, 128) int32, summed from zero in
// x's type in the order i = 0, 1, ..., reps - 1: f32 by round-to-nearest
// adds (adds only, so no FMA), bf16 by an f32 add rounded to bf16 to
// nearest even after each step, as PyTorch adds two bf16 tensors. The
// result is bit-equal to the plain version.
//
// On the TPU all of x sits in VMEM and Mosaic's dynamic_gather moves
// sublanes. On Hopper a block has 227 KB of shared memory, less than x at
// most of the probe's sizes (256 KB to 4 MB). A column gathers only from
// its own column, so a block owns a stripe of w columns of all N rows, w
// the largest power of two with N * w elements in 227 KB (chosen by the
// wrapper, checked here), copies it into shared memory once, and runs the
// gathers of its outputs there. The blocks of one stripe split its rows
// between them, so that the grid covers the SMs.
//
// What bounds it. In device memory x, idx and out each cross once: at N =
// 8,192 in f32, 12.6 MB, 3.8 us at 3.35 TB/s. On chip, reps * N * 128
// element reads from shared memory, at most 32 a clock on each SM (one per
// bank): at N = 8,192 and reps = 50, 52.4M reads, 6.3 us on 132 SMs at
// 1.98 GHz. Rows are random, so a warp's reads collide in banks; the probe
// measures how far below that on-chip figure it stays (the tools print
// both, with the card's own clock). Each stripe copy reads its N x w
// elements again for every row range of the stripe.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 128;      // columns of x
constexpr int kThreads = 1024;   // one block per SM at ~128 KB of stripe
constexpr int kMaxSmem = 232448; // bytes a block may use on Hopper

__device__ __forceinline__ float add_in(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ __nv_bfloat16 add_in(__nv_bfloat16 a,
                                                __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

template <typename T>
__device__ __forceinline__ T zero();

template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// Block (x, y) owns the columns [w x, w x + w) and the rows [y * rpb,
// y * rpb + rpb) of the output; the stripe s holds all n rows of its
// columns, row-major with pitch w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_chain_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    T* __restrict__ out, int n, int reps, int w, int rpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int c0 = blockIdx.x * w;
  const int r0 = blockIdx.y * rpb;
  const int r1 = min(n, r0 + rpb);
  for (int e = threadIdx.x; e < n * w; e += blockDim.x) {
    s[e] = x[(size_t)(e / w) * kWidth + c0 + e % w];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (r1 - r0) * w; e += blockDim.x) {
    const int c = e % w;
    const size_t o = (size_t)(r0 + e / w) * kWidth + c0 + c;
    int row = idx[o] % n;  // (idx + i) mod n, stepped without a division
    if (row < 0) row += n;
    T acc = zero<T>();
    for (int i = 0; i < reps; ++i) {
      acc = add_in(acc, s[row * w + c]);
      if (++row == n) row = 0;
    }
    out[o] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* idx, void* out, int n, int reps, int w,
           int row_blocks, cudaStream_t stream) {
  const size_t smem = (size_t)n * w * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gather_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rpb = (n + row_blocks - 1) / row_blocks;
  dim3 grid(kWidth / w, (n + rpb - 1) / rpb);
  gather_chain_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<T*>(out), n, reps, w, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, 128) f32 (bf16 == 0) or bf16 (bf16 == 1); idx (n, 128) int32; out
// like x. w: a power of two <= 128 with n * w elements in a block's shared
// memory; row_blocks in [1, n] blocks share each stripe's rows.
int igcn_gather_chain(const void* x, const void* idx, void* out, int n,
                      int reps, int w, int row_blocks, int bf16,
                      void* stream) {
  const size_t esize = bf16 ? 2 : 4;
  if (n < 1 || reps < 0 || w < 1 || w > kWidth || (w & (w - 1)) ||
      (size_t)n * w * esize > kMaxSmem || row_blocks < 1 || row_blocks > n ||
      (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, idx, out, n, reps, w, row_blocks, s)
              : launch<float>(x, idx, out, n, reps, w, row_blocks, s);
}

}  // extern "C"
