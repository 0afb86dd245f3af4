// K1 and K2: both directions of the 1-bit-packed interaction matrix B.
//
// Replaces the TPU kernels igcn_cf_tpu/kernels/bitpack.py::_t1_pallas
// (_make_t1_kernel) and ::_t2_pallas (_make_t2_kernel):
//
//   K1  y1 (m, d) = B @ X1     X1 (K, d) bf16 rows, sums in f32
//   K2  y2 (K, d) = B^T @ X2   X2 (m, d) bf16 rows, sums in f32
//
// B is (m, kw) uint32 words, K = 32 * kw, in the bit-plane tile layout:
// column c is word (c / 4096) * 128 + c % 128, bit (c % 4096) / 128. The
// Python wrappers keep the JAX package's transposed (d, n) interface and
// hand the kernels row-major (n, d) operands and outputs.
//
// What bounds them on the H100. At the serving slice B is 30,208 x 1,408
// words (170 MB) and a row holds ~28 set bits, so ~2% of the words are not
// zero. Counted at the dense rate a launch is 2*m*K*d = 1.7e11 FLOP; the
// TPU kernels did that dense work on the MXU. Here both kernels SKIP zero
// words: each launch streams the 170 MB of words once (a ~51 us floor at
// the data sheet's 3.35 TB/s) and gathers one d-wide bf16 row of X per set
// bit (833k rows of 128 B at d=64; X1 is 5.8 MB and X2 3.9 MB, small
// enough for the 50 MB L2). They are bound by the word stream and by
// gather latency, not by arithmetic. Measured times are in PERF.md. No
// tensor cores, no TMA: this is the simple, exact version.
//
// K1 design: one warp per row of B. The 32 lanes read 32 consecutive words
// (one 128-byte load), a ballot finds the non-zero ones, and for each set
// bit the whole warp adds the matching X1 row (lane l owns features
// l, l+32, ...). The row's sum stays in registers; no atomics.
//
// K2 design: K2 contracts over rows. On the TPU a sequential grid carried
// that sum in VMEM; Hopper blocks run in no order. So each warp OWNS one
// word column w (32 output columns) for the whole of B and walks all m rows
// in order, keeping its 32 x d partial sums in shared memory. Every output
// element has exactly one writer and one summation order (rows ascending):
// deterministic, no atomics. The 4 warps of a block own adjacent words, so
// their strided word loads share 32-byte sectors.
//
// Both bodies also serve K6/K7, the bb_matmul pair (entries at the end), and
// take a compile-time MASKED flag for the edge-dropout variants (K1m/K2m of
// the pair, K6m/K7m of bb_matmul): each word a lane loads is ANDed with the
// keep word of its (row, word) coordinate (keepword.cuh) before the ballot.
// The keep decision is a function of (seed, row, word) only, so the two
// directions under one seed drop the same edges, and equal the unmasked
// kernels run over mask_words' masked copy of B. Zero words stay
// zero and skip the hash: it runs on the ~2% of words that hold an edge.
// With MASKED false the bodies are the code they were before the flag.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "keepword.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTKP = 128;            // word lanes per tile
constexpr int kTK = kTKP * 32;       // columns per tile
constexpr int kT1Threads = 256;      // 8 rows per block
constexpr int kT2Warps = 4;          // word columns per block
constexpr int kT2Unroll = 4;         // 32-row groups in flight per warp

__device__ __forceinline__ int column_of(int word, int bit) {
  return (word / kTKP) * kTK + bit * kTKP + (word % kTKP);
}

// DPL: features per lane, d <= 32 * DPL. MASKED: drop edges by the keep
// word of (seed, row, word) with threshold thr (unused when false).
template <int DPL, bool MASKED>
__global__ void __launch_bounds__(kT1Threads)
t1_kernel(const uint32_t* __restrict__ wp, const __nv_bfloat16* __restrict__ x1,
          float* __restrict__ y1, int m, int kw, int d, uint32_t seed,
          int thr) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;  // uniform per warp
  const uint32_t* words = wp + (size_t)row * kw;
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int base = 0; base < kw; base += 32) {
    const int w = base + lane;
    uint32_t word = w < kw ? __ldg(words + w) : 0u;
    if constexpr (MASKED) {
      if (word) word &= igcn::keepword(seed, (uint32_t)row, (uint32_t)w, thr);
    }
    unsigned live = __ballot_sync(kFull, word != 0u);
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      uint32_t bits = __shfl_sync(kFull, word, src);
      while (bits) {  // uniform across the warp
        const int b = __ffs(bits) - 1;
        bits &= bits - 1;
        const __nv_bfloat16* xr = x1 + (size_t)column_of(base + src, b) * d;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int f = lane + 32 * j;
          if (f < d) acc[j] += __bfloat162float(xr[f]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int f = lane + 32 * j;
    if (f < d) y1[(size_t)row * d + f] = acc[j];
  }
}

template <int DPL, bool MASKED>
__global__ void __launch_bounds__(kT2Warps * 32)
t2_kernel(const uint32_t* __restrict__ wp, const __nv_bfloat16* __restrict__ x2,
          float* __restrict__ y2, int m, int kw, int d, uint32_t seed,
          int thr) {
  extern __shared__ float sacc[];  // [kT2Warps][32 planes][d]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w = blockIdx.x * kT2Warps + warp;
  float* acc = sacc + (size_t)warp * 32 * d;
  if (w >= kw) return;  // uniform per warp; no block-wide barrier follows
  for (int i = lane; i < 32 * d; i += 32) acc[i] = 0.f;
  __syncwarp();

  for (int r0 = 0; r0 < m; r0 += 32 * kT2Unroll) {
    uint32_t word[kT2Unroll];
#pragma unroll
    for (int u = 0; u < kT2Unroll; ++u) {
      const int r = r0 + 32 * u + lane;
      word[u] = r < m ? __ldg(wp + (size_t)r * kw + w) : 0u;
      if constexpr (MASKED) {
        if (word[u])
          word[u] &= igcn::keepword(seed, (uint32_t)r, (uint32_t)w, thr);
      }
    }
#pragma unroll
    for (int u = 0; u < kT2Unroll; ++u) {
      unsigned live = __ballot_sync(kFull, word[u] != 0u);
      while (live) {  // rows in ascending order
        const int src = __ffs(live) - 1;
        live &= live - 1;
        uint32_t bits = __shfl_sync(kFull, word[u], src);
        const __nv_bfloat16* xr = x2 + (size_t)(r0 + 32 * u + src) * d;
        float xv[DPL];
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int f = lane + 32 * j;
          xv[j] = f < d ? __bfloat162float(xr[f]) : 0.f;
        }
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          float* a = acc + b * d;
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            const int f = lane + 32 * j;
            if (f < d) a[f] += xv[j];  // each lane owns its features
          }
        }
      }
    }
  }
  __syncwarp();
  for (int b = 0; b < 32; ++b) {
    float* out = y2 + (size_t)column_of(w, b) * d;
    for (int f = lane; f < d; f += 32) out[f] = acc[b * d + f];
  }
}

template <int DPL, bool MASKED>
cudaError_t launch_t1(const uint32_t* wp, const __nv_bfloat16* x1, float* y1,
                      int m, int kw, int d, uint32_t seed, int thr,
                      cudaStream_t stream) {
  const int rows_per_block = kT1Threads / 32;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  t1_kernel<DPL, MASKED><<<blocks, kT1Threads, 0, stream>>>(wp, x1, y1, m, kw,
                                                            d, seed, thr);
  return cudaGetLastError();
}

template <int DPL, bool MASKED>
cudaError_t launch_t2(const uint32_t* wp, const __nv_bfloat16* x2, float* y2,
                      int m, int kw, int d, uint32_t seed, int thr,
                      cudaStream_t stream) {
  const size_t smem = (size_t)kT2Warps * 32 * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      t2_kernel<DPL, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (kw + kT2Warps - 1) / kT2Warps;
  t2_kernel<DPL, MASKED><<<blocks, kT2Warps * 32, smem, stream>>>(
      wp, x2, y2, m, kw, d, seed, thr);
  return cudaGetLastError();
}

// d must be in [1, 256]: the shared partial sums of K2 take 512*d bytes.
bool bad_args(int m, int kw, int d, int thr) {
  return d < 1 || d > 256 || m < 0 || kw < 0 || thr < 0 || thr > 255;
}

template <bool MASKED>
int run_t1(const void* wp, const void* x1, void* y1, int m, int kw, int d,
           uint32_t seed, int thr, void* stream) {
  auto w = static_cast<const uint32_t*>(wp);
  auto x = static_cast<const __nv_bfloat16*>(x1);
  auto y = static_cast<float*>(y1);
  auto s = static_cast<cudaStream_t>(stream);
  if (bad_args(m, kw, d, thr)) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  if (d <= 32) return (int)launch_t1<1, MASKED>(w, x, y, m, kw, d, seed, thr, s);
  if (d <= 64) return (int)launch_t1<2, MASKED>(w, x, y, m, kw, d, seed, thr, s);
  if (d <= 128) return (int)launch_t1<4, MASKED>(w, x, y, m, kw, d, seed, thr, s);
  return (int)launch_t1<8, MASKED>(w, x, y, m, kw, d, seed, thr, s);
}

template <bool MASKED>
int run_t2(const void* wp, const void* x2, void* y2, int m, int kw, int d,
           uint32_t seed, int thr, void* stream) {
  auto w = static_cast<const uint32_t*>(wp);
  auto x = static_cast<const __nv_bfloat16*>(x2);
  auto y = static_cast<float*>(y2);
  auto s = static_cast<cudaStream_t>(stream);
  if (bad_args(m, kw, d, thr)) return (int)cudaErrorInvalidValue;
  if (kw == 0) return (int)cudaGetLastError();
  if (d <= 32) return (int)launch_t2<1, MASKED>(w, x, y, m, kw, d, seed, thr, s);
  if (d <= 64) return (int)launch_t2<2, MASKED>(w, x, y, m, kw, d, seed, thr, s);
  if (d <= 128) return (int)launch_t2<4, MASKED>(w, x, y, m, kw, d, seed, thr, s);
  return (int)launch_t2<8, MASKED>(w, x, y, m, kw, d, seed, thr, s);
}

}  // namespace

extern "C" {

int igcn_t1(const void* wp, const void* x1, void* y1, int m, int kw, int d,
            void* stream) {
  return run_t1<false>(wp, x1, y1, m, kw, d, 0u, 0, stream);
}

int igcn_t2(const void* wp, const void* x2, void* y2, int m, int kw, int d,
            void* stream) {
  return run_t2<false>(wp, x2, y2, m, kw, d, 0u, 0, stream);
}

// K1m and K2m: the transposed pair with the keep mask inside the kernel,
// _t1_pallas/_t2_pallas with masked=True, which bbt_pair_dropped reaches
// (igcn_cf_tpu/kernels/bitpack.py:745). They run the masked bodies that
// K6m/K7m run; entries of their own so that each direction of the pair is
// launched, counted and checked apart. seed is the u32 mask seed, thr =
// round(p * 256); no 1/(1-p) rescale.
int igcn_t1_masked(const void* wp, const void* x1, void* y1, int m, int kw,
                   int d, unsigned int seed, int thr, void* stream) {
  return run_t1<true>(wp, x1, y1, m, kw, d, (uint32_t)seed, thr, stream);
}

int igcn_t2_masked(const void* wp, const void* x2, void* y2, int m, int kw,
                   int d, unsigned int seed, int thr, void* stream) {
  return run_t2<true>(wp, x2, y2, m, kw, d, (uint32_t)seed, thr, stream);
}

// K6 and K7: the bb_matmul pair of the JAX package,
// igcn_cf_tpu/kernels/bitpack.py::_fwd_pallas (K6, Y = B @ X) and
// ::_bwd_pallas (K7, Y = B^T @ X). They compute the products of K1 and K2
// on X in its original row-major (n, d) layout, which is what the kernel
// bodies above read, so the Python wrappers pass X with no transposed copy.
// The propagation-cache build runs the unmasked pair at d = 128 (DPL = 4;
// 64 KB of K7 shared memory).
int igcn_bb_fwd(const void* wp, const void* x, void* y, int m, int kw, int d,
                void* stream) {
  return run_t1<false>(wp, x, y, m, kw, d, 0u, 0, stream);
}

int igcn_bb_bwd(const void* wp, const void* x, void* y, int m, int kw, int d,
                void* stream) {
  return run_t2<false>(wp, x, y, m, kw, d, 0u, 0, stream);
}

// K6m and K7m: the same pair with the in-kernel edge-dropout mask,
// _fwd_pallas/_bwd_pallas with masked=True (bb_matmul_dropped), which NGCF
// runs in every layer of a training step at d = 64. seed is the u32 mask
// seed, thr = round(p * 256) in [0, 255]; no 1/(1-p) rescale. K7m keeps
// K7's one writer per output and ascending row order: deterministic.
int igcn_bb_fwd_masked(const void* wp, const void* x, void* y, int m, int kw,
                       int d, unsigned int seed, int thr, void* stream) {
  return run_t1<true>(wp, x, y, m, kw, d, (uint32_t)seed, thr, stream);
}

int igcn_bb_bwd_masked(const void* wp, const void* x, void* y, int m, int kw,
                       int d, unsigned int seed, int thr, void* stream) {
  return run_t2<true>(wp, x, y, m, kw, d, (uint32_t)seed, thr, stream);
}

}  // extern "C"
