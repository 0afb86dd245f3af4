// K3 and K4: the propagation cache's gather-matmul pair, forward and
// backward of reps = P[rows] @ X0.
//
// Replaces the TPU kernels igcn_cf_tpu/kernels/pcache.py::_fused_fwd (K3)
// and ::_fused_bwd (K4):
//
//   K3  reps (R, d)  = P[rows] @ X0        P (n, npad) bf16, X0 (npad, d) bf16
//   K4  dX0 (npad, d) = P[rows]^T @ ct     ct (R, d) bf16; duplicate rows sum
//
// both with f32 sums and without ever writing P[rows] to device memory. P
// is stored row-major; the JAX package's 4-D slab layout and its 4096-column
// alignment existed only for the TPU's DMA engine.
//
// What bounds them on the H100. At the training slice R = 3 * 2048 = 6,144
// rows of P (npad = 70,912 columns) are 871 MB of bf16 per pass: a 0.26 ms
// stream at the data sheet's 3.35 TB/s, and 2*R*npad*d = 5.6e10 FLOP, which
// FP32 FMAs (67 TFLOP/s) would need ~0.8 ms for. So both kernels multiply on
// the tensor cores, with warp-level mma.sync m16n8k16 (bf16 in, f32
// accumulate): the simplest route onto them, at 16x the FMA rate, which
// leaves the P stream as the bound. No wgmma or TMA in this version.
//
// Shared design. A block has 4 warps and computes a 64 x 64 output tile
// (each warp 16 rows x 64 columns: 8 mma n-tiles, 32 f32 accumulators per
// thread). The contraction runs in 64-deep chunks through a 2-stage
// cp.async ring in shared memory; each 64-element smem row is padded by 8
// bf16 so the ldmatrix row addresses of a warp fall in distinct banks. Rows
// of P are gathered by the block itself (it loads its row ids), 16 B per
// thread per copy, a whole 128 B row segment per 8 threads. A row id
// outside [0, n) and a row past R read as zeros.
//
// K3: grid (row tiles, split, d tiles). R = 6,144 gives only 96 row tiles,
// too few for 132 SMs, so the npad columns are split in S ranges (S from
// igcn_gather_fwd_splits); each split writes its own partial (R, d) slab
// and a second small kernel (split_sum.cuh) sums the slabs in split order.
// No atomics: the result is the same on every run.
//
// K4: contracts over the R gathered rows, which on the TPU was a sequential
// grid axis. Here each block OWNS one 64-column tile of dX0 and walks all R
// rows in order, 64 at a time: every output has one writer and one
// summation order, so two launches are bit-equal, and duplicate row ids
// (users repeat in a batch, items across pos and neg) simply add up. P is
// symmetric, so the gathered ROWS are the needed columns of P^T; the A
// operand is the transposed smem tile, read with ldmatrix.trans.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "split_sum.cuh"

namespace {

constexpr int kTile = 64;            // output rows and columns of a block
constexpr int kChunk = 64;           // contraction depth per pipeline stage
constexpr int kLd = kChunk + 8;      // padded smem row, in bf16
constexpr int kThreads = 128;        // 4 warps
constexpr int kCopies = kTile * kChunk / 8 / kThreads;  // 16 B copies/thread
constexpr int kTargetBlocks = 4 * 132;  // K3 blocks to aim for

using igcn::bf16;
using igcn::cp_async16;
using igcn::cp_async_commit;
using igcn::cp_async_wait;
using igcn::ldsm_x4;
using igcn::ldsm_x4_t;
using igcn::mma16816;

// One 64-deep chunk: acc (16 x 64 per warp) += A (16 x 64) @ B (64 x 64),
// with B stored [k][n] in sB. A_TRANS: A(m, k) is sA[k][m] (K4) instead of
// sA[m][k] (K3).
template <bool A_TRANS>
__device__ __forceinline__ void mma_chunk(float (&acc)[8][4],
                                          const bf16 (*sA)[kLd],
                                          const bf16 (*sB)[kLd], int warp,
                                          int lane) {
  const int m0 = warp * 16;
#pragma unroll
  for (int kk = 0; kk < kChunk; kk += 16) {
    uint32_t a[4];
    if (A_TRANS) {
      ldsm_x4_t(a, &sA[kk + (lane % 8) + (lane / 16) * 8]
                      [m0 + ((lane / 8) % 2) * 8]);
    } else {
      ldsm_x4(a, &sA[m0 + (lane % 16)][kk + (lane / 16) * 8]);
    }
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, &sB[kk + (lane % 16)][np * 16 + (lane / 16) * 8]);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// K3: part[split] (R, dpad) = P[rows, k range of split] @ X0[k range].
__global__ void __launch_bounds__(kThreads)
gather_fwd_kernel(const bf16* __restrict__ p, const int* __restrict__ rows,
                  const bf16* __restrict__ x0, float* __restrict__ part,
                  int n, int npad, int r_tot, int dpad, int k_per_split) {
  __shared__ __align__(16) bf16 sA[2][kTile][kLd];
  __shared__ __align__(16) bf16 sB[2][kChunk][kLd];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * kTile;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(npad, k_begin + k_per_split);
  const int d0 = blockIdx.z * kTile;
  const int n_chunks = (k_end - k_begin + kChunk - 1) / kChunk;

  // this thread's copies: tile row c / 8, 16-byte column c % 8
  const bf16* a_src[kCopies];
  bool a_ok[kCopies];
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int c = tid + i * kThreads;
    const int r = r0 + c / 8;
    const int id = r < r_tot ? rows[r] : -1;
    a_ok[i] = id >= 0 && id < n;
    a_src[i] = p + (size_t)(a_ok[i] ? id : 0) * npad + (c % 8) * 8;
  }
  auto load = [&](int stage, int chunk) {
    const int k0 = k_begin + chunk * kChunk;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int c = tid + i * kThreads;
      cp_async16(&sA[stage][c / 8][(c % 8) * 8], a_src[i] + k0, a_ok[i]);
      cp_async16(&sB[stage][c / 8][(c % 8) * 8],
                 x0 + (size_t)(k0 + c / 8) * dpad + d0 + (c % 8) * 8, true);
    }
    cp_async_commit();
  };

  float acc[8][4] = {};
  if (n_chunks > 0) load(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load((ch + 1) % 2, ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_chunk<false>(acc, sA[ch % 2], sB[ch % 2], warp, lane);
    __syncthreads();  // the stage is reloaded two chunks later
  }

  float* out = part + (size_t)blockIdx.y * r_tot * dpad;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = d0 + j * 8 + t * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * 16 + g + h * 8;
      if (r < r_tot) {
        *reinterpret_cast<float2*>(out + (size_t)r * dpad + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// K4: dx (npad, dpad) = P[rows]^T @ ct, one block per 64 x 64 output tile.
__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(const bf16* __restrict__ p, const int* __restrict__ rows,
                  const bf16* __restrict__ ct, float* __restrict__ dx, int n,
                  int npad, int r_tot, int dpad) {
  __shared__ __align__(16) bf16 sP[2][kChunk][kLd];  // [gathered row][column]
  __shared__ __align__(16) bf16 sC[2][kChunk][kLd];  // [gathered row][feature]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * kTile;
  const int d0 = blockIdx.y * kTile;
  const int n_chunks = (r_tot + kChunk - 1) / kChunk;

  auto load = [&](int stage, int chunk) {
    const int rb = chunk * kChunk;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int c = tid + i * kThreads;
      const int r = rb + c / 8;
      const int id = r < r_tot ? rows[r] : -1;
      const bool ok = id >= 0 && id < n;
      cp_async16(&sP[stage][c / 8][(c % 8) * 8],
                 p + (size_t)(ok ? id : 0) * npad + c0 + (c % 8) * 8, ok);
      cp_async16(&sC[stage][c / 8][(c % 8) * 8],
                 ct + (size_t)(r < r_tot ? r : 0) * dpad + d0 + (c % 8) * 8,
                 r < r_tot);
    }
    cp_async_commit();
  };

  float acc[8][4] = {};
  if (n_chunks > 0) load(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load((ch + 1) % 2, ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_chunk<true>(acc, sP[ch % 2], sC[ch % 2], warp, lane);
    __syncthreads();
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = d0 + j * 8 + t * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + warp * 16 + g + h * 8;
      *reinterpret_cast<float2*>(dx + (size_t)c * dpad + col) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

bool bad_shape(int n, int npad, int r_tot, int dpad) {
  return n < 1 || npad < n || npad % kTile || r_tot < 0 || dpad < kTile ||
         dpad % kTile;
}

}  // namespace

extern "C" {

// Number of column splits K3 uses (the size of its partial scratch).
int igcn_gather_fwd_splits(int r_tot, int npad, int dpad) {
  const int tiles = ((r_tot + kTile - 1) / kTile) * (dpad / kTile);
  const int chunks = npad / kChunk;
  int s = (kTargetBlocks + tiles - 1) / (tiles > 0 ? tiles : 1);
  if (s > chunks) s = chunks;
  return s < 1 ? 1 : s;
}

// p (n, npad) bf16; rows (r_tot,) int32; x0 (npad, dpad) bf16;
// part (splits, r_tot, dpad) f32 scratch; out (r_tot, dpad) f32. With one
// split, part may be out.
int igcn_gather_fwd(const void* p, const void* rows, const void* x0,
                    void* part, void* out, int n, int npad, int r_tot,
                    int dpad, int splits, void* stream) {
  if (bad_shape(n, npad, r_tot, dpad) ||
      splits != igcn_gather_fwd_splits(r_tot, npad, dpad))
    return (int)cudaErrorInvalidValue;
  if (r_tot == 0) return (int)cudaGetLastError();
  auto s = static_cast<cudaStream_t>(stream);
  const int chunks = npad / kChunk;
  const int k_per_split = ((chunks + splits - 1) / splits) * kChunk;
  float* dst = splits == 1 ? static_cast<float*>(out)
                           : static_cast<float*>(part);
  dim3 grid((r_tot + kTile - 1) / kTile, splits, dpad / kTile);
  gather_fwd_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(p), static_cast<const int*>(rows),
      static_cast<const bf16*>(x0), dst, n, npad, r_tot, dpad, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)igcn::sum_splits(static_cast<const float*>(part),
                               static_cast<float*>(out),
                               (long long)r_tot * dpad, splits, s);
}

// p (n, npad) bf16; rows (r_tot,) int32; ct (r_tot, dpad) bf16;
// dx (npad, dpad) f32.
int igcn_gather_bwd(const void* p, const void* rows, const void* ct,
                    void* dx, int n, int npad, int r_tot, int dpad,
                    void* stream) {
  if (bad_shape(n, npad, r_tot, dpad)) return (int)cudaErrorInvalidValue;
  dim3 grid(npad / kTile, dpad / kTile);
  gather_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(p), static_cast<const int*>(rows),
      static_cast<const bf16*>(ct), static_cast<float*>(dx), n, npad, r_tot,
      dpad);
  return (int)cudaGetLastError();
}

}  // extern "C"
