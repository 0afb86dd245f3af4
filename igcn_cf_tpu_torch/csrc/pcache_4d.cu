// T1-T4: the 4-D fused gather kernels of the propagation-cache
// microbenchmarks, forward and backward of out = P[rows] @ X0.
//
// Replaces the TPU kernels tools/microbench_pcache.py::fused_fwd_4d (T1)
// and ::fused_bwd_4d (T2), and tools/microbench_pcache_tune.py::fwd (T3)
// and ::bwd_t (T4):
//
//   T1  out (R, d)    = P4[rows] @ X0     P4 (n, NJ, sub, 128) bf16, X0 (npad, d) bf16
//   T2  dX0 (npad, d) = P4[rows]^T @ ct   ct (R, d) bf16; duplicate rows sum
//   T3  T1's product, with X0 kept in L2 on request (resident_x0)
//   T4  dX0^T (d, npad) = ct^T @ P4[rows]
//
// with npad = NJ * tkc, tkc = sub * 128, and f32 sums. P4 is the row-major
// (n, npad) matrix seen as NJ column slabs of tkc columns per row: the same
// memory, so one row of one slab is a contiguous run of tkc bf16.
//
// What bounds them on the H100. At the tool's shape (n = 70,839, npad =
// 73,728, R = 6,144, d = 64) one pass over the gathered rows is R * npad *
// 2 B = 906 MB, 0.270 ms at the data sheet's 3.35 TB/s, against 2 * R *
// npad * d = 5.8e10 FLOP, 0.059 ms at 989 TFLOP/s bf16: all four kernels are
// bound by the P stream. They multiply on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 sums), fed by a two-stage cp.async ring: the
// building blocks of K3/K4 (pcache.cu; helpers in mma_sync.cuh).
//
// T1 keeps the TPU kernel's design, which K3 gave up: one block owns TR
// gathered rows (TR / 16 warps, 16 rows each) and walks the NJ slabs in
// order, 64 columns at a time, keeping the (TR, 64) sum in registers to the
// end (each 64-column stage summed apart and folded in, see fold). No
// column split and no second pass; the TPU kernel's scratch
// accumulator across slabs is the registers here. At R / TR = 48 blocks on
// 132 SMs most of the card idles: T1 against K3 on the same P measures what
// K3's column split buys.
//
// T3 is T1's body with a compile-time RESIDENT flag. On the TPU,
// resident_x0 fetches all of X0 into VMEM once; on Hopper X0 (npad x 64
// bf16 = 9.4 MB at the tool's shape) cannot sit in a block's 227 KB of
// shared memory, so "resident" means resident in the 50 MB L2: X0's copies
// carry an evict_last policy and P's an evict_first one, so the 906 MB of
// gathered rows stream past without pushing X0 out, and X0 crosses device
// memory about once. Without the flag T3 is T1, launched under its own
// entry; the two variants sum in the same order and are bit-equal.
//
// T2: one block owns one 128-column tile of one slab (npad / 128 blocks),
// walks all R gathered rows in TR-row steps, in order, and keeps the (128,
// 64) output tile in registers (8 warps, 16 columns each) until it writes
// it row-major into (npad, d). One writer per output and one summation
// order: deterministic. The A operand is the gathered P tile read
// transposed with ldmatrix.trans, as in K4.
//
// T4 is the TPU tool's second backward: its Mosaic transposed each (128,
// 128) P sub-tile for T2's dim-0 contraction, so it moved the transpose
// onto the small ct block and wrote dX0^T. T4 keeps T2's grid and stages,
// but its block's tile is (64 features x 128 columns) of the (d, npad)
// output: A = ct^T (features x rows, ldmatrix.trans of the ct stage) and B
// = the gathered P tile as stored (rows x columns). On mma.sync a transpose
// costs nothing either way (ldmatrix reads 8 x 8 tiles with or without
// .trans at one rate), so the two layouts differ in the output alone: T4
// stores along npad, T2 along d. Rows in order, one writer per output:
// deterministic.
//
// A row id outside [0, n) and a row past R read as zeros. d is padded by
// the wrapper to a multiple of 64; each 64-wide feature tile is a grid
// column of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using igcn::bf16;
using igcn::cp_async16;
using igcn::cp_async16_hint;
using igcn::cp_async_commit;
using igcn::cp_async_wait;
using igcn::ldsm_x4;
using igcn::ldsm_x4_t;
using igcn::mma16816;

constexpr int kDTile = 64;              // features per block
constexpr int kChunk = 64;              // T1 columns per pipeline stage
constexpr int kLd = 64 + 8;             // padded smem row of a 64-wide tile
constexpr int kColTile = 128;           // T2 columns of P per block
constexpr int kLdP = kColTile + 8;      // padded smem row of T2's P tile
constexpr int kT2Threads = 256;         // 8 warps x 16 columns
constexpr int kMaxTr = 256;             // TR in [16, 256], a multiple of 16
constexpr int kMaxSmem = 232448;        // bytes a block may use on Hopper

// One k16 step of a warp's 16 x 64 output tile: acc += A (16 x 16) @ B
// (16 x 64). A(m, k) is sA[(m0 + m) * LDA + k0 + k], or with A_TRANS
// sA[(k0 + k) * LDA + m0 + m]; B(k, n) is sB[(k0 + k) * LDB + n]. The
// padded pitches put the 8 row addresses of an ldmatrix in distinct banks.
template <bool A_TRANS, int LDA, int LDB = kLd>
__device__ __forceinline__ void mma_k16(float (&acc)[8][4], const bf16* sA,
                                        const bf16* sB, int m0, int k0,
                                        int lane) {
  uint32_t a[4];
  if (A_TRANS) {
    ldsm_x4_t(a, sA + (k0 + (lane % 8) + (lane / 16) * 8) * LDA + m0 +
                     ((lane / 8) % 2) * 8);
  } else {
    ldsm_x4(a, sA + (m0 + (lane % 16)) * LDA + k0 + (lane / 16) * 8);
  }
#pragma unroll
  for (int np = 0; np < kDTile / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, sB + (k0 + (lane % 16)) * LDB + np * 16 + (lane / 16) * 8);
    mma16816(acc[2 * np], a, b[0], b[1]);
    mma16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// acc += part with the CUDA cores' round-to-nearest f32 adds. One
// tensor-core accumulator carried over a whole P row (4,608 k16 steps at
// npad = 73,728) drifts from the f32 reference by up to 0.105 on random
// sums of about +-1,000 (H100 80GB HBM3, the tool's shape), so each stage
// is summed in a fresh fragment and folded into the running sum here.
__device__ __forceinline__ void fold(float (&acc)[8][4],
                                     const float (&part)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
  }
}

// Write a warp's 16 x 64 f32 tile: rows row0 + [0, 16) below row_end, of
// an output with pitch dpad, columns d0 + [0, 64).
__device__ __forceinline__ void store_tile(const float (&acc)[8][4],
                                           float* out, long long row0,
                                           long long row_end, int dpad,
                                           int d0, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = d0 + j * 8 + t * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row0 + g + h * 8;
      if (r < row_end) {
        *reinterpret_cast<float2*>(out + (size_t)r * dpad + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// T1 and T3: out (R, dpad) = P4[rows] @ X0; block x owns rows [x * tr,
// x * tr + tr), block y the features [64 y, 64 y + 64). 2 * tr threads.
// RESIDENT (T3's resident_x0) copies X0 under evict_last and P under
// evict_first; the arithmetic is the same.
template <bool RESIDENT>
__global__ void __launch_bounds__(2 * kMaxTr)
fused_fwd_4d_kernel(const bf16* __restrict__ p4, const int* __restrict__ rows,
                    const bf16* __restrict__ x0, float* __restrict__ out,
                    int n, int nj, int tkc, int r_tot, int dpad, int tr) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [2][tr][kLd] gathered rows
  bf16* sB = sA + 2 * tr * kLd;              // [2][kChunk][kLd] X0 rows
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * tr;
  const int d0 = blockIdx.y * kDTile;
  const int per_slab = tkc / kChunk;
  const int n_chunks = nj * per_slab;
  const size_t npad = (size_t)nj * tkc;
  uint64_t x_policy = 0, p_policy = 0;
  if constexpr (RESIDENT) {
    x_policy = igcn::l2_evict_last();
    p_policy = igcn::l2_evict_first();
  }

  // tr rows x 8 copies of 16 B per stage over 2 * tr threads: 4 each, the
  // same rows on every stage
  const bf16* a_src[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = tid + i * nthreads;
    const int r = r0 + c / 8;
    const int id = r < r_tot ? rows[r] : -1;
    a_ok[i] = id >= 0 && id < n;
    a_src[i] = p4 + (size_t)(a_ok[i] ? id : 0) * npad + (c % 8) * 8;
  }
  // slab j = chunk / per_slab, columns k0 + [0, 64) of it
  auto load = [&](int stage, int chunk) {
    const size_t col = (size_t)(chunk / per_slab) * tkc +
                       (size_t)(chunk % per_slab) * kChunk;
    bf16* a = sA + stage * tr * kLd;
    bf16* b = sB + stage * kChunk * kLd;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * nthreads;
      bf16* dst = a + (c / 8) * kLd + (c % 8) * 8;
      if constexpr (RESIDENT) {
        cp_async16_hint(dst, a_src[i] + col, a_ok[i], p_policy);
      } else {
        cp_async16(dst, a_src[i] + col, a_ok[i]);
      }
    }
    for (int c = tid; c < kChunk * 8; c += nthreads) {
      bf16* dst = b + (c / 8) * kLd + (c % 8) * 8;
      const bf16* src = x0 + (col + c / 8) * dpad + d0 + (c % 8) * 8;
      if constexpr (RESIDENT) {
        cp_async16_hint(dst, src, true, x_policy);
      } else {
        cp_async16(dst, src, true);
      }
    }
    cp_async_commit();
  };

  float acc[8][4] = {};
  load(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load((ch + 1) % 2, ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* a = sA + (ch % 2) * tr * kLd;
    const bf16* b = sB + (ch % 2) * kChunk * kLd;
    float part[8][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      mma_k16<false, kLd>(part, a, b, warp * 16, k0, lane);
    }
    fold(acc, part);
    __syncthreads();  // the stage is reloaded two chunks later
  }
  store_tile(acc, out, r0 + warp * 16, r_tot, dpad, d0, lane);
}

// One TR-row stage of T2/T4: columns [col0, col0 + 128) of the gathered
// rows rb + [0, tr) into ps (pitch kLdP) and the features [d0, d0 + 64) of
// the same rows of ct into cs (pitch kLd), as one cp.async group. Rows past
// r_tot and ids outside [0, n) read as zeros.
__device__ __forceinline__ void load_col_stage(
    bf16* ps, bf16* cs, const bf16* __restrict__ p4,
    const int* __restrict__ rows, const bf16* __restrict__ ct, int n,
    size_t npad, size_t col0, int r_tot, int dpad, int d0, int rb, int tr,
    int tid) {
  for (int c = tid; c < tr * (kColTile / 8); c += kT2Threads) {
    const int r = rb + c / (kColTile / 8);
    const int id = r < r_tot ? rows[r] : -1;
    const bool ok = id >= 0 && id < n;
    cp_async16(ps + (c / (kColTile / 8)) * kLdP + (c % (kColTile / 8)) * 8,
               p4 + (size_t)(ok ? id : 0) * npad + col0 +
                   (c % (kColTile / 8)) * 8,
               ok);
  }
  for (int c = tid; c < tr * 8; c += kT2Threads) {
    const int r = rb + c / 8;
    cp_async16(cs + (c / 8) * kLd + (c % 8) * 8,
               ct + (size_t)(r < r_tot ? r : 0) * dpad + d0 + (c % 8) * 8,
               r < r_tot);
  }
  cp_async_commit();
}

// T2 (TRANS_OUT false): dx (npad, dpad) = P4[rows]^T @ ct; warp w owns the
// columns col0 + 16 w + [0, 16) and the block's 64 features.
// T4 (TRANS_OUT true): dxt (dpad, npad) = ct^T @ P4[rows]; warp w owns the
// features d0 + 16 (w % 4) + [0, 16) and the columns col0 + 64 (w / 4) +
// [0, 64).
// Block x owns the 128 columns [128 x, 128 x + 128) of P (inside one slab,
// since tkc is a multiple of 128), block y the features [64 y, 64 y + 64).
template <bool TRANS_OUT>
__global__ void __launch_bounds__(kT2Threads)
fused_bwd_4d_kernel(const bf16* __restrict__ p4, const int* __restrict__ rows,
                    const bf16* __restrict__ ct, float* __restrict__ dx,
                    int n, int nj, int tkc, int r_tot, int dpad, int tr) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sP = reinterpret_cast<bf16*>(smem);  // [2][tr][kLdP] rows x columns
  bf16* sC = sP + 2 * tr * kLdP;             // [2][tr][kLd] rows x features
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t npad = (size_t)nj * tkc;
  const size_t col0 = (size_t)blockIdx.x * kColTile;
  const int d0 = blockIdx.y * kDTile;
  const int n_steps = (r_tot + tr - 1) / tr;
  auto load = [&](int stage, int step) {
    load_col_stage(sP + stage * tr * kLdP, sC + stage * tr * kLd, p4, rows, ct,
                   n, npad, col0, r_tot, dpad, d0, step * tr, tr, tid);
  };

  float acc[8][4] = {};
  if (n_steps > 0) load(0, 0);
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) {
      load((s + 1) % 2, s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ps = sP + (s % 2) * tr * kLdP;
    const bf16* cs = sC + (s % 2) * tr * kLd;
    float part[8][4] = {};
    for (int k0 = 0; k0 < tr; k0 += 16) {  // gathered rows in order
      if constexpr (TRANS_OUT) {
        mma_k16<true, kLd, kLdP>(part, cs, ps + (warp / 4) * kChunk,
                                 (warp % 4) * 16, k0, lane);
      } else {
        mma_k16<true, kLdP>(part, ps, cs, warp * 16, k0, lane);
      }
    }
    fold(acc, part);
    __syncthreads();
  }
  if constexpr (TRANS_OUT) {
    store_tile(acc, dx, d0 + (warp % 4) * 16, dpad, (int)npad,
               (int)col0 + (warp / 4) * kChunk, lane);
  } else {
    store_tile(acc, dx, (long long)col0 + warp * 16, (long long)npad, dpad,
               d0, lane);
  }
}

bool bad_shape(int n, int nj, int tkc, int r_tot, int dpad, int tr) {
  return n < 1 || nj < 1 || tkc < kColTile || tkc % kColTile ||
         r_tot < 0 || dpad < kDTile || dpad % kDTile || tr < 16 ||
         tr > kMaxTr || tr % 16;
}

size_t fwd_smem(int tr) { return (size_t)(2 * tr + 2 * kChunk) * kLd * 2; }

size_t bwd_smem(int tr) { return (size_t)2 * tr * (kLdP + kLd) * 2; }

template <bool RESIDENT>
int launch_fwd(const void* p4, const void* rows, const void* x0, void* out,
               int n, int nj, int tkc, int r_tot, int dpad, int tr,
               void* stream) {
  if (bad_shape(n, nj, tkc, r_tot, dpad, tr)) return (int)cudaErrorInvalidValue;
  if (r_tot == 0) return (int)cudaGetLastError();
  const size_t smem = fwd_smem(tr);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_4d_kernel<RESIDENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((r_tot + tr - 1) / tr, dpad / kDTile);
  fused_fwd_4d_kernel<RESIDENT><<<grid, 2 * tr, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(p4), static_cast<const int*>(rows),
      static_cast<const bf16*>(x0), static_cast<float*>(out), n, nj, tkc,
      r_tot, dpad, tr);
  return (int)cudaGetLastError();
}

template <bool TRANS_OUT>
int launch_bwd(const void* p4, const void* rows, const void* ct, void* dx,
               int n, int nj, int tkc, int r_tot, int dpad, int tr,
               void* stream) {
  if (bad_shape(n, nj, tkc, r_tot, dpad, tr) || bwd_smem(tr) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(tr);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_4d_kernel<TRANS_OUT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((size_t)nj * tkc / kColTile), dpad / kDTile);
  fused_bwd_4d_kernel<TRANS_OUT><<<grid, kT2Threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(p4), static_cast<const int*>(rows),
      static_cast<const bf16*>(ct), static_cast<float*>(dx), n, nj, tkc,
      r_tot, dpad, tr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// p4 (n, nj, tkc / 128, 128) bf16; rows (r_tot,) int32; x0 (nj * tkc,
// dpad) bf16; out (r_tot, dpad) f32.
int igcn_fused_fwd_4d(const void* p4, const void* rows, const void* x0,
                      void* out, int n, int nj, int tkc, int r_tot, int dpad,
                      int tr, void* stream) {
  return launch_fwd<false>(p4, rows, x0, out, n, nj, tkc, r_tot, dpad, tr,
                           stream);
}

// T3: igcn_fused_fwd_4d's operands, and resident (0 or 1) for X0 kept in L2.
int igcn_fused_fwd_tune(const void* p4, const void* rows, const void* x0,
                        void* out, int n, int nj, int tkc, int r_tot, int dpad,
                        int tr, int resident, void* stream) {
  if (resident != 0 && resident != 1) return (int)cudaErrorInvalidValue;
  return resident ? launch_fwd<true>(p4, rows, x0, out, n, nj, tkc, r_tot,
                                     dpad, tr, stream)
                  : launch_fwd<false>(p4, rows, x0, out, n, nj, tkc, r_tot,
                                      dpad, tr, stream);
}

// p4 (n, nj, tkc / 128, 128) bf16; rows (r_tot,) int32; ct (r_tot, dpad)
// bf16; dx (nj * tkc, dpad) f32.
int igcn_fused_bwd_4d(const void* p4, const void* rows, const void* ct,
                      void* dx, int n, int nj, int tkc, int r_tot, int dpad,
                      int tr, void* stream) {
  return launch_bwd<false>(p4, rows, ct, dx, n, nj, tkc, r_tot, dpad, tr,
                           stream);
}

// T4: igcn_fused_bwd_4d's operands; dxt (dpad, nj * tkc) f32.
int igcn_fused_bwd_t(const void* p4, const void* rows, const void* ct,
                     void* dxt, int n, int nj, int tkc, int r_tot, int dpad,
                     int tr, void* stream) {
  return launch_bwd<true>(p4, rows, ct, dxt, n, nj, tkc, r_tot, dpad, tr,
                          stream);
}

}  // extern "C"
