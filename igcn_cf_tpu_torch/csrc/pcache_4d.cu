// T1 and T3: the 4-D fused gather kernels of the propagation-cache
// microbenchmarks, the forward out = P[rows] @ X0; and K3, the cache's
// forward, on the same body.
//
// Replaces the TPU kernels tools/microbench_pcache.py::fused_fwd_4d (T1)
// and tools/microbench_pcache_tune.py::fwd (T3):
//
//   T1  out (R, d) = P4[rows] @ X0   P4 (n, NJ, sub, 128) bf16, X0 (npad, d) bf16
//   T3  T1's product, with X0 kept in L2 on request (resident_x0)
//
// The backward kernels of the same tools, T2 (::fused_bwd_4d, dX0 (npad,
// d) = P4[rows]^T @ ct) and T4 (microbench_pcache_tune.py::bwd_t, its
// transpose), are K4's body with K4's store and with a transposed one:
// their entries igcn_fused_bwd_4d and igcn_fused_bwd_t sit beside that
// body in pcache.cu.
//
// with npad = NJ * tkc, tkc = sub * 128, and f32 sums. P4 is the row-major
// (n, npad) matrix seen as NJ column slabs of tkc columns per row: the same
// memory, so one row of one slab is a contiguous run of tkc bf16.
//
// What bounds them on the H100. At the tool's shape (n = 70,839, npad =
// 73,728, R = 6,144, d = 64) one pass over the gathered rows is R * npad *
// 2 B = 906 MB, 0.270 ms at the data sheet's 3.35 TB/s, against 2 * R *
// npad * d = 5.8e10 FLOP, 0.059 ms at 989 TFLOP/s bf16: the body is bound
// by the P stream. They multiply on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 sums), fed by cp.async rings (helpers in
// mma_sync.cuh).
//
// K3, the propagation cache's forward (igcn_cf_tpu/kernels/pcache.py::
// _fused_fwd: reps (R, d) = P[rows] @ X0 on the row-major (n, npad) P), is
// T1's body at TR 128 with NJ gone: its entry igcn_gather_fwd is below, and
// at one (P, rows, X0) it is bit-equal to T1 at TR 128, which runs the
// same kernel with the same S.
//
// T1's forward body. A gathered row is a random 147 KB run of P, so the
// stream is a gather of 128-byte row segments, and at about 1 us of latency
// the card reads only as fast as it keeps bytes in flight (Little's law:
// 3.35 TB/s needs ~3.4 MB in flight). The TPU kernel's design (one block
// per TR rows walking every slab, two stages) kept 48 blocks busy at TR
// 128, at most two 16 KB stages each in flight: ~0.8 TB/s, 1.04 ms. So:
// - The npad contraction is split in S column ranges of whole stages
//   (grid: row blocks x S x feature tiles). S (fwd_splits) is the most
//   splits whose grid the card runs in one wave at this TR, by the
//   occupancy the runtime reports; each split writes a partial (R, dpad)
//   slab, and split_sum.cuh adds the slabs in split order afterwards: one
//   writer per output, no atomics, two launches bit-equal.
// - A kStages-deep cp.async ring of 64-column stages keeps kStages - 1
//   stages of P in flight while one is summed, with one barrier a stage:
//   at TR 128, 2 blocks an SM hold 2 x 16 KB each, ~8.4 MB across the
//   card. Two- and four-stage rings, 128-column stages and an L2::256B
//   prefetch of P were no faster on the card once S fills it: latency is
//   no longer the limit.
// - One X0 stage serves all TR rows of a block, as on the TPU; X0 (9.4 MB)
//   stays in L2, but every row block reads it again: 64 / TR bytes from L2
//   for each byte of P. At TR 64 and 32 that traffic, (1 + 64 / TR) x 906
//   MB at 4.3-4.7 TB/s out of L2, is what bounds the body; at TR 128 the
//   gather of 128-byte segments runs at ~73% of the data sheet's rate
//   (device-only times, H100 80GB HBM3 at 700 W).
// - Each stage is summed in a fresh tensor-core fragment and folded into
//   the running sum with f32 adds (see fold); a block owns TR gathered rows
//   (TR / 16 warps, 16 rows and 64 features each).
// K3 launches this body at TR 128 with T1's S. K4, the cache's backward,
// has a body of its own (pcache.cu), 320-column tiles, which T2 and T4 run.
//
// T3 is T1's body with a compile-time RESIDENT flag. On the TPU,
// resident_x0 fetches all of X0 into VMEM once; on Hopper X0 (npad x 64
// bf16 = 9.4 MB at the tool's shape) cannot sit in a block's 227 KB of
// shared memory, so "resident" means resident in the 50 MB L2: X0's copies
// carry an evict_last policy and P's an evict_first one, so the 906 MB of
// gathered rows stream past without pushing X0 out, and X0 crosses device
// memory about once. S is taken from the RESIDENT-free instance for both,
// so at one (NJ, TR) the two variants and T1 sum in one order and are
// bit-equal. NJ names the JAX tool's slabs; the 4-D P is the row-major P's
// memory, so the body reads npad contiguous columns whatever NJ is.
//
// A row id outside [0, n) and a row past R read as zeros. d is padded by
// the wrapper to a multiple of 64; each 64-wide feature tile is a grid
// column of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"
#include "split_sum.cuh"

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
constexpr int kChunk = 64;              // T1 columns a stage
constexpr int kLd = 64 + 8;             // padded smem row of a 64-wide tile
constexpr int kStages = 3;              // T1/T3 ring depth
constexpr int kMaxTr = 256;             // TR in [16, 256], a multiple of 16
constexpr int kK3Tr = 128;              // K3's rows a block

// One k16 step of a warp's 16 x 64 output tile: acc += A (16 x 16) @ B
// (16 x 64). A(m, k) is sA[(m0 + m) * kLd + k0 + k], B(k, n) is
// sB[(k0 + k) * kLd + n]. The padded pitch puts the 8 row addresses of an
// ldmatrix in distinct banks.
__device__ __forceinline__ void mma_k16(float (&acc)[8][4], const bf16* sA,
                                        const bf16* sB, int m0, int k0,
                                        int lane) {
  uint32_t a[4];
  ldsm_x4(a, sA + (m0 + (lane % 16)) * kLd + k0 + (lane / 16) * 8);
#pragma unroll
  for (int np = 0; np < kDTile / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, sB + (k0 + (lane % 16)) * kLd + np * 16 + (lane / 16) * 8);
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

// T1 and T3: slab y (R, dpad) = P4[rows, columns of split y] @ X0[those
// rows]; block x owns rows [x * tr, x * tr + tr), block y the stages [y *
// per_split, y * per_split + per_split) (the last split may hold fewer, or
// none, and then writes zeros), block z the features [64 z, 64 z + 64).
// 2 * tr threads. RESIDENT (T3's resident_x0) copies X0 under evict_last
// and P under evict_first; the arithmetic is the same.
template <bool RESIDENT>
__global__ void __launch_bounds__(2 * kMaxTr)
fused_fwd_4d_kernel(const bf16* __restrict__ p4, const int* __restrict__ rows,
                    const bf16* __restrict__ x0, float* __restrict__ slabs,
                    int n, int npad, int r_tot, int dpad, int tr,
                    int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);  // [kStages][tr][kLd] P rows
  bf16* sB = sA + kStages * tr * kLd;        // [kStages][kChunk][kLd] X0
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * tr;
  const int first = blockIdx.y * per_split;
  const int n_stages = min(per_split, npad / kChunk - first);
  const int d0 = blockIdx.z * kDTile;
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
  // stage s of this split: columns (first + s) * 64 + [0, 64)
  auto load = [&](int buf, int s) {
    const size_t col = (size_t)(first + s) * kChunk;
    bf16* a = sA + buf * tr * kLd;
    bf16* b = sB + buf * kChunk * kLd;
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
  };

  // the ring: stage s lands in buffer s % kStages; kStages - 1 groups are
  // in flight when stage s is summed (an empty group past the end keeps
  // the count)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load(s, s);
    cp_async_commit();
  }
  float acc[8][4] = {};
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    // stage s landed for every thread, and every warp is done with stage
    // s - 1, whose buffer the next load refills
    __syncthreads();
    if (s + kStages - 1 < n_stages) {
      load((s + kStages - 1) % kStages, s + kStages - 1);
    }
    cp_async_commit();
    const bf16* a = sA + (s % kStages) * tr * kLd;
    const bf16* b = sB + (s % kStages) * kChunk * kLd;
    float part[8][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      mma_k16(part, a, b, warp * 16, k0, lane);
    }
    fold(acc, part);
  }
  cp_async_wait<0>();
  store_tile(acc, slabs + (size_t)blockIdx.y * r_tot * dpad, r0 + warp * 16,
             r_tot, dpad, d0, lane);
}

bool bad_shape(int n, int nj, int tkc, int r_tot, int dpad, int tr) {
  return n < 1 || nj < 1 || tkc < 128 || tkc % 128 ||
         r_tot < 0 || dpad < kDTile || dpad % kDTile || tr < 16 ||
         tr > kMaxTr || tr % 16;
}

size_t fwd_smem(int tr) {
  return (size_t)kStages * (tr + kChunk) * kLd * 2;
}

// Blocks of the forward body an SM holds at this TR, as the runtime's
// occupancy calculator reports it for the RESIDENT-free instance (0 when
// the query fails).
int fwd_blocks_per_sm(int tr) {
  const size_t smem = fwd_smem(tr);
  int blocks = 0;
  if (cudaFuncSetAttribute(fused_fwd_4d_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fused_fwd_4d_kernel<false>, 2 * tr, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// S, the forward's column splits: the most whose grid (row blocks x S x
// feature tiles) the card holds in one wave, at least 1 and at most one
// stage a split.
int fwd_splits(int r_tot, int npad, int dpad, int tr) {
  const int tiles = ((r_tot + tr - 1) / tr) * (dpad / kDTile);
  const int stages = npad / kChunk;
  int dev = 0, sms = 0;
  if (tiles < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  int s = fwd_blocks_per_sm(tr) * sms / tiles;
  if (s > stages) s = stages;
  return s < 1 ? 1 : s;
}

// The forward body over the row-major (n, npad) P, once its entry has
// checked the shape: splits in [1, npad / 64], part given when splits > 1.
template <bool RESIDENT>
int launch_fwd_body(const void* p, const void* rows, const void* x0,
                    void* part, void* out, int n, int npad, int r_tot,
                    int dpad, int tr, int splits, void* stream) {
  if (r_tot == 0) return (int)cudaGetLastError();
  const size_t smem = fwd_smem(tr);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_4d_kernel<RESIDENT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int stages = npad / kChunk;
  const int per_split = (stages + splits - 1) / splits;
  auto s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits == 1 ? out : part);
  dim3 grid((r_tot + tr - 1) / tr, splits, dpad / kDTile);
  fused_fwd_4d_kernel<RESIDENT><<<grid, 2 * tr, smem, s>>>(
      static_cast<const bf16*>(p), static_cast<const int*>(rows),
      static_cast<const bf16*>(x0), dst, n, npad, r_tot, dpad, tr, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)igcn::sum_splits(static_cast<const float*>(part),
                               static_cast<float*>(out),
                               (long long)r_tot * dpad, splits, s);
}

template <bool RESIDENT>
int launch_fwd(const void* p4, const void* rows, const void* x0, void* part,
               void* out, int n, int nj, int tkc, int r_tot, int dpad, int tr,
               int splits, void* stream) {
  const long long npad = (long long)nj * tkc;
  if (bad_shape(n, nj, tkc, r_tot, dpad, tr) || npad > INT32_MAX ||
      splits < 1 || splits > npad / kChunk || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  return launch_fwd_body<RESIDENT>(p4, rows, x0, part, out, n, (int)npad,
                                   r_tot, dpad, tr, splits, stream);
}

}  // namespace

extern "C" {

// Column splits S of the forward body (T1/T3) at this shape: the number of
// partial (r_tot, dpad) f32 slabs its wrappers allocate (none when 1).
int igcn_fused_fwd_splits(int r_tot, int npad, int dpad, int tr) {
  return fwd_splits(r_tot, npad, dpad, tr);
}

// The forward body's launch at this shape, d padded to a multiple of 64 as
// the wrappers do: writes grid x (row blocks), grid y (S), grid z (feature
// tiles), threads a block, shared-memory bytes a block, ring stages, blocks
// an SM (the runtime's occupancy) and the largest S an entry takes.
void igcn_fused_fwd_launch_shape(int r_tot, int npad, int d, int tr,
                                 int* shape) {
  const int dpad = (d + kDTile - 1) / kDTile * kDTile;
  shape[0] = (r_tot + tr - 1) / tr;
  shape[1] = fwd_splits(r_tot, npad, dpad, tr);
  shape[2] = dpad / kDTile;
  shape[3] = 2 * tr;
  shape[4] = (int)fwd_smem(tr);
  shape[5] = kStages;
  shape[6] = fwd_blocks_per_sm(tr);
  shape[7] = npad / kChunk;
}

// K3: p (n, npad) bf16, npad a multiple of 64 (a column slab of the
// sharded cache has npad < n); rows (r_tot,) int32; x0
// (npad, dpad) bf16; part (splits, r_tot, dpad) f32 scratch (may be out
// when splits is 1); out (r_tot, dpad) f32. splits in [1, npad / 64], the
// body's range; the wrapper passes igcn_fused_fwd_splits at TR 128.
int igcn_gather_fwd(const void* p, const void* rows, const void* x0,
                    void* part, void* out, int n, int npad, int r_tot,
                    int dpad, int splits, void* stream) {
  // npad may be under n: a column slab of the sharded cache
  if (n < 1 || npad < kChunk || npad % kChunk || r_tot < 0 || dpad < kDTile ||
      dpad % kDTile || splits < 1 || splits > npad / kChunk ||
      (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  return launch_fwd_body<false>(p, rows, x0, part, out, n, npad, r_tot, dpad,
                                kK3Tr, splits, stream);
}

// p4 (n, nj, tkc / 128, 128) bf16; rows (r_tot,) int32; x0 (nj * tkc,
// dpad) bf16; part (splits, r_tot, dpad) f32 scratch (may be out when
// splits is 1); out (r_tot, dpad) f32. splits in [1, nj * tkc / 64]:
// igcn_fused_fwd_splits, or another value to time the choice.
int igcn_fused_fwd_4d(const void* p4, const void* rows, const void* x0,
                      void* part, void* out, int n, int nj, int tkc,
                      int r_tot, int dpad, int tr, int splits, void* stream) {
  return launch_fwd<false>(p4, rows, x0, part, out, n, nj, tkc, r_tot, dpad,
                           tr, splits, stream);
}

// T3: igcn_fused_fwd_4d's operands, and resident (0 or 1) for X0 kept in L2.
int igcn_fused_fwd_tune(const void* p4, const void* rows, const void* x0,
                        void* part, void* out, int n, int nj, int tkc,
                        int r_tot, int dpad, int tr, int splits, int resident,
                        void* stream) {
  if (resident != 0 && resident != 1) return (int)cudaErrorInvalidValue;
  return resident ? launch_fwd<true>(p4, rows, x0, part, out, n, nj, tkc,
                                     r_tot, dpad, tr, splits, stream)
                  : launch_fwd<false>(p4, rows, x0, part, out, n, nj, tkc,
                                      r_tot, dpad, tr, splits, stream);
}

}  // extern "C"
