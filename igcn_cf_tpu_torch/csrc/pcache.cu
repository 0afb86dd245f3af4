// K4: the propagation cache's backward gather-matmul, dX0 = P[rows]^T @ ct,
// and the two microbenchmark kernels that compute the same function on the
// same memory: T2 (its 4-D form) and T4 (its transposed form). K3, the
// cache's forward (reps = P[rows] @ X0), is the NJ-free case of T1's body:
// its C entry igcn_gather_fwd sits beside that body in pcache_4d.cu.
//
// Replaces the TPU kernels igcn_cf_tpu/kernels/pcache.py::_fused_bwd (K4;
// K3 replaces ::_fused_fwd), tools/microbench_pcache.py::fused_bwd_4d (T2)
// and tools/microbench_pcache_tune.py::bwd_t (T4):
//
//   K4  dX0 (npad, d) = P[rows]^T @ ct    P (n, npad) bf16, ct (R, d) bf16;
//                                          duplicate rows sum
//   T2  dX0 (npad, d) = P4[rows]^T @ ct   P4 (n, NJ, sub, 128) bf16: the
//                                          same memory as the row-major P
//   T4  dX0^T (d, npad) = ct^T @ P4[rows]
//
// with f32 sums and without ever writing P[rows] to device memory. P is
// stored row-major; the JAX package's 4-D slab layout and its 4096-column
// alignment existed only for the TPU's DMA engine.
//
// What bounds it on the H100. At the training slice R = 3 * 2048 = 6,144
// rows of P (npad = 70,912 columns) are 871 MB of bf16 per pass: a 0.26 ms
// stream at the data sheet's 3.35 TB/s, against 2 * R * npad * d = 5.6e10
// FLOP, 0.057 ms on the tensor cores (warp-level mma.sync m16n8k16, bf16
// in, f32 sums). So the bound is the gather of P, and beside it what
// crosses L2 to the SMs: a block that owns W columns of dX0 reads the
// whole ct stream again, 64 / W bytes of ct from L2 for each byte of P.
// The first K4 owned 64 columns (one ct byte a P byte: ~1.74 GB out of L2
// at 4.3-4.7 TB/s, which is where it sat) and ran 1,108 blocks of 6 an SM,
// 1.4-2 waves ending part-full. The design:
// - A block owns W = 320 columns of one 64-feature tile and walks its rows
//   in 16-row stages: ct costs a fifth of P out of L2, and each gathered
//   row is one 640-byte run (five whole 128-byte lines) per block.
// - The whole output in registers in one wave: at the training slice it is
//   70,912 x 64 f32 = 18 MB, over half of the SMs' register files. A
//   block of 10 warps holds its 320 x 64 sums (a warp 32 columns x 64
//   features, 64 f32 sums a thread, 96 registers), 2 blocks an SM: 264
//   slots for the 222 column tiles. The rows walk in the same order in
//   every block, so all blocks read one row of P at about the same time.
//   (Tiles of 256 columns at 3 blocks an SM, and of 384 at 2, ran 3-7%
//   slower on the card.)
// - A 5-stage cp.async ring of 16-row P and ct stages with one barrier a
//   stage keeps four stages (40 KB of P a block, ~9 MB across the card) in
//   flight: finer and deeper than a 3-stage ring of 32-row stages in the
//   same shared memory, which ran ~7% slower. The row ids travel four
//   stages ahead of the copies that use them, in a small shared-memory
//   ring filled by cp.async inside the same groups, so no copy waits on a
//   dependent load of rows[r] from device memory. The id ring is 2 x 4
//   stages deep, so the copies that fill it never land in a slot another
//   warp may still be reading. L2 eviction hints and an L2::256B prefetch
//   of P were no faster.
// - No split of the rows: at every npad the port builds (70,912 for the
//   Gowalla slice, more for Yelp and Amazon) the column tiles alone fill
//   the card, and splits of the 6,144 rows in 2 or 4 ranges, each summed
//   from an f32 slab, ran slower there.
// - Each k16 step (a stage's 16 rows) is summed in a fresh 4-register
//   fragment and added into the running f32 sums with the CUDA cores'
//   round-to-nearest adds, as T1-T4 fold theirs (pcache_4d.cu, fold). One
//   tensor-core accumulator carried over the 384 k16 steps of R = 6,144
//   drifted from the f32 reference by over 1e-3 on random N(0, 1) P and ct
//   (H100 80GB HBM3), past the gather tolerance. With 64 columns a warp
//   (128 sums a thread) the fold's registers spilled past the cap of 2
//   blocks an SM; 32 columns a warp leave room for it.
// Every output has one writer and one summation order (rows in order), no
// atomics: two launches are bit-equal, and duplicate row ids (users repeat
// in a batch, items across pos and neg) simply add up. P is symmetric, so
// the gathered ROWS are the needed columns of P^T; the A operand is the
// transposed shared tile, read with ldmatrix.trans. A row id outside
// [0, n) and a row past R read as zeros; npad is a multiple of 64, so a
// warp's 32 columns of the last tile are all inside P or all outside (npad
// may be under n: a column slab of the sharded cache).
//
// T2 and T4 are this body at npad = NJ * tkc, with K4's store (T2) or a
// transposed one (TRANS_OUT, T4): the same sums, each stored at (column,
// feature) of the (npad, d) output or at (feature, column) of the (d, npad)
// one, so T2's result is K4's bit for bit and T4's is K4's transposed. NJ
// names the TPU tool's column slabs only: the 4-D P4 is the row-major P's
// memory. The TPU tool's TR (gathered rows a grid step) maps, in one
// dispatch for both (launch_tr), to the rows of a ring stage where such
// stages fit 2 blocks an SM: TR 32 runs 4 stages of 32 rows, TR 64 2
// stages of 64 (each ~103 KB of shared memory); 128-row stages would need
// 205 KB a block for two of them, so TR 128, and every other TR, runs K4's
// own 5 stages of 16 rows. The rows of a stage change neither the sums nor
// their order (each k16 step is folded on its own), so every TR gives the
// same bits. The transposed store needs no shared memory: for each of its
// 64 stores a warp writes 4 features x 8 consecutive columns, whole
// 32-byte sectors, and the output (18 MB at the tool's shape) is ~2% of
// the bytes the pass moves. A 2-stage ring of 64-row stages keeps one
// stage in flight and waits on each: TR 64 is the slow row of T2 and T4
// alike (H100 80GB HBM3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

using igcn::bf16;
using igcn::cp_async16;
using igcn::cp_async_commit;
using igcn::cp_async_wait;
using igcn::ldsm_x4_t;
using igcn::mma16816;

constexpr int kDTile = 64;                 // features per block
constexpr int kWarpCols = 32;              // columns of dX0 a warp owns
constexpr int kWarps = 10;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = kWarps * kWarpCols;  // 320 columns a block
constexpr int kLdP = kCols + 8;            // padded smem row of P, in bf16
constexpr int kLdC = kDTile + 8;           // padded smem row of ct
constexpr int kMinBlocks = 2;              // blocks an SM the design needs

// A ring of STAGES stages of ROWS gathered rows (K4: 5 x 16).
template <int ROWS, int STAGES>
struct Ring {
  static_assert(ROWS % 16 == 0 && STAGES >= 2, "k16 steps, one stage ahead");
  static constexpr int kAhead = STAGES - 1;  // stages in flight
  // stages of row ids in smem: load(t) reads slot t and fills slot t +
  // kAhead (mod 2 kAhead), which neither the prologue's loads (slots 0 ..
  // kAhead - 1, no barrier between them) nor the loop's (one barrier a
  // stage) read while it may run
  static constexpr int kIdRing = 2 * kAhead;
  static constexpr int kStageBytes = ROWS * (kLdP + kLdC) * 2;
  static constexpr int kSmem = STAGES * kStageBytes + kIdRing * ROWS * 4;
};

// Copy `bytes` (0-16) from device memory to shared memory and zero the rest
// of the 16; with 0 bytes gmem is not read.
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem,
                                             int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// dx (npad, dpad) = P[rows]^T @ ct, or with TRANS_OUT its transpose dx
// (dpad, npad). Block x owns the columns [320 x, 320 x + 320), block y the
// features [64 y, 64 y + 64); warp w owns the columns 320 x + 32 w + [0,
// 32). The rows walk in stages of ROWS through a ring of STAGES.
template <int ROWS, int STAGES, bool TRANS_OUT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gather_bwd_kernel(const bf16* __restrict__ p, const int* __restrict__ rows,
                  const bf16* __restrict__ ct, float* __restrict__ dx,
                  int n, int npad, int r_tot, int dpad) {
  using R = Ring<ROWS, STAGES>;
  constexpr int kRows = ROWS, kStages = STAGES, kAhead = R::kAhead,
                kIdRing = R::kIdRing;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sP = reinterpret_cast<bf16*>(smem);  // [kStages][kRows][kLdP]
  bf16* sC = sP + kStages * kRows * kLdP;    // [kStages][kRows][kLdC]
  int* sId = reinterpret_cast<int*>(sC + kStages * kRows * kLdC);  // [kIdRing][kRows]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * kCols;
  const int n_stages = (r_tot + kRows - 1) / kRows;
  const int d0 = blockIdx.y * kDTile;

  // the ids of stage t: 4 copies of 4 ids by threads j < 4, zero past r_tot
  // (those rows are masked by their index, not by the id)
  auto load_ids = [&](int t, int j) {
    const int r = t * kRows + 4 * j;
    const int bytes = min(16, max(0, 4 * (r_tot - r)));
    cp_async16_n(sId + (t % kIdRing) * kRows + 4 * j,
                 rows + (bytes ? r : 0), bytes);
  };
  // stage t into ring buffer t % kStages: rows kRows t + [0, kRows) of P
  // (columns col0 + [0, 320)) and of ct (features d0 + [0, 64)); and the ids
  // of stage t + kAhead, which the copies of stage t + kAhead read
  auto load = [&](int t) {
    const int buf = t % kStages;
    const int rb = t * kRows;
    const int* ids = sId + (t % kIdRing) * kRows;
    bf16* sp = sP + buf * kRows * kLdP;
    bf16* sc = sC + buf * kRows * kLdC;
#pragma unroll
    for (int i = 0; i < kRows * (kCols / 8) / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (kCols / 8), col = col0 + (c % (kCols / 8)) * 8;
      const int id = ids[row];
      const bool ok = rb + row < r_tot && id >= 0 && id < n && col < npad;
      cp_async16(sp + row * kLdP + (c % (kCols / 8)) * 8,
                 p + (ok ? (size_t)id * npad + col : 0), ok);
    }
    for (int c = tid; c < kRows * (kDTile / 8); c += kThreads) {
      const int row = c / (kDTile / 8), r = rb + row;
      cp_async16(sc + row * kLdC + (c % 8) * 8,
                 ct + (r < r_tot ? (size_t)r * dpad + d0 + (c % 8) * 8 : 0),
                 r < r_tot);
    }
    if (tid < kRows / 4 && t + kAhead < n_stages) load_ids(t + kAhead, tid);
  };

  // the ids of the first kAhead stages, then those stages (whose loads
  // fill the id slots kAhead .. 2 kAhead - 1, none of which they read)
  if (tid < kAhead * (kRows / 4) && tid / (kRows / 4) < n_stages)
    load_ids(tid / (kRows / 4), tid % (kRows / 4));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < n_stages) load(t);
    cp_async_commit();
  }

  float acc[kWarpCols / 16][8][4] = {};
  const int wc = warp * kWarpCols;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<kStages - 2>();
    // stage s (and the ids of stage s + kAhead) landed for every thread,
    // and every warp is done with stage s - 1, whose buffer the next load
    // refills
    __syncthreads();
    if (s + kAhead < n_stages) load(s + kAhead);
    cp_async_commit();
    const bf16* sp = sP + (s % kStages) * kRows * kLdP;
    const bf16* sc = sC + (s % kStages) * kRows * kLdC;
#pragma unroll
    for (int k0 = 0; k0 < kRows; k0 += 16) {  // gathered rows in order
      uint32_t a[kWarpCols / 16][4];
#pragma unroll
      for (int mt = 0; mt < kWarpCols / 16; ++mt) {
        ldsm_x4_t(a[mt], sp + (k0 + (lane % 8) + (lane / 16) * 8) * kLdP +
                             wc + mt * 16 + ((lane / 8) % 2) * 8);
      }
#pragma unroll
      for (int np = 0; np < kDTile / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, sc + (k0 + (lane % 16)) * kLdC + np * 16 +
                         (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < kWarpCols / 16; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float step[4] = {};  // this k16 step, folded into acc below
            mma16816(step, a[mt], b[2 * h], b[2 * h + 1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][2 * np + h][i] += step[i];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the sums go straight from registers to device memory: no shared memory
  // is written after the loop, so nothing here races with the ring
  if (col0 + wc >= npad) return;  // a warp past the last column of P
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < kWarpCols / 16; ++mt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t c = col0 + wc + mt * 16 + g + h * 8;
        const int f = d0 + j * 8 + t * 2;  // features f and f + 1
        if constexpr (TRANS_OUT) {
          dx[(size_t)f * npad + c] = acc[mt][j][2 * h];
          dx[(size_t)(f + 1) * npad + c] = acc[mt][j][2 * h + 1];
        } else {
          *reinterpret_cast<float2*>(dx + c * dpad + f) =
              make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
      }
    }
  }
}

// npad may be under n: a column slab of P (one table shard's window of the
// sharded cache) has n rows and fewer columns.
bool bad_shape(int n, int npad, int r_tot, int dpad) {
  return n < 1 || npad < 64 || npad % 64 || r_tot < 0 ||
         dpad < kDTile || dpad % kDTile;
}

// Blocks of an instance an SM holds, as the runtime's occupancy calculator
// reports it (0 when the query fails).
template <int ROWS, int STAGES, bool TRANS_OUT>
int blocks_per_sm() {
  constexpr int smem = Ring<ROWS, STAGES>::kSmem;
  int blocks = 0;
  auto kernel = gather_bwd_kernel<ROWS, STAGES, TRANS_OUT>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return blocks;
}

// An instance's launch at this shape, d padded to a multiple of 64: grid x
// (column tiles), grid y (feature tiles), threads a block, shared-memory
// bytes a block, ring stages, rows a stage and blocks an SM.
template <int ROWS, int STAGES, bool TRANS_OUT>
void launch_shape(int npad, int d, int* shape) {
  shape[0] = (npad + kCols - 1) / kCols;
  shape[1] = (d + kDTile - 1) / kDTile;
  shape[2] = kThreads;
  shape[3] = Ring<ROWS, STAGES>::kSmem;
  shape[4] = STAGES;
  shape[5] = ROWS;
  shape[6] = blocks_per_sm<ROWS, STAGES, TRANS_OUT>();
}

template <int ROWS, int STAGES, bool TRANS_OUT>
int launch(const void* p, const void* rows, const void* ct, void* dx, int n,
           int npad, int r_tot, int dpad, void* stream) {
  constexpr int smem = Ring<ROWS, STAGES>::kSmem;
  auto kernel = gather_bwd_kernel<ROWS, STAGES, TRANS_OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((npad + kCols - 1) / kCols, dpad / kDTile);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(p), static_cast<const int*>(rows),
      static_cast<const bf16*>(ct), static_cast<float*>(dx), n, npad, r_tot,
      dpad);
  return (int)cudaGetLastError();
}

// T2's and T4's shape check: K4's, with npad = nj * tkc in int and TR a
// multiple of 16 in [16, 256], as the TPU tool takes it.
bool bad_4d_shape(int n, int nj, int tkc, int r_tot, int dpad, int tr) {
  return n < 1 || nj < 1 || tkc < 128 || tkc % 128 ||
         (long long)nj * tkc > INT32_MAX || r_tot < 0 || dpad < kDTile ||
         dpad % kDTile || tr < 16 || tr > 256 || tr % 16;
}

// TR -> (rows a stage, stages) for T2 and T4: (32, 4) at 32, (64, 2) at 64,
// else K4's (16, 5).
template <bool TRANS_OUT>
void launch_shape_tr(int npad, int d, int tr, int* shape) {
  switch (tr) {
    case 32: return launch_shape<32, 4, TRANS_OUT>(npad, d, shape);
    case 64: return launch_shape<64, 2, TRANS_OUT>(npad, d, shape);
    default: return launch_shape<16, 5, TRANS_OUT>(npad, d, shape);
  }
}

template <bool TRANS_OUT>
int launch_tr(const void* p4, const void* rows, const void* ct, void* dx,
              int n, int nj, int tkc, int r_tot, int dpad, int tr,
              void* stream) {
  if (bad_4d_shape(n, nj, tkc, r_tot, dpad, tr) ||
      reinterpret_cast<uintptr_t>(rows) % 16)
    return (int)cudaErrorInvalidValue;
  const int npad = nj * tkc;
  switch (tr) {
    case 32:
      return launch<32, 4, TRANS_OUT>(p4, rows, ct, dx, n, npad, r_tot, dpad,
                                      stream);
    case 64:
      return launch<64, 2, TRANS_OUT>(p4, rows, ct, dx, n, npad, r_tot, dpad,
                                      stream);
    default:
      return launch<16, 5, TRANS_OUT>(p4, rows, ct, dx, n, npad, r_tot, dpad,
                                      stream);
  }
}

}  // namespace

extern "C" {

// K4's launch at this shape: grid x, grid y, threads, shared bytes,
// stages, blocks an SM.
void igcn_gather_bwd_launch_shape(int npad, int d, int* shape) {
  int full[7];
  launch_shape<16, 5, false>(npad, d, full);
  for (int i = 0; i < 5; ++i) shape[i] = full[i];
  shape[5] = full[6];
}

// p (n, npad) bf16; rows (r_tot,) int32, 16-byte aligned; ct (r_tot, dpad)
// bf16; dx (npad, dpad) f32.
int igcn_gather_bwd(const void* p, const void* rows, const void* ct,
                    void* dx, int n, int npad, int r_tot, int dpad,
                    void* stream) {
  if (bad_shape(n, npad, r_tot, dpad) ||
      reinterpret_cast<uintptr_t>(rows) % 16)
    return (int)cudaErrorInvalidValue;
  return launch<16, 5, false>(p, rows, ct, dx, n, npad, r_tot, dpad, stream);
}

// T2's (transposed == 0) or T4's (transposed == 1) launch at TR tr: grid x,
// grid y, threads, shared bytes, stages, rows a stage, blocks an SM.
void igcn_fused_bwd_4d_launch_shape(int npad, int d, int tr, int transposed,
                                    int* shape) {
  if (transposed) return launch_shape_tr<true>(npad, d, tr, shape);
  launch_shape_tr<false>(npad, d, tr, shape);
}

// T2: p4 (n, nj, tkc / 128, 128) bf16, the row-major (n, nj * tkc) P;
// rows (r_tot,) int32, 16-byte aligned; ct (r_tot, dpad) bf16; dx (nj *
// tkc, dpad) f32.
int igcn_fused_bwd_4d(const void* p4, const void* rows, const void* ct,
                      void* dx, int n, int nj, int tkc, int r_tot, int dpad,
                      int tr, void* stream) {
  return launch_tr<false>(p4, rows, ct, dx, n, nj, tkc, r_tot, dpad, tr,
                          stream);
}

// T4: T2's operands, and dxt (dpad, nj * tkc) f32.
int igcn_fused_bwd_t(const void* p4, const void* rows, const void* ct,
                     void* dxt, int n, int nj, int tkc, int r_tot, int dpad,
                     int tr, void* stream) {
  return launch_tr<true>(p4, rows, ct, dxt, n, nj, tkc, r_tot, dpad, tr,
                         stream);
}

}  // extern "C"
