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
// zero. Both bodies SKIP zero words (the TPU kernels did the dense work on
// the MXU): a launch streams the 170 MB of words once, a ~51 us floor at
// the data sheet's 3.35 TB/s, and gathers one d-wide bf16 row of X per set
// bit (833k rows of 128 B at d=64; X1 is 5.8 MB and X2 3.9 MB, so the
// gathers mostly hit the 50 MB L2). The arithmetic, 2 * d FLOP per set bit,
// is negligible. What bounds each body is the word stream, the latency of
// the dependent chain from a word to its X gathers (set bits are found by
// warp votes and shuffles), and for K2 the partial slabs. Measured times are
// in PERF.md. No tensor cores, no TMA, no atomics. The wrappers pad d to a
// multiple of 8, so that rows of X are whole 16-byte vectors.
//
// t1 body (K1): one warp per row of B, 8 rows a block. Each lane reads 4
// words with one 16-byte load, 128 words a warp step (11 steps at kw =
// 1,408), the next step's load issued before the current step is used: the
// row streams at close to the card's rate. A warp prefix sum ranks the
// step's set bits, and every lane writes its bits' columns into the warp's
// list in shared memory (256 entries). The gathers then run from the list:
// the lanes form G = 32 / L groups of L lanes, L lanes reading one X1 row
// as 16-byte vectors (L = 8 at d=64), group g takes the entries whose rank
// in the row is g mod G, and each group has 4 rows in flight before it adds
// them (16 at d=64), so a row of ~28 set bits waits on ~2 gather latencies,
// not one per step. Each group keeps its partial row sum in registers; a
// fixed butterfly adds the groups at the end.
//
// t2 body (K2): K2 contracts over the rows of B. On the TPU a sequential
// grid axis carried that sum in VMEM; Hopper blocks run in no order. A
// block owns WPB adjacent word columns, one a warp (8 at d <= 64, 4 above,
// so that its shared-memory partials of 32 * d f32 a warp let three blocks
// share an SM at d <= 128), and one of S row chunks: grid (kw / WPB, S).
// Every thread loads 16 bytes of a 128-row tile of the block's words a
// stage (whole 32-byte sectors at WPB = 8), two stages in flight in
// registers, and stores it transposed into shared memory, where a warp
// votes over its own column, 32 rows a ballot, without bank conflicts.
// Live words are taken in ascending row order 4 at a time, all 4 X2 rows
// loaded (each lane one vector of d / 32 features) before any is added; the
// last 4 of a stage are added after the next stage's barrier, so their
// loads overlap it. Each chunk's block writes a partial (K, d) slab; a second pass
// (split_sum.cuh) adds the S slabs in chunk order, so every output element
// has one writer per pass and one summation order: deterministic, and the
// same for any launch. S (igcn_t2_splits) aims at ~10 blocks an SM (8 at
// d=64, 4 at d=128 on the full B), and S = 1 writes y2 directly. The word
// stream of 32 bytes a row (16 at d=128) runs at well under the card's
// rate, and the slabs cost S * K * d * 4 bytes written and read again.
//
// K7m's rows route (t2_kernel_rows): the t2 product without the t2 body.
// Given B's transposed pack B^T (one row an item, B's rows as its columns,
// in the same tile layout; built once with the graph), Y = (B o M)^T @ X is
// the t1 walk over B^T's rows: one writer per output row, so no partial
// slabs and no second pass, and the word stream of 16 bytes a lane of the
// t1 body. Item degrees are skewed (Zipf): at the Gowalla shape the
// heaviest row of B^T holds ~2,000 set bits against a mean of 17, and one
// warp on it waits on ~100 gather rounds. So warps take the rows in
// descending order of their set bits (the pack's `order`), and each row of
// more than one gather list's bits (the pack's first `heavy` rows) takes a
// whole block, warp j walking steps j, j + 8, ... of the row and warp 0
// adding the 8 partials in warp order. A row's sum order thus depends on
// whether a warp or a block walks it: one pack and one schedule give one
// order, deterministic. Measured times are in PERF.md.
//
// Both bodies also serve K6/K7, the bb_matmul pair (entries at the end), and
// take a compile-time MASKED flag for the edge-dropout variants (K1m/K2m of
// the pair, K6m/K7m of bb_matmul): an edge counts only where the keep word
// of its (row, word) coordinate (keepword.cuh) keeps it. The keep decision
// is a function of (seed, row, word) only, so the two directions under one
// seed drop the same edges. Only words that hold an edge are hashed, once a
// set-bit entry of t1's list (lane t tests entry t) and once a live word of
// a t2 batch (lane k hashes slot k). Dropped edges are skipped exactly as
// absent ones and the order of the remaining sums does not change, so the
// masked entries are bit-equal to the unmasked ones run over mask_words'
// masked copy of B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "keepword.cuh"
#include "split_sum.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTKP = 128;            // word lanes per tile
constexpr int kTK = kTKP * 32;       // columns per tile
constexpr int kT1Threads = 256;      // 8 rows per block
constexpr int kT1Words = 128;        // words per warp step: 16 bytes a lane
constexpr int kT1List = 256;         // set-bit columns a warp lists per gather
constexpr int kT1Loads = 4;          // X1 rows in flight per lane group
constexpr int kT2Rows = 128;         // rows of B per t2 stage
constexpr int kT2Ld = kT2Rows + 4;   // padded row of the transposed tile
constexpr int kT2Batch = 4;          // X2 rows a t2 warp gathers at once
constexpr int kT2TargetBlocks = 10 * 132;  // t2 blocks to aim for

__device__ __forceinline__ int column_of(int word, int bit) {
  return (word / kTKP) * kTK + bit * kTKP + (word % kTKP);
}

// Words w .. w+3 of one row of B (w a multiple of 4): one 16-byte load when
// B is 16-byte aligned (vec), else four loads, as for a view that starts
// mid-vector. Words at or past kw read as zero.
__device__ __forceinline__ uint4 load_words(const uint32_t* row, int w,
                                            int kw, bool vec) {
  if (vec) {
    return w < kw ? __ldg(reinterpret_cast<const uint4*>(row + w))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  return make_uint4(w < kw ? __ldg(row + w) : 0u,
                    w + 1 < kw ? __ldg(row + w + 1) : 0u,
                    w + 2 < kw ? __ldg(row + w + 2) : 0u,
                    w + 3 < kw ? __ldg(row + w + 3) : 0u);
}

__device__ __forceinline__ void add_bf16x8(float (&acc)[8], uint4 v) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = u[i];
    const float2 f = __bfloat1622float2(h);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

// Which edges a t1-body walk drops: none; those whose keep word of their
// own (row, word) coordinate clears them (K1m/K6m, walking rows of B); or,
// walking a row of the transposed pack B^T (K7m's rows route), the same
// edges in B's coordinates: entry (item row, user col) is bit
// (row % 4096) / 128 of keepword(seed, col, word(row)), so the rows route
// drops exactly what K6m and the t2 body drop under the seed.
enum class Drop { kNone, kB, kBT };

// Add the X1 rows of list[0, n) to acc; `done` entries of the row came
// before. Lane group g (L lanes, one 16-byte vector of a row each) takes
// the entries whose rank in the row is g mod G, in order, kT1Loads of them
// in flight before their adds. DROP: first drop the entries whose edge the
// keep word clears, keeping the order of the rest (lane t tests entry t of
// each 32), so that the ranks, and the sums, are those of the unmasked body
// over the masked words. Returns the entries added.
template <int L, Drop DROP>
__device__ __forceinline__ int t1_flush(float (&acc)[8], int* list, int n,
                                        int done,
                                        const __nv_bfloat16* __restrict__ x1,
                                        int d, int lane, int row, uint32_t seed,
                                        int thr) {
  constexpr int G = 32 / L;
  __syncwarp();
  if constexpr (DROP != Drop::kNone) {
    int kept = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int e = i0 + lane;
      const int col = e < n ? list[e] : 0;
      bool keep;
      if constexpr (DROP == Drop::kB) {
        const int word = (col / kTK) * kTKP + col % kTKP, bit = (col % kTK) / kTKP;
        keep = e < n &&
               (igcn::keepword(seed, (uint32_t)row, (uint32_t)word, thr) >> bit) & 1u;
      } else {
        const int word = (row / kTK) * kTKP + row % kTKP, bit = (row % kTK) / kTKP;
        keep = e < n &&
               (igcn::keepword(seed, (uint32_t)col, (uint32_t)word, thr) >> bit) & 1u;
      }
      const unsigned ballot = __ballot_sync(kFull, keep);
      __syncwarp();  // every entry of this 32 is read before any moves down
      if (keep) list[kept + __popc(ballot & ((1u << lane) - 1u))] = col;
      kept += __popc(ballot);
    }
    n = kept;
    __syncwarp();
  }
  const int c = lane % L;
  const int first = (lane / L - done % G + G) % G;  // this group's first entry
  const bool chunk_ok = 8 * c < d;
  for (int i0 = 0; i0 < n; i0 += G * kT1Loads) {
    uint4 v[kT1Loads];
#pragma unroll
    for (int u = 0; u < kT1Loads; ++u) {
      const int e = i0 + u * G + first;
      v[u] = e < n && chunk_ok
                 ? __ldg(reinterpret_cast<const uint4*>(x1 + (size_t)list[e] * d) + c)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kT1Loads; ++u) add_bf16x8(acc, v[u]);
  }
  __syncwarp();  // the list is free again
  return n;
}

// One warp's walk over the set bits of one row's words, steps s0, s0 + ds,
// ... of kT1Words words each, their X1 rows added to acc (the lane groups'
// partials, not yet summed). The row's set-bit columns go to the list in
// (step, lane, word, bit) order; a full list is gathered before the walk
// goes on.
template <int L, Drop DROP>
__device__ __forceinline__ void t1_walk(float (&acc)[8], int* list,
                                        const uint32_t* words, int kw, bool vec,
                                        const __nv_bfloat16* __restrict__ x1,
                                        int d, int lane, int row, uint32_t seed,
                                        int thr, int s0, int ds) {
  int n = 0, done = 0;
  const int steps = (kw + kT1Words - 1) / kT1Words;
  uint4 next = load_words(words, s0 * kT1Words + 4 * lane, kw, vec);
  for (int s = s0; s < steps; s += ds) {
    const int base = s * kT1Words + 4 * lane;  // this lane's first word
    const uint32_t w[4] = {next.x, next.y, next.z, next.w};
    if (s + ds < steps) next = load_words(words, base + ds * kT1Words, kw, vec);
    const int cnt = __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
    if (__ballot_sync(kFull, cnt != 0) == 0u) continue;
    int incl = cnt;  // inclusive prefix sum of the set bits over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int off = incl - cnt;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int lo = 0; lo < total;) {  // the step's ranks [lo, hi) fit the list
      const int hi = min(total, lo + kT1List - n);
      const int i0 = max(0, lo - off), i1 = min(cnt, hi - off);
      int idx = 0;  // this lane's own rank
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bits = w[j];
        const int cj = __popc(bits);
        if (idx + cj > i0 && idx < i1) {
          while (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1;
            if (idx >= i0 && idx < i1) list[n + off + idx - lo] = column_of(base + j, b);
            ++idx;
          }
        } else {
          idx += cj;
        }
      }
      n += hi - lo;
      lo = hi;
      if (n == kT1List) {
        done += t1_flush<L, DROP>(acc, list, n, done, x1, d, lane, row, seed, thr);
        n = 0;
      }
    }
  }
  t1_flush<L, DROP>(acc, list, n, done, x1, d, lane, row, seed, thr);
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {  // the groups' partials, in a fixed order
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], o);
  }
}

// L: lanes per X1 row, 16 bytes each (d <= 8 * L); d % 8 == 0. MASKED: drop
// edges by the keep word of (seed, row, word) with threshold thr (unused
// when false).
template <int L, bool MASKED>
__global__ void __launch_bounds__(kT1Threads)
t1_kernel(const uint32_t* __restrict__ wp, const __nv_bfloat16* __restrict__ x1,
          float* __restrict__ y1, int m, int kw, int d, bool vec, uint32_t seed,
          int thr) {
  __shared__ int lists[kT1Threads / 32][kT1List];
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;  // uniform per warp
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  t1_walk<L, MASKED ? Drop::kB : Drop::kNone>(acc, lists[threadIdx.x / 32],
                                             wp + (size_t)row * kw, kw, vec, x1,
                                             d, lane, row, seed, thr, 0, 1);
  const int c = lane % L;
  if (lane < L && 8 * c < d) {
    float4* out = reinterpret_cast<float4*>(y1 + (size_t)row * d + 8 * c);
    out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// K7m's rows route: Y (n_out, d) = (B o M)^T @ X as the t1 walk over the
// rows of the transposed pack wt (mt, kwt) = B^T, one writer per output
// row. Blocks take rows in the order `order` gives: its first n_heavy rows
// a block each (warp j walks steps j, j + 8, ... and warp 0 adds the 8
// partials in warp order), then the rest a warp each. Output rows [mt,
// n_out) hold no set bit and are written as zeros.
template <int L>
__global__ void __launch_bounds__(kT1Threads)
t2_kernel_rows(const uint32_t* __restrict__ wt, const int* __restrict__ order,
               const __nv_bfloat16* __restrict__ x, float* __restrict__ y,
               int mt, int n_out, int kwt, int d, int n_heavy, bool vec,
               uint32_t seed, int thr) {
  constexpr int kWarps = kT1Threads / 32;
  __shared__ int lists[kWarps][kT1List];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool heavy = (int)blockIdx.x < n_heavy;  // uniform per block
  const int slot = heavy ? blockIdx.x : n_heavy + (blockIdx.x - n_heavy) * kWarps + warp;
  if (slot >= n_out) return;  // uniform per warp, never in a heavy block
  const int row = slot < mt ? order[slot] : slot;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  if (row < mt)
    t1_walk<L, Drop::kBT>(acc, lists[warp], wt + (size_t)row * kwt, kwt, vec, x, d,
                          lane, row, seed, thr, heavy ? warp : 0, heavy ? kWarps : 1);
  const int c = lane % L;
  if (heavy) {  // the warps' partials through their (now free) lists
    float* part = reinterpret_cast<float*>(lists[warp]);
    if (lane < L) {
#pragma unroll
      for (int i = 0; i < 8; ++i) part[8 * c + i] = acc[i];
    }
    __syncthreads();
    if (warp != 0) return;
    if (lane < L) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = reinterpret_cast<const float*>(lists[0])[8 * c + i];
      for (int w = 1; w < kWarps; ++w) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] += reinterpret_cast<const float*>(lists[w])[8 * c + i];
      }
    }
  }
  if (lane < L && 8 * c < d) {
    float4* out = reinterpret_cast<float4*>(y + (size_t)row * d + 8 * c);
    out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

// The X2 values a lane owns in a t2 warp: FPL adjacent features from FPL *
// lane on, one vector load of 2 * FPL bytes (d % 8 == 0 keeps it aligned).
template <int FPL>
struct T2Row {
  using Vec = typename std::conditional<
      FPL == 1, unsigned short,
      typename std::conditional<FPL == 2, uint32_t,
                                typename std::conditional<FPL == 4, uint2, uint4>::type>::type>::type;
  Vec v;

  __device__ __forceinline__ void load(const __nv_bfloat16* xr, int d, int lane, bool ok) {
    const int f = FPL * lane;
    v = ok && f < d ? *reinterpret_cast<const Vec*>(xr + f) : Vec{};
  }
  // a[f] += x[f] over the lane's features of one plane's partial row
  __device__ __forceinline__ void add_to(float* a, int d, int lane) const {
    const int f = FPL * lane;
    if (f >= d) return;
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&v);
    if constexpr (FPL >= 4) {
#pragma unroll
      for (int i = 0; i < FPL; i += 4) {
        float4* p = reinterpret_cast<float4*>(a + f + i);
        float4 s = *p;
        s.x += __bfloat162float(x[i]);
        s.y += __bfloat162float(x[i + 1]);
        s.z += __bfloat162float(x[i + 2]);
        s.w += __bfloat162float(x[i + 3]);
        *p = s;
      }
    } else if constexpr (FPL == 2) {
      float2* p = reinterpret_cast<float2*>(a + f);
      float2 s = *p;
      s.x += __bfloat162float(x[0]);
      s.y += __bfloat162float(x[1]);
      *p = s;
    } else {
      a[f] += __bfloat162float(x[0]);
    }
  }
};

// Up to B live words of the stage, taken from (lo, hi) in row order: their
// bits, and their X2 rows, all B loads issued before any value is used.
// MASKED: lane k hashes slot k's word, once for the batch, and the slot's
// bits keep what the keep word keeps.
template <int B, int FPL, bool MASKED>
__device__ __forceinline__ void t2_gather(unsigned long long& lo,
                                          unsigned long long& hi,
                                          const uint32_t (&wd)[4],
                                          const __nv_bfloat16* __restrict__ x2,
                                          int r0, int d, int lane, int w,
                                          uint32_t seed, int thr,
                                          uint32_t (&bits)[B], T2Row<FPL> (&xv)[B]) {
  int p[B];
#pragma unroll
  for (int k = 0; k < B; ++k) {  // branch-free: p = -1 once both are empty
    const bool from_lo = lo != 0ull;
    const unsigned long long cur = from_lo ? lo : hi;
    p[k] = cur ? __ffsll((long long)cur) - 1 + (from_lo ? 0 : 64) : -1;
    lo = from_lo ? lo & (lo - 1) : lo;
    hi = from_lo ? hi : hi & (hi - 1);
    const uint32_t word = (p[k] & 64) ? ((p[k] & 32) ? wd[3] : wd[2])
                                      : ((p[k] & 32) ? wd[1] : wd[0]);
    const uint32_t b = __shfl_sync(kFull, word, p[k] & 31);
    bits[k] = p[k] >= 0 ? b : 0u;
  }
#pragma unroll
  for (int k = 0; k < B; ++k)
    xv[k].load(x2 + (size_t)(r0 + max(p[k], 0)) * d, d, lane, p[k] >= 0);
  if constexpr (MASKED) {
    int pm = -1;
#pragma unroll
    for (int k = 0; k < B; ++k) pm = lane == k ? p[k] : pm;
    const uint32_t keep =
        pm >= 0 ? igcn::keepword(seed, (uint32_t)(r0 + pm), (uint32_t)w, thr) : 0u;
#pragma unroll
    for (int k = 0; k < B; ++k) bits[k] &= __shfl_sync(kFull, keep, k);
  }
}

// Add gathered rows to the warp's partials, rows in order.
template <int B, int FPL>
__device__ __forceinline__ void t2_add(float* acc, int d, int lane,
                                       const uint32_t (&bits)[B],
                                       const T2Row<FPL> (&xv)[B]) {
#pragma unroll
  for (int k = 0; k < B; ++k) {
    uint32_t b32 = bits[k];
    while (b32) {
      const int b = __ffs(b32) - 1;
      b32 &= b32 - 1;
      xv[k].add_to(acc + b * d, d, lane);
    }
  }
}

// FPL: features per lane (T2Row), d <= 32 * FPL. WPB: word columns (and
// warps) per block, a multiple of 4. Rows [blockIdx.y * split_rows,
// + split_rows) of B go into this chunk's slab of `out`, (K, d) f32.
template <int FPL, int WPB, bool MASKED>
__global__ void __launch_bounds__(WPB * 32)
t2_kernel(const uint32_t* __restrict__ wp, const __nv_bfloat16* __restrict__ x2,
          float* __restrict__ out, int m, int kw, int d, int split_rows,
          bool vec, uint32_t seed, int thr) {
  constexpr int kQuads = WPB / 4;  // 16-byte loads per tile row
  static_assert(WPB * 32 == kT2Rows * kQuads, "one load a thread per stage");
  extern __shared__ float smem[];  // [WPB][32 planes][d] f32, then the tile
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem + (size_t)WPB * 32 * d);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* acc = smem + (size_t)warp * 32 * d;
  const int w0 = blockIdx.x * WPB;
  const int w = w0 + warp;  // this warp's word column
  const int r_begin = blockIdx.y * split_rows;
  const int r_end = min(m, r_begin + split_rows);
  const int stages = r_end > r_begin ? (r_end - r_begin + kT2Rows - 1) / kT2Rows : 0;
  // this thread's 16 bytes of a stage: row lrow, words w0 + lw .. + 3
  const int lrow = tid / kQuads, lw = 4 * (tid % kQuads);
  auto fetch = [&](int st) {
    const int r = r_begin + st * kT2Rows + lrow;
    return st < stages && r < r_end ? load_words(wp + (size_t)r * kw, w0 + lw, kw, vec)
                                    : make_uint4(0u, 0u, 0u, 0u);
  };

  for (int i = lane; i < 32 * d; i += 32) acc[i] = 0.f;
  // the last live words of a stage, gathered there and added in the next
  uint32_t pend_bits[kT2Batch] = {};
  T2Row<FPL> pend_x[kT2Batch];
  uint4 cur = fetch(0), next = fetch(1);
  for (int st = 0; st < stages; ++st) {
    uint32_t* tile = tiles + (st & 1) * WPB * kT2Ld;  // [word][row]
    tile[(lw + 0) * kT2Ld + lrow] = cur.x;
    tile[(lw + 1) * kT2Ld + lrow] = cur.y;
    tile[(lw + 2) * kT2Ld + lrow] = cur.z;
    tile[(lw + 3) * kT2Ld + lrow] = cur.w;
    cur = next;
    next = fetch(st + 2);
    // every warp is done with the stage that last used this buffer
    __syncthreads();
    const int r0 = r_begin + st * kT2Rows;
    uint32_t wd[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) wd[u] = tile[warp * kT2Ld + 32 * u + lane];
    // live words of the stage's 128 rows, as one 128-bit mask in row order
    unsigned long long lo = __ballot_sync(kFull, wd[0] != 0u) |
                            (unsigned long long)__ballot_sync(kFull, wd[1] != 0u) << 32;
    unsigned long long hi = __ballot_sync(kFull, wd[2] != 0u) |
                            (unsigned long long)__ballot_sync(kFull, wd[3] != 0u) << 32;
    // rows ascending: the last stage's rows, then all but the last
    // kT2Batch of this stage's, then those, gathered now and added next
    t2_add<kT2Batch, FPL>(acc, d, lane, pend_bits, pend_x);
    while (__popcll(lo) + __popcll(hi) > kT2Batch) {  // uniform across the warp
      uint32_t bits[kT2Batch];
      T2Row<FPL> xv[kT2Batch];
      t2_gather<kT2Batch, FPL, MASKED>(lo, hi, wd, x2, r0, d, lane, w, seed, thr, bits, xv);
      t2_add<kT2Batch, FPL>(acc, d, lane, bits, xv);
    }
    t2_gather<kT2Batch, FPL, MASKED>(lo, hi, wd, x2, r0, d, lane, w, seed, thr, pend_bits,
                                     pend_x);
  }
  t2_add<kT2Batch, FPL>(acc, d, lane, pend_bits, pend_x);
  __syncwarp();
  if (w >= kw) return;
  float* slab = out + (size_t)blockIdx.y * kw * 32 * d;
  for (int b = 0; b < 32; ++b) {
    float* dst = slab + (size_t)column_of(w, b) * d;
    for (int f = lane; f < d; f += 32) dst[f] = acc[b * d + f];
  }
}

// d must be in [8, 256] (the t2 partials take WPB * 128 * d bytes) and a
// multiple of 8, so that X rows are whole 16-byte vectors (the wrappers pad
// them); kw a multiple of 128, or the layout puts columns past K = 32 * kw.
bool bad_args(int m, int kw, int d, int thr) {
  return d < 8 || d > 256 || d % 8 || m < 0 || kw < 0 || kw % kTKP || thr < 0 ||
         thr > 255;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int t1_lanes(int d) {  // lanes per X1 row: 16 bytes each, a power of two
  int l = 1;
  while (8 * l < d) l *= 2;
  return l;
}

int t2_words(int d) { return d <= 64 ? 8 : 4; }

size_t t2_smem(int d) {
  const int wpb = t2_words(d);
  return (size_t)wpb * 32 * d * sizeof(float) + 2 * wpb * kT2Ld * sizeof(uint32_t);
}

int t2_splits(int m, int kw, int d) {
  const int wpb = t2_words(d);
  const int groups = (kw + wpb - 1) / wpb;
  const int stages = (m + kT2Rows - 1) / kT2Rows;
  if (groups == 0 || stages == 0) return 1;
  int s = (kT2TargetBlocks + groups - 1) / groups;
  if (s > stages) s = stages;
  const int per = (stages + s - 1) / s;  // stages per split; no empty split
  return (stages + per - 1) / per;
}

template <int L, bool MASKED>
cudaError_t launch_t1(const uint32_t* wp, const __nv_bfloat16* x1, float* y1,
                      int m, int kw, int d, uint32_t seed, int thr,
                      cudaStream_t stream) {
  const int rows_per_block = kT1Threads / 32;
  const int blocks = (m + rows_per_block - 1) / rows_per_block;
  const bool vec = aligned16(wp);
  t1_kernel<L, MASKED><<<blocks, kT1Threads, 0, stream>>>(wp, x1, y1, m, kw, d,
                                                          vec, seed, thr);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_t2_rows(const uint32_t* wt, const int* order,
                           const __nv_bfloat16* x, float* y, int mt, int n_out,
                           int kwt, int d, int n_heavy, uint32_t seed, int thr,
                           cudaStream_t stream) {
  const int rows_per_block = kT1Threads / 32;
  const int blocks = n_heavy + (n_out - n_heavy + rows_per_block - 1) / rows_per_block;
  t2_kernel_rows<L><<<blocks, kT1Threads, 0, stream>>>(
      wt, order, x, y, mt, n_out, kwt, d, n_heavy, aligned16(wt), seed, thr);
  return cudaGetLastError();
}

template <int FPL, int WPB, bool MASKED>
cudaError_t launch_t2(const uint32_t* wp, const __nv_bfloat16* x2, float* part,
                      float* y2, int m, int kw, int d, int splits,
                      uint32_t seed, int thr, cudaStream_t stream) {
  const size_t smem = t2_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      t2_kernel<FPL, WPB, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int stages = (m + kT2Rows - 1) / kT2Rows;
  const int split_rows = (stages + splits - 1) / splits * kT2Rows;
  const bool vec = aligned16(wp);
  dim3 grid((kw + WPB - 1) / WPB, splits);
  t2_kernel<FPL, WPB, MASKED><<<grid, WPB * 32, smem, stream>>>(
      wp, x2, splits == 1 ? y2 : part, m, kw, d, split_rows, vec, seed, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return igcn::sum_splits(part, y2, (long long)kw * 32 * d, splits, stream);
}

template <bool MASKED>
int run_t1(const void* wp, const void* x1, void* y1, int m, int kw, int d,
           uint32_t seed, int thr, void* stream) {
  auto w = static_cast<const uint32_t*>(wp);
  auto x = static_cast<const __nv_bfloat16*>(x1);
  auto y = static_cast<float*>(y1);
  auto s = static_cast<cudaStream_t>(stream);
  if (bad_args(m, kw, d, thr) || !aligned16(x1) || !aligned16(y1))
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaGetLastError();
  switch (t1_lanes(d)) {
    case 1: return (int)launch_t1<1, MASKED>(w, x, y, m, kw, d, seed, thr, s);
    case 2: return (int)launch_t1<2, MASKED>(w, x, y, m, kw, d, seed, thr, s);
    case 4: return (int)launch_t1<4, MASKED>(w, x, y, m, kw, d, seed, thr, s);
    case 8: return (int)launch_t1<8, MASKED>(w, x, y, m, kw, d, seed, thr, s);
    case 16: return (int)launch_t1<16, MASKED>(w, x, y, m, kw, d, seed, thr, s);
    default: return (int)launch_t1<32, MASKED>(w, x, y, m, kw, d, seed, thr, s);
  }
}

int run_t2_rows(const void* wt, const void* order, const void* x, void* y,
                int mt, int n_out, int kwt, int d, int n_heavy, uint32_t seed,
                int thr, void* stream) {
  auto w = static_cast<const uint32_t*>(wt);
  auto o = static_cast<const int*>(order);
  auto xb = static_cast<const __nv_bfloat16*>(x);
  auto yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (bad_args(mt, kwt, d, thr) || n_out < mt || n_heavy < 0 || n_heavy > mt ||
      !aligned16(x) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaGetLastError();
  switch (t1_lanes(d)) {
    case 1: return (int)launch_t2_rows<1>(w, o, xb, yf, mt, n_out, kwt, d, n_heavy, seed, thr, s);
    case 2: return (int)launch_t2_rows<2>(w, o, xb, yf, mt, n_out, kwt, d, n_heavy, seed, thr, s);
    case 4: return (int)launch_t2_rows<4>(w, o, xb, yf, mt, n_out, kwt, d, n_heavy, seed, thr, s);
    case 8: return (int)launch_t2_rows<8>(w, o, xb, yf, mt, n_out, kwt, d, n_heavy, seed, thr, s);
    case 16: return (int)launch_t2_rows<16>(w, o, xb, yf, mt, n_out, kwt, d, n_heavy, seed, thr, s);
    default: return (int)launch_t2_rows<32>(w, o, xb, yf, mt, n_out, kwt, d, n_heavy, seed, thr, s);
  }
}

template <bool MASKED>
int run_t2(const void* wp, const void* x2, void* part, void* y2, int m, int kw,
           int d, int splits, uint32_t seed, int thr, void* stream) {
  auto w = static_cast<const uint32_t*>(wp);
  auto x = static_cast<const __nv_bfloat16*>(x2);
  auto p = static_cast<float*>(part);
  auto y = static_cast<float*>(y2);
  auto s = static_cast<cudaStream_t>(stream);
  if (bad_args(m, kw, d, thr) || splits < 1 || (splits > 1 && part == nullptr) ||
      !aligned16(x2))
    return (int)cudaErrorInvalidValue;
  if (kw == 0) return (int)cudaGetLastError();
  if (d <= 32) return (int)launch_t2<1, 8, MASKED>(w, x, p, y, m, kw, d, splits, seed, thr, s);
  if (d <= 64) return (int)launch_t2<2, 8, MASKED>(w, x, p, y, m, kw, d, splits, seed, thr, s);
  if (d <= 128) return (int)launch_t2<4, 4, MASKED>(w, x, p, y, m, kw, d, splits, seed, thr, s);
  return (int)launch_t2<8, 4, MASKED>(w, x, p, y, m, kw, d, splits, seed, thr, s);
}

}  // namespace

extern "C" {

// Row splits of the t2 body at this shape: the number of partial (K, d) f32
// slabs its wrapper allocates (none when 1).
int igcn_t2_splits(int m, int kw, int d) { return t2_splits(m, kw, d); }

// The launch shape of a body at (m, kw, d), d padded to a multiple of 8 as
// the wrappers do: t2 false (t1) or true (t2 at its default splits).
// Writes grid x, grid y, threads per block, shared-memory bytes a block.
void igcn_pair_launch_shape(int t2, int m, int kw, int d, int* shape) {
  d = (d + 7) / 8 * 8;
  if (t2) {
    const int wpb = t2_words(d);
    shape[0] = (kw + wpb - 1) / wpb;
    shape[1] = t2_splits(m, kw, d);
    shape[2] = wpb * 32;
    shape[3] = (int)t2_smem(d);
  } else {
    shape[0] = (m + kT1Threads / 32 - 1) / (kT1Threads / 32);
    shape[1] = 1;
    shape[2] = kT1Threads;
    shape[3] = (int)(kT1Threads / 32 * kT1List * sizeof(int));
  }
}

// Every entry takes d a multiple of 8 in [8, 256].
// t1 entries: x1 (K, d) bf16 rows, y1 (m, d) f32.
int igcn_t1(const void* wp, const void* x1, void* y1, int m, int kw, int d,
            void* stream) {
  return run_t1<false>(wp, x1, y1, m, kw, d, 0u, 0, stream);
}

// t2 entries: x2 (m, d) bf16 rows, part (splits, K, d) f32 scratch (unused,
// and may be y2, when splits is 1), y2 (K, d) f32.
int igcn_t2(const void* wp, const void* x2, void* part, void* y2, int m, int kw,
            int d, int splits, void* stream) {
  return run_t2<false>(wp, x2, part, y2, m, kw, d, splits, 0u, 0, stream);
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

int igcn_t2_masked(const void* wp, const void* x2, void* part, void* y2, int m,
                   int kw, int d, int splits, unsigned int seed, int thr,
                   void* stream) {
  return run_t2<true>(wp, x2, part, y2, m, kw, d, splits, (uint32_t)seed, thr,
                      stream);
}

// K6 and K7: the bb_matmul pair of the JAX package,
// igcn_cf_tpu/kernels/bitpack.py::_fwd_pallas (K6, Y = B @ X) and
// ::_bwd_pallas (K7, Y = B^T @ X). They compute the products of K1 and K2
// on X in its original row-major (n, d) layout, which is what the kernel
// bodies above read, so the Python wrappers pass X with no transposed copy.
// The propagation-cache build runs the unmasked pair at d = 128.
int igcn_bb_fwd(const void* wp, const void* x, void* y, int m, int kw, int d,
                void* stream) {
  return run_t1<false>(wp, x, y, m, kw, d, 0u, 0, stream);
}

int igcn_bb_bwd(const void* wp, const void* x, void* part, void* y, int m,
                int kw, int d, int splits, void* stream) {
  return run_t2<false>(wp, x, part, y, m, kw, d, splits, 0u, 0, stream);
}

// K6m and K7m: the same pair with the in-kernel edge-dropout mask,
// _fwd_pallas/_bwd_pallas with masked=True (bb_matmul_dropped), which NGCF
// runs in every layer of a training step at d = 64. seed is the u32 mask
// seed, thr = round(p * 256) in [0, 255]; no 1/(1-p) rescale. K7m keeps
// K7's splits and summation order: deterministic.
int igcn_bb_fwd_masked(const void* wp, const void* x, void* y, int m, int kw,
                       int d, unsigned int seed, int thr, void* stream) {
  return run_t1<true>(wp, x, y, m, kw, d, (uint32_t)seed, thr, stream);
}

int igcn_bb_bwd_masked(const void* wp, const void* x, void* part, void* y,
                       int m, int kw, int d, int splits, unsigned int seed,
                       int thr, void* stream) {
  return run_t2<true>(wp, x, part, y, m, kw, d, splits, (uint32_t)seed, thr,
                      stream);
}

// K7m's rows route (bitpack.mm_bwd_masked_rows): the product of
// igcn_bb_bwd_masked over the transposed pack wt (mt, kwt) of B, x (rows,
// d) bf16 with every column of wt that holds a bit below rows, order (mt,)
// int32 a permutation of wt's rows, y (n_out, d) f32 with n_out >= mt.
// One writer per output row, in a fixed order: deterministic, no scratch.
int igcn_bb_bwd_masked_rows(const void* wt, const void* order, const void* x,
                            void* y, int mt, int n_out, int kwt, int d,
                            int n_heavy, unsigned int seed, int thr,
                            void* stream) {
  return run_t2_rows(wt, order, x, y, mt, n_out, kwt, d, n_heavy, (uint32_t)seed,
                     thr, stream);
}

}  // extern "C"
