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
// its own column, so a block holds a stripe of W columns of all N rows in
// shared memory and gathers from it. The launch plan (the wrapper's
// launch_plan, checked here) gives W, the stripe's column pitch, the row
// ranges that share each stripe's outputs, and the grid:
// - One wave. Stripes x row ranges (the work items) are at most the SMs,
//   one block an SM; where the stripes alone outnumber the SMs, a block
//   walks items (blockIdx.x, + gridDim.x, ...), copying each item's stripe.
//   Each block copies its stripe once, with 16-byte loads of whole row
//   segments where W * size >= 16 bytes (W is a template parameter: no
//   division at run time), four loads a thread in flight.
// - Column runs. Each column is contiguous in shared memory, and where it
//   fits (reps < N) the first reps - 1 rows are repeated after row N - 1,
//   so one output's reps reads are one run of consecutive elements: read
//   as aligned 16-byte chunks (4 f32 or 8 bf16), with no wrap test, the
//   lanes before the run's start in its first chunk and past its end in
//   its last added as +0, which leaves a sum that starts at +0 unchanged.
//   The pitch is odd in 16-byte units where W > 1, so the columns start on
//   different banks. Where the repeat does not fit (reps >= N, or a stripe
//   at the 232,448-byte limit), the same kernel steps through the wrap one
//   element at a time.
// - Runs dealt out by bank group (sorted, where its buffers fit beside the
//   stripe). A 16-byte load is served a quarter-warp at a time, and 8
//   lanes whose runs start in the same bank group serialise. Each item's
//   ids are read while the stripe is copied; each run goes to one of 8
//   buckets by the bank group of its first chunk, and the buckets are
//   dealt out in turn, so the 8 lanes of a quarter-warp start in 8
//   different groups and, all stepping one chunk at a time, stay apart to
//   the end; the runs past the smallest bucket's count (~4% at N = 8,192)
//   follow unsorted. Results are staged in shared memory and stored by
//   rows. Elsewhere a thread owns up to 4 columns of one row: one 16-byte
//   load of their ids, 4 independent sums, one store.
//
// What bounds it. In device memory x, idx and out each cross once: at N =
// 8,192 in f32, 12.6 MB, 3.8 us at 3.35 TB/s. The adds, reps * N * 128 =
// 52.4M at the fp32 peak, 0.8 us. On chip, reps * N * 128 element reads
// from shared memory, at most 32 a clock on each SM (128 bytes): at N =
// 8,192 and reps = 50, 6.3 us on 132 SMs at 1.98 GHz, the floor the smoke
// states. Rows are random, so lanes collide in banks: a 16-byte load is
// served a quarter-warp at a time, and 8 random 16-byte slots among 8
// bank groups put 2.59 on the busiest one on average (4-byte loads: 3.53 of
// 32 lanes on the busiest bank): unsorted, the runs take ~2.6x the on-chip
// floor, ~2.8x with the chunks their alignment adds (14 chunks of 4 for 50
// reads); sorted, ~1.1x expected. The stripe copy adds N + reps - 1
// scattered row segments a block. Measured at N = 8,192 f32 (H100 80GB
// HBM3, 700 W): ~29.4 us a call queued, nearest the on-chip floor (4.7x
// it, 7.8x the device-memory one); ~20.7 us of it outside the runs
// (launch, stripe copy, ids, sort: reps 0) and ~8.7 us of sorted runs, 1.4x
// the floor (~17.5 us unsorted, 2.8x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWidth = 128;       // columns of x
constexpr int kThreads = 1024;    // one block an SM
constexpr int kMaxSmem = 232448;  // bytes a block may use on Hopper
constexpr int kSortPer = 8;       // outputs a thread sorts
constexpr int kSortMax = kSortPer * kThreads;  // outputs an item may sort

// x's element type: 16-byte chunks of kVec elements, each widened to f32,
// and one step of the sum in x's type.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ static float add(float acc, float v) { return __fadd_rn(acc, v); }
  __device__ static float widen(float v) { return v; }
  __device__ static float narrow(float v) { return v; }
  __device__ static void unpack(const uint4& u, float (&v)[kVec]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // the f32 sum of two bf16 values, rounded to bf16 to nearest even
  __device__ static float add(float acc, float v) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, v)));
  }
  __device__ static float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);  // exact: v is a bf16 value
  }
  __device__ static void unpack(const uint4& u, float (&v)[kVec]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// An unsigned type of BYTES bytes (2, 4, 8 or 16), for one load or store.
template <int BYTES>
struct Bits;
template <>
struct Bits<2> { using type = unsigned short; };
template <>
struct Bits<4> { using type = unsigned int; };
template <>
struct Bits<8> { using type = uint2; };
template <>
struct Bits<16> { using type = uint4; };

// The stripe's rows [0, len) into W contiguous columns of pitch elements:
// s[c * pitch + r] = x[(r mod n) * 128 + c0 + c], len <= 2n. A row segment
// of W elements is read in loads of up to 16 bytes; a thread keeps 4 loads
// in flight, and the lanes of a warp store consecutive rows of a column.
template <typename T, int W>
__device__ __forceinline__ void copy_stripe(T* __restrict__ s,
                                            const T* __restrict__ x, int n,
                                            int len, int pitch, int c0) {
  constexpr int kBytes = W * (int)sizeof(T);
  constexpr int kSeg = kBytes < 16 ? kBytes : 16;  // bytes a load
  constexpr int kParts = kBytes / kSeg;            // loads a row segment
  constexpr int kPer = kSeg / (int)sizeof(T);      // elements a load
  constexpr int kPG = kParts < 2 ? kParts : 2;     // loads a row in flight
  constexpr int kRows = 4 / kPG;                   // rows a thread in flight
  using Seg = typename Bits<kSeg>::type;
  for (int r0 = threadIdx.x; r0 < len; r0 += kRows * kThreads) {
#pragma unroll 1
    for (int p0 = 0; p0 < kParts; p0 += kPG) {
      Seg v[kRows][kPG];
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const int r = r0 + b * kThreads;
        const int src = r < n ? r : r - n;
#pragma unroll
        for (int q = 0; q < kPG; ++q) {
          if (r < len) {
            v[b][q] = *reinterpret_cast<const Seg*>(
                x + (size_t)src * kWidth + c0 + (p0 + q) * kPer);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const int r = r0 + b * kThreads;
        if (r >= len) continue;
#pragma unroll
        for (int q = 0; q < kPG; ++q) {
          T e[kPer];
          memcpy(e, &v[b][q], kSeg);
#pragma unroll
          for (int j = 0; j < kPer; ++j) {
            s[((p0 + q) * kPer + j) * pitch + r] = e[j];
          }
        }
      }
    }
  }
}

// sum_{i < reps} col[a + i] in x's type, for a run inside the padded
// column: aligned 16-byte chunks, the lanes outside [a, a + reps) taken as
// +0. Every run steps the same chunks whatever its start (the most any
// start needs, run_chunks), so the lanes of a warp never diverge: chunk 0
// drops the lanes before a, chunks [1, reps / V) are whole for every
// start, and the rest drop the lanes past a + reps.
template <typename T>
__device__ __forceinline__ constexpr int run_chunks(int reps) {
  return (reps + 2 * Elem<T>::kVec - 2) / Elem<T>::kVec;
}

template <typename T>
__device__ __forceinline__ float run_sum(const T* col, int a, int reps) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  float acc = 0.0f;
  if (reps <= 0) return acc;
  const int lo = a & (V - 1);
  const uint4* p = reinterpret_cast<const uint4*>(col + (a - lo));
  float v[V];
  E::unpack(p[0], v);
#pragma unroll
  for (int j = 0; j < V; ++j) acc = E::add(acc, j >= lo && j - lo < reps ? v[j] : 0.0f);
  const int whole = reps / V, chunks = run_chunks<T>(reps);
  int k = 1;
  for (; k < whole; ++k) {
    E::unpack(p[k], v);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = E::add(acc, v[j]);
  }
  for (; k < chunks; ++k) {
    E::unpack(p[k], v);
    const int left = reps + lo - k * V;  // lanes of this chunk in the run
#pragma unroll
    for (int j = 0; j < V; ++j) acc = E::add(acc, j < left ? v[j] : 0.0f);
  }
  return acc;
}

// The same sum over the unpadded column of n elements, stepping through
// the wrap one element at a time.
template <typename T>
__device__ __forceinline__ float wrap_sum(const T* col, int a, int reps,
                                          int n) {
  using E = Elem<T>;
  float acc = 0.0f;
  for (int i = 0; i < reps; ++i) {
    acc = E::add(acc, E::widen(col[a]));
    if (++a == n) a = 0;
  }
  return acc;
}

// (id mod n) in [0, n), with the division only for ids outside it.
__device__ __forceinline__ int wrap_id(int a, int n) {
  if ((unsigned)a >= (unsigned)n) {
    a %= n;
    if (a < 0) a += n;
  }
  return a;
}

// The sorted path's shared memory after the stripe, for m outputs an item:
// the entries (m u32, each output o << 16 | its run's start), the results
// (m of x's type), then the counters: 8 a warp and 8 totals.
constexpr int kCounterBytes = 4 * (8 * (kThreads / 32) + 8);
__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr size_t sort_bytes(size_t m, size_t esize) {
  return round16(4 * m) + round16(esize * m) + kCounterBytes;
}

// Work item i of the plan is (stripe i / ranges, row range i % ranges):
// columns [W * stripe, W * stripe + W) of the rows [range * rpr, range *
// rpr + rpr) of the output. sorted (padded runs only): each item's runs
// are put in 8 buckets by the bank group of their first 16-byte chunk and
// dealt out so that the 8 lanes of a quarter-warp start in 8 different
// bank groups, and so stay apart chunk after chunk; the runs left over
// past the smallest bucket's count follow in any order.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads, 1)
gather_chain_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    T* __restrict__ out, int n, int reps, int pitch, int rpr,
                    int ranges, int padded, int sorted) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  constexpr int kG = W < 4 ? W : 4;       // columns a thread's task
  constexpr int kTasksPerRow = W / kG;
  using Ids = typename Bits<kG * 4>::type;
  using Outs = typename Bits<kG * (int)sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int items = (kWidth / W) * ranges;
  const int len = padded ? n + max(reps - 1, 0) : n;
  // the sorted path's entries, results, and counters: each warp's first
  // rank in each group ([32][8]) and each group's total ([8])
  unsigned char* sort_smem = smem + (size_t)W * pitch * sizeof(T);
  uint32_t* list = reinterpret_cast<uint32_t*>(sort_smem);
  T* res = reinterpret_cast<T*>(sort_smem + round16(4 * (size_t)rpr * W));
  int* warp_base = reinterpret_cast<int*>(
      sort_smem + sort_bytes(rpr * W, sizeof(T)) - kCounterBytes);
  int* total = warp_base + 8 * (kThreads / 32);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c0 = (item / ranges) * W;
    const int r0 = (item % ranges) * rpr;
    const int r1 = min(n, r0 + rpr);
    const int m = (r1 - r0) * W;  // outputs of the item
    if (item != (int)blockIdx.x) __syncthreads();  // the last item's reads
    if (!sorted) {
      copy_stripe<T, W>(s, x, n, len, pitch, c0);
      __syncthreads();
      const int tasks = (r1 - r0) * kTasksPerRow;
      for (int t = tid; t < tasks; t += kThreads) {
        const int cg = (t % kTasksPerRow) * kG;
        const size_t o = (size_t)(r0 + t / kTasksPerRow) * kWidth + c0 + cg;
        const Ids ids_raw = *reinterpret_cast<const Ids*>(idx + o);
        int id[kG];
        memcpy(id, &ids_raw, sizeof(Ids));
        T r[kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int a = wrap_id(id[g], n);
          const T* col = s + (cg + g) * pitch;
          r[g] = E::narrow(padded ? run_sum<T>(col, a, reps)
                                  : wrap_sum<T>(col, a, reps, n));
        }
        Outs o_raw;
        memcpy(&o_raw, r, sizeof(Outs));
        *reinterpret_cast<Outs*>(out + o) = o_raw;
      }
      continue;
    }
    // the item's ids, in flight while the stripe is copied: element i of
    // a thread is output o = (tid + (i / kG) * kThreads) * kG + i % kG,
    // read kG at a time
    uint32_t e[kSortPer];
#pragma unroll
    for (int k = 0; k < kSortPer / kG; ++k) {
      const int o = (tid + k * kThreads) * kG;
      Ids ids_raw{};
      if (o < m) {
        ids_raw = *reinterpret_cast<const Ids*>(
            idx + (size_t)(r0 + o / W) * kWidth + c0 + o % W);
      }
      memcpy(e + k * kG, &ids_raw, sizeof(Ids));
    }
    copy_stripe<T, W>(s, x, n, len, pitch, c0);
    // the bank group of a run's first chunk (8 past the item's end)
    auto group = [&](uint32_t ent) {
      const int o = ent >> 16, a = ent & 0xffff;
      return o < m ? ((o % W) * (pitch / V) + a / V) % 8 : 8;
    };
    // the lanes of the warp whose run is in group g, from ballots of the
    // groups' three bits and of the lanes that hold a run
    auto lanes_in = [](int g, unsigned b0, unsigned b1, unsigned b2,
                       unsigned live) {
      return live & (g & 1 ? b0 : ~b0) & (g & 2 ? b1 : ~b1) &
             (g & 4 ? b2 : ~b2);
    };
    // each warp counts its runs of each group: lane b < 8, group b
    int count = 0;
#pragma unroll
    for (int i = 0; i < kSortPer; ++i) {
      const int o = (tid + (i / kG) * kThreads) * kG + i % kG;
      e[i] = (uint32_t)o << 16 | (uint32_t)wrap_id((int)e[i], n);
      const int q = group(e[i]);
      count += __popc(lanes_in(lane & 7, __ballot_sync(0xffffffffu, q & 1),
                               __ballot_sync(0xffffffffu, q & 2),
                               __ballot_sync(0xffffffffu, q & 4),
                               __ballot_sync(0xffffffffu, q < 8)));
    }
    if (lane < 8) warp_base[warp * 8 + lane] = count;
    __syncthreads();  // the stripe and the counts
    // warp b < 8 scans group b over the warps: each warp's first rank in
    // the group, and the group's total
    if (warp < 8) {
      const int v = warp_base[lane * 8 + warp];
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      warp_base[lane * 8 + warp] = incl - v;
      if (lane == 31) total[warp] = incl;
    }
    __syncthreads();
    int depth = total[0];
#pragma unroll
    for (int b = 1; b < 8; ++b) depth = min(depth, total[b]);
    // deal: the j-th run of group q goes to 8 j + q while j < depth; the
    // leftovers follow in the order (j - depth, q), so they too mix groups
    int seen = 0;  // lane b < 8: this warp's runs of group b so far
#pragma unroll
    for (int i = 0; i < kSortPer; ++i) {
      const int q = group(e[i]);
      const unsigned b0 = __ballot_sync(0xffffffffu, q & 1),
                     b1 = __ballot_sync(0xffffffffu, q & 2),
                     b2 = __ballot_sync(0xffffffffu, q & 4),
                     live = __ballot_sync(0xffffffffu, q < 8);
      const int before = __shfl_sync(0xffffffffu, seen, q & 7);
      seen += __popc(lanes_in(lane & 7, b0, b1, b2, live));
      if (q < 8) {
        const int j = warp_base[warp * 8 + q] + before +
                      __popc(lanes_in(q, b0, b1, b2, live) &
                             ((1u << lane) - 1));
        int pos = 8 * j + q;
        if (j >= depth) {
          const int t = j - depth;
          pos = 8 * depth;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const int extra = total[b] - depth;
            pos += min(extra, t) + (b < q && extra > t);
          }
        }
        list[pos] = e[i];
      }
    }
    __syncthreads();
    for (int p = tid; p < m; p += kThreads) {
      const uint32_t ent = list[p];
      const int o = ent >> 16;
      res[o] = E::narrow(run_sum<T>(s + (o % W) * pitch, ent & 0xffff, reps));
    }
    __syncthreads();
    const int tasks = (r1 - r0) * kTasksPerRow;
    for (int t = tid; t < tasks; t += kThreads) {
      const int cg = (t % kTasksPerRow) * kG;
      const int row = t / kTasksPerRow;
      *reinterpret_cast<Outs*>(out + (size_t)(r0 + row) * kWidth + c0 + cg) =
          *reinterpret_cast<const Outs*>(res + row * W + cg);
    }
  }
}

template <typename T, int W>
int launch(const void* x, const void* idx, void* out, int n, int reps,
           int pitch, int rpr, int ranges, int grid, int padded, int sorted,
           cudaStream_t stream) {
  const size_t smem = (size_t)W * pitch * sizeof(T) +
                      (sorted ? sort_bytes((size_t)rpr * W, sizeof(T)) : 0);
  auto kernel = gather_chain_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<T*>(out), n, reps, pitch, rpr, ranges, padded, sorted);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_w(const void* x, const void* idx, void* out, int n, int reps,
             int w, int pitch, int rpr, int ranges, int grid, int padded,
             int sorted, cudaStream_t s) {
#define IGCN_T5_CASE(W)                                                   \
  case W:                                                                 \
    return launch<T, W>(x, idx, out, n, reps, pitch, rpr, ranges, grid,   \
                        padded, sorted, s);
  switch (w) {
    IGCN_T5_CASE(1) IGCN_T5_CASE(2) IGCN_T5_CASE(4) IGCN_T5_CASE(8)
    IGCN_T5_CASE(16) IGCN_T5_CASE(32) IGCN_T5_CASE(64) IGCN_T5_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef IGCN_T5_CASE
}

// A plan the kernel can run: every run inside its column, every column
// (and the sorted path's buffers) inside the block's shared memory, row
// ranges that tile [0, n) exactly.
bool bad_plan(int n, int reps, int w, int pitch, int rpr, int ranges,
              int grid, int padded, int sorted, int bf16) {
  const long long esize = bf16 ? 2 : 4, vec = 16 / esize;
  if (n < 1 || reps < 0 || w < 1 || w > kWidth || (w & (w - 1)) ||
      (bf16 != 0 && bf16 != 1) || (padded != 0 && padded != 1) ||
      (sorted != 0 && sorted != 1) || rpr < 1 || ranges < 1 || grid < 1 ||
      grid > (kWidth / w) * ranges || (long long)rpr * (ranges - 1) >= n ||
      (long long)rpr * ranges < n || pitch < n)
    return true;
  long long smem = (long long)w * pitch * esize;
  if (sorted) {
    if (!padded || n > 65536 || (long long)rpr * w > kSortMax) return true;
    smem += (long long)sort_bytes((size_t)rpr * w, esize);
  }
  if (smem > kMaxSmem) return true;
  if (!padded) return false;
  // the chunks of a run from the last aligned start, as run_sum reads them
  const long long chunks = (reps + 2 * vec - 2) / vec;
  return reps >= n || pitch % vec ||
         pitch < ((n - 1) / vec + (reps > 0 ? chunks : 1)) * vec;
}

}  // namespace

extern "C" {

// x (n, 128) f32 (bf16 == 0) or bf16 (bf16 == 1); idx (n, 128) int32; out
// like x; all three 16-byte aligned. The plan: stripe width w (a power of
// two), column pitch in elements, rows_per_range x row_ranges tiling [0,
// n), grid blocks, padded (1: the first reps - 1 rows repeated after the
// last, reps < n), sorted (1: the padded runs dealt out by bank group).
int igcn_gather_chain(const void* x, const void* idx, void* out, int n,
                      int reps, int w, int pitch, int rows_per_range,
                      int row_ranges, int grid, int padded, int sorted,
                      int bf16, void* stream) {
  if (bad_plan(n, reps, w, pitch, rows_per_range, row_ranges, grid, padded,
               sorted, bf16) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(idx) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_w<__nv_bfloat16>(x, idx, out, n, reps, w, pitch,
                                        rows_per_range, row_ranges, grid,
                                        padded, sorted, s)
              : launch_w<float>(x, idx, out, n, reps, w, pitch,
                                rows_per_range, row_ranges, grid, padded,
                                sorted, s);
}

}  // extern "C"
