// K5: fused retrieval -- score + banned row + exclusion bits + exact top-k,
// without writing the (users x items) score matrix to device memory.
//
// Replaces the TPU kernel igcn_cf_tpu/kernels/retrieval.py::fused_topk_ids
// (_fused_kernel). Same result: for each user, the ids of the top k items by
// (score descending, item id ascending), where
//
//   score = U[u] . I[:, c]  (f32 FMAs) + banned[c],
//   score = NEG if bit c of the user's exclusion words is set.
//
// Exclusion words use pack_exclusion_words' per-chunk bit-plane layout with
// chunk width li: item c -> word (c / li) * (li / 32) + (c % li) % (li / 32),
// bit (c % li) / (li / 32).
//
// What bounds it on the H100. At the slice (4,096 users x 45,056 items,
// d=64) the scores are 2*n*N*d = 2.4e10 f32 FLOP on the CUDA cores (no f32
// tensor-core path without TF32, which would change the scores): a ~0.35 ms
// floor at the data sheet's 67 TFLOP/s f32 peak. The item table (11.5 MB)
// fits the 50 MB L2; each block of 16 users re-reads its 1,024-item slice
// from L2. The k selection rounds are shared-memory scans, expected to cost
// about as much as the scores at k=20. Measured times are in PERF.md.
//
// Design. Blocks cannot carry a running top-k across a grid in order, as
// the TPU grid did, so retrieval is two passes:
//   1. chunk pass, grid (item chunk of 1,024, group of 16 users): the block
//      computes its 16 x 1,024 scores into SHARED memory, masks them, and
//      one warp per user runs k rounds of (max value, min id) warp
//      reductions, writing each chunk's sorted top-k (values and ids) to a
//      scratch list. Only n * chunks * k candidates reach device memory
//      (1,760 per user at the slice, 4% of the score row).
//   2. merge pass, one warp per user: a k-way merge of the sorted chunk
//      lists by (value descending, id ascending), which is a total order, so
//      the merged top k equals the top k of the whole row.
// Winners are evicted by writing NaN, which no comparison selects, so a
// chunk never yields an item twice.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUsers = 16;                  // users per chunk block
constexpr int kChunk = 1024;                // items per chunk block
constexpr int kThreads = 256;
constexpr int kItemsPerThread = kChunk / kThreads;
constexpr int kMergeWarps = 4;              // users per merge block
constexpr int kNoId = 0x7fffffff;

// (va, ia) ranks before (vb, ib): larger value, then smaller id. NaN never
// ranks before anything.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__global__ void __launch_bounds__(kThreads)
chunk_topk_kernel(const float* __restrict__ users, const float* __restrict__ items_t,
                  const uint32_t* __restrict__ excl, const float* __restrict__ banned,
                  float* __restrict__ part_v, int* __restrict__ part_i,
                  int n_users, int n_items_pad, int d, int k, int li) {
  extern __shared__ float smem[];
  float* su = smem;                  // [kUsers][d]
  float* ss = smem + kUsers * d;     // [kUsers][kChunk] scores
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int u0 = blockIdx.y * kUsers;
  const int c0 = chunk * kChunk;
  const int lw = li / 32;
  const int n_words = n_items_pad / 32;

  for (int i = threadIdx.x; i < kUsers * d; i += kThreads) {
    const int u = u0 + i / d;
    su[i] = u < n_users ? users[(size_t)u * d + i % d] : 0.f;
  }
  __syncthreads();

  float acc[kUsers][kItemsPerThread];
#pragma unroll
  for (int u = 0; u < kUsers; ++u)
#pragma unroll
    for (int t = 0; t < kItemsPerThread; ++t) acc[u][t] = 0.f;
  for (int f = 0; f < d; ++f) {
    float iv[kItemsPerThread];
#pragma unroll
    for (int t = 0; t < kItemsPerThread; ++t) {
      const int c = c0 + threadIdx.x + kThreads * t;
      iv[t] = c < n_items_pad ? __ldg(items_t + (size_t)f * n_items_pad + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUsers; ++u) {
      const float uv = su[u * d + f];
#pragma unroll
      for (int t = 0; t < kItemsPerThread; ++t) acc[u][t] = fmaf(uv, iv[t], acc[u][t]);
    }
  }

#pragma unroll
  for (int t = 0; t < kItemsPerThread; ++t) {
    const int p = threadIdx.x + kThreads * t;
    const int c = c0 + p;
    int word = 0, bit = 0;
    float ban = 0.f;
    if (c < n_items_pad) {
      const int r = c % li;
      word = (c / li) * lw + r % lw;
      bit = r / lw;
      ban = __ldg(banned + c);
    }
#pragma unroll
    for (int u = 0; u < kUsers; ++u) {
      float s = nanf("");  // past the catalog: never selected
      if (c < n_items_pad && u0 + u < n_users) {
        const uint32_t w = __ldg(excl + (size_t)(u0 + u) * n_words + word);
        s = ((w >> bit) & 1u) ? -3.0e38f : acc[u][t] + ban;
      }
      ss[u * kChunk + p] = s;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int u = warp; u < kUsers; u += kThreads / 32) {
    if (u0 + u >= n_users) break;
    float* row = ss + u * kChunk;
    const size_t out = ((size_t)(u0 + u) * n_chunks + chunk) * k;
    for (int t = 0; t < k; ++t) {
      float bv = -INFINITY;
      int bp = kNoId;
      for (int p = lane; p < kChunk; p += 32) {
        const float v = row[p];
        if (better(v, p, bv, bp)) { bv = v; bp = p; }
      }
      warp_best(bv, bp);
      if (lane == 0) {
        part_v[out + t] = bv;
        part_i[out + t] = bp == kNoId ? kNoId : c0 + bp;
      }
      if (bp != kNoId && lane == bp % 32) row[bp] = nanf("");
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
merge_topk_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int* __restrict__ out, int n_users, int n_chunks, int k) {
  extern __shared__ int heads[];  // [kMergeWarps][n_chunks]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = blockIdx.x * kMergeWarps + warp;
  if (u >= n_users) return;  // uniform per warp; no block-wide barrier
  int* head = heads + warp * n_chunks;
  for (int j = lane; j < n_chunks; j += 32) head[j] = 0;
  __syncwarp();
  const float* pv = part_v + (size_t)u * n_chunks * k;
  const int* pi = part_i + (size_t)u * n_chunks * k;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = kNoId, bj = -1;
    for (int j = lane; j < n_chunks; j += 32) {
      const int h = head[j];
      if (h < k) {
        const float v = pv[(size_t)j * k + h];
        const int i = pi[(size_t)j * k + h];
        if (bj < 0 || better(v, i, bv, bi)) { bv = v; bi = i; bj = j; }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      if (oj >= 0 && (bj < 0 || better(ov, oi, bv, bi))) { bv = ov; bi = oi; bj = oj; }
    }
    if (lane == 0) out[(size_t)u * k + t] = bi;
    if (bj >= 0 && lane == bj % 32) head[bj] += 1;
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Item chunks of the first pass: the middle extent of the scratch lists.
int igcn_fused_topk_chunks(int n_items_pad) {
  return (n_items_pad + kChunk - 1) / kChunk;
}

// users (n_users, d) f32, items_t (d, n_items_pad) f32, excl (n_users,
// n_items_pad / 32) u32, banned (n_items_pad) f32; scratch part_v/part_i
// (n_users, igcn_fused_topk_chunks(n_items_pad), k); out (n_users, k) i32.
// Requires 1 <= k <= min(128, n_items_pad), n_items_pad % li == 0, li % 32 == 0.
int igcn_fused_topk(const void* users, const void* items_t, const void* excl,
                    const void* banned, void* part_v, void* part_i, void* out,
                    int n_users, int n_items_pad, int d, int k, int li,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n_users < 0 || d < 1 || k < 1 || k > 128 || k > n_items_pad || li < 32 ||
      li % 32 || n_items_pad % li || n_users > 65535 * kUsers)
    return (int)cudaErrorInvalidValue;
  if (n_users == 0) return (int)cudaGetLastError();
  const int n_chunks = igcn_fused_topk_chunks(n_items_pad);

  const size_t smem1 = (size_t)kUsers * (d + kChunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1(n_chunks, (n_users + kUsers - 1) / kUsers);
  chunk_topk_kernel<<<grid1, kThreads, smem1, s>>>(
      static_cast<const float*>(users), static_cast<const float*>(items_t),
      static_cast<const uint32_t*>(excl), static_cast<const float*>(banned),
      static_cast<float*>(part_v), static_cast<int*>(part_i),
      n_users, n_items_pad, d, k, li);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem2 = (size_t)kMergeWarps * n_chunks * sizeof(int);
  err = cudaFuncSetAttribute(
      merge_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  merge_topk_kernel<<<(n_users + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32,
                      smem2, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<int*>(out), n_users, n_chunks, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
