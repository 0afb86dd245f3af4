// K5: fused retrieval -- score + banned row + exclusion bits + exact top-k,
// without writing the (users x items) score matrix to device memory.
//
// Replaces the TPU kernel igcn_cf_tpu/kernels/retrieval.py::fused_topk_ids
// (_fused_kernel). Same result: for each user, the ids of the top k items by
// (score descending, item id ascending), where
//
//   score = U[u] . I[:, c]  (f32 FMAs, in feature order) + banned[c],
//   score = NEG if bit c of the user's exclusion words is set.
//
// Exclusion words use pack_exclusion_words' per-chunk bit-plane layout with
// chunk width li: item c -> word (c / li) * (li / 32) + (c % li) % (li / 32),
// bit (c % li) / (li / 32). NaN scores are never selected.
//
// What bounds it on the H100. At a 4,096-user request (45,056 padded items,
// d=64) the scores are 2*n*N*d = 2.4e10 f32 FLOP on the CUDA cores (no f32
// tensor-core path without TF32, which would change the scores and the
// ids): a ~0.35 ms floor at the data sheet's 67 TFLOP/s f32 peak. Bytes are
// far below that (the item table is 11.5 MB, the exclusion words 23 MB).
// So the kernel is built to keep the FMA pipes busy and to spend few
// instructions on the selection. Measured times are in PERF.md.
//
// Design.
//   * Grid (user tiles of 128, S item ranges). A block walks its range's
//     item tiles in order, as the TPU grid walked j, and keeps each user's
//     running top-k (values and ids, sorted) in shared memory. S is the
//     most ranges whose grid the card holds in one wave; with S > 1 a
//     merge pass takes the top k of each user's S sorted lists by (value,
//     id), a total order, so the result is the top k of the row.
//   * An item tile is 4 exclusion words x 32 bit planes (128 items), so a
//     user's 4 words (16 bytes) hold the whole tile's exclusion bits and
//     every word is read once. Tiles need li % 128 == 0.
//   * Scores: register tiles of 8 users x 8 items a thread (16 x 16
//     threads over 128 x 128), f32 FMAs in feature order, both operands
//     staged through a cp.async ring of 16 features. The users come from a
//     transposed, zero-padded copy that a small first kernel writes, so
//     each shared float4 of users or items feeds 32 FMAs.
//   * Selection: after a tile, its scores (banned row added) go through a
//     shared slab, half the users at a time, and one warp takes a user row:
//     lane b the 4 items of plane b. The user's running k-th entry and a
//     shared threshold (below) drop the row with one compare a lane where
//     no score can enter. Otherwise the warp masks the scores with the
//     words (staged in the ring), tests each by (value, id), and inserts
//     what passes by rank (ballot + popc; one list slot a lane for k <= 32,
//     four for k <= 128), or, for more than kOneByOne candidates (k <= 32),
//     sorts them (bitonic) and merges the two sorted lists. (Ranking all
//     candidates at once from shared memory cost more: its loads compete
//     with the score tiles' for the shared-memory pipe.)
//   * A range's first tile: while a list holds fewer than k entries, the
//     k-th largest of the 32 lanes' maxima bounds the tile's k-th best from
//     below (k <= 32), so ~k + 10 scores are merged, not 128. Equal scores
//     (constant rows) pass the bound: the merge then takes the whole tile,
//     32 at a time, the counterpart of a full scan.
//   * Shared threshold (S > 1): each range publishes its list's j-th value
//     for the user (an order-preserving key), and a block reads those of a
//     window of m = min(S, 8) ranges around its own, with m * j >= k. The
//     least of them has at least k items scoring that much, so every range
//     drops scores below it: a bound near the k-th best of all the items
//     the window has seen, where a range's own k-th best lags by a factor
//     m. The ids never depend on when it is read.
//   * No per-call host work beyond the launches: the shared-memory
//     attribute is set once per device and instance; S comes from
//     igcn_fused_topk_splits, which the wrapper asks once per shape, and
//     the scratch's size from igcn_fused_topk_scratch_words.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUsers = 128;                 // users a block
constexpr int kWords = 4;                   // exclusion words a tile
constexpr int kItems = 32 * kWords;         // items a tile
constexpr int kBk = 16;                     // features a ring stage
constexpr int kStages = 2;
constexpr int kHalf = kUsers / 2;           // users a slab holds
constexpr int kLd = kItems + 4;             // slab row stride (no conflicts)
constexpr int kRowsPerWarp = kHalf / kWarps;
// One ring stage: users [kBk][kUsers] (from the transposed copy), items
// [kBk][kItems] (plane-major: plane b's kWords items at b * kWords), and
// for a tile's last stage the banned row [kItems] and the exclusion words
// [kUsers][kWords].
constexpr int kSa = 0;
constexpr int kSi = kSa + kBk * kUsers;
constexpr int kSb = kSi + kBk * kItems;
constexpr int kSw = kSb + kItems;
constexpr int kStageFloats = kSw + kUsers * kWords;
constexpr int kSlab = kStages * kStageFloats;  // scores [kHalf][kLd]
constexpr int kLists = kSlab + kHalf * kLd;
constexpr int kMergeWarps = 4;              // users per merge block
constexpr int kNoId = 0x7fffffff;
constexpr float kNeg = -3.0e38f;
constexpr int kMaxDevices = 64;
constexpr int kOneByOne = 8;  // more candidates than this merge as a batch
constexpr int kWindow = 8;    // ranges whose published entries bound a user

// (va, ia) ranks before (vb, ib): larger value, then smaller id. NaN never
// ranks before anything.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Order-preserving unsigned key of a non-NaN float; 0 lies below every key
// (no threshold yet), so a zeroed array starts every user at -inf.
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float key_float(unsigned key) {
  if (key & 0x80000000u) return __uint_as_float(key & 0x7fffffffu);
  return key ? __uint_as_float(~key) : -INFINITY;
}

// The warp's 32 values sorted descending (bitonic; no NaN).
__device__ __forceinline__ float warp_sort_desc(float v, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, stride);
      const bool desc = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      v = low == desc ? fmaxf(v, o) : fminf(v, o);
    }
  }
  return v;
}

// One bitonic compare-exchange of (v, id) pairs across lanes lane ^ stride:
// the lane that keeps the better pair when keep_better, else the worse.
__device__ __forceinline__ void exchange(float& v, int& id, int stride,
                                         bool keep_better) {
  const float ov = __shfl_xor_sync(kFull, v, stride);
  const int oi = __shfl_xor_sync(kFull, id, stride);
  if (keep_better == better(ov, oi, v, id)) {
    v = ov;
    id = oi;
  }
}

// Merge the warp's (cv, ci) pairs, one a lane, into its sorted list of k
// <= 32 entries, slot lane in (rv, ri): sort the pairs (bitonic), take the
// better of slot l and pair 31 - l (the top 32 of both, a bitonic
// sequence), sort that; slots from k on get the fillers back.
__device__ __forceinline__ void merge_batch(float& rv, int& ri, float cv,
                                            int ci, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(cv, ci, stride, ((lane & stride) == 0) == ((lane & size) == 0));
  const float bv = __shfl_sync(kFull, cv, 31 - lane);
  const int bi = __shfl_sync(kFull, ci, 31 - lane);
  if (better(bv, bi, rv, ri)) {
    rv = bv;
    ri = bi;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    exchange(rv, ri, stride, (lane & stride) == 0);
  if (lane >= k) {
    rv = -INFINITY;
    ri = kNoId;
  }
}

// Insert (cv, ci) into the warp's sorted list of k entries, slot
// lane * R + r in (rv[r], ri[r]); a candidate that ranks k-th or later is
// dropped. The slots ranking before it are a prefix, so its rank is their
// count. Slots from k on keep their (-inf, kNoId) fillers.
template <int R>
__device__ __forceinline__ void insert(float (&rv)[R], int (&ri)[R], float cv,
                                       int ci, int k, int lane) {
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < R; ++r)
    cnt += (lane * R + r < k && better(rv[r], ri[r], cv, ci)) ? 1 : 0;
  const int pos = R == 1 ? __popc(__ballot_sync(kFull, cnt))
                         : (int)__reduce_add_sync(kFull, (unsigned)cnt);
  if (pos >= k) return;  // uniform
  const float pv = __shfl_up_sync(kFull, rv[R - 1], 1);
  const int pi = __shfl_up_sync(kFull, ri[R - 1], 1);
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int slot = lane * R + r;
    const float prev_v = r > 0 ? rv[r > 0 ? r - 1 : 0] : pv;
    const int prev_i = r > 0 ? ri[r > 0 ? r - 1 : 0] : pi;
    if (slot > pos && slot < k) {
      rv[r] = prev_v;
      ri[r] = prev_i;
    } else if (slot == pos) {
      rv[r] = cv;
      ri[r] = ci;
    }
  }
}

// One user's scores s (the lane's 4 items, ids c0 .. c0 + 3, banned row
// added) against its running list: mask with the tile's 4 words, keep the
// scores that can enter, insert them. (tv, ti) is the list's k-th entry; tg
// the user's shared threshold (at least k items score tg or more, so no
// score below it is in the row's top k). The list's jth entry, once it
// has one, is published at jkey.
template <int R>
__device__ __forceinline__ void select_tile(float (&s)[4], int c0, int lw,
                                            uint4 words, float* list_v,
                                            int* list_i, int k, int lane,
                                            float tv, int ti, float tg,
                                            unsigned* jkey, int jth,
                                            float* stage_v, int* stage_i) {
  const uint32_t wd[kWords] = {words.x, words.y, words.z, words.w};
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    if ((wd[w] >> lane) & 1u) s[w] = kNeg;
  bool pass[kWords];
  if (R == 1 && ti == kNoId) {
    // fewer than k entries: at least k of this tile's items score at least
    // the k-th largest lane maximum, so nothing below it can enter
    float lm = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
    if (lm != lm) lm = -INFINITY;
    const float bound = fmaxf(
        __shfl_sync(kFull, warp_sort_desc(lm, lane), k - 1), tg);
#pragma unroll
    for (int w = 0; w < kWords; ++w) pass[w] = s[w] >= bound;
  } else {
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      pass[w] = better(s[w], c0 + w, tv, ti) && s[w] >= tg;
  }
  unsigned bal[kWords];
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    bal[w] = __ballot_sync(kFull, pass[w]);
    total += __popc(bal[w]);
  }
  if (total == 0) return;  // uniform: masking or the ids dropped them all
  float rv[R];
  int ri[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rv[r] = list_v[lane * R + r];
    ri[r] = list_i[lane * R + r];
  }
  if (R == 1 && total > kOneByOne) {
    // many candidates (a range's first tiles): compact them 32 at a time
    // through the warp's staging slots and merge each batch
    const unsigned below = (1u << lane) - 1;  // lanes before this one
    int first = 0;  // this lane's first candidate, in lane-then-word order
#pragma unroll
    for (int w = 0; w < kWords; ++w) first += __popc(bal[w] & below);
    for (int b0 = 0; b0 < total; b0 += 32) {
      int at = first;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        if (pass[w]) {
          if (at >= b0 && at < b0 + 32) {
            stage_v[at - b0] = s[w];
            stage_i[at - b0] = c0 + w;
          }
          ++at;
        }
      }
      __syncwarp();
      const bool has = lane < total - b0;
      const float cv = has ? stage_v[lane] : -INFINITY;
      const int ci = has ? stage_i[lane] : kNoId;
      __syncwarp();
      merge_batch(rv[0], ri[0], cv, ci, k, lane);
    }
  } else {
    const int base = c0 - lane * lw;  // id of plane 0's first item
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      unsigned mk = bal[w];
      while (mk) {
        const int src = __ffs(mk) - 1;
        mk &= mk - 1;
        const float cv = __shfl_sync(kFull, s[w], src);
        insert<R>(rv, ri, cv, base + src * lw + w, k, lane);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    list_v[lane * R + r] = rv[r];
    list_i[lane * R + r] = ri[r];
  }
  __syncwarp();
  if (jkey && lane == 0 && list_i[jth - 1] != kNoId)
    *jkey = float_key(list_v[jth - 1]);
}

template <int R>
constexpr size_t range_smem() {
  return (size_t)(kLists + 2 * kUsers * (32 * R + 1) + 2 * kThreads + kUsers) *
         4;
}

// users_t (dpad, npad) f32 <- users (n, d) f32, zero-padded: the range
// kernel then copies whole 512-byte user rows a feature.
__global__ void __launch_bounds__(256)
transpose_users_kernel(const float* __restrict__ users, float* __restrict__ users_t,
                       int n, int d, int npad, int dpad) {
  __shared__ float tile[32][33];
  const int u0 = blockIdx.x * 32, f0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int u = u0 + r, f = f0 + threadIdx.x;
    tile[r][threadIdx.x] = u < n && f < d ? users[(size_t)u * d + f] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int f = f0 + r;
    if (f < dpad) users_t[(size_t)f * npad + u0 + threadIdx.x] = tile[threadIdx.x][r];
  }
}

// users_t (dpad, npad) f32, items_t (d, nip) f32, excl (n, nip / 32) u32,
// banned (nip) f32. Block (x, y): users [128 x, 128 x + 128), item range y
// of splits. Writes each user's sorted top k of the range to part (n,
// splits, k), or its ids to out (n, k) when splits == 1.
template <int R>
__global__ void __launch_bounds__(kThreads, R == 1 ? 2 : 1)
topk_range_kernel(const float* __restrict__ users_t,
                  const float* __restrict__ items_t,
                  const uint32_t* __restrict__ excl,
                  const float* __restrict__ banned, float* __restrict__ part_v,
                  int* __restrict__ part_i, unsigned* __restrict__ gj,
                  int* __restrict__ out, int n, int npad, int nip, int d,
                  int k, int li, int splits, int jth) {
  constexpr int KP = 32 * R;  // list slots a user
  constexpr int KS = KP + 1;  // list row stride (a thread a row: no conflicts)
  extern __shared__ __align__(16) float smem[];
  float* slab = smem + kSlab;
  float* lv = smem + kLists;
  int* lid = reinterpret_cast<int*>(lv + kUsers * KS);
  const int warp = threadIdx.x >> 5;
  float* stage_v = reinterpret_cast<float*>(lid + kUsers * KS) + warp * 64;
  int* stage_i = reinterpret_cast<int*>(stage_v + 32);
  float* tgj = reinterpret_cast<float*>(lid + kUsers * KS) + 2 * kThreads;
  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 4;  // users ty * 4 + {0..3} of each half
  const int tx = threadIdx.x & 15;  // items tx * 4 + {0..3} of each half
  const int u0 = blockIdx.x * kUsers;
  const int range = blockIdx.y;
  const int lw = li >> 5;
  const int nwords = nip >> 5;
  const long long n_tiles = nip / kItems;
  const int t_begin = (int)(n_tiles * range / splits);
  const int t_end = (int)(n_tiles * (range + 1) / splits);
  const int nkb = (d + kBk - 1) / kBk;
  const int total = (t_end - t_begin) * nkb;

  for (int i = threadIdx.x; i < kUsers * KS; i += kThreads) {
    lv[i] = -INFINITY;
    lid[i] = kNoId;
  }
  if (threadIdx.x < kUsers) tgj[threadIdx.x] = -INFINITY;
  // the window of ranges whose published j-th entries bound these users:
  // m consecutive ranges holding this one, m * jth >= k
  const int m = splits < kWindow ? splits : kWindow;
  const int win0 = min((range / kWindow) * kWindow, splits - m);

  // Stage it of the walk: tile t_begin + it / nkb, features kb * kBk on.
  auto load_stage = [&](int it) {
    float* st = smem + (it % kStages) * kStageFloats;
    const int tile = t_begin + it / nkb;
    const int kb = it % nkb;
    const int g = tile * kWords;  // the tile's first word column
    const int cb = (g / lw) * li + g % lw;
    const int f0 = kb * kBk;
    for (int i = threadIdx.x; i < kBk * 32; i += kThreads) {
      const int f = i >> 5, b = i & 31;
      igcn::cp_async16(st + kSa + f * kUsers + b * 4,
                       users_t + (size_t)(f0 + f) * npad + u0 + b * 4, true);
      const bool ok = f0 + f < d;
      igcn::cp_async16(
          st + kSi + f * kItems + b * kWords,
          ok ? items_t + (size_t)(f0 + f) * nip + cb + b * lw : items_t, ok);
    }
    if (kb == nkb - 1) {
      if (threadIdx.x < 32)
        igcn::cp_async16(st + kSb + threadIdx.x * kWords,
                         banned + cb + threadIdx.x * lw, true);
      for (int u = threadIdx.x; u < kUsers; u += kThreads) {
        const bool ok = u0 + u < n;
        igcn::cp_async16(st + kSw + u * kWords,
                         ok ? excl + (size_t)(u0 + u) * nwords + g : excl, ok);
      }
    }
  };

  // acc[i][j]: user (i / 4) * kHalf + ty * 4 + i % 4, item slot
  // (j / 4) * 64 + tx * 4 + j % 4 of the tile
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    igcn::cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    igcn::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < total) load_stage(it + kStages - 1);
    igcn::cp_async_commit();
    const float* st = smem + (it % kStages) * kStageFloats;
#pragma unroll
    for (int f = 0; f < kBk; ++f) {
      const float4 a0 = *reinterpret_cast<const float4*>(st + kSa + f * kUsers + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(st + kSa + f * kUsers + kHalf + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(st + kSi + f * kItems + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(st + kSi + f * kItems + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if ((it + 1) % nkb) continue;
    // The tile's last stage: its scores go through the slab, half the
    // users at a time, and one warp selects for each user row.
    const int g = (t_begin + it / nkb) * kWords;
    const int cb = (g / lw) * li + g % lw;  // id of plane 0's first item
    const float4 bn0 = *reinterpret_cast<const float4*>(st + kSb + tx * 4);
    const float4 bn1 = *reinterpret_cast<const float4*>(st + kSb + 64 + tx * 4);
    const uint4* sw = reinterpret_cast<const uint4*>(st + kSw);
    // the window's published entries for user threadIdx.x / 2, read now and
    // folded into tgj after this tile's selection
    unsigned wkey[kWindow / 2];
#pragma unroll
    for (int q = 0; q < kWindow / 2; ++q) {
      const int i = (threadIdx.x & 1) * (kWindow / 2) + q;
      wkey[q] = gj && i < m ? __ldcg(gj + (size_t)(u0 + (threadIdx.x >> 1)) *
                                              splits + win0 + i)
                            : 0xffffffffu;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h) __syncthreads();  // the first half's rows are read
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = slab + (ty * 4 + i) * kLd;
        float (&a)[8] = acc[h * 4 + i];
        *reinterpret_cast<float4*>(row + tx * 4) =
            make_float4(a[0] + bn0.x, a[1] + bn0.y, a[2] + bn0.z, a[3] + bn0.w);
        *reinterpret_cast<float4*>(row + 64 + tx * 4) =
            make_float4(a[4] + bn1.x, a[5] + bn1.y, a[6] + bn1.z, a[7] + bn1.w);
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = 0.f;
      }
      __syncthreads();
      // Test the warp's rows together (their loads in flight at once), then
      // select for the rows where some score may enter.
      const int r0 = warp * kRowsPerWarp;
      unsigned todo = 0;
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int ul = h * kHalf + r0 + q;
        const float4 sv =
            *reinterpret_cast<const float4*>(slab + (r0 + q) * kLd + lane * 4);
        const float eff = fmaxf(lv[ul * KS + k - 1], tgj[ul]);
        const float m = fmaxf(fmaxf(sv.x, sv.y), fmaxf(sv.z, sv.w));
        // below the k-th entry and tg nothing enters, unless masking could
        // raise a score to NEG
        if (__any_sync(kFull, m >= eff || eff <= kNeg) && u0 + ul < n)
          todo |= 1u << q;
      }
      while (todo) {
        const int r = r0 + __ffs(todo) - 1;
        todo &= todo - 1;
        const int ul = h * kHalf + r;
        const float4 sv =
            *reinterpret_cast<const float4*>(slab + r * kLd + lane * 4);
        float s[4] = {sv.x, sv.y, sv.z, sv.w};
        float* list_v = lv + ul * KS;
        int* list_i = lid + ul * KS;
        select_tile<R>(s, cb + lane * lw, lw, sw[ul], list_v, list_i, k, lane,
                       list_v[k - 1], list_i[k - 1], tgj[ul],
                       gj ? gj + (size_t)(u0 + ul) * splits + range : nullptr,
                       jth, stage_v, stage_i);
      }
    }
    if (gj) {
      // the least of the window's j-th entries (key 0: none yet, -inf):
      // m ranges hold at least m * jth >= k items scoring that much
      unsigned mk = wkey[0];
#pragma unroll
      for (int q = 1; q < kWindow / 2; ++q) mk = min(mk, wkey[q]);
      mk = min(mk, __shfl_xor_sync(kFull, mk, 1));
      if (!(threadIdx.x & 1)) tgj[threadIdx.x >> 1] = key_float(mk);
    }
    // the next writes to the slab follow the ring's barrier
  }
  igcn::cp_async_wait<0>();
  __syncthreads();

#pragma unroll 1
  for (int ul = warp; ul < kUsers; ul += kWarps) {
    const int ug = u0 + ul;
    if (ug >= n) break;
    for (int t = lane; t < k; t += 32) {
      if (splits == 1) {
        out[(size_t)ug * k + t] = lid[ul * KS + t];
      } else {
        const size_t o = ((size_t)ug * splits + range) * k + t;
        part_v[o] = lv[ul * KS + t];
        part_i[o] = lid[ul * KS + t];
      }
    }
  }
}

__global__ void __launch_bounds__(kMergeWarps * 32)
merge_topk_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int* __restrict__ out, int n_users, int n_lists, int k) {
  extern __shared__ int heads[];  // [kMergeWarps][n_lists]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = blockIdx.x * kMergeWarps + warp;
  if (u >= n_users) return;  // uniform per warp; no block-wide barrier
  int* head = heads + warp * n_lists;
  for (int j = lane; j < n_lists; j += 32) head[j] = 0;
  __syncwarp();
  const float* pv = part_v + (size_t)u * n_lists * k;
  const int* pi = part_i + (size_t)u * n_lists * k;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = kNoId, bj = -1;
    for (int j = lane; j < n_lists; j += 32) {
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

// The range kernel's dynamic shared memory, allowed once per device (the
// attribute is the function's, not the launch's).
template <int R>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(topk_range_kernel<R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)range_smem<R>());
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int R>
int blocks_per_sm() {
  int blocks = 0;
  if (allow_smem<R>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, topk_range_kernel<R>, kThreads, range_smem<R>()) !=
          cudaSuccess)
    return 0;
  return blocks;
}

int tiles(int n) { return (n + kUsers - 1) / kUsers; }

long long dpad_of(int d) { return (long long)(d + kBk - 1) / kBk * kBk; }

// The scratch's parts, in 32-bit words, each a multiple of 4 (16 bytes):
// the transposed users (dpad, npad); with splits > 1 the S sorted lists'
// values and ids (n, splits, k) each, then the users' shared thresholds
// (npad).
long long users_words(int n, int d) { return dpad_of(d) * tiles(n) * kUsers; }

long long list_words(int n, int k, int splits) {
  return ((long long)2 * n * splits * k + 3) / 4 * 4;
}

bool bad_shape(int n, int nip, int d, int k, int li) {
  return n < 0 || d < 1 || k < 1 || k > 128 || k > nip || li < kItems ||
         li % kItems || nip % li;
}

}  // namespace

extern "C" {

// S, the item ranges of (n, nip, k): the most whose grid (user tiles x S)
// the card holds in one wave, at least 1 and at most one tile a range.
int igcn_fused_topk_splits(int n, int nip, int k) {
  const int tiles_u = tiles(n);
  const int tiles_i = nip / kItems;
  int dev = 0, sms = 0;
  if (tiles_u < 1 || tiles_i < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  const int per_sm = k <= 32 ? blocks_per_sm<1>() : blocks_per_sm<4>();
  int s = per_sm * sms / tiles_u;
  if (s > tiles_i) s = tiles_i;
  if (s > 65535) s = 65535;
  return s < 1 ? 1 : s;
}

// The launch of (n, nip, k) at S splits, for logs: out = {grid x, grid y
// (S), threads, shared bytes a block, blocks an SM, users a block, items a
// tile, list slots a lane}.
void igcn_fused_topk_launch_shape(int n, int nip, int k, int splits, int* out) {
  const bool small = k <= 32;
  out[0] = tiles(n);
  out[1] = splits;
  out[2] = kThreads;
  out[3] = (int)(small ? range_smem<1>() : range_smem<4>());
  out[4] = small ? blocks_per_sm<1>() : blocks_per_sm<4>();
  out[5] = kUsers;
  out[6] = kItems;
  out[7] = small ? 1 : 4;
}

// 32-bit words of K5's scratch at (n, d, k, splits).
long long igcn_fused_topk_scratch_words(int n, int d, int k, int splits) {
  if (n < 1 || d < 1) return 0;
  long long words = users_words(n, d);
  if (splits > 1)
    words += list_words(n, k, splits) + (long long)tiles(n) * kUsers * splits;
  return words;
}

// users (n_users, d) f32; items_t (d, n_items_pad) f32, excl (n_users,
// n_items_pad / 32) u32, banned (n_items_pad) f32 and scratch (of
// igcn_fused_topk_scratch_words(n_users, d, k, splits) 32-bit words) all
// 16-byte aligned; out (n_users, k) i32. Requires 1 <= k <= min(128,
// n_items_pad), li % 128 == 0, n_items_pad % li == 0, 1 <= splits <=
// n_items_pad / 128.
int igcn_fused_topk(const void* users, const void* items_t, const void* excl,
                    const void* banned, void* scratch, void* out, int n_users,
                    int n_items_pad, int d, int k, int li, int splits,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bad_shape(n_users, n_items_pad, d, k, li) || splits < 1 ||
      splits > n_items_pad / kItems || splits > 65535 ||
      (n_users > 0 && !scratch) ||
      ((uintptr_t)items_t | (uintptr_t)excl | (uintptr_t)banned |
       (uintptr_t)scratch) % 16)
    return (int)cudaErrorInvalidValue;
  if (n_users == 0) return (int)cudaGetLastError();
  const int npad = tiles(n_users) * kUsers;
  const int dpad = (int)dpad_of(d);
  float* users_t = static_cast<float*>(scratch);
  float* part_v = nullptr;
  int* part_i = nullptr;
  unsigned* gj = nullptr;
  if (splits > 1) {
    int* lists = static_cast<int*>(scratch) + users_words(n_users, d);
    part_v = reinterpret_cast<float*>(lists);
    part_i = lists + (size_t)n_users * splits * k;
    gj = reinterpret_cast<unsigned*>(lists + list_words(n_users, k, splits));
    const cudaError_t err = cudaMemsetAsync(
        gj, 0, (size_t)npad * splits * sizeof(unsigned), s);
    if (err != cudaSuccess) return (int)err;
  }
  const int m = splits < kWindow ? splits : kWindow;
  const int jth = (k + m - 1) / m;
  transpose_users_kernel<<<dim3(npad / 32, (dpad + 31) / 32), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(users), users_t, n_users, d, npad, dpad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles(n_users), splits);
  if (k <= 32) {
    err = allow_smem<1>();
    if (err != cudaSuccess) return (int)err;
    topk_range_kernel<1><<<grid, kThreads, range_smem<1>(), s>>>(
        users_t, static_cast<const float*>(items_t),
        static_cast<const uint32_t*>(excl), static_cast<const float*>(banned),
        part_v, part_i, gj, static_cast<int*>(out), n_users, npad,
        n_items_pad, d, k, li, splits, jth);
  } else {
    err = allow_smem<4>();
    if (err != cudaSuccess) return (int)err;
    topk_range_kernel<4><<<grid, kThreads, range_smem<4>(), s>>>(
        users_t, static_cast<const float*>(items_t),
        static_cast<const uint32_t*>(excl), static_cast<const float*>(banned),
        part_v, part_i, gj, static_cast<int*>(out), n_users, npad,
        n_items_pad, d, k, li, splits, jth);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;

  const size_t smem2 = (size_t)kMergeWarps * splits * sizeof(int);
  if (smem2 > 48 * 1024) return (int)cudaErrorInvalidValue;
  merge_topk_kernel<<<(n_users + kMergeWarps - 1) / kMergeWarps,
                      kMergeWarps * 32, smem2, s>>>(
      part_v, part_i, static_cast<int*>(out), n_users, splits, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
