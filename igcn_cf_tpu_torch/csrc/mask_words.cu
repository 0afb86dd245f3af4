// Counterpart of K8: the dropout-masked copies of the bit-packed matrix B.
//
// Replaces the training path's igcn_cf_tpu/kernels/bitpack.py::mask_words
// (bitpack.py:592-606), an XLA-fused elementwise pass; the TPU kernel K8
// (bitpack.py:609 mask_words_hw) drew its bits from the TPU's hardware PRNG
// and was never wired in. This kernel computes exactly mask_words:
//
//   out[r, w] = wp[r, w] & keepword(seed, r, w, thr)        (keepword.cuh)
//
// bit for bit, so the CUDA and CPU paths drop the same edges. The pair
// entry computes it under two seeds in one pass (the IGCN step masks B once
// for each direction of the feature aggregation): two calls of the JAX
// mask_words, reading B once.
//
// What bounds it on the H100. At the training slice B is 30,208 x 1,408
// words (42.5M, 170 MB) and ~97% of them are zero. One seed reads and
// writes 340 MB, ~0.10 ms at the data sheet's 3.35 TB/s; the pair reads B
// once and writes two copies, 510 MB, ~0.15 ms. The hash is 8 rounds of a
// multiply and two xor-shifts per word and seed, ~5e9 integer operations
// for the whole grid, but 0 & anything is 0, so only non-zero words are
// hashed and the pass is bound by the word stream. On dense words (every
// word non-zero) it is bound by the hash instead. The design:
// - 16-byte streaming loads and stores (__ldcs / __stcs: neither B nor the
//   copies fit the 50 MB L2), kVecs of them a thread, all issued before the
//   first is used: 64 bytes a thread in flight, ~50 KB an SM at 3 blocks of
//   256 threads, over the ~26 KB that Little's law asks at ~1 us.
// - A flat 32-bit word index, cut into (row, word) by a division by kw with
//   a multiplier computed once on the host (Divider): no 64-bit division,
//   and any kw, with rows that start anywhere in a 16-byte group. m * kw
//   must be below 2^32; the base pointers must be 16-byte aligned (the
//   wrapper copies an unaligned B).
// - The hash runs once a warp for up to 32 non-zero words: the warp votes
//   its 512 words (16 a lane), and when few are non-zero each non-zero word
//   gets a rank (ballot + popc) and its flat index goes to a per-warp list
//   in shared memory; lane q hashes entries q, q + 32, ... and writes the
//   keep words back by rank; each owner reads its own. At ~14 non-zero
//   words in 512 a warp hashes once instead of once for each of its 16
//   slots that holds a non-zero word somewhere in the warp. Dense warps
//   hash in place: nothing to gather.
// - The keep word's constants (salted seeds, thr's bits as masks) are
//   computed on the host (KeepKey) and read from the constant bank; the
//   pair shares keep_base between its two seeds.
// Every word's keep decision depends only on (seed, row, word), never on
// the launch geometry or the compaction: the ranks move where a hash runs,
// not which (row, word) it hashes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keepword.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;              // 16-byte groups a thread
constexpr int kSlots = 4 * kVecs;     // words a lane
constexpr int kCompact = 128;         // most non-zero words a warp ranks
constexpr unsigned kFull = 0xffffffffu;

// n / d for every 32-bit n: the round-up method of Granlund and Montgomery
// (PLDI 1994, fig. 4.1): l = ceil(log2 d), mul = floor(2^32 (2^l - d) / d)
// + 1, q = (t + ((n - t) >> sh1)) >> sh2 with t = umulhi(n, mul).
struct Divider {
  uint32_t d, mul, sh1, sh2;
};

Divider make_divider(uint32_t d) {  // d >= 1
  uint32_t l = 0;
  while (l < 32 && (1ull << l) < d) ++l;
  Divider v;
  v.d = d;
  v.mul = (uint32_t)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  v.sh1 = l < 1 ? l : 1;
  v.sh2 = l > 1 ? l - 1 : 0;
  return v;
}

__device__ __forceinline__ uint32_t divide(const Divider& v, uint32_t n) {
  const uint32_t t = __umulhi(n, v.mul);
  return (t + ((n - t) >> v.sh1)) >> v.sh2;
}

// keep_base of flat word i of the (m, kw) grid
__device__ __forceinline__ uint32_t base_of(const Divider& kw, uint32_t i) {
  const uint32_t row = divide(kw, i);
  return igcn::keep_base(row, i - row * kw.d);
}

__device__ __forceinline__ uint32_t& word(uint4 (&v)[kVecs], int s) {
  uint4& g = v[s / 4];
  return s % 4 == 0 ? g.x : s % 4 == 1 ? g.y : s % 4 == 2 ? g.z : g.w;
}

// 16-byte group g of wp: words 4 g .. 4 g + 3, zero past n (n % 4 words of
// the group full_groups = n / 4 are read one by one)
__device__ __forceinline__ uint4 load_group(const uint32_t* __restrict__ wp,
                                            uint32_t g, uint32_t full_groups,
                                            uint32_t n) {
  if (g < full_groups) return __ldcs(reinterpret_cast<const uint4*>(wp) + g);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (g == full_groups) {
    const uint32_t i = 4 * g;
    if (i < n) v.x = wp[i];
    if (i + 1 < n) v.y = wp[i + 1];
    if (i + 2 < n) v.z = wp[i + 2];
  }
  return v;
}

__device__ __forceinline__ void store_group(uint32_t* __restrict__ out,
                                            uint32_t g, uint32_t full_groups,
                                            uint32_t n, uint4 v) {
  if (g < full_groups) {
    __stcs(reinterpret_cast<uint4*>(out) + g, v);
  } else if (g == full_groups) {
    const uint32_t i = 4 * g;
    if (i < n) out[i] = v.x;
    if (i + 1 < n) out[i + 1] = v.y;
    if (i + 2 < n) out[i + 2] = v.z;
  }
}

// Warp w of block b owns the 32 kVecs 16-byte groups from 32 kVecs (kWarps
// b + w); lane l holds groups + 32 v + l (v < kVecs), so each of a warp's
// kVecs loads is 512 contiguous bytes. Slot s of a lane is word s % 4 of
// its group s / 4.
template <bool PAIR>
__global__ void __launch_bounds__(kThreads, 3)
mask_words_kernel(const uint32_t* __restrict__ wp, uint32_t* __restrict__ out_a,
                  uint32_t* __restrict__ out_b, uint32_t n, Divider kw,
                  igcn::KeepKey key_a, igcn::KeepKey key_b) {
  // one list of flat indices and one of keep words (two for the pair) a
  // warp; each warp touches only its own rows, and a block masks its
  // groups once, so no slot is ever reused
  __shared__ uint32_t s_idx[kWarps][kCompact];
  __shared__ uint32_t s_keep[PAIR ? 2 : 1][kWarps][kCompact];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t full_groups = n / 4;
  const uint32_t g0 = (blockIdx.x * kWarps + warp) * (32 * kVecs) + lane;

  uint4 v[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    v[k] = load_group(wp, g0 + 32 * k, full_groups, n);

  // the flat index of slot s of this lane (meaningful for words < n only,
  // and only those are non-zero)
  auto flat = [&](int s) { return 4 * (g0 + 32 * (s / 4)) + s % 4; };

  uint32_t ballot[kSlots];
  int total = 0, busy = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    ballot[s] = __ballot_sync(kFull, word(v, s) != 0u);
    total += __popc(ballot[s]);
    busy += ballot[s] != 0u;
  }
  uint4 oa[kVecs], ob[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) oa[k] = ob[k] = make_uint4(0u, 0u, 0u, 0u);

  // warp-uniform: rank when it saves hash rounds and the list holds them
  if (total <= kCompact && (total + 31) / 32 < busy) {
    const uint32_t below = (1u << lane) - 1u;
    uint32_t* idx = s_idx[warp];
    int rank0 = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {  // ranks in slot order, then lane
      if (word(v, s)) idx[rank0 + __popc(ballot[s] & below)] = flat(s);
      rank0 += __popc(ballot[s]);
    }
    __syncwarp();
    for (int q = lane; q < total; q += 32) {
      const uint32_t base = base_of(kw, idx[q]);
      s_keep[0][warp][q] = igcn::keepword(key_a, base);
      if constexpr (PAIR) s_keep[1][warp][q] = igcn::keepword(key_b, base);
    }
    __syncwarp();
    rank0 = 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const uint32_t w = word(v, s);
      if (w) {
        const int q = rank0 + __popc(ballot[s] & below);
        word(oa, s) = w & s_keep[0][warp][q];
        if constexpr (PAIR) word(ob, s) = w & s_keep[1][warp][q];
      }
      rank0 += __popc(ballot[s]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const uint32_t w = word(v, s);
      if (w) {
        const uint32_t base = base_of(kw, flat(s));
        word(oa, s) = w & igcn::keepword(key_a, base);
        if constexpr (PAIR) word(ob, s) = w & igcn::keepword(key_b, base);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    store_group(out_a, g0 + 32 * k, full_groups, n, oa[k]);
    if constexpr (PAIR) store_group(out_b, g0 + 32 * k, full_groups, n, ob[k]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool PAIR>
int launch(const void* wp, void* out_a, void* out_b, int m, int kw,
           unsigned seed_a, unsigned seed_b, int thr, void* stream) {
  const long long n = (long long)m * kw;
  if (m < 0 || kw < 0 || thr < 0 || thr > 255 || n >= (1ll << 32) ||
      !aligned16(wp) || !aligned16(out_a) || (PAIR && !aligned16(out_b)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const long long groups = (n + 3) / 4;
  const long long per_block = (long long)kWarps * 32 * kVecs;
  const unsigned blocks = (unsigned)((groups + per_block - 1) / per_block);
  mask_words_kernel<PAIR><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wp), static_cast<uint32_t*>(out_a),
      static_cast<uint32_t*>(out_b), (uint32_t)n, make_divider((uint32_t)kw),
      igcn::keep_key(seed_a, thr), igcn::keep_key(seed_b, thr));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// wp, out: (m, kw) uint32 words, 16-byte aligned, m * kw < 2^32; thr =
// round(p * 256) in [0, 255].
int igcn_mask_words(const void* wp, void* out, int m, int kw,
                    unsigned int seed, int thr, void* stream) {
  return launch<false>(wp, out, nullptr, m, kw, seed, seed, thr, stream);
}

// The same under two seeds in one pass over wp: out_a under seed_a, out_b
// under seed_b, each bit-equal to igcn_mask_words with its seed.
int igcn_mask_words_pair(const void* wp, void* out_a, void* out_b, int m,
                         int kw, unsigned int seed_a, unsigned int seed_b,
                         int thr, void* stream) {
  return launch<true>(wp, out_a, out_b, m, kw, seed_a, seed_b, thr, stream);
}

}  // extern "C"
