// The coordinate-hashed edge-dropout keep word, shared by every kernel that
// masks the bit-packed interaction matrix B.
//
// Bit-identical to igcn_cf_tpu/kernels/bitpack.py::_keepword (constants
// _C1.._C3 at bitpack.py:52-54): for packed word (row, word) and a 32-bit
// seed, bit b of the result is [byte(row, column of bit b) >= thr], where
// the byte's 8 bits come from 8 salted multiply-xorshift hashes of
// (row, word) and the 32 columns are compared at once, bit-sliced. thr is
// round(p * 256), so the keep probability is 1 - thr / 256 (the JAX
// package's documented 1/256 quantization of p). The keep decision depends
// only on (seed, row, word), never on the launch geometry.
#pragma once

#include <stdint.h>

namespace igcn {

constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;

__host__ __device__ __forceinline__ uint32_t keep_salt(int i) {
  return (uint32_t)i * 0x9E3779B1u + 1u;
}

__host__ __device__ __forceinline__ uint32_t keepword(uint32_t seed,
                                                      uint32_t row,
                                                      uint32_t word, int thr) {
  const uint32_t base = (row * kC1) ^ (word * kC2);  // the same in all rounds
  uint32_t ge = 0u, eq = 0xffffffffu;
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    uint32_t h = base ^ (seed + keep_salt(i));
    h = (h ^ (h >> 16)) * kC3;
    h ^= h >> 16;
    if ((thr >> i) & 1) {
      eq &= h;
    } else {
      ge |= eq & h;
      eq &= ~h;
    }
  }
  return ge | eq;
}

// keepword's per-launch constants for one (seed, thr): each round's salted
// seed, and all ones in the rounds where bit i of thr is clear. Passed by
// value as a kernel parameter, they are operands from the constant bank:
// no register holds them and no branch on thr is left in the rounds.
struct KeepKey {
  uint32_t salted[8];
  uint32_t clear[8];
};

__host__ __device__ inline KeepKey keep_key(uint32_t seed, int thr) {
  KeepKey k;
  for (int i = 0; i < 8; ++i) {
    k.salted[i] = seed + keep_salt(i);
    k.clear[i] = ((thr >> i) & 1) ? 0u : 0xffffffffu;
  }
  return k;
}

// The seed-free part of keepword, shared by every seed of a (row, word).
__host__ __device__ __forceinline__ uint32_t keep_base(uint32_t row,
                                                       uint32_t word) {
  return (row * kC1) ^ (word * kC2);
}

// keepword(seed, row, word, thr) from keep_key(seed, thr) and
// keep_base(row, word): the same rounds, the comparator without branches
// (a set bit of thr: eq &= h; a clear one: ge |= eq & h, eq &= ~h).
__host__ __device__ __forceinline__ uint32_t keepword(const KeepKey& k,
                                                      uint32_t base) {
  uint32_t ge = 0u, eq = 0xffffffffu;
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    uint32_t h = base ^ k.salted[i];
    h = (h ^ (h >> 16)) * kC3;
    h ^= h >> 16;
    ge |= eq & h & k.clear[i];
    eq &= h ^ k.clear[i];
  }
  return ge | eq;
}

}  // namespace igcn
