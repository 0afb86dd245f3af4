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

}  // namespace igcn
