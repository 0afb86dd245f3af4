"""Which train edges IGCN's edge dropout keeps under a u32 seed: a frozen
plain copy of the coordinate hash the configuration's dropout is defined
by (the JAX package's ``_keepword``, documented in the port's PARITY
notes), so the reference recomputes a step's keep decisions from its seeds.

B's columns come in tiles of 4,096; within a tile, column c sits in word
lane c % 128 at bit (c % 4096) // 128. One 32-bit keep word per (row, word)
holds the decision of the word's 32 columns: bit b is 1 where the salted
hash of (row, word) is at least the threshold round(p * 256) in eight
bit-sliced 8-bit comparisons, so an edge is kept with probability
1 - round(p * 256) / 256.
"""

from __future__ import annotations

import torch

_C1, _C2, _C3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_M32 = 0xFFFFFFFF


def threshold(p: float) -> int:
    return max(0, min(255, int(round(p * 256))))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def keep_word(seed: int, rows: torch.Tensor, words: torch.Tensor,
              thr: int) -> torch.Tensor:
    """The keep words of int64 (row, word) pairs, as int64 in [0, 2**32)."""
    base = _mul32(rows, _C1) ^ _mul32(words, _C2)
    ge = torch.zeros_like(base)
    eq = torch.full_like(base, _M32)
    for i in range(7, -1, -1):
        salt = (i * 0x9E3779B1 + 1) & _M32
        h = base ^ ((int(seed) + salt) & _M32)
        h = _mul32(h ^ (h >> 16), _C3)
        h = h ^ (h >> 16)
        if (thr >> i) & 1:
            eq = eq & h
        else:
            ge = ge | (eq & h)
            eq = eq & (h ^ _M32)
    return ge | eq


def kept(seed: int, users: torch.Tensor, items: torch.Tensor,
         p: float) -> torch.Tensor:
    """bool per edge (users[e], items[e]): kept under ``seed``."""
    users, items = users.long(), items.long()
    word = (items // 4096) * 128 + items % 128
    bit = (items % 4096) // 128
    w = keep_word(seed, users, word, threshold(p))
    return ((w >> bit) & 1).bool()
