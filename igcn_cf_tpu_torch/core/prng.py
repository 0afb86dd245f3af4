"""Deterministic randomness plumbing (port of ``igcn_cf_tpu/core/prng.py``).

The JAX package threads explicit PRNG keys. The port threads explicit
``torch.Generator``s instead: ``KeySeq`` is a seeded root that hands out
fresh generators (for any device) and fresh u32 seeds (for the edge-dropout
keep mask, which takes a seed, as the JAX package's ``_seed_from_key``
yields). The streams differ from JAX's for the same seed; the tests feed
both packages the same draws where they compare them.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

_U32 = 2**32


def set_seed(seed: int = 0) -> "KeySeq":
    """Seed Python's, numpy's and torch's global RNGs and return the root
    ``KeySeq`` (reference utils.py:12-20)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return KeySeq(seed)


class KeySeq:
    """A seeded host-side root of randomness. Draws come from a CPU
    generator, so handing one out never waits for a device."""

    def __init__(self, seed: int):
        self._gen = torch.Generator().manual_seed(int(seed))

    def next_seed(self) -> int:
        """A fresh u32 seed."""
        return int(torch.randint(0, _U32, (1,), generator=self._gen,
                                 dtype=torch.int64))

    def generator(self, device="cpu") -> torch.Generator:
        """A fresh generator on ``device``, seeded from this sequence."""
        seed = int(torch.randint(0, 2**62, (1,), generator=self._gen,
                                 dtype=torch.int64))
        return torch.Generator(device=torch.device(device)).manual_seed(seed)

    def get_state(self) -> torch.Tensor:
        return self._gen.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self._gen.set_state(state)


def fold_in(seed: int, data: int) -> int:
    """A u32 seed derived from the u32 ``seed`` and the int ``data``: the
    port's counterpart of ``jax.random.fold_in(key, data)``, which the JAX
    package's sharded step uses to give each table shard its own dropout
    stream (``fold_in(key, t)``). A murmur3 finalizer over ``seed`` xor a
    golden-ratio multiple of ``data + 1``: distinct ``data`` give
    unrelated seeds, and the same arguments the same seed on every rank.
    The stream differs from JAX's."""
    x = (int(seed) ^ ((int(data) + 1) * 0x9E3779B9)) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)
