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
