"""Host-side interaction dataset container (port of
``igcn_cf_tpu/data/dataset.py``).

Per-user train/val/test item lists plus a flat ``train_array`` of
[user, item] pairs. The container never touches a device; graph and mask
structures are derived from it by the kernels layer. The evaluator memoizes
exclusion and eval-list structures on the instance
(``evaluation/evaluate.py``, ``evaluation/metrics.py``), which is why the
split lists are never mutated in place.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import List

import numpy as np


@dataclass
class Interactions:
    """The split lists must not be mutated in place after construction
    (the evaluator's caches on the instance would go stale); derive a new
    object with ``with_splits`` instead, which carries no caches."""

    name: str
    n_users: int
    n_items: int
    train: List[List[int]]
    val: List[List[int]]
    test: List[List[int]]
    neg_ratio: int = 1
    train_array: np.ndarray = field(init=False)

    def __post_init__(self):
        # user-major, each user's items in list order (the JAX package's
        # per-pair comprehension, vectorized)
        lens = np.fromiter((len(self.train[u]) for u in range(self.n_users)),
                           dtype=np.int64, count=self.n_users)
        users = np.repeat(np.arange(self.n_users, dtype=np.int64), lens)
        items = np.fromiter(
            itertools.chain.from_iterable(self.train[: self.n_users]),
            dtype=np.int64, count=int(lens.sum()),
        )
        self.train_array = np.stack([users, items], axis=1)

    def __len__(self) -> int:
        return len(self.train_array)

    def with_splits(self, train=None, val=None, test=None) -> "Interactions":
        return replace(
            self,
            train=train if train is not None else self.train,
            val=val if val is not None else self.val,
            test=test if test is not None else self.test,
        )
