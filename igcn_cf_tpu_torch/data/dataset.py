"""Host-side interaction dataset container (port of
``igcn_cf_tpu/data/dataset.py``).

Per-user train/val/test item lists plus a flat ``train_array`` of
[user, item] pairs. The container never touches a device; graph and mask
structures are derived from it by the kernels layer. The evaluator memoizes
exclusion and eval-list structures on the instance
(``evaluation/evaluate.py``, ``evaluation/metrics.py``), which is why the
split lists are never mutated in place. ``output`` writes the reference's
text format, which ``data/loaders.load_processed`` reads back, and
``get_dataset`` builds a dataset from a config dict through the
``DATASETS`` registry (the loaders register on the package's import).
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field, replace
from typing import List

import numpy as np

from igcn_cf_tpu_torch.core.registry import DATASETS

# the evaluator's caches that depend on train and val only: exclusion items,
# their packed words and their device copies (evaluation/evaluate.py).
# ``_eval_pad_cache``
# (evaluation/metrics.py) is keyed by split name but built from the split's
# lists, so it is never carried: a derived test split would be scored
# against the old lists.
_TRAIN_VAL_CACHES = ("_exclusion_cache", "_packed_excl_cache")


@dataclass
class Interactions:
    """The split lists must not be mutated in place after construction
    (the evaluator's caches on the instance would go stale); derive a new
    object with ``with_splits`` instead, which carries only the caches that
    stay valid."""

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

    # -- derived host structures -------------------------------------------

    def train_csr(self):
        """Sorted per-user train items as (indptr, indices) int64 arrays."""
        indptr = np.zeros(self.n_users + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.train_array[:, 0], minlength=self.n_users),
                  out=indptr[1:])
        # user-major pairs, each user's items sorted
        order = np.lexsort((self.train_array[:, 1], self.train_array[:, 0]))
        return indptr, self.train_array[order, 1].copy()

    def with_splits(self, train=None, val=None, test=None) -> "Interactions":
        """A new dataset with the given splits replaced. When train and val
        are kept (the inductive slices swap only ``test``), the evaluator's
        exclusion caches are carried over, since they depend on train and
        val alone; no other cache is."""
        out = replace(
            self,
            train=train if train is not None else self.train,
            val=val if val is not None else self.val,
            test=test if test is not None else self.test,
        )
        if train is None and val is None:
            for attr in _TRAIN_VAL_CACHES:
                if attr in self.__dict__:
                    out.__dict__[attr] = self.__dict__[attr]
        return out

    # -- output in the reference text format --------------------------------

    def output(self, path: str) -> None:
        """Write train/val/test.txt in the reference format, one line
        'user item item ...' per user (reference dataset.py:40-44,133-137)."""
        os.makedirs(path, exist_ok=True)
        for split_name in ("train", "val", "test"):
            split = getattr(self, split_name)
            with open(os.path.join(path, split_name + ".txt"), "w") as f:
                for user in range(self.n_users):
                    row = [str(user)] + [str(i) for i in split[user]]
                    f.write(" ".join(row) + "\n")


def get_dataset(config: dict) -> Interactions:
    """The dataset of a config dict, as the reference API takes it
    (reference dataset.py:10-14): ``{'name': 'ProcessedDataset', 'path':
    ..., ...}``, the loader found by name in ``DATASETS``."""
    config = dict(config)
    return DATASETS.get(config.pop("name"))(config)
