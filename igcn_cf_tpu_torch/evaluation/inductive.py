"""Six-slice inductive evaluation protocol (port of
``igcn_cf_tpu/evaluation/inductive.py``).

Reproduces reference ``BasicTrainer.inductive_eval`` (reference
trainer.py:179-219): evaluate the test split over
  all/all, old-users/all, new-users/all, all/old-items, all/new-items and
  old-users/old-items,
by slicing the per-user test lists and banning item-id ranges. The reference
mutates ``dataset.test_data`` in place and restores it; here slices are
derived functionally and the trainer's dataset is swapped per slice (the
evaluator reads ``ds.test``). ``with_splits`` carries the exclusion caches
to each slice (train and val do not change) and builds the slice's eval
lists anew."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _sliced(trainer, test_data: List[List[int]], banned_items=None):
    old = trainer.dataset
    trainer.dataset = old.with_splits(test=test_data)
    try:
        results, metrics = trainer.eval("test", banned_items=banned_items)
    finally:
        trainer.dataset = old
    return results, metrics


def inductive_eval(
    trainer, n_old_users: int, n_old_items: int, verbose: bool = True
) -> Dict[str, Dict]:
    ds = trainer.dataset
    test = ds.test
    out: Dict[str, Dict] = {}

    results, metrics = trainer.eval("test")
    out["all_users_all_items"] = metrics
    if verbose:
        print("All users and all items result. {:s}".format(results))

    sliced = [test[u] if u < n_old_users else [] for u in range(ds.n_users)]
    results, metrics = _sliced(trainer, sliced)
    out["old_users_all_items"] = metrics
    if verbose:
        print("Old users and all items result. {:s}".format(results))

    sliced = [[] if u < n_old_users else test[u] for u in range(ds.n_users)]
    results, metrics = _sliced(trainer, sliced)
    out["new_users_all_items"] = metrics
    if verbose:
        print("New users and all items result. {:s}".format(results))

    old_item = lambda items: [i for i in items if i < n_old_items]
    new_item = lambda items: [i for i in items if i >= n_old_items]

    sliced = [old_item(test[u]) for u in range(ds.n_users)]
    banned = np.arange(n_old_items, ds.n_items)
    results, metrics = _sliced(trainer, sliced, banned)
    out["all_users_old_items"] = metrics
    if verbose:
        print("All users and old items result. {:s}".format(results))

    sliced = [new_item(test[u]) for u in range(ds.n_users)]
    banned = np.arange(n_old_items)
    results, metrics = _sliced(trainer, sliced, banned)
    out["all_users_new_items"] = metrics
    if verbose:
        print("All users and new items result. {:s}".format(results))

    sliced = [
        old_item(test[u]) if u < n_old_users else [] for u in range(ds.n_users)
    ]
    banned = np.arange(n_old_items, ds.n_items)
    results, metrics = _sliced(trainer, sliced, banned)
    out["old_users_old_items"] = metrics
    if verbose:
        print("Old users and old items result. {:s}".format(results))

    return out

