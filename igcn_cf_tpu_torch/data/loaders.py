"""Dataset loaders: pre-split text reader and raw-dump parsers (port of
``igcn_cf_tpu/data/loaders.py``).

The reference's data pipeline:

  * ``ProcessedDataset`` — reads ``train.txt/val.txt/test.txt`` where each
    line is ``user item item ...`` and n_items is inferred from the max id
    (reference dataset.py:140-164).
  * Raw parsers for Gowalla check-ins TSV, Yelp review JSON (rating > 3) and
    Amazon-Books ratings CSV (rating > 3), with duplicate interactions keeping
    the earliest timestamp (reference dataset.py:17-44, 167-255).
  * Iterative 10-core filtering (reference dataset.py:66-92) and the
    temporal-or-shuffled 70/10/20 per-user split (reference dataset.py:94-114).

The shuffled split draws from numpy's global RNG as the JAX package does,
so both packages write the same splits under the same ``set_seed``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np

from igcn_cf_tpu_torch import native
from igcn_cf_tpu_torch.core.registry import DATASETS
from igcn_cf_tpu_torch.data.dataset import Interactions


# -- raw-parse helpers (reference dataset.py:17-37) --------------------------


def _update_ui_sets(u, i, user_sets: Dict, item_sets: Dict) -> None:
    user_sets.setdefault(u, set()).add(i)
    item_sets.setdefault(i, set()).add(u)


def _update_inter_lists(u, i, t, user_map, item_map, inter_lists) -> None:
    """Append (item, time) keeping the earliest timestamp for duplicates
    (reference dataset.py:28-37)."""
    if u in user_map and i in item_map:
        lst = inter_lists[user_map[u]]
        mi = item_map[i]
        for entry in lst:
            if entry[0] == mi:
                entry[1] = min(entry[1], t)
                return
        lst.append([mi, t])


def remove_sparse_ui(
    user_sets: Dict, item_sets: Dict, min_inter: int
) -> Tuple[Dict, Dict]:
    """Iterative k-core filter; returns dense user/item id maps (reference
    dataset.py:66-92)."""
    not_stop = True
    while not_stop:
        not_stop = False
        for user in list(user_sets.keys()):
            if len(user_sets[user]) < min_inter:
                not_stop = True
                for item in user_sets[user]:
                    item_sets[item].remove(user)
                user_sets.pop(user)
        for item in list(item_sets.keys()):
            if len(item_sets[item]) < min_inter:
                not_stop = True
                for user in item_sets[item]:
                    user_sets[user].remove(item)
                item_sets.pop(item)
    user_map = {u: idx for idx, u in enumerate(user_sets)}
    item_map = {i: idx for idx, i in enumerate(item_sets)}
    return user_map, item_map


def split_interactions(
    inter_lists: List[List[List[int]]],
    n_users: int,
    n_items: int,
    split_ratio,
    shuffle: bool = False,
    name: str = "raw",
) -> Interactions:
    """Temporal (or shuffled) per-user split with the reference's exact index
    arithmetic: first ``int(n*r_train)`` to train, last ``int(n*r_test)`` to
    test, middle to val (reference dataset.py:94-114)."""
    train: List[List[int]] = [[] for _ in range(n_users)]
    val: List[List[int]] = [[] for _ in range(n_users)]
    test: List[List[int]] = [[] for _ in range(n_users)]
    for user in range(n_users):
        lst = sorted(inter_lists[user], key=lambda e: e[1])
        if shuffle:
            perm = np.random.permutation(len(lst))
            lst = [lst[j] for j in perm]
        n = len(lst)
        n_train = int(n * split_ratio[0])
        n_test = int(n * split_ratio[2])
        # Python negative-slice semantics kept verbatim from the reference
        # (dataset.py:109-111): when n_test == 0, val is empty and test gets
        # the whole list.
        train[user] = [e[0] for e in lst[:n_train]]
        val[user] = [e[0] for e in (lst[n_train:-n_test] if n_test else [])]
        test[user] = [e[0] for e in lst[-n_test:]]
    return Interactions(name, n_users, n_items, train, val, test)


# -- pre-split text format (reference dataset.py:140-164) --------------------


def _read_split(file_path: str) -> Tuple[List[List[int]], int]:
    data: List[List[int]] = []
    n_items = 0
    with open(file_path) as f:
        lines = f.read().strip().split("\n")
    for line in lines:
        items = [int(x) for x in line.split(" ")[1:]]
        if items:
            n_items = max(n_items, max(items) + 1)
        data.append(items)
    return data, n_items


@DATASETS.register("ProcessedDataset")
def load_processed(config: dict) -> Interactions:
    path = config["path"]
    train, n1 = _read_split(os.path.join(path, "train.txt"))
    val, n2 = _read_split(os.path.join(path, "val.txt"))
    test, n3 = _read_split(os.path.join(path, "test.txt"))
    assert len(train) == len(val) == len(test)
    return Interactions(
        name=config.get("dataset_name", os.path.basename(os.path.dirname(path)) or "processed"),
        n_users=len(train),
        n_items=max(n1, n2, n3),
        train=train,
        val=val,
        test=test,
        neg_ratio=int(config.get("neg_ratio", 1)),
    )


# -- raw dataset parsers (reference dataset.py:167-255) ----------------------


class _RawRecords:
    """Vectorized raw-record processing: factorize raw ids to dense codes,
    run the k-core peel and earliest-timestamp dedupe through the native
    (C++) kernels (``igcn_cf_tpu_torch/native``), and build the per-user
    interaction lists.

    Node-id assignment is first-appearance order over the SURVIVING edges
    (the reference enumerates its dict keys in raw insertion order,
    reference dataset.py:84-89 — a node numbering permutation with no effect
    on graph structure or metrics)."""

    def __init__(self, records, min_inter: int):
        raw_u, raw_i, raw_t = [], [], []
        for u, i, t in records:
            raw_u.append(u)
            raw_i.append(i)
            raw_t.append(t)
        u_keys, u_codes = np.unique(np.asarray(raw_u), return_inverse=True)
        i_keys, i_codes = np.unique(np.asarray(raw_i), return_inverse=True)
        times = np.asarray(raw_t, dtype=np.int64)

        keep_idx, tmin = native.dedup_earliest(u_codes, i_codes, times)
        u_codes = u_codes[keep_idx].astype(np.int64)
        i_codes = i_codes[keep_idx].astype(np.int64)
        times = tmin
        keep, user_map_arr, item_map_arr = native.kcore_filter(
            u_codes, i_codes, len(u_keys), len(i_keys), min_inter
        )
        u_codes, i_codes, times = u_codes[keep], i_codes[keep], times[keep]
        self.n_users = int(user_map_arr.max() + 1) if len(u_codes) else 0
        self.n_items = int(item_map_arr.max() + 1) if len(i_codes) else 0
        self.user_map = {
            u_keys[c]: int(user_map_arr[c])
            for c in np.nonzero(user_map_arr >= 0)[0]
        }
        self.item_map = {
            i_keys[c]: int(item_map_arr[c])
            for c in np.nonzero(item_map_arr >= 0)[0]
        }
        self.inter_lists: List[List[List[int]]] = [[] for _ in range(self.n_users)]
        mapped_u = user_map_arr[u_codes]
        mapped_i = item_map_arr[i_codes]
        for u, i, t in zip(mapped_u, mapped_i, times):
            self.inter_lists[u].append([int(i), int(t)])


def _gowalla_records(path: str):
    """Gowalla_totalCheckins.txt: user \t time \t lat \t lon \t item
    (reference dataset.py:171-187)."""
    with open(path) as f:
        for line in f.read().strip().split("\n"):
            u, t, _, _, i = line.strip().split("\t")
            ts = int(time.mktime(time.strptime(t, "%Y-%m-%dT%H:%M:%SZ")))
            yield int(u), int(i), ts


def _yelp_records(path: str):
    """yelp_academic_dataset_review.json, keep stars > 3 (reference
    dataset.py:196-223)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if float(rec["stars"]) > 3.0:
                ts = int(time.mktime(time.strptime(rec["date"], "%Y-%m-%d %H:%M:%S")))
                yield rec["user_id"], rec["business_id"], ts


def _amazon_records(path: str):
    """ratings_Books.csv: user,item,rating,time — keep rating > 3 (reference
    dataset.py:232-253)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            u, i, r, t = line.split(",")
            if float(r) > 3.0:
                yield u, i, int(t)


def _load_raw(config: dict, records_fn, filename: str, name: str) -> Interactions:
    path = os.path.join(config["path"], filename)
    raw = _RawRecords(records_fn(path), int(config["min_inter"]))
    ds = split_interactions(
        raw.inter_lists,
        raw.n_users,
        raw.n_items,
        config["split_ratio"],
        shuffle=bool(config.get("shuffle", False)),
        name=name,
    )
    ds.neg_ratio = int(config.get("neg_ratio", 1))
    return ds


@DATASETS.register("GowallaDataset")
def load_gowalla(config: dict) -> Interactions:
    return _load_raw(config, _gowalla_records, "Gowalla_totalCheckins.txt", "Gowalla")


@DATASETS.register("YelpDataset")
def load_yelp(config: dict) -> Interactions:
    return _load_raw(config, _yelp_records, "yelp_academic_dataset_review.json", "Yelp")


@DATASETS.register("AmazonDataset")
def load_amazon(config: dict) -> Interactions:
    return _load_raw(config, _amazon_records, "ratings_Books.csv", "Amazon")
