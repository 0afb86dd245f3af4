"""Masked full-catalog top-k evaluation (port of
``igcn_cf_tpu/evaluation/evaluate.py``).

The reference protocol (reference trainer.py:140-177): score the whole
catalog for every user, mask the user's train items (plus val items when
testing) and any banned items, take the top k, and compute
Precision/Recall/NDCG against the split's lists. Here representations are
computed once per evaluation (no dropout at evaluation, so this is exact),
and retrieval is ``fused_topk_ids`` (kernel K5 on CUDA) over packed
exclusion words that stay on the device, cached per dataset and split.
The ids stay on the device for the metric reductions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from igcn_cf_tpu_torch.evaluation.metrics import (
    calculate_metrics_device,
    format_metrics,
)
from igcn_cf_tpu_torch.kernels.bitpack import pad_to
from igcn_cf_tpu_torch.kernels.retrieval import (
    LI,
    NEG,
    fused_topk_ids,
    pack_exclusion_words_device,
)


def build_exclusion(ds, include_val: bool) -> Tuple[np.ndarray, int]:
    """(n_users, W) int32 per-user exclusion items (train, plus val when
    testing), padded with ``n_items``; memoized on the dataset instance."""
    cache = ds.__dict__.setdefault("_exclusion_cache", {})
    if include_val in cache:
        return cache[include_val]
    lists = []
    for u in range(ds.n_users):
        items = list(ds.train[u])
        if include_val:
            items = items + list(ds.val[u])
        lists.append(items)
    width = max(1, max(len(x) for x in lists))
    out = np.full((ds.n_users, width), ds.n_items, dtype=np.int32)
    for u, items in enumerate(lists):
        out[u, : len(items)] = items
    cache[include_val] = (out, width)
    return out, width


def packed_exclusion(ds, split: str, n_items_pad: int,
                     device) -> torch.Tensor:
    """Packed exclusion words for ``split`` on ``device`` (K5's layout):
    none for 'train', train items for 'val', train and val items for
    'test'. Packed on the device once per dataset, split and width."""
    cache = ds.__dict__.setdefault("_packed_excl_cache", {})
    key = (split, n_items_pad, str(device))
    words = cache.get(key)
    if words is None:
        if split == "train":
            words = torch.zeros((ds.n_users, n_items_pad // 32),
                                dtype=torch.int32, device=device)
        else:
            excl, _ = build_exclusion(ds, include_val=(split == "test"))
            rows = np.repeat(np.arange(ds.n_users), excl.shape[1])
            cols = excl.reshape(-1).astype(np.int64)
            live = cols < ds.n_items
            words = pack_exclusion_words_device(
                rows[live], cols[live], ds.n_users, n_items_pad, device=device)
        cache[key] = words
    return words


def retrieval_inputs(model, params, buffers, ds, split: str,
                     banned_items: Optional[np.ndarray] = None):
    """K5's operands for evaluating ``split``: (users_rep (n_users, d),
    items_t (d, n_items_pad), exclusion words, banned_row (1, n_items_pad)),
    all on the model's device."""
    n_users, n_items = ds.n_users, ds.n_items
    dev = model.device
    rep = model.rep(params, buffers, train=False)
    nip = pad_to(n_items, LI)
    users_rep = rep[:n_users].contiguous()
    items_t = torch.zeros((rep.shape[1], nip), dtype=torch.float32, device=dev)
    items_t[:, :n_items] = rep[n_users:].T
    banned_row = torch.zeros((1, nip), dtype=torch.float32, device=dev)
    banned_row[0, n_items:] = NEG
    if banned_items is not None:
        banned_row[0, torch.as_tensor(np.asarray(banned_items, np.int64)).to(dev)] = NEG
    return users_rep, items_t, packed_exclusion(ds, split, nip, dev), banned_row


def recommend(model, params, buffers, ds, split: str, max_k: int,
              banned_items: Optional[np.ndarray] = None) -> torch.Tensor:
    """(n_users, max_k) int32 top item ids on the model's device, never a
    masked or banned item."""
    return fused_topk_ids(*retrieval_inputs(model, params, buffers, ds, split,
                                            banned_items), k=max_k)


def evaluate(model, params, buffers, ds, split: str, topks: Sequence[int],
             banned_items: Optional[np.ndarray] = None):
    """(formatted results, metrics dict) for ``split``, as the reference's
    ``BasicTrainer.eval`` returns them."""
    eval_data: List[List[int]] = getattr(ds, split)
    rec = recommend(model, params, buffers, ds, split, max(topks),
                    banned_items)
    metrics = calculate_metrics_device(rec, eval_data, topks, cache_on=ds,
                                       cache_key=split)
    return format_metrics(metrics, topks), metrics
