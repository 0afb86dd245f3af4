"""Masked full-catalog top-k evaluation (port of
``igcn_cf_tpu/evaluation/evaluate.py``).

The reference protocol (reference trainer.py:140-177): score the whole
catalog for every user, mask the user's train items (plus val items when
testing) and any banned items, take the top k, and compute
Precision/Recall/NDCG against the split's lists. Models are routed by
their ``dot_scored`` class attribute, as in the JAX package:

  * dot-scored models (users_rep @ items_rep^T): representations are
    computed once per evaluation (no dropout at evaluation, so this is
    exact), and retrieval is ``fused_topk_ids`` (kernel K5 on CUDA) over
    packed exclusion words that stay on the device, cached per dataset and
    split;
  * the others (MultiVAE, NeuMF, ItemKNN) score blocks of
    ``test_batch_size`` users with ``model.predict``; each (B, n_items)
    score block is masked by a scatter of -inf into the excluded and
    banned columns and ranked by ``mask_topk`` through ``exact_topk``, the
    JAX package's exact top-k. Every item ranks by one int64 key, its
    score's IEEE total order above the complement of its id, so one
    ``torch.topk`` gives ``lax.top_k``'s order: equal scores lowest item id
    first, +0.0 above -0.0. The JAX package takes the top k of each 1,024
    items first, which on its TPU was faster than one flat ``lax.top_k``;
    on the H100 one ``torch.topk`` over the keys is the faster form
    (``tools/microbench_topk``).

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


def exclusion_ids(ds, split: str, device) -> torch.Tensor:
    """(n_users, W) int64 excluded item ids of ``split`` on ``device``,
    padded with ``n_items`` (one column of padding for 'train'); cached
    per dataset, split and device beside the packed words."""
    cache = ds.__dict__.setdefault("_packed_excl_cache", {})
    key = ("ids", split, str(device))
    ids = cache.get(key)
    if ids is None:
        if split == "train":
            excl = np.full((ds.n_users, 1), ds.n_items, dtype=np.int64)
        else:
            excl, _ = build_exclusion(ds, include_val=(split == "test"))
        ids = cache[key] = torch.as_tensor(excl, dtype=torch.int64).to(device)
    return ids


_LOW = 0xFFFFFFFF  # a rank key's low word: the complement of the item id


def _flip(bits: torch.Tensor) -> torch.Tensor:
    """Between an f32's int32 bits and an int32 in the float's IEEE total
    order (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < NaN), the order
    ``lax.top_k`` ranks by; its own inverse."""
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def total_order(scores: torch.Tensor) -> torch.Tensor:
    """The int32 keys of ``scores`` (as f32) in their IEEE total order."""
    return _flip(scores.float().view(torch.int32))


def rank_keys(scores: torch.Tensor) -> torch.Tensor:
    """(B, n) int64 keys: each score's total order in the high word above
    the complement of its column in the low word. The keys are distinct,
    so the top k of them are the top k scores in ``lax.top_k``'s order,
    equal scores lowest column first, whatever order the device's
    selection leaves ties in."""
    low = _LOW - torch.arange(scores.shape[1], device=scores.device,
                              dtype=torch.int64)
    return torch.add(low, total_order(scores).to(torch.int64), alpha=1 << 32)


def decode_keys(keys: torch.Tensor, dtype: torch.dtype):
    """(values in ``dtype``, int32 columns) of ``rank_keys`` keys."""
    vals = _flip((keys >> 32).to(torch.int32)).view(torch.float32)
    return vals.to(dtype), (_LOW - (keys & _LOW)).to(torch.int32)


def exact_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (B, k), int32 ids (B, k)) of the exact top k over the item
    axis, in ``lax.top_k``'s order (the JAX package's ``exact_topk``): one
    ``torch.topk`` over ``rank_keys``. Needs k <= n."""
    top = torch.topk(rank_keys(scores), k, dim=1).values
    return decode_keys(top, scores.dtype)


def exact_topk_ids(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The int32 ids of ``exact_topk``."""
    return exact_topk(scores, k)[1]


def mask_topk(scores: torch.Tensor, exclude: torch.Tensor,
              banned: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """scores (B, n_items); exclude (B, W) item ids padded with n_items;
    banned (n_items,) bool or None. The (B, k) int32 ids of the top k
    scores after -inf is scattered into the excluded and banned columns,
    ranked by ``exact_topk_ids`` (the JAX package's ``mask_topk_core``)."""
    b, n_items = scores.shape
    ext = torch.cat([scores.float(), scores.new_zeros((b, 1), dtype=torch.float32)],
                    dim=1)
    ext.scatter_(1, exclude, float("-inf"))  # the sentinel column absorbs pads
    masked = ext[:, :n_items]
    if banned is not None:
        masked = masked.masked_fill(banned[None, :], float("-inf"))
    return exact_topk_ids(masked, k)


@torch.no_grad()
def recommend_scored(model, params, buffers, ds, split: str, max_k: int,
                     banned_items: Optional[np.ndarray] = None,
                     test_batch_size: int = 512) -> torch.Tensor:
    """The score-matrix path: (n_users, max_k) int32 ids on the model's
    device, from ``model.predict`` over blocks of ``test_batch_size``
    users."""
    dev = model.device
    exclude = exclusion_ids(ds, split, dev)
    banned = None
    if banned_items is not None:
        banned = torch.zeros(ds.n_items, dtype=torch.bool, device=dev)
        banned[torch.as_tensor(np.asarray(banned_items, np.int64)).to(dev)] = True
    parts = []
    for start in range(0, ds.n_users, test_batch_size):
        users = torch.arange(start, min(start + test_batch_size, ds.n_users),
                             device=dev)
        scores = model.predict(params, buffers, users)
        parts.append(mask_topk(scores, exclude[users], banned, max_k))
    return torch.cat(parts)


def recommend(model, params, buffers, ds, split: str, max_k: int,
              banned_items: Optional[np.ndarray] = None,
              test_batch_size: int = 512) -> torch.Tensor:
    """(n_users, max_k) int32 top item ids on the model's device, never a
    masked or banned item."""
    if not model.dot_scored:
        return recommend_scored(model, params, buffers, ds, split, max_k,
                                banned_items, test_batch_size)
    return fused_topk_ids(*retrieval_inputs(model, params, buffers, ds, split,
                                            banned_items), k=max_k)


def evaluate(model, params, buffers, ds, split: str, topks: Sequence[int],
             banned_items: Optional[np.ndarray] = None,
             test_batch_size: int = 512):
    """(formatted results, metrics dict) for ``split``, as the reference's
    ``BasicTrainer.eval`` returns them."""
    eval_data: List[List[int]] = getattr(ds, split)
    rec = recommend(model, params, buffers, ds, split, max(topks),
                    banned_items, test_batch_size)
    metrics = calculate_metrics_device(rec, eval_data, topks, cache_on=ds,
                                       cache_key=split)
    return format_metrics(metrics, topks), metrics
