"""Distributed exact top-k: a local top-k per item block with GLOBAL ids,
all-gathered along ``table`` and merged (port of
``igcn_cf_tpu/parallel/topk.py``).

Each table rank holds a contiguous block of the items. The merged list is
the exact global top-k by (score descending, item id ascending), the order
of ``lax.top_k`` and of the port's K5. Both top-k's rank through
``evaluation/evaluate.exact_topk``, the score's IEEE total order (+0.0
above -0.0) and then the column: the gathered lists are concatenated in
rank order, each already in that order, so the lower position among equal
scores is the lower global id.
"""

from __future__ import annotations

from typing import Optional

import torch

from igcn_cf_tpu_torch.core.mesh import Mesh, gather_rows
from igcn_cf_tpu_torch.evaluation.evaluate import exact_topk


def local_topk_with_global_ids(scores_local: torch.Tensor, offset: int,
                               k: int):
    """(values, global ids) of the top k of each row of a local score block
    whose column 0 is item ``offset``; equal scores keep the lower id."""
    vals, ids = exact_topk(scores_local, k)
    return vals, ids.long() + offset


def merge_topk(vals_all: torch.Tensor, ids_all: torch.Tensor, k: int):
    """(B, T*k) rank-ordered local lists -> the global (values, ids) top k."""
    vals, pos = exact_topk(vals_all, k)
    return vals, torch.gather(ids_all, 1, pos.long())


def gather_merge(vals: torch.Tensor, ids: torch.Tensor, k: int, mesh: Mesh):
    """All-gather each table rank's sorted (B, k_local) lists and merge them
    into the global top ``k``, the same on every table rank."""
    return merge_topk(gather_rows(vals, mesh, dim=1),
                      gather_rows(ids, mesh, dim=1), k)


@torch.no_grad()
def sharded_topk(users_rep: torch.Tensor, items_rep_shard: torch.Tensor,
                 k: int, mesh: Mesh,
                 exclusion_mask_shard: Optional[torch.Tensor] = None):
    """users_rep (B, d) replicated, items_rep_shard this rank's (I_shard, d)
    block (every rank's block the same size). Returns the global (B, k)
    values and ids, replicated."""
    i_shard = items_rep_shard.shape[0]
    scores = users_rep @ items_rep_shard.T
    if exclusion_mask_shard is not None:
        scores = scores.masked_fill(exclusion_mask_shard, float("-inf"))
    vals, ids = local_topk_with_global_ids(scores, mesh.t * i_shard,
                                           min(k, i_shard))
    return gather_merge(vals, ids, k, mesh)
