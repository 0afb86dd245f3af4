"""Matrix Factorization, BPR-MF (port of ``igcn_cf_tpu/models/mf.py``).

The reference MF (reference model.py:52-72): two embedding tables drawn
normal(std=0.1); the BPR pieces are the raw embeddings with per-row squared
L2; the representation is the two tables stacked, so evaluation scores
users_rep @ items_rep^T through fused retrieval (K5 on CUDA), as for the
other dot-scored models.
"""

from __future__ import annotations

import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.models.base import Model, l2sq, normal_init, take_rows


@MODELS.register("MF")
class MF(Model):
    dot_scored = True  # users_rep @ items_rep^T: fused retrieval (K5)

    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.embedding_size = config["embedding_size"]

    def init_params(self, generator=None):
        d = self.embedding_size
        return {
            "user_embedding": normal_init(generator, (self.n_users, d),
                                          device=self.device),
            "item_embedding": normal_init(generator, (self.n_items, d),
                                          device=self.device),
        }

    def rep(self, params, buffers, *, train=False, drop=None):
        with torch.set_grad_enabled(train):
            return torch.cat([params["user_embedding"],
                              params["item_embedding"]])

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train,
                   drop=None):
        u = take_rows(params["user_embedding"], users)
        p = take_rows(params["item_embedding"], pos)
        n = take_rows(params["item_embedding"], neg)
        l2 = l2sq(u, dim=1) + l2sq(p, dim=1) + l2sq(n, dim=1)
        return u, p, n, l2
