"""LightGCN (port of ``igcn_cf_tpu/models/lightgcn.py``).

The reference LightGCN (reference model.py:75-123): one (n_users + n_items,
d) embedding table, the symmetric-normalized adjacency, K propagation rounds
and the mean over layers 0..K; BPR's L2 penalizes the ego (layer-0)
embeddings while scores use the propagated representations; prediction is
users_rep @ items_rep^T.

LightGCN has no dropout, so its propagation operator is fixed for a whole
run: on the propagation-cache engine (``kernels/pcache.py``) a train step
propagates only its 3 * batch rows, P[rows] @ E (K3 forward, K4 backward).
The recompute engine and evaluation run the exact bit-packed propagation
(K1/K2). Only the dense graph backend exists in the port.
"""

from __future__ import annotations

import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.kernels.dense_graph import (
    BipartiteDense,
    choose_backend,
    sym_norm_propagate_mean,
)
from igcn_cf_tpu_torch.kernels.pcache import cached_prop, use_pcache
from igcn_cf_tpu_torch.models.base import Model, l2sq, normal_init


@MODELS.register("LightGCN")
class LightGCN(Model):
    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.backend = choose_backend(
            self.n_users, self.n_items, config.get("graph_backend", "auto"),
            self.device,
        )
        self.pcache = use_pcache(
            self.n_users, self.n_items, self.n_layers,
            config.get("prop_cache", "auto"), self.device,
        )
        self.engine_ab = None  # the measured A/B entry, set by init_buffers

    def init_params(self, generator=None):
        return {
            "embedding": normal_init(
                generator, (self.n_users + self.n_items, self.embedding_size),
                device=self.device,
            )
        }

    def init_buffers(self):
        bip = BipartiteDense.build(self.dataset.train_array, self.n_users,
                                   self.n_items, self.device)
        buffers = {"bip": bip}
        if self.pcache:
            self.attach_pcache(bip, buffers)
        return buffers

    def rep(self, params, buffers, *, train=False, drop=None):
        """(n_users + n_items, d) representations; evaluation runs without
        gradients."""
        with torch.set_grad_enabled(train):
            return sym_norm_propagate_mean(buffers["bip"], params["embedding"],
                                           self.n_layers)

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train,
                   drop=None):
        emb = params["embedding"]
        if train and self.pcache:
            rows = torch.cat([users, self.n_users + pos, self.n_users + neg])
            reps = cached_prop(buffers["pcache"], rows, emb)
            b = users.shape[0]
            u, p, n = reps[:b], reps[b : 2 * b], reps[2 * b :]
        else:
            rep = self.rep(params, buffers, train=train)
            u = rep[users]
            p = rep[self.n_users + pos]
            n = rep[self.n_users + neg]
        # L2 on the ego embeddings, scores on the propagated reps (reference
        # model.py:108-116)
        l2 = (l2sq(emb[users], dim=1) + l2sq(emb[self.n_users + pos], dim=1)
              + l2sq(emb[self.n_users + neg], dim=1))
        return u, p, n, l2

    def rebuild_for(self, new_dataset):
        """dropit's recipe: rebuild the graph only (reference
        run/dropit/lgcn_dropit.py:33-35). The cache is training-only and the
        flows only evaluate after a rebuild, so it is not rebuilt."""
        self.backend = choose_backend(
            new_dataset.n_users, new_dataset.n_items,
            self.config.get("graph_backend", "auto"), self.device,
        )
        self.pcache = False
        return super().rebuild_for(new_dataset)
