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
(K1/K2). On the sparse graph backend (``choose_backend``) the adjacency is
a COO graph and propagation ``kernels/sparse.propagate_mean``, with no
cache.
"""

from __future__ import annotations

import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.graph.build import sym_norm_adjacency
from igcn_cf_tpu_torch.kernels.dense_graph import (
    BipartiteDense,
    choose_backend,
    sym_norm_propagate_mean,
)
from igcn_cf_tpu_torch.kernels.pcache import cached_prop, use_pcache
from igcn_cf_tpu_torch.kernels.sparse import SparseGraph, propagate_mean
from igcn_cf_tpu_torch.models.base import Model, l2sq, normal_init, take_rows


@MODELS.register("LightGCN")
class LightGCN(Model):
    dot_scored = True  # users_rep @ items_rep^T: fused retrieval (K5)

    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.backend = choose_backend(
            self.n_users, self.n_items, config.get("graph_backend", "auto"),
            self.device,
        )
        # P is built from the bit-packed B, which only the dense backend has
        self.pcache = self.backend == "dense" and use_pcache(
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
        if self.backend == "sparse":
            coo = sym_norm_adjacency(self.dataset.train_array, self.n_users,
                                     self.n_items)
            return {"norm_adj": SparseGraph.from_coo(coo, device=self.device)}
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
            if self.backend == "sparse":
                return propagate_mean(buffers["norm_adj"], params["embedding"],
                                      self.n_layers)
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
            u = take_rows(rep, users)
            p = take_rows(rep, self.n_users + pos)
            n = take_rows(rep, self.n_users + neg)
        # L2 on the ego embeddings, scores on the propagated reps (reference
        # model.py:108-116)
        l2 = (l2sq(take_rows(emb, users), dim=1)
              + l2sq(take_rows(emb, self.n_users + pos), dim=1)
              + l2sq(take_rows(emb, self.n_users + neg), dim=1))
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

    def grow_params(self, params, old_n_users, old_n_items):
        """dropui's recipe: grow the table to the new node count; new rows
        get the MEAN of the old embeddings, and the old user and item rows
        move to their shifted slots (reference
        run/dropui/lgcn_dropui.py:31-38). Call after ``rebuild_for``, which
        sets the new counts."""
        old = params["embedding"].detach()
        new = old.mean(dim=0).expand(self.n_users + self.n_items, -1).clone()
        new[:old_n_users] = old[:old_n_users]
        new[self.n_users : self.n_users + old_n_items] = old[old_n_users:]
        return {"embedding": new}
