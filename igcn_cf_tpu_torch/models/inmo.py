"""INMO inductive template aggregation models (port of
``igcn_cf_tpu/models/inmo.py``): IGCN (INMO-LGCN) and IMF (INMO-MF).

  * Embeddings attach to TEMPLATE (core) users and items plus two shared
    tokens, not to every node. Layer 0 is the INMO feature aggregation: a
    user sums its train items' template embeddings plus the user token, an
    item its train users' plus the item token, each row scaled by
    ``row_sum^((alpha-1)/2 - 1/2)``.
  * IGCN then runs LightGCN-style propagation and takes the mean over
    layers; IMF stops at layer 0.
  * Training drops feature-matrix edges (probability ``dropout``), anneals
    alpha by ``delta`` each epoch, and scores an auxiliary BPR loss on the
    raw template embeddings with the learned vector ``w``.
  * IGCN trains through one of two engines: the propagation cache
    (``kernels/pcache.py``: P = mean_k A^k, built once; a step propagates
    only its batch rows) or recompute (the full K-layer propagation every
    step). Evaluation always runs the exact bit-packed propagation.
  * ``save``/``load`` keep the template maps and alpha, and ``rebuild_for``
    rebuilds the graph from the CURRENT dataset: users and items unseen at
    training time get representations over the old templates, with zero new
    parameters.

Only the dense graph backend exists in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.graph.build import select_templates
from igcn_cf_tpu_torch.kernels.dense_graph import (
    BipartiteDense,
    FeatDrop,
    choose_backend,
    feat_aggregate,
    sym_norm_propagate_mean,
)
from igcn_cf_tpu_torch.kernels.pcache import cached_prop, use_pcache
from igcn_cf_tpu_torch.models.base import Model, l2sq, normal_init


@MODELS.register("IGCN")
class IGCN(Model):
    supports_pcache = True  # the propagation operator is fixed in training

    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.dropout = config.get("dropout", 0.0)
        self.feature_ratio = config["feature_ratio"]
        self.delta = config.get("delta", 0.99)
        self.ranking_metric = config.get("ranking_metric", "sort")
        self.alpha = 1.0
        self.engine_ab = None  # the measured A/B entry, set by init_buffers
        self.backend = choose_backend(
            self.n_users, self.n_items, config.get("graph_backend", "auto"),
            self.device,
        )
        self.pcache = self.supports_pcache and use_pcache(
            self.n_users, self.n_items, self.n_layers,
            config.get("prop_cache", "auto"), self.device,
        )
        self.user_map, self.item_map = select_templates(
            dataset.train_array,
            self.n_users,
            self.n_items,
            self.feature_ratio,
            self.ranking_metric,
        )

    @property
    def n_templates(self) -> int:
        return len(self.user_map) + len(self.item_map) + 2

    def _identity_templates(self) -> bool:
        """True when every user/item is its own template (feature_ratio=1
        keeps identity maps, and a dropui rebuild may ADD non-template
        nodes, so the maps are checked against the current counts)."""
        return (
            self.feature_ratio >= 1.0
            and len(self.user_map) == self.n_users
            and len(self.item_map) == self.n_items
        )

    def init_params(self, generator=None):
        return {
            "embedding": normal_init(
                generator, (self.n_templates, self.embedding_size),
                device=self.device,
            ),
            "w": torch.ones(self.embedding_size, dtype=torch.float32,
                            device=self.device),
        }

    def init_buffers(self):
        return self._init_buffers_dense()

    def _init_buffers_dense(self, build_pcache: bool = True):
        """One bit-packed B serves the adjacency and the feature matrix;
        template selection becomes a zero-padded embedding scatter. With the
        cache engine on, P is built (and, for 'auto' on CUDA, the engines
        A/B-measured) unless ``build_pcache`` is False."""
        arr = self.dataset.train_array
        bip = BipartiteDense.build(arr, self.n_users, self.n_items, self.device)
        core_u = np.array(
            sorted(self.user_map, key=self.user_map.get), dtype=np.int64
        )
        core_i = np.array(
            sorted(self.item_map, key=self.item_map.get), dtype=np.int64
        )
        in_u = np.zeros(self.n_users, dtype=np.float32)
        in_u[core_u] = 1.0
        in_i = np.zeros(self.n_items, dtype=np.float32)
        in_i[core_i] = 1.0
        # feature row sums: core train neighbors + the token edge
        rs_u = np.ones(self.n_users, dtype=np.float32)
        rs_i = np.ones(self.n_items, dtype=np.float32)
        np.add.at(rs_u, arr[:, 0], in_i[arr[:, 1]])
        np.add.at(rs_i, arr[:, 1], in_u[arr[:, 0]])
        dev = self.device
        buffers = {
            "bip": bip,
            "core_user_ids": torch.as_tensor(core_u).to(dev),
            "core_item_ids": torch.as_tensor(core_i).to(dev),
            "feat_rowsum_u": torch.as_tensor(rs_u).to(dev),
            "feat_rowsum_i": torch.as_tensor(rs_i).to(dev),
            "alpha": torch.tensor(self.alpha, dtype=torch.float32, device=dev),
        }
        if self.pcache and build_pcache:
            self.attach_pcache(bip, buffers)
        return buffers

    # -- representation -----------------------------------------------------

    def draw_drop(self, keys, generator):
        """The step's feature-matrix dropout: two u32 mask seeds from the
        host ``keys`` and the token-edge keeps from the device
        ``generator``."""
        if self.dropout <= 0.0:
            return None
        keep = 1.0 - self.dropout
        dev = self.device
        return FeatDrop(
            keys.next_seed(), keys.next_seed(),
            torch.rand(self.n_users, generator=generator, device=dev) < keep,
            torch.rand(self.n_items, generator=generator, device=dev) < keep,
        )

    def _inductive_rep_dense(self, params, buffers, drop=None):
        """Layer 0: the INMO feature aggregation over template embeddings,
        with the edge dropout of ``drop`` when given."""
        emb = params["embedding"]
        n_cu = len(self.user_map)
        n_ci = len(self.item_map)
        d = self.embedding_size
        if self._identity_templates():
            e_users_full = emb[:n_cu]
            e_items_full = emb[n_cu : n_cu + n_ci]
        else:
            e_users_full = emb.new_zeros((self.n_users, d)).index_copy(
                0, buffers["core_user_ids"], emb[:n_cu]
            )
            e_items_full = emb.new_zeros((self.n_items, d)).index_copy(
                0, buffers["core_item_ids"], emb[n_cu : n_cu + n_ci]
            )
        # f32 arithmetic, as the JAX package computes the exponent
        exponent = (buffers["alpha"] - 1.0) / 2.0 - 0.5
        w_u = torch.pow(buffers["feat_rowsum_u"], exponent)
        w_i = torch.pow(buffers["feat_rowsum_i"], exponent)
        return feat_aggregate(
            buffers["bip"],
            e_items_full,
            e_users_full,
            emb[n_cu + n_ci],
            emb[n_cu + n_ci + 1],
            w_u,
            w_i,
            dropout=self.dropout if drop is not None else 0.0,
            drop=drop,
        )

    def _propagate(self, buffers, x0):
        return sym_norm_propagate_mean(buffers["bip"], x0, self.n_layers)

    def rep(self, params, buffers, *, train=False, drop=None):
        """(n_users + n_items, d) representations. ``train`` keeps the
        autograd graph and applies ``drop``; evaluation runs without
        gradients or dropout."""
        if train:
            return self._propagate(
                buffers, self._inductive_rep_dense(params, buffers, drop))
        with torch.no_grad():
            return self._propagate(buffers,
                                   self._inductive_rep_dense(params, buffers))

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train,
                   drop=None):
        if train and self.pcache:
            # the cache engine: only the 3 * batch rows are propagated, by
            # K3 forward and K4 backward; X0 (the dropped inductive layer)
            # is the only full-graph work left in the step
            x0 = self._inductive_rep_dense(params, buffers, drop)
            rows = torch.cat([users, self.n_users + pos, self.n_users + neg])
            reps = cached_prop(buffers["pcache"], rows, x0)
            b = users.shape[0]
            u, p, n = reps[:b], reps[b : 2 * b], reps[2 * b :]
        else:
            rep = self.rep(params, buffers, train=train, drop=drop)
            u = rep[users]
            p = rep[self.n_users + pos]
            n = rep[self.n_users + neg]
        # L2 on propagated reps, as IGCN borrows NGCF.bpr_forward
        # (reference model.py:448-449 -> 293-299)
        l2 = l2sq(u, dim=1) + l2sq(p, dim=1) + l2sq(n, dim=1)
        return u, p, n, l2

    def aux_scores(self, params, users, pos, neg):
        """The self-enhanced auxiliary loss's scores on raw template
        embeddings, weighted by ``w`` (reference trainer.py:304-311);
        users/pos/neg are template-space ids."""
        emb = params["embedding"]
        n_core_users = len(self.user_map)
        u = emb[users]
        w = params["w"][None, :]
        return (torch.sum(u * emb[pos + n_core_users] * w, dim=1),
                torch.sum(u * emb[neg + n_core_users] * w, dim=1))

    def epoch_update(self, buffers):
        """The per-epoch anneal alpha <- alpha * delta (reference
        model.py:379-381)."""
        self.alpha *= self.delta
        return dict(buffers, alpha=torch.tensor(
            self.alpha, dtype=torch.float32, device=self.device))

    # -- inductive contract -------------------------------------------------

    def rebuild_for(self, new_dataset):
        """Keep user_map/item_map, alpha and parameters; rebuild the graph
        and feature structures from the new dataset. New users/items get
        feature rows over the OLD templates. The cache is training-only and
        is not rebuilt: re-create the model to train on the new dataset."""
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        self.backend = choose_backend(
            self.n_users, self.n_items,
            self.config.get("graph_backend", "auto"), self.device,
        )
        self.pcache = False
        return self.init_buffers()

    def extra_state(self):
        return {
            "user_map": self.user_map,
            "item_map": self.item_map,
            "alpha": self.alpha,
        }

    def load_extra_state(self, state):
        """The saved template maps define the embedding rows; the current
        dataset provides the interactions."""
        self.user_map = state["user_map"]
        self.item_map = state["item_map"]
        self.alpha = state["alpha"]

    def refresh_buffers(self, buffers):
        """After ``load``, re-derive the buffers from the CURRENT dataset
        with the loaded template maps and alpha. The propagation cache is
        reused only when the interaction graph is the same graph: equal
        edge-set fingerprints (``BipartiteDense.fingerprint``), not merely
        equal shapes and edge counts, so a different graph with the same
        counts gets its own P. Reuse avoids a second multi-GB P next to the
        live one."""
        old_p = buffers.get("pcache")
        old_bip = buffers.get("bip")
        new = self._init_buffers_dense(build_pcache=False)
        if not self.pcache:
            return new
        if (old_p is not None and old_bip is not None
                and old_bip.fingerprint == new["bip"].fingerprint):
            new["pcache"] = old_p
            return new
        return self._init_buffers_dense()


@MODELS.register("IMF")
class IMF(IGCN):
    """INMO-MF: the representation is the inductive layer only, so there is
    no propagation operator to cache."""

    supports_pcache = False

    def _propagate(self, buffers, x0):
        return x0
