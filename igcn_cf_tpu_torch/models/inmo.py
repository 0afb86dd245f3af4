"""INMO inductive template aggregation models, evaluation path (port of
``igcn_cf_tpu/models/inmo.py``): IGCN (INMO-LGCN) and IMF (INMO-MF).

  * Embeddings attach to TEMPLATE (core) users and items plus two shared
    tokens, not to every node. Layer 0 is the INMO feature aggregation: a
    user sums its train items' template embeddings plus the user token, an
    item its train users' plus the item token, each row scaled by
    ``row_sum^((alpha-1)/2 - 1/2)``.
  * IGCN then runs LightGCN-style propagation and takes the mean over
    layers; IMF stops at layer 0.
  * ``save``/``load`` keep the template maps and alpha, and ``rebuild_for``
    rebuilds the graph from the CURRENT dataset: users and items unseen at
    training time get representations over the old templates, with zero new
    parameters.

Only the dense graph backend exists in the port, and no training: no edge
dropout, alpha anneal, propagation cache or BPR pieces yet.
"""

from __future__ import annotations

import numpy as np
import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.graph.build import select_templates
from igcn_cf_tpu_torch.kernels.dense_graph import (
    BipartiteDense,
    choose_backend,
    feat_aggregate,
    sym_norm_propagate_mean,
)
from igcn_cf_tpu_torch.models.base import Model, normal_init


@MODELS.register("IGCN")
class IGCN(Model):
    def __init__(self, config, dataset, device="cpu"):
        super().__init__(config, dataset, device)
        if config.get("prop_cache") is True:
            raise NotImplementedError("the propagation cache is not ported")
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.feature_ratio = config["feature_ratio"]
        self.ranking_metric = config.get("ranking_metric", "sort")
        self.alpha = 1.0
        self.backend = choose_backend(
            self.n_users, self.n_items, config.get("graph_backend", "auto"),
            self.device,
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

    def _init_buffers_dense(self):
        """One bit-packed B serves the adjacency and the feature matrix;
        template selection becomes a zero-padded embedding scatter."""
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
        return {
            "bip": bip,
            "core_user_ids": torch.as_tensor(core_u).to(dev),
            "core_item_ids": torch.as_tensor(core_i).to(dev),
            "feat_rowsum_u": torch.as_tensor(rs_u).to(dev),
            "feat_rowsum_i": torch.as_tensor(rs_i).to(dev),
            "alpha": torch.tensor(self.alpha, dtype=torch.float32, device=dev),
        }

    # -- representation -----------------------------------------------------

    def _inductive_rep_dense(self, params, buffers):
        """Layer 0: the INMO feature aggregation over template embeddings."""
        emb = params["embedding"]
        n_cu = len(self.user_map)
        n_ci = len(self.item_map)
        d = self.embedding_size
        if self._identity_templates():
            e_users_full = emb[:n_cu]
            e_items_full = emb[n_cu : n_cu + n_ci]
        else:
            e_users_full = emb.new_zeros((self.n_users, d)).index_copy_(
                0, buffers["core_user_ids"], emb[:n_cu]
            )
            e_items_full = emb.new_zeros((self.n_items, d)).index_copy_(
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
        )

    def rep(self, params, buffers, *, train=False):
        if train:
            raise NotImplementedError("IGCN training is not ported yet")
        with torch.no_grad():
            x0 = self._inductive_rep_dense(params, buffers)
            return sym_norm_propagate_mean(buffers["bip"], x0, self.n_layers)

    # -- inductive contract -------------------------------------------------

    def rebuild_for(self, new_dataset):
        """Keep user_map/item_map, alpha and parameters; rebuild the graph
        and feature structures from the new dataset. New users/items get
        feature rows over the OLD templates."""
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        self.backend = choose_backend(
            self.n_users, self.n_items,
            self.config.get("graph_backend", "auto"), self.device,
        )
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


@MODELS.register("IMF")
class IMF(IGCN):
    """INMO-MF: the representation is the inductive layer only."""

    def rep(self, params, buffers, *, train=False):
        if train:
            raise NotImplementedError("IMF training is not ported yet")
        with torch.no_grad():
            return self._inductive_rep_dense(params, buffers)
