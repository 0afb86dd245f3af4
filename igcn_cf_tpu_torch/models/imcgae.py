"""IMCGAE, the inductive matrix-completion GAE baseline (port of
``igcn_cf_tpu/models/imcgae.py``).

The reference IMCGAE (reference model.py:546-591): per-node embeddings plus
three shared role embeddings ("identical", "general user", "general
item"); a node's representation is the 3d concat [personal, role,
identical]; each of K propagation layers applies node dropout with
probability ``dropout - 0.1*i``, one step of the sym-normalized adjacency
and the scale ``1/(i+2)``; the final representation is the SUM over the
layers, not the mean.

Both graph backends: the dense one propagates through the bit-packed B
(``sym_norm_propagate``: kernels K6/K7 at d = 3 * embedding_size, their
gradients through the other orientation), the sparse one through
``kernels/sparse.spmm`` over ``sym_norm_adjacency``. Node dropout is a row
mask per layer, drawn by ``draw_drop`` (``IMCGAEDrop``) and exact in either
backend.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.graph.build import sym_norm_adjacency
from igcn_cf_tpu_torch.kernels.dense_graph import (
    BipartiteDense,
    choose_backend,
    sym_norm_propagate,
)
from igcn_cf_tpu_torch.kernels.sparse import SparseGraph, spmm
from igcn_cf_tpu_torch.models.base import Model, l2sq, normal_init, take_rows


class IMCGAEDrop(NamedTuple):
    """One train step's node dropout: a (n_users + n_items,) bool keep per
    layer. The JAX package draws layer i's from ``split(key)`` in turn."""

    keep: List[torch.Tensor]


@MODELS.register("IMCGAE")
class IMCGAE(Model):
    dot_scored = True  # users_rep @ items_rep^T: fused retrieval (K5)

    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.dropout = config["dropout"]
        self.backend = self._choose_backend()

    def _choose_backend(self) -> str:
        return choose_backend(self.n_users, self.n_items,
                              self.config.get("graph_backend", "auto"),
                              self.device)

    def init_params(self, generator=None):
        return {"embedding": normal_init(
            generator, (self.n_users + self.n_items + 3, self.embedding_size),
            device=self.device)}

    def init_buffers(self):
        arr = self.dataset.train_array
        if self.backend == "dense":
            return {"bip": BipartiteDense.build(arr, self.n_users, self.n_items,
                                                self.device)}
        coo = sym_norm_adjacency(arr, self.n_users, self.n_items)
        return {"norm_adj": SparseGraph.from_coo(coo, device=self.device)}

    def draw_drop(self, keys, generator):
        """The step's node keeps, one per layer, drawn on the device."""
        if self.dropout <= 0.0:
            return None
        n = self.n_users + self.n_items
        return IMCGAEDrop([
            torch.rand(n, generator=generator, device=self.device)
            < 1.0 - (self.dropout - 0.1 * i) for i in range(self.n_layers)])

    def _propagate(self, buffers, x):
        if self.backend == "dense":
            return sym_norm_propagate(buffers["bip"], x)
        return spmm(buffers["norm_adj"], x)

    def rep(self, params, buffers, *, train=False, drop=None):
        """(n_users + n_items, 3d) representations; ``train`` keeps the
        autograd graph and applies ``drop``."""
        with torch.set_grad_enabled(train):
            emb = params["embedding"]
            n, m, d = self.n_users, self.n_items, self.embedding_size
            identical, general_u, general_i = emb[n + m], emb[n + m + 1], emb[n + m + 2]
            u_rep = torch.cat([emb[:n], general_u.expand(n, d),
                               identical.expand(n, d)], dim=1)
            i_rep = torch.cat([emb[n : n + m], general_i.expand(m, d),
                               identical.expand(m, d)], dim=1)
            x = torch.cat([u_rep, i_rep])
            acc = x
            for i in range(self.n_layers):
                if train and drop is not None:
                    # per-layer node dropout (reference model.py:578-580)
                    p = self.dropout - 0.1 * i
                    x = torch.where(drop.keep[i][:, None], x / (1.0 - p), 0.0)
                x = self._propagate(buffers, x)
                acc = acc + x / float(i + 2)
            return acc

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train,
                   drop=None):
        rep = self.rep(params, buffers, train=train, drop=drop)
        u = take_rows(rep, users)
        p = take_rows(rep, self.n_users + pos)
        n = take_rows(rep, self.n_users + neg)
        l2 = l2sq(u, dim=1) + l2sq(p, dim=1) + l2sq(n, dim=1)
        return u, p, n, l2

    def rebuild_for(self, new_dataset):
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        self.backend = self._choose_backend()
        return self.init_buffers()

    def grow_params(self, params, old_n_users, old_n_items):
        """dropui's recipe: new personal rows get the mean of the old
        personal embeddings, the 3 shared role rows are kept, and the old
        user and item rows move to their slots (reference
        run/dropui/imc_gae_dropui.py:31-38). Call after ``rebuild_for``."""
        old = params["embedding"].detach()
        new = old[:-3].mean(dim=0).expand(
            self.n_users + self.n_items + 3, -1).clone()
        new[-3:] = old[-3:]
        new[:old_n_users] = old[:old_n_users]
        new[self.n_users : self.n_users + old_n_items] = old[old_n_users:-3]
        return {"embedding": new}
