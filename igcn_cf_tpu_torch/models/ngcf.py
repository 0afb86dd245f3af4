"""NGCF, Neural Graph Collaborative Filtering (port of
``igcn_cf_tpu/models/ngcf.py``).

The reference NGCF (reference model.py:233-302): a kaiming-uniform
embedding table; the L1-row-normalized adjacency A + I; per layer the
message m0 = (A + I) X / (deg + 1), the bilinear term m1 = X * m0, two
linear layers, leaky ReLU (slope 0.2), feature dropout, L2 row
normalization, and the CONCAT of every layer's output with layer 0, so the
representation is (n, d + sum(layer_sizes)). Training drops edges of the
adjacency and its self-loops once per forward, the same drop in every
layer, inside kernels K6m/K7m (``ngcf_propagate``); BPR's L2 is taken on
the concatenated propagated reps. On the sparse graph backend
(``choose_backend``) the adjacency is the COO graph of
``l1_norm_adjacency_with_self_loops``, each layer's message ``spmm``, and
the step's edge drop one ``EdgeKeep`` over its padded entries, shared by
every layer (``edge_dropout_vals``).

Each layer is two spans (``utils/spans``), ``n_layers`` of each a forward:
``model.propagate`` around the message m0 (K6m/K7m or the sparse product,
the self-loops, the rescale and the degree division) and
``model.transform`` around the rest of the layer.
"""

from __future__ import annotations

from typing import List, NamedTuple, Union

import torch
import torch.nn.functional as F

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.graph.build import l1_norm_adjacency_with_self_loops
from igcn_cf_tpu_torch.kernels.dense_graph import (
    BipartiteDense,
    FeatDrop,
    choose_backend,
    ngcf_propagate,
)
from igcn_cf_tpu_torch.kernels.sparse import (
    EdgeKeep,
    SparseGraph,
    draw_edge_keep,
    edge_dropout_vals,
    spmm,
)
from igcn_cf_tpu_torch.models.base import (
    Model,
    kaiming_uniform,
    l2sq,
    linear_apply,
    linear_init,
    take_rows,
)
from igcn_cf_tpu_torch.utils.spans import span


class NGCFDrop(NamedTuple):
    """One train step's dropout draw: ``edge``, the adjacency's edge and
    self-loop drop that every layer reuses (the JAX package reuses one
    ``k_edge``): mask seeds and self-loop keeps on the dense backend, an
    ``EdgeKeep`` on the sparse one; and ``feat``, one (n, layer_size) bool
    keep per layer."""

    edge: Union[FeatDrop, EdgeKeep]
    feat: List[torch.Tensor]


@MODELS.register("NGCF")
class NGCF(Model):
    dot_scored = True  # users_rep @ items_rep^T: fused retrieval (K5)

    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.embedding_size = config["embedding_size"]
        self.layer_sizes = list(config["layer_sizes"])
        self.dropout = config["dropout"]
        self.n_layers = len(self.layer_sizes)
        self.backend = choose_backend(
            self.n_users, self.n_items, config.get("graph_backend", "auto"),
            self.device,
        )

    def init_params(self, generator=None):
        n = self.n_users + self.n_items
        params = {"embedding": kaiming_uniform(
            generator, (n, self.embedding_size), self.device)}
        sizes = [self.embedding_size] + self.layer_sizes
        params["gc_layers"] = [
            linear_init(generator, sizes[i], sizes[i + 1], self.device)
            for i in range(self.n_layers)]
        params["bi_layers"] = [
            linear_init(generator, sizes[i], sizes[i + 1], self.device)
            for i in range(self.n_layers)]
        return params

    def init_buffers(self):
        arr = self.dataset.train_array
        if self.backend == "sparse":
            g = SparseGraph.from_coo(
                l1_norm_adjacency_with_self_loops(arr, self.n_users,
                                                  self.n_items),
                device=self.device)
            self.edge_nnz = g.nnz  # the length of a step's EdgeKeep
            return {"norm_adj": g}
        # B^T packed as well: every masked B^T product of a step (the
        # forward's K7m and K6m's gradient) takes K7m's rows route
        return {"bip": BipartiteDense.build(arr, self.n_users, self.n_items,
                                            self.device, transposed=True)}

    def draw_drop(self, keys, generator):
        """The step's draw. Dense: two u32 edge-mask seeds from the host
        ``keys``, the self-loop keeps from the device ``generator``; sparse:
        an ``EdgeKeep`` from ``generator``. Then the feature keeps from
        ``generator``."""
        if self.dropout <= 0.0:
            return None
        keep = 1.0 - self.dropout
        dev = self.device
        n = self.n_users + self.n_items
        if self.backend == "sparse":
            edge = draw_edge_keep(self.edge_nnz, self.dropout, generator, dev)
        else:
            edge = FeatDrop(
                keys.next_seed(), keys.next_seed(),
                torch.rand(self.n_users, generator=generator, device=dev) < keep,
                torch.rand(self.n_items, generator=generator, device=dev) < keep,
            )
        feat = [torch.rand((n, size), generator=generator, device=dev) < keep
                for size in self.layer_sizes]
        return NGCFDrop(edge, feat)

    def _message(self, buffers, drop):
        """The layers' message function m0(x): (A + I) x / (deg + 1) under
        the step's one edge drop."""
        if self.backend == "sparse":
            g = buffers["norm_adj"]
            if drop is not None:
                g = g.with_vals(edge_dropout_vals(g, self.dropout,
                                                  keep=drop.edge.keep))
            return lambda x: spmm(g, x)
        bip = buffers["bip"]
        edge = None if drop is None else drop.edge
        return lambda x: ngcf_propagate(bip, x, dropout=self.dropout,
                                        drop=edge)

    def _rep(self, params, buffers, drop):
        message = self._message(buffers, drop)
        x = params["embedding"]
        outs = [x]
        for i in range(self.n_layers):
            with span("model.propagate"):
                m0 = message(x)
            with span("model.transform"):
                h = (linear_apply(params["gc_layers"][i], m0)
                     + linear_apply(params["bi_layers"][i], x * m0))
                h = F.leaky_relu(h, negative_slope=0.2)
                if drop is not None:
                    h = torch.where(drop.feat[i], h / (1.0 - self.dropout),
                                    0.0)
                x = h
                norm = torch.sqrt(torch.clamp(l2sq(h, dim=1),
                                              min=1e-24))[:, None]
                outs.append(h / norm)
        return torch.cat(outs, dim=1)

    def rep(self, params, buffers, *, train=False, drop=None):
        """(n_users + n_items, d + sum(layer_sizes)) representations.
        ``train`` keeps the autograd graph and applies ``drop``; evaluation
        runs without gradients or dropout."""
        with torch.set_grad_enabled(train):
            return self._rep(params, buffers, drop if train else None)

    def bpr_pieces(self, params, buffers, users, pos, neg, *, train,
                   drop=None):
        rep = self.rep(params, buffers, train=train, drop=drop)
        u = take_rows(rep, users)
        p = take_rows(rep, self.n_users + pos)
        n = take_rows(rep, self.n_users + neg)
        # L2 on the propagated reps (reference model.py:293-299)
        l2 = l2sq(u, dim=1) + l2sq(p, dim=1) + l2sq(n, dim=1)
        return u, p, n, l2
