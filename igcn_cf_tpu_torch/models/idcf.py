"""IDCF-LGCN, the inductive baseline with relation attention over key users
(port of ``igcn_cf_tpu/models/idcf.py``).

The reference IDCF_LGCN (reference model.py:126-230):

  * a FROZEN pretrained LightGCN embedding table read from ``lgcn_path``
    (reference model.py:152-155), a buffer here, so the optimizer never
    touches it. The file is the checkpoint pickle both packages write
    (``Model.save``); where it is missing, ``_pretrain_lgcn`` trains the
    port's LightGCN on the current dataset and writes it there;
  * query representations x_q = feat @ emb, with feat the bipartite
    adjacency restricted to old-user/old-item columns (reference
    model.py:168-181);
  * ``n_headers`` RelationGAT heads: each attends x_q over the frozen
    embeddings of ``n_samples`` sampled old users/items (reference
    model.py:126-139,183-191); the heads concat through w_out;
  * the contrastive loss logsumexp(sim to the sampled keys) - self-sim,
    on the LAST head's samples (reference model.py:193-202: the loop
    variable's reuse is reference behavior, kept);
  * LightGCN propagation with the layer mean after it, on the sparse COO
    path (``kernels/sparse.py``);
  * BPR's L2 adds every head's wq/wk Frobenius norms (model.py:224-226);
  * ``rebuild_for`` (the base one) rebuilds norm_adj and feat over a grown
    graph while n_old_users/items and the frozen table stay fixed
    (reference run/dropit/idcf_dropit.py, run/dropui/idcf_dropui.py).

The key samples are an explicit draw (``IDCFDraw``): a training step's
from ``draw_drop`` on the device; evaluation's from a fixed seed of the
port's own (``EVAL_SEED``), drawn on the host, so it is the same on any
device. That stream is not the JAX package's ``PRNGKey(0)`` stream.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import List, NamedTuple

import numpy as np
import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.graph.build import (
    COO,
    bipartite_adjacency,
    sym_norm_adjacency,
)
from igcn_cf_tpu_torch.kernels.sparse import SparseGraph, propagate_mean, spmm
from igcn_cf_tpu_torch.models.base import (
    Model,
    l2sq,
    linear_apply,
    linear_init,
    take_rows,
)

EVAL_SEED = 0  # the evaluation's key samples


class IDCFDraw(NamedTuple):
    """The sampled keys of every head: ``su[h]`` (n_samples,) old-user ids,
    ``si[h]`` (n_samples,) old-item ids."""

    su: List[torch.Tensor]
    si: List[torch.Tensor]


@MODELS.register("IDCF_LGCN")
class IDCF_LGCN(Model):
    dot_scored = True  # users_rep @ items_rep^T: fused retrieval (K5)

    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.embedding_size = config["embedding_size"]
        self.n_layers = config["n_layers"]
        self.n_headers = config["n_headers"]
        self.n_samples = config.get("n_samples", 50)
        self.lgcn_path = config["lgcn_path"]
        self.n_old_users = self.n_users
        self.n_old_items = self.n_items

    def init_params(self, generator=None):
        d = self.embedding_size
        heads = [{name: linear_init(generator, d, d, self.device)
                  for name in ("wq", "wk", "wv")}
                 for _ in range(self.n_headers)]
        return {"heads": heads,
                "w_out": linear_init(generator, d * self.n_headers, d,
                                     self.device)}

    def _load_frozen_embedding(self) -> torch.Tensor:
        if not os.path.exists(self.lgcn_path):
            self._pretrain_lgcn()
        with open(self.lgcn_path, "rb") as f:
            blob = pickle.load(f)
        return torch.as_tensor(np.asarray(blob["params"]["embedding"],
                                          np.float32)).to(self.device)

    def _pretrain_lgcn(self) -> None:
        """Train LightGCN on the current dataset (BPR, early-stopped) and
        save it at ``lgcn_path``, as the JAX package does where the
        reference would crash. ``lgcn_pretrain_epochs`` /
        ``lgcn_pretrain_patience`` / ``lgcn_pretrain_val_interval`` set the
        budget."""
        from igcn_cf_tpu_torch.models.base import get_model
        from igcn_cf_tpu_torch.train.trainer import get_trainer

        print(f"[idcf] no LightGCN checkpoint at {self.lgcn_path!r}; "
              "pretraining one (reference expects run --config 1 output)",
              file=sys.stderr, flush=True)
        mc = {"name": "LightGCN", "embedding_size": self.embedding_size,
              "n_layers": self.n_layers}
        tc = {
            "name": "BPRTrainer",
            "optimizer": "Adam",
            "lr": 1e-3,
            "l2_reg": 1e-4,
            "n_epochs": int(self.config.get("lgcn_pretrain_epochs", 200)),
            "batch_size": int(self.config.get("batch_size", 2048)),
            "test_batch_size": 512,
            "topks": [20],
            "val_interval": int(self.config.get("lgcn_pretrain_val_interval", 10)),
            "max_patience": int(self.config.get("lgcn_pretrain_patience", 5)),
        }
        lgcn = get_model(mc, self.dataset, self.device)
        trainer = get_trainer(tc, self.dataset, lgcn)
        trainer.train(verbose=False)
        lgcn.save(self.lgcn_path, trainer.params)

    def init_buffers(self):
        adj = sym_norm_adjacency(self.dataset.train_array, self.n_users,
                                 self.n_items)
        return {
            "norm_adj": SparseGraph.from_coo(adj, device=self.device),
            "feat": SparseGraph.from_coo(self._generate_feat(),
                                         device=self.device),
            "embedding": self._load_frozen_embedding(),
        }

    def _generate_feat(self) -> COO:
        """Adjacency columns restricted to old users / old items (reference
        model.py:168-172): column u stays at u for u < n_old_users; column
        n_users + i maps to n_old_users + i for i < n_old_items."""
        adj = bipartite_adjacency(self.dataset.train_array, self.n_users,
                                  self.n_items)
        cols = adj.cols
        keep_user = cols < self.n_old_users
        item_col = (cols >= self.n_users) & (cols < self.n_users + self.n_old_items)
        keep = keep_user | item_col
        new_cols = np.where(
            keep_user, cols, self.n_old_users + (cols - self.n_users)
        ).astype(np.int32)
        return COO(
            adj.rows[keep],
            new_cols[keep],
            adj.vals[keep],
            (self.n_users + self.n_items, self.n_old_users + self.n_old_items),
        ).sort_by_row()

    # -- key samples ----------------------------------------------------------

    def _draw(self, generator, device) -> IDCFDraw:
        su, si = [], []
        for _ in range(self.n_headers):
            su.append(torch.randint(0, self.n_old_users, (self.n_samples,),
                                    generator=generator, device=device))
            si.append(torch.randint(0, self.n_old_items, (self.n_samples,),
                                    generator=generator, device=device))
        return IDCFDraw(su, si)

    def draw_drop(self, keys, generator):
        """A train step's key samples, drawn on the device."""
        return self._draw(generator, self.device)

    def eval_draw(self) -> IDCFDraw:
        """The evaluation's key samples: the same every call."""
        draw = self._draw(torch.Generator().manual_seed(EVAL_SEED), "cpu")
        return IDCFDraw([t.to(self.device) for t in draw.su],
                        [t.to(self.device) for t in draw.si])

    # -- attention ------------------------------------------------------------

    @staticmethod
    def _gat_head(head, x, neighbors):
        """RelationGAT (reference model.py:126-139): softmax over the sampled
        keys, value-projected mixture."""
        q = linear_apply(head["wq"], x)  # (N, d)
        k = linear_apply(head["wk"], neighbors)  # (S, d)
        attn = torch.softmax(q @ k.T, dim=1)  # (N, S)
        return linear_apply(head["wv"], attn @ neighbors)

    def _rep_and_contrastive(self, params, buffers, draw: IDCFDraw,
                             want_contrastive: bool):
        emb = buffers["embedding"]
        x_q = spmm(buffers["feat"], emb)
        n = self.n_users
        outs = []
        for h in range(self.n_headers):
            sampled_user_embs = emb[draw.su[h]]
            sampled_item_embs = emb[self.n_old_users + draw.si[h]]
            head = params["heads"][h]
            outs.append(torch.cat([
                self._gat_head(head, x_q[:n], sampled_user_embs),
                self._gat_head(head, x_q[n:], sampled_item_embs)]))
        representations = linear_apply(params["w_out"], torch.cat(outs, dim=1))

        contrastive = None
        if want_contrastive:
            u_rep, i_rep = representations[:n], representations[n:]
            u_loss = (torch.logsumexp(u_rep @ sampled_user_embs.T, dim=1)
                      - torch.sum(u_rep * emb[: self.n_old_users], dim=1))
            i_loss = (torch.logsumexp(i_rep @ sampled_item_embs.T, dim=1)
                      - torch.sum(i_rep * emb[self.n_old_users :], dim=1))
            contrastive = torch.cat([u_loss, i_loss])

        final = propagate_mean(buffers["norm_adj"], representations,
                               self.n_layers)
        return final, contrastive

    def rep(self, params, buffers, *, train=False, drop=None):
        """(n_users + n_items, d) representations: over ``drop``'s samples
        when training, over the evaluation's fixed samples otherwise."""
        with torch.set_grad_enabled(train):
            draw = drop if train and drop is not None else self.eval_draw()
            return self._rep_and_contrastive(params, buffers, draw, False)[0]

    def bpr_pieces_contrastive(self, params, buffers, users, pos, neg, *,
                               train, drop):
        rep, contrastive = self._rep_and_contrastive(params, buffers, drop,
                                                     True)
        n = self.n_users
        c = (take_rows(contrastive, users) + take_rows(contrastive, n + pos)
             + take_rows(contrastive, n + neg))
        u, p, ng = (take_rows(rep, users), take_rows(rep, n + pos),
                    take_rows(rep, n + neg))
        l2 = l2sq(u, dim=1) + l2sq(p, dim=1) + l2sq(ng, dim=1)
        for head in params["heads"]:
            l2 = l2 + l2sq(head["wq"]["w"]) + l2sq(head["wk"]["w"])
        return u, p, ng, l2, c
