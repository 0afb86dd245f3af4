"""The non-trainable baselines, ItemKNN and Popularity (port of
``igcn_cf_tpu/models/knn.py``).

ItemKNN (reference model.py:305-335): item-item Jaccard similarity from the
binary interaction matrix, keeping the top-k most similar items per item;
a user's scores are their profile row times the similarity matrix. The
similarity build and the scoring are host scipy, a copy of the JAX
package's (the same ``np.argsort(...)[:, -k:]``, so the neighbour sets are
the same); each block of scores moves to the device for the evaluator's
masked top-k.

Popularity (reference model.py:338-351): every user gets the items with
the most train interactions first. The JAX package scores the broadcast
degrees with ``lax.top_k``; here the model's representation is one column
wide: 1.0 for every user, each item's train degree (f32, exact) for the
items, so users_rep @ items_rep^T is the degree row and the evaluator's
fused retrieval (K5 on CUDA) ranks it. Integer degrees tie everywhere: K5
and its plain version break ties by the lowest item id, as ``lax.top_k``
does.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.models.base import Model

SIM_BLOCK = 1024  # items a block of the similarity build, as in the JAX package
SIM_THREADS = min(8, os.cpu_count() or 1)


def _data_mat(ds) -> sp.csr_matrix:
    arr = ds.train_array
    return sp.coo_matrix(
        (np.ones(len(arr), dtype=np.float32), (arr[:, 0], arr[:, 1])),
        shape=(ds.n_users, ds.n_items),
    ).tocsr()


@MODELS.register("ItemKNN")
class ItemKNN(Model):
    trainable = False

    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.k = config["k"]
        self.data_mat, self.sim_mat = self.calculate_similarity(dataset)

    def calculate_similarity(self, dataset):
        """Top-k Jaccard per item (reference model.py:312-329) in blocks of
        ``SIM_BLOCK`` items, the blocks on ``SIM_THREADS`` host threads
        (numpy's sort and scipy's products release the GIL). Each block's
        rows, columns and values are arrays where the JAX package extends
        Python lists: the same entries in the same order."""
        data_mat = _data_mat(dataset)
        item_degree = np.asarray(data_mat.sum(axis=0)).squeeze()
        n_items = dataset.n_items
        k = min(self.k, n_items)
        gram = data_mat.T.tocsr()

        def top_k(start):
            stop = min(start + SIM_BLOCK, n_items)
            inter = np.asarray((gram[start:stop] @ data_mat).todense())
            union = item_degree[None, :] + item_degree[start:stop, None] - inter
            with np.errstate(invalid="ignore", divide="ignore"):
                sims = inter / union
            sims[~np.isfinite(sims)] = 0.0
            topk = np.argsort(sims, axis=1)[:, -k:]
            return (np.repeat(np.arange(start, stop), k), topk.reshape(-1),
                    np.take_along_axis(sims, topk, axis=1).reshape(-1))

        with ThreadPoolExecutor(SIM_THREADS) as pool:
            rows, cols, vals = zip(*pool.map(top_k, range(0, n_items, SIM_BLOCK)))
        sim_mat = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n_items, n_items), dtype=np.float32,
        ).tocsr()
        return data_mat, sim_mat

    def predict(self, params, buffers, users):
        """(B, n_items) f32 scores: the users' profile rows times the
        similarity matrix on the host, then moved to the device."""
        profiles = self.data_mat[users.cpu().numpy(), :]
        scores = np.asarray((profiles @ self.sim_mat).todense(), dtype=np.float32)
        return torch.as_tensor(scores).to(self.device)

    def rebuild_for(self, new_dataset):
        """dropit: rebuild data_mat, KEEP sim_mat (reference
        run/dropit/knn_dropit.py:30-34). dropui: reshape sim_mat to the new
        catalog (old-item scores only, reference run/dropui/knn_dropui.py)."""
        self.data_mat = _data_mat(new_dataset)
        if new_dataset.n_items != self.sim_mat.shape[0]:
            coo = self.sim_mat.tocoo()
            self.sim_mat = sp.coo_matrix(
                (coo.data, (coo.row, coo.col)),
                shape=(new_dataset.n_items, new_dataset.n_items)).tocsr()
        return super().rebuild_for(new_dataset)


@MODELS.register("Popularity")
class Popularity(Model):
    dot_scored = True  # users_rep @ items_rep^T: fused retrieval (K5)
    trainable = False

    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.item_degree = self.calculate_degree(dataset)

    @staticmethod
    def calculate_degree(dataset) -> np.ndarray:
        """(n_items,) f32 train degree of each item."""
        return np.bincount(dataset.train_array[:, 1],
                           minlength=dataset.n_items).astype(np.float32)

    def init_buffers(self):
        return {"item_degree": torch.as_tensor(self.item_degree).to(self.device)}

    def rep(self, params, buffers, *, train=False, drop=None):
        """(n_users + n_items, 1): 1.0 a user, the degree an item."""
        deg = buffers["item_degree"]
        return torch.cat([deg.new_ones(self.n_users), deg])[:, None]

    def rebuild_for(self, new_dataset):
        """The degrees of the new dataset's train interactions."""
        self.item_degree = self.calculate_degree(new_dataset)
        return super().rebuild_for(new_dataset)
