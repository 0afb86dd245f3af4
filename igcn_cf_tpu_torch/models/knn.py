"""Popularity (port of ``Popularity`` in ``igcn_cf_tpu/models/knn.py``;
ItemKNN is not ported yet).

Every user gets the items with the most train interactions first. The JAX package scores the broadcast degrees with
``lax.top_k``; here the model's representation is one column wide: 1.0
for every user, each item's train degree (f32, exact) for the items, so
users_rep @ items_rep^T is the degree row and the evaluator's fused
retrieval (K5 on CUDA) ranks it. Integer degrees tie everywhere: K5 and
its plain version break ties by the lowest item id, as ``lax.top_k`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.models.base import Model


@MODELS.register("Popularity")
class Popularity(Model):
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
