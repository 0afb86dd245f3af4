"""BCETrainer, NeuMF's staged training (port of ``igcn_cf_tpu/train/bce.py``).

The reference BCETrainer (reference trainer.py:323-366): epoch thresholds
switch ``arch`` gmf -> mlp -> neumf; each switch makes a fresh optimizer,
resets the best NDCG and reloads the stage's best checkpoint, and the neumf
switch re-initializes the MLP tower and output weight (trainer.py:340-345).
The loss is BCE through softplus: softplus(-logit) on the positive and
softplus(logit) on each of the ``neg_ratio`` negatives, averaged over their
concatenation (trainer.py:346-366).

The JAX package swaps whole parameter trees at a switch. Here the reloaded
tree is a new set of leaf tensors, so the switch also rebuilds
``flat_params`` and the optimizer over them: Adam never updates a stale
tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from igcn_cf_tpu_torch.convert import flatten_tree, map_tree
from igcn_cf_tpu_torch.core.registry import TRAINERS
from igcn_cf_tpu_torch.train.bpr import _StepTrainer


@TRAINERS.register("BCETrainer")
class BCETrainer(_StepTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]
        self.mf_pretrain_epochs = config["mf_pretrain_epochs"]
        self.mlp_pretrain_epochs = config["mlp_pretrain_epochs"]
        self.neg_ratio = dataset.neg_ratio

    def sample_step(self):
        return (self.sampler.sample(self.gen, self.batch_size,
                                    neg_ratio=self.neg_ratio),)

    def loss(self, params, batch):
        users, pos, negs = batch
        pos_logits, l2_p = self.model.bce_forward(params, users, pos)
        neg_logits, l2_n = self.model.bce_forward(
            params, users.repeat_interleave(self.neg_ratio), negs.reshape(-1))
        bce = torch.mean(torch.cat([F.softplus(-pos_logits),
                                    F.softplus(neg_logits)]))
        return bce + self.l2_reg * torch.mean(torch.cat([l2_p, l2_n]))

    def _switch(self, arch: str) -> None:
        """Start stage ``arch`` from the last stage's best checkpoint, with
        fresh Adam state over the new leaves."""
        self.model.arch = arch
        self.best_ndcg = -np.inf
        params = self.model.load(self.save_path)
        if arch == "neumf":
            params.update(self.model.init_mlp_layers(self.keys.generator()))
        self.params = map_tree(lambda v: v.requires_grad_(), params)
        self.flat_params = flatten_tree(self.params)
        self.initialize_optimizer()

    def train_one_epoch(self) -> float:
        """Stage switches (reference trainer.py:334-345), then the epoch."""
        if self.epoch == self.mf_pretrain_epochs:
            self._switch("mlp")
        if self.epoch == self.mf_pretrain_epochs + self.mlp_pretrain_epochs:
            self._switch("neumf")
        return super().train_one_epoch()
