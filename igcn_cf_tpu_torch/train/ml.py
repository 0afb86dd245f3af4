"""MLTrainer, MultiVAE's multinomial-likelihood training (port of
``igcn_cf_tpu/train/ml.py``).

The reference MLTrainer (reference trainer.py:369-401): an epoch walks
shuffled batches of user ids (not interaction triples); the loss is the
multinomial log-likelihood -sum(profile * log_softmax(scores)) on the
unnormalized binary profiles, plus the KL term annealed as
min(kl_reg, epoch / n_epochs) and l2_reg times the weights' L2 term.

The shuffle is a permutation on the device, its tail padded by wrapping so
every batch is full; the binary targets are scattered per batch from the
model's padded item buffer. ``train_step`` takes the users and the draw, so
a test can feed it the JAX package's.
"""

from __future__ import annotations

import torch

from igcn_cf_tpu_torch.core.registry import TRAINERS
from igcn_cf_tpu_torch.train.bpr import _StepTrainer


@TRAINERS.register("MLTrainer")
class MLTrainer(_StepTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]
        self.kl_reg = config["kl_reg"]
        self.kl_weight = 0.0  # this epoch's annealed KL weight

    def steps_per_epoch(self) -> int:
        return max(1, -(-self.dataset.n_users // self.batch_size))

    def kl_anneal(self, epoch: int) -> float:
        """min(kl_reg, epoch / n_epochs) (reference trainer.py:382)."""
        return min(self.kl_reg, 1.0 * epoch / self.n_epochs)

    def user_batches(self) -> torch.Tensor:
        """(steps, batch_size) user ids: one permutation on the device, its
        tail padded by wrapping around it."""
        n_users = self.dataset.n_users
        padded = self.steps_per_epoch() * self.batch_size
        perm = torch.randperm(n_users, generator=self.gen, device=self.device)
        wrap = torch.arange(padded, device=self.device) % n_users
        return perm[wrap].view(-1, self.batch_size)

    def binary_profiles(self, users):
        """Unnormalized binary target rows (reference trainer.py:375-376)."""
        rows = self.buffers["profile_items"][users]
        vals = (rows < self.model.n_profile_items).float()
        return self.model.scatter_profiles(rows, vals)

    def loss(self, params, users, draw):
        scores, kl, l2 = self.model.ml_forward(params, self.buffers, users,
                                               train=True, draw=draw)
        log_probs = torch.log_softmax(scores, dim=1)
        ml_loss = -torch.sum(self.binary_profiles(users) * log_probs,
                             dim=1).mean()
        return ml_loss + self.kl_weight * kl.mean() + self.l2_reg * torch.mean(l2)

    def train_one_epoch(self) -> float:
        self.kl_weight = self.kl_anneal(self.epoch)
        losses = [self.train_step(users, self.model.draw(self.buffers, users,
                                                         self.gen))
                  for users in self.user_batches()]
        self.step_losses = torch.stack(losses)
        return float(self.step_losses.mean())
