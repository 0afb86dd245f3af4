"""BPR-family trainers (port of ``igcn_cf_tpu/train/bpr.py``): BPRTrainer,
IGCNTrainer and IDCFTrainer.

  * BPR: softplus(neg_score - pos_score).mean() + l2_reg * l2.mean()
    (reference trainer.py:231-248);
  * IGCN adds the auxiliary self-enhanced BPR on raw template embeddings
    scored with w, weighted by aux_reg, and anneals the feature matrix each
    epoch (reference trainer.py:294-320);
  * IDCF adds contrastive_reg * contrastive_loss.mean() (reference
    trainer.py:261-278).

A step samples its batch on the device, runs the model forward, takes the
gradients with autograd and steps the optimizer. ``train_step`` takes the
batch and the dropout draw as arguments, so a test can feed it the JAX
package's draws; ``sample_step`` draws them the trainer's way. On a card,
BPRTrainer (and IDCFTrainer) replay the step after the sampling as one
CUDA graph where its inputs allow (``train/step_graph.py``); IGCNTrainer's
dropout draw carries host mask seeds, so its steps stay eager.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from igcn_cf_tpu_torch.core.registry import TRAINERS
from igcn_cf_tpu_torch.data.sampler import DeviceNegativeSampler
from igcn_cf_tpu_torch.data.transforms import auxiliary_interactions
from igcn_cf_tpu_torch.train.step_graph import StepGraph
from igcn_cf_tpu_torch.train.trainer import BasicTrainer
from igcn_cf_tpu_torch.utils.spans import span


def bpr_loss_terms(model, params, buffers, users, pos, neg, drop):
    """(mean BPR loss, per-triple l2) of one batch."""
    u_r, p_r, n_r, l2 = model.bpr_pieces(params, buffers, users, pos, neg,
                                         train=True, drop=drop)
    pos_scores = torch.sum(u_r * p_r, dim=1)
    neg_scores = torch.sum(u_r * n_r, dim=1)
    return torch.mean(F.softplus(neg_scores - pos_scores)), l2


class _StepTrainer(BasicTrainer):
    """Shared epoch machinery: a step is ``train_step(*sample_step())``.
    Subclasses define ``sample_step`` and ``loss``."""

    def sample_step(self) -> tuple:
        raise NotImplementedError

    def loss(self, params, *step_inputs) -> torch.Tensor:
        raise NotImplementedError

    def train_step(self, *step_inputs) -> torch.Tensor:
        """One optimizer step on the given inputs; returns the loss (on the
        device, detached, not read back)."""
        with span("train.optimizer"):
            self.opt.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss = self.loss(self.params, *step_inputs)
        # on a card autograd runs the backward nodes on its device thread
        with span("train.backward", adopts=True):
            loss.backward()
        with span("train.optimizer"):
            self.opt.step()
        return loss.detach()

    def train_one_epoch(self) -> float:
        """Returns the epoch's mean loss; the per-step losses stay on the
        device in ``step_losses``."""
        losses = []
        for _ in range(self.steps_per_epoch()):
            with span("train.step"):
                with span("train.sample"):
                    step_inputs = self.sample_step()
                losses.append(self.train_step(*step_inputs))
        with span("train.epoch_end"):
            self.step_losses = torch.stack(losses)
            self.buffers = self.model.epoch_update(self.buffers)
            return float(self.step_losses.mean())


@TRAINERS.register("BPRTrainer")
class BPRTrainer(_StepTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]
        self.step_graph = StepGraph()

    def sample_step(self):
        users, pos, negs = self.sampler.sample(self.gen, self.batch_size)
        return (users, pos, negs[:, 0]), self.model.draw_drop(self.keys, self.gen)

    def train_step(self, *step_inputs) -> torch.Tensor:
        """``_StepTrainer.train_step``, replayed from one CUDA graph where
        the inputs and the trainer's state allow (``StepGraph``)."""
        return self.step_graph.step(self, step_inputs, super().train_step)

    def loss(self, params, batch, drop):
        bpr, l2 = bpr_loss_terms(self.model, params, self.buffers, *batch, drop)
        return bpr + self.l2_reg * torch.mean(l2)


@TRAINERS.register("IGCNTrainer")
class IGCNTrainer(_StepTrainer):
    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.l2_reg = config["l2_reg"]
        self.aux_reg = config["aux_reg"]
        aux_ds = auxiliary_interactions(dataset, model.user_map, model.item_map)
        self.aux_sampler = DeviceNegativeSampler.build(aux_ds, self.device)
        bip = self.buffers.get("bip")
        if bip is not None and model._identity_templates():
            # template space is the full id space: B answers aux membership
            self.aux_sampler = self.aux_sampler.with_dense_b(bip.B)

    def sample_step(self):
        users, pos, negs = self.sampler.sample(self.gen, self.batch_size)
        a_users, a_pos, a_negs = self.aux_sampler.sample(self.gen,
                                                         self.batch_size)
        return ((users, pos, negs[:, 0]), (a_users, a_pos, a_negs[:, 0]),
                self.model.draw_drop(self.keys, self.gen))

    def loss(self, params, batch, aux_batch, drop):
        """bpr + l2_reg * mean(l2) + aux_reg * aux (bpr.py:122-132 of the
        JAX package; the reference folds aux into its "reg" term)."""
        bpr, l2 = bpr_loss_terms(self.model, params, self.buffers, *batch, drop)
        aux_pos, aux_neg = self.model.aux_scores(params, *aux_batch)
        aux_loss = torch.mean(F.softplus(aux_neg - aux_pos))
        return bpr + self.l2_reg * torch.mean(l2) + self.aux_reg * aux_loss


@TRAINERS.register("IDCFTrainer")
class IDCFTrainer(BPRTrainer):
    """BPRTrainer's steps; the model's draw is its heads' key samples."""

    def __init__(self, config, dataset, model):
        super().__init__(config, dataset, model)
        self.contrastive_reg = config["contrastive_reg"]

    def loss(self, params, batch, draw):
        u_r, p_r, n_r, l2, contrastive = self.model.bpr_pieces_contrastive(
            params, self.buffers, *batch, train=True, drop=draw)
        pos_scores = torch.sum(u_r * p_r, dim=1)
        neg_scores = torch.sum(u_r * n_r, dim=1)
        bpr = torch.mean(F.softplus(neg_scores - pos_scores))
        return (bpr + self.l2_reg * torch.mean(l2)
                + self.contrastive_reg * torch.mean(contrastive))
