"""NeuMF, the GMF + MLP dual-embedding model with staged pretraining (port
of ``igcn_cf_tpu/models/neumf.py``).

The reference NeuMF (reference model.py:657-713): four embedding tables
(mf_user/mf_item at d, mlp_user/mlp_item at layer_sizes[0] // 2), all
kaiming-uniform; an MLP tower with leaky ReLU after every layer; the
``arch`` flag in {gmf, mlp, neumf} zeroes the other tower's vector during
staged pretraining (model.py:696-701); the output layer is a bias-free,
ones-initialized weight vector multiplied elementwise before the sum, and
the BCE L2 term is the per-row squared norm of that weighted vector
(model.py:702-706). ``predict`` scores every (user, item) pair through the
tower (model.py:708-713), in user chunks that keep the (users, n_items,
width) f32 intermediate under ``PREDICT_BUDGET_BYTES``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.models.base import (
    Model,
    kaiming_uniform,
    linear_apply,
    take_rows,
)

# bytes of one (users, n_items, width) f32 intermediate of ``predict``
PREDICT_BUDGET_BYTES = 512 * 1024**2


@MODELS.register("NeuMF")
class NeuMF(Model):
    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.embedding_size = config["embedding_size"]
        self.layer_sizes = list(config["layer_sizes"])
        self.arch = "gmf"  # staged by BCETrainer (reference trainer.py:334-345)

    def init_params(self, generator=None):
        d = self.embedding_size
        half = self.layer_sizes[0] // 2
        params = {
            "mf_user": kaiming_uniform(generator, (self.n_users, d), self.device),
            "mf_item": kaiming_uniform(generator, (self.n_items, d), self.device),
            "mlp_user": kaiming_uniform(generator, (self.n_users, half),
                                        self.device),
            "mlp_item": kaiming_uniform(generator, (self.n_items, half),
                                        self.device),
        }
        params.update(self.init_mlp_layers(generator))
        return params

    def init_mlp_layers(self, generator=None):
        """Kaiming weights and zero biases for the tower, a ones output
        weight (reference model.py:681-685)."""
        sizes = self.layer_sizes
        mlp = [{"w": kaiming_uniform(generator, (sizes[i], sizes[i - 1]),
                                     self.device).T.contiguous(),
                "b": torch.zeros(sizes[i], device=self.device)}
               for i in range(1, len(sizes))]
        out_w = torch.ones(sizes[-1] + self.embedding_size, device=self.device)
        return {"mlp_layers": mlp, "output_w": out_w}

    def bce_forward(self, params, users, items):
        """users, items (...,) ids -> (scores (...,), l2 (...,))."""
        mf = (take_rows(params["mf_user"], users)
              * take_rows(params["mf_item"], items))
        mlp = torch.cat([take_rows(params["mlp_user"], users),
                         take_rows(params["mlp_item"], items)], dim=-1)
        for layer in params["mlp_layers"]:
            mlp = F.leaky_relu(linear_apply(layer, mlp), negative_slope=0.01)
        if self.arch == "gmf":
            vec = torch.cat([mf, torch.zeros_like(mlp)], dim=-1)
        elif self.arch == "mlp":
            vec = torch.cat([torch.zeros_like(mf), mlp], dim=-1)
        else:
            vec = torch.cat([mf, mlp], dim=-1)
        weighted = vec * params["output_w"]
        return torch.sum(weighted, dim=-1), torch.sum(weighted * weighted, dim=-1)

    def predict(self, params, buffers, users):
        width = max(self.layer_sizes + [self.layer_sizes[-1] + self.embedding_size])
        chunk = max(1, PREDICT_BUDGET_BYTES // (self.n_items * width * 4))
        items = torch.arange(self.n_items, device=users.device)
        out = []
        for start in range(0, users.shape[0], chunk):
            u = users[start : start + chunk, None].expand(-1, self.n_items)
            out.append(self.bce_forward(params, u, items.expand_as(u))[0])
        return torch.cat(out)
