"""MultiVAE, the variational autoencoder over user profiles (port of
``igcn_cf_tpu/models/multivae.py``).

The reference MultiVAE (reference model.py:594-654): the input is the
L2-normalized binary profile row of each user; sparse-entry dropout on the
profile; an encoder MLP (tanh between layers) to (mean, logvar); the KL
term in the reference's exact form ``sum(-logvar + exp(logvar) + mean^2)``
(model.py:638); a reparameterized sample in training; a decoder MLP (tanh
between layers) to item logits. The L2 term sums the squared Frobenius
norms of every layer weight. ``predict`` pads with -inf where the eval
catalog is wider than the trained profile width (the dropui recipe,
reference model.py:649-654, run/dropui/vae_dropui.py:31-33).

Profile rows are scattered per batch from a padded per-user item buffer
(sentinel column ``n_profile_items``), so the first encoder matmul runs
dense on the device. The entry-dropout keep and the reparameterisation
noise are an explicit draw (``MultiVAEDraw``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from igcn_cf_tpu_torch.core.registry import MODELS
from igcn_cf_tpu_torch.models.base import Model, linear_apply, linear_init


def _fro2(w):
    return torch.sum(w * w)


class MultiVAEDraw(NamedTuple):
    """One step's draw: ``keep`` (B, W) bool over the profile buffer's
    entries (None without dropout), ``eps`` (B, mid) the standard normal
    noise of the reparameterisation. The JAX package derives them from
    ``split(key) -> (k_drop, k_eps)``."""

    keep: Optional[torch.Tensor]
    eps: torch.Tensor


@MODELS.register("MultiVAE")
class MultiVAE(Model):
    def __init__(self, config, dataset, device="cuda"):
        super().__init__(config, dataset, device)
        self.dropout = config["dropout"]
        # reference model.py:600-604: e_sizes = [n_in] + layer_sizes with the
        # last doubled for (mean, logvar); d_sizes is the reverse
        self.n_profile_items = dataset.n_items  # input width at TRAIN time
        sizes = list(config["layer_sizes"])
        self.mid_size = sizes[-1]
        self.e_sizes = [self.n_profile_items] + sizes[:-1] + [2 * self.mid_size]
        self.d_sizes = [self.mid_size] + sizes[:-1][::-1] + [self.n_profile_items]

    def init_params(self, generator=None):
        def mlp(sizes):
            return [linear_init(generator, sizes[i], sizes[i + 1], self.device)
                    for i in range(len(sizes) - 1)]

        return {"encoder": mlp(self.e_sizes), "decoder": mlp(self.d_sizes)}

    def init_buffers(self):
        n_users = self.n_users
        degs = np.array([len(self.dataset.train[u]) for u in range(n_users)],
                        dtype=np.int32)
        max_deg = max(1, int(degs.max()) if n_users else 1)
        items = np.full((n_users, max_deg), self.n_profile_items, dtype=np.int64)
        for u in range(n_users):
            row = np.asarray(self.dataset.train[u], dtype=np.int64)
            # dropui eval: items beyond the trained profile width are left
            # out of the profile (reference run/dropui/vae_dropui.py:31-33)
            row = row[row < self.n_profile_items]
            items[u, : len(row)] = row
        return {
            "profile_items": torch.as_tensor(items).to(self.device),
            "profile_deg": torch.as_tensor(
                np.maximum(degs, 1).astype(np.float32)).to(self.device),
        }

    def draw(self, buffers, users, generator) -> MultiVAEDraw:
        """The step's entry keeps and noise for ``users``, on the device."""
        b, w = users.shape[0], buffers["profile_items"].shape[1]
        keep = None
        if self.dropout > 0.0:
            keep = torch.rand((b, w), generator=generator,
                              device=self.device) < 1.0 - self.dropout
        eps = torch.randn((b, self.mid_size), generator=generator,
                          device=self.device)
        return MultiVAEDraw(keep, eps)

    def scatter_profiles(self, rows, vals):
        """Dense (B, n_profile_items) rows from the padded item ids ``rows``
        and their values; the sentinel column absorbs the padding."""
        out = vals.new_zeros((rows.shape[0], self.n_profile_items + 1))
        out.scatter_add_(1, rows, vals)
        return out[:, : self.n_profile_items]

    def _profiles(self, buffers, users, keep):
        """Dense L2-normalized profile rows, entries dropped by ``keep``."""
        rows = buffers["profile_items"][users]  # (B, W)
        vals = (1.0 / torch.sqrt(buffers["profile_deg"][users]))[:, None].expand(
            rows.shape)
        vals = torch.where(rows < self.n_profile_items, vals, 0.0)
        if keep is not None:
            vals = torch.where(keep, vals / (1.0 - self.dropout), 0.0)
        return self.scatter_profiles(rows, vals)

    def ml_forward(self, params, buffers, users, *, train, draw=None):
        """(scores (B, n_profile_items), kl (B,), l2 scalar); ``train``
        applies ``draw``'s entry dropout and samples z with its noise."""
        with torch.set_grad_enabled(train):
            keep = draw.keep if train and self.dropout > 0.0 else None
            x = self._profiles(buffers, users, keep)
            enc, dec = params["encoder"], params["decoder"]
            l2 = _fro2(enc[0]["w"])
            h = linear_apply(enc[0], x)
            for layer in enc[1:]:
                h = linear_apply(layer, torch.tanh(h))
                l2 = l2 + _fro2(layer["w"])
            mean, log_var = h[:, : self.mid_size], h[:, -self.mid_size :]
            kl = torch.sum(-log_var + torch.exp(log_var) + mean**2, dim=1)
            z = mean + draw.eps * torch.exp(0.5 * log_var) if train else mean
            for layer in dec[:-1]:
                z = torch.tanh(linear_apply(layer, z))
                l2 = l2 + _fro2(layer["w"])
            scores = linear_apply(dec[-1], z)
            l2 = l2 + _fro2(dec[-1]["w"])
            return scores, kl, l2

    def predict(self, params, buffers, users):
        scores, _, _ = self.ml_forward(params, buffers, users, train=False)
        if self.n_profile_items < self.n_items:
            pad = scores.new_full((scores.shape[0],
                                   self.n_items - self.n_profile_items),
                                  float("-inf"))
            scores = torch.cat([scores, pad], dim=1)
        return scores
