"""Model base contract (port of ``igcn_cf_tpu/models/base.py``).

A ``Model`` is an ``nn.Module`` that holds static config and host-side
graph structures. Device state is two explicit dictionaries, as in the JAX
package, so a checkpoint, a refresh or a test can swap either one:

  * ``params``  — trainable tensors, from ``init_params(generator)`` or
    ``load(path)``;
  * ``buffers`` — non-trainable device tensors derived from the dataset,
    from ``init_buffers()``.

``rep(params, buffers, train=False)`` gives the full (n_users + n_items, d)
node representations; ``forward`` is that call. Training goes through
``bpr_pieces(params, buffers, users, pos, neg, train=True, drop=...)``,
which returns (user_rep, pos_rep, neg_rep, l2 per triple) with autograd;
``drop`` is the step's dropout draw, from ``draw_drop``. Params are leaf
tensors with ``requires_grad``; ``torch.optim`` updates them in place.

Checkpoints are the JAX package's pickle, ``{"params": {name: np.ndarray},
"extra": {...}}``, so each package loads the other's.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from igcn_cf_tpu_torch.convert import load_jax_checkpoint, params_to_jax

Params = Dict[str, torch.Tensor]
Buffers = Dict[str, object]


def normal_init(generator: Optional[torch.Generator], shape, std=0.1,
                device="cpu", dtype=torch.float32) -> torch.Tensor:
    """normal_(std=0.1), the embedding-table init of MF/LightGCN/IGCN. Draws
    on the CPU from ``generator``, so a seed gives the same table on any
    device."""
    x = torch.randn(shape, generator=generator, dtype=dtype)
    return (std * x).to(device)


def l2sq(x: torch.Tensor, dim=None) -> torch.Tensor:
    return torch.sum(x * x) if dim is None else torch.sum(x * x, dim=dim)


class Model(nn.Module):
    """Base model; subclasses implement ``init_params``, ``init_buffers``
    and ``rep``, and trainable ones ``bpr_pieces``."""

    trainable: bool = True

    def __init__(self, config: dict, dataset, device="cpu"):
        super().__init__()
        self.config = dict(config)
        self.name = config["name"]
        self.dataset = dataset
        self.n_users = dataset.n_users
        self.n_items = dataset.n_items
        self.device = torch.device(device)

    # -- device state -------------------------------------------------------

    def init_params(self, generator: Optional[torch.Generator] = None) -> Params:
        return {}

    def init_buffers(self) -> Buffers:
        return {}

    # -- representations ----------------------------------------------------

    def rep(self, params: Params, buffers: Buffers, *,
            train: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, params: Params, buffers: Buffers) -> torch.Tensor:
        return self.rep(params, buffers, train=False)

    def bpr_pieces(self, params: Params, buffers: Buffers, users, pos, neg, *,
                   train: bool, drop=None) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def draw_drop(self, keys, generator: torch.Generator):
        """One train step's dropout draw (None: the model drops nothing)."""
        return None

    # -- epoch hook (INMO anneal); default no-op ----------------------------

    def epoch_update(self, buffers: Buffers) -> Buffers:
        return buffers

    def refresh_buffers(self, buffers: Buffers) -> Buffers:
        """Re-derive buffers after a checkpoint load (models whose buffers
        depend on loaded extra state override this)."""
        return buffers

    def rebuild_for(self, new_dataset) -> Buffers:
        """Swap in a (possibly grown) dataset and derive its buffers."""
        self.dataset = new_dataset
        self.n_users = new_dataset.n_users
        self.n_items = new_dataset.n_items
        return self.init_buffers()

    # -- checkpointing ------------------------------------------------------

    def extra_state(self) -> dict:
        return {}

    def load_extra_state(self, state: dict) -> None:
        pass

    def save(self, path: str, params: Params) -> None:
        blob = {"params": params_to_jax(params), "extra": self.extra_state()}
        with open(path, "wb") as f:
            pickle.dump(blob, f)

    def load(self, path: str) -> Params:
        """Restore params onto the model's device and its extra state;
        buffers are then derived from the CURRENT dataset (the inductive
        contract)."""
        params, extra = load_jax_checkpoint(path, self.device)
        self.load_extra_state(extra)
        return params


def get_model(config: dict, dataset, device="cpu") -> Model:
    from igcn_cf_tpu_torch.core.registry import MODELS

    cls = MODELS.get(config["name"])
    return cls(config, dataset, device)

