"""Model base contract (port of ``igcn_cf_tpu/models/base.py``).

A ``Model`` is an ``nn.Module`` that holds static config and host-side
graph structures. Device state is two explicit dictionaries, as in the JAX
package, so a checkpoint, a refresh or a test can swap either one:

  * ``params``  — the tree of trainable tensors, from
    ``init_params(generator)`` or ``load(path)``: a flat ``{name: tensor}``
    for most models, nested dicts and lists where the JAX package nests
    them (NGCF's layer lists);
  * ``buffers`` — non-trainable device tensors derived from the dataset,
    from ``init_buffers()``.

``rep(params, buffers, train=False)`` gives the full (n_users + n_items, d)
node representations; ``forward`` is that call. Training goes through
``bpr_pieces(params, buffers, users, pos, neg, train=True, drop=...)``,
which returns (user_rep, pos_rep, neg_rep, l2 per triple) with autograd;
``drop`` is the step's dropout draw, from ``draw_drop``. Params are leaf
tensors with ``requires_grad``; ``torch.optim`` updates them in place.

Checkpoints are the JAX package's pickle, ``{"params": tree of np.ndarray,
"extra": {...}}``, so each package loads the other's.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from igcn_cf_tpu_torch.convert import load_jax_checkpoint, params_to_jax
from igcn_cf_tpu_torch.kernels import _build

Params = Dict[str, torch.Tensor]
Buffers = Dict[str, object]


def normal_init(generator: Optional[torch.Generator], shape, std=0.1,
                device="cpu", dtype=torch.float32) -> torch.Tensor:
    """normal_(std=0.1), the embedding-table init of MF/LightGCN/IGCN. Draws
    on the CPU from ``generator``, so a seed gives the same table on any
    device."""
    x = torch.randn(shape, generator=generator, dtype=dtype)
    return (std * x).to(device)


def kaiming_uniform(generator: Optional[torch.Generator], shape,
                    device="cpu") -> torch.Tensor:
    """torch.nn.init.kaiming_uniform_'s default (a=0, fan_in, gain
    sqrt(2)): uniform in [-b, b) with b = sqrt(6 / fan_in), fan_in =
    shape[-1] of an (out, in) weight. Drawn on the CPU from ``generator``."""
    bound = float(np.sqrt(6.0 / shape[-1]))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * bound).to(device)


def linear_init(generator: Optional[torch.Generator], in_features: int,
                out_features: int, device="cpu") -> Params:
    """A linear layer as the JAX package holds it: kaiming-uniform weight
    stored (in, out), so it applies as x @ w + b, and a zero bias."""
    w = kaiming_uniform(generator, (out_features, in_features)).T.contiguous()
    return {"w": w.to(device),
            "b": torch.zeros(out_features, dtype=torch.float32, device=device)}


def linear_apply(layer: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ layer["w"] + layer["b"]


def l2sq(x: torch.Tensor, dim=None) -> torch.Tensor:
    return torch.sum(x * x) if dim is None else torch.sum(x * x, dim=dim)


class Model(nn.Module):
    """Base model; subclasses implement ``init_params``, ``init_buffers``
    and ``rep``, and trainable ones ``bpr_pieces``."""

    trainable: bool = True

    def __init__(self, config: dict, dataset, device="cuda"):
        super().__init__()
        self.config = dict(config)
        self.name = config["name"]
        self.dataset = dataset
        self.n_users = dataset.n_users
        self.n_items = dataset.n_items
        self.device = _build.require_device(device)

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

    def attach_pcache(self, bip, buffers: Buffers) -> None:
        """Build the propagation cache P of ``bip`` into
        ``buffers["pcache"]`` for a model whose static gate passed (IGCN,
        LightGCN: ``n_layers``, ``embedding_size``, ``pcache``). For 'auto'
        on CUDA the engines are A/B-measured at the trainer's batch size
        (set on the model before ``init_buffers``) unless the config names
        one; a rejection turns the cache engine off."""
        from igcn_cf_tpu_torch.kernels.pcache import maybe_build_pcache

        p, self.engine_ab = maybe_build_pcache(
            bip, self.n_layers, self.embedding_size,
            self.config.get("prop_cache", "auto"),
            int(self.config.get("prop_cache_ab_batch",
                                getattr(self, "ab_batch", 2048))),
        )
        if p is None:
            self.pcache = False
        else:
            buffers["pcache"] = p

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


def get_model(config: dict, dataset, device="cuda") -> Model:
    """The registered model of ``config["name"]`` on ``device``: the card
    by default (raises where there is none); ``device="cpu"`` runs the
    plain versions."""
    from igcn_cf_tpu_torch.core.registry import MODELS

    cls = MODELS.get(config["name"])
    return cls(config, dataset, device)

