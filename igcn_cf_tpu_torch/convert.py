"""Parameters and checkpoints between this package and the JAX package.

A JAX checkpoint is the pickle ``{"params": {name: np.ndarray}, "extra":
{...}}`` that ``igcn_cf_tpu.models.base.Model.save`` writes; the extra state
holds only plain Python values (template maps, alpha). Both packages write
and read that one format.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch


def params_from_jax(blob_params: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """{name: array} (numpy, or anything ``np.asarray`` takes) -> {name:
    tensor on ``device``}, copied."""
    return {
        name: torch.tensor(np.asarray(value), device=device)
        for name, value in blob_params.items()
    }


def params_to_jax(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{name: tensor} -> {name: np.ndarray} on the host, as the JAX package
    pickles them."""
    return {name: t.detach().cpu().numpy() for name, t in params.items()}


def load_jax_checkpoint(path: str, device):
    """(params on ``device``, extra state) from a checkpoint pickle of either
    package. Unpickles, so read only checkpoints this program or the JAX
    package wrote."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return params_from_jax(blob["params"], device), blob.get("extra", {})
