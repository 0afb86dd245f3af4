"""Parameters and checkpoints between this package and the JAX package.

A JAX checkpoint is the pickle ``{"params": {name: np.ndarray}, "extra":
{...}}`` that ``igcn_cf_tpu.models.base.Model.save`` writes; the extra state
holds only plain Python values (template maps, alpha). Both packages write
and read that one format. Adam's state crosses too, between optax's
``ScaleByAdamState`` and ``torch.optim.Adam``, so a training run can move
between the packages mid-way.
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


# -- Adam state: optax ScaleByAdamState (count, mu, nu) <-> torch.optim.Adam


def _find_adam_state(opt_state):
    """The (count, mu, nu) part of an optax state (``optax.adam`` gives a
    tuple whose first element is a ``ScaleByAdamState``), or a dict with
    those keys as ``adam_state_to_jax`` writes it."""
    if isinstance(opt_state, dict) and {"count", "mu", "nu"} <= opt_state.keys():
        return opt_state["count"], opt_state["mu"], opt_state["nu"]
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _find_adam_state(part)
            if found is not None:
                return found
    return None


def adam_state_to_jax(optimizer: torch.optim.Optimizer,
                      params: Dict[str, torch.Tensor]) -> dict:
    """{"count": int32, "mu": {name: array}, "nu": {name: array}}: the
    fields of optax's ``ScaleByAdamState`` for ``params`` (build one with
    ``ScaleByAdamState(**state)``). Parameters with no step yet have zero
    moments and count 0."""
    count = 0
    mu, nu = {}, {}
    for name, p in params.items():
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            mu[name] = st["exp_avg"].detach().cpu().numpy()
            nu[name] = st["exp_avg_sq"].detach().cpu().numpy()
        else:
            mu[name] = np.zeros(tuple(p.shape), np.float32)
            nu[name] = np.zeros(tuple(p.shape), np.float32)
    return {"count": np.int32(count), "mu": mu, "nu": nu}


def adam_state_from_jax(opt_state, params: Dict[str, torch.Tensor],
                        optimizer: torch.optim.Optimizer) -> None:
    """Load optax Adam state (count, mu, nu) into ``optimizer``'s state for
    ``params`` (torch's step, exp_avg, exp_avg_sq). The update rules are the
    same: lr * mu_hat / (sqrt(nu_hat) + eps) with the bias corrections of
    step count + 1."""
    found = _find_adam_state(opt_state)
    if found is None:
        raise ValueError("no Adam (count, mu, nu) state found")
    count, mu, nu = found
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu[name]), device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu[name]), device=p.device),
        }
