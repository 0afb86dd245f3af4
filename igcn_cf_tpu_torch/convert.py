"""Parameters and checkpoints between this package and the JAX package.

A JAX checkpoint is the pickle ``{"params": tree, "extra": {...}}`` that
``igcn_cf_tpu.models.base.Model.save`` writes, where ``tree`` is the
model's parameter pytree with numpy leaves: a flat ``{name: array}`` for
IGCN/LightGCN, nested dicts and lists for NGCF (``{"embedding": ...,
"gc_layers": [{"w": ..., "b": ...}, ...], ...}``). The extra state holds
only plain Python values (template maps, alpha). Both packages write and
read that one format, and the port's models keep their params in the same
nested shape. ``flatten_tree`` names every leaf by its dotted path
(``gc_layers.0.w``), the view ``torch.optim`` and per-name comparisons use.
Adam's state crosses too, between optax's ``ScaleByAdamState`` and
``torch.optim.Adam``, so a training run can move between the packages
mid-way.
"""

from __future__ import annotations

import pickle
from typing import Callable, Dict

import numpy as np
import torch


def map_tree(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``; dicts and lists
    (tuples become lists, as pickled pytrees hold them) keep their shape."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """{dotted path: leaf} in the tree's order: dict keys, list indices."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def params_from_jax(blob_params, device):
    """A parameter tree of arrays (numpy, or anything ``np.asarray`` takes)
    -> the same tree of tensors on ``device``, copied."""
    return map_tree(lambda v: torch.tensor(np.asarray(v), device=device),
                    blob_params)


def params_to_jax(params):
    """A parameter tree of tensors -> the same tree of host numpy arrays, as
    the JAX package pickles them."""
    return map_tree(lambda t: t.detach().cpu().numpy(), params)


@torch.no_grad()
def copy_params_(params, values) -> None:
    """Copy the leaves of tree ``values`` (tensors or arrays) into the
    same-named leaves of ``params`` in place (optimizers keep pointing at the
    same tensors)."""
    src = flatten_tree(values)
    for name, t in flatten_tree(params).items():
        v = src[name]
        t.copy_(v if isinstance(v, torch.Tensor) else torch.as_tensor(np.array(v)))


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


def adam_state_to_jax(optimizer: torch.optim.Optimizer, params) -> dict:
    """{"count": int32, "mu": tree, "nu": tree}: the fields of optax's
    ``ScaleByAdamState`` for the parameter tree ``params``, mu and nu in its
    shape (build one with ``ScaleByAdamState(**state)``). Parameters with no
    step yet have zero moments and count 0."""
    count = 0
    for p in flatten_tree(params).values():
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])

    def moment(key):
        def get(p):
            st = optimizer.state.get(p, {})
            if st:
                return st[key].detach().cpu().numpy()
            return np.zeros(tuple(p.shape), np.float32)
        return map_tree(get, params)

    return {"count": np.int32(count), "mu": moment("exp_avg"),
            "nu": moment("exp_avg_sq")}


def adam_state_from_jax(opt_state, params, optimizer: torch.optim.Optimizer) -> None:
    """Load optax Adam state (count, mu, nu) into ``optimizer``'s state for
    the parameter tree ``params`` (torch's step, exp_avg, exp_avg_sq),
    matching leaves by their dotted path. The update rules are the same: lr
    * mu_hat / (sqrt(nu_hat) + eps) with the bias corrections of step count
    + 1."""
    found = _find_adam_state(opt_state)
    if found is None:
        raise ValueError("no Adam (count, mu, nu) state found")
    count, mu, nu = found
    mu, nu = flatten_tree(mu), flatten_tree(nu)
    for name, p in flatten_tree(params).items():
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(mu[name]), device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(nu[name]), device=p.device),
        }


def split_population(params, opt_state, n_trials: int) -> list:
    """The JAX package's ``PopulationTrainer`` state, whose leaves carry the
    trial on their leading axis: its stacked parameter tree and its vmapped
    ``scale_by_adam`` state (count (T,), mu and nu stacked) -> one
    ``(parameter tree of numpy arrays, {"count", "mu", "nu"})`` pair a
    trial, for ``params_from_jax`` and ``adam_state_from_jax``."""
    found = _find_adam_state(opt_state)
    if found is None:
        raise ValueError("no Adam (count, mu, nu) state found")
    count, mu, nu = found
    count = np.asarray(count).reshape(-1)

    def take(tree, t):
        return map_tree(lambda v: np.array(np.asarray(v)[t]), tree)

    return [(take(params, t), {"count": np.int32(count[t if count.size > 1 else 0]),
                               "mu": take(mu, t), "nu": take(nu, t)})
            for t in range(n_trials)]


# -- sharded params: the JAX package's global arrays <-> this rank's blocks ---

# The JAX sharded steps' table-sharded parameters and how their global
# arrays split: ``parallel/steps`` holds one (n_templates_pad, d) table in
# row blocks; ``parallel/dense_steps`` stacks (T, rows, d) per shard.
SHARDED_ROWS = {"embedding"}
SHARDED_STACKED = {"emb_u", "emb_i"}


def sharded_params_from_jax(params: dict, mesh, device=None) -> dict:
    """{name: array} global params of a JAX sharded step at the same table
    size (numpy, or anything ``np.asarray`` takes) -> this rank's tensors
    on ``device`` (the mesh's by default): the row block ``t`` of
    ``embedding``, the shard ``t`` of ``emb_u``/``emb_i``, the rest
    whole."""
    device = mesh.device if device is None else device
    out = {}
    for name, v in params.items():
        a = np.asarray(v)
        if name in SHARDED_ROWS:
            rows = a.shape[0] // mesh.table
            a = a[mesh.t * rows: (mesh.t + 1) * rows]
        elif name in SHARDED_STACKED:
            a = a[mesh.t]
        out[name] = torch.tensor(np.array(a), device=device)
    return out


def sharded_params_to_jax(params: dict, mesh) -> dict:
    """This rank's param blocks -> the JAX sharded step's global numpy
    arrays, gathered along ``table`` (every table rank joins)."""
    from igcn_cf_tpu_torch.core.mesh import to_host_replicated

    out = {}
    for name, t in params.items():
        if name in SHARDED_ROWS:
            out[name] = to_host_replicated(t, mesh)
        elif name in SHARDED_STACKED:
            out[name] = to_host_replicated(t.detach()[None], mesh)
        else:
            out[name] = t.detach().cpu().numpy().copy()
    return out
