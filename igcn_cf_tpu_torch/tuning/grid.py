"""Hyperparameter grid search (port of ``igcn_cf_tpu/tuning/grid.py``).

One harness replaces the reference's ten near-identical scripts
(reference hyperparameter/*.py): for each grid point, reseed, rebuild
dataset/model/trainer, train to best validation NDCG, track the argmax
(reference hyperparameter/mf_tuning.py:10-39). Grids below are the
reference's own, per model (reference hyperparameter/*_tuning.py; tuned on
the temporal 'time' split, reference hyperparameter/igcn_tuning.py:13).

Param routing: keys ending in the model's config fields (dropout, k) go to
the model config; the rest (lr, l2_reg, aux_reg, contrastive_reg) to the
trainer config. Models run on ``device``: the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional

import numpy as np

from igcn_cf_tpu_torch.configs import get_config
from igcn_cf_tpu_torch.core.prng import set_seed
from igcn_cf_tpu_torch.data.dataset import get_dataset
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.train.trainer import get_trainer

# reference grids (hyperparameter/*_tuning.py)
GRIDS: Dict[str, Dict[str, list]] = {
    "MF": {"lr": [1e-4, 1e-3, 1e-2], "l2_reg": [1e-4, 1e-3, 1e-2]},
    "LightGCN": {"lr": [1e-3], "l2_reg": [0.0, 1e-5, 1e-4, 1e-3]},
    "IGCN": {
        "lr": [1e-3],
        "l2_reg": [0.0, 1e-5],
        "dropout": [0.0, 0.1, 0.3],
        "aux_reg": [1e-3, 1e-2, 1e-1],
    },
    "IMF": {
        "lr": [1e-3],
        "l2_reg": [1e-5, 1e-4],
        "dropout": [0.1, 0.3, 0.5],
        "aux_reg": [1e-3, 1e-2, 1e-1],
    },
    "NGCF": {"lr": [1e-3], "l2_reg": [1e-4, 1e-3], "dropout": [0.0, 0.1, 0.3]},
    "IMCGAE": {"lr": [1e-3], "l2_reg": [0.0, 1e-5], "dropout": [0.3, 0.5, 0.7, 0.9]},
    "IDCF_LGCN": {
        "lr": [1e-3],
        "l2_reg": [0.0, 1e-5, 1e-4],
        "contrastive_reg": [1e-4, 1e-3, 1e-2],
    },
    "MultiVAE": {
        "lr": [1e-3, 1e-2],
        "l2_reg": [1e-5, 1e-4, 1e-3],
        "dropout": [0.3, 0.5, 0.7],
    },
    "NeuMF": {"lr": [1e-3, 1e-2], "l2_reg": [1e-5, 1e-4, 1e-3, 1e-2]},
    "ItemKNN": {"k": [10, 50, 200, 1000]},
}

_MODEL_KEYS = {"dropout", "k", "feature_ratio", "ranking_metric"}


def parameter_grid(grid: Dict[str, list]) -> Iterable[dict]:
    """sklearn.ParameterGrid order: sorted keys, last key varies fastest."""
    keys = sorted(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        yield dict(zip(keys, combo))


def split_configs(model_config: dict, trainer_config: dict, params: dict):
    """(model config, trainer config) with each key of ``params`` routed to
    the model's (``_MODEL_KEYS``) or the trainer's."""
    mc, tc = dict(model_config), dict(trainer_config)
    for k, v in params.items():
        (mc if k in _MODEL_KEYS else tc)[k] = v
    return mc, tc


def grid_search(dataset_config, model_config, trainer_config,
                grid: Dict[str, list], seed: int = 2021, verbose: bool = True,
                device="cuda"):
    """One full training a grid point, in ``parameter_grid`` order; each
    trial's line is printed as it ends."""
    max_ndcg = -np.inf
    best_params = None
    trials: List[dict] = []
    for params in parameter_grid(grid):
        set_seed(seed)
        mc, tc = split_configs(model_config, trainer_config, params)
        dataset = get_dataset(dataset_config)
        model = get_model(mc, dataset, device)
        trainer = get_trainer(tc, dataset, model)
        ndcg = trainer.train(verbose=verbose)
        trials.append({"params": params, "ndcg": float(ndcg)})
        print("NDCG: {:.3f}, Parameters: {:s}".format(ndcg, str(params)))
        if ndcg > max_ndcg:
            max_ndcg = ndcg
            best_params = params
            print("Maximum NDCG!")
    print(
        "Maximum NDCG: {:.3f}, Best Parameters: {:s}".format(max_ndcg, str(best_params))
    )
    return {"best_ndcg": float(max_ndcg), "best_params": best_params, "trials": trials}


def tune_preset(dataset: str, config_index: int, data_path=None, seed: int = 2021,
                population: str | bool = "auto", device="cuda",
                n_epochs: Optional[int] = None, mesh=None):
    """Tune one preset's reference grid.

    ``population`` selects the search engine: ``True`` forces the population
    search (tuning/population.py), ``False`` the reference-style sequential
    loop, and ``"auto"`` (default) picks population when the model's trainer
    is BPR-family and the grid has more than one combination per group of
    non-traced keys. ``n_epochs`` cuts the preset's epochs (the JAX package
    always runs the preset's). ``mesh``: a trial mesh over which the
    population search splits its trials (the sequential search takes
    none)."""
    dc, mc, tc = (dict(c) for c in get_config(dataset, config_index, data_path))
    if n_epochs is not None:
        tc["n_epochs"] = n_epochs
    grid = GRIDS[mc["name"]]
    if population == "auto":
        population = _population_profitable(tc["name"], grid)
    if population:
        from igcn_cf_tpu_torch.tuning.population import population_grid_search

        return population_grid_search(dc, mc, tc, grid, seed=seed, device=device,
                                      mesh=mesh)
    if mesh is not None:
        raise ValueError(f"a trial mesh splits the population search; "
                         f"{mc['name']} ({tc['name']}) tunes sequentially")
    return grid_search(dc, mc, tc, grid, seed=seed, device=device)


def _population_profitable(trainer_name: str, grid: Dict[str, list]) -> bool:
    """Population tuning pays off when >1 grid combos share a group (same
    non-traced keys), for trainers the population loss covers."""
    from igcn_cf_tpu_torch.tuning.population import TRACED_KEYS

    if trainer_name not in ("BPRTrainer", "IGCNTrainer", "IDCFTrainer"):
        return False
    traced_combos = 1
    for k, v in grid.items():
        if k in TRACED_KEYS:
            traced_combos *= len(v)
    return traced_combos > 1
