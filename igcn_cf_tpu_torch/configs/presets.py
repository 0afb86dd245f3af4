"""Tuned configuration triples (dataset, model, trainer) per dataset.

A copy of the JAX package's ``configs/presets.py``: plain dicts, the
reference's hyperparameters (reference config.py:1-207): 10 Gowalla
configs, 10 Yelp, 8 Amazon, indexed by position (index 2 = IGCN, the paper
model -- reference run/run.py:16). Device fields and dataloader worker
counts are dropped: the device is an argument of the port's models, and
sampling runs on it. Ported so far: IGCN/IMF with IGCNTrainer, LightGCN and
NGCF with BPRTrainer; ``get_model`` refuses the other names."""

from __future__ import annotations

from typing import Dict, List, Tuple

Triple = Tuple[dict, dict, dict]


def _bpr_trainer(lr, l2_reg, **kw) -> dict:
    cfg = {
        "name": "BPRTrainer",
        "optimizer": "Adam",
        "lr": lr,
        "l2_reg": l2_reg,
        "n_epochs": 1000,
        "batch_size": 2048,
        "test_batch_size": 512,
        "topks": [20],
    }
    cfg.update(kw)
    return cfg


def _igcn_trainer(lr, l2_reg, aux_reg, **kw) -> dict:
    cfg = _bpr_trainer(lr, l2_reg, **kw)
    cfg.update({"name": "IGCNTrainer", "aux_reg": aux_reg})
    return cfg


def get_gowalla_config(data_path: str = "data/Gowalla/time") -> List[Triple]:
    """reference config.py:1-73."""
    dataset_config = {"name": "ProcessedDataset", "path": data_path,
                      "dataset_name": "Gowalla"}
    cfg: List[Triple] = []

    cfg.append((dataset_config,
                {"name": "MF", "embedding_size": 64},
                _bpr_trainer(1e-4, 1e-3)))
    cfg.append((dataset_config,
                {"name": "LightGCN", "embedding_size": 64, "n_layers": 3},
                _bpr_trainer(1e-3, 1e-4)))
    cfg.append((dataset_config,
                {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
                 "dropout": 0.3, "feature_ratio": 1.0},
                _igcn_trainer(1e-3, 0.0, 0.01)))
    cfg.append((dataset_config,
                {"name": "ItemKNN", "k": 1000},
                {"name": "BasicTrainer", "n_epochs": 0,
                 "test_batch_size": 512, "topks": [20]}))
    cfg.append((dataset_config,
                {"name": "NGCF", "embedding_size": 64,
                 "layer_sizes": [64, 64, 64], "dropout": 0.1},
                _bpr_trainer(1e-3, 1e-3)))
    cfg.append((dataset_config,
                {"name": "MultiVAE", "layer_sizes": [64, 32], "dropout": 0.7},
                {"name": "MLTrainer", "optimizer": "Adam", "lr": 1e-3,
                 "l2_reg": 1e-4, "kl_reg": 0.2, "n_epochs": 1000,
                 "batch_size": 512, "test_batch_size": 512, "topks": [20]}))
    cfg.append((dataset_config,
                {"name": "IMF", "embedding_size": 64, "n_layers": 0,
                 "dropout": 0.1, "feature_ratio": 1.0},
                _igcn_trainer(1e-3, 1e-5, 0.1)))
    cfg.append((dataset_config,
                {"name": "IMCGAE", "embedding_size": 64, "n_layers": 3,
                 "dropout": 0.3},
                _bpr_trainer(1e-3, 0.0)))
    cfg.append((dataset_config,
                {"name": "IDCF_LGCN", "embedding_size": 64, "n_layers": 3,
                 "n_headers": 4, "lgcn_path": "lgcn.pkl"},
                {"name": "IDCFTrainer", "optimizer": "Adam", "lr": 1e-3,
                 "l2_reg": 1e-4, "contrastive_reg": 1e-3, "n_epochs": 1000,
                 "batch_size": 2048, "test_batch_size": 512, "topks": [20]}))
    cfg.append((dict(dataset_config, neg_ratio=4),
                {"name": "NeuMF", "embedding_size": 64,
                 "layer_sizes": [64, 64, 64]},
                {"name": "BCETrainer", "optimizer": "Adam", "lr": 1e-3,
                 "l2_reg": 1e-3, "n_epochs": 1000, "batch_size": 2048,
                 "test_batch_size": 64, "topks": [20],
                 "mf_pretrain_epochs": 100, "mlp_pretrain_epochs": 100,
                 "max_patience": 100}))
    return cfg


def get_yelp_config(data_path: str = "data/Yelp/time") -> List[Triple]:
    """reference config.py:76-148."""
    dataset_config = {"name": "ProcessedDataset", "path": data_path,
                      "dataset_name": "Yelp"}
    cfg: List[Triple] = []

    cfg.append((dataset_config,
                {"name": "MF", "embedding_size": 64},
                _bpr_trainer(1e-3, 1e-3)))
    cfg.append((dataset_config,
                {"name": "LightGCN", "embedding_size": 64, "n_layers": 3},
                _bpr_trainer(1e-3, 1e-4)))
    cfg.append((dataset_config,
                {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
                 "dropout": 0.3, "feature_ratio": 1.0},
                _igcn_trainer(1e-3, 0.0, 0.01)))
    cfg.append((dataset_config,
                {"name": "ItemKNN", "k": 1000},
                {"name": "BasicTrainer", "n_epochs": 0,
                 "test_batch_size": 512, "topks": [20]}))
    cfg.append((dataset_config,
                {"name": "NGCF", "embedding_size": 64,
                 "layer_sizes": [64, 64, 64], "dropout": 0.3},
                _bpr_trainer(1e-3, 1e-3)))
    cfg.append((dataset_config,
                {"name": "MultiVAE", "layer_sizes": [64, 32], "dropout": 0.7},
                {"name": "MLTrainer", "optimizer": "Adam", "lr": 1e-3,
                 "l2_reg": 1e-4, "kl_reg": 0.2, "n_epochs": 1000,
                 "batch_size": 512, "test_batch_size": 512, "topks": [20]}))
    cfg.append((dataset_config,
                {"name": "IMF", "embedding_size": 64, "n_layers": 0,
                 "dropout": 0.5, "feature_ratio": 1.0},
                _igcn_trainer(1e-3, 1e-5, 0.01)))
    cfg.append((dataset_config,
                {"name": "IMCGAE", "embedding_size": 64, "n_layers": 3,
                 "dropout": 0.3},
                _bpr_trainer(1e-3, 0.0)))
    cfg.append((dataset_config,
                {"name": "IDCF_LGCN", "embedding_size": 64, "n_layers": 3,
                 "n_headers": 4, "lgcn_path": "lgcn.pkl"},
                {"name": "IDCFTrainer", "optimizer": "Adam", "lr": 1e-3,
                 "l2_reg": 1e-4, "contrastive_reg": 1e-3, "n_epochs": 1000,
                 "batch_size": 2048, "test_batch_size": 512, "topks": [20]}))
    cfg.append((dict(dataset_config, neg_ratio=4),
                {"name": "NeuMF", "embedding_size": 64,
                 "layer_sizes": [64, 64, 64]},
                {"name": "BCETrainer", "optimizer": "Adam", "lr": 1e-2,
                 "l2_reg": 1e-2, "n_epochs": 1000, "batch_size": 2048,
                 "test_batch_size": 64, "topks": [20],
                 "mf_pretrain_epochs": 100, "mlp_pretrain_epochs": 100,
                 "max_patience": 100}))
    return cfg


def get_amazon_config(data_path: str = "data/Amazon/time") -> List[Triple]:
    """reference config.py:151-207 (8 configs; no IDCF/NeuMF)."""
    dataset_config = {"name": "ProcessedDataset", "path": data_path,
                      "dataset_name": "Amazon"}
    cfg: List[Triple] = []

    cfg.append((dataset_config,
                {"name": "MF", "embedding_size": 64},
                _bpr_trainer(1e-3, 1e-4)))
    cfg.append((dataset_config,
                {"name": "LightGCN", "embedding_size": 64, "n_layers": 3},
                _bpr_trainer(1e-3, 1e-5)))
    cfg.append((dataset_config,
                {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
                 "dropout": 0.0, "feature_ratio": 1.0},
                _igcn_trainer(1e-3, 0.0, 0.01)))
    cfg.append((dataset_config,
                {"name": "ItemKNN", "k": 10},
                {"name": "BasicTrainer", "n_epochs": 0,
                 "test_batch_size": 512, "topks": [20]}))
    cfg.append((dataset_config,
                {"name": "NGCF", "embedding_size": 64,
                 "layer_sizes": [64, 64, 64], "dropout": 0.3},
                _bpr_trainer(1e-3, 1e-4)))
    cfg.append((dataset_config,
                {"name": "MultiVAE", "layer_sizes": [64, 32], "dropout": 0.7},
                {"name": "MLTrainer", "optimizer": "Adam", "lr": 1e-3,
                 "l2_reg": 1e-5, "kl_reg": 0.2, "n_epochs": 1000,
                 "batch_size": 512, "test_batch_size": 512, "topks": [20]}))
    cfg.append((dataset_config,
                {"name": "IMF", "embedding_size": 64, "n_layers": 0,
                 "dropout": 0.3, "feature_ratio": 1.0},
                _igcn_trainer(1e-3, 1e-5, 0.1)))
    cfg.append((dataset_config,
                {"name": "IMCGAE", "embedding_size": 64, "n_layers": 3,
                 "dropout": 0.9},
                _bpr_trainer(1e-3, 0.0)))
    return cfg


_GETTERS = {
    "gowalla": get_gowalla_config,
    "yelp": get_yelp_config,
    "amazon": get_amazon_config,
}


def get_config(dataset: str, index: int, data_path: str | None = None) -> Triple:
    getter = _GETTERS[dataset.lower()]
    cfgs = getter(data_path) if data_path else getter()
    return cfgs[index]
