"""Behavioural parity run (port of ``tools/parity_run.py``): train MF,
LightGCN, IMF and IGCN to early stop on the quarter-Gowalla synthetic
catalog and check the reference's model ordering (MF < LightGCN < IGCN, IMF
between MF and IGCN: reference run/plot.py:101-108, BASELINE.md).

    python -m igcn_cf_tpu_torch.tools.parity_run [--epochs N] [--out PATH]
        [--device cuda|cpu]

The four configurations, the catalog (7,464 users x 10,245 items, average
degree 9, seed 77: Gowalla's density at a quarter of its catalog), 300
epochs with a validation every 5 and patience 30, and ``set_seed(2021)``
before each model are the JAX tool's; a run cut below 5 epochs validates
at its last epoch. Each model's record (best val
NDCG@20, the test metrics, epochs, seconds, graph backend and training
engine, and the device as nvidia-smi names it with its power limit) is
written to ``--out`` (``PARITY_RESULTS_TORCH.json`` at the root) as it
finishes; the last line printed is the ordering's verdict. Best
checkpoints land in ``checkpoints/`` under the working directory.
"""

from __future__ import annotations

import argparse
import time

from igcn_cf_tpu_torch.core.prng import set_seed
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.tools import ROOT, device_line, update_json
from igcn_cf_tpu_torch.train.trainer import get_trainer

N_EPOCHS = 300  # MF converges slowest at lr 1e-3 (the reference trains 1000)
VAL_INTERVAL = 5
PATIENCE = 30
DEFAULT_OUT = ROOT / "PARITY_RESULTS_TORCH.json"
# Gowalla's density, not its degree: at a quarter of the catalog its ~0.08%
# density means an average degree of ~9
CATALOG = dict(n_users=29858 // 4, n_items=40981 // 4, avg_degree=9, seed=77,
               name="parity_q")

CONFIGS = [
    ("MF", {"name": "MF", "embedding_size": 64},
     {"name": "BPRTrainer", "lr": 1e-3, "l2_reg": 1e-4}),
    ("LightGCN", {"name": "LightGCN", "embedding_size": 64, "n_layers": 3},
     {"name": "BPRTrainer", "lr": 1e-3, "l2_reg": 1e-4}),
    ("IMF", {"name": "IMF", "embedding_size": 64, "n_layers": 0,
             "dropout": 0.1, "feature_ratio": 1.0},
     {"name": "IGCNTrainer", "lr": 1e-3, "l2_reg": 1e-5, "aux_reg": 0.01}),
    ("IGCN", {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
              "dropout": 0.3, "feature_ratio": 1.0},
     {"name": "IGCNTrainer", "lr": 1e-3, "l2_reg": 0.0, "aux_reg": 0.01}),
]
ORDER = ("MF", "LightGCN", "IGCN")


def engine_of(model) -> str:
    """The training engine: 'pcache' (the propagation cache), 'recompute',
    or 'n/a' for a model that has no propagation engine."""
    if not hasattr(model, "pcache"):
        return "n/a"
    return "pcache" if model.pcache else "recompute"


def train_to_early_stop(model_cfg, trainer_cfg, ds, n_epochs, device):
    """One configuration from ``set_seed(2021)`` to its early stop (or
    ``n_epochs``), its best checkpoint reloaded and tested. Returns the JAX
    tool's record, plus the backend's and engine's names and the A/B
    entry, and the test result's line."""
    set_seed(2021)
    trainer_cfg = dict(trainer_cfg, optimizer="Adam", n_epochs=n_epochs,
                       batch_size=2048, test_batch_size=512, topks=[20],
                       val_interval=min(VAL_INTERVAL, n_epochs),
                       max_patience=PATIENCE)
    t0 = time.time()
    model = get_model(model_cfg, ds, device)
    trainer = get_trainer(trainer_cfg, ds, model)
    best = trainer.train(verbose=False)
    res_str, metrics = trainer.eval("test")
    seconds = time.time() - t0
    return {
        "val_ndcg20": float(best),
        "test": {m: {str(k): v for k, v in d.items()} for m, d in metrics.items()},
        "epochs": trainer.epoch + 1,
        "train_seconds": seconds,
        "backend": getattr(model, "backend", "n/a"),
        "engine": engine_of(model),
        "engine_ab": getattr(model, "engine_ab", None),
    }, res_str


def ordering_line(results) -> str:
    ndcgs = [results[m]["test"]["NDCG"]["20"] for m in ORDER]
    ok = ndcgs[0] <= ndcgs[1] <= ndcgs[2]
    return f"ordering MF <= LightGCN <= IGCN: {ndcgs} {'OK' if ok else 'VIOLATED'}"


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=N_EPOCHS,
                        help="epochs at most per model (a cut run)")
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (the plain versions)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    ds = synthetic_interactions(**CATALOG)
    print(f"dataset: {ds.n_users} users {ds.n_items} items {len(ds)} "
          f"interactions; {where}", flush=True)
    results = {}
    for name, model_cfg, trainer_cfg in CONFIGS:
        record, test_line = train_to_early_stop(model_cfg, trainer_cfg, ds,
                                                args.epochs, args.device)
        record["device"] = where
        results = update_json(args.out, name, record)
        print(f"{name}: best val NDCG@20 {record['val_ndcg20']:.4f} | test "
              f"{test_line} | {record['epochs']} epochs in "
              f"{record['train_seconds']:.0f}s ({record['backend']}, "
              f"{record['engine']})", flush=True)
    print(ordering_line(results), flush=True)
    return results


if __name__ == "__main__":
    main()
