"""Soak run (port of ``tools/soak_gowalla.py``): IGCN at the Gowalla-scale
synthetic catalog of ``bench.py`` (29,858 users x 40,981 items, average
degree 34.4, seed 2021) trained to early stop on one card, to show the
numbers stay finite, memory holds and the run converges.

    python -m igcn_cf_tpu_torch.tools.soak_gowalla [--epochs N] [--out PATH]
        [--device cuda|cpu]

The model and trainer settings are the JAX tool's (d = 64, 3 layers,
dropout 0.3; Adam 1e-3, aux_reg 0.01, batch 2048, at most 120 epochs, a
validation every 5, patience 30, a training-state snapshot every 10). The
catalog is generated once with the port's ``synthetic_interactions`` and
cached in ``.datasets/``. The record (best val NDCG@20, test metrics,
epochs, seconds, backend, engine and the device as nvidia-smi names it with
its power limit) goes under ``IGCN_full_scale`` in ``--out``
(``PARITY_RESULTS_TORCH.json`` at the root).
"""

from __future__ import annotations

import argparse
import time

from igcn_cf_tpu_torch.core.prng import set_seed
from igcn_cf_tpu_torch.data.synthetic import cached_synthetic_interactions
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.tools import DATASET_CACHE, device_line, update_json
from igcn_cf_tpu_torch.tools.parity_run import DEFAULT_OUT, engine_of
from igcn_cf_tpu_torch.train.trainer import get_trainer

N_EPOCHS = 120
# bench.py:41-43 and its seed
CATALOG = dict(n_users=29858, n_items=40981, avg_degree=34.4, seed=2021,
               name="gowalla_scale_synth")
MODEL_CFG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
             "dropout": 0.3, "feature_ratio": 1.0}
TRAINER_CFG = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
               "l2_reg": 0.0, "aux_reg": 0.01, "batch_size": 2048,
               "test_batch_size": 512, "topks": [20], "val_interval": 5,
               "max_patience": 30, "state_interval": 10}


def dataset_path(catalog) -> str:
    return str(DATASET_CACHE / "synth_{n_users}x{n_items}_s{seed}.npz".format(
        **catalog))


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=N_EPOCHS)
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (the plain versions)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    ds = cached_synthetic_interactions(dataset_path(CATALOG), **CATALOG)
    print(f"dataset: {ds.n_users} users {ds.n_items} items {len(ds)} "
          f"interactions; {where}", flush=True)
    set_seed(2021)
    model = get_model(dict(MODEL_CFG), ds, args.device)
    trainer = get_trainer(dict(TRAINER_CFG, n_epochs=args.epochs), ds, model)
    t0 = time.time()
    best = trainer.train(verbose=True)
    res, metrics = trainer.eval("test")
    seconds = time.time() - t0
    print(f"DONE best val NDCG@20 {best:.4f}; test {res}; {seconds:.0f}s",
          flush=True)
    record = {
        "val_ndcg20": float(best),
        "test": {m: {str(k): v for k, v in d.items()} for m, d in metrics.items()},
        "epochs": trainer.epoch + 1,
        "train_seconds": seconds,
        "backend": model.backend,
        "engine": engine_of(model),
        "engine_ab": model.engine_ab,
        "device": where,
    }
    update_json(args.out, "IGCN_full_scale", record)
    return record


if __name__ == "__main__":
    main()
