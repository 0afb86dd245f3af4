"""The validation eval's throughput at the Gowalla scale (port of
``tools/bench_eval.py``): IGCN at d=64, 3 layers, dropout 0.3,
feature_ratio 1.0 on the recompute engine (``prop_cache=False``: the eval
never reads P) over the 29,858 x 40,981 synthetic catalog (average degree
34.4, seed 2021, cached in ``.datasets/``), through ``IGCNTrainer.eval``.

    python -m igcn_cf_tpu_torch.tools.bench_eval [reps] [--device cuda|cpu]

Prints the first eval (the exclusion words' pack and the metrics' padded
lists included), each of ``reps`` evals (default 5) with users/s, then the
breakdown of one: the representations (the bit-packed pair, K1/K2, three
layers), ``evaluation.evaluate.recommend`` (the reps again, then K5, with
the ids' copy to the host) and the host ``calculate_metrics``. Every clock
stops after the device has finished.
"""

from __future__ import annotations

import argparse
import time

import torch

from igcn_cf_tpu_torch.data.synthetic import cached_synthetic_interactions
from igcn_cf_tpu_torch.evaluation.evaluate import recommend
from igcn_cf_tpu_torch.evaluation.metrics import calculate_metrics
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.tools import device_line
from igcn_cf_tpu_torch.tools.soak_gowalla import CATALOG, dataset_path
from igcn_cf_tpu_torch.train.trainer import get_trainer

MODEL_CFG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
             "dropout": 0.3, "feature_ratio": 1.0, "prop_cache": False}
TRAINER_CFG = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
               "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1,
               "batch_size": 2048, "test_batch_size": 512, "topks": [20]}


def load_catalog():
    """The Gowalla-scale synthetic catalog (``bench.py:41-43``'s shape and
    seed), read from ``.datasets/`` or generated there once."""
    return cached_synthetic_interactions(dataset_path(CATALOG), **CATALOG)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, device, warmup: int = 1, n: int = 3) -> float:
    """Mean wall milliseconds of ``fn`` over ``n`` calls after ``warmup``,
    the clock stopped after the device finishes."""
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def measure(ds, reps: int, device) -> dict:
    """The eval's walls and breakdown over ``ds`` on ``device``."""
    device = torch.device(device)
    model = get_model(dict(MODEL_CFG), ds, device)
    trainer = get_trainer(dict(TRAINER_CFG), ds, model)
    k = TRAINER_CFG["topks"][0]
    _sync(device)
    t0 = time.perf_counter()
    trainer.eval("val")
    _sync(device)
    first_s = time.perf_counter() - t0
    print(f"# first eval (exclusion words and metric lists built): "
          f"{first_s:.3f} s", flush=True)
    evals_ms = []
    for i in range(reps):
        t0 = time.perf_counter()
        trainer.eval("val")
        _sync(device)
        dt = time.perf_counter() - t0
        evals_ms.append(dt * 1e3)
        print(f"eval[{i}]: {dt * 1e3:9.3f} ms  ({ds.n_users / dt:,.0f} users/s)",
              flush=True)

    params, buffers = trainer.params, trainer.buffers
    with torch.no_grad():
        rep_ms = wall_ms(lambda: model.rep(params, buffers, train=False), device)
        rec_ms = wall_ms(lambda: recommend(model, params, buffers, ds, "val",
                                           k).cpu(), device)
        rec = recommend(model, params, buffers, ds, "val", k).cpu().numpy()
    metrics_ms = wall_ms(lambda: calculate_metrics(ds.val, rec, [k]), device)
    print(f"rep {rep_ms:.3f} ms | recommend {rec_ms:.3f} ms (K5 + D2H "
          f"~{rec_ms - rep_ms:.3f}) | metrics {metrics_ms:.3f} ms", flush=True)
    return {"catalog": [ds.n_users, ds.n_items], "first_eval_s": first_s,
            "evals_ms": evals_ms, "rep_ms": rep_ms, "recommend_ms": rec_ms,
            "metrics_ms": metrics_ms}


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("reps", type=int, nargs="?", default=5)
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (the plain versions)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    ds = load_catalog()
    print(f"# {ds.n_users} users x {ds.n_items} items; {where}", flush=True)
    return dict(measure(ds, args.reps, args.device), device=where)


if __name__ == "__main__":
    main()
