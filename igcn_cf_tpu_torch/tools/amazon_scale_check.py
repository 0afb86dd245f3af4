"""Amazon-book-scale engine check (port of ``tools/amazon_scale_check.py``):
IGCN on a synthetic catalog of the INMO paper's Amazon-book split shape,
52,643 users x 91,599 items (average degree 40, seed 11), trained for 30
timed steps after 30 warm-up steps on each graph backend.

    python -m igcn_cf_tpu_torch.tools.amazon_scale_check [--out PATH]
        [--device cuda|cpu]

First the dense backend with ``prop_cache='auto'``: the capacity gate
(``kernels/pcache.use_pcache``) decides whether P (~41.6 GB in bf16 at this
shape) is admitted on the card, and if it is, P is built and the measured
A/B (``model.engine_ab``) picks the engine. Then the same steps on
``graph_backend='sparse'``. The record (P's admission, bytes and build
seconds, the A/B entry with both engines' ms, each backend's step ms,
examples/s, last loss and peak device memory, and the device as nvidia-smi
names it with its power limit) goes to ``--out``
(``AMAZON_SCALE_TORCH.json`` at the root); ``amazon_serve_check`` adds
its serving section there. The catalog is generated once with the port's
``synthetic_interactions`` and cached in ``.datasets/``.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import torch

from igcn_cf_tpu_torch.data.synthetic import cached_synthetic_interactions
from igcn_cf_tpu_torch.kernels.pcache import (
    pcache_budget_bytes,
    pcache_bytes,
    use_pcache,
)
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.tools import ROOT, device_line, update_json
from igcn_cf_tpu_torch.tools.soak_gowalla import dataset_path
from igcn_cf_tpu_torch.train.trainer import get_trainer

CATALOG = dict(n_users=52643, n_items=91599, avg_degree=40, seed=11,
               name="amazon_scale_synth")
DEFAULT_OUT = ROOT / "AMAZON_SCALE_TORCH.json"
N_STEPS = 30
BATCH = 2048
MODEL_CFG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
             "dropout": 0.0, "feature_ratio": 1.0, "prop_cache": "auto"}
TRAINER_CFG = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
               "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1,
               "batch_size": BATCH, "test_batch_size": 512, "topks": [20]}


def load_catalog():
    return cached_synthetic_interactions(dataset_path(CATALOG), **CATALOG)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_steps(ds, backend: str, device) -> dict:
    """IGCN on ``backend``: its init (P's build and the A/B on the dense
    backend) timed, then ``N_STEPS`` warm-up steps and ``N_STEPS`` timed
    steps (each run ends in a read-back of its mean loss)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model_cfg = dict(MODEL_CFG, graph_backend=backend)
    model = get_model(model_cfg, ds, device)
    admitted = model.pcache
    _sync(device)
    t0 = time.perf_counter()
    trainer = get_trainer(dict(TRAINER_CFG), ds, model)
    _sync(device)
    init_s = time.perf_counter() - t0
    trainer.steps_per_epoch = lambda: N_STEPS
    t0 = time.perf_counter()
    warm_loss = trainer.train_one_epoch()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss = trainer.train_one_epoch()
    dt = time.perf_counter() - t0
    record = {
        "backend": model.backend,
        "pcache_admitted": bool(admitted),
        "pcache": bool(model.pcache),
        "engine_ab": model.engine_ab,
        "init_s": init_s,
        "warmup_s": warm_s,
        "warmup_loss": warm_loss,
        "steps": N_STEPS,
        "batch_size": BATCH,
        "step_ms": 1000.0 * dt / N_STEPS,
        "examples_per_s": N_STEPS * BATCH / dt,
        "loss": loss,
    }
    if device.type == "cuda":
        record["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    print(f"# {backend}: {json.dumps(record)}", flush=True)
    del trainer, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (the plain versions)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    t0 = time.perf_counter()
    ds = load_catalog()
    print(f"# {ds.n_users} users {ds.n_items} items {len(ds)} interactions "
          f"(read or generated in {time.perf_counter() - t0:.1f} s); {where}",
          flush=True)
    dev = torch.device(args.device)
    result = {
        "catalog": [ds.n_users, ds.n_items],
        "interactions": len(ds),
        "device": where,
        "pcache_bytes": pcache_bytes(ds.n_users, ds.n_items),
        "pcache_budget_bytes": (pcache_budget_bytes(dev)
                                if dev.type == "cuda" else None),
        "pcache_gate": use_pcache(ds.n_users, ds.n_items,
                                  MODEL_CFG["n_layers"], "auto", dev),
    }
    result["dense"] = timed_steps(ds, "dense", dev)
    result["sparse"] = timed_steps(ds, "sparse", dev)
    for key, value in result.items():
        update_json(args.out, key, value)
    return result


if __name__ == "__main__":
    main()
