"""Mesh-shape scaling of the sharded INMO trainer (port of
``tools/scaling_harness.py``) -> ``SCALING_TORCH.json``.

    python -m igcn_cf_tpu_torch.tools.scaling_harness [--out PATH]
        [--device cuda|cpu]
    torchrun --nproc-per-node N -m igcn_cf_tpu_torch.tools.scaling_harness

For every factorisation (data, table) of the world's size into powers of
two (``shapes``), a ``parallel/trainer.ShardedIGCNTrainer`` (IGCN, d=64,
3 layers, dropout 0.3, feature_ratio 1.0; its engine by the sharded
gate: the cache engine where a rank's slab fits the card) is built on
``make_mesh(data, table)`` and timed: the build, one warm-up epoch, then
``epochs_timed`` epochs and one sharded ``eval('val')``. Reported: each
shape's examples/s and its speedup over the first shape.

On the card: the quarter catalog (7,464 x 10,245, average degree 9, seed
5) at batch 2,048, 3 timed epochs. On the CPU (gloo): the JAX tool's toy
catalog (512 x 768, average degree 12) at batch 256, 6 timed epochs, and
the least-squares fit of the shared-core work model epoch_s ~ a * data +
b * table + c over the shapes (the ranks share the host's cores, so wall
time follows the total work, and the table-sharded propagation is
repeated on every data row). A shape that fails is recorded with its
error, as the JAX tool records it, and the run then raises after the
record is written. Rank 0 writes the record. One process a rank: NCCL
one a card; ranks that share a card run over a gloo group their caller
starts.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from igcn_cf_tpu_torch.core.mesh import make_mesh
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.parallel.trainer import ShardedIGCNTrainer
from igcn_cf_tpu_torch.tools import ROOT, device_line, process_world

DEFAULT_OUT = ROOT / "SCALING_TORCH.json"
# (catalog, batch, timed epochs): small on the CPU, the quarter catalog on
# the card
CPU_RUN = (dict(n_users=512, n_items=768, avg_degree=12, seed=5,
                name="scaling_cpu"), 256, 6)
CARD_RUN = (dict(n_users=29858 // 4, n_items=40981 // 4, avg_degree=9, seed=5,
                 name="scaling_q"), 2048, 3)
MODEL_CFG = {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
             "dropout": 0.3, "feature_ratio": 1.0}


def shapes(n: int) -> list:
    """(data, table) with data a power of two dividing ``n``, data rising."""
    out = []
    d = 1
    while d <= n:
        if n % d == 0:
            out.append((d, n // d))
        d *= 2
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_shape(ds, data: int, table: int, batch: int, epochs_timed: int,
               device, backend) -> dict:
    """One mesh shape's build, epoch and eval walls."""
    mesh = make_mesh(data, table, device=device, backend=backend)
    _sync(mesh.device)
    t0 = time.perf_counter()
    tr = ShardedIGCNTrainer(
        {"topks": [20], "n_epochs": 1, "val_interval": 1, "lr": 1e-3,
         "aux_reg": 0.01, "batch_size": batch, "test_batch_size": 256},
        ds, mesh, dict(MODEL_CFG))
    _sync(mesh.device)
    build_s = time.perf_counter() - t0
    tr.train_one_epoch()  # warm-up
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(epochs_timed):
        tr.train_one_epoch()  # each ends in a read-back of its loss
    dt = (time.perf_counter() - t0) / epochs_timed
    t0 = time.perf_counter()
    tr.eval("val")
    eval_s = time.perf_counter() - t0
    steps = tr.train_state.steps_per_epoch
    return {"examples_per_s": steps * batch / dt, "epoch_s": dt,
            "eval_s": eval_s, "build_s": build_s,
            "engine": "cache" if tr.train_state.use_pcache else "sparse"}


def workmodel(fitted: list) -> dict:
    """Least-squares epoch_s ~ a * data + b * table + c over (data, table,
    epoch_s) rows."""
    a = np.array([[d, t, 1.0] for d, t, _ in fitted])
    y = np.array([e for _, _, e in fitted])
    coef = np.linalg.lstsq(a, y, rcond=None)[0]
    pred = a @ coef
    return {"per_data_s": float(coef[0]), "per_table_s": float(coef[1]),
            "const_s": float(coef[2]),
            "relerr": float(np.abs(pred - y).max() / y.max())}


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (gloo, the plain versions)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    on_cpu = torch.device(args.device).type == "cpu"
    catalog, batch, epochs_timed = CPU_RUN if on_cpu else CARD_RUN
    ds = synthetic_interactions(**catalog)
    with process_world(args.device) as (world, backend):
        rank = dist.get_rank()
        results = {
            "platform": where,
            "n_devices": world,
            "process_count": world,
            "backend": backend,
            "dataset": {"users": ds.n_users, "items": ds.n_items, "nnz": len(ds)},
            "batch_size": batch,
            "epochs_timed": epochs_timed,
            "shapes": {},
        }
        if on_cpu:
            results["analysis"] = (
                "the ranks share the host's cores, so wall time tracks the "
                "total work ~ data * W_prop + table * W_loss + const: the "
                "table-sharded propagation is repeated on every data row "
                "and the repeats run one after another on shared cores. "
                "See workmodel.")
        base_rate = None
        failed = []
        for data, table in shapes(world):
            tag = f"{data}x{table}"
            try:
                rec = time_shape(ds, data, table, batch, epochs_timed,
                                 args.device, backend)
            except Exception as e:  # a shape that fails is the finding
                results["shapes"][tag] = {"error": f"{type(e).__name__}: {e}"}
                failed.append(tag)
                print(f"{tag:8s} FAILED on rank {rank}: {e}", flush=True)
                traceback.print_exc()
                continue
            if base_rate is None:
                base_rate = rec["examples_per_s"]
            rec["speedup_vs_first"] = rec["examples_per_s"] / base_rate
            results["shapes"][tag] = rec
            if rank == 0:
                print(f"{tag:8s} {rec['examples_per_s']:12,.0f} ex/s  epoch "
                      f"{rec['epoch_s']:.4f} s  eval {rec['eval_s']:.4f} s  "
                      f"({rec['engine']} engine)", flush=True)
        fitted = [(d, t, results["shapes"][f"{d}x{t}"]["epoch_s"])
                  for d, t in shapes(world)
                  if "epoch_s" in results["shapes"][f"{d}x{t}"]]
        if on_cpu and len(fitted) >= 3:
            results["workmodel"] = workmodel(fitted)
            if rank == 0:
                print(f"workmodel fit: {results['workmodel']}", flush=True)
        if rank == 0:
            Path(args.out).write_text(json.dumps(results, indent=2) + "\n")
            print(f"wrote {args.out}", flush=True)
    if failed:
        raise RuntimeError(f"mesh shapes failed: {failed} (recorded in "
                           f"{args.out})")
    return results


if __name__ == "__main__":
    main()
