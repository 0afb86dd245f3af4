"""The sharded propagation-cache engine end to end at a mid scale, against
the recompute engine (port of ``tools/sharded_midscale.py``) ->
``SHARDED_MIDSCALE_TORCH.json``.

    python -m igcn_cf_tpu_torch.tools.sharded_midscale
        [--shape USERSxITEMS] [--steps N] [--out PATH] [--device cuda|cpu]
    torchrun --nproc-per-node N -m igcn_cf_tpu_torch.tools.sharded_midscale

The JAX tool's shape: a synthetic catalog of 26,000 x 38,000 (average
degree 16, seed 13), IGCN at d=32, 3 layers, dropout 0, batch 1,024, 5
steps. Over the world's (data, table) mesh (data 2 where the world is
even and above 2, else 1; table the rest) it builds the sharded
cache engine and the recompute engine (``parallel/steps
.build_inmo_sharded_train`` with ``prop_cache`` True and False), runs both
on the same ``make_batch`` batches, and asserts the JAX tool's bounds: each
step's losses within 2e-2 + 2e-2 * |loss|, and the final embeddings'
largest difference under 6e-2 of their largest magnitude. The record
also gives the largest loss gap over |loss| and the final embeddings'
distance between the engines over the recompute engine's own move from
the init (Frobenius norms), which a smoke run holds to tighter limits:
5 steps at lr 1e-3 leave the loss near ln 2 and the embeddings near
their init, where the JAX bounds would pass an engine that propagated
nothing.

On the card each rank builds its slab of P on the device (K6/K7 at the
128-wide block, ``parallel/pcache.build_sharded_pcache``); on the CPU it
builds it on the host from scipy (``prop_cache="host"``: the device
build's plain products are dense there). At a world of 1 the slab
is the whole P, (64,000 x 65,536) bf16, about 8.4 GB; at the JAX tool's
2 x 4 mesh a rank's slab is 64,000 x 16,384, about 2.1 GB. ``--shape`` and
``--steps`` cut a run; the record states the world, the mesh and the
cuts. Rank 0 writes it. One process a rank, NCCL one a card (gloo with
``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from igcn_cf_tpu_torch.core.mesh import make_mesh, to_host_replicated
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.parallel.steps import build_inmo_sharded_train, make_batch
from igcn_cf_tpu_torch.tools import ROOT, device_line, process_world

DEFAULT_OUT = ROOT / "SHARDED_MIDSCALE_TORCH.json"
N_USERS, N_ITEMS, AVG_DEG, SEED = 26000, 38000, 16, 13
D, LAYERS, BATCH, STEPS = 32, 3, 1024, 5
LOSS_ATOL, LOSS_RTOL = 2e-2, 2e-2
EMB_REL = 6e-2


def default_mesh_shape(world: int) -> tuple:
    """(data, table): data 2 where the world is even and above 2 (the JAX
    tool's 2 x 4 on 8), else 1."""
    data = 2 if world % 2 == 0 and world > 2 else 1
    return data, world // data


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(mesh, n_users: int, n_items: int, steps: int) -> dict:
    """Both engines on ``mesh`` over the synthetic catalog, the bounds
    asserted; the record (every rank returns it)."""
    dev = mesh.device
    pcache_build = "device" if dev.type == "cuda" else "host"
    t0 = time.perf_counter()
    ds = synthetic_interactions(n_users=n_users, n_items=n_items,
                                avg_degree=AVG_DEG, seed=SEED,
                                name="midscale_synth")
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"# dataset {ds.n_users}x{ds.n_items} ({len(ds)} interactions) in "
        f"{time.perf_counter() - t0:.1f} s; mesh {mesh.data}x{mesh.table}",
        flush=True)
    kw = dict(embedding_size=D, n_layers=LAYERS, dropout=0.0, lr=1e-3,
              l2_reg=0.0, aux_reg=0.01, batch_size=BATCH, seed=7)
    _sync(dev)
    t0 = time.perf_counter()
    t_cache = build_inmo_sharded_train(
        ds, mesh, prop_cache="host" if pcache_build == "host" else True, **kw)
    _sync(dev)
    build_cache_s = time.perf_counter() - t0
    slab = t_cache.buffers["pcache"]
    slab_bytes = slab.numel() * 2
    say(f"# cache engine built in {build_cache_s:.3f} s, its slab of P "
        f"{t_cache.pcache_build_s:.3f} s of it ({pcache_build}); a rank's "
        f"slab {tuple(slab.shape)} bf16, {slab_bytes / 1e9:.3f} GB", flush=True)
    t0 = time.perf_counter()
    t_rec = build_inmo_sharded_train(ds, mesh, prop_cache=False, **kw)
    _sync(dev)
    build_rec_s = time.perf_counter() - t0
    e0 = to_host_replicated(t_rec.params["embedding"], mesh)

    rng = np.random.default_rng(4)
    batches = [make_batch(mesh, rng, ds, BATCH) for _ in range(steps)]
    losses, times = [], {"pcache": [], "recompute": []}
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        lc = float(t_cache.step(batch))
        times["pcache"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        lr_ = float(t_rec.step(batch))
        times["recompute"].append(time.perf_counter() - t0)
        losses.append([lc, lr_])
        say(f"# step {i}: cached {lc:.6f} vs recompute {lr_:.6f} "
            f"({times['pcache'][-1] * 1e3:.3f} / "
            f"{times['recompute'][-1] * 1e3:.3f} ms)", flush=True)
        if not abs(lc - lr_) <= LOSS_ATOL + LOSS_RTOL * abs(lr_):
            raise AssertionError(f"step {i}: cached loss {lc} vs recompute {lr_}")

    ec = to_host_replicated(t_cache.params["embedding"], mesh)
    er = to_host_replicated(t_rec.params["embedding"], mesh)
    scale = float(np.abs(er).max()) + 1e-6
    max_dev = float(np.abs(ec - er).max() / scale)
    if not max_dev < EMB_REL:
        raise AssertionError(f"final embeddings differ by {max_dev} of their "
                             "largest magnitude")
    moved = float(np.linalg.norm(er - e0))
    dev_over_move = float(np.linalg.norm(ec - er)) / max(moved, 1e-30)
    loss_gap = max(abs(lc - lr_) / abs(lr_) for lc, lr_ in losses)
    return {
        "mesh": {"data": mesh.data, "table": mesh.table},
        "world": mesh.size,
        "catalog": [ds.n_users, ds.n_items],
        "n_nodes": ds.n_users + ds.n_items,
        "interactions": len(ds),
        "embedding_size": D,
        "n_layers": LAYERS,
        "batch_size": BATCH,
        "steps": steps,
        "pcache_build": pcache_build,
        "per_shard_slab_bytes": slab_bytes,
        "stacked_pcache_shape": [mesh.table, *slab.shape],
        "build_cache_s": build_cache_s,
        "pcache_build_s": t_cache.pcache_build_s,
        "build_recompute_s": build_rec_s,
        "losses_cached_vs_recompute": losses,
        "embedding_max_rel_dev": max_dev,
        "loss_max_rel_gap": loss_gap,
        "embedding_dev_over_move": dev_over_move,
        "embedding_move_from_init": moved,
        "step_s_not_a_perf_claim": times,
        "note": (
            "the sharded cache engine (a rank's column slab of P, K3/K4, "
            "one psum of the (R, d) partials) against the recompute engine "
            "on the same batches: each step's losses and the final "
            "embeddings held to the JAX tool's bounds. Step walls include "
            "each engine's first steps."),
    }


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", default=None, metavar="USERSxITEMS",
                        help=f"cut the catalog (default {N_USERS}x{N_ITEMS})")
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (gloo, the plain versions)")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    n_users, n_items = N_USERS, N_ITEMS
    if args.shape:
        n_users, n_items = (int(x) for x in args.shape.lower().split("x"))
    with process_world(args.device) as (world, backend):
        mesh = make_mesh(*default_mesh_shape(world), device=args.device,
                         backend=backend)
        result = run(mesh, n_users, n_items, args.steps)
        result["platform"] = where
        result["cuts"] = {
            "shape": None if (n_users, n_items) == (N_USERS, N_ITEMS)
            else f"{n_users}x{n_items} of {N_USERS}x{N_ITEMS}",
            "steps": None if args.steps == STEPS else f"{args.steps} of {STEPS}"}
        if mesh.rank == 0:
            Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
            print(json.dumps({"embedding_max_rel_dev":
                              result["embedding_max_rel_dev"],
                              "loss_max_rel_gap": result["loss_max_rel_gap"],
                              "embedding_dev_over_move":
                              result["embedding_dev_over_move"],
                              "per_shard_slab_gb":
                              result["per_shard_slab_bytes"] / 1e9}))
            print(f"wrote {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
