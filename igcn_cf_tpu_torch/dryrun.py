"""Entry points (the port's counterparts of ``__graft_entry__.py``).

``entry()`` returns the flagship model's single-device forward and its
arguments: IGCN's full-catalog scoring of a batch of users (inductive
aggregation, 3-layer propagation, the scoring matmul) on a tiny 48 x 64
catalog.

``dryrun_multichip(n)`` runs the sharded INMO paths over a world of ``n``
ranks, one process a rank (torchrun, ``core/mesh.spawn_world``, or a
world of one in this process), on a (data, table) mesh with data 2 where
``n`` is even and above 2: the sharded trainer for one epoch of at least
2 steps with the alpha anneal and a sharded val eval, its inductive
rebuild over a grown 56 x 72 catalog (the template maps kept), one raw
step each of the sparse, cache and dense-sharded engines, and mesh
serving against one device's ``Recommender``. Every check raises on
failure.

    python -m igcn_cf_tpu_torch.dryrun [--device cuda|cpu]
    torchrun --nproc-per-node N -m igcn_cf_tpu_torch.dryrun --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _tiny_dataset(n_users=48, n_items=64, seed=0):
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions

    return synthetic_interactions(n_users=n_users, n_items=n_items,
                                  avg_degree=8, seed=seed)


def entry(device="cuda"):
    """(forward, (params, buffers, users)): ``forward`` scores 16 users
    against every item of the tiny catalog with IGCN (d=32, 3 layers,
    dropout 0, feature_ratio 1.0) on ``device``."""
    from igcn_cf_tpu_torch.models.base import get_model

    ds = _tiny_dataset()
    model = get_model({"name": "IGCN", "embedding_size": 32, "n_layers": 3,
                       "dropout": 0.0, "feature_ratio": 1.0}, ds, device)
    params = model.init_params(torch.Generator().manual_seed(0))
    buffers = model.init_buffers()

    @torch.no_grad()
    def forward(params, buffers, users):
        rep = model.rep(params, buffers, train=False)
        return rep[users] @ rep[ds.n_users:].T

    users = torch.arange(16, device=model.device)
    return forward, (params, buffers, users)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The sharded paths over this world of ``n_devices`` ranks (started
    here as a world of one where no group is up); returns what each part
    computed."""
    from igcn_cf_tpu_torch.core.mesh import make_mesh
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.parallel.dense_steps import (
        build_inmo_dense_sharded_train,
    )
    from igcn_cf_tpu_torch.parallel.steps import build_inmo_sharded_train, make_batch
    from igcn_cf_tpu_torch.parallel.trainer import ShardedIGCNTrainer
    from igcn_cf_tpu_torch.serve import Recommender
    from igcn_cf_tpu_torch.tools import process_world

    with process_world(device) as (world, backend):
        _check(world == n_devices, f"a dry run of {n_devices} ranks in a world "
               f"of {world}")
        data = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
        mesh = make_mesh(data, n_devices // data, device=device, backend=backend)
        ds = _tiny_dataset()
        rng = np.random.default_rng(0)
        batch_size = 8 * n_devices
        out = {"mesh": (mesh.data, mesh.table)}

        # the sharded trainer: one epoch (>= 2 steps, device-side sampling),
        # the anneal, a sharded masked top-k validation
        trainer = ShardedIGCNTrainer(
            {"topks": [10], "n_epochs": 1, "val_interval": 1, "lr": 1e-3,
             "aux_reg": 0.01, "batch_size": batch_size, "test_batch_size": 16},
            ds, mesh,
            {"name": "IGCN", "embedding_size": 16, "n_layers": 2,
             "dropout": 0.1, "feature_ratio": 1.0})
        _check(trainer.train_state.steps_per_epoch >= 2, "fewer than 2 steps "
               "an epoch")
        out["epoch_loss"] = trainer.train_one_epoch()
        _check(bool(np.isfinite(out["epoch_loss"])), "sharded epoch: "
               "non-finite loss")
        alpha = float(trainer.train_state.buffers["alpha"])
        _check(abs(alpha - 0.99) < 1e-6, f"alpha anneal did not run ({alpha})")
        _, metrics = trainer.eval("val")
        out["val_ndcg"] = metrics["NDCG"][10]
        _check(bool(np.isfinite(out["val_ndcg"])), "sharded eval: non-finite "
               "NDCG")

        # the sharded inductive flow: rebuilt over a grown catalog with the
        # same template maps and params, then a test eval
        grown = _tiny_dataset(n_users=56, n_items=72, seed=0)
        old_maps = dict(trainer.train_state.user_map)
        trainer.rebuild_for(grown)
        _check(trainer.train_state.user_map == old_maps, "the rebuild did not "
               "keep the template maps")
        _, metrics = trainer.eval("test")
        out["grown_test_ndcg"] = metrics["NDCG"][10]
        _check(bool(np.isfinite(out["grown_test_ndcg"])), "sharded rebuilt "
               "eval: non-finite NDCG")
        del trainer

        # one raw step of each engine on a host-sampled batch
        batch = make_batch(mesh, rng, ds, batch_size)
        kw = dict(embedding_size=16, n_layers=2, dropout=0.1, lr=1e-3,
                  aux_reg=0.01, batch_size=batch_size)
        for engine, build in (
                ("sparse", lambda: build_inmo_sharded_train(
                    ds, mesh, prop_cache=False, **kw)),
                ("cache", lambda: build_inmo_sharded_train(
                    ds, mesh, prop_cache=True, **kw)),
                ("dense", lambda: build_inmo_dense_sharded_train(
                    ds, mesh, tile=8, **kw))):
            state = build()
            if engine == "cache":
                _check("pcache" in state.buffers, "the cache engine has no slab")
            out[f"{engine}_loss"] = float(state.step(batch, 0))
            _check(bool(np.isfinite(out[f"{engine}_loss"])),
                   f"{engine} sharded step: non-finite loss")
            del state

        # sharded serving: table-sharded items, per-rank K5, merged; the
        # same ids as one device's Recommender over the same model state
        model = get_model({"name": "IGCN", "embedding_size": 16, "n_layers": 2,
                           "dropout": 0.0, "feature_ratio": 1.0,
                           "graph_backend": "sparse", "prop_cache": False},
                          ds, mesh.device)
        params = model.init_params(torch.Generator().manual_seed(1))
        buffers = model.init_buffers()
        rec_single = Recommender(model, params, buffers, exclude="train")
        rec_mesh = Recommender(model, params, buffers, exclude="train",
                               mesh=mesh)
        users = np.arange(ds.n_users, dtype=np.int64)
        ids = rec_mesh.recommend(users, k=10)
        _check(np.array_equal(ids, rec_single.recommend(users, k=10)),
               "sharded serving differs from one device's")
        _check(bool((ids >= 0).all() and (ids < ds.n_items).all()),
               "sharded serving: ids out of range")
        out["serving_ids"] = ids
        return out


def main(argv=None, device="cuda") -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu (gloo, the plain versions)")
    args = parser.parse_args(argv)
    import torch.distributed as dist

    from igcn_cf_tpu_torch.tools import process_world

    fn, fargs = entry(args.device)
    print("entry forward:", tuple(fn(*fargs).shape), flush=True)
    with process_world(args.device) as (world, _):
        dryrun_multichip(world, args.device)
        if dist.get_rank() == 0:
            print("dryrun_multichip OK", flush=True)


if __name__ == "__main__":
    main()
