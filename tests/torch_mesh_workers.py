"""Rank functions of the port's multi-device tests.

Each function runs on one rank of a world that
``igcn_cf_tpu_torch.core.mesh.spawn_world`` starts (or of a one-rank world
in the test's own process, ``run_single``) and returns host numpy results.
This module imports torch and the port only, never jax: a spawned child
imports it afresh by name, and the test files, which import the JAX
package, compare the results with it.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def dataset(spec):
    """A port ``Interactions`` from {name, n_users, n_items, train, val,
    test} lists."""
    from igcn_cf_tpu_torch.data.dataset import Interactions

    return Interactions(spec["name"], spec["n_users"], spec["n_items"],
                        spec["train"], spec["val"], spec["test"])


def run_single(fn, *args):
    """``fn(0, *args)`` in a one-rank gloo world started in this process,
    torn down after."""
    import torch.distributed as dist

    from igcn_cf_tpu_torch.core.mesh import initialize_distributed

    initialize_distributed("gloo")
    try:
        return fn(0, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def two_meshes(rank, fn, spec, rendezvous2):
    """``fn`` at mesh 2x2 in this world of 4, then at mesh 1x2 in a world of
    the first 2 ranks (rendezvous at the file ``rendezvous2``), so one
    spawn serves both meshes. ``spec['per_mesh'][name]`` is merged into the
    spec of mesh ``name``. Returns {mesh name: fn's result}."""
    import datetime

    import torch.distributed as dist

    per = spec.get("per_mesh", {})
    out = {"2x2": fn(rank, dict(spec, mesh=(2, 2), **per.get("2x2", {})))}
    dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group(
            "gloo", init_method=f"file://{rendezvous2}", rank=rank,
            world_size=2, timeout=datetime.timedelta(seconds=300))
        out["1x2"] = fn(rank, dict(spec, mesh=(1, 2), **per.get("1x2", {})))
    return out


def spawn_two_meshes(fn, spec, rendezvous_dir):
    """{"2x2": [4 rank results], "1x2": [2 rank results]} of ``fn`` from one
    spawned world (``two_meshes``)."""
    from igcn_cf_tpu_torch.core.mesh import spawn_world

    rdv2 = os.path.join(rendezvous_dir, f"second_{os.getpid()}_{id(spec)}")
    res = spawn_world(two_meshes, 4, "gloo", rendezvous_dir, fn, spec, rdv2)
    return {"2x2": [r["2x2"] for r in res],
            "1x2": [r["1x2"] for r in res[:2]]}


def _set_sharded_params(ts, params):
    """The JAX sharded step's global params (any table size) into this
    rank's blocks: the template rows kept, re-padded for this mesh."""
    from igcn_cf_tpu_torch.core.mesh import row_block

    emb = np.asarray(params["embedding"])[: ts.n_templates]
    with torch.no_grad():
        ts.params["embedding"].copy_(torch.as_tensor(
            row_block(emb, ts.mesh.t, ts.t_rows)))
        ts.params["w"].copy_(torch.as_tensor(np.asarray(params["w"])))


def _set_dense_params(st, params, n_users, n_items):
    """Real user/item rows of the dense step's params (emb_u (n_users, d),
    emb_i (n_items, d), toks, w) into this rank's blocks, zero padding."""
    from igcn_cf_tpu_torch.core.mesh import row_block

    t = st.mesh.t
    with torch.no_grad():
        for name, n in (("emb_u", n_users), ("emb_i", n_items)):
            rows = st.params[name].shape[0]
            st.params[name].copy_(torch.as_tensor(
                row_block(np.asarray(params[name])[:n], t, rows)))
        st.params["toks"].copy_(torch.as_tensor(np.asarray(params["toks"])))
        st.params["w"].copy_(torch.as_tensor(np.asarray(params["w"])))


def _grads(st):
    return {k: v.grad.detach().cpu().numpy().copy()
            for k, v in st.params.items()}


def parallel_cases(rank, spec):
    """The parallel layer's cases on a (data, table) gloo mesh."""
    from igcn_cf_tpu_torch.core.mesh import make_mesh, row_block
    from igcn_cf_tpu_torch.graph.build import COO, sym_norm_adjacency
    from igcn_cf_tpu_torch.kernels.bitpack import (
        bb_matmul_dropped,
        keep_mask_dense,
        unpack_bits,
    )
    from igcn_cf_tpu_torch.kernels.dense_graph import BipartiteDense
    from igcn_cf_tpu_torch.core.prng import fold_in
    from igcn_cf_tpu_torch.parallel import pcache as ppc
    from igcn_cf_tpu_torch.parallel.dense_steps import (
        build_inmo_dense_sharded_train,
    )
    from igcn_cf_tpu_torch.parallel.eval import sharded_recommend
    from igcn_cf_tpu_torch.parallel.sharded import (
        ShardedGraph,
        pad_rows,
        propagate_mean_local,
        spmm_local,
    )
    from igcn_cf_tpu_torch.parallel.steps import (
        build_inmo_sharded_train,
        edge_keep,
    )
    from igcn_cf_tpu_torch.parallel.topk import sharded_topk

    mesh = make_mesh(*spec["mesh"], device="cpu")
    t, T = mesh.t, mesh.table
    ds = dataset(spec["ds"])
    out = {"t": t, "d": mesh.d}

    # -- the sharded SpMM and propagation, forward and gradient -------------
    coo = COO(*spec["coo"])
    sh = ShardedGraph.from_coo(coo, T)
    x = pad_rows(spec["x"], sh.n_rows)
    xl = torch.tensor(row_block(x, t, sh.rows_per_shard), requires_grad=True)
    y = spmm_local(sh.local(t, sh.n_rows, "cpu"), xl, mesh)
    ct = torch.as_tensor(row_block(pad_rows(spec["ct"], sh.n_rows), t,
                                   sh.rows_per_shard))
    (y * ct).sum().backward()
    out["spmm"] = (y.detach().numpy(), xl.grad.numpy())
    adj = ShardedGraph.from_coo(sym_norm_adjacency(
        ds.train_array, ds.n_users, ds.n_items), T)
    x0 = pad_rows(spec["x0"], adj.n_rows)
    x0l = torch.tensor(row_block(x0, t, adj.rows_per_shard), requires_grad=True)
    rep = propagate_mean_local(adj.local(t, adj.n_rows, "cpu"), x0l, 2, mesh)
    ct0 = torch.as_tensor(row_block(pad_rows(spec["ct0"], adj.n_rows), t,
                                    adj.rows_per_shard))
    (rep * ct0).sum().backward()
    out["prop"] = (rep.detach().numpy(), x0l.grad.numpy())

    # -- retrieval ------------------------------------------------------------
    users, items = (torch.as_tensor(a) for a in spec["topk"][:2])
    i_shard = items.shape[0] // T
    _, ids = sharded_topk(users, items[t * i_shard: (t + 1) * i_shard],
                          spec["topk"][2], mesh)
    out["topk"] = ids.numpy()
    rec = spec["rec"]
    rds = dataset(rec["ds"])
    out["recommend"] = sharded_recommend(
        mesh, torch.as_tensor(rec["users_rep"]),
        torch.as_tensor(rec["items_rep"]), rds, "test", [rec["k"]],
        banned_items=rec["banned"]).numpy()

    # -- the sharded cache's slabs ------------------------------------------
    n_layers = spec["n_layers"]
    rps = adj.rows_per_shard
    out["slab_host"] = ppc.build_sharded_pcache_host(
        ds.train_array, ds.n_users, ds.n_items, t, n_layers, rps,
        "cpu", block=64).float().numpy()
    bip = BipartiteDense.build(ds.train_array, ds.n_users, ds.n_items, "cpu")
    out["slab_device"] = ppc.build_sharded_pcache(
        bip, t, n_layers, rps).float().numpy()

    # -- one step's loss and gradients on each engine -------------------------
    hp = spec["hparams"]
    batch = tuple(torch.tensor(np.asarray(a)) for a in spec["batch"])
    for engine, cache in (("sparse", False), ("cache", "host")):
        ts = build_inmo_sharded_train(
            ds, mesh, embedding_size=hp["d"], n_layers=n_layers, dropout=0.0,
            l2_reg=hp["l2_reg"], aux_reg=hp["aux_reg"],
            batch_size=len(spec["batch"][0]), prop_cache=cache)
        _set_sharded_params(ts, spec["params"])
        loss = ts.grads(batch)
        out[engine] = (float(loss), _grads(ts))
    st = build_inmo_dense_sharded_train(
        ds, mesh, embedding_size=hp["d"], n_layers=n_layers, dropout=0.0,
        l2_reg=hp["l2_reg"], aux_reg=hp["aux_reg"],
        batch_size=len(spec["batch"][0]), tile=8)
    _set_dense_params(st, spec["dense_params"], ds.n_users, ds.n_items)
    loss = st.grads(batch)
    out["dense"] = (float(loss), _grads(st))

    # -- the JAX package's global params <-> this rank's blocks ---------------
    if T == 2:
        from igcn_cf_tpu_torch.convert import (
            sharded_params_from_jax,
            sharded_params_to_jax,
        )

        out["convert"] = {
            kind: sharded_params_to_jax(
                sharded_params_from_jax(spec[kind], mesh), mesh)
            for kind in ("params", "dense_params_jax")}

    # -- dropout ------------------------------------------------------------
    seed, p = spec["drop"]
    out["edge_keep"] = edge_keep(4096, p, seed, t, "cpu").numpy()
    shard = fold_in(seed, t)
    s_u = fold_in(shard, 0)
    words = st.buffers["B"]
    xi = torch.randn((words.shape[1] * 32, 8),
                     generator=torch.Generator().manual_seed(t),
                     requires_grad=True)
    yu = bb_matmul_dropped(words, xi, s_u, p)
    g = torch.randn(yu.shape, generator=torch.Generator().manual_seed(9 + t))
    (yu * g).sum().backward()
    m = unpack_bits(words) * keep_mask_dense(s_u, words.shape[0],
                                             words.shape[1] * 32, p)
    xb = xi.detach().to(torch.bfloat16).float()
    gb = g.to(torch.bfloat16).float()
    out["masked"] = {
        "seed": s_u,
        "fwd_err": float((yu.detach() - m @ xb).abs().max()),
        "bwd_err": float((xi.grad - m.T @ gb).abs().max()),
        "kept": float(m.sum()), "edges": float(unpack_bits(words).sum()),
    }
    return out


def trainer_cases(rank, spec):
    """The sharded trainer's cases; every checkpoint lands under
    ``spec['dir']``. The training loop and the checkpoint reload run with a
    directory of each rank's own as the working directory, as ranks on
    different hosts would: only rank 0 sees the files it writes."""
    from igcn_cf_tpu_torch.core.mesh import make_mesh
    from igcn_cf_tpu_torch.data.transforms import dropit, dropui
    from igcn_cf_tpu_torch.parallel.trainer import ShardedIGCNTrainer

    mesh = make_mesh(*spec["mesh"], device="cpu")
    ds = dataset(spec["ds"])
    tiny = dataset(spec["tiny"])
    mc, tc = spec["model_cfg"], spec["train_cfg"]
    out = {}
    own = f"rank{rank}"
    for sub in ("ratio", "state", "dropui", os.path.join("train", own),
                os.path.join("ckpt", own)):
        os.makedirs(os.path.join(spec["dir"], sub), exist_ok=True)
    os.chdir(os.path.join(spec["dir"], "train", own))

    # train: one best checkpoint, alpha annealed, NDCG
    tr = ShardedIGCNTrainer(dict(tc), ds, mesh, dict(mc))
    out["best"] = tr.train(verbose=False)
    out["ckpts"] = (sorted(f for f in os.listdir("checkpoints")
                           if f.startswith("IGCN_Sharded"))
                    if os.path.isdir("checkpoints") else [])
    out["final_params"] = tr._host_params()
    if rank == 0:
        with open(tr.save_path, "rb") as f:
            out["best_params"] = pickle.load(f)["params"]
    out["alpha"] = float(tr.train_state.buffers["alpha"])
    out["epoch"] = tr.epoch
    out["history"] = tr.history

    # checkpoints: the port's for the JAX package, the JAX package's here
    os.chdir(os.path.join(spec["dir"], "ckpt"))
    # the cases past the training loop train at a larger batch (fewer
    # steps): they check state and flows, not convergence
    fast = dict(tc, batch_size=512)
    tr = ShardedIGCNTrainer(dict(fast, n_epochs=1), ds, mesh, dict(mc))
    tr.train_one_epoch()
    tr.save(os.path.join(spec["dir"], "ckpt", "port.pkl"))
    out["port_ckpt_params"] = tr._host_params()
    tr.load(spec["jax_ckpt"])
    out["loaded_jax"] = tr._host_params()
    out["loaded_alpha"] = float(tr.train_state.buffers["alpha"])
    # a relative path: the file is in rank 0's directory alone
    os.chdir(os.path.join(spec["dir"], "ckpt", own))
    tr.save("own.pkl")
    out["own_files"] = sorted(os.listdir("."))
    with torch.no_grad():
        for p in tr.train_state.params.values():
            p.zero_()
    tr.load("own.pkl")
    out["reloaded"] = tr._host_params()
    if not spec["all_cases"]:
        return out

    # feature_ratio < 1
    os.chdir(os.path.join(spec["dir"], "ratio"))
    tr = ShardedIGCNTrainer(dict(fast, n_epochs=2), ds, mesh,
                            dict(mc, feature_ratio=0.6,
                                 ranking_metric="degree"))
    ts = tr.train_state
    out["ratio"] = {"n_core": len(ts.user_map) + len(ts.item_map),
                    "loss": tr.train_one_epoch(),
                    "ndcg": tr.eval("val")[1]["NDCG"][tc["topks"][0]]}

    # full-state save / load round trip, then one more epoch
    os.chdir(os.path.join(spec["dir"], "state"))
    cfg = dict(fast, n_epochs=3, val_interval=1, state_interval=1)
    t1 = ShardedIGCNTrainer(dict(cfg), ds, mesh, dict(mc))
    t1.train(verbose=False)
    t2 = ShardedIGCNTrainer(dict(cfg), ds, mesh, dict(mc))
    t2.load_state(t1.state_path)
    state = {"start": t2.start_epoch, "epoch1": t1.epoch,
             "best": (t1.best_ndcg, t2.best_ndcg),
             "patience": (t1.patience, t2.patience),
             "emb": t2.train_state.params["embedding"].detach().numpy().copy(),
             "alpha": float(t2.train_state.buffers["alpha"]),
             "adam_step": float(t2.train_state.opt.state[
                 t2.train_state.params["embedding"]]["step"])}
    with open(t1.state_path, "rb") as f:
        state["saved"] = pickle.load(f)
    t2.n_epochs = cfg["n_epochs"] + 1
    state["resumed_best"] = t2.train(verbose=False)
    state["resumed_epoch"] = t2.epoch
    out["state"] = state

    # the main and aux samplers' streams
    ts = t2.train_state
    gen = torch.Generator().manual_seed(3)
    batch = ts.sample_batch(gen)
    out["streams"] = [b.numpy() for b in batch]

    # dropui zero-shot over the rebuilt shards, and the six slices
    os.chdir(os.path.join(spec["dir"], "dropui"))
    reduced = dropui(tiny, 0.8)
    tr = ShardedIGCNTrainer(dict(tc, n_epochs=1, batch_size=64), reduced,
                            mesh, dict(mc))
    tr.train_one_epoch()
    params = tr._host_params()
    maps = (dict(tr.train_state.user_map), dict(tr.train_state.item_map))
    tr.rebuild_for(tiny)
    users_rep, items_rep = tr._reps()
    out["dropui"] = {"params": params, "maps": maps,
                     "alpha": float(tr.train_state.buffers["alpha"]),
                     "maps_kept": (tr.train_state.user_map, tr.train_state.item_map)
                     == maps,
                     "users_rep": users_rep.numpy(),
                     "items_rep": items_rep.numpy(),
                     "slices": tr.inductive_eval(reduced.n_users,
                                                 reduced.n_items),
                     "reduced": (reduced.n_users, reduced.n_items)}

    # dropit: stale structures, then rebuilt
    reduced = dropit(tiny, 0.8)
    tr = ShardedIGCNTrainer(dict(tc, n_epochs=1, batch_size=64), reduced,
                            mesh, dict(mc))
    tr.train_one_epoch()
    tr.dataset = tiny
    stale = tr.eval("test")[1]
    tr.rebuild_for(tiny)
    out["dropit"] = (stale, tr.eval("test")[1])

    return out


def serve_cases(rank, spec):
    """Mesh serving against one device, and the CLI's ``--mesh`` checks."""
    from igcn_cf_tpu_torch.core.mesh import make_mesh
    from igcn_cf_tpu_torch.serve import Recommender

    mesh = make_mesh(*spec["mesh"], device="cpu")
    ds = dataset(spec["ds"])
    out = {}
    for exclude in ("train", "all"):
        rec = Recommender.from_checkpoint(spec["ckpt"], spec["model_cfg"], ds,
                                          exclude=exclude, mesh=mesh)
        for name, users, k, banned in spec["requests"]:
            out[(exclude, name)] = rec.recommend(users, k=k,
                                                 banned_items=banned)
    rec.refresh(dataset(spec["grown"]))
    out["refreshed"] = rec.recommend(np.arange(spec["grown"]["n_users"]), k=10)
    try:
        make_mesh(mesh.size, 2, device="cpu")
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


def cli_cases(rank, spec):
    """``main([... '--mesh', 'DxT' ...])`` in this world, cwd ``spec['dir']``;
    returns what rank 0 printed."""
    import contextlib
    import io

    from igcn_cf_tpu_torch.cli.main import main

    os.chdir(spec["dir"])
    buf = io.StringIO()
    err = None
    with contextlib.redirect_stdout(buf):
        try:
            main(spec["argv"])
        except ValueError as e:
            err = str(e)
    return {"stdout": buf.getvalue(), "error": err}


class _RecordedPopulation:
    """Wraps ``tuning.population.PopulationTrainer`` for one search:
    records each group's history and best, and, with ``init`` and
    ``draws``, starts every trial from ``init`` (a params tree of numpy
    arrays) and feeds the steps ``draws`` (a list of step inputs) in place
    of the group trainer's own."""

    def __init__(self, init=None, draws=None):
        from igcn_cf_tpu_torch.convert import copy_params_
        from igcn_cf_tpu_torch.tuning import population

        self.groups = []
        rec = self

        class Recorded(population.PopulationTrainer):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                if init is not None:
                    for p in self.params:
                        copy_params_(p, init)
                    steps = iter(draws)
                    self.group.sample_step = lambda: next(steps)

            def train(self, verbose=True):
                best = super().train(verbose)
                rec.groups.append({
                    "losses": [h["losses"] for h in self.history],
                    "ndcgs": [h["ndcgs"] for h in self.history],
                    "best": best, "local": self.local.tolist()})
                return best

        self.cls = Recorded


def population_search(spec, mesh=None, init=None, draws=None):
    """``population_grid_search`` of ``spec`` (dataset config, model and
    trainer configs, grid) on the CPU, over ``mesh``: (result, the groups'
    records)."""
    from unittest import mock

    from igcn_cf_tpu_torch.tuning import population

    torch.set_num_threads(1)
    rec = _RecordedPopulation(init, draws)
    with mock.patch.object(population, "PopulationTrainer", rec.cls):
        result = population.population_grid_search(
            spec["dc"], spec["model_config"], dict(spec["trainer_config"]),
            spec["grid"], verbose=False, device="cpu", mesh=mesh)
    return result, rec.groups


def trial_mesh_cases(rank, spec):
    """The trial mesh in a world of 2 gloo ranks: each search of
    ``spec['searches']`` over ``make_mesh(2, 1)`` (with the JAX package's
    init and draws where the search gives them), then ``tune
    --trial-mesh 2`` through the command line, over this world's group.
    Returns {search name: (result, groups)} and the command's
    stdout."""
    import contextlib
    import io

    from igcn_cf_tpu_torch.cli.main import main
    from igcn_cf_tpu_torch.core.mesh import make_mesh

    mesh = make_mesh(2, 1, device="cpu")
    out = {name: population_search(s, mesh, s.get("init"), s.get("draws"))
           for name, s in spec["searches"].items()}
    os.chdir(spec["dir"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(spec["argv"])
    out["cli"] = buf.getvalue()
    return out


def tools_world_cases(rank, spec):
    """``dryrun_multichip(4)``, then ``scaling_harness`` and
    ``sharded_midscale`` at toy size, in a world of 4 gloo ranks; their
    JSON records land in ``spec['dir']``. Returns the dry run's and the
    tools' results."""
    from igcn_cf_tpu_torch.dryrun import dryrun_multichip
    from igcn_cf_tpu_torch.tools import scaling_harness, sharded_midscale

    torch.set_num_threads(1)
    out = {"dryrun": dryrun_multichip(4, "cpu")}
    scaling_harness.CPU_RUN = (spec["scaling_catalog"], spec["scaling_batch"],
                               spec["scaling_epochs"])
    out["scaling"] = scaling_harness.main(
        ["--out", os.path.join(spec["dir"], "scaling.json"), "--device", "cpu"])
    out["midscale"] = sharded_midscale.main(
        ["--shape", spec["midscale_shape"], "--steps", str(spec["midscale_steps"]),
         "--out", os.path.join(spec["dir"], "midscale.json"), "--device", "cpu"])
    return out
