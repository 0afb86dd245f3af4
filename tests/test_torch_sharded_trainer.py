"""The port's sharded INMO trainer (``parallel/trainer.ShardedIGCNTrainer``)
over gloo worlds on the CPU, mirroring tests/test_sharded_trainer.py: the
reference epoch loop with one best checkpoint and the alpha anneal, NDCG
within 15% of the single-device trainer, feature_ratio < 1, a full-state
round trip, the main and aux sampler streams, the dropui and dropit
rebuilds, and checkpoints that cross between the packages.

One spawned world runs mesh 2x2 (every case) on 4 ranks, then mesh 1x2
(the training loop and the checkpoints) on 2 of them, once for the module;
the rank functions are in ``torch_mesh_workers``, which imports no jax.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

import torch_mesh_workers as W
from igcn_cf_tpu.core.mesh import make_mesh as jax_make_mesh
from torch_threads import one_thread  # noqa: F401

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MODEL_CFG = {
    "name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.0,
    "feature_ratio": 1.0,
}
TRAIN_CFG = {
    "lr": 1e-2, "l2_reg": 0.0, "aux_reg": 0.01, "batch_size": 128,
    "test_batch_size": 64, "topks": [10], "n_epochs": 8, "val_interval": 2,
    "max_patience": 8,
}


def _ds_spec(ds):
    return {"name": ds.name, "n_users": ds.n_users, "n_items": ds.n_items,
            "train": ds.train, "val": ds.val, "test": ds.test}


@pytest.fixture(scope="module")
def jax_ckpt(small_ds, tmp_path_factory):
    """A JAX sharded checkpoint at table 2: (path, its params)."""
    from igcn_cf_tpu.parallel.trainer import ShardedIGCNTrainer as JaxTrainer

    mesh = jax_make_mesh(jax.devices()[:2], data=1, table=2)
    tr = JaxTrainer(dict(TRAIN_CFG, n_epochs=1), small_ds, mesh,
                    dict(MODEL_CFG))
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "jax.pkl")
    tr.save(path)
    with open(path, "rb") as f:
        return path, pickle.load(f)


@pytest.fixture(scope="module")
def port(small_ds, tiny_ds, jax_ckpt, tmp_path_factory):
    # 1x2 runs the loop at 4 epochs and the checkpoints; 2x2 every case
    per_mesh = {name: dict(dir=str(tmp_path_factory.mktemp(f"run{name}")),
                           all_cases=name == "2x2",
                           train_cfg=dict(TRAIN_CFG, n_epochs=8 if name == "2x2"
                                          else 4))
                for name in MESHES}
    spec = dict(ds=_ds_spec(small_ds), tiny=_ds_spec(tiny_ds),
                model_cfg=MODEL_CFG, jax_ckpt=jax_ckpt[0], per_mesh=per_mesh)
    out = W.spawn_two_meshes(W.trainer_cases, spec,
                             str(tmp_path_factory.mktemp("rdv")))
    for name in MESHES:
        out[name + "_dir"] = per_mesh[name]["dir"]
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_train_keeps_one_checkpoint_and_anneals(port, mesh):
    """train(): finite best NDCG, exactly one best checkpoint (the old best
    deleted), and at the end the best checkpoint reloaded with the alpha it
    was saved with, 0.99^(epoch + 1) of the best epoch (each epoch anneals
    before its validation); the same on every rank, also where each rank
    works in its own directory and only rank 0 sees the checkpoint."""
    r0 = port[mesh][0]
    assert np.isfinite(r0["best"]) and r0["best"] > 0.0
    assert len(r0["ckpts"]) == 1
    for r in port[mesh]:
        for name in ("embedding", "w"):
            np.testing.assert_array_equal(r["final_params"][name],
                                          r0["best_params"][name])
    for r in port[mesh][1:]:
        assert r["ckpts"] == []
    validated = [h for h in r0["history"] if "ndcg" in h]
    best = max(validated, key=lambda h: h["ndcg"])  # the first maximum
    assert best["ndcg"] == r0["best"]
    assert abs(r0["alpha"] - 0.99 ** (best["epoch"] + 1)) < 1e-5
    for r in port[mesh][1:]:
        assert r["best"] == r0["best"] and r["alpha"] == r0["alpha"]
    losses = [h["loss"] for h in r0["history"]]
    assert losses[-1] < losses[0]


def test_ndcg_within_15pct_of_single_device(port, small_ds, tmp_path,
                                            monkeypatch):
    """The same data and hyperparameters on the port's single-device
    IGCNTrainer: best NDCG within 15% (different init and sampling
    streams: statistical, as the JAX package's test). The single-device
    model runs its sparse backend, the sharded trainer's arithmetic (the
    dense backend's plain products unpack B at every step on the CPU)."""
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    monkeypatch.chdir(tmp_path)
    ds = W.dataset(_ds_spec(small_ds))
    ref = get_trainer(dict(TRAIN_CFG, name="IGCNTrainer", optimizer="Adam"),
                      ds, get_model(dict(MODEL_CFG, graph_backend="sparse"),
                                    ds, "cpu"))
    best_single = ref.train(verbose=False)
    best = port["2x2"][0]["best"]
    assert abs(best - best_single) <= 0.15 * max(best, best_single)


def test_feature_ratio_below_one(port, small_ds):
    r = port["2x2"][0]["ratio"]
    assert r["n_core"] < small_ds.n_users + small_ds.n_items
    assert np.isfinite(r["loss"]) and np.isfinite(r["ndcg"])


def test_save_state_load_state_round_trip(port):
    """A trainer resumed from the state file continues at the next epoch
    with the saved params, Adam moments, best metric, patience and alpha,
    and trains on."""
    s = port["2x2"][0]["state"]
    assert s["start"] == s["epoch1"] + 1
    assert s["best"][0] == s["best"][1] and s["patience"][0] == s["patience"][1]
    rows = s["emb"].shape[0]
    np.testing.assert_array_equal(s["emb"], s["saved"]["params"]["embedding"][:rows])
    assert abs(s["alpha"] - s["saved"]["alpha"]) < 1e-7
    assert s["adam_step"] == s["saved"]["opt_state"]["embedding"]["step"] > 0
    assert np.isfinite(s["resumed_best"]) and s["resumed_epoch"] == 3


def test_main_and_aux_streams_distinct(port, small_ds):
    """One draw gives a main and an aux batch that differ, negatives
    excluding the user's train items, the same on every rank."""
    ranks = port["2x2"]
    users, pos, neg, a_users, a_pos, a_neg = ranks[0]["streams"]
    assert not np.array_equal(users, a_users) or not np.array_equal(pos, a_pos)
    for u, p, n in zip(users, pos, neg):
        assert p in small_ds.train[u] and n not in small_ds.train[u]
    for r in ranks[1:]:
        for a, b in zip(r["streams"], ranks[0]["streams"]):
            np.testing.assert_array_equal(a, b)


def test_dropui_zero_shot_equals_single_device(port, tiny_ds):
    """After the dropui rebuild (template maps, params and alpha kept), the
    sharded representations of every user and item, the new ones
    included, equal the port's single-device IGCN rebuild on the same
    params (its sparse backend: f32 sums, so within 1e-5); the six slices
    run on the mesh."""
    from igcn_cf_tpu_torch.models.base import get_model

    r = port["2x2"][0]["dropui"]
    assert r["maps_kept"]
    reduced_n = r["reduced"]
    assert reduced_n[0] < tiny_ds.n_users and reduced_n[1] < tiny_ds.n_items
    from igcn_cf_tpu_torch.data.transforms import dropui

    ds = W.dataset(_ds_spec(tiny_ds))
    reduced = dropui(ds, 0.8)
    model = get_model(dict(MODEL_CFG, graph_backend="sparse",
                           prop_cache=False), reduced, "cpu")
    model.user_map, model.item_map = r["maps"]
    model.alpha = r["alpha"]
    buffers = model.rebuild_for(ds)
    params = {"embedding": torch.as_tensor(
                  r["params"]["embedding"][: model.n_templates]),
              "w": torch.as_tensor(r["params"]["w"])}
    rep = model.rep(params, buffers).numpy()
    want_u, want_i = rep[: ds.n_users], rep[ds.n_users:]
    scale = np.abs(want_u).max()
    np.testing.assert_allclose(r["users_rep"] / scale, want_u / scale, atol=1e-5)
    np.testing.assert_allclose(r["items_rep"] / scale, want_i / scale, atol=1e-5)
    assert set(r["slices"]) == {
        "all_users_all_items", "old_users_all_items", "new_users_all_items",
        "all_users_old_items", "all_users_new_items", "old_users_old_items"}
    for m in r["slices"].values():
        assert np.isfinite(m["NDCG"][10])


def test_dropit_rebuild(port):
    stale, rebuilt = port["2x2"][0]["dropit"]
    assert np.isfinite(stale["NDCG"][10]) and np.isfinite(rebuilt["NDCG"][10])


@pytest.mark.parametrize("mesh", MESHES)
def test_port_checkpoint_loads_in_jax(port, small_ds, mesh):
    """The port's sharded checkpoint, read by the JAX package's
    ShardedIGCNTrainer.load at table 2: the same params and alpha."""
    from igcn_cf_tpu.parallel.trainer import ShardedIGCNTrainer as JaxTrainer

    jmesh = jax_make_mesh(jax.devices()[:2], data=1, table=2)
    tr = JaxTrainer(dict(TRAIN_CFG, n_epochs=1), small_ds, jmesh,
                    dict(MODEL_CFG))
    path = os.path.join(port[mesh + "_dir"], "ckpt", "port.pkl")
    tr.load(path)
    want = port[mesh][0]["port_ckpt_params"]
    np.testing.assert_array_equal(np.asarray(tr.train_state.params["embedding"]),
                                  want["embedding"])
    np.testing.assert_array_equal(np.asarray(tr.train_state.params["w"]),
                                  want["w"])
    assert float(tr.train_state.buffers["alpha"]) == pytest.approx(0.99)


@pytest.mark.parametrize("mesh", MESHES)
def test_load_takes_rank0s_file_on_every_rank(port, mesh):
    """load() of a relative path that only rank 0's working directory
    holds: every rank takes its blocks of rank 0's file (the JAX
    checkpoint's params, saved there, zeroed, then loaded)."""
    r0 = port[mesh][0]
    assert r0["own_files"] == ["own.pkl"]
    for r in port[mesh]:
        for name in ("embedding", "w"):
            np.testing.assert_array_equal(r["reloaded"][name],
                                          r0["loaded_jax"][name])
    for r in port[mesh][1:]:
        assert r["own_files"] == []


@pytest.mark.parametrize("mesh", MESHES)
def test_jax_checkpoint_loads_in_port(port, jax_ckpt, mesh):
    """The JAX package's sharded checkpoint in the port: the same template
    rows (the padding rows past them carry nothing; the port zeroes them),
    w and alpha on every rank."""
    want = jax_ckpt[1]
    nt = len(want["user_map"]) + len(want["item_map"]) + 2
    for r in port[mesh]:
        got = r["loaded_jax"]
        np.testing.assert_array_equal(got["embedding"][:nt],
                                      want["params"]["embedding"][:nt])
        assert not got["embedding"][nt:].any()
        np.testing.assert_array_equal(got["w"], want["params"]["w"])
        assert r["loaded_alpha"] == pytest.approx(want["alpha"])
