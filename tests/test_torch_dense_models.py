"""The port's MultiVAE with MLTrainer, NeuMF with BCETrainer and ItemKNN
against the JAX package: forward passes and trainer steps on the JAX
package's own draws, the KL anneal, dropui's -inf padding, NeuMF's staged
run, ItemKNN's similarity matrix, the score-matrix evaluation (ItemKNN's
ids identical, ties included), and checkpoints carried JAX -> port -> JAX."""

import dataclasses
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from igcn_cf_tpu.evaluation.evaluate import recommend as jax_recommend
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.train.trainer import get_trainer as jax_get_trainer
from igcn_cf_tpu_torch.convert import copy_params_, flatten_tree, params_from_jax
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.evaluation.evaluate import mask_topk, recommend
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.models.multivae import MultiVAEDraw
from igcn_cf_tpu_torch.train.trainer import get_trainer
from torch_threads import one_thread  # noqa: F401

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4  # one step's f32 gradients against their largest magnitude
METRIC_ABS = 1e-6
VAE_CFG = {"name": "MultiVAE", "layer_sizes": [16, 8], "dropout": 0.5}
ML_CFG = {"name": "MLTrainer", "optimizer": "Adam", "lr": 1e-3,
          "l2_reg": 1e-4, "kl_reg": 0.2, "n_epochs": 4, "batch_size": 32,
          "test_batch_size": 16, "topks": [10, 20], "seed": 2021}
NEUMF_CFG = {"name": "NeuMF", "embedding_size": 8, "layer_sizes": [16, 8, 8]}
BCE_CFG = {"name": "BCETrainer", "optimizer": "Adam", "lr": 1e-3,
           "l2_reg": 1e-3, "n_epochs": 3, "batch_size": 64,
           "test_batch_size": 16, "topks": [10, 20], "seed": 2021,
           "mf_pretrain_epochs": 1, "mlp_pretrain_epochs": 1}
KNN_CFG = {"name": "ItemKNN", "k": 3}
KNN_TRAINER = {"name": "BasicTrainer", "n_epochs": 0, "test_batch_size": 64,
               "topks": [10, 20]}
SMALL = dict(n_users=300, n_items=400, avg_degree=18, seed=3)


@pytest.fixture(scope="module")
def port_tiny():
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


@pytest.fixture(scope="module")
def port_small():
    return synthetic_interactions(**SMALL)


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_grads_close(got, want):
    for name in want:
        g, w = got[name].numpy(), np.array(want[name])
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, atol=GRAD_REL,
                                   err_msg=name)


def _trainers(jds, pds, model_cfg, trainer_cfg):
    jm = jax_get_model(dict(model_cfg), jds)
    jt = jax_get_trainer(dict(trainer_cfg), jds, jm)
    pm = get_model(dict(model_cfg), pds, device="cpu")
    pt = get_trainer(dict(trainer_cfg), pds, pm)
    copy_params_(pt.params, jt.params)
    return jt, pt


def _assert_same_metrics(got, want):
    for name in want:
        for k in want[name]:
            assert got[name][k] == pytest.approx(want[name][k], abs=METRIC_ABS)


def _check_step(jt, pt, jloss, jgrads, loss):
    grads = torch.autograd.grad(loss, list(pt.flat_params.values()))
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    _assert_grads_close(dict(zip(pt.flat_params, grads)), flatten_tree(jgrads))


# -- MultiVAE and MLTrainer --------------------------------------------------------


def _vae_draw(jm, jb, users, key):
    """The draws JAX MultiVAE.ml_forward makes from its key
    (multivae.py:82-101): split(key) -> (k_drop, k_eps)."""
    k_drop, k_eps = jax.random.split(key)
    w = jb["profile_items"].shape[1]
    keep = jax.random.bernoulli(k_drop, 1.0 - jm.dropout, (len(users), w))
    eps = jax.random.normal(k_eps, (len(users), jm.mid_size))
    return MultiVAEDraw(_t(keep), _t(eps))


@pytest.mark.parametrize("train", [False, True])
def test_multivae_forward_matches_jax(tiny_ds, port_tiny, train):
    jm = jax_get_model(dict(VAE_CFG), tiny_ds)
    jp = jm.init_params(jax.random.PRNGKey(1))
    jb = jm.init_buffers()
    pm = get_model(VAE_CFG, port_tiny, device="cpu")
    pb = pm.init_buffers()
    np.testing.assert_array_equal(pb["profile_items"].numpy(),
                                  np.asarray(jb["profile_items"]))
    users = np.arange(5, 45, 2)
    key = jax.random.PRNGKey(8)
    want = jm.ml_forward(jp, jb, users, train=train, key=key if train else None)
    got = pm.ml_forward(params_from_jax(jp, "cpu"), pb, torch.as_tensor(users),
                        train=train,
                        draw=_vae_draw(jm, jb, users, key) if train else None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **F32_TOL)


def test_ml_trainer_steps_match_jax(tiny_ds, port_tiny):
    """Two steps of loss, gradients and Adam on the same users and draws;
    the second at epoch 1's annealed KL weight."""
    jt, pt = _trainers(tiny_ds, port_tiny, VAE_CFG, ML_CFG)
    for step, epoch in enumerate((0, 1)):
        users = np.random.default_rng(step).permutation(60)[:32]
        key = jax.random.PRNGKey(30 + step)
        kl = min(jt.kl_reg, epoch / jt.n_epochs)
        jloss, jgrads = jax.value_and_grad(jt._loss)(
            jt.params, jt.buffers, users, key, np.float32(kl))
        pt.kl_weight = pt.kl_anneal(epoch)
        assert pt.kl_weight == pytest.approx(kl)
        draw = _vae_draw(jt.model, jt.buffers, users, key)
        users_t = torch.as_tensor(users)
        _check_step(jt, pt, float(jloss), jgrads,
                    pt.loss(pt.params, users_t, draw))
        updates, jt.opt_state = jt.opt.update(jgrads, jt.opt_state, jt.params)
        jt.params = optax.apply_updates(jt.params, updates)
        pt.train_step(users_t, draw)
        want = flatten_tree(jt.params)
        for name, value in pt.flat_params.items():
            np.testing.assert_allclose(value.detach().numpy(),
                                       np.array(want[name]), atol=2e-3,
                                       err_msg=name)


def test_kl_anneal_and_user_batches(port_tiny):
    model = get_model(VAE_CFG, port_tiny, device="cpu")
    trainer = get_trainer(dict(ML_CFG, n_epochs=10, batch_size=25), port_tiny,
                          model)
    assert [trainer.kl_anneal(e) for e in range(4)] == [0.0, 0.1, 0.2, 0.2]
    batches = trainer.user_batches()
    assert batches.shape == (3, 25)  # ceil(60 / 25) full batches
    flat = batches.reshape(-1)
    assert sorted(flat[:60].tolist()) == list(range(60))
    assert torch.equal(flat[60:], flat[:15])  # the tail wraps around
    loss = trainer.train_one_epoch()
    assert np.isfinite(loss) and trainer.step_losses.shape == (3,)


def test_multivae_dropui_pads_new_items(port_tiny):
    """A model trained on 80 items scores a grown catalog: the new items
    get -inf, and the profiles ignore them."""
    model = get_model(VAE_CFG, port_tiny, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    grown = synthetic_interactions(n_users=70, n_items=95, avg_degree=12, seed=8)
    buffers = model.rebuild_for(grown)
    assert model.n_profile_items == 80
    assert int(buffers["profile_items"].max()) == 80
    scores = model.predict(params, buffers, torch.arange(70))
    assert scores.shape == (70, 95)
    assert torch.isinf(scores[:, 80:]).all() and (scores[:, 80:] < 0).all()
    assert torch.isfinite(scores[:, :80]).all()


# -- NeuMF and BCETrainer ------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gmf", "mlp", "neumf"])
def test_neumf_bce_forward_matches_jax(tiny_ds, port_tiny, arch):
    jm = jax_get_model(dict(NEUMF_CFG), tiny_ds)
    jp = jm.init_params(jax.random.PRNGKey(2))
    pm = get_model(NEUMF_CFG, port_tiny, device="cpu")
    jm.arch = pm.arch = arch
    users, items = np.arange(0, 60, 3), np.arange(0, 80, 4)
    want = jm.bce_forward(jp, users, items)
    got = pm.bce_forward(params_from_jax(jp, "cpu"), torch.as_tensor(users),
                         torch.as_tensor(items))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    # predict scores every pair, the same in any chunking
    params = params_from_jax(jp, "cpu")
    scores = pm.predict(params, {}, torch.arange(60))
    want = np.asarray(jm.make_predict_fn(jp, {})(np.arange(60)))
    np.testing.assert_allclose(scores.numpy(), want, **F32_TOL)


def test_neumf_params_shapes(tiny_ds, port_tiny):
    want = jax_get_model(dict(NEUMF_CFG), tiny_ds).init_params(
        jax.random.PRNGKey(0))
    got = get_model(NEUMF_CFG, port_tiny, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    assert ({k: tuple(v.shape) for k, v in flatten_tree(got).items()}
            == {k: tuple(v.shape) for k, v in flatten_tree(want).items()})
    assert torch.equal(got["output_w"], torch.ones(16))
    assert float(got["mf_user"].abs().max()) <= np.sqrt(6 / 8)


def test_neumf_predict_chunks_alike(port_tiny, monkeypatch):
    from igcn_cf_tpu_torch.models import neumf

    model = get_model(NEUMF_CFG, port_tiny, device="cpu")
    model.arch = "neumf"
    params = model.init_params(torch.Generator().manual_seed(3))
    users = torch.arange(60)
    whole = model.predict(params, {}, users)
    monkeypatch.setattr(neumf, "PREDICT_BUDGET_BYTES", 7 * 80 * 16 * 4)
    assert torch.equal(model.predict(params, {}, users), whole)


def test_bce_trainer_step_matches_jax(tiny_ds, port_tiny):
    jds = dataclasses.replace(tiny_ds, neg_ratio=2)
    pds = dataclasses.replace(port_tiny, neg_ratio=2)
    jt, pt = _trainers(jds, pds, NEUMF_CFG, BCE_CFG)
    jt.model.arch = pt.model.arch = "neumf"
    key = jax.random.PRNGKey(11)
    k_batch, k_drop = jax.random.split(key)
    users, pos, negs = jt.sampler.sample(k_batch, jt.batch_size, neg_ratio=2)
    jloss, jgrads = jax.value_and_grad(jt._loss)(
        jt.params, jt.buffers, jt._samplers(), k_batch, k_drop)
    batch = tuple(_t(x).long() for x in (users, pos, negs))
    assert batch[2].shape == (64, 2)
    _check_step(jt, pt, float(jloss), jgrads, pt.loss(pt.params, batch))


def test_bce_staged_run_switches_and_reloads(port_tiny, tmp_path, monkeypatch):
    """1 + 1 + 1 epochs: gmf, mlp, neumf. Each switch reloads the stage's
    best checkpoint and points a fresh Adam at the new leaves."""
    monkeypatch.chdir(tmp_path)
    pds = dataclasses.replace(port_tiny, neg_ratio=2)
    model = get_model(NEUMF_CFG, pds, device="cpu")
    trainer = get_trainer(dict(BCE_CFG), pds, model)
    seen = []
    switch = trainer._switch

    def record(arch):
        with open(trainer.save_path, "rb") as f:
            saved = flatten_tree(pickle.load(f)["params"])
        old_leaves = list(trainer.flat_params.values())
        switch(arch)
        seen.append(arch)
        leaves = list(trainer.flat_params.values())
        assert not any(a is b for a in leaves for b in old_leaves)
        assert trainer.opt.param_groups[0]["params"] == leaves
        assert all(a is b for a, b in zip(trainer.opt.param_groups[0]["params"],
                                          leaves))
        assert trainer.best_ndcg == -np.inf and model.arch == arch
        for name, value in trainer.flat_params.items():
            fresh_tower = arch == "neumf" and name.startswith(("mlp_layers",
                                                               "output_w"))
            if not fresh_tower:
                np.testing.assert_array_equal(value.detach().numpy(),
                                              saved[name], err_msg=name)
        assert torch.equal(trainer.params["output_w"],
                           torch.ones(16)) == (arch == "neumf")

    trainer._switch = record
    trainer.train(verbose=False)
    assert seen == ["mlp", "neumf"] and model.arch == "neumf"
    assert [r["epoch"] for r in trainer.history] == [0, 1, 2]
    stepped = [p for p in trainer.flat_params.values() if p in trainer.opt.state]
    assert len(stepped) == len(trainer.flat_params)


# -- ItemKNN ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [1024, 96])
def test_itemknn_similarity_identical_to_jax(small_ds, port_small, monkeypatch,
                                             block):
    """One block of items, and five blocks built on threads."""
    from igcn_cf_tpu_torch.models import knn

    monkeypatch.setattr(knn, "SIM_BLOCK", block)
    want = jax_get_model(dict(KNN_CFG), small_ds).sim_mat
    got = get_model(KNN_CFG, port_small, device="cpu").sim_mat
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("split", ["val", "test"])
def test_itemknn_eval_ids_identical_to_jax(small_ds, port_small, split):
    """Light users' top 20 reach items of score 0, which tie: the ids are
    the JAX package's on every row, lowest id first among equals."""
    jm = jax_get_model(dict(KNN_CFG), small_ds)
    jt = jax_get_trainer(dict(KNN_TRAINER), small_ds, jm)
    pm = get_model(KNN_CFG, port_small, device="cpu")
    pt = get_trainer(dict(KNN_TRAINER), port_small, pm)
    want_ids = jax_recommend(jm.make_predict_fn({}, {}), small_ds, split, [20],
                             test_batch_size=64)
    got_ids = recommend(pm, {}, {}, port_small, split, 20, test_batch_size=64)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    scores = pm.predict({}, {}, torch.arange(300))
    top = torch.gather(scores, 1, got_ids.long())
    assert int((top == 0).any(dim=1).sum()) > 0  # ties at zero decide rows
    _assert_same_metrics(pt.eval(split)[1], jt.eval(split)[1])


def test_mask_topk_orders_ties_by_id():
    scores = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 0.0, 0.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    exclude = torch.tensor([[2, 7], [7, 7]])  # 7 = n_items, the padding
    banned = torch.zeros(7, dtype=torch.bool)
    banned[4] = True
    got = mask_topk(scores, exclude, banned, 6)
    assert got.tolist() == [[1, 0, 3, 5, 6, 2], [0, 1, 2, 3, 5, 6]]
    assert got.dtype == torch.int32


# -- evaluation against the JAX trainers -------------------------------------------------


@pytest.mark.parametrize("name", ["MultiVAE", "NeuMF"])
def test_trainer_eval_matches_jax(tiny_ds, port_tiny, name):
    cfgs = {"MultiVAE": (VAE_CFG, ML_CFG), "NeuMF": (NEUMF_CFG, BCE_CFG)}
    jt, pt = _trainers(tiny_ds, port_tiny, *cfgs[name])
    for split in ("val", "test"):
        _assert_same_metrics(pt.eval(split)[1], jt.eval(split)[1])


# -- checkpoints JAX -> port -> JAX ------------------------------------------------------


@pytest.mark.parametrize("name", ["MultiVAE", "IDCF_LGCN", "NeuMF"])
def test_checkpoint_round_trip(tiny_ds, port_tiny, tmp_path, name):
    cfg = {"MultiVAE": VAE_CFG, "NeuMF": NEUMF_CFG,
           "IDCF_LGCN": {"name": "IDCF_LGCN", "embedding_size": 8,
                         "n_layers": 2, "n_headers": 2,
                         "lgcn_path": str(tmp_path / "unused.pkl")}}[name]
    jm = jax_get_model(dict(cfg), tiny_ds)
    jp = jm.init_params(jax.random.PRNGKey(6))
    jm.save(str(tmp_path / "jax.pkl"), jp)
    pm = get_model(cfg, port_tiny, device="cpu")
    params = pm.load(str(tmp_path / "jax.pkl"))
    lists = {"MultiVAE": ("encoder", "decoder"), "IDCF_LGCN": ("heads",),
             "NeuMF": ("mlp_layers",)}[name]
    for key in lists:
        assert isinstance(params[key], list) and len(params[key]) == len(jp[key])
    pm.save(str(tmp_path / "port.pkl"), params)
    back = flatten_tree(jm.load(str(tmp_path / "port.pkl")))
    want = flatten_tree(jp)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(want[k]))
