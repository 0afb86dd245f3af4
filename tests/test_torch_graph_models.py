"""The port's IMCGAE and IDCF_LGCN against the JAX package, on the JAX
package's own random draws: IMCGAE's representation on both graph
backends, one BPR step and three Adam steps, ``grow_params``; IDCF's
representation and contrastive pieces over a frozen table read from a JAX
LightGCN checkpoint, one IDCFTrainer step, ``rebuild_for``, and the
auto-pretraining of a missing table."""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.train.trainer import get_trainer as jax_get_trainer
from igcn_cf_tpu_torch.convert import copy_params_, flatten_tree, params_from_jax
from igcn_cf_tpu_torch.core.prng import KeySeq
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.models.idcf import IDCFDraw
from igcn_cf_tpu_torch.models.imcgae import IMCGAEDrop
from igcn_cf_tpu_torch.train.trainer import get_trainer
from torch_threads import one_thread  # noqa: F401

# bf16 operands, f32 sums in another order (tests/test_torch_gcn.py)
PAIR_TOL = dict(rtol=1e-5, atol=1e-4)
# several dense layers: a sum-order difference in one layer can move an
# operand of the next across a bf16 rounding step (2^-8 relative), as for
# NGCF's representation (tests/test_torch_gcn.py)
REP_TOL = dict(rtol=2e-3, atol=1e-5)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
GRAD_REL = 4e-3  # one step's gradients against their largest magnitude
IMCGAE_CFG = {"name": "IMCGAE", "embedding_size": 8, "n_layers": 3,
              "dropout": 0.3}
BPR_CFG = {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-3,
           "l2_reg": 1e-3, "n_epochs": 1, "batch_size": 64, "topks": [10],
           "seed": 2021}
IDCF_CFG = {"name": "IDCF_LGCN", "embedding_size": 8, "n_layers": 2,
            "n_headers": 2, "n_samples": 10}
IDCF_TRAINER = {"name": "IDCFTrainer", "optimizer": "Adam", "lr": 1e-3,
                "l2_reg": 1e-4, "contrastive_reg": 1e-3, "n_epochs": 1,
                "batch_size": 64, "topks": [10], "seed": 2021}


@pytest.fixture(scope="module")
def port_tiny():
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_grads_close(got, want):
    """Each gradient within GRAD_REL of its largest magnitude. A parameter
    whose true gradient is zero (IDCF's wk biases: the attention softmax is
    invariant to them) gets f32 noise, so the scale is floored at 1e-5 of
    the step's largest gradient."""
    floor = 1e-5 * max(np.abs(np.array(w)).max() for w in want.values())
    for name in want:
        g, w = got[name].numpy(), np.array(want[name])
        scale = max(np.abs(w).max(), floor, 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, atol=GRAD_REL,
                                   err_msg=name)


def _imcgae_drop(jmodel, key):
    """The node draws JAX IMCGAE.rep makes from its key (imcgae.py:83-91):
    each layer split(key) -> (key, k_node)."""
    keep = []
    for i in range(jmodel.n_layers):
        key, k_node = jax.random.split(key)
        p = jmodel.dropout - 0.1 * i
        keep.append(_t(jax.random.bernoulli(
            k_node, 1.0 - p, (jmodel.n_users + jmodel.n_items,))))
    return IMCGAEDrop(keep)


def _idcf_draw(jmodel, key):
    """The key samples JAX IDCF draws from its key (idcf.py:146-150): each
    head split(key, 3) -> (key, ku, ki)."""
    su, si = [], []
    for _ in range(jmodel.n_headers):
        key, ku, ki = jax.random.split(key, 3)
        su.append(_t(jax.random.randint(ku, (jmodel.n_samples,), 0,
                                        jmodel.n_old_users)).long())
        si.append(_t(jax.random.randint(ki, (jmodel.n_samples,), 0,
                                        jmodel.n_old_items)).long())
    return IDCFDraw(su, si)


def _trainers(jds, pds, model_cfg, trainer_cfg):
    jm = jax_get_model(dict(model_cfg), jds)
    jt = jax_get_trainer(dict(trainer_cfg), jds, jm)
    pm = get_model(dict(model_cfg), pds, device="cpu")
    pt = get_trainer(dict(trainer_cfg), pds, pm)
    copy_params_(pt.params, jt.params)
    return jt, pt


def _jax_step(jt, key):
    """The JAX step's batch (bpr.py:50-53) and its loss and gradients."""
    k_batch, k_drop = jax.random.split(key)
    users, pos, negs = jt.sampler.sample(k_batch, jt.batch_size)
    batch = tuple(_t(x).long() for x in (users, pos, negs[:, 0]))
    jloss, jgrads = jax.value_and_grad(jt._loss)(
        jt.params, jt.buffers, jt._samplers(), k_batch, k_drop)
    return batch, k_drop, float(jloss), jgrads


def _check_steps(jt, pt, draw_of, n_steps):
    """Loss and gradients of a step on the same params, batch and draws,
    then the Adam update, ``n_steps`` times."""
    lr = jt.config["lr"]
    for step in range(n_steps):
        batch, k_drop, jloss, jgrads = _jax_step(jt, jax.random.PRNGKey(60 + step))
        draw = draw_of(jt.model, k_drop)
        loss = pt.loss(pt.params, batch, draw)
        grads = torch.autograd.grad(loss, list(pt.flat_params.values()))
        assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
        _assert_grads_close(dict(zip(pt.flat_params, grads)),
                            flatten_tree(jgrads))
        updates, jt.opt_state = jt.opt.update(jgrads, jt.opt_state, jt.params)
        jt.params = optax.apply_updates(jt.params, updates)
        got = pt.train_step(batch, draw)
        assert abs(float(got) - jloss) <= LOSS_RTOL * abs(jloss)
        want = flatten_tree(jt.params)
        for name, value in pt.flat_params.items():
            np.testing.assert_allclose(value.detach().numpy(),
                                       np.array(want[name]), atol=2 * lr,
                                       err_msg=name)


# -- IMCGAE ------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("backend,n_layers", [("dense", 1), ("dense", 3),
                                              ("sparse", 3)])
def test_imcgae_rep_matches_jax(tiny_ds, port_tiny, backend, n_layers, train):
    """One dense layer (a product of bf16 operands) at PAIR_TOL, three at
    REP_TOL; the sparse backend in f32."""
    cfg = dict(IMCGAE_CFG, graph_backend=backend, n_layers=n_layers)
    jm = jax_get_model(dict(cfg), tiny_ds)
    jparams = jm.init_params(jax.random.PRNGKey(4))
    pm = get_model(cfg, port_tiny, device="cpu")
    assert pm.backend == backend
    key = jax.random.PRNGKey(17)
    want = jm.rep(jparams, jm.init_buffers(), train=train, key=key)
    drop = _imcgae_drop(jm, key) if train else None
    got = pm.rep(params_from_jax(jparams, "cpu"), pm.init_buffers(),
                 train=train, drop=drop)
    assert got.shape == (140, 24)
    tol = (F32_TOL if backend == "sparse"
           else PAIR_TOL if n_layers == 1 else REP_TOL)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_imcgae_bpr_steps_match_jax(tiny_ds, port_tiny, backend):
    cfg = dict(IMCGAE_CFG, graph_backend=backend)
    jt, pt = _trainers(tiny_ds, port_tiny, cfg, BPR_CFG)
    _check_steps(jt, pt, _imcgae_drop, 3)


def test_imcgae_draw_drop(port_tiny):
    model = get_model(IMCGAE_CFG, port_tiny, device="cpu")
    drop = model.draw_drop(KeySeq(1), torch.Generator().manual_seed(1))
    assert [tuple(k.shape) for k in drop.keep] == [(140,)] * 3
    # layer i keeps 1 - (0.3 - 0.1 i) of the nodes
    assert float(drop.keep[2].float().mean()) > float(drop.keep[0].float().mean())
    assert get_model(dict(IMCGAE_CFG, dropout=0.0), port_tiny,
                     device="cpu").draw_drop(KeySeq(1), torch.Generator()) is None


def test_imcgae_grow_params_matches_jax(tiny_ds, port_tiny):
    small_j = jax_get_model(dict(IMCGAE_CFG), tiny_ds)
    jparams = small_j.init_params(jax.random.PRNGKey(2))
    old_u, old_i = tiny_ds.n_users, tiny_ds.n_items
    grown = synthetic_interactions(n_users=75, n_items=90, avg_degree=12, seed=8)
    small_j.n_users, small_j.n_items = grown.n_users, grown.n_items
    want = small_j.grow_params(jparams, old_u, old_i)
    pm = get_model(IMCGAE_CFG, port_tiny, device="cpu")
    pm.rebuild_for(grown)
    got = pm.grow_params(params_from_jax(jparams, "cpu"), old_u, old_i)
    got, want = got["embedding"].numpy(), np.asarray(want["embedding"])
    assert got.shape == (75 + 90 + 3, 8)
    # the old rows and the three role rows are copies: exact; the new rows
    # are the mean, which sums in another order
    copied = np.r_[0:old_u, 75:75 + old_i, 165:168]
    np.testing.assert_array_equal(got[copied], want[copied])
    np.testing.assert_array_equal(got[-3:], np.asarray(jparams["embedding"])[-3:])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


# -- IDCF_LGCN -------------------------------------------------------------------


@pytest.fixture(scope="module")
def lgcn_path(tiny_ds, tmp_path_factory):
    """A JAX LightGCN checkpoint over the tiny dataset: IDCF's frozen
    table."""
    jm = jax_get_model({"name": "LightGCN", "embedding_size": 8,
                        "n_layers": 2}, tiny_ds)
    path = str(tmp_path_factory.mktemp("lgcn") / "lgcn.pkl")
    jm.save(path, jm.init_params(jax.random.PRNGKey(9)))
    return path


def _idcf_models(jds, pds, path):
    cfg = dict(IDCF_CFG, lgcn_path=path)
    jm = jax_get_model(dict(cfg), jds)
    jparams = jm.init_params(jax.random.PRNGKey(5))
    pm = get_model(cfg, pds, device="cpu")
    return jm, jparams, pm, params_from_jax(jparams, "cpu")


def test_idcf_rep_and_contrastive_match_jax(tiny_ds, port_tiny, lgcn_path):
    jm, jparams, pm, params = _idcf_models(tiny_ds, port_tiny, lgcn_path)
    jb, pb = jm.init_buffers(), pm.init_buffers()
    np.testing.assert_array_equal(pb["embedding"].numpy(),
                                  np.asarray(jb["embedding"]))
    key = jax.random.PRNGKey(21)
    draw = _idcf_draw(jm, key)
    want = jm.rep(jparams, jb, train=True, key=key)
    got = pm.rep(params, pb, train=True, drop=draw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
    users, pos, neg = (np.arange(0, 30, 3), np.arange(10), np.arange(10, 20))
    jout = jm.bpr_pieces_contrastive(jparams, jb, users, pos, neg, train=True,
                                     key=key)
    out = pm.bpr_pieces_contrastive(params, pb, *(torch.as_tensor(a) for a in
                                                  (users, pos, neg)),
                                    train=True, drop=draw)
    for g, w in zip(out, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **F32_TOL)
    # evaluation draws from the port's own fixed seed: the same every call
    torch.testing.assert_close(pm.rep(params, pb), pm.rep(params, pb),
                               rtol=0, atol=0)
    torch.testing.assert_close(pm.rep(params, pb),
                               pm.rep(params, pb, train=True, drop=pm.eval_draw()))


def test_idcf_trainer_step_matches_jax(tiny_ds, port_tiny, lgcn_path):
    cfg = dict(IDCF_CFG, lgcn_path=lgcn_path)
    jt, pt = _trainers(tiny_ds, port_tiny, cfg, IDCF_TRAINER)
    assert "embedding" not in pt.flat_params  # the frozen table is a buffer
    _check_steps(jt, pt, _idcf_draw, 2)


def test_idcf_rebuild_keeps_the_old_counts(port_tiny, lgcn_path):
    model = get_model(dict(IDCF_CFG, lgcn_path=lgcn_path), port_tiny,
                      device="cpu")
    grown = synthetic_interactions(n_users=70, n_items=95, avg_degree=12, seed=7)
    buffers = model.rebuild_for(grown)
    assert (model.n_old_users, model.n_old_items) == (60, 80)
    assert (model.n_users, model.n_items) == (70, 95)
    assert buffers["feat"].n_rows == 165 and buffers["feat"].n_cols == 140
    assert buffers["norm_adj"].n_rows == 165


def test_idcf_pretrains_a_missing_table_jax_loads(tiny_ds, port_tiny,
                                                  tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "lgcn.pkl")
    cfg = dict(IDCF_CFG, lgcn_path=path, lgcn_pretrain_epochs=2,
               lgcn_pretrain_val_interval=1, batch_size=256)
    model = get_model(cfg, port_tiny, device="cpu")
    buffers = model.init_buffers()
    assert os.path.exists(path)
    jm = jax_get_model({"name": "LightGCN", "embedding_size": 8,
                        "n_layers": 2}, tiny_ds)
    table = np.asarray(jm.load(path)["embedding"])
    assert table.shape == (140, 8)
    np.testing.assert_array_equal(buffers["embedding"].numpy(), table)
