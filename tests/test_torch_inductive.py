"""The port's inductive protocols against the JAX package, on a small
synthetic catalog with its dropui and dropit derivations: the same random
params (converted) for IGCN, LightGCN, MF and Popularity give the same
six-slice ``inductive_eval``, the same recommendation ids, the same dropit
stale and rebuilt evals; LightGCN's ``grow_params`` and MF's pieces and
step agree."""

import jax
import numpy as np
import optax
import pytest
import torch

from igcn_cf_tpu.data.synthetic import synthetic_interactions as jax_synthetic
from igcn_cf_tpu.data.transforms import dropit as jax_dropit
from igcn_cf_tpu.data.transforms import dropui as jax_dropui
from igcn_cf_tpu.evaluation.evaluate import recommend as jax_recommend
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.train.trainer import get_trainer as jax_get_trainer
from igcn_cf_tpu_torch.cli.flows import _fresh_trainer_keeping_state
from igcn_cf_tpu_torch.convert import copy_params_, flatten_tree, params_from_jax
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.data.transforms import dropit, dropui
from igcn_cf_tpu_torch.evaluation.evaluate import recommend
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.serve import Recommender
from igcn_cf_tpu_torch.train.trainer import BasicTrainer, get_trainer
from torch_threads import one_thread  # noqa: F401

FULL = dict(n_users=80, n_items=100, avg_degree=14, seed=5)
CONFIGS = {
    "IGCN": {"name": "IGCN", "embedding_size": 16, "n_layers": 2,
             "dropout": 0.3, "feature_ratio": 1.0, "graph_backend": "dense",
             "prop_cache": False},
    "LightGCN": {"name": "LightGCN", "embedding_size": 16, "n_layers": 2,
                 "graph_backend": "dense", "prop_cache": False},
    "MF": {"name": "MF", "embedding_size": 16},
    "Popularity": {"name": "Popularity"},
}
TOPKS = [10, 20]
EVAL_CFG = {"name": "BasicTrainer", "n_epochs": 0, "topks": TOPKS}
# ids rank-wise: at every rank the two ids' scores agree within this
# relative gap. MF's f32 reps are the same in both packages, and retrieval
# is held at 1e-5 as tests/test_torch_retrieval.py holds it; IGCN's and
# LightGCN's propagation rounds each layer's input to bf16, and another
# order of f32 sums can move an element by a bf16 step, so their reps agree
# within tests/test_torch_serve.py's REP_TOL (2e-3 relative) and near-ties
# that close may swap. Popularity's ids are equal.
TOPK_RTOL = {"MF": 1e-5, "IGCN": 2e-3, "LightGCN": 2e-3}
METRIC_ABS = 1e-6
LOSS_RTOL = 1e-5  # one step's loss (PERF.md section 2)
SLICES = ("all_users_all_items", "old_users_all_items", "new_users_all_items",
          "all_users_old_items", "all_users_new_items", "old_users_old_items")


def _pair(derive_jax, derive_port, name, seed=1):
    """(JAX model, params, port model, params) over the derived split, the
    port's params converted from the JAX draw, and both full datasets."""
    jfull, pfull = jax_synthetic(**FULL), synthetic_interactions(**FULL)
    jred, pred = derive_jax(jfull, 0.8), derive_port(pfull, 0.8)
    jm = jax_get_model(dict(CONFIGS[name]), jred)
    pm = get_model(dict(CONFIGS[name]), pred, device="cpu")
    jp = jm.init_params(jax.random.PRNGKey(seed)) if jm.trainable else {}
    pp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jfull, pfull, jm, jp, pm, pp


def _jax_eval_trainer(jm, jds, jp, jb):
    jt = jax_get_trainer(dict(EVAL_CFG), jds, jm)
    jt.params, jt.buffers = jp, jb
    return jt


def _assert_same_metrics(got, want):
    for metric, by_k in want.items():
        for k in TOPKS:
            assert got[metric][k] == pytest.approx(by_k[k], abs=METRIC_ABS), (
                metric, k)


def _assert_same_ids(got, want, scores, name):
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    if name == "Popularity":
        np.testing.assert_array_equal(got, want)
        return
    rows = np.arange(got.shape[0])[:, None]
    sg, sw = scores[rows, got], scores[rows, want]
    assert np.all(np.abs(sg - sw) <= TOPK_RTOL[name] * np.abs(sw)), (got, want)


def _jax_scores(jm, jp, jb, n_users):
    rep = np.asarray(jm.rep(jp, jb, train=False, key=None)) if jm.trainable \
        else np.concatenate([np.ones((n_users, 1), np.float32),
                             jm.item_degree[:, None]])
    return rep[:n_users] @ rep[n_users:].T


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dropui_inductive_eval_matches_jax(name, capsys):
    """Train-free dropui: random params over the 80% split, rebuilt (and,
    for LightGCN, grown) over the full catalog, then the six slices. MF
    has no inductive rebuild: its params are drawn over the full catalog,
    as ``--compare-transductive``'s model is, and sliced the same way."""
    derive = (lambda ds, r: ds) if name == "MF" else None
    jfull, pfull, jm, jp, pm, pp = _pair(derive or jax_dropui, derive or dropui,
                                         name)
    reduced = dropui(pfull, 0.8)
    n_old_users, n_old_items = reduced.n_users, reduced.n_items
    jb, pb = jm.rebuild_for(jfull), pm.rebuild_for(pfull)
    if name == "LightGCN":
        jp = jm.grow_params(jp, n_old_users, n_old_items)
        pp = pm.grow_params(pp, n_old_users, n_old_items)
    want = _jax_eval_trainer(jm, jfull, jp, jb).inductive_eval(
        n_old_users, n_old_items)
    jax_lines = capsys.readouterr().out
    got = BasicTrainer.for_eval(EVAL_CFG, pfull, pm, pp, pb).inductive_eval(
        n_old_users, n_old_items)
    assert capsys.readouterr().out == jax_lines  # the same six lines
    assert tuple(got) == SLICES
    for key in SLICES:
        _assert_same_metrics(got[key], want[key])

    scores = _jax_scores(jm, jp, jb, pfull.n_users)
    for banned in (None, np.arange(n_old_items, pfull.n_items),
                   np.arange(n_old_items)):
        wids = jax_recommend(None, jfull, "test", TOPKS, banned,
                             recommend_fn=jm.make_recommend_fn(jp, jb))
        ids = recommend(pm, pp, pb, pfull, "test", max(TOPKS), banned)
        _assert_same_ids(ids, wids, scores, name)
        if banned is not None:
            # a banned item only where a user has fewer than k others left
            for u, row in enumerate(ids.numpy()):
                left = set(range(pfull.n_items)) - set(banned.tolist()) - set(
                    pfull.train[u]) - set(pfull.val[u])
                n = min(len(left), len(row))
                assert set(row[:n].tolist()) <= left


def test_popularity_ties_break_by_the_lowest_id():
    """Integer degrees tie everywhere: equal scores list the lower id first,
    the order ``lax.top_k`` gives."""
    pfull = synthetic_interactions(**FULL)
    pm = get_model({"name": "Popularity"}, pfull, device="cpu")
    pb = pm.init_buffers()
    ids = recommend(pm, {}, pb, pfull, "train", 20).numpy()
    deg = pm.item_degree
    for row in ids:
        keys = [(-deg[i], i) for i in row]
        assert keys == sorted(keys)
    assert len(np.unique(deg[ids[0]])) < 20  # the case has ties
    red = dropui(pfull, 0.8)
    pm2 = get_model({"name": "Popularity"}, red, device="cpu")
    pb2 = pm2.rebuild_for(pfull)
    np.testing.assert_array_equal(pm2.item_degree, deg)
    torch.testing.assert_close(pb2["item_degree"], pb["item_degree"])


def test_lightgcn_grow_params_matches_jax():
    jfull, pfull, jm, jp, pm, pp = _pair(jax_dropui, dropui, "LightGCN", seed=3)
    n_old_users, n_old_items = pm.n_users, pm.n_items
    jm.rebuild_for(jfull)
    pm.rebuild_for(pfull)
    want = np.asarray(jm.grow_params(jp, n_old_users, n_old_items)["embedding"])
    got = pm.grow_params(pp, n_old_users, n_old_items)["embedding"]
    assert got.shape == (pfull.n_users + pfull.n_items, 16)
    # the mean sums in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-8)
    old = pp["embedding"].detach()
    torch.testing.assert_close(got[:n_old_users], old[:n_old_users], rtol=0, atol=0)
    torch.testing.assert_close(
        got[pfull.n_users:pfull.n_users + n_old_items], old[n_old_users:],
        rtol=0, atol=0)


@pytest.mark.parametrize("name", ["IGCN", "LightGCN", "MF"])
def test_dropit_stale_and_rebuilt_evals_match_jax(name):
    jfull, pfull, jm, jp, pm, pp = _pair(jax_dropit, dropit, name, seed=2)
    jb, pb = jm.init_buffers(), pm.init_buffers()
    results = {}
    for stage in ("stale", "rebuilt"):
        if stage == "rebuilt":
            jb, pb = jm.rebuild_for(jfull), pm.rebuild_for(pfull)
        _, want = _jax_eval_trainer(jm, jfull, jp, jb).eval("test")
        trainer = _fresh_trainer_keeping_state(
            {"name": "BPRTrainer", "topks": TOPKS, "n_epochs": 1}, pfull, pm,
            pp, pb)
        _, results[stage] = trainer.eval("test")
        _assert_same_metrics(results[stage], want)
        wids = jax_recommend(None, jfull, "test", TOPKS,
                             recommend_fn=jm.make_recommend_fn(jp, jb))
        _assert_same_ids(recommend(pm, pp, pb, pfull, "test", 20), wids,
                         _jax_scores(jm, jp, jb, pfull.n_users), name)
    # a graph model sees the new interactions once rebuilt; MF has no graph
    assert (results["stale"] == results["rebuilt"]) == (name == "MF")


def test_eval_only_trainer_builds_nothing_and_evaluates_alike(monkeypatch):
    """``for_eval`` takes the given state: no init params or buffers (which
    for IGCN could build a second propagation cache), no sampler, and the
    same results as a trainer built whole whose state is overwritten."""
    pfull = synthetic_interactions(**FULL)
    cfg = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
           "l2_reg": 0.0, "aux_reg": 0.01, "n_epochs": 1, "topks": TOPKS}
    model = get_model(dict(CONFIGS["IGCN"]), pfull, device="cpu")
    whole = get_trainer(cfg, pfull, model)
    params, buffers = whole.params, whole.buffers
    for attr in ("init_params", "init_buffers"):
        monkeypatch.setattr(model, attr, lambda *a, _n=attr: pytest.fail(_n))
    lean = _fresh_trainer_keeping_state(cfg, pfull, model, params, buffers)
    assert type(lean) is type(whole) and lean.params is params
    assert not hasattr(lean, "sampler") and lean.opt is None
    assert lean.eval("test") == whole.eval("test")
    rec = Recommender.from_trainer(lean)
    assert rec.model is model and rec.params is params
    np.testing.assert_array_equal(
        rec.recommend(np.arange(pfull.n_users), k=20),
        recommend(model, params, buffers, pfull, "val", 20).numpy())


# -- MF ----------------------------------------------------------------------------


MF_TRAINER = {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-3,
              "l2_reg": 1e-3, "n_epochs": 1, "batch_size": 64,
              "topks": TOPKS, "seed": 2021}


def test_mf_rep_pieces_and_step_match_jax():
    jds, pds = jax_synthetic(**FULL), synthetic_interactions(**FULL)
    jm = jax_get_model(dict(CONFIGS["MF"]), jds)
    jt = jax_get_trainer(dict(MF_TRAINER), jds, jm)
    pm = get_model(dict(CONFIGS["MF"]), pds, device="cpu")
    pt = get_trainer(dict(MF_TRAINER), pds, pm)
    copy_params_(pt.params, jt.params)

    want = np.asarray(jm.rep(jt.params, jt.buffers, train=False, key=None))
    got = pm.rep(pt.params, pt.buffers)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)

    k_batch, k_drop = jax.random.split(jax.random.PRNGKey(7))
    users, pos, negs = jt.sampler.sample(k_batch, jt.batch_size)
    batch = tuple(torch.as_tensor(np.array(x)).long()
                  for x in (users, pos, negs[:, 0]))
    jpieces = jm.bpr_pieces(jt.params, jt.buffers, users, pos, negs[:, 0],
                            train=True, key=None)
    for a, b in zip(pm.bpr_pieces(pt.params, pt.buffers, *batch, train=True),
                    jpieces):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-8)

    jloss, jgrads = jax.value_and_grad(jt._loss)(
        jt.params, jt.buffers, jt._samplers(), k_batch, k_drop)
    loss = pt.loss(pt.params, batch, None)
    grads = torch.autograd.grad(loss, list(pt.flat_params.values()))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    jgrads_flat = flatten_tree(jgrads)
    for gname, g in zip(pt.flat_params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads_flat[gname]),
                                   rtol=1e-4, atol=1e-7, err_msg=gname)
    updates, _ = jt.opt.update(jgrads, jt.opt_state, jt.params)
    jnew = flatten_tree(optax.apply_updates(jt.params, updates))
    assert abs(float(pt.train_step(batch, None)) - float(jloss)) <= (
        LOSS_RTOL * abs(float(jloss)))
    for pname, value in pt.flat_params.items():
        np.testing.assert_allclose(value.detach().numpy(), np.asarray(jnew[pname]),
                                   atol=2 * MF_TRAINER["lr"], err_msg=pname)
