"""The port's IGCN serving slice against the JAX package: the same weights
give the same representations (within bf16 re-rounding) and the same
recommendations, through checkpoints written by either package, across an
inductive refresh onto a grown catalog."""

import os

import jax
import numpy as np
import pytest
import torch

from igcn_cf_tpu.data.transforms import dropui as jax_dropui
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.serve import Recommender as JaxRecommender
from igcn_cf_tpu_torch.convert import (
    load_jax_checkpoint,
    params_from_jax,
    params_to_jax,
)
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.data.transforms import dropui
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.serve import Recommender

MODEL_CFG = {
    "name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.0,
    "feature_ratio": 1.0, "graph_backend": "dense", "prop_cache": False,
}
# Each layer rounds its input to bf16, and a different order of f32 sums can
# move an element across a bf16 boundary: one bf16 step (2^-8 relative),
# which spreads into the next layer.
REP_TOL = dict(rtol=2e-3, atol=1e-5)


@pytest.fixture(scope="module")
def port_tiny():
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


def _jax_model(ds, cfg=MODEL_CFG, seed=0):
    model = jax_get_model(dict(cfg), ds)
    params = model.init_params(jax.random.PRNGKey(seed))
    return model, params, model.init_buffers()


def _port_model(ds, jparams, cfg=MODEL_CFG):
    model = get_model(dict(cfg), ds, device="cpu")
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    return model, params, model.init_buffers()


def assert_same_ids(got, want, scores):
    """Identical ids, except between scores within the representation
    tolerance (a near-tie at or inside rank k may swap)."""
    if np.array_equal(got, want):
        return
    rows = np.arange(got.shape[0])[:, None]
    sg, sw = scores[rows, got], scores[rows, want]
    bound = REP_TOL["atol"] * 10 + REP_TOL["rtol"] * np.abs(sw)
    assert np.all(np.abs(sg - sw) <= bound), (got, want)


def _scores(rep, n_users, users):
    rep = np.asarray(rep)
    return rep[users] @ rep[n_users:].T


@pytest.mark.parametrize("name,ratio", [("IGCN", 1.0), ("IGCN", 0.5), ("IMF", 1.0)])
def test_rep_matches_jax(tiny_ds, port_tiny, name, ratio):
    cfg = dict(MODEL_CFG, name=name, feature_ratio=ratio)
    jm, jp, jb = _jax_model(tiny_ds, cfg)
    pm, pp, pb = _port_model(port_tiny, jp, cfg)
    assert pm.user_map == jm.user_map and pm.item_map == jm.item_map
    want = np.asarray(jm.rep(jp, jb, train=False, key=None))
    got = pm.rep(pp, pb, train=False)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **REP_TOL)
    torch.testing.assert_close(pm(pp, pb), got)  # forward is the eval rep


@pytest.mark.parametrize("exclude,banned", [("train", None), ("all", None),
                                            ("train", np.arange(0, 40, 3))])
def test_recommend_matches_jax(tiny_ds, port_tiny, exclude, banned):
    jm, jp, jb = _jax_model(tiny_ds)
    pm, pp, pb = _port_model(port_tiny, jp)
    users = np.arange(tiny_ds.n_users)
    want = JaxRecommender(jm, jp, jb, exclude=exclude).recommend(
        users, k=10, banned_items=banned)
    got = Recommender(pm, pp, pb, exclude=exclude).recommend(
        users, k=10, banned_items=banned)
    assert got.dtype == np.int64 and got.shape == (len(users), 10)
    rep = jm.rep(jp, jb, train=False, key=None)
    assert_same_ids(got, want, _scores(rep, tiny_ds.n_users, users))
    for u, row in zip(users, got):
        known = set(tiny_ds.train[u])
        if exclude == "all":
            known |= set(tiny_ds.val[u]) | set(tiny_ds.test[u])
        if banned is not None:
            known |= set(banned.tolist())
        assert len(set(row.tolist())) == 10 and not set(row.tolist()) & known


def test_jax_checkpoint_refreshed_onto_grown_catalog(tiny_ds, port_tiny, tmp_path):
    """The INMO serving story: a checkpoint trained on the dropui (80%)
    catalog, loaded by the port and refreshed onto the full catalog, serves
    users and items that did not exist at training time, as JAX does."""
    j_reduced = jax_dropui(tiny_ds, 0.8)
    jm, jp, _ = _jax_model(j_reduced)
    path = os.path.join(tmp_path, "jax_ckpt.pkl")
    jm.save(path, jp)

    rec = Recommender.from_checkpoint(path, MODEL_CFG, dropui(port_tiny, 0.8),
                                      device="cpu")
    assert rec.model.n_users == j_reduced.n_users
    seconds = rec.refresh(port_tiny)
    assert seconds >= 0.0 and rec.model.n_users == tiny_ds.n_users
    new_users = np.arange(j_reduced.n_users, tiny_ds.n_users)
    got = rec.recommend(new_users, k=10)

    jrec = JaxRecommender.from_checkpoint(path, MODEL_CFG, j_reduced, bucket=False)
    jrec.refresh(tiny_ds)
    want = jrec.recommend(new_users, k=10)
    rep = jrec.model.rep(jrec.params, jrec.buffers, train=False, key=None)
    assert_same_ids(got, want, _scores(rep, tiny_ds.n_users, new_users))
    for u, row in zip(new_users, got):
        assert row.min() >= 0 and row.max() < tiny_ds.n_items
        assert not set(row.tolist()) & set(tiny_ds.train[u])
    # new items (ids >= the reduced catalog) are servable too
    assert rec.recommend(np.arange(tiny_ds.n_users), k=10).max() >= j_reduced.n_items


def test_port_checkpoint_loads_in_jax(tiny_ds, port_tiny, tmp_path):
    pm = get_model(dict(MODEL_CFG), port_tiny, device="cpu")
    pp = pm.init_params(torch.Generator().manual_seed(5))
    path = os.path.join(tmp_path, "port_ckpt.pkl")
    pm.save(path, pp)

    jrec = JaxRecommender.from_checkpoint(path, MODEL_CFG, tiny_ds, bucket=False)
    rec = Recommender.from_checkpoint(path, MODEL_CFG, port_tiny, device="cpu")
    for name, value in pp.items():
        np.testing.assert_array_equal(np.asarray(jrec.params[name]), value.numpy())
    want_rep = jrec.model.rep(jrec.params, jrec.buffers, train=False, key=None)
    got_rep = rec.model.rep(rec.params, rec.buffers)
    np.testing.assert_allclose(got_rep.numpy(), np.asarray(want_rep), **REP_TOL)
    users = np.arange(tiny_ds.n_users)
    assert_same_ids(rec.recommend(users, k=10), jrec.recommend(users, k=10),
                    _scores(want_rep, tiny_ds.n_users, users))


def test_convert_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    blob = {"embedding": rng.normal(size=(5, 3)).astype(np.float32),
            "w": np.ones(3, np.float32)}
    params = params_from_jax(blob, "cpu")
    back = params_to_jax(params)
    for k in blob:
        np.testing.assert_array_equal(back[k], blob[k])
        assert back[k].dtype == blob[k].dtype
    blob["embedding"][0, 0] = 9.0  # params_from_jax copies
    assert float(params["embedding"][0, 0]) != 9.0
    import pickle

    path = os.path.join(tmp_path, "c.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": blob, "extra": {"alpha": 1.0}}, f)
    loaded, extra = load_jax_checkpoint(path, "cpu")
    assert extra == {"alpha": 1.0}
    np.testing.assert_array_equal(loaded["embedding"].numpy(), blob["embedding"])


class _ExtraRowIGCN:
    """A model whose representation table has a row too many (what
    catalog bucketing produced in the JAX package)."""

    def __init__(self, model):
        self._m = model

    def __getattr__(self, name):
        return getattr(self._m, name)

    def rep(self, params, buffers, *, train=False):
        rep = self._m.rep(params, buffers, train=train)
        return torch.cat([rep, rep[:1]])


def test_recommender_validates_rep_rows(port_tiny):
    pm = get_model(dict(MODEL_CFG), port_tiny, device="cpu")
    pp, pb = pm.init_params(torch.Generator().manual_seed(0)), pm.init_buffers()
    with pytest.raises(ValueError, match="rows"):
        Recommender(_ExtraRowIGCN(pm), pp, pb)


def test_recommend_refuses_bad_requests(port_tiny):
    pm = get_model(dict(MODEL_CFG), port_tiny, device="cpu")
    pp, pb = pm.init_params(torch.Generator().manual_seed(0)), pm.init_buffers()
    rec = Recommender(pm, pp, pb)
    assert rec.recommend([], k=5).shape == (0, 5)
    with pytest.raises(ValueError):
        rec.recommend([port_tiny.n_users], k=5)
    with pytest.raises(ValueError):
        rec.recommend([0], k=5, banned_items=[port_tiny.n_items])
    with pytest.raises(ValueError):
        Recommender(pm, pp, pb, exclude="val")


def test_training_paths_are_not_ported(port_tiny):
    """Training is ported now (tests/test_torch_train.py): the train rep
    carries gradients and the propagation cache builds. The sparse backend
    is still not ported, and serving never builds the cache."""
    pm = get_model(dict(MODEL_CFG), port_tiny, device="cpu")
    pp, pb = pm.init_params(), pm.init_buffers()
    pp["embedding"].requires_grad_()
    assert pm.rep(pp, pb, train=True).requires_grad
    assert not pm.rep(pp, pb, train=False).requires_grad
    cached = get_model(dict(MODEL_CFG, prop_cache=True), port_tiny, device="cpu")
    assert cached.pcache and "pcache" in cached.init_buffers()
    with pytest.raises(NotImplementedError, match="sparse"):
        get_model(dict(MODEL_CFG, graph_backend="sparse"), port_tiny, device="cpu")
