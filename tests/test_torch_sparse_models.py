"""The sparse graph branches of IGCN, IMF, LightGCN and NGCF against the JAX
package on ``graph_backend='sparse'``: the host graphs
(``build_feat_mat``, ``l1_norm_adjacency_with_self_loops``) exactly, the
representations and one training step's loss and gradients on the same
params and the JAX package's own keep masks, the alpha anneal, a rebuild
onto a dropui-grown catalog (new rows over the old templates) and serving
after it; then the port's own sparse-vs-dense agreement and the cache
gate, which builds no P on the sparse backend."""

import jax
import numpy as np
import pytest
import torch

from igcn_cf_tpu.data.synthetic import synthetic_interactions as jax_synthetic
from igcn_cf_tpu.data.transforms import dropit as jax_dropit
from igcn_cf_tpu.data.transforms import dropui as jax_dropui
from igcn_cf_tpu.graph import build as jax_build
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.train.trainer import get_trainer as jax_get_trainer
from igcn_cf_tpu_torch.convert import copy_params_, flatten_tree, params_from_jax
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.data.transforms import dropit, dropui
from igcn_cf_tpu_torch.graph import build
from igcn_cf_tpu_torch.kernels.sparse import EdgeKeep
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.models.ngcf import NGCFDrop
from igcn_cf_tpu_torch.serve import Recommender
from igcn_cf_tpu_torch.train.trainer import get_trainer
from torch_threads import one_thread  # noqa: F401

F32_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
# one step's gradients, f32 on both sides, summed in another order: held
# against the largest gradient magnitude of each leaf
GRAD_REL = 1e-5
# tests/test_dense_backend.py:46-54: the dense backend rounds each layer's
# input to bf16, so its reps agree with the sparse ones within 2e-2 of the
# largest magnitude
DENSE_REL = 2e-2

MODELS = {
    "IGCN": {"name": "IGCN", "embedding_size": 16, "n_layers": 2,
             "dropout": 0.3, "feature_ratio": 1.0},
    "IGCN-0.7": {"name": "IGCN", "embedding_size": 16, "n_layers": 2,
                 "dropout": 0.3, "feature_ratio": 0.7},
    "IMF": {"name": "IMF", "embedding_size": 16, "n_layers": 0,
            "dropout": 0.1, "feature_ratio": 1.0},
    "LightGCN": {"name": "LightGCN", "embedding_size": 16, "n_layers": 2},
    "NGCF": {"name": "NGCF", "embedding_size": 16, "layer_sizes": [16, 8],
             "dropout": 0.1},
}
TRAINERS = {
    "IGCN": {"name": "IGCNTrainer", "l2_reg": 1e-3, "aux_reg": 0.01},
    "IMF": {"name": "IGCNTrainer", "l2_reg": 1e-5, "aux_reg": 0.01},
    "LightGCN": {"name": "BPRTrainer", "l2_reg": 1e-4},
    "NGCF": {"name": "BPRTrainer", "l2_reg": 1e-4},
}
BASE_TRAINER = {"optimizer": "Adam", "lr": 1e-3, "n_epochs": 2,
                "batch_size": 64, "topks": [10], "seed": 2021}


@pytest.fixture(scope="module")
def port_tiny():
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


def _np(x):
    return np.array(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _trainers(jds, pds, case, backend="sparse", **extra):
    model_cfg = dict(MODELS[case], graph_backend=backend, **extra)
    trainer_cfg = dict(TRAINERS[case.split("-")[0]], **BASE_TRAINER)
    jm = jax_get_model(dict(model_cfg), jds)
    jt = jax_get_trainer(dict(trainer_cfg), jds, jm)
    pm = get_model(dict(model_cfg), pds, device="cpu")
    pt = get_trainer(dict(trainer_cfg), pds, pm)
    assert jm.backend == pm.backend == backend
    copy_params_(pt.params, jt.params)
    return jt, pt


# -- the host graphs ---------------------------------------------------------------


def _same_coo(got, want):
    for f in ("rows", "cols", "vals"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.shape == want.shape


def test_l1_norm_adjacency_identical_to_jax(tiny_ds):
    args = (tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    _same_coo(build.l1_norm_adjacency_with_self_loops(*args),
              jax_build.l1_norm_adjacency_with_self_loops(*args))


@pytest.mark.parametrize("ratio", [1.0, 0.7, 0.3])
def test_build_feat_mat_identical_to_jax(tiny_ds, ratio):
    args = (tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    user_map, item_map = jax_build.select_templates(*args, ratio)
    got = build.build_feat_mat(*args, user_map, item_map)
    want = jax_build.build_feat_mat(*args, user_map, item_map)
    _same_coo(got.coo, want.coo)
    assert got.row_sum.dtype == want.row_sum.dtype
    np.testing.assert_array_equal(got.row_sum, want.row_sum)
    assert got.n_templates == want.n_templates
    assert got.user_map == want.user_map and got.item_map == want.item_map


# -- representations and one step ----------------------------------------------------


@pytest.mark.parametrize("case", list(MODELS))
def test_sparse_rep_matches_jax(tiny_ds, port_tiny, case):
    jt, pt = _trainers(tiny_ds, port_tiny, case)
    want = jt.model.rep(jt.params, jt.buffers, train=False, key=None)
    got = pt.model.rep(pt.params, pt.buffers)
    assert "bip" not in pt.buffers and "pcache" not in pt.buffers
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)


def _jax_drop(jmodel, jbuffers, k_drop):
    """The draw the JAX model makes from the step's ``k_drop`` on the
    sparse backend: IGCN/IMF one bernoulli over the feature graph's padded
    entries (inmo.py:200-206); NGCF split(key) -> (key, k_edge), one
    bernoulli over the adjacency's padded entries, then a feature keep per
    layer from split(key) in turn (ngcf.py:76-105)."""
    if jmodel.name == "LightGCN":  # no dropout
        return None
    p = jmodel.dropout
    if jmodel.name in ("IGCN", "IMF"):
        nnz = jbuffers["feat_graph"].vals.shape[0]
        return EdgeKeep(_t(jax.random.bernoulli(k_drop, 1.0 - p, (nnz,))))
    key, k_edge = jax.random.split(k_drop)
    nnz = jbuffers["norm_adj"].vals.shape[0]
    edge = EdgeKeep(_t(jax.random.bernoulli(k_edge, 1.0 - p, (nnz,))))
    n = jmodel.n_users + jmodel.n_items
    feat = []
    for size in jmodel.layer_sizes:
        key, k_feat = jax.random.split(key)
        feat.append(_t(jax.random.bernoulli(k_feat, 1.0 - p, (n, size))))
    return NGCFDrop(edge, feat)


def _jax_step_inputs(jt, key):
    """The JAX trainer's batch (and auxiliary batch) and drop of step
    ``key`` (bpr.py:50-53, :97-102, :122-128)."""
    k_batch, k_drop = jax.random.split(key)
    drop = _jax_drop(jt.model, jt.buffers, k_drop)
    if "aux" not in jt._samplers():
        users, pos, negs = jt.sampler.sample(k_batch, jt.batch_size)
        batch = tuple(_t(x).long() for x in (users, pos, negs[:, 0]))
        return (batch, drop), (k_batch, k_drop)
    k_main, k_aux = jax.random.split(k_batch)
    users, pos, negs = jt.sampler.sample(k_main, jt.batch_size)
    a_users, a_pos, a_negs = jt.aux_sampler.sample(k_aux, jt.batch_size)
    batch = tuple(_t(x).long() for x in (users, pos, negs[:, 0]))
    aux = tuple(_t(x).long() for x in (a_users, a_pos, a_negs[:, 0]))
    return (batch, aux, drop), (k_batch, k_drop)


@pytest.mark.parametrize("case", list(MODELS))
def test_sparse_train_step_matches_jax(tiny_ds, port_tiny, case):
    """Loss and gradients of one step on the same params, batch and keep
    masks (JAX's own bernoulli draws, fed in as the port's draw types)."""
    jt, pt = _trainers(tiny_ds, port_tiny, case)
    inputs, (k_batch, k_drop) = _jax_step_inputs(jt, jax.random.PRNGKey(31))
    jloss, jgrads = jax.value_and_grad(jt._loss)(
        jt.params, jt.buffers, jt._samplers(), k_batch, k_drop)
    loss = pt.loss(pt.params, *inputs)
    grads = torch.autograd.grad(loss, list(pt.flat_params.values()))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = flatten_tree(jgrads)
    for name, g in zip(pt.flat_params, grads):
        w = _np(want[name])
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=GRAD_REL,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["IGCN", "NGCF"])
def test_sparse_draw_drop_shapes(port_tiny, case):
    """The trainer's own draw: an EdgeKeep over the graph's padded entries
    that drops about p of them."""
    model = get_model(dict(MODELS[case], graph_backend="sparse"), port_tiny,
                      "cpu")
    pt = get_trainer(dict(TRAINERS[case], **BASE_TRAINER), port_tiny, model)
    drop = pt.model.draw_drop(pt.keys, pt.gen)
    edge = drop if case == "IGCN" else drop.edge
    g = pt.buffers["feat_graph" if case == "IGCN" else "norm_adj"]
    assert isinstance(edge, EdgeKeep) and edge.keep.shape == (g.nnz,)
    assert edge.keep.dtype == torch.bool
    share = 1.0 - float(edge.keep.float().mean())
    assert abs(share - MODELS[case]["dropout"]) < 0.1
    pt.train_one_epoch()  # the whole epoch runs on these draws
    assert torch.isfinite(pt.step_losses).all()


def test_sparse_anneal_matches_jax(tiny_ds, port_tiny):
    """Two epoch_updates reach the sparse edge weights in both packages."""
    jt, pt = _trainers(tiny_ds, port_tiny, "IGCN-0.7")
    jbuf, pbuf = jt.buffers, pt.buffers
    before = pt.model.rep(pt.params, pbuf)
    for _ in range(2):
        jbuf = jt.model.epoch_update(jbuf)
        pbuf = pt.model.epoch_update(pbuf)
    assert pt.model.alpha == jt.model.alpha == pytest.approx(0.99**2)
    assert float(pbuf["alpha"]) == float(jbuf["alpha"])
    got = pt.model.rep(pt.params, pbuf)
    want = jt.model.rep(jt.params, jbuf, train=False, key=None)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32_TOL)
    assert not torch.allclose(got, before)


# -- the inductive contract on the sparse backend --------------------------------------


FULL = dict(n_users=80, n_items=100, avg_degree=14, seed=5)


@pytest.mark.parametrize("case", ["IGCN-0.7", "LightGCN", "NGCF"])
def test_sparse_rebuild_for_grown_catalog_matches_jax(case):
    """Params over the dropui 80% split (NGCF, whose table does not grow:
    the dropit split), rebuilt onto the full catalog: IGCN's new users and
    items get rows over the OLD templates; the rebuilt reps equal JAX's,
    and a Recommender refreshed onto the grown catalog serves those reps
    with train items masked."""
    jfull, pfull = jax_synthetic(**FULL), synthetic_interactions(**FULL)
    if case == "NGCF":
        jred, pred = jax_dropit(jfull, 0.8), dropit(pfull, 0.8)
    else:
        jred, pred = jax_dropui(jfull, 0.8), dropui(pfull, 0.8)
    cfg = dict(MODELS[case], graph_backend="sparse")
    jm, pm = jax_get_model(dict(cfg), jred), get_model(dict(cfg), pred, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(4))
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    if case == "LightGCN":  # the table grows with the catalog (dropui recipe)
        pb = pm.rebuild_for(pfull)
        jb = jm.rebuild_for(jfull)
        jp = jm.grow_params(jp, pred.n_users, pred.n_items)
        pp = pm.grow_params(pp, pred.n_users, pred.n_items)
    else:
        rec = Recommender(pm, pp, pm.init_buffers())
        rec.refresh(pfull)
        pb = rec.buffers
        jb = jm.rebuild_for(jfull)
    if case.startswith("IGCN"):
        assert pm.n_templates == jm.n_templates < pfull.n_users + pfull.n_items + 2
        assert pb["feat_graph"].n_rows == pfull.n_users + pfull.n_items
    want = _np(jm.rep(jp, jb, train=False, key=None))
    got = pm.rep(pp, pb).numpy()
    assert got.shape == (pfull.n_users + pfull.n_items, want.shape[1])
    np.testing.assert_allclose(got, want, **F32_TOL)
    if not case.startswith("IGCN"):
        return
    ids = rec.recommend(np.arange(pfull.n_users), k=10)
    scores = got[: pfull.n_users] @ got[pfull.n_users :].T
    for u in range(pfull.n_users):
        assert not set(np.asarray(ids[u]).tolist()) & set(pfull.train[u])
        top = np.sort(scores[u][[i for i in range(pfull.n_items)
                                 if i not in set(pfull.train[u])]])[::-1][:10]
        np.testing.assert_allclose(np.sort(scores[u][np.asarray(ids[u])])[::-1],
                                   top, rtol=1e-5)


# -- the port's own backends and the cache gate ----------------------------------------


@pytest.mark.parametrize("case", list(MODELS))
def test_port_sparse_matches_dense_rep(port_tiny, case):
    """The same params on both of the port's backends, no dropout: within
    tests/test_dense_backend.py's 2e-2 of the largest magnitude."""
    reps = []
    for backend in ("sparse", "dense"):
        model = get_model(dict(MODELS[case], graph_backend=backend,
                               prop_cache=False), port_tiny, "cpu")
        params = model.init_params(torch.Generator().manual_seed(3))
        reps.append(model.rep(params, model.init_buffers()).numpy())
    scale = np.abs(reps[0]).max()
    np.testing.assert_allclose(reps[1] / scale, reps[0] / scale, atol=DENSE_REL)


@pytest.mark.parametrize("case", ["IGCN", "LightGCN"])
@pytest.mark.parametrize("prop_cache", ["auto", True])
def test_sparse_models_build_no_pcache(port_tiny, case, prop_cache):
    """P is built from the bit-packed B, which the sparse backend does not
    have: the gate turns the cache engine off before any build."""
    model = get_model(dict(MODELS[case], graph_backend="sparse",
                           prop_cache=prop_cache), port_tiny, "cpu")
    assert model.backend == "sparse" and model.pcache is False
    buffers = model.init_buffers()
    assert "pcache" not in buffers and "bip" not in buffers
    assert model.engine_ab is None
    dense = get_model(dict(MODELS[case], graph_backend="dense",
                           prop_cache=True), port_tiny, "cpu")
    assert dense.pcache is True  # the same config on the dense backend
