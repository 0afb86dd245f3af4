"""The port's analysis module (``igcn_cf_tpu_torch.analysis``) against the
JAX package: the theoretical-error curves on the same catalog, the
reference sweep data, the template-ratio sweep, and training at
``feature_ratio`` < 1 (non-identity template maps) on the JAX package's
draws."""

import jax
import numpy as np
import pytest
import torch

import igcn_cf_tpu.kernels.bitpack as jbp
from igcn_cf_tpu.analysis import plots as jplots
from igcn_cf_tpu.analysis import theoretical_error as jte
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.train.trainer import get_trainer as jax_get_trainer
from igcn_cf_tpu_torch.analysis import plots, theoretical_error as te
from igcn_cf_tpu_torch.convert import copy_params_
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.kernels.dense_graph import FeatDrop
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.train.trainer import get_trainer
from torch_threads import one_thread  # noqa: F401

EXACT = dict(rtol=0, atol=1e-10)
LOSS_RTOL = 1e-5
GRAD_REL = 4e-3  # as tests/test_torch_train.py: one step's gradients
MODEL_CFG = {"name": "IGCN", "embedding_size": 16, "n_layers": 2,
             "dropout": 0.3, "feature_ratio": 0.5, "graph_backend": "dense"}
TRAINER_CFG = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
               "l2_reg": 1e-3, "aux_reg": 0.01, "n_epochs": 1,
               "batch_size": 64, "topks": [10], "seed": 2021}


@pytest.fixture(scope="module")
def port_tiny():
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


def _t(x):
    return torch.as_tensor(np.array(x))


# -- theoretical error ------------------------------------------------------------


def test_svd_and_error_curves_equal_jax(tiny_ds, port_tiny):
    np.testing.assert_array_equal(port_tiny.train_array, tiny_ds.train_array)
    u, v = te.svd_factors(port_tiny, rank=8)
    ju, jv = jte.svd_factors(tiny_ds, rank=8)
    np.testing.assert_allclose(u, ju, **EXACT)
    np.testing.assert_allclose(v, jv, **EXACT)
    r = te._interaction_matrix(port_tiny)
    np.testing.assert_array_equal(r, jte._interaction_matrix(tiny_ds))
    ranked = np.random.default_rng(0).permutation(port_tiny.n_users)
    for n_points in (6, 16):
        got = te.error_curve(r, u, ranked, n_points)
        want = jte.error_curve(r, ju, ranked, n_points)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **EXACT)
    frac, err = got
    assert frac[0] == 0.0 and frac[-1] == 1.0
    assert err[0] == 0.0 and err[-1] == 1.0
    assert np.all(np.diff(err) >= -1e-9)  # adding rows only grows the error


def test_theoretical_error_analysis_equals_jax(tiny_ds, port_tiny):
    got = te.theoretical_error_analysis(port_tiny, rank=8, n_points=8)
    want = jte.theoretical_error_analysis(tiny_ds, rank=8, n_points=8)
    for side in ("users", "items"):
        assert set(got[side]) == set(want[side]) == {
            "sort", "degree", "page_rank", "fraction"}
        for key in want[side]:
            np.testing.assert_allclose(got[side][key], want[side][key], **EXACT,
                                       err_msg=f"{side} {key}")


# -- the template-ratio sweep -------------------------------------------------------


def test_reference_sweep_equals_jax():
    assert plots.REFERENCE_TEMPLATE_SWEEP == jplots.REFERENCE_TEMPLATE_SWEEP
    assert plots.REFERENCE_TEMPLATE_SWEEP["INMO-LGCN-degree"][-1] == 15.341


@pytest.fixture(scope="module")
def sweep_ds(port_tiny, tmp_path_factory):
    path = tmp_path_factory.mktemp("sweep_ds") / "ds"
    port_tiny.output(str(path))
    return {"name": "ProcessedDataset", "path": str(path)}


def test_template_ratio_sweep_is_finite(sweep_ds, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the trainers' best checkpoints land here
    out = plots.template_ratio_sweep(
        sweep_ds, dict(MODEL_CFG, prop_cache=False), TRAINER_CFG,
        ratios=(0.5, 1.0), ranking_metrics=("degree", "sort"), device="cpu")
    assert set(out) == {"ratio", "degree", "sort"}
    assert out["ratio"] == [0.5, 1.0]
    values = np.array([out["degree"], out["sort"]])
    assert values.shape == (2, 2)
    assert np.isfinite(values).all() and (values >= 0).all() and (values <= 100).all()


def test_plots_write_pngs(port_tiny, tmp_path):
    png = b"\x89PNG\r\n\x1a\n"
    path = tmp_path / "sweep.png"
    plots.plot_template_ratio(plots.REFERENCE_TEMPLATE_SWEEP, str(path))
    assert path.read_bytes()[:8] == png
    path = tmp_path / "error.png"
    te.plot_theoretical_error(
        te.theoretical_error_analysis(port_tiny, rank=4, n_points=4), str(path))
    assert path.read_bytes()[:8] == png


# -- training at feature_ratio < 1 against the JAX package ---------------------------


def _jax_step_inputs(jt, key):
    """The batch, the auxiliary batch and the dropout draw of the JAX
    trainer's step ``key`` (bpr.py:50-53, :123-128; dense_graph.py:285-288),
    as tests/test_torch_train.py draws them."""
    k_batch, k_drop = jax.random.split(key)
    k_main, k_aux = jax.random.split(k_batch)
    users, pos, negs = jt.sampler.sample(k_main, jt.batch_size)
    a_users, a_pos, a_negs = jt.aux_sampler.sample(k_aux, jt.batch_size)
    batch = tuple(_t(x).long() for x in (users, pos, negs[:, 0]))
    aux = tuple(_t(x).long() for x in (a_users, a_pos, a_negs[:, 0]))
    k_b, k_bt, k_tu, k_ti = jax.random.split(k_drop, 4)
    p = jt.model.dropout
    drop = FeatDrop(
        int(jbp._seed_from_key(k_b)), int(jbp._seed_from_key(k_bt)),
        _t(jax.random.bernoulli(k_tu, 1.0 - p, (jt.model.n_users, 1))[:, 0]),
        _t(jax.random.bernoulli(k_ti, 1.0 - p, (jt.model.n_items, 1))[:, 0]))
    return (batch, aux, drop), (k_batch, k_drop)


@pytest.mark.parametrize("metric,prop_cache", [
    ("degree", False), ("sort", False), ("page_rank", False), ("degree", True)])
def test_half_templates_step_matches_jax(tiny_ds, port_tiny, metric, prop_cache):
    """At feature_ratio 0.5 the template maps equal JAX's, and one step's
    loss and gradients match on the same params and draws."""
    cfg = dict(MODEL_CFG, ranking_metric=metric, prop_cache=prop_cache)
    jm = jax_get_model(dict(cfg), tiny_ds)
    jt = jax_get_trainer(dict(TRAINER_CFG), tiny_ds, jm)
    pm = get_model(dict(cfg), port_tiny, device="cpu")
    pt = get_trainer(dict(TRAINER_CFG), port_tiny, pm)
    assert pm.user_map == jm.user_map and pm.item_map == jm.item_map
    assert len(pm.user_map) == 30 and len(pm.item_map) == 40
    assert not pm._identity_templates()
    assert pm.pcache is jm.pcache is prop_cache
    copy_params_(pt.params, jt.params)
    inputs, (k_batch, k_drop) = _jax_step_inputs(jt, jax.random.PRNGKey(5))
    jloss, jgrads = jax.value_and_grad(jt._loss)(
        jt.params, jt.buffers, jt._samplers(), k_batch, k_drop)
    loss = pt.loss(pt.params, *inputs)
    grads = torch.autograd.grad(loss, list(pt.params.values()))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for name, g in zip(pt.params, grads):
        w = np.array(jgrads[name])
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=GRAD_REL,
                                   err_msg=name)
