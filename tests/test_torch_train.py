"""The port's IGCN training path against the JAX package: trainer steps on
both engines (same params, the JAX package's batches and dropout draws),
Adam, the sampler, the metrics, the alpha anneal, the training loop's
checkpoints, the propagation-cache reuse guard, and the Adam state carried
between the packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import igcn_cf_tpu.kernels.bitpack as jbp
from igcn_cf_tpu.configs import presets as jax_presets
from igcn_cf_tpu.data.sampler import DeviceNegativeSampler as JaxSampler
from igcn_cf_tpu.data.transforms import auxiliary_interactions as jax_aux
from igcn_cf_tpu.evaluation import metrics as jax_metrics
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.train.trainer import get_trainer as jax_get_trainer
from igcn_cf_tpu_torch.configs import presets
from igcn_cf_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_jax,
    copy_params_,
)
from igcn_cf_tpu_torch.core.prng import KeySeq, set_seed
from igcn_cf_tpu_torch.data.sampler import (
    MAX_RETRIES,
    DeviceNegativeSampler,
    sample_bpr_epoch,
)
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.data.transforms import auxiliary_interactions
from igcn_cf_tpu_torch.evaluation import metrics
from igcn_cf_tpu_torch.kernels.dense_graph import FeatDrop
from igcn_cf_tpu_torch.kernels.pcache import build_prop_cache
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.train.trainer import get_trainer

MODEL_CFG = {"name": "IGCN", "embedding_size": 16, "n_layers": 2,
             "dropout": 0.3, "feature_ratio": 1.0, "graph_backend": "dense"}
TRAINER_CFG = {"name": "IGCNTrainer", "optimizer": "Adam", "lr": 1e-3,
               "l2_reg": 1e-3, "aux_reg": 0.01, "n_epochs": 2,
               "batch_size": 64, "topks": [10], "seed": 2021}
LOSS_RTOL = 1e-5
# gradients of one step: the engines sum bf16 products in f32 in another
# order, and the backward rounds cotangents to bf16, so an element can move
# by a bf16 step (2^-8) of its own size; compared against the largest
# gradient magnitude
GRAD_REL = 4e-3


@pytest.fixture(scope="module")
def port_tiny():
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


def _np(x):
    return np.array(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _trainers(jds, pds, prop_cache, model_cfg=MODEL_CFG, trainer_cfg=TRAINER_CFG):
    jm = jax_get_model(dict(model_cfg, prop_cache=prop_cache), jds)
    jt = jax_get_trainer(dict(trainer_cfg), jds, jm)
    pm = get_model(dict(model_cfg, prop_cache=prop_cache), pds, device="cpu")
    pt = get_trainer(dict(trainer_cfg), pds, pm)
    assert pm.pcache is jm.pcache is bool(prop_cache)
    copy_params_(pt.params, jt.params)
    return jt, pt


def _jax_step_inputs(jt, key):
    """The batch, the auxiliary batch and the dropout draw of the JAX
    trainer's step ``key`` (bpr.py:50-53, :123-128; dense_graph.py:285-288)."""
    k_batch, k_drop = jax.random.split(key)
    k_main, k_aux = jax.random.split(k_batch)
    users, pos, negs = jt.sampler.sample(k_main, jt.batch_size)
    a_users, a_pos, a_negs = jt.aux_sampler.sample(k_aux, jt.batch_size)
    batch = tuple(_t(x).long() for x in (users, pos, negs[:, 0]))
    aux = tuple(_t(x).long() for x in (a_users, a_pos, a_negs[:, 0]))
    return (batch, aux, _jax_drop(jt.model, k_drop)), (k_batch, k_drop)


def _jax_drop(jmodel, k_drop):
    """The feature-matrix drop the JAX model draws from ``k_drop``."""
    k_b, k_bt, k_tu, k_ti = jax.random.split(k_drop, 4)
    p = jmodel.dropout
    return FeatDrop(
        int(jbp._seed_from_key(k_b)), int(jbp._seed_from_key(k_bt)),
        _t(jax.random.bernoulli(k_tu, 1.0 - p, (jmodel.n_users, 1))[:, 0]),
        _t(jax.random.bernoulli(k_ti, 1.0 - p, (jmodel.n_items, 1))[:, 0]))


def _assert_grads_close(got, want):
    for name in want:
        g, w = got[name].numpy(), _np(want[name])
        scale = max(np.abs(w).max(), 1e-30)  # an unused param's grad is 0
        np.testing.assert_allclose(g / scale, w / scale, atol=GRAD_REL,
                                   err_msg=name)


@pytest.mark.parametrize("prop_cache", [True, False])
def test_igcn_trainer_steps_match_jax(tiny_ds, port_tiny, prop_cache):
    """Loss and gradients of one step, then three Adam steps, on the same
    params, batches and drops in both packages, on each engine."""
    jt, pt = _trainers(tiny_ds, port_tiny, prop_cache)
    lr = TRAINER_CFG["lr"]
    params, opt_state = jt.params, jt.opt_state
    for step in range(3):
        inputs, (k_batch, k_drop) = _jax_step_inputs(jt, jax.random.PRNGKey(40 + step))
        jloss, jgrads = jax.value_and_grad(jt._loss)(
            params, jt.buffers, jt._samplers(), k_batch, k_drop)
        loss = pt.loss(pt.params, *inputs)
        grads = torch.autograd.grad(loss, list(pt.params.values()))
        loss = float(loss.detach())
        assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
        _assert_grads_close(dict(zip(pt.params, grads)), jgrads)
        updates, opt_state = jt.opt.update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        got = pt.train_step(*inputs)
        assert abs(float(got) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
        for name in params:
            # Adam moves each entry by ~lr where |g| >> eps; a gradient
            # within tolerance can still flip a near-zero entry's step
            np.testing.assert_allclose(pt.params[name].detach().numpy(),
                                       _np(params[name]), atol=2 * lr)
    moved = np.abs(pt.params["embedding"].detach().numpy()
                   - _np(jt.params["embedding"])).max()
    assert 2 * lr < moved <= 3 * lr * 1.01


def test_imf_step_matches_jax(tiny_ds, port_tiny):
    """IMF (no propagation) trains through the same code."""
    cfg = {"name": "IMF", "embedding_size": 16, "n_layers": 0, "dropout": 0.1,
           "feature_ratio": 1.0, "graph_backend": "dense"}
    jt, pt = _trainers(tiny_ds, port_tiny, False, model_cfg=cfg)
    inputs, (k_batch, k_drop) = _jax_step_inputs(jt, jax.random.PRNGKey(8))
    jloss, jgrads = jax.value_and_grad(jt._loss)(
        jt.params, jt.buffers, jt._samplers(), k_batch, k_drop)
    loss = pt.loss(pt.params, *inputs)
    grads = torch.autograd.grad(loss, list(pt.params.values()))
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _assert_grads_close(dict(zip(pt.params, grads)), jgrads)


def test_bpr_trainer_step_matches_jax(tiny_ds, port_tiny):
    """BPRTrainer: bpr + l2_reg * mean(l2), its batch drawn from the step
    key directly (bpr.py:97-102)."""
    cfg = dict(TRAINER_CFG, name="BPRTrainer")
    jt, pt = _trainers(tiny_ds, port_tiny, True, trainer_cfg=cfg)
    k_batch, k_drop = jax.random.split(jax.random.PRNGKey(9))
    users, pos, negs = jt.sampler.sample(k_batch, jt.batch_size)
    drop = _jax_drop(jt.model, k_drop)
    jloss, jgrads = jax.value_and_grad(jt._loss)(
        jt.params, jt.buffers, jt._samplers(), k_batch, k_drop)
    batch = tuple(_t(x).long() for x in (users, pos, negs[:, 0]))
    loss = pt.loss(pt.params, batch, drop)
    grads = torch.autograd.grad(loss, list(pt.params.values()),
                                materialize_grads=True)  # w is unused
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _assert_grads_close(dict(zip(pt.params, grads)), jgrads)


def test_engines_agree_on_a_step(port_tiny):
    """The cache and recompute engines give the same loss and gradients to
    bf16-storage tolerance (P is bf16)."""
    steps = {}
    for prop_cache in (True, False):
        model = get_model(dict(MODEL_CFG, prop_cache=prop_cache), port_tiny, device="cpu")
        trainer = get_trainer(dict(TRAINER_CFG), port_tiny, model)
        inputs = trainer.sample_step()
        loss = trainer.loss(trainer.params, *inputs)
        grads = torch.autograd.grad(loss, list(trainer.params.values()))
        steps[prop_cache] = (float(loss.detach()), grads)
    (l_c, g_c), (l_r, g_r) = steps[True], steps[False]
    assert abs(l_c - l_r) <= 2e-3 * abs(l_r)
    for a, b in zip(g_c, g_r):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 3e-2 * scale


def test_train_step_counts_and_epoch(port_tiny):
    model = get_model(dict(MODEL_CFG, prop_cache=True), port_tiny, device="cpu")
    trainer = get_trainer(dict(TRAINER_CFG), port_tiny, model)
    assert trainer.steps_per_epoch() == -(-len(port_tiny) // 64)
    before = trainer.params["embedding"].detach().clone()
    loss = trainer.train_one_epoch()
    assert np.isfinite(loss)
    assert trainer.step_losses.shape == (trainer.steps_per_epoch(),)
    assert not torch.equal(before, trainer.params["embedding"])
    assert model.alpha == pytest.approx(0.99)


# -- sampler -----------------------------------------------------------------


def test_sampler_structures_match_jax(tiny_ds, port_tiny):
    got = DeviceNegativeSampler.build(port_tiny, device="cpu")
    want = JaxSampler.build(tiny_ds)
    np.testing.assert_array_equal(got.active_users.numpy(), _np(want.active_users))
    np.testing.assert_array_equal(got.user_items.numpy(), _np(want.user_items))
    np.testing.assert_array_equal(got.user_degree.numpy(), _np(want.user_degree))
    assert got.n_items == want.n_items and MAX_RETRIES == 16


@pytest.mark.parametrize("dense", [False, True])
def test_sampler_validity_and_marginals(port_tiny, dense):
    """The device stream differs from the oracle's; validity is exact and
    the marginals agree within sampling noise."""
    ds = port_tiny
    sampler = DeviceNegativeSampler.build(ds, device="cpu")
    if dense:
        model = get_model(dict(MODEL_CFG, prop_cache=False), ds, device="cpu")
        sampler = sampler.with_dense_b(model.init_buffers()["bip"].B)
    n = 40000
    users, pos, negs = sampler.sample(torch.Generator().manual_seed(3), n, 2)
    assert users.shape == pos.shape == (n,) and negs.shape == (n, 2)
    users, pos, negs = users.numpy(), pos.numpy(), negs.numpy()
    train = [set(x) for x in ds.train]
    assert all(p in train[u] for u, p in zip(users, pos))
    assert not any(neg in train[u] for u, row in zip(users, negs) for neg in row)
    o_users, o_pos, o_negs = sample_bpr_epoch(ds, np.random.default_rng(0), n)
    assert not any(neg in train[u] for u, neg in zip(o_users, o_negs[:, 0]))
    for a, b, size in ((users, o_users, ds.n_users), (pos, o_pos, ds.n_items),
                       (negs[:, 0], o_negs[:, 0], ds.n_items)):
        fa = np.bincount(a, minlength=size) / n
        fb = np.bincount(b, minlength=size) / n
        assert np.abs(fa - fb).max() < 0.01


# -- metrics and evaluation -------------------------------------------------------


def _rec_case(rng, n_users=300, n_items=500, k=20):
    eval_data = [list(rng.choice(n_items, size=rng.integers(0, 12), replace=False))
                 for _ in range(n_users)]
    rec = np.stack([rng.choice(n_items, size=k, replace=False)
                    for _ in range(n_users)])
    for u in range(0, n_users, 3):  # plenty of hits
        hits = eval_data[u][:5]
        rec[u, : len(hits)] = hits
    return eval_data, rec


def test_metrics_equal_jax(rng):
    eval_data, rec = _rec_case(rng)
    topks = [5, 10, 20]
    want = jax_metrics.calculate_metrics(eval_data, rec, topks)
    assert metrics.calculate_metrics(eval_data, rec, topks) == want
    assert metrics.calculate_metrics_slow(eval_data, rec, topks) == \
        jax_metrics.calculate_metrics_slow(eval_data, rec, topks)
    dev = metrics.calculate_metrics_device(torch.as_tensor(rec), eval_data, topks)
    for name in want:  # float64 on the device, float32 means in numpy
        for k in topks:
            assert dev[name][k] == pytest.approx(want[name][k], rel=1e-6)
    assert metrics.format_metrics(want, topks) == \
        jax_metrics.format_metrics(want, topks)


def test_trainer_eval_matches_jax(tiny_ds, port_tiny):
    jt, pt = _trainers(tiny_ds, port_tiny, False)
    for split in ("val", "test"):
        _, want = jt.eval(split)
        _, got = pt.eval(split)
        for name in want:
            assert got[name][10] == pytest.approx(want[name][10], abs=1e-6)


# -- training loop, checkpoints, anneal --------------------------------------


def test_train_writes_a_best_checkpoint_jax_reads(tiny_ds, port_tiny, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = get_model(dict(MODEL_CFG, prop_cache=True), port_tiny, device="cpu")
    trainer = get_trainer(dict(TRAINER_CFG, lr=1e-2), port_tiny, model)
    best = trainer.train(verbose=False)
    assert len(trainer.history) == 2 and best == max(r["ndcg"] for r in trainer.history)
    path = trainer.save_path
    assert os.path.exists(path) and os.listdir("checkpoints") == [os.path.basename(path)]
    assert f"{best * 100:.3f}" in path
    jm = jax_get_model(dict(MODEL_CFG, prop_cache=False), tiny_ds)
    jparams = jm.load(path)
    assert jm.alpha == pytest.approx(0.99**2) and jm.user_map == model.user_map
    jbuf = jm.refresh_buffers(jm.init_buffers())
    want = _np(jm.rep(jparams, jbuf, train=False, key=None))
    got = model.rep(trainer.params, trainer.buffers, train=False)
    # each layer rounds its input to bf16: a sum-order difference can move
    # an element by one bf16 step, which the next layers spread
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3,
                               atol=2.0**-9 * np.abs(want).max())
    # the reload at the end reused P: the graph did not change
    assert "pcache" in trainer.buffers


def test_alpha_anneal_matches_jax(tiny_ds, port_tiny):
    jt, pt = _trainers(tiny_ds, port_tiny, False)
    jbuf, pbuf = jt.buffers, pt.buffers
    for _ in range(3):
        jbuf = jt.model.epoch_update(jbuf)
        pbuf = pt.model.epoch_update(pbuf)
    assert pt.model.alpha == jt.model.alpha == pytest.approx(0.99**3)
    assert float(pbuf["alpha"]) == float(jbuf["alpha"])
    want = jt.model.rep(jt.params, jbuf, train=False, key=None)
    got = pt.model.rep(pt.params, pbuf, train=False)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-3, atol=1e-5)


def test_pcache_reuse_needs_the_same_graph(port_tiny):
    """refresh_buffers reuses P for the same graph only: a different graph
    with the same shape and edge count gets its own P (the JAX package
    compares only shape and count, ROADMAP fault 3.3)."""
    model = get_model(dict(MODEL_CFG, prop_cache=True), port_tiny, device="cpu")
    buffers = model.init_buffers()
    same = model.refresh_buffers(buffers)
    assert same["pcache"] is buffers["pcache"]
    train = [list(x) for x in port_tiny.train]
    u = next(i for i, row in enumerate(train) if row)
    train[u][0] = next(i for i in range(port_tiny.n_items) if i not in train[u])
    other = port_tiny.with_splits(train=train)
    assert len(other) == len(port_tiny)
    model.dataset = other
    moved = model.refresh_buffers(buffers)
    assert moved["pcache"] is not buffers["pcache"]
    assert torch.equal(moved["pcache"], build_prop_cache(moved["bip"], 2))
    assert not torch.equal(moved["pcache"], buffers["pcache"])


def test_save_and_load_state_resume(port_tiny, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = get_model(dict(MODEL_CFG, prop_cache=True), port_tiny, device="cpu")
    trainer = get_trainer(dict(TRAINER_CFG), port_tiny, model)
    trainer.train_one_epoch()
    path = trainer.save_state(str(tmp_path / "state.pkl"))
    model2 = get_model(dict(MODEL_CFG, prop_cache=True), port_tiny, device="cpu")
    trainer2 = get_trainer(dict(TRAINER_CFG, seed=5), port_tiny, model2)
    trainer2.load_state(path)
    assert trainer2.start_epoch == 1 and model2.alpha == model.alpha
    for name in trainer.params:
        assert torch.equal(trainer.params[name], trainer2.params[name])
    a = trainer.train_step(*trainer.sample_step())
    b = trainer2.train_step(*trainer2.sample_step())
    assert float(a) == float(b)
    for name in trainer.params:
        assert torch.equal(trainer.params[name], trainer2.params[name])


# -- Adam state across the packages ------------------------------------------


def test_adam_state_round_trip(port_tiny):
    model = get_model(dict(MODEL_CFG, prop_cache=False), port_tiny, device="cpu")
    trainer = get_trainer(dict(TRAINER_CFG), port_tiny, model)
    for _ in range(2):
        trainer.train_step(*trainer.sample_step())
    state = adam_state_to_jax(trainer.opt, trainer.params)
    assert int(state["count"]) == 2
    fresh = torch.optim.Adam(list(trainer.params.values()), lr=1e-3)
    adam_state_from_jax(optax.ScaleByAdamState(**state), trainer.params, fresh)
    for p in trainer.params.values():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.state[p][k], trainer.opt.state[p][k])
        assert float(fresh.state[p]["step"]) == 2.0
    empty = adam_state_to_jax(fresh.__class__(list(trainer.params.values())),
                              trainer.params)
    assert int(empty["count"]) == 0 and not empty["mu"]["w"].any()
    with pytest.raises(ValueError):
        adam_state_from_jax({"nothing": 1}, trainer.params, fresh)


def test_optax_state_after_three_steps_continues_in_the_port(rng):
    """An optax Adam state after 3 steps, loaded into torch.optim.Adam: one
    more step in each package gives the same params."""
    params = {"embedding": jnp.asarray(rng.normal(size=(30, 8)).astype(np.float32)),
              "w": jnp.ones(8, jnp.float32)}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    for _ in range(3):
        g = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
             for k, v in params.items()}
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    tparams = {k: _t(v).requires_grad_() for k, v in params.items()}
    topt = torch.optim.Adam(list(tparams.values()), lr=1e-2, betas=(0.9, 0.999),
                            eps=1e-8)
    adam_state_from_jax(state, tparams, topt)
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
    params = optax.apply_updates(params, upd)
    for k, p in tparams.items():
        p.grad = _t(g[k])
    topt.step()
    for k in params:
        np.testing.assert_allclose(tparams[k].detach().numpy(), _np(params[k]),
                                   rtol=1e-6, atol=1e-7)
    back = adam_state_to_jax(topt, tparams)
    assert int(back["count"]) == int(state[0].count) == 4
    for k in params:
        np.testing.assert_allclose(back["mu"][k], _np(state[0].mu[k]), rtol=1e-6,
                                   atol=1e-8)


# -- the smaller ports -----------------------------------------------------------


@pytest.mark.parametrize("ratio", [1.0, 0.7])
def test_auxiliary_interactions_match_jax(tiny_ds, port_tiny, ratio):
    model = get_model(dict(MODEL_CFG, feature_ratio=ratio, prop_cache=False),
                      port_tiny, device="cpu")
    got = auxiliary_interactions(port_tiny, model.user_map, model.item_map)
    want = jax_aux(tiny_ds, model.user_map, model.item_map)
    assert (got.name, got.n_users, got.n_items) == (want.name, want.n_users, want.n_items)
    assert got.train == want.train and got.val == want.val
    np.testing.assert_array_equal(got.train_array, want.train_array)


def test_presets_equal_jax():
    for name in ("gowalla", "yelp", "amazon"):
        getter = f"get_{name}_config"
        assert getattr(presets, getter)() == getattr(jax_presets, getter)()
    igcn = presets.get_config("gowalla", 2)
    assert igcn[1] == {"name": "IGCN", "embedding_size": 64, "n_layers": 3,
                       "dropout": 0.3, "feature_ratio": 1.0}
    assert igcn[2]["name"] == "IGCNTrainer" and igcn[2]["batch_size"] == 2048


def test_keyseq_is_deterministic():
    a, b = KeySeq(3), set_seed(3)
    assert [a.next_seed() for _ in range(4)] == [b.next_seed() for _ in range(4)]
    assert all(0 <= c.next_seed() < 2**32 for c in [KeySeq(4)] * 50)
    ga, gb = a.generator(), b.generator()
    assert torch.equal(torch.rand(5, generator=ga), torch.rand(5, generator=gb))
    state = a.get_state()
    s1 = a.next_seed()
    a.set_state(state)
    assert a.next_seed() == s1
