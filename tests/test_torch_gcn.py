"""The port's NGCF and LightGCN training against the JAX package: the
dropout-masked bit-packed product (K6m/K7m's plain versions) with its mask
bit-exact, NGCF's propagation and representation on the JAX package's own
draws, trainer steps and Adam, evaluation, and nested checkpoints carried
both ways."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import igcn_cf_tpu.kernels.bitpack as jbp
import igcn_cf_tpu.kernels.dense_graph as jdg
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.train.trainer import get_trainer as jax_get_trainer
from igcn_cf_tpu_torch.convert import (
    adam_state_from_jax,
    adam_state_to_jax,
    copy_params_,
    flatten_tree,
    load_jax_checkpoint,
    params_from_jax,
)
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.kernels import bitpack, dense_graph
from igcn_cf_tpu_torch.kernels.bitpack import TK, TM
from igcn_cf_tpu_torch.kernels.dense_graph import FeatDrop
from igcn_cf_tpu_torch.models.base import get_model, kaiming_uniform, linear_init
from igcn_cf_tpu_torch.models.ngcf import NGCFDrop
from igcn_cf_tpu_torch.train.trainer import get_trainer

# bf16 operands, f32 sums in another order: only the sums' rounding differs
PAIR_TOL = dict(rtol=1e-5, atol=1e-4)
LOSS_RTOL = 1e-5
# one step's gradients against the largest magnitude: the backward rounds
# cotangents to bf16, and a sum-order difference upstream can move one
# across a bf16 step (tests/test_torch_train.py GRAD_REL)
GRAD_REL = 4e-3
NGCF_CFG = {"name": "NGCF", "embedding_size": 16, "layer_sizes": [16, 8],
            "dropout": 0.1, "graph_backend": "dense"}
LGCN_CFG = {"name": "LightGCN", "embedding_size": 16, "n_layers": 2,
            "graph_backend": "dense"}
TRAINER_CFG = {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-3,
               "l2_reg": 1e-3, "n_epochs": 1, "batch_size": 64, "topks": [10],
               "seed": 2021}


@pytest.fixture(scope="module")
def port_tiny():
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


def _np(x):
    return np.array(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _u32(t):
    return (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).view(np.uint32)


def _edge_drop(key, n_users, n_items, p):
    """The edge draw JAX ngcf_propagate makes from its key
    (dense_graph.py:239-242): split(key, 4) -> (k_b, k_bt, k_su, k_si)."""
    k_b, k_bt, k_su, k_si = jax.random.split(key, 4)
    return FeatDrop(
        int(jbp._seed_from_key(k_b)), int(jbp._seed_from_key(k_bt)),
        _t(jax.random.bernoulli(k_su, 1.0 - p, (n_users, 1))[:, 0]),
        _t(jax.random.bernoulli(k_si, 1.0 - p, (n_items, 1))[:, 0]))


def _ngcf_drop(jmodel, key):
    """The draw JAX NGCF.rep makes from its step key (ngcf.py:76-105):
    split(key) -> (key, k_edge); each layer split(key) -> (key, k_feat)."""
    key, k_edge = jax.random.split(key)
    n = jmodel.n_users + jmodel.n_items
    p = jmodel.dropout
    feat = []
    for size in jmodel.layer_sizes:
        key, k_feat = jax.random.split(key)
        feat.append(_t(jax.random.bernoulli(k_feat, 1.0 - p, (n, size))))
    return NGCFDrop(_edge_drop(k_edge, jmodel.n_users, jmodel.n_items, p), feat)


def _assert_grads_close(got, want):
    for name in want:
        g, w = got[name].numpy(), _np(want[name])
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, atol=GRAD_REL,
                                   err_msg=name)


# -- bb_matmul_dropped: K6m/K7m's plain versions ---------------------------------


def _masked_case(rng, integer=False):
    b = (rng.random((2 * TM, TK)) < 0.1).astype(np.float32)
    wp = bitpack.pack_bits(b)
    draw = ((lambda shape: rng.integers(-4, 5, shape).astype(np.float32))
            if integer else
            (lambda shape: rng.normal(size=shape).astype(np.float32)))
    return wp, draw


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("integer", [True, False])
def test_bb_matmul_dropped_and_grad_match_jax(rng, transpose, integer):
    """Forward and backward against JAX's ``bb_matmul_dropped`` under the
    seed its key yields. With small integers every sum is exact, so equal
    outputs mean identical keep masks, bit for bit."""
    wp, draw = _masked_case(rng, integer=integer)
    m, k = wp.shape[0], wp.shape[1] * 32
    x = draw(((m if transpose else k), 16))
    ct = draw(((k if transpose else m), 16))
    key = jax.random.PRNGKey(5 + transpose)
    seed = int(jbp._seed_from_key(key))
    jy, vjp = jax.vjp(
        lambda v: jbp.bb_matmul_dropped(jnp.asarray(_u32(wp)), v, key, 0.1,
                                        transpose), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_()
    y = bitpack.bb_matmul_dropped(_t(wp), xt, seed, 0.1, transpose)
    (dx,) = torch.autograd.grad(y, xt, _t(ct))
    if integer:
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
    else:
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **PAIR_TOL)
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **PAIR_TOL)
    # the drop is real, and the backward saw the forward's drops
    full = bitpack.bb_matmul(_t(wp), _t(x), transpose)
    assert not torch.equal(full, y.detach())


@pytest.mark.parametrize("seed", [3, 2**32 - 1])
def test_masked_product_equals_product_over_mask_words(rng, monkeypatch, seed):
    """The masked products' plain versions (keep_mask_dense, in row chunks,
    here a ragged 384) equal the unmasked products over ``mask_words``'s
    copy of B: the same frame, which K6m/K7m must also hold on the card."""
    monkeypatch.setattr(bitpack, "_PLAIN_ROWS", 384)
    wp, draw = _masked_case(rng, integer=True)
    wp = _t(wp)
    m, k = wp.shape[0], wp.shape[1] * 32
    premasked = bitpack.mask_words(wp, seed, 0.3)
    xk, xm = _t(draw((k, 8))), _t(draw((m, 8)))
    assert torch.equal(bitpack.mm_fwd_masked(wp, xk, seed, 0.3),
                       bitpack.mm_fwd_plain(premasked, xk))
    assert torch.equal(bitpack.mm_bwd_masked(wp, xm, seed, 0.3),
                       bitpack.mm_bwd_plain(premasked, xm))


def test_keep_mask_dense_row_window():
    """Rows [row0, row0 + n) of the mask are that window of the whole."""
    whole = bitpack.keep_mask_dense(9, 3 * TM, 300, 0.1)
    part = bitpack.keep_mask_dense(9, 700, 300, 0.1, row0=600)
    assert torch.equal(part, whole[600:1300])


def test_masked_wrappers_refuse_bad_seeds():
    wp = torch.zeros((TM, 128), dtype=torch.int32)
    for bad in (-1, 2**32):
        with pytest.raises(ValueError):
            bitpack.mm_fwd_masked(wp, torch.zeros(TK, 4), bad, 0.1)
        with pytest.raises(ValueError):
            bitpack.bb_matmul_dropped(wp, torch.zeros(TM, 4), bad, 0.1, True)


# -- K7m's rows route over a transposed pack: its plain version ------------------


def _heavy_pairs(rng, n_users, n_items, nnz, heavy_item, heavy_users):
    """Random (user, item) pairs plus one item that ``heavy_users`` users
    hold: a row of B^T with that many set bits."""
    pairs = np.stack([rng.integers(0, n_users, nnz),
                      rng.integers(0, n_items, nnz)], axis=1)
    heavy = np.stack([np.arange(heavy_users), np.full(heavy_users, heavy_item)],
                     axis=1)
    return np.concatenate([pairs, heavy])


@pytest.mark.parametrize("n_users,n_items,nnz", [
    (700, 5000, 6000),   # two column tiles of items, users in one tile
    (4500, 300, 9000),   # users over two tiles: B^T's columns padded to 8,192
])
def test_transposed_pack_equals_pack_bits_of_bt(rng, n_users, n_items, nnz):
    """The pack ``build`` makes from its index arrays is ``pack_bits`` of the
    transposed unpacked B, its rows B's real columns and its columns B's
    rows padded to TK; the order lists rows by descending set bits."""
    pairs = _heavy_pairs(rng, n_users, n_items, nnz, n_items - 1, 300)
    g = dense_graph.BipartiteDense.build(pairs, n_users, n_items, device="cpu",
                                         transposed=True)
    bt = bitpack.unpack_bits(g.B).T[:n_items].numpy()
    width = bitpack.pad_to(g.rows_padded, TK)
    want = bitpack.pack_bits(np.pad(bt, ((0, 0), (0, width - bt.shape[1]))))
    np.testing.assert_array_equal(g.BT.words.numpy(), want)
    deg = bt.sum(axis=1)
    order = g.BT.order.numpy()
    assert sorted(order) == list(range(n_items)) and order[0] == n_items - 1
    assert (np.diff(deg[order]) <= 0).all()
    assert g.BT.heavy == int((deg > bitpack.HEAVY_BITS).sum()) == 1
    assert (g.BT.m, g.BT.k) == (g.rows_padded, g.cols_padded)
    again = bitpack.transpose_words(g.B, n_items)
    assert torch.equal(again.words, g.BT.words)
    assert torch.equal(again.order, g.BT.order) and again.heavy == g.BT.heavy


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("p", [0.1, 0.3])
@pytest.mark.parametrize("seed", [11, 2**32 - 9])
def test_rows_route_plain_equals_masked_plain(rng, monkeypatch, seed, p, d):
    """K7m's rows route (plain version) equals ``mm_bwd_masked_plain`` over
    B exactly: small integers make every sum exact, so equal outputs mean
    the same keep decisions, taken in B's coordinates. Item 4,100 has 400
    users, more than one gather list of the kernel's walk; the row blocks
    are a ragged 384."""
    monkeypatch.setattr(bitpack, "_PLAIN_ROWS", 384)
    pairs = _heavy_pairs(rng, 900, 5000, 8000, 4100, 400)
    g = dense_graph.BipartiteDense.build(pairs, 900, 5000, device="cpu",
                                         transposed=True)
    x = torch.as_tensor(rng.integers(-4, 5, (g.rows_padded, d)).astype(np.float32))
    got = bitpack.mm_bwd_masked_rows(g.BT, x, seed, p)
    want = bitpack.mm_bwd_masked_plain(g.B, x, seed, p)
    assert torch.equal(got, want)
    assert not torch.equal(got, bitpack.mm_bwd_plain(g.B, x))  # it drops


@pytest.mark.parametrize("dropout", [0.1, 0.5])
def test_ngcf_same_with_and_without_transposed_pack(port_tiny, dropout):
    """NGCF's loss and gradients on the CPU through the rows route (the
    graph ``init_buffers`` builds, with B^T) and through the t2 orientation
    over B alone: the same edges and operands, f32 sums in another order."""
    from igcn_cf_tpu_torch.core.prng import KeySeq

    cfg = dict(NGCF_CFG, dropout=dropout)
    model = get_model(cfg, port_tiny, device="cpu")
    buffers = model.init_buffers()
    assert buffers["bip"].BT is not None
    plain = {"bip": dataclasses.replace(buffers["bip"], BT=None)}
    params = model.init_params(torch.Generator().manual_seed(3))
    drop = model.draw_drop(KeySeq(4), torch.Generator().manual_seed(4))
    users = torch.arange(0, 40)
    pos, neg = torch.arange(40) % port_tiny.n_items, torch.arange(40, 80) % port_tiny.n_items
    leaves = [v.requires_grad_() for v in flatten_tree(params).values()]
    results = []
    for bufs in (buffers, plain):
        u, pp, n, l2 = model.bpr_pieces(params, bufs, users, pos, neg, train=True,
                                        drop=drop)
        loss = (torch.nn.functional.softplus((u * n).sum(1) - (u * pp).sum(1)).mean()
                + 1e-3 * l2.mean())
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (loss_a, grads_a), (loss_b, grads_b) = results
    torch.testing.assert_close(loss_a, loss_b, rtol=1e-6, atol=0)
    for ga, gb in zip(grads_a, grads_b):
        torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,cfg", [
    ("NGCF", NGCF_CFG),
    ("LightGCN", dict(LGCN_CFG, prop_cache=False)),
    ("IGCN", {"name": "IGCN", "embedding_size": 16, "n_layers": 2,
              "dropout": 0.3, "feature_ratio": 1.0, "graph_backend": "dense",
              "prop_cache": False}),
])
def test_only_ngcf_packs_b_transposed(port_tiny, name, cfg):
    """NGCF's graph carries B's transposed pack; IGCN's and LightGCN's do
    not, so their set-up and memory do not grow."""
    bip = get_model(cfg, port_tiny, device="cpu").init_buffers()["bip"]
    assert (bip.BT is not None) == (name == "NGCF")


# -- NGCF propagation and representation ------------------------------------------


def _graphs(ds):
    arr, n_u, n_i = ds.train_array, ds.n_users, ds.n_items
    return (dense_graph.BipartiteDense.build(arr, n_u, n_i, device="cpu"),
            jdg.BipartiteDense.build(arr, n_u, n_i))


@pytest.mark.parametrize("dropout", [0.0, 0.1, 0.5])
def test_ngcf_propagate_and_grad_match_jax(small_ds, rng, dropout):
    g, jg = _graphs(small_ds)
    n_u, n_i = small_ds.n_users, small_ds.n_items
    x = rng.normal(size=(n_u + n_i, 8)).astype(np.float32)
    key = jax.random.PRNGKey(31)
    want, vjp = jax.vjp(
        lambda v: jdg.ngcf_propagate(jg, v, dropout=dropout, key=key),
        jnp.asarray(x))
    ct = rng.normal(size=want.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_()
    drop = _edge_drop(key, n_u, n_i, dropout) if dropout else None
    got = dense_graph.ngcf_propagate(g, xt, dropout=dropout, drop=drop)
    (dx,) = torch.autograd.grad(got, xt, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **PAIR_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **PAIR_TOL)


def _ngcf_models(jds, pds, cfg=NGCF_CFG):
    jm = jax_get_model(dict(cfg), jds)
    jparams = jm.init_params(jax.random.PRNGKey(4))
    pm = get_model(dict(cfg), pds, device="cpu")
    return jm, jparams, pm, params_from_jax(jparams, "cpu")


@pytest.mark.parametrize("train", [True, False])
def test_ngcf_rep_matches_jax(tiny_ds, port_tiny, train):
    jm, jparams, pm, params = _ngcf_models(tiny_ds, port_tiny)
    key = jax.random.PRNGKey(17)
    want = jm.rep(jparams, jm.init_buffers(), train=train, key=key)
    drop = _ngcf_drop(jm, key) if train else None
    got = pm.rep(params, pm.init_buffers(), train=train, drop=drop)
    assert got.shape == (port_tiny.n_users + port_tiny.n_items, 16 + 16 + 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-3, atol=1e-5)


def test_ngcf_params_shapes_and_init(tiny_ds, port_tiny):
    """The tree of JAX's NGCF.init_params, drawn from the port's own
    generator with the same bounds."""
    params = get_model(NGCF_CFG, port_tiny, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    want = jax_get_model(dict(NGCF_CFG), tiny_ds).init_params(jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in flatten_tree(params).items()}
    assert shapes == {k: tuple(v.shape) for k, v in flatten_tree(want).items()}
    assert shapes["embedding"] == (140, 16) and shapes["gc_layers.1.w"] == (16, 8)
    assert float(params["embedding"].abs().max()) <= np.sqrt(6 / 16)
    w = kaiming_uniform(torch.Generator().manual_seed(1), (4000, 24))
    assert abs(float(w.abs().max()) - np.sqrt(6 / 24)) < 1e-3
    layer = linear_init(torch.Generator().manual_seed(2), 24, 10)
    assert layer["w"].shape == (24, 10) and not layer["b"].any()
    assert float(layer["w"].abs().max()) <= np.sqrt(6 / 24)  # fan_in = 24


def test_ngcf_draw_drop_shapes(port_tiny):
    from igcn_cf_tpu_torch.core.prng import KeySeq

    model = get_model(NGCF_CFG, port_tiny, device="cpu")
    drop = model.draw_drop(KeySeq(1), torch.Generator().manual_seed(1))
    n = port_tiny.n_users + port_tiny.n_items
    assert drop.edge.keep_u.shape == (port_tiny.n_users,)
    assert drop.edge.keep_i.shape == (port_tiny.n_items,)
    assert [tuple(f.shape) for f in drop.feat] == [(n, 16), (n, 8)]
    assert drop.edge.seed_b != drop.edge.seed_bt
    assert get_model(dict(NGCF_CFG, dropout=0.0), port_tiny, device="cpu").draw_drop(
        KeySeq(1), torch.Generator()) is None


# -- trainer steps ---------------------------------------------------------------


def _trainers(jds, pds, model_cfg, trainer_cfg=TRAINER_CFG):
    jm = jax_get_model(dict(model_cfg), jds)
    jt = jax_get_trainer(dict(trainer_cfg), jds, jm)
    pm = get_model(dict(model_cfg), pds, device="cpu")
    pt = get_trainer(dict(trainer_cfg), pds, pm)
    copy_params_(pt.params, jt.params)
    return jt, pt


def _jax_step(jt, key):
    """The JAX BPRTrainer step's batch (bpr.py:50-53, :97-102) and its
    loss and gradients."""
    k_batch, k_drop = jax.random.split(key)
    users, pos, negs = jt.sampler.sample(k_batch, jt.batch_size)
    batch = tuple(_t(x).long() for x in (users, pos, negs[:, 0]))
    jloss, jgrads = jax.value_and_grad(jt._loss)(
        jt.params, jt.buffers, jt._samplers(), k_batch, k_drop)
    return batch, k_drop, float(jloss), jgrads


@pytest.mark.parametrize("model_cfg", [
    NGCF_CFG, dict(LGCN_CFG, prop_cache=True), dict(LGCN_CFG, prop_cache=False)],
    ids=["ngcf", "lightgcn-cache", "lightgcn-recompute"])
def test_bpr_trainer_steps_match_jax(tiny_ds, port_tiny, model_cfg):
    """Loss and gradients of one step, then three Adam steps, on the same
    params, batches and drops in both packages."""
    jt, pt = _trainers(tiny_ds, port_tiny, model_cfg)
    if model_cfg["name"] == "LightGCN":
        assert pt.model.pcache is jt.model.pcache is model_cfg["prop_cache"]
    lr = TRAINER_CFG["lr"]
    for step in range(3):
        batch, k_drop, jloss, jgrads = _jax_step(jt, jax.random.PRNGKey(60 + step))
        drop = _ngcf_drop(jt.model, k_drop) if model_cfg["name"] == "NGCF" else None
        loss = pt.loss(pt.params, batch, drop)
        grads = torch.autograd.grad(loss, list(pt.flat_params.values()))
        assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
        _assert_grads_close(dict(zip(pt.flat_params, grads)),
                            flatten_tree(jgrads))
        updates, jt.opt_state = jt.opt.update(jgrads, jt.opt_state, jt.params)
        jt.params = optax.apply_updates(jt.params, updates)
        got = pt.train_step(batch, drop)
        assert abs(float(got) - jloss) <= LOSS_RTOL * abs(jloss)
        want = flatten_tree(jt.params)
        for name, value in pt.flat_params.items():
            # Adam moves each entry by ~lr where |g| >> eps; a gradient
            # within tolerance can still flip a near-zero entry's step
            np.testing.assert_allclose(value.detach().numpy(), _np(want[name]),
                                       atol=2 * lr, err_msg=name)


def test_ngcf_trainer_epoch_and_launch_free_cpu(port_tiny):
    """A CPU epoch runs on the plain versions only: no kernel is counted."""
    from igcn_cf_tpu_torch.kernels import _build

    model = get_model(NGCF_CFG, port_tiny, device="cpu")
    trainer = get_trainer(dict(TRAINER_CFG, batch_size=256), port_tiny, model)
    before = {k: v.detach().clone() for k, v in trainer.flat_params.items()}
    _build.reset_launches()
    loss = trainer.train_one_epoch()
    assert np.isfinite(loss) and not any(_build.LAUNCHES.values())
    assert trainer.step_losses.shape == (trainer.steps_per_epoch(),)
    for name, value in trainer.flat_params.items():
        assert not torch.equal(before[name], value), name


@pytest.mark.parametrize("model_cfg", [NGCF_CFG, LGCN_CFG], ids=["ngcf", "lightgcn"])
def test_trainer_eval_matches_jax(tiny_ds, port_tiny, model_cfg):
    jt, pt = _trainers(tiny_ds, port_tiny, model_cfg)
    for split in ("val", "test"):
        _, want = jt.eval(split)
        _, got = pt.eval(split)
        for name in want:
            assert got[name][10] == pytest.approx(want[name][10], abs=1e-6)


def test_lightgcn_rebuild_drops_the_cache(port_tiny):
    model = get_model(dict(LGCN_CFG, prop_cache=True), port_tiny, device="cpu")
    assert "pcache" in model.init_buffers()
    buffers = model.rebuild_for(port_tiny)
    assert not model.pcache and "pcache" not in buffers and "bip" in buffers


# -- nested checkpoints across the packages ---------------------------------------


def test_jax_ngcf_checkpoint_loads_in_the_port(tiny_ds, port_tiny, tmp_path):
    """A JAX NGCF checkpoint (nested params: layer lists of {"w", "b"})
    loads in the port, leaf for leaf, and gives JAX's representation."""
    jm, jparams, pm, _ = _ngcf_models(tiny_ds, port_tiny)
    path = str(tmp_path / "ngcf.pkl")
    jm.save(path, jparams)
    params, extra = load_jax_checkpoint(path, "cpu")
    assert extra == {} and isinstance(params["gc_layers"], list)
    want = flatten_tree(jparams)
    got = flatten_tree(pm.load(path))
    assert got.keys() == want.keys()  # jax pickles dicts with sorted keys
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), _np(want[name]))
    np.testing.assert_allclose(
        pm.rep(pm.load(path), pm.init_buffers()).numpy(),
        np.asarray(jm.rep(jparams, jm.init_buffers(), train=False, key=None)),
        rtol=2e-3, atol=1e-5)


def test_port_ngcf_best_checkpoint_loads_in_jax(tiny_ds, port_tiny, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = get_model(NGCF_CFG, port_tiny, device="cpu")
    trainer = get_trainer(dict(TRAINER_CFG, lr=1e-2, batch_size=256),
                          port_tiny, model)
    best = trainer.train(verbose=False)
    assert os.path.exists(trainer.save_path) and f"{best * 100:.3f}" in trainer.save_path
    jm = jax_get_model(dict(NGCF_CFG), tiny_ds)
    jparams = jm.load(trainer.save_path)
    assert isinstance(jparams["bi_layers"], list)
    for name, value in flatten_tree(jparams).items():
        np.testing.assert_array_equal(_np(value),
                                      trainer.flat_params[name].detach().numpy())
    want = jm.rep(jparams, jm.init_buffers(), train=False, key=None)
    got = model.rep(trainer.params, trainer.buffers, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=1e-5)


def test_ngcf_state_and_adam_round_trip(port_tiny, tmp_path):
    """save_state/load_state and Adam's optax form keep the nested tree:
    a resumed trainer takes the same next step."""
    model = get_model(NGCF_CFG, port_tiny, device="cpu")
    trainer = get_trainer(dict(TRAINER_CFG), port_tiny, model)
    for _ in range(2):
        trainer.train_step(*trainer.sample_step())
    state = adam_state_to_jax(trainer.opt, trainer.params)
    assert int(state["count"]) == 2 and isinstance(state["mu"]["gc_layers"], list)
    fresh = torch.optim.Adam(list(trainer.flat_params.values()), lr=1e-3)
    adam_state_from_jax(optax.ScaleByAdamState(**state), trainer.params, fresh)
    for p in trainer.flat_params.values():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(fresh.state[p][k], trainer.opt.state[p][k])
    path = trainer.save_state(str(tmp_path / "state.pkl"))
    model2 = get_model(NGCF_CFG, port_tiny, device="cpu")
    trainer2 = get_trainer(dict(TRAINER_CFG, seed=5), port_tiny, model2)
    trainer2.load_state(path)
    a = trainer.train_step(*trainer.sample_step())
    b = trainer2.train_step(*trainer2.sample_step())
    assert float(a) == float(b)
    for name, value in trainer.flat_params.items():
        assert torch.equal(value, trainer2.flat_params[name]), name
