"""The port's parallel layer (``igcn_cf_tpu_torch/parallel``,
``core/mesh``) against the JAX package's, mirroring tests/test_parallel.py.

The port runs one process a shard, over gloo on the CPU: one spawned world
(``core/mesh.spawn_world``) runs mesh 2x2 on 4 ranks, then mesh 1x2 on 2 of
them, once for the module (the rank functions are in ``torch_mesh_workers``,
which imports no jax); mesh 1x1 runs in a one-rank world in this process. The JAX functions run on the
conftest's 8-device CPU mesh cut to the same shape, on the same numpy
inputs. The JAX steps' gradients are read out of an update with
``optax.sgd(2**20)`` in place of ``optax.adam`` (params_before -
params_after = 2**20 * grad, exact to f32 rounding of the update).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_mesh_workers as W
from igcn_cf_tpu.core.mesh import TABLE_AXIS
from igcn_cf_tpu.core.mesh import make_mesh as jax_make_mesh
from igcn_cf_tpu.graph.build import COO as JaxCOO
from igcn_cf_tpu.graph.build import sym_norm_adjacency as jax_sym_norm
from igcn_cf_tpu.parallel import sharded as jsh
from igcn_cf_tpu.parallel import steps as jsteps

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
D, N_LAYERS, BATCH, L2, AUX = 8, 2, 64, 0.1, 0.01
SGD_LR = 2.0 ** 20
# sparse and cache engines: f32 sums in other orders; the dense step's
# products round their operands to bf16
GRAD_REL = {"sparse": 1e-5, "cache": 1e-5, "dense": 1e-3}


def _ds_spec(ds):
    return {"name": ds.name, "n_users": ds.n_users, "n_items": ds.n_items,
            "train": ds.train, "val": ds.val, "test": ds.test}


def _jax_mesh(shape):
    data, table = shape
    return jax_make_mesh(jax.devices()[: data * table], data=data, table=table)


def _rand_coo(rng, n_rows, n_cols, nnz):
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    return JaxCOO(rows, cols, vals, (n_rows, n_cols)).sort_by_row()


def _rec_dataset(tiny_ds):
    """tiny_ds with user 0's train list grown to all but 6 items, so with
    items 0-9 banned user 0 has fewer allowed items than k=10."""
    from igcn_cf_tpu.data.dataset import Interactions

    train = [list(x) for x in tiny_ds.train]
    val = [list(x) for x in tiny_ds.val]
    test = [list(x) for x in tiny_ds.test]
    keep = set(test[0]) | set(val[0]) | {70, 71, 72, 73, 74, 75}
    train[0] = [i for i in range(tiny_ds.n_items) if i not in keep]
    return Interactions("rec", tiny_ds.n_users, tiny_ds.n_items, train, val,
                        test)


def _jax_grads(build, batch, mesh):
    """(loss, {name: grad}) of one JAX sharded step, SGD in place of Adam."""
    orig = optax.adam
    optax.adam = lambda lr: optax.sgd(SGD_LR)
    try:
        tr = build()
    finally:
        optax.adam = orig
    before = {k: np.asarray(v).copy() for k, v in tr.params.items()}
    params, _, loss = tr.step(tr.params, tr.opt_state, tr.buffers,
                              tuple(jnp.asarray(b) for b in batch),
                              jax.random.PRNGKey(0))
    return float(loss), {k: (before[k] - np.asarray(params[k])) / SGD_LR
                         for k in before}, before


@pytest.fixture(scope="module")
def jref(tiny_ds):
    """The JAX package's results and the shared numpy inputs."""
    rng = np.random.default_rng(0)
    out = {}
    mesh2 = _jax_mesh((1, 2))
    # sharded SpMM and propagation, with gradients
    coo = _rand_coo(rng, 96, 96, 600)
    x = rng.normal(size=(96, 16)).astype(np.float32)
    ct = rng.normal(size=(96, 16)).astype(np.float32)
    adj = jax_sym_norm(tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    n = tiny_ds.n_users + tiny_ds.n_items
    x0 = rng.normal(size=(n, 8)).astype(np.float32)
    ct0 = rng.normal(size=(n, 8)).astype(np.float32)
    out["inputs"] = dict(coo=(coo.rows, coo.cols, coo.vals, coo.shape), x=x,
                         ct=ct, x0=x0, ct0=ct0)
    spec_t = P(TABLE_AXIS, None)

    def sharded(sh, x_full, ct_full, body):
        xp = jnp.asarray(jsh.pad_rows(x_full, sh.n_rows))
        cp = jnp.asarray(jsh.pad_rows(ct_full, sh.n_rows))
        f = jax.shard_map(body, mesh=mesh2, in_specs=(spec_t,) * 4,
                          out_specs=spec_t, check_vma=False)
        y = jax.jit(f)(sh.rows_local, sh.cols, sh.vals, xp)
        g = jax.jit(jax.grad(lambda xx: jnp.sum(
            f(sh.rows_local, sh.cols, sh.vals, xx) * cp)))(xp)
        return np.asarray(y), np.asarray(g)

    sh = jsh.ShardedGraph.from_coo(coo, 2)
    out["spmm"] = sharded(sh, x, ct, lambda r, c, v, xs: jsh.spmm_local(
        r, c, v, sh.rows_per_shard, xs))
    ash = jsh.ShardedGraph.from_coo(adj, 2)
    out["prop"] = sharded(ash, x0, ct0, lambda r, c, v, xs: jsh.propagate_mean_local(
        (r, c, v), ash.rows_per_shard, xs, N_LAYERS))

    # top-k
    from igcn_cf_tpu.parallel.topk import sharded_topk

    users = rng.normal(size=(16, 8)).astype(np.float32)
    items = rng.normal(size=(64, 8)).astype(np.float32)
    out["inputs"]["topk"] = (users, items, 10)
    out["topk"] = np.asarray(jax.shard_map(
        lambda u, i: sharded_topk(u, i, 10)[1], mesh=mesh2,
        in_specs=(P(), spec_t), out_specs=P(), check_vma=False)(
            jnp.asarray(users), jnp.asarray(items)))

    # the distributed masked top-k, with a row of few allowed items
    from igcn_cf_tpu.parallel.eval import sharded_recommend

    rds = _rec_dataset(tiny_ds)
    users_rep = rng.normal(size=(rds.n_users, 16)).astype(np.float32)
    items_rep = rng.normal(size=(rds.n_items, 16)).astype(np.float32)
    banned = np.arange(10)
    out["inputs"]["rec"] = dict(ds=_ds_spec(rds), users_rep=users_rep,
                                items_rep=items_rep, banned=banned, k=10)
    out["recommend"] = {
        name: np.asarray(sharded_recommend(
            _jax_mesh(shape), jnp.asarray(users_rep), items_rep, rds, "test",
            [10], banned_items=banned, test_batch_size=32))
        for name, shape in MESHES.items()}

    # the sharded cache's slabs (T = 2)
    from igcn_cf_tpu.kernels.dense_graph import BipartiteDense as JaxBip
    from igcn_cf_tpu.parallel.pcache import (
        build_sharded_pcache,
        build_sharded_pcache_host,
    )

    rps = ash.rows_per_shard
    bip = JaxBip.build(tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    for kind, arr in (
        ("device", build_sharded_pcache(bip, mesh2, N_LAYERS, rps)),
        ("host", build_sharded_pcache_host(
            tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items, mesh2,
            N_LAYERS, rps, block=64)),
    ):
        a = np.asarray(arr, dtype=np.float32)
        out[f"slab_{kind}"] = a.reshape(a.shape[0], a.shape[1], -1)
    out["rps"] = rps

    # one step of each engine on the same params and batch, at each mesh
    from igcn_cf_tpu.parallel.dense_steps import build_inmo_dense_sharded_train

    batch = [np.asarray(b) for b in jsteps.make_batch(
        mesh2, np.random.default_rng(3), tiny_ds, BATCH)]
    out["inputs"]["batch"] = batch
    kw = dict(embedding_size=D, n_layers=N_LAYERS, dropout=0.0, lr=1e-2,
              l2_reg=L2, aux_reg=AUX, batch_size=BATCH)
    for name, shape in MESHES.items():
        jm = _jax_mesh(shape)
        for engine, cache in (("sparse", False), ("cache", "host")):
            loss, grads, before = _jax_grads(
                lambda: jsteps.build_inmo_sharded_train(
                    tiny_ds, jm, seed=7, prop_cache=cache, **kw), batch, jm)
            out[(name, engine)] = (loss, grads)
            out["params"] = before
        loss, grads, before = _jax_grads(
            lambda: build_inmo_dense_sharded_train(tiny_ds, jm, tile=8, **kw),
            batch, jm)
        flat = {k: v.reshape(-1, v.shape[-1]) if v.ndim == 3 else v
                for k, v in grads.items()}
        out[(name, "dense")] = (loss, flat)
        out["dense_params"] = {k: v.reshape(-1, v.shape[-1]) if v.ndim == 3
                               else v for k, v in before.items()}
        out["dense_params_jax"] = before
    return out


@pytest.fixture(scope="module")
def port(tiny_ds, jref, tmp_path_factory):
    """The port's results: {mesh name: [rank results]}."""
    spec = dict(jref["inputs"], ds=_ds_spec(tiny_ds), n_layers=N_LAYERS,
                hparams=dict(d=D, l2_reg=L2, aux_reg=AUX),
                params=jref["params"],
                dense_params={k: v[: {"emb_u": tiny_ds.n_users,
                                      "emb_i": tiny_ds.n_items}.get(k, len(v))]
                              for k, v in jref["dense_params"].items()},
                dense_params_jax=jref["dense_params_jax"],
                drop=(123456789, 0.3))
    out = W.spawn_two_meshes(W.parallel_cases, spec,
                             str(tmp_path_factory.mktemp("rdv")))
    out["1x1"] = [W.run_single(W.parallel_cases, dict(spec, mesh=(1, 1)))]
    return out


def _row0(results):
    """The results of the ranks of data row 0, in table order."""
    return [r for r in results if r["d"] == 0]


def _cat(results, key, i=None):
    parts = [r[key] if i is None else r[key][i] for r in _row0(results)]
    return np.concatenate(parts)


# -- layout, SpMM, propagation ------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_sharded_graph_layout_equals_jax(tiny_ds, n_shards):
    """Exactly the JAX partition: rows_local, cols, vals and the sizes."""
    from igcn_cf_tpu_torch.graph.build import sym_norm_adjacency
    from igcn_cf_tpu_torch.parallel.sharded import ShardedGraph

    args = (tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items)
    want = jsh.ShardedGraph.from_coo(jax_sym_norm(*args), n_shards)
    got = ShardedGraph.from_coo(sym_norm_adjacency(*args), n_shards)
    for name in ("rows_local", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    for name in ("n_rows", "n_cols", "rows_per_shard", "n_shards"):
        assert getattr(got, name) == getattr(want, name)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("what", ["spmm", "prop"])
def test_shard_local_product_and_gradient_match_jax(port, jref, mesh, what):
    """spmm_local and propagate_mean_local, forward and the gradient of
    sum(Y * ct) in X (the all-gather's reduce-scatter), against JAX's
    shard_map programs: within 1e-5 (f32 sums in another order)."""
    y, g = _cat(port[mesh], what, 0), _cat(port[mesh], what, 1)
    want_y, want_g = jref[what]
    np.testing.assert_allclose(y, want_y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, want_g, rtol=1e-5, atol=1e-6)


def test_make_batch_draws_jax_batches(tiny_ds):
    """The host sampler draws the JAX package's batch from the same numpy
    seed: positive-excluding negatives and the aux stream in template
    space."""
    from igcn_cf_tpu_torch.core.mesh import Mesh
    from igcn_cf_tpu_torch.parallel.steps import make_batch

    mesh = Mesh(1, 1, 0, 0, torch.device("cpu"), "gloo", None, None)
    ds = W.dataset(_ds_spec(tiny_ds))
    got = make_batch(mesh, np.random.default_rng(3), ds, BATCH)
    want = jsteps.make_batch(_jax_mesh((1, 2)), np.random.default_rng(3),
                             tiny_ds, BATCH)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for u, n in zip(got[0].tolist(), got[2].tolist()):
        assert n not in tiny_ds.train[u]


# -- retrieval ---------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_topk_ids_equal_jax(port, jref, mesh):
    for r in port[mesh]:
        np.testing.assert_array_equal(r["topk"], jref["topk"])


@pytest.mark.parametrize("case", ["ties", "signed_zeros"])
def test_local_topk_and_merge_match_jax(case):
    """Each table rank's top-k and the merge of the gathered lists against
    JAX ``parallel/topk``'s ``lax.top_k``, values and ids bit for bit, on
    scores with ties across the ranks' blocks and on rows of +0.0 and -0.0
    (``lax.top_k`` ranks +0.0 first)."""
    from igcn_cf_tpu.parallel import topk as jtopk
    from igcn_cf_tpu_torch.parallel import topk as ptopk

    rng = np.random.default_rng(5)
    t_ranks, n, k = 2, 48, 10
    x = np.round(rng.normal(size=(8, t_ranks * n)) * 4) / 4
    if case == "signed_zeros":
        zeros = np.where(rng.random(x.shape) < 0.5, -0.0, 0.0)
        x = np.where(rng.random(x.shape) < 0.05, x, zeros)
    x = x.astype(np.float32)

    def same(got, want):
        want = [np.asarray(w) for w in want]
        np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                      want[0].view(np.int32))
        np.testing.assert_array_equal(got[1].numpy(), want[1])

    jlists, plists = [], []
    for t in range(t_ranks):
        block = x[:, t * n:(t + 1) * n]
        jlists.append(jtopk.local_topk_with_global_ids(jnp.asarray(block),
                                                       t * n, k))
        plists.append(ptopk.local_topk_with_global_ids(torch.as_tensor(block),
                                                       t * n, k))
        same(plists[-1], jlists[-1])
    same(ptopk.merge_topk(*(torch.cat(z, dim=1) for z in zip(*plists)), k),
         jtopk.merge_topk(*(jnp.concatenate(z, axis=1) for z in zip(*jlists)),
                          k))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_recommend_equals_jax_and_one_device(port, jref, mesh):
    """Per-shard K5 (its plain version here) + the merge: the same ids as
    JAX's sharded evaluator and as the port's single-device retrieval, with
    banned items and a user with fewer allowed items than k (its NEG items
    listed in id order), on every rank."""
    from igcn_cf_tpu_torch.evaluation.evaluate import packed_exclusion
    from igcn_cf_tpu_torch.kernels.bitpack import pad_to
    from igcn_cf_tpu_torch.kernels.retrieval import LI, NEG, fused_topk_ids

    rec = jref["inputs"]["rec"]
    rds = W.dataset(rec["ds"])
    nip = pad_to(rds.n_items, LI)
    items_t = torch.zeros((16, nip))
    items_t[:, : rds.n_items] = torch.as_tensor(rec["items_rep"]).T
    banned = torch.zeros((1, nip))
    banned[0, rds.n_items:] = NEG
    banned[0, rec["banned"]] = NEG
    one = fused_topk_ids(torch.as_tensor(rec["users_rep"]), items_t,
                         packed_exclusion(rds, "test", nip, "cpu"), banned,
                         k=10).numpy()
    allowed0 = rds.n_items - 10 - len(set(rds.train[0]) | set(rds.val[0]))
    assert allowed0 < 10  # the short row is there
    for r in port[mesh]:
        np.testing.assert_array_equal(r["recommend"], jref["recommend"][mesh])
        np.testing.assert_array_equal(r["recommend"], one)
    assert port["1x1"][0]["recommend"].tolist() == one.tolist()


# -- the sharded cache ----------------------------------------------------------


def _within_bf16_ulp(got, want):
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7),
                   0.0)
    assert np.all(np.abs(got - want) <= ulp), float(np.abs(got - want).max())


@pytest.mark.parametrize("kind", ["device", "host"])
def test_slab_builds_match_jax(port, jref, kind):
    """Each rank's (n, width) slab equals the JAX shard's slab reshaped to
    2-D, within one bf16 ulp, overlap columns [rps, width) included."""
    for r in port["1x2"]:
        got = r[f"slab_{kind}"]
        want = jref[f"slab_{kind}"][r["t"]]
        assert got.shape == want.shape
        _within_bf16_ulp(got, want)


def test_slab_overlap_columns_are_the_next_shards(port, jref, tiny_ds):
    """A slab's columns past rps hold the next shard's real P columns (the
    window of the global P), zero only past n: X0 must be zero-padded."""
    from igcn_cf_tpu_torch.kernels.pcache import prop_cache_oracle

    n = tiny_ds.n_users + tiny_ds.n_items
    rps = jref["rps"]
    oracle = prop_cache_oracle(tiny_ds.train_array, tiny_ds.n_users,
                               tiny_ds.n_items, N_LAYERS)
    for r in port["1x2"]:
        slab = r["slab_host"]
        width = slab.shape[1]
        want = np.zeros((n, 2 * rps + width), np.float32)
        want[:, :n] = oracle
        t = r["t"]
        np.testing.assert_allclose(slab, want[:, t * rps: t * rps + width],
                                   atol=8e-3)
        assert width > rps and np.abs(slab[:, rps:]).sum() > 0 or t == 1


def test_cached_prop_takes_a_narrow_slab():
    """K3/K4's wrapper checks take a slab with fewer columns than rows
    (X0 one row a column) and agree with the plain products."""
    from igcn_cf_tpu_torch.kernels.pcache import cached_prop

    g = torch.Generator().manual_seed(0)
    p = torch.rand((300, 128), generator=g).to(torch.bfloat16)
    x0 = torch.randn((100, 8), generator=g, requires_grad=True)
    rows = torch.randint(0, 300, (50,), generator=g)
    y = cached_prop(p, rows, x0)
    y.sum().backward()
    pf = p[rows].float()[:, :100]
    np.testing.assert_allclose(y.detach().numpy(),
                               (pf @ x0.detach().to(torch.bfloat16).float()).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x0.grad.numpy(), (pf.T @ torch.ones(50, 8)).numpy(),
                               rtol=1e-5, atol=1e-5)


# -- steps: loss and gradients ---------------------------------------------------


def _port_step(port, mesh, engine, n_users, n_items, n_templates):
    """(loss, {name: whole gradient}) from the ranks of data row 0."""
    ranks = _row0(port[mesh])
    loss = ranks[0][engine][0]
    for r in port[mesh]:  # every rank holds the same pmean'd loss
        assert r[engine][0] == pytest.approx(loss, rel=1e-6)
    grads = {}
    for name in ranks[0][engine][1]:
        g = np.concatenate([r[engine][1][name] for r in ranks]) \
            if name in ("embedding", "emb_u", "emb_i") else ranks[0][engine][1][name]
        rows = {"embedding": n_templates, "emb_u": n_users,
                "emb_i": n_items}.get(name)
        grads[name] = g[:rows] if rows else g
    return loss, grads


def _assert_grads(got, want, rel, what):
    for name, w in want.items():
        g = got[name][: len(w)] if w.ndim else got[name]
        w = w[: len(g)]
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= rel, (what, name, err)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("engine", ["sparse", "cache", "dense"])
def test_step_gradients_equal_jax(port, jref, tiny_ds, mesh, engine):
    """One step's loss and gradients (before any update) against the JAX
    sharded step's on the same mesh shape, params and batch: sparse and
    cache within 1e-5 of each gradient's largest magnitude, dense within
    1e-3 (bf16 operands). Catches a collective whose backward sums the
    replicated loss's cotangent over the table ranks."""
    nt = tiny_ds.n_users + tiny_ds.n_items + 2
    loss, grads = _port_step(port, mesh, engine, tiny_ds.n_users,
                             tiny_ds.n_items, nt)
    want_loss, want = jref[(mesh, engine)]
    assert loss == pytest.approx(want_loss, rel=1e-5)
    if engine != "dense":
        want = {"embedding": want["embedding"][:nt], "w": want["w"]}
    else:
        want = {"emb_u": want["emb_u"][: tiny_ds.n_users],
                "emb_i": want["emb_i"][: tiny_ds.n_items],
                "toks": want["toks"], "w": want["w"]}
    _assert_grads(grads, want, GRAD_REL[engine], (mesh, engine))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("engine", ["sparse", "cache", "dense"])
def test_step_gradients_equal_the_ports_1x1(port, tiny_ds, mesh, engine):
    nt = tiny_ds.n_users + tiny_ds.n_items + 2
    args = (engine, tiny_ds.n_users, tiny_ds.n_items, nt)
    loss, grads = _port_step(port, mesh, *args)
    loss1, grads1 = _port_step(port, "1x1", *args)
    assert loss == pytest.approx(loss1, rel=1e-6)
    _assert_grads(grads, grads1, GRAD_REL[engine], (mesh, engine))


@pytest.mark.parametrize("mesh", MESHES)
def test_cache_step_matches_recompute(port, tiny_ds, mesh):
    """The cache engine (bf16 P and X0) against the sparse recompute engine
    on the same params and batch: the loss within 1e-3 relative, the
    gradients within 2e-2 of their largest magnitude."""
    nt = tiny_ds.n_users + tiny_ds.n_items + 2
    n = (tiny_ds.n_users, tiny_ds.n_items, nt)
    loss_c, g_c = _port_step(port, mesh, "cache", *n)
    loss_r, g_r = _port_step(port, mesh, "sparse", *n)
    assert loss_c == pytest.approx(loss_r, rel=1e-3)
    _assert_grads(g_c, g_r, 2e-2, mesh)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", ["params", "dense_params_jax"])
def test_convert_jax_sharded_params_round_trip(port, jref, mesh, kind):
    """``convert.sharded_params_from_jax`` hands each rank its blocks of the
    JAX steps' global params (the (n_templates_pad, d) table, the (T,
    rows, d) stacked emb_u/emb_i) and ``sharded_params_to_jax`` gathers
    them back: the same arrays, bit for bit, on every rank."""
    for r in port[mesh]:
        got = r["convert"][kind]
        assert set(got) == set(jref[kind])
        for name, want in jref[kind].items():
            np.testing.assert_array_equal(got[name], want)


# -- dropout ---------------------------------------------------------------------


def test_edge_masks_differ_across_shards(port):
    """The same step seed gives table ranks unrelated keeps; data ranks of
    one table column share theirs."""
    ranks = port["2x2"]
    by_t = {}
    for r in ranks:
        by_t.setdefault(r["t"], []).append(r["edge_keep"])
    assert not np.array_equal(by_t[0][0], by_t[1][0])
    for keeps in by_t.values():
        np.testing.assert_array_equal(keeps[0], keeps[1])
    assert 0.6 < by_t[0][0].mean() < 0.8  # kept with probability 0.7


def test_masked_product_forward_and_backward_see_one_mask(port):
    """Each shard's K6m forward and K7m backward (plain versions here) equal
    the dense products of B masked by keep_mask_dense of the shard's
    seed; the shards' seeds differ, and the mask drops about p of B."""
    seeds = set()
    for r in _row0(port["1x2"]):
        m = r["masked"]
        seeds.add(m["seed"])
        assert m["fwd_err"] < 1e-5 and m["bwd_err"] < 1e-5
        assert 0.6 < m["kept"] / m["edges"] < 0.8
    assert len(seeds) == 2


@pytest.mark.parametrize("t", [0, 1])
def test_masked_product_bit_equal_to_jax(tiny_ds, t):
    """A shard's packed words and its masked product under the u32 seed
    that JAX's shard key yields equal JAX's ``bb_matmul_dropped`` bit for
    bit (integer-valued X, so every sum is exact in any order)."""
    from igcn_cf_tpu.kernels.bitpack import _seed_from_key
    from igcn_cf_tpu.kernels.bitpack import bb_matmul_dropped as jax_dropped
    from igcn_cf_tpu.kernels.bitpack import pack_bits as jax_pack
    from igcn_cf_tpu_torch.kernels.bitpack import mm_bwd_masked, mm_fwd_masked
    from igcn_cf_tpu_torch.parallel.dense_steps import shard_words

    nu, ni, tile, p = tiny_ds.n_users, tiny_ds.n_items, 8, 0.3
    nup, nip = -(-nu // 16) * 16, -(-ni // 16) * 16
    b = np.zeros((4096, 4096), np.uint8)
    b[tiny_ds.train_array[:, 0], tiny_ds.train_array[:, 1]] = 1
    urows = nup // 2
    jax_words = jax_pack(b[:nup, :4096]).reshape(2, urows, -1)[t]
    arr = tiny_ds.train_array.astype(np.int64)
    uniq = np.unique(arr[:, 0] * ni + arr[:, 1])
    words = shard_words(uniq // ni, uniq % ni, t, urows, 4096, "cpu")
    np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                  np.asarray(jax_words).view(np.uint32))
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), t), 3)[0]
    seed = int(_seed_from_key(key))
    rng = np.random.default_rng(t)
    x = rng.integers(-4, 5, (4096, 8)).astype(np.float32)
    ct = rng.integers(-4, 5, (urows, 8)).astype(np.float32)
    want = np.asarray(jax_dropped(jnp.asarray(jax_words), jnp.asarray(x), key,
                                  p))
    got = mm_fwd_masked(words, torch.as_tensor(x), seed, p).numpy()
    np.testing.assert_array_equal(got, want)
    want_b = np.asarray(jax.vjp(lambda xx: jax_dropped(
        jnp.asarray(jax_words), xx, key, p), jnp.asarray(x))[1](
            jnp.asarray(ct))[0])
    got_b = mm_bwd_masked(words, torch.as_tensor(ct), seed, p).numpy()
    np.testing.assert_array_equal(got_b, want_b)
