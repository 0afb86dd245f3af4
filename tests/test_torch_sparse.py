"""The port's sparse COO path against the JAX package: ``sym_norm_adjacency``
exactly, ``spmm``/``spmm_transpose`` and their gradients, ``propagate_mean``,
``edge_dropout_vals`` on a given keep mask, and ``choose_backend``'s
routing to 'sparse'."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import igcn_cf_tpu.kernels.sparse as jsp
from igcn_cf_tpu.graph import build as jax_build
from igcn_cf_tpu_torch.graph import build
from igcn_cf_tpu_torch.kernels import dense_graph, sparse
from igcn_cf_tpu_torch.models.base import get_model
from torch_threads import one_thread  # noqa: F401

F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _graphs(ds):
    coo = build.sym_norm_adjacency(ds.train_array, ds.n_users, ds.n_items)
    jcoo = jax_build.sym_norm_adjacency(ds.train_array, ds.n_users, ds.n_items)
    return coo, jcoo, sparse.SparseGraph.from_coo(coo, device="cpu"), \
        jsp.SparseGraph.from_coo(jcoo)


def test_sym_norm_adjacency_identical_to_jax(tiny_ds):
    coo, jcoo, _, _ = _graphs(tiny_ds)
    for f in ("rows", "cols", "vals"):
        got, want = getattr(coo, f), getattr(jcoo, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert coo.shape == jcoo.shape
    np.testing.assert_array_equal(coo.to_dense(), jcoo.to_dense())


def test_from_coo_pads_like_jax(tiny_ds):
    _, _, g, jg = _graphs(tiny_ds)
    assert g.nnz == jg.nnz and g.nnz % 8 == 0
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(jg, f)))
    assert (g.n_rows, g.n_cols) == (jg.n_rows, jg.n_cols)
    assert g.row_ptr[-1] == g.col_ptr[-1] == g.nnz


@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_and_grad_match_jax(tiny_ds, rng, transpose):
    _, _, g, jg = _graphs(tiny_ds)
    x = rng.normal(size=(g.n_rows, 16)).astype(np.float32)
    jfn = jsp.spmm_transpose if transpose else jsp.spmm
    fn = sparse.spmm_transpose if transpose else sparse.spmm
    want, vjp = jax.vjp(lambda v: jfn(jg, v), jnp.asarray(x))
    ct = rng.normal(size=want.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(ct))
    xt = torch.as_tensor(x).requires_grad_()
    got = fn(g, xt)
    (dx,) = torch.autograd.grad(got, xt, torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **F32_TOL)


def test_spmm_on_a_rectangular_graph_with_empty_rows(rng):
    """A (5 x 7) COO with empty rows and columns against its dense product."""
    rows = np.array([0, 0, 2, 2, 2, 4], np.int32)
    cols = np.array([1, 6, 0, 3, 6, 2], np.int32)
    vals = rng.normal(size=6).astype(np.float32)
    coo = build.COO(rows, cols, vals, (5, 7))
    g = sparse.SparseGraph.from_coo(coo, device="cpu")
    x = torch.as_tensor(rng.normal(size=(7, 3)).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32))
    dense = torch.as_tensor(coo.to_dense())
    torch.testing.assert_close(sparse.spmm(g, x), dense @ x)
    torch.testing.assert_close(sparse.spmm_transpose(g, y), dense.T @ y)


def test_propagate_mean_and_grad_match_jax(tiny_ds, rng):
    _, _, g, jg = _graphs(tiny_ds)
    x = rng.normal(size=(g.n_rows, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jsp.propagate_mean(jg, v, 3), jnp.asarray(x))
    ct = rng.normal(size=want.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(ct))
    xt = torch.as_tensor(x).requires_grad_()
    got = sparse.propagate_mean(g, xt, 3)
    (dx,) = torch.autograd.grad(got, xt, torch.as_tensor(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **F32_TOL)


def test_propagate_mean_is_deterministic(tiny_ds, rng):
    _, _, g, _ = _graphs(tiny_ds)
    x = torch.as_tensor(rng.normal(size=(g.n_rows, 8)).astype(np.float32))
    outs = []
    for _ in range(2):
        xt = x.clone().requires_grad_()
        y = sparse.propagate_mean(g, xt, 3)
        (dx,) = torch.autograd.grad(y.sum(), xt)
        outs.append((y.detach(), dx))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_edge_dropout_vals_on_a_given_keep_match_jax(tiny_ds):
    """On JAX's own bernoulli draw the values are exactly equal; a drawn
    mask drops about p of the entries."""
    _, _, g, jg = _graphs(tiny_ds)
    key = jax.random.PRNGKey(3)
    want = jsp.edge_dropout_vals(jg, key, 0.3)
    keep = jax.random.bernoulli(key, 0.7, (jg.vals.shape[0],))
    got = sparse.edge_dropout_vals(g, 0.3, keep=torch.as_tensor(np.array(keep)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = sparse.edge_dropout_vals(g, 0.3,
                                     generator=torch.Generator().manual_seed(0))
    live = g.vals != 0
    share = float((drawn[live] == 0).float().mean())
    assert 0.2 < share < 0.4
    torch.testing.assert_close(drawn[drawn != 0], g.vals[drawn != 0] / 0.7)
    assert g.with_vals(drawn).vals is drawn


def test_choose_backend_routes_to_sparse(port_tiny_ds):
    assert dense_graph.choose_backend(60, 80, "sparse", device="cpu") == "sparse"
    assert dense_graph.choose_backend(10**6, 10**6, device="cpu") == "sparse"
    assert dense_graph.choose_backend(60, 80, "dense_lean", device="cpu") == "dense"
    assert dense_graph.choose_backend(60, 80, device="cpu") == "dense"
    with pytest.raises(ValueError):
        dense_graph.choose_backend(60, 80, "coo", device="cpu")
    # IGCN, LightGCN and NGCF construct on 'sparse': COO graphs, no B
    for cfg in ({"name": "IGCN", "embedding_size": 8, "n_layers": 2,
                 "feature_ratio": 1.0},
                {"name": "LightGCN", "embedding_size": 8, "n_layers": 2},
                {"name": "NGCF", "embedding_size": 8, "layer_sizes": [8],
                 "dropout": 0.1}):
        model = get_model(dict(cfg, graph_backend="sparse"), port_tiny_ds,
                          "cpu")
        assert model.backend == "sparse"
        buffers = model.init_buffers()
        assert "bip" not in buffers
        assert isinstance(buffers["norm_adj"], sparse.SparseGraph)


@pytest.fixture(scope="module")
def port_tiny_ds():
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions

    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)
