"""The port's bit-packed operand and dense graph engine against the JAX
package: packing and device builds bit-exact, the transposed pair (plain
versions of K1/K2) and the INMO/propagation layers within f32-sum
tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import igcn_cf_tpu.kernels.bitpack as jbp
import igcn_cf_tpu.kernels.dense_graph as jdg
from igcn_cf_tpu_torch.kernels import _build, bitpack, dense_graph
from igcn_cf_tpu_torch.kernels.bitpack import TK, TM
from torch_threads import one_thread  # noqa: F401

# bf16 operands, f32 sums in another order: only rounding of the sums differs
PAIR_TOL = dict(rtol=1e-5, atol=1e-4)


def _u32(t):
    return (t.numpy() if isinstance(t, torch.Tensor) else t).view(np.uint32)


def _pairs(rng, n_rows, n_cols, nnz, dups=True):
    arr = np.stack([rng.integers(0, n_rows, nnz), rng.integers(0, n_cols, nnz)], 1)
    if dups:  # repeated pairs must not carry into neighboring bits
        arr = np.concatenate([arr, arr[: nnz // 5]])
    return arr


def test_layout_constants_match_jax():
    assert (bitpack.TM, bitpack.TKP, bitpack.TK) == (jbp.TM, jbp.TKP, jbp.TK)


@pytest.mark.parametrize("shape,density", [((TM, TK), 0.1), ((3, 2 * TK), 0.5)])
def test_pack_bits_identical_to_jax(rng, shape, density):
    b = (rng.random(shape) < density).astype(np.float32)
    got = bitpack.pack_bits(b)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(_u32(got), jbp.pack_bits(b))
    np.testing.assert_array_equal(
        bitpack.unpack_bits(torch.as_tensor(got)).numpy(), b
    )


@pytest.mark.parametrize("n_rows,n_cols", [(60, 80), (700, 5000)])
def test_pack_interactions_identical_to_jax(rng, n_rows, n_cols):
    arr = _pairs(rng, n_rows, n_cols, 3 * n_rows)
    got, mp, kp = bitpack.pack_interactions(arr, n_rows, n_cols)
    want, wmp, wkp = jbp.pack_interactions(arr, n_rows, n_cols)
    assert (mp, kp) == (wmp, wkp)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        bitpack.unpack_bits(torch.as_tensor(got)).numpy(), jbp.unpack_bits_np(want)
    )


def test_high_bit_words_survive_int32(rng):
    """Columns on plane 31 set the sign bit of the int32 word."""
    cols = np.array([31 * 128 + 5, 4096 + 31 * 128])
    arr = np.stack([np.zeros(2, np.int64), cols], 1)
    got, _, _ = bitpack.pack_interactions(arr, 1, 8192)
    assert got[0, 5] < 0 and _u32(got)[0, 5] == 2**31
    g = dense_graph.BipartiteDense.build(arr, 1, 8192, device="cpu")
    np.testing.assert_array_equal(g.B.numpy(), got)


@pytest.mark.parametrize("n_users,n_items,nnz", [(60, 80, 500), (700, 5000, 9000),
                                                 (5, 3, 0)])
def test_bipartite_build_identical_to_jax(rng, n_users, n_items, nnz):
    arr = _pairs(rng, n_users, n_items, nnz)
    got = dense_graph.BipartiteDense.build(arr, n_users, n_items, device="cpu")
    want = jdg.BipartiteDense.build(arr, n_users, n_items)
    np.testing.assert_array_equal(_u32(got.B), np.asarray(want.B))
    np.testing.assert_array_equal(got.deg_u.numpy(), np.asarray(want.deg_u))
    np.testing.assert_array_equal(got.deg_i.numpy(), np.asarray(want.deg_i))
    host = dense_graph.BipartiteDense.build_host(arr, n_users, n_items)
    jhost = jdg.BipartiteDense.build_host(arr, n_users, n_items)
    np.testing.assert_array_equal(_u32(host.B), np.asarray(jhost.B))
    np.testing.assert_array_equal(host.deg_u.numpy(), np.asarray(jhost.deg_u))
    np.testing.assert_array_equal(host.deg_i.numpy(), np.asarray(jhost.deg_i))
    assert (got.rows_padded, got.cols_padded) == (want.rows_padded, want.cols_padded)


def _pair_inputs(rng, m, k, d, density=0.1):
    b = (rng.random((m, k)) < density).astype(np.float32)
    wp = bitpack.pack_bits(b)
    x1t = rng.normal(size=(d, k)).astype(np.float32)
    x2t = rng.normal(size=(d, m)).astype(np.float32)
    return wp, x1t, x2t


@pytest.mark.parametrize("m,k,d", [(TM, TK, 8), (2 * TM, 2 * TK, 16)])
def test_bbt_pair_plain_matches_jax_xla(rng, m, k, d):
    wp, x1t, x2t = _pair_inputs(rng, m, k, d)
    y1t, y2t = bitpack.bbt_pair(torch.as_tensor(wp), torch.as_tensor(x1t),
                                torch.as_tensor(x2t))
    w1, w2 = jbp._t_xla(jnp.asarray(_u32(wp)), jnp.asarray(x1t),
                        jnp.asarray(x2t), jnp.uint32(0), jnp.uint32(0), 0.0,
                        False)
    assert y1t.shape == (d, m) and y2t.shape == (d, k)
    np.testing.assert_allclose(y1t.numpy(), np.asarray(w1), **PAIR_TOL)
    np.testing.assert_allclose(y2t.numpy(), np.asarray(w2), **PAIR_TOL)


@pytest.mark.parametrize("d", [8, 16])
def test_bbt_pair_plain_matches_pallas_interpret(rng, d):
    wp, x1t, x2t = _pair_inputs(rng, TM, TK, d)
    jwp = jnp.asarray(_u32(wp))
    w1 = jbp._t1_pallas(jwp, jnp.asarray(x1t), jnp.uint32(0), 0.0, False,
                        interpret=True)
    w2 = jbp._t2_pallas(jwp, jnp.asarray(x2t), jnp.uint32(0), 0.0, False,
                        interpret=True)
    y1t = bitpack.t1(torch.as_tensor(wp), torch.as_tensor(x1t))
    y2t = bitpack.t2(torch.as_tensor(wp), torch.as_tensor(x2t))
    np.testing.assert_allclose(y1t.numpy(), np.asarray(w1), **PAIR_TOL)
    np.testing.assert_allclose(y2t.numpy(), np.asarray(w2), **PAIR_TOL)


def test_bbt_pair_rounds_operands_to_bf16():
    wp = torch.as_tensor(bitpack.pack_bits(np.eye(TM, TK, dtype=np.float32)))
    x1t = torch.full((1, TK), 1.0 + 2.0**-10)  # below bf16 resolution
    y1t, _ = bitpack.bbt_pair(wp, x1t, torch.zeros(1, TM))
    assert float(y1t[0, 0]) == 1.0


def test_cpu_tensors_take_the_plain_versions(rng):
    wp, x1t, x2t = _pair_inputs(rng, TM, TK, 4)
    before = dict(_build.LAUNCHES)
    bitpack.bbt_pair(torch.as_tensor(wp), torch.as_tensor(x1t), torch.as_tensor(x2t))
    assert _build.LAUNCHES == before


def test_bf16_rows_pads_with_zero_columns():
    """The launch helpers' operand copy: (n, d), here the transposed view of
    a (d, n) operand as the pair's entries pass it, -> contiguous (n,
    width) bf16 rows, d padded to a multiple of 8 with zero columns (the
    bodies read rows as 16-byte vectors)."""
    xt = torch.randn(5, 7)
    rows = bitpack._bf16_rows(xt.T)
    assert rows.shape == (7, 8) and rows.dtype == torch.bfloat16
    assert rows.is_contiguous()
    assert torch.equal(rows[:, :5], xt.T.to(torch.bfloat16))
    assert not rows[:, 5:].any()
    xt = torch.randn(16, 7)
    assert torch.equal(bitpack._bf16_rows(xt.T), xt.T.to(torch.bfloat16))


def test_other_devices_are_refused():
    wp = torch.zeros((TM, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        bitpack.t1(wp, torch.zeros((4, TK), device="meta"))


def test_missing_nvcc_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_library_path_is_keyed_on_sources():
    p = _build.library_path()
    assert p.parent == _build.BUILD_DIR and p == _build.library_path()
    assert p.name.startswith("libigcn_kernels_") and p.suffix == ".so"
    assert {s.name for s in _build._sources()} >= {"bbt_pair.cu", "fused_topk.cu"}


# -- dense graph layers -------------------------------------------------------


def _graphs(ds):
    arr, n_u, n_i = ds.train_array, ds.n_users, ds.n_items
    return (dense_graph.BipartiteDense.build(arr, n_u, n_i, device="cpu"),
            jdg.BipartiteDense.build(arr, n_u, n_i))


def test_feat_aggregate_matches_jax(tiny_ds, rng):
    g, jg = _graphs(tiny_ds)
    d = 16
    e_i = rng.normal(size=(tiny_ds.n_items, d)).astype(np.float32)
    e_u = rng.normal(size=(tiny_ds.n_users, d)).astype(np.float32)
    tok_u, tok_i = rng.normal(size=(2, d)).astype(np.float32)
    w_u = rng.random(tiny_ds.n_users).astype(np.float32)
    w_i = rng.random(tiny_ds.n_items).astype(np.float32)
    args = (e_i, e_u, tok_u, tok_i, w_u, w_i)
    got = dense_graph.feat_aggregate(g, *map(torch.as_tensor, args))
    want = jdg.feat_aggregate(jg, *map(jnp.asarray, args))
    assert got.shape == (tiny_ds.n_users + tiny_ds.n_items, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAIR_TOL)


def test_one_propagation_step_matches_jax(small_ds, rng):
    g, jg = _graphs(small_ds)
    xt = rng.normal(size=(8, small_ds.n_users + small_ds.n_items)).astype(np.float32)
    got = dense_graph.sym_norm_propagate(g, torch.as_tensor(xt).T).T
    want = jdg._sym_norm_propagate_t(jg, jnp.asarray(xt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAIR_TOL)


@pytest.mark.parametrize("n_layers", [1, 3])
def test_sym_norm_propagate_mean_matches_jax(small_ds, rng, n_layers):
    g, jg = _graphs(small_ds)
    x0 = rng.normal(size=(small_ds.n_users + small_ds.n_items, 8)).astype(np.float32)
    got = dense_graph.sym_norm_propagate_mean(g, torch.as_tensor(x0), n_layers)
    want = jdg.sym_norm_propagate_mean(jg, jnp.asarray(x0), n_layers)
    # each layer rounds its input to bf16; a different f32 sum order can move
    # an element across a bf16 boundary, one step (2^-8 of it), which reaches
    # the next layer through normalized weights <= 1
    atol = 2.0**-8 * float(np.abs(x0).max()) if n_layers > 1 else 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=atol)


def test_choose_backend():
    assert dense_graph.choose_backend(60, 80, device="cpu") == "dense"
    assert dense_graph.choose_backend(60, 80, "dense", device="cpu") == "dense"
    assert dense_graph.choose_backend(10**6, 10**6, "dense", device="cpu") == "dense"
    assert dense_graph.choose_backend(60, 80, "sparse", device="cpu") == "sparse"
    # too large for the budget: the sparse COO path
    assert dense_graph.choose_backend(10**6, 10**6, device="cpu") == "sparse"
    # the JAX package's round-1 alias (dense_graph.py:327-328)
    assert dense_graph.choose_backend(60, 80, "dense_lean", device="cpu") == "dense"
    with pytest.raises(ValueError):
        dense_graph.choose_backend(60, 80, "dense_fast", device="cpu")
    assert dense_graph.dense_budget_bytes("cpu") == dense_graph.CPU_DENSE_BUDGET_BYTES
