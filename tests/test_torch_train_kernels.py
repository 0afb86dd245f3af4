"""The port's training kernels (plain versions, as CPU tensors take them)
against the JAX package: the dropout keep mask and packed membership
bit-exact, bb_matmul and the transposed pairs with their gradients, the
propagation cache build, the gather-matmul pair (against the Pallas kernels
in interpret mode), and the feature aggregation with dropout on the JAX
package's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import igcn_cf_tpu.kernels.bitpack as jbp
import igcn_cf_tpu.kernels.dense_graph as jdg
import igcn_cf_tpu.kernels.pcache as jpc
from igcn_cf_tpu_torch.kernels import _build, bitpack, dense_graph, pcache
from igcn_cf_tpu_torch.kernels.bitpack import TK, TM
from igcn_cf_tpu_torch.kernels.dense_graph import FeatDrop
from igcn_cf_tpu_torch.utils.timing import cuda_ms
from torch_threads import one_thread  # noqa: F401

# bf16 operands, f32 sums in another order: only the sums' rounding differs
PAIR_TOL = dict(rtol=1e-5, atol=1e-4)
# P is stored in bf16: ~2^-8 relative per entry, entries in [0, 1]
# (tests/test_pcache.py:29)
BF16_ATOL = 8e-3


def _u32(t):
    return (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).view(np.uint32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _words(rng, m, kw):
    return rng.integers(0, 2**32, size=(m, kw), dtype=np.uint64).astype(np.uint32)


# -- keep mask, bit-exact -------------------------------------------------------


@pytest.mark.parametrize("p", [0.0, 0.1, 0.3, 0.5, 0.99, 1.0])
def test_threshold_matches_jax(p):
    assert bitpack._threshold_u8(p) == jbp._threshold_u8(p)
    assert bitpack._threshold_u8(0.3) == 77  # p = 0.3 drops 77/256


@pytest.mark.parametrize("key_seed,p", [(0, 0.3), (7, 0.5), (2021, 0.1)])
def test_mask_words_bit_exact_vs_jax(rng, key_seed, p):
    wp = _words(rng, TM, 2 * 128)
    key = jax.random.PRNGKey(key_seed)
    seed = int(jbp._seed_from_key(key))
    got = bitpack.mask_words(_t(wp.view(np.int32)), seed, p)
    np.testing.assert_array_equal(_u32(got), np.asarray(jbp.mask_words(jnp.asarray(wp), key, p)))


def test_keepword_over_the_slices_full_range():
    """Rows and words up to the Gowalla slice's B (30,208 x 1,408 words) and
    seeds near 2**32, where u32 products wrap."""
    rows = np.array([0, 1, 511, 4097, 20000, 30206, 30207], np.uint32)
    words = np.array([0, 1, 127, 128, 1000, 1406, 1407], np.uint32)
    for seed in (0, 1, 2**31, 2**32 - 2, 2**32 - 1):
        for thr in (0, 77, 128, 255):
            want = np.asarray(jbp._keepword(jnp.uint32(seed),
                                            jnp.asarray(rows)[:, None],
                                            jnp.asarray(words)[None, :], thr))
            got = bitpack._keepword(seed, _t(rows.astype(np.int64))[:, None],
                                    _t(words.astype(np.int64))[None, :], thr)
            np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_mask_words_at_high_coordinates_and_seeds(rng):
    """The full (row, word) frame of a tall B with seeds near 2**32."""
    wp = _words(rng, 30208, 8)
    for seed in (2**32 - 1, 2**32 - 12345):
        want = wp & np.asarray(jbp._keepword(
            jnp.uint32(seed), jax.lax.broadcasted_iota(jnp.uint32, wp.shape, 0),
            jax.lax.broadcasted_iota(jnp.uint32, wp.shape, 1), 77))
        got = bitpack.mask_words(_t(wp.view(np.int32)), seed, 0.3)
        np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("m,kw,keys", [
    (7, 5, (3, 4)),        # kw not a multiple of 4: rows start mid-group
    (33, 3, (21, 2021)),
    (TM, 130, (0, 1)),
    (5, 1, (8, 9)),
])
def test_mask_words_pair_matches_two_calls_and_jax(rng, m, kw, keys):
    """The pair's plain counterpart, as CPU tensors take it, is two
    one-seed calls and JAX ``mask_words`` under each key."""
    wp = _words(rng, m, kw)
    wp[rng.random((m, kw)) < 0.5] = 0
    ka, kb = map(jax.random.PRNGKey, keys)
    sa, sb = int(jbp._seed_from_key(ka)), int(jbp._seed_from_key(kb))
    before = dict(_build.LAUNCHES)
    got = bitpack.mask_words_pair(_t(wp.view(np.int32)), sa, sb, 0.3)
    assert _build.LAUNCHES == before  # CPU tensors take the plain version
    for g, seed, key in zip(got, (sa, sb), (ka, kb)):
        one = bitpack.mask_words(_t(wp.view(np.int32)), seed, 0.3)
        np.testing.assert_array_equal(_u32(g), _u32(one))
        np.testing.assert_array_equal(
            _u32(g), np.asarray(jbp.mask_words(jnp.asarray(wp), key, 0.3)))


def test_mask_words_pair_at_seeds_near_2_32(rng):
    """A tall B of 3 words a row under the two seeds the smoke uses."""
    wp = _words(rng, 30208, 3)
    seeds = (2**32 - 12345, 2**32 - 1)
    got = bitpack.mask_words_pair(_t(wp.view(np.int32)), *seeds, 0.3)
    for g, seed in zip(got, seeds):
        want = wp & np.asarray(jbp._keepword(
            jnp.uint32(seed), jax.lax.broadcasted_iota(jnp.uint32, wp.shape, 0),
            jax.lax.broadcasted_iota(jnp.uint32, wp.shape, 1), 77))
        np.testing.assert_array_equal(_u32(g), want)


def test_mask_words_pair_seeds_must_be_u32():
    wp = torch.zeros((TM, 128), dtype=torch.int32)
    for seeds in ((-1, 0), (0, 2**32)):
        with pytest.raises(ValueError):
            bitpack.mask_words_pair(wp, *seeds, 0.3)


def test_feat_aggregate_masks_b_in_one_pair_call(tiny_ds, monkeypatch):
    """The dropped feature aggregation masks B once for both directions,
    through one ``mask_words_pair`` call under the draw's two seeds."""
    g, _ = _graphs(tiny_ds)
    calls = []

    def pair(wp, seed_a, seed_b, p):
        calls.append((seed_a, seed_b))
        return bitpack.mask_words_pair(wp, seed_a, seed_b, p)

    monkeypatch.setattr(dense_graph, "mask_words_pair", pair)
    n_u, n_i, d = tiny_ds.n_users, tiny_ds.n_items, 8
    drop = FeatDrop(5, 2**32 - 6, torch.ones(n_u, dtype=torch.bool),
                    torch.ones(n_i, dtype=torch.bool))
    dense_graph.feat_aggregate(
        g, torch.randn(n_i, d), torch.randn(n_u, d), torch.randn(d),
        torch.randn(d), torch.rand(n_u), torch.rand(n_i), dropout=0.3,
        drop=drop)
    assert calls == [(5, 2**32 - 6)]


@pytest.mark.parametrize("n_rows,n_cols,seed,p", [(40, 4096, 5, 0.3),
                                                  (7, 8192 + 300, 2**32 - 3, 0.7)])
def test_keep_mask_dense_bit_exact_vs_jax(n_rows, n_cols, seed, p):
    got = bitpack.keep_mask_dense(seed, n_rows, n_cols, p)
    want = np.asarray(jbp.keep_mask_dense(jnp.uint32(seed), n_rows, n_cols, p))
    np.testing.assert_array_equal(got.numpy(), want)
    keep = got.float().mean().item()
    assert abs(keep - (1 - bitpack._threshold_u8(p) / 256)) < 0.03


def test_mask_words_applies_keep_mask_dense(rng):
    b = (rng.random((TM, TK)) < 0.2).astype(np.float32)
    wp = torch.as_tensor(bitpack.pack_bits(b))
    masked = bitpack.unpack_bits(bitpack.mask_words(wp, 99, 0.3))
    keep = bitpack.keep_mask_dense(99, TM, TK, 0.3)
    np.testing.assert_array_equal(masked.numpy(), b * keep.numpy())


def test_mask_seed_must_be_u32():
    wp = torch.zeros((TM, 128), dtype=torch.int32)
    for bad in (-1, 2**32):
        with pytest.raises(ValueError):
            bitpack.mask_words(wp, bad, 0.3)


def test_packed_lookup_bit_exact_vs_jax(rng):
    arr = np.stack([rng.integers(0, 700, 6000), rng.integers(0, 9000, 6000)], 1)
    packed, _, _ = jbp.pack_interactions(arr, 700, 9000)
    rows = rng.integers(0, 700, 3000)
    cols = rng.integers(0, 9000, 3000)
    rows[:500], cols[:500] = arr[:500, 0], arr[:500, 1]  # some members
    want = np.asarray(jbp.packed_lookup(jnp.asarray(packed), jnp.asarray(rows),
                                        jnp.asarray(cols)))
    got = bitpack.packed_lookup(_t(packed.view(np.int32)), _t(rows), _t(cols))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:500].all()


# -- bb_matmul (K6/K7) and the pairs (K1/K2), with gradients ------------------


@pytest.mark.parametrize("transpose", [False, True])
def test_bb_matmul_and_grad_match_jax(rng, transpose):
    b = (rng.random((TM, TK)) < 0.1).astype(np.float32)
    wp = bitpack.pack_bits(b)
    x = rng.normal(size=((TM if transpose else TK), 16)).astype(np.float32)
    ct = rng.normal(size=((TK if transpose else TM), 16)).astype(np.float32)
    jy, vjp = jax.vjp(lambda v: jbp.bb_matmul(jnp.asarray(_u32(wp)), v, transpose),
                      jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_()
    y = bitpack.bb_matmul(_t(wp), xt, transpose)
    (dx,) = torch.autograd.grad(y, xt, _t(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **PAIR_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **PAIR_TOL)


def _pair_case(rng, d=8):
    m, k = 2 * TM, TK
    w1 = bitpack.pack_bits((rng.random((m, k)) < 0.1).astype(np.float32))
    w2 = bitpack.pack_bits((rng.random((m, k)) < 0.1).astype(np.float32))
    x1t = rng.normal(size=(d, k)).astype(np.float32)
    x2t = rng.normal(size=(d, m)).astype(np.float32)
    c1 = rng.normal(size=(d, m)).astype(np.float32)
    c2 = rng.normal(size=(d, k)).astype(np.float32)
    return w1, w2, x1t, x2t, c1, c2


def _port_pair_grads(fn, x1t, x2t, c1, c2):
    a, b = _t(x1t).requires_grad_(), _t(x2t).requires_grad_()
    y1, y2 = fn(a, b)
    g1, g2 = torch.autograd.grad((y1, y2), (a, b), (_t(c1), _t(c2)))
    return y1.detach(), y2.detach(), g1, g2


def test_bbt_pair_premasked_grads_match_jax_vjp(rng):
    """W1 != W2, so an operand swap in the backward would show."""
    w1, w2, x1t, x2t, c1, c2 = _pair_case(rng)
    (jy1, jy2), vjp = jax.vjp(
        lambda a, b: jbp.bbt_pair_premasked(jnp.asarray(_u32(w1)),
                                            jnp.asarray(_u32(w2)), a, b),
        jnp.asarray(x1t), jnp.asarray(x2t))
    jg1, jg2 = vjp((jnp.asarray(c1), jnp.asarray(c2)))
    got = _port_pair_grads(
        lambda a, b: bitpack.bbt_pair_premasked(_t(w1), _t(w2), a, b),
        x1t, x2t, c1, c2)
    for g, w in zip(got, (jy1, jy2, jg1, jg2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PAIR_TOL)


def test_bbt_pair_grads_match_jax_vjp(rng):
    w1, _, x1t, x2t, c1, c2 = _pair_case(rng, d=4)
    (jy1, jy2), vjp = jax.vjp(
        lambda a, b: jbp.bbt_pair(jnp.asarray(_u32(w1)), a, b),
        jnp.asarray(x1t), jnp.asarray(x2t))
    jg1, jg2 = vjp((jnp.asarray(c1), jnp.asarray(c2)))
    got = _port_pair_grads(lambda a, b: bitpack.bbt_pair(_t(w1), a, b),
                           x1t, x2t, c1, c2)
    for g, w in zip(got, (jy1, jy2, jg1, jg2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PAIR_TOL)


# -- dense graph: propagation step and the dropped feature aggregation -------


def _graphs(ds):
    arr, n_u, n_i = ds.train_array, ds.n_users, ds.n_items
    return (dense_graph.BipartiteDense.build(arr, n_u, n_i, device="cpu"),
            jdg.BipartiteDense.build(arr, n_u, n_i))


def test_sym_norm_propagate_matches_jax(small_ds, rng):
    g, jg = _graphs(small_ds)
    x = rng.normal(size=(small_ds.n_users + small_ds.n_items, 8)).astype(np.float32)
    got = dense_graph.sym_norm_propagate(g, _t(x))
    want = jdg.sym_norm_propagate(jg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAIR_TOL)


def _jax_drop(key, n_users, n_items, p):
    """The draws JAX feat_aggregate makes from its key (dense_graph.py:285-288)."""
    k_b, k_bt, k_tu, k_ti = jax.random.split(key, 4)
    return FeatDrop(
        int(jbp._seed_from_key(k_b)), int(jbp._seed_from_key(k_bt)),
        _t(jax.random.bernoulli(k_tu, 1.0 - p, (n_users, 1))[:, 0]),
        _t(jax.random.bernoulli(k_ti, 1.0 - p, (n_items, 1))[:, 0]))


@pytest.mark.parametrize("key_seed", [11, 12])
def test_feat_aggregate_with_dropout_matches_jax(tiny_ds, rng, key_seed):
    g, jg = _graphs(tiny_ds)
    n_u, n_i, d, p = tiny_ds.n_users, tiny_ds.n_items, 16, 0.3
    args = [rng.normal(size=(n_i, d)), rng.normal(size=(n_u, d)),
            rng.normal(size=d), rng.normal(size=d), rng.random(n_u),
            rng.random(n_i)]
    args = [a.astype(np.float32) for a in args]
    key = jax.random.PRNGKey(key_seed)
    want, vjp = jax.vjp(
        lambda ei, eu, tu, ti: jdg.feat_aggregate(
            jg, ei, eu, tu, ti, jnp.asarray(args[4]), jnp.asarray(args[5]),
            dropout=p, key=key),
        *map(jnp.asarray, args[:4]))
    ct = rng.normal(size=want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_() for a in args[:4]]
    got = dense_graph.feat_aggregate(g, *leaves, _t(args[4]), _t(args[5]),
                                     dropout=p, drop=_jax_drop(key, n_u, n_i, p))
    grads = torch.autograd.grad(got, leaves, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **PAIR_TOL)
    for gt, w in zip(grads, jgrads):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), **PAIR_TOL)
    # the drop is real: it differs from the undropped layer
    full = dense_graph.feat_aggregate(g, *map(_t, args))
    assert not np.allclose(full.numpy(), got.detach().numpy())


def test_choose_backend_dense_lean_in_both_packages():
    for n_u, n_i in ((60, 80), (5000, 9000)):
        assert dense_graph.choose_backend(n_u, n_i, "dense_lean", device="cpu") == \
            jdg.choose_backend(n_u, n_i, "dense_lean") == "dense"


# -- propagation cache --------------------------------------------------------


@pytest.mark.parametrize("n_layers", [1, 3])
def test_build_prop_cache_matches_jax_and_oracle(tiny_ds, n_layers):
    g, jg = _graphs(tiny_ds)
    n = tiny_ds.n_users + tiny_ds.n_items
    p = pcache.build_prop_cache(g, n_layers)
    assert p.dtype == torch.bfloat16 and p.shape == (n, pcache.pcache_npad(n))
    got = p.float().numpy()  # stored as the logical (n, npad) matrix
    want = np.asarray(jpc.pcache_to_2d(jpc.build_prop_cache(jg, n_layers)),
                      np.float32)
    oracle = pcache.prop_cache_oracle(tiny_ds.train_array, tiny_ds.n_users,
                                      tiny_ds.n_items, n_layers)
    np.testing.assert_array_equal(
        oracle, jpc.prop_cache_oracle(tiny_ds.train_array, tiny_ds.n_users,
                                      tiny_ds.n_items, n_layers))
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=BF16_ATOL)
    np.testing.assert_allclose(got[:, :n], oracle, atol=BF16_ATOL)
    assert not got[:, n:].any()  # padding columns are zero
    np.testing.assert_allclose(got[:, :n], got[:, :n].T, atol=BF16_ATOL)


def test_build_prop_cache_cols_is_a_column_window(tiny_ds):
    g, _ = _graphs(tiny_ds)
    full = pcache.build_prop_cache(g, 2)
    part = pcache.build_prop_cache_cols(g, 2, 128, 128)
    assert torch.equal(part, full[:, 128:256])
    with pytest.raises(ValueError):
        pcache.build_prop_cache_cols(g, 2, 0, 100)


def _slab_case(seed=0, n=700, nj=2, sub=8, d=32, r=192):
    """A random bf16 P in the JAX slab layout (n, nj, sub, 128) and the
    port's row-major view of the same bytes."""
    rng = np.random.default_rng(seed)
    p4 = jnp.asarray(rng.standard_normal((n, nj, sub, 128)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    rows = rng.integers(0, n, size=r).astype(np.int32)
    rows[r // 2:] = rows[: r - r // 2]  # duplicate rows must sum
    npad = nj * sub * 128
    x0b = jnp.asarray(rng.standard_normal((npad, d)).astype(np.float32)).astype(jnp.bfloat16)
    ctb = jnp.asarray(rng.standard_normal((r, d)).astype(np.float32)).astype(jnp.bfloat16)
    p = torch.as_tensor(np.array(p4.astype(jnp.float32))).reshape(n, npad).to(torch.bfloat16)
    return p4, p, rows, x0b, ctb


def _bf16_t(x):
    return torch.as_tensor(np.array(x.astype(jnp.float32))).to(torch.bfloat16)


def test_gather_pair_matches_pallas_interpret():
    """K3/K4's plain versions against the TPU kernels themselves, run in
    interpret mode, with duplicate rows."""
    p4, p, rows, x0b, ctb = _slab_case()
    want_f = jpc._fused_fwd(p4, jnp.asarray(rows), x0b, tr=64, interpret=True)
    want_b = jpc._bwd_to_2d(jpc._fused_bwd(p4, jnp.asarray(rows), ctb, tr=64,
                                           interpret=True))
    got_f = pcache.gather_fwd(p, _t(rows), _bf16_t(x0b))
    got_b = pcache.gather_bwd(p, _t(rows), _bf16_t(ctb))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **PAIR_TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **PAIR_TOL)


def test_cached_prop_and_grad_match_jax(tiny_ds, rng):
    g, _ = _graphs(tiny_ds)
    n = tiny_ds.n_users + tiny_ds.n_items
    p = pcache.build_prop_cache(g, 2)
    # the operators on the same P: the port's bytes in JAX's slab shape
    p4 = jnp.asarray(p.float().numpy()).astype(jnp.bfloat16).reshape(
        n, 1, p.shape[1] // 128, 128)
    rows = np.array([0, 5, 5, tiny_ds.n_users + 3, n - 1, 0], np.int32)
    x0 = rng.normal(size=(n, 8)).astype(np.float32)
    ct = rng.normal(size=(len(rows), 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jpc.cached_prop(p4, jnp.asarray(rows), x),
                        jnp.asarray(x0))
    (jdx,) = vjp(jnp.asarray(ct))
    xt = _t(x0).requires_grad_()
    got = pcache.cached_prop(p, _t(rows), xt)
    (dx,) = torch.autograd.grad(got, xt, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **PAIR_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **PAIR_TOL)
    assert dx.shape == (n, 8) and dx.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cached_prop_takes_int32_and_int64_rows(tiny_ds, rng, monkeypatch, dtype):
    """The forward converts rows to int32 once and the backward reads that
    copy: with either id type, the output and dX0 equal the JAX operator's
    (duplicate ids included)."""
    g, _ = _graphs(tiny_ds)
    n = tiny_ds.n_users + tiny_ds.n_items
    p = pcache.build_prop_cache(g, 2)
    p4 = jnp.asarray(p.float().numpy()).astype(jnp.bfloat16).reshape(
        n, 1, p.shape[1] // 128, 128)
    rows = rng.integers(0, n, size=40).astype(np.int32)
    rows[20:] = rows[:20]
    x0 = rng.normal(size=(n, 16)).astype(np.float32)
    ct = rng.normal(size=(len(rows), 16)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jpc.cached_prop(p4, jnp.asarray(rows), x),
                        jnp.asarray(x0))
    (jdx,) = vjp(jnp.asarray(ct))
    seen = []
    bwd = pcache.gather_bwd
    monkeypatch.setattr(pcache, "gather_bwd",
                        lambda p_, r_, c_: seen.append(r_.dtype) or bwd(p_, r_, c_))
    xt = _t(x0).requires_grad_()
    got = pcache.cached_prop(p, torch.as_tensor(rows).to(dtype), xt)
    (dx,) = torch.autograd.grad(got, xt, _t(ct))
    assert seen == [torch.int32]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **PAIR_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **PAIR_TOL)


def test_pcache_gating(monkeypatch):
    assert not pcache.use_pcache(100, 100, 3, "auto", device="cpu")  # auto on the CPU: off
    assert pcache.use_pcache(100, 100, 3, True, device="cpu")
    assert not pcache.use_pcache(100, 100, 0, True, device="cpu")
    assert not pcache.use_pcache(100, 100, 3, False, device="cpu")
    with pytest.raises(ValueError):
        pcache.use_pcache(100, 100, 3, "always", device="cpu")
    # the slice: n = 70,839, npad = 70,912, 10.05 GB of bf16
    assert pcache.pcache_bytes(29858, 40981) == 70839 * 70912 * 2
    assert pcache.pcache_fits(29858, 40981, 80 * 10**9 - pcache.PCACHE_RESERVE_BYTES)
    assert not pcache.pcache_fits(29858, 40981, 8 * 2**30)
    # forced over budget on a card raises instead of failing mid-build
    monkeypatch.setattr(pcache, "pcache_budget_bytes", lambda device: 2**30)
    with pytest.raises(ValueError, match="budget"):
        pcache.use_pcache(29858, 40981, 3, True, device="cuda")
    assert not pcache.use_pcache(29858, 40981, 3, "auto", device="cuda")
    monkeypatch.setattr(pcache, "pcache_budget_bytes", lambda device: 2**40)
    assert pcache.use_pcache(29858, 40981, 3, "auto", device="cuda")


def test_ab_memo_round_trip(tmp_path, monkeypatch, tiny_ds):
    """The verdict is remembered per kernel sources, card and shape, in the
    memo file; a remembered verdict is used without measuring."""
    monkeypatch.setattr(pcache, "AB_MEMO_PATH", str(tmp_path / "ab" / "m.json"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "Card X")
    key = pcache._ab_memo_key(140, 16, 2, 64, "cuda")
    assert key.startswith(_build.library_path().stem) and "Card_X" in key
    assert key != pcache._ab_memo_key(140, 16, 2, 2048, "cuda")
    g, _ = _graphs(tiny_ds)
    calls = []

    def fake_measure(bip, p, n_layers, d, batch_size):
        calls.append(batch_size)
        return {"pcache_ms": 1.0, "recompute_ms": 3.0}

    monkeypatch.setattr(pcache, "measure_engines_ms", fake_measure)
    use, entry = pcache.ab_select(g, None, 2, 16, 64)
    assert use and entry["use_pcache"] and calls == [64]
    use, entry = pcache.ab_select(g, None, 2, 16, 64)
    assert use and calls == [64]  # remembered
    assert pcache._ab_memo_load()[pcache._ab_memo_key(140, 16, 2, 64, "cuda")]


def test_cuda_timer_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_ms(lambda: None)
