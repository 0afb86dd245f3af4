"""The kernel-microbenchmark slice of the port against the JAX package, on
the CPU at small sizes: K1m/K2m's plain versions against the Pallas
t-kernels in interpret mode, the dropped pair and its VJP, T1/T2's plain
versions against the JAX tool's Pallas kernels in interpret mode, the three
forms of the dropped feature aggregation, the two tools' control flow, and
the entry points' default device (the card)."""

import functools
import importlib.util
import inspect
from pathlib import Path

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import igcn_cf_tpu.kernels.bitpack as jbp
import igcn_cf_tpu.kernels.dense_graph as jdg
from igcn_cf_tpu_torch import dryrun, tools
from igcn_cf_tpu_torch.analysis import plots
from igcn_cf_tpu_torch.core import mesh
from igcn_cf_tpu_torch.data.sampler import DeviceNegativeSampler
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.kernels import _build, bitpack, dense_graph, pcache, retrieval
from igcn_cf_tpu_torch.kernels.bitpack import TK, TM
from igcn_cf_tpu_torch.kernels.dense_graph import FeatDrop
from igcn_cf_tpu_torch.models.base import Model, get_model
from igcn_cf_tpu_torch.models.inmo import IGCN
from igcn_cf_tpu_torch.models.lightgcn import LightGCN
from igcn_cf_tpu_torch.models.ngcf import NGCF
from igcn_cf_tpu_torch.parallel import dense_steps, steps
from igcn_cf_tpu_torch.parallel import trainer as sharded_trainer
from igcn_cf_tpu_torch.serve import Recommender
from igcn_cf_tpu_torch.tools import amazon_scale_check, amazon_serve_check
from igcn_cf_tpu_torch.tools import microbench_dual as mdual
from igcn_cf_tpu_torch.tools import microbench_gather as mgather
from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mtune
from igcn_cf_tpu_torch.tools import parity_run, soak_gowalla
from igcn_cf_tpu_torch.tools import (
    amazon_sharded_projection,
    bench_eval,
    bench_serve,
    bench_serve_grown,
    microbench_retrieval,
    microbench_spmm2,
    microbench_topk,
    scaling_harness,
    serve_grown_phase,
    sharded_midscale,
)
from igcn_cf_tpu_torch.tuning import grid, population
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# bf16 operands, f32 sums in another order: only the sums' rounding differs
PAIR_TOL = dict(rtol=1e-5, atol=1e-4)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_tool(name):
    """The JAX package's tool ``tools/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` of the test in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# -- K1m/K2m: the in-kernel masked transposed pair ------------------------------


@pytest.mark.parametrize("p", [0.1, 0.3])
@pytest.mark.parametrize("seed", [5, 2**32 - 9])
def test_masked_pair_plain_matches_pallas_interpret(rng, p, seed):
    """``t1_masked``/``t2_masked`` on the CPU (their row-blocked plain
    versions) against ``_t1_pallas``/``_t2_pallas(masked=True)``."""
    d = 8
    b = (rng.random((TM, TK)) < 0.2).astype(np.float32)
    wp = bitpack.pack_bits(b)
    x1t = rng.normal(size=(d, TK)).astype(np.float32)
    x2t = rng.normal(size=(d, TM)).astype(np.float32)
    jwp = jnp.asarray(wp.view(np.uint32))
    want1 = jbp._t1_pallas(jwp, jnp.asarray(x1t), jnp.uint32(seed), p, True,
                           interpret=True)
    want2 = jbp._t2_pallas(jwp, jnp.asarray(x2t), jnp.uint32(seed), p, True,
                           interpret=True)
    before = dict(_build.LAUNCHES)
    got1 = bitpack.t1_masked(_t(wp), _t(x1t), seed, p)
    got2 = bitpack.t2_masked(_t(wp), _t(x2t), seed, p)
    assert _build.LAUNCHES == before  # CPU tensors take the plain versions
    assert got1.shape == (d, TM) and got2.shape == (d, TK)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **PAIR_TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **PAIR_TOL)
    # the mask drops: the unmasked pair differs
    assert not np.allclose(got1.numpy(), bitpack.t1(_t(wp), _t(x1t)).numpy())


def _pair_case(rng, d=8):
    m, k = 2 * TM, TK
    wp = bitpack.pack_bits((rng.random((m, k)) < 0.1).astype(np.float32))
    x1t = rng.normal(size=(d, k)).astype(np.float32)
    x2t = rng.normal(size=(d, m)).astype(np.float32)
    c1 = rng.normal(size=(d, m)).astype(np.float32)
    c2 = rng.normal(size=(d, k)).astype(np.float32)
    return wp, x1t, x2t, c1, c2


def _port_pair(fn, x1t, x2t, c1, c2):
    a, b = _t(x1t).requires_grad_(), _t(x2t).requires_grad_()
    y1, y2 = fn(a, b)
    g1, g2 = torch.autograd.grad((y1, y2), (a, b), (_t(c1), _t(c2)))
    return y1.detach(), y2.detach(), g1, g2


@pytest.mark.parametrize("k1,k2,p", [(3, 11, 0.3), (21, 4, 0.1)])
def test_bbt_pair_dropped_and_vjp_match_jax(rng, k1, k2, p):
    """Forward and VJP against the JAX ``bbt_pair_dropped`` given the seeds
    its keys yield; seed1 != seed2, so a seed swap in the backward shows."""
    wp, x1t, x2t, c1, c2 = _pair_case(rng)
    key1, key2 = jax.random.PRNGKey(k1), jax.random.PRNGKey(k2)
    (jy1, jy2), vjp = jax.vjp(
        lambda a, b: jbp.bbt_pair_dropped(jnp.asarray(wp.view(np.uint32)), a, b,
                                          key1, key2, p),
        jnp.asarray(x1t), jnp.asarray(x2t))
    jg1, jg2 = vjp((jnp.asarray(c1), jnp.asarray(c2)))
    s1, s2 = int(jbp._seed_from_key(key1)), int(jbp._seed_from_key(key2))
    got = _port_pair(
        lambda a, b: bitpack.bbt_pair_dropped(_t(wp), a, b, s1, s2, p),
        x1t, x2t, c1, c2)
    for g, w in zip(got, (jy1, jy2, jg1, jg2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PAIR_TOL)


def test_bbt_pair_dropped_matches_premasked(rng):
    """The in-kernel masked pair equals the pair over ``mask_words``
    copies, forward and gradients."""
    wp, x1t, x2t, c1, c2 = _pair_case(rng, d=4)
    s1, s2, p = 2**32 - 5, 77, 0.3
    got = _port_pair(
        lambda a, b: bitpack.bbt_pair_dropped(_t(wp), a, b, s1, s2, p),
        x1t, x2t, c1, c2)
    w1, w2 = bitpack.mask_words(_t(wp), s1, p), bitpack.mask_words(_t(wp), s2, p)
    want = _port_pair(lambda a, b: bitpack.bbt_pair_premasked(w1, w2, a, b),
                      x1t, x2t, c1, c2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **PAIR_TOL)


def test_dropped_pair_refuses_bad_seeds():
    wp = torch.zeros((TM, 128), dtype=torch.int32)
    for bad in (-1, 2**32):
        with pytest.raises(ValueError):
            bitpack.bbt_pair_dropped(wp, torch.zeros(2, TK), torch.zeros(2, TM),
                                     bad, 1, 0.3)
        with pytest.raises(ValueError):
            bitpack.t2_masked(wp, torch.zeros(2, TM), bad, 0.3)


# -- T1/T2: the 4-D fused gather kernels ---------------------------------------


def test_fused_4d_plain_matches_jax_tool_interpret(interpret):
    """T1/T2's plain versions against the JAX tool's ``fused_fwd_4d`` and
    ``fused_bwd_4d`` (Pallas, interpret mode) at its correctness shape."""
    jtool = _jax_tool("microbench_pcache")
    p4, rows, x0, ct, tr = mpc.correctness_inputs("cpu")
    jp4 = jnp.asarray(p4.float().numpy()).astype(jnp.bfloat16)
    jrows = jnp.asarray(rows.numpy())
    r_tot = rows.shape[0]
    want_f = jtool.fused_fwd_4d(jp4, jrows, jnp.asarray(x0.numpy()),
                                r_tot=r_tot, tr=tr)
    want_b = jtool.fused_bwd_4d(jp4, jrows, jnp.asarray(ct.numpy()),
                                r_tot=r_tot, tr=tr)
    before = dict(_build.LAUNCHES)
    got_f = mpc.fused_fwd_4d(p4, rows, x0, tr)
    got_b = mpc.fused_bwd_4d(p4, rows, ct, tr)
    assert _build.LAUNCHES == before
    assert got_f.shape == (r_tot, 64) and got_b.shape == (1024, 64)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **PAIR_TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **PAIR_TOL)


def test_fused_4d_plain_is_the_cached_prop_function(rng):
    """The 4-D view is the row-major P's memory: T1/T2's plain versions
    compute K3/K4's function on it, duplicate rows included."""
    n, nj, npad = 300, 2, 512
    p = torch.as_tensor(rng.standard_normal((n, npad)).astype(np.float32)).to(
        torch.bfloat16)
    p4 = mpc.to4d(p, nj)
    assert p4.shape == (n, nj, 2, 128) and p4.data_ptr() == p.data_ptr()
    rows = torch.as_tensor(np.r_[rng.integers(0, n, 90), [7, 7, 7]])
    x0 = torch.as_tensor(rng.standard_normal((npad, 16)).astype(np.float32))
    ct = torch.as_tensor(rng.standard_normal((93, 16)).astype(np.float32))
    torch.testing.assert_close(mpc.fused_fwd_4d(p4, rows, x0),
                               pcache.gather_fwd(p, rows, x0.to(torch.bfloat16)))
    torch.testing.assert_close(mpc.fused_bwd_4d(p4, rows, ct),
                               pcache.gather_bwd(p, rows, ct.to(torch.bfloat16)))


def test_correctness_check_runs_on_the_cpu_plain_versions():
    err = mpc.correctness("cpu")
    assert err == {"F4": 0.0, "G4": 0.0}


# -- the three forms of the dropped feature aggregation --------------------------


def _jax_drop(key, n_users, n_items, p):
    """The draws JAX feat_aggregate makes from its key (dense_graph.py:285-288)."""
    k_b, k_bt, k_tu, k_ti = jax.random.split(key, 4)
    return FeatDrop(
        int(jbp._seed_from_key(k_b)), int(jbp._seed_from_key(k_bt)),
        _t(jax.random.bernoulli(k_tu, 1.0 - p, (n_users, 1))[:, 0]),
        _t(jax.random.bernoulli(k_ti, 1.0 - p, (n_items, 1))[:, 0]))


@pytest.mark.parametrize("key_seed", [11, 12])
def test_insitu_variants_agree_and_match_jax(tiny_ds, rng, key_seed):
    """old-path (K6m/K7m), bbt-drop (K1m/K2m) and premask (mask_words, then
    K1/K2) on the same draws: outputs and gradients equal each other and
    the JAX ``feat_aggregate`` given the same key."""
    arr, n_u, n_i = tiny_ds.train_array, tiny_ds.n_users, tiny_ds.n_items
    g = dense_graph.BipartiteDense.build(arr, n_u, n_i, device="cpu")
    jg = jdg.BipartiteDense.build(arr, n_u, n_i)
    d, p = 16, 0.3
    args = [rng.normal(size=(n_i, d)), rng.normal(size=(n_u, d)),
            rng.normal(size=d), rng.normal(size=d), rng.random(n_u),
            rng.random(n_i)]
    args = [a.astype(np.float32) for a in args]
    key = jax.random.PRNGKey(key_seed)
    want, vjp = jax.vjp(
        lambda ei, eu: jdg.feat_aggregate(
            jg, ei, eu, *map(jnp.asarray, args[2:]), dropout=p, key=key),
        jnp.asarray(args[0]), jnp.asarray(args[1]))
    ct = rng.normal(size=want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    drop = _jax_drop(key, n_u, n_i, p)
    for name, fn in mdual.VARIANTS:
        leaves = [_t(a).requires_grad_() for a in args[:2]]
        got = fn(g, *leaves, *map(_t, args[2:]), dropout=p, drop=drop)
        grads = torch.autograd.grad(got, leaves, _t(ct))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **PAIR_TOL, err_msg=name)
        for gt, w in zip(grads, jgrads):
            np.testing.assert_allclose(gt.numpy(), np.asarray(w), **PAIR_TOL,
                                       err_msg=name)


# -- the tools' control flow and helpers ------------------------------------------


def test_popcount_matches_numpy(rng):
    words = rng.integers(0, 2**32, size=(64, 40), dtype=np.uint64).astype(np.uint32)
    want = int(np.unpackbits(words.view(np.uint8)).sum())
    assert mdual.popcount(_t(words.view(np.int32))) == want


def test_datasheet_by_card_name():
    assert tools.datasheet("NVIDIA H100 80GB HBM3").hbm_bytes_s == 3.35e12
    assert tools.datasheet("NVIDIA H100 80GB HBM3").bf16_flops == 989e12
    assert tools.datasheet("NVIDIA H100 PCIe").hbm_bytes_s == 2.0e12
    assert tools.datasheet("NVIDIA H200").hbm_bytes_s == 4.8e12
    with pytest.raises(ValueError):
        tools.datasheet("TPU v5 lite")  # no other card's numbers
    assert tools.bound_ms(3.35e9, 1e9, 989e12, 3.35e12) == (1.0, "bytes")
    ms, by = tools.bound_ms(1e6, 989e12, 989e12, 3.35e12)
    assert (ms, by) == (1000.0, "operations")


def _fake_card(monkeypatch, mod):
    card = tools.Card("NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3, 700.00 W",
                      tools.datasheet("NVIDIA H100 80GB HBM3"))
    monkeypatch.setattr(mod, "card", lambda: card)

    def one_call(fn, **kw):  # no device clock on the CPU: run once, time 1
        fn()
        return 1.0

    monkeypatch.setattr(mod, "cuda_ms", one_call)


def test_microbench_dual_rows_at_a_tiny_shape(monkeypatch, capsys):
    """The tool's control flow on the CPU plain versions: every row, the
    keep rate, and no kernel launch."""
    for name, value in (("M", TM), ("K", TK), ("N_USERS", 300),
                        ("N_ITEMS", 500), ("NNZ", 3000)):
        monkeypatch.setattr(mdual, name, value)
    _fake_card(monkeypatch, mdual)
    before = dict(_build.LAUNCHES)
    ms = mdual.main(["8"], device="cpu")
    assert _build.LAUNCHES == before
    assert len(ms) == 8 + 2 * len(mdual.VARIANTS)
    out = capsys.readouterr().out
    rate = float(out.split("mask_words keep rate: ")[1].split()[0])
    assert abs(rate - (1 - 77 / 256)) < 0.01


def test_microbench_pcache_rows_at_a_tiny_shape(monkeypatch, capsys):
    for name, value in (("N", 300), ("NPAD", 1024), ("R", 96), ("D", 16),
                        ("TR", 32), ("NJ", 2)):
        monkeypatch.setattr(mpc, name, value)
    _fake_card(monkeypatch, mpc)
    ms = mpc.main(device="cpu")
    assert set(ms) == {"A0", "A", "B", "C", "D", "F4", "G4", "E"}
    out = capsys.readouterr().out
    assert "roofline (NVIDIA H100 80GB HBM3, 700.00 W)" in out


def test_tools_refuse_to_time_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        tools.card()


# -- the entry points run on the card unless asked for the CPU --------------------


@pytest.mark.parametrize("fn", [
    get_model, Model.__init__, IGCN.__init__, LightGCN.__init__,
    NGCF.__init__, Recommender.from_checkpoint,
    dense_graph.BipartiteDense.build, DeviceNegativeSampler.build,
    dense_graph.choose_backend, pcache.use_pcache,
    retrieval.pack_exclusion_words_device, mdual.main, mpc.main,
    mtune.main, mtune.correctness, mgather.main, mgather.correctness,
    mgather.gather_inputs, parity_run.main, soak_gowalla.main,
    amazon_scale_check.main, amazon_serve_check.main, grid.grid_search,
    grid.tune_preset, population.population_grid_search,
    plots.template_ratio_sweep, mesh.make_mesh, microbench_retrieval.main,
    bench_eval.main, bench_serve.main, bench_serve_grown.main,
    serve_grown_phase.main, scaling_harness.main, sharded_midscale.main,
    amazon_sharded_projection.main, dryrun.entry, dryrun.dryrun_multichip,
    dryrun.main, microbench_topk.main, microbench_spmm2.main,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("fn", [
    steps.build_inmo_sharded_train, dense_steps.build_inmo_dense_sharded_train,
    sharded_trainer.ShardedIGCNTrainer.__init__,
], ids=lambda f: f.__qualname__)
def test_mesh_entry_points_run_on_the_meshs_device(fn):
    """The sharded builders and trainer take their device from the mesh,
    whose own default is the card (``make_mesh`` above): no device
    parameter of theirs can send them to the CPU."""
    params = inspect.signature(fn).parameters
    assert "mesh" in params and "device" not in params


def test_default_calls_raise_without_a_card(tmp_path):
    """Where no card is visible, a call that leaves the device to its
    default raises: it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    ds = synthetic_interactions(n_users=40, n_items=50, avg_degree=6, seed=3)
    cfg = {"name": "LightGCN", "embedding_size": 8, "n_layers": 1}
    for name in ("IGCN", "LightGCN", "NGCF"):
        model_cfg = dict(cfg, name=name, feature_ratio=1.0,
                         layer_sizes=[8], dropout=0.1)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            get_model(model_cfg, ds)
    model = get_model(cfg, ds, device="cpu")
    path = str(tmp_path / "ckpt.pkl")
    model.save(path, model.init_params(torch.Generator().manual_seed(0)))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Recommender.from_checkpoint(path, cfg, ds)
    for call in (
            lambda: dense_graph.BipartiteDense.build(ds.train_array, 40, 50),
            lambda: DeviceNegativeSampler.build(ds),
            lambda: dense_graph.choose_backend(40, 50),
            lambda: retrieval.pack_exclusion_words_device([0], [1], 40, 4096)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
    with pytest.raises((RuntimeError, AssertionError)):
        pcache.use_pcache(40, 50, 1)  # the card's memory budget is asked
