"""The tuning and gather-probe microbenchmarks of the port against the JAX
package, on the CPU at small sizes: T3/T4's plain versions against the JAX
tune tool's Pallas ``fwd`` (both ``resident_x0``) and ``bwd_t`` in
interpret mode, T5's plain version against the gather tool's Pallas kernel
in interpret mode (exactly), and both tools' control flow."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from igcn_cf_tpu_torch import tools
from igcn_cf_tpu_torch.kernels import _build, pcache
from igcn_cf_tpu_torch.tools import microbench_gather as mg
from igcn_cf_tpu_torch.tools import microbench_pcache as mpc
from igcn_cf_tpu_torch.tools import microbench_pcache_tune as mpt
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# bf16 operands, f32 sums in another order: only the sums' rounding differs
PAIR_TOL = dict(rtol=1e-5, atol=1e-4)
# the interpret-mode cases: a few seconds each (the JAX tool's own
# correctness shape, sub 8 and TR 64, takes ~9 s a call)
SMALL = dict(n=100, nj=2, sub=4, d=32, tr=32, r_tot=96)


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


def _jnp_bf16(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# -- T3/T4 against the JAX tune tool ------------------------------------------------


@pytest.mark.parametrize("resident_x0", [False, True])
def test_fwd_tune_plain_matches_jax_tool_interpret(interpret, resident_x0):
    """T3's plain version against the JAX tool's ``fwd`` (Pallas, interpret
    mode) on the same numpy draws."""
    jtool = _jax_tool("microbench_pcache_tune")
    p4, rows, x0, _, tr = mpt.correctness_inputs("cpu", **SMALL)
    want = jtool.fwd(_jnp_bf16(p4), jnp.asarray(rows.numpy()), _jnp_bf16(x0),
                     tr=tr, resident_x0=resident_x0)
    before = dict(_build.LAUNCHES)
    got = mpt.fwd_tune(p4, rows, x0, tr, resident_x0)
    assert _build.LAUNCHES == before  # CPU tensors take the plain versions
    assert got.shape == (SMALL["r_tot"], SMALL["d"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAIR_TOL)


def test_bwd_t_plain_matches_jax_tool_interpret(interpret):
    """T4's plain version against the JAX tool's ``bwd_t``: the (d, npad)
    transpose of dX0, as the JAX kernel returns it."""
    jtool = _jax_tool("microbench_pcache_tune")
    p4, rows, _, ct, tr = mpt.correctness_inputs("cpu", **SMALL)
    want = jtool.bwd_t(_jnp_bf16(p4), jnp.asarray(rows.numpy()), _jnp_bf16(ct),
                       tr=tr)
    before = dict(_build.LAUNCHES)
    got = mpt.bwd_t(p4, rows, ct, tr)
    assert _build.LAUNCHES == before
    npad = SMALL["nj"] * SMALL["sub"] * 128
    assert got.shape == (SMALL["d"], npad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PAIR_TOL)


def test_correctness_inputs_draw_the_jax_tools_sequence():
    """The default case is the JAX ``correctness()``'s: numpy seed 0, P4,
    rows, X0, ct in that order, at n 700, NJ 2, sub 8, d 32, TR 64, R 192."""
    p4, rows, x0, ct, tr = mpt.correctness_inputs("cpu")
    rng = np.random.default_rng(0)
    want_p4 = rng.standard_normal((700, 2, 8, 128)).astype(np.float32)
    want_rows = rng.integers(0, 700, size=192).astype(np.int32)
    assert tr == 64 and p4.shape == (700, 2, 8, 128) and p4.dtype == torch.bfloat16
    assert x0.shape == (2048, 32) and ct.shape == (192, 32)
    assert torch.equal(p4, torch.as_tensor(want_p4).to(torch.bfloat16))
    assert torch.equal(rows, torch.as_tensor(want_rows))


def test_tune_plain_versions_are_the_4d_functions(rng):
    """T3 computes T1's function in both variants; T4 is T2's result
    transposed, duplicate rows included."""
    n, nj, npad, d = 200, 2, 512, 16
    p = torch.as_tensor(rng.standard_normal((n, npad)).astype(np.float32)).to(
        torch.bfloat16)
    p4 = mpc.to4d(p, nj)
    rows = torch.as_tensor(np.r_[rng.integers(0, n, 60), [5, 5, 5]])
    x0 = torch.as_tensor(rng.standard_normal((npad, d)).astype(np.float32))
    ct = torch.as_tensor(rng.standard_normal((63, d)).astype(np.float32))
    want = mpc.fused_fwd_4d(p4, rows, x0)
    for res in (False, True):
        assert torch.equal(mpt.fwd_tune(p4, rows, x0, resident_x0=res), want)
    torch.testing.assert_close(mpt.bwd_t(p4, rows, ct),
                               mpc.fused_bwd_4d(p4, rows, ct).T)


def test_bwd_t_plain_is_k4_plain_transposed(rng):
    """T4 computes K4's function on the same memory, transposed (the card
    runs it through K4's body): its plain version, as CPU tensors take it,
    equals K4's plain version transposed, duplicate rows included, at every
    TR, with no launch."""
    n, nj, npad, d = 150, 2, 512, 24
    p = torch.as_tensor(rng.standard_normal((n, npad)).astype(np.float32)).to(
        torch.bfloat16)
    rows = torch.as_tensor(np.r_[rng.integers(0, n, 40), [7, 7, 149]])
    ct = torch.as_tensor(rng.standard_normal((43, d)).astype(np.float32))
    want = pcache.gather_bwd(p, rows, ct.to(torch.bfloat16)).T
    before = dict(_build.LAUNCHES)
    for tr in mpt.BWD_TRS:
        torch.testing.assert_close(mpt.bwd_t(mpc.to4d(p, nj), rows, ct, tr),
                                   want, **PAIR_TOL)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("splits", [None, 1, 3])
def test_fwd_wrappers_take_splits_on_the_cpu(rng, splits):
    """T1 takes the column splits S (T3 always its chosen S); on the CPU both
    run the plain version whatever S is, and launch nothing."""
    n, nj, npad, d = 50, 2, 512, 8
    p4 = mpc.to4d(torch.as_tensor(rng.standard_normal((n, npad)).astype(
        np.float32)).to(torch.bfloat16), nj)
    rows = torch.as_tensor(rng.integers(0, n, 20))
    x0 = torch.as_tensor(rng.standard_normal((npad, d)).astype(np.float32))
    before = dict(_build.LAUNCHES)
    want = mpc.fused_fwd_4d_plain(p4, rows, x0)
    assert torch.equal(mpc.fused_fwd_4d(p4, rows, x0, 32, splits), want)
    for res in (False, True):
        assert torch.equal(mpt.fwd_tune(p4, rows, x0, 32, res), want)
    assert _build.LAUNCHES == before


def test_tune_correctness_runs_on_the_cpu_plain_versions():
    before = dict(_build.LAUNCHES)
    err = mpt.correctness("cpu")
    assert _build.LAUNCHES == before
    assert err == {"fwd resident=0": 0.0, "fwd resident=1": 0.0, "bwd_t": 0.0}


# -- T5 against the JAX gather tool --------------------------------------------------


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_gather_chain_plain_equals_pallas_interpret(dtype, jdtype):
    """``gather_chain_plain`` against ``make_gather_kernel``'s pallas_call
    (interpret mode) on the JAX tool's draws: exactly equal, bf16 rounding
    after every add included."""
    n, reps = 64, 5
    jtool = _jax_tool("microbench_gather")
    idx, x = mg.gather_inputs(n, dtype, "cpu")
    call = pl.pallas_call(
        jtool.make_gather_kernel(n, reps),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, 128), jdtype),
        interpret=True)
    want = call(jnp.asarray(idx.numpy()), jnp.asarray(x.float().numpy()).astype(jdtype))
    want = torch.as_tensor(np.array(want.astype(jnp.float32))).to(dtype)
    before = dict(_build.LAUNCHES)
    got = mg.gather_chain(idx, x, reps)
    assert _build.LAUNCHES == before
    assert got.dtype == dtype and torch.equal(got, want)


def test_gather_chain_plain_is_the_sequential_sum():
    """f32: the sum of the reps gathers in the order of i, from zero."""
    n, reps = 96, 7
    idx, x = mg.gather_inputs(n, torch.float32, "cpu")
    xn, idn = x.numpy(), idx.numpy()
    want = np.zeros_like(xn)
    cols = np.arange(128)[None, :]
    for i in range(reps):
        want = want + xn[(idn + i) % n, cols]
    assert torch.equal(mg.gather_chain_plain(idx, x, reps), torch.as_tensor(want))
    assert torch.equal(mg.gather_chain_plain(idx, x, 0), torch.zeros_like(x))


def test_gather_inputs_draw_the_jax_tools_sequence():
    idx, x = mg.gather_inputs(512, torch.bfloat16, "cpu")
    rng = np.random.default_rng(0)
    want_x = rng.standard_normal((512, 128)).astype(np.float32)
    want_idx = rng.integers(0, 512, size=(512, 128)).astype(np.int32)
    assert idx.dtype == torch.int32 and torch.equal(idx, torch.as_tensor(want_idx))
    assert torch.equal(x, torch.as_tensor(want_x).to(torch.bfloat16))


@pytest.mark.parametrize("n,dtype,w", [
    (512, torch.float32, 64), (2048, torch.float32, 16),
    (8192, torch.float32, 4), (2048, torch.bfloat16, 32),
    (58112, torch.float32, 1), (100, torch.float32, 128)])
def test_stripe_width_fits_a_blocks_shared_memory(n, dtype, w):
    """The widest power-of-two stripe whose N rows fit 232,448 bytes."""
    assert mg.stripe_width(n, dtype) == w


def test_stripe_width_refuses_rows_that_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        mg.stripe_width(58113, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        mg.stripe_width(116225, torch.bfloat16)


def test_gather_correctness_runs_on_the_cpu_plain_versions():
    before = dict(_build.LAUNCHES)
    err = mg.correctness("cpu")
    assert _build.LAUNCHES == before
    assert err == {"N=512 float32": 0.0, "N=2048 float32": 0.0,
                   "N=8192 float32": 0.0, "N=2048 bfloat16": 0.0}


# -- the tools' control flow ----------------------------------------------------------


def _one_call(fn, **kw):  # no device clock on the CPU: run once, time 1
    fn()
    return 1.0


def _fake_card(monkeypatch, mod):
    card = tools.Card("NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3, 700.00 W",
                      tools.datasheet("NVIDIA H100 80GB HBM3"))
    monkeypatch.setattr(mod, "card", lambda: card)


def test_microbench_pcache_tune_rows_at_a_tiny_shape(monkeypatch, capsys):
    """Every (NJ, TR, resident) row of the sweep on the CPU plain versions,
    the roofline, and no kernel launch."""
    for name, value in (("N", 300), ("NPAD", 1024), ("R", 96), ("D", 16)):
        monkeypatch.setattr(mpc, name, value)
    _fake_card(monkeypatch, mpt)
    monkeypatch.setattr(mpt, "cuda_ms", _one_call)
    before = dict(_build.LAUNCHES)
    ms = mpt.main(device="cpu")
    assert _build.LAUNCHES == before
    want = [f"fwd nj={nj} tr={tr} resident={int(res)}"
            for nj in (4, 2) for tr, res in mpt.FWD_GRID]
    want += [f"bwd_t nj={nj} tr={tr}" for nj in (4, 2) for tr in (128, 64, 32)]
    assert sorted(ms) == sorted(want) and len(want) == 14
    out = capsys.readouterr().out
    for name in want:
        assert name in out
    assert out.count("launch: plain version (CPU)") == 6  # each T4 row
    assert "roofline (NVIDIA H100 80GB HBM3, 700.00 W)" in out
    assert "819 GB/s" not in out  # no TPU roofline


def test_microbench_gather_rows_at_a_tiny_shape(monkeypatch, capsys):
    monkeypatch.setattr(mg, "CASES", ((64, torch.float32), (32, torch.bfloat16)))
    _fake_card(monkeypatch, mg)
    monkeypatch.setattr(mg, "sm_clock", lambda: (132, 1980.0))
    monkeypatch.setattr(mg, "queued_cuda_ms", _one_call)
    before = dict(_build.LAUNCHES)
    ms = mg.main(device="cpu")
    assert _build.LAUNCHES == before
    assert set(ms) == {"N=64 float32", "N=32 bfloat16"}
    out = capsys.readouterr().out
    assert "bit-equal to its plain version in 2 cases" in out
    assert "cycles/row at 1980 MHz" in out and "all 132 SMs" in out
    assert out.count("us/gather") == 2
    assert "940 MHz" not in out  # no TPU clock


@pytest.mark.parametrize("main", [mpt.main, mg.main],
                         ids=["microbench_pcache_tune", "microbench_gather"])
def test_tools_refuse_to_run_without_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        main()
