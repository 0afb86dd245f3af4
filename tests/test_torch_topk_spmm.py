"""The score-matrix eval's exact top-k and the two tools that measure the
eval's ranking and the sparse product's parts, on the CPU at toy sizes,
against the JAX package: ``exact_topk`` against JAX ``exact_topk`` at its
chunks 512 and 1,024 and ``mask_topk`` against JAX ``mask_topk_core`` (ids
and values exact: random normals, scores with ties across chunk borders,
signed zeros, rows with fewer than k finite scores, and JAX's flat
branch), ``microbench_topk``'s ranking against the JAX tool's, each of
``microbench_spmm2``'s parts against the JAX op it ports, and both tools'
``main`` at a toy size."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from igcn_cf_tpu.data.synthetic import synthetic_interactions as jax_synthetic
from igcn_cf_tpu.evaluation.evaluate import exact_topk as jax_exact_topk
from igcn_cf_tpu.evaluation.evaluate import mask_topk_core as jax_mask_topk_core
from igcn_cf_tpu.graph.build import sym_norm_adjacency as jax_sym_norm
from igcn_cf_tpu.kernels.sparse import SparseGraph as JaxSparseGraph
from igcn_cf_tpu_torch.evaluation.evaluate import (
    exact_topk,
    exact_topk_ids,
    mask_topk,
)
from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.tools import microbench_spmm2 as mspmm
from igcn_cf_tpu_torch.tools import microbench_topk as mtopk
from igcn_cf_tpu_torch.tools.microbench_topk import TOPK_CHUNK
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B, N, K = 16, 5000, 20
# bf16 parts: operands rounded to bf16, sums of a row's ~10 entries
BF16_RTOL = 1e-2


def _jax_tool(name):
    """The JAX package's tool ``tools/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scores(case: str, n: int = N, seed: int = 0) -> np.ndarray:
    """(B, n) f32 scores of one case, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n)).astype(np.float32)
    if case == "normal":
        return x
    ties = np.round(x * 8) / 8  # multiples of 2^-3: ties across chunk borders
    if case == "ties":
        return ties.astype(np.float32)
    if case == "signed_zeros":  # lax.top_k ranks +0.0 above -0.0
        z = np.where(rng.random((B, n)) < 0.5, -0.0, 0.0)
        return np.where(rng.random((B, n)) < 0.002, ties, z).astype(np.float32)
    if case == "few_finite":  # about five finite scores a row, the rest -inf
        return np.where(rng.random((B, n)) < 5 / n, ties,
                        -np.inf).astype(np.float32)
    raise ValueError(case)


CASES = ("normal", "ties", "signed_zeros", "few_finite")


def _assert_same(got, want):
    vals, ids = got
    want_vals, want_ids = (np.asarray(w) for w in want)
    assert ids.dtype == torch.int32 and ids.shape == want_ids.shape
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    # bit for bit, so +0.0 and -0.0 must match too
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  want_vals.view(np.int32))


# -- exact_topk against the JAX package's ---------------------------------------


@pytest.mark.parametrize("chunk", [512, 1024])
@pytest.mark.parametrize("case", CASES)
def test_exact_topk_matches_jax(case, chunk):
    s = _scores(case)
    assert N > 2 * chunk  # JAX's two-stage branch
    _assert_same(exact_topk(torch.as_tensor(s), K),
                 jax_exact_topk(jnp.asarray(s), K, chunk))


@pytest.mark.parametrize("chunk", [512, 1024])
@pytest.mark.parametrize("branch", ["narrow_row", "wide_k"])
def test_exact_topk_flat_branch_matches_jax(branch, chunk):
    """JAX's flat branch: a row of at most two chunks, or k past a chunk."""
    n, k = (2 * chunk, K) if branch == "narrow_row" else (N, chunk + 1)
    for case in CASES:
        s = _scores(case, n=n, seed=1)
        _assert_same(exact_topk(torch.as_tensor(s), k),
                     jax_exact_topk(jnp.asarray(s), k, chunk))


def test_exact_topk_ids_keeps_the_input_dtype():
    s = torch.as_tensor(_scores("ties")).to(torch.bfloat16)
    vals, ids = exact_topk(s, K)
    assert vals.dtype == torch.bfloat16
    want = torch.sort(s.float(), dim=1, descending=True, stable=True)
    assert torch.equal(ids.long(), want.indices[:, :K])
    assert torch.equal(exact_topk_ids(s, K), ids)


def _mask_inputs(rng, n):
    excl = np.full((B, 40), n, dtype=np.int64)  # padded with n_items
    for r in range(B):
        m = int(rng.integers(0, 40))
        excl[r, :m] = rng.choice(n, size=m, replace=False)
    banned = rng.random(n) < 0.01
    return excl, banned


@pytest.mark.parametrize("n", [N, 1500])
@pytest.mark.parametrize("case", CASES)
def test_mask_topk_matches_jax(case, n):
    """``mask_topk`` against JAX ``mask_topk_core``: at 5,000 items JAX's
    two-stage branch at chunk 1,024, at 1,500 its flat one."""
    s = _scores(case, n=n, seed=2)
    excl, banned = _mask_inputs(np.random.default_rng(3), n)
    got = mask_topk(torch.as_tensor(s), torch.as_tensor(excl),
                    torch.as_tensor(banned), K)
    want = np.asarray(jax_mask_topk_core(jnp.asarray(s), jnp.asarray(excl),
                                         jnp.asarray(banned), K, n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (n > 2 * TOPK_CHUNK) == (n == N)


def test_mask_topk_orders_ties_by_id_across_chunks():
    """Every score equal: the top k are the lowest ids that are neither
    excluded nor banned, in id order, over three of JAX's chunks."""
    n = 3 * TOPK_CHUNK
    scores = torch.zeros((2, n))
    exclude = torch.tensor([[0, 3, n], [n, n, n]])
    banned = torch.zeros(n, dtype=torch.bool)
    banned[5] = True
    got = mask_topk(scores, exclude, banned, 6)
    assert got.tolist() == [[1, 2, 4, 6, 7, 8], [0, 1, 2, 3, 4, 6]]


# -- microbench_topk ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_topk_tool():
    return _jax_tool("microbench_topk")


@pytest.mark.parametrize("chunk", mtopk.CHUNKS)
def test_two_stage_topk_matches_the_jax_tool(jax_topk_tool, chunk):
    for case in ("normal", "ties"):
        s = _scores(case)
        got = mtopk.two_stage_topk(torch.as_tensor(s), K, chunk)
        want = np.asarray(jax_topk_tool.two_stage_topk(jnp.asarray(s), K, chunk))
        np.testing.assert_array_equal(got.numpy(), want)


def test_flat_topk_matches_the_jax_tool(jax_topk_tool):
    for case in CASES:
        s = _scores(case)
        np.testing.assert_array_equal(
            mtopk.flat_topk(torch.as_tensor(s), K).numpy(),
            np.asarray(jax_topk_tool.flat_topk(jnp.asarray(s), K)))


def _one_call(fn, **kw):  # no device clock on the CPU: run once, time 1
    fn()
    return 1.0


def test_microbench_topk_main_at_a_toy_size(monkeypatch, capsys):
    for name, value in (("B", 8), ("N_ITEMS", 9000), ("NB", 2)):
        monkeypatch.setattr(mtopk, name, value)
    monkeypatch.setattr(mtopk, "cuda_ms", _one_call)
    before = dict(_build.LAUNCHES)
    r = mtopk.main(["--device", "cpu"])
    assert _build.LAUNCHES == before
    assert r["exact_match"] == {c: True for c in mtopk.CHUNKS}
    assert r["exact_topk_match"]
    assert set(r["ms"]) == {"flat", "exact_topk", "torch_topk", *mtopk.CHUNKS}
    assert set(r["parts_ms"]) == {"keys", "first_stage", "second_stage",
                                  "first_stage_int32"}
    assert r["device"] == "cpu" and r["torch_topk_match"] in (True, False)
    out = capsys.readouterr().out
    assert "two_stage chunk=4096: exact_match=True" in out


# -- microbench_spmm2 ----------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    """The 60 x 80 synthetic graph through both packages, and the JAX
    tool's draws of X and the pre-gathered rows."""
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
    from igcn_cf_tpu_torch.graph.build import sym_norm_adjacency
    from igcn_cf_tpu_torch.kernels.sparse import SparseGraph

    kw = dict(n_users=60, n_items=80, avg_degree=12, seed=1)
    jds, pds = jax_synthetic(**kw), synthetic_interactions(**kw)
    jg = JaxSparseGraph.from_coo(jax_sym_norm(jds.train_array, jds.n_users,
                                              jds.n_items))
    pg = SparseGraph.from_coo(sym_norm_adjacency(pds.train_array, pds.n_users,
                                                 pds.n_items), device="cpu")
    x, pre = mspmm.operands(pg, "cpu")
    return jg, pg, x, pre


def test_spmm2_graph_and_draws_equal_the_jax_tools(graphs):
    jg, pg, x, pre = graphs
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    rng = np.random.default_rng(0)  # the JAX tool's draws, in its order
    np.testing.assert_array_equal(
        x.numpy(), rng.normal(size=(jg.n_rows, mspmm.D)).astype(np.float32))
    np.testing.assert_array_equal(
        pre.numpy(), rng.normal(size=(jg.vals.shape[0], mspmm.D)).astype(np.float32))


def _jax_cumsum_seg(g, p):
    """The JAX tool's cumsum-diff segment sum (its ``:78-87``)."""
    indptr = np.zeros(g.n_rows + 1, dtype=np.int32)
    np.add.at(indptr, np.asarray(g.rows) + 1, 1)
    indptr = jnp.asarray(np.cumsum(indptr).astype(np.int32))
    cs = jnp.cumsum(p, axis=0)
    cs = jnp.concatenate([jnp.zeros((1, p.shape[1]), p.dtype), cs], axis=0)
    return cs[indptr[1:]] - cs[indptr[:-1]]


# each part of microbench_spmm2 and the JAX tool's op it ports
JAX_PARTS = {
    "gather": lambda g, x: x[g.cols],
    "gather_scale": lambda g, x: x[g.cols] * g.vals[:, None],
    "segment_sorted": lambda g, p: jax.ops.segment_sum(
        p, g.rows, num_segments=g.n_rows, indices_are_sorted=True),
    "segment_unsorted": lambda g, p: jax.ops.segment_sum(
        p, g.rows, num_segments=g.n_rows),
    "scatter_add": lambda g, p: jnp.zeros((g.n_rows, p.shape[1]),
                                          p.dtype).at[g.rows].add(p),
    "cumsum_diff": _jax_cumsum_seg,
}
JAX_PARTS["gather_bf16"] = JAX_PARTS["gather"]
JAX_PARTS["segment_sorted_bf16"] = JAX_PARTS["segment_sorted"]


@pytest.mark.parametrize("part", [p[0] for p in mspmm.PARTS])
def test_spmm2_part_matches_jax(graphs, part):
    jg, pg, x, pre = graphs
    _, fn, operand, dtype = next(p for p in mspmm.PARTS if p[0] == part)
    arg = {"x": x, "pre": pre}[operand]
    got = fn(pg, arg.to(dtype))
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(JAX_PARTS[part](jg, jnp.asarray(arg.numpy()).astype(jdtype)),
                      dtype=np.float32)
    assert got.dtype == dtype and got.shape == want.shape
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_microbench_spmm2_main_at_a_toy_size(monkeypatch, capsys):
    for name, value in (("N_USERS", 60), ("N_ITEMS", 80), ("AVG_DEGREE", 12)):
        monkeypatch.setattr(mspmm, name, value)
    monkeypatch.setattr(mspmm, "cuda_ms", _one_call)
    before = dict(_build.LAUNCHES)
    r = mspmm.main(["--device", "cpu"])
    assert _build.LAUNCHES == before
    assert set(r["ms"]) == {p[0] for p in mspmm.PARTS}
    assert r["segment_equals_spmm"] and r["device"] == "cpu"
    assert 0 <= r["cumsum_max_err"] < 1e-4
    assert 0 <= r["host_f32_cumsum_err"] < 1e-4
    assert r["gathered_mb"] == r["nnz"] * mspmm.D * 4 / 1e6
    assert "equal to _segment_spmm: True" in capsys.readouterr().out


def test_tools_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    for main in (mtopk.main, mspmm.main):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main([])
