"""The port's measuring tools, the sharded tools and the dry run, on the CPU
at toy sizes, against the JAX package where both compute the same thing:
``entry()``'s forward against ``__graft_entry__.entry()``'s,
``dryrun_multichip(4)``, ``scaling_harness`` and ``sharded_midscale`` in
one gloo world of 4 (their shapes, records and bounds against the JAX
tools'), the Amazon projection's geometry against JAX
``parallel/pcache.shard_slab_width``, ``microbench_retrieval``'s exclusion
words against JAX ``pack_exclusion_words`` and its block-0 check on the
plain K5, and the serving and eval tools' records."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch_mesh_workers as W

import __graft_entry__ as graft
import igcn_cf_tpu.models.inmo as jinmo
from igcn_cf_tpu.kernels.retrieval import (
    pack_exclusion_words as jax_pack_exclusion_words,
)
from igcn_cf_tpu.parallel.pcache import shard_slab_width as jax_shard_slab_width
from igcn_cf_tpu_torch import dryrun
from igcn_cf_tpu_torch.convert import params_from_jax
from igcn_cf_tpu_torch.core.mesh import spawn_world
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.kernels.bitpack import pad_to
from igcn_cf_tpu_torch.kernels.retrieval import LI
from igcn_cf_tpu_torch.tools import amazon_sharded_projection as asp
from igcn_cf_tpu_torch.tools import bench_eval, bench_serve, bench_serve_grown
from igcn_cf_tpu_torch.tools import microbench_retrieval as mr
from igcn_cf_tpu_torch.tools import scaling_harness, serve_grown_phase
from igcn_cf_tpu_torch.tools import sharded_midscale
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# tests/test_torch_serve.py's IGCN representation tolerance against JAX:
# each layer rounds its input to bf16, and another order of f32 sums can
# move an element by one bf16 step
REP_TOL = dict(rtol=2e-3, atol=1e-5)


def _one_call(fn, **kw):  # no device clock on the CPU: run once, time 1
    fn()
    return 1.0


@pytest.fixture(scope="module")
def small():
    return synthetic_interactions(n_users=120, n_items=150, avg_degree=10,
                                  seed=3)


# -- entry() and the dry run ------------------------------------------------------


def test_entry_forward_matches_graft_entry(monkeypatch):
    """The full-catalog scoring forward of ``entry()`` on the JAX params
    (converted) equals ``__graft_entry__.entry()``'s, within REP_TOL of
    the scores (the representation test's tolerance, stated above). Both
    run the bit-packed dense backend: the port's 'auto' takes it where B
    fits, the JAX package's on a TPU, so its CPU 'auto' is pointed there
    (tests/test_torch_serve.py compares the two dense backends too)."""
    choose = jinmo.choose_backend
    monkeypatch.setattr(jinmo, "choose_backend", lambda n_users, n_items, req="auto":
                        choose(n_users, n_items, "dense" if req == "auto" else req))
    jfn, (jparams, jbuffers, jusers) = graft.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jbuffers, jusers))
    fn, (params, buffers, users) = dryrun.entry("cpu")
    got = fn(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu"), buffers, users)
    assert got.shape == want.shape == (16, 64)
    np.testing.assert_allclose(got.numpy(), want, **REP_TOL)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One gloo world of 4: ``dryrun_multichip(4)``, then the scaling
    harness (the JAX tool's toy catalog cut to 200 x 300, 2 timed epochs)
    and the midscale tool (300 x 400, 2 steps), each rank's results."""
    run_dir = tmp_path_factory.mktemp("tools_world")
    spec = {"dir": str(run_dir),
            "scaling_catalog": dict(n_users=200, n_items=300, avg_degree=8,
                                    seed=5, name="scaling_cpu"),
            "scaling_batch": 128, "scaling_epochs": 2,
            "midscale_shape": "300x400", "midscale_steps": 2}
    return run_dir, spawn_world(W.tools_world_cases, 4, "gloo", str(run_dir),
                                spec)


def test_dryrun_multichip_four_ranks(world):
    _, ranks = world
    for r in ranks:
        d = r["dryrun"]
        assert d["mesh"] == (2, 2)
        for key in ("epoch_loss", "val_ndcg", "grown_test_ndcg", "sparse_loss",
                    "cache_loss", "dense_loss"):
            assert np.isfinite(d[key]), key
        np.testing.assert_array_equal(d["serving_ids"],
                                      ranks[0]["dryrun"]["serving_ids"])


def test_dryrun_multichip_one_rank_in_this_process():
    import torch.distributed as dist

    d = dryrun.dryrun_multichip(1, "cpu")
    assert d["mesh"] == (1, 1) and not dist.is_initialized()
    assert d["serving_ids"].shape == (48, 10)


def test_scaling_harness_shapes_and_record(world):
    run_dir, ranks = world
    jax_record = json.loads((ROOT / "SCALING.json").read_text())
    assert [f"{d}x{t}" for d, t in scaling_harness.shapes(8)] == list(
        jax_record["shapes"])
    record = json.loads((run_dir / "scaling.json").read_text())
    assert set(jax_record) <= set(record)
    assert list(record["shapes"]) == ["1x4", "2x2", "4x1"]
    entry_keys = set(next(iter(jax_record["shapes"].values())))
    for tag, entry in record["shapes"].items():
        assert entry_keys <= set(entry), tag
        assert entry["examples_per_s"] > 0 and entry["engine"] == "sparse"
    assert record["shapes"]["1x4"]["speedup_vs_first"] == 1.0
    assert set(record["workmodel"]) == set(jax_record["workmodel"])
    assert record["n_devices"] == 4 and record["platform"] == "cpu"
    assert all(list(r["scaling"]["shapes"]) == list(record["shapes"])
               for r in ranks)


def test_sharded_midscale_record_and_bounds(world):
    run_dir, ranks = world
    jax_record = json.loads((ROOT / "SHARDED_MIDSCALE.json").read_text())
    assert [sharded_midscale.N_USERS, sharded_midscale.N_ITEMS] == jax_record[
        "catalog"]
    assert (sharded_midscale.D, sharded_midscale.LAYERS,
            sharded_midscale.BATCH) == (jax_record["embedding_size"],
                                        jax_record["n_layers"],
                                        jax_record["batch_size"])
    record = json.loads((run_dir / "midscale.json").read_text())
    assert set(jax_record) <= set(record)
    assert record["mesh"] == {"data": 2, "table": 2} and record["world"] == 4
    assert record["cuts"] == {"shape": "300x400 of 26000x38000",
                              "steps": "2 of 5"}
    # the JAX tool's bounds, as the tool asserts them
    for cached, recompute in record["losses_cached_vs_recompute"]:
        assert abs(cached - recompute) <= 2e-2 + 2e-2 * abs(recompute)
    assert record["embedding_max_rel_dev"] < 6e-2
    # and chip_smoke's tighter limits, which a cache engine that propagates
    # nothing fails (its embeddings stay at their init: a ratio of 1)
    assert record["loss_max_rel_gap"] < 1e-4
    assert record["embedding_dev_over_move"] < 5e-2
    n = 700
    rps = -(-n // (2 * 8)) * 8
    assert record["stacked_pcache_shape"] == [2, n, jax_shard_slab_width(rps)]


# -- the Amazon projection ------------------------------------------------------------


def test_amazon_projection_geometry_equals_jax():
    """rows_per_shard, the slab's width and bytes at the Amazon shape as the
    JAX tool computes them (tools/amazon_sharded_projection.py:54-57)."""
    n = 52643 + 91599
    rps = -(-n // (8 * 8)) * 8
    geo = asp.geometry(52643, 91599)
    assert geo == {"n": n, "rows_per_shard": rps,
                   "width": jax_shard_slab_width(rps),
                   "slab_bytes": n * jax_shard_slab_width(rps) * 2}
    assert (geo["rows_per_shard"], geo["width"]) == (18032, 20480)
    assert geo["slab_bytes"] == 5_908_152_320
    assert asp.floor_ms(6144, 20480, 3.35e12) == pytest.approx(0.15024, abs=1e-5)


def test_amazon_projection_keeps_the_record(tmp_path, monkeypatch):
    out = tmp_path / "AMAZON_SCALE_TORCH.json"
    out.write_text((ROOT / "AMAZON_SCALE_TORCH.json").read_text())
    before = json.loads(out.read_text())
    for name, value in (("N_USERS", 120), ("N_ITEMS", 150), ("BATCH", 32)):
        monkeypatch.setattr(asp, name, value)
    monkeypatch.setattr(asp, "cuda_ms", _one_call)
    result = asp.main(["--out", str(out), "--device", "cpu"])
    after = json.loads(out.read_text())
    assert {k: v for k, v in after.items() if k != "sharded_projection"} == {
        k: v for k, v in before.items() if k != "sharded_projection"}
    assert after["sharded_projection"]["projected_step_ms"] == pytest.approx(
        1.0 + before["dense"]["step_ms"] / 8)
    assert result["max_abs_err"] == {"K3": 0.0, "K4": 0.0}


# -- retrieval, eval and serving -------------------------------------------------------


def test_microbench_retrieval_words_equal_jax():
    excl = mr.exclusion_lists(300, 5000)
    nip = pad_to(5000, LI)
    got = mr.pack_exclusion_words(excl, 300, 5000, nip)
    want = jax_pack_exclusion_words(excl, 300, 5000, nip)
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(want).view(np.uint32))
    assert all(5 <= len(x) < 60 and len(set(x)) == len(x) for x in excl)


def test_microbench_retrieval_block0_on_the_plain_k5(monkeypatch, capsys):
    monkeypatch.setattr(mr, "N_USERS", 600)
    monkeypatch.setattr(mr, "N_ITEMS", 5000)
    monkeypatch.setattr(mr, "cuda_ms", _one_call)
    before = dict(_build.LAUNCHES)
    r = mr.main(["--sweep", "--device", "cpu"])
    assert r["block0_exact"] and r["sweep"] == [] and r["device"] == "cpu"
    assert _build.LAUNCHES == before
    assert "block-0 exact match: True" in capsys.readouterr().out


def test_bench_eval_breakdown(small):
    r = bench_eval.measure(small, 2, "cpu")
    assert len(r["evals_ms"]) == 2 and r["catalog"] == [120, 150]
    assert all(r[k] > 0 for k in ("rep_ms", "recommend_ms", "metrics_ms"))


def test_bench_serve_merges_and_keeps_the_grown_probe(small, tmp_path,
                                                      monkeypatch):
    """A re-run of bench_serve rewrites its own keys and keeps the grown
    probe's; the record holds every key of the JAX tool's SERVE.json."""
    out = tmp_path / "SERVE_TORCH.json"
    monkeypatch.setattr(bench_serve, "load_catalog", lambda: small)
    monkeypatch.setattr(bench_serve, "REQUEST_SIZES", (16, 64))
    monkeypatch.setattr(serve_grown_phase, "REQUEST_USERS", 32)
    monkeypatch.setattr(serve_grown_phase, "cached_synthetic_interactions",
                        lambda path, **kw: small)

    def in_process(phase, args):  # the phase's main here, not a subprocess
        return serve_grown_phase.main([phase, args.backend, "--ckpt", args.ckpt,
                                       "--device", args.device])

    monkeypatch.setattr(bench_serve_grown, "run_phase", in_process)
    bench_serve.main(["dense", "--out", str(out), "--device", "cpu"])
    grown = bench_serve_grown.main(["--out", str(out), "--ckpt",
                                    str(tmp_path / "ckpt.pkl"), "--device",
                                    "cpu"])
    assert grown["grown_probe"]["reduced_catalog"] == [96, 120]
    result = bench_serve.main(["--out", str(out), "--device", "cpu"])
    record = json.loads(out.read_text())
    assert set(json.loads((ROOT / "SERVE.json").read_text())) <= set(record)
    assert record["graph_backend"] == "sparse" == result["graph_backend"]
    assert record["grown_probe"] == json.loads(json.dumps(grown["grown_probe"]))
    assert record["refresh_grown_first_s"] == grown["refresh_grown_first_s"]
    assert set(record["requests"]) == {"16", "64"}
    assert record["platform"] == "cpu"


def test_new_tools_raise_without_a_card(tmp_path):
    """Left to their default device, the new entry points raise where no
    card is visible, before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    for call in (lambda: mr.main([]), lambda: bench_eval.main([]),
                 lambda: bench_serve.main(["--out", str(tmp_path / "s.json")]),
                 lambda: bench_serve_grown.main(["--ckpt", str(tmp_path / "c")]),
                 lambda: serve_grown_phase.main(["warm"]),
                 lambda: scaling_harness.main([]), lambda: sharded_midscale.main([]),
                 lambda: asp.main([]), dryrun.entry,
                 lambda: dryrun.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
