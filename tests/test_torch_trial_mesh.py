"""The population search's trial mesh (``tune --trial-mesh``) against the
one-process population search and the JAX package's sharded population.

One gloo world of 2 ranks (``tests/torch_mesh_workers.trial_mesh_cases``)
runs every search over ``make_mesh(2, 1)``; the test process runs the same
searches without a mesh. Each trial's per-epoch losses and val NDCGs, its
best NDCG and the result (trial order, ``best_params``) must be the same
bits; three trials over two ranks cover the padding. The JAX package's
population over a 4-device data mesh (``tests/test_tuning.py``'s catalog,
config and grid) draws its own init and batches: fed those, the trial mesh
matches its NDCGs within that test's ``atol=2e-3``, with the same
``best_params``."""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch
import torch_mesh_workers as W

import igcn_cf_tpu.tuning.population as jpop
from igcn_cf_tpu.core.mesh import make_mesh as jax_make_mesh
from igcn_cf_tpu.core.prng import set_seed as jax_set_seed
from igcn_cf_tpu.data.dataset import get_dataset as jax_get_dataset
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu_torch.cli import main as cli
from igcn_cf_tpu_torch.core.mesh import spawn_world
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.tuning import grid
from torch_threads import one_thread  # noqa: F401

# tests/test_tuning.py:25-29
MF = {"name": "MF", "embedding_size": 8}
MF_TRAINER = {"name": "BPRTrainer", "optimizer": "Adam", "batch_size": 64,
              "test_batch_size": 32, "topks": [5], "n_epochs": 3,
              "val_interval": 1}
GRID = {"lr": [1e-2, 1e-3], "l2_reg": [0.0, 1e-3]}
JAX_NDCG_ATOL = 2e-3  # tests/test_tuning.py:46
# two groups of two IGCN trials (the sparse backend: the dense one's plain
# products are slow on the CPU), patience 1: a trial at lr 0.1 stops an
# epoch early, on both ranks alike
IGCN = {"name": "IGCN", "embedding_size": 8, "n_layers": 2,
        "feature_ratio": 1.0, "graph_backend": "sparse", "prop_cache": False}
IGCN_TRAINER = dict(MF_TRAINER, name="IGCNTrainer", n_epochs=3, batch_size=128,
                    max_patience=1)
IGCN_GRID = {"lr": [1e-2, 1e-1], "l2_reg": [0.0], "dropout": [0.0, 0.3],
             "aux_reg": [1e-1]}


@pytest.fixture(scope="module")
def grid_ds(tmp_path_factory):
    """tests/test_tuning.py's catalog, written as a processed split."""
    ds = synthetic_interactions(n_users=40, n_items=50, avg_degree=8, seed=11)
    path = tmp_path_factory.mktemp("grid_ds") / "ds"
    ds.output(str(path))
    return str(path)


def _jax_init_and_draws(dc, seed=2021):
    """The init and the step batches of the JAX package's population over
    ``GRID``: its PopulationTrainer built as ``population_grid_search``
    builds it (population.py:317-345), its epoch keys split into steps
    and each step's batch drawn as its BPR loss draws it (:55-61, :199-221).
    The batches in the port's step-input form (``sample_step``)."""
    jax_set_seed(seed)
    ds = jax_get_dataset(dc)
    model = jax_get_model(dict(MF), ds)
    trials = list(grid.parameter_grid(GRID))
    jp = jpop.PopulationTrainer(dict(MF_TRAINER), ds, model, trials)
    init = jax.tree_util.tree_map(lambda x: np.asarray(x[0]), jp.params)
    n_steps = max(1, -(-len(ds) // jp.batch_size))
    draws = []
    for _ in range(MF_TRAINER["n_epochs"]):
        for key in jax.random.split(jp.keys.next(), n_steps):
            k_batch, _ = jax.random.split(key)
            users, pos, negs = jp.samplers["main"].sample(k_batch, jp.batch_size)
            draws.append((tuple(torch.as_tensor(np.array(x)).long()
                                for x in (users, pos, negs[:, 0])), None))
    return init, draws


@pytest.fixture(scope="module")
def searches(grid_ds):
    dc = {"name": "ProcessedDataset", "path": grid_ds}
    init, draws = _jax_init_and_draws(dc)
    return {
        "mf": {"dc": dc, "model_config": MF, "trainer_config": MF_TRAINER,
               "grid": GRID},
        "padded": {"dc": dc, "model_config": MF, "trainer_config": MF_TRAINER,
                   "grid": {"lr": [1e-2, 1e-3, 3e-3], "l2_reg": [1e-3]}},
        "igcn": {"dc": dc, "model_config": IGCN, "trainer_config": IGCN_TRAINER,
                 "grid": IGCN_GRID},
        "jax draws": {"dc": dc, "model_config": MF,
                      "trainer_config": MF_TRAINER, "grid": GRID,
                      "init": init, "draws": draws},
    }


TUNE_ARGV = ["tune", "--dataset", "gowalla", "--config", "0", "--n-epochs", "1",
             "--device", "cpu"]


@pytest.fixture(scope="module")
def world(searches, grid_ds, tmp_path_factory):
    """Both ranks' results of ``trial_mesh_cases``: one world for every
    case."""
    run_dir = tmp_path_factory.mktemp("trial_mesh")
    spec = {"searches": searches, "dir": str(run_dir),
            "argv": TUNE_ARGV + ["--data-path", grid_ds, "--trial-mesh", "2"]}
    return spawn_world(W.trial_mesh_cases, 2, "gloo", str(run_dir), spec)


def _assert_same_groups(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("losses", "ndcgs"):
            assert len(g[key]) == len(w[key])
            for a, b in zip(g[key], w[key]):
                np.testing.assert_array_equal(a, b)  # NaN where both stopped
        np.testing.assert_array_equal(g["best"], w["best"])


@pytest.mark.parametrize("name", ["mf", "padded", "igcn", "jax draws"])
def test_trial_mesh_equals_one_process_population(name, searches, world,
                                                  tmp_path, monkeypatch):
    """Every rank returns the one-process search's result, and its groups'
    per-epoch losses, val NDCGs and bests, bit for bit."""
    monkeypatch.chdir(tmp_path)
    s = searches[name]
    want, want_groups = W.population_search(s, None, s.get("init"),
                                            s.get("draws"))
    for rank in world:
        got, groups = rank[name]
        assert got == want
        _assert_same_groups(groups, want_groups)
    if name == "igcn":  # patience 1: some trials stopped before the end
        assert any(np.isnan(g["losses"][-1]).any() for g in want_groups)


def test_trial_mesh_splits_padded_blocks(searches, world):
    """Three trials over two ranks: a pad slot fills rank 1's block,
    contiguous blocks of two; four split two and two."""
    assert [r["padded"][1][0]["local"] for r in world] == [[0, 1], [2, 3]]
    assert [r["mf"][1][0]["local"] for r in world] == [[0, 1], [2, 3]]
    assert len(world[0]["padded"][0]["trials"]) == 3


def test_trial_mesh_matches_jax_sharded_population(searches, world, tmp_path,
                                                   monkeypatch):
    """The JAX package's population over a 4-device data mesh, and the trial
    mesh of 2 ranks fed its init and batches: NDCGs within
    tests/test_tuning.py's atol, the same trial order and best_params."""
    monkeypatch.chdir(tmp_path)
    s = searches["jax draws"]
    mesh = jax_make_mesh(jax.devices()[:4], data=4, table=1)
    want = jpop.population_grid_search(s["dc"], MF, dict(MF_TRAINER), GRID,
                                       verbose=False, mesh=mesh)
    got = world[0]["jax draws"][0]
    assert [t["params"] for t in got["trials"]] == [t["params"]
                                                     for t in want["trials"]]
    np.testing.assert_allclose([t["ndcg"] for t in got["trials"]],
                               [t["ndcg"] for t in want["trials"]],
                               atol=JAX_NDCG_ATOL)
    assert got["best_params"] == want["best_params"]


def test_tune_trial_mesh_prints_the_one_process_lines(world, grid_ds, tmp_path,
                                                      monkeypatch):
    """``tune --trial-mesh 2`` (MF's 9 points over 2 ranks, one pad): rank 0
    prints what the one-process ``tune`` prints, rank 1 nothing."""
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(TUNE_ARGV + ["--data-path", grid_ds])
    assert world[0]["cli"] == buf.getvalue()
    assert "Maximum NDCG:" in world[0]["cli"]
    assert world[1]["cli"] == ""


def test_tune_trial_mesh_one_runs_in_this_process(grid_ds, tmp_path,
                                                  monkeypatch):
    """``--trial-mesh 1`` needs no launcher, prints the one-process lines
    and tears its group down; a mesh larger than the world raises naming
    torchrun; the sequential search takes no trial mesh."""
    import torch.distributed as dist

    monkeypatch.chdir(tmp_path)
    outs = []
    for extra in ([], ["--trial-mesh", "1"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(TUNE_ARGV + ["--data-path", grid_ds] + extra)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        cli.main(TUNE_ARGV + ["--data-path", grid_ds, "--trial-mesh", "2"])
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="tunes sequentially"):
        cli.main(TUNE_ARGV + ["--data-path", grid_ds, "--trial-mesh", "1",
                              "--sequential"])
    assert not dist.is_initialized()
