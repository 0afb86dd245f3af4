"""The port's tuning (``igcn_cf_tpu_torch.tuning``) and its ``tune``
subcommand against the JAX package: the grids, the grouping and routing of
every grid point, the three population losses and one Adam step of three
trials on the JAX package's draws, and, in the port, the population search
equal to the sequential one bit for bit."""

import re

import jax
import numpy as np
import pytest
import torch

import igcn_cf_tpu.kernels.bitpack as jbp
import igcn_cf_tpu.tuning.grid as jgrid
import igcn_cf_tpu.tuning.population as jpop
from igcn_cf_tpu.configs import get_config as jax_get_config
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu_torch.cli import main as cli
from igcn_cf_tpu_torch.configs import get_config
from igcn_cf_tpu_torch.convert import (
    adam_state_from_jax,
    flatten_tree,
    params_from_jax,
    split_population,
)
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.kernels.dense_graph import FeatDrop
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.models.idcf import IDCFDraw
from igcn_cf_tpu_torch.train.trainer import OPTIMIZERS
from igcn_cf_tpu_torch.tuning import grid, population
from torch_threads import one_thread  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_REL = 4e-3  # as tests/test_torch_train.py: one step's gradients
PRESETS = [(name, i) for name, n in (("gowalla", 10), ("yelp", 10), ("amazon", 8))
           for i in range(n)]


def _t(x):
    return torch.as_tensor(np.array(x))


# -- grids, keys and routing ------------------------------------------------------


def test_grids_and_keys_equal_jax():
    assert grid.GRIDS == jgrid.GRIDS
    assert grid._MODEL_KEYS == jgrid._MODEL_KEYS
    assert population.TRACED_KEYS == jpop.TRACED_KEYS
    for g in grid.GRIDS.values():
        assert list(grid.parameter_grid(g)) == list(jgrid.parameter_grid(g))
    # sklearn.ParameterGrid order: sorted keys, the last fastest
    assert list(grid.parameter_grid({"b": [1, 2], "a": [3, 4]})) == [
        {"a": 3, "b": 1}, {"a": 3, "b": 2}, {"a": 4, "b": 1}, {"a": 4, "b": 2}]


@pytest.mark.parametrize("preset", PRESETS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_population_profitable_equals_jax(preset):
    _, mc, tc = get_config(*preset)
    assert (grid._population_profitable(tc["name"], grid.GRIDS[mc["name"]])
            == jgrid._population_profitable(tc["name"], jgrid.GRIDS[mc["name"]]))


class _Recorder:
    """Stands in for the dataset loader, the model factory and the trainers
    of a search module, recording the configs and trials each gets."""

    def __init__(self):
        self.calls = []

    def patch(self, monkeypatch, module, population_trainer=False):
        monkeypatch.setattr(module, "get_dataset", lambda dc: ("ds", dc["path"]))
        monkeypatch.setattr(module, "get_model",
                            lambda mc, ds, *device: ("model", dict(mc)))
        recorder = self

        if population_trainer:
            class Trainer:
                def __init__(self, tc, dataset, model, trials, **_):
                    recorder.calls.append((model[1], dict(tc), list(trials)))
                    self.n = len(trials)

                def train(self, verbose=True):
                    return 0.1 + 0.01 * np.arange(self.n)

            monkeypatch.setattr(module, "PopulationTrainer", Trainer)
        else:
            class Trainer:
                def __init__(self, tc, model):
                    recorder.calls.append((model[1], dict(tc)))

                def train(self, verbose=True):
                    return 0.1 + 0.01 * len(recorder.calls)

            monkeypatch.setattr(module, "get_trainer",
                                lambda tc, ds, model: Trainer(tc, model))


@pytest.mark.parametrize("name", sorted(grid.GRIDS))
def test_grouping_and_routing_equal_jax(name, monkeypatch, capsys):
    """Each grid point's model and trainer configs, the groups of the
    population search and their trials, in order, and the printed lines,
    as the JAX package's."""
    index = next(i for i in range(10)
                 if get_config("gowalla", i)[1]["name"] == name)
    dc, mc, tc = get_config("gowalla", index, "data/x")
    g = grid.GRIDS[name]
    outs = []
    for seq_mod, pop_mod in ((jgrid, jpop), (grid, population)):
        seq, pop = _Recorder(), _Recorder()
        seq.patch(monkeypatch, seq_mod)
        pop.patch(monkeypatch, pop_mod, population_trainer=True)
        result_seq = seq_mod.grid_search(dc, mc, tc, g, verbose=False)
        result_pop = pop_mod.population_grid_search(dc, mc, tc, g)
        outs.append((seq.calls, pop.calls, result_seq, result_pop,
                     capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == len(list(grid.parameter_grid(g)))


# -- the population losses on the JAX package's draws ----------------------------


LGCN = {"name": "LightGCN", "embedding_size": 8, "n_layers": 2,
        "prop_cache": False, "graph_backend": "dense"}
IGCN = {"name": "IGCN", "embedding_size": 8, "n_layers": 2, "dropout": 0.3,
        "feature_ratio": 1.0, "prop_cache": False, "graph_backend": "dense"}
IDCF = {"name": "IDCF_LGCN", "embedding_size": 8, "n_layers": 2,
        "n_headers": 2, "n_samples": 10}
BASE = {"optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-3, "n_epochs": 1,
        "batch_size": 64, "topks": [10], "seed": 2021}
LOSS_CASES = {
    "BPRTrainer": (LGCN, dict(BASE, name="BPRTrainer"),
                   [{"lr": 1e-3, "l2_reg": 0.0}, {"lr": 1e-2, "l2_reg": 1e-3},
                    {"lr": 3e-3, "l2_reg": 1e-1}]),
    "IGCNTrainer": (IGCN, dict(BASE, name="IGCNTrainer", aux_reg=0.01),
                    [{"lr": 1e-3, "l2_reg": 0.0, "aux_reg": 1e-2},
                     {"lr": 1e-2, "l2_reg": 1e-3, "aux_reg": 1e-1},
                     {"lr": 3e-3, "l2_reg": 1e-1, "aux_reg": 1e-3}]),
    "IDCFTrainer": (IDCF, dict(BASE, name="IDCFTrainer", contrastive_reg=1e-3),
                    [{"lr": 1e-3, "l2_reg": 0.0, "contrastive_reg": 1e-4},
                     {"lr": 1e-2, "l2_reg": 1e-4, "contrastive_reg": 1e-2},
                     {"lr": 3e-3, "l2_reg": 1e-3, "contrastive_reg": 1e-1}]),
}


@pytest.fixture(scope="module")
def port_tiny():
    return synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)


@pytest.fixture(scope="module")
def lgcn_path(tiny_ds, tmp_path_factory):
    """A JAX LightGCN checkpoint over the tiny dataset: IDCF's frozen
    table."""
    jm = jax_get_model({"name": "LightGCN", "embedding_size": 8,
                        "n_layers": 2}, tiny_ds)
    path = str(tmp_path_factory.mktemp("lgcn") / "lgcn.pkl")
    jm.save(path, jm.init_params(jax.random.PRNGKey(9)))
    return path


def _jax_inputs(name, jp, key):
    """The step's inputs in the port's form (the trainer's ``sample_step``)
    from the JAX population loss's draws of ``key`` (population.py:61-107,
    bpr.py, dense_graph.py:285-288, idcf.py:146-150), and (k_batch,
    k_drop)."""
    k_batch, k_drop = jax.random.split(key)
    main = jp.samplers["main"]
    model = jp.model
    if name == "IGCNTrainer":
        k_main, k_aux = jax.random.split(k_batch)
    else:
        k_main = k_batch
    users, pos, negs = main.sample(k_main, jp.batch_size)
    batch = tuple(_t(x).long() for x in (users, pos, negs[:, 0]))
    if name == "BPRTrainer":
        return (batch, None), (k_batch, k_drop)
    if name == "IDCFTrainer":
        su, si = [], []
        k = k_drop
        for _ in range(model.n_headers):
            k, ku, ki = jax.random.split(k, 3)
            su.append(_t(jax.random.randint(ku, (model.n_samples,), 0,
                                            model.n_old_users)).long())
            si.append(_t(jax.random.randint(ki, (model.n_samples,), 0,
                                            model.n_old_items)).long())
        return (batch, IDCFDraw(su, si)), (k_batch, k_drop)
    a_users, a_pos, a_negs = jp.samplers["aux"].sample(k_aux, jp.batch_size)
    aux = tuple(_t(x).long() for x in (a_users, a_pos, a_negs[:, 0]))
    k_b, k_bt, k_tu, k_ti = jax.random.split(k_drop, 4)
    p = model.dropout
    drop = FeatDrop(
        int(jbp._seed_from_key(k_b)), int(jbp._seed_from_key(k_bt)),
        _t(jax.random.bernoulli(k_tu, 1.0 - p, (model.n_users, 1))[:, 0]),
        _t(jax.random.bernoulli(k_ti, 1.0 - p, (model.n_items, 1))[:, 0]))
    return (batch, aux, drop), (k_batch, k_drop)


def _jax_step(jp, params, opt_state, keys):
    """The population step of population.py:199-211, vmapped over trials:
    per-trial losses and gradients, then scale_by_adam and each trial's
    lr."""
    loss, grads = jax.vmap(jax.value_and_grad(jp._loss),
                           in_axes=(0, None, 0, None, None))(
        params, jp.buffers, jp.hyper, *keys)
    direction, opt_state = jax.vmap(jp.opt.update)(grads, opt_state, params)
    params = jax.tree_util.tree_map(
        lambda p, d: p - jp.hyper["lr"].reshape((-1,) + (1,) * (p.ndim - 1)) * d,
        params, direction)
    return loss, grads, params, opt_state


def _assert_grads_close(got, want):
    """Each gradient within GRAD_REL of its largest magnitude (floored at
    1e-5 of the step's largest: IDCF's wk biases have a zero true
    gradient)."""
    floor = 1e-5 * max(np.abs(np.array(w)).max() for w in want.values())
    for name in want:
        g, w = got[name].numpy(), np.array(want[name])
        scale = max(np.abs(w).max(), floor, 1e-30)
        np.testing.assert_allclose(g / scale, w / scale, atol=GRAD_REL,
                                   err_msg=name)


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_population_loss_and_adam_step_match_jax(name, tiny_ds, port_tiny,
                                                 lgcn_path):
    """Three trials with their own scalars: after one JAX population step,
    the stacked params and Adam state split into the port's trials; then a
    second step's per-trial loss, gradients and updated params on the same
    draws."""
    model_cfg, tc, trials = LOSS_CASES[name]
    if model_cfg["name"] == "IDCF_LGCN":
        model_cfg = dict(model_cfg, lgcn_path=lgcn_path)
    jm = jax_get_model(dict(model_cfg), tiny_ds)
    jp = jpop.PopulationTrainer(dict(tc), tiny_ds, jm, trials)
    _, _, params, opt_state = _jax_step(
        jp, jp.params, jp.opt_state, _jax_inputs(name, jp, jax.random.PRNGKey(3))[1])
    inputs, keys = _jax_inputs(name, jp, jax.random.PRNGKey(4))
    jloss, jgrads, jparams, _ = _jax_step(jp, params, opt_state, keys)

    pm = get_model(dict(model_cfg), port_tiny, device="cpu")
    buffers = pm.init_buffers()
    loss_fn = population._make_population_loss(name, pm)
    hyper = population.trial_hyper(tc, trials)
    split = split_population(params, opt_state, len(trials))
    for t, (tree, adam) in enumerate(split):
        p = params_from_jax(tree, "cpu")
        flat = flatten_tree(p)
        for v in flat.values():
            v.requires_grad_()
        opt = OPTIMIZERS["Adam"](list(flat.values()), hyper[t]["lr"])
        adam_state_from_jax(adam, p, opt)
        loss = loss_fn(p, buffers, hyper[t], *inputs)
        grads = torch.autograd.grad(loss, list(flat.values()))
        want = float(jloss[t])
        assert abs(float(loss.detach()) - want) <= LOSS_RTOL * abs(want), t
        _assert_grads_close(dict(zip(flat, grads)),
                            {k: v[t] for k, v in flatten_tree(jgrads).items()})
        loss = loss_fn(p, buffers, hyper[t], *inputs)
        loss.backward()
        opt.step()
        for k, v in flatten_tree(jparams).items():
            np.testing.assert_allclose(flat[k].detach().numpy(), np.array(v[t]),
                                       atol=2 * hyper[t]["lr"], err_msg=k)


def test_split_population_round_trips(rng):
    stacked = {"a": rng.standard_normal((3, 4, 2)).astype(np.float32),
               "b": [{"w": rng.standard_normal((3, 5)).astype(np.float32)}]}
    state = {"count": np.array([2, 2, 2], np.int32), "mu": stacked,
             "nu": jax.tree_util.tree_map(np.abs, stacked)}
    out = split_population(stacked, state, 3)
    assert len(out) == 3
    for t, (tree, adam) in enumerate(out):
        np.testing.assert_array_equal(tree["a"], stacked["a"][t])
        np.testing.assert_array_equal(tree["b"][0]["w"], stacked["b"][0]["w"][t])
        assert int(adam["count"]) == 2
        np.testing.assert_array_equal(adam["nu"]["a"], np.abs(stacked["a"][t]))


# -- in the port: population == sequential, bit for bit --------------------------


MF = {"name": "MF", "embedding_size": 8}
MF_TRAINER = {"name": "BPRTrainer", "optimizer": "Adam", "batch_size": 64,
              "test_batch_size": 32, "topks": [5], "n_epochs": 3,
              "val_interval": 1}
MF_GRID = {"lr": [1e-2, 1e-3], "l2_reg": [0.0, 1e-3]}
IGCN_SEARCH = {"name": "IGCN", "embedding_size": 8, "n_layers": 2,
               "feature_ratio": 1.0, "graph_backend": "dense"}
IGCN_TRAINER = dict(MF_TRAINER, name="IGCNTrainer", n_epochs=2, batch_size=128,
                    max_patience=1)
IGCN_GRID = {"lr": [1e-2], "l2_reg": [0.0, 1e-3], "dropout": [0.0, 0.3],
             "aux_reg": [1e-3, 1e-1]}
SEARCHES = {
    "MF": (MF, MF_TRAINER, MF_GRID),
    "IGCN cache": (dict(IGCN_SEARCH, prop_cache=True), IGCN_TRAINER, IGCN_GRID),
    "IGCN recompute": (dict(IGCN_SEARCH, prop_cache=False), IGCN_TRAINER,
                       IGCN_GRID),
}


@pytest.fixture(scope="module")
def grid_ds(tmp_path_factory):
    """tests/test_tuning.py's catalog, written as a processed split."""
    ds = synthetic_interactions(n_users=40, n_items=50, avg_degree=8, seed=11)
    path = tmp_path_factory.mktemp("grid_ds") / "ds"
    ds.output(str(path))
    return str(path)


@pytest.mark.parametrize("search", list(SEARCHES))
def test_population_equals_sequential(search, grid_ds, tmp_path, monkeypatch):
    """Each trial's per-epoch losses and best val NDCG, and the best
    params, equal in both searches."""
    monkeypatch.chdir(tmp_path)
    model_cfg, trainer_cfg, g = SEARCHES[search]
    seq_trainers, pops = [], []
    get_trainer = grid.get_trainer
    monkeypatch.setattr(grid, "get_trainer", lambda *a: seq_trainers.append(
        get_trainer(*a)) or seq_trainers[-1])

    class Recorded(population.PopulationTrainer):
        def __init__(self, *a):
            super().__init__(*a)
            pops.append(self)

    monkeypatch.setattr(population, "PopulationTrainer", Recorded)
    dc = {"name": "ProcessedDataset", "path": grid_ds}
    seq = grid.grid_search(dc, model_cfg, dict(trainer_cfg), g, verbose=False,
                           device="cpu")
    pop = population.population_grid_search(dc, model_cfg, dict(trainer_cfg), g,
                                            verbose=False, device="cpu")
    assert pop == seq
    assert len(seq["trials"]) == len(list(grid.parameter_grid(g)))
    # per-epoch losses: the population's trials in group order
    pop_losses = [[h["losses"][t] for h in p.history]
                  for p in pops for t in range(p.n_trials)]
    combos = list(grid.parameter_grid(g))
    order = sorted(range(len(combos)), key=lambda i: tuple(
        (k, v) for k, v in sorted(combos[i].items())
        if k not in population.TRACED_KEYS))
    seq_losses = [[h["loss"] for h in seq_trainers[i].history] for i in order]
    for got, want in zip(pop_losses, seq_losses):
        np.testing.assert_array_equal(np.array(got[: len(want)]), np.array(want))
        assert np.isnan(got[len(want):]).all()  # stopped trials train no more


# -- the tune subcommand -------------------------------------------------------------


def test_tune_prints_jax_lines_and_routes(grid_ds, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    base = ["tune", "--dataset", "gowalla", "--config", "0", "--data-path",
            grid_ds, "--n-epochs", "1", "--device", "cpu"]
    outs = {}
    for flag in ("auto", "--population", "--sequential"):
        cli.main(base + ([] if flag == "auto" else [flag]))
        outs[flag] = capsys.readouterr().out
    mf_points = list(grid.parameter_grid(grid.GRIDS["MF"]))
    for flag, out in outs.items():
        lines = [line for line in out.splitlines() if line.startswith("NDCG: ")]
        assert [line.split("Parameters: ")[1] for line in lines] == [
            str(p) for p in mf_points]
        assert all(re.match(r"^NDCG: \d+\.\d{3}, Parameters: \{", line)
                   for line in lines)
        assert re.search(r"^Maximum NDCG: \d+\.\d{3}, Best Parameters: \{",
                         out, re.M)
        assert "Maximum NDCG!" in out
    # auto takes the population for MF's 9 traced points
    for flag in ("auto", "--population"):
        assert re.search(r"^Epoch 0/1, losses: \[[\d. \n]+\], 9/9 trials alive$",
                         outs[flag], re.M)
    assert re.search(r"^Epoch 0/1, Loss: \d+\.\d{6}, Time: ", outs["--sequential"],
                     re.M)
    assert outs["auto"] == outs["--population"]
    # the searches agree to the printed digits
    ndcg = {f: [line for line in o.splitlines() if line.startswith("NDCG")]
            for f, o in outs.items()}
    assert ndcg["auto"] == ndcg["--sequential"]

    # auto routes a non-BPR trainer (MultiVAE) to the sequential search
    called = []
    monkeypatch.setattr(grid, "grid_search",
                        lambda *a, **k: called.append(("sequential", a[3], k)))
    monkeypatch.setattr(population, "population_grid_search",
                        lambda *a, **k: called.append(("population", a[3], k)))
    cli.main(["tune", "--config", "5", "--data-path", grid_ds, "--device", "cpu",
              "--seed", "7", "--n-epochs", "2"])
    cli.main(["tune", "--config", "2", "--data-path", grid_ds, "--device", "cpu"])
    assert [(c[0], c[1]) for c in called] == [
        ("sequential", grid.GRIDS["MultiVAE"]), ("population", grid.GRIDS["IGCN"])]
    assert called[0][2] == {"seed": 7, "device": torch.device("cpu")}


def test_tune_preset_passes_epochs_and_seed(monkeypatch):
    seen = []
    monkeypatch.setattr(grid, "grid_search",
                        lambda dc, mc, tc, g, **k: seen.append((dc, tc, k)))
    grid.tune_preset("gowalla", 0, data_path="p", seed=5, population=False,
                     device="cpu", n_epochs=3)
    dc, tc, k = seen[0]
    assert dc["path"] == "p" and tc["n_epochs"] == 3 and k == {
        "seed": 5, "device": "cpu"}
    want = jax_get_config("gowalla", 0, "p")[2]
    assert dict(tc, n_epochs=want["n_epochs"]) == want


def test_tune_raises_without_a_card(grid_ds):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["tune", "--data-path", grid_ds, "--n-epochs", "1"])
