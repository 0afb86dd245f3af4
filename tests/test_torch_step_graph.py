"""BPRTrainer's step replayed as one CUDA graph (``train/step_graph.py``).

On the CPU: which step inputs a graph may take, that a CPU trainer never
captures and trains as the eager loop does, and the benchmark's readers of
the replay count. On the card (each test skips without one): two graphed
epochs against two eager ones from the same weights and draws, for
LightGCN on both dense engines and for MF; each other model ``get_trainer``
trains engages or stays eager as its inputs say, and matches its eager
epoch; a host sync in the loss falls back; a resumed trainer captures
again.

This file imports neither jax nor igcn_cf_tpu, so it also runs where only
the port is installed:

    python -m pytest --noconftest tests/test_torch_step_graph.py -q -s
"""

import sys
from collections import Counter

import pytest
import torch

from benchmark.run import Reading, reader
from benchmark.trace import family
from igcn_cf_tpu_torch import utils
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.kernels.dense_graph import FeatDrop
from igcn_cf_tpu_torch.kernels.sparse import EdgeKeep
from igcn_cf_tpu_torch.models.base import get_model
from igcn_cf_tpu_torch.models.ngcf import NGCFDrop
from igcn_cf_tpu_torch.train import step_graph
from igcn_cf_tpu_torch.train.bpr import _StepTrainer
from igcn_cf_tpu_torch.train.trainer import get_trainer
from igcn_cf_tpu_torch.utils import spans

# graphed against eager: the same launches on the same inputs. The graph's
# Adam is ``capturable`` (its bias corrections in f32 on the device, not in
# f64 on the host): a few ulps a step, which Adam's normalisation makes
# O(lr) on entries whose gradients are near zero, so parameters and moments
# are held to the eager path with the same optimizer, and the losses also
# to the eager path with the plain one
GRAPH_RTOL = 1e-6

TRAINER_CFG = {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-3,
               "l2_reg": 1e-4, "n_epochs": 2, "batch_size": 256,
               "topks": [20], "seed": 3}
GRAPHED = {
    "lightgcn_cache": {"name": "LightGCN", "embedding_size": 64,
                       "n_layers": 2, "graph_backend": "dense",
                       "prop_cache": True},
    "lightgcn_recompute": {"name": "LightGCN", "embedding_size": 64,
                           "n_layers": 2, "graph_backend": "dense",
                           "prop_cache": False},
    "mf": {"name": "MF", "embedding_size": 64},
}


@pytest.fixture(autouse=True)
def fresh_spans():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ds():
    return synthetic_interactions(n_users=300, n_items=500, avg_degree=12,
                                  seed=5)


def _trainer(model_cfg, ds, device, **trainer_kw):
    cfg = dict(TRAINER_CFG, **trainer_kw)
    return get_trainer(cfg, ds, get_model(model_cfg, ds, device))


def _eager(trainer, capturable=False):
    """The trainer with the loop's eager step, as before the graph; with
    ``capturable``, its Adam made capturable before each step, as the
    graphed trainer's is."""

    def step(*inputs):
        if capturable:
            step_graph.make_capturable(trainer.opt)
        return _StepTrainer.train_step(trainer, *inputs)

    trainer.train_step = step
    return trainer


def _epochs(trainer, n):
    """Every step's loss over ``n`` epochs, on the host."""
    return torch.cat([(trainer.train_one_epoch(), trainer.step_losses)[1]
                      .cpu() for _ in range(n)])


def _counts():
    return {name: s["count"] for name, s in spans.snapshot()["spans"].items()}


def _on_card(run):
    """``run()``'s result and the port's kernels that ran on the card
    meanwhile, by family (``benchmark.trace.family``), from a profiler of
    the device: a graph's replayed kernels included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    kernels = Counter(family(e.name())
                      for e in prof.profiler.kineto_results.events()
                      if e.device_type() == DeviceType.CUDA)
    del kernels[None]  # PyTorch's own kernels, copies and fills
    return out, kernels


def _assert_close(got, want, rtol, what):
    scale = float(want.abs().max())
    gap = float((got.double() - want.double()).abs().max())
    assert gap <= rtol * max(scale, 1e-30), (what, gap, scale)


def _assert_state_close(a, b, rtol):
    for name, p in a.flat_params.items():
        q = b.flat_params[name]
        _assert_close(p.detach(), q.detach(), rtol, name)
        for key in ("exp_avg", "exp_avg_sq"):
            _assert_close(a.opt.state[p][key], b.opt.state[q][key], rtol,
                          f"{name} {key}")


# -- CPU: eligibility, the CPU path, the readers --------------------------------


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself as on a card: only what the
    eligibility walk reads."""

    @property
    def is_cuda(self):
        return True


def _dev(*shape, dtype=torch.int64):
    return torch.Tensor._make_subclass(_CudaLike, torch.zeros(shape,
                                                              dtype=dtype))


@pytest.mark.parametrize("case,ok", [
    ("bpr_batch", True),
    ("ngcf_sparse_draw", True),
    ("list_draw", True),
    ("host_seeds", False),
    ("cpu_tensor", False),
    ("python_float", False),
])
def test_graph_leaves_take_only_card_tensors_and_none(case, ok):
    batch = (_dev(8), _dev(8), _dev(8))
    inputs = {
        "bpr_batch": (batch, None),
        "ngcf_sparse_draw": (batch, NGCFDrop(EdgeKeep(_dev(30, dtype=torch.bool)),
                                             [_dev(4, 2, dtype=torch.bool)])),
        "list_draw": (batch, [_dev(5), _dev(5)]),
        # a dense dropout draw's u32 mask seeds, launch arguments of K8p
        "host_seeds": (batch, FeatDrop(7, 8, _dev(3, dtype=torch.bool),
                                       _dev(4, dtype=torch.bool))),
        "cpu_tensor": ((torch.zeros(8), *batch[1:]), None),
        "python_float": (batch, 0.3),
    }[case]
    leaves = step_graph.graph_leaves(inputs)
    assert (leaves is not None) is ok
    if ok:
        flat = [batch[0], batch[1], batch[2]]
        assert all(a is b for a, b in zip(leaves, flat))


def test_a_changed_shape_or_dtype_changes_the_signature():
    base = step_graph.signature([_dev(8), None])
    assert step_graph.signature([_dev(8), None]) == base
    assert step_graph.signature([_dev(9), None]) != base
    assert step_graph.signature([_dev(8, dtype=torch.int32), None]) != base
    assert step_graph.signature([_dev(8), _dev(1)]) != base


def test_a_cpu_trainer_never_captures_and_trains_as_the_eager_loop(ds):
    torch.manual_seed(0)
    cfg = dict(GRAPHED["lightgcn_cache"], embedding_size=16)
    graphed = _trainer(cfg, ds, "cpu", n_epochs=1)
    eager = _eager(_trainer(cfg, ds, "cpu", n_epochs=1))
    spans.enable()
    got = _epochs(graphed, 1)
    counts = _counts()
    want = _epochs(eager, 1)
    assert torch.equal(got, want)
    for name, p in graphed.flat_params.items():
        assert torch.equal(p, eager.flat_params[name])
    assert "train.replay" not in counts
    assert "train.graph_fallback" not in counts
    assert counts["train.step"] == graphed.steps_per_epoch()
    sg = graphed.step_graph
    assert sg.graph is None and sg.sig is None and sg.fallback is None
    assert not any(g["capturable"] for g in graphed.opt.param_groups)


def _snapshot(monkeypatch, steps, replays):
    got = {"train.step": {"count": steps, "total_ms": 1.0, "self_ms": 1.0}}
    if replays:
        got["train.replay"] = {"count": replays, "total_ms": 1.0,
                               "self_ms": 1.0}
    monkeypatch.setattr(spans, "snapshot",
                        lambda: {"spans": got, "launches": {}})


@pytest.mark.parametrize("name", ["graph_step_share", "graph_step_share.dev"])
@pytest.mark.parametrize("steps,replays,want", [
    (690, 690, 1.0),      # every traced step replayed
    (690, 0, 0.0),        # an eager trainer
    (690, 345, 0.5),
    (689, 690, None),     # the spans saw another number of steps
])
def test_the_replay_readers_read_a_snapshot(name, steps, replays, want,
                                             monkeypatch):
    _snapshot(monkeypatch, steps, replays)
    assert reader(name)(Reading(None, {"steps": 690}, {}, None)) == want


@pytest.mark.parametrize("name", ["graph_step_share", "graph_step_share.dev"])
def test_the_replay_readers_read_none_without_spans_or_steps(name,
                                                             monkeypatch):
    _snapshot(monkeypatch, 690, 690)
    assert reader(name)(Reading(None, {}, {}, None)) is None
    # a program without the spans module (the parent of the spans)
    monkeypatch.setitem(sys.modules, "igcn_cf_tpu_torch.utils.spans", None)
    monkeypatch.delattr(utils, "spans")
    assert reader(name)(Reading(None, {"steps": 690}, {}, None)) is None


# -- on the card ------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(GRAPHED))
def test_graphed_epochs_match_eager_ones(cuda, ds, model):
    """Two epochs replayed from the graph against two eager ones from the
    same weights and generator state: every step's loss, the parameters and
    Adam's moments; every step but the first replays. Both paths run the
    port's kernels on the card as often, by name in a device profile; the
    launch wrappers are called by the eager path every step, by the graphed
    one twice in all (its eager first step and the capture)."""
    cfg = GRAPHED[model]
    graphed = _trainer(cfg, ds, cuda)
    eager = _eager(_trainer(cfg, ds, cuda), capturable=True)
    plain = _eager(_trainer(cfg, ds, cuda))
    steps = 2 * graphed.steps_per_epoch()
    before = dict(_build.LAUNCHES)
    spans.enable()
    got, graphed_kernels = _on_card(lambda: _epochs(graphed, 2))
    counts = _counts()
    spans.disable()
    graphed_launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
    before = dict(_build.LAUNCHES)
    want, eager_kernels = _on_card(lambda: _epochs(eager, 2))
    eager_launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
    assert counts["train.replay"] == steps - 1
    assert "train.graph_fallback" not in counts
    assert graphed.step_graph.graph is not None
    assert graphed_kernels == eager_kernels
    assert all(n % steps == 0 for n in eager_launches.values())
    assert graphed_launches == {k: 2 * n // steps
                                for k, n in eager_launches.items()}
    # the recompute engine's products run the t1/t2 bodies (K1/K2 by name)
    assert set(graphed_kernels) == {"lightgcn_cache": {"K3", "K4"},
                                    "lightgcn_recompute": {"K1", "K2"},
                                    "mf": set()}[model]
    if model == "lightgcn_cache":
        assert graphed_kernels["K3"] == graphed_kernels["K4"] == steps
        assert eager_launches["K3"] == eager_launches["K4"] == steps
    _assert_close(got, want, GRAPH_RTOL, "step losses")
    _assert_state_close(graphed, eager, GRAPH_RTOL)
    _assert_close(got, _epochs(plain, 2), GRAPH_RTOL, "plain Adam's losses")


# (model, trainer settings, what its trainer does with the graph): the dense
# NGCF's draw carries host mask seeds, IGCNTrainer's step is its own
ZOO = {
    "lightgcn_sparse": ({"name": "LightGCN", "embedding_size": 64,
                         "n_layers": 2, "graph_backend": "sparse"}, {},
                        "engaged"),
    "ngcf_dense": ({"name": "NGCF", "embedding_size": 64,
                    "layer_sizes": [64, 64], "dropout": 0.1,
                    "graph_backend": "dense"}, {}, "eager"),
    "ngcf_sparse": ({"name": "NGCF", "embedding_size": 64,
                     "layer_sizes": [64, 64], "dropout": 0.1,
                     "graph_backend": "sparse"}, {}, "engaged"),
    "imcgae": ({"name": "IMCGAE", "embedding_size": 64, "n_layers": 2,
                "dropout": 0.3}, {}, "engaged"),
    "idcf": ({"name": "IDCF_LGCN", "embedding_size": 64, "n_layers": 2,
              "n_headers": 2, "n_samples": 10, "lgcn_path": "lgcn.pkl",
              "lgcn_pretrain_epochs": 1},
             {"name": "IDCFTrainer", "contrastive_reg": 1e-3}, "engaged"),
    "igcn": ({"name": "IGCN", "embedding_size": 64, "n_layers": 2,
              "dropout": 0.3, "feature_ratio": 1.0, "graph_backend": "dense",
              "prop_cache": True},
             {"name": "IGCNTrainer", "aux_reg": 0.01}, "eager"),
}


@pytest.mark.parametrize("model", sorted(ZOO))
def test_every_trainer_engages_or_stays_eager(cuda, ds, model,
                                                         tmp_path,
                                                         monkeypatch):
    """One epoch of each other model ``get_trainer`` trains, against the
    same epoch on the eager path: it replays every step but the first, or
    never tries (inputs with host mask seeds; IGCNTrainer's own steps);
    either way its losses and state match the eager epoch's. The outcome is
    printed for the card run's log."""
    monkeypatch.chdir(tmp_path)  # IDCF's LightGCN checkpoint
    model_cfg, trainer_kw, expected = ZOO[model]
    graphed = _trainer(model_cfg, ds, cuda, n_epochs=1, **trainer_kw)
    steps = graphed.steps_per_epoch()
    spans.enable()
    got = _epochs(graphed, 1)
    torch.cuda.synchronize()
    counts = _counts()
    spans.disable()
    replays = counts.get("train.replay", 0)
    fallbacks = counts.get("train.graph_fallback", 0)
    # Adam as the graphed trainer ran it: capturable once the graph engaged
    eager = _eager(_trainer(model_cfg, ds, cuda, n_epochs=1, **trainer_kw),
                   capturable=bool(replays or fallbacks))
    want = _epochs(eager, 1)
    sg = getattr(graphed, "step_graph", None)
    outcome = ("engaged" if replays else "fell back" if fallbacks
               else "eager")
    print(f"# step graph {model}: {outcome}; {replays} replays, {fallbacks} "
          f"fallbacks of {steps} steps"
          + (f"; {sg.fallback.splitlines()[0]}" if sg and sg.fallback
             else ""))
    assert (replays, fallbacks) == {"engaged": (steps - 1, 0),
                                    "eager": (0, 0)}[expected]
    _assert_close(got, want, GRAPH_RTOL, "step losses")
    _assert_state_close(graphed, eager, GRAPH_RTOL)


def test_a_host_sync_in_the_loss_falls_back_and_trains_on(cuda, ds):
    """A loss that reads a number back cannot be captured: the trainer
    drops the graph, counts the fallback once and trains eagerly."""

    def synced(trainer):
        loss = trainer.loss

        def read_back(params, *args):
            out = loss(params, *args)
            float(out)
            return out

        trainer.loss = read_back
        return trainer

    cfg = GRAPHED["lightgcn_cache"]
    graphed = synced(_trainer(cfg, ds, cuda))
    eager = _eager(synced(_trainer(cfg, ds, cuda)), capturable=True)
    spans.enable()
    got = _epochs(graphed, 2)
    torch.cuda.synchronize()
    counts = _counts()
    spans.disable()
    want = _epochs(eager, 2)
    assert counts["train.graph_fallback"] == 1
    assert "train.replay" not in counts
    assert graphed.step_graph.fallback and graphed.step_graph.graph is None
    _assert_close(got, want, GRAPH_RTOL, "step losses")
    _assert_state_close(graphed, eager, GRAPH_RTOL)


def test_a_resumed_trainer_captures_again_and_matches_eager(cuda, ds,
                                                            tmp_path):
    """``load_state`` puts new Adam state in: the graph made for the old
    state is dropped, the next step runs eagerly and the one after captures
    again; the resumed epochs match the eager trainer's."""
    cfg = GRAPHED["lightgcn_cache"]
    graphed = _trainer(cfg, ds, cuda, n_epochs=3)
    eager = _eager(_trainer(cfg, ds, cuda, n_epochs=3), capturable=True)
    steps = graphed.steps_per_epoch()
    spans.enable()
    got = []
    for t, tag in ((graphed, "g"), (eager, "e")):
        losses = [_epochs(t, 1)]
        path = str(tmp_path / f"{tag}.pkl")
        t.save_state(path)
        losses.append(_epochs(t, 1))
        t.load_state(path)
        losses.append(_epochs(t, 1))
        got.append(torch.cat(losses))
        if t is graphed:
            torch.cuda.synchronize()
            counts = _counts()
            spans.disable()
    assert counts["train.replay"] == 3 * steps - 2
    assert "train.graph_fallback" not in counts
    _assert_close(got[0], got[1], GRAPH_RTOL, "step losses")
    _assert_state_close(graphed, eager, GRAPH_RTOL)
