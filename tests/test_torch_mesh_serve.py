"""Serving over a mesh and the command line's ``--mesh`` flows, in the
port: ``Recommender(..., mesh=)`` against the single-device Recommender and
the JAX package's mesh mode, and ``--mesh`` on ``run``, ``dropit`` and
``dropui``.

One spawned gloo world on the CPU runs mesh 2x2 on 4 ranks, then mesh 1x2
on 2 of them (rank functions in ``torch_mesh_workers``, which imports no
jax); the ``--mesh 1x1`` flows run in this process, a world of one.
"""

import numpy as np
import pytest

import jax

import torch_mesh_workers as W
from igcn_cf_tpu.data.transforms import dropui as jax_dropui
from igcn_cf_tpu.models.base import get_model as jax_get_model
from igcn_cf_tpu.serve import Recommender as JaxRecommender
from torch_threads import one_thread  # noqa: F401

MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
MODEL_CFG = {
    "name": "IGCN", "embedding_size": 16, "n_layers": 2, "dropout": 0.0,
    "feature_ratio": 1.0, "graph_backend": "dense", "prop_cache": False,
}
REQUESTS = [("all", None, 10, None), ("k5", None, 5, None),
            ("banned", np.arange(7), 5, np.arange(0, 25))]


# the single-device serving test's tolerance (tests/test_torch_serve.py):
# each layer rounds its input to bf16, so two scores this close may swap
REP_TOL = dict(rtol=2e-3, atol=1e-5)


def assert_same_ids(got, want, scores):
    """Identical ids, except between scores within the representation
    tolerance (a near-tie at or inside rank k may swap)."""
    if np.array_equal(got, want):
        return
    rows = np.arange(got.shape[0])[:, None]
    sg, sw = scores[rows, got], scores[rows, want]
    bound = REP_TOL["atol"] * 10 + REP_TOL["rtol"] * np.abs(sw)
    assert np.all(np.abs(sg - sw) <= bound), (got, want)


def _ds_spec(ds):
    return {"name": ds.name, "n_users": ds.n_users, "n_items": ds.n_items,
            "train": ds.train, "val": ds.val, "test": ds.test}


def _requests(n_users):
    return [(name, np.arange(n_users) if users is None else users, k, banned)
            for name, users, k, banned in REQUESTS]


@pytest.fixture(scope="module")
def served(tiny_ds, tmp_path_factory):
    """A JAX IGCN checkpoint over the dropui split, served by the JAX mesh
    mode, the port's single device and the port's meshes."""
    from igcn_cf_tpu.core.mesh import make_mesh as jax_make_mesh
    from igcn_cf_tpu_torch.serve import Recommender

    reduced = jax_dropui(tiny_ds, 0.8)
    jm = jax_get_model(dict(MODEL_CFG), reduced)
    jp = jm.init_params(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("ckpt") / "igcn.pkl")
    jm.save(path, jp)
    requests = _requests(reduced.n_users)
    out = {"jax": {}, "one": {}, "reduced": reduced}
    jb = jm.init_buffers()
    for name, shape in MESHES.items():
        mesh = jax_make_mesh(jax.devices()[:4][: shape[0] * shape[1]],
                             data=shape[0], table=shape[1])
        rec = JaxRecommender(jm, jp, jb, exclude="train", mesh=mesh)
        out["jax"][name] = {r[0]: rec.recommend(r[1], k=r[2], banned_items=r[3])
                            for r in requests}
    out["rep"] = np.asarray(jm.rep(jp, jb, train=False, key=None))
    ds = W.dataset(_ds_spec(reduced))
    grown = W.dataset(_ds_spec(tiny_ds))
    for exclude in ("train", "all"):
        rec = Recommender.from_checkpoint(path, MODEL_CFG, ds, exclude=exclude,
                                          device="cpu")
        for name, users, k, banned in requests:
            out["one"][(exclude, name)] = rec.recommend(users, k=k,
                                                        banned_items=banned)
    rec.refresh(grown)
    out["one"]["refreshed"] = rec.recommend(np.arange(grown.n_users), k=10)
    spec = dict(ds=_ds_spec(reduced), grown=_ds_spec(tiny_ds), ckpt=path,
                model_cfg=MODEL_CFG, requests=requests)
    out["port"] = W.spawn_two_meshes(W.serve_cases, spec,
                                     str(tmp_path_factory.mktemp("rdv")))
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("exclude", ["train", "all"])
def test_mesh_serving_equals_one_device(served, mesh, exclude):
    """Every rank's ids equal the single-device Recommender's, with and
    without banned items and at k 5 and 10, never a masked item."""
    red = served["reduced"]
    for r in served["port"][mesh]:
        for name, users, k, banned in _requests(red.n_users):
            got = r[(exclude, name)]
            np.testing.assert_array_equal(got, served["one"][(exclude, name)])
            assert got.shape == (len(users), k) and (got < red.n_items).all()
            for u, row in zip(users, got):
                known = set(red.train[u])
                if exclude == "all":
                    known |= set(red.val[u]) | set(red.test[u])
                if banned is not None:
                    known |= set(banned.tolist())
                assert not set(row.tolist()) & known


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_serving_matches_jax_mesh_mode(served, mesh):
    """The port's mesh mode against the JAX package's on the same mesh
    shape and weights: the same ids, but where two scores are within the
    representations' bf16 tolerance (a near-tie may swap)."""
    rep = served["rep"]
    n_users = served["reduced"].n_users
    for name, users, k, banned in _requests(n_users):
        scores = rep[users] @ rep[n_users:].T
        assert_same_ids(served["port"][mesh][0][("train", name)],
                        served["jax"][mesh][name], scores)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_refresh_onto_grown_catalog(served, mesh):
    """After an inductive refresh onto the full catalog (new users and
    items), the mesh mode still equals one device."""
    for r in served["port"][mesh]:
        np.testing.assert_array_equal(r["refreshed"], served["one"]["refreshed"])


def test_mesh_needs_as_many_processes_as_shards(served):
    for r in served["port"]["2x2"]:
        assert "torchrun" in r["mismatch"] and "8 processes" in r["mismatch"]


@pytest.fixture(scope="module")
def text_split(tmp_path_factory):
    """A small catalog in the reference text format, with its dropit and
    dropui splits."""
    from igcn_cf_tpu_torch.cli.main import main
    from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions

    root = tmp_path_factory.mktemp("text")
    path = str(root / "1")
    synthetic_interactions(n_users=120, n_items=150, avg_degree=14,
                           seed=9).output(path)
    for kind in ("dropit", "dropui"):
        main(["derive", "--kind", kind, "--path", path])
    return path


def _cli(argv, tmp_path, monkeypatch, capsys):
    from igcn_cf_tpu_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("flow", ["run", "dropit", "dropui"])
def test_cli_mesh_1x1_prints_the_jax_lines(flow, text_split, tmp_path,
                                           monkeypatch, capsys):
    """``--mesh 1x1`` in one plain process (a world of one, gloo on the
    CPU): the JAX package's lines of each flow, and the process group torn
    down after."""
    import torch.distributed as dist

    out = _cli([flow, "--config", "2", "--data-path", text_split,
                "--n-epochs", "1", "--device", "cpu", "--mesh", "1x1"],
               tmp_path, monkeypatch, capsys)
    assert "Epoch 0/1, Loss:" in out and "Validation result." in out
    assert "Best NDCG, save model to checkpoints/IGCN_ShardedIGCNTrainer_" in out
    want = {"run": ["Test result."],
            "dropit": ["Previous interactions test result.",
                       "Updated interactions test result."],
            "dropui": ["Inductive results.", "All users and all items result.",
                       "Old users and old items result.",
                       "Popularity model results."]}[flow]
    for line in want:
        assert line in out, (line, out)
    assert not dist.is_initialized()


def test_cli_mesh_world_size_mismatch_raises(text_split, tmp_path,
                                             monkeypatch, capsys):
    """``--mesh 1x2`` in a plain process (a world of one) names torchrun."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        _cli(["run", "--config", "2", "--data-path", text_split, "--n-epochs",
              "1", "--device", "cpu", "--mesh", "1x2"], tmp_path, monkeypatch,
             capsys)
    assert not dist.is_initialized()


def test_cli_mesh_refuses_other_models(text_split, tmp_path, monkeypatch,
                                       capsys):
    with pytest.raises(ValueError, match="IGCN/IMF"):
        _cli(["run", "--config", "1", "--data-path", text_split, "--n-epochs",
              "1", "--device", "cpu", "--mesh", "1x1"], tmp_path, monkeypatch,
             capsys)
