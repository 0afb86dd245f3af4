"""The port's host data layer against the JAX package: the same numpy seeds
give identical datasets, derivations and template maps."""

import numpy as np
import pytest

from igcn_cf_tpu.data.synthetic import synthetic_interactions as jax_synthetic
from igcn_cf_tpu.data.transforms import dropit as jax_dropit
from igcn_cf_tpu.data.transforms import dropui as jax_dropui
from igcn_cf_tpu.graph import build as jax_build
from igcn_cf_tpu_torch.core.registry import MODELS, Registry
from igcn_cf_tpu_torch.data.dataset import Interactions
from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.data.transforms import dropit, dropui
from igcn_cf_tpu_torch.graph import build
from torch_threads import one_thread  # noqa: F401

SYNTH_CASES = [
    dict(n_users=60, n_items=80, avg_degree=12, seed=7),  # tiny_ds
    dict(n_users=300, n_items=400, avg_degree=18, seed=3),  # small_ds
    dict(n_users=1600, n_items=900, avg_degree=9, seed=2021, zipf_a=1.3,
         cluster_strength=1.0),
]


def _same_dataset(a, b):
    assert (a.name, a.n_users, a.n_items) == (b.name, b.n_users, b.n_items)
    assert a.train == b.train and a.val == b.val and a.test == b.test
    np.testing.assert_array_equal(a.train_array, b.train_array)
    assert a.train_array.dtype == b.train_array.dtype == np.int64


@pytest.mark.parametrize("kw", SYNTH_CASES)
def test_synthetic_identical_to_jax(kw):
    _same_dataset(synthetic_interactions(**kw), jax_synthetic(**kw))


@pytest.mark.parametrize("ratio", [0.8, 0.5])
def test_dropui_identical_to_jax(small_ds, ratio):
    port = synthetic_interactions(n_users=300, n_items=400, avg_degree=18, seed=3)
    _same_dataset(dropui(port, ratio), jax_dropui(small_ds, ratio))


def test_dropit_identical_to_jax(small_ds):
    port = synthetic_interactions(n_users=300, n_items=400, avg_degree=18, seed=3)
    _same_dataset(dropit(port, 0.8), jax_dropit(small_ds, 0.8))


def test_empty_train_array_shape():
    ds = Interactions("e", 3, 4, [[], [], []], [[]] * 3, [[]] * 3)
    assert ds.train_array.shape == (0, 2) and len(ds) == 0


def test_with_splits_keeps_train_array(tiny_ds):
    port = synthetic_interactions(n_users=60, n_items=80, avg_degree=12, seed=7)
    swapped = port.with_splits(test=port.val)
    assert swapped.test is port.val and swapped.train is port.train
    np.testing.assert_array_equal(swapped.train_array, port.train_array)


@pytest.mark.parametrize("ratio,metric", [
    (1.0, "sort"), (0.5, "sort"), (0.5, "degree"), (0.3, "page_rank"),
])
def test_select_templates_identical_to_jax(small_ds, ratio, metric):
    arr = small_ds.train_array
    n_u, n_i = small_ds.n_users, small_ds.n_items
    got = build.select_templates(arr, n_u, n_i, ratio, metric)
    want = jax_build.select_templates(arr, n_u, n_i, ratio, metric)
    assert got == want


def test_bipartite_adjacency_and_degrees_identical_to_jax(tiny_ds):
    arr = tiny_ds.train_array
    got = build.bipartite_adjacency(arr, tiny_ds.n_users, tiny_ds.n_items)
    want = jax_build.bipartite_adjacency(arr, tiny_ds.n_users, tiny_ds.n_items)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.shape == want.shape and got.nnz == want.nnz
    np.testing.assert_array_equal(build.degrees(got), jax_build.degrees(want))


def test_unknown_ranking_metric_raises(tiny_ds):
    with pytest.raises(ValueError):
        build.graph_rank_nodes(tiny_ds.train_array, 60, 80, "nope")


def test_registry_holds_the_ported_models():
    from igcn_cf_tpu.core.registry import MODELS as JAX_MODELS

    assert MODELS.names() == JAX_MODELS.names()  # all eleven
    assert len(MODELS.names()) == 11
    with pytest.raises(KeyError, match="unknown model 'Nope'"):
        MODELS.get("Nope")
    reg = Registry("thing")
    reg.register("a")(object)
    with pytest.raises(KeyError):
        reg.register("a")(object)
    with pytest.raises(KeyError):
        reg.get("b")
