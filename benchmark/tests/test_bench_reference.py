"""The plain reference against the port on a tiny catalog on the CPU, and
the whole run of each cell there judged correct and reporting its
end-to-end metrics."""

import numpy as np
import pytest
import torch

from benchmark.catalog import generate
from benchmark.reference import gcn, keepmask
from benchmark.run import end_to_end_of, execute
from benchmark.tests.helpers import cells, tiny

SIZE = dict(n_users=300, n_items=400, n_interactions=6000)


@pytest.fixture(scope="module")
def cat():
    return generate(seed=4242, **SIZE)


def test_keep_bits_equal_the_ports_mask(cat):
    from igcn_cf_tpu_torch.kernels.bitpack import keep_mask_dense

    u, i = (torch.as_tensor(x) for x in cat.pairs(0))
    for seed in (0, 12345, 2**32 - 1):
        dense = keep_mask_dense(seed, 300, 400, 0.3)
        assert torch.equal(keepmask.kept(seed, u, i, 0.3), dense[u, i])


def test_propagation_matches_the_ports(cat):
    from igcn_cf_tpu_torch.kernels.dense_graph import (
        BipartiteDense, sym_norm_propagate_mean)

    u, i = cat.pairs(0)
    g = gcn.Graph.of(u, i, 300, 400, "cpu")
    x0 = torch.randn(700, 64, generator=torch.Generator().manual_seed(1))
    ref = gcn.propagate_mean(g, x0.double(), 3)
    bip = BipartiteDense.build(np.stack([u, i], 1), 300, 400, "cpu")
    port = sym_norm_propagate_mean(bip, x0, 3)
    # the port rounds each layer's operand to bf16 (sums in f32)
    err = (port.double() - ref).abs().max() / ref.abs().max()
    assert err < 3e-3


def test_serving_reps_match_the_ports(cat):
    from igcn_cf_tpu_torch.data.transforms import dropui
    from igcn_cf_tpu_torch.models.base import get_model

    from benchmark.harness import dataset_of

    full = dataset_of(cat, "tiny")
    model = get_model({"name": "IGCN", "embedding_size": 64, "n_layers": 3,
                       "dropout": 0.3, "feature_ratio": 1.0,
                       "graph_backend": "dense", "prop_cache": False},
                      dropui(full, 0.8), "cpu")
    emb = 0.1 * torch.randn(model.n_templates, 64,
                            generator=torch.Generator().manual_seed(2))
    params = {"embedding": emb, "w": torch.ones(64)}
    port = model.rep(params, model.rebuild_for(full))
    g = gcn.Graph.of(*cat.pairs(0), 300, 400, "cpu")
    users, items = gcn.igcn_serving_reps(emb, g, 240, 320, 3)
    ref = torch.cat([users, items])
    assert port.shape == ref.shape
    err = (port.double() - ref).abs().max() / ref.abs().max()
    assert err < 3e-3


@pytest.mark.parametrize("cell", cells())
def test_a_run_of_each_cell_is_correct_on_the_cpu(cell):
    spec, c, limits, ctx = tiny(cell)
    result = execute(spec, c, limits, ctx)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", cells())
def test_a_run_reports_its_cells_end_to_end_metrics(cell):
    spec, c, limits, ctx = tiny(cell)
    result = execute(spec, c, limits, ctx)
    want = [m["name"] for m in end_to_end_of(spec, cell)]
    assert sorted(result["metrics"]) == sorted(want)
    assert all(m["value"] > 0 for m in result["metrics"].values())
