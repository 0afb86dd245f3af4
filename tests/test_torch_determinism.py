"""A training step of every model family repeats bit for bit on a
multi-threaded CPU, as the JAX package's steps do: two runs of one step's
forward and backward, from the same params, batch and dropout draw, give
equal losses and gradients (so Adam, elementwise, moves them the same
way).

The catalog is small and the batch large, so each id repeats many times in
a batch and a gather's backward accumulates many rows into one, in
parallel where the CPU kernel runs threads."""

import pytest
import torch

from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.models.base import get_model, take_rows
from igcn_cf_tpu_torch.train.trainer import get_trainer
from torch_threads import one_thread  # noqa: F401

THREADS = 4
D = 64
BPR = {"name": "BPRTrainer", "optimizer": "Adam", "lr": 1e-3, "l2_reg": 1e-3,
       "n_epochs": 1, "batch_size": 2048, "topks": [20], "seed": 2021}
IGCN_TRAINER = dict(BPR, name="IGCNTrainer", aux_reg=0.01)
INMO = {"embedding_size": D, "n_layers": 3, "dropout": 0.3,
        "feature_ratio": 1.0}
CASES = {
    "MF": ({"name": "MF", "embedding_size": D}, BPR),
    "LightGCN dense": ({"name": "LightGCN", "embedding_size": D,
                        "n_layers": 3, "graph_backend": "dense",
                        "prop_cache": False}, BPR),
    "LightGCN cache": ({"name": "LightGCN", "embedding_size": D,
                        "n_layers": 3, "graph_backend": "dense",
                        "prop_cache": True}, BPR),
    "LightGCN sparse": ({"name": "LightGCN", "embedding_size": D,
                         "n_layers": 3, "graph_backend": "sparse"}, BPR),
    "IGCN cache": (dict(INMO, name="IGCN", graph_backend="dense",
                        prop_cache=True), IGCN_TRAINER),
    "IGCN recompute": (dict(INMO, name="IGCN", graph_backend="dense",
                            prop_cache=False), IGCN_TRAINER),
    "IGCN sparse": (dict(INMO, name="IGCN", graph_backend="sparse"),
                    IGCN_TRAINER),
    "IGCN templates 0.5": (dict(INMO, name="IGCN", graph_backend="dense",
                                prop_cache=False, feature_ratio=0.5),
                           IGCN_TRAINER),
    "IMF": (dict(INMO, name="IMF", n_layers=0, graph_backend="dense"),
            IGCN_TRAINER),
    "NGCF": ({"name": "NGCF", "embedding_size": D, "layer_sizes": [D, D],
              "dropout": 0.1, "graph_backend": "dense"}, BPR),
    "IMCGAE": ({"name": "IMCGAE", "embedding_size": D, "n_layers": 3,
                "dropout": 0.3}, BPR),
    "IDCF_LGCN": ({"name": "IDCF_LGCN", "embedding_size": D, "n_layers": 3,
                   "n_headers": 2, "n_samples": 20},
                  dict(BPR, name="IDCFTrainer", l2_reg=1e-4,
                       contrastive_reg=1e-3)),
    "NeuMF": ({"name": "NeuMF", "embedding_size": D, "layer_sizes": [D, D]},
              dict(BPR, name="BCETrainer", mf_pretrain_epochs=0,
                   mlp_pretrain_epochs=0)),
}


@pytest.fixture(scope="module")
def many_repeats():
    ds = synthetic_interactions(n_users=300, n_items=400, avg_degree=12,
                                seed=5)
    ds.neg_ratio = 4  # NeuMF's negatives per positive
    return ds


@pytest.fixture
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def lgcn_path(many_repeats, tmp_path_factory):
    """A LightGCN checkpoint over the catalog: IDCF's frozen table."""
    model = get_model({"name": "LightGCN", "embedding_size": D, "n_layers": 3},
                      many_repeats, device="cpu")
    path = str(tmp_path_factory.mktemp("lgcn") / "lgcn.pkl")
    model.save(path, model.init_params(torch.Generator().manual_seed(9)))
    return path


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_repeats_bit_for_bit(case, many_repeats, lgcn_path, threads):
    model_cfg, trainer_cfg = CASES[case]
    if model_cfg["name"] == "IDCF_LGCN":
        model_cfg = dict(model_cfg, lgcn_path=lgcn_path)
    model = get_model(dict(model_cfg), many_repeats, device="cpu")
    if model_cfg["name"] == "NeuMF":
        model.arch = "neumf"  # both towers
    trainer = get_trainer(dict(trainer_cfg), many_repeats, model)
    inputs = trainer.sample_step()
    params = list(trainer.flat_params.values())

    def loss_and_grads():
        loss = trainer.loss(trainer.params, *inputs)
        return loss.detach(), torch.autograd.grad(loss, params)

    loss_a, grads_a = loss_and_grads()
    loss_b, grads_b = loss_and_grads()
    assert torch.equal(loss_a, loss_b)
    for name, a, b in zip(trainer.flat_params, grads_a, grads_b):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.mark.parametrize("shape", [(5000,), (64, 40)])
def test_take_rows_gradient_repeats_with_duplicates(shape, threads):
    """The helper's gradient is bit-equal over two calls when every row is
    taken many times, and equals x[idx]'s within f32 rounding."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(50, 33, generator=gen, requires_grad=True)
    idx = torch.randint(0, 50, shape, generator=gen)
    ct = torch.randn(*shape, 33, generator=gen)
    out = take_rows(x, idx)
    assert torch.equal(out, x.detach()[idx])
    grads = [torch.autograd.grad(take_rows(x, idx), x, ct)[0] for _ in range(2)]
    assert torch.equal(grads[0], grads[1])
    want = torch.autograd.grad(x[idx], x, ct)[0]
    torch.testing.assert_close(grads[0], want, rtol=1e-5, atol=1e-5)
