"""NGCF in the benchmark, on the CPU at a small size: the port against the
plain reference (``benchmark/reference/ngcf.py``) on seeded weights, on
both graph backends, with and without dropout; the cell's limits
against the precision control and half a batch; the driver's rebuilt edge
drop; NGCF's readers; and the spans in its layers."""

import pytest
import torch

from benchmark.catalog import generate
from benchmark.drivers import train_ngcf
from benchmark.harness import Context, dataset_of
from benchmark.reference import gcn, ngcf
from benchmark.reference.compare import judge
from benchmark.roofline import datasheet, k1, k2, least_s
from benchmark.run import Reading, cell_files, cell_of, load_spec, reader
from benchmark.trace import Trace
from igcn_cf_tpu_torch.utils import spans

N_USERS, N_ITEMS, D, SIZES = 60, 90, 16, [16, 16, 16]
SEED = 2**31 + 977
H100 = datasheet("NVIDIA H100 80GB HBM3")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these tests train small steps beside the
    suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cat():
    return generate(N_USERS, N_ITEMS, 1200, seed=SEED)


def _trainer(cat, backend: str, dropout: float, batch: int = 64):
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    ds = dataset_of(cat, "small")
    model = get_model({"name": "NGCF", "embedding_size": D,
                       "layer_sizes": SIZES, "dropout": dropout,
                       "graph_backend": backend}, ds, "cpu")
    trainer = get_trainer({"name": "BPRTrainer", "optimizer": "Adam",
                           "lr": 1e-3, "l2_reg": 1e-3, "n_epochs": 1,
                           "batch_size": batch, "test_batch_size": 64,
                           "topks": [20], "seed": 5}, ds, model)
    init = train_ngcf.weights(SEED, trainer.flat_params, "cpu")
    with torch.no_grad():
        for k, v in init.items():
            trainer.flat_params[k].copy_(v)
    return trainer, init


def _sparse_drop(trainer, g: gcn.Graph, inputs):
    """The reference's drop of a sparse step: the ``EdgeKeep`` of the
    padded COO entries of A + I found at each train edge's two entries and
    at each self-loop."""
    batch, drop = inputs
    sg = trainer.buffers["norm_adj"]
    nu, n = g.n_users, g.n_users + g.n_items
    real = 2 * len(g.u) + n  # padding follows the real entries
    keys = sg.rows[:real] * n + sg.cols[:real]
    order = torch.argsort(keys)

    def keep_at(rows, cols):
        j = torch.searchsorted(keys[order], rows * n + cols)
        assert torch.equal(keys[order][j], rows * n + cols)
        return drop.edge.keep[:real][order][j]

    ids = torch.arange(n)
    self_keep = keep_at(ids, ids)
    return batch, ngcf.Drop(keep_at(g.u, nu + g.i), keep_at(nu + g.i, g.u),
                            self_keep[:nu], self_keep[nu:], drop.feat)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


# Tolerances, by the norm of each leaf's difference over the reference's
# norm (the largest seen at this size in brackets). The sparse backend
# computes in float32: its rounding (6e-8) grown through three layers, the
# row norms and the BPR sum reads under 1e-5 [loss 1.4e-7, gradients
# 5.8e-6]. The dense backend's K6/K7 round each message's operand to
# bfloat16 (2**-9 = 2e-3 relative an element) and sum in float32: the
# loss, a mean over the batch, moves by about 1e-5 [2.2e-5] and a leaf's
# gradient by up to 1e-2 [8.2e-3]. Adam's first step moves every entry by
# lr times the sign of its gradient whatever the gradient's size, so the
# entries whose gradients lie under the rounding move either way, and the
# change over 3 steps reads up to ten times the gradients' gap [sparse
# 8.9e-5, dense 6.8e-2]. Each limit is 2-7 times the largest reading.
TOL = {"sparse": {"loss": 1e-6, "grad": 3e-5, "change": 3e-4},
       "dense": {"loss": 1e-4, "grad": 2.5e-2, "change": 0.15}}


@pytest.mark.parametrize("dropout", [0.1, 0.0], ids=["dropout", "no_drop"])
@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_the_port_matches_the_reference(cat, backend, dropout):
    trainer, init = _trainer(cat, backend, dropout)
    g = gcn.Graph.of(*cat.pairs(0), N_USERS, N_ITEMS, "cpu")
    flat = trainer.flat_params
    names = list(flat)
    losses, steps, grad1 = [], [], None
    for _ in range(3):
        inputs = trainer.sample_step()
        if grad1 is None:
            value = trainer.loss(trainer.params, *inputs)
            grad1 = dict(zip(names, torch.autograd.grad(
                value, [flat[n] for n in names])))
        losses.append(float(trainer.train_step(*inputs)))
        if inputs[1] is None:
            steps.append((inputs[0], None))
        elif backend == "dense":
            steps.append(train_ngcf._step_args(inputs, g, dropout))
        else:
            steps.append(_sparse_drop(trainer, g, inputs))
    cfg = {"layer_sizes": SIZES, "dropout": dropout, "l2_reg": 1e-3,
           "lr": 1e-3}
    ref = ngcf.follow(init, g, cfg, steps)
    tol = TOL[backend]
    for a, b in zip(losses, ref.losses):
        assert abs(a - b) / abs(b) < tol["loss"], (losses, ref.losses)
    assert set(grad1) == set(ref.grad1) == set(init)
    for n in names:
        assert _rel(grad1[n], ref.grad1[n]) < tol["grad"], n
        assert _rel(flat[n].detach() - init[n], ref.change[n]) \
            < tol["change"], n


def test_the_control_and_half_a_batch_are_not_correct():
    """``ngcf.train`` at this file's size on the CPU, under its limits."""
    from benchmark import calibrate_ngcf

    spec = load_spec()
    config, traffic, limits = cell_files(spec, cell_of(spec, "ngcf.train"))
    config["catalog"].update(n_users=N_USERS, n_items=N_ITEMS,
                             n_interactions=1200)
    config["model"].update(embedding_size=D, layer_sizes=SIZES)
    traffic["batch_size"] = 280  # 3 steps an epoch: those checked
    ctx = Context("ngcf.train", SEED, 0.0, False, config, traffic,
                  torch.device("cpu"), 0.0)
    ctx.keep_check = True
    out = train_ngcf.run(ctx)
    extra = calibrate_ngcf.train_readings(out.check)
    assert judge(out.numbers, limits)[0], out.numbers
    assert not judge(extra["control"], limits)[0], extra["control"]
    assert not judge(extra["half_batch"], limits)[0], extra["half_batch"]


def test_step_args_rebuild_the_ports_edge_drop_bit_for_bit(cat):
    from igcn_cf_tpu_torch.kernels.bitpack import mask_words_plain, unpack_bits

    trainer, _ = _trainer(cat, "dense", 0.1)
    g = gcn.Graph.of(*cat.pairs(0), N_USERS, N_ITEMS, "cpu")
    B = trainer.buffers["bip"].B
    for _ in range(3):
        inputs = trainer.sample_step()
        edge = inputs[1].edge
        batch, drop = train_ngcf._step_args(inputs, g, 0.1)
        assert batch is inputs[0]
        # the words K6m drops under seed_b (users' rows), K7m under seed_bt
        for seed, keep in ((edge.seed_b, drop.edge_u),
                           (edge.seed_bt, drop.edge_i)):
            kept = unpack_bits(mask_words_plain(B, seed, 0.1))[g.u, g.i]
            assert torch.equal(kept.bool(), keep)
        assert 0 < int(drop.edge_u.sum()) < len(g.u)
        assert not torch.equal(drop.edge_u, drop.edge_i)
        assert drop.self_u is edge.keep_u and drop.self_i is edge.keep_i
        assert all(a is b for a, b in zip(drop.feat, inputs[1].feat))


NGCF_READERS = ("k6m_roofline", "k7m_roofline", "ngcf_propagate_device_ms",
                "ngcf_transform_device_ms", "train_mfu.ngcf")


def _work(steps: int = 10) -> dict:
    nu, ni = 29_858, 40_981
    return {"model": "NGCF", "n_users": nu, "n_items": ni, "nnz": 719_000,
            "d": 64, "n_layers": 3, "layer_sizes": [64, 64, 64],
            "rep_width": 256, "batch": 2048,
            "n_params": (nu + ni) * 64 + 6 * (64 * 64 + 64), "steps": steps}


def test_ngcf_readers_by_hand():
    steps = 10
    trace = Trace(window_s=0.2, busy_s=0.08,
                  families={"K1": [6 * steps, 0.012],
                            "K2": [6 * steps, 0.030]},
                  by_range={"model.propagate": 0.006,
                            "model.transform": 0.004, "loss": 0.011})
    r = Reading(trace, _work(steps), {}, H100)
    got = {name: reader(name)(r) for name in NGCF_READERS}
    # K6m: B's 29,858 x 1,281 words, X 40,981 x 64 bf16, Y 29,858 x 64 f32
    k6m_bytes = 29_858 * 1281 * 4 + 40_981 * 64 * 2 + 29_858 * 64 * 4
    assert got["k6m_roofline"] == pytest.approx(
        100 * 60 * k6m_bytes / 3.35e12 / 0.012)
    k7m_bytes = 29_858 * 1281 * 4 + 29_858 * 64 * 2 + 40_981 * 64 * 4
    assert got["k7m_roofline"] == pytest.approx(
        100 * 60 * k7m_bytes / 3.35e12 / 0.030)
    assert got["ngcf_propagate_device_ms"] == pytest.approx(0.6)
    assert got["ngcf_transform_device_ms"] == pytest.approx(0.4)
    # 12 products of 2 nnz d, six linears of 2 n d d three times over
    # (forward, the input's and the weight's gradients), the pair scores
    # over 256 columns three times, Adam's 12 a parameter
    n = 29_858 + 40_981
    flops = (12 * 2 * 719_000 * 64 + 6 * 3 * 2 * n * 64 * 64
             + 3 * 4096 * 2 * 256 + 12 * _work()["n_params"])
    assert flops == pytest.approx(11.6e9, rel=0.01)
    assert got["train_mfu.ngcf"] == pytest.approx(
        100 * flops / (0.008 * 67e12))
    # the same products' least time: roofline.k1/k2 agree with the bytes
    assert least_s(k1(29_858, 40_981, 719_000, 64), H100) == \
        pytest.approx(k6m_bytes / 3.35e12)
    assert least_s(k2(29_858, 40_981, 719_000, 64), H100) == \
        pytest.approx(k7m_bytes / 3.35e12)


def test_ngcf_readers_read_none_without_what_they_read():
    for name in NGCF_READERS:
        assert reader(name)(Reading(None, _work(), {}, H100)) is None, name
    # a program without the spans: no range of theirs in the trace
    bare = Trace(window_s=0.2, busy_s=0.0, by_range={"loss": 0.01})
    for name in ("ngcf_propagate_device_ms", "ngcf_transform_device_ms",
                 "k6m_roofline", "k7m_roofline", "train_mfu.ngcf"):
        assert reader(name)(Reading(bare, _work(), {}, H100)) is None, name


def test_a_forward_records_each_layer_span_once_a_layer(cat):
    trainer, _ = _trainer(cat, "dense", 0.1)
    spans.disable()
    spans.reset()
    try:
        trainer.model.rep(trainer.params, trainer.buffers)
        assert "model.propagate" not in spans.snapshot()["spans"]
        spans.enable()
        trainer.model.rep(trainer.params, trainer.buffers)
        got = spans.snapshot()["spans"]
    finally:
        spans.disable()
        spans.reset()
    for name in ("model.propagate", "model.transform"):
        assert got[name]["count"] == len(SIZES), name


def test_spans_read_as_ranges_keep_their_times():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("model.propagate"):
            torch.ones(4).sum()
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "model.propagate"]
    assert len(raw) == 1 and not raw[0].is_user_annotation()
    read = train_ngcf.spans_as_ranges(prof, train_ngcf.INNER)
    events = read.profiler.kineto_results.events()
    ranged = [e for e in events if e.name() == "model.propagate"]
    assert len(ranged) == 1 and ranged[0].is_user_annotation()
    assert (ranged[0].start_ns(), ranged[0].end_ns()) == \
        (raw[0].start_ns(), raw[0].end_ns())
    others = [e for e in events if e.name() != "model.propagate"]
    assert others and not any(e.is_user_annotation() for e in others)
