"""NGCF trained in whole epochs, as ``train_epochs`` trains IGCN and
LightGCN, through the port's entry points on the graph backend the
traffic names (``engine``).

What differs from ``train_epochs``: NGCF's parameters (the embedding and
each layer's two linears) all take the benchmark's weights from the seed
(``weights``); the reference is ``reference/ngcf.py``, which rebuilds each
checked step's edge drop from its two mask seeds (``keepmask``) and takes
its self-loop and feature keeps from the recorded draw; ``work`` carries
what NGCF's readers need (``layer_sizes``, the concat width); and the
traced run reads, besides the drivers' ranges, the program's own spans
``model.propagate`` and ``model.transform`` as ranges. Their device time
stays counted in ``loss`` too, so that ``model_device_ms.dev`` reads the
whole model, and is kept apart under their names for NGCF's readers. The
window, the rate and the checked steps are ``train_epochs``'.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import torch

from benchmark.catalog import generate
from benchmark.drivers.train_epochs import (CHECKED_STEPS, DEVICE, RANGES,
                                            WALL, Recorder, _device_s,
                                            bad_triples)
from benchmark.harness import (Outcome, activities, dataset_of,
                               embedding_weights, free, peak_memory, ranged,
                               sync, timed_calls, unrange)
from benchmark.reference import gcn, ngcf
from benchmark.reference.compare import train_numbers
from benchmark.trace import WINDOW, summarize
from benchmark.window import rate

# the program's spans in NGCF's layers, read as ranges inside ``loss``
INNER = ("model.propagate", "model.transform")


def weights(seed: int, flat: dict, device) -> dict:
    """The benchmark's value of every leaf of NGCF's parameters, drawn on
    ``device`` from ``seed``: the embedding normal(0, 0.1) as the other
    cells' (``embedding_weights``); each linear's (in, out) weight uniform
    within +-sqrt(6 / in) (kaiming uniform, as the reference project
    initialises its layers) and its bias within +-1 / sqrt(in)
    (``nn.Linear``'s default)."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 2)
    out = {}
    for name, v in flat.items():
        if name == "embedding":
            out[name] = embedding_weights(seed, v.shape[0], v.shape[1],
                                          device)
            continue
        layer, _, kind = name.rpartition(".")
        weight = flat.get(layer + ".w")
        if kind not in ("w", "b") or weight is None or weight.dim() != 2:
            raise ValueError(f"unexpected parameter {name!r}")
        fan_in = weight.shape[0]
        bound = math.sqrt(6.0 / fan_in) if kind == "w" else 1 / math.sqrt(
            fan_in)
        u = torch.rand(tuple(v.shape), generator=g, dtype=torch.float32,
                       device=device)
        out[name] = (2.0 * u - 1.0) * bound
    return out


def build(ctx, cat):
    """(trainer, initial params) on the traffic's graph backend, with the
    benchmark's weights in place of the trainer's own draw."""
    from igcn_cf_tpu_torch.data import sampler
    from igcn_cf_tpu_torch.kernels import dense_graph
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    model_cfg = dict(ctx.config["model"], graph_backend=ctx.traffic["engine"])
    trainer_cfg = dict(ctx.config["trainer"], seed=ctx.seed,
                       batch_size=ctx.traffic["batch_size"])
    with ctx.phase("dataset"):
        ds = dataset_of(cat, ctx.config["name"])
    inner = [(dense_graph.BipartiteDense, "build", "graph_build"),
             (sampler.DeviceNegativeSampler, "build", "sampler_build")]
    with ctx.phase("model"):
        model = get_model(model_cfg, ds, ctx.device)
    with ctx.phase("trainer"), timed_calls(ctx, inner):
        trainer = get_trainer(trainer_cfg, ds, model)
    ctx.setup["trainer"] -= sum(ctx.setup.get(name, 0.0)
                                for _, _, name in inner)
    flat = trainer.flat_params
    init = weights(ctx.seed, flat, ctx.device)
    with torch.no_grad():
        for k, v in init.items():
            flat[k].copy_(v)
    return trainer, init


def _step_args(inputs, g: gcn.Graph, p: float):
    """The reference loss's (batch, drop) of one recorded ``sample_step``
    of the dense backend: the edge drop from its two mask seeds."""
    batch, drop = inputs
    if drop is None:
        return batch, None
    edge = drop.edge
    return batch, ngcf.Drop.of_seeds(g, int(edge.seed_b), int(edge.seed_bt),
                                     p, edge.keep_u, edge.keep_i, drop.feat)


def run(ctx) -> Outcome:
    cfg = ctx.config
    with ctx.phase("catalog"):
        cat = generate(seed=ctx.seed, device=ctx.device, **cfg["catalog"])
    ctx.log(f"catalog {cat.n_users} x {cat.n_items}, {len(cat.users)} "
            f"interactions, {int((cat.split == 0).sum())} train")
    # the catalog's draw holds blocks of logits for a moment: the training's
    # own peak is read apart from it
    draw_peak = peak_memory(ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    trainer, init = build(ctx, cat)
    steps = trainer.steps_per_epoch()
    batch = ctx.traffic["batch_size"]
    if steps < CHECKED_STEPS:
        raise ValueError(f"an epoch of {steps} steps: {CHECKED_STEPS} are "
                         "checked")

    rec = Recorder(trainer)
    with ctx.phase("warm_up_epoch"):
        trainer.train_one_epoch()
    rec.detach()
    device_time = DEVICE in ctx.end_to_end
    if device_time and WALL in ctx.end_to_end:
        raise ValueError(f"a cell reports {WALL} or {DEVICE}, not both: the "
                         "profiler that reads the device slows the host")
    if device_time and not ctx.trace:
        with ctx.phase("profiler_init"):
            _device_s(ctx, lambda: torch.ones(1, device=ctx.device).sum())

    model_cfg = cfg["model"]
    sizes = list(model_cfg["layer_sizes"])
    work = {"model": model_cfg["name"], "n_users": cat.n_users,
            "n_items": cat.n_items, "nnz": int((cat.split == 0).sum()),
            "d": model_cfg["embedding_size"], "n_layers": len(sizes),
            "layer_sizes": sizes,
            "rep_width": model_cfg["embedding_size"] + sum(sizes),
            "batch": batch,
            "n_params": sum(v.numel() for v in trainer.flat_params.values())}
    e2e, trace = {}, None
    if not ctx.trace:
        t0 = ctx.start_window()
        ends, busy = [t0], []
        while True:
            if device_time:
                busy.append(_device_s(ctx, trainer.train_one_epoch))
            else:
                trainer.train_one_epoch()  # ends reading the loss back
            ends.append(time.perf_counter())
            if ends[-1] - t0 + (ends[-1] - ends[-2]) > ctx.seconds:
                break
        epochs = len(ends) - 1
        attempted = epochs * steps
        if device_time:
            e2e[DEVICE] = 1e3 * sum(busy) / attempted
        else:
            e2e[WALL] = rate(epochs * steps * batch, ends[-1] - t0)
        ctx.log(f"{epochs} epochs of {steps} steps in {ends[-1] - t0:.4f} s: "
                f"{[round(b - a, 4) for a, b in zip(ends, ends[1:])]}"
                + (f"; device s {[round(b, 4) for b in busy]}"
                   if device_time else ""))
    else:
        ctx.start_window()
        t = time.perf_counter()
        plain = ctx.traffic["plain_epochs"]
        for _ in range(plain):
            trainer.train_one_epoch()
        work["step_wall_s"] = (time.perf_counter() - t) / (plain * steps)
        trace, attempted = _traced(ctx, trainer), (
            plain + ctx.traffic["trace_epochs"]) * steps
        work["steps"] = ctx.traffic["trace_epochs"] * steps
    peak = peak_memory(ctx.device)
    ctx.log(f"peak bytes: the catalog's draw {draw_peak}, training {peak}")
    peak = max(peak, draw_peak)

    inputs = rec.inputs
    # a step that never reached the recorder leaves the gaps unread, which
    # is not correct
    numbers = {"unchecked": float(CHECKED_STEPS - min(len(inputs),
                                                      len(rec.losses)))}
    prog = None
    if not numbers["unchecked"]:
        prog = ([float(x) for x in rec.losses],
                {k: v / 0.1 for k, v in rec.exp_avg1.items()},  # 1 - b1
                {k: rec.params_n[k] - init[k] for k in init})
    del trainer, rec
    free(ctx.device)

    ref_cfg = dict(model_cfg, **cfg["trainer"])
    u, i = cat.pairs(0)
    g = gcn.Graph.of(u, i, cat.n_users, cat.n_items, ctx.device)
    steps_args = [_step_args(x, g, model_cfg["dropout"]) for x in inputs]
    numbers["bad_triples"] = float(bad_triples(cat, inputs, ctx.device))
    ref = None
    if prog is not None:
        t = time.perf_counter()
        ref = ngcf.follow(init, g, ref_cfg, steps_args)
        numbers.update(train_numbers(*prog, ref))
        ctx.log(f"reference {time.perf_counter() - t:.3f} s; losses program "
                f"{prog[0]} reference {ref.losses}")
    out = Outcome(e2e, work, numbers, attempted, 0, peak, trace)
    if ctx.keep_check:
        out.check = dict(init=init, graph=g, cfg=ref_cfg, steps=steps_args,
                         ref=ref)
    return out


class _AsRange:
    """A profiler event read as a user annotation: what a range of
    ``record_function`` is, and a span's range is not."""

    __slots__ = ("_event",)

    def __init__(self, event):
        self._event = event

    def __getattr__(self, name):
        return getattr(self._event, name)

    def is_user_annotation(self) -> bool:
        return True


def spans_as_ranges(prof, names):
    """A finished profile in which the program's spans of ``names`` read as
    ranges: a span opens a fast profiler range, which ``trace.summarize``
    would take for an operator."""
    events = [_AsRange(e) if e.name() in names else e
              for e in prof.profiler.kineto_results.events()]
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _traced(ctx, trainer):
    opt = trainer.opt
    ranged(trainer, "sample_step", "sampler")
    ranged(trainer, "train_step", "train_step")
    ranged(trainer, "loss", "loss")
    ranged(opt, "zero_grad", "optimizer")
    ranged(opt, "step", "optimizer")
    from torch.profiler import profile, record_function

    with profile(activities=activities(ctx.device)) as prof:
        with record_function(WINDOW):
            for _ in range(ctx.traffic["trace_epochs"]):
                with record_function("epoch"):
                    trainer.train_one_epoch()
            sync(ctx.device)
    unrange(trainer, "sample_step", "train_step", "loss")
    unrange(opt, "zero_grad", "step")
    t = time.perf_counter()
    out = summarize(spans_as_ranges(prof, INNER), RANGES + INNER)
    inner = sum(out.by_range.get(name, 0.0) for name in INNER)
    if inner:
        out.by_range["loss"] = out.by_range.get("loss", 0.0) + inner
    ctx.log(f"trace read in {time.perf_counter() - t:.3f} s")
    return out
