"""Training in whole epochs, as ``BasicTrainer.train`` runs them.

Set-up draws the catalog from the seed, builds the model and its trainer
through the port's entry points on the engine the traffic names, puts the
benchmark's weights in, and runs one whole epoch through
``train_one_epoch``: that warms every shape the window uses, and its first
three steps are the ones checked (their inputs, losses, Adam's state after
the first and the parameters after the third are kept on the way). The
window then runs whole ``train_one_epoch()`` calls with no synchronize
between steps; the rate counts the batch's interactions of every step of
the epochs completed, over the time from the window's start to the end of
the last one. A cell judged by ``train_step_device_ms`` instead runs each
epoch of its window under a profiler that sees only the device, and reads
the device's busy time a step over every epoch of the window: the host's
pace, which sets the wall rate, does not move it. ``--trace 1`` instead
times ``plain_epochs`` epochs (the wall time a step takes, for
``train_mfu`` and ``train_int_per_s.wall``) and then traces
``trace_epochs`` with a range around each call into a layer.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.catalog import generate
from benchmark.harness import (Outcome, activities, dataset_of,
                               device_activities, embedding_weights, free,
                               peak_memory, ranged, sync, timed_calls,
                               unrange)
from benchmark.reference import gcn
from benchmark.reference.compare import train_numbers
from benchmark.trace import WINDOW, device_busy_s, summarize
from benchmark.window import rate

CHECKED_STEPS = 3
WALL, DEVICE = "train_int_per_s", "train_step_device_ms"
RANGES = ("epoch", "sampler", "train_step", "loss", "optimizer")


class Recorder:
    """Wraps the trainer's ``sample_step`` and ``train_step`` on the
    instance for the first ``n`` steps: keeps each step's inputs and loss,
    Adam's first moments after the first step and the parameters after the
    last."""

    def __init__(self, trainer, n: int = CHECKED_STEPS):
        self.trainer, self.n = trainer, n
        self.inputs, self.losses = [], []
        self.exp_avg1, self.params_n = None, None
        sample, step = trainer.sample_step, trainer.train_step

        def sample_step():
            out = sample()
            if len(self.inputs) < self.n:
                self.inputs.append(_clone(out))
            return out

        def train_step(*args):
            loss = step(*args)
            i = len(self.losses)
            if i < self.n:
                self.losses.append(loss.clone())
                flat = trainer.flat_params
                if i == 0:
                    # no first moment in the state: the optimizer got none
                    self.exp_avg1 = {
                        k: trainer.opt.state.get(v, {}).get(
                            "exp_avg", torch.zeros_like(v)).clone()
                        for k, v in flat.items()}
                if i == self.n - 1:
                    self.params_n = {k: v.detach().clone()
                                     for k, v in flat.items()}
            return loss

        trainer.sample_step, trainer.train_step = sample_step, train_step

    def detach(self) -> None:
        unrange(self.trainer, "sample_step", "train_step")


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


def build(ctx, cat):
    """(trainer, initial params) on the engine the traffic names, with the
    benchmark's weights in place of the trainer's own draw."""
    from igcn_cf_tpu_torch.data import sampler
    from igcn_cf_tpu_torch.kernels import dense_graph, pcache
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train import bpr
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    model_cfg = dict(ctx.config["model"],
                     prop_cache=ctx.traffic["engine"] == "cache")
    trainer_cfg = dict(ctx.config["trainer"], seed=ctx.seed,
                       batch_size=ctx.traffic["batch_size"])
    with ctx.phase("dataset"):
        ds = dataset_of(cat, ctx.config["name"])
    # builds that run inside the trainer's construction, each timed apart
    inner = [(dense_graph.BipartiteDense, "build", "graph_build"),
             (pcache, "build_prop_cache", "p_build"),
             (sampler.DeviceNegativeSampler, "build", "sampler_build"),
             (bpr, "auxiliary_interactions", "aux_interactions")]
    with ctx.phase("model"):
        model = get_model(model_cfg, ds, ctx.device)
    with ctx.phase("trainer"), timed_calls(ctx, inner):
        trainer = get_trainer(trainer_cfg, ds, model)
    ctx.setup["trainer"] -= sum(ctx.setup.get(name, 0.0)
                                for _, _, name in inner)
    flat = trainer.flat_params
    emb = flat["embedding"]
    init = {"embedding": embedding_weights(ctx.seed, emb.shape[0],
                                           emb.shape[1], ctx.device)}
    if "w" in flat:
        init["w"] = torch.ones_like(flat["w"])
    if set(init) != set(flat):
        raise ValueError(f"unexpected parameters {sorted(flat)}")
    with torch.no_grad():
        for k, v in init.items():
            flat[k].copy_(v)
    return trainer, init


def _step_args(model: str, inputs):
    """The reference loss's arguments of one recorded ``sample_step``."""
    if model == "IGCN":
        batch, aux, drop = inputs
        return (batch, aux, gcn.Drop(int(drop.seed_b), int(drop.seed_bt),
                                     drop.keep_u, drop.keep_i))
    return (inputs[0],)


def bad_triples(cat, steps_inputs, device) -> int:
    """Sampled triples that break the sampler's contract: a user without
    train items, a positive not in the user's train items, or a negative
    in them. IGCN's auxiliary triples live in template space, which is the
    id space itself at feature_ratio 1."""
    u, i = cat.pairs(0)
    keys = torch.as_tensor(np.unique(u * cat.n_items + i)).to(device)

    def member(users, items):
        q = users.long() * cat.n_items + items.long()
        j = torch.searchsorted(keys, q).clamp_max(len(keys) - 1)
        return keys[j] == q

    bad = 0
    for inputs in steps_inputs:
        triples = [inputs[0]] + ([inputs[1]] if len(inputs) == 3 else [])
        for users, pos, neg in triples:
            ok = ((users >= 0) & (users < cat.n_users) & member(users, pos)
                  & (neg >= 0) & (neg < cat.n_items) & ~member(users, neg))
            bad += int((~ok).sum())
    return bad


def run(ctx) -> Outcome:
    cfg = ctx.config
    with ctx.phase("catalog"):
        cat = generate(seed=ctx.seed, device=ctx.device, **cfg["catalog"])
    ctx.log(f"catalog {cat.n_users} x {cat.n_items}, {len(cat.users)} "
            f"interactions, {int((cat.split == 0).sum())} train")
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

    work = {"model": cfg["model"]["name"], "n_users": cat.n_users,
            "n_items": cat.n_items, "nnz": int((cat.split == 0).sum()),
            "d": cfg["model"]["embedding_size"],
            "n_layers": cfg["model"]["n_layers"], "batch": batch,
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
    model = cfg["model"]["name"]
    del trainer, rec
    free(ctx.device)

    ref_cfg = dict(cfg["model"], **cfg["trainer"])
    u, i = cat.pairs(0)
    g = gcn.Graph.of(u, i, cat.n_users, cat.n_items, ctx.device)
    steps_args = [_step_args(model, x) for x in inputs]
    numbers["bad_triples"] = float(bad_triples(cat, inputs, ctx.device))
    ref = None
    if prog is not None:
        t = time.perf_counter()
        ref = gcn.follow(model, init, g, ref_cfg, steps_args)
        numbers.update(train_numbers(*prog, ref))
        ctx.log(f"reference {time.perf_counter() - t:.3f} s; losses program "
                f"{prog[0]} reference {ref.losses}")
    out = Outcome(e2e, work, numbers, attempted, 0, peak, trace)
    if ctx.keep_check:
        out.check = dict(model=model, init=init, graph=g, cfg=ref_cfg,
                         steps=steps_args, ref=ref)
    return out


def _device_s(ctx, call) -> float:
    """Device seconds that ``call`` and all it queued took, under a
    profiler that records the device's work alone."""
    from torch.profiler import profile

    with profile(activities=device_activities(ctx.device)) as prof:
        call()
        sync(ctx.device)
    return device_busy_s(prof, ctx.device)


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
    out = summarize(prof, RANGES)
    ctx.log(f"trace read in {time.perf_counter() - t:.3f} s")
    return out
