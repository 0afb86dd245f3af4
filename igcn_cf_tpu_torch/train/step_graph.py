"""A BPR training step replayed as one CUDA graph.

On a card a BPR step is about a hundred small launches (the model's
forward, autograd's backward, Adam's update) whose host cost exceeds their
device time. ``StepGraph`` captures the whole step once, ``zero_grad``,
the loss, ``backward()`` and ``opt.step()``, and replays it: each later
step copies its freshly sampled inputs into the graph's static input
tensors and launches the graph. Sampling stays eager, outside the graph.

What decides whether a step replays is what the code can observe:

  * every leaf of the step's inputs is a CUDA tensor or None
    (``graph_leaves``); a Python number in them, such as a dropout draw's
    mask seed that a kernel takes as a launch argument, would be frozen
    into the graph, and CPU tensors take the plain versions, which have
    nothing to capture;
  * the leaves' shapes and dtypes, and the trainer's optimizer, buffers,
    parameters and optimizer state (by identity), are those the graph was
    captured with. Anything else drops the graph: the next step runs
    eagerly and the one after captures again.

The first step, and the first after a drop, runs eagerly: it makes every
lazy initialisation and Adam's state. The next is captured and replayed
for itself. Where capture raises (a host sync inside some model's loss),
the trainer drops the graph for good, logs it once, records the span
``train.graph_fallback`` and runs eagerly from then on.

Parameters, gradients and Adam's moments stay the tensors they were, so
evaluation, checkpoints and ``copy_params_`` work on them as before. Each
replay is recorded as span ``train.replay``. ``kernels._build.LAUNCHES``
counts the wrappers' own launches only: those of the eager step and of the
capture, none of a replay's, whose kernels a device trace shows by name.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

import torch

from igcn_cf_tpu_torch.utils.spans import span


def graph_leaves(step_inputs) -> Optional[list]:
    """The leaves of ``step_inputs`` (nested tuples, named tuples and
    lists) in order, where each is a CUDA tensor or None; None where any
    is not."""
    leaves = []

    def walk(x) -> bool:
        if x is None or (isinstance(x, torch.Tensor) and x.is_cuda):
            leaves.append(x)
            return True
        if isinstance(x, (tuple, list)):
            return all(walk(v) for v in x)
        return False

    return leaves if walk(step_inputs) else None


def signature(leaves: list) -> tuple:
    """What a captured graph fixes of its input leaves."""
    return tuple(None if t is None else (t.shape, t.dtype, t.device)
                 for t in leaves)


def _rebuild(x, leaves):
    """``x`` with its leaves taken in order from the iterator ``leaves``."""
    if x is None or isinstance(x, torch.Tensor):
        return next(leaves)
    vals = [_rebuild(v, leaves) for v in x]
    if isinstance(x, list):
        return vals
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def _owners(trainer) -> tuple:
    """The objects whose tensors a captured step reads and writes."""
    opt = trainer.opt
    return (opt, trainer.buffers, trainer.flat_params, *opt.state.values())


def _same(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def make_capturable(opt: torch.optim.Optimizer) -> None:
    """Let ``opt`` step inside a graph: ``capturable`` on in each group that
    has the option, and each step counter on its parameter's device."""
    for group in opt.param_groups:
        if "capturable" not in group:
            continue
        group["capturable"] = True
        for p in group["params"]:
            state = opt.state.get(p)
            step = state.get("step") if state else None
            if isinstance(step, torch.Tensor) and step.device != p.device:
                state["step"] = step.to(p.device)


class StepGraph:
    """One trainer's captured step (see the module's docstring)."""

    def __init__(self):
        self.graph = None      # the captured step
        self.static = []       # its input leaves, None kept
        self.loss = None       # its loss output
        self.sig = None        # what the warm step or the graph was made for
        self.owners = ()
        self.fallback = None   # why capture failed: the trainer stays eager
        self.side = None       # the stream the warm step and the capture use

    def drop(self) -> None:
        self.graph, self.static, self.loss = None, [], None
        self.sig, self.owners = None, ()

    def step(self, trainer, step_inputs: tuple,
             eager: Callable[..., torch.Tensor]) -> torch.Tensor:
        """The loss of one step on ``step_inputs`` (detached, on the
        device): replayed where the graph holds, else by ``eager``, the
        trainer's own step."""
        leaves = graph_leaves(step_inputs)
        if self.fallback is not None or leaves is None:
            self.drop()
            return eager(*step_inputs)
        sig = signature(leaves)
        if sig == self.sig and _same(_owners(trainer), self.owners):
            if self.graph is None and not self._capture(step_inputs, leaves,
                                                        eager):
                with span("train.graph_fallback"):
                    return eager(*step_inputs)
            return self._replay(leaves)
        self.drop()
        make_capturable(trainer.opt)
        if self.side is None:
            self.side = torch.cuda.Stream(trainer.device)
        # warm on the stream that captures: its lazy initialisations (a
        # library's workspace a stream) are then made outside the capture
        here = torch.cuda.current_stream()
        self.side.wait_stream(here)
        with torch.cuda.stream(self.side):
            loss = eager(*step_inputs)
        here.wait_stream(self.side)
        self.sig, self.owners = sig, _owners(trainer)
        return loss

    def _capture(self, step_inputs, leaves, eager) -> bool:
        static = [None if t is None else t.clone() for t in leaves]
        graph = torch.cuda.CUDAGraph()
        self.side.wait_stream(torch.cuda.current_stream())
        # not ``torch.cuda.graph``: where its capture fails, it leaves the
        # side stream current
        try:
            with torch.cuda.stream(self.side):
                graph.capture_begin()
                try:
                    loss = eager(*_rebuild(step_inputs, iter(static)))
                finally:
                    graph.capture_end()
        except RuntimeError as err:
            self.drop()
            self.fallback = f"{type(err).__name__}: {err}"
            print(f"[step_graph] capture failed, training eagerly: "
                  f"{self.fallback.splitlines()[0]}", file=sys.stderr,
                  flush=True)
            return False
        self.graph, self.static, self.loss = graph, static, loss
        return True

    def _replay(self, leaves: list) -> torch.Tensor:
        with span("train.replay"):
            for s, t in zip(self.static, leaves):
                if s is not None:
                    s.copy_(t)
            self.graph.replay()
            return self.loss.clone()
