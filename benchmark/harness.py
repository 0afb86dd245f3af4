"""What every driver shares: the run's context, set-up phases, the
benchmark's own weights, ranges around the program's calls, and the
outcome a driver hands back."""

from __future__ import annotations

import gc
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_memory(device) -> int:
    """Peak bytes allocated on the card since the run began (0 on the CPU)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def free(device) -> None:
    """Give back what the program's state held, once it is dropped."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def activities(device) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def device_activities(device) -> list:
    """The profiler's activities that see the device's work alone: CUDA on
    a card, the CPU's operators without one."""
    from torch.profiler import ProfilerActivity

    if torch.device(device).type == "cuda":
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


@dataclass
class Context:
    """One run of one cell. ``t0`` is the host clock at the process's first
    statement; ``setup`` collects the set-up's parts in seconds."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    device: torch.device
    t0: float
    setup: dict = field(default_factory=dict)
    window_start: Optional[float] = None
    # keep what the reference was given on the outcome (``Outcome.check``),
    # for reading the precision control and the planted faults beside it
    keep_check: bool = False
    # the cell's end-to-end metrics, which say what a window measures
    end_to_end: tuple = ()

    def log(self, msg: str) -> None:
        print(f"# {msg}", file=sys.stderr, flush=True)

    @contextmanager
    def phase(self, name: str):
        """Time a part of the set-up, the device's work in it included."""
        start = time.perf_counter()
        yield
        sync(self.device)
        spent = time.perf_counter() - start
        self.setup[name] = self.setup.get(name, 0.0) + spent

    def start_window(self) -> float:
        sync(self.device)
        self.window_start = time.perf_counter()
        return self.window_start

    @property
    def setup_s(self) -> float:
        return self.window_start - self.t0


@contextmanager
def timed_calls(ctx: Context, targets):
    """Charge the calls to ``(owner, attribute, phase)`` targets to set-up
    phases while the block runs: each call is timed to its end on the
    device. A target the program no longer has is skipped."""
    saved = []
    for owner, attr, name in targets:
        if not hasattr(owner, attr):
            continue
        raw = owner.__dict__.get(attr, getattr(owner, attr))
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw

        def timed(*a, _fn=fn, _name=name, **kw):
            with ctx.phase(_name):
                return _fn(*a, **kw)

        setattr(owner, attr, staticmethod(timed)
                if isinstance(raw, staticmethod) else timed)
        saved.append((owner, attr, raw))
    try:
        yield
    finally:
        for owner, attr, raw in reversed(saved):
            setattr(owner, attr, raw)


def dataset_of(cat, name: str):
    """The port's dataset of a ``catalog.Catalog``."""
    from igcn_cf_tpu_torch.data.dataset import Interactions

    return Interactions(name, cat.n_users, cat.n_items, cat.lists(0),
                        cat.lists(1), cat.lists(2))


def embedding_weights(seed: int, rows: int, d: int, device,
                      std: float = 0.1) -> torch.Tensor:
    """The embedding table both sides start from: normal(0, std) in f32,
    drawn on ``device`` from ``seed`` in one call."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 1)
    return std * torch.randn((rows, d), generator=g, dtype=torch.float32,
                             device=device)


def ranged(obj, attr: str, name: str) -> None:
    """Wrap ``obj.attr`` (a bound method) on the instance in a profiler
    range called ``name``."""
    fn = getattr(obj, attr)

    def call(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)

    setattr(obj, attr, call)


def unrange(obj, *attrs: str) -> None:
    for attr in attrs:
        obj.__dict__.pop(attr, None)


@dataclass
class Outcome:
    """What a driver hands back. ``e2e`` holds the end-to-end readings (the
    harness adds ``setup_s``), ``work`` what the per-layer readers need
    besides the trace, ``numbers`` the correctness numbers."""

    e2e: dict
    work: dict
    numbers: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None
    check: object = None
