"""Named spans of host time inside the program, aggregated by name.

    from igcn_cf_tpu_torch.utils import spans

    with spans.span("train.step"):
        ...
    spans.snapshot()   # {"spans": {name: {count, total_ms, self_ms}},
                       #  "launches": the kernels' launch counts}

    with spans.profiled("prof"):   # prof/trace.json and prof/spans.json
        ...

Spans are off by default: an off span reads two flags and hands back one
shared null context, allocating nothing, so the program keeps them on its
hot path. They are on while a ``torch.profiler`` runs, or after
``enable()``. An open span keeps, per name, the count, the total wall time
and the self time (the wall time less that of the spans opened inside it),
on ``time.perf_counter_ns``; single spans are not kept. Under a profiler a
span also opens a profiler range of its name, so it lies on the profiler's
timeline, on the clock of the device's kernels.

Parents are tracked per thread. A span opened with ``adopts=True`` also
adopts, while it is open, the spans opened on other threads that have none
of their own open: autograd runs a CUDA graph's backward nodes on its
device thread while the caller blocks in ``backward()``, and the kernel
launches there are children of the caller's backward span.

Names are dotted (``train.step``, ``kernel.K3``) and none starts with
``cu``: a profiler trace reader takes events named ``cu*`` as CUDA runtime
calls.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_clock = time.perf_counter_ns
_enabled = False
_agg: dict = {}  # name -> [count, total ns, self ns]
_lock = threading.Lock()
_local = threading.local()
_adopter = None  # the open span that adopts other threads' spans

# a profiler range at a seventh of ``record_function``'s host cost
_range = torch._C._profiler._RecordFunctionFast


class _Null:
    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_NULL = _Null()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One open span (``span`` returns it only while spans are on)."""

    __slots__ = ("name", "adopts", "parent", "prev", "child", "rng", "t0")

    def __init__(self, name: str, adopts: bool = False):
        self.name, self.adopts = name, adopts

    def __enter__(self):
        global _adopter
        st = _stack()
        self.parent = st[-1] if st else _adopter
        st.append(self)
        if self.adopts:
            self.prev, _adopter = _adopter, self
        self.child = 0
        self.rng = None
        if _profiler._is_profiler_enabled:
            self.rng = _range(self.name)
            self.rng.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        global _adopter
        wall = _clock() - self.t0
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        _stack().pop()
        with _lock:
            if self.adopts:
                _adopter = self.prev
            a = _agg.get(self.name)
            if a is None:
                a = _agg[self.name] = [0, 0, 0]
            a[0] += 1
            a[1] += wall
            a[2] += wall - self.child
            if self.parent is not None:
                self.parent.child += wall
        return None


def active() -> bool:
    """True while spans record: under a profiler or after ``enable()``."""
    return _enabled or _profiler._is_profiler_enabled


def span(name: str, adopts: bool = False):
    """A context manager that records the block as span ``name`` while
    spans are on, and the shared null context otherwise."""
    if _enabled or _profiler._is_profiler_enabled:
        return Span(name, adopts)
    return _NULL


def enable() -> None:
    """Record spans without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only under a profiler again."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Forget every recorded span (the launch counts stay)."""
    with _lock:
        _agg.clear()


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_ms", "self_ms"}}, "launches":
    {kernel id: launches}}``: every span recorded since the last
    ``reset()`` and ``kernels._build.LAUNCHES``."""
    from igcn_cf_tpu_torch.kernels import _build

    with _lock:
        got = {name: {"count": c, "total_ms": t / 1e6, "self_ms": s / 1e6}
               for name, (c, t, s) in sorted(_agg.items())}
    return {"spans": got, "launches": dict(_build.LAUNCHES)}


@contextlib.contextmanager
def profiled(trace_dir):
    """A ``torch.profiler`` trace of the block (host and, on a card, device
    activity) written to ``trace_dir/trace.json``, and beside it
    ``spans.json``: the ``snapshot()`` of the spans recorded in the block
    and the launch counts. Nothing when ``trace_dir`` is None."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    with open(os.path.join(trace_dir, "spans.json"), "w") as f:
        json.dump(snapshot(), f, indent=1)
