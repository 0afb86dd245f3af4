"""Device timing on CUDA (port of ``igcn_cf_tpu/utils/timing.py``).

The JAX package differenced two traced loop counts because its TPU platform
did not block on ``block_until_ready``. On CUDA, events recorded on the
stream around one call measure that call's device time: a time is the
median over calls after warm-up. A CPU has no device clock, so timing there
is refused rather than measured with the host's.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def cuda_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of one ``fn()`` call on the current CUDA stream,
    by CUDA events around each of ``reps`` calls after ``warmup`` calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times CUDA work and needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# clock cycles the stream sleeps while the host queues the timed calls:
# about 10 ms at the H100's 1.98 GHz, over the host's time to launch them
_HOLD_CYCLES = 20_000_000


def queued_cuda_ms(fn: Callable[[], object], reps: int = 50,
                   warmup: int = 2) -> float:
    """Mean milliseconds of one ``fn()`` call on the device when ``reps``
    calls run back to back: a sleep kernel holds the stream while the host
    queues them, so a call shorter than its own launch is timed by the
    device and not at the host's launch rate."""
    if not torch.cuda.is_available():
        raise RuntimeError("queued_cuda_ms times CUDA work and needs a CUDA "
                           "device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
