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
