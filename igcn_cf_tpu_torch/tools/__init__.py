"""Kernel microbenchmarks of the port, run on the card (ports of the JAX
package's ``tools/microbench_dual.py``, ``tools/microbench_pcache.py``,
``tools/microbench_pcache_tune.py`` and ``tools/microbench_gather.py``):

    python -m igcn_cf_tpu_torch.tools.microbench_dual [d]
    python -m igcn_cf_tpu_torch.tools.microbench_pcache
    python -m igcn_cf_tpu_torch.tools.microbench_pcache_tune
    python -m igcn_cf_tpu_torch.tools.microbench_gather

Times are CUDA-event medians (``utils/timing.cuda_ms``), or for calls of a
few microseconds the mean over calls queued back to back
(``utils/timing.queued_cuda_ms``). Rooflines come from the card: its name
and power limit as nvidia-smi reports them, its peak rates from NVIDIA's
data sheet for that name (``datasheet``), and its SM count and maximum SM
clock (``sm_clock``).
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

import torch

# Name fragment (as torch.cuda.get_device_name gives it) -> device memory
# bytes/s, dense bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor
# cores: NVIDIA's data sheets, at the part's full power limit. Checked in
# order, the most specific first.
DATASHEETS = (
    ("H200", (4.8e12, 989e12, 67e12)),
    ("H100 NVL", (3.9e12, 835e12, 60e12)),
    ("H100 PCIe", (2.0e12, 756e12, 51e12)),
    ("H100", (3.35e12, 989e12, 67e12)),  # SXM5, "NVIDIA H100 80GB HBM3"
)


class Peaks(NamedTuple):
    hbm_bytes_s: float
    bf16_flops: float
    fp32_flops: float


def datasheet(name: str) -> Peaks:
    """The data sheet's peak rates of the card called ``name``; an unknown
    card is refused rather than given another card's numbers."""
    for fragment, peaks in DATASHEETS:
        if fragment in name:
            return Peaks(*peaks)
    raise ValueError(f"no data sheet for card {name!r}")


class Card(NamedTuple):
    name: str
    smi: str  # "name, power.limit" as nvidia-smi prints it
    peaks: Peaks


def card() -> Card:
    """The visible card 0: its name, nvidia-smi's name and power limit, and
    its data-sheet peaks. Raises without a CUDA card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the microbenchmarks time CUDA kernels and need a "
                           "CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return Card(name, smi, datasheet(name))


def bound_ms(nbytes: float, flops: float, flops_peak: float,
             hbm_bytes_s: float) -> tuple[float, str]:
    """The least time for work that moves ``nbytes`` and does ``flops`` at
    the given peaks: the larger of the two times, and which one it is."""
    t_bytes = nbytes / hbm_bytes_s * 1e3
    t_ops = flops / flops_peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def report(name: str, ms: float, nbytes: float = 0, flops: float = 0) -> None:
    """Print one row: ms per call, and GB/s and TF/s over the given work."""
    line = f"{name:44s} {ms:9.4f} ms"
    if nbytes:
        line += f"   {nbytes / 1e9 / (ms / 1e3):8.1f} GB/s"
    if flops:
        line += f"   {flops / (ms / 1e3) / 1e12:7.2f} TF/s"
    print(line, flush=True)


def sm_clock() -> tuple[int, float]:
    """Card 0's SM count and its maximum SM clock in MHz, as nvidia-smi
    reports it (``clocks.max.sm``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0]
    return sms, float(mhz)
