"""The port's tools, run on the card. Kernel microbenchmarks (ports of the
JAX package's ``tools/microbench_dual.py``, ``tools/microbench_pcache.py``,
``tools/microbench_pcache_tune.py`` and ``tools/microbench_gather.py``):

    python -m igcn_cf_tpu_torch.tools.microbench_dual [d]
    python -m igcn_cf_tpu_torch.tools.microbench_pcache
    python -m igcn_cf_tpu_torch.tools.microbench_pcache_tune
    python -m igcn_cf_tpu_torch.tools.microbench_gather

and the convergence and scale runs (ports of ``tools/parity_run.py``,
``tools/soak_gowalla.py``, ``tools/amazon_scale_check.py`` and
``tools/amazon_serve_check.py``), which write ``PARITY_RESULTS_TORCH.json``
and ``AMAZON_SCALE_TORCH.json`` at the root of the checkout:

    python -m igcn_cf_tpu_torch.tools.parity_run [--epochs N]
    python -m igcn_cf_tpu_torch.tools.soak_gowalla
    python -m igcn_cf_tpu_torch.tools.amazon_scale_check
    python -m igcn_cf_tpu_torch.tools.amazon_serve_check

the measuring tools (ports of ``tools/microbench_retrieval.py``,
``tools/bench_eval.py``, ``tools/bench_serve.py`` and
``tools/bench_serve_grown.py`` with ``tools/serve_grown_phase.py``), the
benchmark's scenario sources: K5 at the eval's 29,858 users, the eval's
split, refresh and requests into ``SERVE_TORCH.json``:

    python -m igcn_cf_tpu_torch.tools.microbench_retrieval [--sweep]
    python -m igcn_cf_tpu_torch.tools.bench_eval [reps]
    python -m igcn_cf_tpu_torch.tools.bench_serve [sparse|dense]
    python -m igcn_cf_tpu_torch.tools.bench_serve_grown [sparse|dense]

and the sharded tools (ports of ``tools/scaling_harness.py``,
``tools/sharded_midscale.py`` and ``tools/amazon_sharded_projection.py``),
one process a rank under torchrun, into ``SCALING_TORCH.json``,
``SHARDED_MIDSCALE_TORCH.json`` and ``AMAZON_SCALE_TORCH.json``:

    python -m igcn_cf_tpu_torch.tools.scaling_harness
    python -m igcn_cf_tpu_torch.tools.sharded_midscale [--shape UxI]
    python -m igcn_cf_tpu_torch.tools.amazon_sharded_projection

Times are CUDA-event medians (``utils/timing.cuda_ms``), or for calls of a
few microseconds the mean over calls queued back to back
(``utils/timing.queued_cuda_ms``). Rooflines come from the card: its name
and power limit as nvidia-smi reports them, its peak rates from NVIDIA's
data sheet for that name (``datasheet``), and its SM count and maximum SM
clock (``sm_clock``).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
from pathlib import Path
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


# the checkout's root: the runs' results and dataset caches live there
ROOT = Path(__file__).resolve().parents[2]
# synthetic catalogs the runs generate once (gitignored)
DATASET_CACHE = ROOT / ".datasets"


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


def device_line(device) -> str:
    """What a result record says of the device it ran on: nvidia-smi's
    name and power limit of the card, or "cpu". Raises for CUDA where no
    card is visible."""
    from igcn_cf_tpu_torch.kernels import _build

    device = _build.require_device(device)
    return card().smi if device.type == "cuda" else "cpu"


def update_json(path, key: str, record) -> dict:
    """Set ``key`` of the JSON object in ``path`` (created if absent) to
    ``record``, written whole; returns the object."""
    path = Path(path)
    results = json.loads(path.read_text()) if path.exists() else {}
    results[key] = record
    path.write_text(json.dumps(results, indent=2) + "\n")
    return results


@contextlib.contextmanager
def process_world(device):
    """(size, backend) of this process group, started for ``device``'s
    backend (NCCL on the card, gloo on the CPU) where none is up:
    torchrun's world, else a world of one. A group the caller started
    (gloo ranks sharing a card, say) is used as it is and left up; one
    this block starts is torn down when it ends."""
    import torch.distributed as dist

    from igcn_cf_tpu_torch.core.mesh import default_backend, initialize_distributed
    from igcn_cf_tpu_torch.kernels import _build

    started = not dist.is_initialized()
    try:
        initialize_distributed(default_backend(_build.require_device(device)))
        yield dist.get_world_size(), dist.get_backend()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
