"""Probe the rate of row gathers out of on-chip memory: T5 (port of
``tools/microbench_gather.py``).

    python -m igcn_cf_tpu_torch.tools.microbench_gather

One call of T5 runs ``reps`` gathers of an (N, 128) block with arbitrary
row indices, each column from its own column, and sums them:
out[r, c] = sum_{i < reps} x[(idx[r, c] + i) mod N, c]. The JAX tool asked
whether the TPU's in-VMEM gather runs at vector speed; on the card each
block holds a column stripe of x in shared memory (``csrc/gather_probe.cu``)
and gathers from it, as ``launch_plan`` lays the work out: one wave of
blocks over (column stripe, row range) items, each column a contiguous run
that repeats its first reps - 1 rows where that fits.

For the JAX tool's cases (N = 512, 2,048 and 8,192 in f32, and 2,048 in
bf16; reps = 50; x and idx from numpy seed 0) this prints, after checking
each case bit-equal to its plain version: its launch plan, microseconds
per gather, rows
gathered per second, and cycles per row at the card's maximum SM clock
(nvidia-smi's ``clocks.max.sm``, printed beside it). All SMs gather at
once, so the rates are the whole card's, not one SM's. Each case also
prints its two floors: x, idx and out crossing device memory once at the
data sheet's rate, and reps * N * 128 element reads from shared memory at
32 a clock per SM (one per bank).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.tools import card, sm_clock
from igcn_cf_tpu_torch.utils.timing import queued_cuda_ms

WIDTH = 128  # columns of x
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
STRIPE_BYTES = 32  # widest stripe row the plan takes: one 32-byte sector of x
# outputs of a work item the kernel sorts by bank group: at most 8 a thread,
# and at least 4 a thread, below which the sort's barriers and scan cost
# more than the conflicts they remove (H100 80GB HBM3)
SORT_MIN, SORT_MAX = 4 * 1024, 8 * 1024
REPS = 50
SEED = 0
CASES = ((512, torch.float32), (2048, torch.float32), (8192, torch.float32),
         (2048, torch.bfloat16))


def gather_inputs(n_rows: int, dtype=torch.float32, device="cuda"):
    """(idx, x): the JAX tool's draws from numpy seed ``SEED``: x
    standard_normal((n, 128)) as f32, then cast to ``dtype``; idx
    integers(0, n, (n, 128)) as int32."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((n_rows, WIDTH)).astype(np.float32)
    idx = rng.integers(0, n_rows, size=(n_rows, WIDTH)).astype(np.int32)
    return (torch.as_tensor(idx).to(device),
            torch.as_tensor(x).to(device=device, dtype=dtype))


def stripe_width(n_rows: int, dtype) -> int:
    """The columns of a block's stripe: the largest power of two up to 128
    whose N rows fit a block's shared memory. Refuses an N whose one-column
    stripe does not fit."""
    w = WIDTH
    while w and n_rows * w * dtype.itemsize > SMEM_LIMIT:
        w //= 2
    if not w:
        raise ValueError(f"N={n_rows} rows of {dtype} do not fit a block's "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return w


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


class LaunchPlan(NamedTuple):
    """How T5 lays out one call (``launch_plan``)."""
    width: int           # W, the columns of a stripe (a power of two)
    padded: bool         # each column repeats its first reps - 1 rows
    pitch: int           # elements between two columns in shared memory
    rows_per_range: int  # output rows of a work item
    row_ranges: int      # work items a stripe; they tile [0, N)
    grid: int            # blocks, one an SM: min(items, SMs)
    sorted: bool         # padded runs dealt out by bank group (sort_bytes)
    smem_bytes: int      # shared memory a block: the stripe, width * pitch
                         # * size, and the sort's buffers

    @property
    def stripes(self) -> int:
        return WIDTH // self.width

    @property
    def items(self) -> int:
        return self.stripes * self.row_ranges


def padded_pitch(n_rows: int, dtype, reps: int, width: int = 1) -> int | None:
    """The column pitch (elements) of a stripe of ``width`` columns whose
    columns repeat their first reps - 1 rows after row N - 1: room for the
    16-byte chunks a run reads from any start (the most any start needs,
    (reps + 2 vec - 2) // vec chunks of vec elements), and, where width >
    1, odd in 16-byte units, so the columns start on different banks; None
    where that layout does not apply (reps >= N) or does not fit a block's
    shared memory."""
    vec = 16 // dtype.itemsize
    if reps >= n_rows:
        return None
    chunks = (reps + 2 * vec - 2) // vec if reps else 1
    pitch = ((n_rows - 1) // vec + chunks) * vec
    if width > 1 and pitch // vec % 2 == 0:
        pitch += vec
    return pitch if width * pitch * dtype.itemsize <= SMEM_LIMIT else None


def sort_bytes(outputs: int, dtype) -> int:
    """Shared memory the sorted runs take beside the stripe, for a work
    item of ``outputs`` outputs: their entries (4 bytes each) and results,
    each rounded up to 16 bytes, and the counters (8 ints for each of the
    32 warps, and 8 totals)."""
    return (_round_up(4 * outputs, 16) + _round_up(dtype.itemsize * outputs, 16)
            + 4 * (8 * 32 + 8))


@functools.lru_cache(maxsize=256)
def launch_plan(n_rows: int, dtype, sms: int, reps: int = REPS,
                width: int | None = None) -> LaunchPlan:
    """T5's launch on a card of ``sms`` SMs. A stripe is W columns of all N
    rows, padded (``padded_pitch``) where one padded column fits, else
    unpadded (``stripe_width``'s fit); W is the widest power of two up to a
    32-byte row (STRIPE_BYTES) that fits, or ``width`` where given (it must
    fit). The rows are cut in the most equal ranges that keep stripes x
    ranges at most the SMs (at least one range), and the grid, one block
    an SM, is the items or the SMs, whichever is fewer: one wave, blocks
    walking items where the stripes outnumber the SMs. Padded runs are
    sorted by bank group where an item's outputs number SORT_MIN to
    SORT_MAX, N is at most 65,536 and the sort's buffers fit beside the
    stripe. Refuses an N whose one-column stripe does not fit."""
    size = dtype.itemsize
    widest = stripe_width(n_rows, dtype)  # refuses what does not fit
    padded = padded_pitch(n_rows, dtype, reps) is not None
    if width is None:
        width = min(widest, STRIPE_BYTES // size)
        while padded and padded_pitch(n_rows, dtype, reps, width) is None:
            width //= 2
    pitch = padded_pitch(n_rows, dtype, reps, width) if padded else n_rows
    if (width < 1 or width > WIDTH or width & (width - 1) or pitch is None
            or width * pitch * size > SMEM_LIMIT):
        raise ValueError(f"a stripe of {width} columns of N={n_rows} rows of "
                         f"{dtype} does not fit a block's {SMEM_LIMIT} bytes "
                         "of shared memory")
    stripes = WIDTH // width
    rows = -(-n_rows // max(1, min(n_rows, sms // stripes)))
    ranges = -(-n_rows // rows)
    smem = width * pitch * size
    sort = (padded and n_rows <= 65536
            and SORT_MIN <= rows * width <= SORT_MAX
            and smem + sort_bytes(rows * width, dtype) <= SMEM_LIMIT)
    return LaunchPlan(width, padded, pitch, rows, ranges,
                      min(stripes * ranges, sms), sort,
                      smem + (sort_bytes(rows * width, dtype) if sort else 0))


def plan_line(plan: LaunchPlan, sms: int) -> str:
    """A plan as one line of the tool's output."""
    layout = ("padded runs, sorted by bank group" if plan.sorted else
              "padded runs" if plan.padded else "wrapping columns")
    walk = -(-plan.items // plan.grid)
    return (f"{plan.stripes} stripes of {plan.width} x {plan.row_ranges} row "
            f"ranges of {plan.rows_per_range} = {plan.items} items, grid "
            f"{plan.grid} on {sms} SMs (at most {walk} item{'s' * (walk > 1)} "
            f"a block), pitch {plan.pitch}, {plan.smem_bytes} B shared, "
            f"{layout}")


def gather_chain_plain(idx: torch.Tensor, x: torch.Tensor,
                       reps: int = REPS) -> torch.Tensor:
    """sum_{i < reps} x[(idx + i) mod N, column], summed from zero in x's
    dtype in the order of i."""
    idx = idx.long()
    acc = torch.zeros_like(x)
    for i in range(reps):
        acc = acc + torch.gather(x, 0, torch.remainder(idx + i, x.shape[0]))
    return acc


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gather_chain(idx: torch.Tensor, x: torch.Tensor, reps: int = REPS,
                 plan: LaunchPlan | None = None) -> torch.Tensor:
    """T5: ``gather_chain_plain``'s sums, bit-equal, for x (N, 128) f32 or
    bf16 and idx (N, 128) int32. CUDA tensors launch
    ``csrc/gather_probe.cu`` as ``launch_plan`` lays it out for the card's
    SMs (``plan`` overrides it, to time or test another); CPU tensors take
    the plain version."""
    if not _build.on_cuda(x):
        return gather_chain_plain(idx, x, reps)
    if (x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2
            or x.shape[1] != WIDTH or not x.is_contiguous()):
        raise ValueError("x must be a contiguous (N, 128) f32 or bf16 tensor")
    if (idx.dtype != torch.int32 or idx.shape != x.shape
            or not idx.is_contiguous() or idx.device != x.device):
        raise ValueError("idx must be a contiguous int32 tensor of x's shape "
                         "on x's device")
    if reps < 0:
        raise ValueError(f"reps {reps} < 0")
    n = x.shape[0]
    if plan is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = launch_plan(n, x.dtype, sms, reps)
    out = torch.empty_like(x)
    _build.launch("igcn_gather_chain", _aligned16(x), _aligned16(idx), out, n,
                  reps, plan.width, plan.pitch, plan.rows_per_range,
                  plan.row_ranges, plan.grid, int(plan.padded),
                  int(plan.sorted), int(x.dtype == torch.bfloat16))
    _build.LAUNCHES["T5"] += 1
    return out


# -- the tool ------------------------------------------------------------------------


def _case(n: int, dtype) -> str:
    return f"N={n} {str(dtype).removeprefix('torch.')}"


def correctness(device="cuda") -> dict:
    """T5 at each case against its plain version: any difference ends the
    run. Returns {case: max abs error}, 0.0 for each."""
    err = {}
    for n, dtype in CASES:
        idx, x = gather_inputs(n, dtype, device)
        if not torch.equal(gather_chain(idx, x), gather_chain_plain(idx, x)):
            raise AssertionError(f"T5 {_case(n, dtype)} differs from its plain "
                                 "version")
        err[_case(n, dtype)] = 0.0
    print(f"correctness: T5 bit-equal to its plain version in {len(err)} "
          "cases", flush=True)
    return err


def main(device="cuda") -> dict:
    """Every case on the card; returns {case: ms per call of REPS
    gathers}."""
    c = card()
    sms, mhz = sm_clock()
    print(f"# {c.name} | nvidia-smi: {c.smi} | {sms} SMs, max SM clock "
          f"{mhz:.0f} MHz (clocks.max.sm)", flush=True)
    correctness(device)
    print(f"\ntiming (reps {REPS}; the whole card's rate, all {sms} SMs "
          "gathering at once):", flush=True)
    ms = {}
    for n, dtype in CASES:
        idx, x = gather_inputs(n, dtype, device)
        name = _case(n, dtype)
        print(f"{name:14s}: plan {plan_line(launch_plan(n, dtype, sms), sms)}",
              flush=True)
        ms[name] = queued_cuda_ms(lambda: gather_chain(idx, x, REPS))
        per_gather = ms[name] / 1e3 / REPS  # seconds
        nbytes = 2 * x.numel() * x.element_size() + idx.numel() * 4
        mem_us = nbytes / c.peaks.hbm_bytes_s * 1e6
        smem_us = REPS * n * WIDTH / (32 * sms * mhz * 1e6) * 1e6
        print(f"{name:14s}: {per_gather * 1e6:9.4f} us/gather "
              f"({n / per_gather / 1e9:8.3f} Grows/s, "
              f"{per_gather * mhz * 1e6 / n:8.4f} cycles/row at {mhz:.0f} "
              f"MHz); {ms[name] * 1e3:9.3f} us/call against floors of "
              f"{mem_us:.3f} us (device memory, x/idx/out once at "
              f"{c.peaks.hbm_bytes_s / 1e9:.0f} GB/s) and {smem_us:.3f} us "
              f"(shared memory, 32 reads a clock per SM)", flush=True)
    return ms


if __name__ == "__main__":
    main()
