"""Probe the rate of row gathers out of on-chip memory: T5 (port of
``tools/microbench_gather.py``).

    python -m igcn_cf_tpu_torch.tools.microbench_gather

One call of T5 runs ``reps`` gathers of an (N, 128) block with arbitrary
row indices, each column from its own column, and sums them:
out[r, c] = sum_{i < reps} x[(idx[r, c] + i) mod N, c]. The JAX tool asked
whether the TPU's in-VMEM gather runs at vector speed; on the card each
block holds a column stripe of x in shared memory (``csrc/gather_probe.cu``)
and gathers from it.

For the JAX tool's cases (N = 512, 2,048 and 8,192 in f32, and 2,048 in
bf16; reps = 50; x and idx from numpy seed 0) this prints, after checking
each case bit-equal to its plain version: microseconds per gather, rows
gathered per second, and cycles per row at the card's maximum SM clock
(nvidia-smi's ``clocks.max.sm``, printed beside it). All SMs gather at
once, so the rates are the whole card's, not one SM's. Each case also
prints its two floors: x, idx and out crossing device memory once at the
data sheet's rate, and reps * N * 128 element reads from shared memory at
32 a clock per SM (one per bank).
"""

from __future__ import annotations

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.tools import card, sm_clock
from igcn_cf_tpu_torch.utils.timing import queued_cuda_ms

WIDTH = 128  # columns of x
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
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


def gather_chain_plain(idx: torch.Tensor, x: torch.Tensor,
                       reps: int = REPS) -> torch.Tensor:
    """sum_{i < reps} x[(idx + i) mod N, column], summed from zero in x's
    dtype in the order of i."""
    idx = idx.long()
    acc = torch.zeros_like(x)
    for i in range(reps):
        acc = acc + torch.gather(x, 0, torch.remainder(idx + i, x.shape[0]))
    return acc


def gather_chain(idx: torch.Tensor, x: torch.Tensor,
                 reps: int = REPS) -> torch.Tensor:
    """T5: ``gather_chain_plain``'s sums, bit-equal, for x (N, 128) f32 or
    bf16 and idx (N, 128) int32. CUDA tensors launch
    ``csrc/gather_probe.cu``; CPU tensors take the plain version."""
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
    w = stripe_width(n, x.dtype)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    row_blocks = min(n, -(-sms // (WIDTH // w)))  # the grid covers the SMs
    out = torch.empty_like(x)
    _build.launch("igcn_gather_chain", x, idx, out, n, reps, w, row_blocks,
                  int(x.dtype == torch.bfloat16))
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
