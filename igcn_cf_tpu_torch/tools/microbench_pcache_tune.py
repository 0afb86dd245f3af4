"""Tune the 4-D fused gather kernels on the card: T3 (forward, X0 per stage
or kept in L2) and T4 (backward written as dX0^T) over NJ x TR (port of
``tools/microbench_pcache_tune.py``).

    python -m igcn_cf_tpu_torch.tools.microbench_pcache_tune

After a small-shape correctness check (the JAX tool's ``correctness()``
case), one random bf16 P of the pcache tool's shape (n = 70,839, npad =
73,728, 10.45 GB; R = 6,144, d = 64; ``microbench_pcache.random_inputs``)
is seen through ``microbench_pcache.to4d(p, nj)`` for NJ = 4, then 2, with
no second copy, and each row prints ms, and GB/s and TF/s over one pass of
the gathered rows (R * npad * 2 B) and the product's FLOP:

  fwd nj= tr= resident=   T3 for the JAX tool's (TR, resident_x0) grid
  bwd_t nj= tr=           T4 for TR 128, 64 and 32, each with its launch

then the card's roofline for one pass. No row is skipped: the JAX tool
left out combinations over 15 MB of TPU VMEM, but a T3 block holds 3 (TR +
64) x 72 bf16 of shared memory (its three-stage ring) and a T4 block at
most ~103 KB, under the card's 232,448 bytes. On the card NJ names the
slabs only: T3 and T4 read the same contiguous columns at NJ 4 and 2. TR
reaches T3's launch as rows a block (split in S column ranges by TR,
``microbench_pcache.fwd_splits``) and T4's as rows a ring stage at TR 64
(2 stages) and 32 (4 stages); 128-row stages do not fit 2 blocks an SM,
so T4's TR 128 row runs K4's own 5 stages of 16 rows, as its printed
launch says. A row the kernel refuses raises and ends the run.
"""

from __future__ import annotations

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.tools import bound_ms, card, report
from igcn_cf_tpu_torch.tools.microbench_pcache import (
    _check_4d, _fwd_launch, _launch_4d, bwd_launch_line, fused_fwd_4d_plain,
    random_inputs, relerr, to4d)
from igcn_cf_tpu_torch.utils.timing import cuda_ms

TR = 128
NJS = (4, 2)
# (TR, resident_x0) rows of the forward, and TRs of the backward: the JAX
# tool's sweep
FWD_GRID = ((128, False), (64, False), (64, True), (32, True))
BWD_TRS = (128, 64, 32)

# resident_x0 changes where X0 is kept, not the function: T3 computes T1's
fwd_tune_plain = fused_fwd_4d_plain


def bwd_t_plain(p4: torch.Tensor, rows: torch.Tensor,
                ct: torch.Tensor) -> torch.Tensor:
    """(d, npad) f32 = ct^T @ P[rows], ct rounded to bf16, f32 sums."""
    g = p4.reshape(p4.shape[0], -1)[rows.long()]
    return ct.to(torch.bfloat16).float().T @ g.float()


def fwd_tune(p4: torch.Tensor, rows: torch.Tensor, x0: torch.Tensor,
             tr: int = TR, resident_x0: bool = False) -> torch.Tensor:
    """T3: (R, d) f32 = P4[rows] @ X0, X0 (npad, d) taken as bf16, through
    T1's body: a block owns ``tr`` gathered rows and one of S column ranges
    (``microbench_pcache.fwd_splits``), the partial slabs summed in order.
    ``resident_x0`` keeps
    X0 in L2 (evict_last) while P streams past (evict_first); both variants
    are bit-equal to T1 at the same ``tr``. CUDA tensors launch
    ``csrc/pcache_4d.cu``; CPU tensors take the plain version."""
    if not _build.on_cuda(p4):
        return fwd_tune_plain(p4, rows, x0)
    return _fwd_launch("igcn_fused_fwd_tune", "T3", p4, rows, x0, tr,
                       int(bool(resident_x0)))


def bwd_t(p4: torch.Tensor, rows: torch.Tensor, ct: torch.Tensor,
          tr: int = TR) -> torch.Tensor:
    """T4: (d, npad) f32 = ct^T @ P4[rows], ct (R, d) taken as bf16, the
    transpose of ``fused_bwd_4d``'s result, as the JAX kernel returns it.
    CUDA tensors launch K4's body (``csrc/pcache.cu``) with a transposed
    store, so the result is ``pcache.gather_bwd`` of the same memory
    transposed, bit for bit, and ``fused_bwd_4d``'s transposed: 320-column
    tiles walk the R rows in order, deterministic, duplicate rows sum.
    ``tr`` sets the rows of a ring stage where such stages fit 2 blocks an
    SM (32 and 64; ``microbench_pcache.bwd_launch_shape``); any other TR
    runs K4's 16-row stages. CPU tensors take the plain version."""
    if not _build.on_cuda(p4):
        return bwd_t_plain(p4, rows, ct)
    _check_4d(p4, rows, ct, rows.shape[0], "ct", tr)
    npad = p4.shape[1] * p4.shape[2] * 128
    return _launch_4d("igcn_fused_bwd_t", "T4", p4, rows, ct, npad, tr,
                      transposed=True)


# -- the tool ------------------------------------------------------------------------


def correctness_inputs(device, n=700, nj=2, sub=8, d=32, tr=64, r_tot=192):
    """The JAX tool's ``correctness()`` case, drawn with numpy seed 0 in its
    order (P4, rows, X0, ct); X0 and ct as bf16. Smaller shapes keep the
    same draws."""
    npad = nj * sub * 128
    rng = np.random.default_rng(0)
    p4 = rng.standard_normal((n, nj, sub, 128)).astype(np.float32)
    rows = rng.integers(0, n, size=r_tot).astype(np.int32)
    x0 = rng.standard_normal((npad, d)).astype(np.float32)
    ct = rng.standard_normal((r_tot, d)).astype(np.float32)
    return (torch.as_tensor(p4).to(device=device, dtype=torch.bfloat16),
            torch.as_tensor(rows).to(device),
            torch.as_tensor(x0).to(device=device, dtype=torch.bfloat16),
            torch.as_tensor(ct).to(device=device, dtype=torch.bfloat16), tr)


def correctness(device="cuda") -> dict:
    """T3 (both variants) and T4 at the small shape against f32 products of
    the same bf16 operands; a relative error above 1e-4 ends the run."""
    p4, rows, x0, ct, tr = correctness_inputs(device)
    want = fwd_tune_plain(p4, rows, x0)
    err = {f"fwd resident={int(res)}":
           relerr(fwd_tune(p4, rows, x0, tr, res), want)
           for res in (False, True)}
    err["bwd_t"] = relerr(bwd_t(p4, rows, ct, tr), bwd_t_plain(p4, rows, ct))
    print("correctness (small scale):", flush=True)
    for name, e in err.items():
        print(f"  {name}: {e:.3e}", flush=True)
        if not e <= 1e-4:
            raise AssertionError(f"{name} relative error {e:.3e} over 1e-4")
    return err


def main(device="cuda") -> dict:
    """Every row on the card; returns {row: ms}."""
    c = card()
    print(f"# {c.name} | nvidia-smi: {c.smi}", flush=True)
    correctness(device)
    p, rows, x0, ct = random_inputs(device)
    x0b, ctb = x0.to(torch.bfloat16), ct.to(torch.bfloat16)
    r, npad = rows.shape[0], p.shape[1]
    row_bytes = r * npad * 2
    flops = 2 * r * npad * x0.shape[1]
    print("\ntiming (Gowalla scale):", flush=True)
    ms = {}
    for nj in NJS:
        p4 = to4d(p, nj)
        for tr, res in FWD_GRID:
            name = f"fwd nj={nj} tr={tr} resident={int(res)}"
            ms[name] = cuda_ms(lambda: fwd_tune(p4, rows, x0b, tr, res))
            report(name, ms[name], row_bytes, flops)
        for tr in BWD_TRS:
            name = f"bwd_t nj={nj} tr={tr}"
            ms[name] = cuda_ms(lambda: bwd_t(p4, rows, ctb, tr))
            report(name, ms[name], row_bytes, flops)
            line = bwd_launch_line(npad, x0.shape[1], tr, device, True)
            print(f"  launch: {line}", flush=True)
    floor, by = bound_ms(row_bytes, flops, c.peaks.bf16_flops,
                         c.peaks.hbm_bytes_s)
    print(f"\nroofline ({c.smi}): one pass over the gathered rows = "
          f"{row_bytes / 1e9:.3f} GB = {floor:.4f} ms at "
          f"{c.peaks.hbm_bytes_s / 1e9:.0f} GB/s (data sheet; bound by {by})",
          flush=True)
    return ms


if __name__ == "__main__":
    main()
