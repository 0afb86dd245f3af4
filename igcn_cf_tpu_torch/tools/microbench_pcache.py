"""Decompose the propagation-cache train step on the card, and the 4-D fused
gather kernels T1/T2 (port of ``tools/microbench_pcache.py``).

    python -m igcn_cf_tpu_torch.tools.microbench_pcache

A cache train step gathers R = 3 * 2048 rows of P and contracts them with
X0 forward and with the cotangent backward. At the JAX tool's shapes (n =
70,839 nodes, npad = 73,728 columns, R = 6,144, d = 64; P random bf16,
10.45 GB) this prints, after the small-shape correctness check, one row per
piece: ms, and GB/s and TF/s over the bytes of one pass over the gathered
rows (R * npad * 2 B) and the product's FLOP:

  A0  a full sum of G = P[rows] (one consume pass over G)
  A   the gather G = P[rows] (torch.index_select)
  B   the forward product G @ X0 on the pre-gathered G (torch.matmul, bf16)
  C   the backward product G^T @ ct on the pre-gathered G
  D   gather, forward and backward through torch
  F4  T1 ``fused_fwd_4d`` (csrc/pcache_4d.cu)
  G4  T2 ``fused_bwd_4d`` (K4's body, csrc/pcache.cu), with its launch
  E   the port's ``cached_prop`` forward and backward (K3 through T1's body in
      csrc/pcache_4d.cu, K4 in csrc/pcache.cu)

then the card's roofline for one pass.

T1 and T2 read P in the JAX tool's 4-D layout (n, NJ, sub, 128): NJ column
slabs of sub x 128 per row, the same memory as the row-major (n, npad) P
that K3/K4 read, so row E runs on the very tensor F4 and G4 read.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from igcn_cf_tpu_torch.kernels import _build
from igcn_cf_tpu_torch.kernels.bitpack import pad_to
from igcn_cf_tpu_torch.kernels.pcache import (
    _TILE, _check_4d, _d_padded, _rows32, cached_prop, fwd_body_launch)
from igcn_cf_tpu_torch.tools import bound_ms, card, report
from igcn_cf_tpu_torch.utils.timing import cuda_ms

N = 70839
NPAD = 73728  # NJ * 128 * 144
R = 6144
D = 64
TR = 128
NJ = 4
SEED = 0


def to4d(p2: torch.Tensor, nj: int) -> torch.Tensor:
    """(n, npad) -> the (n, nj, npad / nj / 128, 128) view of the same
    memory."""
    n, npad = p2.shape
    return p2.view(n, nj, npad // nj // 128, 128)


# -- T1/T2: plain versions -------------------------------------------------------


def fused_fwd_4d_plain(p4: torch.Tensor, rows: torch.Tensor,
                       x0: torch.Tensor) -> torch.Tensor:
    """(R, d) f32 = P[rows] @ X0, X0 rounded to bf16, f32 sums."""
    g = p4.reshape(p4.shape[0], -1)[rows.long()]
    return g.float() @ x0.to(torch.bfloat16).float()


def fused_bwd_4d_plain(p4: torch.Tensor, rows: torch.Tensor,
                       ct: torch.Tensor) -> torch.Tensor:
    """(npad, d) f32 = P[rows]^T @ ct, ct rounded to bf16, f32 sums."""
    g = p4.reshape(p4.shape[0], -1)[rows.long()]
    return g.float().T @ ct.to(torch.bfloat16).float()


# -- T1/T2: CUDA kernels -----------------------------------------------------------


def _launch_4d(entry, kid, p4, rows, x, out_rows, tr, *extra,
               transposed=False):
    """Launch C entry ``entry`` over (P4, rows, x padded to dpad, out) and
    count it under ``kid``; out is (out_rows, d) f32, or with
    ``transposed`` (d, out_rows). ``extra`` ints follow ``tr``."""
    with _build.counted(kid):
        n, nj, sub, _ = p4.shape
        xb = _d_padded(x)
        dpad = xb.shape[1]
        shape = (dpad, out_rows) if transposed else (out_rows, dpad)
        out = torch.empty(shape, dtype=torch.float32, device=p4.device)
        _build.launch(entry, p4, _rows32(rows), xb, out, n, nj, sub * 128,
                      rows.shape[0], dpad, tr, *extra)
    return out[: x.shape[1]] if transposed else out[:, : x.shape[1]]


# the forward body's launch shape, as igcn_fused_fwd_launch_shape writes it
FWD_SHAPE_KEYS = ("row_blocks", "splits", "d_tiles", "threads", "smem_bytes",
                  "stages", "blocks_per_sm", "max_splits")


def fwd_splits(r: int, npad: int, d: int, tr: int = TR) -> int:
    """Column splits S of T1/T3's body at this shape on the current card:
    the number of partial (R, d) f32 slabs their wrappers allocate (none
    when 1)."""
    return _build.splits("igcn_fused_fwd_splits", torch.cuda.current_device(),
                         r, npad, pad_to(d, _TILE), tr)


def fwd_launch_shape(r: int, npad: int, d: int, tr: int = TR) -> dict:
    """T1/T3's launch at this shape: ``FWD_SHAPE_KEYS`` -> int."""
    shape = (ctypes.c_int * len(FWD_SHAPE_KEYS))()
    _build.library().igcn_fused_fwd_launch_shape(r, npad, d, tr, shape)
    return dict(zip(FWD_SHAPE_KEYS, shape))


def fused_fwd_4d(p4: torch.Tensor, rows: torch.Tensor, x0: torch.Tensor,
                 tr: int = TR, splits: int | None = None) -> torch.Tensor:
    """T1: (R, d) f32 = P4[rows] @ X0 for P4 (n, NJ, sub, 128) bf16 and X0
    (NJ * sub * 128, d) taken as bf16. A block owns ``tr`` gathered rows
    and one of S column ranges (``fwd_splits``; ``splits`` overrides it
    only to time the choice); the S partial slabs are summed in order,
    so two launches are bit-equal. CUDA tensors launch
    ``csrc/pcache_4d.cu``; CPU tensors take the plain version."""
    if not _build.on_cuda(p4):
        return fused_fwd_4d_plain(p4, rows, x0)
    return fwd_body_launch("igcn_fused_fwd_4d", "T1", p4, rows, x0, tr,
                           splits=splits)


def fused_bwd_4d(p4: torch.Tensor, rows: torch.Tensor, ct: torch.Tensor,
                 tr: int = TR) -> torch.Tensor:
    """T2: (npad, d) f32 = P4[rows]^T @ ct, ct (R, d) taken as bf16. CUDA
    tensors launch K4's body (``csrc/pcache.cu``) with K4's store, so the
    result is ``pcache.gather_bwd`` of the same memory, bit for bit:
    320-column tiles walk the R rows in order, deterministic, duplicate
    rows sum. ``tr`` sets the rows of a ring stage as for T4
    (``bwd_launch_shape``). CPU tensors take the plain version."""
    if not _build.on_cuda(p4):
        return fused_bwd_4d_plain(p4, rows, ct)
    _check_4d(p4, rows, ct, rows.shape[0], "ct", tr)
    npad = p4.shape[1] * p4.shape[2] * 128
    return _launch_4d("igcn_fused_bwd_4d", "T2", p4, rows, ct, npad, tr)


# T2's and T4's launch, as igcn_fused_bwd_4d_launch_shape writes it
BWD_SHAPE_KEYS = ("grid_x", "d_tiles", "threads", "smem_bytes", "stages",
                  "rows_a_stage", "blocks_per_sm")


def bwd_launch_shape(npad: int, d: int, tr: int = TR,
                     transposed: bool = False) -> dict:
    """T2's (or with ``transposed`` T4's) launch at TR ``tr`` on the
    current card: ``BWD_SHAPE_KEYS`` -> int. TR 32 runs 4 ring stages of 32
    rows, TR 64 2 of 64, any other TR K4's 5 stages of 16 rows."""
    shape = (ctypes.c_int * len(BWD_SHAPE_KEYS))()
    _build.library().igcn_fused_bwd_4d_launch_shape(npad, d, tr,
                                                    int(transposed), shape)
    return dict(zip(BWD_SHAPE_KEYS, shape))


def bwd_launch_line(npad: int, d: int, tr: int, device,
                    transposed: bool = False) -> str:
    """T2's (or T4's) launch at TR ``tr`` as a row's note: none on the
    CPU."""
    if torch.device(device).type != "cuda":
        return "plain version (CPU)"
    s = bwd_launch_shape(npad, d, tr, transposed)
    return (f"grid ({s['grid_x']}, {s['d_tiles']}) x {s['threads']} threads, "
            f"{s['stages']} stages of {s['rows_a_stage']} rows, "
            f"{s['smem_bytes']} B shared, {s['blocks_per_sm']} blocks an SM")


# -- the tool ------------------------------------------------------------------------


def relerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def correctness_inputs(device):
    """The JAX tool's ``correctness()`` case, drawn with numpy seed 0 in its
    order: n 712, npad 1,024, R 256, TR 64, NJ 2, d 64."""
    n, npad, r_tot, tr, nj, d = 712, 1024, 256, 64, 2, 64
    rng = np.random.default_rng(0)
    p = rng.standard_normal((n, npad)).astype(np.float32)
    rows = rng.integers(0, n, size=r_tot).astype(np.int32)
    x0 = rng.standard_normal((npad, d)).astype(np.float32)
    ct = rng.standard_normal((r_tot, d)).astype(np.float32)
    p4 = to4d(torch.as_tensor(p).to(device=device, dtype=torch.bfloat16), nj)
    return (p4, torch.as_tensor(rows).to(device), torch.as_tensor(x0).to(device),
            torch.as_tensor(ct).to(device), tr)


def correctness(device="cuda") -> dict:
    """T1/T2 at the small shape against f32 products of the same bf16
    operands; a relative error above 1e-4 ends the run."""
    p4, rows, x0, ct, tr = correctness_inputs(device)
    err = {"F4": relerr(fused_fwd_4d(p4, rows, x0, tr),
                        fused_fwd_4d_plain(p4, rows, x0)),
           "G4": relerr(fused_bwd_4d(p4, rows, ct, tr),
                        fused_bwd_4d_plain(p4, rows, ct))}
    print("correctness (small scale):", flush=True)
    for name, e in err.items():
        print(f"  {name} fused {'fwd' if name == 'F4' else 'bwd'} 4d: {e:.3e}",
              flush=True)
        if not e <= 1e-4:
            raise AssertionError(f"{name} relative error {e:.3e} over 1e-4")
    return err


def random_inputs(device="cuda", seed: int = SEED):
    """P (N, NPAD) bf16, rows (R,) int32, X0 (NPAD, D) and ct (R, D) f32,
    from a seeded torch.Generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randint(0, N, (R,), generator=gen, device=device,
                         dtype=torch.int32)
    x0 = torch.randn((NPAD, D), generator=gen, device=device)
    ct = torch.randn((R, D), generator=gen, device=device)
    p = torch.randn((N, NPAD), generator=gen, device=device,
                    dtype=torch.bfloat16)
    return p, rows, x0, ct


def main(device="cuda") -> dict:
    """Every row on the card; returns {row: ms}."""
    c = card()
    print(f"# {c.name} | nvidia-smi: {c.smi}", flush=True)
    correctness(device)
    p, rows, x0, ct = random_inputs(device)
    x0b, ctb = x0.to(torch.bfloat16), ct.to(torch.bfloat16)
    row_bytes = R * NPAD * 2
    flops = 2 * R * NPAD * D
    print("\ntiming (Gowalla scale):", flush=True)
    ms = {}
    g = p.index_select(0, rows)
    ms["A0"] = cuda_ms(lambda: g.sum())
    report("A0 full-sum of G (consume pass)", ms["A0"], row_bytes)
    ms["A"] = cuda_ms(lambda: p.index_select(0, rows))
    report("A  torch gather P[rows] (index_select)", ms["A"], row_bytes)
    ms["B"] = cuda_ms(lambda: g @ x0b)
    report("B  torch fwd matmul G @ X0", ms["B"], row_bytes, flops)
    ms["C"] = cuda_ms(lambda: g.T @ ctb)
    report("C  torch bwd matmul G^T @ ct", ms["C"], row_bytes, flops)
    del g

    def d_step():
        g = p.index_select(0, rows)
        return g @ x0b, g.T @ ctb

    ms["D"] = cuda_ms(d_step)
    report("D  torch gather+fwd+bwd", ms["D"], 3 * row_bytes, 2 * flops)
    p4 = to4d(p, NJ)
    ms["F4"] = cuda_ms(lambda: fused_fwd_4d(p4, rows, x0, TR))
    report(f"F4 T1 fused fwd 4d (TR {TR}, NJ {NJ})", ms["F4"], row_bytes, flops)
    ms["G4"] = cuda_ms(lambda: fused_bwd_4d(p4, rows, ct, TR))
    report(f"G4 T2 fused bwd 4d (TR {TR}, NJ {NJ})", ms["G4"], row_bytes, flops)
    print(f"  launch: {bwd_launch_line(NPAD, D, TR, device)}", flush=True)
    x0n = x0[:N].clone().requires_grad_()
    ms["E"] = cuda_ms(lambda: torch.autograd.grad(cached_prop(p, rows, x0n),
                                                  x0n, ct))
    report("E  port cached_prop fwd+bwd (K3/K4)", ms["E"], 2 * row_bytes,
           2 * flops)
    floor, by = bound_ms(row_bytes, flops, c.peaks.bf16_flops,
                         c.peaks.hbm_bytes_s)
    print(f"\nroofline ({c.smi}): one pass over the gathered rows = "
          f"{row_bytes / 1e9:.3f} GB = {floor:.4f} ms at "
          f"{c.peaks.hbm_bytes_s / 1e9:.0f} GB/s (data sheet; bound by {by})",
          flush=True)
    return ms


if __name__ == "__main__":
    main()
