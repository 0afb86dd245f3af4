"""The sparse propagation's parts, one by one (port of
``tools/microbench_spmm2.py``).

    python -m igcn_cf_tpu_torch.tools.microbench_spmm2 [--device cuda|cpu]

The sparse backend's product (``kernels/sparse._segment_spmm``) is a
gather of rows of X by the entries' columns, a scale by the entries'
values, and a sum over each row's entries in order (``torch.segment_reduce``
over the CSR row offsets). At the JAX tool's graph, the symmetric
normalized adjacency of the quarter-Gowalla synthetic catalog (29,858 // 4
users x 40,981 // 4 items, avg_degree 34, seed 1) with d = 64, X
(nodes, 64) and the pre-gathered rows (nnz, 64) drawn N(0, 1) from numpy
seed 0 as the JAX tool draws them, this prints nodes, nnz and the MB
gathered, then the ms of each part:

  gather              X[cols] (``index_select``), with its GB/s
  gather_scale        X[cols] * vals
  segment_sorted      the sorted segment sum of the pre-gathered rows,
                      ``segment_reduce`` over ``row_ptr`` as ``_segment_spmm``
  segment_unsorted    ``index_add_`` by row (float atomics on the card)
  scatter_add         ``index_put_(accumulate=True)`` by row
  cumsum_diff         a cumulative sum, then its differences at ``row_ptr``
  gather_bf16, segment_sorted_bf16   the first and third in bf16

and the largest difference of ``cumsum_diff`` from ``segment_sorted``, beside
the same difference with the sum run down each column in f32 on the host
(numpy's ``cumsum``; the card's scan adds in f32 too, where torch on the
CPU adds in f64), and whether ``segment_sorted`` of ``gather_scale`` is
``_segment_spmm``'s output bit for bit. Times are CUDA-event medians
(``utils/timing.cuda_ms``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from igcn_cf_tpu_torch.data.synthetic import synthetic_interactions
from igcn_cf_tpu_torch.graph.build import sym_norm_adjacency
from igcn_cf_tpu_torch.kernels.sparse import SparseGraph, _segment_spmm
from igcn_cf_tpu_torch.tools import device_line
from igcn_cf_tpu_torch.utils.timing import cuda_ms

N_USERS, N_ITEMS, AVG_DEGREE, SEED = 29858 // 4, 40981 // 4, 34, 1
D = 64


def gather(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, g.cols)


def gather_scale(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, g.cols) * g.vals[:, None]


def segment_sorted(g: SparseGraph, pre: torch.Tensor) -> torch.Tensor:
    return torch.segment_reduce(pre, "sum", offsets=g.row_ptr, axis=0,
                                unsafe=True)


def segment_unsorted(g: SparseGraph, pre: torch.Tensor) -> torch.Tensor:
    return pre.new_zeros((g.n_rows, pre.shape[1])).index_add_(0, g.rows, pre)


def scatter_add(g: SparseGraph, pre: torch.Tensor) -> torch.Tensor:
    return pre.new_zeros((g.n_rows, pre.shape[1])).index_put_(
        (g.rows,), pre, accumulate=True)


def cumsum_diff(g: SparseGraph, pre: torch.Tensor) -> torch.Tensor:
    """out[r] = cs[row_ptr[r + 1]] - cs[row_ptr[r]] over the cumulative sum
    cs of the rows, a zero row first."""
    cs = torch.cat([pre.new_zeros((1, pre.shape[1])), torch.cumsum(pre, 0)])
    return cs[g.row_ptr[1:]] - cs[g.row_ptr[:-1]]


def host_f32_cumsum_err(g: SparseGraph, pre: torch.Tensor,
                        want: torch.Tensor) -> float:
    """The largest difference of ``cumsum_diff`` from ``want`` with the
    cumulative sum added in f32, row after row, on the host."""
    ptr = g.row_ptr.cpu().numpy()
    cs = np.cumsum(pre.cpu().numpy(), axis=0, dtype=np.float32)
    cs = np.concatenate([np.zeros((1, cs.shape[1]), np.float32), cs])
    return float(np.abs(cs[ptr[1:]] - cs[ptr[:-1]] - want.cpu().numpy()).max())


# (name, part, operand: "x" or "pre", dtype)
PARTS = (
    ("gather", gather, "x", torch.float32),
    ("gather_scale", gather_scale, "x", torch.float32),
    ("segment_sorted", segment_sorted, "pre", torch.float32),
    ("segment_unsorted", segment_unsorted, "pre", torch.float32),
    ("scatter_add", scatter_add, "pre", torch.float32),
    ("cumsum_diff", cumsum_diff, "pre", torch.float32),
    ("gather_bf16", gather, "x", torch.bfloat16),
    ("segment_sorted_bf16", segment_sorted, "pre", torch.bfloat16),
)


def build_graph(device) -> SparseGraph:
    """The JAX tool's graph on ``device``."""
    ds = synthetic_interactions(n_users=N_USERS, n_items=N_ITEMS,
                                avg_degree=AVG_DEGREE, seed=SEED)
    coo = sym_norm_adjacency(ds.train_array, ds.n_users, ds.n_items)
    return SparseGraph.from_coo(coo, device=device)


def operands(g: SparseGraph, device) -> tuple:
    """(x (nodes, D), pre (nnz, D)) f32: the JAX tool's N(0, 1) draws from
    numpy seed 0, in its order."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(g.n_rows, D)).astype(np.float32)
    pre = rng.normal(size=(g.nnz, D)).astype(np.float32)
    return torch.as_tensor(x).to(device), torch.as_tensor(pre).to(device)


def main(argv=None, device="cuda") -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=device,
                        help="cuda (the card; raises where none is visible) "
                             "or cpu")
    args = parser.parse_args(argv)
    where = device_line(args.device)
    dev = torch.device(args.device)
    g = build_graph(dev)
    x, pre = operands(g, dev)
    e = g.nnz
    result = {"device": where, "nodes": g.n_rows, "nnz": e, "d": D,
              "gathered_mb": e * D * 4 / 1e6, "ms": {}}
    print(f"# {where}\nnodes {g.n_rows}, nnz {e}, bytes gathered "
          f"{result['gathered_mb']:.0f} MB", flush=True)
    inputs = {"x": x, "pre": pre}
    for name, part, operand, dtype in PARTS:
        arg = inputs[operand].to(dtype)
        ms = result["ms"][name] = cuda_ms(lambda: part(g, arg))
        line = f"{name:20s} {ms:9.4f} ms"
        if name == "gather":
            result["gather_gb_s"] = e * D * 4 / (ms / 1e3) / 1e9
            line += f"  ({result['gather_gb_s']:6.1f} GB/s)"
        print(line, flush=True)
    want = segment_sorted(g, pre)
    result["cumsum_max_err"] = float((cumsum_diff(g, pre) - want).abs().max())
    result["host_f32_cumsum_err"] = host_f32_cumsum_err(g, pre, want)
    print(f"cumsum_diff max err: {result['cumsum_max_err']:.6g} (f32 sums on "
          f"the host: {result['host_f32_cumsum_err']:.6g})", flush=True)
    result["segment_equals_spmm"] = torch.equal(
        segment_sorted(g, gather_scale(g, x)),
        _segment_spmm(g.row_ptr, g.cols, g.vals, x))
    print(f"segment_sorted(gather_scale) equal to _segment_spmm: "
          f"{result['segment_equals_spmm']}", flush=True)
    return result


if __name__ == "__main__":
    main()
