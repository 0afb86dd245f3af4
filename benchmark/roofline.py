"""Peaks of the card, and the operations and bytes each measured kernel and
a whole training step need.

Peaks are NVIDIA's data-sheet rates at the part's full power limit (dense,
no sparsity). A kernel's least time is the larger of its operations over
the peak of the unit it runs on and its bytes over the memory's bandwidth.
Bytes count each input the computation needs read once and each output
written once, at the catalog's logical size: padding the program adds
(rows to 512, columns to 4,096 or 128) is not counted, since the inputs do
not need it.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple

# Name fragment (as torch.cuda.get_device_name gives it) -> device memory
# bytes/s, dense bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor
# cores. Checked in order, the most specific first.
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
    """The peaks of the card called ``name``; an unknown card is refused
    rather than given another card's numbers."""
    for fragment, peaks in DATASHEETS:
        if fragment in name:
            return Peaks(*peaks)
    raise ValueError(f"no data sheet for card {name!r}")


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, as it prints
    them, or why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


class Work(NamedTuple):
    flops: float
    nbytes: float
    on_tensor_cores: bool  # bf16 tensor-core peak, else the f32 peak


def least_s(w: Work, peaks: Peaks) -> float:
    flops_peak = peaks.bf16_flops if w.on_tensor_cores else peaks.fp32_flops
    return max(w.flops / flops_peak, w.nbytes / peaks.hbm_bytes_s)


def words_per_row(n_items: int) -> int:
    """Packed words a row of B needs: one bit a column. The kernels pad
    columns to tiles of 4,096; what the padding reads is not counted."""
    return -(-n_items // 32)


# -- the propagation cache (K3 forward, K4 backward) --------------------------


def k3(rows: int, n: int, d: int) -> Work:
    """reps (R, d) f32 = P[rows] @ X0: R rows of the bf16 P (n columns), X0
    (n, d) bf16 read once, the f32 output written once; 2 R n d operations
    on the bf16 tensor cores."""
    return Work(2.0 * rows * n * d, rows * n * 2 + n * d * 2 + rows * d * 4,
                True)


def k4(rows: int, n: int, d: int) -> Work:
    """dX0 (n, d) f32 = P[rows]^T @ ct: R rows of P, ct (R, d) bf16, the f32
    output written once."""
    return Work(2.0 * rows * n * d, rows * n * 2 + rows * d * 2 + n * d * 4,
                True)


# -- the bit-packed products (K1, K2) and the mask pair (K8p) -----------------


def b_bytes(n_users: int, n_items: int) -> int:
    return n_users * words_per_row(n_items) * 4


def k1(n_users: int, n_items: int, nnz: int, d: int) -> Work:
    """Y (n_users, d) f32 = B @ X, X (n_items, d) bf16: B's words, X and Y
    once each; 2 nnz d operations over B's set bits (never at a dense
    rate)."""
    return Work(2.0 * nnz * d,
                b_bytes(n_users, n_items) + n_items * d * 2 + n_users * d * 4,
                True)


def k2(n_users: int, n_items: int, nnz: int, d: int) -> Work:
    """Y (n_items, d) f32 = B^T @ X, X (n_users, d) bf16."""
    return Work(2.0 * nnz * d,
                b_bytes(n_users, n_items) + n_users * d * 2 + n_items * d * 4,
                True)


def k8p(n_users: int, n_items: int) -> Work:
    """B read once, its two masked copies written."""
    return Work(0.0, 3 * b_bytes(n_users, n_items), False)


# -- retrieval (K5) -----------------------------------------------------------


def k5(users: int, n_items: int, d: int, k: int) -> Work:
    """Top-k ids of ``users`` over every item by f32 dot products: users x
    items x d x 2 operations at the f32 peak; the users' rows, the items'
    table, the users' exclusion words and the ids once each."""
    return Work(2.0 * users * n_items * d,
                users * d * 4 + n_items * d * 4
                + users * words_per_row(n_items) * 4 + users * k * 4, False)


# -- a whole training step ----------------------------------------------------

# operations an Adam update spends on one parameter: two moment updates (3
# and 4), the bias corrections, the square root, the division by it plus
# epsilon, and the scaled subtraction
ADAM_FLOPS_PER_PARAM = 12


def train_step_flops(model: str, n_users: int, n_items: int, nnz: int,
                     d: int, n_layers: int, batch: int,
                     n_params: int) -> float:
    """The operations of one training step of the reference algorithm,
    whatever engine computes it: K layers of full-graph propagation over
    the 2 nnz entries of the normalised adjacency, forward and backward;
    IGCN's feature aggregation over B's set bits in both directions,
    forward and backward; the scores of the batch's positive and negative
    pairs, forward and backward (and IGCN's auxiliary pairs); Adam."""
    prop = n_layers * 2 * (2.0 * 2 * nnz * d)
    step = prop
    pairs = 2 * batch
    if model == "IGCN":
        step += 2 * (2.0 * 2 * nnz * d)
        pairs += 2 * batch
    step += 3 * pairs * 2.0 * d
    return step + ADAM_FLOPS_PER_PARAM * n_params
