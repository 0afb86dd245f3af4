"""The multi-device substrate on ``torch.distributed`` (port of
``igcn_cf_tpu/core/mesh.py``).

A 2-D logical mesh of ``data`` x ``table`` ranks:

  * ``data``  -- batch-parallel axis: each data row takes a slice of the
    BPR batch, and losses and gradients are averaged over it;
  * ``table`` -- node/catalog axis: the rows of the embedding table, the
    node representations and the item axis of score matrices are split in
    contiguous row blocks, one a table rank.

The JAX package runs one process that drives every device of its mesh. The
port runs one process a shard: rank ``r = d * table + t`` holds the row
block ``t`` of every table-sharded array and the batch slice ``d``. Host
graph builds are deterministic numpy, run on every rank, which keeps its own
block. ``make_mesh`` creates a ``table_group`` (the ranks of one data row)
and a ``data_group`` (the ranks of one table column) for this rank; every
rank creates every group, in the same order, as ``dist.new_group`` requires.

Backend and device: ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``, unless
the caller names one. There is no switch from one to the other and no
carrying on on the CPU where no card is found. NCCL takes one rank a card;
two ranks on one card run over gloo with CUDA tensors, named explicitly.
Launch: ``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT`` take the place of the JAX package's
``JAX_COORDINATOR_ADDRESS``; without them, and with a world of 1,
``initialize_distributed`` starts a one-rank group, so NCCL really runs at
a 1x1 mesh. ``spawn_world`` starts a world of processes on this host for
tests and tools, rendezvousing through a file.

Differentiable collectives, with the gradients of the JAX package's
``shard_map`` programs. Every table rank computes the same replicated loss,
and a value that is replicated over the table ranks carries the same
cotangent on each of them. So:

  * ``psum`` (table): the partial sums' cotangent is the sum's, unchanged;
  * ``all_gather`` (table, tiled rows): a gathered operand consumed
    shard-locally (``local=True``: each rank's consumer differs) sums its
    cotangent over the table ranks, then keeps this rank's rows; one
    consumed by the replicated loss (``local=False``) keeps this rank's
    rows of the cotangent as it is;
  * ``pmean`` (data): the mean's cotangent, unchanged; the gradient of a
    parameter replicated over ``data`` is averaged over it afterwards
    (``average_grads``), and the gradient of a parameter replicated over
    ``table`` but used shard-locally is summed over the table ranks
    (``sum_grads``).

Only ``all_reduce``, ``all_gather`` and ``broadcast`` run, which gloo and
NCCL both take.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import uuid
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from igcn_cf_tpu_torch.kernels import _build

# A collective that waits longer than this raises, so a rank that died or
# never joined fails the world instead of hanging it.
DEFAULT_TIMEOUT_S = 300

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(backend: str = "gloo",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group, once per process. Under a launcher
    (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` set) every process joins the launcher's world; without
    one this process starts a world of one rank over an in-process store.
    A group that is already up is kept as it is."""
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if all(v in os.environ for v in _LAUNCHER_VARS):
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    if "WORLD_SIZE" in os.environ and int(os.environ["WORLD_SIZE"]) != 1:
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no launcher "
            "rendezvous (MASTER_ADDR/MASTER_PORT): start the processes with "
            "torchrun")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timeout)


@dataclass
class Mesh:
    """This rank's view of a (data, table) mesh."""

    data: int
    table: int
    d: int  # this rank's data coordinate
    t: int  # this rank's table coordinate
    device: torch.device
    backend: str
    table_group: object  # the ranks (d, 0 .. table-1)
    data_group: object  # the ranks (0 .. data-1, t)

    @property
    def rank(self) -> int:
        return self.d * self.table + self.t

    @property
    def size(self) -> int:
        return self.data * self.table


def _rank_device(device) -> torch.device:
    """``device`` for this rank: on CUDA without an index, card
    ``LOCAL_RANK`` modulo the visible cards (ranks that share a card run
    over gloo)."""
    device = _build.require_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def make_mesh(data: int = 1, table: int | None = None, *, device="cuda",
              backend: str | None = None) -> Mesh:
    """The (data, table) mesh over this process group, which
    ``initialize_distributed`` starts if it is not up. ``table`` defaults to
    the world size over ``data``. The world must hold exactly data * table
    ranks. ``backend`` defaults to ``default_backend(device)``; a group
    already up must run that backend."""
    device = _build.require_device(device)
    backend = backend or default_backend(device)
    initialize_distributed(backend)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not "
                         f"the requested {backend}")
    world = dist.get_world_size()
    if table is None:
        table = world // data
    if data < 1 or table < 1 or data * table != world:
        raise ValueError(
            f"mesh {data}x{table} needs {data * table} processes, the world "
            f"has {world}: launch one process a shard, e.g. torchrun "
            f"--nproc-per-node {data * table} -m igcn_cf_tpu_torch.cli.main "
            f"... --mesh {data}x{table}")
    rank = dist.get_rank()
    d, t = divmod(rank, table)
    rank_device = _rank_device(device)
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    table_group = data_group = None
    # every rank creates every group, in one order (dist.new_group is
    # collective)
    for dd in range(data):
        g = dist.new_group([dd * table + tt for tt in range(table)])
        if dd == d:
            table_group = g
    for tt in range(table):
        g = dist.new_group([dd * table + tt for dd in range(data)])
        if tt == t:
            data_group = g
    return Mesh(data, table, d, t, rank_device, backend, table_group,
                data_group)


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


# -- plain collectives (no autograd) --------------------------------------------


def _gather_list(x: torch.Tensor, group, size: int) -> list:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def gather_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The table ranks' blocks of ``x`` concatenated along ``dim`` in rank
    order, on every table rank (no gradient)."""
    return torch.cat(_gather_list(x.detach(), mesh.table_group, mesh.table),
                     dim=dim)


def gather_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data ranks' ``x`` concatenated along dim 0 in rank order, on
    every data rank (no gradient): a trial mesh's per-rank results."""
    return torch.cat(_gather_list(x.detach(), mesh.data_group, mesh.data))


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place; returns ``x``."""
    dist.all_reduce(x, group=group)
    return x


def to_host_replicated(x: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """A table-sharded array's row blocks gathered to host numpy (a copy),
    the whole array on every rank (checkpoints, tests)."""
    return gather_rows(x, mesh).cpu().numpy()


def row_block(x, t: int, rows: int):
    """Rows [t * rows, (t + 1) * rows) of a replicated array: the block a
    table rank holds (zero-padded past the array's end), the counterpart of
    the JAX package's ``reshard`` onto a table-sharded layout."""
    lo = t * rows
    block = x[lo: lo + rows]
    if block.shape[0] == rows:
        return block
    if isinstance(block, torch.Tensor):
        pad = block.new_zeros((rows - block.shape[0],) + tuple(block.shape[1:]))
        return torch.cat([block, pad])
    pad = np.zeros((rows - block.shape[0],) + block.shape[1:], block.dtype)
    return np.concatenate([block, pad])


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's ``obj`` (anything picklable) on every rank of the world, so
    that what rank 0 alone can read (its files) reaches ranks on other
    hosts."""
    box = [obj if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh: Mesh) -> None:
    """Every rank of the world reaches this point (an all_reduce on the
    mesh's device, which NCCL's ``barrier`` would guess at)."""
    dist.all_reduce(torch.zeros(1, device=mesh.device))


# -- differentiable collectives --------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, local):
        ctx.mesh, ctx.local, ctx.rows = mesh, local, x.shape[0]
        return gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, ct):
        mesh = ctx.mesh
        if ctx.local:
            ct = all_reduce_(ct.contiguous().clone(), mesh.table_group)
        lo = mesh.t * ctx.rows
        return ct[lo: lo + ctx.rows], None, None


def all_gather(x: torch.Tensor, mesh: Mesh, local: bool = True) -> torch.Tensor:
    """The table ranks' row blocks of ``x`` concatenated in rank order
    (``jax.lax.all_gather(..., tiled=True)`` along ``table``). ``local``:
    the result feeds a shard-local computation, so the backward sums the
    cotangents of the table ranks before keeping this rank's rows; False
    for a result the replicated loss consumes."""
    return _AllGather.apply(x, mesh, local)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        out = all_reduce_(x.detach().contiguous().clone(), group)
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the table ranks (``jax.lax.psum`` along ``table``). The sum
    feeds the replicated loss, so each partial's cotangent is the sum's."""
    return _Sum.apply(x, mesh.table_group, 1.0)


def pmean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mean over the data ranks (``jax.lax.pmean`` along ``data``). The
    cotangent passes unchanged; ``average_grads`` then averages the
    gradients of the parameters the data ranks share."""
    return _Sum.apply(x, mesh.data_group, 1.0 / mesh.data)


@torch.no_grad()
def average_grads(params: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average each parameter's gradient over the data ranks: the
    parameters are replicated over ``data`` and each data rank saw its own
    slice of the batch."""
    if mesh.data == 1:
        return
    for p in params:
        if p.grad is not None:
            all_reduce_(p.grad, mesh.data_group).div_(mesh.data)


@torch.no_grad()
def sum_grads(params: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum each parameter's gradient over the table ranks: for parameters
    replicated over ``table`` whose every use is shard-local (each rank's
    gradient covers only its own rows' terms)."""
    for p in params:
        if p.grad is not None:
            all_reduce_(p.grad, mesh.table_group)


# -- worlds of processes on this host ---------------------------------------------


def _world_entry(rank, fn, world, backend, init_file, out_dir, timeout_s,
                 args):
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        if dist.is_initialized():  # fn may have torn it down itself
            dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, backend: str, rendezvous_dir: str,
                *args, timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes joined in one
    process group of ``backend``, rendezvousing through a new file in
    ``rendezvous_dir`` (no TCP port, so worlds may run side by side).
    ``fn`` must be importable by module name in a fresh interpreter and
    return something picklable. Returns the ranks' results in rank order.
    Any rank's exception fails the call; so does the world outlasting
    ``timeout_s``, after which its processes are terminated."""
    import torch.multiprocessing as mp

    run_dir = os.path.join(rendezvous_dir, f"world_{uuid.uuid4().hex}")
    os.makedirs(run_dir)
    init_file = os.path.join(run_dir, "rendezvous")
    ctx = mp.start_processes(
        _world_entry,
        args=(fn, world, backend, init_file, run_dir,
              min(timeout_s, DEFAULT_TIMEOUT_S), args),
        nprocs=world, join=False, start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
    try:
        while not ctx.join(timeout=1.0):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"world of {world} outlasted {timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    results = []
    for rank in range(world):
        with open(os.path.join(run_dir, f"result_{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
