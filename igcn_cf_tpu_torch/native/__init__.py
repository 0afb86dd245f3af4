"""ctypes bindings of the native (C++) data-path kernels (port of
``igcn_cf_tpu/native/__init__.py``).

``kcore.cpp`` (a copy of the JAX package's) is compiled with ``g++`` at
first use into ``igcn_cf_tpu_torch/build/``, under a name keyed on a hash
of the source and flags, and bound with ctypes (a plain C interface). A
missing compiler or a failed build raises: ``kcore_filter`` and
``dedup_earliest`` never fall back quietly. Their numpy versions,
``kcore_filter_numpy`` and ``dedup_earliest_numpy``, are the tests' oracle
and may be called by name.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "kcore.cpp"
BUILD_DIR = SOURCE.parents[1] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _build() -> Path:
    """The shared library of ``kcore.cpp``, compiled unless a build of the
    same source and flags is there. Written under a temporary name and
    renamed, so concurrent builds never load a half-written file."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the native data kernels need a C++ compiler "
                           "(g++, or $CXX) on the PATH")
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libigcn_native_{digest.hexdigest()[:12]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{out.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The bound library, built at the first call."""
    lib = ctypes.CDLL(str(_build()))
    lib.kcore_filter.restype = ctypes.c_int64
    lib.kcore_filter.argtypes = [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _U8P, _I64P, _I64P,
    ]
    lib.dedup_earliest.restype = ctypes.c_int64
    lib.dedup_earliest.argtypes = [
        _I64P, _I64P, _I64P, ctypes.c_int64, _I64P, _I64P,
    ]
    return lib


def _p(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def _ids(a, n: int, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.int64)
    if len(a) and (a.min() < 0 or a.max() >= n):
        raise ValueError(f"{what} ids must lie in [0, {n})")
    return a


def kcore_filter(
    users: np.ndarray, items: np.ndarray, n_users: int, n_items: int,
    min_inter: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Iterative bipartite k-core peel (reference dataset.py:66-92:
    surviving nodes get dense ids in first-appearance order over the edge
    list). Returns (keep_mask bool (E,), user_map (n_users,), item_map
    (n_items,)) with -1 for dropped nodes."""
    users = _ids(users, n_users, "user")
    items = _ids(items, n_items, "item")
    if len(users) != len(items):
        raise ValueError("users and items must have one entry an edge")
    keep = np.zeros(len(users), dtype=np.uint8)
    user_map = np.empty(n_users, dtype=np.int64)
    item_map = np.empty(n_items, dtype=np.int64)
    library().kcore_filter(
        _p(users, _I64P), _p(items, _I64P), len(users), n_users, n_items,
        min_inter, _p(keep, _U8P), _p(user_map, _I64P), _p(item_map, _I64P),
    )
    return keep.astype(bool), user_map, item_map


def kcore_filter_numpy(users, items, n_users, n_items, min_inter):
    """``kcore_filter`` by round-based peeling in numpy."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    alive = np.ones(len(users), dtype=bool)
    while True:
        deg_u = np.bincount(users[alive], minlength=n_users)
        deg_i = np.bincount(items[alive], minlength=n_items)
        bad = (deg_u[users] < min_inter) | (deg_i[items] < min_inter)
        bad &= alive
        if not bad.any():
            break
        alive &= ~bad
    user_map = np.full(n_users, -1, dtype=np.int64)
    item_map = np.full(n_items, -1, dtype=np.int64)
    # first-appearance dense ids
    for ids, out in ((users[alive], user_map), (items[alive], item_map)):
        keys, first = np.unique(ids, return_index=True)
        out[keys[np.argsort(first)]] = np.arange(len(keys))
    return alive, user_map, item_map


def dedup_earliest(
    users: np.ndarray, items: np.ndarray, times: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate (user, item) records keeping the earliest timestamp, in
    first-appearance order (reference dataset.py:28-37). Returns (indices
    of the surviving records, their earliest timestamps)."""
    users = np.ascontiguousarray(users, dtype=np.int64)
    items = np.ascontiguousarray(items, dtype=np.int64)
    times = np.ascontiguousarray(times, dtype=np.int64)
    n = len(users)
    if not len(items) == len(times) == n:
        raise ValueError("users, items and times must have one entry a record")
    order = np.empty(n, dtype=np.int64)
    t_out = np.empty(n, dtype=np.int64)
    kept = library().dedup_earliest(
        _p(users, _I64P), _p(items, _I64P), _p(times, _I64P), n,
        _p(order, _I64P), _p(t_out, _I64P),
    )
    return order[:kept], t_out[:kept]


def dedup_earliest_numpy(users, items, times):
    """``dedup_earliest`` with a dict over the records in order."""
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    first, tmin = {}, {}
    for e, key in enumerate(zip(users.tolist(), items.tolist())):
        if key in first:
            tmin[key] = min(tmin[key], int(times[e]))
        else:
            first[key] = e
            tmin[key] = int(times[e])
    idx = np.array(sorted(first.values()), dtype=np.int64)
    t = np.array([tmin[(int(users[e]), int(items[e]))] for e in idx],
                 dtype=np.int64)
    return idx, t
