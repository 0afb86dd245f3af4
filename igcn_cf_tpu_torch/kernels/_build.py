"""Build and bind the hand-written CUDA kernels in ``csrc/``.

At first use, every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one compiler process per source in parallel, and linked into
one shared library with a plain C interface, loaded with ctypes. The
library lands in ``igcn_cf_tpu_torch/build/`` under a name keyed on a hash
of the sources and flags, so an edit rebuilds and an unchanged tree reuses
the library. Nothing is fetched.

A missing ``nvcc`` or a failed build raises: a CUDA tensor never falls back
to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from igcn_cf_tpu_torch.utils import spans

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-Xcompiler", "-fPIC", "-std=c++17",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# Launches of each kernel, counted by its wrapper (``counted``) when the
# block around a launch exits with no error. A run resets them to show which
# kernels it went through. A CUDA graph's replay runs the kernels it captured
# with no wrapper call, so it adds nothing here (``train/step_graph.py``).
# K1m/K2m and K6m/K7m are the masked variants of K1/K2 and K6/K7 (edge
# dropout inside the kernel), K8p is K8's two-seed pair; T1/T2 are the 4-D
# gather kernels of ``tools/microbench_pcache``, T3/T4 their tuning
# variants of ``tools/microbench_pcache_tune`` and T5 the gather probe of
# ``tools/microbench_gather``. K7m_rows counts the K7m launches that took
# the rows route over a transposed pack (``bitpack.mm_bwd_masked_rows``):
# each is a K7m launch too, so K7m_rows / K7m is the route's share.
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0,
            "K6m": 0, "K7m": 0, "K7m_rows": 0, "K8": 0, "K8p": 0, "K1m": 0,
            "K2m": 0, "T1": 0, "T2": 0, "T3": 0, "T4": 0, "T5": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C entry points: every pointer and the stream as c_void_p, every int as
# c_int; each returns cudaGetLastError() after its launches. The stream is
# the last argument and is added by ``launch``.
_SIGNATURES = {
    # t1 body: (wp, x (K, d) bf16, y (m, d) f32, m, kw, d, stream), d a
    # multiple of 8; the masked entries take (seed, thr) before the stream
    "igcn_t1": (_P, _P, _P, _I, _I, _I, _P),
    "igcn_bb_fwd": (_P, _P, _P, _I, _I, _I, _P),
    "igcn_t1_masked": (_P, _P, _P, _I, _I, _I, _U, _I, _P),
    "igcn_bb_fwd_masked": (_P, _P, _P, _I, _I, _I, _U, _I, _P),
    # t2 body: (wp, x (m, d) bf16, part (splits, K, d) f32, y (K, d) f32, m,
    # kw, d, splits, stream); the masked entries take (seed, thr) before
    # the stream
    "igcn_t2": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "igcn_bb_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "igcn_t2_masked": (_P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _P),
    "igcn_bb_bwd_masked": (_P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _P),
    # K7m's rows route: (wt, order, x (rows, d) bf16, y (n_out, d) f32, mt,
    # n_out, kwt, d, n_heavy, seed, thr, stream)
    "igcn_bb_bwd_masked_rows": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _I,
                                _P),
    # (wp, out, m, kw, seed, thr, stream)
    "igcn_mask_words": (_P, _P, _I, _I, _U, _I, _P),
    # (wp, out_a, out_b, m, kw, seed_a, seed_b, thr, stream)
    "igcn_mask_words_pair": (_P, _P, _P, _I, _I, _U, _U, _I, _P),
    # (p, rows, x0, part, out, n, npad, r, dpad, splits, stream)
    "igcn_gather_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (p, rows, ct, dx, n, npad, r, dpad, stream)
    "igcn_gather_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (p4, rows, x0, part, out, n, nj, tkc, r, dpad, tr, splits, stream)
    "igcn_fused_fwd_4d": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # (p4, rows, ct, dx, n, nj, tkc, r, dpad, tr, stream): K4's body, rows
    # 16-byte aligned
    "igcn_fused_bwd_4d": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (p4, rows, x0, part, out, n, nj, tkc, r, dpad, tr, splits, resident,
    #  stream)
    "igcn_fused_fwd_tune": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P),
    # (p4, rows, ct, dxt, n, nj, tkc, r, dpad, tr, stream): K4's body, rows
    # 16-byte aligned
    "igcn_fused_bwd_t": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (x, idx, out, n, reps, w, pitch, rows_per_range, row_ranges, grid,
    #  padded, sorted, bf16, stream): microbench_gather.launch_plan's plan
    "igcn_gather_chain": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    # (users, items_t, excl, banned, scratch, out, n_users, n_items_pad, d,
    #  k, li, splits, stream)
    "igcn_fused_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}

_lib = None


@functools.lru_cache(maxsize=1024)
def splits(entry: str, device: int, *shape: int) -> int:
    """The split count that C helper ``entry`` chooses at ``shape`` (ints)
    on card ``device``, asked once a shape: the runtime's occupancy query
    behind it costs host time that every launch would pay."""
    with torch.cuda.device(device):
        return getattr(library(), entry)(*shape)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _Count:
    """Counts a launch of ``kid`` when the block exits cleanly."""

    __slots__ = ("kid",)

    def __init__(self, kid: str):
        self.kid = kid

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            LAUNCHES[self.kid] += 1


class _CountedSpan(spans.Span):
    __slots__ = ("kid",)

    def __init__(self, kid: str):
        super().__init__("kernel." + kid)
        self.kid = kid

    def __exit__(self, exc_type, exc, tb):
        super().__exit__(exc_type, exc, tb)
        if exc_type is None:
            LAUNCHES[self.kid] += 1


_COUNTS = {kid: _Count(kid) for kid in LAUNCHES}


def counted(kid: str):
    """A launch wrapper's block, from its entry to the launch's return:
    counts the launch in ``LAUNCHES[kid]`` when the block exits with no
    error and, while spans are on, records it as span ``kernel.<kid>``
    (the wrapper's host cost of one launch)."""
    if spans.active():
        return _CountedSpan(kid)
    return _COUNTS[kid]


def require_device(device) -> torch.device:
    """``device`` as a torch.device, refused when it names CUDA and no card
    is visible: an entry point that defaults to the card raises there and
    never carries on on the CPU. Pass ``device="cpu"`` for the plain
    versions."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; pass "
            "device='cpu' to run the plain versions on the CPU")
    return device


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of igcn_cf_tpu_torch cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libigcn_kernels_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise with the first failure's output."""
    failed = None
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, stdout + stderr)
    if failed:
        cmd, code, text = failed
        raise RuntimeError(f"nvcc failed with code {code}:\n{' '.join(cmd)}\n"
                           f"{text}")


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one nvcc per source, all started together, then one link. Returns the
    library's path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        _run(procs)
        cmd = [nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.igcn_error_string.argtypes = [ctypes.c_int]
        lib.igcn_error_string.restype = ctypes.c_char_p
        lib.igcn_fused_topk_splits.argtypes = [ctypes.c_int] * 3
        lib.igcn_fused_topk_splits.restype = ctypes.c_int
        lib.igcn_fused_topk_launch_shape.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.igcn_fused_topk_launch_shape.restype = None
        lib.igcn_fused_topk_scratch_words.argtypes = [ctypes.c_int] * 4
        lib.igcn_fused_topk_scratch_words.restype = ctypes.c_longlong
        lib.igcn_gather_fwd_splits.argtypes = [ctypes.c_int] * 3
        lib.igcn_gather_fwd_splits.restype = ctypes.c_int
        lib.igcn_gather_fwd_launch_shape.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.igcn_gather_fwd_launch_shape.restype = None
        lib.igcn_gather_bwd_launch_shape.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.igcn_gather_bwd_launch_shape.restype = None
        lib.igcn_fused_bwd_4d_launch_shape.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.igcn_fused_bwd_4d_launch_shape.restype = None
        lib.igcn_t2_splits.argtypes = [ctypes.c_int] * 3
        lib.igcn_t2_splits.restype = ctypes.c_int
        lib.igcn_fused_fwd_splits.argtypes = [ctypes.c_int] * 4
        lib.igcn_fused_fwd_splits.restype = ctypes.c_int
        lib.igcn_fused_fwd_launch_shape.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.igcn_fused_fwd_launch_shape.restype = None
        lib.igcn_pair_launch_shape.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.igcn_pair_launch_shape.restype = None
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` with tensors passed as device pointers, on the
    current stream of the tensors' device. Raises if the launch failed."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    # no device switch when the device is already current: a launch's host
    # time counts wherever the card waits on the host
    if dev.index == torch.cuda.current_device():
        err = getattr(lib, name)(*c_args, stream)
    else:
        with torch.cuda.device(dev):
            err = getattr(lib, name)(*c_args, stream)
    if err != 0:
        msg = lib.igcn_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
