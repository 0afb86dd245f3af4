"""Reading the device's work out of a ``torch.profiler`` trace.

The harness wraps each call into a layer in a ``record_function`` range
and the traced part of the window in ``"window"``. Each device activity
(kernel, copy, fill) is tied to the runtime call that launched it on the
host by its correlation id (or, where the profiler kept no runtime call, to
the host op it is linked to); the call's start falls inside the innermost
of the ranges that were open, and the activity's time is charged to that
range. Kernels the program launches through its own library run under no
PyTorch op, so the runtime call is what places them. The device's busy
time is the union of every activity's interval inside the window.

Kernels are named by the family of the program's hand-written kernels they
belong to (``FAMILIES``); a split-sum pass belongs to the kernel it follows
on its stream.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

from benchmark.window import busy, gaps

WINDOW = "window"

# substrings of the demangled kernel names of ``igcn_cf_tpu_torch/csrc``
# that the cells' windows run -> the kernel ids of PERF.md's table
FAMILIES = (
    ("fused_fwd_4d_kernel", "K3"),
    ("gather_bwd_kernel", "K4"),
    ("t1_kernel", "K1"),
    ("t2_kernel", "K2"),
    ("mask_words_kernel", "K8p"),
    ("transpose_users_kernel", "K5"),
    ("topk_range_kernel", "K5"),
    ("merge_topk_kernel", "K5"),
)
SPLIT_SUM = "sum_splits_kernel"


def family(name: str) -> str | None:
    for fragment, kid in FAMILIES:
        if fragment in name:
            return kid
    return None


@dataclass
class Trace:
    """What one traced window did on the device. Seconds throughout."""

    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_count: int = 0
    by_range: dict = field(default_factory=dict)  # range -> device s
    families: dict = field(default_factory=dict)  # kernel id -> [count, s]
    top_ops: list = field(default_factory=list)  # [[name, s]] by time
    idle_by_host: list = field(default_factory=list)  # [[range, s]]


@dataclass
class _Activity:
    start: int
    end: int
    name: str
    stream: int
    corr: int
    linked: int
    kernel: bool


def _kind(e) -> str | None:
    """'kernel', 'copy' or None (not device work) for a device event."""
    get = getattr(e, "activity_type", None)
    act = get() if get else None
    if act is not None:
        act = str(act).lower()
        if "kernel" in act:
            return "kernel"
        if "memcpy" in act or "memset" in act:
            return "copy"
        return None
    name = e.name()
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"


class _Ranges:
    """Ranges open on the host timeline. A range never nests in one of its
    own name, so each name's spans are disjoint; where several names cover
    a time, the shortest span is the innermost."""

    def __init__(self, spans: dict):
        self._spans = {n: sorted(ss) for n, ss in spans.items()}
        self._starts = {n: [s for s, _ in ss] for n, ss in self._spans.items()}

    def at(self, t: int) -> str | None:
        best, best_len = None, None
        for n, ss in self._spans.items():
            i = bisect.bisect_right(self._starts[n], t) - 1
            if i >= 0 and t < ss[i][1]:
                length = ss[i][1] - ss[i][0]
                if best is None or length < best_len:
                    best, best_len = n, length
        return best


def device_busy_s(prof, device) -> float:
    """Seconds in which the device worked during a finished profile: the
    union of every kernel, copy and fill interval. A profile of the CPU
    alone (no card) reads the union of its operators instead."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if device.type == "cuda" else DeviceType.CPU
    spans = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == want and not e.is_user_annotation()
             and (want == DeviceType.CPU or _kind(e) is not None)]
    if not spans:
        return 0.0
    lo = min(s for s, _ in spans)
    hi = max(e for _, e in spans)
    return busy(spans, lo, hi) / 1e9


def summarize(prof, ranges) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile`` whose window
    is the ``WINDOW`` range. ``ranges`` names the layer ranges to charge."""
    from torch.autograd import DeviceType

    names = set(ranges) | {WINDOW}
    spans = defaultdict(list)
    op_at: dict[int, int] = {}  # host op id -> start
    call_at: dict[int, int] = {}  # runtime call's correlation id -> start
    acts: list[_Activity] = []
    for e in prof.profiler.kineto_results.events():
        dt = e.device_type()
        if dt == DeviceType.CPU:
            name = e.name()
            if e.is_user_annotation():
                if name in names:
                    spans[name].append((e.start_ns(), e.end_ns()))
            elif name.startswith("cu"):  # a CUDA runtime or driver call
                call_at[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:
                op_at[e.correlation_id()] = e.start_ns()
        elif dt == DeviceType.CUDA and not e.is_user_annotation():
            kind = _kind(e)
            if kind is not None:
                acts.append(_Activity(e.start_ns(), e.end_ns(), e.name(),
                                      getattr(e, "device_resource_id",
                                              lambda: 0)(),
                                      e.correlation_id(),
                                      e.linked_correlation_id(),
                                      kind == "kernel"))
    if not spans[WINDOW]:
        raise ValueError("the trace has no window range")
    lo = min(s for s, _ in spans[WINDOW])
    hi = max(e for _, e in spans[WINDOW])
    acts = [a for a in acts if a.end > lo and a.start < hi]
    acts.sort(key=lambda a: a.start)
    layer = _Ranges({n: s for n, s in spans.items() if n != WINDOW})

    t = Trace(window_s=(hi - lo) / 1e9)
    t.busy_s = busy(((a.start, a.end) for a in acts), lo, hi) / 1e9
    by_range = defaultdict(float)
    fams = defaultdict(lambda: [0, 0.0])
    ops = defaultdict(float)
    last_family: dict[int, str | None] = {}
    for a in acts:
        dur = (a.end - a.start) / 1e9
        ops[a.name] += dur
        host_t = call_at.get(a.corr, op_at.get(a.linked))
        rng = layer.at(host_t) if host_t is not None else None
        by_range[rng or "unattributed"] += dur
        if not a.kernel:
            continue
        t.kernel_count += 1
        if SPLIT_SUM in a.name:
            kid = last_family.get(a.stream)
            if kid is not None:
                fams[kid][1] += dur
            continue
        kid = family(a.name)
        last_family[a.stream] = kid
        if kid is not None:
            fams[kid][0] += 1
            fams[kid][1] += dur
    t.by_range = dict(by_range)
    t.families = {k: list(v) for k, v in fams.items()}
    t.top_ops = [[n, s] for n, s in
                 sorted(ops.items(), key=lambda kv: -kv[1])[:10]]
    idle = defaultdict(float)
    for s, e in gaps(((a.start, a.end) for a in acts), lo, hi):
        idle[layer.at(s) or "between ranges"] += (e - s) / 1e9
    t.idle_by_host = [[n, s] for n, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]]
    return t
