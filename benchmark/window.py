"""The arithmetic of a measured window: rates over the whole window, a tail
over every request, and the device's busy time as a union of intervals."""

from __future__ import annotations

import math
from typing import Iterable, Sequence


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) of every value, nearest rank: the
    smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def merge(intervals: Iterable[tuple[float, float]]) -> list:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals: Iterable[tuple[float, float]], lo: float,
         hi: float) -> float:
    """Length of the union of the intervals inside [lo, hi)."""
    total = 0.0
    for s, e in merge(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(intervals: Iterable[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers."""
    out, t = [], lo
    for s, e in merge(intervals):
        if e <= lo or s >= hi:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out
