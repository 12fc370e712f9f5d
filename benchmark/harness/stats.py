"""The metric arithmetic: rates over a whole window, tail percentiles over
every frame, busy time as a union of intervals, roofline shares."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, and HBM3
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# float32 operations of one Moller-Trumbore test: stage 1 (the cross
# product, det, |det| test and u) for every test, the rest (q, v, t and
# their tests) where stage 1 passes; and the sampling and shading of a
# path segment (half the ~300 a lane-iteration of two rays counts)
MT_STAGE1_OPS = 28.0
MT_STAGE2_OPS = 30.0
SEGMENT_OPS = 150.0


def rate(count: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value:
    the smallest value that at least q% of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches [start, end) of [lo, hi) outside the union."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_pct(busy: float, window: float) -> float:
    """Share of the window in which the device ran nothing, in %."""
    return 100.0 * (1.0 - busy / window)


def least_ms(ops: float, n_bytes: float) -> Tuple[float, str]:
    """The least time in ms the card could take, and its bound."""
    t_ops = ops / FP32_PEAK * 1e3
    t_bytes = n_bytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def brute_force_ops(tests: float, stage1_passes: float, segments: float) -> float:
    """Float32 operations of a brute-force tracer that makes `tests`
    (segment, triangle) tests, `stage1_passes` of them past stage 1,
    over `segments` path segments."""
    return (MT_STAGE1_OPS * tests + MT_STAGE2_OPS * stage1_passes
            + SEGMENT_OPS * segments)
