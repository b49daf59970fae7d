"""The benchmark's arithmetic on measured numbers: time per item and rates
over a whole window, percentiles over every sample, and the union of
device intervals and its gaps."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all `values`, by linear interpolation
    between the closest ranks (numpy's default rule)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def per_item_ms(start_s: float, end_s: float, items: int) -> float:
    """Wall milliseconds of the window [start_s, end_s] per item done in it."""
    if items <= 0:
        raise ValueError("no item completed in the window")
    return (end_s - start_s) * 1e3 / items


def rate(items: int, start_s: float, end_s: float) -> float:
    """Items a second over the window [start_s, end_s]."""
    if end_s <= start_s:
        raise ValueError("an empty window")
    return items / (end_s - start_s)


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
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


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]
