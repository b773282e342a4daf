"""Arithmetic of the metrics, kept apart from the harness so that tests
can hold it against hand-made inputs."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_length(intervals, lo: float, hi: float) -> float:
    """Total length of the union of (start, end) intervals, clipped to
    [lo, hi]."""
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


def gaps(intervals, lo: float, hi: float):
    """The idle stretches of [lo, hi] that no interval covers, as
    (start, end), in time order."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]
