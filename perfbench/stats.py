"""Arithmetic of the benchmark's numbers: quartile spreads, and the union
of device-busy intervals."""

from __future__ import annotations

import statistics


def spread(values) -> float:
    """Distance between the first and third quartiles over the median,
    with ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(intervals) -> list:
    """Merge (start, end) intervals into disjoint sorted ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered(intervals) -> float:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) stretches of [lo, hi] outside the intervals."""
    out, at = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def passed(checks) -> bool:
    """Every compared number within its limit: at most the limit, or at
    least it where the check is a count that must be reached (``min``)."""
    return all(c["value"] >= c["limit"] if c.get("min") else c["value"] <= c["limit"]
               for c in checks)
