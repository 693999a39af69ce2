"""Device time inside many short program spans in one pass: the union of
the window's device intervals is built once, and each span's part of it
is found by bisection (``_device.busy_ns`` clips every interval to every
span, which a traced run of millions of kernels and a thousand spans
cannot afford)."""

from __future__ import annotations

import bisect

from perfbench import stats


def busy_ns(run, spans) -> float:
    """ns of the union of every device interval (kernels, copies and
    memsets) that lies inside the disjoint ``spans`` ((start, end) ns)."""
    union = stats.union([(s, e) for _n, s, e, _c in run.events])
    starts = [s for s, _e in union]
    ends = [e for _s, e in union]
    cum = [0]
    for s, e in union:
        cum.append(cum[-1] + e - s)
    total = 0
    for lo, hi in spans:
        i = bisect.bisect_right(ends, lo)  # the first interval ending after lo
        j = bisect.bisect_left(starts, hi)  # the first starting at or after hi
        if i < j:
            total += (cum[j] - cum[i] - max(0, lo - starts[i])
                      - max(0, ends[j - 1] - hi))
    return total
