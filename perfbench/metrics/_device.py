"""Shared arithmetic of the device-trace readers: intervals of a kind
within the window, or within spans of it."""

from __future__ import annotations

from .. import stats


def intervals(run, copies: bool | None, spans=None) -> list:
    """(start, end) ns of the window's device ops: copies (memcpy and
    memset) with ``copies=True``, kernels with False, all with None;
    clipped to the window, or to each of ``spans`` where given."""
    ops = [(s, e) for _n, s, e, c in run.events if copies is None or c == copies]
    return [iv for lo, hi in (spans or [run.window_ns]) for iv in stats.clip(ops, lo, hi)]


def busy_ns(run, copies: bool | None, spans=None) -> float:
    return stats.covered(intervals(run, copies, spans))


def idle_share(run):
    """Per cent of the window with no device op running: 1 - (union of
    every kernel, copy and memset interval) / window."""
    if not run.on_card:
        return None
    lo, hi = run.window_ns
    return 100.0 * (1.0 - busy_ns(run, None) / (hi - lo))
