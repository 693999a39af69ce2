"""Device timing with CUDA events, for the smoke run and the kernel tools."""

from __future__ import annotations

import torch


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn``, from CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, launches: int = 100, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in a
    CUDA graph and replayed, so no host work sits between launches."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(graph.replay, iters=replays) / launches
