"""Common runtime pieces the store data plane needs: the wire encoding,
lock-order checking, performance counters, latency histograms and
tracing spans (src/common/).

The JAX package's ``common`` also holds the admin socket, the config
schema, the cluster log client and the op tracker; those come with the
daemons.
"""

from .histogram import LogHistogram, PerfHistogram2D
from .perf_counters import (
    PerfCounters,
    PerfCountersBuilder,
    PerfCountersCollection,
)
from .tracing import Span, Tracer

__all__ = [
    "LogHistogram",
    "PerfHistogram2D",
    "Span",
    "Tracer",
    "PerfCounters",
    "PerfCountersBuilder",
    "PerfCountersCollection",
]
