"""Common runtime pieces the store data plane and the messenger need:
the wire encoding, lock-order checking, performance counters, latency
histograms, tracing spans, dout logging and the byte/op throttle
(src/common/).

The JAX package's ``common`` also holds the admin socket, the config
schema, the cluster log client and the op tracker; those come with the
daemons.
"""

from .histogram import LogHistogram, PerfHistogram2D
from .log import Log, dout
from .perf_counters import (
    PerfCounters,
    PerfCountersBuilder,
    PerfCountersCollection,
)
from .throttle import Throttle
from .tracing import Span, Tracer

__all__ = [
    "Log",
    "LogHistogram",
    "PerfHistogram2D",
    "Span",
    "Throttle",
    "Tracer",
    "PerfCounters",
    "PerfCountersBuilder",
    "PerfCountersCollection",
    "dout",
]
