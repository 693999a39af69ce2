"""Common runtime pieces of the port (src/common/): the wire encoding,
lock-order checking, performance counters, latency histograms, tracing
spans, dout logging, the byte/op throttle, and for the daemons the
config schema, the admin socket, the op tracker, the cluster log client
and crash reports.
"""

from .admin_socket import AdminSocket, admin_command
from .config import OPT_BOOL, OPT_FLOAT, OPT_INT, OPT_STR, Config, Option
from .histogram import LogHistogram, PerfHistogram2D
from .log import Log, dout
from .log_client import LogChannel, LogClient
from .op_tracker import OpTracker, TrackedOp
from .perf_counters import (
    PerfCounters,
    PerfCountersBuilder,
    PerfCountersCollection,
)
from .throttle import Throttle
from .tracing import Span, Tracer

__all__ = [
    "AdminSocket",
    "admin_command",
    "Config",
    "Log",
    "LogChannel",
    "LogClient",
    "LogHistogram",
    "OpTracker",
    "PerfHistogram2D",
    "Span",
    "Throttle",
    "TrackedOp",
    "Tracer",
    "Option",
    "OPT_BOOL",
    "OPT_FLOAT",
    "OPT_INT",
    "OPT_STR",
    "PerfCounters",
    "PerfCountersBuilder",
    "PerfCountersCollection",
    "dout",
]
