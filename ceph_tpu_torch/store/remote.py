"""The ambient sub-op trace id of the remote shard proxy
(src/osd/ECBackend.cc:886's sub-op tracing).

Only ``trace_context``/``current_trace`` live here: ``ECStore.put``
wraps its shard fan-out in the caller's trace.  ``RemoteStore`` and
``ShardServer`` (the MECSubRead/MECSubWrite proxy pair) need the
messenger and come with it.
"""

from __future__ import annotations

import contextlib
import threading

# ambient span id for sub-ops issued through RemoteStore: set by the
# caller (the EC daemon path wraps its shard fan-out) so every
# MECSubWrite carries the client op's trace without threading a
# parameter through the ObjectStore interface
_TRACE = threading.local()


@contextlib.contextmanager
def trace_context(trace: str):
    prev = getattr(_TRACE, "id", "")
    _TRACE.id = trace
    try:
        yield
    finally:
        _TRACE.id = prev


def current_trace() -> str:
    return getattr(_TRACE, "id", "")
