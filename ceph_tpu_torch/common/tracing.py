"""Distributed tracing — spans with parent ids across daemons (the
blkin/ZTracer seat, src/common/zipkin_trace.h + blkin's span model).

The repo already carries trace ids on every sub-op message
(msg/message.py MOSDRepOp.trace / MECSubWrite.trace, stamped with the
client reqid) but nothing ever collected them: dump_historic_ops on
two daemons could be joined by hand and that was the whole story.
This module is the missing collection plane:

- ``Span`` — one timed stage on one daemon: (trace_id, span_id,
  parent_id, daemon, name, start/end, tags, events).  The trace id is
  the client reqid, exactly the id the wire already carries.  Stamps
  are ``time.time_ns()``, the clock kineto's device events are read
  on, so a span can be laid over a device trace.
- ``Tracer`` — per-daemon span factory + bounded buffer of finished
  spans.  ``dump_traces`` serves the buffer over the admin socket
  (the `dump_historic_ops`-shaped local view); ``drain`` hands
  batches to the MMgrReport push so the mgr ``tracing`` module can
  assemble one logical op's spans from DIFFERENT daemons into a
  single tree.
- ambient context — a thread-local (tracer, span) stack so deep
  layers (stores, codecs) open child spans without threading a
  tracer parameter through every signature, the same trick
  store/remote.py's ``trace_context`` plays for sub-op trace ids.

Span buffers are bounded (drop-oldest) — tracing must never be the
thing that OOMs a daemon.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque

# role ranks used by the mgr's cross-daemon tree assembly: a span
# with no resolvable parent attaches under the nearest earlier span
# of a lower rank (client root <- primary op <- replica/shard subop)
ROLE_CLIENT = "client"
ROLE_PRIMARY = "primary"
ROLE_REPLICA = "replica"
ROLE_SHARD = "shard"
ROLE_RANK = {ROLE_CLIENT: 0, ROLE_PRIMARY: 1, ROLE_REPLICA: 2, ROLE_SHARD: 2}

_ambient = threading.local()  # .stack: list[(Tracer, Span)]


def _new_id() -> str:
    return os.urandom(6).hex()


class Span:
    """One timed stage; finished spans become plain dicts in the
    tracer's buffer (the wire/admin-socket shape)."""

    __slots__ = (
        "_tracer", "trace_id", "span_id", "parent_id", "daemon",
        "name", "role", "start_ns", "end_ns", "tags", "events", "_done",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: str,
        parent_id: str = "",
        role: str = "",
        tags: dict | None = None,
    ):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.daemon = tracer.daemon
        self.name = name
        self.role = role
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.tags = dict(tags or {})
        self.events: list[tuple[float, str]] = []
        self._done = False

    def mark_event(self, event: str) -> None:
        self.events.append((time.time_ns() / 1e9, event))

    def set_tag(self, key: str, value) -> None:
        self.tags[key] = value

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        self.end_ns = time.time_ns()
        self._tracer._complete(self)

    def __enter__(self) -> "Span":
        _push(self._tracer, self)
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is not None:
            self.mark_event(f"exception: {exc_type.__name__}")
        _pop(self)
        self.finish()
        return False

    def dump(self) -> dict:
        end_ns = self.end_ns or time.time_ns()
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "daemon": self.daemon,
            "name": self.name,
            "role": self.role,
            "start": self.start_ns / 1e9,
            "end": end_ns / 1e9,
            "duration": (end_ns - self.start_ns) / 1e9,
            "start_ns": self.start_ns,
            "end_ns": end_ns,
            "tags": dict(self.tags),
            "events": [
                {"time": t, "event": e} for t, e in self.events
            ],
        }


class _NullSpan:
    """No ambient tracer: ``span()`` still returns a context manager
    so instrumented code needs no conditionals."""

    __slots__ = ()

    def mark_event(self, event: str) -> None:
        pass

    def set_tag(self, key: str, value) -> None:
        pass

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Per-daemon span factory + bounded finished-span buffer."""

    def __init__(self, daemon: str, max_spans: int = 2048):
        self.daemon = daemon
        self._lock = threading.Lock()
        self._buffer: deque[dict] = deque(maxlen=max_spans)
        self._seq = itertools.count()
        self.spans_started = 0
        self.spans_dropped = 0  # buffer overwrites (drop-oldest)

    def start_span(
        self,
        name: str,
        trace_id: str = "",
        parent_id: str = "",
        role: str = "",
        tags: dict | None = None,
    ) -> Span:
        """New span; with no explicit trace/parent it continues the
        ambient span's trace (child) or starts a fresh trace (root)."""
        amb = current_span()
        if not trace_id:
            if isinstance(amb, Span):
                trace_id = amb.trace_id
            else:
                trace_id = ambient_trace_id() or _new_id()
        if not parent_id and isinstance(amb, Span) and (
            amb.trace_id == trace_id
        ):
            parent_id = amb.span_id
        with self._lock:
            self.spans_started += 1
        return Span(self, name, trace_id, parent_id, role, tags)

    def _complete(self, span: Span) -> None:
        with self._lock:
            if len(self._buffer) == self._buffer.maxlen:
                self.spans_dropped += 1
            self._buffer.append(span.dump())

    # -- consumers ---------------------------------------------------------
    def drain(self, limit: int = 512) -> list[dict]:
        """Pop up to ``limit`` finished spans for an MMgrReport batch."""
        out: list[dict] = []
        with self._lock:
            while self._buffer and len(out) < limit:
                out.append(self._buffer.popleft())
        return out

    def dump_traces(self, trace_id: str = "") -> dict:
        """Admin-socket view of the (undrained) local buffer."""
        with self._lock:
            spans = [
                s for s in self._buffer
                if not trace_id or s["trace_id"] == trace_id
            ]
        return {
            "num_spans": len(spans),
            "spans_started": self.spans_started,
            "spans_dropped": self.spans_dropped,
            "spans": spans,
        }

    def register_admin_commands(self, admin_socket) -> None:
        admin_socket.register_command(
            "dump_traces",
            lambda args: self.dump_traces(str(args.get("trace", ""))),
            "show buffered trace spans (optional arg: trace)",
        )


# -- ambient context --------------------------------------------------------


def _stack() -> list:
    s = getattr(_ambient, "stack", None)
    if s is None:
        s = _ambient.stack = []
    return s


def _push(tracer: Tracer, span: Span) -> None:
    _stack().append((tracer, span))


def _pop(span: Span) -> None:
    s = _stack()
    for i in range(len(s) - 1, -1, -1):
        if s[i][1] is span:
            del s[i]
            return


def current_span():
    """The innermost ambient span on this thread (or NULL_SPAN)."""
    s = _stack()
    return s[-1][1] if s else NULL_SPAN


def ambient_trace_id() -> str:
    """Trace id propagated by the transport (messenger dispatch) for
    handlers that run with no ambient span yet."""
    return getattr(_ambient, "trace_id", "")


@contextlib.contextmanager
def propagate(trace_id: str):
    """Install a wire-carried trace id as this thread's ambient —
    the msg/messenger.py dispatch hook: any span a handler opens
    without an explicit trace id joins the sender's trace."""
    prev = getattr(_ambient, "trace_id", "")
    _ambient.trace_id = trace_id
    try:
        yield
    finally:
        _ambient.trace_id = prev


def current_tracer() -> Tracer | None:
    s = _stack()
    return s[-1][0] if s else None


def span(name: str, tags: dict | None = None, role: str = ""):
    """Child span of the ambient span — a no-op without one.  The
    store layers use this so their per-stage spans ride whichever
    daemon op is executing above them, without API changes."""
    tracer = current_tracer()
    if tracer is None:
        return NULL_SPAN
    return tracer.start_span(name, role=role, tags=tags)


# -- cross-daemon tree assembly (shared by the mgr tracing module) ----------


def assemble_tree(spans: list[dict]) -> list[dict]:
    """Spans (from ANY number of daemons) of one trace → span tree.

    Parent resolution: an explicit parent_id wins when that span is
    present; otherwise the span attaches under the nearest
    earlier-starting span with a strictly lower role rank (client 0 <
    primary 1 < replica/shard 2) — the cross-daemon links the wire
    does not carry.  Unresolvable spans become roots."""
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    nodes = sorted(by_id.values(), key=lambda s: s["start"])
    roots: list[dict] = []
    for node in nodes:
        parent = by_id.get(node["parent_id"])
        if parent is None or parent is node:
            rank = ROLE_RANK.get(node["role"], 99)
            best = None
            for cand in nodes:
                if cand is node or cand["start"] > node["start"]:
                    continue
                crank = ROLE_RANK.get(cand["role"], 99)
                if crank < rank and (
                    best is None or cand["start"] >= best[0]
                ):
                    best = (cand["start"], cand)
            parent = best[1] if best else None
        if parent is None:
            roots.append(node)
        else:
            parent["children"].append(node)
    return roots
