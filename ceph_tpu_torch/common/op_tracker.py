"""Op tracking — in-flight op registry + historic ring buffer
(src/common/TrackedOp.cc; dumped as dump_ops_in_flight /
dump_historic_ops over the admin socket).

A TrackedOp accumulates per-stage timestamped events ("queued",
"reached_pg", "commit_sent", ...); on completion it moves into a
bounded history keyed for the slowest-ops view.
"""

from __future__ import annotations

import itertools
import re
import threading
import time
from collections import deque

from .histogram import LogHistogram

# qos classes / op types become perf-dump keys and prometheus label
# values: anything outside this alphabet collapses to "other" at the
# recording site, so one hostile/garbled class string cannot poison
# the exporter (the label-safety rule check_metrics lints)
_CLASS_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9_]{0,31}$")
# stage labels ("prev__cur" event pairs) run longer than class names
_STAGE_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9_]{0,79}$")
# distinct per-stage labels are client-influenced (event names embed
# peer osd ids): bound the map so the tracker cannot grow unbounded
MAX_STAGE_HISTOGRAMS = 64


def sanitize_class(name: str, default: str = "other") -> str:
    return name if _CLASS_RE.match(name or "") else default


class TrackedOp:
    def __init__(
        self,
        tracker: "OpTracker",
        description: str,
        trace: str = "",
        op_type: str = "",
        qos_class: str = "",
    ):
        self._tracker = tracker
        self.seq = next(tracker._seq)
        self.description = description
        # the span/trace id (blkin/ZTracer role): the client's reqid,
        # carried by every sub-op, so dump_historic_ops on DIFFERENT
        # daemons correlates one logical op end-to-end
        self.trace = trace
        # the latency-histogram keys: what kind of op, and which QoS
        # class the scheduler served it under
        self.op_type = sanitize_class(op_type)
        self.qos_class = sanitize_class(qos_class, default="client")
        self.initiated_at = time.time()
        self.events: list[tuple[float, str]] = []
        self._done = False

    def mark_event(self, event: str) -> None:
        self.events.append((time.time(), event))

    def finish(self) -> None:
        if not self._done:
            self._done = True
            self.mark_event("done")
            self._tracker._complete(self)

    def __enter__(self):
        self.mark_event("start")
        return self

    def __exit__(self, exc_type, *exc):
        self.mark_event("exception" if exc_type else "finish")
        self.finish()
        return False

    @property
    def duration(self) -> float:
        end = self.events[-1][0] if self._done else time.time()
        return end - self.initiated_at

    def dump(self) -> dict:
        return {
            "seq": self.seq,
            "description": self.description,
            "trace": self.trace,
            "op_type": self.op_type,
            "qos_class": self.qos_class,
            "initiated_at": self.initiated_at,
            "duration": self.duration,
            "type_data": {
                "events": [
                    {"time": t, "event": e} for t, e in self.events
                ]
            },
        }


def _slowest_stage(op: TrackedOp) -> dict:
    """The single longest inter-event gap — the stage that made a
    slow op slow (the ``dump_historic_slow_ops`` view only states the
    total; the gap names the culprit).  The op's initiation counts as
    the zeroth event, so a long queue wait before the first mark is
    attributed too."""
    prev_t, prev_e = op.initiated_at, "initiated"
    best = {"event": prev_e, "gap": 0.0}
    for t, e in op.events:
        gap = t - prev_t
        if gap > best["gap"]:
            # the gap ENDS at this event: it is the wait between
            # prev_e and e, reported as "prev_e -> e"
            best = {"event": f"{prev_e} -> {e}", "gap": gap}
        prev_t, prev_e = t, e
    return best


class OpTracker:
    """history_size/history_duration mirror
    osd_op_history_size/duration's roles."""

    def __init__(self, history_size: int = 20, history_duration: float = 600.0):
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._inflight: dict[int, TrackedOp] = {}
        self._history: deque[TrackedOp] = deque()
        self.history_size = history_size
        self.history_duration = history_duration
        # latency distributions (the PerfHistogram seat): completion
        # latency per (qos_class, op_type), plus the gap between
        # adjacent stage events per stage label — cumulative, so the
        # mgr windows them by snapshot subtraction
        self._hist: dict[tuple[str, str], LogHistogram] = {}
        self._stage_hist: dict[str, LogHistogram] = {}

    def create_op(
        self,
        description: str,
        trace: str = "",
        op_type: str = "",
        qos_class: str = "",
    ) -> TrackedOp:
        op = TrackedOp(self, description, trace, op_type, qos_class)
        with self._lock:
            self._inflight[op.seq] = op
        return op

    def _complete(self, op: TrackedOp) -> None:
        with self._lock:
            self._inflight.pop(op.seq, None)
            self._history.append(op)
            now = time.time()
            while len(self._history) > self.history_size or (
                self._history
                and now - self._history[0].initiated_at
                > self.history_duration
            ):
                self._history.popleft()
            key = (op.qos_class, op.op_type)
            hist = self._hist.get(key)
            if hist is None:
                hist = self._hist[key] = LogHistogram()
        # histogram adds take the histogram's own lock, not the
        # tracker's — completion must stay cheap under contention
        end = op.events[-1][0] if op.events else now
        hist.add(max(0.0, end - op.initiated_at))
        self._record_stage_gaps(op)

    def _record_stage_gaps(self, op: TrackedOp) -> None:
        """Per-stage latency: the gap between each adjacent event
        pair, recorded under "prev->cur" (the slowest_stage labels,
        as distributions instead of one winner per op).  ONE tracker
        lock acquisition resolves every label; the adds run after,
        under the histograms' own locks — completion stays cheap."""
        gaps: list[tuple[str, float]] = []
        prev_t, prev_e = op.initiated_at, "initiated"
        for t, e in op.events:
            raw = f"{prev_e}__{e}".replace(" ", "_").replace(".", "_")
            label = raw if _STAGE_RE.match(raw) else "other"
            gaps.append((label, max(0.0, t - prev_t)))
            prev_t, prev_e = t, e
        pending: list[tuple[LogHistogram, float]] = []
        with self._lock:
            for label, gap in gaps:
                hist = self._stage_hist.get(label)
                if hist is None:
                    if len(self._stage_hist) >= MAX_STAGE_HISTOGRAMS:
                        hist = self._stage_hist.setdefault(
                            "other", LogHistogram()
                        )
                    else:
                        hist = self._stage_hist[label] = LogHistogram()
                pending.append((hist, gap))
        for hist, gap in pending:
            hist.add(gap)

    # -- histogram views ---------------------------------------------------
    def dump_histograms(self) -> dict:
        """The `perf histogram dump` op block: completion latency per
        (qos_class, op_type) and per-stage gap distributions."""
        with self._lock:
            hists = dict(self._hist)
            stages = dict(self._stage_hist)
        return {
            "ops": {
                f"{qos}.{typ}": h.snapshot()
                for (qos, typ), h in sorted(hists.items())
            },
            "stages": {
                label: h.snapshot()
                for label, h in sorted(stages.items())
            },
        }

    def histogram_perf_entries(self) -> dict:
        """Flat entries for the MMgrReport perf dump: one
        ``op_hist.<qos_class>.<op_type>`` snapshot per pair — the mgr
        slo module merges these cluster-wide, the exporter renders
        them as native histogram families.  Stage-gap histograms stay
        local (admin/tell surface): their labels are unbounded-ish
        and per-daemon is where they are diagnostic."""
        with self._lock:
            hists = dict(self._hist)
        return {
            f"op_hist.{qos}.{typ}": h.snapshot()
            for (qos, typ), h in hists.items()
        }

    # -- admin socket views ------------------------------------------------
    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._inflight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._history]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_slow_ops(
        self, threshold: float = 0.0, qos_class: str = ""
    ) -> dict:
        """``qos_class`` filters to one class (the span/tracker
        plumbing carries it)."""
        with self._lock:
            ops = sorted(
                (
                    op
                    for op in self._history
                    if op.duration >= threshold
                    and (not qos_class or op.qos_class == qos_class)
                ),
                key=lambda o: o.duration,
                reverse=True,
            )
            dumps = []
            for op in ops:
                d = op.dump()
                d["slowest_stage"] = _slowest_stage(op)
                dumps.append(d)
            return {"num_ops": len(dumps), "ops": dumps}

    # -- SLOW_OPS watchdog views (OSD::check_ops_in_flight role) -----------
    def slow_ops(self, threshold: float) -> list[TrackedOp]:
        """In-flight ops older than ``threshold`` seconds — the
        osd_op_complaint_time check the health watchdog polls."""
        now = time.time()
        with self._lock:
            return [
                op
                for op in self._inflight.values()
                if now - op.initiated_at >= threshold
            ]

    def slow_op_summary(self, threshold: float) -> dict:
        """(count, oldest age) for the mon health report."""
        slow = self.slow_ops(threshold)
        now = time.time()
        oldest = max(
            (now - op.initiated_at for op in slow), default=0.0
        )
        return {"num_slow_ops": len(slow), "oldest_age": oldest}

    def register_admin_commands(
        self, admin_socket, extra_histograms=None
    ) -> None:
        """``extra_histograms`` (zero-arg callable → dict) lets the
        owning daemon merge its own grids (the OSD's 2D commit
        histogram) into the admin-socket `perf histogram dump`, so
        the socket serves the same view as the tell surface."""
        admin_socket.register_command(
            "dump_ops_in_flight",
            lambda args: self.dump_ops_in_flight(),
            "show in-flight ops",
        )
        admin_socket.register_command(
            "dump_historic_ops",
            lambda args: self.dump_historic_ops(),
            "show recent completed ops",
        )
        admin_socket.register_command(
            "dump_historic_slow_ops",
            lambda args: self.dump_historic_slow_ops(
                float(args.get("threshold", 0.0)),
                str(args.get("qos_class", "")),
            ),
            "show recent ops sorted by duration "
            "(optional args: threshold, qos_class)",
        )
        def _hist_dump(args):
            out = self.dump_histograms()
            if extra_histograms is not None:
                out.update(extra_histograms())
            return out

        admin_socket.register_command(
            "perf histogram dump",
            _hist_dump,
            "per-(qos, op-type) latency + per-stage gap histograms"
            " (+ the daemon's own grids)",
        )
