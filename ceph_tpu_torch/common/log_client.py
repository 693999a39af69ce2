"""Cluster-log client (src/common/LogClient.{h,cc} + LogEntry.h).

Every daemon holds a ``LogClient``; code paths clog through a
``LogChannel`` (named channel, default "cluster"; operator actions go
to "audit").  Entries carry the daemon identity, a wall-clock stamp, a
priority, and a per-daemon sequence number, and queue into a bounded
buffer the daemon's tick drains into an ``MLog`` message to the
monitor — the LogClient → LogMonitor path that makes ``ceph log last``
the cluster's health timeline.

Entries also echo into the local dout ring (subsys "clog"), so a crash
report's dout tail shows what the daemon clogged before dying.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from .log import dout

# priority ladder, least to most severe (LogEntry.h's clog levels)
CLOG_PRIOS = ("debug", "info", "warn", "error", "sec")

# clog prio -> dout level for the local ring mirror
_DOUT_LEVEL = {"debug": 20, "info": 5, "warn": 1, "error": 0, "sec": 0}

# schema bounds (tools/check_metrics.py lints these)
MAX_MESSAGE_LEN = 4096
MAX_CHANNEL_LEN = 64
MAX_NAME_LEN = 64


def prio_rank(prio: str) -> int:
    """Severity rank for level filtering; unknown prios sort lowest."""
    try:
        return CLOG_PRIOS.index(prio)
    except ValueError:
        return -1


class LogChannel:
    """One named channel of a daemon's LogClient (LogChannel role):
    the ``clog.error(...)`` surface."""

    def __init__(self, client: "LogClient", channel: str = "cluster"):
        self.client = client
        self.channel = channel

    def log(self, prio: str, message: str) -> None:
        self.client.queue(self.channel, prio, message)

    def debug(self, message: str) -> None:
        self.log("debug", message)

    def info(self, message: str) -> None:
        self.log("info", message)

    def warn(self, message: str) -> None:
        self.log("warn", message)

    def error(self, message: str) -> None:
        self.log("error", message)


class LogClient:
    """Per-daemon cluster-log queue: bounded, drained onto the wire by
    the daemon's tick (drop-oldest under flooding, counted)."""

    def __init__(self, name: str, max_pending: int = 256):
        self.name = name[:MAX_NAME_LEN]
        self._pending: deque[dict] = deque(maxlen=max_pending)
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._channels: dict[str, LogChannel] = {}
        self.entries_queued = 0
        self.entries_dropped = 0

    def channel(self, name: str = "cluster") -> LogChannel:
        with self._lock:
            ch = self._channels.get(name)
            if ch is None:
                ch = self._channels[name] = LogChannel(self, name)
            return ch

    def queue(self, channel: str, prio: str, message: str) -> dict:
        if prio not in CLOG_PRIOS:
            prio = "info"
        entry = {
            "name": self.name,
            "stamp": time.time(),
            "channel": channel[:MAX_CHANNEL_LEN],
            "prio": prio,
            "message": str(message)[:MAX_MESSAGE_LEN],
            "seq": next(self._seq),
        }
        with self._lock:
            if len(self._pending) == self._pending.maxlen:
                self.entries_dropped += 1
            self._pending.append(entry)
            self.entries_queued += 1
        dout("clog", _DOUT_LEVEL[prio], f"[{channel} {prio}] {message}")
        return entry

    def drain(self) -> list[dict]:
        """Take every pending entry (the MLog batch)."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
            return out

    def requeue(self, entries: list[dict]) -> None:
        """Put a failed batch back at the FRONT (order preserved) so a
        transient mon outage loses nothing; overflow still drops the
        oldest."""
        with self._lock:
            for i, entry in enumerate(reversed(entries)):
                if len(self._pending) == self._pending.maxlen:
                    # count EVERY entry of the batch we discard, not
                    # just the first — the drop counter is the
                    # operator's signal for clog loss
                    self.entries_dropped += len(entries) - i
                    break
                self._pending.appendleft(entry)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def flush(self, monc) -> bool:
        """Drain onto the mon (MLog via ``monc.send_log``); a failed
        send requeues so a mon outage loses nothing.  The one flush
        contract every daemon shares — returns True when the batch
        (if any) went out."""
        entries = self.drain()
        if not entries:
            return True
        try:
            monc.send_log(entries, name=self.name)
            return True
        except Exception:  # noqa: BLE001 — transport-agnostic: any
            # failure means "mon didn't get it", so requeue
            self.requeue(entries)
            return False
