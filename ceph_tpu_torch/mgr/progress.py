"""Mgr progress module (src/pybind/mgr/progress reduced).

Global progress bars for long-running cluster operations.  Three
producers feed the same event table:

- **osdmap diffing** (the reference's OSD out/in handlers): an OSD
  marked out or back in opens a rebalance event whose fraction is
  degraded+misplaced objects remaining versus the start snapshot
  (from the pgmap digest).  The start total latches lazily — the
  storm needs a tick or two to surface in PG stats — and an event
  that never sees a nonzero remaining within the grace completes
  immediately (the remap was a no-op).
- **MPGStats piggyback**: OSDs ship scrub/repair run fractions in
  the MPGStats ``events`` field; the Manager parks them in
  ``_progress_inbox`` and this module folds them in.
- **the "progress event" command**: in-process subsystems (RGW
  reshard) and external tooling push {id, message, fraction, done}
  through the normal command path.

Completed events stay listed (done, fraction 1.0) until the TTL
retires them.  Event starts/completions clog, so they stream in
``ceph -w``.
"""

from __future__ import annotations

import json
import threading
import time

from ..msg.message import MMonCommandReply
from . import MgrModule

# a rebalance event that never shows a nonzero remaining within this
# many seconds was a no-op remap: complete it instead of leaking a
# forever-0% bar
NOOP_GRACE = 5.0

DEFAULT_TTL = 30.0

MAX_EVENTS = 256


class ProgressModule(MgrModule):
    NAME = "progress"
    TICK_EVERY = 1.0

    def __init__(self, mgr):
        super().__init__(mgr)
        # id -> {message, fraction, started, updated, done, done_at,
        #         start_total (rebalance events only)}
        self._events: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._prev_out: set[int] | None = None
        self._prev_up: set[int] | None = None

    # -- event API (the mgr_module remote interface) -----------------------
    def start_event(
        self, ev_id: str, message: str, fraction: float = 0.0
    ) -> None:
        with self._lock:
            if ev_id in self._events and not self._events[ev_id]["done"]:
                return
            if len(self._events) >= MAX_EVENTS:
                self._retire(force=True)
            now = time.time()
            self._events[ev_id] = {
                "message": message,
                "fraction": max(0.0, min(float(fraction), 1.0)),
                "started": now,
                "updated": now,
                "done": False,
                "done_at": 0.0,
                "start_total": None,
            }
        self.mgr.clog.info(f"Progress started: {message}")

    def update_event(
        self, ev_id: str, fraction: float, message: str | None = None
    ) -> None:
        with self._lock:
            ev = self._events.get(ev_id)
            if ev is None or ev["done"]:
                return
            # monotone: a bar that regresses reads as a bug, and the
            # chaos verdict asserts it never does
            ev["fraction"] = max(
                ev["fraction"], min(float(fraction), 1.0)
            )
            if message:
                ev["message"] = message
            ev["updated"] = time.time()

    def complete_event(self, ev_id: str) -> None:
        with self._lock:
            ev = self._events.get(ev_id)
            if ev is None or ev["done"]:
                return
            ev["fraction"] = 1.0
            ev["done"] = True
            ev["done_at"] = time.time()
            message = ev["message"]
        self.mgr.clog.info(f"Progress completed: {message}")

    def active_events(self) -> list[dict]:
        with self._lock:
            return [
                {"id": k, **{x: v[x] for x in (
                    "message", "fraction", "started", "updated",
                    "done", "done_at",
                )}}
                for k, v in sorted(self._events.items())
            ]

    # -- producers ----------------------------------------------------------
    def _drain_inbox(self) -> None:
        inbox = getattr(self.mgr, "_progress_inbox", None)
        if inbox is None:
            return
        while inbox:
            try:
                ev = inbox.popleft()
            except IndexError:
                break
            if not isinstance(ev, dict):
                continue
            ev_id = str(ev.get("id", ""))[:256]
            if not ev_id:
                continue
            if ev.get("done"):
                if ev_id in self._events:
                    self.complete_event(ev_id)
                continue
            try:
                fraction = float(ev.get("fraction", 0.0))
            except (TypeError, ValueError):
                fraction = 0.0
            message = str(ev.get("message", ev_id))[:512]
            if ev_id not in self._events:
                self.start_event(ev_id, message, fraction)
            else:
                self.update_event(ev_id, fraction, message)

    def _diff_osdmap(self) -> None:
        m = self.get("osd_map")
        if m is None:
            return
        out_set = {
            o for o in range(m.max_osd)
            if m.exists(o) and m.osd_weight[o] == 0
        }
        up_set = {o for o in range(m.max_osd) if m.is_up(o)}
        prev_out, prev_up = self._prev_out, self._prev_up
        self._prev_out, self._prev_up = out_set, up_set
        if prev_out is None:
            return  # first sight of the map: no transition to report
        for o in sorted(out_set - prev_out):
            self.start_event(
                f"rebalance:osd.{o}-out",
                f"Rebalancing after osd.{o} marked out",
            )
        for o in sorted(prev_out - out_set):
            self.start_event(
                f"rebalance:osd.{o}-in",
                f"Rebalancing after osd.{o} marked in",
            )

    def _advance_rebalance(self) -> None:
        """Drive every open rebalance event from the pgmap digest:
        remaining = degraded + misplaced, fraction = 1 - remaining /
        start_total (monotone-clamped)."""
        pgmap = self.mgr.modules.get("pgmap")
        digest = getattr(pgmap, "digest", None) or {}
        totals = digest.get("totals")
        if totals is None:
            return
        remaining = int(totals.get("degraded", 0)) + int(
            totals.get("misplaced", 0)
        )
        now = time.time()
        with self._lock:
            open_rebalance = [
                (k, v) for k, v in self._events.items()
                if k.startswith("rebalance:") and not v["done"]
            ]
        for ev_id, ev in open_rebalance:
            if ev["start_total"] is None:
                if remaining > 0:
                    with self._lock:
                        ev["start_total"] = remaining
                elif now - ev["started"] > NOOP_GRACE:
                    self.complete_event(ev_id)
                continue
            if remaining <= 0:
                self.complete_event(ev_id)
            else:
                total = max(ev["start_total"], remaining)
                self.update_event(ev_id, 1.0 - remaining / total)

    def _retire(self, force: bool = False) -> None:
        """Drop completed events past the TTL (caller may hold the
        lock only in the force path)."""
        ttl = float(self.get_module_option("ttl", DEFAULT_TTL))
        now = time.time()
        dead = [
            k for k, v in self._events.items()
            if v["done"] and (force or now - v["done_at"] > ttl)
        ]
        for k in dead:
            self._events.pop(k, None)

    # -- serve --------------------------------------------------------------
    def serve(self) -> None:
        self._drain_inbox()
        self._diff_osdmap()
        self._advance_rebalance()
        with self._lock:
            self._retire()

    # -- command surface -----------------------------------------------------
    def _render(self) -> str:
        rows = []
        for ev in self.active_events():
            width = 30
            filled = int(round(ev["fraction"] * width))
            bar = "=" * filled + ">" * (0 if ev["done"] else 1)
            rows.append(
                f"[{bar:<{width}}] {ev['fraction'] * 100:5.1f}%  "
                f"{ev['message']}"
                + ("  (done)" if ev["done"] else "")
            )
        return "\n".join(rows) if rows else "(no active events)"

    def handle_command(self, cmd: dict) -> MMonCommandReply:
        prefix = cmd.get("prefix", "")
        if prefix == "progress":
            return MMonCommandReply(outb=self._render())
        if prefix == "progress json":
            return MMonCommandReply(
                outb=json.dumps({"events": self.active_events()})
            )
        if prefix == "progress clear":
            with self._lock:
                n = len(self._events)
                self._events.clear()
            return MMonCommandReply(outb=f"cleared {n} event(s)")
        if prefix == "progress event":
            ev_id = str(cmd.get("id", ""))[:256]
            if not ev_id:
                return MMonCommandReply(rc=-22, outs="missing id")
            if cmd.get("done"):
                self.complete_event(ev_id)
                return MMonCommandReply(outb="ok")
            try:
                fraction = float(cmd.get("fraction", 0.0))
            except (TypeError, ValueError):
                return MMonCommandReply(rc=-22, outs="bad fraction")
            message = str(cmd.get("message", ev_id))[:512]
            if ev_id in self._events:
                self.update_event(ev_id, fraction, message)
            else:
                self.start_event(ev_id, message, fraction)
            return MMonCommandReply(outb="ok")
        return MMonCommandReply(
            rc=-22, outs=f"unknown progress command {prefix!r}"
        )
