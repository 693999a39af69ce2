"""Failure detection — heartbeats + failure reports
(OSD::handle_osd_ping / send_failures, src/osd/OSD.cc:5235,5889, and
OSDMonitor::prepare_failure's reporter-count gate).

Each OSD pings its heartbeat peers; a peer silent past the grace
period generates a failure report, and the monitor-side aggregator
marks an OSD down once enough DISTINCT reporters agree — then the map
epoch bumps and the batched mapper recomputes placements (elasticity
is CRUSH remap, SURVEY.md §5.3)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.log import dout
from .osdmap import OSDMap

OSD_HEARTBEAT_GRACE = 20.0  # osd_heartbeat_grace
MON_OSD_MIN_DOWN_REPORTERS = 2  # mon_osd_min_down_reporters


class HeartbeatTracker:
    """One OSD's view of its peers (the 4-messenger ping plane,
    collapsed to timestamps)."""

    def __init__(self, whoami: int, grace: float = OSD_HEARTBEAT_GRACE):
        self.whoami = whoami
        self.grace = grace
        self._last_rx: dict[int, float] = {}

    def peers(self) -> set[int]:
        return set(self._last_rx)

    def add_peer(self, osd: int, now: float) -> None:
        self._last_rx.setdefault(osd, now)

    def remove_peer(self, osd: int) -> None:
        self._last_rx.pop(osd, None)

    def handle_ping(self, from_osd: int, now: float) -> None:
        if from_osd in self._last_rx:
            self._last_rx[from_osd] = now

    def failures(self, now: float) -> list[tuple[int, float]]:
        """(peer, seconds_silent) past grace — the send_failures
        payload."""
        out = []
        for osd, last in self._last_rx.items():
            silent = now - last
            if silent >= self.grace:
                out.append((osd, silent))
        return out

    def reset(self, now: float) -> None:
        """Thrash-heal hook: forgive all accumulated silence (every
        peer counts as freshly heard).  After a partition heals, the
        stale rx stamps would otherwise keep reporting peers that are
        in fact fine until a ping happens to land."""
        for osd in self._last_rx:
            self._last_rx[osd] = now


@dataclass
class _Pending:
    reporters: set[int] = field(default_factory=set)


class FailureAggregator:
    """Monitor-side reporter-count gate
    (OSDMonitor::prepare_failure/check_failure, simplified to the
    distinct-reporter threshold)."""

    def __init__(
        self,
        osdmap: OSDMap,
        min_reporters=MON_OSD_MIN_DOWN_REPORTERS,
        mark_down_fn=None,
    ):
        """``mark_down_fn(target)`` commits the down marking; the
        default mutates the map in place with a bare epoch bump (test
        convenience).  The monitor passes its own committer so the
        marking becomes a real Incremental pushed to subscribers
        (mon/monitor.py).

        ``min_reporters`` may be an int or a zero-arg callable — the
        monitor passes a callable reading its centralized config
        (mon_osd_min_down_reporters), so `ceph config set mon
        mon_osd_min_down_reporters N` takes effect at runtime."""
        self.osdmap = osdmap
        self.min_reporters = min_reporters
        self.mark_down_fn = mark_down_fn
        self._pending: dict[int, _Pending] = {}

    def _threshold(self) -> int:
        mr = self.min_reporters
        return max(1, int(mr() if callable(mr) else mr))

    def report_failure(
        self, target: int, reporter: int, now: float
    ) -> bool:
        """Returns True when the report tipped ``target`` down."""
        if not self.osdmap.is_up(target):
            # target already down through some other path: drop any
            # stale pending entry so it cannot pre-count a future
            # down marking
            self._pending.pop(target, None)
            return False
        if not self.osdmap.is_up(reporter):
            return False  # dead reporters don't count
        p = self._pending.setdefault(target, _Pending())
        p.reporters.add(reporter)
        # reporters that died since reporting no longer count
        p.reporters = {
            r for r in p.reporters if self.osdmap.is_up(r)
        }
        threshold = self._threshold()
        dout(
            "osd",
            5,
            f"failure report: osd.{target} by osd.{reporter} "
            f"({len(p.reporters)}/{threshold})",
        )
        if len(p.reporters) >= threshold:
            self._mark_down(target)
            return True
        return False

    def cancel_report(self, target: int, reporter: int) -> None:
        """The MOSDFailure recovery path: a reporter hearing the target
        again withdraws its report."""
        p = self._pending.get(target)
        if p:
            p.reporters.discard(reporter)
            if not p.reporters:
                del self._pending[target]

    def _mark_down(self, target: int) -> None:
        if self.mark_down_fn is not None:
            self.mark_down_fn(target)
        else:
            # stand-alone mode: mutate in place (a real deployment
            # routes through the monitor's incremental commit)
            self.osdmap.mark_down(target)
            self.osdmap.epoch += 1
        self._pending.pop(target, None)
        dout("osd", 0, f"osd.{target} marked down, epoch -> {self.osdmap.epoch}")

    def pending_reports(self) -> dict[int, int]:
        return {t: len(p.reporters) for t, p in self._pending.items()}

    def reset(self) -> None:
        """Thrash-heal hook: drop every half-counted report.  A
        healed partition leaves reporter sets one short of threshold;
        an unrelated later report must not tip a healthy OSD down on
        those stale counts."""
        self._pending.clear()
