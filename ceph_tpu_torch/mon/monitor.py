"""Monitor service + client (Monitor.cc / OSDMonitor.cc / MonClient.cc).

``Monitor`` owns the authoritative OSDMap.  Mutations arrive as
``Incremental``s (from commands, boot messages, or the failure
aggregator), are committed to the ``MonitorStore`` log, applied, and
pushed to every subscriber — the PaxosService propose→commit→notify
cycle with the quorum collapsed to one node (deviation documented in
the package docstring).

``MonitorStore`` is the MonitorDBStore role: a versioned blob log
("osdmap_full_<e>" / "osdmap_inc_<e>" keys) behind the ObjectStore
transaction API, so swapping in the persistent store gives mon-state
durability for free.

``MonClient`` keeps a daemon's local map current: subscribe from the
current epoch, apply pushed incrementals, surface epoch changes to a
callback (the OSD's handle_osd_map role).
"""

from __future__ import annotations

import json
import re as _re
import sys
import threading
import time
from collections import deque

from ..common.log_client import (
    CLOG_PRIOS as _clog_prios,
    MAX_CHANNEL_LEN as _MAX_CHANNEL_LEN,
    MAX_MESSAGE_LEN as _MAX_MESSAGE_LEN,
    MAX_NAME_LEN as _MAX_NAME_LEN,
)
from ..msg import (
    MLog,
    MOSDMap,
    Message,
    MessageError,
    Messenger,
)
from ..msg.message import (
    MMonCommand,
    MMonCommandReply,
    MMonSubscribe,
    MOSDBoot,
    MOSDFailure,
)
from ..msg.messenger import Connection, Dispatcher
from ..crush.types import PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED
from ..osd.failure import FailureAggregator
from ..osd.osdmap import Incremental, OSDMap, PgPool
from ..store.objectstore import MemStore, ObjectStore, StoreError, Transaction

MON_COLL = "mon_store"

# cluster-log vocabulary accepted off the wire: the prio ladder is
# OWNED by common/log_client.py (one source — a prio added there must
# not be clamped away here); LogStore.add rewrites anything else.
# The channel rule excludes '/' so the "channel/prio" totals key
# stays unambiguous.
_CLOG_PRIOS = frozenset(_clog_prios)
_CHANNEL_RE = _re.compile(r"^[a-zA-Z][a-zA-Z0-9_.-]{0,63}$")

# health-mute bounds: mute codes are client-supplied strings stored
# until unmute/expiry — cap count and length or a loop of unique
# no-TTL mutes grows the mon without bound
MAX_HEALTH_MUTES = 64
MAX_MUTE_CODE_LEN = 64
# an osd stat report (~1 Hz when healthy) older than this stops
# feeding OSD_NEARFULL/OSD_FULL — a silent OSD must not pin HEALTH_ERR
STAT_REPORT_GRACE = 30.0


class MonitorStore:
    """Versioned map-blob log over an ObjectStore (MonitorDBStore role:
    every commit is one transaction; replay rebuilds the map chain)."""

    def __init__(self, store: ObjectStore | None = None):
        self.store = store or MemStore()
        try:
            self.store.queue_transaction(
                Transaction().create_collection(MON_COLL)
            )
        except StoreError:
            pass

    def put_commit(
        self, epoch: int, inc_blob: bytes | None, full_blob: bytes
    ) -> None:
        txn = Transaction()
        if inc_blob is not None:
            txn.touch(MON_COLL, f"osdmap_inc_{epoch}")
            txn.write(MON_COLL, f"osdmap_inc_{epoch}", 0, inc_blob)
        txn.touch(MON_COLL, f"osdmap_full_{epoch}")
        txn.write(MON_COLL, f"osdmap_full_{epoch}", 0, full_blob)
        txn.touch(MON_COLL, "meta")
        txn.setattr(
            MON_COLL, "meta", "last_committed", str(epoch).encode()
        )
        self.store.queue_transaction(txn)

    def last_committed(self) -> int:
        try:
            return int(self.store.getattr(MON_COLL, "meta", "last_committed"))
        except StoreError:
            return 0

    def get_inc(self, epoch: int) -> bytes | None:
        try:
            return self.store.read(MON_COLL, f"osdmap_inc_{epoch}")
        except StoreError:
            return None

    def get_full(self, epoch: int) -> bytes | None:
        try:
            return self.store.read(MON_COLL, f"osdmap_full_{epoch}")
        except StoreError:
            return None

    # -- generic blobs (the non-osdmap PaxosService keys: clog, ...) --------
    def put_blob(self, key: str, blob: bytes) -> None:
        txn = Transaction()
        txn.touch(MON_COLL, key)
        # truncate first: a shorter rewrite must not leave the old
        # tail glued onto the new blob
        txn.truncate(MON_COLL, key, 0)
        txn.write(MON_COLL, key, 0, blob)
        self.store.queue_transaction(txn)

    def get_blob(self, key: str) -> bytes | None:
        try:
            return self.store.read(MON_COLL, key)
        except StoreError:
            return None


class LogStore:
    """The LogMonitor role (src/mon/LogMonitor.{h,cc} reduced):
    cluster-log entries from MLog batches land in a bounded window
    with per-(channel, prio) running totals, persisted as one blob in
    the MonitorStore so a restarted mon keeps its health timeline.
    ``last`` serves ``ceph log last [n] [level] [channel]``."""

    KEY = "clog"
    MAX_TOTALS_KEYS = 64  # counter-cardinality bound (see add())

    def __init__(self, store: MonitorStore, max_entries: int = 500):
        self.store = store
        self.max_entries = max_entries
        # optional fanout hook: called with the ACCEPTED (coerced)
        # entries after every add — the `ceph -w` watch stream taps
        # here so subscribers see exactly what the window recorded
        self.notify = None
        self._entries: deque[dict] = deque(maxlen=max_entries)
        self._totals: dict[str, int] = {}  # "channel/prio" -> count
        self.total = 0
        # persistence is THROTTLED (the reference batches LogMonitor
        # commits through paxos the same way): the in-memory window is
        # authoritative for `log last`; a mon restart may lose the
        # last ~1s of entries
        self._last_persist = 0.0
        blob = store.get_blob(self.KEY)
        if blob:
            try:
                state = json.loads(blob)
                self._entries.extend(state.get("entries", []))
                self._totals = dict(state.get("totals", {}))
                self.total = int(state.get("total", 0))
            except (ValueError, TypeError):
                pass  # corrupt window: start fresh, never crash the mon

    def add(self, entries: list[dict]) -> int:
        added = 0
        accepted: list[dict] = []
        for raw in entries:
            if not isinstance(raw, dict) or "message" not in raw:
                continue
            # coerce EVERY field: entries arrive off the wire, and a
            # wrong-typed prio/stamp persisted into the window would
            # break `log last` until it ages out
            try:
                entry = {
                    "name": str(raw.get("name", "unknown"))[
                        :_MAX_NAME_LEN
                    ],
                    "stamp": float(raw.get("stamp", time.time())),
                    "channel": str(raw.get("channel", "cluster"))[
                        :_MAX_CHANNEL_LEN
                    ],
                    "prio": str(raw.get("prio", "info")),
                    "message": str(raw["message"])[
                        :_MAX_MESSAGE_LEN
                    ],
                    "seq": int(raw.get("seq", 0)),
                }
            except (TypeError, ValueError):
                continue  # unsalvageable entry: drop, never poison
            # channel and prio become _totals keys, prometheus label
            # values, and persisted state: clamp to a safe vocabulary
            # or an attacker looping `ceph log` with unique channels
            # grows mon memory and scrape size without bound (and a
            # '/' in a channel would corrupt the "channel/prio" key)
            if entry["prio"] not in _CLOG_PRIOS:
                entry["prio"] = "info"
            if not _CHANNEL_RE.match(entry["channel"]):
                entry["channel"] = "cluster"
            self._entries.append(entry)
            accepted.append(entry)
            key = f"{entry['channel']}/{entry['prio']}"
            if (
                key not in self._totals
                and len(self._totals) >= self.MAX_TOTALS_KEYS
            ):
                # bounded counter cardinality: overflow channels fold
                # into one bucket instead of growing forever
                key = f"other/{entry['prio']}"
            self._totals[key] = self._totals.get(key, 0) + 1
            self.total += 1
            added += 1
        now = time.time()
        if added and now - self._last_persist >= 1.0:
            self._last_persist = now
            self._persist()
        if accepted and self.notify is not None:
            try:
                self.notify(accepted)
            except Exception:  # noqa: BLE001 — fanout best-effort
                pass
        return added

    def last(
        self,
        n: int = 20,
        level: str | None = None,
        channel: str | None = None,
    ) -> list[dict]:
        from ..common.log_client import prio_rank

        if int(n) <= 0:
            return []
        entries = list(self._entries)
        if channel:
            entries = [
                e for e in entries if e.get("channel") == channel
            ]
        if level:
            floor = prio_rank(level)
            entries = [
                e
                for e in entries
                if prio_rank(e.get("prio", "info")) >= floor
            ]
        return entries[-max(0, int(n)):]

    def stat(self) -> dict:
        return {
            "total": self.total,
            "window": len(self._entries),
            "by_channel_prio": dict(self._totals),
        }

    def _persist(self) -> None:
        try:
            self.store.put_blob(
                self.KEY,
                json.dumps(
                    {
                        "entries": list(self._entries),
                        "totals": self._totals,
                        "total": self.total,
                    }
                ).encode(),
            )
        except StoreError:
            pass  # the in-memory window still serves `log last`


class Monitor(Dispatcher):
    """Single-node map authority (Monitor + OSDMonitor roles)."""

    def __init__(
        self,
        osdmap: OSDMap,
        store: MonitorStore | None = None,
        min_reporters: int = 2,
    ):
        self.store = store or MonitorStore()
        self._lock = threading.RLock()
        replay_to = self.store.last_committed()
        if replay_to > osdmap.epoch:
            # cold restart: adopt the highest committed map
            blob = self.store.get_full(replay_to)
            if blob is not None:
                osdmap = OSDMap.decode(blob)
        self.osdmap = osdmap
        if self.store.last_committed() < osdmap.epoch:
            self.store.put_commit(osdmap.epoch, None, osdmap.encode())
        # flap guard: the reporter threshold is config-gated
        # (mon_osd_min_down_reporters) with the constructor value as
        # the fallback, so an asymmetric partition's single live
        # reporter cannot keep re-downing a reachable OSD once the
        # operator raises the bar
        self._min_reporters_default = min_reporters
        self.failures = FailureAggregator(
            osdmap,
            min_reporters=self.min_down_reporters,
            mark_down_fn=self._commit_mark_down,
        )
        # subscribers: conn -> last epoch sent
        self._subs: dict[Connection, int] = {}
        # centralized config database (ConfigMonitor role)
        self.config_db: dict[str, dict[str, str]] = {}
        # SLOW_OPS reports (HealthMonitor's daemon-health role):
        # daemon -> (wallclock received, count, oldest_age).  Kept
        # in-memory per monitor, like mgr beacons — a count of 0
        # clears; stale reports age out of health after the grace
        self.slow_ops: dict[str, tuple[float, int, float]] = {}
        # cluster log (LogMonitor role): MLog batches + the mon's own
        # entries land here and serve `ceph log last`
        self.clog_store = LogStore(self.store)
        # health mutes (HealthMonitor mutes): code -> expiry wallclock
        # (inf = no TTL); muted codes leave the rollup, not the detail
        self.health_mutes: dict[str, float] = {}
        # un-archived recent crash count, pushed by the mgr crash
        # module ("crash report") — raises RECENT_CRASH
        self.recent_crashes = 0
        # scrub-error reports ("osd scrub errors" upcalls): daemon ->
        # (wallclock received, error count, damaged pgids, large-omap
        # object count).  Feeds OSD_SCRUB_ERRORS / PG_DAMAGED /
        # LARGE_OMAP_OBJECTS; an all-zero report clears, stale
        # reports age out like slow-op reports
        self.scrub_reports: dict[
            str, tuple[float, int, list, int]
        ] = {}
        # per-OSD space stats ("osd stat report" upcalls, the
        # osd_stat_t role): osd -> (wallclock received, kb, kb_used,
        # kb_avail).  Feeds OSD_NEARFULL / OSD_FULL
        self.osd_stats: dict[int, tuple[float, int, int, int]] = {}
        # per-OSD commit/apply latency (the osd_stat_t perf seat
        # `ceph osd perf` serves): osd -> (ts, commit_ms, apply_ms)
        self.osd_perf_stats: dict[int, tuple[float, float, float]] = {}
        # SLO burn-rate verdicts pushed by the mgr slo module ("slo
        # report", the RECENT_CRASH push idiom): code -> (wallclock
        # received, severity, summary).  An empty push clears; stale
        # reports age out with the slow-op grace (a dead mgr must not
        # pin SLO_LATENCY forever)
        self.slo_reports: dict[str, tuple[float, str, str]] = {}
        # PGMap digest pushed by the mgr pgmap module ("pgmap
        # report"): (wallclock received, digest dict).  Feeds the
        # `ceph status` pgmap section, `ceph df`, the grown `pg
        # dump`, and PG_DEGRADED / PG_AVAILABILITY; silence past the
        # stat-report grace drops it (dead mgr ≠ healthy PGs)
        self.pgmap: tuple[float, dict] | None = None
        # `ceph -w` watch subscribers: conn -> {level, debug,
        # dout_mark}; fed by the clog_store notify fanout below
        self._watch_subs: dict[Connection, dict] = {}
        self.clog_store.notify = self._push_watch
        # last health-check code set, so transitions (raise/clear)
        # write the cluster log — the health timeline
        self._prev_health: set[str] = set()

    def _config_float(self, key: str) -> float:
        """One mon option: the centralized config database overrides
        the schema default ('ceph config set mon <key> <v>')."""
        raw = self.config_db.get("mon", {}).get(key)
        if raw is not None:
            try:
                return float(raw)
            except ValueError:
                pass
        from ..common.config import SCHEMA

        return float(SCHEMA[key].default)

    def min_down_reporters(self) -> int:
        """mon_osd_min_down_reporters: config_db gates, the
        constructor value is the fallback (default 1 in the schema,
        so stand-alone monitors keep their constructed behavior)."""
        raw = self.config_db.get("mon", {}).get(
            "mon_osd_min_down_reporters"
        )
        if raw is not None:
            try:
                return max(1, int(raw))
            except ValueError:
                pass
        return max(1, int(self._min_reporters_default))

    def slow_op_report_grace(self) -> float:
        """mon_slow_op_report_grace: the centralized config database
        ('ceph config set mon mon_slow_op_report_grace N') overrides
        the schema default."""
        raw = self.config_db.get("mon", {}).get(
            "mon_slow_op_report_grace"
        )
        if raw is not None:
            try:
                return float(raw)
            except ValueError:
                pass
        from ..common.config import SCHEMA

        return float(SCHEMA["mon_slow_op_report_grace"].default)

    # -- commit cycle ------------------------------------------------------
    def commit(self, inc: Incremental) -> int:
        """propose_pending: apply + log + notify; returns new epoch."""
        with self._lock:
            blob = inc.encode()
            self.osdmap.apply_incremental(inc)
            self.store.put_commit(
                self.osdmap.epoch, blob, self.osdmap.encode()
            )
            self._push_maps()
            return self.osdmap.epoch

    def pending(self) -> Incremental:
        return self.osdmap.new_incremental()

    def _commit_mark_down(self, target: int) -> None:
        with self._lock:
            if not self.osdmap.is_up(target):
                return  # raced with a command; XOR must not re-up it
            inc = self.pending()
            inc.mark_down(target)
            self.commit(inc)
            self._clog(
                "warn",
                f"osd.{target} marked down after failure reports",
            )

    # -- cluster log (LogMonitor ingest + the mon's own channel) -----------
    def _clog(
        self, prio: str, message: str, channel: str = "cluster"
    ) -> None:
        """The mon's own cluster-log entry (no wire hop needed)."""
        self.clog_store.add(
            [
                {
                    "name": "mon.0",
                    "stamp": time.time(),
                    "channel": channel,
                    "prio": prio,
                    "message": message,
                    "seq": self.clog_store.total + 1,
                }
            ]
        )

    def pgmap_digest(self) -> dict | None:
        """The freshest mgr-pushed PGMap digest, or None when the
        mgr has gone silent past the stat-report grace (a dead mgr's
        last digest must not keep reporting healthy PGs)."""
        if self.pgmap is None:
            return None
        ts, digest = self.pgmap
        if time.time() - ts > STAT_REPORT_GRACE:
            return None
        return digest

    # -- health (HealthMonitor role) ---------------------------------------
    def health_checks(self) -> dict[str, dict]:
        """Every active health check, code -> {severity, summary} —
        BEFORE mutes.  State transitions against the previous
        evaluation are clogged, so the cluster log is the health
        timeline (LogMonitor's health-to-clog path)."""
        m = self.osdmap
        checks: dict[str, dict] = {}
        down = [
            o for o in range(m.max_osd)
            if m.exists(o) and not m.is_up(o)
        ]
        out = [
            o for o in range(m.max_osd)
            if m.exists(o) and m.osd_weight[o] == 0
        ]
        if down:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(down)} osds down",
            }
        if out:
            checks["OSD_OUT"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(out)} osds out",
            }
        # OSD_NEARFULL / OSD_FULL (OSDMonitor's full-flag checks,
        # src/mon/OSDMonitor.cc + PGMap::get_health fullness rows):
        # computed from the freshest per-OSD stat reports; a downed
        # reporter's stats stop counting (its data re-homes anyway)
        nearfull_ratio = self._config_float("mon_osd_nearfull_ratio")
        full_ratio = self._config_float("mon_osd_full_ratio")
        nearfull_osds: list[int] = []
        full_osds: list[int] = []
        stats_now = time.time()
        for osd, (ts, kb, kb_used, _kb_avail) in list(
            self.osd_stats.items()
        ):
            if not m.is_up(osd):
                del self.osd_stats[osd]
                continue
            if stats_now - ts > STAT_REPORT_GRACE:
                # an up-but-silent OSD's last report must not pin
                # OSD_FULL forever (same aging rule as slow-op and
                # scrub reports); reports flow at ~1 Hz when healthy
                del self.osd_stats[osd]
                continue
            ratio = (kb_used / kb) if kb else 0.0
            if ratio >= full_ratio:
                full_osds.append(osd)
            elif ratio >= nearfull_ratio:
                nearfull_osds.append(osd)
        if full_osds:
            checks["OSD_FULL"] = {
                "severity": "HEALTH_ERR",
                "summary": (
                    f"{len(full_osds)} full osd(s) "
                    f"{sorted(full_osds)}: writes blocked"
                ),
            }
        if nearfull_osds:
            checks["OSD_NEARFULL"] = {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{len(nearfull_osds)} nearfull osd(s) "
                    f"{sorted(nearfull_osds)}"
                ),
            }
        # SLOW_OPS: fresh nonzero reports only — a crashed daemon's
        # last report must not pin WARN forever
        now = time.time()
        grace = self.slow_op_report_grace()
        slow_total, oldest, reporters = 0, 0.0, []
        for daemon, (ts, count, age) in list(self.slow_ops.items()):
            if now - ts > grace:
                del self.slow_ops[daemon]
                continue
            if count > 0:
                slow_total += count
                oldest = max(oldest, age)
                reporters.append(daemon)
        if slow_total:
            checks["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{slow_total} slow ops, oldest one blocked for "
                    f"{oldest:.0f} sec, daemons {sorted(reporters)} "
                    "have slow ops (SLOW_OPS)"
                ),
            }
        # OSD_SCRUB_ERRORS / PG_DAMAGED (scrub findings).  Unlike
        # slow-op reports these must NOT age out on a timer — damage
        # stays damaged until a repair's zero-report clears it (the
        # reference keeps it in pg stats).  Only a reporter that left
        # the cluster drops its contribution (its PGs re-scrub under
        # their new primaries).
        err_total, damaged, large_total = 0, set(), 0
        for daemon, (_ts, count, pgs, large) in list(
            self.scrub_reports.items()
        ):
            try:
                osd_id = int(daemon.rsplit(".", 1)[1])
            except (IndexError, ValueError):
                osd_id = -1
            if osd_id >= 0 and not m.is_up(osd_id):
                del self.scrub_reports[daemon]
                continue
            if count > 0:
                err_total += count
                damaged.update(pgs)
            large_total += max(0, large)
        if err_total:
            checks["OSD_SCRUB_ERRORS"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{err_total} scrub errors",
            }
        if damaged:
            checks["PG_DAMAGED"] = {
                "severity": "HEALTH_ERR",
                "summary": (
                    f"Possible data damage: {len(damaged)} pg"
                    f"{'s' if len(damaged) > 1 else ''} inconsistent"
                ),
            }
        if large_total:
            # LARGE_OMAP_OBJECTS (PGMap::get_health_checks): deep
            # scrub found omap objects past the key threshold — the
            # bucket-index reshard signal; cleared by the next deep
            # scrub after the index re-shards
            checks["LARGE_OMAP_OBJECTS"] = {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{large_total} large omap object"
                    f"{'s' if large_total > 1 else ''} found"
                ),
            }
        if self.recent_crashes:
            checks["RECENT_CRASH"] = {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{self.recent_crashes} daemons have recently "
                    "crashed"
                ),
            }
        # SLO_LATENCY (the mgr slo module's burn-rate verdicts): the
        # mgr re-pushes every tick while burning, so stale entries age
        # out on the slow-op grace — an evaluator that died mid-burn
        # cannot pin the check
        grace = self.slow_op_report_grace()
        for code, (ts, severity, summary) in list(
            self.slo_reports.items()
        ):
            if now - ts > grace:
                del self.slo_reports[code]
                continue
            checks[code] = {"severity": severity, "summary": summary}
        # PG_DEGRADED / PG_AVAILABILITY (PGMap::get_health_checks):
        # from the mgr's pgmap digest; a stale digest (dead mgr)
        # drops the checks rather than pinning them forever
        digest = self.pgmap_digest()
        if digest is not None:
            t = digest.get("totals", {})
            degraded = int(t.get("degraded", 0))
            unfound = int(t.get("unfound", 0))
            objects = max(int(t.get("objects", 0)), 1)
            if degraded or unfound:
                replicas = objects  # reported objects ≈ placements led
                checks["PG_DEGRADED"] = {
                    "severity": "HEALTH_WARN",
                    "summary": (
                        f"Degraded data redundancy: {degraded}/"
                        f"{replicas} objects degraded"
                        + (f", {unfound} unfound" if unfound else "")
                    ),
                }
            # inactive = reported pgs not in an active state; pools
            # whose primaries have not reported at all stay unknown,
            # not unavailable
            inactive = sum(
                1 for row in digest.get("pgs", {}).values()
                if not str(row.get("state", "")).startswith("active")
            )
            if inactive > 0:
                checks["PG_AVAILABILITY"] = {
                    "severity": "HEALTH_WARN",
                    "summary": (
                        "Reduced data availability: "
                        f"{inactive} pgs inactive"
                    ),
                }
        cur = set(checks)
        for code in sorted(cur - self._prev_health):
            self._clog(
                "warn",
                f"Health check failed: "
                f"{checks[code]['summary']} ({code})",
            )
        for code in sorted(self._prev_health - cur):
            self._clog("info", f"Health check cleared: {code}")
        self._prev_health = cur
        return checks

    # -- subscriber fan-out ------------------------------------------------
    def _map_message(self, since: int) -> MOSDMap:
        """Incremental run (since, current]; full map if a gap or a
        fresh subscriber (MOSDMap build semantics)."""
        cur = self.osdmap.epoch
        if since <= 0 or since >= cur:
            incs = []
        else:
            incs = [self.store.get_inc(e) for e in range(since + 1, cur + 1)]
        if since and incs and all(b is not None for b in incs):
            return MOSDMap(incrementals=incs)
        return MOSDMap(full=self.osdmap.encode())

    def _push_maps(self) -> None:
        for conn, sent in list(self._subs.items()):
            if conn.is_closed:
                del self._subs[conn]
                continue
            try:
                conn.send(self._map_message(sent))
                self._subs[conn] = self.osdmap.epoch
            except MessageError:
                del self._subs[conn]

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MMonSubscribe):
            if msg.from_osd >= 0 and getattr(
                conn, "peer_label", None
            ) is None:
                # stamp the subscriber's identity so directional
                # fault rules (netsplits) match the mon's map pushes
                # on this accepted connection too
                conn.peer_label = f"osd.{msg.from_osd}"
            with self._lock:
                self._subs[conn] = self.osdmap.epoch
                reply = self._map_message(msg.start_epoch)
                reply.tid = msg.tid
                conn.send(reply)
            return True
        if isinstance(msg, MOSDFailure):
            with self._lock:
                if msg.failed_for < 0:
                    self.failures.cancel_report(msg.target, msg.reporter)
                else:
                    self.failures.report_failure(
                        msg.target, msg.reporter, time.time()
                    )
            return True
        if isinstance(msg, MOSDBoot):
            with self._lock:
                inc = self.pending()
                inc.mark_up(msg.osd, addr=msg.addr)
                inc.mark_in(msg.osd)
                self.commit(inc)
                self._clog("info", f"osd.{msg.osd} boot")
            return True
        if isinstance(msg, MLog):
            try:
                entries = json.loads(msg.entries)
            except ValueError:
                entries = []
            if isinstance(entries, list):
                with self._lock:
                    self.clog_store.add(
                        [e for e in entries if isinstance(e, dict)]
                    )
            return True
        if isinstance(msg, MMonCommand):
            # "log subscribe" needs the CONNECTION (the watch stream
            # pushes back on it), which command handlers never see —
            # intercept here, before the handler table
            try:
                cmd = json.loads(msg.cmd)
            except ValueError:
                cmd = None
            if (
                isinstance(cmd, dict)
                and cmd.get("prefix") == "log subscribe"
            ):
                reply = self._watch_subscribe(conn, cmd)
            else:
                reply = self.handle_command(msg.cmd)
            reply.tid = msg.tid
            conn.send(reply)
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        self._subs.pop(conn, None)
        self._watch_subs.pop(conn, None)

    # -- `ceph -w` watch stream (the MLog subscription shape) --------------
    def _watch_subscribe(
        self, conn: Connection, cmd: dict
    ) -> MMonCommandReply:
        level = str(cmd.get("level", "info"))
        if level not in _CLOG_PRIOS:
            level = "info"
        with self._lock:
            self._watch_subs[conn] = {
                "level": level,
                "debug": bool(cmd.get("debug", False)),
                # dout watermark: the firehose streams only entries
                # newer than the subscription
                "dout_mark": time.time(),
            }
        return MMonCommandReply(
            outb=json.dumps({"subscribed": True, "level": level})
        )

    def _push_watch(self, entries: list[dict]) -> None:
        """clog fanout (LogStore.notify): every accepted entry
        streams to each subscriber that clears its level floor, as an
        MLog batch; ``--watch-debug`` subscribers additionally get
        the fresh dout-ring tail as channel="debug" entries."""
        if not self._watch_subs:
            return
        from ..common.log import log as _dout_ring
        from ..common.log_client import prio_rank

        for conn, sub in list(self._watch_subs.items()):
            if conn.is_closed:
                self._watch_subs.pop(conn, None)
                continue
            floor = prio_rank(sub["level"])
            batch = [
                e for e in entries
                if prio_rank(e.get("prio", "info")) >= floor
            ]
            if sub["debug"]:
                fresh = [
                    r for r in _dout_ring().dump_recent()
                    if r["stamp"] > sub["dout_mark"]
                ]
                if fresh:
                    sub["dout_mark"] = max(
                        r["stamp"] for r in fresh
                    )
                    batch.extend(
                        {
                            "name": "mon.0",
                            "stamp": r["stamp"],
                            "channel": "debug",
                            "prio": "debug",
                            "message": (
                                f"[{r['subsys']}:{r['level']}] "
                                f"{r['message']}"
                            ),
                            "seq": 0,
                        }
                        for r in fresh
                    )
            if not batch:
                continue
            try:
                conn.send(
                    MLog(name="mon.0", entries=json.dumps(batch))
                )
            except (MessageError, OSError):
                self._watch_subs.pop(conn, None)

    # -- command surface (MonCommands.h role) ------------------------------
    # read-only or high-rate periodic chatter: never audit-logged
    # (the reference's `mon debug` vs audit-channel split)
    _AUDIT_EXEMPT = frozenset(
        {
            "status", "health", "osd dump", "osd tree", "pg dump",
            "osd pool ls", "config get", "config dump", "mgr stat",
            "mds stat", "osd erasure-code-profile get",
            "osd erasure-code-profile ls",
            "log last", "log stat",
            # periodic daemon chatter
            "mds beacon", "mgr beacon", "osd slow ops",
            "crash report", "osd scrub errors", "osd stat report",
            "osd df", "osd perf", "slo report",
            "pgmap report", "df",
        }
    )

    def handle_command(self, cmd_json: str) -> MMonCommandReply:
        try:
            cmd = json.loads(cmd_json)
            prefix = cmd.get("prefix", "")
            handler = _COMMANDS.get(prefix)
            if handler is None:
                return MMonCommandReply(
                    rc=-22, outs=f"unknown command {prefix!r}"
                )
            with self._lock:
                if prefix not in self._AUDIT_EXEMPT:
                    # mutating operator commands hit the audit channel
                    # (the reference logs every dispatch to clog audit)
                    self._clog(
                        "info",
                        f"cmd={cmd_json[:512]}: dispatch",
                        channel="audit",
                    )
                return handler(self, cmd)
        except Exception as e:  # noqa: BLE001 — the RPC contract: a
            # command must ALWAYS produce a reply (a raised handler
            # would otherwise leave the caller blocked to timeout)
            if not isinstance(
                e, (KeyError, ValueError, TypeError, AttributeError)
            ):
                # those four are malformed-input shapes (missing,
                # bad, or wrong-typed fields — e.g. cmd='[]' makes
                # .get raise AttributeError) — operator error, not a
                # mon crash; filing reports for them would let any
                # client raise RECENT_CRASH with garbage commands.
                # Anything else is a real handler bug: file a report
                from ..common import crash as _crash

                _crash.capture(
                    "mon.0", e, extra_meta={"cmd": cmd_json[:512]}
                )
            return MMonCommandReply(rc=-22, outs=f"{type(e).__name__}: {e}")


def _cmd_status(mon: Monitor, cmd: dict) -> MMonCommandReply:
    m = mon.osdmap
    up = sum(1 for o in range(m.max_osd) if m.is_up(o))
    inn = sum(
        1
        for o in range(m.max_osd)
        if m.exists(o) and m.osd_weight[o] > 0
    )
    status = {
        "epoch": m.epoch,
        "num_osds": m.max_osd,
        "num_up_osds": up,
        "num_in_osds": inn,
        "num_pools": len(m.pools),
    }
    digest = mon.pgmap_digest()
    if digest is not None:
        # the reference's `ceph status` data/io section (PGMap::print_summary)
        status["pgmap"] = {
            "num_pgs": digest.get("num_pgs", 0),
            "pgs_by_state": digest.get("pg_states", {}),
            "data": digest.get("totals", {}),
            "io": digest.get("io", {}),
            "recovery": digest.get("recovery", {}),
        }
    return MMonCommandReply(outb=json.dumps(status))


def _cmd_pgmap_report(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """The mgr pgmap module's digest push.  Bounded validation (the
    slo-report idiom): the digest travels base64(binary) and must
    decode through the pinned codec or the push is rejected."""
    import base64 as _b64

    from ..mgr.pgmap import decode_pgmap_digest

    raw = cmd.get("digest")
    if not isinstance(raw, str) or len(raw) > 4 << 20:
        return MMonCommandReply(rc=-22, outs="bad digest")
    try:
        digest = decode_pgmap_digest(_b64.b64decode(raw))
    except Exception:  # noqa: BLE001 — reject, never crash the mon
        return MMonCommandReply(rc=-22, outs="undecodable digest")
    mon.pgmap = (time.time(), digest)
    return MMonCommandReply(outb=json.dumps({"ok": True}))


def _cmd_df(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph df': cluster fill from the per-OSD stat reports +
    per-pool stored/objects from the pgmap digest."""
    now = time.time()
    kb = kb_used = kb_avail = 0
    for _osd, (ts, k, ku, ka) in list(mon.osd_stats.items()):
        if now - ts > STAT_REPORT_GRACE:
            continue
        kb += k
        kb_used += ku
        kb_avail += ka
    digest = mon.pgmap_digest() or {}
    pools = []
    for pid in sorted(mon.osdmap.pools):
        p = (digest.get("pools") or {}).get(pid, {})
        pools.append(
            {
                "id": pid,
                "name": mon.osdmap.pool_names.get(pid, str(pid)),
                "stored": p.get("bytes", 0),
                "objects": p.get("objects", 0),
                "degraded": p.get("degraded", 0),
                "misplaced": p.get("misplaced", 0),
            }
        )
    return MMonCommandReply(
        outb=json.dumps(
            {
                "stats": {
                    "total_bytes": kb * 1024,
                    "total_used_bytes": kb_used * 1024,
                    "total_avail_bytes": kb_avail * 1024,
                },
                "pools": pools,
            }
        )
    )


def _cmd_osd_down(mon: Monitor, cmd: dict) -> MMonCommandReply:
    osd = int(cmd["id"])
    if not mon.osdmap.is_up(osd):
        # the state entry is an XOR: re-queueing it for a down OSD
        # would flip it back up (OSDMonitor guards with is_up too)
        return MMonCommandReply(outs=f"osd.{osd} is already down")
    inc = mon.pending()
    inc.mark_down(osd)
    epoch = mon.commit(inc)
    return MMonCommandReply(outs=f"marked down osd.{osd}", outb=json.dumps({"epoch": epoch}))


def _cmd_osd_out(mon: Monitor, cmd: dict) -> MMonCommandReply:
    osd = int(cmd["id"])
    inc = mon.pending()
    inc.mark_out(osd)
    epoch = mon.commit(inc)
    return MMonCommandReply(outs=f"marked out osd.{osd}", outb=json.dumps({"epoch": epoch}))


def _cmd_osd_in(mon: Monitor, cmd: dict) -> MMonCommandReply:
    osd = int(cmd["id"])
    inc = mon.pending()
    inc.mark_in(osd)
    epoch = mon.commit(inc)
    return MMonCommandReply(outs=f"marked in osd.{osd}", outb=json.dumps({"epoch": epoch}))


def _cmd_osd_reweight(mon: Monitor, cmd: dict) -> MMonCommandReply:
    osd = int(cmd["id"])
    weight = float(cmd["weight"])
    inc = mon.pending()
    inc.new_weight[osd] = int(weight * 0x10000)
    epoch = mon.commit(inc)
    return MMonCommandReply(outb=json.dumps({"epoch": epoch}))


def _cmd_osd_blocklist(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """Client fencing ("osd blocklist add/rm/ls", OSDMonitor's
    blocklist command, src/mon/OSDMonitor.cc prepare_command
    "osd blocklist").  ``addr`` is the client id the objecter stamps
    into every reqid; OSDs reject ops from blocklisted ids, which is
    what makes exclusive-lock break-lock and MDS failover safe."""
    op = cmd.get("blocklistop", "add")
    if op == "ls":
        now = time.time()
        live = {
            a: u for a, u in mon.osdmap.blocklist.items() if u > now
        }
        return MMonCommandReply(outb=json.dumps(live))
    addr = cmd["addr"]
    inc = mon.pending()
    if op == "add":
        expire = float(cmd.get("expire", 3600.0))
        inc.new_blocklist[addr] = time.time() + expire
        # trim dead entries while we are mutating anyway (the
        # reference expires them in OSDMonitor tick).  NEVER trim the
        # addr being re-added: apply_incremental applies new before
        # old, so the same addr in both would cancel the fresh fence
        now = time.time()
        for a, until in mon.osdmap.blocklist.items():
            if until <= now and a != addr:
                inc.old_blocklist.append(a)
        epoch = mon.commit(inc)
        return MMonCommandReply(
            outs=f"blocklisting {addr} for {expire}s",
            outb=json.dumps({"epoch": epoch}),
        )
    if op == "rm":
        if addr not in mon.osdmap.blocklist:
            return MMonCommandReply(
                outs=f"{addr} isn't blocklisted"
            )
        inc.old_blocklist.append(addr)
        epoch = mon.commit(inc)
        return MMonCommandReply(
            outs=f"un-blocklisting {addr}",
            outb=json.dumps({"epoch": epoch}),
        )
    return MMonCommandReply(rc=-22, outs=f"bad blocklistop {op!r}")


def _cmd_pool_create(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """Pool creation (OSDMonitor "osd pool create").  Erasure pools
    (pool_type=3) size themselves from the profile (size=k+m,
    min_size=k+1 — OSDMonitor::prepare_pool_size) and, when no
    crush_rule is given, get a profile-named indep rule created the
    way the plugin's create_rule would (OSDMonitor.cc:10928 flow)."""
    name = cmd["pool"]
    if name in mon.osdmap.pool_names.values():
        return MMonCommandReply(rc=-17, outs=f"pool {name!r} exists")
    pool_id = mon.osdmap.pool_max + 1
    ptype = int(cmd.get("pool_type", 1))
    size = int(cmd.get("size", 3))
    min_size = cmd.get("min_size")
    crush_rule = cmd.get("crush_rule")
    profile_name = cmd.get("erasure_code_profile", "")
    inc = mon.pending()
    if ptype == PG_POOL_TYPE_ERASURE:
        profile_name = profile_name or "default"
        profile = mon.osdmap.erasure_code_profiles.get(profile_name)
        if profile is None:
            return MMonCommandReply(
                rc=-2,
                outs=f"erasure-code-profile {profile_name!r} not found",
            )
        try:
            from ..osd.ec_pg import ECCodec

            # only n and k are read here: the check builds the codec on
            # the CPU, from a copy (the stored profile is not changed)
            codec = ECCodec({**profile, "device": "cpu"})
        except Exception as e:  # noqa: BLE001 — profile is user input
            return MMonCommandReply(
                rc=-22, outs=f"invalid profile {profile_name!r}: {e}"
            )
        size = codec.n
        min_size = (
            int(min_size) if min_size is not None else codec.k + 1
        )
        if crush_rule is None:
            # reuse a rule already named after the profile, else build
            # one on a crushmap copy and ship it in the incremental
            cmap = mon.osdmap.crush
            existing = [
                rid
                for rid, rname in cmap.rule_names.items()
                if rname == profile_name
            ]
            if existing:
                crush_rule = existing[0]
            else:
                import copy as _copy

                newmap = _copy.deepcopy(cmap)
                try:
                    crush_rule = newmap.add_simple_rule(
                        profile_name,
                        profile.get("crush-root", "default"),
                        profile.get("crush-failure-domain", "host"),
                        mode="indep",
                    )
                except (KeyError, AssertionError) as e:
                    return MMonCommandReply(
                        rc=-22,
                        outs=f"cannot create erasure rule: {e}",
                    )
                inc.crush = newmap
    pool = PgPool(
        pool_id=pool_id,
        type=ptype,
        size=size,
        pg_num=int(cmd.get("pg_num", 32)),
        crush_rule=int(crush_rule or 0),
        erasure_code_profile=profile_name,
    )
    if min_size is not None:
        pool.min_size = int(min_size)
    inc.new_pools[pool_id] = pool
    inc.new_pool_names[pool_id] = name
    inc.new_pool_max = pool_id
    epoch = mon.commit(inc)
    return MMonCommandReply(
        outs=f"pool '{name}' created",
        outb=json.dumps({"pool_id": pool_id, "epoch": epoch}),
    )


def _pool_by_name(mon: Monitor, name: str):
    for pid, pname in mon.osdmap.pool_names.items():
        if pname == name:
            return pid, mon.osdmap.pools[pid]
    return None, None


def _cmd_pool_mksnap(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """"osd pool mksnap" (OSDMonitor::prepare_command pool snaps):
    bump the pool's snap_seq and record the named snap; the new pool
    rides an incremental, and every write after this epoch clones."""
    pid, pool = _pool_by_name(mon, cmd["pool"])
    if pool is None:
        return MMonCommandReply(rc=-2, outs=f"pool {cmd['pool']!r} not found")
    snap = cmd["snap"]
    if snap in pool.snaps.values():
        return MMonCommandReply(rc=-17, outs=f"snap {snap!r} exists")
    import copy as _copy

    newpool = _copy.deepcopy(pool)
    newpool.snap_seq += 1
    newpool.snaps[newpool.snap_seq] = snap
    inc = mon.pending()
    inc.new_pools[pid] = newpool
    epoch = mon.commit(inc)
    return MMonCommandReply(
        outs=f"created pool {cmd['pool']} snap {snap}",
        outb=json.dumps(
            {"snapid": newpool.snap_seq, "epoch": epoch}
        ),
    )


def _cmd_pool_rmsnap(mon: Monitor, cmd: dict) -> MMonCommandReply:
    pid, pool = _pool_by_name(mon, cmd["pool"])
    if pool is None:
        return MMonCommandReply(rc=-2, outs=f"pool {cmd['pool']!r} not found")
    snap = cmd["snap"]
    sid = next(
        (k for k, v in pool.snaps.items() if v == snap), None
    )
    if sid is None:
        return MMonCommandReply(rc=-2, outs=f"snap {snap!r} not found")
    import copy as _copy

    newpool = _copy.deepcopy(pool)
    del newpool.snaps[sid]
    inc = mon.pending()
    inc.new_pools[pid] = newpool
    epoch = mon.commit(inc)
    return MMonCommandReply(
        outs=f"removed pool {cmd['pool']} snap {snap}",
        outb=json.dumps({"snapid": sid, "epoch": epoch}),
    )


def _cmd_pool_delete(mon: Monitor, cmd: dict) -> MMonCommandReply:
    name = cmd["pool"]
    ids = [i for i, n in mon.osdmap.pool_names.items() if n == name]
    if not ids:
        return MMonCommandReply(rc=-2, outs=f"pool {name!r} not found")
    inc = mon.pending()
    inc.old_pools.add(ids[0])
    epoch = mon.commit(inc)
    return MMonCommandReply(outb=json.dumps({"epoch": epoch}))


def _cmd_ec_profile_set(mon: Monitor, cmd: dict) -> MMonCommandReply:
    name = cmd["name"]
    profile = {}
    for kv in cmd.get("profile", []):
        k, _, v = kv.partition("=")
        profile[k] = v
    inc = mon.pending()
    inc.new_erasure_code_profiles[name] = profile
    epoch = mon.commit(inc)
    return MMonCommandReply(outb=json.dumps({"epoch": epoch}))


def _cmd_pg_upmap_items(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """"osd pg-upmap-items <pgid> <from> <to> [...]" — the balancer's
    commit surface (OSDMonitor's pg-upmap-items command)."""
    pgid = cmd["pgid"]
    try:
        pool_id, ps = (int(x) for x in pgid.split("."))
    except ValueError:
        return MMonCommandReply(rc=-22, outs=f"bad pgid {pgid!r}")
    if pool_id not in mon.osdmap.pools:
        return MMonCommandReply(rc=-2, outs=f"no pool {pool_id}")
    mappings = [
        (int(a), int(b)) for a, b in cmd.get("mappings", [])
    ]
    inc = mon.pending()
    if mappings:
        inc.new_pg_upmap_items[(pool_id, ps)] = mappings
    else:
        inc.old_pg_upmap_items.add((pool_id, ps))
    epoch = mon.commit(inc)
    return MMonCommandReply(outb=json.dumps({"epoch": epoch}))


def _cmd_osd_dump(mon: Monitor, cmd: dict) -> MMonCommandReply:
    m = mon.osdmap
    return MMonCommandReply(
        outb=json.dumps(
            {
                "epoch": m.epoch,
                "max_osd": m.max_osd,
                "osds": [
                    {
                        "osd": o,
                        "up": int(m.is_up(o)),
                        "in": int(m.exists(o) and m.osd_weight[o] > 0),
                        "weight": m.osd_weight[o] / 0x10000,
                    }
                    for o in range(m.max_osd)
                ],
                "pools": {
                    str(pid): {
                        "name": m.pool_names.get(pid, ""),
                        "size": p.size,
                        "pg_num": p.pg_num,
                        "type": p.type,
                    }
                    for pid, p in m.pools.items()
                },
            }
        )
    )


def _prune_mutes(mon: Monitor) -> None:
    """TTL expiry: a lapsed mute restores the check to the rollup."""
    now = time.time()
    for code, expiry in list(mon.health_mutes.items()):
        if expiry <= now:
            del mon.health_mutes[code]
            mon._clog("info", f"Health check unmuted: {code} (TTL)")


def _cmd_health(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph health' (HealthMonitor role): DOWN/OUT osds, fresh
    SLOW_OPS reports, and RECENT_CRASH degrade to WARN.  Muted codes
    leave the rollup (status + checks) but stay in checks_detail —
    mutes filter, they never lose detail."""
    checks = mon.health_checks()
    _prune_mutes(mon)
    muted = {c for c in checks if c in mon.health_mutes}
    active = {c: v for c, v in checks.items() if c not in muted}
    # the rollup takes the WORST active severity: scrub damage
    # (OSD_SCRUB_ERRORS/PG_DAMAGED) is HEALTH_ERR, not a warning
    if not active:
        status = "HEALTH_OK"
    elif any(
        v.get("severity") == "HEALTH_ERR" for v in active.values()
    ):
        status = "HEALTH_ERR"
    else:
        status = "HEALTH_WARN"
    return MMonCommandReply(
        outs=status,
        outb=json.dumps(
            {
                "status": status,
                "checks": [v["summary"] for v in active.values()],
                "checks_detail": {
                    code: {**v, "muted": code in muted}
                    for code, v in checks.items()
                },
                "muted": sorted(muted),
            }
        ),
    )


def _cmd_health_mute(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph health mute <code> [--ttl N]': drop a check code from
    the health rollup (HealthMonitor mutes)."""
    code = str(cmd.get("code", "")).strip()
    if not code or len(code) > MAX_MUTE_CODE_LEN:
        return MMonCommandReply(
            rc=-22, outs="missing or oversized code (-EINVAL)"
        )
    if (
        code not in mon.health_mutes
        and len(mon.health_mutes) >= MAX_HEALTH_MUTES
    ):
        return MMonCommandReply(
            rc=-7, outs="too many muted codes (-E2BIG)"
        )
    ttl = cmd.get("ttl")
    expiry = float("inf") if ttl is None else time.time() + float(ttl)
    mon.health_mutes[code] = expiry
    mon._clog(
        "info",
        f"Health check muted: {code}"
        + (f" (TTL {float(ttl):.0f}s)" if ttl is not None else ""),
        channel="audit",
    )
    return MMonCommandReply(
        outs=f"muted {code}",
        outb=json.dumps({"code": code, "ttl": ttl}),
    )


def _cmd_health_unmute(mon: Monitor, cmd: dict) -> MMonCommandReply:
    code = str(cmd.get("code", "")).strip()
    if code not in mon.health_mutes:
        return MMonCommandReply(
            rc=-2, outs=f"{code!r} is not muted (-ENOENT)"
        )
    del mon.health_mutes[code]
    mon._clog(
        "info", f"Health check unmuted: {code}", channel="audit"
    )
    return MMonCommandReply(outs=f"unmuted {code}")


def _cmd_crash_report(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """mgr crash module → mon: the current count of un-archived
    recent crashes (the mgr-raised health check surface).  Archiving
    pushes 0, which clears RECENT_CRASH."""
    mon.recent_crashes = max(0, int(cmd.get("num_recent", 0)))
    return MMonCommandReply(outb=json.dumps({"ok": True}))


def _cmd_log_last(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph log last [n] [level] [channel]' (LogMonitor's command)."""
    n = int(cmd.get("num", 20))
    level = cmd.get("level")
    channel = cmd.get("channel")
    entries = mon.clog_store.last(n, level=level, channel=channel)
    return MMonCommandReply(
        outs="\n".join(
            f"{e['stamp']:.6f} {e['name']} ({e['channel']}) "
            f"[{e['prio'].upper()}] {e['message']}"
            for e in entries
        ),
        outb=json.dumps(entries),
    )


def _cmd_log_stat(mon: Monitor, cmd: dict) -> MMonCommandReply:
    return MMonCommandReply(outb=json.dumps(mon.clog_store.stat()))


def _cmd_log_inject(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph log <text>': operator entry onto the cluster log (the
    reference's `ceph log` command)."""
    text = cmd.get("logtext", "")
    if isinstance(text, list):
        text = " ".join(str(t) for t in text)
    if not text:
        return MMonCommandReply(rc=-22, outs="missing logtext (-EINVAL)")
    mon.clog_store.add(
        [
            {
                "name": str(cmd.get("name", "client.admin")),
                "stamp": time.time(),
                "channel": str(cmd.get("channel", "cluster")),
                "prio": str(cmd.get("prio", "info")),
                "message": str(text),
                "seq": 0,
            }
        ]
    )
    return MMonCommandReply(outs="logged")


def _cmd_osd_slow_ops(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """Daemon → mon slow-op report (the OSD SLOW_OPS watchdog's
    upcall; MOSDBeacon's health payload in the reference).  A count
    of 0 withdraws the daemon's complaint immediately."""
    daemon = str(cmd.get("daemon", ""))
    if not daemon:
        return MMonCommandReply(rc=-22, outs="missing daemon")
    count = int(cmd.get("count", 0))
    oldest = float(cmd.get("oldest_age", 0.0))
    if count <= 0:
        mon.slow_ops.pop(daemon, None)
    else:
        mon.slow_ops[daemon] = (time.time(), count, oldest)
    return MMonCommandReply(rc=0, outb=json.dumps({"ok": True}))


def _cmd_osd_stat_report(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """Daemon → mon space-stat report (the osd_stat_t carry of
    MPGStats, reduced to the fullness fields): kb/kb_used/kb_avail
    from the OSD's store statfs.  Feeds OSD_NEARFULL/OSD_FULL."""
    try:
        osd = int(cmd["osd"])
    except (KeyError, TypeError, ValueError):
        return MMonCommandReply(rc=-22, outs="missing osd id")
    kb = max(0, int(cmd.get("kb", 0)))
    kb_used = max(0, int(cmd.get("kb_used", 0)))
    kb_avail = max(0, int(cmd.get("kb_avail", 0)))
    mon.osd_stats[osd] = (time.time(), kb, kb_used, kb_avail)
    # optional perf seat (commit/apply latency → `ceph osd perf`);
    # apply defaults to commit — the stores have no journal split
    if "commit_latency_ms" in cmd:
        try:
            commit = max(0.0, float(cmd["commit_latency_ms"]))
            apply_ = max(
                0.0, float(cmd.get("apply_latency_ms", commit))
            )
            mon.osd_perf_stats[osd] = (time.time(), commit, apply_)
        except (TypeError, ValueError):
            pass  # malformed perf seat: keep the space stats
    # the reply carries the EFFECTIVE ratios so the OSD's write gate
    # follows `ceph config set mon mon_osd_full_ratio ...` instead of
    # diverging from the health check on its local schema default
    return MMonCommandReply(
        rc=0,
        outb=json.dumps(
            {
                "ok": True,
                "nearfull_ratio": mon._config_float(
                    "mon_osd_nearfull_ratio"
                ),
                "full_ratio": mon._config_float(
                    "mon_osd_full_ratio"
                ),
            }
        ),
    )


def _cmd_osd_df(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph osd df' (reduced): per-OSD kb/kb_used/kb_avail from the
    latest stat reports, with the effective full ratios."""
    return MMonCommandReply(
        outb=json.dumps(
            {
                "nearfull_ratio": mon._config_float(
                    "mon_osd_nearfull_ratio"
                ),
                "full_ratio": mon._config_float("mon_osd_full_ratio"),
                "nodes": [
                    {
                        "osd": osd,
                        "kb": kb,
                        "kb_used": kb_used,
                        "kb_avail": kb_avail,
                        "utilization": (
                            kb_used / kb if kb else 0.0
                        ),
                    }
                    for osd, (_ts, kb, kb_used, kb_avail) in sorted(
                        mon.osd_stats.items()
                    )
                ],
            }
        )
    )


def _cmd_osd_perf(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph osd perf' (OSDMonitor's osd_stat_t perf view): per-OSD
    commit/apply latency from the freshest stat reports — the CLI
    table the reference prints from PGMap::dump_osd_perf_stats."""
    now = time.time()
    infos = []
    for osd, (ts, commit, apply_) in sorted(
        mon.osd_perf_stats.items()
    ):
        if not mon.osdmap.is_up(osd) or now - ts > STAT_REPORT_GRACE:
            del mon.osd_perf_stats[osd]
            continue
        infos.append(
            {
                "id": osd,
                "perf_stats": {
                    "commit_latency_ms": commit,
                    "apply_latency_ms": apply_,
                },
            }
        )
    return MMonCommandReply(
        outs="\n".join(
            ["osd  commit_latency(ms)  apply_latency(ms)"]
            + [
                f"{e['id']:>3}  "
                f"{e['perf_stats']['commit_latency_ms']:>18.3f}  "
                f"{e['perf_stats']['apply_latency_ms']:>17.3f}"
                for e in infos
            ]
        ),
        outb=json.dumps({"osd_perf_infos": infos}),
    )


_SLO_SEVERITIES = ("HEALTH_WARN", "HEALTH_ERR")
MAX_SLO_CHECKS = 32
MAX_SLO_SUMMARY = 512


def _cmd_slo_report(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """mgr slo module → mon: the current burn-rate verdicts (the
    mgr-raised health-check push, same idiom as "crash report").
    Each push REPLACES the set — an empty ``checks`` clears
    SLO_LATENCY immediately; entries are bounded and validated
    because they render into health summaries and the cluster log."""
    checks = cmd.get("checks", {})
    if not isinstance(checks, dict):
        return MMonCommandReply(rc=-22, outs="checks must be a dict")
    if len(checks) > MAX_SLO_CHECKS:
        return MMonCommandReply(
            rc=-7, outs="too many slo checks (-E2BIG)"
        )
    now = time.time()
    accepted: dict[str, tuple[float, str, str]] = {}
    for code, det in checks.items():
        code = str(code)
        if not code.startswith("SLO_") or len(code) > MAX_MUTE_CODE_LEN:
            return MMonCommandReply(
                rc=-22, outs=f"bad slo check code {code!r}"
            )
        severity = str(det.get("severity", "HEALTH_WARN"))
        if severity not in _SLO_SEVERITIES:
            return MMonCommandReply(
                rc=-22, outs=f"bad severity {severity!r}"
            )
        summary = str(det.get("summary", ""))[:MAX_SLO_SUMMARY]
        accepted[code] = (now, severity, summary)
    mon.slo_reports = accepted
    return MMonCommandReply(outb=json.dumps({"ok": True}))


def _cmd_tell(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph tell <daemon> <args...>' routing: the mon validates the
    target and names its address; the CLI dispatches the inner
    command there as an MCommand (the mon→daemon command route of
    the reference, collapsed to mon-names/client-dispatches exactly
    like the scrub orders)."""
    target = str(cmd.get("target", ""))
    kind, _, ident = target.partition(".")
    if kind != "osd" or not ident.isdigit():
        return MMonCommandReply(
            rc=-22, outs=f"bad tell target {target!r} (osd.N only)"
        )
    osd = int(ident)
    if not mon.osdmap.is_up(osd):
        return MMonCommandReply(
            rc=-11, outs=f"osd.{osd} is down (-EAGAIN)"
        )
    addr = mon.osdmap.osd_addrs.get(osd, "")
    if not addr:
        return MMonCommandReply(
            rc=-11, outs=f"osd.{osd} has no address (-EAGAIN)"
        )
    return MMonCommandReply(
        outb=json.dumps(
            {
                "target": target,
                "addr": addr,
                "args": cmd.get("args", {}),
            }
        )
    )


def _cmd_osd_scrub_errors(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """Daemon → mon scrub-findings report (the pg-stats path that
    feeds OSD_SCRUB_ERRORS/PG_DAMAGED in the reference).  A report of
    0 errors — what a successful repair sends — clears the daemon's
    contribution immediately."""
    daemon = str(cmd.get("daemon", ""))
    if not daemon:
        return MMonCommandReply(rc=-22, outs="missing daemon")
    errors = int(cmd.get("errors", 0))
    pgs = [str(p) for p in cmd.get("pgs", [])]
    large = int(cmd.get("large_omap", 0))
    if errors <= 0 and large <= 0:
        mon.scrub_reports.pop(daemon, None)
    else:
        mon.scrub_reports[daemon] = (
            time.time(), errors, pgs, large,
        )
    return MMonCommandReply(rc=0, outb=json.dumps({"ok": True}))


def _cmd_pg_scrub(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph pg scrub|deep-scrub|repair <pgid>': validate the pg and
    name its primary + address — the CLI dispatches the order to the
    primary OSD directly (the mon→mgr→OSD scrub-order route of the
    reference, collapsed to mon-names/client-dispatches)."""
    what = str(cmd.get("prefix", "pg scrub"))[3:]
    pgid = str(cmd.get("pgid", ""))
    try:
        pool_id, ps = (int(x) for x in pgid.split("."))
    except ValueError:
        return MMonCommandReply(rc=-22, outs=f"bad pgid {pgid!r}")
    pool = mon.osdmap.pools.get(pool_id)
    if pool is None or ps < 0 or ps >= pool.pg_num:
        return MMonCommandReply(rc=-2, outs=f"pg {pgid} dne")
    _up, _upp, _acting, primary = mon.osdmap.pg_to_up_acting_osds(
        pool_id, ps
    )
    if primary < 0 or not mon.osdmap.is_up(primary):
        return MMonCommandReply(
            rc=-11, outs=f"pg {pgid} has no live primary (-EAGAIN)"
        )
    return MMonCommandReply(
        outs=f"instructing pg {pgid} on osd.{primary} to {what}",
        outb=json.dumps(
            {
                "pgid": pgid,
                "op": what,
                "primary": primary,
                "addr": mon.osdmap.osd_addrs.get(primary, ""),
            }
        ),
    )


def _cmd_osd_tree(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph osd tree' (CrushTreeDumper role): the crush hierarchy
    with up/down + weight per device, shadow trees hidden."""
    m = mon.osdmap
    crush = m.crush
    shadows = {
        c for per in crush.class_bucket.values() for c in per.values()
    }
    lines = []

    def walk(item: int, depth: int, weight: int) -> None:
        indent = "    " * depth
        if item >= 0:
            state = "up" if m.is_up(item) else "down"
            reweight = (
                m.osd_weight[item] / 0x10000
                if item < m.max_osd
                else 0.0
            )
            cls = crush.class_names.get(
                crush.class_map.get(item, -1), ""
            )
            lines.append(
                f"{item:>4} {cls:>6} {weight / 0x10000:>8.5f} "
                f"{indent}osd.{item} {state:>6} {reweight:.5f}"
            )
            return
        b = crush.buckets[item]
        name = crush.item_names.get(item, f"bucket{-1 - item}")
        tname = crush.type_names.get(b.type, str(b.type))
        lines.append(
            f"{item:>4} {'':>6} {b.weight / 0x10000:>8.5f} "
            f"{indent}{tname} {name}"
        )
        for child, w in zip(b.items, b.item_weights):
            walk(child, depth + 1, w)

    for root in sorted(crush._roots(), reverse=True):
        if root in shadows:
            continue
        walk(root, 0, crush.buckets[root].weight)
    header = "  ID  CLASS   WEIGHT NAME/STATE"
    return MMonCommandReply(outb="\n".join([header] + lines))


def _cmd_pg_dump(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'ceph pg dump': every pool PG with its up/acting sets (the
    OSDMonitor side of pg listing; per-PG I/O stats live on the mgr)."""
    m = mon.osdmap
    digest_pgs = (mon.pgmap_digest() or {}).get("pgs", {})
    pgs = []
    for pid, pool in m.pools.items():
        for ps in range(pool.pg_num):
            up, upp, acting, actingp = m.pg_to_up_acting_osds(pid, ps)
            row = {
                "pgid": f"{pid}.{ps}",
                "up": up,
                "up_primary": upp,
                "acting": acting,
                "acting_primary": actingp,
            }
            # states + counts from the mgr digest (the PGMap side of
            # pg dump); unreported pgs keep the map-only row
            st = digest_pgs.get(row["pgid"])
            if st is not None:
                row.update(
                    {
                        "state": st.get("state", "unknown"),
                        "num_objects": st.get("objects", 0),
                        "num_bytes": st.get("bytes", 0),
                        "num_objects_degraded": st.get("degraded", 0),
                        "num_objects_misplaced": st.get(
                            "misplaced", 0
                        ),
                        "num_objects_unfound": st.get("unfound", 0),
                        "recovery_progress": st.get(
                            "recovery_progress", 0.0
                        ),
                    }
                )
            pgs.append(row)
    return MMonCommandReply(outb=json.dumps({"pg_stats": pgs}))


def _cmd_pool_ls(mon: Monitor, cmd: dict) -> MMonCommandReply:
    names = [
        mon.osdmap.pool_names.get(pid, str(pid))
        for pid in sorted(mon.osdmap.pools)
    ]
    return MMonCommandReply(
        outs="\n".join(names), outb=json.dumps(names)
    )


def _cmd_ec_profile_get(mon: Monitor, cmd: dict) -> MMonCommandReply:
    name = cmd["name"]
    prof = mon.osdmap.erasure_code_profiles.get(name)
    if prof is None:
        return MMonCommandReply(rc=-2, outs=f"profile {name!r} not found")
    return MMonCommandReply(outb=json.dumps(prof))


def _cmd_ec_profile_ls(mon: Monitor, cmd: dict) -> MMonCommandReply:
    return MMonCommandReply(
        outb=json.dumps(sorted(mon.osdmap.erasure_code_profiles))
    )


def _cmd_config_set(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """ConfigMonitor role: centralized config database ('ceph config
    set <who> <key> <value>')."""
    who, key, value = cmd["who"], cmd["key"], str(cmd["value"])
    mon.config_db.setdefault(who, {})[key] = value
    return MMonCommandReply(outs=f"set {who}/{key}")


def _cmd_config_get(mon: Monitor, cmd: dict) -> MMonCommandReply:
    who = cmd["who"]
    key = cmd.get("key")
    section = mon.config_db.get(who, {})
    if key is not None:
        if key not in section:
            return MMonCommandReply(rc=-2, outs=f"no config {who}/{key}")
        return MMonCommandReply(outs=section[key], outb=json.dumps(section[key]))
    return MMonCommandReply(outb=json.dumps(section))


def _cmd_config_dump(mon: Monitor, cmd: dict) -> MMonCommandReply:
    return MMonCommandReply(outb=json.dumps(mon.config_db))


def _fence_mds(mon: Monitor, entry: dict | None) -> None:
    """Blocklist a demoted/replaced active's rados client id so a
    partitioned-but-alive daemon cannot flush journal or metadata the
    promoted standby's replay never saw (MDSMonitor fences the old
    gid via the OSDMap blocklist, src/mon/MDSMonitor.cc fail_mds_gid).
    Paxos-committed, so every OSD enforces it."""
    cid = (entry or {}).get("client")
    if not cid:
        return
    try:
        inc = mon.pending()
        inc.new_blocklist[cid] = time.time() + 3600.0
        mon.commit(inc)
    except Exception:  # noqa: BLE001 — a no-quorum window loses the
        # fence attempt, not the failover; the stale active still
        # demotes on its next beacon reply
        pass


def _mdsmap_of(mon: Monitor) -> dict:
    m = getattr(mon, "mdsmap", None)
    if m is None or "actives" not in m:
        m = mon.mdsmap = {
            "epoch": 0,
            "max_mds": 1,
            # rank (as str, JSON-stable) -> {name, addr, client}
            "actives": {},
            "standbys": [],
            "beacons": {},
            # subtree auth table: path prefix -> rank.  "subtrees" is
            # the LATEST table (what daemons must converge to);
            # "subtrees_stable" is what clients may route by — it
            # advances only once every active has flushed under the
            # new table and acked its epoch (the Migrator
            # export/import barrier, reduced to flush+ack)
            "subtrees": {"/": 0},
            "subtrees_stable": {"/": 0},
            "table_epoch": 0,
            "table_acks": {},  # name -> acked table_epoch
            # shrink-evicted ranks whose journals rank 0 must adopt
            # (replay + trim) before the re-pinned table stabilizes;
            # entries are [rank, gen] — the generation tag makes an
            # ack specific to ONE eviction, so a stale beacon ack
            # from before a re-grow→re-shrink cycle cannot drain a
            # NEWER eviction's un-replayed journal
            "stray_ranks": [],
            "stray_gen": 0,
        }
    return m


def _mds_promote_holes(mon: Monitor, m: dict) -> None:
    """Fill empty ranks (0..max_mds-1) from the standby pool.  A rank
    whose shrink-evicted journal is still queued for adoption
    (stray_ranks) is NOT refilled yet: promoting it mid-adoption
    would let the adopter's eventual trim() write a stale journal
    head over entries the fresh rank has already flushed — the rank
    re-grows only after its journal drained (rank 0 is never evicted,
    so adoption always makes progress)."""
    queued = {e[0] for e in m.get("stray_ranks", [])}
    for rank in range(m["max_mds"]):
        key = str(rank)
        if key in m["actives"] or rank in queued:
            continue
        if not m["standbys"]:
            break
        m["actives"][key] = m["standbys"].pop(0)
        m["epoch"] += 1


def _mds_table_maybe_stabilize(m: dict) -> None:
    """Expose the latest subtree table to clients once EVERY active
    has flushed under it (two-phase export: the old auth's dirty
    state must reach the backing omap before the new auth serves).
    Undrained stray journals (a shrink's evicted ranks, adopted by
    rank 0 — see _cmd_mds_set_max) hold the table back too: clients
    must not route to the new auth before it replayed the evicted
    rank's client-acked mutations."""
    te = m["table_epoch"]
    if m["subtrees_stable"] == m["subtrees"]:
        return
    if m.get("stray_ranks"):
        return
    if all(
        m["table_acks"].get(e["name"], -1) >= te
        for e in m["actives"].values()
    ):
        m["subtrees_stable"] = dict(m["subtrees"])


def _cmd_mds_beacon(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """MDSMonitor beacon handling (src/mon/MDSMonitor.cc reduced):
    max_mds active ranks + standbys, stale-beacon failover, subtree
    table distribution.  The mdsmap lives on the leader; a fresh
    leader rebuilds it from the next beacons (deviation: not
    paxos-committed — documented in mds package).  Replacing a stale
    active FENCES it (see _fence_mds)."""
    name = cmd["name"]
    addr = cmd["addr"]
    m = _mdsmap_of(mon)
    now = time.time()
    m["beacons"][name] = now
    if cmd.get("adopted_ranks") and m.get("stray_ranks"):
        # rank 0 replayed these evicted ranks' journals (shrink
        # adoption, _cmd_mds_set_max): drain the queue so the
        # re-pinned table can stabilize.  Acks are (rank, gen) pairs
        # — an ack for an OLDER eviction of the same rank does not
        # drain a newer one still awaiting replay
        done = {(int(e[0]), int(e[1])) for e in cmd["adopted_ranks"]}
        m["stray_ranks"] = [
            e for e in m["stray_ranks"] if tuple(e) not in done
        ]
    if "table_epoch" in cmd:
        m["table_acks"][name] = int(cmd["table_epoch"])
        _mds_table_maybe_stabilize(m)
    grace = getattr(mon, "mds_beacon_grace", 4.0)
    entry = {"name": name, "addr": addr,
             "client": cmd.get("client", "")}

    # evict stale actives (fenced) so their ranks become holes
    for rank, e in list(m["actives"].items()):
        if (
            e["name"] != name
            and now - m["beacons"].get(e["name"], 0) > grace
        ):
            _fence_mds(mon, e)
            del m["actives"][rank]
            m["table_acks"].pop(e["name"], None)
            m["epoch"] += 1

    my_rank = next(
        (
            int(r) for r, e in m["actives"].items()
            if e["name"] == name
        ),
        None,
    )
    if my_rank is not None:
        if m["actives"][str(my_rank)]["addr"] != addr:
            m["epoch"] += 1
        m["actives"][str(my_rank)] = entry
    elif entry["client"] and mon.osdmap.is_blocklisted(
        entry["client"]
    ):
        # a shrink/fail-evicted daemon still beaconing under its
        # FENCED identity must not become promotion-eligible:
        # parking it in standbys could re-promote it in this very
        # call (_mds_promote_holes below) while every rados op it
        # issues raises -EBLOCKLISTED — a wedged active that never
        # drains stray_ranks.  Keep it out; the standby reply makes
        # the daemon shed the identity (new_identity) and its next
        # beacon registers a fresh, unfenced standby.
        m["standbys"] = [
            s for s in m["standbys"] if s["name"] != name
        ]
    else:
        if all(s["name"] != name for s in m["standbys"]):
            m["standbys"].append(entry)
            m["epoch"] += 1
        else:
            m["standbys"] = [
                entry if s["name"] == name else s
                for s in m["standbys"]
            ]
    _mds_promote_holes(mon, m)
    _mds_table_maybe_stabilize(m)
    my_rank = next(
        (
            int(r) for r, e in m["actives"].items()
            if e["name"] == name
        ),
        None,
    )
    payload = {
        "state": "active" if my_rank is not None else "standby",
        "rank": -1 if my_rank is None else my_rank,
        "epoch": m["epoch"],
        "subtrees": m["subtrees"],
        "table_epoch": m["table_epoch"],
        "actives": {
            r: e["addr"] for r, e in m["actives"].items()
        },
    }
    if my_rank == 0 and m.get("stray_ranks"):
        # the shrink re-pin target: adopt these evicted ranks'
        # journals before serving their subtrees
        payload["adopt_ranks"] = sorted(m["stray_ranks"])
    return MMonCommandReply(rc=0, outb=json.dumps(payload))


def _cmd_mds_set_max(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'mds set-max-mds' (fs set max_mds): grow/shrink the active
    rank count; standbys promote into new ranks on their next
    beacons.  Shrinking evicts the highest ranks exactly like
    ``mds fail`` does: the evicted daemon's client id is FENCED (a
    partitioned-but-alive rank must not flush stale state later), its
    subtrees re-pin to 0, and its rank joins ``stray_ranks`` — the
    journal-adoption queue rank 0 drains (replaying the evicted
    rank's unflushed, client-acked mutations) before the re-pinned
    table stabilizes for clients.  The evicted daemon re-registers as
    a standby via its next beacon, shedding the fenced identity on
    the way (mds/server.py demotion path)."""
    m = _mdsmap_of(mon)
    n = int(cmd["max_mds"])
    if n < 1:
        return MMonCommandReply(rc=-22, outs="max_mds >= 1 (-EINVAL)")
    strays = m.setdefault("stray_ranks", [])
    # a grow does NOT drop queued strays: _mds_promote_holes holds
    # the re-grown rank back until its journal adoption drains, so a
    # fresh promotee never races the adopter's replay+trim
    m["max_mds"] = n
    for rank in [r for r in m["actives"] if int(r) >= n]:
        gone = m["actives"].pop(rank)
        _fence_mds(mon, gone)
        m["beacons"].pop(gone["name"], None)
        m["table_acks"].pop(gone["name"], None)
        # one queue entry per rank (promotion is blocked while
        # queued, so the same rank cannot be evicted twice into the
        # queue — the filter is belt-and-suspenders), tagged with a
        # fresh generation so only an ack for THIS eviction drains it
        gen = m["stray_gen"] = m.get("stray_gen", 0) + 1
        strays[:] = [e for e in strays if e[0] != int(rank)]
        strays.append([int(rank), gen])
    changed = False
    for p, r in list(m["subtrees"].items()):
        if r >= n:
            m["subtrees"][p] = 0
            changed = True
    if changed:
        m["table_epoch"] += 1
    _mds_promote_holes(mon, m)
    m["epoch"] += 1
    return MMonCommandReply(
        rc=0, outb=json.dumps({"epoch": m["epoch"]})
    )


def _cmd_mds_pin(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """'mds pin <path> <rank>' — subtree auth delegation (the
    ceph.dir.pin xattr / export_dir surface, src/mds/MDCache.cc
    subtree auth + src/mds/Migrator.cc export, reduced to a table
    flip with a flush barrier): ops under <path> route to <rank>.
    Clients switch only after every active acks the new table
    (see _mds_table_maybe_stabilize)."""
    m = _mdsmap_of(mon)
    path = "/" + "/".join(p for p in cmd["path"].split("/") if p)
    rank = int(cmd["rank"])
    if rank >= m["max_mds"] or rank < 0:
        return MMonCommandReply(
            rc=-22, outs=f"rank {rank} out of range (-EINVAL)"
        )
    if m["subtrees"].get(path) == rank:
        return MMonCommandReply(rc=0, outs="no change")
    m["subtrees"][path] = rank
    m["table_epoch"] += 1
    m["epoch"] += 1
    return MMonCommandReply(
        rc=0,
        outb=json.dumps(
            {"epoch": m["epoch"], "table_epoch": m["table_epoch"]}
        ),
    )


def _cmd_mds_stat(mon: Monitor, cmd: dict) -> MMonCommandReply:
    m = _mdsmap_of(mon)
    return MMonCommandReply(
        rc=0,
        outb=json.dumps(
            {
                "epoch": m["epoch"],
                # rank-0 compat alias for single-MDS callers
                "active": m["actives"].get("0"),
                "actives": m["actives"],
                "standbys": m["standbys"],
                "max_mds": m["max_mds"],
                # clients route by the STABLE table only
                "subtrees": m["subtrees_stable"],
                "table_epoch": m["table_epoch"],
            }
        ),
    )


def _cmd_mds_fail(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """Operator-forced failover: demote (and fence) an active — by
    name, rank, or rank 0 by default; the next standby beacon claims
    the hole."""
    m = _mdsmap_of(mon)
    who = str(cmd.get("who", "0"))
    rank = None
    for r, e in m["actives"].items():
        if r == who or e["name"] == who:
            rank = r
            break
    if rank is None:
        return MMonCommandReply(rc=-2, outs=f"no active {who!r} (-ENOENT)")
    gone = m["actives"].pop(rank)
    _fence_mds(mon, gone)
    m["beacons"].pop(gone["name"], None)
    m["table_acks"].pop(gone["name"], None)
    _mds_promote_holes(mon, m)
    m["epoch"] += 1
    return MMonCommandReply(
        rc=0, outs=f"failed mds {gone['name']}",
        outb=json.dumps({"epoch": m["epoch"]}),
    )


def _pool_by_name(mon: Monitor, name: str):
    for pid, pname in mon.osdmap.pool_names.items():
        if pname == name:
            return pid, mon.osdmap.pools[pid]
    return None, None


def _tier_commit(mon: Monitor, *pools) -> int:
    inc = mon.pending()
    for pid, newp in pools:
        newp.last_change = mon.osdmap.epoch + 1
        inc.new_pools[pid] = newp
    return mon.commit(inc)


def _cmd_osd_tier(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """Cache-tier pool wiring (OSDMonitor's "osd tier add /
    cache-mode / set-overlay / remove-overlay / remove" commands,
    src/mon/OSDMonitor.cc): a CACHE pool fronts a BASE pool; once the
    overlay is set, clients route the base pool's ops to the cache
    (Objecter's read_tier/write_tier redirection)."""
    import copy as _copy

    op = cmd["tierop"]
    bid, base = _pool_by_name(mon, cmd["pool"])
    if base is None:
        return MMonCommandReply(rc=-2, outs=f"no pool {cmd['pool']!r}")
    if op in ("add", "remove", "cache-mode", "set-overlay"):
        cid_, cache = _pool_by_name(mon, cmd["tierpool"])
        if cache is None:
            return MMonCommandReply(
                rc=-2, outs=f"no pool {cmd['tierpool']!r}"
            )
    if op == "add":
        if cache.type != PG_POOL_TYPE_REPLICATED:
            return MMonCommandReply(
                rc=-22, outs="cache tier must be replicated (-EINVAL)"
            )
        if base.type != PG_POOL_TYPE_REPLICATED:
            # deviation: the promote path pulls whole objects via the
            # replicated recovery machinery; an EC base would need
            # per-shard reconstruction on fetch (reject loudly rather
            # than silently -ENOENT every cold read)
            return MMonCommandReply(
                rc=-22,
                outs="tiering over an erasure base pool unsupported "
                "(-EINVAL)",
            )
        nc = _copy.deepcopy(cache)
        nc.tier_of = bid
        epoch = _tier_commit(mon, (cid_, nc))
    elif op == "cache-mode":
        mode = cmd.get("mode", "writeback")
        if mode not in ("writeback", "none"):
            return MMonCommandReply(rc=-22, outs=f"bad mode {mode!r}")
        if mode == "none" and any(
            p.read_tier == cid_ or p.write_tier == cid_
            for p in mon.osdmap.pools.values()
        ):
            # disabling tiering under a live overlay would strand
            # redirected writes in the cache pool (real Ceph: -EBUSY)
            return MMonCommandReply(
                rc=-16, outs="remove the overlay first (-EBUSY)"
            )
        nc = _copy.deepcopy(cache)
        nc.cache_mode = "" if mode == "none" else mode
        epoch = _tier_commit(mon, (cid_, nc))
    elif op == "set-overlay":
        if cache.tier_of != bid:
            return MMonCommandReply(
                rc=-22,
                outs=f"{cmd['tierpool']} is not a tier of {cmd['pool']}",
            )
        nb = _copy.deepcopy(base)
        nb.read_tier = cid_
        nb.write_tier = cid_
        epoch = _tier_commit(mon, (bid, nb))
    elif op == "remove-overlay":
        nb = _copy.deepcopy(base)
        nb.read_tier = -1
        nb.write_tier = -1
        epoch = _tier_commit(mon, (bid, nb))
    elif op == "remove":
        if base.read_tier == cid_:
            return MMonCommandReply(
                rc=-16, outs="remove the overlay first (-EBUSY)"
            )
        nc = _copy.deepcopy(cache)
        nc.tier_of = -1
        nc.cache_mode = ""
        epoch = _tier_commit(mon, (cid_, nc))
    else:
        return MMonCommandReply(rc=-22, outs=f"bad tierop {op!r}")
    return MMonCommandReply(
        rc=0, outb=json.dumps({"epoch": epoch})
    )


def _cmd_mgr_beacon(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """MgrMonitor beacon (src/mon/MgrMonitor.cc reduced): one active
    mgr whose address daemons discover to push MMgrReports."""
    m = getattr(mon, "mgrmap", None)
    if m is None:
        m = mon.mgrmap = {"epoch": 0, "active": None}
    entry = {"name": cmd["name"], "addr": cmd["addr"]}
    if m["active"] != entry:
        m["active"] = entry
        m["epoch"] += 1
    return MMonCommandReply(
        rc=0, outb=json.dumps({"epoch": m["epoch"]})
    )


def _cmd_mgr_stat(mon: Monitor, cmd: dict) -> MMonCommandReply:
    m = getattr(mon, "mgrmap", None) or {"epoch": 0, "active": None}
    return MMonCommandReply(rc=0, outb=json.dumps(m))


def _cmd_pool_set(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """osd pool set <pool> pg_num <n> (OSDMonitor::prepare_command
    pg_num path): increase-only; primaries split their PGs when they
    observe the new map (object re-homing by stable_mod)."""
    name = cmd["pool"]
    var = cmd.get("var", "")
    pool_id = None
    for pid, pname in mon.osdmap.pool_names.items():
        if pname == name:
            pool_id = pid
            break
    if pool_id is None:
        return MMonCommandReply(rc=-2, outs=f"no pool {name!r} (-ENOENT)")
    if var == "target_max_objects":
        import copy as _copy

        newp = _copy.deepcopy(mon.osdmap.pools[pool_id])
        newp.target_max_objects = int(cmd["val"])
        newp.last_change = mon.osdmap.epoch + 1
        inc = mon.pending()
        inc.new_pools[pool_id] = newp
        epoch = mon.commit(inc)
        return MMonCommandReply(
            rc=0, outb=json.dumps({"epoch": epoch})
        )
    if var != "pg_num":
        return MMonCommandReply(rc=-22, outs=f"cannot set {var!r} (-EINVAL)")
    val = int(cmd["val"])
    pool = mon.osdmap.pools[pool_id]
    if val < pool.pg_num:
        return MMonCommandReply(
            rc=-22, outs="pg_num cannot shrink (-EINVAL)"
        )
    if val == pool.pg_num:
        return MMonCommandReply(rc=0, outs="no change")
    if pool.snap_seq or getattr(pool, "snaps", None):
        # splitting migrates heads through the client op path; snap
        # clones have no such path and would strand in the parent
        return MMonCommandReply(
            rc=-95,
            outs="pg_num change on pools with snapshots unsupported "
            "(-EOPNOTSUPP)",
        )
    import copy as _copy

    newp = _copy.deepcopy(pool)
    newp.pg_num = val
    newp.pgp_num = val
    newp.last_change = mon.osdmap.epoch + 1
    inc = mon.pending()
    inc.new_pools[pool_id] = newp
    epoch = mon.commit(inc)
    return MMonCommandReply(
        rc=0,
        outs=f"set pool {name} pg_num to {val}",
        outb=json.dumps({"epoch": epoch}),
    )


def _cmd_sm_snap_create(mon: Monitor, cmd: dict) -> MMonCommandReply:
    """Self-managed snap allocation (OSDMonitor / pg_pool_t
    add_unmanaged_snap): the id is live for clone resolution and
    trimming (recorded with an empty name), but only writers whose
    snapc carries it clone — the pool's named-snap machinery stays
    untouched."""
    pid, pool = _pool_by_name(mon, cmd["pool"])
    if pool is None:
        return MMonCommandReply(rc=-2, outs=f"pool {cmd['pool']!r} not found")
    import copy as _copy

    newpool = _copy.deepcopy(pool)
    newpool.snap_seq += 1
    newpool.snaps[newpool.snap_seq] = ""
    inc = mon.pending()
    inc.new_pools[pid] = newpool
    epoch = mon.commit(inc)
    return MMonCommandReply(
        outb=json.dumps({"snapid": newpool.snap_seq, "epoch": epoch})
    )


def _cmd_sm_snap_rm(mon: Monitor, cmd: dict) -> MMonCommandReply:
    pid, pool = _pool_by_name(mon, cmd["pool"])
    if pool is None:
        return MMonCommandReply(rc=-2, outs=f"pool {cmd['pool']!r} not found")
    snapid = int(cmd["snapid"])
    if snapid not in pool.snaps or pool.snaps[snapid] != "":
        return MMonCommandReply(
            rc=-2, outs=f"no self-managed snap {snapid} (-ENOENT)"
        )
    import copy as _copy

    newpool = _copy.deepcopy(pool)
    del newpool.snaps[snapid]
    inc = mon.pending()
    inc.new_pools[pid] = newpool
    epoch = mon.commit(inc)
    return MMonCommandReply(outb=json.dumps({"epoch": epoch}))


_COMMANDS = {
    "status": _cmd_status,
    "osd down": _cmd_osd_down,
    "osd out": _cmd_osd_out,
    "osd in": _cmd_osd_in,
    "osd reweight": _cmd_osd_reweight,
    "osd blocklist": _cmd_osd_blocklist,
    "osd dump": _cmd_osd_dump,
    "osd pool create": _cmd_pool_create,
    "osd pool delete": _cmd_pool_delete,
    "osd pool mksnap": _cmd_pool_mksnap,
    "osd pool rmsnap": _cmd_pool_rmsnap,
    "osd pg-upmap-items": _cmd_pg_upmap_items,
    "osd erasure-code-profile set": _cmd_ec_profile_set,
    "osd erasure-code-profile get": _cmd_ec_profile_get,
    "osd erasure-code-profile ls": _cmd_ec_profile_ls,
    "osd tree": _cmd_osd_tree,
    "osd pool ls": _cmd_pool_ls,
    "pg dump": _cmd_pg_dump,
    "pgmap report": _cmd_pgmap_report,
    "df": _cmd_df,
    "health": _cmd_health,
    "health mute": _cmd_health_mute,
    "health unmute": _cmd_health_unmute,
    "crash report": _cmd_crash_report,
    "log last": _cmd_log_last,
    "log stat": _cmd_log_stat,
    "log": _cmd_log_inject,
    "osd slow ops": _cmd_osd_slow_ops,
    "osd scrub errors": _cmd_osd_scrub_errors,
    "osd stat report": _cmd_osd_stat_report,
    "osd df": _cmd_osd_df,
    "osd perf": _cmd_osd_perf,
    "slo report": _cmd_slo_report,
    "tell": _cmd_tell,
    "pg scrub": _cmd_pg_scrub,
    "pg deep-scrub": _cmd_pg_scrub,
    "pg repair": _cmd_pg_scrub,
    "config set": _cmd_config_set,
    "config get": _cmd_config_get,
    "config dump": _cmd_config_dump,
    "mds beacon": _cmd_mds_beacon,
    "mds stat": _cmd_mds_stat,
    "mds fail": _cmd_mds_fail,
    "mds set-max-mds": _cmd_mds_set_max,
    "mds pin": _cmd_mds_pin,
    "mgr beacon": _cmd_mgr_beacon,
    "mgr stat": _cmd_mgr_stat,
    "osd pool set": _cmd_pool_set,
    "osd tier": _cmd_osd_tier,
    "osd pool selfmanaged-snap create": _cmd_sm_snap_create,
    "osd pool selfmanaged-snap rm": _cmd_sm_snap_rm,
}


class MonClient(Dispatcher):
    """Daemon-side map follower (MonClient role): subscribe, apply
    pushed full/incremental maps, notify ``on_map(epoch)``."""

    def __init__(self, messenger: Messenger, on_map=None, whoami: int = -1):
        self.messenger = messenger
        self.whoami = whoami
        self.on_map = on_map
        self.osdmap: OSDMap | None = None
        self._conn: Connection | None = None
        self._addrs: list[tuple[str, int]] = []
        self._reconnect_lock = threading.Lock()
        self._lock = threading.Lock()
        self._epoch_event = threading.Condition(self._lock)
        messenger.add_dispatcher(self)

    # -- session -----------------------------------------------------------
    def connect(self, host: str, port: int) -> None:
        if (host, int(port)) not in self._addrs:
            self._addrs.append((host, int(port)))
        self._conn = self.messenger.connect(host, int(port))
        reply = self._conn.call(
            MMonSubscribe(start_epoch=0, from_osd=self.whoami)
        )
        assert isinstance(reply, MOSDMap)
        self._apply(reply)

    def connect_any(self, addrs) -> None:
        """Session to the first reachable monitor of a quorum
        (MonClient::get_monmap_and_config's mon-list behavior)."""
        self._addrs = [(h, int(p)) for h, p in addrs]
        self.ensure_connected()

    def ensure_connected(self) -> None:
        """(Re)establish the mon session, cycling the known monitor
        addresses — the client half of monitor failover."""
        if self._conn is not None and not self._conn.is_closed:
            return
        with self._reconnect_lock:
            if self._conn is not None and not self._conn.is_closed:
                return
            last: Exception | None = None
            for host, port in self._addrs:
                try:
                    conn = self.messenger.connect(host, port)
                    reply = conn.call(
                        MMonSubscribe(
                            start_epoch=0, from_osd=self.whoami
                        )
                    )
                    assert isinstance(reply, MOSDMap)
                    self._conn = conn
                    self._apply(reply)
                    return
                except (MessageError, OSError, AssertionError) as e:
                    last = e
            raise MessageError(f"no monitor reachable: {last}")

    def ms_handle_reset(self, conn: Connection) -> None:
        """Session mon died: re-subscribe elsewhere EAGERLY — a
        client that only watches the map would otherwise go stale
        until its next command (MonClient::_reopen_session)."""
        if conn is not self._conn or not self._addrs:
            return
        if sys.is_finalizing():
            # interpreter teardown: connection resets fire as the GC
            # finalizes the messenger loop, and Thread.start() HANGS
            # during finalization (the new thread never bootstraps) —
            # a short-lived CLI would wedge on exit instead of exiting
            return
        threading.Thread(
            target=self._reconnect_bg,
            name="monc.reconnect",
            daemon=True,
        ).start()

    def _reconnect_bg(self) -> None:
        for _ in range(100):
            try:
                self.ensure_connected()
                return
            except (MessageError, OSError):
                time.sleep(0.2)

    def command(
        self, cmd: dict, timeout: float = 15.0
    ) -> MMonCommandReply:
        """Mon command with failover: retries across monitors on
        connection loss and waits out elections (-EAGAIN replies), the
        MonClient::start_mon_command resend behavior."""
        deadline = time.monotonic() + timeout
        payload = json.dumps(cmd)
        last_err: Exception | None = None
        while True:
            try:
                self.ensure_connected()
                # bound the in-flight call by the caller's deadline
                # too: a mon that accepts TCP but never replies must
                # not hold a timeout=2.0 caller for the default 30s
                reply = self._conn.call(
                    MMonCommand(cmd=payload),
                    timeout=max(
                        0.5, min(30.0, deadline - time.monotonic())
                    ),
                )
                assert isinstance(reply, MMonCommandReply)
                if reply.rc == -11 and "-EAGAIN" in reply.outs:
                    # electing: wait and resend
                    if time.monotonic() >= deadline:
                        return reply
                    time.sleep(0.2)
                    continue
                return reply
            except (MessageError, OSError, AssertionError) as e:
                last_err = e
                if self._conn is not None:
                    self._conn.close()
                if time.monotonic() >= deadline:
                    raise MessageError(
                        f"mon command failed: {last_err}"
                    ) from last_err
                time.sleep(0.2)

    def report_failure(self, target: int, failed_for: float) -> None:
        self.ensure_connected()
        self._conn.send(
            MOSDFailure(
                target=target,
                reporter=self.whoami,
                failed_for=failed_for,
                epoch=self.epoch,
            )
        )

    def send_log(self, entries: list[dict], name: str = "") -> None:
        """Ship a drained LogClient batch to the mon (MLog); raises
        MessageError/OSError on failure so the caller can requeue."""
        if not entries:
            return
        self.ensure_connected()
        self._conn.send(
            MLog(
                tid=self.messenger.new_tid(),
                name=name or (entries[0].get("name", "") if entries else ""),
                entries=json.dumps(entries),
            )
        )

    def boot(self, osd: int, addr: str = "") -> None:
        self.ensure_connected()
        self._conn.send(MOSDBoot(osd=osd, addr=addr))

    @property
    def epoch(self) -> int:
        with self._lock:
            return self.osdmap.epoch if self.osdmap else 0

    def wait_for_epoch(self, epoch: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._epoch_event:
            while self.osdmap is None or self.osdmap.epoch < epoch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._epoch_event.wait(remaining)
            return True

    # -- map application ---------------------------------------------------
    def _apply(self, msg: MOSDMap) -> None:
        resubscribe = False
        with self._epoch_event:
            if msg.full:
                self.osdmap = OSDMap.decode(msg.full)
            for blob in msg.incrementals:
                inc = Incremental.decode(blob)
                if self.osdmap is None or inc.epoch > self.osdmap.epoch + 1:
                    resubscribe = True  # gap: need a fresh full map
                    break
                if inc.epoch <= self.osdmap.epoch:
                    continue  # dup push (already ahead)
                self.osdmap.apply_incremental(inc)
            self._epoch_event.notify_all()
        if resubscribe and self._conn is not None:
            # fire-and-forget: the reply dispatches as another MOSDMap
            # (we are on the read-loop thread here; call() would block it)
            self._conn.send(
                MMonSubscribe(
                    tid=self.messenger.new_tid(),
                    start_epoch=0,
                    from_osd=self.whoami,
                )
            )
            return
        if self.on_map is not None and self.osdmap is not None:
            self.on_map(self.osdmap.epoch)

    def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MOSDMap):
            self._apply(msg)
            return True
        return False
