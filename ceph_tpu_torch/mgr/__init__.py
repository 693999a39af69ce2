"""Manager daemon — the module host
(src/mgr/Mgr.cc + src/pybind/mgr/mgr_module.py).

The reference mgr embeds CPython to run python modules against
cluster state it mirrors from the monitors.  Here the host IS python:
``Manager`` keeps a live OSDMap via a MonClient subscription, hosts
``MgrModule`` subclasses on a shared tick, and gives them the
mgr_module surface that matters:

- ``self.get("osd_map") / get("pg_summary") / get("df")`` — cluster
  state snapshots
- ``self.mon_command(cmd)`` — the command path back to the quorum
- per-module config via ``set_module_option``

Built-in modules (the pybind/mgr counterparts):

- ``balancer`` — runs the upmap balancer library
  (ceph_tpu_torch/osd/balancer.py calc_pg_upmaps) on a COPY of the map and
  commits the new pg_upmap_items through "osd pg-upmap-items", the
  reference balancer module's active mode.
- ``prometheus`` — an HTTP /metrics endpoint in the Prometheus text
  exposition format (ceph_osd_up, ceph_osd_in, ceph_pool_*,
  ceph_pg_total ...), the src/pybind/mgr/prometheus role.
- ``status`` — health/df rollups for the CLI surface.
- ``tracing`` — cross-daemon span assembly: drains span batches
  piggybacked on MMgrReport and serves one logical op's spans from
  client + primary + replicas as a single tree (the collection half
  of the blkin/ZTracer role).

``Manager(device=...)`` (default ``cuda``) is where the balancer maps
its plans' PG tables (``calc_pg_upmaps(device=)``), as ``OSD(device)``
is where a daemon computes.
"""

from __future__ import annotations

import copy
import http.server
import json
import re
import threading
import time
from collections import OrderedDict, deque

from ..common import crash as crash_util
from ..common import tracing
from ..common.log_client import LogClient
from ..mon.monitor import MonClient
from ..msg import Messenger
from ..msg.message import (
    MMgrReport,
    MMonCommand,
    MMonCommandReply,
    MPGStats,
)
from ..msg.messenger import Dispatcher

__all__ = ["Manager", "MgrModule"]


def histogram_exposition_lines(
    name: str, help_: str, series: list
) -> list[str]:
    """Render ONE prometheus-native histogram family: a single
    HELP/TYPE header, then per-labelset cumulative ``_bucket`` rows
    (monotone, closing with the mandatory ``le="+Inf"``) plus the
    ``_sum``/``_count`` pair.  ``series`` is [(labels dict, histogram
    snapshot)].  Module-level so tools/check_metrics.py lints the
    exact text the exporter serves."""
    from ..common.histogram import cumulative_buckets, snapshot_counts

    name = PrometheusModule.sanitize_name(name)
    out = [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]

    def lbl(labels: dict) -> str:
        return ",".join(
            f"{PrometheusModule.sanitize_name(k)}="
            f'"{PrometheusModule.escape_label(v)}"'
            for k, v in labels.items()
        )

    for labels, snap in series:
        base = lbl(labels)
        for le, cum in cumulative_buckets(snap):
            sep = "," if base else ""
            out.append(
                f'{name}_bucket{{{base}{sep}le="{le}"}} {cum}'
            )
        total = sum(snapshot_counts(snap))
        braces = f"{{{base}}}" if base else ""
        out.append(f"{name}_sum{braces} {float(snap.get('sum', 0.0))}")
        out.append(f"{name}_count{braces} {total}")
    return out


class MgrModule:
    """Base class for manager modules (mgr_module.MgrModule)."""

    NAME = "module"
    TICK_EVERY = 1.0  # seconds between serve() calls

    def __init__(self, mgr: "Manager"):
        self.mgr = mgr
        self._last_tick = 0.0

    # -- the mgr_module surface -------------------------------------------
    def get(self, what: str):
        return self.mgr.get(what)

    def mon_command(self, cmd: dict, timeout: float = 15.0):
        return self.mgr.monc.command(cmd, timeout=timeout)

    def get_module_option(self, key: str, default=None):
        return self.mgr.module_options.get(self.NAME, {}).get(
            key, default
        )

    def serve(self) -> None:  # pragma: no cover — interface hook
        """Called on the host tick, at most every TICK_EVERY s."""

    def shutdown(self) -> None:
        pass


class Manager(Dispatcher):
    """The mgr daemon: mon session + module host (Mgr.cc) + the
    daemon-stats plane (DaemonServer.cc role): daemons discover the
    mgr through the monitor ("mgr beacon"/"mgr stat") and push
    MMgrReport perf dumps to its messenger; modules and the
    prometheus exporter read them via get("daemon_perf")."""

    def __init__(
        self,
        modules: list[type[MgrModule]] | None = None,
        name: str = "x",
        shared_services: bool | None = None,
        device: str = "cuda",
    ):
        self.name = name
        self.device = device
        # shared-services: the tick loop rides a shared-stack timer
        # and mgr commands drain through a serial strand instead of a
        # thread per command — zero dedicated mgr threads (as the OSD
        # does with shared services)
        self.shared_services = bool(shared_services)
        self._tick_handle = None
        self._cmd_strand = None
        self._last_beacon = 0.0
        self.messenger = Messenger("mgr")
        self.monc = MonClient(self.messenger, whoami=-2)
        self.module_options: dict[str, dict] = {}
        self._module_types = list(
            modules
            if modules is not None
            else [
                BalancerModule,
                PrometheusModule,
                StatusModule,
                PgAutoscalerModule,
                TelemetryModule,
                DashboardModule,
                TracingModule,
                CrashModule,
                SLOModule,
                PgMapModule,
                ProgressModule,
            ]
        )
        self.modules: dict[str, MgrModule] = {}
        self._ticker: threading.Thread | None = None
        self._stop = threading.Event()
        # DaemonServer role: inbound perf reports, daemon -> (ts, dump)
        self.daemon_perf: dict[str, tuple[float, dict]] = {}
        self._perf_lock = threading.Lock()
        # span inbox: (daemon, span dicts) batches from MMgrReport,
        # drained by the tracing module's tick; bounded so a span
        # firehose with no tracing module cannot grow without limit
        self._span_inbox: deque[tuple[str, list]] = deque(maxlen=4096)
        # crash inbox: reports piggybacked on MMgrReport, drained by
        # the crash module's tick (bounded the same way)
        self._crash_inbox: deque[dict] = deque(maxlen=256)
        # PG-stats plane (MPGStats ingestion): osd id -> (ts, epoch,
        # [pg stat dicts]); the pgmap module folds the freshest
        # primary reports into the digest
        self.pg_stats: dict[int, tuple[float, int, list]] = {}
        self._pg_stats_lock = threading.Lock()
        # progress events piggybacked on MPGStats (scrub/repair),
        # drained by the progress module's tick
        self._progress_inbox: deque[dict] = deque(maxlen=512)
        # the mgr's own cluster-log channel (flushed on the tick)
        self._log_client = LogClient(f"mgr.{name}")
        self.clog = self._log_client.channel()
        self.messenger.add_dispatcher(self)
        self.addr: str | None = None

    # -- MMgrReport ingestion (DaemonServer::handle_report) ----------------
    def ms_dispatch(self, conn, msg) -> bool:
        if isinstance(msg, MMonCommand):
            # mgr-targeted commands (`ceph crash ...`): the reference
            # CLI routes MgrCommands to the active mgr the same way.
            # Handled OFF the messenger loop — a handler that talks
            # back to the mon (crash archive → "crash report") would
            # deadlock the loop thread on its own blocking call
            def run(msg=msg, conn=conn):
                reply = self.handle_command(msg.cmd)
                reply.tid = msg.tid
                try:
                    conn.send(reply)
                except Exception:  # noqa: BLE001 — caller gone
                    pass

            strand = self._cmd_strand
            if strand is not None:
                strand.submit(run)
            else:
                threading.Thread(
                    target=run, name="mgr.command", daemon=True
                ).start()
            return True
        if isinstance(msg, MPGStats):
            try:
                stats = json.loads(msg.stats)
                events = json.loads(msg.events)
            except ValueError:
                return True
            if isinstance(stats, list):
                with self._pg_stats_lock:
                    self.pg_stats[msg.osd] = (
                        time.time(),
                        msg.epoch,
                        [s for s in stats if isinstance(s, dict)],
                    )
            if isinstance(events, list):
                self._progress_inbox.extend(
                    e for e in events if isinstance(e, dict)
                )
            return True
        if not isinstance(msg, MMgrReport):
            return False
        try:
            spans = json.loads(msg.spans)
        except ValueError:
            spans = []
        if spans:
            self._span_inbox.append((msg.daemon, spans))
        try:
            crashes = json.loads(msg.crashes)
        except ValueError:
            crashes = []
        if isinstance(crashes, list):
            self._crash_inbox.extend(
                c for c in crashes if isinstance(c, dict)
            )
        try:
            dump = json.loads(msg.perf)
        except ValueError:
            return True
        if dump:
            with self._perf_lock:
                self.daemon_perf[msg.daemon] = (time.time(), dump)
        return True

    # -- mgr command surface (MgrCommands dispatch) ------------------------
    def handle_command(self, cmd_json: str) -> MMonCommandReply:
        """Route a command to the owning module (prefix word 1 names
        it: "crash ls" → modules["crash"]); always reply."""
        try:
            cmd = json.loads(cmd_json)
            prefix = cmd.get("prefix", "")
            mod = self.modules.get(prefix.split(" ")[0])
            handler = getattr(mod, "handle_command", None)
            if handler is None:
                return MMonCommandReply(
                    rc=-22, outs=f"unknown mgr command {prefix!r}"
                )
            return handler(cmd)
        except Exception as e:  # noqa: BLE001 — the RPC contract
            return MMonCommandReply(
                rc=-22, outs=f"{type(e).__name__}: {e}"
            )

    def ms_handle_reset(self, conn) -> None:
        pass

    def set_module_option(self, module: str, key: str, value) -> None:
        self.module_options.setdefault(module, {})[key] = value

    def start(self, mon_addrs) -> None:
        if isinstance(mon_addrs, tuple):
            mon_addrs = [mon_addrs]
        host, port = self.messenger.bind()
        self.addr = f"{host}:{port}"
        self.monc.connect_any(mon_addrs)
        self._beacon()
        for mtype in self._module_types:
            mod = mtype(self)
            self.modules[mod.NAME] = mod
        if self.shared_services:
            stack = self.messenger._stack
            self._cmd_strand = stack.offload.strand()
            self._tick_handle = stack.timers.every(
                0.2, self._tick_once
            )
        else:
            self._ticker = threading.Thread(
                target=self._tick_loop, name="mgr.tick", daemon=True
            )
            self._ticker.start()

    def _beacon(self) -> None:
        try:
            self.monc.command(
                {
                    "prefix": "mgr beacon",
                    "name": self.name,
                    "addr": self.addr,
                }
            )
        except Exception:  # noqa: BLE001 — beacons retry on the tick
            pass

    def shutdown(self) -> None:
        self._stop.set()
        if self._tick_handle is not None:
            self._tick_handle.cancel()
        if self._ticker is not None:
            self._ticker.join(timeout=5)
        for mod in self.modules.values():
            try:
                mod.shutdown()
            except Exception:  # noqa: BLE001
                pass
        self.messenger.shutdown()

    def _tick_loop(self) -> None:
        while not self._stop.wait(0.2):
            self._tick_once()

    def _tick_once(self) -> None:
        if self._stop.is_set():
            return
        now = time.monotonic()
        if now - self._last_beacon > 2.0:
            self._last_beacon = now
            self._beacon()
        for mod in self.modules.values():
            if now - mod._last_tick < mod.TICK_EVERY:
                continue
            mod._last_tick = now
            try:
                mod.serve()
            except Exception as e:  # noqa: BLE001 — a module must
                # not kill the host (mgr module crash containment);
                # the contained crash still files a report
                import traceback

                traceback.print_exc()
                crash_util.capture(
                    f"mgr.{self.name}",
                    e,
                    clog=self.clog,
                    extra_meta={"module": mod.NAME},
                )
        self._log_client.flush(self.monc)

    # -- cluster state snapshots (MgrModule.get) ---------------------------
    def get(self, what: str):
        m = self.monc.osdmap
        if m is None:
            return None
        if what == "osd_map":
            return m
        if what == "osd_stats":
            return {
                "epoch": m.epoch,
                "num_osds": m.max_osd,
                "num_up": sum(
                    1 for o in range(m.max_osd) if m.is_up(o)
                ),
                "num_in": sum(
                    1
                    for o in range(m.max_osd)
                    if m.exists(o) and m.osd_weight[o] > 0
                ),
            }
        if what == "pg_summary":
            total = sum(p.pg_num for p in m.pools.values())
            return {
                "num_pools": len(m.pools),
                "num_pgs": total,
                "by_pool": {
                    pid: p.pg_num for pid, p in m.pools.items()
                },
            }
        if what == "daemon_perf":
            cutoff = time.time() - 30.0
            with self._perf_lock:
                for d in [
                    d
                    for d, (ts, _dump) in self.daemon_perf.items()
                    if ts < cutoff
                ]:
                    del self.daemon_perf[d]  # dead daemon: stop
                    # exporting a frozen, live-looking series
                return {
                    d: dump for d, (_ts, dump) in self.daemon_perf.items()
                }
        if what == "pg_stats":
            # merged primary view: pgid -> freshest stat dict across
            # reporting OSDs (freshest by (reported_epoch, recv ts));
            # silence past the grace drops an OSD's contribution, so
            # a dead primary's stale rows age out like daemon_perf
            cutoff = time.time() - 30.0
            merged: dict[str, tuple[tuple, dict]] = {}
            with self._pg_stats_lock:
                for osd in [
                    o for o, (ts, _e, _s) in self.pg_stats.items()
                    if ts < cutoff
                ]:
                    del self.pg_stats[osd]
                for _osd, (ts, _epoch, stats) in self.pg_stats.items():
                    for st in stats:
                        pgid = st.get("pgid")
                        if not isinstance(pgid, str):
                            continue
                        rank = (st.get("reported_epoch", 0), ts)
                        cur = merged.get(pgid)
                        if cur is None or rank > cur[0]:
                            merged[pgid] = (rank, st)
            return {pgid: st for pgid, (_r, st) in merged.items()}
        if what == "df":
            return {
                "pools": [
                    {
                        "name": m.pool_names.get(pid, str(pid)),
                        "id": pid,
                        "type": p.type,
                        "size": p.size,
                        "pg_num": p.pg_num,
                    }
                    for pid, p in m.pools.items()
                ],
            }
        raise KeyError(f"unknown mgr state {what!r}")


class StatusModule(MgrModule):
    """Health rollup (the mgr status/health surface).  The tick polls
    the mon's authoritative rollup (`health`, with mute-aware
    checks_detail) and the cluster-log counters (`log stat`) so the
    prometheus exporter and dashboard serve them without a mon
    round-trip per scrape."""

    NAME = "status"
    TICK_EVERY = 2.0  # two mon round-trips per tick: keep it off the
    # hot path (scrapes read the cache)

    def __init__(self, mgr: "Manager"):
        super().__init__(mgr)
        self.last_health: dict = {}
        self.last_log_stat: dict = {}

    def serve(self) -> None:
        # SHORT timeout: these are cache refreshes on the shared mgr
        # tick thread — during a mon outage the default 15s failover
        # retry would stall every other module's tick
        try:
            reply = self.mon_command({"prefix": "health"}, timeout=2.0)
            if reply.rc == 0 and reply.outb:
                self.last_health = json.loads(reply.outb)
            reply = self.mon_command(
                {"prefix": "log stat"}, timeout=2.0
            )
            if reply.rc == 0 and reply.outb:
                self.last_log_stat = json.loads(reply.outb)
        except Exception:  # noqa: BLE001 — mon away: keep last known
            pass

    def health(self) -> dict:
        stats = self.get("osd_stats")
        if stats is None:
            return {"status": "HEALTH_WARN", "checks": ["no map"]}
        if self.last_health:
            return {**self.last_health, **stats}
        # no mon rollup yet: degrade to the local map view
        checks = []
        if stats["num_up"] < stats["num_in"]:
            checks.append(
                f"{stats['num_in'] - stats['num_up']} osds down"
            )
        return {
            "status": "HEALTH_OK" if not checks else "HEALTH_WARN",
            "checks": checks,
            **stats,
        }


class BalancerModule(MgrModule):
    """Active upmap balancing (src/pybind/mgr/balancer, mode=upmap):
    plan on a map copy, commit the delta via pg-upmap-items.
    ``ceph balancer on|off|status`` (routed to the active mgr) turns it
    on and off and reads the plans applied, each with the epoch of the
    map it was planned on."""

    NAME = "balancer"
    TICK_EVERY = 1.0

    def __init__(self, mgr: "Manager"):
        super().__init__(mgr)
        self.last_plan: dict = {}
        self.plans_applied = 0
        self.plans: deque[dict] = deque(maxlen=16)

    def handle_command(self, cmd: dict) -> MMonCommandReply:
        prefix = cmd.get("prefix", "")
        if prefix in ("balancer on", "balancer off"):
            self.mgr.set_module_option(
                self.NAME, "active", prefix == "balancer on"
            )
            return MMonCommandReply(outs=prefix.replace(" ", " is "))
        if prefix == "balancer status":
            return MMonCommandReply(outb=json.dumps({
                "active": bool(self.get_module_option("active", False)),
                "plans_applied": self.plans_applied,
                "plans": list(self.plans),
            }))
        return MMonCommandReply(
            rc=-22, outs=f"unknown balancer command {prefix!r}"
        )

    def serve(self) -> None:
        if not self.get_module_option("active", False):
            return
        m = self.get("osd_map")
        if m is None:
            return
        from ..osd.balancer import calc_pg_upmaps

        plan_map = copy.deepcopy(m)
        changed = calc_pg_upmaps(
            plan_map,
            max_deviation=int(
                self.get_module_option("upmap_max_deviation", 1)
            ),
            max_changes=int(
                self.get_module_option("max_optimizations", 10)
            ),
            device=self.mgr.device,
        )
        if not changed:
            return
        delta = {
            pg: items
            for pg, items in plan_map.pg_upmap_items.items()
            if m.pg_upmap_items.get(pg) != items
        }
        self.last_plan = {
            f"{pid}.{ps}": items for (pid, ps), items in delta.items()
        }
        self.plans.append({
            "epoch": m.epoch,
            "plan": {k: [list(i) for i in v] for k, v in self.last_plan.items()},
        })
        for (pid, ps), items in delta.items():
            reply = self.mon_command(
                {
                    "prefix": "osd pg-upmap-items",
                    "pgid": f"{pid}.{ps}",
                    "mappings": [list(i) for i in items],
                }
            )
            if reply.rc == 0:
                self.plans_applied += 1


class PrometheusModule(MgrModule):
    """/metrics exporter in the Prometheus text format
    (src/pybind/mgr/prometheus)."""

    NAME = "prometheus"

    def __init__(self, mgr: "Manager"):
        super().__init__(mgr)
        self.port = int(self.get_module_option("port", 0))
        module = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = module.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self.server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", self.port), Handler
        )
        self.port = self.server.server_address[1]
        threading.Thread(
            target=self.server.serve_forever,
            name="mgr.prometheus",
            daemon=True,
        ).start()

    def shutdown(self) -> None:
        self.server.shutdown()

    # exposition-format hygiene (the prometheus module's
    # promethize()): metric names allow [a-zA-Z0-9_:], label values
    # need \ and " escaped
    _BAD_NAME = re.compile(r"[^a-zA-Z0-9_:]")

    @classmethod
    def sanitize_name(cls, name: str) -> str:
        name = cls._BAD_NAME.sub("_", name)
        if name and name[0].isdigit():
            name = "_" + name
        return name

    @staticmethod
    def escape_label(value: str) -> str:
        return (
            str(value)
            .replace("\\", r"\\")
            .replace('"', r"\"")
            .replace("\n", r"\n")
        )

    def render(self) -> str:
        out = []
        # one HELP/TYPE header per metric FAMILY: prometheus parsers
        # reject (or silently mis-type) a family whose header arrived
        # under a different family's name
        headered: set[str] = set()

        def metric(name, value, help_=None, labels=None, kind="gauge"):
            name = self.sanitize_name(name)
            if help_ and name not in headered:
                headered.add(name)
                out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} {kind}")
            lbl = ""
            if labels:
                inner = ",".join(
                    f'{self.sanitize_name(k)}="{self.escape_label(v)}"'
                    for k, v in labels.items()
                )
                lbl = "{" + inner + "}"
            out.append(f"{name}{lbl} {value}")

        stats = self.get("osd_stats")
        if stats is None:
            return "# mgr has no map yet\n"
        metric(
            "ceph_osdmap_epoch", stats["epoch"], "OSDMap epoch"
        )
        metric("ceph_num_osds", stats["num_osds"], "total osds")
        metric("ceph_num_up_osds", stats["num_up"], "up osds")
        metric("ceph_num_in_osds", stats["num_in"], "in osds")
        m = self.get("osd_map")
        for o in range(m.max_osd):
            metric(
                "ceph_osd_up",
                1 if m.is_up(o) else 0,
                "per-osd up state",
                labels={"ceph_daemon": f"osd.{o}"},
            )
        pg = self.get("pg_summary")
        metric("ceph_pg_total", pg["num_pgs"], "total pgs")
        # per-daemon series from MMgrReport perf dumps (the
        # DaemonServer -> exporter plane): plain counters become
        # gauges, avgcount/sum pairs become _count/_sum pairs —
        # every family gets ITS OWN header, once
        for daemon, dump in sorted(
            (self.get("daemon_perf") or {}).items()
        ):
            for cname, val in sorted(dump.items()):
                base = "ceph_daemon_" + cname.replace(".", "_")
                labels = {"ceph_daemon": daemon}
                help_ = f"per-daemon perf counter {cname}"
                if isinstance(val, dict) and "avgcount" in val:
                    metric(
                        base + "_count", val["avgcount"],
                        help_, labels=labels,
                    )
                    metric(
                        base + "_sum", val["sum"],
                        help_, labels=labels,
                    )
                elif isinstance(val, (int, float)):
                    metric(base, val, help_, labels=labels)
        # scrub plane (the data-integrity families): errors/progress/
        # last-scrubbed age per daemon, lifted out of the generic
        # per-daemon dump under their own stable names
        scrub_families = (
            ("scrub_errors", "ceph_osd_scrub_errors",
             "open scrub inconsistencies per osd", "gauge"),
            ("scrubs_active", "ceph_osd_scrubs_active",
             "scrubs in flight per osd", "gauge"),
            ("scrub_chunks", "ceph_osd_scrub_chunks_total",
             "scrub chunks processed (progress)", "counter"),
            ("scrub_last_age", "ceph_osd_scrub_last_age_seconds",
             "seconds since the stalest primary pg was scrubbed",
             "gauge"),
        )
        for daemon, dump in sorted(
            (self.get("daemon_perf") or {}).items()
        ):
            for key, fam, help_, kind in scrub_families:
                if key in dump and isinstance(
                    dump[key], (int, float)
                ):
                    metric(
                        fam, dump[key], help_,
                        labels={"ceph_daemon": daemon}, kind=kind,
                    )
        # latency histograms → NATIVE prometheus histogram families
        # (cumulative le buckets ending +Inf, _sum/_count): the
        # op_hist.<qos>.<type> entries become one labeled family,
        # everything else histogram-shaped gets its own
        from ..common.histogram import is_histogram_snapshot

        hist_families: dict[str, dict] = {}
        for daemon, dump in sorted(
            (self.get("daemon_perf") or {}).items()
        ):
            for cname, val in sorted(dump.items()):
                if not is_histogram_snapshot(val):
                    continue
                if cname.startswith("op_hist."):
                    parts = cname.split(".")
                    fam = "ceph_osd_op_latency_seconds"
                    help_ = (
                        "op completion latency by qos class and "
                        "op type (log2 buckets)"
                    )
                    labels = {
                        "ceph_daemon": daemon,
                        "qos_class": parts[1] if len(parts) > 1 else "",
                        "op_type": parts[2] if len(parts) > 2 else "",
                    }
                else:
                    fam = (
                        "ceph_daemon_"
                        + cname.replace(".", "_")
                        + "_seconds"
                    )
                    help_ = f"per-daemon latency histogram {cname}"
                    labels = {"ceph_daemon": daemon}
                hist_families.setdefault(
                    fam, {"help": help_, "series": []}
                )["series"].append((labels, val))
        for fam, ent in sorted(hist_families.items()):
            if fam in headered:
                continue
            headered.add(fam)
            out.extend(
                histogram_exposition_lines(
                    fam, ent["help"], ent["series"]
                )
            )
        # SLO plane rollups: burn rates + windowed percentiles per
        # class from the slo module's last evaluation
        slo_mod = self.mgr.modules.get("slo")
        status = getattr(slo_mod, "last_status", None) or {}
        for tgt in status.get("targets", []):
            for window in ("fast", "slow"):
                metric(
                    "ceph_slo_burn_rate",
                    tgt.get(f"{window}_burn", 0.0),
                    "error-budget burn rate per slo target and window",
                    labels={
                        "qos_class": tgt.get("qos_class", ""),
                        "percentile": f"{tgt.get('percentile', 0):g}",
                        "window": window,
                    },
                )
        for klass, row in sorted(
            (status.get("classes") or {}).items()
        ):
            for q in (50, 95, 99):
                metric(
                    "ceph_slo_latency_ms",
                    row.get(f"p{q}_ms", 0.0),
                    "windowed latency percentile per qos class",
                    labels={
                        "qos_class": klass, "quantile": f"0.{q}"
                    },
                )
        for entry in self.get("df")["pools"]:
            metric(
                "ceph_pool_pg_num",
                entry["pg_num"],
                "per-pool pg count",
                labels={"pool": entry["name"]},
            )
        # -- event plane: health detail, crash reports, cluster log --------
        status_mod = self.mgr.modules.get("status")
        health = getattr(status_mod, "last_health", None) or {}
        sev = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}
        metric(
            "ceph_health_status",
            sev.get(health.get("status"), 0),
            "cluster health (0=OK 1=WARN 2=ERR), mutes applied",
        )
        for code, det in sorted(
            (health.get("checks_detail") or {}).items()
        ):
            metric(
                "ceph_health_detail",
                1,
                "active health checks incl. muted ones",
                labels={
                    "name": code,
                    "severity": det.get("severity", "HEALTH_WARN"),
                    "muted": "true" if det.get("muted") else "false",
                },
            )
        crash_mod = self.mgr.modules.get("crash")
        if crash_mod is not None:
            metric(
                "ceph_crash_reports_total",
                crash_mod.total_ingested,
                "crash reports ingested by the mgr crash module",
                kind="counter",  # *_total + monotonic: OpenMetrics
                # parsers reject a gauge under this name
            )
            metric(
                "ceph_crash_reports_recent",
                len(crash_mod.recent()),
                "un-archived recent crashes (the RECENT_CRASH count)",
            )
        log_stat = getattr(status_mod, "last_log_stat", None) or {}
        for key, count in sorted(
            (log_stat.get("by_channel_prio") or {}).items()
        ):
            channel, _, prio = key.partition("/")
            metric(
                "ceph_cluster_log_messages_total",
                count,
                "cluster log entries by channel and priority",
                labels={"channel": channel, "prio": prio},
                kind="counter",
            )
        # -- PG-stats plane: pgmap digest families + progress events -------
        from .pgmap import pgmap_exposition_lines

        pgmap_mod = self.mgr.modules.get("pgmap")
        digest = getattr(pgmap_mod, "digest", None)
        if digest:
            out.extend(pgmap_exposition_lines(digest))
        progress_mod = self.mgr.modules.get("progress")
        if progress_mod is not None:
            events = progress_mod.active_events()
            metric(
                "ceph_progress_events",
                sum(1 for e in events if not e["done"]),
                "open (not yet completed) mgr progress events",
            )
        return "\n".join(out) + "\n"


class TelemetryModule(MgrModule):
    """Cluster telemetry report (src/pybind/mgr/telemetry reduced):
    the same anonymized "basic channel" shape — cluster geometry,
    pool shapes, daemon versions/perf rollups — generated on tick
    and kept as the last report.  Deviation: nothing phones home;
    the report is served locally (module.report() / the dashboard)."""

    NAME = "telemetry"
    TICK_EVERY = 5.0

    def __init__(self, mgr: "Manager"):
        super().__init__(mgr)
        self.last_report: dict = {}
        self.reports_generated = 0

    def report(self) -> dict:
        from ..version import FRAMEWORK_VERSION

        stats = self.get("osd_stats") or {}
        pg = self.get("pg_summary") or {}
        df = self.get("df") or {"pools": []}
        perf = self.get("daemon_perf") or {}
        rep = {
            "report_version": 1,
            "version": FRAMEWORK_VERSION,
            "created": time.time(),
            "cluster": stats,
            "pg": pg,
            "pools": [
                # anonymized shape, not names (telemetry's
                # basic-channel redaction)
                {"id": p["id"], "type": p["type"],
                 "size": p["size"], "pg_num": p["pg_num"]}
                for p in df["pools"]
            ],
            "daemons": {
                "count": len(perf),
                "kinds": sorted(
                    {d.split(".")[0] for d in perf}
                ),
                "total_client_ops": sum(
                    (dump.get("op") or {}).get("value", 0)
                    if isinstance(dump.get("op"), dict)
                    else dump.get("op", 0)
                    for dump in perf.values()
                ),
            },
        }
        return rep

    def serve(self) -> None:
        self.last_report = self.report()
        self.reports_generated += 1


class DashboardModule(MgrModule):
    """Minimal dashboard (src/pybind/mgr/dashboard reduced to the
    read-only status surface): an HTTP endpoint serving a live HTML
    cluster overview plus JSON APIs (/api/health, /api/osds,
    /api/pools, /api/daemons, /api/telemetry)."""

    NAME = "dashboard"

    def __init__(self, mgr: "Manager"):
        super().__init__(mgr)
        module = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    if self.path in ("/", "/index.html"):
                        self._reply(
                            module.render_html().encode(),
                            "text/html",
                        )
                    elif self.path.startswith("/api/"):
                        payload = module.api(self.path[5:])
                        self._reply(
                            json.dumps(payload).encode(),
                            "application/json",
                        )
                    else:
                        self.send_response(404)
                        self.end_headers()
                except Exception:  # noqa: BLE001 — a half-up mgr
                    # must answer 500, not kill the handler thread
                    self.send_response(500)
                    self.end_headers()

            def log_message(self, *a):  # quiet
                pass

        self.server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", int(self.get_module_option("port", 0))),
            Handler,
        )
        self.port = self.server.server_address[1]
        threading.Thread(
            target=self.server.serve_forever,
            name="mgr.dashboard",
            daemon=True,
        ).start()

    def shutdown(self) -> None:
        self.server.shutdown()

    def api(self, what: str):
        if what == "health":
            mod = self.mgr.modules.get("status")
            if isinstance(mod, StatusModule):
                return mod.health()
            return self.get("osd_stats")
        if what == "osds":
            m = self.get("osd_map")
            return [
                {
                    "osd": o,
                    "up": m.is_up(o),
                    "in": m.exists(o) and m.osd_weight[o] > 0,
                    "addr": m.osd_addrs.get(o, ""),
                }
                for o in range(m.max_osd)
            ] if m is not None else []
        if what == "pools":
            return (self.get("df") or {}).get("pools", [])
        if what == "daemons":
            return self.get("daemon_perf") or {}
        if what == "telemetry":
            mod = self.mgr.modules.get("telemetry")
            if isinstance(mod, TelemetryModule):
                return mod.report()
            return {}
        if what == "crashes":
            mod = self.mgr.modules.get("crash")
            if isinstance(mod, CrashModule):
                mod.ingest_pending()
                return mod.ls()
            return []
        if what == "log":
            try:
                # short timeout: this runs per HTTP request — a dead
                # mon must not hang page loads for the 15s failover
                reply = self.mgr.monc.command(
                    {"prefix": "log last", "num": 20}, timeout=2.0
                )
                if reply.rc == 0 and reply.outb:
                    return json.loads(reply.outb)
            except Exception:  # noqa: BLE001 — mon away
                pass
            return []
        raise KeyError(what)

    def render_html(self) -> str:
        health = self.api("health") or {}
        osds = self.api("osds")
        pools = self.api("pools")
        rows = "".join(
            f"<tr><td>osd.{o['osd']}</td>"
            f"<td>{'up' if o['up'] else 'down'}</td>"
            f"<td>{'in' if o['in'] else 'out'}</td>"
            f"<td>{o['addr']}</td></tr>"
            for o in osds
        )
        prows = "".join(
            f"<tr><td>{p['name']}</td><td>{p['pg_num']}</td>"
            f"<td>{'ec' if p['type'] == 3 else 'rep'}</td>"
            f"<td>{p['size']}</td></tr>"
            for p in pools
        )
        import html as _html

        crashes = self.api("crashes")
        recent_log = self.api("log")
        # clog messages are remotely-injectable free text (`ceph log
        # <anything>`): escape EVERY field or the dashboard is stored
        # XSS for whoever can reach the mon
        lrows = "".join(
            "<tr>"
            + "".join(
                f"<td>{_html.escape(str(e.get(k, '')))}</td>"
                for k in ("name", "channel", "prio", "message")
            )
            + "</tr>"
            for e in recent_log[-10:]
        )
        muted = _html.escape(
            ", ".join(health.get("muted", [])) or "none"
        )
        # health summaries carry wire-injectable text too (SLOW_OPS
        # embeds reporter daemon names): escape like the log rows
        status = _html.escape(str(health.get("status", "?")))
        checks = _html.escape(
            ", ".join(health.get("checks", [])) or "no checks"
        )
        return (
            "<html><head><title>ceph-tpu</title></head><body>"
            f"<h1>cluster: {status}</h1>"
            f"<p>{checks}"
            f"</p><p>muted checks: {muted} &middot; crash reports: "
            f"{len(crashes)}</p>"
            "<h2>osds</h2><table border=1><tr><th>osd</th>"
            f"<th>state</th><th>in/out</th><th>addr</th></tr>{rows}"
            "</table><h2>pools</h2><table border=1><tr><th>name</th>"
            f"<th>pg_num</th><th>type</th><th>size</th></tr>{prows}"
            "</table><h2>cluster log</h2><table border=1>"
            "<tr><th>from</th><th>channel</th><th>prio</th>"
            f"<th>message</th></tr>{lrows}</table></body></html>"
        )


class TracingModule(MgrModule):
    """Cross-daemon trace assembly (the collection half of the
    blkin/ZTracer seat; op_tracker.py's docstring promised the
    correlation, this module delivers it).

    Daemons piggyback drained spans on their MMgrReport pushes; this
    module drains the manager's span inbox on its tick, indexes spans
    by trace id, and serves one logical op's spans — from the client,
    the primary, and every replica/shard — as a single tree
    (``get_trace``).  Traces are bounded LRU-by-insertion
    (``max_traces``); a trace stops accepting spans ``trace_ttl``
    after its first span arrived, so an id reused much later starts a
    fresh entry instead of gluing two ops together."""

    NAME = "tracing"
    TICK_EVERY = 0.2

    def __init__(self, mgr: "Manager"):
        super().__init__(mgr)
        self.max_traces = int(self.get_module_option("max_traces", 512))
        self.trace_ttl = float(self.get_module_option("trace_ttl", 600.0))
        # trace id -> {"first_seen": ts, "spans": [span dicts]}
        self._traces: OrderedDict[str, dict] = OrderedDict()
        self._lock = threading.Lock()
        self.spans_ingested = 0

    def serve(self) -> None:
        self.ingest_pending()

    def ingest_pending(self) -> None:
        """Drain the manager's span inbox (callable directly so tests
        and admin surfaces need not wait a tick)."""
        while True:
            try:
                daemon, spans = self.mgr._span_inbox.popleft()
            except IndexError:
                return
            self._ingest(daemon, spans)

    def _ingest(self, daemon: str, spans: list) -> None:
        now = time.time()
        with self._lock:
            for span in spans:
                if not isinstance(span, dict) or not span.get("trace_id"):
                    continue
                span.setdefault("daemon", daemon)
                entry = self._traces.get(span["trace_id"])
                if entry is None:
                    entry = {"first_seen": now, "spans": []}
                    self._traces[span["trace_id"]] = entry
                    while len(self._traces) > self.max_traces:
                        self._traces.popitem(last=False)
                elif now - entry["first_seen"] > self.trace_ttl:
                    entry = {"first_seen": now, "spans": []}
                    self._traces[span["trace_id"]] = entry
                entry["spans"].append(span)
                self.spans_ingested += 1

    # -- query surface -----------------------------------------------------
    def traces(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def get_trace(self, trace_id: str) -> dict:
        """One logical op as a span TREE across daemons: explicit
        parent ids when the spans carry them, role-rank attachment
        (client < primary < replica/shard) for the cross-daemon hops
        the wire does not encode."""
        with self._lock:
            entry = self._traces.get(trace_id)
            spans = list(entry["spans"]) if entry else []
        return {
            "trace_id": trace_id,
            "num_spans": len(spans),
            "daemons": sorted({s.get("daemon", "") for s in spans}),
            "roots": tracing.assemble_tree(spans),
        }

    def dump(self, qos_class: str = "") -> dict:
        """Summary of every held trace (the dump_traces rollup).
        ``qos_class`` keeps only traces whose spans carry that class
        tag (the objecter stamps it on every root span, the primary
        on every osd_op span)."""
        with self._lock:
            entries = {
                tid: e
                for tid, e in self._traces.items()
                if not qos_class
                or any(
                    s.get("tags", {}).get("qos_class") == qos_class
                    for s in e["spans"]
                )
            }
            return {
                "num_traces": len(entries),
                "spans_ingested": self.spans_ingested,
                "qos_class": qos_class,
                "traces": {
                    tid: {
                        "num_spans": len(e["spans"]),
                        "daemons": sorted(
                            {
                                s.get("daemon", "")
                                for s in e["spans"]
                            }
                        ),
                    }
                    for tid, e in entries.items()
                },
            }

    def handle_command(self, cmd: dict) -> MMonCommandReply:
        """`ceph tracing dump [qos_class=X]` / `ceph tracing
        summary` — the per-class filter/aggregation surface (routed
        to the active mgr like crash/slo commands)."""
        self.ingest_pending()  # fresh spans show up now
        prefix = cmd.get("prefix", "")
        if prefix == "tracing dump":
            return MMonCommandReply(
                outb=json.dumps(
                    self.dump(str(cmd.get("qos_class", "")))
                )
            )
        if prefix == "tracing summary":
            return MMonCommandReply(
                outb=json.dumps(self.class_summary())
            )
        return MMonCommandReply(
            rc=-22, outs=f"unknown tracing command {prefix!r}"
        )

    def class_summary(self) -> dict:
        """Span counts + mean duration per qos_class across every
        held trace — the per-class aggregation seat."""
        agg: dict[str, dict] = {}
        with self._lock:
            spans = [
                s
                for e in self._traces.values()
                for s in e["spans"]
            ]
        for s in spans:
            klass = str(
                (s.get("tags") or {}).get("qos_class") or "untagged"
            )
            row = agg.setdefault(
                klass, {"spans": 0, "total_duration": 0.0}
            )
            row["spans"] += 1
            row["total_duration"] += float(s.get("duration", 0.0))
        for row in agg.values():
            row["mean_duration"] = (
                row["total_duration"] / row["spans"]
                if row["spans"]
                else 0.0
            )
        return agg


class CrashModule(MgrModule):
    """Crash-report collection (src/pybind/mgr/crash reduced): drains
    reports piggybacked on MMgrReport plus the process-global pending
    queue (co-hosted daemons), dedupes by crash_id, serves
    ``ceph crash ls / info <id> / stat / archive [<id>|all]``, and
    keeps the mon's RECENT_CRASH count current via the "crash report"
    command — archiving pushes the cleared count, which clears the
    health warning."""

    NAME = "crash"
    TICK_EVERY = 0.5
    # un-archived crashes younger than this raise RECENT_CRASH
    # (mgr/crash/warn_recent_interval; the reference defaults to two
    # weeks)
    DEFAULT_WARN_RECENT_INTERVAL = 14 * 24 * 3600.0

    def __init__(self, mgr: "Manager"):
        super().__init__(mgr)
        self.max_reports = int(self.get_module_option("max_reports", 128))
        self.crashes: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.total_ingested = 0
        self._last_reported: int | None = None
        self._last_report_time = 0.0

    def serve(self) -> None:
        self.ingest_pending()
        self._report_health()

    # -- ingest ------------------------------------------------------------
    def ingest_pending(self) -> None:
        """Drain both delivery paths (callable directly so tests need
        not wait a tick)."""
        while True:
            try:
                report = self.mgr._crash_inbox.popleft()
            except IndexError:
                break
            self._ingest(report)
        for report in crash_util.drain_pending():
            self._ingest(report)

    def _ingest(self, report: dict) -> None:
        cid = report.get("crash_id")
        if not cid or not isinstance(cid, str):
            return
        with self._lock:
            if cid in self.crashes:
                return  # double delivery (wire + global queue)
            report.setdefault("archived", False)
            self.crashes[cid] = report
            self.total_ingested += 1
            while len(self.crashes) > self.max_reports:
                self.crashes.popitem(last=False)

    # -- health ------------------------------------------------------------
    def _is_recent(self, report: dict, cutoff: float) -> bool:
        """The ONE recency predicate (health count and `crash stat`
        must never disagree)."""
        return (
            not report.get("archived")
            and float(report.get("timestamp", 0)) >= cutoff
        )

    def _recent_cutoff(self) -> float:
        interval = float(
            self.get_module_option(
                "warn_recent_interval",
                self.DEFAULT_WARN_RECENT_INTERVAL,
            )
        )
        return time.time() - interval

    def recent(self) -> list[dict]:
        cutoff = self._recent_cutoff()
        with self._lock:
            return [
                r
                for r in self.crashes.values()
                if self._is_recent(r, cutoff)
            ]

    def _report_health(self) -> None:
        n = len(self.recent())
        now = time.monotonic()
        # re-push an UNCHANGED count every few seconds anyway: the
        # mon holds it in memory only, so a restarted mon would
        # otherwise show HEALTH_OK over un-archived crashes forever
        # (the SLOW_OPS re-report idiom)
        if n == self._last_reported and now - self._last_report_time < 5.0:
            return
        try:
            reply = self.mon_command(
                {"prefix": "crash report", "num_recent": n},
                timeout=2.0,  # tick thread: never stall other modules
            )
            if reply.rc == 0:
                self._last_reported = n
                self._last_report_time = now
        except Exception:  # noqa: BLE001 — retried next tick
            pass

    # -- query/command surface ---------------------------------------------
    def ls(self) -> list[dict]:
        with self._lock:
            return sorted(
                (
                    {
                        "crash_id": r["crash_id"],
                        "entity_name": r.get("entity_name", ""),
                        "timestamp_iso": r.get("timestamp_iso", ""),
                        "exception": r.get("exception", ""),
                        "archived": bool(r.get("archived")),
                    }
                    for r in self.crashes.values()
                ),
                key=lambda r: r["crash_id"],
            )

    def info(self, crash_id: str) -> dict | None:
        with self._lock:
            return self.crashes.get(crash_id)

    def stat(self) -> dict:
        cutoff = self._recent_cutoff()
        with self._lock:
            archived = sum(
                1 for r in self.crashes.values() if r.get("archived")
            )
            return {
                "total_ingested": self.total_ingested,
                "held": len(self.crashes),
                "archived": archived,
                "recent": sum(
                    1
                    for r in self.crashes.values()
                    if self._is_recent(r, cutoff)
                ),
            }

    def archive(self, crash_id: str) -> bool:
        with self._lock:
            report = self.crashes.get(crash_id)
            if report is None:
                return False
            report["archived"] = True
        self._report_health()
        return True

    def archive_all(self) -> int:
        with self._lock:
            n = 0
            for r in self.crashes.values():
                if not r.get("archived"):
                    r["archived"] = True
                    n += 1
        self._report_health()
        return n

    def handle_command(self, cmd: dict) -> MMonCommandReply:
        prefix = cmd.get("prefix", "")
        self.ingest_pending()  # a just-crashed daemon shows up now
        if prefix == "crash ls":
            rows = self.ls()
            return MMonCommandReply(
                outs="\n".join(
                    f"{r['crash_id']}  {r['entity_name']}"
                    + ("  (archived)" if r["archived"] else "")
                    for r in rows
                ),
                outb=json.dumps(rows),
            )
        if prefix == "crash info":
            report = self.info(str(cmd.get("id", "")))
            if report is None:
                return MMonCommandReply(
                    rc=-2, outs="no such crash (-ENOENT)"
                )
            return MMonCommandReply(outb=json.dumps(report))
        if prefix == "crash stat":
            return MMonCommandReply(outb=json.dumps(self.stat()))
        if prefix == "crash archive":
            target = str(cmd.get("id", ""))
            if target == "all":
                n = self.archive_all()
                return MMonCommandReply(
                    outs=f"archived {n} crash report(s)"
                )
            if not self.archive(target):
                return MMonCommandReply(
                    rc=-2, outs="no such crash (-ENOENT)"
                )
            return MMonCommandReply(outs=f"archived {target}")
        return MMonCommandReply(
            rc=-22, outs=f"unknown crash command {prefix!r}"
        )


class PgAutoscalerModule(MgrModule):
    """pg_num autoscaling (src/pybind/mgr/pg_autoscaler/module.py
    reduced): per replicated pool, the ideal pg count is the power of
    two nearest target_pgs_per_osd * in-osds / (pools * size); an
    undersized pool gets a recommendation, and in mode "on" the
    module commits the increase through "osd pool set pg_num"
    (primaries split by stable_mod re-homing when they observe the
    map).  Erasure pools split like any other: the pool-type-agnostic
    re-homing path decodes whole objects and re-writes them through
    the child primary's EC write (the reference's split machinery is
    pool-type-agnostic too, src/osd/OSDMap.cc)."""

    NAME = "pg_autoscaler"
    TICK_EVERY = 1.0

    def __init__(self, mgr: "Manager"):
        super().__init__(mgr)
        self.recommendations: dict[str, dict] = {}
        self.applied = 0

    def _ideal(self, m, pool) -> int:
        target_per_osd = int(
            self.get_module_option("target_pgs_per_osd", 32)
        )
        num_in = max(
            1,
            sum(
                1
                for o in range(m.max_osd)
                if m.exists(o) and m.osd_weight[o] > 0
            ),
        )
        npools = max(1, len(m.pools))
        raw = target_per_osd * num_in / (npools * max(pool.size, 1))
        ideal = 1
        while ideal * 2 <= raw:
            ideal *= 2
        return max(ideal, pool.pg_num)

    def serve(self) -> None:
        m = self.get("osd_map")
        if m is None:
            return
        for pid, pool in list(m.pools.items()):
            ideal = self._ideal(m, pool)
            name = m.pool_names.get(pid, str(pid))
            if ideal > pool.pg_num:
                self.recommendations[name] = {
                    "current": pool.pg_num,
                    "ideal": ideal,
                }
                if self.get_module_option("mode", "warn") == "on":
                    # one doubling per tick: bounded splitting churn,
                    # the reference's max_misplaced throttling role
                    step = min(ideal, pool.pg_num * 2)
                    reply = self.mon_command(
                        {
                            "prefix": "osd pool set",
                            "pool": name,
                            "var": "pg_num",
                            "val": str(step),
                        }
                    )
                    if reply.rc == 0:
                        self.applied += 1
            else:
                self.recommendations.pop(name, None)


# imported last: slo.py subclasses MgrModule from this module (the
# bottom import breaks the would-be cycle)
from .slo import SLOModule  # noqa: E402
from .pgmap import PgMapModule  # noqa: E402
from .progress import ProgressModule  # noqa: E402

__all__.extend(["SLOModule", "PgMapModule", "ProgressModule"])
