"""The thrasher — qa/tasks/thrashosds + ceph_manager.py's Thrasher
loop: execute a deterministic fault ``Schedule`` against a LIVE
cluster while the consistency oracle (qa/oracle.py) watches every
client op, then force convergence and audit.

Two cluster harnesses implement the same small surface:

- ``ThrashCluster`` — in-process: one Monitor + mgr(PgMap) + N OSDs
  over ``WALStore(MemStore)``, all on the shared-event-loop stack.
  Daemon "death" abandons the WALStore exactly as a SIGKILL would
  (no close, no flush — the tests/test_wal_store.py crash idiom) and
  revival remounts the SAME wal dir, so acked-write durability is
  really carried by crash replay, not by Python object lifetime.
- ``ProcThrashCluster`` — multi-process: the proc.Supervisor fleet;
  kill is a real SIGKILL via the kill-on-request hold API, revival a
  supervisor respawn, and network faults ride ``ceph tell <osd>
  fault ...``.

``Thrasher.run`` executes one schedule: events fire at their offsets
(optionally time-compressed), guarded so ANY subset keeps the cluster
above min_size (that is what makes shrink probes safe), followed by
an unconditional epilogue (heal everything, revive everything, mark
everything in) and a bounded HEALTH_OK convergence check + final
audit.  ``Thrasher.run_with_shrink`` ddmin-minimizes a violating
schedule and emits ``repro_<seed>.json``.

``mutation="suppress_replay"`` deliberately breaks the durability
invariant — every WAL remount first truncates the log — to prove the
oracle fires (the mutation-testing gate: an oracle nobody has seen
fail is an oracle nobody can trust).

Every harness takes ``device`` (default ``cuda``; the tests pass
``cpu``) and hands it to each part that computes: the OSDs' codecs and
scrub maps, the WAL's replay verify after every remount, the manager.
On ``cuda`` the in-process harness builds the kernels before any OSD
boots, so a first compile cannot stall a daemon past its heartbeat
grace.
"""

from __future__ import annotations

import pathlib
import shutil
import tempfile
import threading
import time
from random import Random

from ..common.perf_counters import PerfCountersBuilder
from .oracle import ConsistencyOracle, HistoryRecorder
from .schedule import Schedule, ScheduleEvent

DEFAULT_SEED = 20260806
MIN_LIVE_IN = 2  # never drop below min_size usable OSDs


def _map_up_in(osdmap, i: int) -> bool:
    """up AND in (weight > 0) per the client's map view."""
    return (
        osdmap.is_up(i)
        and 0 <= i < len(osdmap.osd_weight)
        and osdmap.osd_weight[i] > 0
    )


def build_thrash_perf():
    """The thrasher counter schema (l_thrash_* block) — module-level
    so tools/check_metrics.py lints it without a run."""
    return (
        PerfCountersBuilder("qa.thrasher")
        .add_u64_counter(
            "l_thrash_events", "schedule events executed"
        )
        .add_u64_counter(
            "l_thrash_skipped_events",
            "events skipped by safety guards / capability set",
        )
        .add_u64_counter(
            "l_thrash_violations", "oracle violations recorded"
        )
        .add_u64_counter(
            "l_thrash_shrink_steps", "shrink probe runs executed"
        )
        .create_perf_counters()
    )


# -- fault-plane primitives (shared with tests/chaos.py) --------------------
def addr_str(addr) -> str:
    host, port = addr
    return f"{host}:{port}"


def install_aliases(messengers, aliases: dict[str, str]) -> None:
    """Teach every injector the daemon-name -> address map so rules
    and partitions can say ``osd.1`` / ``mon.2``."""
    for m in messengers:
        for name, addr in aliases.items():
            m.faults.alias(name, addr)


def install_partition(
    messengers, groups, aliases, name="netsplit", seed=DEFAULT_SEED
) -> None:
    """One symmetric netsplit: the same named partition (and seed) on
    every member messenger."""
    for m in messengers:
        m.faults.reseed(seed)
    install_aliases(messengers, aliases)
    for m in messengers:
        m.faults.set_partition(name, groups)


def install_lossy(
    messenger, dst: str, delay=0.02, jitter=0.03, dup=0.4
) -> int:
    """One netem-style delay+jitter+dup rule toward ``dst`` (no
    drops: nothing times out, so a seeded run replays exactly)."""
    return messenger.faults.add_rule(
        dst=dst, delay=delay, jitter=jitter, dup=dup
    )


def heal(messengers, name: str | None = None) -> None:
    for m in messengers:
        if name is not None:
            m.faults.clear_partition(name)
        else:
            m.faults.clear()


def fault_counters(messenger) -> dict:
    return messenger.faults.perf.dump()


def _base_map(n: int):
    """The canonical n-host replicated CRUSH map every harness uses
    (one OSD per straw2 host under "default", a firstn host rule)."""
    from ..crush.builder import CrushMap
    from ..crush.types import CRUSH_BUCKET_STRAW2, Tunables
    from ..osd.osdmap import OSDMap

    cmap = CrushMap(tunables=Tunables())
    hosts = []
    for h in range(n):
        hosts.append(
            cmap.add_bucket(
                CRUSH_BUCKET_STRAW2, 1, [h], [0x10000],
                name=f"host{h}",
            )
        )
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts,
        [cmap.buckets[b].weight for b in hosts], name="default",
    )
    cmap.add_simple_rule("rep", "default", "host", mode="firstn")
    return OSDMap.build(cmap, n)


class ThrashCluster:
    """In-process live cluster with crash-real OSD death.

    Every OSD runs over ``WALStore(MemStore(), <wal dir>)``: the wal
    dir on disk is the daemon's only durable state, so kill/revive
    exercises the actual replay path and ``mutation`` can corrupt it.
    """

    caps = frozenset(
        {
            "kill", "revive", "wal_kill", "out", "in", "reweight",
            "netsplit", "heal_netsplit", "lossy", "clear_faults",
            "power_loss", "fill_pressure", "fill_release", "scrub",
            "settle",
        }
    )

    def __init__(
        self,
        n_osds: int = 3,
        seed: int = DEFAULT_SEED,
        workdir: str | None = None,
        pg_num: int = 4,
        mutation: str | None = None,
        device: str = "cuda",
    ):
        from ..mgr import Manager
        from ..mgr.pgmap import PgMapModule
        from ..mon.monitor import Monitor
        from ..msg import Messenger
        from ..rados import Rados

        self.n = int(n_osds)
        self.seed = int(seed)
        self.mutation = mutation
        self.device = device
        if device.startswith("cuda"):
            from ..tools.cluster import prebuild_kernels

            prebuild_kernels(device)
        self.pool = "qapool"
        self._own_workdir = workdir is None
        self.workdir = pathlib.Path(
            workdir
            if workdir is not None
            else tempfile.mkdtemp(prefix="qa-thrash-")
        )
        self.mon = Monitor(_base_map(self.n), min_reporters=2)
        self.mon_msgr = Messenger("mon")
        self.mon_msgr.add_dispatcher(self.mon)
        self.mon_addr = self.mon_msgr.bind()
        self.mgr = Manager(
            modules=[PgMapModule], name="qa-mgr", device=device
        )
        self.mgr.start(self.mon_addr)
        self.osds: dict[int, object] = {}
        self.wal_replays: dict[int, int] = {}
        for i in range(self.n):
            self._boot_osd(i)
        self.client = Rados(f"qa-{seed}").connect(*self.mon_addr)
        self.client.objecter.op_timeout = 30.0
        self.pool_id = self.client.pool_create(
            self.pool, pg_num=int(pg_num), size=3, min_size=2
        )
        self.io = self.client.open_ioctx(self.pool)
        self.refresh_aliases()
        self._wait_boot()

    # -- plumbing -----------------------------------------------------------
    def _wal_dir(self, i: int) -> pathlib.Path:
        return self.workdir / f"osd{i}-wal"

    def _make_store(self, i: int):
        from ..store.objectstore import MemStore
        from ..store.wal_store import WALStore

        if self.mutation == "suppress_replay":
            # the deliberate invariant break: throw the log away
            # before every mount, so "crash replay" replays nothing
            shutil.rmtree(self._wal_dir(i), ignore_errors=True)
        return WALStore(MemStore(), self._wal_dir(i), device=self.device)

    def _boot_osd(self, i: int):
        from ..osd.daemon import OSD

        store = self._make_store(i)
        self.wal_replays[i] = (
            self.wal_replays.get(i, 0) + store.replayed_records
        )
        osd = OSD(
            i, store=store, tick_interval=0.2, heartbeat_grace=1.0,
            device=self.device,
        )
        osd.log_keep = 4096  # thrash windows must stay log-recoverable
        osd.boot(*self.mon_addr)
        self.osds[i] = osd
        return osd

    def _wait_boot(self, timeout: float = 20.0):
        from ..msg.messenger import wait_for

        assert wait_for(
            lambda: all(
                self.client.monc.osdmap.is_up(i)
                for i in self.osds
            ),
            timeout,
        ), "OSDs never booted into the map"

    def refresh_aliases(self) -> None:
        """(Re)install osd-name aliases everywhere — revived OSDs
        bind fresh ports, so partitions must re-learn addresses."""
        aliases = {
            f"osd.{i}": addr_str(o.addr)
            for i, o in self.osds.items()
            if getattr(o, "addr", None) is not None
        }
        install_aliases(self.messengers(), aliases)

    def messengers(self) -> list:
        return [self.mon_msgr, self.client.messenger] + [
            o.messenger for o in self.osds.values()
        ]

    def osd_messengers(self) -> list:
        return [o.messenger for o in self.osds.values()]

    # -- daemon lifecycle ---------------------------------------------------
    def kill_osd(self, i: int) -> None:
        """SIGKILL-equivalent: abandon the WAL un-flushed (no close,
        no drain — in-flight acks die with it), then tear the daemon
        down.  The wal dir on disk is all that survives."""
        osd = self.osds.pop(i)
        osd.store._closed = True  # the crash: nothing flushes
        osd._stop.set()
        osd._workq.put(None)
        osd.messenger.shutdown()

    def revive_osd(self, i: int) -> int:
        """Remount the wal dir (crash replay) and reboot the OSD.
        Returns the number of replayed records."""
        before = self.wal_replays.get(i, 0)
        self._boot_osd(i)
        self.refresh_aliases()
        return self.wal_replays[i] - before

    def crash_restart_osd(self, i: int) -> int:
        self.kill_osd(i)
        return self.revive_osd(i)

    def power_loss(self) -> int:
        """Whole-cluster crash: every OSD's WAL abandoned at the same
        instant, then every OSD remounted and rebooted.  Zero acked
        loss across this is the WAL group-commit contract."""
        for i in list(self.osds):
            self.kill_osd(i)
        replayed = 0
        for i in range(self.n):
            replayed += self.revive_osd(i)
        return replayed

    # -- mon surface --------------------------------------------------------
    def mon_command(self, cmd: dict):
        return self.client.mon_command(cmd)

    def mark_out(self, i: int) -> None:
        self.mon_command({"prefix": "osd out", "id": i})

    def mark_in(self, i: int) -> None:
        self.mon_command({"prefix": "osd in", "id": i})

    def reweight(self, i: int, weight: float) -> None:
        self.mon_command(
            {"prefix": "osd reweight", "id": i, "weight": weight}
        )

    def health(self) -> tuple[str, dict]:
        import json

        rc, outb, _outs = self.mon_command({"prefix": "health"})
        if rc != 0:
            return "UNKNOWN", {}
        doc = json.loads(outb)
        return doc.get("status", "UNKNOWN"), doc.get(
            "checks_detail", {}
        )

    def wait_healthy(self, timeout: float = 60.0) -> bool:
        from ..msg.messenger import wait_for

        def ok():
            if not all(
                _map_up_in(self.client.monc.osdmap, i)
                for i in range(self.n)
            ):
                return False
            return self.health()[0] == "HEALTH_OK"

        return wait_for(ok, timeout, interval=0.25)

    # -- fault hooks --------------------------------------------------------
    def scrub_random(self, rng: Random, deep: bool) -> str | None:
        """Order an on-demand scrub on a deterministic-random live
        PG (the scrub-during-fault composition)."""
        for i in sorted(self.osds):
            pgid = self.osds[i].scrubber.request_random(
                rng, deep=deep
            )
            if pgid is not None:
                return pgid
        return None

    def reset_failure_reports(self) -> None:
        """Heal hook: a partition leaves half-counted failure reports
        pending on the mon; a later unrelated report must not tip a
        healthy OSD down with stale counts."""
        self.mon.failures.reset()

    def set_fill(self, i: int, ratio: float):
        """Shrink osd.i's capacity until it is ``ratio`` full (the
        OSD_FULL / backoff-park pressure).  Returns the restore
        value, or None when the osd is down."""
        osd = self.osds.get(i)
        if osd is None:
            return None
        inner = osd.store.inner
        original = inner.total_bytes
        used = max(1, int(inner.statfs()["used"]))
        inner.total_bytes = max(used + 4096, int(used / ratio))
        return original

    def restore_fill(self, i: int, total: int) -> None:
        osd = self.osds.get(i)
        if osd is not None:
            osd.store.inner.total_bytes = total

    # -- teardown -----------------------------------------------------------
    def shutdown(self) -> None:
        for i in list(self.osds):
            try:
                self.kill_osd(i)
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for closer in (
            self.client.shutdown,
            self.mgr.shutdown,
            self.mon_msgr.shutdown,
        ):
            try:
                closer()
            except Exception:  # noqa: BLE001
                pass
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)


class ProcThrashCluster:
    """Multi-process harness: the proc.Supervisor fleet.  Kill is a
    real SIGKILL held against auto-respawn (the kill-on-request API),
    revive a supervisor respawn (real WAL replay in the readiness
    report), and network faults ride ``ceph tell osd.N fault ...``."""

    caps = frozenset(
        {
            "kill", "revive", "wal_kill", "out", "in", "reweight",
            "netsplit", "heal_netsplit", "lossy", "clear_faults",
            "scrub", "settle",
        }
    )

    def __init__(
        self,
        n_osds: int = 3,
        seed: int = DEFAULT_SEED,
        workdir: str | None = None,
        pg_num: int = 4,
        mutation: str | None = None,
        device: str = "cuda",
    ):
        from ..proc import ClusterSpec, Supervisor
        from ..rados import Rados

        if mutation is not None:
            raise ValueError(
                "mutation modes are in-process only (the proc "
                "harness cannot reach inside a child's store)"
            )
        self.n = int(n_osds)
        self.seed = int(seed)
        self.pool = "qapool"
        self._own_workdir = workdir is None
        self.workdir = pathlib.Path(
            workdir
            if workdir is not None
            else tempfile.mkdtemp(prefix="qa-proc-thrash-")
        )
        self.spec = ClusterSpec.plan(
            str(self.workdir),
            mons=1,
            osds=self.n,
            mgrs=1,
            memstore=True,
            wal=True,
            device=device,
        )
        self.sup = Supervisor(self.spec, min_uptime=0.5)
        self.sup.start(ready_timeout=120)
        self.client = Rados(f"qa-proc-{seed}").connect_any(
            self.spec.mon_addrs
        )
        self.client.objecter.op_timeout = 30.0
        self.pool_id = self.client.pool_create(
            self.pool, pg_num=int(pg_num), size=3, min_size=2
        )
        self.io = self.client.open_ioctx(self.pool)
        self._lossy_rules: list[int] = []

    # -- daemon lifecycle ---------------------------------------------------
    def kill_osd(self, i: int) -> None:
        self.sup.kill(f"osd.{i}", hold=True)

    def revive_osd(self, i: int) -> int:
        role = f"osd.{i}"
        self.sup.respawn(role)
        self.sup.wait_ready([role], timeout=60)
        try:
            return int(self.sup.ready_info(role)["replayed"])
        except (KeyError, TypeError, ValueError):
            return 0

    def crash_restart_osd(self, i: int) -> int:
        self.kill_osd(i)
        return self.revive_osd(i)

    def refresh_aliases(self) -> None:
        pass  # proc rules are address-based (osdmap is authoritative)

    # -- mon / tell surface -------------------------------------------------
    def mon_command(self, cmd: dict):
        return self.client.mon_command(cmd)

    def tell(self, target: str, args: dict):
        """``ceph tell osd.N ...``: the mon names the address, we
        dispatch the MCommand there (the CLI route)."""
        import json

        from ..msg.message import MCommand

        rc, outb, outs = self.mon_command(
            {"prefix": "tell", "target": target, "args": args}
        )
        if rc != 0:
            return rc, "", outs
        t = json.loads(outb)
        host, _, port = t["addr"].rpartition(":")
        conn = self.client.messenger.connect(host, int(port))
        reply = conn.call(
            MCommand(
                tid=self.client.messenger.new_tid(),
                cmd=json.dumps(t["args"]),
            )
        )
        return reply.rc, reply.outb, reply.outs

    def mark_out(self, i: int) -> None:
        self.mon_command({"prefix": "osd out", "id": i})

    def mark_in(self, i: int) -> None:
        self.mon_command({"prefix": "osd in", "id": i})

    def reweight(self, i: int, weight: float) -> None:
        self.mon_command(
            {"prefix": "osd reweight", "id": i, "weight": weight}
        )

    def health(self) -> tuple[str, dict]:
        import json

        rc, outb, _outs = self.mon_command({"prefix": "health"})
        if rc != 0:
            return "UNKNOWN", {}
        doc = json.loads(outb)
        return doc.get("status", "UNKNOWN"), doc.get(
            "checks_detail", {}
        )

    def archive_crashes(self) -> None:
        """SIGKILLed children ride MMgrReport into RECENT_CRASH —
        expected deaths, archived so convergence can reach
        HEALTH_OK."""
        import json

        from ..msg.message import MMonCommand

        rc, outb, _outs = self.mon_command({"prefix": "mgr stat"})
        if rc != 0 or not outb:
            return
        active = json.loads(outb).get("active")
        if not active:
            return
        host, _, port = active["addr"].rpartition(":")
        try:
            conn = self.client.messenger.connect(host, int(port))
            conn.call(
                MMonCommand(
                    cmd=json.dumps(
                        {"prefix": "crash archive", "id": "all"}
                    )
                )
            )
        except Exception:  # noqa: BLE001 — convergence retries
            pass

    def wait_healthy(self, timeout: float = 90.0) -> bool:
        from ..msg.messenger import wait_for

        def ok():
            if not all(
                _map_up_in(self.client.monc.osdmap, i)
                for i in range(self.n)
            ):
                return False
            status, checks = self.health()
            if "RECENT_CRASH" in checks:
                self.archive_crashes()
                return False
            return status == "HEALTH_OK"

        return wait_for(ok, timeout, interval=0.5)

    # -- fault hooks --------------------------------------------------------
    def _osd_addr(self, i: int) -> str | None:
        return self.client.monc.osdmap.osd_addrs.get(i)

    def install_lossy(self, i: int, delay, jitter, dup) -> None:
        addr = self._osd_addr(i)
        if addr:
            self._lossy_rules.append(
                install_lossy(
                    self.client.messenger, addr, delay, jitter, dup
                )
            )

    def install_netsplit(self, victim: int) -> None:
        """Symmetric victim isolation with address-based drop rules
        installed over ``tell`` on every live daemon."""
        vaddr = self._osd_addr(victim)
        if vaddr is None:
            return
        for j in range(self.n):
            if j == victim:
                continue
            jaddr = self._osd_addr(j)
            if jaddr is None:
                continue
            self.tell(
                f"osd.{j}",
                {"prefix": "fault set", "dst": vaddr, "drop": 1.0},
            )
            self.tell(
                f"osd.{victim}",
                {"prefix": "fault set", "dst": jaddr, "drop": 1.0},
            )

    def clear_faults(self) -> None:
        for i in range(self.n):
            try:
                self.tell(f"osd.{i}", {"prefix": "fault clear"})
            except Exception:  # noqa: BLE001 — daemon may be down
                pass
        self.client.messenger.faults.clear()
        self._lossy_rules.clear()

    def scrub_random(self, rng: Random, deep: bool) -> str | None:
        import json

        from ..msg.message import MScrubCommand

        pg_num = self.client.monc.osdmap.pools[
            self.pool_id
        ].pg_num
        pgid = f"{self.pool_id}.{rng.randrange(pg_num)}"
        rc, outb, _outs = self.mon_command(
            {
                "prefix": (
                    "pg deep-scrub" if deep else "pg scrub"
                ),
                "pgid": pgid,
            }
        )
        if rc != 0 or not outb:
            return None
        t = json.loads(outb)
        host, _, port = t["addr"].rpartition(":")
        conn = self.client.messenger.connect(host, int(port))
        conn.call(
            MScrubCommand(
                tid=self.client.messenger.new_tid(),
                op=t["op"],
                pgid=t["pgid"],
            )
        )
        return pgid

    def reset_failure_reports(self) -> None:
        pass  # mon is out-of-process; its aggregator self-heals

    def shutdown(self) -> None:
        for closer in (
            self.client.shutdown,
            self.sup.stop,
        ):
            try:
                closer()
            except Exception:  # noqa: BLE001
                pass
        if self._own_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)


class Thrasher:
    """Execute a Schedule against a live cluster under the oracle.

    The executor tracks its OWN alive/in sets (a pure function of the
    events applied, never of cluster timing) and guards every event
    so at least MIN_LIVE_IN OSDs stay alive AND in — which is what
    makes arbitrary shrink subsets safe to execute.  Whatever the
    events did, the epilogue heals faults, revives the dead, marks
    everything in, restores weights and capacity, then demands
    HEALTH_OK within ``convergence_timeout`` and runs the final
    audit."""

    def __init__(
        self,
        schedule: Schedule,
        mode: str = "inprocess",
        mutation: str | None = None,
        time_scale: float = 1.0,
        convergence_timeout: float = 60.0,
        workload_clients: int = 2,
        objects_per_client: int = 4,
        perf=None,
        workdir: str | None = None,
        device: str = "cuda",
    ):
        if mutation not in (None, "suppress_replay"):
            raise ValueError(f"unknown mutation: {mutation!r}")
        self.schedule = schedule
        self.mode = mode
        self.mutation = mutation
        self.time_scale = max(0.1, float(time_scale))
        self.convergence_timeout = float(convergence_timeout)
        self.workload_clients = int(workload_clients)
        self.objects_per_client = int(objects_per_client)
        self.perf = perf if perf is not None else build_thrash_perf()
        self.workdir = workdir
        self.device = device

    def _make_cluster(self):
        cls = (
            ProcThrashCluster
            if self.mode == "proc"
            else ThrashCluster
        )
        return cls(
            n_osds=self.schedule.osds,
            seed=self.schedule.seed,
            mutation=self.mutation,
            workdir=self.workdir,
            device=self.device,
        )

    # -- one run ------------------------------------------------------------
    def run(self, events: list[ScheduleEvent] | None = None) -> dict:
        events = (
            list(self.schedule.events)
            if events is None
            else list(events)
        )
        cluster = self._make_cluster()
        oracle = ConsistencyOracle(perf=self.perf)
        recorder = HistoryRecorder(
            cluster.io,
            oracle,
            seed=self.schedule.seed,
            clients=self.workload_clients,
            objects_per_client=self.objects_per_client,
        )
        trace: list[dict] = []
        state = _ExecState(self.schedule.osds)
        try:
            recorder.start()
            time.sleep(0.5 / self.time_scale)
            t0 = time.monotonic()
            for idx, ev in enumerate(events):
                delay = (
                    t0 + ev.t / self.time_scale - time.monotonic()
                )
                if delay > 0:
                    time.sleep(delay)
                applied, note = self._apply(
                    cluster, state, ev, idx
                )
                self.perf.inc(
                    "l_thrash_events"
                    if applied
                    else "l_thrash_skipped_events"
                )
                trace.append(
                    {
                        "t": ev.t,
                        "kind": ev.kind,
                        "applied": applied,
                        "note": note,
                    }
                )
            self._epilogue(cluster, state)
            recorder.stop()
            converged = cluster.wait_healthy(
                self.convergence_timeout
            )
            if not converged:
                status, checks = cluster.health()
                oracle.add_violation(
                    "no_health_convergence",
                    {
                        "status": status,
                        "checks": sorted(checks),
                        "timeout": self.convergence_timeout,
                    },
                )
            audited = recorder.final_audit()
            return {
                "seed": self.schedule.seed,
                "mode": self.mode,
                "mutation": self.mutation,
                "events": len(events),
                "events_applied": sum(
                    1 for e in trace if e["applied"]
                ),
                "trace": trace,
                "ops": recorder.ops,
                "op_errors": recorder.errors,
                "audited": audited,
                "converged": converged,
                "wal_replays": dict(
                    getattr(cluster, "wal_replays", {})
                ),
                "violations": [
                    v.to_dict() for v in oracle.violations
                ],
            }
        finally:
            recorder.stop(timeout=5.0)
            cluster.shutdown()

    # -- event execution ----------------------------------------------------
    def _apply(self, cluster, state, ev, idx) -> tuple[bool, str]:
        if ev.kind not in cluster.caps:
            return False, "unsupported by harness"
        # per-event deterministic rng (scrub target picks etc.):
        # a pure function of (seed, event index), independent of
        # which other events a shrink subset kept
        rng = Random((self.schedule.seed << 20) ^ (idx + 1))
        a = ev.args
        osd = a.get("osd")
        if ev.kind == "kill":
            if osd not in state.alive:
                return False, "already down"
            if not state.safe_without(osd):
                return False, "guard: would drop below min live"
            cluster.kill_osd(osd)
            state.alive.discard(osd)
            return True, ""
        if ev.kind == "revive":
            if osd in state.alive:
                return False, "already up"
            replayed = cluster.revive_osd(osd)
            state.alive.add(osd)
            return True, f"replayed={replayed}"
        if ev.kind == "wal_kill":
            if osd not in state.alive:
                return False, "down"
            if state.netsplit is not None:
                return False, "guard: netsplit active"
            replayed = cluster.crash_restart_osd(osd)
            return True, f"replayed={replayed}"
        if ev.kind == "out":
            if osd not in state.in_set:
                return False, "already out"
            if not state.safe_without(osd):
                return False, "guard: would drop below min live"
            cluster.mark_out(osd)
            state.in_set.discard(osd)
            return True, ""
        if ev.kind == "in":
            if osd in state.in_set:
                return False, "already in"
            cluster.mark_in(osd)
            state.in_set.add(osd)
            return True, ""
        if ev.kind == "reweight":
            cluster.reweight(osd, a["weight"])
            state.reweighted.add(osd)
            return True, ""
        if ev.kind == "netsplit":
            if state.netsplit is not None:
                return False, "already split"
            if osd not in state.alive or not state.safe_without(
                osd
            ):
                return False, "guard: victim down or min live"
            self._install_netsplit(cluster, osd)
            state.netsplit = osd
            return True, ""
        if ev.kind == "heal_netsplit":
            if state.netsplit is None:
                return False, "no split"
            self._heal_netsplit(cluster)
            state.netsplit = None
            return True, ""
        if ev.kind == "lossy":
            self._install_lossy(cluster, a)
            state.lossy = True
            return True, ""
        if ev.kind == "clear_faults":
            self._clear_faults(cluster, state)
            return True, ""
        if ev.kind == "power_loss":
            replayed = cluster.power_loss()
            state.alive = set(range(self.schedule.osds))
            state.netsplit = None
            return True, f"replayed={replayed}"
        if ev.kind == "fill_pressure":
            if osd in state.fills or osd not in state.alive:
                return False, "already filled or down"
            original = cluster.set_fill(osd, a["ratio"])
            if original is None:
                return False, "store unavailable"
            state.fills[osd] = original
            return True, ""
        if ev.kind == "fill_release":
            if not state.fills:
                return False, "nothing filled"
            for i, total in list(state.fills.items()):
                cluster.restore_fill(i, total)
            state.fills.clear()
            return True, ""
        if ev.kind == "scrub":
            pgid = cluster.scrub_random(rng, bool(a.get("deep")))
            return (
                (True, f"pg={pgid}")
                if pgid is not None
                else (False, "no scrubbable pg")
            )
        if ev.kind == "settle":
            return True, ""
        return False, f"unknown kind {ev.kind!r}"

    def _install_netsplit(self, cluster, victim: int) -> None:
        if isinstance(cluster, ProcThrashCluster):
            cluster.install_netsplit(victim)
            return
        cluster.refresh_aliases()
        groups = [
            [f"osd.{victim}"],
            [
                f"osd.{j}"
                for j in cluster.osds
                if j != victim
            ],
        ]
        aliases = {
            f"osd.{j}": addr_str(o.addr)
            for j, o in cluster.osds.items()
        }
        install_partition(
            cluster.osd_messengers(),
            groups,
            aliases,
            name="qa-netsplit",
            seed=self.schedule.seed,
        )

    def _heal_netsplit(self, cluster) -> None:
        if isinstance(cluster, ProcThrashCluster):
            cluster.clear_faults()
        else:
            heal(cluster.osd_messengers(), "qa-netsplit")
            cluster.reset_failure_reports()

    def _install_lossy(self, cluster, a: dict) -> None:
        if isinstance(cluster, ProcThrashCluster):
            cluster.install_lossy(
                a["osd"], a["delay"], a["jitter"], a["dup"]
            )
            return
        osd = cluster.osds.get(a["osd"])
        if osd is None:
            return
        cluster.client.messenger.faults.alias(
            f"osd.{a['osd']}", addr_str(osd.addr)
        )
        install_lossy(
            cluster.client.messenger,
            f"osd.{a['osd']}",
            a["delay"],
            a["jitter"],
            a["dup"],
        )

    def _clear_faults(self, cluster, state) -> None:
        if isinstance(cluster, ProcThrashCluster):
            cluster.clear_faults()
        else:
            heal(cluster.messengers())
            cluster.reset_failure_reports()
        state.netsplit = None
        state.lossy = False

    def _epilogue(self, cluster, state) -> None:
        """Unconditional convergence path — runs the same whatever
        subset of events executed (the shrinkability contract)."""
        self._clear_faults(cluster, state)
        for i, total in list(state.fills.items()):
            cluster.restore_fill(i, total)
        state.fills.clear()
        for i in sorted(
            set(range(self.schedule.osds)) - state.alive
        ):
            cluster.revive_osd(i)
            state.alive.add(i)
        for i in sorted(
            set(range(self.schedule.osds)) - state.in_set
        ):
            cluster.mark_in(i)
            state.in_set.add(i)
        for i in sorted(state.reweighted):
            cluster.reweight(i, 1.0)
        state.reweighted.clear()

    # -- shrink -------------------------------------------------------------
    def run_with_shrink(
        self,
        artifact_dir: str | None = None,
        max_shrink_runs: int = 24,
    ) -> dict:
        """One full run; on violation, ddmin the event list to a
        minimal reproducing subset and emit ``repro_<seed>.json``."""
        from .shrink import shrink_events, write_repro

        report = self.run()
        if not report["violations"]:
            return report
        kinds = {v["kind"] for v in report["violations"]}

        def reproduces(subset) -> bool:
            r = self.run(events=list(subset))
            return any(
                v["kind"] in kinds for v in r["violations"]
            )

        minimal, runs = shrink_events(
            self.schedule.events,
            reproduces,
            perf=self.perf,
            max_runs=max_shrink_runs,
        )
        report["minimal_events"] = [
            e.to_dict() for e in minimal
        ]
        report["shrink_runs"] = runs
        if artifact_dir is not None:
            report["repro_path"] = str(
                write_repro(
                    artifact_dir,
                    self.schedule,
                    minimal,
                    report["violations"],
                    runs,
                    mutation=self.mutation,
                )
            )
        return report


class _ExecState:
    """The executor's own bookkeeping — a pure function of the
    applied events, so guards behave identically across replays and
    shrink probes."""

    def __init__(self, n: int):
        self.n = n
        self.alive = set(range(n))
        self.in_set = set(range(n))
        self.netsplit: int | None = None
        self.lossy = False
        self.fills: dict[int, int] = {}
        self.reweighted: set[int] = set()

    def safe_without(self, osd: int) -> bool:
        usable = (self.alive & self.in_set) - {osd}
        return len(usable) >= MIN_LIVE_IN


def replay_repro(
    path,
    mode: str = "inprocess",
    time_scale: float = 1.0,
    device: str = "cuda",
) -> dict:
    """Re-execute the MINIMAL schedule from a repro artifact (the
    standalone-reproduction contract: the artifact alone restarts
    the investigation — including the mutation, when the violation
    was a deliberate oracle proof). The artifact names no package:
    a repro written by ``python -m ceph_tpu_torch.qa.thrasher``
    replays here, on ``device``."""
    from .shrink import load_repro

    doc = load_repro(path)
    minimal = Schedule.from_dict(doc["minimal_schedule"])
    thr = Thrasher(
        minimal,
        mode=mode,
        mutation=doc.get("mutation"),
        time_scale=time_scale,
        convergence_timeout=30.0,
        device=device,
    )
    return thr.run()


# make `python -m ceph_tpu_torch.qa.thrasher --seed N --duration S
# [--device cpu]` a standalone smoke driver
def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.qa.thrasher",
        description="deterministic thrasher",
    )
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--osds", type=int, default=3)
    p.add_argument(
        "--mode", choices=("inprocess", "proc"), default="inprocess"
    )
    p.add_argument("--time-scale", type=float, default=1.0)
    p.add_argument("--mutation", default=None)
    p.add_argument("--artifact-dir", default=None)
    p.add_argument("--pace", type=float, default=1.0)
    p.add_argument(
        "--device", default="cuda",
        help="where the OSDs, the WAL verify and the manager compute",
    )
    p.add_argument(
        "--weight",
        action="append",
        default=[],
        metavar="KIND=W",
        help="override an event weight (repeatable); kinds absent "
        "from any --weight set are excluded",
    )
    args = p.parse_args(argv)
    try:
        weights = None
        if args.weight:
            weights = {}
            for spec in args.weight:
                kind, _, w = spec.partition("=")
                weights[kind] = float(w)
        sched = Schedule.from_seed(
            args.seed,
            duration=args.duration,
            osds=args.osds,
            weights=weights,
            pace=args.pace,
        )
        thr = Thrasher(
            sched,
            mode=args.mode,
            mutation=args.mutation,
            time_scale=args.time_scale,
            device=args.device,
        )
    except ValueError as e:
        p.error(str(e))
    report = thr.run_with_shrink(artifact_dir=args.artifact_dir)
    print(json.dumps(report, indent=2, sort_keys=True))
    return 1 if report["violations"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
