"""Process supervisor — the ceph-run / systemd ``Restart=on-failure``
role: spawn the fleet from a :class:`~ceph_tpu_torch.proc.spec.ClusterSpec`,
monitor the children, respawn crashes with exponential backoff and a
crash-loop cap, and feed every real process death into the crash
plane so RECENT_CRASH raises for it.

State machine per child (the supervisor discriminates clean shutdown
from crash by wait status, like systemd)::

    spawned ── exit 0 ──────────────▶ exited   (never respawned)
       │  ╲─ SIGTERM via stop() ───▶ stopped  (never respawned)
       │
       └─ nonzero / signal ─▶ crashed ─▶ backoff ─▶ spawned
                                 │   (delay = base·2^(n-1), capped)
                                 └─ n > crash_loop_cap ─▶ failed

``n`` counts CONSECUTIVE short-lived crashes: a child that stayed up
past ``min_uptime`` resets the streak, so a daemon that crashes once
a day never walks into the cap.  Every crash builds a
``build_process_report`` (signal name / exit status + child log
tail) and rides MMgrReport to the mgr crash module over the real
wire — the ceph-crash uploader seat.

Children are ``setsid`` process-group leaders with per-child log
capture; ``stop()`` (and the orphan reaper) kills the whole GROUP,
so a wedged daemon's own children cannot outlive the harness.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

from ..common import crash as crash_util
from ..common.perf_counters import PerfCountersBuilder
from .spec import ClusterSpec

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
SUPERVISOR_STATE = "supervisor.json"
# crash reports ride several consecutive perf pushes (the OSD's
# CRASH_RESEND_COUNT idiom): an mgr restart racing one push must not
# lose the death
CRASH_RESEND_COUNT = 3
LOG_TAIL_LINES = 40


def build_proc_perf():
    """The supervisor counter schema (l_proc_* family) —
    module-level so tools/check_metrics.py lints it without a live
    supervisor."""
    return (
        PerfCountersBuilder("proc.supervisor")
        .add_u64_gauge(
            "l_proc_children", "supervised child processes alive"
        )
        .add_u64_counter(
            "l_proc_restarts",
            "crashed daemons respawned (after backoff)",
        )
        .add_u64_counter(
            "l_proc_crash_loops",
            "daemons abandoned after crash-looping past the cap",
        )
        .create_perf_counters()
    )


class _Child:
    """One supervised role's lifecycle record."""

    def __init__(self, role: str, argv: list[str]):
        self.role = role
        self.argv = argv
        self.proc: subprocess.Popen | None = None
        self.log_fh = None
        self.spawned_at = 0.0
        self.consecutive_crashes = 0
        self.restarts = 0
        self.state = "new"
        self.respawn_at = 0.0
        # kill-on-request: the next death is deliberate — park in
        # "held" instead of the backoff/respawn path until respawn()
        self.hold = False

    @property
    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None


class Supervisor:
    """Spawn/monitor/respawn a fleet of daemon processes."""

    def __init__(
        self,
        spec: ClusterSpec,
        backoff_base: float = 0.5,
        backoff_max: float = 30.0,
        crash_loop_cap: int = 5,
        min_uptime: float = 2.0,
        poll_interval: float = 0.1,
        report_interval: float = 2.0,
        extra_env: dict | None = None,
    ):
        self.spec = spec
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.crash_loop_cap = crash_loop_cap
        self.min_uptime = min_uptime
        self.poll_interval = poll_interval
        self.report_interval = report_interval
        self.extra_env = dict(extra_env or {})
        self.perf = build_proc_perf()
        self.children: dict[str, _Child] = {}
        self._lock = threading.Lock()
        self._stopping = False
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        # crash-plane wire client (lazy; best-effort throughout)
        self._msgr = None
        self._monc = None
        self._mgr_state: dict = {}
        self._crash_outbox: list[tuple[dict, int]] = []
        self._outbox_lock = threading.Lock()
        self._last_report = 0.0

    # -- backoff schedule (unit-tested in isolation) ------------------------
    @staticmethod
    def backoff_delay(
        consecutive: int, base: float, cap: float
    ) -> float:
        """Exponential: base·2^(n−1), capped (systemd RestartSec +
        the ceph-run sleep ladder)."""
        return min(cap, base * (2 ** max(0, consecutive - 1)))

    # -- spawning -----------------------------------------------------------
    def _child_argv(self, role: str) -> list[str]:
        return [
            sys.executable, "-m", "ceph_tpu_torch.proc.daemon",
            "--role", role,
            "--spec", str(self.spec.dir / "spec.json"),
        ]

    def _spawn(self, child: _Child) -> None:
        ready = self.spec.ready_path(child.role)
        try:
            ready.unlink()  # a stale file must not fake readiness
        except OSError:
            pass
        if child.log_fh is None:
            child.log_fh = open(
                self.spec.log_path(child.role), "ab", buffering=0
            )
        env = dict(os.environ)
        env["PYTHONPATH"] = (
            str(REPO_ROOT)
            + os.pathsep
            + env.get("PYTHONPATH", "")
        ).rstrip(os.pathsep)
        env.update(self.extra_env)
        # setsid: the child leads its own process group, so teardown
        # can kill the GROUP and a wedged daemon's own subprocesses
        # die with it
        child.proc = subprocess.Popen(
            child.argv,
            stdout=child.log_fh,
            stderr=child.log_fh,
            stdin=subprocess.DEVNULL,
            env=env,
            start_new_session=True,
        )
        child.spawned_at = time.monotonic()
        child.state = "running"
        self._write_state()

    def start(self, ready_timeout: float = 90.0) -> None:
        """Spawn the fleet in boot-phase order: mons (gate on quorum
        readiness), then mgrs, then OSDs (gate), then gateways."""
        self.spec.dir.mkdir(parents=True, exist_ok=True)
        self.spec.save()
        roles = self.spec.roles()
        phases = [
            [r for r in roles if r.startswith("mon.")],
            [r for r in roles if r.startswith("mgr.")],
            [r for r in roles if r.startswith("osd.")],
            [
                r for r in roles
                if r.startswith(("mds.", "rgw."))
            ],
        ]
        for phase in phases:
            for role in phase:
                child = _Child(role, self._child_argv(role))
                with self._lock:
                    self.children[role] = child
                self._spawn(child)
            self.wait_ready(phase, timeout=ready_timeout)
        self.perf.set("l_proc_children", self._alive_count())
        self._monitor = threading.Thread(
            target=self._monitor_loop,
            name="proc.supervisor",
            daemon=True,
        )
        self._monitor.start()

    def wait_ready(
        self, roles: list[str], timeout: float = 90.0
    ) -> None:
        """Block until every role's readiness file names its CURRENT
        incarnation's pid."""
        deadline = time.monotonic() + timeout
        for role in roles:
            child = self.children[role]
            path = self.spec.ready_path(role)
            while True:
                if child.proc is not None and (
                    child.proc.poll() is not None
                ):
                    raise RuntimeError(
                        f"{role} died during boot "
                        f"(rc={child.proc.returncode}); see "
                        f"{self.spec.log_path(role)}"
                    )
                try:
                    info = json.loads(path.read_text())
                    if info.get("pid") == child.pid:
                        break
                except (OSError, ValueError):
                    pass
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{role} not ready after {timeout}s; see "
                        f"{self.spec.log_path(role)}"
                    )
                time.sleep(0.05)

    def ready_info(self, role: str) -> dict:
        return json.loads(
            self.spec.ready_path(role).read_text()
        )

    # -- monitoring / respawn ----------------------------------------------
    def _alive_count(self) -> int:
        with self._lock:
            return sum(
                1
                for c in self.children.values()
                if c.proc is not None and c.proc.poll() is None
            )

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            now = time.monotonic()
            with self._lock:
                children = list(self.children.values())
            for child in children:
                if child.state == "running":
                    rc = (
                        child.proc.poll()
                        if child.proc is not None
                        else None
                    )
                    if rc is not None:
                        self._on_death(child, rc)
                elif (
                    child.state == "backoff"
                    and now >= child.respawn_at
                    and not self._stopping
                ):
                    child.restarts += 1
                    self.perf.inc("l_proc_restarts")
                    self._spawn(child)
            self.perf.set("l_proc_children", self._alive_count())
            if now - self._last_report >= self.report_interval:
                self._last_report = now
                self._push_report()

    def _on_death(self, child: _Child, rc: int) -> None:
        if self._stopping or child.state in ("stopped", "exited"):
            return
        if rc == 0:
            # clean exit: the daemon chose to leave (Restart=
            # on-failure semantics — never respawned, never reported)
            child.state = "exited"
            self._write_state()
            return
        uptime = time.monotonic() - child.spawned_at
        if child.hold:
            # a requested kill: deliberate chaos, not a crash loop.
            # Still reported (a SIGKILL is a SIGKILL — telemetry does
            # not launder intent) but parked until respawn() instead
            # of riding the backoff path.
            child.state = "held"
            report = crash_util.build_process_report(
                child.role,
                rc,
                log_tail=self._log_tail(child.role),
                extra_meta={
                    "pid": child.pid,
                    "uptime_s": round(uptime, 3),
                    "requested": True,
                },
            )
            with self._outbox_lock:
                self._crash_outbox.append(
                    (report, CRASH_RESEND_COUNT)
                )
            self._write_state()
            self._push_report()
            return
        if uptime < self.min_uptime:
            child.consecutive_crashes += 1
        else:
            child.consecutive_crashes = 1
        report = crash_util.build_process_report(
            child.role,
            rc,
            log_tail=self._log_tail(child.role),
            extra_meta={
                "pid": child.pid,
                "uptime_s": round(uptime, 3),
                "consecutive_crashes": child.consecutive_crashes,
            },
        )
        with self._outbox_lock:
            self._crash_outbox.append((report, CRASH_RESEND_COUNT))
        if child.consecutive_crashes > self.crash_loop_cap:
            child.state = "failed"
            self.perf.inc("l_proc_crash_loops")
        else:
            child.state = "backoff"
            child.respawn_at = (
                time.monotonic()
                + self.backoff_delay(
                    child.consecutive_crashes,
                    self.backoff_base,
                    self.backoff_max,
                )
            )
        self._write_state()
        self._push_report()  # the death should raise health promptly

    def _log_tail(self, role: str) -> list[str]:
        try:
            data = self.spec.log_path(role).read_bytes()[-16384:]
            return data.decode("utf-8", "replace").splitlines()[
                -LOG_TAIL_LINES:
            ]
        except OSError:
            return []

    # -- crash/perf delivery (the RGW mgr-report wire idiom) ---------------
    def _push_report(self) -> None:
        try:
            self._push_report_inner()
        except Exception:  # noqa: BLE001 — telemetry is best-effort;
            # a monless window must not kill the monitor loop
            self._mgr_state.pop("conn", None)

    def _push_report_inner(self) -> None:
        from ..msg.message import MMgrReport

        monc = self._ensure_monc()
        if monc is None:
            return
        state = self._mgr_state
        now = time.monotonic()
        if (
            state.get("addr") is None
            or now - state.get("checked", -1e9) > 5.0
        ):
            state["checked"] = now
            reply = monc.command({"prefix": "mgr stat"})
            active = (
                json.loads(reply.outb).get("active")
                if reply.rc == 0
                else None
            )
            addr = active["addr"] if active else None
            if addr != state.get("addr"):
                state["addr"] = addr
                state["conn"] = None
        if state.get("addr") is None:
            return
        conn = state.get("conn")
        if conn is None or conn.is_closed:
            host, _, port = state["addr"].rpartition(":")
            conn = state["conn"] = self._msgr.connect(
                host, int(port), timeout=5.0
            )
        with self._outbox_lock:
            crashes = [r for r, _n in self._crash_outbox]
            self._crash_outbox = [
                (r, n - 1)
                for r, n in self._crash_outbox
                if n > 1
            ]
        conn.send(
            MMgrReport(
                daemon="supervisor",
                perf=json.dumps(self.perf.dump()),
                crashes=json.dumps(crashes),
            )
        )

    def _ensure_monc(self):
        if self._monc is not None:
            return self._monc
        try:
            from ..mon.monitor import MonClient
            from ..msg import Messenger

            self._msgr = Messenger("proc-supervisor")
            monc = MonClient(self._msgr, whoami=-1)
            monc.connect_any(self.spec.mon_addrs)
            self._monc = monc
        except Exception:  # noqa: BLE001 — no quorum yet; retried
            # on the next push
            if self._msgr is not None:
                try:
                    self._msgr.shutdown()
                except Exception:  # noqa: BLE001
                    pass
            self._msgr = None
            self._monc = None
        return self._monc

    # -- chaos / introspection ----------------------------------------------
    def kill(
        self, role: str, sig: int = signal.SIGKILL, hold: bool = False
    ) -> int:
        """Deliver a REAL signal to a child (chaos hook).  Returns
        the pid that was signalled.  ``hold=True`` is the
        kill-on-request contract: the death parks the child in
        "held" (no backoff, no auto-respawn) until ``respawn()`` —
        the thrasher owns the revive timing, not the backoff
        schedule."""
        child = self.children[role]
        pid = child.pid
        if pid is None:
            raise RuntimeError(f"{role} not running")
        child.hold = bool(hold)
        os.kill(pid, sig)
        return pid

    def respawn(self, role: str) -> int | None:
        """Bring a held (or failed/exited/backoff) child back NOW,
        clearing the hold and the crash-loop count — a requested
        revive is a fresh start, not restart N of a loop.  Returns
        the new pid (None when the child was already running)."""
        child = self.children[role]
        child.hold = False
        if child.state == "running" and child.proc is not None:
            if child.proc.poll() is None:
                return None
            # raced a death the monitor loop has not seen yet: fall
            # through and spawn over it
        child.consecutive_crashes = 0
        child.restarts += 1
        self.perf.inc("l_proc_restarts")
        self._spawn(child)
        self._write_state()
        return child.pid

    def status(self) -> dict:
        with self._lock:
            return {
                role: {
                    "state": c.state,
                    "pid": c.pid,
                    "restarts": c.restarts,
                    "consecutive_crashes": c.consecutive_crashes,
                }
                for role, c in self.children.items()
            }

    def _write_state(self) -> None:
        """Persist supervisor + child pids for the orphan reaper."""
        state = {
            "pid": os.getpid(),
            "children": {
                role: c.pid
                for role, c in self.children.items()
                if c.pid is not None
            },
        }
        path = self.spec.dir / SUPERVISOR_STATE
        try:
            tmp = path.with_suffix(".tmp")
            tmp.write_text(json.dumps(state))
            tmp.replace(path)
        except OSError:
            pass

    @staticmethod
    def reap_orphans(directory: str | pathlib.Path) -> list[int]:
        """Kill process GROUPS recorded by a dead supervisor (the
        harness-poisoning fix: a wedged daemon from a crashed run
        must not squat the ports of the next).  A LIVE supervisor's
        children are left alone.  Returns the pids signalled."""
        path = pathlib.Path(directory) / SUPERVISOR_STATE
        try:
            state = json.loads(path.read_text())
        except (OSError, ValueError):
            return []
        sup_pid = state.get("pid")
        if sup_pid is not None:
            try:
                os.kill(sup_pid, 0)
                return []  # supervisor alive: not ours to reap
            except ProcessLookupError:
                pass
            except PermissionError:
                return []
        reaped = []
        for pid in state.get("children", {}).values():
            try:
                # setsid children lead their own group: killpg takes
                # the daemon AND anything it spawned
                os.killpg(pid, signal.SIGKILL)
                reaped.append(pid)
            except (ProcessLookupError, PermissionError):
                pass
        try:
            path.unlink()
        except OSError:
            pass
        return reaped

    # -- teardown -----------------------------------------------------------
    def stop(self, timeout: float = 15.0) -> None:
        """SIGTERM every child's process group, escalate to SIGKILL
        on stragglers, stop monitoring.  The gateways (mds, rgw) stop
        first, each wave within ``timeout``: an active MDS flushes its
        cache to the OSDs as it stops, which needs them up."""
        self._stopping = True
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5)
        with self._lock:
            children = list(self.children.values())
        gateways = [c for c in children if c.role.startswith(("mds.", "rgw."))]
        for wave in (gateways, [c for c in children if c not in gateways]):
            self._terminate(wave, timeout)
        if self._msgr is not None:
            try:
                self._msgr.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            self._msgr = None
            self._monc = None
        try:
            (self.spec.dir / SUPERVISOR_STATE).unlink()
        except OSError:
            pass

    @staticmethod
    def _terminate(children: list[_Child], timeout: float) -> None:
        for child in children:
            if child.proc is None or child.proc.poll() is not None:
                continue
            child.state = "stopped"
            try:
                os.killpg(child.proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                continue
        deadline = time.monotonic() + timeout
        for child in children:
            if child.proc is None:
                continue
            remain = max(0.1, deadline - time.monotonic())
            try:
                child.proc.wait(timeout=remain)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(child.proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
                try:
                    child.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            if child.log_fh is not None:
                try:
                    child.log_fh.close()
                except OSError:
                    pass
                child.log_fh = None
