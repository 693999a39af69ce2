"""The port's multi-process runtime held against the JAX package's on
the CPU.

The spec grammar (with the port's ``device`` and ``osd_options`` keys),
the supervisor's backoff schedule, its clean-exit, crash, streak-reset
and crash-loop decisions, its live crash loop and orphan reaping run on
both packages and agree. The port's supervisor spawns the port's daemon
module and adds no JAX setting to a child's environment, and its stop
ends the gateways before the OSDs, which an MDS's final flush needs
(the JAX supervisor's does not: ROADMAP §C). A daemon role
on a CUDA device that the machine lacks fails its boot with the reason
in its log. The mds and rgw roles boot in a process cluster of each
package (a monitor, 2 OSDs, an MDS and a gateway), publish ready
records with the JAX roles' keys, and serve: the MDS is the monitor's
active, the gateway answers S3. Then a real process cluster
of each package (a monitor and 3 OSDs, one OS process each, the port's
on ``device="cpu"``) takes the same writes into a jerasure k=2 m=1 pool
and a 2-replica pool: every write reads back, and after a clean stop
each OSD's stored objects (shard bytes, hinfo and the other xattrs)
are equal across the packages.

Tolerance: exact (bytes, decisions, reports).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import ceph_tpu.proc as jproc
import ceph_tpu.proc.supervisor as jsupervisor
import ceph_tpu.rados as jrados
from ceph_tpu.store.blockstore import BlockStore as JBlockStore
import ceph_tpu_torch.proc as tproc
import ceph_tpu_torch.proc.supervisor as tsupervisor
import ceph_tpu_torch.rados as trados
from ceph_tpu_torch.msg.messenger import wait_for

from conftest import strict_timing

DEADLINE = 30.0 if strict_timing() else 90.0
PKGS = {"torch": (tproc, tsupervisor), "jax": (jproc, jsupervisor)}


# -- spec grammar -------------------------------------------------------------
def test_spec_plan_roundtrip_with_device(tmp_path):
    spec = tproc.ClusterSpec.plan(
        tmp_path / "t", mons=3, osds=4, mgrs=1, memstore=True, wal=True, mon_port=7700,
        device="cpu", osd_options={"heartbeat_grace": 20.0, "max_backfills": 8},
    )
    again = tproc.ClusterSpec.load(spec.save())
    assert again.data == spec.data
    assert again.device == "cpu"
    assert again.data["osd_options"] == {"heartbeat_grace": 20.0, "max_backfills": 8}
    assert tproc.ClusterSpec.plan(tmp_path / "d", mon_port=7700).device == "cuda"
    ref = jproc.ClusterSpec.plan(
        tmp_path / "t", mons=3, osds=4, mgrs=1, memstore=True, wal=True, mon_port=7700,
    )
    mine = dict(spec.data)
    assert (mine.pop("device"), mine.pop("osd_options")) == ("cpu", again.data["osd_options"])
    assert mine == ref.data
    assert spec.roles() == ref.roles()
    with pytest.raises(ValueError):
        tproc.ClusterSpec.plan(tmp_path, mons=0)


@pytest.mark.parametrize("n", range(0, 11))
def test_backoff_schedule_equal(n):
    for base, cap in ((0.5, 30.0), (0.02, 0.1)):
        assert tproc.Supervisor.backoff_delay(n, base, cap) == jproc.Supervisor.backoff_delay(
            n, base, cap
        )


# -- death discrimination (no real processes) --------------------------------
class _FakeProc:
    def __init__(self, pid=4242):
        self.pid = pid

    def poll(self):
        return 0


def _unit(pkg: str, tmp_path, **kw):
    proc, sup_mod = PKGS[pkg]
    spec = proc.ClusterSpec.plan(tmp_path / pkg, mons=1, osds=0, mgrs=0, memstore=True)
    kw.setdefault("report_interval", 3600.0)
    sup = proc.Supervisor(spec, **kw)
    child = sup_mod._Child("test.0", [sys.executable, "-c", "pass"])
    child.proc = _FakeProc()
    child.spawned_at = time.monotonic()
    child.state = "running"
    sup.children["test.0"] = child
    return sup, child


def _decisions(pkg: str, tmp_path) -> list:
    """Clean exit; two short crashes; a crash after a long uptime;
    crashes past the cap. Records each decision."""
    out = []
    sup, child = _unit(pkg, tmp_path, backoff_base=0.5, min_uptime=10.0, crash_loop_cap=3)
    sup._on_death(child, 0)
    out.append((child.state, child.consecutive_crashes, len(sup._crash_outbox)))
    for rc in (-signal.SIGKILL, -signal.SIGSEGV, 1, 1, 1):
        child.state = "running"
        child.spawned_at = time.monotonic()
        t0 = time.monotonic()
        sup._on_death(child, rc)
        delay = round(child.respawn_at - t0, 1) if child.state == "backoff" else None
        report = sup._crash_outbox[-1][0]
        out.append((child.state, child.consecutive_crashes, delay, report["exception"],
                    report["entity_name"], report["meta"]["process_death"]))
    child.state = "running"
    child.consecutive_crashes = 4
    child.spawned_at = time.monotonic() - 60.0
    sup._on_death(child, 1)
    out.append((child.state, child.consecutive_crashes))
    out.append(sup.perf.dump())
    return out


def test_supervisor_decisions_equal(tmp_path):
    mine = _decisions("torch", tmp_path)
    assert mine == _decisions("jax", tmp_path)
    assert mine[0] == ("exited", 0, 0)
    assert [d[0] for d in mine[1:6]] == ["backoff"] * 3 + ["failed", "failed"]
    assert "SIGKILL" in mine[1][3]


def _live(pkg: str, tmp_path, argv: list) -> tuple:
    proc, sup_mod = PKGS[pkg]
    spec = proc.ClusterSpec.plan(tmp_path / pkg, mons=1, osds=0, mgrs=0, memstore=True)
    spec.dir.mkdir()
    sup = proc.Supervisor(spec, report_interval=3600.0, backoff_base=0.02, backoff_max=0.1,
                          crash_loop_cap=2, min_uptime=10.0, poll_interval=0.02)
    child = sup_mod._Child("loop.0", argv)
    sup.children["loop.0"] = child
    sup._spawn(child)
    sup._monitor = threading.Thread(target=sup._monitor_loop, daemon=True)
    sup._monitor.start()
    try:
        assert wait_for(
            lambda: sup.status()["loop.0"]["state"] in ("failed", "exited"), DEADLINE
        ), sup.status()
        st = dict(sup.status()["loop.0"])
        st.pop("pid")
        perf = sup.perf.dump()
        perf.pop("l_proc_children")  # a gauge the monitor loop samples
        return st, perf, sorted(r["exception"] for r, _n in sup._crash_outbox)
    finally:
        sup.stop()


@pytest.mark.parametrize("code", ["import sys; sys.exit(1)", "pass"], ids=["crash_loop", "clean"])
def test_live_children_equal(tmp_path, code):
    argv = [sys.executable, "-c", code]
    mine = _live("torch", tmp_path, argv)
    assert mine == _live("jax", tmp_path, argv)
    if code == "pass":
        assert mine[0]["state"] == "exited" and mine[0]["restarts"] == 0 and mine[2] == []
    else:
        assert mine[0] == {"state": "failed", "restarts": 2, "consecutive_crashes": 3}
        assert mine[1]["l_proc_crash_loops"] == 1


_FLUSHING_MDS = """
import pathlib, signal, sys, time

def alive(pid):
    try:
        return open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False

def term(*_):
    time.sleep(0.5)
    while not alive(int(sys.argv[1])):
        time.sleep(0.1)  # a final flush retrying against a stopped OSD
    sys.exit(0)

signal.signal(signal.SIGTERM, term)
pathlib.Path(sys.argv[2]).touch()
while True:
    time.sleep(0.1)
"""


def test_stop_waits_for_the_gateways_before_the_osds(tmp_path):
    """An MDS needs its OSDs while it stops (the final cache flush), so
    ``stop`` ends the gateways before the OSDs. The JAX supervisor
    signals every child at once, and this stand-in MDS then waits out
    the timeout and is killed (ROADMAP §C)."""
    spec = tproc.ClusterSpec.plan(tmp_path, mons=1, osds=1, mgrs=0, memstore=True)
    spec.dir.mkdir(exist_ok=True)
    sup = tproc.Supervisor(spec, report_interval=3600.0)
    osd = tsupervisor._Child("osd.0", [sys.executable, "-c", "import time; time.sleep(120)"])
    sup.children["osd.0"] = osd
    sup._spawn(osd)
    mark = tmp_path / "mds.armed"
    mds = tsupervisor._Child("mds.0", [sys.executable, "-c", _FLUSHING_MDS, str(osd.pid),
                                       str(mark)])
    sup.children["mds.0"] = mds
    sup._spawn(mds)
    try:
        assert wait_for(mark.exists, DEADLINE)
    finally:
        sup.stop(timeout=5.0)
    assert mds.proc.returncode == 0
    assert osd.proc.returncode == -signal.SIGTERM


def test_reap_orphans_kills_recorded_groups(tmp_path):
    victim = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(120)"], start_new_session=True,
    )
    try:
        (tmp_path / "supervisor.json").write_text(
            json.dumps({"pid": os.getpid(), "children": {"x.0": victim.pid}})
        )
        assert tproc.Supervisor.reap_orphans(tmp_path) == []
        assert victim.poll() is None
        dead = subprocess.Popen([sys.executable, "-c", "pass"])
        dead.wait()
        (tmp_path / "supervisor.json").write_text(
            json.dumps({"pid": dead.pid, "children": {"x.0": victim.pid}})
        )
        assert tproc.Supervisor.reap_orphans(tmp_path) == [victim.pid]
        assert victim.wait(timeout=10) == -signal.SIGKILL
        assert not (tmp_path / "supervisor.json").exists()
        assert tproc.Supervisor.reap_orphans(tmp_path) == []
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.wait()


# -- what a child is given -----------------------------------------------------
def test_child_runs_the_port_daemon_without_jax_settings(tmp_path, monkeypatch):
    spawned = []

    class _Popen:
        def __init__(self, argv, **kw):
            spawned.append((argv, kw["env"]))
            self.pid = 4243

    monkeypatch.setattr(tsupervisor.subprocess, "Popen", _Popen)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    spec = tproc.ClusterSpec.plan(tmp_path, mons=1, osds=1, mgrs=0, memstore=True)
    sup = tproc.Supervisor(spec, extra_env={"CEPH_TPU_RESIDENCY_BYTES": str(256 << 20)})
    child = tsupervisor._Child("osd.0", sup._child_argv("osd.0"))
    sup._spawn(child)
    child.log_fh.close()
    (argv, env), = spawned
    assert argv[1:3] == ["-m", "ceph_tpu_torch.proc.daemon"]
    assert "JAX_PLATFORMS" not in env
    assert env["CEPH_TPU_RESIDENCY_BYTES"] == str(256 << 20)
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(tsupervisor.REPO_ROOT)
    assert (tsupervisor.REPO_ROOT / "ceph_tpu_torch" / "proc" / "daemon.py").exists()


def _boot_role(tmp_path, role: str, device: str) -> tuple[int, str]:
    spec = tproc.ClusterSpec.plan(tmp_path, mons=1, osds=1, mgrs=1, memstore=True, device=device)
    spec.save()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tsupervisor.REPO_ROOT)
    run = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.proc.daemon", "--role", role,
         "--spec", str(spec.dir / "spec.json")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    return run.returncode, run.stderr


@pytest.mark.parametrize("role", ["osd.0", "mgr.0"])
def test_role_on_a_missing_card_fails_its_boot(tmp_path, role):
    """No quiet switch to the CPU: the boot raises before the daemon
    is made, so it needs no monitor."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    rc, err = _boot_role(tmp_path, role, "cuda")
    assert rc == 1
    assert "no usable CUDA card" in err


def _role_fleet(pkg: str, root):
    """A process cluster of ``pkg`` (the port's on ``device="cpu"``): a
    monitor, 2 OSDs, an mds and an rgw. Function-scoped: conftest reaps
    the JAX package's daemon processes after each test."""
    proc, _sup = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    spec = proc.ClusterSpec.plan(root / pkg, mons=1, osds=2, mgrs=0, memstore=True, mds=1,
                                 rgw=1, **kw)
    sup = proc.Supervisor(spec, report_interval=3600.0)
    try:
        sup.start(ready_timeout=DEADLINE)
    except BaseException:
        sup.stop()
        raise
    return spec, sup


def _role_serves(pkg: str, spec, role: str, ready: dict):
    """What the role answers: the MDS map's active address for an mds,
    the status of an S3 bucket create and object PUT and GET for an
    rgw."""
    if role.startswith("mds."):
        rados = trados if pkg == "torch" else jrados
        client = rados.Rados(f"roles-{pkg}").connect_any(spec.mon_addrs)
        try:
            def active():
                rc, outb, _ = client.mon_command({"prefix": "mds stat"})
                return rc == 0 and json.loads(outb).get("actives")

            assert wait_for(active, DEADLINE), "no active mds"
            addrs = [a["addr"] if isinstance(a, dict) else a for a in active().values()]
            return addrs == [ready["addr"]]
        finally:
            client.shutdown()
    import http.client

    codes = []
    for method, path, body in (("PUT", "/roles", b""), ("PUT", "/roles/o", b"x" * 5000),
                               ("GET", "/roles/o", b"")):
        conn = http.client.HTTPConnection("127.0.0.1", ready["port"], timeout=60)
        try:
            conn.request(method, path, body=body or None)
            resp = conn.getresponse()
            codes.append((resp.status, len(resp.read())))
        finally:
            conn.close()
    return codes


# the JAX roles' ready-record keys, and what each role serves
ROLE_RECORDS = {"mds.0": (["addr", "pid", "role"], True),
                "rgw.0": (["pid", "port", "role"], [(200, 0), (200, 0), (200, 5000)])}


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_mds_and_rgw_roles_boot_and_serve(tmp_path, pkg):
    """Each package's fleet boots mds.0 and rgw.0, whose ready records
    carry the same keys and which serve: the MDS as the map's active,
    the gateway a bucket and an object."""
    spec, sup = _role_fleet(pkg, tmp_path)
    try:
        got = {role: _role_record(pkg, spec, sup, role) for role in ROLE_RECORDS}
    finally:
        # the gateways first, while their OSDs are up (the JAX
        # supervisor signals every child at once: ROADMAP §C)
        for role in ROLE_RECORDS:
            if sup.status()[role]["state"] == "running":
                sup.kill(role, signal.SIGTERM, hold=True)
                sup.children[role].proc.wait(timeout=DEADLINE)
        sup.stop()
    assert got == ROLE_RECORDS


def _role_record(pkg: str, spec, sup, role: str) -> tuple:
    """The ready record's keys and what the role serves, after checking
    the record names the live process of the package's daemon module."""
    assert sup.status()[role]["state"] == "running", (
        pkg, (spec.dir / f"{role}.log").read_text()[-3000:])
    ready = json.loads(spec.ready_path(role).read_text())
    assert ready["role"] == role and ready["pid"] == sup.status()[role]["pid"]
    ps = subprocess.run(["ps", "-o", "args=", "-p", str(ready["pid"])],
                        capture_output=True, text=True)
    module = "ceph_tpu_torch.proc.daemon" if pkg == "torch" else "ceph_tpu.proc.daemon"
    assert module in ps.stdout and (pkg == "jax" or "ceph_tpu.proc" not in ps.stdout)
    return sorted(ready), _role_serves(pkg, spec, role, ready)


# -- a real process cluster of each package ---------------------------------------
def _process_cluster(pkg: str, tmp_path) -> tuple[dict, dict]:
    proc, _sup = PKGS[pkg]
    rados = trados if pkg == "torch" else jrados
    kw = {"device": "cpu"} if pkg == "torch" else {}
    spec = proc.ClusterSpec.plan(tmp_path / pkg, mons=1, osds=3, mgrs=0, **kw)
    sup = proc.Supervisor(spec, report_interval=3600.0)
    client = None
    reads = {}
    try:
        sup.start(ready_timeout=DEADLINE)
        st = sup.status()
        assert set(st) == {"mon.0", "osd.0", "osd.1", "osd.2"}
        assert len({c["pid"] for c in st.values()} | {os.getpid()}) == 5
        client = rados.Rados(f"proc-{pkg}").connect_any(spec.mon_addrs)
        client.objecter.op_timeout = DEADLINE
        rc, _b, outs = client.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "p",
            "profile": ["plugin=jerasure", "technique=reed_sol_van", "k=2", "m=1"],
        })
        assert rc == 0, outs
        client.pool_create("ec", pool_type=3, pg_num=4, erasure_code_profile="p", min_size=2)
        client.pool_create("rep", pg_num=4, size=2)
        rng = np.random.default_rng(11)
        writes = [(pool, f"o{i}", rng.bytes(int(rng.integers(1, 70000))))
                  for pool in ("ec", "rep") for i in range(8)]
        for pool, oid, data in writes:
            client.open_ioctx(pool).write_full(oid, data)
        client.open_ioctx("ec").write("o1", b"X" * 5000, 4096)
        for pool, oid, _data in writes:
            reads[(pool, oid)] = client.open_ioctx(pool).read(oid)
    finally:
        if client is not None:
            client.shutdown()
        sup.stop()
    assert not (spec.dir / "supervisor.json").exists()
    stored = {}
    for i in range(3):
        store = JBlockStore(spec.dir / f"osd.{i}", sync=False)
        try:
            for cid in store.list_collections():
                for oid in store.list_objects(cid):
                    if oid.startswith("o_"):
                        stored[(i, cid, oid)] = (store.read(cid, oid), store.list_attrs(cid, oid))
        finally:
            store.close()
    return reads, stored


def test_process_clusters_store_equal_objects(tmp_path):
    reads, stored = _process_cluster("torch", tmp_path)
    ref_reads, ref_stored = _process_cluster("jax", tmp_path)
    assert reads == ref_reads
    assert reads[("ec", "o2")] and len(reads) == 16
    assert sorted(stored) == sorted(ref_stored)
    assert any("hinfo" in "".join(attrs) for _data, attrs in stored.values())
    for key, got in stored.items():
        assert got == ref_stored[key], key
