"""The port's manager held against the JAX package's on the CPU.

A live port cluster (a monitor, 4 OSDs on ``device="cpu"``, a
``Manager(device="cpu")`` and a client) takes writes; the manager
collects the OSDs' perf reports and PG stats, serves ``/metrics`` over
HTTP and pushes its PGMap digest to the monitor. Then one snapshot of
what that manager holds (the map's bytes, the perf dumps, the PG stats)
goes into a port manager and a JAX manager that are not on the network,
each with the status, crash, SLO, pgmap, progress and Prometheus
modules, and the same inputs (crash reports, progress events, SLO
targets): the digest's bytes and its exposition, the rendered
``/metrics`` text, the SLO evaluation, the progress events and the crash
listings are equal. The balancer's plan on one skewed map is the JAX
balancer's, and ``calc_pg_upmaps(device="cpu")``'s on a copy.

Tolerance: exact (bytes and text).
"""

from __future__ import annotations

import copy
import json
import time
import urllib.request

import numpy as np
import pytest

import ceph_tpu.mgr as jmgr_pkg
import ceph_tpu.mgr.pgmap as jpgmap
import ceph_tpu.msg as jmsg
from ceph_tpu.msg.message import MMonCommandReply as JReply
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
import ceph_tpu_torch.mgr as tmgr_pkg
import ceph_tpu_torch.mgr.pgmap as tpgmap
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.crush.builder import CrushMap
from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables
from ceph_tpu_torch.mon.monitor import Monitor
from ceph_tpu_torch.msg import Messenger, NetworkStack
from ceph_tpu_torch.msg.message import MMonCommandReply as TReply
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.osd.balancer import calc_pg_upmaps
from ceph_tpu_torch.osd.daemon import OSD
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.rados import Rados

from conftest import strict_timing

DEADLINE = 30.0 if strict_timing() else 90.0
N = 4
PKGS = {"torch": (tmgr_pkg, tpgmap, OSDMap, TReply), "jax": (jmgr_pkg, jpgmap, JOSDMap, JReply)}
MODULES = ("StatusModule", "CrashModule", "SLOModule", "PgMapModule", "ProgressModule",
           "PrometheusModule")
CRASH = {
    "crash_id": "2026-01-01T00:00:00.000000Z_0123", "entity_name": "osd.3",
    "timestamp": time.time() - 60.0, "process_name": "ceph-osd",
    "backtrace": ["Traceback", "RuntimeError: kernel"], "utsname_hostname": "h",
}
EVENTS = [
    {"id": "scrub pg 1.0 (osd.0)", "message": "scrubbing", "fraction": 0.25, "done": False},
    {"id": "scrub pg 1.0 (osd.0)", "fraction": 0.1},
    {"id": "recovery pg 2.3 (osd.1)", "message": "recovering", "fraction": 0.5, "done": False},
    {"id": "scrub pg 1.0 (osd.0)", "done": True},
]


@pytest.fixture(autouse=True)
def no_live_reactor():
    before = (NetworkStack.live(), jmsg.NetworkStack.live())
    yield
    crash.drain_pending()
    crash.reset_throttle()
    if before == (None, None):
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None, 10.0
        )


def _crush(n: int):
    cmap = CrushMap(tunables=Tunables())
    hosts = [
        cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h], [0x10000], name=f"host{h}")
        for h in range(n)
    ]
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts, [cmap.buckets[b].weight for b in hosts], name="default"
    )
    cmap.add_simple_rule("rep", "default", "host", mode="firstn")
    return cmap


@pytest.fixture(scope="module")
def live():
    """A port cluster with a live port manager, after some writes;
    yields the manager, the client and a snapshot of the manager's
    state."""
    mon_msgr = Messenger("mon")
    mon = Monitor(OSDMap.build(_crush(N), N), min_reporters=2)
    mon_msgr.add_dispatcher(mon)
    addr = mon_msgr.bind()
    osds = []
    mgr = r = None
    try:
        for i in range(N):
            osd = OSD(i, tick_interval=0.2, heartbeat_grace=20.0, device="cpu")
            osd.boot(*addr)
            osds.append(osd)
        mgr = tmgr_pkg.Manager(name="x", device="cpu")
        mgr.start(addr)
        r = Rados("mgr-test").connect(*addr)
        rc, _b, outs = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "p",
            "profile": ["plugin=isa", "k=2", "m=1"],
        })
        assert rc == 0, outs
        r.pool_create("rep", pg_num=32, size=2)
        r.pool_create("ec", pool_type=3, pg_num=4, erasure_code_profile="p")
        rng = np.random.default_rng(3)
        for pool in ("rep", "ec"):
            io = r.open_ioctx(pool)
            for i in range(12):
                io.write_full(f"o{i}", rng.bytes(int(rng.integers(100, 20000))))
        n_pgs = 36

        def reported():
            stats = mgr.get("pg_stats") or {}
            perf = mgr.get("daemon_perf") or {}
            return (
                len(stats) == n_pgs
                and all(st["state"] == "active+clean" for st in stats.values())
                and sum(st["num_objects"] for st in stats.values()) == 24
                and sum(d.startswith("osd.") for d in perf) == N
            )

        assert wait_for(reported, DEADLINE), "the manager never saw every PG clean"
        with mgr._perf_lock, mgr._pg_stats_lock:
            snap = {
                "map": mgr.monc.osdmap.encode(),
                "perf": copy.deepcopy(mgr.daemon_perf),
                "pg_stats": copy.deepcopy(mgr.pg_stats),
            }
        yield mgr, r, snap
    finally:
        if r is not None:
            r.shutdown()
        if mgr is not None:
            mgr.shutdown()
        for osd in osds:
            osd.shutdown()
        mon_msgr.shutdown()


def _mirror(pkg: str, snap: dict, skew: bool = False):
    """A manager of package ``pkg`` holding the snapshot, off the
    network: module commands to the monitor are recorded, answered
    rc 0."""
    mgr_pkg, _pgmap, map_cls, reply_cls = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    mgr = mgr_pkg.Manager(modules=[], name="mirror", **kw)
    mgr.monc.osdmap = map_cls.decode(snap["map"])
    if skew:
        mgr.monc.osdmap.osd_weight[0] = 0x8000
    now = time.time()
    mgr.daemon_perf = {d: (now, dump) for d, (_ts, dump) in copy.deepcopy(snap["perf"]).items()}
    mgr.pg_stats = {o: (now, e, st) for o, (_ts, e, st) in copy.deepcopy(snap["pg_stats"]).items()}
    pushed = []
    for name in MODULES + ("BalancerModule",):
        mod = getattr(mgr_pkg, name)(mgr)
        mod.mon_command = lambda cmd, timeout=2.0: pushed.append(cmd) or reply_cls(rc=0)
        mgr.modules[mod.NAME] = mod
    return mgr, pushed


def _close(mgr) -> None:
    for mod in mgr.modules.values():
        mod.shutdown()
    mgr.messenger.shutdown()


def _feed(mgr) -> None:
    mgr.set_module_option("slo", "targets", "client_p99_ms=10@99")
    mgr._crash_inbox.append(copy.deepcopy(CRASH))
    mgr.modules["crash"].ingest_pending()
    for ev in EVENTS:
        mgr._progress_inbox.append(dict(ev))
        mgr.modules["progress"]._drain_inbox()
    mgr.modules["slo"].serve()
    mgr.modules["pgmap"].serve()


@pytest.fixture(scope="module")
def mirrors(live):
    _mgr, _r, snap = live
    made = {pkg: _mirror(pkg, snap) for pkg in PKGS}
    try:
        for mgr, _pushed in made.values():
            _feed(mgr)
        yield made
    finally:
        for mgr, _pushed in made.values():
            _close(mgr)


def test_live_manager_serves_metrics_and_pushes_digest(live):
    mgr, r, _snap = live
    url = f"http://127.0.0.1:{mgr.modules['prometheus'].port}/metrics"

    def scrape() -> str:
        return urllib.request.urlopen(url, timeout=10).read().decode()

    assert wait_for(lambda: 'ceph_pg_state{state="active+clean"} 36' in scrape(), DEADLINE)
    body = scrape()
    assert f"ceph_num_up_osds {N}" in body
    for i in range(N):
        assert f'ceph_osd_up{{ceph_daemon="osd.{i}"}} 1' in body
    assert "# TYPE ceph_pg_state gauge" in body

    def pushed():
        rc, outb, _outs = r.mon_command({"prefix": "status"})
        return rc == 0 and json.loads(outb).get("pgmap", {}).get("num_pgs") == 36

    assert wait_for(pushed, DEADLINE), "the digest never reached the monitor"


def test_pgmap_digest_bytes_and_exposition_equal(mirrors):
    (tm, _tp), (jm, _jp) = mirrors["torch"], mirrors["jax"]
    mine, ref = tm.modules["pgmap"].digest, jm.modules["pgmap"].digest
    assert mine["num_pgs"] == 36 and mine["totals"]["objects"] == 24
    assert tpgmap.encode_pgmap_digest(mine) == jpgmap.encode_pgmap_digest(ref)
    assert tpgmap.pgmap_exposition_lines(mine) == jpgmap.pgmap_exposition_lines(ref)
    blob = tpgmap.encode_pgmap_digest(mine)
    assert tpgmap.encode_pgmap_digest(jpgmap.decode_pgmap_digest(blob)) == blob


def test_metrics_text_equal(mirrors):
    (tm, _tp), (jm, _jp) = mirrors["torch"], mirrors["jax"]
    mine, ref = tm.modules["prometheus"].render(), jm.modules["prometheus"].render()
    families = {line.split()[2] for line in mine.splitlines() if line.startswith("# TYPE")}
    assert {"ceph_osd_up", "ceph_pg_total", "ceph_pg_state", "ceph_daemon_op"} <= families
    assert mine == ref


def test_status_health_equal(mirrors):
    (tm, _tp), (jm, _jp) = mirrors["torch"], mirrors["jax"]
    assert tm.modules["status"].health() == jm.modules["status"].health()
    assert tm.get("osd_stats") == jm.get("osd_stats")
    assert tm.get("pg_summary") == jm.get("pg_summary")
    assert tm.get("df") == jm.get("df")


def test_slo_evaluation_equal(mirrors):
    (tm, tp), (jm, jp) = mirrors["torch"], mirrors["jax"]
    mine, ref = tm.modules["slo"].last_status, jm.modules["slo"].last_status
    assert mine["classes"]["client"]["count"] > 0
    for st in (mine, ref):
        st.pop("evaluated_at", None)
    assert mine == ref
    assert [c for c in tp if c["prefix"] != "pgmap report"] == [
        c for c in jp if c["prefix"] != "pgmap report"
    ]


def test_progress_events_equal(mirrors):
    (tm, _tp), (jm, _jp) = mirrors["torch"], mirrors["jax"]

    def events(mgr):
        return [
            {k: v for k, v in ev.items() if k not in ("started", "updated", "done_at")}
            for ev in mgr.modules["progress"].active_events()
        ]

    assert events(tm) == events(jm)
    assert len(events(tm)) == 2
    assert any(ev["done"] and ev["fraction"] == 1.0 for ev in events(tm))


@pytest.mark.parametrize("prefix", ["crash ls", "crash stat", "crash info"])
def test_crash_module_replies_equal(mirrors, prefix):
    (tm, _tp), (jm, _jp) = mirrors["torch"], mirrors["jax"]
    cmd = {"prefix": prefix}
    if prefix == "crash info":
        cmd["id"] = CRASH["crash_id"]
    mine = tm.modules["crash"].handle_command(cmd)
    ref = jm.modules["crash"].handle_command(cmd)
    assert (mine.rc, mine.outs, mine.outb) == (ref.rc, ref.outs, ref.outb)
    assert mine.rc == 0


def test_balancer_plan_equal(live):
    """osd.0 reweighted to 0.5 on both packages' copies of the map."""
    _mgr, _r, snap = live
    made = {pkg: _mirror(pkg, snap, skew=True) for pkg in PKGS}
    try:
        for mgr, _pushed in made.values():
            mgr.set_module_option("balancer", "active", True)
            mgr.set_module_option("balancer", "max_optimizations", 8)
            mgr.modules["balancer"].serve()
        (tm, tp), (jm, jp) = made["torch"], made["jax"]
        plan = tm.modules["balancer"].last_plan
        assert plan, "no plan on the skewed map"
        assert plan == jm.modules["balancer"].last_plan
        assert tp == jp
        assert tm.modules["balancer"].plans_applied == len(plan)
        om = OSDMap.decode(snap["map"])
        om.osd_weight[0] = 0x8000
        before = dict(om.pg_upmap_items)
        calc_pg_upmaps(om, max_deviation=1, max_changes=8, device="cpu")
        direct = {
            f"{pid}.{ps}": items for (pid, ps), items in om.pg_upmap_items.items()
            if before.get((pid, ps)) != items
        }
        assert direct == plan
    finally:
        for mgr, _pushed in made.values():
            _close(mgr)


def test_balancer_commands_through_the_manager(live):
    """``balancer on|off|status`` (the port's addition, routed to the
    active manager by the CLI) turn the live manager's balancer on and
    off and list each applied plan with its map epoch."""
    mgr, _r, _snap = live
    bal = mgr.modules["balancer"]
    assert mgr.handle_command(json.dumps({"prefix": "balancer on"})).rc == 0
    assert bal.get_module_option("active") is True
    status = json.loads(mgr.handle_command(json.dumps({"prefix": "balancer status"})).outb)
    assert status["active"] is True and status["plans_applied"] == bal.plans_applied
    assert all(set(p) == {"epoch", "plan"} for p in status["plans"])
    assert mgr.handle_command(json.dumps({"prefix": "balancer off"})).rc == 0
    assert json.loads(mgr.handle_command(json.dumps({"prefix": "balancer status"})).outb)[
        "active"] is False
    assert mgr.handle_command(json.dumps({"prefix": "balancer bogus"})).rc == -22
