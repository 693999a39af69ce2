"""Faults of the JAX OSD daemon that the port's daemon does not copy,
each with its smallest input, on the CPU (ROADMAP §C).

1. A second activation of one interval removes the objects recovery
   pushed in between: ``_apply_activate`` treats every entry past the
   rewind point as divergent, even one the authoritative suffix carries
   too, and an object born after the rewind point (no prior version) is
   never pulled back. The port keeps entries the suffix carries.
2. When an OSD moves to another position of an erasure PG's acting set,
   the shards it holds are the old position's but carry the same object
   names; after an overwrite (RMW) has dropped the HashInfo hashes,
   recovery reads them as survivors of the new position and rebuilds
   wrong bytes. The port empties a moved member's copy so it is
   backfilled like a new one.
3. The tick queues a strict re-peer walk on every tick while any
   primary PG is unpeered, including one whose recovery is running,
   and each walk re-peers it; the walks starve the recovery pushes. The
   port skips recovering PGs and queues one walk at a time.
4. A primary PG whose last peering left a peer unrecovered (or whose
   replica missed a write) reports ``active+clean`` until the tick
   re-peers it, so a wait for "clean" can end before recovery has run.
   The port reports it as ``active+recovery_wait``.
5. A rebuilt erasure shard (a recovery push, a scrub repair) is written
   without the object's birth-snap stamp, so on a rebuilt primary a
   read at a snap older than the object finds it. The port's rebuilt
   shards carry the stamp, and such a read gives -ENOENT.
6. A replica NAKs a rep-op that reaches it while the primary's
   activation, sent first on the same connection, still waits on its
   worker. On a new erasure pool a write then lands on fewer than k
   positions, the client's resend is answered from the primary's reqid
   cache as done, and the object cannot be read. The port applies such
   a rep-op after the activation, in order.
8. A write that an up acting member failed enters the primary's reqid
   cache before the sub-writes fan out. The client gets -EAGAIN and
   resends, and the resend is answered "done" from the cache while the
   member still lacks the write: on an erasure PG a write on fewer
   than k positions is acknowledged. The port keeps such a reqid
   pending and answers its resends -EAGAIN until a peering pass has
   brought the write to every up acting member.
7. (A fault of the port's own repair of 2.) The primary's query at the
   map that moved an OSD's erasure position can arrive before that OSD
   has walked the map; answering from the copy it still holds passes the
   old position's log off as the new one's, the primary skips the
   backfill, and the walk then drops the copy: reads after "clean" find
   too few shards. The port drops the moved copy before it answers.

Tolerance: exact (object bytes, queued work items, state strings).
"""

from __future__ import annotations

import copy
import json
import time

import numpy as np
import pytest

import ceph_tpu.msg as jmsg
import ceph_tpu.osd.daemon as jdaemon
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
from ceph_tpu.osd.osdmap import PgPool as JPgPool
import ceph_tpu_torch.osd.daemon as tdaemon
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.common.log import log as dout_log
from ceph_tpu_torch.crush.builder import CrushMap
from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables
from ceph_tpu_torch.mon.monitor import Monitor
from ceph_tpu_torch.msg import Messenger, NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.osd.osdmap import OSDMap, PgPool
from ceph_tpu_torch.rados import Rados
from ceph_tpu_torch.store import Transaction

from conftest import strict_timing

DEADLINE = 45.0 if strict_timing() else 120.0


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


def _crush(n: int, crush_cls=None):
    crush_cls = crush_cls or CrushMap
    cmap = crush_cls(tunables=Tunables())
    hosts = [
        cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h], [0x10000], name=f"host{h}")
        for h in range(n)
    ]
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts, [cmap.buckets[b].weight for b in hosts], name="default"
    )
    cmap.add_simple_rule("rep", "default", "host", mode="firstn")
    return cmap


class _Conn:
    """Stands in for the primary's connection: takes the activation's
    reply, serves no pulls."""

    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)

    def call(self, msg, timeout=None):
        raise OSError("no pulls in this test")


def _activate_twice(daemon, map_cls, pool_cls, crush_cls, txn_cls, **kw):
    """A replica holds object "a", written at (5, 3) after the rewind
    point (4, 2); the primary's activation carries that same entry and
    arrives twice."""
    osd = daemon.OSD(0, **kw)
    try:
        om = map_cls.build(_crush(3, crush_cls), 3)
        om.add_pool(pool_cls(pool_id=1, size=3, pg_num=1, crush_rule=0))
        osd.monc.osdmap = om
        pg = osd._get_or_create_pg("1.0")
        entry = daemon.LogEntry(op=daemon.MODIFY, oid="a", version=(5, 3))
        oid = daemon.OBJ_PREFIX + "a"
        osd.store.queue_transaction(txn_cls().touch(pg.cid, oid).write(pg.cid, oid, 0, b"pushed"))
        pg.log.append(entry)
        osd._persist_entry(pg, entry)
        info = daemon.PGInfo(pgid="1.0", last_update=(5, 3))
        msg = daemon.MPGActivate(
            pgid="1.0", epoch=5, info_blob=daemon._encode_info(info), rewind_to=(4, 2),
            entry_blobs=[daemon._encode_entry(entry)],
        )
        conn = _Conn()
        for _ in range(2):
            osd._apply_activate(conn, msg)
        return osd.store.exists(pg.cid, oid), pg.log.head, len(conn.sent)
    finally:
        osd.messenger.shutdown()


def test_repeated_activation_keeps_recovered_objects():
    from ceph_tpu.crush.builder import CrushMap as JCrushMap
    from ceph_tpu.store.objectstore import Transaction as JTransaction

    mine = _activate_twice(tdaemon, OSDMap, PgPool, CrushMap, Transaction, device="cpu")
    assert mine == (True, (5, 3), 2)
    # the reference removes the object it had been pushed
    ref = _activate_twice(jdaemon, JOSDMap, JPgPool, JCrushMap, JTransaction)
    assert ref == (False, (5, 3), 2)


def test_moved_shard_is_backfilled_not_read_as_a_survivor():
    """7 OSDs, isa k=3 m=2: marking osd.3 out moves osd.1 from position
    4 to position 1 of PG 1.13. Objects overwritten in place (RMW, no
    HashInfo hashes) read back equal after the recovery."""
    n = 7
    mon_msgr = Messenger("mon")
    mon_msgr.add_dispatcher(Monitor(OSDMap.build(_crush(n), n), min_reporters=2))
    addr = mon_msgr.bind()
    osds = {}
    r = None
    try:
        for i in range(n):
            osds[i] = tdaemon.OSD(i, tick_interval=0.5, heartbeat_grace=20.0, device="cpu")
            osds[i].boot(*addr)
        r = Rados("faults").connect(*addr)
        rc, _b, outs = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "p",
            "profile": ["plugin=isa", "k=3", "m=2"],
        })
        assert rc == 0, outs
        r.pool_create("rep", pg_num=16, size=3)
        pool_id = r.pool_create("ec", pool_type=3, pg_num=16, erasure_code_profile="p")
        io = r.open_ioctx("ec")
        rng = np.random.default_rng(1)
        model = {f"o{i}": rng.bytes(65536) for i in range(48)}
        for f in [io.aio_write_full(k, v) for k, v in model.items()]:
            f.result(timeout=DEADLINE)
        for name in list(model)[::3]:
            patch = rng.bytes(8292)
            io.write(name, patch, 3 * 4096)
            buf = bytearray(model[name])
            buf[3 * 4096:3 * 4096 + len(patch)] = patch
            model[name] = bytes(buf)
        before = r.monc.osdmap.pg_to_up_acting_osds(pool_id, 13)[2]
        osds.pop(3).shutdown()
        for cmd in ({"prefix": "osd down", "id": 3}, {"prefix": "osd out", "id": 3}):
            rc, _b, outs = r.mon_command(cmd)
            assert rc == 0, outs
        def moved():
            after = r.monc.osdmap.pg_to_up_acting_osds(pool_id, 13)[2]
            return 3 not in after and 1 in after and before.index(1) != after.index(1)

        assert wait_for(moved, DEADLINE), before

        def clean():
            states = [st["state"] for o in osds.values() for st in o.collect_pg_stats()]
            return len(states) == 32 and all(s == "active+clean" for s in states)

        assert wait_for(clean, DEADLINE), "recovery never reached active+clean"
        for name, data in model.items():
            assert io.read(name) == data, name
        assert any(
            "shard position moved" in e["message"] for e in dout_log().dump_recent("osd")
        )
    finally:
        if r is not None:
            r.shutdown()
        for osd in osds.values():
            osd.shutdown()
        mon_msgr.shutdown()


def _primary_with_pgs(daemon, map_cls, pool_cls, crush_cls, **kw):
    """An OSD (not booted) that leads two PGs of a 3-OSD replicated
    pool, both peered; returns it and the two PGs."""
    osd = daemon.OSD(0, **kw)
    # no monitor here: the scrub health report would wait out its
    # command timeout on every first tick
    osd.scrubber.maybe_report = lambda now: None
    om = map_cls.build(_crush(3, crush_cls), 3)
    om.add_pool(pool_cls(pool_id=1, size=3, pg_num=16, crush_rule=0))
    osd.monc.osdmap = om
    led = []
    for ps in range(16):
        _u, _p, acting, primary = om.pg_to_up_acting_osds(1, ps)
        pg = osd._get_or_create_pg(f"1.{ps}")
        pg.acting, pg.primary = acting, primary
        pg.current_interval = pg.peered_interval = (tuple(acting), primary)
        pg.state = "active" if primary == 0 else "replica"
        if primary == 0:
            led.append(pg)
    assert len(led) >= 2
    return osd, led[0], led[1]


def _ticks_then_walks(daemon, map_cls, pool_cls, crush_cls, unpeered_idle: bool, **kw):
    """Three ticks with one primary PG unpeered while its recovery
    runs (and, with ``unpeered_idle``, a second one unpeered and not
    recovering); then every queued work item is served. Returns the
    re-peer walks queued and the PGs those walks re-peered."""
    osd, recovering, idle = _primary_with_pgs(daemon, map_cls, pool_cls, crush_cls, **kw)
    try:
        recovering.peered_interval = None
        op = daemon._RecoveryOp(
            pg=recovering, epoch=1, osd=1, since=(0, 0), conn=_Conn(), remaining={"a"},
        )
        osd._recovering[(recovering.pgid, 1)] = op
        if unpeered_idle:
            idle.peered_interval = None
        for _ in range(3):
            osd._tick()
        items = []
        while osd._workq.qlen():
            items.append(osd._workq.get(timeout=1.0))
        walks = [it for it in items if isinstance(it, tuple) and it[0] == "map"]
        peered = []
        osd._peer = lambda pg, epoch: peered.append(pg.pgid) or True
        for _map, epoch in walks:
            osd._walk_pgs(epoch)
        return len(walks), peered, recovering.pgid, idle.pgid
    finally:
        osd.messenger.shutdown()


@pytest.mark.parametrize("unpeered_idle", [False, True])
def test_tick_queues_one_walk_and_leaves_recovering_pg(unpeered_idle):
    """Fault 3: with only the recovering PG unpeered, the port's ticks
    queue no walk, so it is not re-peered; with another PG unpeered,
    three ticks queue one walk. The reference queues a walk every tick,
    each re-peering the recovering PG."""
    from ceph_tpu.crush.builder import CrushMap as JCrushMap

    walks, peered, rec, idle = _ticks_then_walks(
        tdaemon, OSDMap, PgPool, CrushMap, unpeered_idle, device="cpu"
    )
    if unpeered_idle:
        assert walks == 1
        assert idle in peered
    else:
        assert walks == 0 and peered == []
    ref_walks, ref_peered, rec, _idle = _ticks_then_walks(
        jdaemon, JOSDMap, JPgPool, JCrushMap, unpeered_idle
    )
    assert ref_walks == 3 and rec in ref_peered


def _unpeered_state(daemon, map_cls, pool_cls, crush_cls, **kw):
    osd, pg, _other = _primary_with_pgs(daemon, map_cls, pool_cls, crush_cls, **kw)
    try:
        pg.peered_interval = None
        return {st["pgid"]: st["state"] for st in osd.collect_pg_stats()}[pg.pgid]
    finally:
        osd.messenger.shutdown()


def test_unpeered_primary_pg_is_not_reported_clean():
    """Fault 4: the primary's PG is active with every member up, but
    its last peering pass failed a peer's recovery."""
    from ceph_tpu.crush.builder import CrushMap as JCrushMap

    assert _unpeered_state(tdaemon, OSDMap, PgPool, CrushMap, device="cpu") == (
        "active+recovery_wait"
    )
    assert _unpeered_state(jdaemon, JOSDMap, JPgPool, JCrushMap) == "active+clean"


class _SnapCluster:
    """A monitor, 4 OSDs on the CPU and a client; an isa k=2 m=1 pool
    with one snapshot taken before "late" was written."""

    def __init__(self):
        self.mon_msgr = Messenger("mon")
        self.mon_msgr.add_dispatcher(Monitor(OSDMap.build(_crush(4), 4), min_reporters=2))
        self.addr = self.mon_msgr.bind()
        self.osds, self.stores = {}, {}
        for i in range(4):
            self.start(i)
        self.r = Rados("snaps").connect(*self.addr)
        self.r.objecter.op_timeout = 60.0
        rc, _b, outs = self.r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "p",
            "profile": ["plugin=isa", "k=2", "m=1"],
        })
        assert rc == 0, outs
        self.pool_id = self.r.pool_create("ec", pool_type=3, pg_num=4, erasure_code_profile="p",
                                          min_size=2)
        self.io = self.r.open_ioctx("ec")
        self.io.write_full("early", b"e" * 9000)
        self.snap = self.io.snap_create("s1")

    def start(self, i: int):
        osd = tdaemon.OSD(i, store=self.stores.get(i), tick_interval=0.2,
                          heartbeat_grace=20.0, device="cpu")
        osd.boot(*self.addr)
        self.osds[i], self.stores[i] = osd, osd.store

    def primary_of(self, oid: str):
        from ceph_tpu_torch.osdc.objecter import object_to_pg

        pgid = object_to_pg(self.r.monc.osdmap.pools[self.pool_id], oid)
        _u, _p, acting, primary = self.r.monc.osdmap.pg_to_up_acting_osds(
            self.pool_id, int(pgid.split(".")[1])
        )
        return pgid, primary, acting

    def clean(self) -> bool:
        states = [st["state"] for o in self.osds.values() for st in o.collect_pg_stats()]
        return len(states) == 4 and all(s == "active+clean" for s in states)

    def shutdown(self):
        self.r.shutdown()
        for osd in self.osds.values():
            osd.shutdown()
        self.mon_msgr.shutdown()


def _rebuild_by_repair(c: _SnapCluster, data: bytes) -> None:
    c.io.write_full("late", data)
    pgid, primary, _acting = c.primary_of("late")
    osd = c.osds[primary]
    pg = osd.pgs[pgid]
    oid = tdaemon.OBJ_PREFIX + "late"
    good = osd.store.read(pg.cid, oid)
    osd.store.queue_transaction(Transaction().write(pg.cid, oid, 0, bytes([good[0] ^ 1])))
    stamp = pg.last_deep_scrub
    assert "deep-scrub" in c.r.pg_scrub(pgid, deep=True)
    assert wait_for(lambda: pg.last_deep_scrub != stamp, DEADLINE)
    assert [r["object"]["name"] for r in c.r.list_inconsistent_obj(pgid)] == ["late"]
    assert "repair" in c.r.pg_repair(pgid)
    assert wait_for(lambda: osd.store.read(pg.cid, oid) == good, DEADLINE)


def _rebuild_by_recovery(c: _SnapCluster, data: bytes) -> None:
    _pgid, primary, _acting = c.primary_of("late")
    c.osds.pop(primary).shutdown()
    rc, _b, outs = c.r.mon_command({"prefix": "osd down", "id": primary})
    assert rc == 0, outs
    c.io.write_full("late", data)
    c.start(primary)
    assert wait_for(c.clean, DEADLINE), "recovery never reached active+clean"
    pgid, again, _acting = c.primary_of("late")
    assert again == primary
    assert c.stores[primary].exists(f"pg_{pgid}", tdaemon.OBJ_PREFIX + "late")


@pytest.mark.parametrize("rebuild", [_rebuild_by_repair, _rebuild_by_recovery],
                         ids=["scrub_repair", "recovery_push"])
def test_snap_read_on_rebuilt_primary_gives_enoent(rebuild):
    """Fault 5: the primary's shard of "late", born after snapshot s1,
    is rebuilt; a read at s1 must not find it, and the head reads
    back whole."""
    c = _SnapCluster()
    try:
        assert wait_for(c.clean, DEADLINE), "the pool never went active+clean"
        data = bytes(range(256)) * 70
        rebuild(c, data)
        pgid, primary, _acting = c.primary_of("late")
        born = c.stores[primary].getattr(f"pg_{pgid}", tdaemon.OBJ_PREFIX + "late",
                                         tdaemon.BORN_ATTR)
        assert int(born) == c.snap
        c.io.snap_set_read("s1")
        with pytest.raises(Exception, match="ENOENT"):
            c.io.read("late")
        assert c.io.read("early") == b"e" * 9000
        c.io.snap_set_read(0)
        assert c.io.read("late") == data
    finally:
        c.shutdown()


def test_query_ahead_of_the_walk_answers_for_the_moved_position():
    """7 OSDs, isa k=3 m=2, pools "rep" then "ec": marking osd.3 out
    moves osd.1 from position 4 to position 1 of PG 1.13 (primary
    osd.4). osd.1 holds an object and its log entry from position 4 and
    has the new map but has not walked it when the primary's query
    comes: the answer carries no log, the old copy is gone, and a later
    check of the same move drops nothing pushed since."""
    mon = Monitor(OSDMap.build(_crush(7), 7), min_reporters=2)
    for cmd in (
        {"prefix": "osd erasure-code-profile set", "name": "p",
         "profile": ["plugin=isa", "k=3", "m=2"]},
        {"prefix": "osd pool create", "pool": "rep", "pg_num": 16, "size": 3},
        {"prefix": "osd pool create", "pool": "ec", "pool_type": 3, "pg_num": 16,
         "erasure_code_profile": "p"},
    ):
        assert mon.handle_command(json.dumps(cmd)).rc == 0
    before = copy.deepcopy(mon.osdmap)
    assert mon.handle_command(json.dumps({"prefix": "osd out", "id": 3})).rc == 0
    after = mon.osdmap
    old_acting, old_primary = before.pg_to_up_acting_osds(1, 13)[2:]
    acting, primary = after.pg_to_up_acting_osds(1, 13)[2:]
    assert (old_acting.index(1), acting.index(1), primary) == (4, 1, 4)

    osd = tdaemon.OSD(1, device="cpu")
    try:
        osd.monc.osdmap = before
        pg = osd._get_or_create_pg("1.13")
        pg.acting, pg.primary = old_acting, old_primary
        pg.current_interval = pg.peered_interval = (tuple(old_acting), old_primary)
        pg.state = "replica"
        oid = tdaemon.OBJ_PREFIX + "a"
        osd.store.queue_transaction(Transaction().touch(pg.cid, oid).write(pg.cid, oid, 0, b"p4"))
        entry = tdaemon.LogEntry(op=tdaemon.MODIFY, oid="a", version=(4, 1))
        pg.log.append(entry)
        osd._persist_entry(pg, entry)

        osd.monc.osdmap = after
        conn = _Conn()
        osd._handle_query(conn, tdaemon.MPGQuery(pgid="1.13", epoch=after.epoch))
        (notify,) = conn.sent
        assert notify.entry_blobs == []
        assert not osd.store.exists(pg.cid, oid)
        fresh = osd.pgs["1.13"]
        assert fresh is not pg and fresh.current_interval == (tuple(acting), primary)

        # the primary's backfill lands; the walk's check drops nothing
        pushed = tdaemon.OBJ_PREFIX + "b"
        osd.store.queue_transaction(
            Transaction().touch(fresh.cid, pushed).write(fresh.cid, pushed, 0, b"p1")
        )
        assert osd._drop_if_moved(fresh, acting, primary) is fresh
        assert osd.store.exists(fresh.cid, pushed)
    finally:
        osd.messenger.shutdown()


def _rep_op_behind_activation(daemon, map_cls, pool_cls, crush_cls, txn_cls, **kw):
    """A replica of PG 1.0 (3 OSDs, size 3) gets the primary's
    activation, then a rep-op writing object "a", before its worker has
    run; then the worker drains. Returns the rep-op reply's ``ok`` and
    whether "a" is stored."""
    om = map_cls.build(_crush(3, crush_cls), 3)
    om.add_pool(pool_cls(pool_id=1, size=3, pg_num=1, crush_rule=0))
    acting = om.pg_to_up_acting_osds(1, 0)[2]
    osd = daemon.OSD(acting[1], **kw)
    try:
        osd.monc.osdmap = om
        cid = daemon.PG("1.0", 1).cid
        oid = daemon.OBJ_PREFIX + "a"
        entry = daemon.LogEntry(op=daemon.MODIFY, oid="a", version=(5, 1))
        conn = _Conn()
        osd.ms_dispatch(conn, daemon.MPGActivate(
            tid=3, pgid="1.0", epoch=5, info_blob=daemon._encode_info(daemon.PGInfo(pgid="1.0")),
            rewind_to=(0, 0), entry_blobs=[],
        ))
        osd.ms_dispatch(conn, daemon.MOSDRepOp(
            tid=5, pgid="1.0", epoch=5, txn=txn_cls().touch(cid, oid).write(cid, oid, 0, b"x"),
            entry_blob=daemon._encode_entry(entry),
        ))
        while True:
            item = osd._workq.get(timeout=0.5)
            if item is None:
                break
            osd._process_work_item(item)
            if osd._workq.qlen() == 0:
                break
        (reply,) = [m for m in conn.sent if m.tid == 5]
        return reply.ok, osd.store.exists(cid, oid)
    finally:
        osd.messenger.shutdown()


def test_rep_op_behind_a_queued_activation_is_applied_in_order():
    from ceph_tpu.crush.builder import CrushMap as JCrushMap
    from ceph_tpu.store.objectstore import Transaction as JTransaction

    mine = _rep_op_behind_activation(tdaemon, OSDMap, PgPool, CrushMap, Transaction, device="cpu")
    assert mine == (True, True)
    # the reference NAKs it, and the write is not on this replica
    ref = _rep_op_behind_activation(jdaemon, JOSDMap, JPgPool, JCrushMap, JTransaction)
    assert ref == (False, False)


class _ThreeOSDs:
    """A monitor, 3 OSDs on the CPU and a client; one pool of one PG
    over all three."""

    def __init__(self, ec: bool):
        self.mon_msgr = Messenger("mon")
        self.mon_msgr.add_dispatcher(Monitor(OSDMap.build(_crush(3), 3), min_reporters=2))
        self.addr = self.mon_msgr.bind()
        self.osds = {}
        for i in range(3):
            osd = tdaemon.OSD(i, tick_interval=0.2, heartbeat_grace=20.0, device="cpu")
            osd.boot(*self.addr)
            self.osds[i] = osd
        self.r = Rados("reqid").connect(*self.addr)
        if ec:
            rc, _b, outs = self.r.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "p",
                "profile": ["plugin=isa", "k=2", "m=1"],
            })
            assert rc == 0, outs
            self.pool_id = self.r.pool_create("p", pool_type=3, pg_num=1,
                                              erasure_code_profile="p", min_size=2)
        else:
            self.pool_id = self.r.pool_create("p", pg_num=1, size=3)
        self.pgid = f"{self.pool_id}.0"

    def clean(self) -> bool:
        states = [st["state"] for o in self.osds.values() for st in o.collect_pg_stats()
                  if st["pgid"] == self.pgid]
        return states == ["active+clean"]

    def shutdown(self):
        self.r.shutdown()
        for osd in self.osds.values():
            osd.shutdown()
        self.mon_msgr.shutdown()


def _holdings(c: _ThreeOSDs, acting: list, oid: str) -> list:
    cid = f"pg_{c.pgid}"
    return [
        c.osds[o].store.read(cid, oid) if c.osds[o].store.exists(cid, oid) else None
        for o in acting
    ]


DATA = bytes(range(256)) * 96
REQID = "client.9:1"


def _nak_at_position_1(c: _ThreeOSDs, data: bytes):
    """Once the PG is clean, leave the replica at acting position 1
    unactivated with no activation queued, so it NAKs rep-ops. Returns
    the primary, the acting set and a function that runs one attempt
    of a WRITEFULL of ``data`` under one reqid on the primary's worker
    and gives its result and what each acting member holds."""
    from ceph_tpu_torch.msg.message import MOSDOp, OSD_OP_WRITEFULL

    assert wait_for(c.clean, DEADLINE), "the pool never went active+clean"
    osdmap = c.r.monc.osdmap
    _u, _p, acting, primary = osdmap.pg_to_up_acting_osds(c.pool_id, 0)
    p = c.osds[primary]
    replica = c.osds[acting[1]]
    assert replica.whoami != primary
    # the primary's fire-and-forget activation of its last peering
    # has reached the replica and none waits on its worker; only then
    # is the PG left unactivated, on the replica's worker
    assert wait_for(
        lambda: replica.pgs[c.pgid].activated_epoch == p.pgs[c.pgid].activated_epoch > 0
        and not replica._activations_queued.get(c.pgid), DEADLINE
    ), "the replica never took the primary's activation"
    rpg = replica.pgs[c.pgid]
    replica._on_worker(lambda: setattr(rpg, "activated_epoch", 0))

    oid = tdaemon.OBJ_PREFIX + "a"
    msg = MOSDOp(pool=c.pool_id, pgid=c.pgid, oid="a", op=OSD_OP_WRITEFULL, data=data,
                 length=len(data), reqid=REQID, epoch=osdmap.epoch)

    def attempt():
        pg = p.pgs[c.pgid]
        try:
            got = ("done", p._mutate(pg, p.monc.osdmap.epoch, msg, oid))
        except tdaemon.StoreError as e:
            got = ("error", str(e))
        return got, _holdings(c, acting, oid)

    return p, acting, attempt


@pytest.mark.parametrize("ec", [False, True], ids=["replicated_size3", "isa_k2m1"])
def test_resend_of_a_write_a_replica_failed_is_not_acked_early(ec):
    """Fault 8: the replica at acting position 1 is left unactivated
    with no activation queued, so it NAKs the rep-op. The first attempt
    gets -EAGAIN; a resend before the re-peer is not answered as done;
    when a resend is answered as done, every acting member holds the
    write (the object's bytes, or on the erasure PG each position's
    shard)."""
    from ceph_tpu_torch.osd.ec_pg import ECCodec

    c = _ThreeOSDs(ec)
    try:
        p, acting, attempt = _nak_at_position_1(c, DATA)

        # the first attempt and a resend, with no work item between them
        (first, _h1), (resend, _h2) = p._on_worker(lambda: (attempt(), attempt()))
        assert first[0] == "error" and "EAGAIN" in first[1], first
        assert resend[0] == "error" and "EAGAIN" in resend[1], resend

        deadline = time.monotonic() + DEADLINE
        while True:
            got, held = p._on_worker(attempt)
            if got[0] == "done":
                break
            assert "EAGAIN" in got[1], got
            assert time.monotonic() < deadline, "the resend was never answered"
            time.sleep(0.2)
        assert got == ("done", b"")
        if ec:
            codec = ECCodec({"plugin": "isa", "k": "2", "m": "1", "device": "cpu"})
            shards, _meta = codec.encode_object(DATA)
            assert held == [bytes(shards[pos]) for pos in range(3)]
        else:
            assert held == [DATA] * 3
        assert c.r.open_ioctx("p").read("a") == DATA
    finally:
        c.shutdown()


@pytest.mark.parametrize("ec", [False, True], ids=["replicated_size3", "isa_k2m1"])
def test_pending_write_a_rewind_dropped_is_applied_anew(ec):
    """A write an up member failed stays pending on the primary; if an
    activation then rewinds it out of the primary's log, its resend is
    a new op: it is neither answered from the pending entry nor held
    back as pending, and it lands in the log again."""
    c = _ThreeOSDs(ec)
    try:
        p, _acting, attempt = _nak_at_position_1(c, DATA)
        first, _h = p._on_worker(attempt)
        assert first[0] == "error" and "EAGAIN" in first[1], first
        pg = p.pgs[c.pgid]

        def rewind_and_replay():
            version = pg.reqid_pending[REQID][0]
            at = [i for i, e in enumerate(pg.log.entries) if e.reqid == REQID]
            assert [pg.log.entries[i].version for i in at] == [version]
            pg.log.truncate_after(pg.log.entries[at[0] - 1].version if at[0] else pg.log.log_tail)
            return version, p._replay_reqid(pg, REQID), REQID in pg.reqid_pending

        version, replayed, still_pending = p._on_worker(rewind_and_replay)
        assert replayed is None and not still_pending
        # the resend applies the write again: a new entry in the log
        # (whether the replica has been activated again by now or not)
        again, _h = p._on_worker(attempt)
        assert again == ("done", b"") or "EAGAIN" in again[1], again
        entries = p._on_worker(lambda: [e.version for e in pg.log.entries if e.reqid == REQID])
        assert len(entries) == 1 and entries[0] > version
    finally:
        c.shutdown()
