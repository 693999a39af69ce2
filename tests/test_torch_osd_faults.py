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

Tolerance: exact (object bytes).
"""

from __future__ import annotations

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
