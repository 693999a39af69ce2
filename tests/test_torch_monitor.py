"""The port's monitor held against the JAX package's on the CPU.

The same command sequence goes to a JAX ``Monitor`` and to the port's
(an EC profile, replicated and EC pool creates, osd down/out/in/
reweight, ``pg-upmap-items``, pool snaps): each committed
``Incremental``'s bytes and each epoch's ``OSDMap`` encoding are equal,
and so are the command replies that carry no clock. A cold restart
from the port's ``MonitorStore`` replays the chain. A JAX ``MonClient``
subscribed to the port's monitor, and the port's ``MonClient``
subscribed to the JAX monitor, see the same maps (the wire is the
same).

Tolerance: exact.
"""

from __future__ import annotations

import json

import pytest

import ceph_tpu.msg as jmsg
from ceph_tpu.crush.builder import CrushMap as JCrushMap
from ceph_tpu.mon import MonClient as JMonClient
from ceph_tpu.mon import Monitor as JMonitor
from ceph_tpu.mon import MonitorStore as JMonitorStore
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
from ceph_tpu.osd.osdmap import PgPool as JPgPool
from ceph_tpu_torch.crush.builder import CrushMap
from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2
from ceph_tpu_torch.mon import MonClient, Monitor, MonitorStore
from ceph_tpu_torch.msg import Messenger, NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.osd.osdmap import OSDMap, PgPool

N = 6


@pytest.fixture(autouse=True)
def no_live_reactor():
    before = (NetworkStack.live(), jmsg.NetworkStack.live())
    yield
    if before == (None, None):
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None,
            5.0,
        )


def _base_map(pkg: str):
    crush_cls, map_cls, pool_cls = (
        (CrushMap, OSDMap, PgPool) if pkg == "torch" else (JCrushMap, JOSDMap, JPgPool)
    )
    cmap = crush_cls()
    hosts = [
        cmap.add_bucket(
            CRUSH_BUCKET_STRAW2, 1, [2 * h, 2 * h + 1], [0x10000] * 2, name=f"host{h}"
        )
        for h in range(3)
    ]
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts, [cmap.buckets[b].weight for b in hosts], name="default"
    )
    cmap.add_simple_rule("rep", "default", "host", mode="firstn")
    om = map_cls.build(cmap, N)
    om.add_pool(pool_cls(pool_id=1, size=3, pg_num=16, crush_rule=0))
    return om


COMMANDS = [
    {"prefix": "osd erasure-code-profile set", "name": "ecp", "profile": ["plugin=isa", "k=3", "m=2"]},
    {"prefix": "osd erasure-code-profile set", "name": "jp", "profile": ["k=2", "m=1", "plugin=jerasure"]},
    {"prefix": "osd pool create", "pool": "rbd", "pg_num": 8, "size": 3},
    {"prefix": "osd pool create", "pool": "ecpool", "pool_type": 3, "pg_num": 8, "erasure_code_profile": "ecp"},
    {"prefix": "osd pool create", "pool": "ec2", "pool_type": 3, "pg_num": 4, "erasure_code_profile": "jp", "min_size": 2},
    {"prefix": "osd pool create", "pool": "rbd"},
    {"prefix": "osd pool create", "pool": "bad", "pool_type": 3, "erasure_code_profile": "missing"},
    {"prefix": "osd down", "id": 2},
    {"prefix": "osd down", "id": 2},
    {"prefix": "osd out", "id": 2},
    {"prefix": "osd in", "id": 2},
    {"prefix": "osd reweight", "id": 4, "weight": 0.5},
    {"prefix": "osd reweight", "id": 999, "weight": 0.5},
    {"prefix": "osd pg-upmap-items", "pgid": "1.3", "mappings": [[0, 5]]},
    {"prefix": "osd pg-upmap-items", "pgid": "1.3", "mappings": []},
    {"prefix": "osd pg-upmap-items", "pgid": "9.0", "mappings": [[0, 1]]},
    {"prefix": "osd pool mksnap", "pool": "rbd", "snap": "s1"},
    {"prefix": "osd pool mksnap", "pool": "rbd", "snap": "s1"},
    {"prefix": "osd pool rmsnap", "pool": "rbd", "snap": "s1"},
    {"prefix": "osd pool set", "pool": "ecpool", "var": "pg_num", "val": "16"},
    {"prefix": "osd pool set", "pool": "rbd", "var": "size", "val": "2"},
    {"prefix": "osd pool delete", "pool": "ec2"},
    {"prefix": "osd dump"},
    {"prefix": "osd tree"},
    {"prefix": "osd pool ls"},
    {"prefix": "osd erasure-code-profile get", "name": "ecp"},
    {"prefix": "osd erasure-code-profile ls"},
    {"prefix": "config set", "who": "osd", "key": "osd_max_scrubs", "value": "2"},
    {"prefix": "config get", "who": "osd", "key": "osd_max_scrubs"},
    {"prefix": "nonsense"},
]


def _drive(mon_cls, store_cls, pkg):
    store = store_cls()
    mon = mon_cls(_base_map(pkg), store=store)
    replies = []
    for cmd in COMMANDS:
        r = mon.handle_command(json.dumps(cmd))
        replies.append((r.rc, r.outs, r.outb))
    return mon, store, replies


@pytest.fixture(scope="module")
def driven():
    return _drive(Monitor, MonitorStore, "torch"), _drive(JMonitor, JMonitorStore, "jax")


def test_command_replies_equal(driven):
    (_mon, _s, replies), (_jmon, _js, jreplies) = driven
    assert len(replies) == len(COMMANDS)
    for cmd, mine, ref in zip(COMMANDS, replies, jreplies):
        assert mine == ref, cmd["prefix"]
    rcs = [r[0] for r in replies]
    # EEXIST, ENOENT profile, bad reweight, no such pool, snap exists,
    # a pool variable that cannot be set, unknown
    assert [rc for rc in rcs if rc] == [-17, -2, -22, -2, -17, -22, -22]


def test_incrementals_and_maps_equal(driven):
    (mon, store, _r), (jmon, jstore, _jr) = driven
    last = store.last_committed()
    assert last == jstore.last_committed() == mon.osdmap.epoch
    assert last >= 14
    for epoch in range(1, last + 1):
        assert store.get_inc(epoch) == jstore.get_inc(epoch), epoch
        assert store.get_full(epoch) == jstore.get_full(epoch), epoch
    assert mon.osdmap.encode() == jmon.osdmap.encode()
    # the EC pool's stored profile is what was set: the port's check on
    # the CPU did not add a device key to it
    assert mon.osdmap.erasure_code_profiles["ecp"] == {"plugin": "isa", "k": "3", "m": "2"}


def test_cold_restart_replays_chain(driven):
    (mon, store, _r), _ = driven
    again = Monitor(_base_map("torch"), store=store)
    assert again.osdmap.epoch == mon.osdmap.epoch
    assert again.osdmap.encode() == mon.osdmap.encode()
    # and keeps committing on top of the replayed chain
    r = again.handle_command(json.dumps({"prefix": "osd out", "id": 5}))
    assert r.rc == 0 and json.loads(r.outb)["epoch"] == mon.osdmap.epoch + 1


def _serve(mon, msgr_cls):
    m = msgr_cls("mon")
    m.add_dispatcher(mon)
    return m, m.bind()


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_monclients_cross_subscribe(server):
    """A client of each package subscribes to one monitor; every commit
    reaches both, and their maps encode to the monitor's bytes."""
    if server == "torch":
        mon, srv_msgr_cls = Monitor(_base_map("torch")), Messenger
    else:
        mon, srv_msgr_cls = JMonitor(_base_map("jax")), jmsg.Messenger
    msgrs = []
    try:
        m, addr = _serve(mon, srv_msgr_cls)
        msgrs.append(m)
        clients = []
        for tag, msgr_cls, mc_cls in (("torch", Messenger, MonClient), ("jax", jmsg.Messenger, JMonClient)):
            cm = msgr_cls(f"client.{tag}")
            msgrs.append(cm)
            mc = mc_cls(cm, whoami=0 if tag == "torch" else 1)
            mc.connect(*addr)
            clients.append(mc)
        for mc in clients:
            assert mc.osdmap.encode() == mon.osdmap.encode()
        # commands from either client commit; both follow incrementally
        r = clients[0].command({"prefix": "osd pool create", "pool": "p", "pg_num": 4, "size": 2})
        assert r.rc == 0, r.outs
        r = clients[1].command({"prefix": "osd out", "id": 1})
        assert r.rc == 0, r.outs
        clients[1].report_failure(3, failed_for=30.0)
        clients[0].report_failure(3, failed_for=30.0)
        assert wait_for(lambda: not mon.osdmap.is_up(3), 10.0)
        for mc in clients:
            assert mc.wait_for_epoch(mon.osdmap.epoch)
            assert mc.osdmap.encode() == mon.osdmap.encode()
        assert clients[0].osdmap.pool_names == clients[1].osdmap.pool_names
    finally:
        for m in msgrs:
            m.shutdown()
