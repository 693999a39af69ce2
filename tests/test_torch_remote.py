"""The port's EC sub-op boundary held against the JAX package's on the
CPU: ``RemoteStore``/``ShardServer`` over real messenger connections,
an ``ECStore(device="cpu")`` whose shards all sit behind the network
stores the same shard bytes and hinfo as the JAX ``ECStore`` over its
own remote shards (writes, degraded reads, recovery), a RemoteStore of
one package drives a ShardServer of the other, and the heartbeat and
failure-report tests of ``tests/test_failure.py`` that need no
monitor run over the port's ``OSDMap`` (the ``tests/test_remote_store.py``
cases, and its process test with the port's shard daemon)."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import pytest

import ceph_tpu.msg as jmsg
from ceph_tpu.store import objectstore as j_objectstore
from ceph_tpu.store.ec_store import ECStore as JECStore
from ceph_tpu.store.remote import RemoteStore as JRemoteStore
from ceph_tpu.store.remote import ShardServer as JShardServer
from ceph_tpu_torch.crush.builder import CrushMap
from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables
from ceph_tpu_torch.msg import MessageError, Messenger, NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.osd import OSDMap, OSDMapMapping, PgPool
from ceph_tpu_torch.osd.failure import FailureAggregator, HeartbeatTracker
from ceph_tpu_torch.store import ECStore, MemStore, Transaction
from ceph_tpu_torch.store.objectstore import StoreError
from ceph_tpu_torch.store.remote import RemoteStore, ShardServer

PROFILE = {"technique": "reed_sol_van", "k": "3", "m": "2", "w": "8"}
N = 5


@pytest.fixture(autouse=True)
def no_live_reactor():
    before = (NetworkStack.live(), jmsg.NetworkStack.live())
    yield
    if before == (None, None):
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None,
            5.0,
        )


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


class _Cluster:
    """N shard servers of one package, each on its own messenger and
    port, their backing MemStores, and one client messenger."""

    def __init__(self, pkg: str, client_pkg: str | None = None):
        msgr = Messenger if pkg == "torch" else jmsg.Messenger
        server_cls = ShardServer if pkg == "torch" else JShardServer
        store_cls = MemStore if pkg == "torch" else j_objectstore.MemStore
        client_pkg = client_pkg or pkg
        self.client = (Messenger if client_pkg == "torch" else jmsg.Messenger)("client")
        remote_cls = RemoteStore if client_pkg == "torch" else JRemoteStore
        self.servers, self.backing, self.remotes = [], [], []
        for i in range(N):
            m = msgr(f"osd.{i}")
            self.backing.append(store_cls())
            m.add_dispatcher(server_cls(store=self.backing[-1], whoami=i))
            self.servers.append(m)
            self.remotes.append(remote_cls(self.client.connect(*m.bind())))

    def shutdown(self):
        self.client.shutdown()
        for m in self.servers:
            m.shutdown()


@pytest.fixture
def twin():
    """A JAX ECStore over JAX shard servers and a port ECStore over
    port shard servers, same profile."""
    j, t = _Cluster("jax"), _Cluster("torch")
    try:
        yield (
            JECStore(plugin="jerasure", profile=dict(PROFILE), stores=j.remotes),
            ECStore(plugin="jerasure", profile={**PROFILE, "device": "cpu"}, stores=t.remotes),
            j,
            t,
        )
    finally:
        j.shutdown()
        t.shutdown()


def _assert_same_backing(j: _Cluster, t: _Cluster):
    """The shard servers' stores hold the same objects, bytes and attrs
    (hinfo included)."""
    for pos, (js, ts) in enumerate(zip(j.backing, t.backing)):
        assert js.list_collections() == ts.list_collections(), pos
        for cid in js.list_collections():
            assert js.list_objects(cid) == ts.list_objects(cid), (pos, cid)
            for oid in js.list_objects(cid):
                assert js.read(cid, oid) == ts.read(cid, oid), (pos, oid)
                assert js.list_attrs(cid, oid) == ts.list_attrs(cid, oid), (pos, oid)


@pytest.mark.parametrize("server_pkg,client_pkg", [("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_remote_store_basic_ops(server_pkg, client_pkg):
    c = _Cluster(server_pkg, client_pkg)
    txn_cls = Transaction if client_pkg == "torch" else j_objectstore.Transaction
    err = StoreError if client_pkg == "torch" else j_objectstore.StoreError
    try:
        rs = c.remotes[0]
        rs.queue_transaction(
            txn_cls()
            .create_collection("c")
            .touch("c", "o")
            .write("c", "o", 0, b"abcdefgh")
            .setattr("c", "o", "k", b"v")
            .omap_setkeys("c", "o", {"a": b"1", "b": b"22"})
        )
        assert rs.read("c", "o") == b"abcdefgh"
        assert rs.read("c", "o", 2, 3) == b"cde"
        assert rs.getattr("c", "o", "k") == b"v"
        assert rs.list_attrs("c", "o") == {"k": b"v"}
        assert rs.omap_get("c", "o") == {"a": b"1", "b": b"22"}
        assert rs.stat("c", "o") == 8
        assert rs.exists("c", "o") and not rs.exists("c", "nope")
        assert rs.list_objects("c") == ["o"]
        with pytest.raises(err):
            rs.read("c", "nope")
        with pytest.raises(err):
            rs.queue_transaction(txn_cls().touch("missing-coll", "o"))
        with pytest.raises(err):
            rs.read("c", "o", 1 << 33, 4)  # outside the 32-bit sub-read window
        assert c.backing[0].read("c", "o") == b"abcdefgh"
        assert rs.ping(from_osd=-1) < 5
    finally:
        c.shutdown()


def test_ec_over_network_matches_jax(twin):
    """Writes (aligned, unaligned, overwrites through RMW) leave the
    same shard bytes and hinfo on both packages' shard servers."""
    jec, tec, j, t = twin
    for i, n in enumerate((1, 4096, 10000, 3 * 4096 * 2 + 17)):
        payload = _bytes(n, i)
        jec.put(f"obj{i}", payload)
        tec.put(f"obj{i}", payload)
        assert tec.get(f"obj{i}") == payload == jec.get(f"obj{i}")
    jec.write("obj2", 777, _bytes(5000, 9))
    tec.write("obj2", 777, _bytes(5000, 9))
    assert tec.get("obj2") == jec.get("obj2")
    _assert_same_backing(j, t)


def test_degraded_read_and_recovery_over_network_match_jax(twin):
    jec, tec, j, t = twin
    payload = b"\xa5" * 10000 + b"tail"
    for ec in (jec, tec):
        ec.put("obj", payload)
        ec.lose_shard("obj", 1)
        ec.corrupt_shard("obj", 3)
        assert ec.get("obj") == payload
    _assert_same_backing(j, t)
    for ec in (jec, tec):
        assert ec.recover_shard("obj", 1) > 0
        assert ec.recover_shard("obj", 3) > 0
        assert ec.scrub("obj").clean
    _assert_same_backing(j, t)


def test_recover_objects_batch_over_network_matches_jax(twin):
    jec, tec, j, t = twin
    names = [f"o{i}" for i in range(6)]
    for i, name in enumerate(names):
        payload = _bytes(3000 + 4096 * i, 100 + i)
        jec.put(name, payload)
        tec.put(name, payload)
    for ec in (jec, tec):
        for name in names:
            ec.lose_shard(name, 2)
    js, ts = jec.recover_objects_batch(names, 2), tec.recover_objects_batch(names, 2)
    assert (ts["objects"], ts["batched"]) == (js["objects"], js["batched"]) == (6, 6)
    _assert_same_backing(j, t)
    assert all(r.clean for r in tec.scrub_batch(names).values())


def test_dead_shard_reads_degrade_and_writes_raise():
    """A stopped shard server surfaces as StoreError through the proxy:
    reads reconstruct around it; a ping raises MessageError."""
    c = _Cluster("torch")
    try:
        ec = ECStore(plugin="jerasure", profile={**PROFILE, "device": "cpu"}, stores=c.remotes)
        payload = _bytes(20000, 3)
        ec.put("obj", payload)
        c.servers[2].shutdown()
        assert wait_for(lambda: c.remotes[2].conn.is_closed, 5.0)
        with pytest.raises(StoreError):
            c.remotes[2].exists(ec.cid, "obj")
        with pytest.raises(MessageError):
            c.remotes[2].ping(timeout=2)
        assert ec.get("obj") == payload
    finally:
        c.shutdown()


# -- heartbeats and failure reports (tests/test_failure.py, no monitor) ---------


def _cluster():
    m = CrushMap(tunables=Tunables(0, 0, 50, 1, 1, 1, 0))
    hosts = []
    for h in range(3):
        hosts.append(
            m.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h * 2, h * 2 + 1], [0x10000] * 2, name=f"h{h}")
        )
    m.add_bucket(CRUSH_BUCKET_STRAW2, 3, hosts, [m.buckets[b].weight for b in hosts], name="default")
    rep = m.add_simple_rule("r", "default", "host")
    om = OSDMap.build(m, 6)
    om.add_pool(PgPool(pool_id=1, size=3, pg_num=32, crush_rule=rep))
    return om


def test_heartbeat_grace():
    hb = HeartbeatTracker(whoami=0, grace=20)
    for peer in (1, 2, 3):
        hb.add_peer(peer, now=100.0)
    hb.handle_ping(1, now=120.0)
    hb.handle_ping(2, now=105.0)
    fails = dict(hb.failures(now=131.0))
    assert 1 not in fails
    assert fails[2] == pytest.approx(26.0)
    assert fails[3] == pytest.approx(31.0)


def test_failure_reports_mark_down_and_remap():
    om = _cluster()
    agg = FailureAggregator(om, min_reporters=2)
    mapping = OSDMapMapping(device="cpu")
    mapping.update(om, use_device=False)
    before_epoch = om.epoch
    assert not agg.report_failure(4, reporter=0, now=1.0)
    assert om.is_up(4)
    assert agg.report_failure(4, reporter=1, now=2.0)
    assert not om.is_up(4)
    assert om.epoch == before_epoch + 1
    mapping.update(om, use_device=False)
    for ps in range(32):
        up, _, _, _ = mapping.get(1, ps)
        assert 4 not in up


def test_duplicate_and_dead_reporters_do_not_count():
    om = _cluster()
    agg = FailureAggregator(om, min_reporters=2)
    assert not agg.report_failure(3, reporter=0, now=1.0)
    assert not agg.report_failure(3, reporter=0, now=2.0)
    assert om.is_up(3)
    om.mark_down(5)
    assert not agg.report_failure(3, reporter=5, now=3.0)
    assert om.is_up(3)


def test_cancel_report():
    om = _cluster()
    agg = FailureAggregator(om, min_reporters=2)
    agg.report_failure(3, reporter=0, now=1.0)
    agg.cancel_report(3, reporter=0)
    assert agg.pending_reports() == {}
    assert not agg.report_failure(3, reporter=1, now=2.0)
    assert om.is_up(3)


def test_dead_reporter_pending_filtered():
    om = _cluster()
    agg = FailureAggregator(om, min_reporters=2)
    agg.report_failure(3, reporter=5, now=1.0)
    om.mark_down(5)
    assert not agg.report_failure(3, reporter=1, now=2.0)
    assert om.is_up(3)


def test_externally_downed_target_clears_pending():
    om = _cluster()
    agg = FailureAggregator(om, min_reporters=2)
    agg.report_failure(3, reporter=0, now=1.0)
    om.mark_down(3)
    agg.report_failure(3, reporter=1, now=2.0)
    assert agg.pending_reports() == {}


def test_min_down_reporters_flap_guard():
    om = _cluster()
    config = {"mon_osd_min_down_reporters": 1}
    agg = FailureAggregator(om, min_reporters=lambda: config["mon_osd_min_down_reporters"])
    assert agg.report_failure(4, reporter=0, now=1.0)
    assert not om.is_up(4)
    config["mon_osd_min_down_reporters"] = 2
    assert not agg.report_failure(3, reporter=0, now=2.0)
    assert om.is_up(3)
    assert not agg.report_failure(3, reporter=0, now=3.0)
    assert om.is_up(3)
    assert agg.report_failure(3, reporter=1, now=4.0)
    assert not om.is_up(3)


def test_heartbeat_over_remote_pings_detects_stopped_shard():
    """Ping rounds through ``RemoteStore.ping`` feed a tracker until it
    names the stopped shard; two reporters mark it down."""
    c = _Cluster("torch")
    try:
        tracker = HeartbeatTracker(whoami=-1, grace=0.5)
        now = time.monotonic()
        for i in range(N):
            tracker.add_peer(i, now)

        def ping_round():
            for i, rs in enumerate(c.remotes):
                try:
                    rs.ping(from_osd=-1, timeout=1)
                    tracker.handle_ping(i, time.monotonic())
                except MessageError:
                    pass
            return [f[0] for f in tracker.failures(time.monotonic())]

        assert ping_round() == []
        c.servers[3].shutdown()
        assert wait_for(lambda: ping_round() == [3], timeout=10)
        om = _cluster()
        agg = FailureAggregator(om, min_reporters=2)
        assert not agg.report_failure(3, 0, time.monotonic())
        assert agg.report_failure(3, 1, time.monotonic())
        assert om.is_down(3)
    finally:
        c.shutdown()


# -- separate shard processes ----------------------------------------------------


def _spawn_shard(osd_id: int):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.store.remote", "--osd-id", str(osd_id)],
        stdout=subprocess.PIPE,
        text=True,
    )
    line = proc.stdout.readline().strip()
    assert line.startswith("shard_daemon ready "), line
    host, port = line.rsplit(" ", 1)[1].split(":")
    return proc, host, int(port)


@pytest.mark.slow
def test_ec_over_processes_with_heartbeat_failure_detection():
    procs = []
    client = Messenger("client")
    try:
        stores = []
        for i in range(N):
            proc, host, port = _spawn_shard(i)
            procs.append(proc)
            stores.append(RemoteStore(client.connect(host, port)))
        ec = ECStore(plugin="jerasure", profile={**PROFILE, "device": "cpu"}, stores=stores)
        payload = bytes(range(256)) * 100
        ec.put("obj", payload)
        assert ec.get("obj") == payload

        tracker = HeartbeatTracker(whoami=-1, grace=1.0)
        now = time.monotonic()
        for i in range(N):
            tracker.add_peer(i, now)

        def ping_round():
            for i, rs in enumerate(stores):
                try:
                    rs.ping(from_osd=-1, timeout=2)
                    tracker.handle_ping(i, time.monotonic())
                except MessageError:
                    pass

        ping_round()
        assert tracker.failures(time.monotonic()) == []
        procs[2].kill()
        procs[2].wait(10)
        assert ec.get("obj") == payload
        assert wait_for(
            lambda: (ping_round(), [f[0] for f in tracker.failures(time.monotonic())] == [2])[1],
            timeout=10,
        )
        cmap = CrushMap()
        cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, list(range(N)), [0x10000] * N, name="host0")
        om = OSDMap.build(cmap, N)
        agg = FailureAggregator(om, min_reporters=2)
        assert not agg.report_failure(2, 0, time.monotonic())
        assert agg.report_failure(2, 1, time.monotonic())
        assert om.is_down(2)

        proc, host, port = _spawn_shard(N)
        procs.append(proc)
        stores[2] = RemoteStore(client.connect(host, port))
        stores[2].queue_transaction(Transaction().create_collection(ec.cid))
        ec.stores[2] = stores[2]
        assert ec.recover_shard("obj", 2) > 0
        assert ec.scrub("obj").clean
        assert ec.get("obj") == payload
    finally:
        client.shutdown()
        for p in procs:
            p.kill()
            p.wait(10)
