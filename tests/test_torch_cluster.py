"""A live port cluster held against a live JAX cluster on the CPU.

Each cluster is a monitor, 5 OSD daemons over ``MemStore`` and a
``Rados`` client in this process; the port's OSDs run on
``device="cpu"``. Both carry a replicated pool (size 3) and an EC pool
of isa k=3 m=2, built from the same maps, so PGs place alike and each
position of a PG's acting set holds in one cluster what it holds in the
other.

The port's OSDs coalesce writes and recoveries (``osd_tpu_batch_max``
and ``osd_recovery_batch_max`` at their defaults); the JAX OSDs run
every op alone (both set to 1). So equal bytes across the clusters also
show that batched writes and batched recovery give the bytes of the
per-op paths.

Equal across the two clusters, exactly: every read, stat and error; the
data objects at each acting position (shard bytes, hinfo and the other
xattrs, omap); the PG logs' entries (op, object, sequence number) in
order; the (object, shard) a deep scrub flags after a planted bit flip,
and the repair. The port's cluster loses an OSD, serves degraded I/O
and recovers it; the JAX cluster takes the same writes whole, and the
recovered positions must hold what it wrote. Not compared: map epochs
(each cluster's OSDs boot and peer on their own clock, so a log entry's
epoch and the PG info differ), timestamps, and the birth-snap xattr of
a shard the JAX cluster rebuilt (see ``_assert_same_stores``).

The JAX package's isa codes lack the ``w`` that its stripe seam reads
(ROADMAP §C), so its EC pool could not be written at all; the JAX
cluster runs with ``ErasureCodeIsa.w = 8`` set for this module, which is
what the port's isa codes carry.

Waits poll conditions under deadlines taken from ``conftest``'s load
check. OSDs are stopped and marked down by command, and the heartbeat
grace is the reference's 20 s, so a loaded box never reports a live OSD.
"""

from __future__ import annotations

import concurrent.futures
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

import ceph_tpu.ec.isa as jisa
import ceph_tpu.msg as jmsg
import ceph_tpu.osd.daemon as jdaemon
from ceph_tpu.crush.builder import CrushMap as JCrushMap
from ceph_tpu.mon.monitor import Monitor as JMonitor
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
from ceph_tpu.rados import Rados as JRados
import ceph_tpu_torch.osd.daemon as tdaemon
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.crush.builder import CrushMap
from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables
from ceph_tpu_torch.mon.monitor import Monitor
from ceph_tpu_torch.msg import Messenger, NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.ops.kernel_stats import kernel_stats
from ceph_tpu_torch.osd.ec_pg import ECCodec
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osdc.objecter import object_to_pg
from ceph_tpu_torch.rados import Rados
from ceph_tpu_torch.store.ec_store import ECStore
from ceph_tpu_torch.store.objectstore import Transaction

from conftest import strict_timing

N = 5
PG_NUM = 4
EC_PROFILE = ["plugin=isa", "k=3", "m=2"]
DEADLINE = 45.0 if strict_timing() else 120.0
GRACE = 20.0


def _base_map(pkg: str):
    crush_cls, map_cls = (CrushMap, OSDMap) if pkg == "torch" else (JCrushMap, JOSDMap)
    cmap = crush_cls(tunables=Tunables())
    hosts = [
        cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h], [0x10000], name=f"host{h}")
        for h in range(N)
    ]
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts, [cmap.buckets[b].weight for b in hosts], name="default"
    )
    cmap.add_simple_rule("rep", "default", "host", mode="firstn")
    return map_cls.build(cmap, N)


class Cluster:
    """A monitor, N OSDs and a client of one package."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        mon_cls, msgr_cls, rados_cls = (
            (Monitor, Messenger, Rados) if pkg == "torch" else (JMonitor, jmsg.Messenger, JRados)
        )
        self.daemon = tdaemon if pkg == "torch" else jdaemon
        self.mon = mon_cls(_base_map(pkg), min_reporters=2)
        self.mon_msgr = msgr_cls("mon")
        self.mon_msgr.add_dispatcher(self.mon)
        self.mon_addr = self.mon_msgr.bind()
        self.osds: dict = {}
        self.stores: dict = {}
        for i in range(N):
            self.start_osd(i)
        self.rados = rados_cls(f"{pkg}-client").connect(*self.mon_addr)
        self.pools = {}

    def start_osd(self, i: int):
        kw = dict(store=self.stores.get(i), tick_interval=0.2, heartbeat_grace=GRACE)
        if self.pkg == "torch":
            kw["device"] = "cpu"
        osd = self.daemon.OSD(i, **kw)
        if self.pkg == "jax":
            # the per-op paths: no write coalescing, no batched recovery
            osd.osd_tpu_batch_max = 1
            osd.osd_recovery_batch_max = 1
        osd.boot(*self.mon_addr)
        self.osds[i] = osd
        self.stores[i] = osd.store
        return osd

    def stop_osd(self, i: int) -> None:
        self.osds.pop(i).shutdown()
        rc, _b, outs = self.rados.mon_command({"prefix": "osd down", "id": i})
        assert rc == 0, outs

    def create_pools(self) -> None:
        r = self.rados
        rc, _b, outs = r.mon_command(
            {"prefix": "osd erasure-code-profile set", "name": "ecp", "profile": EC_PROFILE}
        )
        assert rc == 0, outs
        self.pools["rep"] = r.pool_create("rep", pg_num=PG_NUM, size=3)
        self.pools["ec"] = r.pool_create(
            "ec", pool_type=3, pg_num=PG_NUM, erasure_code_profile="ecp"
        )

    def pg_states(self) -> dict:
        out = {}
        for osd in list(self.osds.values()):
            for st in osd.collect_pg_stats():
                out[st["pgid"]] = st["state"]
        return out

    def clean(self) -> bool:
        want = {f"{p}.{ps}" for p in self.pools.values() for ps in range(PG_NUM)}
        states = self.pg_states()
        return set(states) == want and all(s == "active+clean" for s in states.values())

    def primary(self, pool: str, oid: str):
        pool_id = self.pools[pool]
        pgid = object_to_pg(self.rados.monc.osdmap.pools[pool_id], oid)
        _u, _p, _a, primary = self.rados.monc.osdmap.pg_to_up_acting_osds(
            pool_id, int(pgid.split(".")[1])
        )
        return pgid, self.osds[primary]

    def shutdown(self) -> None:
        self.rados.shutdown()
        for osd in self.osds.values():
            osd.shutdown()
        self.mon_msgr.shutdown()


def _wait(cond, what: str, timeout: float = DEADLINE) -> None:
    assert wait_for(cond, timeout), what


@pytest.fixture(scope="module")
def clusters():
    mp = pytest.MonkeyPatch()
    mp.setattr(jisa.ErasureCodeIsa, "w", 8, raising=False)
    made = []
    try:
        for pkg in ("torch", "jax"):
            c = Cluster(pkg)
            made.append(c)
            c.create_pools()
        for c in made:
            _wait(c.clean, f"{c.pkg} cluster never went active+clean")
        yield made
    finally:
        for c in made:
            c.shutdown()
        mp.undo()
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None, 10.0
        )


@pytest.fixture(autouse=True)
def _drain_port_crash_queue():
    yield
    crash.drain_pending()
    crash.reset_throttle()


def _payload(rng, lo: int, hi: int) -> bytes:
    return rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()


def _op_sequence(seed: int, n: int = 60):
    """A seeded serial op sequence over 8 objects of each pool."""
    rng = np.random.default_rng(seed)
    kinds = ["write_full", "write", "append", "setxattr", "getxattr", "omap_set",
             "omap_get", "omap_rm", "stat", "remove", "read", "read_range"]
    ops = []
    for _ in range(n):
        pool = "rep" if rng.random() < 0.5 else "ec"
        oid = f"obj{int(rng.integers(0, 8))}"
        kind = kinds[int(rng.integers(0, len(kinds)))]
        arg = None
        if kind == "write_full":
            arg = _payload(rng, 1, 40000)
        elif kind == "write":
            arg = (_payload(rng, 1, 9000), int(rng.integers(0, 30000)))
        elif kind == "append":
            arg = _payload(rng, 1, 7000)
        elif kind == "setxattr":
            arg = (f"k{int(rng.integers(0, 3))}", _payload(rng, 1, 64))
        elif kind == "getxattr":
            arg = f"k{int(rng.integers(0, 3))}"
        elif kind == "omap_set":
            arg = {f"m{int(rng.integers(0, 4))}": _payload(rng, 1, 32)}
        elif kind == "omap_rm":
            arg = [f"m{int(rng.integers(0, 4))}"]
        elif kind == "read_range":
            arg = (int(rng.integers(1, 5000)), int(rng.integers(0, 20000)))
        ops.append((pool, oid, kind, arg))
    return ops


def _apply(io, oid: str, kind: str, arg):
    if kind == "write_full":
        return io.write_full(oid, arg)
    if kind == "write":
        return io.write(oid, arg[0], arg[1])
    if kind == "append":
        return io.append(oid, arg)
    if kind == "setxattr":
        return io.set_xattr(oid, *arg)
    if kind == "getxattr":
        return io.get_xattr(oid, arg)
    if kind == "omap_set":
        return io.omap_set(oid, arg)
    if kind == "omap_get":
        return io.omap_get_vals(oid)
    if kind == "omap_rm":
        return io.omap_rm_keys(oid, arg)
    if kind == "stat":
        return io.stat(oid)
    if kind == "remove":
        return io.remove(oid)
    if kind == "read":
        return io.read(oid)
    return io.read(oid, arg[0], arg[1])


def _run(cluster, ops):
    ios = {p: cluster.rados.open_ioctx(p) for p in cluster.pools}
    out = []
    for pool, oid, kind, arg in ops:
        try:
            out.append(("ok", _apply(ios[pool], oid, kind, arg)))
        except Exception as e:  # noqa: BLE001 — the error is the result
            out.append(("err", type(e).__name__, str(e)))
    return out


def _stored(cluster) -> dict:
    """The data objects (bytes, xattrs, omap) each position of each PG's
    acting set holds, keyed by (pgid, position, osd)."""
    out = {}
    prefix = cluster.daemon.OBJ_PREFIX
    osdmap = cluster.rados.monc.osdmap
    for pool_id in sorted(cluster.pools.values()):
        for ps in range(PG_NUM):
            pgid = f"{pool_id}.{ps}"
            _u, _p, acting, _primary = osdmap.pg_to_up_acting_osds(pool_id, ps)
            for pos, osd in enumerate(acting):
                store, cid = cluster.stores[osd], f"pg_{pgid}"
                for oid in sorted(store.list_objects(cid)):
                    if oid.startswith(prefix):
                        out[(pgid, pos, osd, oid)] = (
                            store.read(cid, oid),
                            dict(store.list_attrs(cid, oid)),
                            dict(store.omap_get(cid, oid)),
                        )
    return out


def _logs(cluster) -> dict:
    """Each PG's log on its primary: (op, object, sequence) in order."""
    out = {}
    for osd in cluster.osds.values():
        for pgid, pg in list(osd.pgs.items()):
            if pg.primary == osd.whoami:
                out[pgid] = [(e.op, e.oid, e.version[1]) for e in pg.log.entries]
    return out


def _assert_same_stores(t, j, ref_rebuilt=frozenset()) -> None:
    """Equal data objects at every position, the birth-snap stamp
    ("sn_born") included. The JAX daemon's EC recovery push and EC
    repair write a rebuilt shard without that stamp (ROADMAP §C); the
    port's write it. So on a shard the JAX cluster rebuilt, named in
    ``ref_rebuilt`` as (pgid, osd, object), the port's side must carry
    the stamp and only the JAX side is let off it."""
    mine, ref = _stored(t), _stored(j)
    assert sorted(mine) == sorted(ref)
    for key in ref:
        pgid, _pos, osd, oid = key
        if (pgid, osd, oid) in ref_rebuilt:
            assert tdaemon.BORN_ATTR in mine[key][1], key
            mine[key][1].pop(tdaemon.BORN_ATTR)
            ref[key][1].pop(tdaemon.BORN_ATTR, None)
        assert mine[key] == ref[key], key


def test_serial_ops_equal(clusters):
    t, j = clusters
    ops = _op_sequence(7)
    mine, ref = _run(t, ops), _run(j, ops)
    for op, a, b in zip(ops, mine, ref):
        assert a == b, op[:3]
    assert sum(r[0] == "ok" for r in mine) > len(ops) // 2
    assert any(r[0] == "err" for r in mine)


def test_stored_objects_and_logs_equal(clusters):
    t, j = clusters
    _wait(lambda: t.clean() and j.clean(), "clusters not clean")
    _assert_same_stores(t, j)
    mine, ref = _logs(t), _logs(j)
    assert mine == ref
    assert sum(len(v) for v in mine.values()) >= 30


def _stall(osd):
    """Hold the OSD's worker on a strict item until the gate opens."""
    gate = threading.Event()
    osd._workq.put(("splitcall", lambda: gate.wait(30), concurrent.futures.Future()))
    return gate


def _oids_on(cluster, pool: str, osd, count: int, tag: str) -> list[str]:
    out = []
    i = 0
    while len(out) < count:
        oid = f"{tag}{i}"
        if cluster.primary(pool, oid)[1] is osd:
            out.append(oid)
        i += 1
    return out


def _burst(cluster, pool: str, osd, payloads: dict) -> list:
    """Queue one write_full per payload behind a stalled worker, in
    order, then release it; returns the completions."""
    io = cluster.rados.open_ioctx(pool)
    gate = _stall(osd)
    futs = []
    expect = osd._workq.qlen()
    for oid, data in payloads.items():
        futs.append(io.aio_write_full(oid, data))
        expect += 1
        _wait(lambda: osd._workq.qlen() >= expect, "op never queued", 10.0)
    gate.set()
    return futs


def test_coalesced_writes_equal_per_op(clusters):
    t, j = clusters
    osd = t.primary("ec", "anchor")[1]
    oids = _oids_on(t, "ec", osd, 6, "burst")
    rng = np.random.default_rng(11)
    payloads = {oid: _payload(rng, 5000, 60000) for oid in oids}
    before = kernel_stats().dump()
    for fut in _burst(t, "ec", osd, payloads):
        fut.result(timeout=DEADLINE)
    after = kernel_stats().dump()
    disp = after["l_tpu_batch_encode_dispatches"] - before["l_tpu_batch_encode_dispatches"]
    ops = after["l_tpu_batch_encode_ops_per_dispatch"] - before["l_tpu_batch_encode_ops_per_dispatch"]
    assert disp >= 1 and ops > disp, (disp, ops)
    jio = j.rados.open_ioctx("ec")
    for oid, data in payloads.items():
        jio.write_full(oid, data)
    tio = t.rados.open_ioctx("ec")
    for oid, data in payloads.items():
        assert tio.read(oid) == data == jio.read(oid)
    _assert_same_stores(t, j)
    assert _logs(t) == _logs(j)


def _victim(cluster) -> int:
    """An OSD in the acting set of an EC PG that is not its primary."""
    pool_id = cluster.pools["ec"]
    _u, _p, acting, primary = cluster.rados.monc.osdmap.pg_to_up_acting_osds(pool_id, 0)
    return next(o for o in acting if o != primary)


def test_degraded_io_and_recovery_equal(clusters):
    """The port's cluster loses an OSD, serves degraded reads and
    writes, takes it back and recovers it (the rebuilt EC shards come
    from the coalesced recovery); the JAX cluster takes the same writes
    with every OSD up. Every position of every PG then holds the same
    bytes in both: what recovery rebuilt is what the whole cluster
    wrote. (The JAX daemon's activation race, ROADMAP §C, can drop a
    revived OSD's recovered objects, so its cluster is not put through
    the failure.)"""
    t, j = clusters
    victim = _victim(t)
    expect = {}
    for pool in ("rep", "ec"):
        io = t.rados.open_ioctx(pool)
        for oid in io.list_objects():
            expect[(pool, oid)] = io.read(oid)
    t.stop_osd(victim)
    _wait(lambda: not t.rados.monc.osdmap.is_up(victim), "never marked down")
    for (pool, oid), data in expect.items():
        assert t.rados.open_ioctx(pool).read(oid) == data, (pool, oid)
    rng = np.random.default_rng(5)
    writes = [(pool, f"deg{i}", _payload(rng, 3000, 50000)) for pool in ("rep", "ec") for i in range(6)]
    for c in clusters:
        for pool, oid, data in writes:
            c.rados.open_ioctx(pool).write_full(oid, data)
        c.rados.open_ioctx("ec").write("obj1", b"D" * 5000, 4096)
    before = sum(o.perf.dump()["recovery_batches"] for o in t.osds.values())
    t.start_osd(victim)
    _wait(t.clean, "never recovered to active+clean")
    after = sum(o.perf.dump()["recovery_batches"] for o in t.osds.values())
    assert after > before, "the port's recovery never ran a coalesced batch"
    for pool, oid, data in writes:
        for c in clusters:
            assert c.rados.open_ioctx(pool).read(oid) == data
    _assert_same_stores(t, j)
    assert _logs(t) == _logs(j)
    assert all(o.perf.dump()["recovery_failed"] == 0 for o in t.osds.values())


def _flip_and_scrub(cluster, oid: str):
    pgid, primary = cluster.primary("ec", oid)
    pg = primary.pgs[pgid]
    victim = next(o for o in pg.acting if o != primary.whoami)
    store = cluster.osds[victim].store
    store_oid = cluster.daemon.OBJ_PREFIX + oid
    raw = bytearray(store.read(pg.cid, store_oid))
    good = bytes(raw)
    raw[len(raw) // 3] ^= 0x10
    store.queue_transaction(Transaction().write(pg.cid, store_oid, 0, bytes(raw)))
    return pgid, primary, victim, store, pg.cid, store_oid, good


def _deep_scrub(cluster, pgid: str, primary) -> list:
    pg = primary.pgs[pgid]
    stamp = pg.last_deep_scrub
    assert "deep-scrub" in cluster.rados.pg_scrub(pgid, deep=True)
    _wait(lambda: pg.last_deep_scrub != stamp, "deep scrub never finished")
    return cluster.rados.list_inconsistent_obj(pgid)


def test_deep_scrub_flags_same_shard_and_repairs(clusters):
    found = []
    for c in clusters:
        io = c.rados.open_ioctx("ec")
        io.write_full("scrubbed", bytes(range(256)) * 160)
        pgid, primary, victim, store, cid, store_oid, good = _flip_and_scrub(c, "scrubbed")
        recs = _deep_scrub(c, pgid, primary)
        found.append(
            sorted(
                (r["object"]["name"], r.get("corrupt"), [(s["osd"], s["errors"]) for s in r["shards"]])
                for r in recs
            )
        )
        assert "repair" in c.rados.pg_repair(pgid)
        _wait(lambda: store.read(cid, store_oid) == good, "repair never rebuilt the shard")
        _wait(lambda: c.rados.list_inconsistent_obj(pgid) == [], "records never cleared")
        assert _deep_scrub(c, pgid, primary) == []
        assert io.read("scrubbed") == bytes(range(256)) * 160
    assert found[0] == found[1]
    assert len(found[0]) == 1 and found[0][0][0] == "scrubbed" and len(found[0][0][1]) == 1
    # the JAX cluster's repair was the last loop pass
    _assert_same_stores(*clusters, ref_rebuilt={(pgid, victim, store_oid)})


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_clients_of_either_package_interoperate(clusters, writer):
    """A client of one package writes to the other package's cluster;
    the other package's own client reads it back (the wire is the
    same)."""
    t, j = clusters
    home, guest_cls = (j, Rados) if writer == "torch" else (t, JRados)
    guest = guest_cls(f"guest-{writer}").connect(*home.mon_addr)
    try:
        rng = np.random.default_rng(3)
        for pool in ("rep", "ec"):
            gio, hio = guest.open_ioctx(pool), home.rados.open_ioctx(pool)
            for i in range(4):
                data = _payload(rng, 100, 30000)
                gio.write_full(f"x{writer}{i}", data)
                assert hio.read(f"x{writer}{i}") == data
                hio.append(f"x{writer}{i}", b"tail")
                assert gio.read(f"x{writer}{i}") == data + b"tail"
    finally:
        guest.shutdown()


def test_kernel_error_in_coalesced_encode_propagates(clusters, monkeypatch):
    """A RuntimeError from the batch encode (what a failed kernel launch
    or a CUDA error raises) is no batching failure: it is not swallowed
    into the per-op encode, it reaches the worker's crash report. The
    dropped ops are resent by their clients and land once it is gone."""
    t, _j = clusters
    real = ECCodec.encode_object_batch

    def failing(self, datas):
        if len(datas) > 1:
            raise RuntimeError("CUDA error: simulated launch failure")
        return real(self, datas)

    monkeypatch.setattr(ECCodec, "encode_object_batch", failing)
    osd = t.primary("ec", "anchor")[1]
    rng = np.random.default_rng(17)
    payloads = {oid: _payload(rng, 2000, 20000) for oid in _oids_on(t, "ec", osd, 3, "kerr")}
    crashes = len(osd._pending_crashes)
    futs = _burst(t, "ec", osd, payloads)
    _wait(lambda: len(osd._pending_crashes) > crashes, "the RuntimeError was swallowed")
    report = list(osd._pending_crashes)[-1]
    assert report["exception"] == "RuntimeError: CUDA error: simulated launch failure"
    assert report["meta"]["work_item"] == "op"
    assert osd.client_throttle.current == 0 or all(not f.done() for f in futs)
    monkeypatch.setattr(ECCodec, "encode_object_batch", real)
    for fut in futs:
        fut.result(timeout=DEADLINE)
    io = t.rados.open_ioctx("ec")
    for oid, data in payloads.items():
        assert io.read(oid) == data


def test_kernel_error_in_batched_recovery_propagates(clusters, monkeypatch):
    """The same for the batched recovery rebuild: the error reaches the
    crash report and fails the recovery (the tick re-peers); once it is
    gone the recovery completes and every object reads back."""
    t, _j = clusters
    victim = _victim(t)
    t.stop_osd(victim)
    _wait(lambda: not t.rados.monc.osdmap.is_up(victim), "never marked down")
    pool_id = t.pools["ec"]
    pool = t.rados.monc.osdmap.pools[pool_id]
    oids = [f"rec{i}" for i in range(40) if object_to_pg(pool, f"rec{i}") == f"{pool_id}.0"][:4]
    assert len(oids) >= 2
    rng = np.random.default_rng(23)
    io = t.rados.open_ioctx("ec")
    payloads = {oid: _payload(rng, 2000, 30000) for oid in oids}
    for oid, data in payloads.items():
        io.write_full(oid, data)
    primary = t.primary("ec", oids[0])[1]
    real = ECStore.reconstruct_shards_batch

    def failing(self, *a, **kw):
        raise RuntimeError("CUDA error: simulated launch failure")

    monkeypatch.setattr(ECStore, "reconstruct_shards_batch", failing)
    crashes = len(primary._pending_crashes)
    t.start_osd(victim)
    _wait(lambda: len(primary._pending_crashes) > crashes, "the RuntimeError was swallowed")
    report = list(primary._pending_crashes)[-1]
    assert report["exception"] == "RuntimeError: CUDA error: simulated launch failure"
    assert report["meta"]["work_item"] == "recover_push"
    _wait(lambda: primary.perf.dump()["recovery_failed"] >= 1, "recovery not marked failed")
    monkeypatch.setattr(ECStore, "reconstruct_shards_batch", real)
    _wait(t.clean, "never recovered once the error was gone")
    for oid, data in payloads.items():
        assert io.read(oid) == data


def test_rados_cli_against_the_port_cluster(clusters, tmp_path):
    """``python -m ceph_tpu_torch.tools.rados_cli`` puts, stats, lists
    and gets an object of the port's EC pool; the JAX client reads it."""
    t, j = clusters
    data = np.random.default_rng(31).integers(0, 256, 70000, dtype=np.uint8).tobytes()
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(data)
    mon = f"{t.mon_addr[0]}:{t.mon_addr[1]}"
    root = pathlib.Path(__file__).resolve().parent.parent

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.rados_cli", "-m", mon, "-p", "ec", *args],
            cwd=root, capture_output=True, text=True, timeout=DEADLINE,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    cli("put", "cliobj", str(src))
    assert "cliobj" in cli("ls").split()
    assert str(len(data)) in cli("stat", "cliobj")
    cli("get", "cliobj", str(dst))
    assert dst.read_bytes() == data
    guest = JRados("guest-cli").connect(*t.mon_addr)
    try:
        assert guest.open_ioctx("ec").read("cliobj") == data
    finally:
        guest.shutdown()
