"""The port's file system held against the JAX package's on live
clusters, on the CPU: ``CephFS`` in library mode, and the MDS tier
(``MDSDaemon`` + ``MDSClient``).

A JAX and a port cluster side by side (``tests/test_torch_cluster.py``'s
``Cluster``, the port's OSDs on ``device="cpu"``), each with three more
pools: ``fsmeta`` (3 replicas, the MDS's metadata), ``fslib`` (3
replicas, library mode's metadata and data) and ``fsec`` (isa k=3 m=2,
file data). The same seeded sequences run on both clusters, each
package driving its own:

- library mode: directories, striped files across object boundaries
  (stripe unit 4096, count 2, object size 8192), sparse reads,
  overwrites, truncate, rename, unlink, rmdir rules and a second mount,
  with the data in the replicated and in the erasure-coded pool; and
  filesystem snapshots with their read-only mounts;
- the MDS tier: one active MDS, clients whose file data goes to the
  replicated and to the erasure-coded pool; the namespace, two clients
  sharing a directory through capability recall, a stat cache a
  sibling's write invalidates, a client's own mutations; then the
  active killed hard with its journal tail unflushed, a standby taking
  over by journal replay, and the clients riding over the failover;
- two active ranks: ``/a`` pinned to the second rank, work on both
  subtrees, renames across the boundary, and the rank of a killed
  active re-homed on a standby that replays its journal.

Equal, exactly: every result and every error, the capability recalls,
the journal entries replayed, and the stored objects at every acting
position of every PG (dirfrags, inodes, the journal head and entries,
the data shards and hinfo). The clock is ``test_torch_rgw``'s fixed
clock, patched into both packages' ``fs`` and ``mds`` modules, so
every ``mtime`` is equal; nothing is masked. Which daemon holds which
rank after two start at once is decided by the order their beacons
reach the monitor, so the multi-rank sequence records ranks by role
(the pinned subtree's, the other's), not by daemon name.

Across the packages on one cluster: a JAX ``MDSDaemon`` serves a port
``MDSClient`` and a JAX one at once; then a port ``MDSDaemon`` takes
over by replaying the JAX daemon's journal and serves the tree they
wrote, equal; and the same with the packages swapped.

The JAX isa codes need ``ErasureCodeIsa.w = 8`` for an EC pool
(ROADMAP §C); it is set for this module only, as in the cluster test.
"""

from __future__ import annotations

import random
import types

import pytest

import ceph_tpu.ec.isa as jisa
import ceph_tpu.fs as jfs
import ceph_tpu.mds as jmds
import ceph_tpu.mds.client as jmds_client
import ceph_tpu.mds.server as jmds_server
import ceph_tpu.msg as jmsg
from ceph_tpu.osdc.striper import StripeLayout as JStripeLayout
from ceph_tpu.rados import Rados as JRados
import ceph_tpu_torch.fs as tfs
import ceph_tpu_torch.mds as tmds
import ceph_tpu_torch.mds.client as tmds_client
import ceph_tpu_torch.mds.server as tmds_server
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.msg import NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.osdc.striper import StripeLayout
from ceph_tpu_torch.rados import Rados

from test_torch_cluster import PG_NUM, Cluster, _stored, _wait
from test_torch_rgw import CLOCK, T0, _recorder

PKGS = {
    "torch": types.SimpleNamespace(fs=tfs, mds=tmds, Rados=Rados, StripeLayout=StripeLayout,
                                   modules=(tfs, tmds_client, tmds_server)),
    "jax": types.SimpleNamespace(fs=jfs, mds=jmds, Rados=JRados, StripeLayout=JStripeLayout,
                                 modules=(jfs, jmds_client, jmds_server)),
}
LAYOUT = (4096, 2, 8192)


class _Fleet:
    """The MDS daemons and clients of one package on a cluster, each
    on a Rados of its own."""

    def __init__(self, ns, cluster):
        self.ns, self.cluster = ns, cluster
        self.mds: dict = {}
        self.radoses: list = []
        self.clients: list = []

    def _rados(self, name: str):
        r = self.ns.Rados(name).connect(*self.cluster.mon_addr)
        self.radoses.append(r)
        return r

    def start_mds(self, name: str, **kw):
        d = self.ns.mds.MDSDaemon(name, self._rados(f"mds-{name}"), "fsmeta",
                                  beacon_interval=0.3, **kw)
        self.mds[name] = d
        return d

    def kill_mds(self, name: str) -> None:
        """Hard kill: no flush, no goodbye; the journal tail stays."""
        d = self.mds.pop(name)
        d._stop.set()
        d.msgr.shutdown()

    def wait_active(self, name: str) -> None:
        _wait(lambda: self.mds[name].state == "active", f"mds {name} never became active")

    def client(self, name: str, pool: str):
        c = self.ns.mds.MDSClient(self._rados(f"fs-{name}"), pool, name=name,
                                  layout=self.ns.StripeLayout(*LAYOUT))
        self.clients.append(c)
        return c

    def shutdown(self) -> None:
        for c in self.clients:
            c.close()
        for name in list(self.mds):
            self.kill_mds(name)
        for r in self.radoses:
            r.shutdown()


@pytest.fixture(scope="module")
def clusters():
    mp = pytest.MonkeyPatch()
    mp.setattr(jisa.ErasureCodeIsa, "w", 8, raising=False)
    for ns in PKGS.values():
        for mod in ns.modules:
            mp.setattr(mod, "time", CLOCK)
    made = []
    try:
        for pkg in ("torch", "jax"):
            c = Cluster(pkg)
            made.append(c)
            c.create_pools()
            c.pools["fsmeta"] = c.rados.pool_create("fsmeta", pg_num=PG_NUM, size=3)
            c.pools["fslib"] = c.rados.pool_create("fslib", pg_num=PG_NUM, size=3)
            c.pools["fsec"] = c.rados.pool_create("fsec", pool_type=3, pg_num=PG_NUM,
                                                  erasure_code_profile="ecp")
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


def _library(ns, rados, data_pool: str, top: str, seed: int) -> list:
    """test_rgw_fs's file layer, under ``/top``, data in ``data_pool``."""
    CLOCK.now = T0 + 7000.0
    rng = random.Random(seed)
    out = []
    rec = _recorder(out)
    fs = ns.fs.CephFS(rados.open_ioctx("fslib"), rados.open_ioctx(data_pool),
                      layout=ns.StripeLayout(*LAYOUT))
    d = f"/{top}"
    rec("mkdir top", lambda: fs.mkdir(d))
    rec("mkdir home", lambda: fs.mkdir(f"{d}/home"))
    rec("mkdir user", lambda: fs.mkdir(f"{d}/home/user"))
    rec("readdir top", lambda: fs.readdir(d))
    rec("mkdir again", lambda: fs.mkdir(f"{d}/home"))
    rec("readdir missing", lambda: fs.readdir(f"{d}/nope"))
    rec("create", lambda: fs.create(f"{d}/home/user/notes.txt"))
    data = bytes(range(256)) * 128
    rec("write", lambda: fs.write(f"{d}/home/user/notes.txt", 0, data))
    rec("read", lambda: fs.read(f"{d}/home/user/notes.txt"))
    st = rec("stat", lambda: fs.stat(f"{d}/home/user/notes.txt"))
    rec("data objects", lambda: sorted(n for n in rados.open_ioctx(data_pool).list_objects()
                                       if n.startswith(f"{st['ino']:x}.")))
    rec("create sparse", lambda: fs.create(f"{d}/home/user/sparse"))
    rec("write sparse", lambda: fs.write(f"{d}/home/user/sparse", 10000, b"tail"))
    rec("read hole", lambda: fs.read(f"{d}/home/user/sparse", 0, 4))
    rec("read tail", lambda: fs.read(f"{d}/home/user/sparse", 10000, 4))
    for i in range(6):
        off, n = rng.randrange(0, 40000), rng.randrange(1, 20000)
        blob = rng.randbytes(n)
        rec(f"overwrite {i}", lambda: fs.write(f"{d}/home/user/notes.txt", off, blob))
        rec(f"reread {i}", lambda: fs.read(f"{d}/home/user/notes.txt",
                                           rng.randrange(0, 50000), rng.randrange(1, 30000)))
    rec("truncate", lambda: fs.truncate(f"{d}/home/user/notes.txt", 100))
    rec("stat truncated", lambda: fs.stat(f"{d}/home/user/notes.txt"))
    rec("extend", lambda: fs.write(f"{d}/home/user/notes.txt", 200, b"end"))
    rec("read gap", lambda: fs.read(f"{d}/home/user/notes.txt", 100, 100))
    rec("mkdir archive", lambda: fs.mkdir(f"{d}/archive"))
    rec("rename", lambda: fs.rename(f"{d}/home/user/notes.txt", f"{d}/archive/notes.old"))
    rec("readdir archive", lambda: fs.readdir(f"{d}/archive"))
    rec("read renamed", lambda: fs.read(f"{d}/archive/notes.old", 200, 3))
    rec("unlink", lambda: fs.unlink(f"{d}/archive/notes.old"))
    rec("stat unlinked", lambda: fs.stat(f"{d}/archive/notes.old"))
    rec("data gone", lambda: [n for n in rados.open_ioctx(data_pool).list_objects()
                              if n.startswith(f"{st['ino']:x}.")])
    rec("rmdir full", lambda: fs.rmdir(f"{d}/home"))
    rec("unlink sparse", lambda: fs.unlink(f"{d}/home/user/sparse"))
    rec("rmdir user", lambda: fs.rmdir(f"{d}/home/user"))
    rec("readdir home", lambda: fs.readdir(f"{d}/home"))
    fs2 = ns.fs.CephFS(rados.open_ioctx("fslib"), rados.open_ioctx(data_pool))
    rec("second mount", lambda: sorted(fs2.readdir(d)))
    return out


def _snapshots(ns, rados) -> list:
    CLOCK.now = T0 + 8000.0
    out = []
    rec = _recorder(out)
    fs = ns.fs.CephFS(rados.open_ioctx("fslib"))
    rec("mkdir", lambda: fs.mkdir("/proj"))
    rec("create", lambda: fs.create("/proj/a.txt"))
    rec("write", lambda: fs.write("/proj/a.txt", 0, b"version one"))
    rec("snapshot v1", lambda: fs.snapshot("v1"))
    rec("list", fs.list_snapshots)
    rec("write two", lambda: fs.write("/proj/a.txt", 0, b"VERSION TWO"))
    rec("create b", lambda: fs.create("/proj/b.txt"))
    rec("mkdir later", lambda: fs.mkdir("/proj/later"))
    rec("unlink a", lambda: fs.unlink("/proj/a.txt"))
    snap = fs.at_snap("v1")
    rec("snap readdir", lambda: snap.readdir("/proj"))
    rec("snap read", lambda: snap.read("/proj/a.txt"))
    rec("snap stat", lambda: snap.stat("/proj/a.txt"))
    rec("snap create", lambda: snap.create("/proj/nope"))
    rec("snap write", lambda: snap.write("/proj/a.txt", 0, b"x"))
    rec("snap mkdir", lambda: snap.mkdir("/zzz"))
    rec("live readdir", lambda: sorted(fs.readdir("/proj")))
    rec("snapshot v2", lambda: fs.snapshot("v2"))
    rec("v2 readdir", lambda: fs.at_snap("v2").readdir("/proj"))
    rec("remove v1", lambda: fs.remove_snapshot("v1"))
    rec("list after", fs.list_snapshots)
    rec("at removed", lambda: fs.at_snap("v1"))
    return out


def _mds_sequence(ns, cluster) -> list:
    """One active MDS, clients on both data pools, caps, then a hard
    failover to a standby that replays the journal."""
    CLOCK.now = T0 + 9000.0
    rng = random.Random(41)
    out = []
    rec = _recorder(out)
    fleet = _Fleet(ns, cluster)
    try:
        fleet.start_mds("a", flush_every=8)
        fleet.wait_active("a")
        rec("mds stat actives", lambda: sorted(
            __import__("json").loads(cluster.rados.mon_command(
                {"prefix": "mds stat"})[1])["actives"]))
        for top, pool in (("docs", "rep"), ("ecdocs", "fsec")):
            fs = fleet.client(f"ns-{top}", pool)
            d = f"/{top}"
            rec(f"{top} mkdir", lambda: fs.mkdir(d))
            rec(f"{top} mkdir sub", lambda: fs.mkdir(f"{d}/sub"))
            rec(f"{top} create", lambda: fs.create(f"{d}/hello.txt"))
            rec(f"{top} write", lambda: fs.write(f"{d}/hello.txt", 0, b"hello mds world"))
            rec(f"{top} read", lambda: fs.read(f"{d}/hello.txt"))
            rec(f"{top} readdir", lambda: fs.readdir(d))
            rec(f"{top} stat", lambda: fs.stat(f"{d}/hello.txt"))
            rec(f"{top} rename", lambda: fs.rename(f"{d}/hello.txt", f"{d}/sub/hi.txt"))
            rec(f"{top} read renamed", lambda: fs.read(f"{d}/sub/hi.txt"))
            rec(f"{top} truncate", lambda: fs.truncate(f"{d}/sub/hi.txt", 5))
            rec(f"{top} read truncated", lambda: fs.read(f"{d}/sub/hi.txt"))
            for i in range(4):
                name = f"{d}/f{i}"
                blob = rng.randbytes(rng.randrange(1, 60000))
                off = rng.randrange(0, 30000)
                rec(f"{top} create f{i}", lambda: fs.create(name))
                rec(f"{top} write f{i}", lambda: fs.write(name, off, blob))
                rec(f"{top} overwrite f{i}", lambda: fs.write(name, off // 2, blob[:777]))
                rec(f"{top} read f{i}", lambda: fs.read(name))
                rec(f"{top} stat f{i}", lambda: fs.stat(name))
            rec(f"{top} unlink", lambda: fs.unlink(f"{d}/sub/hi.txt"))
            rec(f"{top} rmdir", lambda: fs.rmdir(f"{d}/sub"))
            rec(f"{top} rmdir full", lambda: fs.rmdir(d))
            rec(f"{top} stat missing", lambda: fs.stat(f"{d}/nope"))
            rec(f"{top} mkdir exists", lambda: fs.mkdir(d))
            rec(f"{top} readdir end", lambda: fs.readdir(d))

        # two clients share a directory through capability recall
        a, b = fleet.client("capA", "rep"), fleet.client("capB", "fsec")
        rec("cap mkdir", lambda: a.mkdir("/shared"))
        rec("cap readdir a", lambda: a.readdir("/shared"))
        rec("cap stat a", lambda: a.stat("/shared"))
        calls = []
        orig = a._call
        a._call = lambda op, args, reqid=None: (calls.append(op), orig(op, args, reqid))[1]
        rec("cap cached readdir", lambda: a.readdir("/shared"))
        a._call = orig
        rec("cap calls while cached", lambda: list(calls))
        rec("cap create b", lambda: b.create("/shared/from_b.txt"))
        rec("cap recalls a", lambda: a.recalls >= 1)
        rec("cap readdir a after", lambda: a.readdir("/shared"))
        rec("cap readdir b", lambda: b.readdir("/shared"))
        rec("cap create a", lambda: a.create("/shared/from_a.txt"))
        rec("cap readdir b after", lambda: b.readdir("/shared"))
        # a sibling's write invalidates a cached stat
        rec("stat mkdir", lambda: a.mkdir("/sized"))
        rec("stat create", lambda: a.create("/sized/f"))
        rec("stat size", lambda: a.stat("/sized/f")["size"])
        rec("stat write b", lambda: b.write("/sized/f", 0, b"x" * 4096))
        rec("stat size after", lambda: a.stat("/sized/f")["size"])
        # one's own mutations invalidate one's own caches
        rec("own mkdir", lambda: a.mkdir("/own"))
        rec("own create x", lambda: a.create("/own/x"))
        rec("own stat x", lambda: a.stat("/own/x")["type"])
        rec("own readdir", lambda: a.readdir("/own"))
        rec("own create y", lambda: a.create("/own/y"))
        rec("own readdir y", lambda: a.readdir("/own"))
        rec("own unlink x", lambda: a.unlink("/own/x"))
        rec("own stat gone", lambda: a.stat("/own/x"))
        rec("own rename", lambda: a.rename("/own/y", "/own/z"))
        rec("own readdir z", lambda: a.readdir("/own"))

        # the active killed with its journal tail unflushed
        fleet.start_mds("b", flush_every=10_000)
        fs = fleet.client("failover", "fsec")
        rec("work mkdir", lambda: fs.mkdir("/work"))
        for i in range(8):
            rec(f"pre{i}", lambda: fs.create(f"/work/pre{i}"))
        rec("pre write", lambda: fs.write("/work/pre0", 0, b"survives failover"))
        rec("a active", lambda: fleet.mds["a"].state)
        fleet.kill_mds("a")
        for i in range(4):
            rec(f"post{i}", lambda: fs.create(f"/work/post{i}"))
        rec("b state", lambda: fleet.mds["b"].state)
        rec("b replayed", lambda: fleet.mds["b"].replayed_entries)
        fresh = fleet.client("checker", "fsec")
        rec("fresh readdir", lambda: fresh.readdir("/work"))
        rec("fresh read", lambda: fresh.read("/work/pre0"))
        rec("fresh stat", lambda: fresh.stat("/work/pre0"))
        rec("old client after failover", lambda: a.readdir("/shared"))
        rec("fleet recalls", lambda: sorted((c.name, c.recalls) for c in fleet.clients))
    finally:
        fleet.shutdown()
    return out


@pytest.fixture(scope="module")
def sequences(clusters):
    t, j = clusters
    got = {}
    for key, fn in (
        ("library rep", lambda ns, c: _library(ns, c.rados, "fslib", "lib", 3)),
        ("library ec", lambda ns, c: _library(ns, c.rados, "fsec", "libec", 4)),
        ("snapshots", lambda ns, c: _snapshots(ns, c.rados)),
        ("mds", _mds_sequence),
    ):
        got[key] = (fn(PKGS["torch"], t), fn(PKGS["jax"], j))
    return got


@pytest.mark.parametrize("key", ["library rep", "library ec", "snapshots", "mds"])
def test_sequences_equal(sequences, key):
    mine, ref = sequences[key]
    assert [label for label, _g in mine] == [label for label, _g in ref]
    for a, b in zip(mine, ref):
        assert a == b, a[0]
    got = dict(mine)
    if key.startswith("library"):
        assert got["mkdir again"][:2] == ("err", "FSError")
        assert got["read gap"] == b"\0" * 100
    elif key == "snapshots":
        assert got["snap read"] == b"version one"
        assert got["snap create"][0] == "err" and "read-only" in got["snap create"][2]
    else:
        assert got["b state"] == "active" and got["b replayed"] > 0
        assert got["cap calls while cached"] == [] and got["cap recalls a"] is True
        assert got["fresh read"] == b"survives failover"
        assert got["stat size after"] == 4096


def _multi_rank(ns, cluster) -> list:
    """Two active ranks, ``/a`` pinned to the second; a killed active's
    rank re-homed on a standby."""
    import json

    CLOCK.now = T0 + 11000.0
    out = []
    rec = _recorder(out)
    fleet = _Fleet(ns, cluster)
    mon = cluster.rados

    def stable(path, rank):
        rc, outb, _ = mon.mon_command({"prefix": "mds stat"})
        return rc == 0 and json.loads(outb)["subtrees"].get(path) == rank

    try:
        rc, _b, outs = mon.mon_command({"prefix": "mds set-max-mds", "max_mds": 2})
        assert rc == 0, outs
        fleet.start_mds("m0", flush_every=10_000)
        fleet.start_mds("m1", flush_every=10_000)
        _wait(lambda: all(d.state == "active" for d in fleet.mds.values())
              and {d.rank for d in fleet.mds.values()} == {0, 1}, "two actives never formed")
        by_rank = {d.rank: name for name, d in fleet.mds.items()}
        fs = fleet.client("mm", "fsec")
        rec("mkdir a", lambda: fs.mkdir("/a"))
        rec("mkdir b", lambda: fs.mkdir("/b"))
        rc, _b, outs = mon.mon_command({"prefix": "mds pin", "path": "/a", "rank": 1})
        assert rc == 0, outs
        _wait(lambda: stable("/a", 1), "pin /a -> 1 never stabilized")
        before = {r: fleet.mds[n].ops_served for r, n in by_rank.items()}
        for i in range(6):
            rec(f"create fa{i}", lambda: fs.create(f"/a/fa{i}"))
            rec(f"create fb{i}", lambda: fs.create(f"/b/fb{i}"))
        rec("write a", lambda: fs.write("/a/fa0", 0, b"alpha"))
        rec("write b", lambda: fs.write("/b/fb0", 0, b"beta"))
        fresh = fleet.client("mm-check", "fsec")
        rec("readdir a", lambda: fresh.readdir("/a"))
        rec("readdir b", lambda: fresh.readdir("/b"))
        rec("read a", lambda: fresh.read("/a/fa0"))
        rec("read b", lambda: fresh.read("/b/fb0"))
        rec("both ranks served", lambda: all(
            fleet.mds[n].ops_served > before[r] for r, n in by_rank.items()))
        rec("rank 1 refuses /b", lambda: fleet.mds[by_rank[1]]._check_auth("/b/x"))
        rec("rank 0 refuses /a", lambda: fleet.mds[by_rank[0]]._check_auth("/a/x"))
        rec("create mover", lambda: fs.create("/b/mover"))
        rec("write mover", lambda: fs.write("/b/mover", 0, b"payload"))
        ino = fs.stat("/b/mover")["ino"]
        rec("rename across", lambda: fs.rename("/b/mover", "/a/moved"))
        rec("readdir a moved", lambda: fs.readdir("/a"))
        rec("same ino", lambda: fs.stat("/a/moved")["ino"] == ino)
        rec("rename back", lambda: fs.rename("/a/moved", "/b/back"))
        rec("read back", lambda: fs.read("/b/back"))
        for i in range(5):
            rec(f"ha{i}", lambda: fs.create(f"/a/ha{i}"))
        fleet.kill_mds(by_rank[1])
        fleet.start_mds("m2", flush_every=10_000)
        _wait(lambda: fleet.mds["m2"].state == "active", "the standby never took rank 1")
        rec("m2 rank", lambda: fleet.mds["m2"].rank)
        rec("m2 replayed", lambda: fleet.mds["m2"].replayed_entries)
        fresh2 = fleet.client("mm-ha", "fsec")
        rec("readdir a after", lambda: fresh2.readdir("/a"))
        rec("read back after", lambda: fresh2.read("/b/back"))
        rec("create after", lambda: fresh2.create("/a/after-failover"))
        rec("readdir after", lambda: fresh.readdir("/a"))
    finally:
        fleet.shutdown()
        mon.mon_command({"prefix": "mds set-max-mds", "max_mds": 1})
    return out


def test_multi_rank_equal(clusters, sequences):
    t, j = clusters
    mine, ref = _multi_rank(PKGS["torch"], t), _multi_rank(PKGS["jax"], j)
    assert mine == ref
    got = dict(mine)
    assert got["both ranks served"] is True and got["m2 rank"] == 1
    assert got["rank 1 refuses /b"][:2] == ("err", "_Err")
    assert got["m2 replayed"] > 0 and got["read back after"] == b"payload"


def test_stored_fs_objects_equal(clusters, sequences):
    t, j = clusters
    _wait(lambda: t.clean() and j.clean(), "clusters not clean")
    mine, ref = _stored(t), _stored(j)
    assert sorted(mine) == sorted(ref)
    for key in ref:
        assert mine[key] == ref[key], key
    names = {k[3] for k in mine}
    for want in ("o_mds_ino.1", "o_mds_dir.1"):
        assert want in names, want
    assert any(n.startswith("o_mds_journal") or "journal" in n for n in names), sorted(names)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tree_carried_across_packages(clusters, sequences, writer):
    """On the reader package's cluster: the writer package's MDS serves
    a client of each package at once; then a reader-package MDS takes
    over by replaying the writer's journal and serves the same tree."""
    t, j = clusters
    host = t if writer == "jax" else j
    w_ns, r_ns = PKGS[writer], PKGS["torch" if writer == "jax" else "jax"]
    writer_fleet, reader_fleet = _Fleet(w_ns, host), _Fleet(r_ns, host)
    rng = random.Random(len(writer))
    top = f"/carried-{writer}"
    try:
        writer_fleet.start_mds("w", flush_every=10_000)
        writer_fleet.wait_active("w")
        wc = writer_fleet.client("wc", "fsec")
        rc_ = reader_fleet.client("rc", "rep")
        model = {}
        wc.mkdir(top)
        for i in range(5):
            path, blob = f"{top}/w{i}", rng.randbytes(rng.randrange(1, 40000))
            wc.create(path)
            wc.write(path, 0, blob)
            model[path] = ("fsec", blob)
        for i in range(3):
            path, blob = f"{top}/r{i}", rng.randbytes(rng.randrange(1, 40000))
            rc_.create(path)
            rc_.write(path, 0, blob)
            model[path] = ("rep", blob)
        assert wc.readdir(top) == rc_.readdir(top) == sorted(p.rsplit("/", 1)[1] for p in model)
        for path, (pool, blob) in model.items():
            reader = wc if pool == "fsec" else rc_
            assert reader.read(path) == blob
            assert wc.stat(path) == rc_.stat(path)
        reader_fleet.start_mds("r", flush_every=10_000)
        writer_fleet.kill_mds("w")
        reader_fleet.wait_active("r")
        assert reader_fleet.mds["r"].replayed_entries > 0
        check = reader_fleet.client("check", "fsec")
        assert check.readdir(top) == sorted(p.rsplit("/", 1)[1] for p in model)
        for path, (pool, blob) in model.items():
            c = check if pool == "fsec" else rc_
            assert c.read(path) == blob
            assert check.stat(path)["size"] == len(blob)
        check.unlink(f"{top}/w0")
        assert "w0" not in rc_.readdir(top)
    finally:
        reader_fleet.shutdown()
        writer_fleet.shutdown()
