"""The port's block images held against the JAX package's on live
clusters, on the CPU.

A JAX and a port cluster side by side (``tests/test_torch_cluster.py``'s
``Cluster``: a monitor, 5 OSDs over MemStore and a client each; a
3-replica pool and an isa k=3 m=2 pool at pg_num 4; the port's OSDs on
``device="cpu"``). The same seeded sequence of image operations runs
on both clusters, in both pools, each package driving its own cluster
through its own ``rbd``: create with features, striped writes across
object boundaries (stripe_count 4), reads, discards, resizes,
snapshots and reads at a snapshot, clone, copy-up and flatten, the
object map's diff and du, and a cached image's write-back.

Equal, exactly: every result and every error; the stored objects at
each acting position of every PG (header omap, ``rbd_directory``, data
shards and hinfo, object-map bytes, journal objects); the JSON and text
that ``rbd_cli``'s ``info``, ``ls``, ``snap ls``, ``diff`` and ``du``
print. Across the packages on one cluster: an image the JAX ``rbd``
wrote reads equal through the port's ``rbd`` (its on-disk format is the
state carried across), a JAX holder of an image's exclusive lock hands
it to a port contender, and the port's ``MirrorDaemon`` replays a
journal the JAX ``rbd`` wrote.

The JAX isa codes need ``ErasureCodeIsa.w = 8`` for an EC pool
(ROADMAP §C); it is set for this module only, as in the cluster test.
"""

from __future__ import annotations

import random
import re

import pytest

import ceph_tpu.ec.isa as jisa
import ceph_tpu.msg as jmsg
import ceph_tpu.rbd as jrbd
import ceph_tpu.tools.rbd_cli as jrbd_cli
from ceph_tpu.osdc.striper import StripeLayout as JStripeLayout
from ceph_tpu.osdc.striper import map_extent as jmap_extent
from ceph_tpu.rados import Rados as JRados
from ceph_tpu.rbd.object_map import ObjectMap as JObjectMap
import ceph_tpu_torch.rbd as trbd
import ceph_tpu_torch.tools.rbd_cli as trbd_cli
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.msg import NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.osdc.striper import StripeLayout, map_extent
from ceph_tpu_torch.rados import Rados
from ceph_tpu_torch.rbd.mirror import MirrorDaemon
from ceph_tpu_torch.rbd.object_map import ObjectMap

from test_torch_cluster import Cluster, _stored, _wait

FEATURES = "exclusive-lock,object-map,journaling"


@pytest.mark.parametrize("layout", [(4096, 3, 8192), (1024, 4, 4096), (65536, 1, 1 << 22),
                                    (16384, 4, 65536), (4096, 8, 1 << 20)])
def test_striper_extents_equal(layout):
    rng = random.Random(sum(layout))
    mine, ref = StripeLayout(*layout), JStripeLayout(*layout)
    for _ in range(200):
        off = rng.randrange(0, 1 << 24)
        ln = rng.randrange(1, 1 << 18)
        got = map_extent(mine, off, ln)
        assert got == jmap_extent(ref, off, ln)
        assert sum(n for _o, _off, n in got) == ln


class _FakeIo:
    """Holds what an ObjectMap saves (write_full) and serves it back."""

    def __init__(self, not_found):
        self.objects, self.not_found = {}, not_found

    def write_full(self, oid, data):
        self.objects[oid] = bytes(data)

    def read(self, oid, length=-1, offset=0, snapid=None):
        if oid not in self.objects:
            raise self.not_found(oid)
        return self.objects[oid]

    def remove(self, oid):
        self.objects.pop(oid, None)


def test_object_map_bytes_equal():
    from ceph_tpu.osdc.objecter import ObjectNotFound as JNotFound
    from ceph_tpu_torch.osdc.objecter import ObjectNotFound

    saved = []
    for cls, nf in ((ObjectMap, ObjectNotFound), (JObjectMap, JNotFound)):
        io = _FakeIo(nf)
        m = cls(io, "rbd_object_map.x", 37)
        m.load()
        m.pre_write_many([0, 3, 36, 5])
        m.snap_create(11)
        m.pre_write(3)
        m.pre_write(7)
        m.post_remove(5)
        m.resize(50)
        m.pre_write(49)
        m.save()
        answers = (m.existing_objects(), m.diff(11, ()), m.used_objects())
        m.snap_remove(11, None)
        m.resize(20)
        m.save()
        saved.append((answers, m.existing_objects(), dict(sorted(io.objects.items()))))
    assert saved[0] == saved[1]


def _payload(rng: random.Random, n: int) -> bytes:
    return rng.randbytes(n)


def _scenario(rbd_mod, io, seed: int) -> list:
    """One seeded run of image operations; every result or error."""
    rng = random.Random(seed)
    out = []

    def rec(label, fn):
        try:
            got = fn()
        except Exception as e:  # noqa: BLE001 — errors are results here
            got = ("err", type(e).__name__, str(e))
        out.append((label, got))
        return got

    RBD, Image = rbd_mod.RBD, rbd_mod.Image
    rbd = RBD()
    size = 1 << 20
    rec("create", lambda: rbd.create(io, "img", size, stripe_unit=16384, stripe_count=4,
                                     object_size=65536, features=FEATURES))
    rec("create again", lambda: rbd.create(io, "img", 1))
    rec("bad features", lambda: rbd.create(io, "bad", 1, features="frobnicate"))
    rec("open missing", lambda: Image(io, "missing"))
    img = Image(io, "img")
    try:
        for i in range(10):
            off = rng.randrange(0, size - 1)
            data = _payload(rng, rng.randint(1, min(150000, size - off)))
            rec(f"write {i}", lambda: img.write(off, data))
            roff = rng.randrange(0, size - 1)
            rec(f"read {i}", lambda: img.read(roff, rng.randint(1, 90000)))
        rec("write past end", lambda: img.write(size - 4, b"12345678"))
        rec("discard partial", lambda: img.discard(70000, 30000))
        rec("discard whole", lambda: img.discard(0, 262144))
        rec("stat", img.stat)
        rec("snap s1", lambda: img.snap_create("s1"))
        for i in range(4):
            off = rng.randrange(0, size - 1)
            data = _payload(rng, rng.randint(1, min(80000, size - off)))
            rec(f"write after snap {i}", lambda: img.write(off, data))
        rec("diff all", lambda: img.diff_objects())
        rec("diff s1", lambda: img.diff_objects("s1"))
        rec("used", img.used_objects)
        rec("read head", lambda: img.read(0, size))
        rec("set snap", lambda: img.set_snap("s1"))
        rec("read s1", lambda: img.read(0, size))
        rec("set head", lambda: img.set_snap(None))
        rec("resize down", lambda: img.resize(300000))
        rec("read shrunk", lambda: img.read(0, size))
        rec("resize up", lambda: img.resize(800000))
        rec("read grown", lambda: img.read(0, 800000))
        rec("snap s2", lambda: img.snap_create("s2"))
        rec("snaps", img.snap_list)
        rec("diff s2", lambda: img.diff_objects("s2"))
    finally:
        img.close()

    rec("clone", lambda: rbd.clone(io, "img", "s1", "kid"))
    rec("clone of missing snap", lambda: rbd.clone(io, "img", "nope", "kid2"))
    kid = Image(io, "kid")
    try:
        rec("kid parent", lambda: kid.parent)
        rec("kid read", lambda: kid.read(0, 200000))
        rec("kid copy-up write", lambda: kid.write(5000, _payload(rng, 3000)))
        rec("kid discard", lambda: kid.discard(65536, 70000))
        rec("kid read after", lambda: kid.read(0, 300000))
        rec("kid flatten", kid.flatten)
        rec("kid parent after", lambda: kid.parent)
        rec("kid read flat", lambda: kid.read(0, size))
    finally:
        kid.close()

    rec("create cached", lambda: rbd.create(io, "cimg", 512 * 1024, stripe_unit=65536,
                                            object_size=131072))
    cimg = Image(io, "cimg", cache=True, cache_opts=dict(flush_age=3600.0))
    try:
        for i in range(48):
            off = rng.randrange(0, 128) * 4096
            data = _payload(rng, 4096)
            rec(f"cached write {i}", lambda: cimg.write(off, data))
        rec("cached read", lambda: cimg.read(0, 512 * 1024))
        rec("cached flush", cimg.flush)
        rec("cacher backend writes", lambda: cimg._cache.backend_writes)
    finally:
        cimg.close()
    plain = Image(io, "cimg")
    try:
        rec("uncached read", lambda: plain.read(0, 512 * 1024))
    finally:
        plain.close()

    rec("create doomed", lambda: rbd.create(io, "doomed", 200000, stripe_unit=65536,
                                            object_size=65536))

    def doomed_write():
        with Image(io, "doomed") as d:
            d.write(0, _payload(rng, 150000))

    rec("doomed write", doomed_write)
    rec("ls", lambda: rbd.list(io))
    rec("remove", lambda: rbd.remove(io, "doomed"))
    rec("ls after", lambda: rbd.list(io))
    return out


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


@pytest.fixture(scope="module")
def scenario(clusters):
    t, j = clusters
    got = {}
    for pool in ("rep", "ec"):
        got[pool] = (_scenario(trbd, t.rados.open_ioctx(pool), 17),
                     _scenario(jrbd, j.rados.open_ioctx(pool), 17))
    return got


@pytest.mark.parametrize("pool", ["rep", "ec"])
def test_image_operations_equal(scenario, pool):
    mine, ref = scenario[pool]
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a == b, a[0]
    errors = [r for r in mine if isinstance(r[1], tuple) and r[1][:1] == ("err",)]
    assert {r[0] for r in errors} == {"create again", "bad features", "open missing",
                                      "write past end", "clone of missing snap"}


_LOCK_HOLDER = re.compile(rb'"[0-9a-f]+:[0-9]+": [0-9.e+]+')


def _identity_free(stored: dict) -> dict:
    """The stored objects with each client's identity masked: a header
    snapshot taken under the exclusive lock keeps the holder's watch
    (``w_<cookie>``) and its lock record (client id, watch cookie,
    time), which differ between any two clients."""
    out = {}
    for key, (data, attrs, omap) in stored.items():
        attrs = {("w_<cookie>" if k.startswith("w_") else k):
                 (_LOCK_HOLDER.sub(b'"<holder>": 0', v) if k == "c_cls_lock" else v)
                 for k, v in attrs.items()}
        out[key] = (data, attrs, omap)
    return out


def test_stored_rbd_objects_equal(clusters, scenario):
    t, j = clusters
    _wait(lambda: t.clean() and j.clean(), "clusters not clean")
    mine, ref = _identity_free(_stored(t)), _identity_free(_stored(j))
    assert sorted(mine) == sorted(ref)
    for key in ref:
        assert mine[key] == ref[key], key
    names = {k[3] for k in mine}
    for want in ("o_rbd_directory", "o_rbd_header.img", "o_rbd_object_map.img",
                 "o_rbd_journal.img.head", "o_rbd_data.img.0000000000000000",
                 "o_rbd_data.cimg.0000000000000000"):
        assert want in names, want


def _cli(mod, cluster, pool, args, capsys) -> tuple:
    host, port = cluster.mon_addr
    rc = mod.main(["-m", f"{host}:{port}", "-p", pool] + args)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


@pytest.mark.parametrize("pool", ["rep", "ec"])
def test_rbd_cli_outputs_equal(clusters, scenario, pool, capsys):
    t, j = clusters
    for args in (["info", "img"], ["info", "kid"], ["ls"], ["snap", "ls", "img"],
                 ["diff", "img"], ["diff", "img", "--from-snap", "s1"], ["du", "img"],
                 ["info", "missing"], ["lock", "status", "img"]):
        mine = _cli(trbd_cli, t, pool, args, capsys)
        ref = _cli(jrbd_cli, j, pool, args, capsys)
        assert mine == ref, args
    assert '"name": "img"' in _cli(trbd_cli, t, pool, ["info", "img"], capsys)[1]


def test_jax_written_image_reads_through_the_port(clusters):
    """A JAX client writes an image into the port's cluster; the port's
    rbd opens and reads it, and writes to it that the JAX rbd reads."""
    t, _j = clusters
    SIZE = 5 * 4 * 32768  # whole object sets (see the next test)
    guest = JRados("jax-rbd").connect(*t.mon_addr)
    try:
        rng = random.Random(5)
        for pool in ("rep", "ec"):
            gio, hio = guest.open_ioctx(pool), t.rados.open_ioctx(pool)
            jrbd.RBD().create(gio, "carried", SIZE, stripe_unit=8192, stripe_count=4,
                              object_size=32768, features="exclusive-lock,object-map")
            model = bytearray(SIZE)
            with jrbd.Image(gio, "carried") as im:
                for _ in range(6):
                    off = rng.randrange(0, SIZE - 10000)
                    data = rng.randbytes(rng.randint(1, SIZE - off))
                    im.write(off, data)
                    model[off:off + len(data)] = data
                im.snap_create("frozen")
                jdiff = im.diff_objects()
            with trbd.Image(hio, "carried") as im:
                assert im.read(0, SIZE) == bytes(model)
                assert im.diff_objects() == jdiff
                assert im.snap_list() == ["frozen"]
                im.write(1000, b"port" * 1000)
                model[1000:5000] = b"port" * 1000
            with jrbd.Image(gio, "carried") as im:
                assert im.read(0, SIZE) == bytes(model)
    finally:
        guest.shutdown()


def test_exclusive_lock_hands_off_from_jax_holder_to_port(clusters):
    t, _j = clusters
    guest = JRados("jax-holder").connect(*t.mon_addr)
    try:
        gio, hio = guest.open_ioctx("rep"), t.rados.open_ioctx("rep")
        jrbd.RBD().create(gio, "locked", 262144, stripe_unit=65536, object_size=65536,
                          features="exclusive-lock,object-map")
        holder = jrbd.Image(gio, "locked")
        contender = trbd.Image(hio, "locked")
        try:
            holder.write(0, b"J" * 8192)
            assert holder.is_lock_owner()
            first = holder.lock_holder()
            contender.write(8192, b"T" * 8192)  # requests the lock; the holder hands off
            assert contender.is_lock_owner()
            assert wait_for(lambda: not holder.is_lock_owner(), 10.0)
            assert contender.lock_holder() != first
            assert contender.read(0, 16384) == b"J" * 8192 + b"T" * 8192
            holder.write(16384, b"K" * 4096)  # and back again
            assert holder.is_lock_owner()
            assert holder.read(0, 20480) == b"J" * 8192 + b"T" * 8192 + b"K" * 4096
        finally:
            contender.close()
            holder.close()
    finally:
        guest.shutdown()


def test_port_mirror_replays_a_jax_journal(clusters):
    """The JAX rbd writes a journaled image into the port cluster's
    replicated pool; the port's MirrorDaemon replays it into the
    erasure pool, then replays a later tail."""
    t, _j = clusters
    guest = JRados("jax-journal").connect(*t.mon_addr)
    try:
        gio = guest.open_ioctx("rep")
        src, dst = t.rados.open_ioctx("rep"), t.rados.open_ioctx("ec")
        jrbd.RBD().create(gio, "mirrored", 400000, stripe_unit=65536, object_size=65536,
                          features="journaling")
        rng = random.Random(9)
        with jrbd.Image(gio, "mirrored") as im:
            for _ in range(5):
                off = rng.randrange(0, 390000)
                im.write(off, rng.randbytes(rng.randint(1, 400000 - off)))
        d = MirrorDaemon(src, dst, interval=0.0)
        try:
            d.replay_once()
            with jrbd.Image(gio, "mirrored") as im:
                im.discard(0, 65536)
                im.write(300000, b"tail" * 2000)
                im.resize(500000)
                im.write(450000, b"end" * 1000)
                want = im.read(0, 500000)
            assert d.replay_once() == 4
            with trbd.Image(dst, "mirrored") as out:
                assert out.size() == 500000
                assert out.read(0, 500000) == want
        finally:
            d.stop()
    finally:
        guest.shutdown()


def test_aio_writes_beyond_the_io_pool_complete(clusters):
    """More aio writes in flight than the image's I/O workers: each one
    waits on its own per-object fan-out, so they must not share that
    pool (the JAX image deadlocks here; ROADMAP §C)."""
    t, _j = clusters
    io = t.rados.open_ioctx("ec")
    trbd.RBD().create(io, "aio", 1 << 20, stripe_unit=65536, object_size=65536)
    rng = random.Random(3)
    model = bytearray(1 << 20)
    with trbd.Image(io, "aio") as im:
        futs = []
        # distinct blocks: concurrent writes to one block land in any order
        for blk in rng.sample(range(256), 3 * trbd._IO_WORKERS):
            off = blk * 4096
            data = rng.randbytes(4096)
            model[off:off + 4096] = data
            futs.append(im.aio_write(off, data))
            if len(futs) >= 2 * trbd._IO_WORKERS:
                assert futs.pop(0).result(timeout=60) == 4096
        for f in futs:
            assert f.result(timeout=60) == 4096
        assert im.aio_read(0, 1 << 20).result(timeout=60) == bytes(model)


def test_partial_last_object_set_is_mapped_whole(clusters):
    """An image of 600000 bytes striped 4 wide over 32 KiB objects ends
    in a partial object set whose stripe units reach objects 16 to 19,
    while the last byte lies in object 17. The JAX image sizes its object
    map (and its removal and flatten loops) from the object of the last
    byte, so a write inside the image fails there; the port's maps
    every object the image spans (ROADMAP §C)."""
    t, j = clusters
    for rbd_mod, c in ((trbd, t), (jrbd, j)):
        io = c.rados.open_ioctx("rep")
        rbd_mod.RBD().create(io, "partial", 600000, stripe_unit=8192, stripe_count=4,
                             object_size=32768, features="exclusive-lock,object-map")
    with trbd.Image(t.rados.open_ioctx("rep"), "partial") as im:
        assert im.stat()["num_objs"] == 20
        assert im.write(548864, b"x" * 100) == 100  # object 19
        assert im.read(548864, 100) == b"x" * 100
        assert 19 in im.diff_objects()
    trbd.RBD().remove(t.rados.open_ioctx("rep"), "partial")
    assert not [n for n in t.rados.open_ioctx("rep").list_objects()
                if n.startswith("rbd_data.partial")]
    with jrbd.Image(j.rados.open_ioctx("rep"), "partial") as im:
        assert im.stat()["num_objs"] == 18
        with pytest.raises(IndexError):
            im.write(548864, b"x" * 100)
