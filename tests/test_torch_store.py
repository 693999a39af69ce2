"""The port's object stores and PG backends held against the JAX
package's on the CPU: the same writes through ``ECStore`` and
``ReplicatedStore`` of both packages leave the same shard bytes and
xattrs in every ``MemStore``, the same scrub findings, the same rebuilt
shards and the same reads (the messenger-free cases of the JAX package's
``tests/test_store.py``, ``tests/test_rmw.py`` and
``tests/test_replicated.py``); plus the transaction codec, the pool
factory and ``osd.ec_pg``'s store seams."""

from __future__ import annotations

import random
import threading

import numpy as np
import pytest

from ceph_tpu.common.encoding import Encoder as JEncoder
from ceph_tpu.ec.interface import ErasureCodeError as JErasureCodeError
from ceph_tpu.osd import ec_pg as j_ec_pg
from ceph_tpu.osd.osdmap import PgPool
from ceph_tpu.store import objectstore as j_objectstore
from ceph_tpu.store.ec_store import ECStore as JECStore
from ceph_tpu.store.replicated import ReplicatedStore as JReplicatedStore
from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.crush.types import PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED
from ceph_tpu_torch.ec import ErasureCodeError
from ceph_tpu_torch.osd import ec_pg
from ceph_tpu_torch.store import ECStore, MemStore, ReplicatedStore, Transaction
from ceph_tpu_torch.store.objectstore import StoreError, decode_transaction, encode_transaction
from ceph_tpu_torch.store.pg_backend import PGBackendError, build_pg_backend

RS42 = ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "8"})
RS32 = ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2", "w": "8"})
CLAY = ("clay", {"k": "4", "m": "2", "d": "5"})


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _twin_ec(plugin, prof, **kw):
    return (
        JECStore(plugin=plugin, profile=dict(prof), **kw),
        ECStore(plugin=plugin, profile={**prof, "device": "cpu"}, **kw),
    )


def _assert_same_state(j, t):
    """Every store of the two backends holds the same collections,
    objects, bytes and xattrs."""
    assert len(j.stores) == len(t.stores)
    for pos, (js, ts) in enumerate(zip(j.stores, t.stores)):
        assert js.list_collections() == ts.list_collections(), pos
        for cid in js.list_collections():
            assert js.list_objects(cid) == ts.list_objects(cid), (pos, cid)
            for oid in js.list_objects(cid):
                assert js.read(cid, oid) == ts.read(cid, oid), (pos, oid)
                assert js.list_attrs(cid, oid) == ts.list_attrs(cid, oid), (pos, oid)


def _assert_same_scrub(j, t, names):
    jb, tb = j.scrub_batch(names), t.scrub_batch(names)
    for name in names:
        for got in (tb[name], t.scrub(name)):
            want = jb[name]
            assert (got.missing, sorted(got.corrupt), got.inconsistent) == (
                want.missing, sorted(want.corrupt), want.inconsistent), name


def _model_write(model: bytearray, offset: int, data: bytes) -> None:
    if len(model) < offset + len(data):
        model.extend(b"\0" * (offset + len(data) - len(model)))
    model[offset : offset + len(data)] = data


# -- objectstore -------------------------------------------------------------


def test_transaction_atomicity_and_ops():
    st = MemStore()
    st.queue_transaction(Transaction().create_collection("c"))
    st.queue_transaction(Transaction().touch("c", "o").write("c", "o", 0, b"hello"))
    bad = Transaction().write("c", "o", 0, b"XXXXX").setattr("c", "missing", "a", b"v")
    with pytest.raises(StoreError):
        st.queue_transaction(bad)
    assert st.read("c", "o") == b"hello"
    st.queue_transaction(Transaction().touch("c", "p").write("c", "p", 4, b"data")
                         .setattr("c", "p", "k", b"v"))
    assert st.read("c", "p") == b"\0\0\0\0data" and st.read("c", "p", 4, 2) == b"da"
    assert st.getattr("c", "p", "k") == b"v" and st.stat("c", "p") == 8
    st.queue_transaction(Transaction().truncate("c", "p", 2))
    assert st.read("c", "p") == b"\0\0"
    assert st.list_objects("c") == ["o", "p"]
    st.queue_transaction(Transaction().remove("c", "p"))
    assert not st.exists("c", "p")
    with pytest.raises(StoreError):
        st.queue_transaction(Transaction().create_collection("c"))


def test_transaction_codec_matches_jax():
    def ops(txn_cls):
        return (txn_cls().create_collection("c").touch("c", "o").write("c", "o", 7, b"xyz")
                .setattr("c", "o", "a", b"\x00\x01").omap_setkeys("c", "o", {"k": b"v"})
                .truncate("c", "o", 3).clone("c", "o", "o2").remove("c", "o2"))

    e, je = Encoder(), JEncoder()
    encode_transaction(e, ops(Transaction))
    j_objectstore.encode_transaction(je, ops(j_objectstore.Transaction))
    assert e.getvalue() == je.getvalue()
    assert decode_transaction(Decoder(e.getvalue())).ops == ops(Transaction).ops


# -- ECStore -----------------------------------------------------------------


def test_put_get_scrub_match_jax():
    j, t = _twin_ec(*RS42)
    payloads = {"small": _bytes(1000, 0), "big": _bytes(100_000, 1), "empty": b""}
    for name, data in payloads.items():
        j.put(name, data)
        t.put(name, data)
    t.put("small", payloads["big"])  # overwrite updates hinfo
    j.put("small", payloads["big"])
    _assert_same_state(j, t)
    for name in payloads:
        assert t.get(name) == j.get(name)
        assert t.meta(name) == j.meta(name)
    assert t.get("small") == payloads["big"]
    _assert_same_scrub(j, t, list(payloads))


def test_degraded_read_and_faults_match_jax():
    j, t = _twin_ec(*RS42)
    data = _bytes(100_000, 2)
    for st in (j, t):
        st.put("obj", data)
        st.lose_shard("obj", 1)
        st.corrupt_shard("obj", 4, offset=17)
    assert t.get("obj") == j.get("obj") == data
    _assert_same_scrub(j, t, ["obj"])
    j.lose_shard("obj", 2)
    t.lose_shard("obj", 2)
    with pytest.raises(JErasureCodeError):
        j.get("obj")
    with pytest.raises(ErasureCodeError):
        t.get("obj")


@pytest.mark.parametrize("plugin,prof", [RS42, CLAY], ids=["jerasure", "clay"])
def test_recover_objects_batch_matches_jax(plugin, prof):
    """A dead position rebuilt for many objects in one batched decode
    (clay's fractional repair takes the per-object path on both sides),
    with a silently corrupt helper and an absent object among them."""
    j, t = _twin_ec(plugin, prof)
    names = [f"o{i}" for i in range(5)]
    for i, name in enumerate(names):
        data = _bytes(3 * t.sinfo.stripe_width + 100 * i, 10 + i)
        for st in (j, t):
            st.put(name, data)
    for st in (j, t):
        for name in names:
            st.lose_shard(name, 2)
        st.corrupt_shard("o3", 0, offset=5)
    jstats = j.recover_objects_batch(names + ["absent"], 2)
    tstats = t.recover_objects_batch(names + ["absent"], 2)
    for key in ("objects", "batched", "read_bytes", "survivor_shards"):
        assert tstats[key] == jstats[key], key
    _assert_same_state(j, t)
    _assert_same_scrub(j, t, names)
    for name in names:
        assert t.get(name) == j.get(name)


def test_recover_objects_batch_lets_device_errors_propagate(monkeypatch):
    """The batched recovery degrades to the per-object path only on
    ErasureCodeError or StoreError; a failed launch propagates."""
    _j, t = _twin_ec(*RS42)
    for i in range(3):
        t.put(f"o{i}", _bytes(2 * t.sinfo.stripe_width, 20 + i))
        t.lose_shard(f"o{i}", 1)

    def failing(*_a, **_kw):
        raise RuntimeError("gf8_bitplane_stripes launch failed: simulated")

    monkeypatch.setattr(t.ec.backend, "decode_stripes_batch", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        t.recover_objects_batch(["o0", "o1", "o2"], 1)


def test_recover_shard_reads_and_truncated_helper_match_jax():
    jc, tc = _twin_ec(*CLAY)
    jm, tm = _twin_ec(*RS42)
    data = _bytes(200_000, 3)
    for st in (jc, tc, jm, tm):
        st.put("obj", data)
        st.lose_shard("obj", 0)
    read = tc.recover_shard("obj", 0)
    assert read == jc.recover_shard("obj", 0)
    # clay reads 1/q = 1/2 of each of d = 5 helpers
    shard = tc.stores[1].stat("ec_pool", "obj")
    assert read / shard == pytest.approx(5 / 2, rel=0.01)
    tm.stores[1].queue_transaction(Transaction().truncate("ec_pool", "obj", 100))
    jm.stores[1].queue_transaction(j_objectstore.Transaction().truncate("ec_pool", "obj", 100))
    assert tm.recover_shard("obj", 0) == jm.recover_shard("obj", 0)
    for j, t in ((jc, tc), (jm, tm)):
        _assert_same_state(j, t)
        assert t.get("obj") == data
    assert tc.scrub("obj").clean


def test_rmw_random_offsets_match_model_and_jax():
    rng = random.Random(7)
    j, t = _twin_ec(*RS32)
    base = _bytes(20000, 4)
    j.put("obj", base)
    t.put("obj", base)
    model = bytearray(base)
    sw = t.sinfo.stripe_width
    for _ in range(25):
        offset = rng.randrange(0, 22000)
        length = rng.choice([1, 7, sw // 2, sw, sw + 3, 3 * sw - 1, 4096])
        fill = bytes(rng.randrange(256) for _ in range(length))
        assert t.write("obj", offset, fill) > 0
        j.write("obj", offset, fill)
        _model_write(model, offset, fill)
    assert t.get("obj") == bytes(model)
    _assert_same_state(j, t)
    _assert_same_scrub(j, t, ["obj"])
    # an overwritten object's hinfo is invalid: corruption is an
    # inconsistency, not an attributed shard
    j.corrupt_shard("obj", 4, offset=3)
    t.corrupt_shard("obj", 4, offset=3)
    _assert_same_scrub(j, t, ["obj"])
    assert t.scrub("obj").inconsistent


def test_rmw_grow_gap_degraded_and_missing_object_match_jax():
    j, t = _twin_ec(*RS32)
    sw = t.sinfo.stripe_width
    for st in (j, t):
        st.write("new", 100, b"hello")
        st.put("obj", b"A" * 5000)
        st.write("obj", 5000, b"B" * 100)
        st.write("obj", 5 * sw + 17, b"C" * 10)
        st.put("deg", bytes(range(256)) * (5 * sw // 256))
        st.lose_shard("deg", 0)
        st.write("deg", 2 * sw, b"Z" * 100)  # rebuilds shard 0 first
    assert t.get("new") == b"\0" * 100 + b"hello"
    model = bytearray(b"A" * 5000)
    _model_write(model, 5000, b"B" * 100)
    _model_write(model, 5 * sw + 17, b"C" * 10)
    assert t.get("obj") == bytes(model)
    _assert_same_state(j, t)
    _assert_same_scrub(j, t, ["new", "obj", "deg"])


def test_concurrent_writes_commit_in_submission_order():
    _j, t = _twin_ec(*RS32)
    t.put("obj", b"\0" * 8192)
    seqs = {}
    barrier = threading.Barrier(4)

    def writer(i):
        barrier.wait(timeout=30)
        seqs[i] = t.write("obj", 100, bytes([i]) * 3000)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    final = t.get("obj")[100:3100]
    assert len(set(final)) == 1
    assert seqs[final[0]] == max(seqs.values())
    assert t.scrub("obj").clean


def test_extent_cache_and_put_invalidation():
    _j, t = _twin_ec(*RS32)
    sw = t.sinfo.stripe_width
    t.put("obj", b"Q" * 8192)
    ticket = t._enter("obj")
    try:
        t.extent_cache.put("obj", 0, b"R" * sw)
        assert t.extent_cache.get("obj", 0) == b"R" * sw
    finally:
        t._exit("obj", ticket)
    assert t.extent_cache.get("obj", 0) is None
    t.extent_cache.open("o")
    try:
        t.put("o", b"\0" * (4 * sw))
        t.write("o", 10, b"\x11" * 8)
        t.put("o", b"\x42" * (4 * sw))
        t.write("o", sw + 5, b"\x33" * 8)
    finally:
        t.extent_cache.close("o")
    model = bytearray(b"\x42" * (4 * sw))
    model[sw + 5 : sw + 13] = b"\x33" * 8
    assert t.get("o") == bytes(model)
    assert t.scrub("o").clean


# -- ReplicatedStore -----------------------------------------------------------


def _twin_rep(size=3):
    return JReplicatedStore(size=size), ReplicatedStore(size=size, device="cpu")


def test_replicated_writes_reads_and_overwrites_match_jax():
    j, t = _twin_rep()
    rng = random.Random(7)
    model = bytearray()
    for st in (j, t):
        st.put("a", b"hello world")
        st.put("o", b"")
    for _ in range(30):
        off = rng.randrange(0, 5000)
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 400)))
        j.write("o", off, data)
        t.write("o", off, data)
        _model_write(model, off, data)
    assert t.get("o") == bytes(model) and t.get("a") == b"hello world"
    _assert_same_state(j, t)
    _assert_same_scrub(j, t, ["a", "o"])


def test_replicated_faults_scrub_and_recovery_match_jax():
    j, t = _twin_rep()
    for st in (j, t):
        st.put("a", b"x" * 4096)
        st.corrupt_replica("a", 1)
        st.lose_replica("a", 2)
        st.put("d", b"y" * 100)
        st.write("d", 10, b"zz")  # digest invalidated: majority decides
        st.corrupt_replica("d", 2)
        st.put("f", b"payload-bytes")
        st.corrupt_replica("f", 0)
    _assert_same_scrub(j, t, ["a", "d", "f"])
    assert t.scrub("a").missing == [2] and t.scrub("a").corrupt == [1]
    assert t.get("f") == b"payload-bytes"  # replica fallback
    assert t.pending_repair.get("f") == {0}
    for st in (j, t):
        for name, rep in (("a", 1), ("a", 2), ("d", 2), ("f", 0)):
            st.recover_replica(name, rep)
    _assert_same_state(j, t)
    for name in ("a", "d", "f"):
        assert t.scrub(name).clean
    for i in range(3):
        t.lose_replica("f", i)
    with pytest.raises(StoreError):
        t.get("f")


def test_replicated_degraded_overwrite_recovers_first_like_jax():
    j, t = _twin_rep()
    for st in (j, t):
        st.put("x", b"D" * 3000)
        st.lose_replica("x", 1)
        st.lose_replica("x", 2)
        st.write("x", 0, b"p")
    assert t.get("x") == b"p" + b"D" * 2999
    _assert_same_state(j, t)
    assert t.scrub("x").clean


# -- the pool factory and ec_pg's store seams ------------------------------------


def test_pg_backend_factory_dispatch():
    be = build_pg_backend(PgPool(pool_id=1, type=PG_POOL_TYPE_REPLICATED, size=3))
    assert isinstance(be, ReplicatedStore) and be.size == 3
    ec_pool = PgPool(pool_id=2, type=PG_POOL_TYPE_ERASURE, size=5,
                     erasure_code_profile="myprofile")
    profiles = {"myprofile": {"plugin": "jerasure", "technique": "reed_sol_van",
                              "k": "3", "m": "2", "w": "8", "device": "cpu"}}
    be = build_pg_backend(ec_pool, profiles)
    assert isinstance(be, ECStore) and be.k == 3 and be.n == 5
    assert be.device.type == "cpu"
    with pytest.raises(PGBackendError):
        build_pg_backend(ec_pool, {})
    with pytest.raises(PGBackendError):
        build_pg_backend(PgPool(pool_id=3, type=99))


def test_ec_pg_store_seams_match_jax():
    prof = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "3", "m": "2", "w": "8"}
    codec = ec_pg.ECCodec({**prof, "device": "cpu"})
    jcodec = j_ec_pg.ECCodec(prof)
    j, t = _twin_ec(prof["plugin"], {k: v for k, v in prof.items() if k != "plugin"})
    data = _bytes(5 * t.sinfo.stripe_width + 11, 6)
    j.put("obj", data)
    t.put("obj", data)
    got = ec_pg.rmw_write_txns(codec, t, "ec_pool", "obj", 5000, b"W" * 3000, range(5), len(data))
    want = j_ec_pg.rmw_write_txns(jcodec, j, "ec_pool", "obj", 5000, b"W" * 3000, range(5),
                                  len(data))
    assert sorted(got) == sorted(want)
    for pos in got:
        assert got[pos].ops == want[pos].ops
    meta = {"size": 3, "hashes": [1, 2, 3]}
    assert ec_pg.shard_write_txn("c", "o", b"abc", meta, {"x": b"y"}).ops == \
        j_ec_pg.shard_write_txn("c", "o", b"abc", meta, {"x": b"y"}).ops
    # an unreachable position reads as a dead shard: degraded reads and
    # the batched scrub see it as missing
    dead = ec_pg.UnreachableStore()
    with pytest.raises(StoreError):
        dead.read("ec_pool", "obj")
    assert not ec_pg.UnreachableStore.residency_local
    view = ECStore(plugin="jerasure", profile=dict(codec.ec.get_profile()),
                   stores=[t.stores[0], dead] + t.stores[2:], ensure_collections=False)
    assert view.get("obj") == data
    assert view.scrub_batch(["obj"])["obj"].missing == [1]
