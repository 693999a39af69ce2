"""The port's device-resident payload plane (``ops/residency.py``) on the
CPU, mirroring the library-level cases of the JAX package's
``tests/test_residency.py``: DeviceBuf identity for crc and compare, a
stale buffer never serving a digest, invalidation on overwrite and
delete, generation and explicit invalidate, ``put_committed`` ignoring
a racing txn, eviction under pressure, batched encode identity, and
resident survivors riding the batched decode with zero upload."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ops.residency import bucket_pow2 as j_bucket_pow2
from ceph_tpu.osd.ec_pg import ECCodec as JCodec
from ceph_tpu_torch.native import ceph_crc32c
from ceph_tpu_torch.ops.kernel_stats import kernel_stats
from ceph_tpu_torch.ops.profiler import dispatch_profiler
from ceph_tpu_torch.ops.residency import (
    DeviceBuf,
    ResidencyCache,
    bucket_pow2,
    residency_cache,
)
from ceph_tpu_torch.ops.scrub_kernels import batch_compare, batch_crc32c
from ceph_tpu_torch.osd.ec_pg import ECCodec
from ceph_tpu_torch.store import ECStore, MemStore, ReplicatedStore, Transaction

RAGGED_SIZES = (0, 1, 5, 4096, 4097, 8192, 70001, 262144)
EC_PROFILE = {"k": "2", "m": "1", "technique": "reed_sol_van", "device": "cpu"}


def _payloads(sizes, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in sizes]


def _cpu_buf(data) -> DeviceBuf:
    return DeviceBuf(data=data, device="cpu")


def test_bucket_pow2():
    for n, floor in ((0, 1), (1, 1), (2, 1), (3, 1), (8, 1), (9, 1), (3, 8)):
        assert bucket_pow2(n, floor=floor) == j_bucket_pow2(n, floor=floor)
    assert bucket_pow2(9) == 16 and bucket_pow2(3, floor=8) == 8


def test_devicebuf_uploads_and_fetches_once():
    buf = _cpu_buf(b"abcdef")
    assert len(buf) == 6 and not buf.resident
    dev = buf.device()
    assert buf.resident and dev.dtype == torch.uint8 and dev.tolist() == list(b"abcdef")
    assert buf.device() is dev  # uploaded once
    assert buf.host() == b"abcdef" and buf.tobytes() == b"abcdef"
    born = DeviceBuf(dev=torch.arange(5, dtype=torch.uint8))
    assert born.resident and len(born) == 5 and born.torch_device.type == "cpu"
    assert born.host() is born.host()  # fetched once
    np.testing.assert_array_equal(np.asarray(born), np.arange(5, dtype=np.uint8))
    with pytest.raises(ValueError):
        DeviceBuf()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_encode_batch_byte_identity_ragged(backend):
    """Coalesced encode == per-op encode == the JAX package's, byte for
    byte, on ragged sizes including empty, sub-stripe, exact-stripe and
    seam-crossing payloads (stripe_width = k * 4096)."""
    prof = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "2", "m": "1", "w": "8"}
    codec = ECCodec({**prof, "device": "cpu"})
    jcodec = JCodec({**prof, "backend": backend if backend == "numpy" else "jax"})
    datas = _payloads((0, 1, 8191, 8192, 8193, 40000, 100000))
    for batch_n in (2, 3, len(datas)):
        subset = datas[:batch_n]
        batched = codec.encode_object_batch(subset)
        for data, got, want in zip(subset, batched, jcodec.encode_object_batch(subset)):
            assert got == codec.encode_object(data)
            assert got == want


def test_batch_crc32c_devicebuf_identity():
    bufs = _payloads(RAGGED_SIZES)
    want = np.array([ceph_crc32c(0xFFFFFFFF, b) for b in bufs], dtype=np.uint32)
    mixed = [_cpu_buf(b) if i % 2 else b for i, b in enumerate(bufs)]
    np.testing.assert_array_equal(batch_crc32c(mixed, 0xFFFFFFFF, device="cpu"), want)
    np.testing.assert_array_equal(batch_crc32c(bufs, 0xFFFFFFFF, device="cpu"), want)
    np.testing.assert_array_equal(batch_crc32c(mixed, 0xFFFFFFFF, backend="oracle"), want)


def test_batch_compare_devicebuf_identity():
    stored = _payloads((4096, 5000, 3, 0))
    expected = [
        stored[0],
        stored[1][:-1] + bytes([stored[1][-1] ^ 0xFF]),
        stored[2] + b"x",
        b"",
    ]
    want = [False, True, True, False]
    for variant in (
        stored,
        [_cpu_buf(s) for s in stored],
        [_cpu_buf(s) if i % 2 else s for i, s in enumerate(stored)],
    ):
        assert list(batch_compare(variant, expected, device="cpu")) == want
        assert list(batch_compare(variant, expected, backend="oracle")) == want


def test_stale_buffer_never_serves_scrub_digest_ec():
    """Injected bit rot rides a store txn; the txn bumps the shard's
    generation, so the resident (clean) copy misses and deep scrub
    audits the rotten bytes."""
    ecs = ECStore(profile=dict(EC_PROFILE), stripe_width=2 * 4096)
    ecs.put("victim", _payloads((50000,))[0])
    before = residency_cache().stats()
    res = ecs.scrub_batch(["victim"])["victim"]
    after = residency_cache().stats()
    assert res.clean
    assert after["hits"] >= before["hits"] + ecs.n
    ecs.corrupt_shard("victim", 1)
    res = ecs.scrub_batch(["victim"])["victim"]
    assert res.corrupt == [1], "a stale resident buffer served a scrub digest"
    assert ecs.scrub("victim").corrupt == res.corrupt


def test_invalidation_on_overwrite_and_delete():
    ecs = ECStore(profile=dict(EC_PROFILE), stripe_width=2 * 4096)
    a, b = _payloads((20000, 30000), seed=9)
    ecs.put("obj", a)
    ecs.put("obj", b)  # overwrite: old residency must not survive
    assert ecs.get("obj") == b
    assert ecs.scrub_batch(["obj"])["obj"].clean
    ecs.corrupt_shard("obj", 0)
    assert ecs.scrub_batch(["obj"])["obj"].corrupt == [0]
    ecs.lose_shard("obj", 2)
    assert 2 in ecs.scrub_batch(["obj"])["obj"].missing


def test_replicated_residency_scrub_and_bitrot():
    rs = ReplicatedStore(size=3, device="cpu")
    rs.put("rob", _payloads((45000,), seed=11)[0])
    before = residency_cache().stats()
    assert rs.scrub_batch(["rob"])["rob"].clean
    assert residency_cache().stats()["hits"] >= before["hits"] + 3
    raw = bytearray(rs.stores[2].read(rs.cid, "rob"))
    raw[100] ^= 0xFF
    rs.stores[2].queue_transaction(Transaction().write(rs.cid, "rob", 0, bytes(raw)))
    assert rs.scrub_batch(["rob"])["rob"].corrupt == [2]


def test_cache_generation_and_explicit_invalidate():
    cache = ResidencyCache(capacity_bytes=1 << 20)
    store = MemStore()
    store.queue_transaction(
        Transaction().create_collection("c").touch("c", "o").write("c", "o", 0, b"abc")
    )
    buf = cache.put(store, "c", "o", data=b"abc", device="cpu")
    assert cache.get(store, "c", "o") is buf
    assert cache.get(store, "c", "o", expect_len=99) is None  # len gate
    cache.put(store, "c", "o", data=b"abc", device="cpu")
    store.queue_transaction(Transaction().write("c", "o", 0, b"xyz"))
    assert cache.get(store, "c", "o") is None
    cache.put(store, "c", "o", data=b"xyz", device="cpu")
    cache.invalidate(store, "c", "o")
    assert cache.get(store, "c", "o") is None


def test_put_committed_ignores_racing_txn():
    """Another THREAD's txn lands between our commit and our
    registration: the entry binds the generation OUR txn assigned, so
    the racer's higher generation makes it miss."""
    cache = ResidencyCache(capacity_bytes=1 << 20)
    store = MemStore()
    store.queue_transaction(Transaction().create_collection("c"))
    store.queue_transaction(Transaction().touch("c", "o").write("c", "o", 0, b"OLD"))
    racer = threading.Thread(
        target=lambda: store.queue_transaction(Transaction().write("c", "o", 0, b"NEW"))
    )
    racer.start()
    racer.join(timeout=30)
    assert not racer.is_alive()
    cache.put_committed(store, "c", "o", data=b"OLD", device="cpu")
    assert cache.get(store, "c", "o") is None
    store.queue_transaction(Transaction().write("c", "o", 0, b"NEW2"))
    buf = cache.put_committed(store, "c", "o", data=b"NEW2", device="cpu")
    assert buf is not None
    assert cache.get(store, "c", "o") is buf


def test_remote_proxy_never_registers():
    cache = ResidencyCache(capacity_bytes=1 << 20)

    class Proxy(MemStore):
        residency_local = False

    assert cache.put(Proxy(), "c", "o", data=b"zz", device="cpu") is None


def test_eviction_under_memory_pressure():
    cache = ResidencyCache(capacity_bytes=10_000, ks=kernel_stats())
    store = MemStore()
    store.queue_transaction(Transaction().create_collection("c"))
    payload = b"x" * 3000
    for i in range(3):
        store.queue_transaction(Transaction().touch("c", f"o{i}").write("c", f"o{i}", 0, payload))
        cache.put(store, "c", f"o{i}", data=payload, device="cpu")
    assert cache.stats()["bytes_resident"] == 9000
    assert cache.get(store, "c", "o0") is not None  # o0 MRU; o1 the LRU victim
    store.queue_transaction(Transaction().touch("c", "o3").write("c", "o3", 0, payload))
    before_ev = cache.stats()["evictions"]
    cache.put(store, "c", "o3", data=payload, device="cpu")
    st = cache.stats()
    assert st["bytes_resident"] <= 10_000
    assert st["evictions"] == before_ev + 1
    assert cache.get(store, "c", "o1") is None
    assert cache.get(store, "c", "o0") is not None
    assert cache.get(store, "c", "o3") is not None
    # an over-capacity payload is refused, not thrashed through
    assert cache.put(store, "c", "o0", data=b"y" * 20_000, device="cpu") is None


def test_decode_batch_takes_resident_survivors_with_zero_upload():
    """Survivors already on the device ride the batched decode with no
    upload (the profiler's record says so), the rebuilt shards come back
    device-born, and the bytes equal the per-object decode."""
    codec = ECCodec({"plugin": "isa", "k": "4", "m": "2", "device": "cpu"})
    datas = _payloads((4 * 4096 * 3, 4 * 4096 * 2, 4 * 4096 * 3), seed=3)
    encoded = codec.encode_object_batch(datas)
    lost = {1, 4}
    resident = []
    for shards, _meta in encoded:
        row = {}
        for p, s in shards.items():
            if p not in lost:
                row[p] = DeviceBuf(dev=torch.from_numpy(np.frombuffer(s, np.uint8).copy()))
        resident.append(row)
    mixed = [dict(r) for r in resident]
    mixed[1] = {p: b.host() if p == 0 else b for p, b in mixed[1].items()}
    for sets, uploaded in ((resident, 0), (mixed, len(encoded[1][0][0]))):
        seq = dispatch_profiler().history()["entries"][-1]["seq"]
        rec = codec.decode_object_batch(sets, lost)
        (entry,) = [e for e in dispatch_profiler().history(kind="ec_decode")["entries"]
                    if e["seq"] > seq]
        assert entry["backend"] == "torch"
        assert entry["bytes_uploaded"] == uploaded
        assert entry["bytes_uploaded"] + entry["bytes_resident"] == entry["bytes_in"]
        for r, (shards, _meta) in zip(rec, encoded):
            for p in lost:
                assert isinstance(r[p], DeviceBuf) and r[p].resident
                assert r[p].host() == shards[p]
