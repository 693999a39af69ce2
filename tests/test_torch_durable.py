"""The port's durable stores held against the JAX package's on the CPU:
the same seeded transactions go into a JAX store and a port store
(``BlockStore``, ``KStore``, and a ``WALStore`` over each) and leave the
same objects, attrs and omaps; each package mounts the directories the
other wrote and reads the same state; WAL replay counts and torn-tail
truncation match; ``fsck``, the compressor plugins and
``objectstore_tool`` export/import match.

Which files are byte-equal, and why: all of them.  No file of these
stores carries a time, a process id or a random nonce: ``block.dev``
holds the extents the shared first-fit allocator placed, the KV logs
and snapshots hold the same encoders' records under the same crc32c,
``wal.log`` holds one framed record per transaction in commit order,
and the WAL's drain applies one record per inner commit in that same
order, so even the inner store under a WAL (whose apply runs on a
thread) writes the same frames.  Only cephx's sealed blobs, outside
these stores, differ from run to run (``tests/test_torch_auth.py``)."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

import ceph_tpu.compressor as jcompressor
from ceph_tpu.store import objectstore as j_objectstore
from ceph_tpu.store.blockstore import BlockStore as JBlockStore
from ceph_tpu.store.kstore import KStore as JKStore
from ceph_tpu.store.wal_store import WALStore as JWALStore
from ceph_tpu.tools import objectstore_tool as j_tool
import ceph_tpu_torch.compressor as compressor
from ceph_tpu_torch.common.encoding import Encoder
from ceph_tpu_torch.store import BlockStore, KStore, MemStore, Transaction, WALStore
from ceph_tpu_torch.store.framed_log import append_frame
from ceph_tpu_torch.store.objectstore import StoreError, encode_transaction
from ceph_tpu_torch.store.wal_store import encode_wal_record, make_wal_record
from ceph_tpu_torch.tools import objectstore_tool

PKG = {
    "torch": {"block": BlockStore, "k": KStore, "wal": WALStore, "txn": Transaction},
    "jax": {
        "block": JBlockStore, "k": JKStore, "wal": JWALStore,
        "txn": j_objectstore.Transaction,
    },
}


def _seeded_txns(seed: int, txn_cls, n: int = 40) -> list:
    """A seeded run of valid transactions over two collections: writes
    across block boundaries, overwrites, truncates, attrs, omaps,
    clones and removes."""
    rng = np.random.default_rng(seed)
    colls = ["pg_1.0", "pg_1.1"]
    live: dict[str, set] = {c: set() for c in colls}
    out = [txn_cls().create_collection(colls[0]).create_collection(colls[1])]
    for _ in range(n):
        cid = colls[int(rng.integers(2))]
        oid = f"obj{int(rng.integers(6))}"
        txn = txn_cls()
        op = int(rng.integers(8)) if oid in live[cid] else 0
        if op in (0, 1):
            size = int(rng.choice([1, 100, 4096, 5000, 20000]))
            off = int(rng.integers(0, 9000))
            data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            txn.write(cid, oid, off, data)
            live[cid].add(oid)
        elif op == 2:
            txn.truncate(cid, oid, int(rng.integers(0, 12000)))
        elif op == 3:
            txn.setattr(cid, oid, f"a{int(rng.integers(3))}", rng.bytes(int(rng.integers(0, 30))))
        elif op == 4:
            txn.omap_setkeys(cid, oid, {f"k{int(rng.integers(5))}": rng.bytes(8) for _ in range(3)})
        elif op == 5:
            txn.omap_rmkeys(cid, oid, ["k0", "k1"])
        elif op == 6:
            dst = f"obj{int(rng.integers(6))}"
            if dst != oid:
                txn.clone(cid, oid, dst)
                live[cid].add(dst)
            else:
                txn.touch(cid, oid)
        else:
            txn.remove(cid, oid)
            live[cid].discard(oid)
        out.append(txn)
    return out


def _dump(store) -> dict:
    out = {}
    for cid in store.list_collections():
        for oid in store.list_objects(cid):
            out[(cid, oid)] = (
                store.read(cid, oid),
                store.list_attrs(cid, oid),
                store.omap_get(cid, oid),
            )
    return out


def _open(pkg: str, kind: str, root: pathlib.Path):
    cls = PKG[pkg]
    if kind in ("block", "k"):
        return cls[kind](root / "data", sync=False)
    inner = cls[kind.split("+")[1]](root / "data", sync=False)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return cls["wal"](inner, root / "wal", **kw)


def _close(store) -> None:
    store.close()  # a WALStore closes its inner store too


def _files(root: pathlib.Path) -> dict[str, bytes]:
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(root.rglob("*"))
        if p.is_file()
    }


KINDS = ["block", "k", "wal+block", "wal+k"]


@pytest.mark.parametrize("kind", KINDS)
def test_same_txns_same_state_and_cross_mount(kind, tmp_path):
    roots = {pkg: tmp_path / pkg for pkg in PKG}
    dumps = {}
    for pkg, root in roots.items():
        store = _open(pkg, kind, root)
        for txn in _seeded_txns(3, PKG[pkg]["txn"]):
            store.queue_transaction(txn)
        if kind.startswith("wal"):
            assert store.flush()
            store.compact()  # a checkpoint, so wal.ckpt is compared too
        dumps[pkg] = _dump(store)
        _close(store)
    assert dumps["torch"] == dumps["jax"]
    assert len(dumps["torch"]) >= 4
    # each package mounts the other's directories and reads the same
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        store = _open(reader, kind, roots[writer])
        assert _dump(store) == dumps[writer]
        if kind == "block":
            assert store.fsck() == []
        _close(store)
    # byte-equal files (see the module docstring for why)
    files = {pkg: _files(root) for pkg, root in roots.items()}
    assert sorted(files["torch"]) == sorted(files["jax"])
    for name in files["torch"]:
        assert files["torch"][name] == files["jax"][name], name


@pytest.mark.parametrize("codec", ["zlib", "none"])
def test_blockstore_compression_files_byte_equal(codec, tmp_path):
    dumps, files = {}, {}
    for pkg in PKG:
        store = PKG[pkg]["block"](tmp_path / pkg, sync=False, compression=codec)
        txn = PKG[pkg]["txn"]().create_collection("c")
        txn.write("c", "text", 0, b"compressible " * 4000)
        txn.write("c", "rand", 0, np.random.default_rng(1).bytes(9000))
        store.queue_transaction(txn)
        dumps[pkg] = _dump(store)
        assert store.fsck() == []
        store.close()
        files[pkg] = _files(tmp_path / pkg)
    assert dumps["torch"] == dumps["jax"]
    assert files["torch"] == files["jax"]


def test_blockstore_bitrot_caught_on_read_and_fsck_like_jax(tmp_path):
    verdicts = {}
    for pkg in PKG:
        store = PKG[pkg]["block"](tmp_path / pkg, sync=False)
        store.queue_transaction(
            PKG[pkg]["txn"]().create_collection("c").write("c", "o", 0, b"x" * 10000)
        )
        store.close()
        with open(tmp_path / pkg / "block.dev", "r+b") as f:
            f.seek(100)
            f.write(b"\xff")
        store = PKG[pkg]["block"](tmp_path / pkg, sync=False)
        with pytest.raises((StoreError, j_objectstore.StoreError)) as err:
            store.read("c", "o")
        verdicts[pkg] = (str(err.value), store.fsck())
        store.close()
    assert verdicts["torch"] == verdicts["jax"]
    assert verdicts["torch"][1]


def _crash(store) -> None:
    """SIGKILL stand-in: abandon without close or flush."""
    store._closed = True


@pytest.mark.parametrize("inner", ["block", "k"])
def test_wal_replay_counts_match_jax(inner, tmp_path):
    """Committed-but-unapplied records replay exactly once, with the
    same count in both packages, and every acknowledged write reads
    back; the log itself is byte-equal."""
    results = {}
    for pkg in PKG:
        root = tmp_path / pkg
        store = _open(pkg, f"wal+{inner}", root)
        txns = _seeded_txns(9, PKG[pkg]["txn"], n=30)
        for txn in txns[:10]:
            store.queue_transaction(txn)
        assert store.flush()
        store.drain_paused = True
        for txn in txns[10:]:
            store.queue_transaction(txn)
        acked = _dump(store)
        _crash(store)
        store.inner.close()
        again = _open(pkg, f"wal+{inner}", root)
        results[pkg] = (again.replayed_records, _dump(again), (root / "wal" / "wal.log").read_bytes())
        assert results[pkg][1] == acked
        _close(again)
    assert results["torch"][0] == results["jax"][0] == 21
    assert results["torch"][1] == results["jax"][1]
    assert results["torch"][2] == results["jax"][2]


def _append_record(f, seq: int, txn_or_payload, crc: int | None = None) -> None:
    if isinstance(txn_or_payload, bytes):
        payload = txn_or_payload
    else:
        e = Encoder()
        encode_transaction(e, txn_or_payload)
        payload = e.getvalue()
    rec = make_wal_record(seq, payload)
    if crc is not None:
        rec.crc = crc
    e = Encoder()
    encode_wal_record(e, rec)
    append_frame(f, e.getvalue(), False)


@pytest.mark.parametrize("fault", ["torn_tail", "bad_record_crc", "undecodable"])
def test_wal_torn_and_corrupt_tails_truncate_like_jax(fault, tmp_path):
    """A torn frame, a record whose payload crc fails the device verify,
    or a crc-valid undecodable record: both packages replay the same
    prefix and truncate the log to the same bytes."""
    waldir = tmp_path / "src"
    waldir.mkdir()
    with open(waldir / "wal.log", "ab") as f:
        _append_record(f, 1, Transaction().create_collection("c").write("c", "a", 0, b"A" * 5000))
        _append_record(f, 2, Transaction().write("c", "b", 0, b"B"))
        if fault == "bad_record_crc":
            _append_record(f, 3, Transaction().write("c", "c", 0, b"C"), crc=0x12345678)
        elif fault == "undecodable":
            _append_record(f, 3, b"\xff\xff\xff\xff")
        else:
            _append_record(f, 3, Transaction().write("c", "c", 0, b"C"))
        _append_record(f, 4, Transaction().write("c", "d", 0, b"D"))
    raw = (waldir / "wal.log").read_bytes()
    if fault == "torn_tail":
        raw = raw[:-7]
    results = {}
    for pkg in PKG:
        d = tmp_path / pkg
        d.mkdir()
        (d / "wal.log").write_bytes(raw)
        inner = MemStore() if pkg == "torch" else j_objectstore.MemStore()
        kw = {"device": "cpu"} if pkg == "torch" else {}
        w = PKG[pkg]["wal"](inner, d, **kw)
        results[pkg] = (
            w.replayed_records,
            sorted(w.list_objects("c")),
            w.wal_perf.dump()["l_os_wal_apply_errors"],
        )
        w.close()
        results[pkg] += ((d / "wal.log").read_bytes(),)
    assert results["torch"] == results["jax"]
    want = 3 if fault == "torn_tail" else 2
    assert results["torch"][0] == want
    assert len(results["torch"][3]) < len(raw)


def test_wal_replay_on_device_failure_raises(tmp_path, monkeypatch):
    """The replay verify never answers from the host crc: a device
    failure raises out of the mount."""
    from ceph_tpu_torch.ops import scrub_kernels

    d = tmp_path / "wal"
    d.mkdir()
    with open(d / "wal.log", "ab") as f:
        _append_record(f, 1, Transaction().create_collection("c"))

    def broken(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(scrub_kernels, "crc_bits", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        WALStore(MemStore(), d, device="cpu")


def test_kstore_compaction_and_snapshot_bytes_match_jax(tmp_path):
    files = {}
    for pkg in PKG:
        store = PKG[pkg]["k"](tmp_path / pkg, sync=False, compression="zlib")
        for txn in _seeded_txns(5, PKG[pkg]["txn"], n=20):
            store.queue_transaction(txn)
        store.compact()
        store.close()
        files[pkg] = _files(tmp_path / pkg)
    assert files["torch"] == files["jax"]
    store = JKStore(tmp_path / "torch", sync=False)
    assert _dump(store)
    store.close()


@pytest.mark.parametrize("name", jcompressor.available())
def test_compressor_outputs_equal(name):
    assert name in compressor.available()
    rng = np.random.default_rng(4)
    for data in (b"", b"abc" * 1000, rng.bytes(5000), bytes(20000)):
        packed = compressor.create(name).compress(data)
        assert packed == jcompressor.create(name).compress(data)
        assert jcompressor.create(name).decompress(packed) == data
        assert compressor.create(name).decompress(packed) == data


def test_compressor_registry_and_errors_match_jax():
    assert compressor.available() == jcompressor.available()
    with pytest.raises(compressor.CompressorError):
        compressor.create("brotli-not-here")
    with pytest.raises(compressor.CompressorError):
        compressor.create("zlib").decompress(b"\x05\x00\x00\x00garbage")


def _kstore_with_objects(pkg: str, path: pathlib.Path):
    store = PKG[pkg]["k"](path, sync=False)
    txn = PKG[pkg]["txn"]().create_collection("pg_9.0")
    txn.write("pg_9.0", "o_x", 0, b"hello objects")
    txn.setattr("pg_9.0", "o_x", "_", b"oi")
    txn.omap_setkeys("pg_9.0", "o_x", {"k": b"v"})
    txn.write("pg_9.0", "o_y", 0, b"y" * 5000)
    store.queue_transaction(txn)
    store.close()


def test_objectstore_tool_export_import_match_jax(capsys, tmp_path):
    for pkg in PKG:
        _kstore_with_objects(pkg, tmp_path / pkg)
    outs = {}
    for pkg, tool in (("torch", objectstore_tool), ("jax", j_tool)):
        path = str(tmp_path / pkg)
        got = []
        for words in (["list-collections"], ["list"], ["info", "pg_9.0", "o_x"], ["fsck"]):
            assert tool.main(["--data-path", path, *words]) == 0
            got.append(capsys.readouterr().out)
        assert tool.main(["--data-path", path, "export", "pg_9.0", "o_x", str(tmp_path / f"{pkg}.obj")]) == 0
        assert tool.main(["--data-path", path, "export-pg", "pg_9.0", str(tmp_path / f"{pkg}.pg")]) == 0
        outs[pkg] = got
    assert outs["torch"] == outs["jax"]
    assert json.loads(outs["torch"][2])["omap_keys"] == 1
    assert (tmp_path / "torch.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()
    assert (tmp_path / "torch.pg").read_bytes() == (tmp_path / "jax.pg").read_bytes()
    # the port imports the JAX export into a fresh store, and back
    assert objectstore_tool.main(["--data-path", str(tmp_path / "fresh"), "import-pg", str(tmp_path / "jax.pg")]) == 0
    assert objectstore_tool.main(
        ["--data-path", str(tmp_path / "fresh"), "import", "pg_9.0", "renamed", str(tmp_path / "jax.obj")]
    ) == 0
    assert j_tool.main(["--data-path", str(tmp_path / "fresh"), "remove", "pg_9.0", "o_y"]) == 0
    capsys.readouterr()
    fresh = KStore(tmp_path / "fresh", sync=False)
    try:
        assert fresh.list_objects("pg_9.0") == ["o_x", "renamed"]
        assert fresh.read("pg_9.0", "renamed") == b"hello objects"
        assert fresh.omap_get("pg_9.0", "renamed") == {"k": b"v"}
        assert fresh.list_attrs("pg_9.0", "renamed") == {"_": b"oi"}
    finally:
        fresh.close()
    assert objectstore_tool.main(["--data-path", str(tmp_path / "torch"), "bogus"]) == 2


def test_wal_lets_a_rotted_object_be_rewritten(tmp_path):
    """An object whose media fails its at-rest checksum can be removed
    and rewritten through the port's WAL (the repair a deep scrub
    orders).  The JAX WALStore's validation reads such an object as
    absent and refuses the remove: a fault of the reference that the
    port does not copy."""
    outcome = {}
    for pkg in PKG:
        root = tmp_path / pkg
        store = _open(pkg, "wal+block", root)
        txn_cls = PKG[pkg]["txn"]
        store.queue_transaction(txn_cls().create_collection("c").write("c", "o", 0, b"x" * 10000))
        _close(store)
        with open(root / "data" / "block.dev", "r+b") as f:
            f.seek(100)
            f.write(b"\xff")
        store = _open(pkg, "wal+block", root)
        with pytest.raises((StoreError, j_objectstore.StoreError)):
            store.read("c", "o")
        assert store.exists("c", "o")
        try:
            store.queue_transaction(txn_cls().remove("c", "o").touch("c", "o").write("c", "o", 0, b"new"))
            assert store.flush()
            outcome[pkg] = store.read("c", "o")
        except (StoreError, j_objectstore.StoreError) as err:
            outcome[pkg] = str(err)
        _close(store)
    assert outcome == {"torch": b"new", "jax": "no object c/o (-ENOENT)"}
