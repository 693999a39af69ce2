"""The replica half of the port's deep scrub held against the JAX
package's on the CPU: ``build_scrub_map(device="cpu")`` over the shards
of an EC PG and the replicas of a replicated PG, on MemStore and on
BlockStore media, gives the same maps as the JAX package's (which runs
its device crc on the CPU, as ``tests/test_scrub_kernels.py:133-160``
runs it); ``compare_ec``, ``compare_replicated``, ``make_record`` and
``ScrubStore`` give the same findings and store the same bytes, with
corruption planted in the shards, in their attrs and on the media
itself."""

from __future__ import annotations

import json

import numpy as np
import pytest

from ceph_tpu.osd import scrub as j_scrub
from ceph_tpu.store import objectstore as j_objectstore
from ceph_tpu.store.blockstore import BlockStore as JBlockStore
from ceph_tpu.store.ec_store import ECStore as JECStore
from ceph_tpu.store.replicated import ReplicatedStore as JReplicatedStore
from ceph_tpu_torch.native import ceph_crc32c
from ceph_tpu_torch.osd import scrub
from ceph_tpu_torch.store import BlockStore, ECStore, MemStore, ReplicatedStore, Transaction

PROFILE = {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "8"}
NAMES = [f"obj{i}" for i in range(8)]


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _twin_ec(media, tmp_path):
    if media == "block":
        jstores = [JBlockStore(tmp_path / f"j{i}", sync=False) for i in range(6)]
        tstores = [BlockStore(tmp_path / f"t{i}", sync=False) for i in range(6)]
    else:
        jstores, tstores = None, None
    return (
        JECStore(plugin="jerasure", profile=dict(PROFILE), stores=jstores),
        ECStore(plugin="jerasure", profile={**PROFILE, "device": "cpu"}, stores=tstores),
    )


def _fill(ec):
    for i, name in enumerate(NAMES):
        ec.put(name, _bytes(1000 + 7000 * i, i))


def _plant(ec, txn_cls):
    """Shard-side faults: flipped payload byte, lost shard, foreign
    attr, truncated shard, a hinfo that no longer matches."""
    ec.corrupt_shard("obj1", 2, offset=5)
    ec.lose_shard("obj2", 0)
    ec.stores[3].queue_transaction(txn_cls().setattr(ec.cid, "obj3", "u_x", b"rogue"))
    ec.stores[1].queue_transaction(txn_cls().truncate(ec.cid, "obj4", 10))
    hinfo = ec.stores[5].getattr(ec.cid, "obj5", scrub.HINFO_KEY)
    bad = json.loads(hinfo)
    bad["hashes"] = [h ^ 1 for h in bad["hashes"]]
    ec.stores[5].queue_transaction(
        txn_cls().setattr(ec.cid, "obj5", scrub.HINFO_KEY, json.dumps(bad).encode())
    )


def _maps(mod, ec, deep, **kw):
    oids = NAMES + ["absent"]
    return {
        pos: mod.build_scrub_map(store, ec.cid, oids, deep=deep, with_hinfo=True, **kw)
        for pos, store in enumerate(ec.stores)
    }


def _entries(maps, oid):
    """One object's entry from every position's map."""
    return {pos: m[oid] for pos, m in maps.items()}


@pytest.mark.parametrize("media", ["mem", "block"])
@pytest.mark.parametrize("deep", [True, False], ids=["deep", "shallow"])
def test_ec_scrub_maps_and_findings_match_jax(media, deep, tmp_path):
    jec, tec = _twin_ec(media, tmp_path)
    _fill(jec)
    _fill(tec)
    clean = _maps(scrub, tec, deep, device="cpu")
    assert clean == _maps(j_scrub, jec, deep)
    for oid in NAMES:
        rec, reenc = scrub.compare_ec(oid, _entries(clean, oid), list(range(6)), tec.sinfo, deep)
        assert (rec, reenc) == (None, False), oid
    _plant(jec, j_objectstore.Transaction)
    _plant(tec, Transaction)
    tmaps = _maps(scrub, tec, deep, device="cpu")
    jmaps = _maps(j_scrub, jec, deep)
    assert tmaps == jmaps
    found = {}
    for oid in NAMES + ["absent"]:
        got = scrub.compare_ec(oid, _entries(tmaps, oid), list(range(6)), tec.sinfo, deep)
        assert got == j_scrub.compare_ec(oid, _entries(jmaps, oid), list(range(6)), jec.sinfo, deep), oid
        if got[0] is not None:
            found[oid] = got[0]["union_shard_errors"]
    want = {
        "obj2": [scrub.ERR_MISSING],
        "obj4": sorted([scrub.ERR_EC_SIZE] + ([scrub.ERR_EC_HASH] if deep else [])),
    }
    if deep:
        want["obj1"] = [scrub.ERR_EC_HASH]
    assert found == want
    if deep:
        # the digests are the host C crc's, seeded as the reference seeds them
        raw = tec.stores[0].read(tec.cid, "obj6")
        assert tmaps[0]["obj6"]["data_digest"] == ceph_crc32c(scrub.DIGEST_SEED, raw)


def test_media_bitrot_reads_as_read_error_like_jax(tmp_path):
    """Out-of-band rot in one shard's ``block.dev`` is read, never served
    from residency: the media's at-rest checksum fails, the map flags
    that one (object, shard) pair as a read error."""
    jec, tec = _twin_ec("block", tmp_path)
    _fill(jec)
    _fill(tec)
    for prefix, ec in (("j", jec), ("t", tec)):
        for store in ec.stores:
            store.close()
        with open(tmp_path / f"{prefix}3" / "block.dev", "r+b") as f:
            f.seek(9)
            byte = f.read(1)
            f.seek(9)
            f.write(bytes([byte[0] ^ 0x40]))
        cls = JBlockStore if prefix == "j" else BlockStore
        ec.stores = [cls(tmp_path / f"{prefix}{i}", sync=False) for i in range(6)]
    tmaps = _maps(scrub, tec, True, device="cpu")
    jmaps = _maps(j_scrub, jec, True)
    assert tmaps == jmaps
    flagged = []
    for oid in NAMES:
        got = scrub.compare_ec(oid, _entries(tmaps, oid), list(range(6)), tec.sinfo, True)
        assert got == j_scrub.compare_ec(oid, _entries(jmaps, oid), list(range(6)), jec.sinfo, True)
        rec = got[0]
        if rec is not None:
            flagged += [(oid, sh["shard"], sh["errors"]) for sh in rec["shards"] if sh["errors"]]
    assert flagged == [("obj0", 3, [scrub.ERR_READ])]


def test_residency_serves_only_trusted_stores():
    """Freshly written MemStore shards digest from the residency cache;
    proxies and media are read (``_resident`` consults scrub-trusted
    stores only)."""
    from ceph_tpu_torch.ops.residency import residency_cache

    tec = ECStore(plugin="jerasure", profile={**PROFILE, "device": "cpu"})
    _fill(tec)
    hits = residency_cache().stats()["hits"]
    scrub.build_scrub_map(tec.stores[0], tec.cid, NAMES, deep=True, device="cpu")
    assert residency_cache().stats()["hits"] > hits

    class Untrusted(MemStore):
        residency_scrub_safe = False

    store = Untrusted()
    store.queue_transaction(Transaction().create_collection("c").write("c", "o", 0, b"abc"))
    assert scrub._resident(store, "c", "o", 3) is None


def test_build_scrub_map_device_failure_raises(monkeypatch):
    from ceph_tpu_torch.ops import scrub_kernels

    store = MemStore()
    store.queue_transaction(Transaction().create_collection("c").write("c", "o", 0, b"abc"))

    def broken(*_a, **_k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(scrub_kernels, "crc_bits", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        scrub.build_scrub_map(store, "c", ["o"], deep=True, device="cpu")


@pytest.mark.parametrize("deep", [True, False], ids=["deep", "shallow"])
def test_replicated_scrub_maps_and_findings_match_jax(deep):
    jr, tr = JReplicatedStore(size=3), ReplicatedStore(size=3, device="cpu")
    for rep, txn_cls in ((jr, j_objectstore.Transaction), (tr, Transaction)):
        for i, name in enumerate(NAMES[:5]):
            rep.put(name, _bytes(3000 + 100 * i, 50 + i))
        rep.stores[2].queue_transaction(txn_cls().write(rep.cid, "obj0", 7, b"\x00\xff"))
        rep.stores[0].queue_transaction(txn_cls().remove(rep.cid, "obj1"))
        rep.stores[1].queue_transaction(txn_cls().omap_setkeys(rep.cid, "obj2", {"k": b"v"}))
        rep.stores[1].queue_transaction(txn_cls().truncate(rep.cid, "obj3", 5))
    oids = NAMES[:5]
    tmaps = {o: scrub.build_scrub_map(s, tr.cid, oids, deep=deep, device="cpu") for o, s in enumerate(tr.stores)}
    jmaps = {o: j_scrub.build_scrub_map(s, jr.cid, oids, deep=deep) for o, s in enumerate(jr.stores)}
    assert tmaps == jmaps
    found = {}
    for oid in oids:
        per_osd = {osd: tmaps[osd][oid] for osd in tmaps}
        for primary in (0, 2):
            got = scrub.compare_replicated(oid, per_osd, primary, deep)
            assert got == j_scrub.compare_replicated(
                oid, {osd: jmaps[osd][oid] for osd in jmaps}, primary, deep
            )
        if got is not None:
            found[oid] = [(sh["osd"], sh["errors"]) for sh in got["shards"] if sh["errors"]]
    assert found == {
        "obj0": [(2, [scrub.ERR_DATA])] if deep else [],
        "obj1": [(0, [scrub.ERR_MISSING])],
        "obj2": [(1, [scrub.ERR_OMAP])],
        "obj3": [(1, [scrub.ERR_SIZE] + ([scrub.ERR_DATA] if deep else []))],
    } if deep else {
        "obj1": [(0, [scrub.ERR_MISSING])],
        "obj2": [(1, [scrub.ERR_OMAP])],
        "obj3": [(1, [scrub.ERR_SIZE])],
    }
    # an unreachable peer is not an inconsistency
    assert scrub.compare_replicated("obj4", {0: tmaps[0]["obj4"], 1: None}, 0, deep) is None


def _seeded_shards(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    errs = sorted(scrub.KNOWN_ERRORS)
    return [
        {
            "osd": int(rng.integers(0, 12)),
            "shard": pos,
            "errors": sorted({errs[int(i)] for i in rng.integers(0, len(errs), int(rng.integers(0, 3)))}),
            "size": int(rng.integers(0, 1 << 20)),
        }
        for pos in range(int(rng.integers(1, 6)))
    ]


@pytest.mark.parametrize("seed", range(6))
def test_make_record_matches_jax(seed):
    shards = _seeded_shards(seed)
    errors = [scrub.ERR_INCONSISTENT] if seed % 2 else []
    selected = {"size": seed} if seed % 3 else None
    assert scrub.make_record(f"o{seed}", shards, errors, selected) == j_scrub.make_record(
        f"o{seed}", shards, errors, selected
    )


def test_scrub_store_persists_the_same_bytes():
    records = [scrub.make_record(f"o{s}", _seeded_shards(s), [], None) for s in range(4)]
    stores = {"torch": MemStore(), "jax": j_objectstore.MemStore()}
    txn = {"torch": Transaction, "jax": j_objectstore.Transaction}
    mods = {"torch": scrub, "jax": j_scrub}
    for pkg, store in stores.items():
        store.queue_transaction(txn[pkg]().create_collection("pg"))
        mods[pkg].ScrubStore.save(store, "pg", records)
    assert stores["torch"].omap_get("pg", scrub.SCRUB_META) == stores["jax"].omap_get("pg", scrub.SCRUB_META)
    # each package loads what the other saved
    assert scrub.ScrubStore.load(stores["jax"], "pg") == j_scrub.ScrubStore.load(stores["torch"], "pg") == sorted(
        records, key=lambda r: r["object"]["name"]
    )
    scrub.ScrubStore.clear(stores["torch"], "pg")
    assert scrub.ScrubStore.load(stores["torch"], "pg") == []
    assert scrub.ScrubStore.load(MemStore(), "nope") == []
