"""Scrub maps and their comparison — the replica half of deep scrub
(src/osd/scrubber/: ScrubMap, ScrubStore, be_compare_scrubmaps).

Shape vs the reference:

- ``build_scrub_map`` is one daemon's digest map over a chunk of
  objects: size + omap/xattr digests always, payload checksums when
  ``deep`` — batched per chunk through
  ``ops/scrub_kernels.batch_crc32c`` on ``device`` (default ``cuda``;
  one device call per daemon per chunk instead of the reference's
  per-object CPU loop; a device failure raises).
- Erasure pools audit each shard's crc against the object's stored
  HashInfo (``compare_ec``); overwritten objects (hinfo invalidated,
  matching the reference's ec_overwrites semantics) report that they
  need a decode + re-encode compare.  Replicated pools compare by
  digest majority (``compare_replicated``).
- Findings persist as omap records on a per-PG ``_scrub_`` object
  (``ScrubStore``) in the ``rados list-inconsistent-obj`` shape
  (``make_record``).

The JAX package's ``Scrubber`` — the chunked, preemptible scrub run the
primary drives, its ``MRepScrub``/``MScrubMap`` replica rounds and
repair through the recovery push — drives the OSD daemon
(``osd/daemon.py``) and comes to the port with it.
"""

from __future__ import annotations

import json

from ..native import ceph_crc32c
from ..ops.scrub_kernels import batch_crc32c
from ..store.ec_store import HINFO_KEY
from ..store.objectstore import StoreError, Transaction

# the per-PG scrub metadata object: inconsistency records live in its
# omap (the ScrubStore's OMAP_DIR), outside the OBJ_PREFIX namespace
# so listings and client ops never see it
SCRUB_META = "_scrub_"
REC_PREFIX = "inc_"

# attrs excluded from the xattr digest: t_dirty is cleared locally
# only (cache-tier flush), hinfo is audited separately per shard
VOLATILE_ATTRS = frozenset({"t_dirty", HINFO_KEY})

# the digest seed (the reference's data_digest crc32c(-1) convention,
# shared with the EC HashInfo cumulative seeds)
DIGEST_SEED = 0xFFFFFFFF

# shard/object error vocabulary (rados list-inconsistent-obj codes)
ERR_MISSING = "missing"
ERR_SIZE = "size_mismatch"
ERR_DATA = "data_digest_mismatch"
ERR_OMAP = "omap_digest_mismatch"
ERR_ATTR = "attr_digest_mismatch"
ERR_EC_HASH = "ec_hash_mismatch"
ERR_EC_SIZE = "ec_size_mismatch"
ERR_READ = "read_error"
ERR_INCONSISTENT = "inconsistent"
KNOWN_ERRORS = frozenset(
    {
        ERR_MISSING, ERR_SIZE, ERR_DATA, ERR_OMAP, ERR_ATTR,
        ERR_EC_HASH, ERR_EC_SIZE, ERR_READ, ERR_INCONSISTENT,
    }
)


def _digest(parts: dict[str, bytes]) -> int:
    """Canonical crc32c over sorted (key, value) pairs."""
    crc = DIGEST_SEED
    for key in sorted(parts):
        crc = ceph_crc32c(crc, key.encode() + b"\0")
        crc = ceph_crc32c(crc, bytes(parts[key]) + b"\0")
    return crc


def _resident(store, cid: str, oid: str, expect_len=None):
    """Generation-checked residency lookup (ops/residency.py): a hit
    is the payload the last committed txn landed, already on device —
    the deep-scrub digest of a freshly written object costs zero
    host→device transfer.  Only scrub-trusted stores are consulted:
    proxies mutate out of our sight, and persistent media (whose
    out-of-band bit rot is exactly what deep scrub audits) must be
    READ, never served from cache."""
    from ..ops.residency import residency_cache, scrub_trusted

    if not scrub_trusted(store):
        return None
    return residency_cache().get(store, cid, oid, expect_len=expect_len)


def build_scrub_map(
    store,
    cid: str,
    oids,
    deep: bool,
    with_hinfo: bool = False,
    device="cuda",
) -> dict[str, dict]:
    """One daemon's digest map over a chunk of store oids (the
    ScrubMap role, src/osd/scrubber_common.h): size + omap/xattr
    digests always, payload crc32c when ``deep`` (ALL payloads of the
    chunk in one batched device call; device-RESIDENT payloads — the
    bytes the EC/replicated write path just committed — digest with
    no re-upload).  The crcs run on ``device``."""
    out: dict[str, dict] = {}
    datas: list[bytes] = []
    data_oids: list[str] = []
    for oid in oids:
        try:
            if not store.exists(cid, oid):
                out[oid] = {"exists": False}
                continue
            attrs = store.list_attrs(cid, oid)
            try:
                omap = store.omap_get(cid, oid)
            except StoreError:
                omap = {}
            ent: dict = {
                "exists": True,
                "size": store.stat(cid, oid),
                # omap cardinality feeds the LARGE_OMAP_OBJECTS
                # deep-scrub check (the bucket-index hot-spot signal)
                "omap_keys": len(omap),
                "omap_digest": _digest(omap),
                "attrs_digest": _digest(
                    {
                        k: v
                        for k, v in attrs.items()
                        if k not in VOLATILE_ATTRS
                    }
                ),
            }
            if with_hinfo:
                try:
                    ent["hinfo"] = json.loads(attrs[HINFO_KEY])
                except (KeyError, ValueError):
                    ent["hinfo"] = None
            if deep:
                buf = _resident(store, cid, oid, ent["size"])
                datas.append(
                    buf if buf is not None else store.read(cid, oid)
                )
                data_oids.append(oid)
            out[oid] = ent
        except StoreError:
            out[oid] = {"exists": True, "error": ERR_READ}
    if datas:
        for oid, crc in zip(
            data_oids, batch_crc32c(datas, DIGEST_SEED, device=device)
        ):
            out[oid]["data_digest"] = int(crc)
    return out


class ScrubStore:
    """Inconsistency records persisted in the PG's ``_scrub_`` omap
    (src/osd/scrubber/ScrubStore.cc): written by the scrub that found
    them, served by ``rados list-inconsistent-obj``, cleared by the
    scrub/repair that no longer reproduces them."""

    @staticmethod
    def save(store, cid: str, records: list[dict]) -> None:
        txn = Transaction().touch(cid, SCRUB_META)
        txn.omap_clear(cid, SCRUB_META)
        if records:
            txn.omap_setkeys(
                cid,
                SCRUB_META,
                {
                    REC_PREFIX
                    + rec["object"]["name"]: json.dumps(
                        rec, sort_keys=True
                    ).encode()
                    for rec in records
                },
            )
        store.queue_transaction(txn)

    @staticmethod
    def load(store, cid: str) -> list[dict]:
        try:
            kv = store.omap_get(cid, SCRUB_META)
        except StoreError:
            return []
        out = []
        for key in sorted(kv):
            if not key.startswith(REC_PREFIX):
                continue
            try:
                rec = json.loads(kv[key])
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    @staticmethod
    def clear(store, cid: str) -> None:
        try:
            store.queue_transaction(
                Transaction()
                .touch(cid, SCRUB_META)
                .omap_clear(cid, SCRUB_META)
            )
        except StoreError:
            pass


def make_record(
    oid: str,
    shards: list[dict],
    errors: list[str],
    selected: dict | None = None,
) -> dict:
    """One inconsistency record in the ``rados list-inconsistent-obj``
    shape (src/include/rados/rados_types.hpp obj_err_t), with the
    compact legacy keys (oid/osd/corrupt/missing) the daemon's
    ``pg.scrub_errors`` consumers already read."""
    union = sorted(
        {e for sh in shards for e in sh.get("errors", ())}
    )
    bad = [sh for sh in shards if sh.get("errors")]
    rec = {
        "object": {"name": oid, "nspace": "", "snap": "head"},
        "errors": sorted(set(errors) | set(union)),
        "union_shard_errors": union,
        "selected_object_info": selected,
        "shards": shards,
        # legacy compact keys
        "oid": oid,
        "osd": bad[0]["osd"] if bad else -1,
        "missing": [
            sh.get("shard", sh["osd"])
            for sh in shards
            if ERR_MISSING in sh.get("errors", ())
        ],
        "corrupt": [
            sh.get("shard", sh["osd"])
            for sh in shards
            if {ERR_DATA, ERR_EC_HASH, ERR_EC_SIZE}
            & set(sh.get("errors", ()))
        ],
        "inconsistent": ERR_INCONSISTENT in errors,
    }
    return rec


def compare_replicated(
    oid: str, maps: dict[int, dict], primary: int, deep: bool
) -> dict | None:
    """Compare one object's per-osd scrub-map entries; returns an
    inconsistency record or None.  Authoritative selection is digest
    majority (ties break toward the group holding the primary, then
    the lowest osd) — the be_select_auth_object seat."""
    present = {
        osd: ent
        for osd, ent in maps.items()
        if ent is not None and ent.get("exists")
    }
    if not present:
        return None  # nobody holds it (fully deleted): not an error

    def key_of(ent):
        fields = [ent.get("size"), ent.get("omap_digest"),
                  ent.get("attrs_digest")]
        if deep:
            fields.append(ent.get("data_digest"))
        return tuple(fields)

    groups: dict[tuple, list[int]] = {}
    for osd, ent in present.items():
        if ent.get("error"):
            continue
        groups.setdefault(key_of(ent), []).append(osd)
    if not groups:
        auth_osd, auth_key = primary, None
    else:
        def rank(item):
            key, members = item
            return (
                len(members),
                primary in members,
                -min(members),
            )

        auth_key, members = max(groups.items(), key=rank)
        auth_osd = primary if primary in members else min(members)
    auth = present.get(auth_osd)
    shards = []
    clean = True
    for osd, ent in sorted(maps.items()):
        sh = {"osd": osd, "shard": -1, "errors": []}
        if ent is None:
            # unreachable peer: not scrubbed, not an inconsistency
            continue
        if not ent.get("exists"):
            sh["errors"].append(ERR_MISSING)
        elif ent.get("error"):
            sh["errors"].append(ent["error"])
        else:
            sh["size"] = ent.get("size")
            sh["omap_digest"] = ent.get("omap_digest")
            sh["attrs_digest"] = ent.get("attrs_digest")
            if deep:
                sh["data_digest"] = ent.get("data_digest")
            if auth is not None and ent is not auth:
                if ent.get("size") != auth.get("size"):
                    sh["errors"].append(ERR_SIZE)
                if deep and ent.get("data_digest") != auth.get(
                    "data_digest"
                ):
                    sh["errors"].append(ERR_DATA)
                if ent.get("omap_digest") != auth.get("omap_digest"):
                    sh["errors"].append(ERR_OMAP)
                if ent.get("attrs_digest") != auth.get(
                    "attrs_digest"
                ):
                    sh["errors"].append(ERR_ATTR)
        if sh["errors"]:
            clean = False
        shards.append(sh)
    if clean:
        return None
    selected = None
    if auth is not None:
        selected = {
            "osd": auth_osd,
            "size": auth.get("size"),
            "data_digest": auth.get("data_digest"),
        }
    rec = make_record(oid, shards, [], selected)
    # legacy peer-vs-primary fields the seed tests read
    pri = maps.get(primary) or {}
    rec["primary_crc"] = pri.get("data_digest")
    bad = [sh for sh in shards if sh["errors"]]
    if bad:
        peer = maps.get(bad[0]["osd"]) or {}
        rec["peer_crc"] = peer.get("data_digest")
    return rec


def compare_ec(
    oid: str,
    maps: dict[int, dict],
    acting: list[int],
    sinfo,
    deep: bool,
) -> tuple[dict | None, bool]:
    """Compare one EC object's per-position shard entries against the
    stored HashInfo.  Returns (record | None, needs_reencode): when
    the hinfo carries no per-shard hashes (partial overwrite
    invalidated it, the reference's ec_overwrites behavior) a deep
    scrub must fall back to decode + re-encode — the caller runs that
    batched."""
    by_pos = {
        pos: maps.get(osd)
        for pos, osd in enumerate(acting)
    }
    present = {
        pos: ent
        for pos, ent in by_pos.items()
        if ent is not None and ent.get("exists")
    }
    if not present:
        return None, False
    # authoritative hinfo: the value most shards agree on
    votes: dict[str, list[int]] = {}
    for pos, ent in present.items():
        hinfo = ent.get("hinfo")
        if hinfo is not None:
            votes.setdefault(
                json.dumps(hinfo, sort_keys=True), []
            ).append(pos)
    hinfo = None
    if votes:
        blob, _members = max(
            votes.items(), key=lambda kv: (len(kv[1]), kv[0])
        )
        hinfo = json.loads(blob)
    hashes = (hinfo or {}).get("hashes")
    size = (hinfo or {}).get("size", 0)
    expected_len = (
        sinfo.logical_to_next_chunk_offset(size)
        if sinfo is not None
        else None
    )
    shards = []
    clean = True
    for pos, osd in enumerate(acting):
        ent = by_pos.get(pos)
        if ent is None:
            continue  # unreachable: peering handles it, not scrub
        sh = {"osd": osd, "shard": pos, "errors": []}
        if not ent.get("exists"):
            sh["errors"].append(ERR_MISSING)
        elif ent.get("error"):
            sh["errors"].append(ent["error"])
        else:
            sh["size"] = ent.get("size")
            sh["omap_digest"] = ent.get("omap_digest")
            sh["attrs_digest"] = ent.get("attrs_digest")
            if deep:
                sh["data_digest"] = ent.get("data_digest")
            if (
                expected_len is not None
                and ent.get("size") != expected_len
            ):
                sh["errors"].append(ERR_EC_SIZE)
            if (
                deep
                and hashes is not None
                and pos < len(hashes)
                and ent.get("data_digest") != hashes[pos]
            ):
                sh["errors"].append(ERR_EC_HASH)
        if sh["errors"]:
            clean = False
        shards.append(sh)
    needs_reencode = deep and hashes is None and bool(size)
    if clean:
        return None, needs_reencode
    rec = make_record(oid, shards, [], {"size": size})
    return rec, needs_reencode

