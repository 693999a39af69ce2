"""The OSD's per-pool erasure codec — the codec half of the backend that
build_pg_backend's ERASURE branch mounts (src/osd/PGBackend.cc:571-607,
src/osd/ECBackend.cc).

``ECCodec`` is the JAX package's ``osd/ec_pg.ECCodec``: one pool
profile's code and stripe geometry, with the whole-object encode and the
batched encode and decode-from-survivors that the write-coalescing and
recovery paths call.  Its batch methods run over ``ec.stripe``'s
``encode_batch`` / ``decode_batch``, hence over the torch backend's
grouped routes (kernel K2).  The store seams of that module sit beside
it: ``UnreachableStore`` (a shard position with nobody behind it),
``rmw_write_txns`` (the stripe-granular partial overwrite as one range
transaction per position) and ``shard_write_txn`` (one position's
full-shard write).
"""

from __future__ import annotations

import json

import numpy as np

from ..ec import ErasureCodeProfile, registry_instance
from ..ec.stripe import HashInfo, StripeInfo, decode_batch, encode_batch, rmw_encode
from ..store.ec_store import HINFO_KEY
from ..store.objectstore import ObjectStore, StoreError, Transaction

DEFAULT_STRIPE_UNIT = 4096  # osd_pool_erasure_code_stripe_unit role


class UnreachableStore(ObjectStore):
    """A shard position with nobody behind it (down OSD or
    CRUSH_ITEM_NONE hole): every access fails like a dead peer."""

    residency_local = False

    def _fail(self, *_a, **_kw):
        raise StoreError("shard unreachable (down or hole)")

    queue_transaction = _fail
    read = _fail
    getattr = _fail
    stat = _fail
    exists = _fail
    list_objects = _fail
    list_collections = _fail
    list_attrs = _fail
    omap_get = _fail
    omap_get_vals = _fail


class ECCodec:
    """One pool profile's codec + stripe geometry, cached per profile
    by the daemon (the ErasureCodePluginRegistry::factory product the
    reference hangs off the pool, PGBackend.cc:588).  The profile's
    ``device`` key (default ``cuda``) says where the region math runs."""

    def __init__(self, profile: dict[str, str]):
        plugin = profile.get("plugin", "jerasure")
        prof = ErasureCodeProfile(
            {k: v for k, v in profile.items() if k != "plugin"}
        )
        self.ec = registry_instance().factory(plugin, prof)
        self.k = self.ec.get_data_chunk_count()
        self.n = self.ec.get_chunk_count()
        chunk = self.ec.get_chunk_size(self.k * DEFAULT_STRIPE_UNIT)
        self.sinfo = StripeInfo(self.k, self.k * chunk)

    def encode_object(
        self, data: bytes
    ) -> tuple[dict[int, bytes], dict]:
        """Full-object encode: pad to stripe multiples, run the stripe
        seam, compute per-shard HashInfo.  Returns ({pos: shard_bytes},
        meta) with meta in the shard-xattr JSON shape ECStore reads.
        ONE implementation serves both paths: this is the
        single-element case of the batch (encode_batch runs a
        1-element batch through the same per-buffer encode)."""
        return self.encode_object_batch([data])[0]

    def encode_object_batch(
        self, datas
    ) -> list[tuple[dict[int, bytes], dict]]:
        """Batched :meth:`encode_object`: every queued payload's
        stripes ride ONE pipelined device pass (the write-coalescing
        seam — ec/stripe.encode_batch), byte-identical to per-object
        encodes.  Returns one ({pos: shard_bytes}, meta) per payload,
        in order."""
        padded = []
        for data in datas:
            logical = len(data)
            plen = self.sinfo.logical_to_next_stripe_offset(logical)
            padded.append(bytes(data) + b"\0" * (plen - logical))
        shard_sets = encode_batch(self.sinfo, self.ec, padded)
        out: list[tuple[dict[int, bytes], dict]] = []
        for data, shards in zip(datas, shard_sets):
            if not shards:  # zero-length object: n empty shards
                shards = {
                    i: np.zeros(0, dtype=np.uint8) for i in range(self.n)
                }
            hinfo = HashInfo(self.n)
            hinfo.append(0, shards)
            meta = {
                "size": len(data),
                "hashes": hinfo.cumulative_shard_hashes,
            }
            out.append(
                ({i: bytes(shards[i]) for i in range(self.n)}, meta)
            )
        return out

    def decode_object_batch(self, shard_sets, want) -> list[dict]:
        """Batched decode-from-survivors (the repair-side twin of
        :meth:`encode_object_batch`): rebuild the SAME missing
        positions for many objects in one coalesced device dispatch.
        ``shard_sets`` holds one survivor dict per object ({position:
        bytes | ndarray | DeviceBuf}); returns one {position: payload}
        per object — device-born DeviceBufs where the batched route
        ran, numpy arrays from the per-object repair — byte-identical
        to per-object decode (ec/stripe.decode_batch)."""
        return decode_batch(self.sinfo, self.ec, shard_sets, want)


def rmw_write_txns(
    codec: ECCodec,
    ecs,
    cid: str,
    oid: str,
    offset: int,
    data: bytes,
    positions,
    old_size: int,
) -> dict[int, "Transaction"]:
    """Stripe-granular partial overwrite for the daemon's EC write
    path (start_rmw, src/osd/ECBackend.cc:1858): read ONLY the
    partially-covered head/tail stripes that hold pre-existing bytes
    (through ``ecs`` — the per-PG store view, so degraded stripes
    reconstruct), re-encode just the covered stripe range, and return
    one RANGE transaction per position (shard bytes at the range's
    chunk offset + updated HashInfo).

    Only ``(end-first)`` stripes' worth of shard bytes travel to each
    replica — a 4KB overwrite of a multi-MB object ships ~one chunk
    per shard, not the whole re-encoded object.  Matching the
    reference's ec_overwrites semantics, the cumulative HashInfo is
    invalidated (no "hashes" key): scrub falls back to the re-encode
    consistency check."""
    data = bytes(data)
    sinfo = codec.sinfo
    cs = sinfo.chunk_size
    first, _end, _buf, shards = rmw_encode(
        sinfo, codec.ec, offset, data, old_size,
        lambda stripes: ecs.read_stripes(oid, stripes),
    )
    meta = {"size": max(old_size, offset + len(data))}
    blob = json.dumps(meta).encode()
    txns: dict[int, Transaction] = {}
    for pos in positions:
        txn = Transaction()
        # touch first: the txn must apply unconditionally on a lagging
        # replica that does not hold the object yet
        txn.touch(cid, oid)
        txn.write(cid, oid, first * cs, bytes(shards[pos]))
        txn.setattr(cid, oid, HINFO_KEY, blob)
        txns[pos] = txn
    return txns


def shard_write_txn(
    cid: str,
    oid: str,
    shard: bytes,
    meta: dict,
    attrs: dict[str, bytes] | None = None,
) -> Transaction:
    """One position's full-shard write as an unconditional transaction
    (touch+truncate replaces remove-if-exists so the SAME op list
    applies on a replica that may not hold the object yet)."""
    txn = Transaction()
    txn.touch(cid, oid)
    txn.truncate(cid, oid, 0)
    if shard:
        txn.write(cid, oid, 0, shard)
    txn.setattr(cid, oid, HINFO_KEY, json.dumps(meta).encode())
    for name, value in (attrs or {}).items():
        txn.setattr(cid, oid, name, value)
    return txn
