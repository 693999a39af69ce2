"""PGMap digest codec (src/mon/PGMap.{h,cc}): the binary form of the
digest the manager pushes to the monitor ("pgmap report"), where it
feeds ``ceph status``/``ceph df``/``pg dump`` and the PG_DEGRADED /
PG_AVAILABILITY health checks.

The encoding is dencoder-pinned: maps encode sorted, so the same digest
always produces the same bytes, equal to the JAX package's.

Only the codec is here; the monitor decodes reports with it.
``PgMapModule``, which folds the OSDs' per-PG stats into the digest, and
the rest of ``mgr/`` come to the port with the manager daemon.
"""

from __future__ import annotations

from ..common.encoding import Decoder, Encoder

PGMAP_DIGEST_VERSION = 1


def _enc_pool(e: Encoder, p: dict) -> None:
    e.string(p.get("name", ""))
    e.u32(p.get("num_pgs", 0)).u32(p.get("active_pgs", 0))
    e.u64(p.get("objects", 0)).u64(p.get("bytes", 0))
    e.u64(p.get("degraded", 0)).u64(p.get("misplaced", 0))
    e.u64(p.get("unfound", 0))


def _dec_pool(d: Decoder) -> dict:
    return {
        "name": d.string(),
        "num_pgs": d.u32(), "active_pgs": d.u32(),
        "objects": d.u64(), "bytes": d.u64(),
        "degraded": d.u64(), "misplaced": d.u64(),
        "unfound": d.u64(),
    }


def _enc_pg(e: Encoder, p: dict) -> None:
    e.string(p.get("state", ""))
    e.u64(p.get("objects", 0)).u64(p.get("bytes", 0))
    e.u64(p.get("degraded", 0)).u64(p.get("misplaced", 0))
    e.u64(p.get("unfound", 0))
    e.list(p.get("up", []), lambda en, v: en.s32(v))
    e.list(p.get("acting", []), lambda en, v: en.s32(v))
    e.u32(p.get("reported_epoch", 0))
    e.f64(p.get("recovery_progress", 0.0))


def _dec_pg(d: Decoder) -> dict:
    return {
        "state": d.string(),
        "objects": d.u64(), "bytes": d.u64(),
        "degraded": d.u64(), "misplaced": d.u64(),
        "unfound": d.u64(),
        "up": d.list(lambda de: de.s32()),
        "acting": d.list(lambda de: de.s32()),
        "reported_epoch": d.u32(),
        "recovery_progress": d.f64(),
    }


def encode_pgmap_digest(digest: dict) -> bytes:
    """Deterministic binary encoding of the digest (the dencoder pin:
    Encoder.map iterates sorted, so byte-for-byte stable)."""
    e = Encoder()
    e.u32(PGMAP_DIGEST_VERSION)
    e.u32(digest.get("num_pgs", 0)).u32(digest.get("num_pools", 0))
    e.map(
        digest.get("pg_states", {}),
        lambda en, k: en.string(k),
        lambda en, v: en.u64(v),
    )
    e.map(
        digest.get("pools", {}),
        lambda en, k: en.s64(int(k)),
        _enc_pool,
    )
    t = digest.get("totals", {})
    e.u64(t.get("objects", 0)).u64(t.get("bytes", 0))
    e.u64(t.get("degraded", 0)).u64(t.get("misplaced", 0))
    e.u64(t.get("unfound", 0))
    io = digest.get("io", {})
    e.f64(io.get("ops_sec", 0.0)).f64(io.get("read_ops_sec", 0.0))
    e.f64(io.get("write_ops_sec", 0.0))
    rec = digest.get("recovery", {})
    e.f64(rec.get("objects_sec", 0.0)).f64(rec.get("bytes_sec", 0.0))
    e.map(
        digest.get("pgs", {}),
        lambda en, k: en.string(k),
        _enc_pg,
    )
    return e.getvalue()


def decode_pgmap_digest(buf: bytes) -> dict:
    d = Decoder(buf)
    version = d.u32()
    if version != PGMAP_DIGEST_VERSION:
        raise ValueError(f"pgmap digest version {version}")
    out = {
        "version": version,
        "num_pgs": d.u32(),
        "num_pools": d.u32(),
        "pg_states": d.map(
            lambda de: de.string(), lambda de: de.u64()
        ),
        "pools": d.map(lambda de: de.s64(), _dec_pool),
        "totals": {
            "objects": d.u64(), "bytes": d.u64(),
            "degraded": d.u64(), "misplaced": d.u64(),
            "unfound": d.u64(),
        },
        "io": {
            "ops_sec": d.f64(), "read_ops_sec": d.f64(),
            "write_ops_sec": d.f64(),
        },
        "recovery": {
            "objects_sec": d.f64(), "bytes_sec": d.f64(),
        },
        "pgs": d.map(lambda de: de.string(), _dec_pg),
    }
    return out
