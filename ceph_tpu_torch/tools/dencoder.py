"""ceph-dencoder analog — the encoding-corpus regression gate
(src/tools/ceph-dencoder/ceph_dencoder.cc + the ceph-object-corpus
workflow).

The reference pins sample encodings of every versioned struct in a
corpus repository and re-checks decode+re-encode on every build, so a
format change that breaks old blobs is caught at CI time rather than
at mixed-version upgrade time.  Same machinery here:

- ``TYPES`` registers every versioned wire/disk struct with a
  deterministic sample builder, an encoder, and a decoder.
- ``generate`` writes the sample encodings into ``corpus/dencoder/``.
- ``check`` decodes every PINNED blob with today's code and
  re-encodes it; any byte difference (or decode failure) is a format
  regression against data already in the wild.
- CLI: ``list`` / ``generate`` / ``check`` / ``decode -t TYPE FILE``.

Every type is registered with the JAX package's sample and bytes.

A NEW field appended to a struct re-encodes pinned blobs differently
— that is exactly the signal: regenerate the corpus DELIBERATELY
(``generate --force``) in the same change that bumps the format, the
review showing both.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from ..common.encoding import Decoder, Encoder

CORPUS_DIR = (
    pathlib.Path(__file__).resolve().parents[2] / "corpus" / "dencoder"
)


def _sample_messages():
    """Deterministic sample instances of every registered message."""
    from ..msg import message as M

    samples = {
        "MPing": M.MPing(from_osd=3, stamp=12.5, is_reply=True),
        "MOSDOp": M.MOSDOp(
            pool=7, pgid="7.3", oid="obj-1", op=M.OSD_OP_WRITE,
            offset=4096, length=11, data=b"hello world",
            attr="k", reqid="client.9", epoch=42, snapid=5,
            snap_seq=6, flags=M.OSD_FLAG_FULL_TRY, qos="gold",
        ),
        "MOSDOpReply": M.MOSDOpReply(
            ok=True, error="", data=b"payload", names=["a", "b"],
            size=11, epoch=42,
        ),
        "MMonCommand": M.MMonCommand(cmd='{"prefix": "status"}'),
        "MMonCommandReply": M.MMonCommandReply(
            rc=-22, outs="bad", outb='{"x": 1}'
        ),
        "MMonSubscribe": M.MMonSubscribe(start_epoch=9),
        "MOSDBoot": M.MOSDBoot(osd=2, addr="127.0.0.1:6800"),
        "MOSDFailure": M.MOSDFailure(
            target=1, reporter=0, failed_for=30
        ),
        "MClientRequest": M.MClientRequest(
            op="mkdir", args='{"path": "/d"}', reqid="c.1"
        ),
        "MClientReply": M.MClientReply(rc=0, outs="", outb='{"ino": 5}'),
        "MClientCaps": M.MClientCaps(action="revoke", ino=77),
        "MMgrReport": M.MMgrReport(
            daemon="osd.1", perf='{"op": 4}',
            spans='[{"trace_id": "t", "span_id": "s"}]',
            crashes='[{"crash_id": "c", "entity_name": "osd.1"}]',
        ),
        "MLog": M.MLog(
            name="osd.1",
            entries='[{"name": "osd.1", "channel": "cluster", '
            '"prio": "warn", "message": "m", "seq": 1, '
            '"stamp": 1.5}]',
        ),
        "MRepScrub": M.MRepScrub(
            op="scan", pgid="1.3", epoch=42, from_osd=0,
            deep=True, oids=["o_a", "o_b"],
        ),
        "MScrubMap": M.MScrubMap(
            pgid="1.3", from_osd=2, ok=True, error="",
            map_json='{"o_a": {"exists": true, "size": 11, '
            '"data_digest": 7}}',
        ),
        "MScrubCommand": M.MScrubCommand(
            op="deep-scrub", pgid="1.3"
        ),
        "MOSDBackoff": M.MOSDBackoff(
            op=M.BACKOFF_OP_BLOCK, pgid="7.3", id=4,
            reason="full", epoch=42,
        ),
        "MCommand": M.MCommand(
            cmd='{"prefix": "fault list"}'
        ),
        # the recovery protocol: pull/push/reply + the
        # two-sided reservation handshake — pinned so a
        # recovery-message format drift fails the corpus gate
        "MPGPull": M.MPGPull(
            pgid="7.3", epoch=42, oid="obj-1", shard=2
        ),
        "MPGPush": M.MPGPush(
            pgid="7.3", epoch=42, oid="obj-1", exists=True,
            data=b"shard-bytes",
            attrs={"hinfo_key": b'{"size": 11}', "u_color": b"teal"},
            omap={"k1": b"v1"},
            entry_blob=b"entry",
        ),
        "MPGPushReply": M.MPGPushReply(from_osd=2, ok=True),
        "MRecoveryReserve": M.MRecoveryReserve(
            op="request", pgid="7.3", epoch=42, from_osd=1
        ),
        # the PG-stats plane: OSD → mgr per-PG accounting
        # + piggybacked progress events
        "MPGStats": M.MPGStats(
            osd=1, epoch=42,
            stats='[{"pgid": "7.3", "state": "active+clean", '
            '"num_objects": 4, "num_bytes": 4096, '
            '"num_objects_degraded": 0}]',
            events='[{"id": "scrub pg 7.3 (osd.1)", '
            '"message": "scrub pg 7.3 (osd.1)", '
            '"fraction": 0.5, "done": false}]',
        ),
    }
    for name, msg in samples.items():
        msg.tid = 99
    return samples


def _build_types():
    """name -> (sample_bytes_builder, roundtrip) where roundtrip
    decodes a blob and re-encodes it with TODAY's code."""
    from ..crush.builder import CrushMap
    from ..crush.encode import decode_crush_map, encode_crush_map
    from ..crush.types import CRUSH_BUCKET_STRAW2, Tunables
    from ..msg import message as M
    from ..osd.daemon import (
        _decode_entry,
        _decode_info,
        _encode_entry,
        _encode_info,
    )
    from ..osd.osdmap import Incremental, OSDMap, PgPool
    from ..osd.pg_log import LogEntry, PGInfo
    from ..store.objectstore import (
        Transaction,
        decode_transaction,
        encode_transaction,
    )

    def crush_sample() -> CrushMap:
        m = CrushMap(tunables=Tunables())
        hosts = [
            m.add_bucket(
                CRUSH_BUCKET_STRAW2, 1, [h * 2, h * 2 + 1],
                [0x10000, 0x18000], name=f"host{h}",
            )
            for h in range(3)
        ]
        m.add_bucket(
            CRUSH_BUCKET_STRAW2, 3, hosts,
            [m.buckets[b].weight for b in hosts], name="default",
        )
        m.add_simple_rule("data", "default", "host", mode="firstn")
        return m

    def osdmap_sample() -> OSDMap:
        om = OSDMap.build(crush_sample(), 6)
        om.pools[1] = PgPool(
            pool_id=1, size=3, min_size=2, pg_num=8,
            crush_rule=0, last_change=3,
        )
        om.pool_names[1] = "data"
        om.pg_upmap_items[(1, 3)] = ((0, 4),)
        om.epoch = 7
        return om

    def inc_sample() -> Incremental:
        inc = osdmap_sample().new_incremental()
        inc.mark_down(2)
        inc.new_weight[3] = 0x8000
        return inc

    types = {}

    # messages pin their full FRAME (header + crcs + payload)
    for name, msg in _sample_messages().items():
        mtype = msg.TYPE

        def build(msg=msg) -> bytes:
            return msg.to_frame()

        def roundtrip(blob: bytes, mtype=mtype) -> bytes:
            hdr = blob[: M.Message.HEADER_SIZE]
            got_type, tid, plen = M.Message.parse_header(hdr)
            assert got_type == mtype, f"type moved: {got_type}"
            body = blob[M.Message.HEADER_SIZE :]
            decoded = M.Message.from_payload(
                got_type, tid, body[:plen],
                int.from_bytes(body[plen:], "little"),
            )
            return decoded.to_frame()

        types[f"msg_{name}"] = (build, roundtrip)

    types["osdmap_full"] = (
        lambda: osdmap_sample().encode(),
        lambda blob: OSDMap.decode(blob).encode(),
    )
    types["osdmap_incremental"] = (
        lambda: inc_sample().encode(),
        lambda blob: Incremental.decode(blob).encode(),
    )
    types["crush_map"] = (
        lambda: encode_crush_map(crush_sample()),
        lambda blob: encode_crush_map(decode_crush_map(blob)),
    )

    entry = LogEntry(
        op=0, oid="obj", version=(7, 21), prior_version=(7, 20),
        reqid="client.4",
    )
    types["pg_log_entry"] = (
        lambda: _encode_entry(entry),
        lambda blob: _encode_entry(_decode_entry(blob)),
    )
    info = PGInfo(
        pgid="1.3", last_update=(7, 21), log_tail=(6, 2),
        last_epoch_started=7,
    )
    types["pg_info"] = (
        lambda: _encode_info(info),
        lambda blob: _encode_info(_decode_info(blob)),
    )

    txn = (
        Transaction()
        .create_collection("c")
        .touch("c", "o")
        .write("c", "o", 128, b"bytes")
        .truncate("c", "o", 64)
        .setattr("c", "o", "a", b"v")
        .omap_setkeys("c", "o", {"k": b"v"})
        .omap_rmkeys("c", "o", ["dead"])
        .clone("c", "o", "o2")
        .remove("c", "o2")
    )

    def txn_build() -> bytes:
        e = Encoder()
        encode_transaction(e, txn)
        return e.getvalue()

    def txn_roundtrip(blob: bytes) -> bytes:
        e = Encoder()
        encode_transaction(e, decode_transaction(Decoder(blob)))
        return e.getvalue()

    types["objectstore_transaction"] = (txn_build, txn_roundtrip)

    # WAL plane (store/wal_store.py): the on-log record (seq + crc
    # over the transaction payload) and the replay-base checkpoint are
    # durable formats — a log written by one build must replay under
    # every later one
    from ..store.wal_store import (
        WALCheckpoint,
        decode_wal_checkpoint,
        decode_wal_record,
        encode_wal_checkpoint,
        encode_wal_record,
        make_wal_record,
    )

    def wal_record_build() -> bytes:
        e = Encoder()
        encode_wal_record(e, make_wal_record(42, txn_build()))
        return e.getvalue()

    def wal_record_roundtrip(blob: bytes) -> bytes:
        e = Encoder()
        encode_wal_record(e, decode_wal_record(Decoder(blob)))
        return e.getvalue()

    types["wal_record"] = (wal_record_build, wal_record_roundtrip)

    def wal_ckpt_build() -> bytes:
        e = Encoder()
        encode_wal_checkpoint(e, WALCheckpoint(1337))
        return e.getvalue()

    def wal_ckpt_roundtrip(blob: bytes) -> bytes:
        e = Encoder()
        encode_wal_checkpoint(e, decode_wal_checkpoint(Decoder(blob)))
        return e.getvalue()

    types["wal_checkpoint"] = (wal_ckpt_build, wal_ckpt_roundtrip)

    # latency-histogram snapshots (the SLO plane's wire/artifact
    # shapes, common/histogram.py): the 1D log2 histogram and the 2D
    # latency×size grid both pin their binary snapshot encoding
    from ..common.histogram import LogHistogram, PerfHistogram2D

    def hist_sample() -> LogHistogram:
        h = LogHistogram()
        for v in (1e-5, 3e-4, 3e-4, 0.002, 0.05, 1.7, 900.0, 1e9):
            h.add(v)
        return h

    def grid_sample() -> PerfHistogram2D:
        g = PerfHistogram2D()
        for lat, size in (
            (1e-4, 4096.0), (0.003, 65536.0), (0.2, 1.0),
            (9.0, 1 << 26),
        ):
            g.add(lat, size)
        return g

    types["perf_histogram"] = (
        lambda: hist_sample().encode(),
        lambda blob: LogHistogram.decode(blob).encode(),
    )
    types["perf_histogram_2d"] = (
        lambda: grid_sample().encode(),
        lambda blob: PerfHistogram2D.decode(blob).encode(),
    )

    # sharded bucket-index plane (rgw/index.py): the bucket metadata
    # record (index layout + live reshard descriptor) and the
    # reshard-queue entry pin their canonical encodings — a record
    # shape drift would strand every bucket written before it
    from ..rgw.index import (
        decode_bucket_record,
        decode_reshard_entry,
        encode_bucket_record,
        encode_reshard_entry,
    )

    bucket_rec = {
        "ctime": 1700000000.0,
        "owner": "alice",
        "acl": {
            "owner": "alice",
            "grants": [
                {"grantee": "alice", "permission": "FULL_CONTROL"}
            ],
        },
        "index": {"gen": 2, "num_shards": 8},
        "reshard": {
            "status": "in_progress",
            "target_gen": 3,
            "target_shards": 16,
            "stamp": 1700000001.5,
        },
    }
    types["rgw_bucket_record"] = (
        lambda: encode_bucket_record(bucket_rec),
        lambda blob: encode_bucket_record(
            decode_bucket_record(blob)
        ),
    )
    reshard_ent = {
        "bucket": "photos",
        "target_shards": 16,
        "reason": "threshold",
        "queued_at": 1700000002.25,
    }
    types["rgw_reshard_entry"] = (
        lambda: encode_reshard_entry(reshard_ent),
        lambda blob: encode_reshard_entry(
            decode_reshard_entry(blob)
        ),
    )

    # the PGMap digest (mgr/pgmap.py): the mgr→mon rollup the status
    # / df / health surfaces read — sorted-map encoding, so the same
    # digest is always the same bytes
    from ..mgr.pgmap import decode_pgmap_digest, encode_pgmap_digest

    digest_sample = {
        "version": 1,
        "num_pgs": 8,
        "num_pools": 1,
        "pg_states": {"active+clean": 7, "active+degraded": 1},
        "pools": {
            1: {
                "name": "data", "num_pgs": 8, "active_pgs": 8,
                "objects": 24, "bytes": 49152, "degraded": 3,
                "misplaced": 0, "unfound": 0,
            }
        },
        "totals": {
            "objects": 24, "bytes": 49152, "degraded": 3,
            "misplaced": 0, "unfound": 0,
        },
        "io": {
            "ops_sec": 12.5, "read_ops_sec": 4.5,
            "write_ops_sec": 8.0,
        },
        "recovery": {"objects_sec": 2.0, "bytes_sec": 4096.0},
        "pgs": {
            "1.3": {
                "state": "active+degraded", "objects": 3,
                "bytes": 6144, "degraded": 3, "misplaced": 0,
                "unfound": 0, "up": [0, 1, 2], "acting": [0, 1],
                "reported_epoch": 7, "recovery_progress": 0.25,
            }
        },
    }
    types["pgmap_digest"] = (
        lambda: encode_pgmap_digest(digest_sample),
        lambda blob: encode_pgmap_digest(
            decode_pgmap_digest(blob)
        ),
    )
    return types


def list_types() -> list[str]:
    return sorted(_build_types())


def generate(force: bool = False) -> list[str]:
    """Pin missing sample encodings (all of them with --force)."""
    CORPUS_DIR.mkdir(parents=True, exist_ok=True)
    written = []
    for name, (build, _rt) in sorted(_build_types().items()):
        path = CORPUS_DIR / f"{name}.bin"
        if path.exists() and not force:
            continue
        path.write_bytes(build())
        written.append(name)
    return written


def check() -> dict[str, str]:
    """Decode+re-encode every pinned blob; returns {type: error}
    (empty = the formats still read everything in the wild)."""
    errors: dict[str, str] = {}
    types = _build_types()
    for name, (_build, roundtrip) in sorted(types.items()):
        path = CORPUS_DIR / f"{name}.bin"
        if not path.exists():
            errors[name] = "not pinned (run dencoder generate)"
            continue
        blob = path.read_bytes()
        try:
            again = roundtrip(blob)
        except Exception as e:  # noqa: BLE001 — any decode failure
            # IS the regression being hunted
            errors[name] = f"decode failed: {type(e).__name__}: {e}"
            continue
        if again != blob:
            errors[name] = (
                f"re-encode differs ({len(blob)} -> {len(again)} "
                "bytes): format changed against pinned data"
            )
    for path in sorted(CORPUS_DIR.glob("*.bin")):
        if path.stem not in types:
            errors[path.stem] = "pinned but no longer registered"
    return errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dencoder", description=__doc__.splitlines()[0]
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    g = sub.add_parser("generate")
    g.add_argument("--force", action="store_true")
    sub.add_parser("check")
    d = sub.add_parser("decode")
    d.add_argument("-t", "--type", required=True)
    d.add_argument("file")
    args = p.parse_args(argv)
    if args.cmd == "list":
        print("\n".join(list_types()))
        return 0
    if args.cmd == "generate":
        for name in generate(force=args.force):
            print(f"pinned {name}")
        return 0
    if args.cmd == "check":
        errors = check()
        for name, err in errors.items():
            print(f"{name}: {err}", file=sys.stderr)
        ok = sum(1 for t in list_types() if t not in errors)
        print(f"{ok} ok, {len(errors)} bad")
        return 1 if errors else 0
    if args.cmd == "decode":
        types = _build_types()
        if args.type not in types:
            print(f"unknown type {args.type}", file=sys.stderr)
            return 2
        blob = pathlib.Path(args.file).read_bytes()
        again = types[args.type][1](blob)
        same = again == blob
        print(
            f"{args.type}: {len(blob)} bytes, re-encode "
            f"{'identical' if same else 'DIFFERS'}"
        )
        return 0 if same else 1
    return 2


if __name__ == "__main__":
    sys.exit(main())
