"""ceph-objectstore-tool analog — offline store surgery
(src/tools/ceph_objectstore_tool.cc): inspect/export/import/remove
objects in a STOPPED OSD's KStore directory.

    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR <op>

    ops: list-collections | list [COLL] | info COLL OID
         export COLL OID FILE | import COLL OID FILE
         remove COLL OID | export-pg COLL FILE | import-pg FILE
         fsck

Export blobs carry data + xattrs + omap (the tool's object dump
format); ``export-pg``/``import-pg`` move a whole collection, the
offline-PG-surgery use case (e.g. rescuing a PG from a dead OSD's
store into a replacement).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..common.encoding import Decoder, Encoder
from ..store.kstore import KStore
from ..store.objectstore import StoreError, Transaction

_MAGIC = 0x4F535442  # "OSTB"


def _export_obj(store, cid: str, oid: str) -> bytes:
    e = Encoder()
    e.u32(_MAGIC).string(cid).string(oid)
    e.bytes(store.read(cid, oid))
    e.map(
        store.list_attrs(cid, oid),
        lambda e2, k: e2.string(k),
        lambda e2, v: e2.bytes(v),
    )
    e.map(
        store.omap_get(cid, oid),
        lambda e2, k: e2.string(k),
        lambda e2, v: e2.bytes(v),
    )
    return e.getvalue()


def _import_obj(store, blob: bytes, cid=None, oid=None) -> tuple[str, str]:
    d = Decoder(blob)
    if d.u32() != _MAGIC:
        raise StoreError("bad export magic")
    b_cid, b_oid = d.string(), d.string()
    cid, oid = cid or b_cid, oid or b_oid
    data = d.bytes()
    attrs = d.map(lambda d2: d2.string(), lambda d2: d2.bytes())
    omap = d.map(lambda d2: d2.string(), lambda d2: d2.bytes())
    txn = Transaction()
    if cid not in store.list_collections():
        txn.create_collection(cid)
    elif store.exists(cid, oid):
        txn.remove(cid, oid)
    txn.touch(cid, oid)
    if data:
        txn.write(cid, oid, 0, data)
    for k, v in attrs.items():
        txn.setattr(cid, oid, k, v)
    if omap:
        txn.omap_setkeys(cid, oid, omap)
    store.queue_transaction(txn)
    return cid, oid


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="objectstore_tool", description=__doc__
    )
    p.add_argument("--data-path", required=True)
    p.add_argument("op", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if not args.op:
        p.error("no op")
    store = KStore(args.data_path)
    try:
        op, rest = args.op[0], args.op[1:]
        if op == "list-collections":
            for cid in store.list_collections():
                print(cid)
        elif op == "list":
            colls = rest or store.list_collections()
            for cid in colls:
                for oid in store.list_objects(cid):
                    print(f"{cid}\t{oid}")
        elif op == "info":
            cid, oid = rest
            print(
                json.dumps(
                    {
                        "collection": cid,
                        "oid": oid,
                        "size": store.stat(cid, oid),
                        "xattrs": sorted(store.list_attrs(cid, oid)),
                        "omap_keys": len(store.omap_get(cid, oid)),
                    }
                )
            )
        elif op == "export":
            cid, oid, path = rest
            blob = _export_obj(store, cid, oid)
            (sys.stdout.buffer.write(blob) if path == "-"
             else open(path, "wb").write(blob))
        elif op == "import":
            cid, oid, path = rest
            _import_obj(store, open(path, "rb").read(), cid, oid)
            store.compact()
        elif op == "remove":
            cid, oid = rest
            store.queue_transaction(Transaction().remove(cid, oid))
            store.compact()
        elif op == "export-pg":
            cid, path = rest
            e = Encoder()
            oids = store.list_objects(cid)
            e.u32(len(oids))
            for oid in oids:
                e.bytes(_export_obj(store, cid, oid))
            open(path, "wb").write(e.getvalue())
        elif op == "import-pg":
            (path,) = rest
            d = Decoder(open(path, "rb").read())
            n = d.u32()
            for _ in range(n):
                _import_obj(store, d.bytes())
            store.compact()
            print(f"imported {n} objects")
        elif op == "fsck":
            # the KStore mount already replays + validates the WAL and
            # snapshot crc; walk everything to force full reads
            objs = 0
            for cid in store.list_collections():
                for oid in store.list_objects(cid):
                    store.read(cid, oid)
                    store.list_attrs(cid, oid)
                    store.omap_get(cid, oid)
                    objs += 1
            print(
                json.dumps(
                    {
                        "collections": len(store.list_collections()),
                        "objects": objs,
                        "ok": True,
                    }
                )
            )
        else:
            print(f"unknown op {op!r}", file=sys.stderr)
            return 2
        return 0
    finally:
        store.close()


if __name__ == "__main__":
    sys.exit(main())
