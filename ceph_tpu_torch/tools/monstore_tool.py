"""ceph-monstore-tool analog — offline mon-store surgery
(src/tools/ceph_monstore_tool.cc).

Operates on a STOPPED monitor's MonitorStore (the MonitorDBStore
role: versioned osdmap blobs behind an ObjectStore — KStore or
BlockStore on disk).  The rescue walk the reference supports:

- ``status``            — last_committed + which full/incremental
                          epochs the store actually holds
- ``dump [--epoch N]``  — JSON summary of a committed map
- ``export/import``     — raw full-map blobs out of / into the store
                          (get-osdmap / rebuild inputs)
- ``set-last-committed``— rewind/advance the committed pointer to an
                          epoch the store holds (the
                          rebuild/rewrite-crush class of rescue)
- ``prune --keep K``    — drop history below last_committed-K

Every mutation goes through the store's transaction API, so the
repair itself is crash-safe.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..mon.monitor import MON_COLL, MonitorStore
from ..osd.osdmap import OSDMap
from ..store.objectstore import StoreError, Transaction


def open_store(path: str):
    """Mount the on-disk store backing a stopped monitor (KStore or
    BlockStore, detected by their files)."""
    p = pathlib.Path(path)
    if (p / "block.dev").exists() or (p / "kv.log").exists():
        from ..store.blockstore import BlockStore

        return BlockStore(p)
    if (p / "wal.log").exists() or (p / "snap.bin").exists():
        from ..store import KStore

        return KStore(p)
    raise SystemExit(f"{path}: no KStore or BlockStore found")


class MonStore:
    """The tool's view over a MonitorStore's key layout."""

    def __init__(self, store):
        self.store = store
        self.ms = MonitorStore(store)

    def epochs(self) -> tuple[list[int], list[int]]:
        fulls, incs = [], []
        try:
            names = self.store.list_objects(MON_COLL)
        except StoreError:
            return [], []
        for n in names:
            if n.startswith("osdmap_full_"):
                fulls.append(int(n[len("osdmap_full_"):]))
            elif n.startswith("osdmap_inc_"):
                incs.append(int(n[len("osdmap_inc_"):]))
        return sorted(fulls), sorted(incs)

    def status(self) -> dict:
        fulls, incs = self.epochs()
        lc = self.ms.last_committed()
        return {
            "last_committed": lc,
            "full_epochs": fulls,
            "incremental_epochs": incs,
            "consistent": lc in fulls if fulls else lc == 0,
        }

    def get_map(self, epoch: int | None = None) -> OSDMap:
        epoch = epoch or self.ms.last_committed()
        blob = self.ms.get_full(epoch)
        if blob is None:
            raise SystemExit(f"no full map for epoch {epoch}")
        return OSDMap.decode(blob)

    def dump(self, epoch: int | None = None) -> dict:
        m = self.get_map(epoch)
        return {
            "epoch": m.epoch,
            "max_osd": m.max_osd,
            "up_osds": [o for o in range(m.max_osd) if m.is_up(o)],
            "pools": {
                m.pool_names.get(pid, str(pid)): {
                    "id": pid,
                    "type": p.type,
                    "size": p.size,
                    "pg_num": p.pg_num,
                    "snap_seq": p.snap_seq,
                }
                for pid, p in m.pools.items()
            },
            "pg_upmap_items": len(m.pg_upmap_items),
        }

    def export_map(self, epoch: int | None, out: str) -> int:
        epoch = epoch or self.ms.last_committed()
        blob = self.ms.get_full(epoch)
        if blob is None:
            raise SystemExit(f"no full map for epoch {epoch}")
        pathlib.Path(out).write_bytes(blob)
        return epoch

    def import_map(self, path: str) -> int:
        """Install a full-map blob at ITS OWN epoch (rebuild input);
        advances last_committed when the blob is newer."""
        blob = pathlib.Path(path).read_bytes()
        m = OSDMap.decode(blob)  # validates before any write
        txn = Transaction()
        txn.touch(MON_COLL, f"osdmap_full_{m.epoch}")
        txn.truncate(MON_COLL, f"osdmap_full_{m.epoch}", 0)
        txn.write(MON_COLL, f"osdmap_full_{m.epoch}", 0, blob)
        if m.epoch > self.ms.last_committed():
            txn.touch(MON_COLL, "meta")
            txn.setattr(
                MON_COLL, "meta", "last_committed",
                str(m.epoch).encode(),
            )
        self.store.queue_transaction(txn)
        return m.epoch

    def set_last_committed(self, epoch: int) -> None:
        fulls, _ = self.epochs()
        if epoch not in fulls:
            raise SystemExit(
                f"store holds no full map for epoch {epoch} "
                f"(have {fulls})"
            )
        txn = Transaction()
        txn.touch(MON_COLL, "meta")
        txn.setattr(
            MON_COLL, "meta", "last_committed", str(epoch).encode()
        )
        self.store.queue_transaction(txn)

    def prune(self, keep: int) -> list[int]:
        """Drop full+inc blobs below last_committed - keep (the
        reference's compaction/prune rescue)."""
        lc = self.ms.last_committed()
        cutoff = lc - max(keep, 0)
        fulls, incs = self.epochs()
        dropped = []
        txn = Transaction()
        for e in fulls:
            if e < cutoff:
                txn.remove(MON_COLL, f"osdmap_full_{e}")
                dropped.append(e)
        for e in incs:
            if e < cutoff:
                txn.remove(MON_COLL, f"osdmap_inc_{e}")
        if txn.ops:
            self.store.queue_transaction(txn)
        return dropped


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="monstore-tool", description=__doc__.splitlines()[0]
    )
    p.add_argument("path", help="stopped monitor's store directory")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status")
    d = sub.add_parser("dump")
    d.add_argument("--epoch", type=int)
    e = sub.add_parser("export")
    e.add_argument("--epoch", type=int)
    e.add_argument("--out", required=True)
    i = sub.add_parser("import")
    i.add_argument("--in", dest="infile", required=True)
    slc = sub.add_parser("set-last-committed")
    slc.add_argument("epoch", type=int)
    pr = sub.add_parser("prune")
    pr.add_argument("--keep", type=int, default=32)
    args = p.parse_args(argv)

    store = open_store(args.path)
    try:
        t = MonStore(store)
        if args.cmd == "status":
            print(json.dumps(t.status(), indent=2))
        elif args.cmd == "dump":
            print(json.dumps(t.dump(args.epoch), indent=2))
        elif args.cmd == "export":
            epoch = t.export_map(args.epoch, args.out)
            print(f"exported epoch {epoch} to {args.out}")
        elif args.cmd == "import":
            epoch = t.import_map(args.infile)
            print(f"imported full map at epoch {epoch}")
        elif args.cmd == "set-last-committed":
            t.set_last_committed(args.epoch)
            print(f"last_committed = {args.epoch}")
        elif args.cmd == "prune":
            dropped = t.prune(args.keep)
            print(f"pruned {len(dropped)} full maps")
    finally:
        close = getattr(store, "close", None)
        if close is not None:
            close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
