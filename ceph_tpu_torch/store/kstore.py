"""KStore — persistent ObjectStore: WAL + checkpoint over files.

The reference's default store is BlueStore (raw block device, RocksDB
metadata, its own WAL — src/os/bluestore/BlueStore.cc, 16k LoC); its
simpler sibling KStore keeps everything in the KV log.  This store
takes the KStore-class design, re-rendered for the framework:

- **write-ahead log**: every transaction is framed (length + crc32c
  over the framework transaction encoding, msg/message.py) and
  fsync'd to ``wal.log`` BEFORE the in-memory apply — commit means
  "in the WAL", exactly the ObjectStore::queue_transaction durability
  contract (src/os/ObjectStore.h:215).
- **checkpoint**: ``compact()`` snapshots the full state to
  ``snap.bin`` (write-to-temp + fsync + atomic rename) and truncates
  the WAL; crash anywhere leaves either the old or the new snapshot.
- **mount replay**: load the snapshot, then re-apply WAL entries in
  order; a torn tail (partial frame, crc mismatch — the
  kill-mid-write case) is detected and discarded, matching journal
  replay semantics.

Deviation from BlueStore, documented: no raw-block allocator, no
compression/checksum-per-blob, no RocksDB — object data lives in the
snapshot + WAL stream.  The Transaction API, atomicity, and
crash-restart behavior are the parity surface (SURVEY.md §5.4).
"""

from __future__ import annotations

import os
import pathlib
import threading

from ..common import lockdep
from ..common.encoding import Decoder, DecodeError, Encoder
from ..native import ceph_crc32c
from .framed_log import (
    append_frame,
    replay_frames,
    truncate_tail,
    write_checkpoint,
)
from .objectstore import (
    MemStore,
    StoreError,
    Transaction,
    decode_transaction,
    encode_transaction,
)

_SNAP = "snap.bin"
_WAL = "wal.log"
_SNAP_MAGIC = 0x4B53544F  # "KSTO" (v1: data + xattrs)
_SNAP_MAGIC_V2 = 0x4B535432  # "KST2" (v2: + omap)


class KStore(MemStore):
    """File-backed store; state in RAM, durability via WAL+snapshot."""

    def __init__(
        self,
        path: str | os.PathLike,
        sync: bool = True,
        compression: str = "none",
    ):
        """``compression`` names a compressor plugin for checkpoint
        blobs (the BlueStore blob-compression role at this store's
        granularity); snapshots record their codec, so a store written
        with one codec mounts under any configuration."""
        super().__init__()
        self.path = pathlib.Path(path)
        self.sync = sync
        from ..compressor import create as compressor_create

        self.compressor = compressor_create(compression)
        self.path.mkdir(parents=True, exist_ok=True)
        self._wal_lock = lockdep.Mutex("kstore.wal")
        self._mount()
        self._wal = open(self.path / _WAL, "ab")

    # -- durability plumbing ----------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        # validate + apply under the memstore lock, but WAL-append
        # first: an entry is only written once the ops are known to
        # apply cleanly, so we shadow-apply, then log, then commit.
        from .objectstore import residency_gens

        residency_gens.note_txn(self, txn)
        with self._lock:
            from .objectstore import _TxnState

            st = _TxnState(self)
            for op in txn.ops:
                self._apply(st, op)
            with self._wal_lock:
                e = Encoder()
                encode_transaction(e, txn)
                append_frame(self._wal, e.getvalue(), self.sync)
            self._commit(st)

    def compact(self) -> None:
        """Checkpoint: snapshot full state, truncate the WAL."""
        with self._lock:
            blob = self._snapshot()
            write_checkpoint(self.path / _SNAP, blob)
            with self._wal_lock:
                self._wal.close()
                self._wal = open(self.path / _WAL, "wb")
                if self.sync:
                    os.fsync(self._wal.fileno())

    def close(self) -> None:
        with self._wal_lock:
            if not self._wal.closed:
                self._wal.flush()
                if self.sync:
                    os.fsync(self._wal.fileno())
                self._wal.close()

    # -- snapshot format ---------------------------------------------------
    def _snapshot(self) -> bytes:
        e = Encoder()
        e.u32(_SNAP_MAGIC_V2)
        e.u32(len(self._colls))
        for cid in sorted(self._colls):
            e.string(cid)
            objs = self._colls[cid]
            e.u32(len(objs))
            for oid in sorted(objs):
                obj = objs[oid]
                e.string(oid)
                e.bytes(bytes(obj.data))
                e.map(
                    obj.xattrs,
                    lambda e2, k: e2.string(k),
                    lambda e2, v: e2.bytes(v),
                )
                e.map(
                    obj.omap,
                    lambda e2, k: e2.string(k),
                    lambda e2, v: e2.bytes(v),
                )
        body = e.getvalue()
        codec = self.compressor.name.encode()
        body = (
            len(codec).to_bytes(1, "little")
            + codec
            + self.compressor.compress(body)
        )
        return body + ceph_crc32c(0, body).to_bytes(4, "little")

    def _load_snapshot(self, blob: bytes) -> None:
        from .objectstore import _Object

        if len(blob) < 4:
            raise DecodeError("snapshot too short")
        body, crc = blob[:-4], int.from_bytes(blob[-4:], "little")
        if ceph_crc32c(0, body) != crc:
            raise DecodeError("snapshot crc mismatch")
        from ..compressor import CompressorError, create as compressor_create

        if len(body) >= 4 and int.from_bytes(
            body[:4], "little"
        ) in (_SNAP_MAGIC, _SNAP_MAGIC_V2):
            # legacy pre-compression snapshot: magic-first, raw body
            pass
        else:
            if len(body) < 1 or body[0] > 32:
                raise DecodeError("bad snapshot codec header")
            clen = body[0]
            try:
                codec = body[1 : 1 + clen].decode("ascii")
                body = compressor_create(codec).decompress(
                    body[1 + clen :]
                )
            except (CompressorError, UnicodeDecodeError) as e:
                raise DecodeError(f"snapshot decompress: {e}")
        d = Decoder(body)
        magic = d.u32()
        if magic not in (_SNAP_MAGIC, _SNAP_MAGIC_V2):
            raise DecodeError("bad snapshot magic")
        has_omap = magic == _SNAP_MAGIC_V2
        for _ in range(d.u32()):
            cid = d.string()
            coll: dict = {}
            for _ in range(d.u32()):
                oid = d.string()
                obj = _Object()
                obj.data = bytearray(d.bytes())
                obj.xattrs = d.map(
                    lambda d2: d2.string(), lambda d2: d2.bytes()
                )
                if has_omap:
                    obj.omap = d.map(
                        lambda d2: d2.string(), lambda d2: d2.bytes()
                    )
                coll[oid] = obj
            self._colls[cid] = coll

    # -- mount / replay ----------------------------------------------------
    def _mount(self) -> None:
        snap = self.path / _SNAP
        if snap.exists():
            self._load_snapshot(snap.read_bytes())
        wal = self.path / _WAL
        if not wal.exists():
            return
        raw = wal.read_bytes()
        pos = 0
        for body, end in replay_frames(raw):
            try:
                txn = decode_transaction(Decoder(body))
            except DecodeError:
                break
            try:
                super().queue_transaction(txn)
            except StoreError:
                # an entry that no longer applies cleanly (snapshot
                # already contains it and the op is not idempotent,
                # e.g. mkcoll): possible only for WAL entries logged
                # before the last compact raced a crash; skip it
                pass
            pos = end
        if pos < len(raw):
            # drop the torn tail so future appends start clean
            truncate_tail(wal, pos)
