"""BlockStore — the BlueStore-role extent store
(src/os/bluestore/BlueStore.cc reduced to its load-bearing design).

Where KStore keeps object data inside its snapshot+WAL stream, this
store puts data where BlueStore puts it:

- **one flat block file** (``block.dev`` — the raw-device role), with
  a first-fit **extent allocator** over 4KB units
  (src/os/bluestore/Allocator.h; the free map is rebuilt at mount by
  walking the metadata, exactly like BlueStore's allocator init from
  the FreelistManager/onode walk).
- **a KV metadata index** (the RocksDB role, src/kv/RocksDBStore.cc):
  onodes (size + xattrs + the logical→disk blob map), collection
  markers, and omap keys live in a log-structured KV — batch commits
  framed+crc'd into a WAL, periodically checkpointed, torn tails
  discarded at mount.
- **at-rest checksums verified on EVERY read**
  (BlueStore::_verify_csum): each blob records the crc32c of its
  on-disk bytes; any read that touches the blob re-verifies before
  returning, and a mismatch raises StoreError instead of returning
  rotted bytes.
- **inline compression** through the compressor plugin registry
  (CompressionPlugin.h): blobs compress on write when the codec
  actually saves space; the blob records its codec, so stores mount
  under any configuration.
- **fsck()**: walks every onode — blob extents in bounds,
  no double-allocated blocks, every checksum re-verified, omap keys
  orphan-checked (BlueStore::_fsck).

Durability ordering per transaction: data extents are written and
fsync'd to the block file FIRST, then the KV batch (onode/omap
changes) commits through the KV WAL — a crash between the two leaves
only unreferenced garbage in free space, never a committed onode
pointing at unwritten data.  Old extents are released only after the
KV commit (copy-on-write overwrites), so SIGKILL at any instant
yields either the old or the new object state.

Deviations, documented: no deferred-write path for small IO (every
write is COW), clone copies data (no shared-blob refcounting), csum
granularity is the blob (BlueStore defaults to 4KB csum chunks
inside blobs), and the KV is the framework's own WAL+checkpoint log
rather than RocksDB.
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
    ObjectStore,
    StoreError,
    Transaction,
)

ALLOC_UNIT = 4096
_SEP = "\x1f"  # KV key field separator (never appears in cid/oid)
_KV_WAL = "kv.log"
_KV_SNAP = "kv.snap"
_DEV = "block.dev"
_KV_MAGIC = 0x424B5631  # "BKV1"


def _okey(cid: str, oid: str) -> str:
    return f"o{_SEP}{cid}{_SEP}{oid}"


def _ckey(cid: str) -> str:
    return f"C{_SEP}{cid}"


def _mkey(cid: str, oid: str, key: str = "") -> str:
    return f"m{_SEP}{cid}{_SEP}{oid}{_SEP}{key}"


def _round_up(n: int) -> int:
    return (n + ALLOC_UNIT - 1) // ALLOC_UNIT * ALLOC_UNIT


class _KVLog:
    """Tiny log-structured KV (the RocksDB seat): dict state, batch
    WAL with length+crc frames, checkpoint with atomic rename, torn
    tails discarded at mount."""

    def __init__(self, path: pathlib.Path, sync: bool):
        self.path = path
        self.sync = sync
        self.db: dict[str, bytes] = {}
        self._mount()
        self._wal = open(self.path / _KV_WAL, "ab")

    def _mount(self) -> None:
        snap = self.path / _KV_SNAP
        if snap.exists():
            blob = snap.read_bytes()
            if len(blob) < 4:
                raise StoreError("kv snapshot too short")
            body, crc = blob[:-4], int.from_bytes(blob[-4:], "little")
            if ceph_crc32c(0, body) != crc:
                raise StoreError("kv snapshot crc mismatch")
            d = Decoder(body)
            if d.u32() != _KV_MAGIC:
                raise StoreError("bad kv snapshot magic")
            self.db = d.map(
                lambda d2: d2.string(), lambda d2: d2.bytes()
            )
        wal = self.path / _KV_WAL
        if not wal.exists():
            return
        raw = wal.read_bytes()
        pos = 0
        for body, end in replay_frames(raw):
            try:
                d = Decoder(body)
                sets = d.map(
                    lambda d2: d2.string(), lambda d2: d2.bytes()
                )
                dels = d.list(lambda d2: d2.string())
            except DecodeError:
                break
            self.db.update(sets)
            for k in dels:
                self.db.pop(k, None)
            pos = end
        if pos < len(raw):
            truncate_tail(wal, pos)

    def commit(self, sets: dict[str, bytes], dels) -> None:
        e = Encoder()
        e.map(
            sets, lambda e2, k: e2.string(k), lambda e2, v: e2.bytes(v)
        )
        e.list(list(dels), lambda e2, k: e2.string(k))
        body = e.getvalue()
        start = self._wal.tell()
        try:
            append_frame(self._wal, body, self.sync)
        except Exception:
            # a partially-written frame must not poison the WAL: later
            # commits would land after the torn bytes and be discarded
            # by replay even though they reported success
            try:
                self._wal.truncate(start)
                self._wal.seek(start)
            except Exception:
                pass
            raise
        # ---- durable point: nothing below may raise out of commit ----
        self.db.update(sets)
        for k in dels:
            self.db.pop(k, None)
        if self._wal.tell() > 4 << 20:
            try:
                self.compact()
            except Exception:
                # compaction is an optimization; the WAL already holds
                # the committed frame — a raise here would make the
                # caller roll back extents that durable onodes
                # reference (double-allocation corruption)
                pass

    def compact(self) -> None:
        e = Encoder()
        e.u32(_KV_MAGIC)
        e.map(
            self.db,
            lambda e2, k: e2.string(k),
            lambda e2, v: e2.bytes(v),
        )
        body = e.getvalue()
        blob = body + ceph_crc32c(0, body).to_bytes(4, "little")
        write_checkpoint(self.path / _KV_SNAP, blob)
        self._wal.close()
        self._wal = open(self.path / _KV_WAL, "wb")
        if self.sync:
            os.fsync(self._wal.fileno())

    def close(self) -> None:
        if not self._wal.closed:
            self._wal.flush()
            if self.sync:
                os.fsync(self._wal.fileno())
            self._wal.close()


class _Allocator:
    """First-fit extent allocator over the block file (Allocator.h
    role): free runs in 4KB units plus a growth frontier; rebuilt at
    mount from the onode walk."""

    def __init__(self):
        self.free: list[list[int]] = []  # sorted [off, len]
        self.frontier = 0

    def allocate(self, nbytes: int) -> tuple[int, int]:
        """One contiguous extent (off, alloc_len)."""
        need = _round_up(max(nbytes, 1))
        for run in self.free:
            if run[1] >= need:
                off = run[0]
                run[0] += need
                run[1] -= need
                if run[1] == 0:
                    self.free.remove(run)
                return off, need
        off = self.frontier
        self.frontier += need
        return off, need

    def release(self, off: int, length: int) -> None:
        import bisect

        need = _round_up(max(length, 1))
        i = bisect.bisect_left(self.free, [off, need])
        # coalesce with the immediate neighbours only — the list is
        # sorted and disjoint, so nothing further can touch the run
        if i > 0 and self.free[i - 1][0] + self.free[i - 1][1] == off:
            self.free[i - 1][1] += need
            j = i - 1
        else:
            self.free.insert(i, [off, need])
            j = i
        if (
            j + 1 < len(self.free)
            and self.free[j][0] + self.free[j][1] == self.free[j + 1][0]
        ):
            self.free[j][1] += self.free[j + 1][1]
            del self.free[j + 1]

    def rebuild(self, used: list[tuple[int, int]]) -> None:
        """Free map = complement of the used extents."""
        self.free = []
        pos = 0
        frontier = 0
        for off, length in sorted(used):
            length = _round_up(length)
            if off > pos:
                self.free.append([pos, off - pos])
            pos = max(pos, off + length)
            frontier = max(frontier, off + length)
        self.frontier = frontier


class _Onode:
    """In-memory onode: size, xattrs, and the logical→disk blob map
    (sorted, non-overlapping; gaps read as zeros)."""

    __slots__ = ("size", "xattrs", "blobs")

    def __init__(self, size=0, xattrs=None, blobs=None):
        self.size = size
        self.xattrs = xattrs if xattrs is not None else {}
        # blob: [loff, llen, doff, dlen, codec, crc]
        self.blobs = blobs if blobs is not None else []

    def encode(self) -> bytes:
        e = Encoder()
        e.u64(self.size)
        e.map(
            self.xattrs,
            lambda e2, k: e2.string(k),
            lambda e2, v: e2.bytes(v),
        )
        e.u32(len(self.blobs))
        for loff, llen, doff, dlen, codec, crc in self.blobs:
            e.u64(loff).u64(llen).u64(doff).u64(dlen)
            e.string(codec)
            e.u32(crc)
        return e.getvalue()

    @classmethod
    def decode(cls, blob: bytes) -> "_Onode":
        d = Decoder(blob)
        size = d.u64()
        xattrs = d.map(lambda d2: d2.string(), lambda d2: d2.bytes())
        blobs = []
        for _ in range(d.u32()):
            blobs.append(
                [d.u64(), d.u64(), d.u64(), d.u64(), d.string(), d.u32()]
            )
        return cls(size, xattrs, blobs)

    def copy(self) -> "_Onode":
        return _Onode(
            self.size, dict(self.xattrs), [list(b) for b in self.blobs]
        )


class BlockStore(ObjectStore):
    """Extent-allocated, checksummed, optionally-compressed store."""

    def __init__(
        self,
        path: str | os.PathLike,
        sync: bool = True,
        compression: str = "none",
        min_compress: int = 4096,
    ):
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.sync = sync
        from ..compressor import create as compressor_create

        self.compressor = compressor_create(compression)
        self._compressor_create = compressor_create
        self.min_compress = min_compress
        self._lock = lockdep.RMutex("blockstore")
        self.kv = _KVLog(self.path, sync)
        dev_path = self.path / _DEV
        if not dev_path.exists():
            dev_path.touch()
        self._dev = open(dev_path, "r+b")
        self.alloc = _Allocator()
        self._rebuild_allocator()

    def statfs(self) -> dict:
        # allocator accounting (O(free runs)): used = everything ever
        # allocated below the frontier minus the free runs — no onode
        # walk on the ~1 Hz fullness poll or the write hot path
        with self._lock:
            used = self.alloc.frontier - sum(
                run[1] for run in self.alloc.free
            )
        total = int(self.total_bytes)
        return {
            "total": total,
            "used": max(0, used),
            "avail": max(0, total - used),
        }

    def _rebuild_allocator(self) -> None:
        used = []
        for key, val in self.kv.db.items():
            if key.startswith("o" + _SEP):
                on = _Onode.decode(val)
                for _l, _ll, doff, dlen, _c, _crc in on.blobs:
                    used.append((doff, dlen))
        self.alloc.rebuild(used)

    # -- device IO ---------------------------------------------------------
    def _dev_read(self, off: int, length: int) -> bytes:
        self._dev.seek(off)
        got = self._dev.read(length)
        return got + b"\0" * (length - len(got))

    def _blob_data(self, blob, st=None) -> bytes:
        """Read + VERIFY one blob (BlueStore::_verify_csum on every
        read), decompressing as recorded.  ``st`` lets same-
        transaction reads see extents whose device write is still
        pending in the txn."""
        loff, llen, doff, dlen, codec, crc = blob
        raw = None
        if st is not None:
            for woff, wdata in st.dev_writes:
                if woff == doff:
                    raw = bytes(wdata[:dlen])
                    raw += b"\0" * (dlen - len(raw))
                    break
        if raw is None:
            raw = self._dev_read(doff, dlen)
        if ceph_crc32c(0, raw) != crc:
            raise StoreError(
                f"checksum mismatch reading extent {doff}+{dlen} "
                "(-EIO)"
            )
        if codec != "none":
            from ..compressor import CompressorError

            try:
                raw = self._compressor_create(codec).decompress(raw)
            except CompressorError as e:
                raise StoreError(f"blob decompress failed: {e}")
        return raw

    # -- transaction path --------------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        from .objectstore import residency_gens

        residency_gens.note_txn(self, txn)
        with self._lock:
            st = _BTxn(self)
            committed = False
            try:
                for op in txn.ops:
                    self._apply(st, op)
                # data first ...
                for off, data in st.dev_writes:
                    self._dev.seek(off)
                    self._dev.write(data)
                if st.dev_writes:
                    self._dev.flush()
                    if self.sync:
                        os.fsync(self._dev.fileno())
                # ... then metadata; a crash in between leaves only
                # unreferenced bytes in free space
                sets: dict[str, bytes] = {}
                dels: list[str] = []
                for cid in st.new_colls:
                    sets[_ckey(cid)] = b""
                for cid in st.dead_colls:
                    dels.append(_ckey(cid))
                dels.extend(st.kv_dels)
                for (cid, oid), on in st.onodes.items():
                    if on is None:
                        dels.append(_okey(cid, oid))
                    else:
                        sets[_okey(cid, oid)] = on.encode()
                for key, val in st.kv_sets.items():
                    sets[key] = val
                self.kv.commit(sets, dels)
                committed = True
            finally:
                if not committed:
                    # any failure before the KV commit — StoreError
                    # from an op, ENOSPC from the WAL append, even a
                    # malformed-tuple TypeError — must hand the fresh
                    # extents back, or every failed txn leaks space
                    # until remount
                    for off, length in st.allocated:
                        self.alloc.release(off, length)
            for off, length in st.freed:
                self.alloc.release(off, length)

    def _apply(self, st: "_BTxn", op) -> None:
        kind, cid, oid = op[0], op[1], op[2]
        if kind == "mkcoll":
            if st.coll_exists(cid):
                raise StoreError(f"collection {cid} exists (-EEXIST)")
            st.dead_colls.discard(cid)
            st.new_colls.add(cid)
        elif kind == "rmcoll":
            if not st.coll_exists(cid):
                raise StoreError(f"no collection {cid} (-ENOENT)")
            if not st.coll_empty(cid):
                raise StoreError(
                    f"collection {cid} not empty (-ENOTEMPTY)"
                )
            st.new_colls.discard(cid)
            st.dead_colls.add(cid)
        elif kind == "touch":
            st.get(cid, oid, create=True)
        elif kind == "write":
            _, _, _, offset, data = op
            self._op_write(st, cid, oid, offset, bytes(data))
        elif kind == "truncate":
            _, _, _, size = op
            self._op_truncate(st, cid, oid, size)
        elif kind == "setattr":
            _, _, _, name, value = op
            on = st.get(cid, oid)
            if on is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            on.xattrs[name] = bytes(value)
        elif kind == "rmattr":
            _, _, _, name = op
            on = st.get(cid, oid)
            if on is None or name not in on.xattrs:
                raise StoreError(
                    f"no attr {name} on {cid}/{oid} (-ENODATA)"
                )
            del on.xattrs[name]
        elif kind == "remove":
            on = st.get(cid, oid)
            if on is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            for b in on.blobs:
                st.freed.append((b[2], b[3]))
            st.onodes[(cid, oid)] = None
            for k in st.omap_keys(cid, oid):
                st.kv_dels.add(_mkey(cid, oid, k))
        elif kind == "omap_setkeys":
            _, _, _, kv = op
            if st.get(cid, oid) is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            for k, v in kv.items():
                st.kv_sets[_mkey(cid, oid, k)] = bytes(v)
                st.kv_dels.discard(_mkey(cid, oid, k))
        elif kind == "omap_rmkeys":
            _, _, _, keys = op
            if st.get(cid, oid) is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            for k in keys:
                st.kv_sets.pop(_mkey(cid, oid, k), None)
                st.kv_dels.add(_mkey(cid, oid, k))
        elif kind == "omap_clear":
            if st.get(cid, oid) is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            for k in st.omap_keys(cid, oid):
                st.kv_sets.pop(_mkey(cid, oid, k), None)
                st.kv_dels.add(_mkey(cid, oid, k))
        elif kind == "clone":
            _, _, src_oid, dst_oid = op
            src = st.get(cid, src_oid)
            if src is None:
                raise StoreError(
                    f"no object {cid}/{src_oid} (-ENOENT)"
                )
            data = self._read_onode(st, src, 0, src.size)
            prev = st.get(cid, dst_oid)
            if prev is not None:
                for b in prev.blobs:
                    st.freed.append((b[2], b[3]))
            dst = _Onode(0, dict(src.xattrs), [])
            st.onodes[(cid, dst_oid)] = dst
            if data:
                self._write_blob(st, dst, 0, data)
            dst.size = src.size
            # omap copies too
            old_dst = set(st.omap_keys(cid, dst_oid))
            for k in old_dst:
                st.kv_sets.pop(_mkey(cid, dst_oid, k), None)
                st.kv_dels.add(_mkey(cid, dst_oid, k))
            for k in st.omap_keys(cid, src_oid):
                st.kv_sets[_mkey(cid, dst_oid, k)] = st.omap_get_one(
                    cid, src_oid, k
                )
                st.kv_dels.discard(_mkey(cid, dst_oid, k))
        else:
            raise StoreError(f"unknown op {kind}")

    def _op_write(self, st, cid, oid, offset, data) -> None:
        on = st.get(cid, oid, create=True)
        end = offset + len(data)
        if not data:
            on.size = max(on.size, offset)
            return
        overl = [
            b
            for b in on.blobs
            if b[0] < end and b[0] + b[1] > offset
        ]
        lo = min([offset] + [b[0] for b in overl])
        hi = max([end] + [b[0] + b[1] for b in overl])
        buf = bytearray(hi - lo)
        for b in overl:
            got = self._blob_data(b, st)[: b[1]]
            buf[b[0] - lo : b[0] - lo + len(got)] = got
        buf[offset - lo : end - lo] = data
        for b in overl:
            st.freed.append((b[2], b[3]))
            on.blobs.remove(b)
        self._write_blob(st, on, lo, bytes(buf))
        on.size = max(on.size, end)

    def _write_blob(self, st, on, loff, data) -> None:
        codec = "none"
        stored = data
        if (
            self.compressor.name != "none"
            and len(data) >= self.min_compress
        ):
            packed = self.compressor.compress(data)
            # only keep it when compression actually saves a block
            if len(packed) + ALLOC_UNIT <= len(data):
                stored = packed
                codec = self.compressor.name
        doff, alen = self.alloc.allocate(len(stored))
        st.allocated.append((doff, alen))
        st.dev_writes.append((doff, stored))
        on.blobs.append(
            [
                loff,
                len(data),
                doff,
                len(stored),
                codec,
                ceph_crc32c(0, stored),
            ]
        )
        on.blobs.sort(key=lambda b: b[0])

    def _op_truncate(self, st, cid, oid, size) -> None:
        on = st.get(cid, oid, create=True)
        keep = []
        for b in on.blobs:
            if b[0] >= size:
                st.freed.append((b[2], b[3]))
            elif b[0] + b[1] > size:
                b[1] = size - b[0]  # tail trimmed; extent kept
                keep.append(b)
            else:
                keep.append(b)
        on.blobs = keep
        on.size = size

    def _read_onode(self, st, on, offset, length) -> bytes:
        if length < 0:
            length = on.size - offset
        length = max(0, min(length, on.size - offset))
        if length == 0:
            return b""
        buf = bytearray(length)
        end = offset + length
        for b in on.blobs:
            if b[0] >= end or b[0] + b[1] <= offset:
                continue
            data = self._blob_data(b, st)[: b[1]]
            s = max(offset, b[0])
            e = min(end, b[0] + b[1])
            buf[s - offset : e - offset] = data[s - b[0] : e - b[0]]
        return bytes(buf)

    # -- read surface ------------------------------------------------------
    def _onode(self, cid: str, oid: str) -> _Onode:
        if _ckey(cid) not in self.kv.db:
            raise StoreError(f"no collection {cid} (-ENOENT)")
        blob = self.kv.db.get(_okey(cid, oid))
        if blob is None:
            raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
        return _Onode.decode(blob)

    def read(self, cid, oid, offset=0, length=-1) -> bytes:
        with self._lock:
            on = self._onode(cid, oid)
            return self._read_onode(None, on, offset, length)

    def getattr(self, cid, oid, name) -> bytes:
        with self._lock:
            on = self._onode(cid, oid)
            if name not in on.xattrs:
                raise StoreError(f"no attr {name} (-ENODATA)")
            return on.xattrs[name]

    def stat(self, cid, oid) -> int:
        with self._lock:
            return self._onode(cid, oid).size

    def exists(self, cid, oid) -> bool:
        with self._lock:
            return _okey(cid, oid) in self.kv.db

    def list_collections(self) -> list[str]:
        with self._lock:
            p = "C" + _SEP
            return sorted(
                k[len(p):] for k in self.kv.db if k.startswith(p)
            )

    def coll_exists(self, cid: str) -> bool:
        with self._lock:
            return _ckey(cid) in self.kv.db

    def list_objects(self, cid) -> list[str]:
        with self._lock:
            if _ckey(cid) not in self.kv.db:
                raise StoreError(f"no collection {cid} (-ENOENT)")
            p = f"o{_SEP}{cid}{_SEP}"
            return sorted(
                k[len(p):] for k in self.kv.db if k.startswith(p)
            )

    def list_attrs(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return dict(self._onode(cid, oid).xattrs)

    def omap_get(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            self._onode(cid, oid)
            p = _mkey(cid, oid)
            return {
                k[len(p):]: v
                for k, v in self.kv.db.items()
                if k.startswith(p)
            }

    def omap_get_vals(
        self, cid, oid, start_after: str = "", max_return: int = -1
    ) -> dict[str, bytes]:
        with self._lock:
            omap = self.omap_get(cid, oid)
            out: dict[str, bytes] = {}
            for k in sorted(omap):
                if start_after and k <= start_after:
                    continue
                out[k] = omap[k]
                if 0 <= max_return <= len(out):
                    break
            return out

    # -- maintenance -------------------------------------------------------
    def compact(self) -> None:
        with self._lock:
            self.kv.compact()

    def close(self) -> None:
        with self._lock:
            self.kv.close()
            if not self._dev.closed:
                self._dev.flush()
                if self.sync:
                    os.fsync(self._dev.fileno())
                self._dev.close()

    def fsck(self) -> list[str]:
        """Full consistency walk (BlueStore::_fsck): every blob's
        checksum re-verified, extents bounds- and overlap-checked,
        omap keys matched to live onodes."""
        errors: list[str] = []
        with self._lock:
            seen: list[tuple[int, int, str]] = []
            dev_size = self._dev.seek(0, 2)
            for key, val in sorted(self.kv.db.items()):
                if not key.startswith("o" + _SEP):
                    continue
                _tag, cid, oid = key.split(_SEP, 2)
                if _ckey(cid) not in self.kv.db:
                    errors.append(f"{cid}/{oid}: orphan collection")
                try:
                    on = _Onode.decode(val)
                except DecodeError as e:
                    errors.append(f"{cid}/{oid}: onode decode: {e}")
                    continue
                for b in on.blobs:
                    if b[2] + b[3] > max(dev_size, self.alloc.frontier):
                        errors.append(
                            f"{cid}/{oid}: blob extent {b[2]}+{b[3]} "
                            "out of bounds"
                        )
                        continue
                    try:
                        self._blob_data(b)
                    except StoreError as e:
                        errors.append(f"{cid}/{oid}: {e}")
                    seen.append((b[2], _round_up(b[3]), f"{cid}/{oid}"))
            seen.sort()
            for (o1, l1, n1), (o2, _l2, n2) in zip(seen, seen[1:]):
                if o1 + l1 > o2:
                    errors.append(
                        f"extent overlap: {n1} and {n2} share blocks"
                    )
            for key in self.kv.db:
                if key.startswith("m" + _SEP):
                    _tag, cid, oid, _k = key.split(_SEP, 3)
                    if _okey(cid, oid) not in self.kv.db:
                        errors.append(f"{cid}/{oid}: orphan omap key")
        return errors


class _BTxn:
    """Transaction-local shadow state (the MemStore _TxnState shape
    rendered for KV-backed onodes)."""

    def __init__(self, store: BlockStore):
        self.store = store
        self.onodes: dict[tuple[str, str], _Onode | None] = {}
        self.new_colls: set[str] = set()
        self.dead_colls: set[str] = set()
        self.kv_sets: dict[str, bytes] = {}
        self.kv_dels: set[str] = set()
        self.dev_writes: list[tuple[int, bytes]] = []
        self.allocated: list[tuple[int, int]] = []
        self.freed: list[tuple[int, int]] = []

    def coll_exists(self, cid: str) -> bool:
        if cid in self.dead_colls:
            return False
        return cid in self.new_colls or _ckey(cid) in self.store.kv.db

    def coll_empty(self, cid: str) -> bool:
        p = f"o{_SEP}{cid}{_SEP}"
        for key in self.store.kv.db:
            if key.startswith(p):
                oid = key[len(p):]
                if self.onodes.get((cid, oid), ...) is not None:
                    return False
        for (c, _oid), on in self.onodes.items():
            if c == cid and on is not None:
                return False
        return True

    def get(self, cid: str, oid: str, create: bool = False):
        key = (cid, oid)
        if key in self.onodes:
            on = self.onodes[key]
            if on is None and create:
                on = self.onodes[key] = _Onode()
            return on
        if not self.coll_exists(cid):
            raise StoreError(f"no collection {cid} (-ENOENT)")
        blob = self.store.kv.db.get(_okey(cid, oid))
        if blob is None:
            if not create:
                return None
            on = _Onode()
        else:
            on = _Onode.decode(blob)
        self.onodes[key] = on
        return on

    def omap_keys(self, cid: str, oid: str) -> list[str]:
        p = _mkey(cid, oid)
        keys = {
            k[len(p):]
            for k in self.store.kv.db
            if k.startswith(p)
        }
        for k in self.kv_sets:
            if k.startswith(p):
                keys.add(k[len(p):])
        for k in self.kv_dels:
            if k.startswith(p):
                keys.discard(k[len(p):])
        return sorted(keys)

    def omap_get_one(self, cid: str, oid: str, key: str) -> bytes:
        full = _mkey(cid, oid, key)
        if full in self.kv_sets:
            return self.kv_sets[full]
        return self.store.kv.db.get(full, b"")
