"""Transactional object store boundary (src/os/ObjectStore.h,
src/os/Transaction.h) with a RAM backend (src/os/memstore/).

A Transaction is an ordered op list applied atomically by
``queue_transaction`` — all or nothing, like the reference's contract
(BlueStore gets atomicity from its WAL; memstore from applying to a
per-object shadow and merging only on success).  Objects are byte
arrays with xattrs, grouped into collections.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass, field

from ..common.encoding import Decoder, Encoder
from ..common import lockdep


class StoreError(Exception):
    pass


class ResidencyGens:
    """Per-(store, cid, oid) mutation generations — the invalidation
    spine of the device-payload residency cache (ops/residency.py).

    Every concrete ``queue_transaction`` notes its transaction here
    BEFORE applying, so a device-resident copy of an object registered
    at generation g can never serve a digest once ANY transaction —
    client write, recovery push, or an injected bit-rot txn — has
    named that object (its generation moved past g and the cache
    lookup misses).  Conservative by construction: a failed
    transaction still bumps, which only costs a re-upload.

    The map is bounded: on overflow the whole table clears and a
    global epoch bumps, which invalidates every outstanding residency
    entry at once (generations are (epoch, counter) pairs).
    """

    MAX_ENTRIES = 1 << 20

    def __init__(self):
        self._lock = threading.Lock()
        self._epoch = 0
        self._gens: dict[tuple, int] = {}
        self._tokens = 0
        self._tls = threading.local()

    def store_token(self, store) -> int:
        """A process-unique id for a store instance (id() can be
        recycled by the allocator after GC; this never is)."""
        tok = getattr(store, "_residency_token", None)
        if tok is None:
            with self._lock:
                tok = getattr(store, "_residency_token", None)
                if tok is None:
                    self._tokens += 1
                    tok = self._tokens
                    store._residency_token = tok
        return tok

    def note_txn(self, store, txn: "Transaction") -> None:
        tok = self.store_token(store)
        # per-THREAD record of the generations this txn assigned: the
        # writer that queued the txn registers its payload against
        # exactly these (txn_gen below), so a concurrent thread's
        # later txn — which assigns a HIGHER generation — can never
        # be absorbed into the registration (the lookup would compare
        # against the newer generation and miss).  Bounded; consumed
        # by txn_gen.
        pend = getattr(self._tls, "pending", None)
        if pend is None or len(pend) > 256:
            pend = {}
            self._tls.pending = pend
        with self._lock:
            for op in txn.ops:
                kind = op[0]
                if kind in ("mkcoll", "rmcoll"):
                    # rmcoll requires an empty collection, so every
                    # object was already bumped by its own removal
                    continue
                # clone mutates the DESTINATION object
                oid = op[3] if kind == "clone" else op[2]
                key = (tok, op[1], oid)
                self._gens[key] = self._gens.get(key, 0) + 1
                pend[key] = (self._epoch, self._gens[key])
            if len(self._gens) > self.MAX_ENTRIES:
                self._gens.clear()
                self._epoch += 1

    def txn_gen(self, store, cid: str, oid: str):
        """The generation THIS THREAD's own transaction assigned to
        (cid, oid), or None if no such txn is recorded — consumed on
        read.  Registering a payload against this (rather than the
        CURRENT generation) closes the commit-to-register window: a
        racing writer's txn lands a higher generation, so the entry
        registered here simply misses."""
        pend = getattr(self._tls, "pending", None)
        if not pend:
            return None
        return pend.pop(
            (self.store_token(store), cid, oid), None
        )

    def gen_of(self, store, cid: str, oid: str) -> tuple[int, int]:
        tok = self.store_token(store)
        with self._lock:
            return (self._epoch, self._gens.get((tok, cid, oid), 0))


# process-global: one invalidation spine, like the one CUDA context the
# resident buffers themselves live in
residency_gens = ResidencyGens()


@dataclass
class _Object:
    data: bytearray = field(default_factory=bytearray)
    xattrs: dict[str, bytes] = field(default_factory=dict)
    # the omap: a sorted key→value namespace separate from xattrs
    # (ObjectStore.h:687 omap_get and siblings; BlueStore keeps it in
    # RocksDB — the index-style workload surface cls_log/rgw build on)
    omap: dict[str, bytes] = field(default_factory=dict)


class Transaction:
    """Ordered op list (Transaction.h's op encoding, as python ops)."""

    def __init__(self):
        self.ops: list[tuple] = []

    def create_collection(self, cid: str):
        self.ops.append(("mkcoll", cid, None))
        return self

    def touch(self, cid: str, oid: str):
        self.ops.append(("touch", cid, oid))
        return self

    def write(self, cid: str, oid: str, offset: int, data: bytes):
        self.ops.append(("write", cid, oid, offset, bytes(data)))
        return self

    def truncate(self, cid: str, oid: str, size: int):
        self.ops.append(("truncate", cid, oid, size))
        return self

    def setattr(self, cid: str, oid: str, name: str, value: bytes):
        self.ops.append(("setattr", cid, oid, name, bytes(value)))
        return self

    def rmattr(self, cid: str, oid: str, name: str):
        self.ops.append(("rmattr", cid, oid, name))
        return self

    def remove(self, cid: str, oid: str):
        self.ops.append(("remove", cid, oid))
        return self

    def omap_setkeys(self, cid: str, oid: str, kv: dict[str, bytes]):
        self.ops.append(
            ("omap_setkeys", cid, oid,
             {k: bytes(v) for k, v in kv.items()})
        )
        return self

    def omap_rmkeys(self, cid: str, oid: str, keys):
        self.ops.append(("omap_rmkeys", cid, oid, list(keys)))
        return self

    def omap_clear(self, cid: str, oid: str):
        self.ops.append(("omap_clear", cid, oid))
        return self

    def clone(self, cid: str, src_oid: str, dst_oid: str):
        """Copy src's data+xattrs+omap over dst (Transaction::clone —
        the make_writeable snap-clone primitive; each replica/shard
        clones its own LOCAL object, so no bytes ride the wire)."""
        self.ops.append(("clone", cid, src_oid, dst_oid))
        return self

    def remove_collection(self, cid: str):
        self.ops.append(("rmcoll", cid, None))
        return self


class ObjectStore:
    """The abstract boundary (ObjectStore.h): transactions in, reads
    out."""

    # advertised capacity for statfs (ObjectStore::statfs role):
    # tests shrink it to exercise full/nearfull handling; concrete
    # stores may override statfs with a cheaper accounting
    total_bytes = 1 << 30

    # device-payload residency (ops/residency.py) registers entries
    # only against stores whose mutations all flow through THIS
    # process's queue_transaction — proxies (RemoteStore) set False:
    # the backing object mutates on the remote daemon's own store,
    # which the proxy's generation counter cannot observe
    residency_local = True
    # whether DEEP SCRUB may digest a resident copy in place of a
    # media read.  Default False: on persistent media (BlockStore) a
    # byte can rot WITHOUT a transaction, and the scrub exists to
    # catch exactly that — it must read the media.  In-memory stores
    # (MemStore) set True: their read() serves the same txn-observed
    # state the generation spine tracks, so the resident copy and the
    # "media" cannot diverge out-of-band.
    residency_scrub_safe = False

    def queue_transaction(self, txn: Transaction) -> None:
        raise NotImplementedError

    def statfs(self) -> dict:
        """{total, used, avail} bytes (store_statfs_t reduced) — the
        source of the OSD's kb_used/kb_avail stat reports and the
        mon's OSD_NEARFULL/OSD_FULL checks.  Default: walk object
        sizes (callers cache; the OSD polls at ~1 Hz).  Concrete
        stores override with their own accounting (MemStore's object
        dicts, BlockStore's allocator) — the walk is the fallback
        for stores with nothing cheaper."""
        used = 0
        try:
            for cid in self.list_collections():
                for oid in self.list_objects(cid):
                    try:
                        used += self.stat(cid, oid)
                    except StoreError:
                        continue
        except StoreError:
            pass
        total = int(self.total_bytes)
        return {
            "total": total,
            "used": used,
            "avail": max(0, total - used),
        }

    def read(self, cid: str, oid: str, offset: int = 0, length: int = -1) -> bytes:
        raise NotImplementedError

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        raise NotImplementedError

    def stat(self, cid: str, oid: str) -> int:
        raise NotImplementedError

    def exists(self, cid: str, oid: str) -> bool:
        raise NotImplementedError

    def list_objects(self, cid: str) -> list[str]:
        raise NotImplementedError

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def coll_exists(self, cid: str) -> bool:
        """Collection existence (ObjectStore::collection_exists).
        Concrete stores override with an O(1) probe; the fallback
        walks the listing."""
        try:
            return cid in self.list_collections()
        except StoreError:
            return False

    def list_attrs(self, cid: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        """Whole omap (ObjectStore::omap_get)."""
        raise NotImplementedError

    def omap_get_vals(
        self,
        cid: str,
        oid: str,
        start_after: str = "",
        max_return: int = -1,
    ) -> dict[str, bytes]:
        """Key-ordered page after ``start_after``
        (ObjectStore::omap_get_values + iterator paging)."""
        raise NotImplementedError


class _TxnState:
    """Shadow state for one transaction: copies only the objects the
    op list names; collections created/removed are tracked as deltas."""

    __slots__ = ("store", "objects", "new_colls", "dead_colls")

    def __init__(self, store: "MemStore"):
        self.store = store
        # (cid, oid) -> _Object copy or None (= removed)
        self.objects: dict[tuple[str, str], _Object | None] = {}
        self.new_colls: set[str] = set()
        self.dead_colls: set[str] = set()

    def coll_exists(self, cid: str) -> bool:
        if cid in self.dead_colls:
            return False
        return cid in self.new_colls or cid in self.store._colls

    def get(self, cid: str, oid: str, create: bool = False):
        if not self.coll_exists(cid):
            raise StoreError(f"no collection {cid} (-ENOENT)")
        key = (cid, oid)
        if key in self.objects:
            obj = self.objects[key]
        else:
            src = self.store._colls.get(cid, {}).get(oid)
            obj = copy.deepcopy(src) if src is not None else None
            self.objects[key] = obj
        if obj is None and create:
            obj = _Object()
            self.objects[key] = obj
        return obj

    def coll_empty(self, cid: str) -> bool:
        live = set(self.store._colls.get(cid, {}))
        for (c, oid), obj in self.objects.items():
            if c != cid:
                continue
            if obj is None:
                live.discard(oid)
            else:
                live.add(oid)
        return not live


class MemStore(ObjectStore):
    """RAM ObjectStore (src/os/memstore/) with per-object
    copy-on-write transaction shadows."""

    # in-memory: read() and the resident copy cannot diverge without
    # a transaction, so scrub may digest residency (see base class)
    residency_scrub_safe = True

    def __init__(self):
        self._lock = lockdep.Mutex("memstore")
        self._colls: dict[str, dict[str, _Object]] = {}

    # -- transactions ------------------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        # residency invalidation BEFORE the apply: a device-resident
        # copy must stop matching the moment this txn names the object
        residency_gens.note_txn(self, txn)
        with self._lock:
            st = _TxnState(self)
            for op in txn.ops:
                self._apply(st, op)
            self._commit(st)

    def _commit(self, st: _TxnState) -> None:
        """Merge a validated shadow into live state (all ops applied
        cleanly).  Shared by the persistent store, which WAL-appends
        between validation and this merge."""
        for cid in st.dead_colls:
            self._colls.pop(cid, None)
        for cid in st.new_colls:
            self._colls.setdefault(cid, {})
        for (cid, oid), obj in st.objects.items():
            if cid in st.dead_colls or cid not in self._colls:
                continue
            if obj is None:
                self._colls[cid].pop(oid, None)
            else:
                self._colls[cid][oid] = obj

    def _apply(self, st: _TxnState, op) -> None:
        kind, cid, oid = op[0], op[1], op[2]
        if kind == "mkcoll":
            if st.coll_exists(cid):
                raise StoreError(f"collection {cid} exists (-EEXIST)")
            st.dead_colls.discard(cid)
            st.new_colls.add(cid)
            return
        if kind == "rmcoll":
            if not st.coll_exists(cid):
                raise StoreError(f"no collection {cid} (-ENOENT)")
            if not st.coll_empty(cid):
                raise StoreError(f"collection {cid} not empty (-ENOTEMPTY)")
            st.new_colls.discard(cid)
            st.dead_colls.add(cid)
            return
        if kind == "touch":
            st.get(cid, oid, create=True)
        elif kind == "write":
            _, _, _, offset, data = op
            obj = st.get(cid, oid, create=True)
            end = offset + len(data)
            if len(obj.data) < end:
                obj.data.extend(b"\0" * (end - len(obj.data)))
            obj.data[offset:end] = data
        elif kind == "truncate":
            _, _, _, size = op
            obj = st.get(cid, oid, create=True)
            if len(obj.data) > size:
                del obj.data[size:]
            else:
                obj.data.extend(b"\0" * (size - len(obj.data)))
        elif kind == "setattr":
            _, _, _, name, value = op
            obj = st.get(cid, oid)
            if obj is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            obj.xattrs[name] = value
        elif kind == "rmattr":
            _, _, _, name = op
            obj = st.get(cid, oid)
            if obj is None or name not in obj.xattrs:
                raise StoreError(f"no attr {name} on {cid}/{oid} (-ENODATA)")
            del obj.xattrs[name]
        elif kind == "remove":
            obj = st.get(cid, oid)
            if obj is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            st.objects[(cid, oid)] = None
        elif kind == "omap_setkeys":
            _, _, _, kv = op
            obj = st.get(cid, oid)
            if obj is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            obj.omap.update(kv)
        elif kind == "omap_rmkeys":
            _, _, _, keys = op
            obj = st.get(cid, oid)
            if obj is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            for k in keys:
                obj.omap.pop(k, None)
        elif kind == "omap_clear":
            obj = st.get(cid, oid)
            if obj is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            obj.omap.clear()
        elif kind == "clone":
            _, _, src_oid, dst_oid = op
            src = st.get(cid, src_oid)
            if src is None:
                raise StoreError(
                    f"no object {cid}/{src_oid} (-ENOENT)"
                )
            dst = _Object(
                data=bytearray(src.data),
                xattrs=dict(src.xattrs),
                omap=dict(src.omap),
            )
            st.objects[(cid, dst_oid)] = dst
        else:
            raise StoreError(f"unknown op {kind}")

    # -- reads -------------------------------------------------------------
    def _get(self, cid: str, oid: str) -> _Object:
        coll = self._colls.get(cid)
        if coll is None:
            raise StoreError(f"no collection {cid} (-ENOENT)")
        obj = coll.get(oid)
        if obj is None:
            raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
        return obj

    def read(self, cid, oid, offset=0, length=-1) -> bytes:
        with self._lock:
            data = self._get(cid, oid).data
            if length < 0:
                return bytes(data[offset:])
            return bytes(data[offset : offset + length])

    def getattr(self, cid, oid, name) -> bytes:
        with self._lock:
            obj = self._get(cid, oid)
            if name not in obj.xattrs:
                raise StoreError(f"no attr {name} (-ENODATA)")
            return obj.xattrs[name]

    def stat(self, cid, oid) -> int:
        with self._lock:
            return len(self._get(cid, oid).data)

    def statfs(self) -> dict:
        # one locked pass over the in-memory dicts — no per-object
        # stat() round-trips like the base-class fallback walk
        with self._lock:
            used = sum(
                len(obj.data)
                for objs in self._colls.values()
                for obj in objs.values()
            )
        total = int(self.total_bytes)
        return {
            "total": total,
            "used": used,
            "avail": max(0, total - used),
        }

    def exists(self, cid, oid) -> bool:
        with self._lock:
            return oid in self._colls.get(cid, {})

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(self._colls)

    def coll_exists(self, cid: str) -> bool:
        with self._lock:
            return cid in self._colls

    def list_attrs(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            obj = self._colls.get(cid, {}).get(oid)
            if obj is None:
                raise StoreError(f"no object {cid}/{oid} (-ENOENT)")
            return dict(obj.xattrs)

    def list_objects(self, cid) -> list[str]:
        with self._lock:
            if cid not in self._colls:
                raise StoreError(f"no collection {cid} (-ENOENT)")
            return sorted(self._colls[cid])

    def omap_get(self, cid, oid) -> dict[str, bytes]:
        with self._lock:
            return dict(self._get(cid, oid).omap)

    def omap_get_vals(
        self, cid, oid, start_after: str = "", max_return: int = -1
    ) -> dict[str, bytes]:
        with self._lock:
            omap = self._get(cid, oid).omap
            out: dict[str, bytes] = {}
            for k in sorted(omap):
                if k <= start_after and start_after:
                    continue
                out[k] = omap[k]
                if 0 <= max_return <= len(out):
                    break
            return out


# -- transaction serialization ---------------------------------------------
# (Transaction.h's op encoding role; lives here rather than the
# messenger so the WAL (kstore) and the wire (msg) share one codec)

_TXN_OPS = {
    "mkcoll": "cs",
    "touch": "css",
    "write": "cssqb",
    "truncate": "cssq",
    "setattr": "csssb",
    "rmattr": "csss",
    "remove": "css",
    "rmcoll": "cs",
    "omap_setkeys": "cssm",
    "omap_rmkeys": "cssL",
    "omap_clear": "css",
    "clone": "csss",
}
# field codes: c=opcode string, s=str, q=int, b=bytes,
# m=str→bytes map, L=str list
# opcodes are EXPLICIT and append-only: they are a durable format
# (the KStore WAL frames transactions with them)
_OPCODES = {
    "mkcoll": 0,
    "remove": 1,
    "rmattr": 2,
    "rmcoll": 3,
    "setattr": 4,
    "touch": 5,
    "truncate": 6,
    "write": 7,
    "omap_setkeys": 8,
    "omap_rmkeys": 9,
    "omap_clear": 10,
    "clone": 11,
}
_OPNAMES = {i: name for name, i in _OPCODES.items()}


def encode_transaction(e: Encoder, txn: Transaction) -> None:
    """Serialize the ordered op list (Transaction.h op encoding role)."""
    e.u32(len(txn.ops))
    for op in txn.ops:
        name = op[0]
        spec = _TXN_OPS[name]
        e.u8(_OPCODES[name])
        for kind, val in zip(spec[1:], op[1:]):
            if kind == "s":
                e.string(val if val is not None else "")
            elif kind == "q":
                e.s64(val)
            elif kind == "b":
                e.bytes(val)
            elif kind == "m":
                e.map(
                    val,
                    lambda e2, k: e2.string(k),
                    lambda e2, v: e2.bytes(v),
                )
            elif kind == "L":
                e.list(val, lambda e2, s: e2.string(s))


def decode_transaction(d: Decoder) -> Transaction:
    txn = Transaction()
    for _ in range(d.u32()):
        name = _OPNAMES[d.u8()]
        spec = _TXN_OPS[name]
        args = []
        for kind in spec[1:]:
            if kind == "s":
                args.append(d.string())
            elif kind == "q":
                args.append(d.s64())
            elif kind == "b":
                args.append(d.bytes())
            elif kind == "m":
                args.append(
                    d.map(lambda d2: d2.string(), lambda d2: d2.bytes())
                )
            elif kind == "L":
                args.append(d.list(lambda d2: d2.string()))
        if name in ("mkcoll", "rmcoll"):
            args = args[:1]  # stored as (op, cid, None)
            txn.ops.append((name, args[0], None))
        else:
            txn.ops.append((name, *args))
    return txn
