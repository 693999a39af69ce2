"""ReplicatedStore — primary-subordinate replication
(src/osd/ReplicatedBackend.cc).

One ObjectStore per replica plays the acting set.  Writes build ONE
transaction and apply it to every replica (the reference's
issue_repop → MOSDRepOp fan-out → sub_op_modify on each subordinate,
ReplicatedBackend.cc:459-546 / :975-1060); an op completes when every
replica committed, so readers ordered behind it observe all copies
identical.  Object metadata (size + whole-object crc32c data digest,
the object_info_t data_digest role) rides the same transaction as an
xattr.  Partial overwrites invalidate the digest exactly like EC
overwrites invalidate hinfo; scrub then falls back to majority
byte-comparison.

Reads serve from the primary and, on a missing/corrupt copy, fall
back to the next replica after noting the primary needs repair — the
read-path analog of the reference marking an EIO object for recovery.
``scrub`` compares every replica against the authoritative copy
(digest-verified, else majority content); ``recover_replica`` pushes
the authoritative copy onto a lost/corrupt replica (the push side of
ReplicatedBackend recovery, :2208 prep_push).

Any ObjectStore works as a replica.  ``scrub_batch`` digests every
copy of many objects in one device call on the store's ``device``
(default ``cuda``), serving copies the residency cache holds without a
second upload.
"""

from __future__ import annotations

import json
import threading
from collections import Counter

import torch

from ..common import tracing
from ..native import ceph_crc32c
from .objectstore import MemStore, ObjectStore, StoreError, Transaction
from .pg_util import ObjectOpQueue, ScrubResult

INFO_KEY = "rinfo_key"  # object_info_t analog (size + data digest)


class ReplicatedStore:
    def __init__(
        self, stores: list[ObjectStore] | None = None, size: int = 3,
        device="cuda",
    ):
        """``device`` is where the residency registrations and the
        scrub's crc run."""
        self.device = torch.device(device)
        self.stores = stores or [MemStore() for _ in range(size)]
        self.size = len(self.stores)
        assert self.size >= 1
        self.cid = "rep_pool"
        for store in self.stores:
            try:
                store.queue_transaction(
                    Transaction().create_collection(self.cid)
                )
            except StoreError:
                pass
        # per-object FIFO op ordering (the PG op queue collapsed)
        self._opq = ObjectOpQueue()
        # replicas flagged by read fallbacks, pending repair (the
        # read-path analog of marking an EIO object for recovery)
        self._repair_lock = threading.Lock()
        self.pending_repair: dict[str, set[int]] = {}

    # -- ordering ----------------------------------------------------------
    def _enter(self, name: str) -> int:
        return self._opq.enter(name)

    def _exit(self, name: str, ticket: int) -> None:
        self._opq.exit(name, ticket)

    def _flag_repair(self, name: str, replica: int) -> None:
        with self._repair_lock:
            self.pending_repair.setdefault(name, set()).add(replica)

    def _clear_repair(self, name: str, replica: int) -> None:
        with self._repair_lock:
            flagged = self.pending_repair.get(name)
            if flagged is not None:
                flagged.discard(replica)
                if not flagged:
                    del self.pending_repair[name]

    # -- write path --------------------------------------------------------
    def put(self, name: str, data: bytes) -> None:
        """Full-object write: one transaction per replica carrying the
        bytes and the refreshed object info (size + data digest)."""
        data = bytes(data)
        meta = {
            "size": len(data),
            "digest": ceph_crc32c(0xFFFFFFFF, data),
        }
        ticket = self._enter(name)
        try:
            # per-stage child span under the ambient daemon op (the
            # sub_op_applied stages of the replicated write)
            with tracing.span(
                "rep_put", tags={"oid": name, "size": len(data)}
            ) as sp:
                for i, store in enumerate(self.stores):
                    txn = Transaction()
                    if store.exists(self.cid, name):
                        txn.remove(self.cid, name)
                    txn.touch(self.cid, name)
                    if data:
                        txn.write(self.cid, name, 0, data)
                    txn.setattr(
                        self.cid, name, INFO_KEY,
                        json.dumps(meta).encode(),
                    )
                    store.queue_transaction(txn)
                    # register AFTER the txn (it bumped the object's
                    # generation; the entry records the post-txn gen)
                    from ..ops.residency import residency_cache

                    residency_cache().put_committed(
                        store, self.cid, name, data=data,
                        device=self.device,
                    )
                    sp.mark_event(f"replica_{i}_applied")
        finally:
            self._exit(name, ticket)

    def write(self, name: str, offset: int, data: bytes) -> None:
        """Partial overwrite: the same range write applied on every
        replica; the whole-object digest is invalidated (the reference
        clears data_digest on partial writes too)."""
        data = bytes(data)
        if not data:
            return
        ticket = self._enter(name)
        try:
            old = self._meta(name, default=True)
            if old["size"] or old["digest"] is not None:
                # overwriting a degraded object would auto-create
                # short zero-filled replicas that could outvote the
                # good copy in a later majority scrub — repair missing
                # or truncated replicas first (the
                # wait_for_degraded_object barrier)
                self._recover_degraded(name, old)
            meta = {
                "size": max(old["size"], offset + len(data)),
                "digest": None,
            }
            for store in self.stores:
                txn = Transaction()
                txn.write(self.cid, name, offset, data)
                txn.setattr(self.cid, name, INFO_KEY, json.dumps(meta).encode())
                store.queue_transaction(txn)
        finally:
            self._exit(name, ticket)

    def _recover_degraded(self, name: str, meta: dict) -> None:
        for i, store in enumerate(self.stores):
            try:
                if store.stat(self.cid, name) == meta["size"]:
                    continue
            except StoreError:
                pass
            self._recover_locked(name, i, meta)

    # -- read path ---------------------------------------------------------
    def _meta(self, name: str, default: bool = False) -> dict:
        for store in self.stores:
            try:
                return json.loads(store.getattr(self.cid, name, INFO_KEY))
            except StoreError:
                continue
        if default:
            return {"size": 0, "digest": None}
        raise StoreError(f"object {name} not found (-ENOENT)")

    def _read_verified(self, name: str, meta: dict, replica: int):
        try:
            raw = self.stores[replica].read(self.cid, name)
        except StoreError:
            return None
        if len(raw) != meta["size"]:
            return None
        digest = meta.get("digest")
        if digest is not None and ceph_crc32c(0xFFFFFFFF, raw) != digest:
            return None
        return raw

    def get(self, name: str) -> bytes:
        """Primary read with replica fallback on a bad copy.

        Like the reference, a read can only verify what the object
        info carries: after a partial overwrite invalidated the data
        digest, a flipped bit on the primary is invisible to reads
        (only size is checked) until scrub's majority comparison
        attributes it and recovery repairs it."""
        ticket = self._enter(name)
        try:
            with tracing.span("rep_get", tags={"oid": name}) as sp:
                meta = self._meta(name)
                for replica in range(self.size):
                    raw = self._read_verified(name, meta, replica)
                    if raw is not None:
                        return raw
                    sp.mark_event(f"replica_{replica}_fallback")
                    self._flag_repair(name, replica)
                raise StoreError(
                    f"object {name}: no verifiable replica (-EIO)"
                )
        finally:
            self._exit(name, ticket)

    # -- scrub / recovery --------------------------------------------------
    def scrub(self, name: str) -> ScrubResult:
        """Compare every replica against the authoritative copy:
        digest-verified when the digest is live, majority content
        otherwise (the reference's be_select_auth_object)."""
        ticket = self._enter(name)
        try:
            return self._scrub_locked(name)
        finally:
            self._exit(name, ticket)

    def scrub_batch(self, names) -> dict[str, ScrubResult]:
        """Device-batched deep scrub: every replica copy of every
        object checksums in ONE batched crc32c call on the store's
        device (ops/scrub_kernels.batch_crc32c); digest-less objects keep
        the per-object majority-content compare.  Findings are
        identical to scrub() by construction."""
        from ..ops.residency import (
            residency_cache,
            scrub_trusted as _scrub_trusted,
        )
        from ..ops.scrub_kernels import batch_crc32c

        results: dict[str, ScrubResult] = {}
        bufs: list[bytes] = []
        where: list[tuple[str, int, int]] = []
        tickets = {n: self._enter(n) for n in dict.fromkeys(names)}
        try:
            for name in tickets:
                result = results[name] = ScrubResult()
                try:
                    meta = self._meta(name)
                except StoreError:
                    continue
                digest = meta.get("digest")
                raws: dict[int, bytes] = {}
                for i, store in enumerate(self.stores):
                    if digest is not None and _scrub_trusted(store):
                        # generation-checked residency: a hit is the
                        # payload the last committed txn landed —
                        # digest it where it already lives (no second
                        # host→device transfer); any txn since
                        # registration (including injected bit rot)
                        # misses and falls through to the disk read;
                        # persistent media is never served from cache
                        buf = residency_cache().get(
                            store, self.cid, name,
                            expect_len=meta["size"],
                        )
                        if buf is not None:
                            bufs.append(buf)
                            where.append((name, i, digest))
                            continue
                    try:
                        raws[i] = store.read(self.cid, name)
                    except StoreError:
                        result.missing.append(i)
                        continue
                    if digest is not None:
                        if len(raws[i]) != meta["size"]:
                            result.corrupt.append(i)
                        else:
                            bufs.append(raws[i])
                            where.append((name, i, digest))
                if digest is None and raws:
                    counts = Counter(raws.values())
                    auth, n = counts.most_common(1)[0]
                    if n <= len(raws) - n:
                        result.inconsistent = True
                    else:
                        result.corrupt.extend(
                            i
                            for i, raw in sorted(raws.items())
                            if raw != auth
                        )
            if bufs:
                crcs = batch_crc32c(bufs, 0xFFFFFFFF, device=self.device)
                for (name, i, digest), crc in zip(where, crcs):
                    if int(crc) != digest:
                        results[name].corrupt.append(i)
            for result in results.values():
                result.corrupt.sort()
        finally:
            for name, ticket in tickets.items():
                self._exit(name, ticket)
        return results

    def _scrub_locked(self, name: str) -> ScrubResult:
        meta = self._meta(name)
        result = ScrubResult()
        raws: dict[int, bytes] = {}
        for i, store in enumerate(self.stores):
            try:
                raws[i] = store.read(self.cid, name)
            except StoreError:
                result.missing.append(i)
        digest = meta.get("digest")
        if digest is not None:
            for i, raw in raws.items():
                if (
                    len(raw) != meta["size"]
                    or ceph_crc32c(0xFFFFFFFF, raw) != digest
                ):
                    result.corrupt.append(i)
        elif raws:
            # digest invalidated: majority content is authoritative
            counts = Counter(raws.values())
            auth, n = counts.most_common(1)[0]
            if n <= len(raws) - n:
                result.inconsistent = True  # no majority
            else:
                result.corrupt.extend(
                    i for i, raw in sorted(raws.items()) if raw != auth
                )
        return result

    def _authoritative(self, name: str, meta: dict) -> bytes:
        if meta.get("digest") is not None:
            for replica in range(self.size):
                raw = self._read_verified(name, meta, replica)
                if raw is not None:
                    return raw
        else:
            # dead digest: a size check cannot attribute corruption —
            # only the majority can (be_select_auth_object)
            raws = {}
            for i, store in enumerate(self.stores):
                try:
                    raws[i] = store.read(self.cid, name)
                except StoreError:
                    continue
            if raws:
                counts = Counter(raws.values())
                auth, n = counts.most_common(1)[0]
                if n > len(raws) - n:
                    return auth
        raise StoreError(
            f"object {name}: no authoritative copy (-EIO)"
        )

    def recover_replica(self, name: str, replica: int) -> int:
        """Push the authoritative copy onto one replica
        (ReplicatedBackend recovery push).  Returns bytes pushed."""
        ticket = self._enter(name)
        try:
            return self._recover_locked(name, replica, self._meta(name))
        finally:
            self._exit(name, ticket)

    def _recover_locked(self, name: str, replica: int, meta: dict) -> int:
        raw = self._authoritative(name, meta)
        txn = Transaction()
        if self.stores[replica].exists(self.cid, name):
            txn.remove(self.cid, name)
        txn.touch(self.cid, name)
        if raw:
            txn.write(self.cid, name, 0, raw)
        txn.setattr(
            self.cid, name, INFO_KEY, json.dumps(meta).encode()
        )
        self.stores[replica].queue_transaction(txn)
        self._clear_repair(name, replica)
        return len(raw)

    # -- fault injection ---------------------------------------------------
    def lose_replica(self, name: str, replica: int) -> None:
        if self.stores[replica].exists(self.cid, name):
            self.stores[replica].queue_transaction(
                Transaction().remove(self.cid, name)
            )

    def corrupt_replica(self, name: str, replica: int, offset: int = 0) -> None:
        raw = bytearray(self.stores[replica].read(self.cid, name))
        raw[offset] ^= 0xFF
        self.stores[replica].queue_transaction(
            Transaction().write(self.cid, name, 0, bytes(raw))
        )
