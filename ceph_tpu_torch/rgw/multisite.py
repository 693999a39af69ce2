"""RGW multisite — cross-zone asynchronous bucket/object sync
(src/rgw/rgw_sync.cc + rgw_data_sync.cc, reduced to the working
core: a per-zone DATALOG of change events and a sync agent that
tails it into another zone).

Every mutating gateway op appends a datalog entry (the reference's
datalog/mdlog shards collapsed to one ordered omap log).  A
``SyncAgent`` replicates zone A → zone B:

- **full sync** (bootstrap): with no marker recorded, every bucket
  and object copies over (data, ACLs, lifecycle configs), then the
  marker jumps to the datalog head.
- **incremental sync**: the agent tails entries after its marker —
  put/delete/acl events re-fetch the current source state and apply
  it to the destination — and persists the marker AT the
  destination zone (where the reference keeps sync status too), so
  a restarted agent resumes.

Run two agents in opposite directions for active-active (last
writer wins per object, as in the reference's merge semantics for
concurrent writes to different sites).

Deviations: one ordered log (no sharding), no metadata-vs-data log
split, no incremental-vs-full per-bucket state machine — the full
pass is idempotent re-copy."""

from __future__ import annotations

import threading
import time

from ..osdc.objecter import ObjectNotFound, RadosError
from . import SYNC_USER, SYSTEM, RGWError

MARKER_OID = "rgw.sync.markers"


class SyncAgent:
    def __init__(self, src, dst, zone: str = "secondary",
                 interval: float = 0.5):
        self.src = src  # source RGW
        self.dst = dst  # destination RGW
        self.zone = zone
        self.interval = interval
        self.full_syncs = 0
        self.entries_applied = 0
        # last swallowed sync_once failure (cleared by the next clean
        # pass) — the agent survives transient errors, but a stuck
        # bootstrap must be diagnosable from outside the thread
        self.last_error: str | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name=f"rgw-sync.{zone}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sync_once()
                self.last_error = None
            except Exception as e:  # noqa: BLE001 — the agent survives
                self.last_error = f"{type(e).__name__}: {e}"

    # -- marker (sync status lives at the DESTINATION) ---------------------
    def _get_marker(self) -> int | None:
        try:
            vals = self.dst.io.omap_get_vals(MARKER_OID)
        except (ObjectNotFound, RadosError):
            return None
        raw = vals.get(f"marker.{self.zone}")
        return int(raw) if raw is not None else None

    def _set_marker(self, seq: int) -> None:
        try:
            self.dst.io.stat(MARKER_OID)
        except (ObjectNotFound, RadosError):
            self.dst.io.write_full(MARKER_OID, b"")
        self.dst.io.omap_set(
            MARKER_OID, {f"marker.{self.zone}": str(seq).encode()}
        )

    # -- passes ------------------------------------------------------------
    def sync_once(self) -> int:
        marker = self._get_marker()
        if marker is None:
            head = self.src.datalog_head()
            self._full_sync()
            self._set_marker(head)
            self.full_syncs += 1
            return 0
        applied = 0
        for seq, ent in self.src.datalog_entries(after=marker):
            self._apply(ent)
            self._set_marker(seq)
            applied += 1
            self.entries_applied += 1
        return applied

    def _full_sync(self) -> None:
        for bucket in self.src._buckets():
            self._ensure_bucket(bucket)
            marker = ""
            while True:
                entries, truncated = self.src.list_objects(
                    bucket, marker=marker, max_keys=256, user=SYSTEM
                )
                for e in entries:
                    self._copy_object(bucket, e["key"])
                    marker = e["key"]
                if not truncated:
                    break

    def _ensure_bucket(self, bucket: str) -> None:
        rec = dict(self.src._bucket_rec(bucket))
        try:
            self.dst._bucket_rec(bucket)
        except RGWError:
            self.dst.create_bucket(bucket, user=SYNC_USER)
        # owner/acl + lifecycle follow the source (metadata sync).
        # NOT the index layout: each zone shards and reshards its
        # indexes independently (adopting the source's descriptor
        # would point the replica at shard objects it never wrote —
        # every previously synced entry would vanish from listings).
        # The read-modify-write runs under the destination's bucket
        # lock with the destination record re-read inside it, and
        # keeps the destination's OWN index + live reshard
        # descriptor verbatim: an unlocked save racing the reshard
        # state machine could erase a cutover mark (losing a
        # concurrent write's redo signal) or revert a freshly
        # flipped generation
        with self.dst._bucket_lock(bucket):
            drec = self.dst._bucket_rec(bucket)
            rec["index"] = drec.get("index") or {
                "gen": 0, "num_shards": 1,
            }
            rec.pop("reshard", None)
            if "reshard" in drec:
                rec["reshard"] = drec["reshard"]
            self.dst._save_bucket_rec(bucket, rec)
        rules = self.src.get_bucket_lifecycle(bucket, user=SYSTEM)
        if rules:
            self.dst.put_bucket_lifecycle(bucket, rules, user=SYNC_USER)
        else:
            # a rule deleted at the source must die at the replica
            # too, or its LC keeps expiring objects cluster-wide
            self.dst.delete_bucket_lifecycle(bucket, user=SYNC_USER)

    def _copy_object(self, bucket: str, key: str) -> None:
        try:
            data = self.src.get_object(bucket, key, user=SYSTEM)
            entry = self.src.stat_object(bucket, key)
        except (ObjectNotFound, RGWError):
            return  # raced a delete; the datalog entry will follow
        self.dst.put_object(bucket, key, data, user=SYNC_USER)
        # carry the index metadata the put reset (owner/acl).  NOT
        # storage_class: the copy lands the UNCOMPRESSED head bytes,
        # so stamping the source's COLD class would make the replica
        # claim a transition that never happened (reads would try the
        # compressed-payload path against plain bytes, and the
        # destination LC would skip the object forever); leaving the
        # class STANDARD lets the destination's own lifecycle
        # re-transition it for real
        dentry = self.dst.stat_object(bucket, key)
        for k in ("owner", "acl"):
            if k in entry:
                dentry[k] = entry[k]
        # through the index layer (the destination bucket may be
        # sharded — or mid-reshard — independently of the source)
        self.dst.index.set_entry(bucket, key, dentry)

    def _apply(self, ent: dict) -> None:
        op, bucket, key = ent["op"], ent["bucket"], ent.get("key")
        try:
            if op == "create_bucket":
                self._ensure_bucket(bucket)
            elif op == "delete_bucket":
                try:
                    self.dst.delete_bucket(bucket, user=SYNC_USER)
                except RGWError:
                    pass
            elif op in ("put", "acl", "transition"):
                self._ensure_bucket(bucket)
                self._copy_object(bucket, key)
            elif op == "delete":
                try:
                    self.dst.delete_object(bucket, key, user=SYNC_USER)
                except (ObjectNotFound, RGWError):
                    pass
            elif op in ("lifecycle", "bucket_acl"):
                self._ensure_bucket(bucket)
        except RGWError:
            pass  # destination-side hiccup; the next full pass heals
