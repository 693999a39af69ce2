"""Sharded bucket-index plane — hash-sharded RGW indexes, k-way
merged listings, and ONLINE dynamic resharding (src/cls/rgw/ +
src/rgw/rgw_reshard.cc roles, reduced to the load-bearing
architecture).

Why: a bucket whose index is ONE omap object serializes every index
mutation on a single PG/OSD — the classic real-Ceph hot-spot once a
bucket holds millions of objects.  The reference shards the index
over ``rgw_override_bucket_index_max_shards`` rados objects keyed by
name hash and reshards BUSY buckets online (RGWReshard).  Same
machinery here:

**Shard layout.**  A bucket's metadata record carries an ``index``
descriptor ``{"gen": G, "num_shards": N}``.  Entry ``key`` lives in
shard ``crc32(key) % N`` at oid ``bucket.index.<name>.<G>.<shard>``.
The (gen 0, 1 shard) layout keeps the LEGACY single-object oid
``bucket.index.<name>`` so pre-shard buckets (and their on-disk
indexes) read unchanged.

**Listings.**  Paged ListObjects k-way merge-sorts per-shard omap
pages (each shard iterator keeps its OWN continuation marker and
pulls successive pages lazily), so the merged page is byte-identical
to the unsharded listing: within one generation a key hashes to
exactly one shard, keys are globally unique, and the global
``marker`` / ``max-keys`` contract is preserved verbatim.

**Online reshard** (the RGWReshard state machine):

1. ``in_progress`` is marked in the bucket record (a ``reshard``
   descriptor naming target gen/shards).  From this point every
   index mutation DUAL-WRITES: current gen (authoritative) + target
   gen.
2. Migration copies gen-G entries into the gen-G+1 shard set in
   fixpoint passes — each pass re-diffs both generations and fixes
   any divergence (a copy racing a concurrent write can land a stale
   value or resurrect a deleted key; the next pass repairs it, and
   convergence needs one CLEAN pass).
3. ``cutover``: writers briefly park (retry loop against the bucket
   record) while a final clean pass runs with the write stream
   quiesced, then the record flips atomically to
   ``{"gen": G+1, "num_shards": M}`` and the reshard descriptor is
   dropped.  Old-gen shard objects are removed after the flip.

Lost-entry proof sketch: a writer writes under layout L then
RE-READS the record; if the layout changed it redoes the write under
the new layout.  So an old-gen-only write either (a) completed
before the ``in_progress`` mark — hence before the first copy pass
read its shard — or (b) observes the mark on re-read and redoes as a
dual-write.  Phantom proof: a delete under ``in_progress`` removes
the key from BOTH generations; a copy pass that raced it re-adds the
old value to the target gen, and the next fixpoint pass (old gen no
longer holds the key) removes it again — the clean-pass exit
criterion guarantees the cutover snapshot diverges nowhere.

A crash mid-reshard leaves ``in_progress`` in the record: gen G
stays authoritative, readers and listings are untouched, writers
keep dual-writing (idempotent), and re-running the reshard RESUMES
(the fixpoint passes converge from any partial state).  A crash
mid-``cutover`` is bounded by ``CUTOVER_GRACE``: writers treat a
stale cutover as ``in_progress`` (dual-write, no park) so traffic
flows until an admin restarts the reshard.

**Reshard queue** (RGWReshard's reshard log): every
``check_interval``-th mutation of a bucket counts the shard it just
wrote (a ``max_return``-bounded page read); past
``rgw_max_objs_per_shard`` the bucket is queued in the ``rgw.reshard``
omap log with a computed target shard count, drained by
``process_reshard_queue`` (or the background ``ReshardWorker``).

Migration writes the shard omaps DIRECTLY — never through
``put_object`` — so migrated entries are invisible to the multisite
datalog and replication streams ride a reshard without re-emitting
(the reference short-circuits reshard index ops the same way).

Deviations, documented: crc32 stands in for ceph_str_hash_linux; the
bucket record is the reshard state authority (no cls_rgw guards), so
one gateway process must own a bucket's reshard at a time; no
per-shard bi-log (the zone datalog stays the replication spine).
"""

from __future__ import annotations

import heapq
import json
import threading
import time
import zlib

from ..common.perf_counters import PerfCountersBuilder
from ..osdc.objecter import ObjectNotFound, RadosError

__all__ = [
    "BucketIndex",
    "ReshardWorker",
    "build_rgw_perf",
    "decode_bucket_record",
    "decode_reshard_entry",
    "encode_bucket_record",
    "encode_reshard_entry",
    "shard_of",
    "shard_oid",
]

RESHARD_OID = "rgw.reshard"  # the reshard queue/log object
RESHARD_NONE = ""
RESHARD_IN_PROGRESS = "in_progress"
RESHARD_CUTOVER = "cutover"
# a cutover older than this is a crashed resharder: writers fall back
# to dual-writing instead of parking forever
CUTOVER_GRACE = 5.0
# bounded writer park during a live cutover (well above any observed
# final-pass duration; a writer that exhausts it errors out busy,
# the reference's ERR_BUSY_RESHARDING)
_MUTATE_RETRIES = 400
_STALL_SLEEP = 0.02
_PAGE = 1024  # per-shard omap page size for full walks
_BATCH = 512  # omap_set batch size during migration


def shard_of(key: str, num_shards: int) -> int:
    """Stable name-hash shard choice (the ceph_str_hash seat)."""
    if num_shards <= 1:
        return 0
    return zlib.crc32(key.encode("utf-8")) % num_shards


def shard_oid(bucket: str, gen: int, shard: int, num_shards: int) -> str:
    """Index shard object name.  The (gen 0, 1 shard) layout keeps
    the legacy single-object name so pre-shard buckets read
    unchanged (and the unsharded fast path stays byte-compatible
    with everything ever written)."""
    if gen == 0 and num_shards <= 1:
        return f"bucket.index.{bucket}"
    return f"bucket.index.{bucket}.{gen}.{shard}"


# -- canonical encodings (dencoder-pinned) -----------------------------------
def encode_bucket_record(rec: dict) -> bytes:
    """Canonical bucket-record bytes: key-sorted, separator-minimal
    JSON so decode+re-encode is byte-stable (the dencoder corpus
    pins this shape as ``rgw_bucket_record``)."""
    return json.dumps(
        rec, sort_keys=True, separators=(",", ":")
    ).encode()


def decode_bucket_record(raw: bytes) -> dict:
    rec = json.loads(raw)
    if not isinstance(rec, dict):
        raise ValueError("bucket record is not an object")
    return rec


def encode_reshard_entry(ent: dict) -> bytes:
    """Canonical reshard-log entry bytes (``rgw_reshard_entry``)."""
    return json.dumps(
        ent, sort_keys=True, separators=(",", ":")
    ).encode()


def decode_reshard_entry(raw: bytes) -> dict:
    ent = json.loads(raw)
    if not isinstance(ent, dict):
        raise ValueError("reshard entry is not an object")
    return ent


# -- telemetry ---------------------------------------------------------------
def build_rgw_perf(name: str = "rgw"):
    """The gateway's index/reshard counter families
    (``l_rgw_index_*`` / ``l_rgw_reshard_*``), riding the same
    perf → MMgrReport → prometheus pipe as every other daemon."""
    b = PerfCountersBuilder(name)
    b.add_u64_counter(
        "l_rgw_index_ops", "index entry mutations (set/remove)"
    )
    b.add_u64_counter(
        "l_rgw_index_reads", "index entry/stat shard reads"
    )
    b.add_u64_counter(
        "l_rgw_index_list_pages",
        "per-shard omap pages pulled by merged listings",
    )
    b.add_u64_counter(
        "l_rgw_index_list_entries",
        "entries served by merged listings",
    )
    b.add_u64_counter(
        "l_rgw_index_retries",
        "mutations redone because the index layout moved underneath",
    )
    b.add_u64_counter(
        "l_rgw_index_dual_writes",
        "mutations mirrored to the reshard target generation",
    )
    b.add_u64_counter(
        "l_rgw_index_stall_waits",
        "writer park iterations while a cutover ran",
    )
    b.add_u64_gauge(
        "l_rgw_index_shards",
        "index shard count of the last bucket touched",
    )
    b.add_u64_counter(
        "l_rgw_reshard_queued",
        "buckets queued for reshard by the per-shard fill check",
    )
    b.add_u64_counter(
        "l_rgw_reshard_started", "reshards started (incl. resumes)"
    )
    b.add_u64_counter(
        "l_rgw_reshard_completed", "reshards cut over"
    )
    b.add_u64_counter(
        "l_rgw_reshard_entries_migrated",
        "entries copied/fixed into the target generation",
    )
    b.add_u64_counter(
        "l_rgw_reshard_passes", "migration fixpoint passes run"
    )
    b.add_u64_gauge(
        "l_rgw_reshard_in_progress", "reshards currently running"
    )
    return b.create_perf_counters()


class _Layout:
    """One observation of a bucket's index layout.  ``epoch()``
    captures everything a writer must re-validate after its write:
    a change means the write may have missed a generation and must
    be redone under the new layout."""

    __slots__ = (
        "gen", "num_shards", "status", "target_gen",
        "target_shards", "stamp",
    )

    def __init__(self, rec: dict):
        idx = rec.get("index") or {}
        self.gen = int(idx.get("gen", 0))
        self.num_shards = int(idx.get("num_shards", 1))
        rs = rec.get("reshard") or {}
        self.status = str(rs.get("status", RESHARD_NONE))
        self.target_gen = int(rs.get("target_gen", self.gen + 1))
        self.target_shards = int(rs.get("target_shards", 0))
        self.stamp = float(rs.get("stamp", 0.0))

    def epoch(self) -> tuple:
        return (
            self.gen, self.num_shards, self.status,
            self.target_gen, self.target_shards,
        )

    def resharding(self) -> bool:
        return self.status in (RESHARD_IN_PROGRESS, RESHARD_CUTOVER)

    def parked(self, now: float) -> bool:
        """Writers park only during a FRESH cutover; a stale one
        (crashed resharder) degrades to dual-write so traffic
        flows."""
        return (
            self.status == RESHARD_CUTOVER
            and now - self.stamp < CUTOVER_GRACE
        )


class BucketIndex:
    """The sharded-index layer every RGW index read/write/list rides
    (the cls_rgw + RGWRados::Bucket index seam)."""

    def __init__(self, rgw):
        self.rgw = rgw
        self.io = rgw.io
        # per-bucket mutation counter driving the periodic shard-fill
        # check (in-memory: the check is advisory, the queue is the
        # durable state)
        self._op_counts: dict[str, int] = {}
        self._op_counts_lock = threading.Lock()
        self.check_interval = 16

    # -- layout ------------------------------------------------------------
    def _fresh_layout(self, bucket: str) -> _Layout:
        return _Layout(self.rgw._bucket_rec(bucket))

    def layout(self, bucket: str, rec: dict | None = None) -> _Layout:
        if rec is None:
            return self._fresh_layout(bucket)
        return _Layout(rec)

    def shard_oids(
        self, bucket: str, gen: int, num_shards: int
    ) -> list[str]:
        return [
            shard_oid(bucket, gen, s, num_shards)
            for s in range(max(1, num_shards))
        ]

    def create(self, bucket: str, num_shards: int) -> dict:
        """Index descriptor + shard objects for a new bucket."""
        for oid in self.shard_oids(bucket, 0, num_shards):
            self.io.write_full(oid, b"")
        return {"gen": 0, "num_shards": int(max(1, num_shards))}

    def _touch_missing(self, oid: str) -> None:
        """Create-if-missing WITHOUT wiping omap (write_full on an
        existing object clears its keys — fatal on reshard resume)."""
        try:
            self.io.stat(oid)
        except (ObjectNotFound, RadosError):
            self.io.write_full(oid, b"")

    # -- reads -------------------------------------------------------------
    def _read_shard(self, oid: str, **kw) -> dict[str, bytes]:
        """One shard's omap page; a MISSING shard object reads as
        empty (an empty target-gen shard may never have been
        touched into existence)."""
        try:
            return self.io.omap_get_vals(oid, **kw)
        except (ObjectNotFound, RadosError):
            return {}

    def get_entry(self, bucket: str, key: str, rec: dict | None = None):
        """The entry blob for ``key`` or None — reads ONE shard of
        the current generation (the whole point: stat cost no longer
        scales with bucket size)."""
        lay = self.layout(bucket, rec)
        for _attempt in range(2):
            oid = shard_oid(
                bucket, lay.gen,
                shard_of(key, lay.num_shards), lay.num_shards,
            )
            vals = self._read_shard(oid)
            self.rgw.perf.inc("l_rgw_index_reads")
            if key in vals:
                return vals[key]
            # miss could be a cutover race: the generation this
            # layout names may have been cleaned up — retry once on
            # a FRESH record before declaring absence
            fresh = self._fresh_layout(bucket)
            if fresh.epoch() == lay.epoch():
                return None
            lay = fresh
        return None

    def _shard_pages(self, oid: str, marker: str, page: int):
        """Lazy per-shard iterator with its own continuation marker
        (the per-shard cursor the k-way merge advances)."""
        m = marker
        while True:
            try:
                vals = self.io.omap_get_vals(
                    oid, start_after=m, max_return=page
                )
            except (ObjectNotFound, RadosError):
                return
            keys = sorted(vals)
            if not keys:
                return
            self.rgw.perf.inc("l_rgw_index_list_pages")
            for k in keys:
                yield (k, vals[k])
            if len(keys) < page:
                return
            m = keys[-1]

    def list_page(
        self,
        bucket: str,
        marker: str = "",
        max_keys: int = 1000,
        rec: dict | None = None,
    ) -> tuple[list[tuple[str, bytes]], bool]:
        """Key-ordered page after ``marker`` → ([(key, raw)],
        truncated): k-way merge-sort across the current generation's
        shards.  Within a generation every key lives in exactly one
        shard, so the merged stream is EXACTLY the unsharded omap
        order — the listing contract (and its XML) is byte-identical
        to the single-object index."""
        lay = self.layout(bucket, rec)
        page = min(max(max_keys + 1, 2), _PAGE)
        for _attempt in range(3):
            merged = heapq.merge(
                *(
                    self._shard_pages(oid, marker, page)
                    for oid in self.shard_oids(
                        bucket, lay.gen, lay.num_shards
                    )
                )
            )
            out: list[tuple[str, bytes]] = []
            truncated = False
            for k, raw in merged:
                if len(out) >= max_keys:
                    truncated = True
                    break
                out.append((k, raw))
            # a cutover racing the page walk could have removed the
            # generation mid-merge (missing shards read as empty) —
            # an unchanged layout across the walk proves the page is
            # whole; a moved one re-lists under the new generation
            fresh = self._fresh_layout(bucket)
            if fresh.epoch() == lay.epoch():
                break
            lay = fresh
        self.rgw.perf.inc("l_rgw_index_list_entries", len(out))
        self.rgw.perf.set("l_rgw_index_shards", lay.num_shards)
        return out, truncated

    def entries(self, bucket: str, rec: dict | None = None):
        """Every (key, raw) of the current generation in key order
        (the LC walk / full-sync seat), paged underneath."""
        marker = ""
        while True:
            page, truncated = self.list_page(
                bucket, marker=marker, max_keys=_PAGE - 1, rec=rec
            )
            yield from page
            if not truncated or not page:
                return
            marker = page[-1][0]
            rec = None  # later pages re-read the layout

    def any_entries(self, bucket: str, rec: dict | None = None) -> bool:
        """Emptiness probe across ALL shards of the current
        generation (the delete-bucket gate: one shard being empty
        proves nothing)."""
        lay = self.layout(bucket, rec)
        return any(
            self._read_shard(oid, max_return=1)
            for oid in self.shard_oids(bucket, lay.gen, lay.num_shards)
        )

    def shard_counts(
        self, bucket: str, rec: dict | None = None
    ) -> list[int]:
        """Per-shard entry counts of the current generation (the
        ``bucket stats`` fill view the reshard threshold reasons
        about)."""
        lay = self.layout(bucket, rec)
        return [
            sum(
                1 for _kv in self._shard_pages(oid, "", _PAGE)
            )
            for oid in self.shard_oids(
                bucket, lay.gen, lay.num_shards
            )
        ]

    def count_entries(self, bucket: str, rec: dict | None = None) -> int:
        return sum(self.shard_counts(bucket, rec))

    # -- writes ------------------------------------------------------------
    def set_entry(
        self, bucket: str, key: str, entry, rec: dict | None = None
    ) -> None:
        raw = (
            entry
            if isinstance(entry, (bytes, bytearray))
            else json.dumps(entry).encode()
        )
        self._mutate(bucket, key, bytes(raw), rec)

    def rm_entry(
        self, bucket: str, key: str, rec: dict | None = None
    ) -> None:
        self._mutate(bucket, key, None, rec)

    def _apply(self, bucket: str, key: str, value, lay: _Layout) -> None:
        """One write under one observed layout: current generation
        always; the reshard target generation too while a reshard is
        live (the dual-write keeping the target convergent)."""
        targets = [
            (lay.gen, shard_of(key, lay.num_shards), lay.num_shards)
        ]
        if lay.resharding() and lay.target_shards > 0:
            targets.append(
                (
                    lay.target_gen,
                    shard_of(key, lay.target_shards),
                    lay.target_shards,
                )
            )
            self.rgw.perf.inc("l_rgw_index_dual_writes")
        for gen, shard, n in targets:
            oid = shard_oid(bucket, gen, shard, n)
            if value is None:
                try:
                    self.io.omap_rm_keys(oid, [key])
                except (ObjectNotFound, RadosError):
                    pass  # removing from a shard that never existed
            else:
                self.io.omap_set(oid, {key: value})

    def _mutate(
        self, bucket: str, key: str, value, rec: dict | None
    ) -> None:
        """The write protocol: write under the observed layout, then
        RE-READ the record; a moved layout (reshard started, cut
        over, or target changed) redoes the write so no generation
        that could become authoritative misses it."""
        lay = self.layout(bucket, rec)
        for _attempt in range(_MUTATE_RETRIES):
            if lay.parked(time.time()):
                # a live cutover quiesces writers briefly (the
                # reference's ERR_BUSY_RESHARDING retry loop,
                # server-side)
                self.rgw.perf.inc("l_rgw_index_stall_waits")
                time.sleep(_STALL_SLEEP)
                lay = self._fresh_layout(bucket)
                continue
            self._apply(bucket, key, value, lay)
            self.rgw.perf.inc("l_rgw_index_ops")
            fresh = self._fresh_layout(bucket)
            if fresh.epoch() == lay.epoch():
                if value is not None:
                    self._maybe_check_fill(bucket, key, lay)
                return
            self.rgw.perf.inc("l_rgw_index_retries")
            lay = fresh
        from . import RGWError

        raise RGWError(
            f"bucket {bucket!r} index busy resharding (-EBUSY)"
        )

    def remove_index(self, bucket: str, rec: dict | None = None) -> None:
        """Drop every shard object (both generations while a reshard
        is live) — the delete-bucket teardown."""
        lay = self.layout(bucket, rec)
        oids = set(
            self.shard_oids(bucket, lay.gen, lay.num_shards)
        )
        if lay.resharding() and lay.target_shards > 0:
            oids.update(
                self.shard_oids(
                    bucket, lay.target_gen, lay.target_shards
                )
            )
        for oid in oids:
            try:
                self.io.remove(oid)
            except (ObjectNotFound, RadosError):
                pass
        try:
            self.io.omap_rm_keys(RESHARD_OID, [bucket])
        except (ObjectNotFound, RadosError):
            pass

    # -- reshard queue (RGWReshard's reshard log) --------------------------
    def _maybe_check_fill(
        self, bucket: str, key: str, lay: _Layout
    ) -> None:
        """Every ``check_interval``-th mutation counts the shard it
        just wrote; past ``rgw_max_objs_per_shard`` the bucket joins
        the reshard queue (hash-uniform estimate for the target)."""
        thr = int(self.rgw.max_objs_per_shard)
        if thr <= 0 or lay.resharding():
            return
        with self._op_counts_lock:
            n = self._op_counts.get(bucket, 0) + 1
            self._op_counts[bucket] = n
            if n % self.check_interval:
                return
        oid = shard_oid(
            bucket, lay.gen,
            shard_of(key, lay.num_shards), lay.num_shards,
        )
        count = len(self._read_shard(oid, max_return=thr + 1))
        if count <= thr:
            return
        est_total = count * lay.num_shards
        target = max(lay.num_shards * 2, 2)
        while est_total / target > thr:
            target *= 2
        self.queue_reshard(bucket, target, reason="threshold")

    def queue_reshard(
        self, bucket: str, target_shards: int, reason: str = "admin"
    ) -> bool:
        """Add a bucket to the reshard queue; False if already
        queued (the queue is idempotent — one entry per bucket)."""
        existing = self._read_shard(RESHARD_OID)
        if bucket in existing:
            return False
        self._touch_missing(RESHARD_OID)
        ent = {
            "bucket": bucket,
            "target_shards": int(target_shards),
            "reason": reason,
            "queued_at": time.time(),
        }
        self.io.omap_set(
            RESHARD_OID, {bucket: encode_reshard_entry(ent)}
        )
        self.rgw.perf.inc("l_rgw_reshard_queued")
        return True

    def reshard_queue(self) -> list[dict]:
        return [
            decode_reshard_entry(raw)
            for _b, raw in sorted(self._read_shard(RESHARD_OID).items())
        ]

    def process_reshard_queue(self) -> int:
        """Drain the queue (the RGWReshard worker pass); returns the
        number of buckets resharded."""
        from . import RGWError

        done = 0
        for ent in self.reshard_queue():
            bucket = ent["bucket"]
            try:
                self.reshard(bucket, int(ent["target_shards"]))
                done += 1
            except RGWError:
                pass  # bucket vanished / target stale: drop the entry
            except Exception:
                # transient failure (mon blip, pool hiccup): KEEP the
                # queue entry so the next worker pass resumes the
                # reshard — dropping it would strand the bucket
                # in_progress forever (the resharding guard stops
                # the fill check from ever re-queueing it)
                raise
            try:
                self.io.omap_rm_keys(RESHARD_OID, [bucket])
            except (ObjectNotFound, RadosError):
                pass
        return done

    # -- reshard state machine ---------------------------------------------
    def status(self, bucket: str) -> dict:
        """``reshard status``: layout + live reshard descriptor."""
        rec = self.rgw._bucket_rec(bucket)
        lay = _Layout(rec)
        queued = bucket in self._read_shard(RESHARD_OID)
        return {
            "bucket": bucket,
            "gen": lay.gen,
            "num_shards": lay.num_shards,
            "status": lay.status or "idle",
            "target_gen": lay.target_gen if lay.resharding() else None,
            "target_shards": (
                lay.target_shards if lay.resharding() else None
            ),
            "queued": queued,
        }

    def _report_progress(
        self, bucket: str, target_shards: int, fraction: float,
        done: bool = False,
    ) -> None:
        """Feed the mgr progress-event plane: in-process gateways
        set ``rgw.progress_hook`` (callable (event_id, message,
        fraction, done)) — tests bridge it straight to the progress
        module; out-of-process gateways use the mgr's
        ``progress event`` command instead.  Best-effort: a broken
        hook must never fail a reshard."""
        hook = getattr(self.rgw, "progress_hook", None)
        if hook is None:
            return
        try:
            hook(
                f"reshard:{bucket}",
                f"Resharding bucket {bucket!r} to "
                f"{target_shards} shards",
                fraction,
                done,
            )
        except Exception:  # noqa: BLE001 — observability side-channel
            pass

    def _save_reshard_state(
        self, bucket: str, status: str, target_gen: int,
        target_shards: int,
    ) -> _Layout:
        with self.rgw._bucket_lock(bucket):
            rec = self.rgw._bucket_rec(bucket)
            rec["reshard"] = {
                "status": status,
                "target_gen": target_gen,
                "target_shards": target_shards,
                "stamp": time.time(),
            }
            self.rgw._save_bucket_rec(bucket, rec)
            return _Layout(rec)

    def _still_mine(self, bucket: str, lay: _Layout) -> None:
        """Abort a resharder whose layout moved underneath it: the
        record is the reshard-state authority, and a second
        resharder (admin CLI racing the background worker) that kept
        migrating against a flipped generation would read the old
        gen as empty and DELETE every migrated entry."""
        from . import RGWError

        fresh = self._fresh_layout(bucket)
        if (
            fresh.gen != lay.gen
            or fresh.num_shards != lay.num_shards
            or fresh.target_gen != lay.target_gen
            or fresh.target_shards != lay.target_shards
        ):
            raise RGWError(
                f"bucket {bucket!r} reshard superseded: layout "
                f"moved to gen {fresh.gen} x{fresh.num_shards}"
            )

    def _migrate_pass(self, bucket: str, lay: _Layout) -> int:
        """One fixpoint pass: diff the full old and new generations
        and fix every divergence.  Returns the number of fixes (0 =
        clean pass).  Writes go straight to the shard omaps — no
        datalog, no put_object: migration must be invisible to
        multisite replication."""
        old: dict[str, bytes] = {}
        for oid in self.shard_oids(bucket, lay.gen, lay.num_shards):
            for k, raw in self._shard_pages(oid, "", _PAGE):
                old[k] = raw
        new: dict[str, bytes] = {}
        for oid in self.shard_oids(
            bucket, lay.target_gen, lay.target_shards
        ):
            for k, raw in self._shard_pages(oid, "", _PAGE):
                new[k] = raw
        sets: dict[int, dict[str, bytes]] = {}
        for k, raw in old.items():
            if new.get(k) != raw:
                sets.setdefault(
                    shard_of(k, lay.target_shards), {}
                )[k] = raw
        rms: dict[int, list[str]] = {}
        for k in new.keys() - old.keys():
            rms.setdefault(
                shard_of(k, lay.target_shards), []
            ).append(k)
        diffs = 0
        for shard, kv in sets.items():
            oid = shard_oid(
                bucket, lay.target_gen, shard, lay.target_shards
            )
            items = list(kv.items())
            for i in range(0, len(items), _BATCH):
                self.io.omap_set(oid, dict(items[i : i + _BATCH]))
            diffs += len(items)
        for shard, keys in rms.items():
            oid = shard_oid(
                bucket, lay.target_gen, shard, lay.target_shards
            )
            self.io.omap_rm_keys(oid, keys)
            diffs += len(keys)
        self.rgw.perf.inc("l_rgw_reshard_passes")
        if diffs:
            self.rgw.perf.inc(
                "l_rgw_reshard_entries_migrated", diffs
            )
        return diffs

    def reshard(
        self,
        bucket: str,
        target_shards: int,
        max_passes: int = 8,
        fault_hook=None,
    ) -> dict:
        """Online reshard to ``target_shards`` (``bucket reshard``):
        mark → fixpoint migrate under live dual-writing traffic →
        brief cutover park → atomic flip → old-gen cleanup.  Resumes
        idempotently after a crash.  ``fault_hook(stage)`` is the
        crash-injection seam tests use (stages: ``marked``,
        ``migrated``, ``cutover``)."""
        from . import RGWError  # cycle-free at call time

        rec = self.rgw._bucket_rec(bucket)
        lay = _Layout(rec)
        target_shards = int(target_shards)
        if target_shards < 1:
            raise RGWError("target shard count must be >= 1")
        if lay.resharding():
            # resume: the recorded target wins (a different request
            # against a half-done reshard would orphan its entries)
            target_shards = lay.target_shards
        elif target_shards == lay.num_shards:
            raise RGWError(
                f"bucket {bucket!r} already has "
                f"{target_shards} shard(s)"
            )
        t0 = time.monotonic()
        self.rgw.perf.inc("l_rgw_reshard_started")
        self.rgw.perf.inc("l_rgw_reshard_in_progress")
        self._report_progress(bucket, target_shards, 0.0)
        try:
            lay = self._save_reshard_state(
                bucket, RESHARD_IN_PROGRESS, lay.gen + 1,
                target_shards,
            )
            for oid in self.shard_oids(
                bucket, lay.target_gen, lay.target_shards
            ):
                self._touch_missing(oid)
            if fault_hook:
                fault_hook("marked")
            entries = 0
            passes = 0
            while True:
                self._still_mine(bucket, lay)
                diffs = self._migrate_pass(bucket, lay)
                passes += 1
                entries = max(entries, diffs)
                # convergent bar: each fixpoint pass halves what can
                # remain, capped below the cutover's share
                self._report_progress(
                    bucket, target_shards,
                    min(1.0 - 0.5 ** passes, 0.9),
                )
                # exit on a CLEAN pass (at least one pass ran);
                # sustained write traffic is bounded by max_passes —
                # the cutover park quiesces the stragglers
                if diffs == 0 and passes > 1:
                    break
                if passes >= max_passes:
                    break
            if fault_hook:
                fault_hook("migrated")
            # cutover: park writers, run clean passes with the write
            # stream quiesced (a straggler that wrote pre-park is
            # caught here; one that wrote during the park redoes its
            # write against the NEW layout after the flip)
            lay = self._save_reshard_state(
                bucket, RESHARD_CUTOVER, lay.target_gen,
                lay.target_shards,
            )
            # bounded: once the cutover outlives CUTOVER_GRACE,
            # writers resume dual-writing and a pass can observe a
            # transient mid-dual-write divergence every time — but
            # each pass REPAIRS what it saw, and every protocol
            # writer either dual-wrote or redoes post-flip, so
            # flipping after a bounded number of clean-seeking
            # passes stays lossless
            for _pass in range(50):
                self._still_mine(bucket, lay)
                if not self._migrate_pass(bucket, lay):
                    break
            if fault_hook:
                fault_hook("cutover")
            old_oids = self.shard_oids(
                bucket, lay.gen, lay.num_shards
            )
            with self.rgw._bucket_lock(bucket):
                self._still_mine(bucket, lay)
                rec = self.rgw._bucket_rec(bucket)
                rec["index"] = {
                    "gen": lay.target_gen,
                    "num_shards": lay.target_shards,
                }
                rec.pop("reshard", None)
                self.rgw._save_bucket_rec(bucket, rec)
            for oid in old_oids:
                try:
                    self.io.remove(oid)
                except (ObjectNotFound, RadosError):
                    pass
            self.rgw.perf.inc("l_rgw_reshard_completed")
            self._report_progress(
                bucket, target_shards, 1.0, done=True
            )
            with self._op_counts_lock:
                self._op_counts.pop(bucket, None)
            return {
                "bucket": bucket,
                "from_shards": lay.num_shards,
                "to_shards": lay.target_shards,
                "gen": lay.target_gen,
                "entries": entries,
                "passes": passes,
                "duration_s": round(time.monotonic() - t0, 3),
            }
        finally:
            self.rgw.perf.dec("l_rgw_reshard_in_progress")


class ReshardWorker:
    """Background queue drainer (RGWReshard::process_all_logshards):
    every ``interval`` seconds, reshard whatever the fill checks
    queued."""

    def __init__(self, rgw, interval: float = 2.0):
        self.rgw = rgw
        self.interval = interval
        self.passes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="rgw.reshard", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.rgw.index.process_reshard_queue()
            except Exception:  # noqa: BLE001 — the worker survives
                pass
            self.passes += 1

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
