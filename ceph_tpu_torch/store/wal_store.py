"""WALStore — a write-ahead-log front for any concrete ObjectStore
(the BlueStore deferred-write/group-commit role, src/os/bluestore:
_deferred_queue, deferred_batch_ops, _kv_sync_thread).

The reference wins small-write latency by decoupling durability from
apply: a transaction is durable (and acked) the moment its record is
in the WAL; the data/omap apply lands later, and adjacent commits
share one fsync-equivalent barrier.  This store renders that design
over the framework's ObjectStore boundary:

- **commit = WAL append**: every transaction is validated, encoded,
  and framed into ``wal.log`` (``wal_record``: seq + crc32c over the
  transaction payload, inside the framed_log length+crc envelope).
  Small transactions (total write payload below
  ``wal_prefer_deferred_size``) ack as soon as their record's group
  barrier syncs; large ones also wait for the in-order apply (the
  BlueStore non-deferred txc still writes a WAL intent first).
- **group commit**: a dedicated WAL-writer thread drains the commit
  queue in batches of up to ``wal_max_group_txc`` records; when more
  writers are in flight than the batch has captured it holds the
  barrier open up to ``wal_flush_interval_ms`` for the stragglers, so
  N callers pay one fsync.  A solo writer never waits.
- **deferred read-through**: a read of an object whose records the
  drain has not applied yet is served by materializing the pending
  ops over the inner state (the BlueStore deferred-read contract:
  read-after-ack must observe the ack'd bytes).
- **exact replay point**: the drain appends a seq-stamp op (a setattr
  on a hidden ``_wal_meta_`` collection) to every transaction it
  applies to the inner store, so the inner state ATOMICALLY records
  the last applied seq.  Replay applies exactly the records after the
  stamp — naive re-apply from a checkpoint is NOT idempotent (a
  ``clone`` re-applied after its source moved clones the wrong
  bytes); the stamp makes replay exact, not just convergent.
- **residency binds the commit point**: ``residency_gens.note_txn``
  runs at WAL commit (before ack), not at the deferred apply — the
  generation a writer registers a device-resident payload under is
  the one its COMMIT assigned, and the drain's later inner-store
  apply bumps only the inner store's own token, so the registration
  stays valid across the deferred window.

Crash model: SIGKILL.  Completed file writes survive the process (the
page cache outlives it); replay tolerates a torn tail (framed_log)
and batch-verifies every record's payload crc on the device
(``ops/scrub_kernels.batch_crc32c`` on ``device``, default ``cuda``)
before re-applying.  A device failure raises out of the mount: the
replay never answers from the host crc.
"""

from __future__ import annotations

import logging
import os
import pathlib
import threading
import time

from ..common.encoding import Decoder, DecodeError, Encoder
from ..common.perf_counters import PerfCounters, PerfCountersBuilder
from ..native import ceph_crc32c
from .framed_log import (
    append_frame,
    replay_frames,
    truncate_tail,
    write_checkpoint,
)
from .objectstore import (
    MemStore,
    ObjectStore,
    StoreError,
    Transaction,
    _TxnState,
    decode_transaction,
    encode_transaction,
    residency_gens,
)

log = logging.getLogger(__name__)

_WAL = "wal.log"
_CKPT = "wal.ckpt"
_CKPT_MAGIC = 0x57414C31  # "WAL1"

# the hidden collection carrying the applied-seq stamp; filtered from
# list_collections so no OSD walk (PG load, scrub, statfs callers)
# ever sees it as user state
META_COLL = "_wal_meta_"
META_OID = "applied"
META_ATTR = "seq"


# -- wal_record / wal_checkpoint codecs (dencoder-pinned) -------------------
# The on-log record format is durable: a log written by one build must
# replay under every later one, so the layout is pinned in the
# dencoder corpus like the transaction encoding it wraps.

class WALRecord:
    __slots__ = ("seq", "crc", "payload")

    def __init__(self, seq: int, crc: int, payload: bytes):
        self.seq = seq
        self.crc = crc
        self.payload = payload


def make_wal_record(seq: int, payload: bytes) -> WALRecord:
    return WALRecord(seq, ceph_crc32c(0, payload), payload)


def encode_wal_record(e: Encoder, rec: WALRecord) -> None:
    e.u64(rec.seq)
    e.u32(rec.crc)
    e.bytes(rec.payload)


def decode_wal_record(d: Decoder) -> WALRecord:
    seq = d.u64()
    crc = d.u32()
    payload = d.bytes()
    return WALRecord(seq, crc, payload)


class WALCheckpoint:
    __slots__ = ("base_seq",)

    def __init__(self, base_seq: int):
        self.base_seq = base_seq


def encode_wal_checkpoint(e: Encoder, ck: WALCheckpoint) -> None:
    e.u32(_CKPT_MAGIC)
    e.u64(ck.base_seq)


def decode_wal_checkpoint(d: Decoder) -> WALCheckpoint:
    if d.u32() != _CKPT_MAGIC:
        raise DecodeError("bad wal checkpoint magic")
    return WALCheckpoint(d.u64())


# -- perf schema ------------------------------------------------------------

def build_wal_perf(name: str = "os_wal") -> PerfCounters:
    """The l_os_wal_* family: WAL plane accounting, riding the OSD's
    perf dump → MMgrReport → prometheus pipeline."""
    b = PerfCountersBuilder(name)
    b.add_u64_counter("l_os_wal_appends", "records committed to the WAL")
    b.add_u64_counter("l_os_wal_append_bytes", "txn payload bytes WAL'd")
    b.add_u64_counter("l_os_wal_deferred", "small txns acked at append")
    b.add_u64_counter(
        "l_os_wal_deferred_bytes", "write bytes deferred to the drain"
    )
    b.add_u64_counter("l_os_wal_barriers", "group-commit sync barriers")
    b.add_u64_avg(
        "l_os_wal_group_records",
        "records per barrier (sum/avgcount = mean group size)",
    )
    b.add_u64_counter(
        "l_os_wal_barrier_waits",
        "records that rode another caller's barrier",
    )
    b.add_u64_counter(
        "l_os_wal_reads_from_log",
        "reads served through the pending overlay (deferred read)",
    )
    b.add_u64_counter("l_os_wal_applies", "records applied to the inner store")
    b.add_u64_counter(
        "l_os_wal_apply_errors", "validated records the inner apply rejected"
    )
    b.add_u64_counter("l_os_wal_replay_records", "records re-applied at mount")
    b.add_u64_counter("l_os_wal_checkpoints", "WAL truncation checkpoints")
    b.add_u64_gauge("l_os_wal_pending_records", "committed, not yet applied")
    b.add_u64_gauge("l_os_wal_pending_bytes", "payload bytes pending apply")
    return b.create_perf_counters()


class _Pending:
    """One WAL-committed, not-yet-applied transaction."""

    __slots__ = (
        "seq", "txn", "payload", "deferred",
        "synced", "synced_ev", "applied_ev", "error",
    )

    def __init__(self, seq, txn, payload, deferred):
        self.seq = seq
        self.txn = txn
        self.payload = payload
        self.deferred = deferred
        self.synced = False
        self.synced_ev = threading.Event()
        self.applied_ev = threading.Event()
        self.error: str | None = None


class WALStore(ObjectStore):
    """WAL front over a concrete store (MemStore/KStore/BlockStore)."""

    def __init__(
        self,
        inner: ObjectStore,
        path: str | os.PathLike,
        sync: bool = True,
        prefer_deferred_size: int = 65536,
        max_group_txc: int = 32,
        flush_interval_ms: float = 0.5,
        checkpoint_bytes: int = 8 << 20,
        perf: PerfCounters | None = None,
        drain_delay: float = 0.0,
        device: str = "cuda",
    ):
        self.inner = inner
        # where replay batch-verifies the records' crcs
        self.device = device
        self.path = pathlib.Path(path)
        self.sync = sync
        self.prefer_deferred_size = int(prefer_deferred_size)
        self.max_group_txc = max(1, int(max_group_txc))
        self.flush_interval = float(flush_interval_ms) / 1000.0
        self.checkpoint_bytes = int(checkpoint_bytes)
        self.wal_perf = perf if perf is not None else build_wal_perf()
        # test hooks: slow or freeze the drain to widen the deferred
        # window deterministically
        self.drain_delay = float(drain_delay)
        self.drain_paused = False

        # scrub trust follows the backing media: an in-memory inner
        # cannot rot out-of-band, persistent media can
        self.residency_scrub_safe = inner.residency_scrub_safe
        # WAL truncation is only safe when the inner store is itself
        # durable (it persists each apply); a MemStore inner keeps the
        # full log so a remount can rebuild from empty
        self._durable_inner = hasattr(inner, "compact")

        # _state_lock orders the commit/overlay/apply seam: writers
        # validate+enqueue under it, readers materialize under it, the
        # drain applies+unpends under it (so a reader can never see a
        # record both in the overlay and in the inner store).  Lock
        # order: _state_lock -> _wal_cv and
        # _state_lock -> inner's own lock, always.
        self._state_lock = threading.Lock()
        self._drain_cv = threading.Condition(self._state_lock)
        self._pending: dict[int, _Pending] = {}
        self._by_cid: dict[str, list[int]] = {}
        self._next_seq = 1
        self._closed = False

        # group-commit plumbing
        self._wal_cv = threading.Condition()
        self._wal_q: list[_Pending] = []
        self._inflight = 0
        self._wal_bytes = 0

        self.path.mkdir(parents=True, exist_ok=True)
        self.replayed_records = self._mount()
        self._wal = open(self.path / _WAL, "ab")
        self._wal_bytes = self._wal.tell()

        self._writer_thread = threading.Thread(
            target=self._wal_writer, name="wal-writer", daemon=True
        )
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="wal-drain", daemon=True
        )
        self._writer_thread.start()
        self._drain_thread.start()

    # -- capacity passthrough ----------------------------------------------
    @property
    def total_bytes(self):
        return self.inner.total_bytes

    def statfs(self) -> dict:
        # deferred bytes are already durable in the WAL but not in the
        # inner accounting yet; the drain closes the gap within one
        # flush interval, well under the OSD's ~1 Hz poll
        return self.inner.statfs()

    # -- commit path --------------------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        if self._closed:
            raise StoreError("wal store is closed")
        write_bytes = sum(
            len(op[4]) for op in txn.ops if op[0] == "write"
        )
        deferred = write_bytes < self.prefer_deferred_size
        e = Encoder()
        encode_transaction(e, txn)
        payload = e.getvalue()

        with self._wal_cv:
            self._inflight += 1
        try:
            with self._state_lock:
                self._validate(txn)
                # commit-point binding: the generation this txn
                # assigns is the one the writer registers a resident
                # payload under — bound HERE, before ack, never at
                # the deferred apply
                residency_gens.note_txn(self, txn)
                seq = self._next_seq
                self._next_seq += 1
                rec = _Pending(seq, txn, payload, deferred)
                self._pending[seq] = rec
                for cid in {op[1] for op in txn.ops}:
                    self._by_cid.setdefault(cid, []).append(seq)
                self.wal_perf.inc("l_os_wal_pending_records")
                self.wal_perf.inc(
                    "l_os_wal_pending_bytes", len(payload)
                )
                # seq assignment and WAL enqueue are ONE critical
                # section (lock order: _state_lock -> _wal_cv): two
                # committers must hit _wal_q in seq order, or the
                # writer appends/fsyncs out of order and a crash can
                # leave a later-seq txn durable without the earlier
                # txn it was validated against (replay also sorts by
                # seq defensively, but the prefix it replays must be
                # seq-contiguous for history to be exact)
                with self._wal_cv:
                    if self._closed:
                        self._unpend(rec)
                        raise StoreError("wal store is closed")
                    self._wal_q.append(rec)
                    self._wal_cv.notify_all()
            rec.synced_ev.wait()
            if rec.error is None and not deferred:
                rec.applied_ev.wait()
        finally:
            with self._wal_cv:
                self._inflight -= 1
                self._wal_cv.notify_all()
        if rec.error is not None:
            raise StoreError(rec.error)
        self.wal_perf.inc("l_os_wal_appends")
        self.wal_perf.inc("l_os_wal_append_bytes", len(payload))
        if deferred:
            self.wal_perf.inc("l_os_wal_deferred")
            self.wal_perf.inc("l_os_wal_deferred_bytes", write_bytes)

    def _validate(self, txn: Transaction) -> None:
        """Shadow-apply against the effective (inner + overlay) state
        so a bad transaction fails HERE, synchronously, exactly like a
        synchronous store — never at the deferred apply, where the
        caller is long gone.  Caller holds _state_lock."""
        scratch = MemStore()
        by_cid: dict[str, set[str]] = {}
        rmcolls = set()
        for op in txn.ops:
            kind, cid = op[0], op[1]
            if cid == META_COLL:
                # the applied-seq stamp is store plumbing; a user txn
                # overwriting it would corrupt the exact-replay point
                raise StoreError(
                    f"collection {META_COLL} is reserved (-EPERM)"
                )
            oids = by_cid.setdefault(cid, set())
            if kind == "clone":
                oids.update((op[2], op[3]))
            elif kind == "rmcoll":
                rmcolls.add(cid)
            elif op[2] is not None:
                oids.add(op[2])
        for cid, oids in by_cid.items():
            self._materialize_into(
                scratch, cid, oids, full=cid in rmcolls,
                keep_unreadable=True,
            )
        st = _TxnState(scratch)
        for op in txn.ops:
            scratch._apply(st, op)

    # -- group-commit writer ------------------------------------------------
    def _wal_writer(self) -> None:
        while True:
            with self._wal_cv:
                while not self._wal_q and not self._closed:
                    self._wal_cv.wait()
                if self._closed and not self._wal_q:
                    return
                batch = self._wal_q[: self.max_group_txc]
                del self._wal_q[: len(batch)]
                # hold the barrier open for stragglers: only when MORE
                # writers are in flight than this batch captured (a
                # solo writer never waits), and only while there is
                # room in the group
                while (
                    len(batch) < self.max_group_txc
                    and self._inflight > len(batch)
                    and not self._closed
                ):
                    self._wal_cv.wait(self.flush_interval)
                    if not self._wal_q:
                        break
                    room = self.max_group_txc - len(batch)
                    batch.extend(self._wal_q[:room])
                    del self._wal_q[:room]
            self._commit_batch(batch)

    def _commit_batch(self, batch: list[_Pending]) -> None:
        ok: list[_Pending] = []
        for rec in batch:
            e = Encoder()
            encode_wal_record(e, make_wal_record(rec.seq, rec.payload))
            try:
                # per-record append without fsync; one barrier below
                append_frame(self._wal, e.getvalue(), sync=False)
                self._wal_bytes += 8 + len(e.getvalue())
                ok.append(rec)
            except StoreError as err:
                self._fail_record(rec, str(err))
        if ok and self.sync:
            try:
                os.fsync(self._wal.fileno())
            except OSError as err:
                for rec in ok:
                    self._fail_record(rec, f"wal fsync failed: {err}")
                ok = []
        if not ok:
            return
        self.wal_perf.inc("l_os_wal_barriers")
        self.wal_perf.inc("l_os_wal_group_records", len(ok))
        self.wal_perf.inc("l_os_wal_barrier_waits", len(ok) - 1)
        with self._drain_cv:
            for rec in ok:
                rec.synced = True
                rec.synced_ev.set()
            self._drain_cv.notify_all()

    def _fail_record(self, rec: _Pending, error: str) -> None:
        """Un-commit a record whose append failed (ENOSPC/IO error):
        remove it from the overlay so reads stop observing it, then
        wake the caller to raise."""
        with self._state_lock:
            self._unpend(rec)
        rec.error = error
        rec.synced_ev.set()

    def _unpend(self, rec: _Pending) -> None:
        """Caller holds _state_lock."""
        if self._pending.pop(rec.seq, None) is None:
            return
        for cid in {op[1] for op in rec.txn.ops}:
            seqs = self._by_cid.get(cid)
            if seqs is not None:
                try:
                    seqs.remove(rec.seq)
                except ValueError:
                    pass
                if not seqs:
                    del self._by_cid[cid]
        self.wal_perf.dec("l_os_wal_pending_records")
        self.wal_perf.dec("l_os_wal_pending_bytes", len(rec.payload))

    # -- deferred drain -----------------------------------------------------
    def _drain_loop(self) -> None:
        while True:
            with self._drain_cv:
                rec = self._next_drainable()
                while rec is None and not self._closed:
                    self._drain_cv.wait(0.05)
                    rec = self._next_drainable()
                if rec is None and self._closed:
                    return
            if self.drain_delay:
                # test hook: widen the committed-but-unapplied window
                time.sleep(self.drain_delay)
            with self._drain_cv:
                # re-check under the lock (a racing close/unpend)
                if self._pending.get(rec.seq) is not rec:
                    continue
                self._apply_one(rec)
                self._drain_cv.notify_all()
            self._maybe_checkpoint()

    def _next_drainable(self) -> _Pending | None:
        """Lowest-seq synced pending record; None if paused or none.
        Caller holds _state_lock."""
        if self.drain_paused or not self._pending:
            return None
        seq = min(self._pending)
        rec = self._pending[seq]
        return rec if rec.synced else None

    def _apply_one(self, rec: _Pending) -> None:
        """Apply one record to the inner store, stamped with its seq,
        and drop it from the overlay — one _state_lock critical
        section, so no reader can see the record double-applied.
        Caller holds _state_lock."""
        inner_txn = Transaction()
        inner_txn.ops = list(rec.txn.ops)
        inner_txn.setattr(
            META_COLL, META_OID, META_ATTR,
            rec.seq.to_bytes(8, "little"),
        )
        try:
            self.inner.queue_transaction(inner_txn)
            self.wal_perf.inc("l_os_wal_applies")
        except StoreError as err:
            # validated at commit; an inner rejection here means the
            # inner state diverged out-of-band — count it, keep the
            # drain alive (the KStore mount-replay precedent).  A
            # non-deferred caller is still blocked on applied_ev and
            # must RAISE, not return success for bytes that never
            # landed; a deferred caller is long gone, so the best we
            # can do for its acked state is shout (the record is
            # still in the WAL and the applied stamp did not
            # advance, so a remount retries the apply)
            self.wal_perf.inc("l_os_wal_apply_errors")
            if rec.deferred:
                log.error(
                    "wal drain: apply of acked deferred txn seq=%d "
                    "failed, acked state diverged until remount "
                    "replay: %s",
                    rec.seq, err,
                )
            else:
                rec.error = f"wal apply failed: {err}"
        self._unpend(rec)
        rec.applied_ev.set()

    def _maybe_checkpoint(self) -> None:
        if not self._durable_inner:
            return
        with self._state_lock:
            if self._pending or self._wal_bytes < self.checkpoint_bytes:
                return
            # every record in the log is applied and the inner store
            # persists its own applies: compact the inner (bounds ITS
            # log too), checkpoint the replay base, start a fresh WAL
            self.inner.compact()
            base = self._next_seq - 1
            e = Encoder()
            encode_wal_checkpoint(e, WALCheckpoint(base))
            body = e.getvalue()
            write_checkpoint(
                self.path / _CKPT,
                body + ceph_crc32c(0, body).to_bytes(4, "little"),
            )
            self._wal.close()
            self._wal = open(self.path / _WAL, "wb")
            if self.sync:
                os.fsync(self._wal.fileno())
            self._wal_bytes = 0
            self.wal_perf.inc("l_os_wal_checkpoints")

    # -- mount / replay -----------------------------------------------------
    def _mount(self) -> int:
        base = 0
        ckpt = self.path / _CKPT
        if ckpt.exists():
            blob = ckpt.read_bytes()
            if len(blob) >= 4:
                body, crc = blob[:-4], int.from_bytes(blob[-4:], "little")
                if ceph_crc32c(0, body) == crc:
                    try:
                        base = decode_wal_checkpoint(Decoder(body)).base_seq
                    except DecodeError:
                        base = 0
        applied = base
        try:
            raw = self.inner.getattr(META_COLL, META_OID, META_ATTR)
            applied = max(applied, int.from_bytes(raw, "little"))
        except StoreError:
            pass
        self._ensure_meta()

        wal = self.path / _WAL
        replayed = 0
        last_seq = applied
        if wal.exists():
            raw = wal.read_bytes()
            records: list[WALRecord] = []
            ends: list[int] = []
            pos = 0
            for body, end in replay_frames(raw):
                try:
                    rec = decode_wal_record(Decoder(body))
                except DecodeError:
                    break
                records.append(rec)
                ends.append(end)
                pos = end
            # batch-verify every record's payload crc on the device
            # kernels before trusting ANY of them; a mismatch is a
            # torn record — it and everything after it are discarded
            if records:
                from ..ops.scrub_kernels import batch_crc32c

                crcs = batch_crc32c(
                    [r.payload for r in records], device=self.device
                )
                for i, rec in enumerate(records):
                    if int(crcs[i]) != rec.crc:
                        records = records[:i]
                        pos = ends[i - 1] if i else 0
                        break
            # decode-verify in log order: a crc-valid record whose
            # txn fails to decode is as fatal as a torn one — every
            # later record was validated against its effects, so
            # applying them without it would fork the replayed
            # history.  Stop there and truncate, loudly.
            decoded: list[tuple[WALRecord, Transaction | None]] = []
            for i, rec in enumerate(records):
                if rec.seq <= applied:
                    # already stamped into the inner store
                    decoded.append((rec, None))
                    continue
                try:
                    txn = decode_transaction(Decoder(rec.payload))
                except DecodeError as err:
                    self.wal_perf.inc("l_os_wal_apply_errors")
                    log.error(
                        "wal replay: record seq=%d is crc-valid but "
                        "undecodable (%s); discarding it and %d "
                        "later record(s)",
                        rec.seq, err, len(records) - i - 1,
                    )
                    records = records[:i]
                    pos = ends[i - 1] if i else 0
                    break
                decoded.append((rec, txn))
            if pos < len(raw):
                truncate_tail(wal, pos)
            # defensive: apply in seq order even if a log written by
            # an earlier build interleaved records (the commit path
            # holds seq assignment and enqueue in one critical
            # section, so a healthy log is already ordered)
            decoded.sort(key=lambda p: p[0].seq)
            for rec, txn in decoded:
                last_seq = max(last_seq, rec.seq)
                if txn is None:
                    continue
                txn.setattr(
                    META_COLL, META_OID, META_ATTR,
                    rec.seq.to_bytes(8, "little"),
                )
                try:
                    self.inner.queue_transaction(txn)
                    replayed += 1
                except StoreError:
                    self.wal_perf.inc("l_os_wal_apply_errors")
        self._next_seq = last_seq + 1
        if replayed:
            self.wal_perf.inc("l_os_wal_replay_records", replayed)
        return replayed

    def _ensure_meta(self) -> None:
        """The stamp target must exist before the first stamped apply
        (setattr requires the object)."""
        txn = Transaction()
        if not self.inner.coll_exists(META_COLL):
            txn.create_collection(META_COLL)
            txn.touch(META_COLL, META_OID)
        elif not self.inner.exists(META_COLL, META_OID):
            txn.touch(META_COLL, META_OID)
        if txn.ops:
            self.inner.queue_transaction(txn)

    # -- lifecycle ----------------------------------------------------------
    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every committed record is applied (tests and
        clean shutdown; durability never depends on it)."""
        with self._drain_cv:
            return self._drain_cv.wait_for(
                lambda: not self._pending, timeout
            )

    def close(self, close_inner: bool = True) -> None:
        if self._closed:
            return
        self.flush()
        # set under _wal_cv so a committer's enqueue (which re-checks
        # _closed under the same lock) can never slip a record into
        # _wal_q after the writer thread decided to exit
        with self._wal_cv:
            self._closed = True
            self._wal_cv.notify_all()
        with self._drain_cv:
            self._drain_cv.notify_all()
        self._writer_thread.join(timeout=5.0)
        self._drain_thread.join(timeout=5.0)
        # the writer drains _wal_q before exiting; if it wedged past
        # the join timeout, fail the leftovers so no committer blocks
        # forever on synced_ev
        with self._wal_cv:
            leftovers = self._wal_q[:]
            self._wal_q.clear()
        for rec in leftovers:
            self._fail_record(rec, "wal store closed before append")
        if not self._wal.closed:
            self._wal.flush()
            if self.sync:
                os.fsync(self._wal.fileno())
            self._wal.close()
        if close_inner and hasattr(self.inner, "close"):
            self.inner.close()

    def compact(self) -> None:
        """Force a checkpoint (ignores the size threshold)."""
        self.flush()
        saved = self.checkpoint_bytes
        self.checkpoint_bytes = 0
        try:
            self._maybe_checkpoint()
        finally:
            self.checkpoint_bytes = saved

    # -- reads (deferred read-through) --------------------------------------
    def _materialize_into(
        self,
        scratch: MemStore,
        cid: str,
        oids,
        full: bool = False,
        keep_unreadable: bool = False,
    ) -> bool:
        """Populate ``scratch`` with the effective state of ``cid``
        restricted to ``oids`` plus every object the cid's pending ops
        name: inner copies first, then the pending ops replayed in seq
        order.  ``full`` seeds every inner object name (placeholders)
        so collection-emptiness is decidable.  ``keep_unreadable``
        seeds an object the inner store holds but cannot read (an
        at-rest checksum failure) as an empty placeholder instead of
        dropping it, so validation lets a remove or a full rewrite
        repair it.  Returns True when the overlay contributed (the
        read counts as served-from-log).  Caller holds _state_lock."""
        seqs = self._by_cid.get(cid, ())
        named = set(oids)
        for seq in seqs:
            for op in self._pending[seq].txn.ops:
                if op[1] != cid:
                    continue
                if op[0] == "clone":
                    named.update((op[2], op[3]))
                elif op[2] is not None:
                    named.add(op[2])
        if self.inner.coll_exists(cid):
            from .objectstore import _Object

            coll = scratch._colls.setdefault(cid, {})
            for oid in named:
                try:
                    data = self.inner.read(cid, oid)
                except StoreError:
                    if not (keep_unreadable and self.inner.exists(cid, oid)):
                        continue
                    data = b""
                o = _Object(data=bytearray(data))
                try:
                    o.xattrs = dict(self.inner.list_attrs(cid, oid))
                except StoreError:
                    pass
                try:
                    o.omap = dict(self.inner.omap_get(cid, oid))
                except StoreError:
                    pass
                coll[oid] = o
            if full:
                try:
                    for oid in self.inner.list_objects(cid):
                        if oid not in coll:
                            coll[oid] = _Object()
                except StoreError:
                    pass
        if not seqs:
            return False
        for seq in seqs:
            ops = [
                op for op in self._pending[seq].txn.ops if op[1] == cid
            ]
            st = _TxnState(scratch)
            try:
                for op in ops:
                    scratch._apply(st, op)
                scratch._commit(st)
            except StoreError:
                # a pending txn that re-validates dirty against the
                # RESTRICTED seed can only mean a materializer bug;
                # fail open to the inner state rather than wedge reads
                continue
        return True

    def _overlay_read(self, cid: str, oids, fn):
        """Run ``fn(store)`` against the effective state: the inner
        store directly when the cid has no pending records, else a
        materialized scratch."""
        if cid == META_COLL:
            # the stamp plumbing is store-internal: the whole read
            # surface presents it as absent, matching
            # list_collections/coll_exists (an empty MemStore gives
            # the exact missing-collection semantics per surface —
            # exists() -> False, read() -> -ENOENT, ...)
            return fn(MemStore())
        with self._state_lock:
            if not self._by_cid.get(cid):
                return fn(self.inner)
            scratch = MemStore()
            self._materialize_into(scratch, cid, oids)
            self.wal_perf.inc("l_os_wal_reads_from_log")
            return fn(scratch)

    def read(self, cid, oid, offset=0, length=-1) -> bytes:
        return self._overlay_read(
            cid, (oid,), lambda s: s.read(cid, oid, offset, length)
        )

    def getattr(self, cid, oid, name) -> bytes:
        return self._overlay_read(
            cid, (oid,), lambda s: s.getattr(cid, oid, name)
        )

    def stat(self, cid, oid) -> int:
        return self._overlay_read(
            cid, (oid,), lambda s: s.stat(cid, oid)
        )

    def exists(self, cid, oid) -> bool:
        return self._overlay_read(
            cid, (oid,), lambda s: s.exists(cid, oid)
        )

    def list_attrs(self, cid, oid) -> dict:
        return self._overlay_read(
            cid, (oid,), lambda s: s.list_attrs(cid, oid)
        )

    def omap_get(self, cid, oid) -> dict:
        return self._overlay_read(
            cid, (oid,), lambda s: s.omap_get(cid, oid)
        )

    def omap_get_vals(
        self, cid, oid, start_after: str = "", max_return: int = -1
    ) -> dict:
        return self._overlay_read(
            cid,
            (oid,),
            lambda s: s.omap_get_vals(cid, oid, start_after, max_return),
        )

    def list_objects(self, cid) -> list[str]:
        if cid == META_COLL:
            raise StoreError(f"no collection {cid} (-ENOENT)")
        with self._state_lock:
            seqs = self._by_cid.get(cid)
            if not seqs:
                return self.inner.list_objects(cid)
            # effective membership: inner names adjusted by the
            # pending ops' creates/removes/rmcoll
            scratch = MemStore()
            self._materialize_into(scratch, cid, (), full=True)
            self.wal_perf.inc("l_os_wal_reads_from_log")
            return scratch.list_objects(cid)

    def list_collections(self) -> list[str]:
        with self._state_lock:
            colls = set(self.inner.list_collections())
            for seqs in self._by_cid.values():
                for seq in seqs:
                    for op in self._pending[seq].txn.ops:
                        if op[0] == "mkcoll":
                            colls.add(op[1])
                        elif op[0] == "rmcoll":
                            colls.discard(op[1])
            colls.discard(META_COLL)
            return sorted(colls)

    def coll_exists(self, cid: str) -> bool:
        with self._state_lock:
            exists = self.inner.coll_exists(cid)
            for seq in self._by_cid.get(cid, ()):
                for op in self._pending[seq].txn.ops:
                    if op[0] == "mkcoll" and op[1] == cid:
                        exists = True
                    elif op[0] == "rmcoll" and op[1] == cid:
                        exists = False
            return exists and cid != META_COLL
