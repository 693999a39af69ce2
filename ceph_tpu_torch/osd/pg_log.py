"""PG log — per-PG ordered op journal and log-based recovery math
(src/osd/PGLog.{h,cc}, src/osd/osd_types.h pg_log_entry_t).

Every client op on a PG appends one entry (MODIFY or DELETE of an
object at an eversion).  Peering compares logs: the authoritative log
is chosen by greatest ``last_epoch_started`` then newest
``last_update`` (find_best_info), and a
peer's missing set is exactly the objects named by authoritative
entries newer than that peer's ``last_update`` (proc_replica_log /
PGLog::merge_log's missing accumulation).  A peer whose last_update
predates the authoritative ``log_tail`` cannot catch up by log and
needs backfill (a full object copy walk).

eversion = (epoch, version): epoch of the map the primary ruled
under, monotone op counter — ordered lexicographically, exactly
eversion_t (osd_types.h:633).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.encoding import Decoder, Encoder

EV_ZERO = (0, 0)

MODIFY = 1  # pg_log_entry_t::MODIFY
DELETE = 2  # pg_log_entry_t::DELETE


@dataclass
class LogEntry:
    op: int
    oid: str
    version: tuple[int, int]
    prior_version: tuple[int, int] = EV_ZERO
    # client request id (osd_reqid_t role): lets the primary detect a
    # retried op and ack it without re-applying (append idempotency)
    reqid: str = ""

    def encode(self, e: Encoder) -> None:
        e.u8(self.op).string(self.oid)
        e.u32(self.version[0]).u64(self.version[1])
        e.u32(self.prior_version[0]).u64(self.prior_version[1])
        e.string(self.reqid)

    @classmethod
    def decode(cls, d: Decoder) -> "LogEntry":
        return cls(
            op=d.u8(),
            oid=d.string(),
            version=(d.u32(), d.u64()),
            prior_version=(d.u32(), d.u64()),
            reqid=d.string(),
        )


@dataclass
class PGInfo:
    """pg_info_t subset driving peering (osd_types.h:3348)."""

    pgid: str = ""
    last_update: tuple[int, int] = EV_ZERO
    log_tail: tuple[int, int] = EV_ZERO
    last_epoch_started: int = 0

    def encode(self, e: Encoder) -> None:
        e.string(self.pgid)
        e.u32(self.last_update[0]).u64(self.last_update[1])
        e.u32(self.log_tail[0]).u64(self.log_tail[1])
        e.u32(self.last_epoch_started)

    @classmethod
    def decode(cls, d: Decoder) -> "PGInfo":
        return cls(
            pgid=d.string(),
            last_update=(d.u32(), d.u64()),
            log_tail=(d.u32(), d.u64()),
            last_epoch_started=d.u32(),
        )


class PGLog:
    """Bounded in-order entry list: append, trim, and the recovery
    queries peering needs."""

    def __init__(self, entries: list[LogEntry] | None = None):
        self.entries: list[LogEntry] = list(entries or [])
        self.log_tail: tuple[int, int] = EV_ZERO

    @property
    def head(self) -> tuple[int, int]:
        return self.entries[-1].version if self.entries else self.log_tail

    def append(self, entry: LogEntry) -> None:
        assert entry.version > self.head, (entry.version, self.head)
        self.entries.append(entry)

    def trim(self, keep: int) -> None:
        """Drop the oldest entries, advancing log_tail (PGLog::trim)."""
        if len(self.entries) > keep:
            cut = self.entries[: len(self.entries) - keep]
            self.log_tail = cut[-1].version
            self.entries = self.entries[len(cut) :]

    def entries_after(self, version: tuple[int, int]) -> list[LogEntry]:
        """Entries strictly newer than ``version``; valid only when
        version >= log_tail (else the caller needs backfill)."""
        assert version >= self.log_tail, (version, self.log_tail)
        return [e for e in self.entries if e.version > version]

    def missing_since(
        self, version: tuple[int, int]
    ) -> dict[str, tuple[int, int]]:
        """oid → newest needed version for a peer at ``version``
        (the missing-set accumulation of proc_replica_log): DELETEs
        supersede older modifies of the same object."""
        missing: dict[str, tuple[int, int]] = {}
        for entry in self.entries_after(version):
            # newest op wins — DELETEs are pushed too (the peer must
            # apply the removal)
            missing[entry.oid] = entry.version
        return missing

    def truncate_after(self, version: tuple[int, int]) -> list[LogEntry]:
        """Drop entries strictly newer than ``version`` (the divergent
        rewind of PGLog::rewind_divergent_log); returns them newest
        first, the order rollback wants."""
        removed = [e for e in self.entries if e.version > version]
        self.entries = [e for e in self.entries if e.version <= version]
        return list(reversed(removed))

    def object_op(self, oid: str) -> LogEntry | None:
        """Newest entry for an object, if still in the log."""
        for entry in reversed(self.entries):
            if entry.oid == oid:
                return entry
        return None


def find_best_info(infos: dict[int, PGInfo]) -> int | None:
    """Authoritative peer choice (PeeringState::find_best_info):
    greatest last_epoch_started first (a peer from a stale interval
    must never win on a higher last_update alone), then newest
    last_update, then longest log (smallest tail), then lowest osd id
    for determinism.  None when no peer has any history."""
    best = None
    for osd, info in sorted(infos.items()):
        if info.last_update == EV_ZERO and info.last_epoch_started == 0:
            continue
        if best is None:
            best = osd
            continue
        cur = infos[best]
        key = (info.last_epoch_started, info.last_update)
        cur_key = (cur.last_epoch_started, cur.last_update)
        if key > cur_key:
            best = osd
        elif key == cur_key and info.log_tail < cur.log_tail:
            best = osd
    return best


def needs_backfill(auth: PGInfo, peer: PGInfo) -> bool:
    """A peer older than the authoritative log tail cannot recover by
    log (PeeringState::choose_acting's backfill split)."""
    return peer.last_update < auth.log_tail
