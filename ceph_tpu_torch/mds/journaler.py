"""Replayable metadata journal on rados (src/osdc/Journaler.cc:1).

The reference journals every metadata mutation into a striped object
stream ahead of lazily flushing the cache to the backing dirfrag
objects; on MDS failover the standby replays the stream from the
expire position to rebuild the unflushed tail.  Same shape here:

- head object ``<prefix>.head``: JSON {write_pos, expire_pos} — the
  Journaler::Header (write_pos/expire_pos/trimmed_pos collapsed to
  the two positions this machinery needs).
- entry stream striped over ``<prefix>.<objno:08x>`` objects of fixed
  ``object_size``; each entry is a 4-byte LE length frame + payload
  and may span object boundaries (the reference's journal stripes the
  same way through the Filer).

Durability contract: ``append`` buffers; ``flush`` writes the data
extents FIRST and the head LAST, so a torn flush is re-read as "tail
not yet committed" — replay stops at the recorded write_pos, never
mid-frame.
"""

from __future__ import annotations

import json
import struct

from ..osdc.objecter import ObjectNotFound, RadosError

_LEN = struct.Struct("<I")


class Journaler:
    """One journal stream bound to an ioctx (metadata pool)."""

    def __init__(
        self, ioctx, prefix: str = "mds_journal", object_size: int = 1 << 16
    ):
        self.ioctx = ioctx
        self.prefix = prefix
        self.object_size = object_size
        self.write_pos = 0
        self.expire_pos = 0
        self._pending: list[bytes] = []

    def _oid(self, objno: int) -> str:
        return f"{self.prefix}.{objno:08x}"

    def _head_oid(self) -> str:
        return f"{self.prefix}.head"

    # -- head --------------------------------------------------------------
    def load(self) -> "Journaler":
        """Read the head (or start fresh when none exists)."""
        try:
            head = json.loads(self.ioctx.read(self._head_oid()))
            self.write_pos = int(head["write_pos"])
            self.expire_pos = int(head["expire_pos"])
        except (ObjectNotFound, RadosError, ValueError, KeyError):
            self.write_pos = 0
            self.expire_pos = 0
        return self

    def _write_head(self) -> None:
        self.ioctx.write_full(
            self._head_oid(),
            json.dumps(
                {
                    "write_pos": self.write_pos,
                    "expire_pos": self.expire_pos,
                }
            ).encode(),
        )

    # -- append / flush ----------------------------------------------------
    def append(self, entry: bytes) -> int:
        """Buffer one entry; returns the stream position its frame
        ends at once flushed."""
        frame = _LEN.pack(len(entry)) + bytes(entry)
        self._pending.append(frame)
        return self.write_pos + sum(len(f) for f in self._pending)

    def flush(self) -> int:
        """Write buffered frames (data first, head last); returns the
        new write_pos."""
        if not self._pending:
            return self.write_pos
        blob = b"".join(self._pending)
        self._pending.clear()
        pos = self.write_pos
        off = 0
        while off < len(blob):
            objno, obj_off = divmod(pos + off, self.object_size)
            n = min(self.object_size - obj_off, len(blob) - off)
            self.ioctx.write(
                self._oid(objno), blob[off : off + n], offset=obj_off
            )
            off += n
        self.write_pos = pos + len(blob)
        self._write_head()
        return self.write_pos

    # -- replay ------------------------------------------------------------
    def _read_stream(self, pos: int, length: int) -> bytes:
        parts = []
        while length > 0:
            objno, obj_off = divmod(pos, self.object_size)
            n = min(self.object_size - obj_off, length)
            try:
                got = self.ioctx.read(
                    self._oid(objno), length=n, offset=obj_off
                )
            except (ObjectNotFound, RadosError):
                got = b""
            parts.append(got + b"\0" * (n - len(got)))
            pos += n
            length -= n
        return b"".join(parts)

    def replay(self):
        """Yield every committed entry in [expire_pos, write_pos) —
        the standby's journal replay on takeover."""
        for entry, _end in self.replay_from(self.expire_pos):
            yield entry

    # -- registered clients (Journaler client registry role,
    # src/journal/JournalMetadata.cc: a tailing consumer — rbd-mirror —
    # records its replay position; trim never passes the slowest
    # client).  Positions live in a SEPARATE omap object so consumer
    # updates never race the owner's head writes. ---------------------------
    def _clients_oid(self) -> str:
        return f"{self.prefix}.clients"

    def register_client(self, cid: str) -> int:
        """Idempotent; a new client starts at the current expire_pos
        (everything earlier is already in the backing store)."""
        existing = self.client_pos(cid)
        if existing is not None:
            return existing
        try:
            self.ioctx.stat(self._clients_oid())
        except (ObjectNotFound, RadosError):
            self.ioctx.write_full(self._clients_oid(), b"")
        self.ioctx.omap_set(
            self._clients_oid(),
            {f"client.{cid}": str(self.expire_pos).encode()},
        )
        return self.expire_pos

    def update_client(self, cid: str, pos: int) -> None:
        self.ioctx.omap_set(
            self._clients_oid(), {f"client.{cid}": str(pos).encode()}
        )

    def unregister_client(self, cid: str) -> None:
        try:
            self.ioctx.omap_rm_keys(
                self._clients_oid(), [f"client.{cid}"]
            )
        except (ObjectNotFound, RadosError):
            pass

    def client_pos(self, cid: str) -> int | None:
        try:
            vals = self.ioctx.omap_get_vals(self._clients_oid())
        except (ObjectNotFound, RadosError):
            return None
        raw = vals.get(f"client.{cid}")
        return int(raw) if raw is not None else None

    def _clients_min(self) -> int | None:
        try:
            vals = self.ioctx.omap_get_vals(self._clients_oid())
        except (ObjectNotFound, RadosError):
            return None
        poss = [
            int(v) for k, v in vals.items()
            if k.startswith("client.")
        ]
        return min(poss) if poss else None

    def replay_from(self, pos: int):
        """Yield (entry, end_pos) from ``pos`` to the committed head
        — the tailing-consumer read (rbd-mirror's journal fetch)."""
        pos = max(pos, self.expire_pos)
        while pos + _LEN.size <= self.write_pos:
            (n,) = _LEN.unpack(self._read_stream(pos, _LEN.size))
            if pos + _LEN.size + n > self.write_pos:
                break
            yield self._read_stream(pos + _LEN.size, n), (
                pos + _LEN.size + n
            )
            pos += _LEN.size + n

    # -- trim --------------------------------------------------------------
    def trim(self, upto: int | None = None) -> None:
        """Advance expire_pos (everything before it is reflected in
        the backing store) and delete fully-expired stream objects.
        Never trims past the slowest REGISTERED client (rbd-mirror
        must see every entry before it is deleted)."""
        upto = self.write_pos if upto is None else upto
        cmin = self._clients_min()
        if cmin is not None:
            upto = min(upto, cmin)
        old_obj = self.expire_pos // self.object_size
        # NEVER regress: a client registered from a stale instance
        # may record a position below the already-trimmed prefix
        self.expire_pos = max(
            self.expire_pos, min(upto, self.write_pos)
        )
        self._write_head()
        for objno in range(old_obj, self.expire_pos // self.object_size):
            try:
                self.ioctx.remove(self._oid(objno))
            except (ObjectNotFound, RadosError):
                pass
