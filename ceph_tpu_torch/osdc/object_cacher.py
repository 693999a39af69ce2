"""ObjectCacher — the client-side object cache
(src/osdc/ObjectCacher.cc:1-2806 reduced to the load-bearing design).

librbd and the fs client put this between themselves and the cluster:
reads serve from cached extents, writes buffer DIRTY and write back
asynchronously (coalesced), a dirty limit throttles writers while the
flusher drains, and clean memory evicts LRU under a size cap.  Same
shape here, per backing object:

- extents: non-overlapping (offset, buffer, dirty) runs, overwritten/
  merged in place by writes, filled by reads.
- write-back: a flusher thread writes dirty runs (adjacent ones
  coalesced into one backend write) once they age past
  ``flush_age`` or whenever dirty bytes cross ``target_dirty``;
  writers block when dirty crosses ``max_dirty`` until the flusher
  catches up (the dirty throttle).
- eviction: clean extents drop LRU when the cache exceeds
  ``max_size``; dirty data is never dropped, only flushed.
- ``flush()`` barriers everything dirty to the cluster; ``close()``
  flushes and stops the flusher.

Coherence contract, documented: this caches for ONE client — the
reference guards it with rbd exclusive locks / MDS capabilities, and
here the rbd image (single writer) is the intended user.  Holes read
through the cache are cached as zeros; another client's concurrent
writes are invisible until ``discard``/``invalidate``.
"""

from __future__ import annotations

import logging
import threading
import time

from .objecter import BlocklistedError, ObjectNotFound, RadosError

log = logging.getLogger(__name__)


class _Extent:
    __slots__ = ("off", "buf", "dirty", "born")

    def __init__(self, off: int, buf: bytearray, dirty: bool):
        self.off = off
        self.buf = buf
        self.dirty = dirty
        self.born = time.monotonic()

    @property
    def end(self) -> int:
        return self.off + len(self.buf)


class ObjectCacher:
    def __init__(
        self,
        ioctx,
        max_dirty: int = 8 << 20,
        target_dirty: int = 4 << 20,
        max_size: int = 32 << 20,
        flush_age: float = 1.0,
    ):
        self.ioctx = ioctx
        self.max_dirty = max_dirty
        self.target_dirty = target_dirty
        self.max_size = max_size
        self.flush_age = flush_age
        self._lock = threading.Condition(threading.RLock())
        self._objects: dict[str, list[_Extent]] = {}
        self._lru: dict[str, float] = {}
        self.dirty_bytes = 0
        self.total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.backend_writes = 0
        self._stop = threading.Event()
        self.fatal_error: Exception | None = None
        self._flusher = threading.Thread(
            target=self._flush_loop, name="objectcacher.flush",
            daemon=True,
        )
        self._flusher.start()

    # -- bookkeeping --------------------------------------------------------
    def _account(self, delta_total: int, delta_dirty: int) -> None:
        self.total_bytes += delta_total
        self.dirty_bytes += delta_dirty

    def _insert(self, oid: str, ext: _Extent) -> None:
        """Insert a run, carving away any overlap from existing runs
        (the newcomer's bytes win — it is either a fresh write or
        data just fetched into a gap)."""
        runs = self._objects.setdefault(oid, [])
        out: list[_Extent] = []
        for r in runs:
            if r.end <= ext.off or r.off >= ext.end:
                out.append(r)
                continue
            # overlap: keep the non-overlapped head/tail pieces
            if r.off < ext.off:
                head = _Extent(
                    r.off, r.buf[: ext.off - r.off], r.dirty
                )
                head.born = r.born
                out.append(head)
            if r.end > ext.end:
                tail = _Extent(
                    ext.end, r.buf[ext.end - r.off :], r.dirty
                )
                tail.born = r.born
                out.append(tail)
            dropped = len(r.buf) - (
                (ext.off - r.off if r.off < ext.off else 0)
                + (r.end - ext.end if r.end > ext.end else 0)
            )
            self._account(-dropped, -dropped if r.dirty else 0)
        out.append(ext)
        out.sort(key=lambda e: e.off)
        self._objects[oid] = out
        self._account(len(ext.buf), len(ext.buf) if ext.dirty else 0)
        self._lru[oid] = time.monotonic()

    # -- read path ----------------------------------------------------------
    def read(self, oid: str, offset: int, length: int) -> bytes:
        """Assemble from cache; fetch gaps from the backend (cached
        clean, holes as zeros).  Returns exactly ``length`` bytes.

        Assembly re-checks coverage under the lock: a concurrent
        reader's eviction may have dropped extents between the gap
        scan and the copy, and assembling zeros for data the backend
        holds would be silent corruption — so uncovered ranges loop
        back through the fetch."""
        fetched_any = False
        for attempt in range(6):
            with self._lock:
                gaps = self._gaps(oid, offset, length)
                if not gaps:
                    if not fetched_any:
                        self.hits += 1
                    out = bytearray(length)
                    for r in self._objects.get(oid, []):
                        if r.end <= offset or r.off >= offset + length:
                            continue
                        s = max(offset, r.off)
                        e = min(offset + length, r.end)
                        out[s - offset : e - offset] = r.buf[
                            s - r.off : e - r.off
                        ]
                    self._lru[oid] = time.monotonic()
                    self._evict_locked()
                    return bytes(out)
            fetched_any = True
            for g_off, g_len in gaps:
                self.misses += 1
                try:
                    got = self.ioctx.read(
                        oid, length=g_len, offset=g_off
                    )
                except (ObjectNotFound, RadosError):
                    got = b""
                buf = bytearray(got) + bytearray(g_len - len(got))
                with self._lock:
                    # a write may have raced into the gap: only fill
                    # what is STILL uncovered, never clobbering newer
                    # bytes
                    for s_off, s_len in self._gaps(oid, g_off, g_len):
                        self._insert(
                            oid,
                            _Extent(
                                s_off,
                                buf[
                                    s_off - g_off : s_off
                                    - g_off
                                    + s_len
                                ],
                                dirty=False,
                            ),
                        )
        # pathological eviction contention: serve directly from the
        # backend with the (never-evicted) dirty extents overlaid
        try:
            got = self.ioctx.read(oid, length=length, offset=offset)
        except (ObjectNotFound, RadosError):
            got = b""
        out = bytearray(got) + bytearray(length - len(got))
        with self._lock:
            for r in self._objects.get(oid, []):
                if not r.dirty or r.end <= offset or r.off >= offset + length:
                    continue
                s_ = max(offset, r.off)
                e_ = min(offset + length, r.end)
                out[s_ - offset : e_ - offset] = r.buf[
                    s_ - r.off : e_ - r.off
                ]
        return bytes(out)

    def _gaps(self, oid: str, offset: int, length: int):
        gaps = []
        pos = offset
        for r in self._objects.get(oid, []):
            if r.end <= pos or r.off >= offset + length:
                continue
            if r.off > pos:
                gaps.append((pos, r.off - pos))
            pos = max(pos, r.end)
        if pos < offset + length:
            gaps.append((pos, offset + length - pos))
        return gaps

    # -- write path ----------------------------------------------------------
    def write(self, oid: str, offset: int, data: bytes) -> None:
        if self.fatal_error is not None:
            # fenced: buffering more write-back data would only grow
            # the amount silently lost — fail fast with the cause
            raise self.fatal_error
        data = bytes(data)
        if not data:
            return
        with self._lock:
            self._insert(
                oid, _Extent(offset, bytearray(data), dirty=True)
            )
            self._lock.notify_all()
            # the dirty throttle: block while over the hard limit so
            # one writer cannot buffer unbounded dirty memory
            deadline = time.monotonic() + 30.0
            while self.dirty_bytes > self.max_dirty:
                self._lock.wait(0.05)
                if time.monotonic() > deadline:
                    raise RadosError("objectcacher flush stalled")
                self._flush_some_locked(self.target_dirty)

    # -- flush ---------------------------------------------------------------
    def _dirty_runs(self, oid: str):
        """Adjacent dirty extents coalesce into single writes."""
        runs = []
        cur = None
        for r in self._objects.get(oid, []):
            if not r.dirty:
                continue
            if cur is not None and cur[0] + len(cur[1]) == r.off:
                cur[1] += r.buf
                cur[2].append(r)
            else:
                cur = [r.off, bytearray(r.buf), [r]]
                runs.append(cur)
        return runs

    def _flush_object_locked(self, oid: str) -> None:
        for off, buf, members in self._dirty_runs(oid):
            # write OUTSIDE the lock would be ideal; the runs are
            # snapshots so a short critical section is correct and
            # the single-writer contract keeps latency acceptable
            self.ioctx.write(oid, bytes(buf), offset=off)
            self.backend_writes += 1
            for m in members:
                if m.dirty:
                    m.dirty = False
                    self._account(0, -len(m.buf))
        self._lock.notify_all()

    def _flush_some_locked(self, down_to: int) -> None:
        for oid in sorted(
            self._objects,
            key=lambda o: min(
                (r.born for r in self._objects[o] if r.dirty),
                default=float("inf"),
            ),
        ):
            if self.dirty_bytes <= down_to:
                break
            self._flush_object_locked(oid)

    def flush(self, oid: str | None = None) -> None:
        if self.fatal_error is not None:
            raise self.fatal_error
        with self._lock:
            if oid is not None:
                self._flush_object_locked(oid)
            else:
                self._flush_some_locked(0)

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_age / 2):
            now = time.monotonic()
            try:
                with self._lock:
                    if self.dirty_bytes > self.target_dirty:
                        self._flush_some_locked(self.target_dirty)
                        continue
                    for oid, runs in list(self._objects.items()):
                        if any(
                            r.dirty and now - r.born > self.flush_age
                            for r in runs
                        ):
                            self._flush_object_locked(oid)
            except BlocklistedError as e:
                # FATAL: this client has been fenced — every retry
                # would fail identically and the application must
                # learn its write-back data is lost.  Record the
                # error (surfaced by the next write()/flush()) and
                # stop the flusher.
                log.error("object cacher fenced, stopping flusher: %s", e)
                self.fatal_error = e
                return
            except Exception as e:
                # a transient backend failure (e.g. an op timing out
                # across a primary failover) must degrade to a delayed
                # flush, not kill the flusher thread for the image's
                # lifetime — dirty runs stay dirty and retry next tick
                log.warning("object cacher flush tick failed: %s", e)

    # -- eviction / invalidation --------------------------------------------
    def _evict_locked(self) -> None:
        if self.total_bytes <= self.max_size:
            return
        for oid in sorted(self._lru, key=self._lru.get):
            runs = self._objects.get(oid, [])
            keep = []
            for r in runs:
                if r.dirty:
                    keep.append(r)
                else:
                    self._account(-len(r.buf), 0)
            if keep:
                self._objects[oid] = keep
            else:
                self._objects.pop(oid, None)
                self._lru.pop(oid, None)
            if self.total_bytes <= self.max_size:
                break

    def invalidate_all(self) -> None:
        """Flush everything dirty, then drop the whole cache — the
        caller is changing what the backend returns (snapshot
        routing, external writers)."""
        with self._lock:
            self._flush_some_locked(0)
            self._objects.clear()
            self._lru.clear()
            self.dirty_bytes = 0
            self.total_bytes = 0
            self._lock.notify_all()

    def discard(self, oid: str) -> None:
        """Drop ALL cached state for an object (dirty included) —
        the caller is deleting/trimming it."""
        with self._lock:
            for r in self._objects.pop(oid, []):
                self._account(-len(r.buf), -len(r.buf) if r.dirty else 0)
            self._lru.pop(oid, None)
            self._lock.notify_all()

    def close(self) -> None:
        self._stop.set()
        self._flusher.join(timeout=5)
        if self.fatal_error is not None:
            # fenced: the dirty data is unrecoverable from here; the
            # failure already surfaced (or will) via write()/flush()
            log.error(
                "object cacher closed fenced; %d dirty bytes dropped",
                self.dirty_bytes,
            )
            return
        self.flush()
