"""rbd object-map + fast-diff — per-object existence tracking
(src/librbd/ObjectMap.cc:1, src/cls/rbd object_map methods, and the
fast-diff feature of src/librbd/api/DiffIterate.cc — redesigned as a
numpy state vector persisted in one map object instead of a cls-side
2-bit BitVector; states are byte-wide here, a documented deviation
that trades 4x map size — one byte per 4MB object — for direct
numpy indexing of diff queries).

States per data object (the reference's OBJECT_* values):

- 0 ``NONEXISTENT`` — never written (reads fall through / zero-fill)
- 1 ``EXISTS`` — written, and DIRTY since the last snapshot
- 2 ``EXISTS_CLEAN`` — written before the last snapshot, untouched
  since (the fast-diff distinction: snapshots demote 1 → 2)

Update discipline mirrors the reference's crash-safety order: the
map marks an object EXISTS **before** the data write lands (a crash
leaves the map conservative — it may claim existence for an object
the write never reached, which costs one spurious read, never a
missed one), and marks NONEXISTENT **after** a whole-object remove.

``snap_create`` persists a copy of the map at the snap
(``<map_oid>@<snapid>``) and demotes head states to CLEAN, so
``diff`` between any snap and head is a vector compare — no data
object is ever scanned (the rbd diff --whole-object fast path).

The map is only trusted while this client holds the image's
exclusive lock (same invariant as the reference, ObjectMap.cc's
"requires exclusive lock" precondition): lockless writers would race
their read-modify-write of the map object.
"""

from __future__ import annotations

import threading

import numpy as np

from ..osdc.objecter import ObjectNotFound, RadosError

__all__ = [
    "ObjectMap",
    "OBJECT_NONEXISTENT",
    "OBJECT_EXISTS",
    "OBJECT_EXISTS_CLEAN",
]

OBJECT_NONEXISTENT = 0
OBJECT_EXISTS = 1
OBJECT_EXISTS_CLEAN = 2


class ObjectMap:
    def __init__(self, ioctx, map_oid: str, num_objects: int):
        self.ioctx = ioctx
        self.oid = map_oid
        self._states = np.zeros(num_objects, dtype=np.uint8)
        self._loaded = False
        # Image fans one striped write over a thread pool and admits
        # concurrent writers; every mutate-then-save must be atomic
        # or one thread's tobytes() snapshot can persist over (and
        # erase) another's just-set EXISTS bit (the reference
        # serializes via in-process aio_update queueing)
        self._mut = threading.Lock()

    # -- persistence -------------------------------------------------------
    def load(self) -> None:
        try:
            raw = self.ioctx.read(self.oid)
        except (ObjectNotFound, RadosError):
            raw = b""
        got = np.frombuffer(raw, dtype=np.uint8)
        with self._mut:
            n = len(self._states)
            self._states = np.zeros(n, dtype=np.uint8)
            self._states[: min(n, got.size)] = got[: min(n, got.size)]
            self._loaded = True

    def save(self) -> None:
        with self._mut:
            self._save_locked()

    def _save_locked(self) -> None:
        self.ioctx.write_full(self.oid, self._states.tobytes())

    def resize(self, num_objects: int) -> None:
        with self._mut:
            old = self._states
            self._states = np.zeros(num_objects, dtype=np.uint8)
            self._states[: min(num_objects, old.size)] = old[
                : min(num_objects, old.size)
            ]

    # -- state updates (persisted immediately; see module doc order) -------
    def pre_write(self, objectno: int) -> None:
        """Mark EXISTS (dirty) before the data write ships."""
        self.pre_write_many((objectno,))

    def pre_write_many(self, objectnos) -> None:
        """One persisted update covering every object a striped write
        touches (ObjectMap::aio_update batches the same way)."""
        with self._mut:
            objectnos = [
                o for o in objectnos
                if self._states[o] != OBJECT_EXISTS
            ]
            if objectnos:
                self._states[list(objectnos)] = OBJECT_EXISTS
                self._save_locked()

    def post_remove(self, objectno: int) -> None:
        """Mark NONEXISTENT after a whole-object remove commits."""
        with self._mut:
            if self._states[objectno] != OBJECT_NONEXISTENT:
                self._states[objectno] = OBJECT_NONEXISTENT
                self._save_locked()

    # -- queries (the point: no data-object scans) -------------------------
    def object_exists(self, objectno: int) -> bool:
        return self._states[objectno] != OBJECT_NONEXISTENT

    def existing_objects(self) -> list[int]:
        return np.nonzero(self._states)[0].tolist()

    def used_objects(self) -> int:
        """rbd du seat: object count without listing the pool."""
        return int(np.count_nonzero(self._states))

    # -- snapshots / fast-diff ---------------------------------------------
    def _snap_oid(self, snapid: int) -> str:
        return f"{self.oid}@{snapid}"

    def snap_create(self, snapid: int) -> None:
        """Freeze the map at the snap and demote head to CLEAN."""
        with self._mut:
            self.ioctx.write_full(
                self._snap_oid(snapid), self._states.tobytes()
            )
            self._states[self._states == OBJECT_EXISTS] = (
                OBJECT_EXISTS_CLEAN
            )
            self._save_locked()

    def snap_remove(self, snapid: int, next_snapid: int | None) -> None:
        """Retiring a snap must not lose its interval's dirty set:
        fold it into the NEXT snap's map (merging interval A→B into
        B→C yields A→C) or, with no later snap, back into the head as
        EXISTS.  Only objects still existing at the fold target take
        the dirty bit — a vanished object is covered by the
        existence compare.  Then the frozen map object is removed
        (it would otherwise leak forever)."""
        with self._mut:
            try:
                doomed = self._load_snap(snapid)
            except (ObjectNotFound, RadosError):
                doomed = None
            if doomed is not None:
                dirty = doomed == OBJECT_EXISTS
                if next_snapid is not None:
                    nxt = self._load_snap(next_snapid)
                    nxt[dirty & (nxt == OBJECT_EXISTS_CLEAN)] = (
                        OBJECT_EXISTS
                    )
                    self.ioctx.write_full(
                        self._snap_oid(next_snapid), nxt.tobytes()
                    )
                else:
                    self._states[
                        dirty & (self._states == OBJECT_EXISTS_CLEAN)
                    ] = OBJECT_EXISTS
                    self._save_locked()
            try:
                self.ioctx.remove(self._snap_oid(snapid))
            except (ObjectNotFound, RadosError):
                pass

    def _load_snap(self, snapid: int) -> np.ndarray:
        raw = self.ioctx.read(self._snap_oid(snapid))
        got = np.frombuffer(raw, dtype=np.uint8)
        out = np.zeros(len(self._states), dtype=np.uint8)
        out[: min(out.size, got.size)] = got[: min(out.size, got.size)]
        return out

    def diff(
        self,
        from_snapid: int | None = None,
        through_snapids: tuple[int, ...] = (),
    ) -> list[int]:
        """Object numbers that changed since ``from_snapid`` (None =
        everything that exists), straight from the state vectors —
        the fast-diff whole-object answer.

        ``through_snapids``: snaps taken AFTER ``from_snapid`` — a
        head-dirty bit only proves change since the *latest* snap, so
        each intermediate interval's dirty set (frozen in that snap's
        map) ORs in (DiffIterate's per-snap object-map walk)."""
        if from_snapid is None:
            return self.existing_objects()
        base = self._load_snap(from_snapid)
        head = self._states
        base_ex = base != OBJECT_NONEXISTENT
        head_ex = head != OBJECT_NONEXISTENT
        changed = (
            (head == OBJECT_EXISTS)  # dirtied since the latest snap
        ) | (base_ex != head_ex)  # appeared or vanished
        for sid in through_snapids:
            changed |= self._load_snap(sid) == OBJECT_EXISTS
        return np.nonzero(changed)[0].tolist()
