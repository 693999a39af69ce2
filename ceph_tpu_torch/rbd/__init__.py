"""librbd analog — block images striped over the object layer
(src/librbd/librbd.cc public surface; image metadata in the
cls_rbd/omap style: header object + rbd_directory index;
data objects laid out by the Striper, src/osdc/Striper.cc).

An image is:

- ``rbd_header.<name>`` — an object whose OMAP holds size, order and
  stripe layout (the cls_rbd header pattern: metadata as omap keys,
  not serialized blobs, so partial updates are single-key writes).
- ``rbd_directory`` — pool-wide omap index of image names (cls_rbd's
  directory object).
- ``rbd_data.<name>.<object_no:016x>`` — data objects, SPARSE: a
  never-written object simply doesn't exist and reads as zeros.

I/O maps logical extents through the Striper and fans per-object ops
out on a thread pool (the io dispatch/ObjectCacher parallelism role —
and on an erasure pool this is the feeder of the primary OSDs' encode
on their device: ``stripe_count`` concurrent full-object writes per
window). The image computes nothing itself; where the bytes are
encoded is the OSDs' ``device``.
Snapshots delegate to pool snapshots (``Image.set_snap`` routes reads
through the pool snap context) — a documented deviation from librbd's
per-image snap contexts.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import threading

from ..osdc.striper import StripeLayout, map_extent
from ..osdc.objecter import ObjectNotFound, RadosError
from .lock import ExclusiveLock, LockBusy
from .object_map import ObjectMap

__all__ = [
    "RBD", "Image", "RBDError", "StripeLayout", "ExclusiveLock",
    "LockBusy", "ObjectMap",
]

DIRECTORY = "rbd_directory"
_IO_WORKERS = 8
# aio completions run on their own pool: an aio write waits on its
# per-object fan-out in the I/O pool, and sharing that pool would
# deadlock once _IO_WORKERS aio ops are in flight (every worker a
# parent waiting on a child queued behind it)
_AIO_WORKERS = 16


class RBDError(RadosError):
    pass


def _header_oid(name: str) -> str:
    return f"rbd_header.{name}"


def _data_oid(name: str, objectno: int) -> str:
    return f"rbd_data.{name}.{objectno:016x}"


class RBD:
    """Pool-level image management (the librbd::RBD surface)."""

    def create(
        self,
        ioctx,
        name: str,
        size: int,
        stripe_unit: int = 1 << 22,
        stripe_count: int = 1,
        object_size: int = 1 << 22,
        features: str = "",
    ) -> None:
        """``features``: comma list of "exclusive-lock" and
        "object-map" (the RBD_FEATURE_* bits; object-map implies
        exclusive-lock exactly as the reference enforces)."""
        if size < 0:
            raise RBDError("negative image size")
        feats = {f for f in features.split(",") if f}
        if not feats <= {"exclusive-lock", "object-map", "journaling"}:
            raise RBDError(f"unknown features {features!r} (-EINVAL)")
        if "object-map" in feats or "journaling" in feats:
            feats.add("exclusive-lock")
        layout = StripeLayout(stripe_unit, stripe_count, object_size)
        existing = ioctx.omap_get_vals(DIRECTORY) if self._dir_exists(
            ioctx
        ) else {}
        if name in existing:
            raise RBDError(f"image {name!r} exists (-EEXIST)")
        ioctx.write_full(_header_oid(name), b"")
        ioctx.omap_set(
            _header_oid(name),
            {
                "size": str(size).encode(),
                "stripe_unit": str(layout.stripe_unit).encode(),
                "stripe_count": str(layout.stripe_count).encode(),
                "object_size": str(layout.object_size).encode(),
                "features": ",".join(sorted(feats)).encode(),
            },
        )
        ioctx.omap_set(DIRECTORY, {name: b"1"})

    def clone(
        self,
        ioctx,
        parent_name: str,
        parent_snap: str,
        child_name: str,
    ) -> None:
        """COW clone of a parent image snapshot (librbd layering,
        librbd/Operations.cc clone): the child starts as pure
        metadata — reads fall through to the parent AT THE SNAP for
        objects the child has never written, writes copy-up the
        parent object first (object-granular COW, exactly the
        reference's granularity).  Deviations: no protect/unprotect
        gate and no children registry — removing a parent (or its
        snap) under live clones is the operator's misstep to avoid;
        flatten() severs the dependency."""
        snap_full = f"{parent_name}@{parent_snap}"
        snaps = {n: s for s, n in ioctx.snap_list().items()}
        if snap_full not in snaps:
            raise RBDError(
                f"parent snap {parent_snap!r} not found (-ENOENT)"
            )
        try:
            # the header AT THE SNAP: a parent resized after the
            # snapshot must not leak its head size into the child
            pmeta = ioctx.omap_get_vals(
                _header_oid(parent_name), snapid=snaps[snap_full]
            )
        except (ObjectNotFound, RadosError) as e:
            raise RBDError(f"parent {parent_name!r} not found: {e}")
        if "parent" in pmeta:
            # a clone of an unflattened clone would need recursive
            # read-through; flatten the middle image first
            raise RBDError(
                f"parent {parent_name!r} is itself a clone — "
                "flatten it before cloning (-EINVAL)"
            )
        existing = ioctx.omap_get_vals(DIRECTORY) if self._dir_exists(
            ioctx
        ) else {}
        if child_name in existing:
            raise RBDError(f"image {child_name!r} exists (-EEXIST)")
        psize = int(pmeta["size"])
        ioctx.write_full(_header_oid(child_name), b"")
        ioctx.omap_set(
            _header_oid(child_name),
            {
                "size": pmeta["size"],
                "stripe_unit": pmeta["stripe_unit"],
                "stripe_count": pmeta["stripe_count"],
                "object_size": pmeta["object_size"],
                "parent": json.dumps(
                    {
                        "name": parent_name,
                        "snap": parent_snap,
                        "snapid": snaps[snap_full],
                        "size": psize,
                    }
                ).encode(),
            },
        )
        ioctx.omap_set(DIRECTORY, {child_name: b"1"})

    @staticmethod
    def _dir_exists(ioctx) -> bool:
        try:
            ioctx.stat(DIRECTORY)
            return True
        except (ObjectNotFound, RadosError):
            return False

    def list(self, ioctx) -> list[str]:
        if not self._dir_exists(ioctx):
            return []
        return sorted(ioctx.omap_get_vals(DIRECTORY))

    def remove(self, ioctx, name: str) -> None:
        img = Image(ioctx, name)
        try:
            for objectno in range(img._max_objects()):
                try:
                    ioctx.remove(_data_oid(name, objectno))
                except (ObjectNotFound, RadosError):
                    pass
            map_oids = [f"rbd_object_map.{name}"] + [
                f"rbd_object_map.{name}@{sid}"
                for sid in img._image_snapids()
            ]
        finally:
            img.close()
        for moid in map_oids:
            try:
                ioctx.remove(moid)
            except (ObjectNotFound, RadosError):
                pass
        ioctx.remove(_header_oid(name))
        ioctx.omap_rm_keys(DIRECTORY, [name])


class Image:
    """One open image (librbd::Image): striped read/write/discard,
    resize, snapshot-routed reads."""

    def __init__(self, ioctx, name: str, cache: bool = False,
                 cache_opts: dict | None = None):
        """``cache=True`` opens the image behind an ObjectCacher
        (rbd_cache role): reads serve from cached extents, writes go
        write-back and flush on close()/flush() — single-writer
        semantics, like rbd_cache without an exclusive-lock
        arbiter (documented deviation)."""
        self.ioctx = ioctx
        self.name = name
        self._cache = None
        try:
            meta = ioctx.omap_get_vals(_header_oid(name))
        except (ObjectNotFound, RadosError) as e:
            raise RBDError(f"image {name!r} not found: {e}")
        if "size" not in meta:
            raise RBDError(f"image {name!r} has no header metadata")
        self._size = int(meta["size"])
        self.parent = (
            json.loads(meta["parent"]) if "parent" in meta else None
        )
        self._copyup_lock = threading.Lock()
        self._copyup_locks: dict[int, threading.Lock] = {}
        self.layout = StripeLayout(
            int(meta["stripe_unit"]),
            int(meta["stripe_count"]),
            int(meta["object_size"]),
        )
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=_IO_WORKERS,
            thread_name_prefix=f"rbd.{name}",
        )
        self._aio = concurrent.futures.ThreadPoolExecutor(
            max_workers=_AIO_WORKERS,
            thread_name_prefix=f"rbd.{name}.aio",
        )
        # feature plane: exclusive-lock + object-map (ExclusiveLock /
        # ObjectMap seats).  Mutations gate on lock ownership; a
        # cooperative handoff drains in-flight writes, flushes, and
        # releases (see _handoff_release)
        self.features = set(
            meta.get("features", b"").decode().split(",")
        ) - {""}
        self._xlock: ExclusiveLock | None = None
        self._objmap: ObjectMap | None = None
        self._wr_cond = threading.Condition()
        self._wr_inflight = 0
        self._releasing = False
        # acquire+map-load must complete ATOMICALLY before any other
        # local writer proceeds: is_owner flips true inside acquire()
        # BEFORE the map load, and a second writer racing past on
        # that flag could persist an EXISTS bit the stale load then
        # clobbers.  _ready flips only after the load.
        self._acquire_mu = threading.Lock()
        self._ready = False
        if "exclusive-lock" in self.features:
            self._xlock = ExclusiveLock(
                ioctx, _header_oid(name),
                on_release_request=self._handoff_release,
            )
        if "object-map" in self.features:
            self._objmap = ObjectMap(
                ioctx, f"rbd_object_map.{name}", self._max_objects()
            )
            self._objmap.load()
        # image journal (librbd/Journal.cc role): mutations append
        # to a per-image rados journal stream BEFORE the data ships;
        # the journal tail replays on lock acquisition (crash
        # consistency) and feeds rbd-mirror (see rbd/mirror.py)
        self._journal = None
        self._journal_uncommitted = 0
        # append+flush must be atomic across concurrent writers, and
        # replay suppression is THREAD-scoped: a replaying thread's
        # re-entrant writes skip journaling while other writers'
        # mutations journal normally
        self._journal_mu = threading.Lock()
        self._replay_tls = threading.local()
        if "journaling" in self.features:
            from ..mds.journaler import Journaler

            self._journal = Journaler(
                ioctx, prefix=f"rbd_journal.{name}"
            )
        if cache:
            if self.parent is not None:
                # the cacher cannot see parent read-through/copy-up;
                # silently uncached IO would betray cache=True
                raise RBDError(
                    "cache=True unsupported on an unflattened clone "
                    "(flatten first) (-EINVAL)"
                )
            # AFTER header validation: a failed open must not leak
            # the cacher's flusher thread
            from ..osdc.object_cacher import ObjectCacher

            self._cache = ObjectCacher(ioctx, **(cache_opts or {}))

    # -- exclusive-lock gating ---------------------------------------------
    def _ensure_owner_ready(self) -> None:
        """Lock held AND map loaded, atomically vs other local
        writers (see _acquire_mu/_ready above)."""
        if self._xlock.is_owner and self._ready:
            return
        with self._acquire_mu:
            if self._xlock.is_owner and self._ready:
                return
            self._xlock.acquire()
            if self._objmap is not None:
                # the map is only trusted under the lock: reload
                # what the previous owner persisted
                self._objmap.load()
            # _ready flips BEFORE journal replay: replay re-applies
            # entries through write()/discard(), which re-enter the
            # owner-ready fast path — entering the mutex again would
            # self-deadlock
            self._ready = True
            if self._journal is not None:
                self._journal_replay_tail()

    def _enter_write(self) -> None:
        """Every mutation passes here: wait out a handoff/barrier in
        progress, take (or confirm) the exclusive lock, count
        ourselves in-flight so a handoff can drain us."""
        if self._xlock is None:
            return
        with self._wr_cond:
            while self._releasing:
                self._wr_cond.wait()
            self._wr_inflight += 1
        try:
            self._ensure_owner_ready()
        except BaseException:
            with self._wr_cond:
                self._wr_inflight -= 1
                self._wr_cond.notify_all()
            raise

    def _exit_write(self) -> None:
        if self._xlock is None:
            return
        with self._wr_cond:
            self._wr_inflight -= 1
            self._wr_cond.notify_all()

    @contextlib.contextmanager
    def _write_barrier(self):
        """Exclude ALL writers (local in-flight drained, new ones
        held at the gate) for an operation that must see a frozen
        image — the snapshot+map-freeze pair.  A cooperative handoff
        queues behind the same flag, so the lock cannot leave this
        client mid-barrier."""
        if self._xlock is None:
            yield
            return
        with self._wr_cond:
            while self._releasing:
                self._wr_cond.wait()
            self._releasing = True
            while self._wr_inflight:
                self._wr_cond.wait()
        try:
            yield
        finally:
            with self._wr_cond:
                self._releasing = False
                self._wr_cond.notify_all()

    def _handoff_release(self) -> None:
        """Peer asked for the lock: drain in-flight writes, barrier
        the cache, hand it over (ExclusiveLock's release path)."""
        with self._wr_cond:
            while self._releasing:
                self._wr_cond.wait()
            self._releasing = True
            while self._wr_inflight:
                self._wr_cond.wait()
            try:
                if self._cache is not None:
                    self._cache.flush()
                self._ready = False
                self._xlock.release()
            finally:
                self._releasing = False
                self._wr_cond.notify_all()

    # -- image journal (librbd/Journal.cc reduced) -------------------------
    def _journal_append(self, op: int, off: int, length: int,
                        data: bytes = b"") -> None:
        """Journal-ahead: the entry is DURABLE before the data ships
        (a crash replays it on the next lock acquisition; rbd-mirror
        tails the same stream)."""
        if self._journal is None or getattr(
            self._replay_tls, "on", False
        ):
            return
        from ..common.encoding import Encoder

        e = Encoder()
        e.u8(op).u64(off).u64(length).bytes(data)
        with self._journal_mu:
            self._journal.append(e.getvalue())
            self._journal.flush()

    def _journal_commit(self) -> None:
        """Mark the applied prefix committed (trim honors mirror
        clients, so entries survive until every consumer saw them)."""
        if self._journal is None or getattr(
            self._replay_tls, "on", False
        ):
            # replay commits once, at its end — a mid-replay trim
            # would delete stream objects the generator still reads
            return
        self._journal_uncommitted += 1
        if self._journal_uncommitted >= 16:
            self._journal_uncommitted = 0
            with self._journal_mu:
                self._journal.trim()

    def _journal_replay_tail(self) -> None:
        """Re-apply the uncommitted journal tail (entries appended
        by a previous owner that crashed between journal and data;
        every entry is idempotent absolute-offset state)."""
        with self._journal_mu:
            self._journal.load()
        self._replay_tls.on = True
        try:
            for blob in self._journal.replay():
                self._journal_apply(blob)
        finally:
            self._replay_tls.on = False
        with self._journal_mu:
            self._journal.trim()

    def _journal_apply(self, blob: bytes) -> None:
        from ..common.encoding import Decoder

        d = Decoder(blob)
        op, off, length = d.u8(), d.u64(), d.u64()
        data = d.bytes()
        if op == 1:
            # the entry was in-bounds at append time; the image may
            # have SHRUNK since (a later resize entry restores it) —
            # grow transiently rather than wedging replay on the
            # size check
            if off + len(data) > self._size:
                self.resize(off + len(data))
            self.write(off, data)
        elif op == 2:
            self.discard(off, length)
        elif op == 3:
            self.resize(off)

    def lock_acquire(self) -> None:
        """Explicitly take the exclusive lock (rbd lock acquire)."""
        if self._xlock is None:
            raise RBDError("exclusive-lock feature not enabled")
        self._ensure_owner_ready()

    def lock_release(self) -> None:
        if self._xlock is not None:
            self._handoff_release()

    def is_lock_owner(self) -> bool:
        return self._xlock is not None and self._xlock.is_owner

    def lock_holder(self) -> str | None:
        """Current exclusive-lock holder cookie, or None (the rbd
        lock-status surface)."""
        if self._xlock is None:
            raise RBDError("exclusive-lock feature not enabled")
        return self._xlock._holder()

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        # drain in-flight aio FIRST: a queued aio_write must buffer
        # into a live cacher, not a closed one (its data would be
        # silently lost)
        self._aio.shutdown(wait=True)
        self._pool.shutdown(wait=True)
        if self._cache is not None:
            self._cache.close()  # flush-on-close (rbd_cache contract)
        if self._xlock is not None:
            self._xlock.close()

    def flush(self) -> None:
        """Barrier all write-back state to the cluster."""
        if self._cache is not None:
            self._cache.flush()

    def __enter__(self) -> "Image":
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- metadata ----------------------------------------------------------
    def size(self) -> int:
        return self._size

    def stat(self) -> dict:
        return {
            "size": self._size,
            "obj_size": self.layout.object_size,
            "stripe_unit": self.layout.stripe_unit,
            "stripe_count": self.layout.stripe_count,
            "num_objs": self._max_objects(),
        }

    def _max_objects(self) -> int:
        """Objects the image spans: all of each full object set, and in
        a last, partial set one for each stripe unit it reaches, up to
        stripe_count. The object holding the last byte is not always
        the highest: with stripe_count > 1 a partial set can reach a
        higher-numbered object before it (ROADMAP §C)."""
        if self._size == 0:
            return 0
        lay = self.layout
        full, rest = divmod(self._size, lay.object_size * lay.stripe_count)
        units = -(-rest // lay.stripe_unit)
        return full * lay.stripe_count + min(lay.stripe_count, units)

    def resize(self, new_size: int) -> None:
        """Grow is metadata-only (sparse); shrink trims the dropped
        range first — whole objects are removed and the boundary
        object's tail zeroed (librbd trim)."""
        if new_size < 0:
            raise RBDError("negative image size")
        old = self._size
        if self._journal is not None and not getattr(
            self._replay_tls, "on", False
        ):
            self._enter_write()
            try:
                self._journal_append(3, new_size, 0)
            finally:
                self._exit_write()
        was = getattr(self._replay_tls, "on", False)
        self._replay_tls.on = True  # the shrink's discard is covered
        try:                        # by the resize entry (this thread
            if new_size < old:      # only); don't double-journal
                self.discard(new_size, old - new_size)
        finally:
            self._replay_tls.on = was
        self._size = new_size
        self.ioctx.omap_set(
            _header_oid(self.name), {"size": str(new_size).encode()}
        )
        if self._objmap is not None:
            self._enter_write()
            try:
                self._objmap.resize(self._max_objects())
                self._objmap.save()
            finally:
                self._exit_write()

    # -- data path ---------------------------------------------------------
    def read(self, offset: int, length: int) -> bytes:
        """Striped read; holes (missing objects / short objects) read
        as zeros (sparse semantics)."""
        if offset < 0 or length < 0:
            raise RBDError("negative read extent")
        length = max(0, min(length, self._size - offset))
        if length == 0:
            return b""
        extents = map_extent(self.layout, offset, length)

        def read_one(ext):
            objectno, obj_off, n = ext
            oid = _data_oid(self.name, objectno)
            if self._cache is not None:
                return self._cache.read(oid, obj_off, n)
            try:
                data = self.ioctx.read(
                    oid, length=n, offset=obj_off
                )
            except (ObjectNotFound, RadosError):
                if self.parent is not None:
                    return self._parent_read(objectno, obj_off, n)
                data = b""
            return data + b"\0" * (n - len(data))

        parts = list(self._pool.map(read_one, extents))
        return b"".join(parts)

    def _parent_read(self, objectno: int, obj_off: int, n: int) -> bytes:
        """Read-through to the parent snapshot for an object the
        child never wrote (librbd's parent overlap read)."""
        p = self.parent
        # no explicit overlap bound: beyond-parent ranges simply have
        # no parent object bytes and zero-fill below (a computed
        # bound would need the inverse striper map for
        # stripe_count > 1 and gets it wrong otherwise)
        try:
            data = self.ioctx.read(
                _data_oid(p["name"], objectno), length=n,
                offset=obj_off, snapid=p["snapid"],
            )
        except (ObjectNotFound, RadosError):
            data = b""
        return data + b"\0" * (n - len(data))

    def _copy_up(self, objectno: int) -> None:
        """First write to an inherited object materializes the whole
        parent object in the child (librbd copy-up) so the child
        object fully shadows the parent from then on.  Serialized per
        object: concurrent stripes of one write (or parallel aio)
        must not let a late write_full of the parent base clobber a
        sibling's already-written chunk."""
        with self._copyup_lock:
            lock = self._copyup_locks.setdefault(
                objectno, threading.Lock()
            )
        with lock:
            oid = _data_oid(self.name, objectno)
            try:
                self.ioctx.stat(oid)
                return  # child already owns this object
            except (ObjectNotFound, RadosError):
                pass
            base = self._parent_read(
                objectno, 0, self.layout.object_size
            ).rstrip(b"\0")
            # write even when empty: the object's EXISTENCE is the
            # shadow
            self.ioctx.write_full(oid, base)

    def write(self, offset: int, data: bytes) -> int:
        if offset < 0:
            raise RBDError("negative write offset")
        data = bytes(data)
        if offset + len(data) > self._size:
            raise RBDError(
                f"write past image end ({offset + len(data)} > "
                f"{self._size}) (-EINVAL)"
            )
        extents = map_extent(self.layout, offset, len(data))
        cuts = []
        pos = 0
        for objectno, obj_off, n in extents:
            cuts.append((objectno, obj_off, data[pos : pos + n]))
            pos += n

        def write_one(cut):
            objectno, obj_off, chunk = cut
            oid = _data_oid(self.name, objectno)
            if self.parent is not None and not (
                obj_off == 0 and len(chunk) == self.layout.object_size
            ):
                # partial writes copy-up; a full-object write fully
                # shadows the parent by itself (librbd skips too)
                self._copy_up(objectno)
            if self._cache is not None:
                self._cache.write(oid, obj_off, chunk)
            else:
                self.ioctx.write(oid, chunk, offset=obj_off)

        self._enter_write()
        try:
            self._journal_append(1, offset, len(data), data)
            if self._objmap is not None:
                # EXISTS lands in the map BEFORE the data ships: a
                # crash between the two leaves the map conservative
                self._objmap.pre_write_many(
                    [c[0] for c in cuts]
                )
            list(self._pool.map(write_one, cuts))
            self._journal_commit()
        finally:
            self._exit_write()
        return len(data)

    def discard(self, offset: int, length: int) -> None:
        """Zero a range (librbd discard): whole objects drop, partial
        ranges overwrite with zeros."""
        if offset < 0 or length < 0:
            raise RBDError("negative discard extent")
        length = max(0, min(length, self._size - offset))
        if length == 0:
            return
        self._enter_write()
        try:
            self._journal_append(2, offset, length)
            self._discard_inner(offset, length)
            self._journal_commit()
        finally:
            self._exit_write()

    def _discard_inner(self, offset: int, length: int) -> None:
        for objectno, obj_off, n in map_extent(
            self.layout, offset, length
        ):
            oid = _data_oid(self.name, objectno)
            whole = obj_off == 0 and n == self.layout.object_size
            if self.parent is not None:
                # removing the child object would RESURRECT parent
                # data; a clone's discard writes zeros instead — and
                # a FAILED zeroing must surface (swallowing it would
                # be exactly the resurrection this path prevents)
                self._copy_up(objectno)
                self.ioctx.write(oid, b"\0" * n, offset=obj_off)
                continue
            if self._objmap is not None and not whole:
                self._objmap.pre_write(objectno)
            if self._cache is not None and whole:
                self._cache.discard(oid)
            elif self._cache is not None:
                # partial discard: zero through the cache so no
                # stale cached bytes survive it
                self._cache.write(oid, obj_off, b"\0" * n)
                continue
            if whole:
                try:
                    self.ioctx.remove(oid)
                except (ObjectNotFound, RadosError):
                    pass
                if self._objmap is not None:
                    # NONEXISTENT lands AFTER the remove commits (the
                    # inverse of the pre-write order, same reasoning)
                    self._objmap.post_remove(objectno)
            else:
                try:
                    self.ioctx.write(oid, b"\0" * n, offset=obj_off)
                except RadosError:
                    pass

    def flatten(self) -> None:
        """Copy every still-inherited object down from the parent and
        sever the dependency (librbd flatten): afterwards the child
        is a standalone image and the parent/snap may be retired."""
        if self.parent is None:
            return
        list(
            self._pool.map(self._copy_up, range(self._max_objects()))
        )
        self.ioctx.omap_rm_keys(_header_oid(self.name), ["parent"])
        self.parent = None

    # -- object-map queries (rbd diff/du fast path) ------------------------
    def _image_snapids(self) -> list[int]:
        """This image's snap ids, oldest first (ids are monotone)."""
        prefix = f"{self.name}@"
        return sorted(
            sid
            for sid, n in self.ioctx.snap_list().items()
            if n.startswith(prefix)
        )

    def diff_objects(self, from_snap: str | None = None) -> list[int]:
        """Object numbers changed since ``from_snap`` (None = all
        existing), answered ENTIRELY from the object map — no data
        object is read or listed (the fast-diff whole-object path,
        src/librbd/api/DiffIterate.cc).  Requires the object-map
        feature."""
        if self._objmap is None:
            raise RBDError(
                "diff_objects needs the object-map feature (-EINVAL)"
            )
        self._objmap.load()
        if from_snap is None:
            return self._objmap.existing_objects()
        from_id = self.ioctx.snap_lookup(f"{self.name}@{from_snap}")
        later = tuple(
            s for s in self._image_snapids() if s > from_id
        )
        return self._objmap.diff(from_id, later)

    def used_objects(self) -> int:
        """Allocated object count from the map (rbd du seat)."""
        if self._objmap is None:
            raise RBDError(
                "used_objects needs the object-map feature (-EINVAL)"
            )
        self._objmap.load()
        return self._objmap.used_objects()

    # -- aio (librbd completions) ------------------------------------------
    def aio_read(self, offset: int, length: int):
        return self._aio.submit(self.read, offset, length)

    def aio_write(self, offset: int, data: bytes):
        return self._aio.submit(self.write, offset, bytes(data))

    # -- snapshots (pool-snap delegation; documented deviation) ------------
    def snap_create(self, snap_name: str) -> int:
        # the snapshot and the map freeze must see a QUIESCED image:
        # a write racing between them would have its dirty bit
        # demoted to CLEAN even though its data lands after the snap,
        # hiding the object from every future fast-diff.  The barrier
        # drains in-flight writers and holds new ones (and any lock
        # handoff) until both land.
        with self._write_barrier():
            if self._xlock is not None:
                self._ensure_owner_ready()
            # completed writes must be IN the snapshot: barrier the
            # write-back cache before taking it (rbd_cache contract)
            if self._cache is not None:
                self._cache.flush()
            snapid = self.ioctx.snap_create(
                f"{self.name}@{snap_name}"
            )
            if self._objmap is not None:
                self._objmap.snap_create(snapid)
        return snapid

    def snap_remove(self, snap_name: str) -> None:
        if self._objmap is not None:
            snapid = self.ioctx.snap_lookup(
                f"{self.name}@{snap_name}"
            )
            later = [
                s for s in self._image_snapids() if s > snapid
            ]
            with self._write_barrier():
                self._ensure_owner_ready()
                self._objmap.snap_remove(
                    snapid, later[0] if later else None
                )
        self.ioctx.snap_remove(f"{self.name}@{snap_name}")

    def snap_list(self) -> list[str]:
        prefix = f"{self.name}@"
        return sorted(
            n[len(prefix):]
            for n in self.ioctx.snap_list().values()
            if n.startswith(prefix)
        )

    def set_snap(self, snap_name: str | None) -> None:
        """Route reads through a snapshot (librbd::Image::snap_set);
        None returns to the head.  The cache cannot distinguish head
        from snapshot bytes, so it flushes and invalidates on every
        routing change (librbd flushes+invalidates on snap_set for
        the same reason)."""
        if self._cache is not None:
            self._cache.invalidate_all()
        if snap_name is None:
            self.ioctx.snap_set_read(0)
        else:
            self.ioctx.snap_set_read(f"{self.name}@{snap_name}")
