"""CephFS analog — the file layer over rados
(src/mds + src/client reduced to the load-bearing layout).

What carries over from the reference's on-disk design:

- **Directories are omap objects**: dirfrag ``mds_dir.<ino>`` maps
  entry name → dentry JSON (ino/type) — exactly how the real MDS
  persists dirfrags in the metadata pool's omap.
- **Inodes** carry their attributes in the dentry + a backtrace-style
  inode object ``mds_ino.<ino>`` (size/layout/mtime as omap keys) so
  partial metadata updates are single-key writes.
- **File DATA uses the real CephFS object naming**:
  ``<ino:x>.<objectno:08x>`` in the data pool, striped through
  osdc/striper.py with the file_layout_t math — a framework client
  and a reference-format-aware tool agree on where bytes live.

Surface (the libcephfs/Client.cc verbs): mkdir/rmdir/readdir,
create/open/unlink/rename, read/write (sparse, striped), stat,
truncate.

Snapshots (round 4): ``snapshot(name)`` freezes the WHOLE filesystem
by snapshotting the metadata and data pools together (the pool-snap
delegation the rbd layer uses), and ``at_snap(name)`` returns a
READ-ONLY mount whose every lookup/readdir/read resolves at that
moment — metadata omaps and striped data objects alike ride the
clone-resolution machinery.  Deviation vs the reference's .snap
dirs: snapshots are filesystem-global, not per-directory snaprealms.

Deviations, documented: the MDS tier (ceph_tpu_torch.mds) carries
capabilities/journal/failover; THIS module is the library-mode
single-writer client.
"""

from __future__ import annotations

import itertools
import json
import stat as statmod
import time

from ..osdc.objecter import ObjectNotFound, RadosError
from ..osdc.striper import StripeLayout, map_extent

__all__ = ["CephFS", "FSError", "NotFound"]

ROOT_INO = 1


class FSError(RadosError):
    pass


class NotFound(FSError):
    pass


def _dir_oid(ino: int) -> str:
    return f"mds_dir.{ino}"


def _ino_oid(ino: int) -> str:
    return f"mds_ino.{ino}"


def _data_oid(ino: int, objectno: int) -> str:
    # the REAL CephFS data-object naming: <ino hex>.<objno 08x>
    return f"{ino:x}.{objectno:08x}"


class CephFS:
    """One mounted filesystem (the Client.cc role, library-form)."""

    def __init__(self, meta_ioctx, data_ioctx=None,
                 layout: StripeLayout | None = None):
        self.meta = meta_ioctx
        self.data = data_ioctx or meta_ioctx
        self.layout = layout or StripeLayout(
            stripe_unit=1 << 20, stripe_count=1, object_size=1 << 22
        )
        self._mkfs_if_needed()

    def _mkfs_if_needed(self) -> None:
        try:
            self.meta.omap_get_vals(_ino_oid(ROOT_INO), max_return=1)
        except (ObjectNotFound, RadosError):
            self.meta.write_full(_ino_oid(ROOT_INO), b"")
            self.meta.omap_set(
                _ino_oid(ROOT_INO),
                {"type": b"dir", "next_ino": b"2"},
            )
            self.meta.write_full(_dir_oid(ROOT_INO), b"")

    def _alloc_ino(self) -> int:
        # the inode-number table lives on the root inode (InoTable role)
        cur = int(
            self.meta.omap_get_vals(_ino_oid(ROOT_INO))["next_ino"]
        )
        self.meta.omap_set(
            _ino_oid(ROOT_INO), {"next_ino": str(cur + 1).encode()}
        )
        return cur

    # -- path walking (Client::path_walk) ----------------------------------
    def _lookup(self, path: str) -> tuple[int, dict]:
        """path → (ino, dentry) — root is ('', {type: dir})."""
        ino = ROOT_INO
        dentry = {"type": "dir", "ino": ROOT_INO}
        for name in [p for p in path.split("/") if p]:
            if dentry["type"] != "dir":
                raise FSError(f"{name!r}: not a directory (-ENOTDIR)")
            entries = self._readdir_raw(ino)
            if name not in entries:
                raise NotFound(f"{path!r} (-ENOENT)")
            dentry = entries[name]
            ino = dentry["ino"]
        return ino, dentry

    def _parent_of(self, path: str) -> tuple[int, str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise FSError("root has no parent (-EINVAL)")
        parent = "/".join(parts[:-1])
        ino, dentry = self._lookup(parent)
        if dentry["type"] != "dir":
            raise FSError(f"{parent!r}: not a directory (-ENOTDIR)")
        return ino, parts[-1]

    def _readdir_raw(self, dir_ino: int) -> dict[str, dict]:
        try:
            vals = self.meta.omap_get_vals(_dir_oid(dir_ino))
        except (ObjectNotFound, RadosError):
            raise NotFound(f"dirfrag {dir_ino} missing")
        return {k: json.loads(v) for k, v in vals.items()}

    def _ino_meta(self, ino: int) -> dict[str, bytes]:
        return self.meta.omap_get_vals(_ino_oid(ino))

    # -- directories -------------------------------------------------------
    def mkdir(self, path: str) -> int:
        parent, name = self._parent_of(path)
        if name in self._readdir_raw(parent):
            raise FSError(f"{path!r} exists (-EEXIST)")
        ino = self._alloc_ino()
        self.meta.write_full(_ino_oid(ino), b"")
        self.meta.omap_set(
            _ino_oid(ino),
            {"type": b"dir", "mtime": str(time.time()).encode()},
        )
        self.meta.write_full(_dir_oid(ino), b"")
        self.meta.omap_set(
            _dir_oid(parent),
            {name: json.dumps({"type": "dir", "ino": ino}).encode()},
        )
        return ino

    def rmdir(self, path: str) -> None:
        parent, name = self._parent_of(path)
        entries = self._readdir_raw(parent)
        if name not in entries:
            raise NotFound(f"{path!r} (-ENOENT)")
        dentry = entries[name]
        if dentry["type"] != "dir":
            raise FSError(f"{path!r}: not a directory (-ENOTDIR)")
        if self._readdir_raw(dentry["ino"]):
            raise FSError(f"{path!r} not empty (-ENOTEMPTY)")
        self.meta.remove(_dir_oid(dentry["ino"]))
        self.meta.remove(_ino_oid(dentry["ino"]))
        self.meta.omap_rm_keys(_dir_oid(parent), [name])

    def readdir(self, path: str = "/") -> list[str]:
        ino, dentry = self._lookup(path)
        if dentry["type"] != "dir":
            raise FSError(f"{path!r}: not a directory (-ENOTDIR)")
        return sorted(self._readdir_raw(ino))

    # -- files -------------------------------------------------------------
    def create(self, path: str) -> int:
        parent, name = self._parent_of(path)
        if name in self._readdir_raw(parent):
            raise FSError(f"{path!r} exists (-EEXIST)")
        ino = self._alloc_ino()
        self.meta.write_full(_ino_oid(ino), b"")
        self.meta.omap_set(
            _ino_oid(ino),
            {
                "type": b"file",
                "size": b"0",
                "mtime": str(time.time()).encode(),
            },
        )
        self.meta.omap_set(
            _dir_oid(parent),
            {name: json.dumps({"type": "file", "ino": ino}).encode()},
        )
        return ino

    def stat(self, path: str) -> dict:
        ino, dentry = self._lookup(path)
        meta = self._ino_meta(ino)
        is_dir = dentry["type"] == "dir"
        return {
            "ino": ino,
            "mode": (
                statmod.S_IFDIR if is_dir else statmod.S_IFREG
            ),
            "type": dentry["type"],
            "size": int(meta.get("size", b"0")),
            "mtime": float(meta.get("mtime", b"0")),
        }

    def write(self, path: str, offset: int, data: bytes) -> int:
        ino, dentry = self._lookup(path)
        if dentry["type"] != "file":
            raise FSError(f"{path!r}: not a file (-EISDIR)")
        data = bytes(data)
        pos = 0
        # extents come back in logical order: slices are sequential
        for objectno, obj_off, n in map_extent(
            self.layout, offset, len(data)
        ):
            self.data.write(
                _data_oid(ino, objectno),
                data[pos : pos + n],
                offset=obj_off,
            )
            pos += n
        size = int(self._ino_meta(ino)["size"])
        new_size = max(size, offset + len(data))
        self.meta.omap_set(
            _ino_oid(ino),
            {
                "size": str(new_size).encode(),
                "mtime": str(time.time()).encode(),
            },
        )
        return len(data)

    def read(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        ino, dentry = self._lookup(path)
        if dentry["type"] != "file":
            raise FSError(f"{path!r}: not a file (-EISDIR)")
        size = int(self._ino_meta(ino)["size"])
        if length < 0:
            length = size - offset
        length = max(0, min(length, size - offset))
        if length == 0:
            return b""
        parts = []
        for objectno, obj_off, n in map_extent(
            self.layout, offset, length
        ):
            try:
                got = self.data.read(
                    _data_oid(ino, objectno), length=n, offset=obj_off
                )
            except (ObjectNotFound, RadosError):
                got = b""
            parts.append(got + b"\0" * (n - len(got)))
        return b"".join(parts)

    def truncate(self, path: str, size: int) -> None:
        ino, dentry = self._lookup(path)
        if dentry["type"] != "file":
            raise FSError(f"{path!r}: not a file (-EISDIR)")
        old = int(self._ino_meta(ino)["size"])
        if size < old:
            # with striping the trimmed tail is NOT a contiguous
            # object range — zero it extent by extent so a later
            # write past the new end reads holes as zeros
            for objectno, obj_off, n in map_extent(
                self.layout, size, old - size
            ):
                try:
                    self.data.write(
                        _data_oid(ino, objectno),
                        b"\0" * n,
                        offset=obj_off,
                    )
                except RadosError:
                    pass
        self.meta.omap_set(
            _ino_oid(ino), {"size": str(size).encode()}
        )

    def unlink(self, path: str) -> None:
        parent, name = self._parent_of(path)
        entries = self._readdir_raw(parent)
        if name not in entries:
            raise NotFound(f"{path!r} (-ENOENT)")
        dentry = entries[name]
        if dentry["type"] == "dir":
            raise FSError(f"{path!r} is a directory (-EISDIR)")
        ino = dentry["ino"]
        # remove EVERY data object of the inode by name prefix — the
        # current size under-counts objects a truncate left zeroed
        prefix = f"{ino:x}."
        for oid in self.data.list_objects():
            if oid.startswith(prefix):
                try:
                    self.data.remove(oid)
                except (ObjectNotFound, RadosError):
                    pass
        self.meta.remove(_ino_oid(ino))
        self.meta.omap_rm_keys(_dir_oid(parent), [name])

    # -- snapshots (pool-snap delegation) ----------------------------------
    def snapshot(self, name: str) -> None:
        """Freeze the filesystem: one pool snap on the metadata pool
        and (when distinct) the data pool, under the fs namespace
        ``fs@<name>``."""
        self.meta.snap_create(f"fs@{name}")
        if self._distinct_data_pool():
            self.data.snap_create(f"fs@{name}")

    def _distinct_data_pool(self) -> bool:
        # POOL identity, not ioctx identity: two ioctxs over one pool
        # must not double-snap it
        return self.data.pool_id != self.meta.pool_id

    def remove_snapshot(self, name: str) -> None:
        self.meta.snap_remove(f"fs@{name}")
        if self._distinct_data_pool():
            self.data.snap_remove(f"fs@{name}")

    def list_snapshots(self) -> list[str]:
        return sorted(
            n[len("fs@"):]
            for n in self.meta.snap_list().values()
            if n.startswith("fs@")
        )

    def at_snap(self, name: str) -> "SnapMount":
        """A read-only view of the filesystem as of ``snapshot(name)``."""
        if name not in self.list_snapshots():
            raise NotFound(f"no fs snapshot {name!r} (-ENOENT)")
        return SnapMount(self, f"fs@{name}")

    def rename(self, src: str, dst: str) -> None:
        sparent, sname = self._parent_of(src)
        dparent, dname = self._parent_of(dst)
        entries = self._readdir_raw(sparent)
        if sname not in entries:
            raise NotFound(f"{src!r} (-ENOENT)")
        if dname in self._readdir_raw(dparent):
            raise FSError(f"{dst!r} exists (-EEXIST)")
        dentry = entries[sname]
        self.meta.omap_set(
            _dir_oid(dparent), {dname: json.dumps(dentry).encode()}
        )
        self.meta.omap_rm_keys(_dir_oid(sparent), [sname])


class SnapMount(CephFS):
    """Read-only mount at a filesystem snapshot: the same client code
    with both ioctx read contexts pinned to the snap (a fresh ioctx
    pair, so the live mount's contexts stay untouched), and every
    mutating verb refused."""

    _RO = (
        "mkdir", "rmdir", "create", "write", "truncate",
        "unlink", "rename", "snapshot", "remove_snapshot",
    )

    def __init__(self, live: "CephFS", snap_full: str):
        meta = live.meta.rados.open_ioctx(
            live.meta.rados.monc.osdmap.pool_names[live.meta.pool_id]
        )
        meta.snap_set_read(snap_full)
        if live.data.pool_id == live.meta.pool_id:
            data = meta
        else:
            data = live.data.rados.open_ioctx(
                live.data.rados.monc.osdmap.pool_names[
                    live.data.pool_id
                ]
            )
            data.snap_set_read(snap_full)
        self.meta = meta
        self.data = data
        self.layout = live.layout
        # NO _mkfs_if_needed: a snapshot view never writes

    def __getattribute__(self, name):
        if name in SnapMount._RO:
            raise FSError(
                f"{name}: read-only snapshot mount (-EROFS)"
            )
        return super().__getattribute__(name)
