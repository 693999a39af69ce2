"""ceph-fuse — a REAL kernel-mounted POSIX surface over the MDS tier
(src/ceph_fuse.cc + src/client/fuse_ll.cc, reduced to the high-level
libfuse API driven through ctypes — no C extension, no third-party
binding; the image ships libfuse.so.2 and that is all this needs).

    ceph-tpu-fuse /mnt/cephtpu --mon 127.0.0.1:6789

maps the mounted tree onto an ``MDSClient`` mount: metadata verbs go
through MDS sessions (multi-MDS subtree routing included), file DATA
stripes straight to the data pool — exactly the kernel/fuse client
split the reference has.  Runs foreground single-threaded (`-f -s`);
unmount with ``fusermount -u``.

Deviations: permissions/ownership are not enforced (single-tenant
dev mounts, like ceph-fuse with client permissions off); no
symlinks/hardlinks (the MDS tier does not model them); mtime is
advisory.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import stat as statmod
import sys

c_off_t = ctypes.c_int64
c_mode_t = ctypes.c_uint32


class Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_int64), ("tv_nsec", ctypes.c_int64)]


class Stat(ctypes.Structure):
    """x86_64 glibc struct stat."""

    _fields_ = [
        ("st_dev", ctypes.c_uint64),
        ("st_ino", ctypes.c_uint64),
        ("st_nlink", ctypes.c_uint64),
        ("st_mode", ctypes.c_uint32),
        ("st_uid", ctypes.c_uint32),
        ("st_gid", ctypes.c_uint32),
        ("__pad0", ctypes.c_uint32),
        ("st_rdev", ctypes.c_uint64),
        ("st_size", ctypes.c_int64),
        ("st_blksize", ctypes.c_int64),
        ("st_blocks", ctypes.c_int64),
        ("st_atime", ctypes.c_int64),
        ("st_atime_nsec", ctypes.c_int64),
        ("st_mtime", ctypes.c_int64),
        ("st_mtime_nsec", ctypes.c_int64),
        ("st_ctime", ctypes.c_int64),
        ("st_ctime_nsec", ctypes.c_int64),
        ("__glibc_reserved", ctypes.c_int64 * 3),
    ]


_FN = ctypes.CFUNCTYPE
GETATTR_T = _FN(ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(Stat))
MKDIR_T = _FN(ctypes.c_int, ctypes.c_char_p, c_mode_t)
PATH1_T = _FN(ctypes.c_int, ctypes.c_char_p)
RENAME_T = _FN(ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p)
TRUNCATE_T = _FN(ctypes.c_int, ctypes.c_char_p, c_off_t)
OPEN_T = _FN(ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p)
RW_T = _FN(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char),
    ctypes.c_size_t, c_off_t, ctypes.c_void_p,
)
CREATE_T = _FN(ctypes.c_int, ctypes.c_char_p, c_mode_t, ctypes.c_void_p)
FILL_DIR_T = _FN(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
    ctypes.POINTER(Stat), c_off_t,
)
READDIR_T = _FN(
    ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p, FILL_DIR_T,
    c_off_t, ctypes.c_void_p,
)
UTIMENS_T = _FN(
    ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(Timespec)
)


class FuseOperations(ctypes.Structure):
    """struct fuse_operations, FUSE_USE_VERSION 26 (libfuse 2.9)."""

    _fields_ = [
        ("getattr", GETATTR_T),
        ("readlink", ctypes.c_void_p),
        ("getdir", ctypes.c_void_p),
        ("mknod", ctypes.c_void_p),
        ("mkdir", MKDIR_T),
        ("unlink", PATH1_T),
        ("rmdir", PATH1_T),
        ("symlink", ctypes.c_void_p),
        ("rename", RENAME_T),
        ("link", ctypes.c_void_p),
        ("chmod", ctypes.c_void_p),
        ("chown", ctypes.c_void_p),
        ("truncate", TRUNCATE_T),
        ("utime", ctypes.c_void_p),
        ("open", OPEN_T),
        ("read", RW_T),
        ("write", RW_T),
        ("statfs", ctypes.c_void_p),
        ("flush", ctypes.c_void_p),
        ("release", ctypes.c_void_p),
        ("fsync", ctypes.c_void_p),
        ("setxattr", ctypes.c_void_p),
        ("getxattr", ctypes.c_void_p),
        ("listxattr", ctypes.c_void_p),
        ("removexattr", ctypes.c_void_p),
        ("opendir", ctypes.c_void_p),
        ("readdir", READDIR_T),
        ("releasedir", ctypes.c_void_p),
        ("fsyncdir", ctypes.c_void_p),
        ("init", ctypes.c_void_p),
        ("destroy", ctypes.c_void_p),
        ("access", ctypes.c_void_p),
        ("create", CREATE_T),
        ("ftruncate", ctypes.c_void_p),
        ("fgetattr", ctypes.c_void_p),
        ("lock", ctypes.c_void_p),
        ("utimens", UTIMENS_T),
        ("bmap", ctypes.c_void_p),
        ("flags", ctypes.c_uint),
        ("ioctl", ctypes.c_void_p),
        ("poll", ctypes.c_void_p),
        ("write_buf", ctypes.c_void_p),
        ("read_buf", ctypes.c_void_p),
        ("flock", ctypes.c_void_p),
        ("fallocate", ctypes.c_void_p),
    ]


class CephFuse:
    """The fuse_ll.cc seat: libfuse callbacks → MDSClient verbs."""

    def __init__(self, fs):
        self.fs = fs  # an MDSClient
        self._keep = []  # callback refs must outlive fuse_main

    # -- helpers -----------------------------------------------------------
    def _err(self, e) -> int:
        from ..mds.client import MDSError

        if isinstance(e, MDSError):
            table = {
                -2: -errno.ENOENT, -17: -errno.EEXIST,
                -20: -errno.ENOTDIR, -21: -errno.EISDIR,
                -39: -errno.ENOTEMPTY, -22: -errno.EINVAL,
            }
            return table.get(e.rc, -errno.EIO)
        return -errno.EIO

    # -- callbacks ---------------------------------------------------------
    def _getattr(self, path, stbuf):
        try:
            p = path.decode()
            st = self.fs.stat(p) if p != "/" else {
                "type": "dir", "size": 0, "mtime": 0, "ino": 1,
            }
        except Exception as e:  # noqa: BLE001
            return self._err(e)
        ctypes.memset(ctypes.byref(stbuf.contents), 0,
                      ctypes.sizeof(Stat))
        s = stbuf.contents
        is_dir = st["type"] == "dir"
        s.st_mode = (
            (statmod.S_IFDIR | 0o755) if is_dir
            else (statmod.S_IFREG | 0o644)
        )
        s.st_nlink = 2 if is_dir else 1
        s.st_ino = st.get("ino", 0)
        s.st_size = 0 if is_dir else int(st.get("size", 0))
        s.st_blksize = 4096
        s.st_blocks = (s.st_size + 511) // 512
        mt = int(st.get("mtime", 0))
        s.st_mtime = s.st_atime = s.st_ctime = mt
        s.st_uid = os.getuid()
        s.st_gid = os.getgid()
        return 0

    def _readdir(self, path, buf, filler, _off, _fi):
        try:
            names = self.fs.readdir(path.decode())
        except Exception as e:  # noqa: BLE001
            return self._err(e)
        filler(buf, b".", None, 0)
        filler(buf, b"..", None, 0)
        for n in names:
            filler(buf, n.encode(), None, 0)
        return 0

    def _mkdir(self, path, _mode):
        try:
            self.fs.mkdir(path.decode())
            return 0
        except Exception as e:  # noqa: BLE001
            return self._err(e)

    def _rmdir(self, path):
        try:
            self.fs.rmdir(path.decode())
            return 0
        except Exception as e:  # noqa: BLE001
            return self._err(e)

    def _unlink(self, path):
        try:
            self.fs.unlink(path.decode())
            return 0
        except Exception as e:  # noqa: BLE001
            return self._err(e)

    def _rename(self, src, dst):
        try:
            self.fs.rename(src.decode(), dst.decode())
            return 0
        except Exception as e:  # noqa: BLE001
            return self._err(e)

    def _create(self, path, _mode, _fi):
        try:
            self.fs.create(path.decode())
            return 0
        except Exception as e:  # noqa: BLE001
            return self._err(e)

    def _open(self, path, _fi):
        try:
            self.fs.stat(path.decode())
            return 0
        except Exception as e:  # noqa: BLE001
            return self._err(e)

    def _read(self, path, buf, size, off, _fi):
        try:
            data = self.fs.read(path.decode(), off, size)
        except Exception as e:  # noqa: BLE001
            return self._err(e)
        ctypes.memmove(buf, data, len(data))
        return len(data)

    def _write(self, path, buf, size, off, _fi):
        try:
            data = ctypes.string_at(buf, size)
            self.fs.write(path.decode(), off, data)
            return size
        except Exception as e:  # noqa: BLE001
            return self._err(e)

    def _truncate(self, path, length):
        try:
            self.fs.truncate(path.decode(), length)
            return 0
        except Exception as e:  # noqa: BLE001
            return self._err(e)

    def _utimens(self, _path, _times):
        return 0  # advisory

    def operations(self) -> FuseOperations:
        ops = FuseOperations()
        binds = [
            ("getattr", GETATTR_T, self._getattr),
            ("mkdir", MKDIR_T, self._mkdir),
            ("unlink", PATH1_T, self._unlink),
            ("rmdir", PATH1_T, self._rmdir),
            ("rename", RENAME_T, self._rename),
            ("truncate", TRUNCATE_T, self._truncate),
            ("open", OPEN_T, self._open),
            ("read", RW_T, self._read),
            ("write", RW_T, self._write),
            ("readdir", READDIR_T, self._readdir),
            ("create", CREATE_T, self._create),
            ("utimens", UTIMENS_T, self._utimens),
        ]
        for name, typ, fn in binds:
            cb = typ(fn)
            self._keep.append(cb)  # MUST outlive fuse_main
            setattr(ops, name, cb)
        return ops


def mount(fs, mountpoint: str, foreground: bool = True) -> int:
    """Block serving the mount until unmounted (fuse_main)."""
    libname = ctypes.util.find_library("fuse")
    if libname is None:
        raise OSError("libfuse not available")
    lib = ctypes.CDLL(libname)
    ceph = CephFuse(fs)
    ops = ceph.operations()
    argv_list = [b"ceph-tpu-fuse", mountpoint.encode()]
    if foreground:
        argv_list += [b"-f", b"-s"]
    # the MDS cap-recall protocol is the coherence authority; the
    # kernel must not serve its own stale dentry/attr caches over it
    argv_list += [b"-o", b"entry_timeout=0,attr_timeout=0"]
    argv = (ctypes.c_char_p * len(argv_list))(*argv_list)
    return lib.fuse_main_real(
        len(argv_list), argv, ctypes.byref(ops),
        ctypes.sizeof(ops), None,
    )


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="ceph-tpu-fuse")
    p.add_argument("mountpoint")
    p.add_argument("--mon", required=True, help="HOST:PORT")
    p.add_argument("--data-pool", default="fsdata")
    p.add_argument("--name", default="fuse")
    args = p.parse_args(argv)

    from ..mds import MDSClient
    from ..rados import Rados

    host, _, port = args.mon.rpartition(":")
    r = Rados(f"fuse-{args.name}").connect(host, int(port))
    fs = MDSClient(r, args.data_pool, name=args.name)
    try:
        return mount(fs, args.mountpoint)
    finally:
        fs.close()
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main())
