"""Host C pieces of the port, loaded with ctypes: ``ceph_crc32c``.

``csrc/crc32c.c`` (slicing-by-8, the JAX package's ``native/crc32c.c``)
is built with the host ``cc`` into ``build/ceph_tpu_torch/`` at first
use (``ops._build.build``).  A failed build raises: the shard hashes
never fall back to the table-driven Python version, which stays here as
``crc32c_plain``, the plain version the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            from .ops import _build

            lib = ctypes.CDLL(str(_build.build("crc32c.c")))
            lib.ceph_crc32c.restype = ctypes.c_uint32
            lib.ceph_crc32c.argtypes = [
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t,
            ]
            _lib = lib
    return _lib


def ceph_crc32c(crc: int, data) -> int:
    """ceph_crc32c(seed, data) — src/include/crc32c.h semantics: the
    caller's running crc, no implicit init or final inversion.  ``data``
    is bytes-like or a uint8 numpy array."""
    buf = np.ascontiguousarray(
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else data,
        dtype=np.uint8,
    )
    return _library().ceph_crc32c(crc & 0xFFFFFFFF, buf.ctypes.data, buf.size)


@functools.lru_cache(maxsize=1)
def _table() -> tuple[int, ...]:
    poly = 0x1EDC6F41

    def rev8(b):
        return int(f"{b:08b}"[::-1], 2)

    def rev32(v):
        return int(f"{v:032b}"[::-1], 2)

    table = []
    for i in range(256):
        c = rev8(i) << 24
        for _ in range(8):
            c = ((c << 1) ^ poly) & 0xFFFFFFFF if c & 0x80000000 else (
                c << 1
            ) & 0xFFFFFFFF
        table.append(rev32(c))
    return tuple(table)


def crc32c_plain(crc: int, data) -> int:
    """The table-driven Python crc32c, one byte a step."""
    table = _table()
    crc &= 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc


def crc32c_plain_rows(crc: int, rows: np.ndarray) -> np.ndarray:
    """``crc32c_plain(crc, row)`` of every row of a (n, L) uint8 array
    at once: the same table step, one byte column at a time across the
    rows."""
    table = np.array(_table(), dtype=np.uint32)
    cols = np.ascontiguousarray(np.asarray(rows, dtype=np.uint8).T)
    out = np.full(cols.shape[1], crc & 0xFFFFFFFF, dtype=np.uint32)
    for col in cols:
        out = (out >> 8) ^ table[(out ^ col) & 0xFF]
    return out
