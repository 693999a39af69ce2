"""Shared framed-WAL/checkpoint plumbing for the persistent stores
(KStore's transaction log and BlockStore's KV log ride the same
length+crc32c framing, torn-tail replay, and atomic-rename
checkpoint — one durability-critical implementation, two users)."""

from __future__ import annotations

import os
import pathlib

from ..native import ceph_crc32c
from .objectstore import StoreError


def frame(body: bytes) -> bytes:
    """[u32 len][u32 crc32c(body)][body]."""
    return (
        len(body).to_bytes(4, "little")
        + ceph_crc32c(0, body).to_bytes(4, "little")
        + body
    )


def append_frame(f, body: bytes, sync: bool) -> None:
    """Append one frame durably.  On a partial write (ENOSPC, IO
    error) the file is truncated back to the pre-append offset so a
    half-written frame can never sit MID-log and silently hide every
    commit that lands after it from the next mount's replay."""
    start = f.tell()
    try:
        f.write(frame(body))
        f.flush()
        if sync:
            os.fsync(f.fileno())
    except OSError as e:
        try:
            f.truncate(start)
            f.flush()
        except OSError:
            pass
        raise StoreError(f"wal append failed: {e}")


def replay_frames(raw: bytes):
    """Yield (body, end_pos) for every intact frame; stops at the
    first torn/corrupt frame (the kill-mid-write tail)."""
    pos = 0
    while pos + 8 <= len(raw):
        blen = int.from_bytes(raw[pos : pos + 4], "little")
        crc = int.from_bytes(raw[pos + 4 : pos + 8], "little")
        body = raw[pos + 8 : pos + 8 + blen]
        if len(body) < blen or ceph_crc32c(0, body) != crc:
            return
        pos += 8 + blen
        yield body, pos


def truncate_tail(path: pathlib.Path, good_pos: int) -> None:
    """Drop a torn tail so future appends start clean."""
    with open(path, "r+b") as f:
        f.truncate(good_pos)


def write_checkpoint(path: pathlib.Path, blob: bytes) -> None:
    """write-temp + fsync + atomic rename (crash leaves old or new)."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)
