"""Shard daemon + remote store proxy — the EC sub-op network boundary.

In the reference, the primary's ECBackend never touches a replica's
disk directly: sub-writes travel as MOSDECSubOpWrite and are applied
by the shard OSD's handle_sub_write (src/osd/ECBackend.cc:2106 fan-out,
:934 apply), sub-reads as MOSDECSubOpRead answered by handle_sub_read
(:1010).  This module provides both halves for the framework:

- ``ShardServer`` — a dispatcher hosting one ObjectStore; applies
  MECSubWrite transactions atomically, answers MECSubRead batches, and
  echoes MPing heartbeats (the OSD side).
- ``RemoteStore`` — an ObjectStore *proxy* over a messenger
  Connection, so the existing ECStore data plane (ec_store.py) runs
  unchanged with every shard behind a real network hop.  One sub-op
  message per transaction / read batch, exactly the reference's
  granularity.
- ``shard_daemon_main`` — stand-alone process entry
  (``python -m ceph_tpu_torch.store.remote --port P``), used by the
  multi-process EC tests and any real deployment.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import threading
import time

from ..msg import (
    MECSubRead,
    MECSubReadReply,
    MECSubWrite,
    MECSubWriteReply,
    MPing,
    Message,
    MessageError,
    Messenger,
)
from ..common.encoding import Decoder, Encoder
from ..msg.message import (
    READ_ATTR,
    READ_ATTRS,
    READ_DATA,
    READ_EXISTS,
    READ_LIST,
    READ_OMAP,
    READ_STAT,
)
from ..msg.messenger import Connection, Dispatcher
from .objectstore import MemStore, ObjectStore, StoreError, Transaction


# ambient span id for sub-ops issued through RemoteStore: set by the
# caller (the EC daemon path wraps its shard fan-out) so every
# MECSubWrite carries the client op's trace without threading a
# parameter through the ObjectStore interface
_TRACE = threading.local()


@contextlib.contextmanager
def trace_context(trace: str):
    prev = getattr(_TRACE, "id", "")
    _TRACE.id = trace
    try:
        yield
    finally:
        _TRACE.id = prev


def current_trace() -> str:
    return getattr(_TRACE, "id", "")


class ShardServer(Dispatcher):
    """Shard-OSD dispatcher: one ObjectStore behind sub-op messages."""

    def __init__(
        self,
        store: ObjectStore | None = None,
        whoami: int = 0,
        tracker=None,
        tracer=None,
    ):
        self.store = store or MemStore()
        self.whoami = whoami
        self.tracker = tracker  # OpTracker: sub-ops record their span
        self.tracer = tracer  # common.tracing.Tracer (optional)

    def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MECSubWrite):
            reply = MECSubWriteReply(
                tid=msg.tid, from_osd=self.whoami
            )
            top = None
            if self.tracker is not None:
                top = self.tracker.create_op(
                    f"ec_sub_write({msg.trace})", trace=msg.trace
                )
            span = None
            if self.tracer is not None and msg.trace:
                from ..common.tracing import ROLE_SHARD

                span = self.tracer.start_span(
                    "ec_sub_write",
                    trace_id=msg.trace,
                    role=ROLE_SHARD,
                )
            try:
                self.store.queue_transaction(msg.txn)
            except StoreError as e:
                reply.ok = False
                reply.error = str(e)
            if top is not None:
                top.mark_event("applied" if reply.ok else "failed")
                top.finish()
            if span is not None:
                span.mark_event("applied" if reply.ok else "failed")
                span.finish()
            conn.send(reply)
            return True
        if isinstance(msg, MECSubRead):
            reply = MECSubReadReply(tid=msg.tid, from_osd=self.whoami)
            for kind, cid, oid, a1, a2 in msg.ops:
                try:
                    reply.results.append((True, self._read(kind, cid, oid, a1, a2)))
                except StoreError as e:
                    reply.results.append((False, str(e).encode()))
            conn.send(reply)
            return True
        if isinstance(msg, MPing) and not msg.is_reply:
            conn.send(
                MPing(
                    tid=msg.tid,
                    from_osd=self.whoami,
                    stamp=msg.stamp,
                    is_reply=True,
                )
            )
            return True
        return False

    def _read(self, kind, cid, oid, a1, a2) -> bytes:
        s = self.store
        if kind == READ_DATA:
            length = a1 >> 32
            offset = a1 & 0xFFFFFFFF
            if length == 0xFFFFFFFF:  # whole-object sentinel
                length = -1
            return s.read(cid, oid, offset, length)
        if kind == READ_ATTR:
            return s.getattr(cid, oid, a2)
        if kind == READ_STAT:
            return s.stat(cid, oid).to_bytes(8, "little")
        if kind == READ_EXISTS:
            return b"\1" if s.exists(cid, oid) else b"\0"
        if kind == READ_LIST:
            return "\0".join(s.list_objects(cid)).encode()
        if kind == READ_ATTRS:
            e = Encoder()
            e.map(
                s.list_attrs(cid, oid),
                lambda e2, k: e2.string(k),
                lambda e2, v: e2.bytes(v),
            )
            return e.getvalue()
        if kind == READ_OMAP:
            e = Encoder()
            e.map(
                s.omap_get(cid, oid),
                lambda e2, k: e2.string(k),
                lambda e2, v: e2.bytes(v),
            )
            return e.getvalue()
        raise StoreError(f"unknown read kind {kind}")


def _pack_extent(offset: int, length: int) -> int:
    """(offset, length) packed into the u64 arg1 slot; length -1 (whole
    object) is carried as the sentinel 0xFFFFFFFF.  Extents are bounded
    to 32 bits each — shard objects are chunk-sized; reject anything
    larger loudly instead of silently corrupting the packing."""
    if length < 0:
        length = 0xFFFFFFFF
    if not 0 <= offset < 1 << 32 or not 0 <= length <= 0xFFFFFFFF:
        raise StoreError(
            f"extent ({offset}, {length}) exceeds the 32-bit sub-read "
            "window"
        )
    return (length << 32) | offset


class RemoteStore(ObjectStore):
    """ObjectStore proxy: every call becomes one sub-op round trip."""

    def __init__(self, conn: Connection, timeout: float = 30.0):
        self.conn = conn
        self.timeout = timeout

    def _call(self, msg, reply_cls):
        """Sub-op round trip; a dead/unreachable shard surfaces as
        StoreError, exactly like a local IO failure, so the EC layer's
        degraded-read/recovery paths engage."""
        try:
            reply = self.conn.call(msg, timeout=self.timeout)
        except MessageError as e:
            raise StoreError(f"shard unreachable: {e}") from e
        if not isinstance(reply, reply_cls):
            raise StoreError(f"unexpected reply {type(reply).__name__}")
        return reply

    # proxy: the backing store mutates on the remote daemon; our
    # generation counter cannot see those txns, so residency entries
    # must never key on this object
    residency_local = False

    # -- write -------------------------------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        reply = self._call(
            MECSubWrite(txn=txn, trace=current_trace()),
            MECSubWriteReply,
        )
        if not reply.ok:
            raise StoreError(reply.error)

    # -- reads -------------------------------------------------------------
    def _one(self, kind, cid, oid, a1=0, a2="") -> bytes:
        reply = self._call(
            MECSubRead(ops=[(kind, cid, oid, a1, a2)]), MECSubReadReply
        )
        if not reply.results:
            raise StoreError("empty read reply")
        ok, data = reply.results[0]
        if not ok:
            raise StoreError(data.decode())
        return data

    def read(self, cid, oid, offset=0, length=-1) -> bytes:
        return self._one(
            READ_DATA, cid, oid, _pack_extent(offset, length)
        )

    def getattr(self, cid, oid, name) -> bytes:
        return self._one(READ_ATTR, cid, oid, 0, name)

    def stat(self, cid, oid) -> int:
        return int.from_bytes(self._one(READ_STAT, cid, oid), "little")

    def exists(self, cid, oid) -> bool:
        # READ_EXISTS never fails server-side (absence is b"\\0"), so
        # any StoreError here is a transport failure and must surface —
        # a dead shard is not the same as "object absent"
        return self._one(READ_EXISTS, cid, oid) == b"\1"

    def list_objects(self, cid) -> list[str]:
        raw = self._one(READ_LIST, cid, "")
        return raw.decode().split("\0") if raw else []

    def list_attrs(self, cid, oid) -> dict[str, bytes]:
        raw = self._one(READ_ATTRS, cid, oid)
        return Decoder(raw).map(
            lambda d: d.string(), lambda d: d.bytes()
        )

    def omap_get(self, cid, oid) -> dict[str, bytes]:
        raw = self._one(READ_OMAP, cid, oid)
        return Decoder(raw).map(
            lambda d: d.string(), lambda d: d.bytes()
        )

    def ping(self, from_osd: int = -1, timeout: float = 5.0) -> float:
        """Heartbeat round trip; returns rtt seconds (raises
        MessageError when the shard is gone)."""
        t0 = time.monotonic()
        reply = self.conn.call(
            MPing(from_osd=from_osd, stamp=t0), timeout=timeout
        )
        if not isinstance(reply, MPing) or not reply.is_reply:
            raise MessageError("bad ping reply")
        return time.monotonic() - t0


def shard_daemon_main(argv=None) -> int:
    """Stand-alone shard OSD process (the ceph-osd role for one shard)."""
    p = argparse.ArgumentParser(prog="shard_daemon")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--osd-id", type=int, default=0)
    args = p.parse_args(argv)
    msgr = Messenger(name=f"osd.{args.osd_id}")
    msgr.add_dispatcher(ShardServer(whoami=args.osd_id))
    host, port = msgr.bind("127.0.0.1", args.port)
    # parent parses this line to learn the bound port
    print(f"shard_daemon ready {host}:{port}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        msgr.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(shard_daemon_main())
