"""Typed messages + frame codec (the ECMsgTypes / MOSDPing / MOSDMap
roles, src/osd/ECMsgTypes.{h,cc}, src/messages/MOSDPing.h,
src/messages/MOSDMap.h) over the framework's versioned encoding.

Frame layout (ProtocolV2 crc-mode analog, src/msg/async/frames_v2.h):

    u32 magic | u16 type | u16 reserved | u64 tid | u32 payload_len
    u32 header_crc (crc32c over the 20 header bytes)
    payload bytes
    u32 payload_crc

Every message carries ``tid`` (transaction id) so replies pair with
requests across the connection, like the reference's sub-op tids.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..common.encoding import Decoder, Encoder
from ..native import ceph_crc32c
from ..store.objectstore import (
    Transaction,
    decode_transaction,
    encode_transaction,
)

FRAME_MAGIC = 0x43545546  # "CTUF"
_HEADER = struct.Struct("<IHHQI")


class MessageError(Exception):
    pass


_REGISTRY: dict[int, type["Message"]] = {}


def register_message(cls):
    """Class decorator: register a Message subclass by its TYPE id
    (the ceph_msg_type dispatch table role)."""
    if cls.TYPE in _REGISTRY:
        raise ValueError(f"message type {cls.TYPE} already registered")
    _REGISTRY[cls.TYPE] = cls
    return cls


@dataclass
class Message:
    """Base: subclasses set TYPE and implement encode_payload/
    decode_payload.  ``tid`` pairs replies with requests."""

    TYPE = 0
    tid: int = 0

    def encode_payload(self, e: Encoder) -> None:  # pragma: no cover
        pass

    @classmethod
    def decode_payload(cls, d: Decoder) -> "Message":
        return cls()

    # -- frame codec -------------------------------------------------------
    def to_frame(self) -> bytes:
        e = Encoder()
        self.encode_payload(e)
        payload = e.getvalue()
        header = _HEADER.pack(
            FRAME_MAGIC, self.TYPE, 0, self.tid, len(payload)
        )
        return b"".join(
            (
                header,
                ceph_crc32c(0, header).to_bytes(4, "little"),
                payload,
                ceph_crc32c(0, payload).to_bytes(4, "little"),
            )
        )

    @staticmethod
    def parse_header(buf: bytes) -> tuple[int, int, int]:
        """(type, tid, payload_len) from the 24-byte header block;
        raises MessageError on magic/crc mismatch."""
        if len(buf) != _HEADER.size + 4:
            raise MessageError("short header")
        magic, mtype, _res, tid, plen = _HEADER.unpack(
            buf[: _HEADER.size]
        )
        if magic != FRAME_MAGIC:
            raise MessageError(f"bad magic {magic:#x}")
        crc = int.from_bytes(buf[_HEADER.size :], "little")
        if ceph_crc32c(0, buf[: _HEADER.size]) != crc:
            raise MessageError("header crc mismatch")
        return mtype, tid, plen

    @staticmethod
    def from_payload(mtype: int, tid: int, payload: bytes, crc: int):
        if ceph_crc32c(0, payload) != crc:
            raise MessageError("payload crc mismatch")
        cls = _REGISTRY.get(mtype)
        if cls is None:
            raise MessageError(f"unknown message type {mtype}")
        msg = cls.decode_payload(Decoder(payload))
        msg.tid = tid
        return msg

    HEADER_SIZE = _HEADER.size + 4


# -- concrete messages -----------------------------------------------------


@register_message
@dataclass
class MPing(Message):
    """Heartbeat (MOSDPing): PING or PING_REPLY with sender id and a
    timestamp echoed back for rtt accounting."""

    TYPE = 1
    from_osd: int = 0
    stamp: float = 0.0
    is_reply: bool = False

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd).f64(self.stamp).bool(self.is_reply)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPing":
        return cls(
            from_osd=d.s32(), stamp=d.f64(), is_reply=d.bool()
        )


@register_message
@dataclass
class MECSubWrite(Message):
    """Primary → shard sub-write (ECSubWrite, src/osd/ECMsgTypes.h:37):
    one object-store transaction to apply atomically, tagged with the
    sender and the map epoch it was planned under."""

    TYPE = 2
    from_osd: int = 0
    epoch: int = 0
    txn: Transaction = field(default_factory=Transaction)
    trace: str = ""  # span id (ECBackend.cc:886: sub-ops carry trace)

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd).u32(self.epoch)
        encode_transaction(e, self.txn)
        e.string(self.trace)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MECSubWrite":
        return cls(
            from_osd=d.s32(), epoch=d.u32(),
            txn=decode_transaction(d), trace=d.string(),
        )


@register_message
@dataclass
class MECSubWriteReply(Message):
    """Shard → primary commit ack (ECSubWriteReply)."""

    TYPE = 3
    from_osd: int = 0
    ok: bool = True
    error: str = ""

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd).bool(self.ok).string(self.error)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MECSubWriteReply":
        return cls(from_osd=d.s32(), ok=d.bool(), error=d.string())


# read op kinds (the shard-side handle_sub_read switch)
READ_DATA = 0  # (cid, oid, off, len) -> bytes
READ_ATTR = 1  # (cid, oid, attr) -> bytes
READ_STAT = 2  # (cid, oid) -> size
READ_EXISTS = 3  # (cid, oid) -> bool
READ_LIST = 4  # (cid,) -> [oid]
READ_ATTRS = 5  # (cid, oid) -> encoded {name: value} map
READ_OMAP = 6  # (cid, oid) -> encoded {key: value} map


@register_message
@dataclass
class MECSubRead(Message):
    """Primary → shard sub-read (ECSubRead, src/osd/ECMsgTypes.h:96):
    a batch of read ops [(kind, cid, oid, arg1, arg2)]."""

    TYPE = 4
    from_osd: int = 0
    ops: list[tuple] = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd)
        e.u32(len(self.ops))
        for kind, cid, oid, a1, a2 in self.ops:
            e.u8(kind).string(cid).string(oid).u64(a1).string(a2)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MECSubRead":
        msg = cls(from_osd=d.s32())
        for _ in range(d.u32()):
            msg.ops.append(
                (d.u8(), d.string(), d.string(), d.u64(), d.string())
            )
        return msg


@register_message
@dataclass
class MECSubReadReply(Message):
    """Shard → primary read results (ECSubReadReply): per-op
    (ok, bytes) pairs; failed ops carry the error text."""

    TYPE = 5
    from_osd: int = 0
    results: list[tuple[bool, bytes]] = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd)
        e.u32(len(self.results))
        for ok, data in self.results:
            e.bool(ok).bytes(data)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MECSubReadReply":
        msg = cls(from_osd=d.s32())
        for _ in range(d.u32()):
            msg.results.append((d.bool(), d.bytes()))
        return msg


@register_message
@dataclass
class MOSDMap(Message):
    """Map distribution (MOSDMap): full map blob and/or a run of
    incremental blobs, by epoch."""

    TYPE = 6
    full: bytes = b""  # OSDMap.encode() or empty
    incrementals: list[bytes] = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.bytes(self.full)
        e.list(self.incrementals, lambda e2, b: e2.bytes(b))

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDMap":
        return cls(
            full=d.bytes(),
            incrementals=d.list(lambda d2: d2.bytes()),
        )


@register_message
@dataclass
class MMonSubscribe(Message):
    """Client → mon map subscription (MonClient subscribe flow,
    src/mon/MonClient.cc): "send me osdmaps starting at start_epoch"."""

    TYPE = 7
    what: str = "osdmap"
    start_epoch: int = 0  # 0 = send the full current map
    from_osd: int = -1

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.what).u32(self.start_epoch).s32(self.from_osd)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonSubscribe":
        return cls(
            what=d.string(), start_epoch=d.u32(), from_osd=d.s32()
        )


@register_message
@dataclass
class MOSDFailure(Message):
    """OSD → mon failure report (MOSDFailure; OSD::send_failures,
    src/osd/OSD.cc:5889).  ``failed_for`` seconds of silence; a report
    with failed_for < 0 withdraws a previous report (the recovery
    cancel path)."""

    TYPE = 8
    target: int = -1
    reporter: int = -1
    failed_for: float = 0.0
    epoch: int = 0

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.target).s32(self.reporter)
        e.f64(self.failed_for).u32(self.epoch)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDFailure":
        return cls(
            target=d.s32(), reporter=d.s32(),
            failed_for=d.f64(), epoch=d.u32(),
        )


@register_message
@dataclass
class MMonCommand(Message):
    """CLI → mon command (MMonCommand: the `ceph` CLI speaks JSON
    command dicts per src/mon/MonCommands.h)."""

    TYPE = 9
    cmd: str = "{}"  # JSON dict, e.g. {"prefix": "osd pool create", ...}

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.cmd)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonCommand":
        return cls(cmd=d.string())


@register_message
@dataclass
class MMonCommandReply(Message):
    """Mon → CLI reply: rc + human text + JSON payload."""

    TYPE = 10
    rc: int = 0
    outs: str = ""
    outb: str = ""  # JSON

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.rc).string(self.outs).string(self.outb)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonCommandReply":
        return cls(rc=d.s32(), outs=d.string(), outb=d.string())


@register_message
@dataclass
class MOSDBoot(Message):
    """OSD → mon boot announcement (MOSDBoot): mark me up at addr."""

    TYPE = 11
    osd: int = -1
    addr: str = ""

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.osd).string(self.addr)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDBoot":
        return cls(osd=d.s32(), addr=d.string())


# -- OSD daemon: client ops, replication, peering, recovery ----------------

# client op kinds (the do_osd_ops switch, PrimaryLogPG.cc)
OSD_OP_WRITEFULL = 0
OSD_OP_WRITE = 1
OSD_OP_READ = 2
OSD_OP_DELETE = 3
OSD_OP_STAT = 4
OSD_OP_SETXATTR = 5  # oid attr (in .oid/.attr), value in .data
OSD_OP_GETXATTR = 6
OSD_OP_LIST = 7  # list this PG's objects (the pgls op)
OSD_OP_APPEND = 8  # atomic append (offset resolved on the primary)
OSD_OP_CALL = 9  # object-class call (attr='cls.method', data=indata)
OSD_OP_OMAPSET = 10  # data = encoded {key: value} map
OSD_OP_OMAPGET = 11  # attr = start_after, length = max_return
OSD_OP_OMAPRM = 12  # data = encoded [key] list
OSD_OP_OMAPCLEAR = 13
OSD_OP_WATCH = 14  # offset = client cookie
OSD_OP_UNWATCH = 15  # offset = client cookie
OSD_OP_NOTIFY = 16  # data = payload; reply.data = encoded ack list

# MOSDOp.flags bits (the CEPH_OSD_FLAG_* seat)
OSD_FLAG_FULL_TRY = 1  # attempt the write even on a full OSD/pool
# (repair/delete traffic that FREES space must still land;
# CEPH_OSD_FLAG_FULL_TRY, src/include/rados.h)


@register_message
@dataclass
class MOSDOp(Message):
    """Client → primary object op (MOSDOp): targeted at a pg, carrying
    one op (the reference batches a vector; one is enough for the
    librados surface here)."""

    TYPE = 12
    pool: int = 0
    pgid: str = ""
    oid: str = ""
    op: int = OSD_OP_READ
    offset: int = 0
    length: int = 0
    data: bytes = b""
    attr: str = ""
    reqid: str = ""  # stable across retries (osd_reqid_t role)
    epoch: int = 0  # client's map epoch (primary checks staleness)
    snapid: int = 0  # read snapshot (0 = head, CEPH_NOSNAP role)
    # writer SnapContext seq (SnapContext::seq, PrimaryLogPG.h:632):
    # self-managed snaps — make_writeable clones against THIS, not
    # the pool's snap_seq, when the writer provides one
    snap_seq: int = 0
    # op flags (OSD_FLAG_*): FULL_TRY lets repair/delete traffic land
    # on a full OSD instead of parking on backoff
    flags: int = 0
    # QoS class (the dmclock client-class tag): the primary enqueues
    # this op under the named scheduler class when its profile is
    # registered, else under the default client class; empty = client
    qos: str = ""

    def encode_payload(self, e: Encoder) -> None:
        e.s64(self.pool).string(self.pgid).string(self.oid)
        e.u8(self.op).u64(self.offset).s64(self.length)
        e.bytes(self.data).string(self.attr).string(self.reqid)
        e.u32(self.epoch).u64(self.snapid).u64(self.snap_seq)
        e.u32(self.flags).string(self.qos)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDOp":
        return cls(
            pool=d.s64(), pgid=d.string(), oid=d.string(),
            op=d.u8(), offset=d.u64(), length=d.s64(),
            data=d.bytes(), attr=d.string(), reqid=d.string(),
            epoch=d.u32(), snapid=d.u64(), snap_seq=d.u64(),
            # versioned-decode tolerance: frames from before the
            # backoff plane carry no flags word, pre-SLO ones no qos
            flags=d.u32() if d.remaining() else 0,
            qos=d.string() if d.remaining() else "",
        )


@register_message
@dataclass
class MOSDOpReply(Message):
    """Primary → client result (MOSDOpReply)."""

    TYPE = 13
    ok: bool = True
    error: str = ""
    data: bytes = b""
    names: list = field(default_factory=list)
    size: int = 0
    epoch: int = 0  # primary's epoch (client refreshes when ahead)

    def encode_payload(self, e: Encoder) -> None:
        e.bool(self.ok).string(self.error).bytes(self.data)
        e.list(self.names, lambda e2, n: e2.string(n))
        e.u64(self.size).u32(self.epoch)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDOpReply":
        return cls(
            ok=d.bool(), error=d.string(), data=d.bytes(),
            names=d.list(lambda d2: d2.string()),
            size=d.u64(), epoch=d.u32(),
        )


@register_message
@dataclass
class MOSDRepOp(Message):
    """Primary → replica: one transaction + its log entry (MOSDRepOp /
    sub_op_modify: data and pg log ride the same atomic apply)."""

    TYPE = 14
    pgid: str = ""
    epoch: int = 0
    txn: "Transaction" = None  # type: ignore[assignment]
    entry_blob: bytes = b""  # encoded LogEntry
    trace: str = ""  # span id (the client reqid; ECBackend.cc:886 role)

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.pgid).u32(self.epoch)
        encode_transaction(e, self.txn)
        e.bytes(self.entry_blob)
        e.string(self.trace)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDRepOp":
        return cls(
            pgid=d.string(), epoch=d.u32(),
            txn=decode_transaction(d), entry_blob=d.bytes(),
            trace=d.string(),
        )


@register_message
@dataclass
class MOSDRepOpReply(Message):
    TYPE = 15
    from_osd: int = 0
    ok: bool = True
    error: str = ""

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd).bool(self.ok).string(self.error)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDRepOpReply":
        return cls(from_osd=d.s32(), ok=d.bool(), error=d.string())


@register_message
@dataclass
class MPGQuery(Message):
    """Primary → peer: send me your pg_info (the GetInfo query,
    PeeringState's pg_query_t)."""

    TYPE = 16
    pgid: str = ""
    epoch: int = 0

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.pgid).u32(self.epoch)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGQuery":
        return cls(pgid=d.string(), epoch=d.u32())


@register_message
@dataclass
class MPGNotify(Message):
    """Peer → primary: pg_info + recent log suffix (MNotifyRec role;
    the log rides along so the primary can locate the divergence
    point, the proc_replica_log input)."""

    TYPE = 17
    from_osd: int = 0
    info_blob: bytes = b""  # encoded PGInfo ('' = pg unknown here)
    entry_blobs: list = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd).bytes(self.info_blob)
        e.list(self.entry_blobs, lambda e2, b: e2.bytes(b))

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGNotify":
        return cls(
            from_osd=d.s32(), info_blob=d.bytes(),
            entry_blobs=d.list(lambda d2: d2.bytes()),
        )


@register_message
@dataclass
class MPGLogReq(Message):
    """Primary → authoritative peer: entries after ``since`` (the
    GetLog request)."""

    TYPE = 18
    pgid: str = ""
    epoch: int = 0
    since: tuple = (0, 0)

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.pgid).u32(self.epoch)
        e.u32(self.since[0]).u64(self.since[1])

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGLogReq":
        return cls(
            pgid=d.string(), epoch=d.u32(), since=(d.u32(), d.u64())
        )


@register_message
@dataclass
class MPGLogReply(Message):
    """Authoritative peer → primary: log entries + info (MLogRec)."""

    TYPE = 19
    from_osd: int = 0
    info_blob: bytes = b""
    entry_blobs: list = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd).bytes(self.info_blob)
        e.list(self.entry_blobs, lambda e2, b: e2.bytes(b))

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGLogReply":
        return cls(
            from_osd=d.s32(), info_blob=d.bytes(),
            entry_blobs=d.list(lambda d2: d2.bytes()),
        )


@register_message
@dataclass
class MPGPush(Message):
    """Primary → recovering peer: one whole object at a version (the
    recovery push, ReplicatedBackend::prep_push; None data = the
    object was deleted)."""

    TYPE = 20
    pgid: str = ""
    epoch: int = 0
    oid: str = ""
    exists: bool = True
    data: bytes = b""
    attrs: dict = field(default_factory=dict)
    omap: dict = field(default_factory=dict)
    entry_blob: bytes = b""  # the log entry that names this version

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.pgid).u32(self.epoch).string(self.oid)
        e.bool(self.exists).bytes(self.data)
        e.map(
            self.attrs,
            lambda e2, k: e2.string(k),
            lambda e2, v: e2.bytes(v),
        )
        e.map(
            self.omap,
            lambda e2, k: e2.string(k),
            lambda e2, v: e2.bytes(v),
        )
        e.bytes(self.entry_blob)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGPush":
        return cls(
            pgid=d.string(), epoch=d.u32(), oid=d.string(),
            exists=d.bool(), data=d.bytes(),
            attrs=d.map(lambda d2: d2.string(), lambda d2: d2.bytes()),
            omap=d.map(lambda d2: d2.string(), lambda d2: d2.bytes()),
            entry_blob=d.bytes(),
        )


@register_message
@dataclass
class MPGPushReply(Message):
    TYPE = 21
    from_osd: int = 0
    ok: bool = True

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.from_osd).bool(self.ok)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGPushReply":
        return cls(from_osd=d.s32(), ok=d.bool())


@register_message
@dataclass
class MWatchNotify(Message):
    """OSD → watcher: a notify fired on an object you watch
    (MWatchNotify); the client acks with MWatchNotifyAck carrying the
    same notify_id."""

    TYPE = 26
    oid: str = ""
    notify_id: int = 0
    cookie: int = 0  # the watcher's registration cookie
    payload: bytes = b""

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.oid).u64(self.notify_id).u64(self.cookie)
        e.bytes(self.payload)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MWatchNotify":
        return cls(
            oid=d.string(), notify_id=d.u64(), cookie=d.u64(),
            payload=d.bytes(),
        )


@register_message
@dataclass
class MWatchNotifyAck(Message):
    TYPE = 27
    notify_id: int = 0
    cookie: int = 0
    reply: bytes = b""

    def encode_payload(self, e: Encoder) -> None:
        e.u64(self.notify_id).u64(self.cookie).bytes(self.reply)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MWatchNotifyAck":
        return cls(
            notify_id=d.u64(), cookie=d.u64(), reply=d.bytes()
        )


# -- lossless-peer sessions (ProtocolV2 session reconnect/replay) ----------


@register_message
@dataclass
class MSessionOpen(Message):
    """Session handshake (ProtocolV2 RECONNECT frame role): names the
    logical session and reports the sender's last received seq so the
    peer can prune acked messages and replay the rest."""

    TYPE = 28
    session: str = ""
    last_in_seq: int = 0
    # dialer incarnation id: a changed nonce tells the acceptor the
    # client's session state reset (fresh daemon), so stale in_seq
    # must not dedup-drop the new incarnation's messages
    nonce: str = ""

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.session).u64(self.last_in_seq)
        e.string(self.nonce)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MSessionOpen":
        return cls(
            session=d.string(), last_in_seq=d.u64(),
            nonce=d.string(),
        )


@register_message
@dataclass
class MSessionData(Message):
    """Seq-stamped envelope: ``inner`` is a complete message frame.
    The receiver drops seq <= its in_seq (redelivery after replay)
    and otherwise processes the inner frame as if it arrived bare."""

    TYPE = 29
    seq: int = 0
    inner: bytes = b""

    def encode_payload(self, e: Encoder) -> None:
        e.u64(self.seq).bytes(self.inner)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MSessionData":
        return cls(seq=d.u64(), inner=d.bytes())


@register_message
@dataclass
class MSessionAck(Message):
    """Cumulative ack (bounds the sender's replay buffer); with
    ``nack`` set it reports a sequence GAP — the receiver saw a seq
    beyond last_in_seq+1 — and the sender must resend everything
    after last_in_seq in order."""

    TYPE = 30
    session: str = ""
    last_in_seq: int = 0
    nack: bool = False

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.session).u64(self.last_in_seq)
        e.bool(self.nack)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MSessionAck":
        return cls(
            session=d.string(), last_in_seq=d.u64(), nack=d.bool()
        )


# election ops (Elector.cc / ElectionLogic.cc roles)
ELECT_PROPOSE = 0
ELECT_ACK = 1
ELECT_VICTORY = 2


@register_message
@dataclass
class MMonElection(Message):
    """Monitor election (MMonElection): PROPOSE carries the
    candidate's (last_committed, rank) so peers defer to the most
    up-to-date, lowest-rank candidate; ACK endorses a proposal epoch;
    VICTORY announces the leader + quorum."""

    TYPE = 24
    op: int = ELECT_PROPOSE
    epoch: int = 0
    rank: int = -1
    last_committed: int = 0
    quorum: list = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.u8(self.op).u32(self.epoch).s32(self.rank)
        e.u64(self.last_committed)
        e.list(self.quorum, lambda e2, r: e2.s32(r))

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonElection":
        return cls(
            op=d.u8(), epoch=d.u32(), rank=d.s32(),
            last_committed=d.u64(),
            quorum=d.list(lambda d2: d2.s32()),
        )


# paxos ops (Paxos.cc collect/begin/accept/commit/lease)
PAXOS_COLLECT = 0
PAXOS_LAST = 1
PAXOS_BEGIN = 2
PAXOS_ACCEPT = 3
PAXOS_COMMIT = 4
PAXOS_LEASE = 5
PAXOS_SYNC = 6  # lagging peon asks the leader for missing commits


@register_message
@dataclass
class MMonPaxos(Message):
    """Paxos round message (MMonPaxos): ``epoch`` is the election
    epoch guarding against deposed leaders (the pn role), ``version``
    the map epoch being proposed/committed.  ``entries`` carries
    catch-up runs of (version, inc_blob, full_blob)."""

    TYPE = 25
    op: int = PAXOS_COLLECT
    epoch: int = 0
    version: int = 0
    last_committed: int = 0
    ok: bool = True
    rank: int = -1
    inc_blob: bytes = b""
    full_blob: bytes = b""
    entries: list = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.u8(self.op).u32(self.epoch).u64(self.version)
        e.u64(self.last_committed).bool(self.ok).s32(self.rank)
        e.bytes(self.inc_blob).bytes(self.full_blob)
        e.u32(len(self.entries))
        for v, inc, full in self.entries:
            e.u64(v).bytes(inc).bytes(full)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMonPaxos":
        msg = cls(
            op=d.u8(), epoch=d.u32(), version=d.u64(),
            last_committed=d.u64(), ok=d.bool(), rank=d.s32(),
            inc_blob=d.bytes(), full_blob=d.bytes(),
        )
        for _ in range(d.u32()):
            msg.entries.append((d.u64(), d.bytes(), d.bytes()))
        return msg


@register_message
@dataclass
class MPGActivate(Message):
    """Primary → peer: peering finished — rewind divergent entries
    past ``rewind_to``, adopt the authoritative log suffix, go active
    (the MOSDPGLog activation message with the merge_log divergence
    point)."""

    TYPE = 22
    pgid: str = ""
    epoch: int = 0
    info_blob: bytes = b""  # primary's (authoritative) info
    rewind_to: tuple = (0, 0)  # newest version shared with the auth log
    entry_blobs: list = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.pgid).u32(self.epoch).bytes(self.info_blob)
        e.u32(self.rewind_to[0]).u64(self.rewind_to[1])
        e.list(self.entry_blobs, lambda e2, b: e2.bytes(b))

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGActivate":
        return cls(
            pgid=d.string(), epoch=d.u32(), info_blob=d.bytes(),
            rewind_to=(d.u32(), d.u64()),
            entry_blobs=d.list(lambda d2: d2.bytes()),
        )


@register_message
@dataclass
class MPGPull(Message):
    """Recovering primary → authoritative peer: send me this object
    (the pull side of recovery, ReplicatedBackend::prepare_pull);
    answered by a tid-paired MPGPush.  For erasure pools ``shard`` is
    the requester's acting-set position — the server reconstructs that
    shard's bytes (ECBackend recovery reads); -1 = whole object
    (replicated pools)."""

    TYPE = 23
    pgid: str = ""
    epoch: int = 0
    oid: str = ""
    shard: int = -1

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.pgid).u32(self.epoch).string(self.oid)
        e.s32(self.shard)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGPull":
        return cls(
            pgid=d.string(), epoch=d.u32(), oid=d.string(),
            shard=d.s32(),
        )


@register_message
@dataclass
class MClientRequest(Message):
    """FS client → MDS metadata op (MClientRequest: op name + JSON
    args; src/messages/MClientRequest.h role).  ``reqid`` lets the
    session dedup retries across reconnects."""

    TYPE = 40
    op: str = ""
    args: str = "{}"
    reqid: str = ""

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.op).string(self.args).string(self.reqid)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MClientRequest":
        return cls(op=d.string(), args=d.string(), reqid=d.string())


@register_message
@dataclass
class MClientReply(Message):
    """MDS → client op reply (MClientReply role)."""

    TYPE = 41
    rc: int = 0
    outs: str = ""
    outb: str = "{}"

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.rc).string(self.outs).string(self.outb)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MClientReply":
        return cls(rc=d.s32(), outs=d.string(), outb=d.string())


@register_message
@dataclass
class MClientCaps(Message):
    """Capability traffic between MDS and client (MClientCaps role):
    the MDS revokes a session's cap on an inode before a conflicting
    mutation commits; the client invalidates its cached state and
    acks on the same tid."""

    TYPE = 42
    action: str = ""  # "revoke" | "ack"
    ino: int = 0

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.action).s64(self.ino)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MClientCaps":
        return cls(action=d.string(), ino=d.s64())


@register_message
@dataclass
class MRecoveryReserve(Message):
    """Two-sided recovery/backfill reservation handshake
    (src/messages/MRecoveryReserve.h + MBackfillReserve.h, the
    doc/dev/osd_internals/backfill_reservation.rst protocol): the
    primary REQUESTs a slot at the replica before pushing, the
    replica GRANTs or DENYs against its own osd_max_backfills cap,
    and a RELEASE returns the slot when recovery finishes (or
    fails).  Denied primaries retry on a later tick instead of
    overrunning a busy peer."""

    TYPE = 44
    op: str = ""  # "request" | "grant" | "deny" | "release"
    pgid: str = ""
    epoch: int = 0
    from_osd: int = -1

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.op).string(self.pgid)
        e.u32(self.epoch).s64(self.from_osd)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MRecoveryReserve":
        return cls(
            op=d.string(), pgid=d.string(), epoch=d.u32(),
            from_osd=d.s64(),
        )


@register_message
@dataclass
class MMgrReport(Message):
    """Daemon → mgr perf-counter report (src/messages/MMgrReport.h
    role): the daemon name plus a JSON perf dump, pushed on the
    daemon's tick so the mgr's stats plane sees live counters.

    ``spans`` piggybacks the daemon's drained trace spans (a JSON
    list, common/tracing.py shape) on the same report — the mgr
    ``tracing`` module ingests them, so distributed tracing rides the
    existing stats plane instead of needing its own session.

    ``crashes`` piggybacks pending crash reports (a JSON list,
    common/crash.py shape) the same way — the mgr ``crash`` module
    ingests them and raises RECENT_CRASH."""

    TYPE = 43
    daemon: str = ""
    perf: str = "{}"
    spans: str = "[]"
    crashes: str = "[]"

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.daemon).string(self.perf).string(self.spans)
        e.string(self.crashes)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MMgrReport":
        return cls(
            daemon=d.string(), perf=d.string(), spans=d.string(),
            # versioned-decode tolerance: frames from before the
            # crash plane carry no 4th string
            crashes=d.string() if d.remaining() else "[]",
        )


@register_message
@dataclass
class MRepScrub(Message):
    """Primary → acting-set member scrub traffic (the MOSDRepScrub +
    scrub-reservation roles, src/messages/MOSDRepScrub.h and the
    ScrubReserver handshake):

    - ``op="reserve"``/``"release"``: the osd_max_scrubs reservation
      handshake — the replica grants or denies a scrub slot against
      its own cap before the primary starts digesting chunks.
    - ``op="ls"``: list this PG's object names, so the primary scrubs
      objects it has itself lost.
    - ``op="scan"``: build a digest map over ``oids`` (size + omap +
      xattr digests; payload crc32c when ``deep``) — the MOSDRepScrub
      → ScrubMap round, answered by MScrubMap."""

    TYPE = 46
    op: str = "scan"  # reserve | release | ls | scan
    pgid: str = ""
    epoch: int = 0
    from_osd: int = -1
    deep: bool = False
    oids: list = field(default_factory=list)

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.op).string(self.pgid).u32(self.epoch)
        e.s32(self.from_osd).bool(self.deep)
        e.list(self.oids, lambda e2, o: e2.string(o))

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MRepScrub":
        return cls(
            op=d.string(), pgid=d.string(), epoch=d.u32(),
            from_osd=d.s32(), deep=d.bool(),
            oids=d.list(lambda d2: d2.string()),
        )


@register_message
@dataclass
class MScrubMap(Message):
    """Acting-set member → primary scrub answer (the ScrubMap carry
    of MOSDRepScrubMap): ``map_json`` is the JSON digest map for
    ``scan`` (oid → {size, omap_digest, attrs_digest, data_digest,
    hinfo}), the JSON name list for ``ls``, and empty for the
    reservation verdicts, where ``ok`` is grant/deny."""

    TYPE = 47
    pgid: str = ""
    from_osd: int = -1
    ok: bool = True
    error: str = ""
    map_json: str = ""

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.pgid).s32(self.from_osd).bool(self.ok)
        e.string(self.error).string(self.map_json)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MScrubMap":
        return cls(
            pgid=d.string(), from_osd=d.s32(), ok=d.bool(),
            error=d.string(), map_json=d.string(),
        )


@register_message
@dataclass
class MScrubCommand(Message):
    """Client/CLI → primary OSD scrub-plane command (the path `ceph
    pg (deep-)scrub`, `ceph pg repair`, and `rados
    list-inconsistent-obj` take after the mon names the primary —
    the mgr→OSD scrub order of DaemonServer::handle_command).
    Answered with an MMonCommandReply (rc/outs/outb)."""

    TYPE = 48
    op: str = "scrub"  # scrub | deep-scrub | repair | list-inconsistent-obj
    pgid: str = ""

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.op).string(self.pgid)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MScrubCommand":
        return cls(op=d.string(), pgid=d.string())


@register_message
@dataclass
class MLog(Message):
    """Daemon → mon cluster-log batch (src/messages/MLog.h): the
    LogClient's drained entries (common/log_client.py shape, a JSON
    list) bound for the monitor's LogMonitor store, where they become
    ``ceph log last``."""

    TYPE = 45
    name: str = ""  # sending daemon identity
    entries: str = "[]"

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.name).string(self.entries)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MLog":
        return cls(name=d.string(), entries=d.string())


# MOSDBackoff ops (src/messages/MOSDBackoff.h CEPH_OSD_BACKOFF_OP_*)
BACKOFF_OP_BLOCK = "block"
BACKOFF_OP_UNBLOCK = "unblock"


@register_message
@dataclass
class MOSDBackoff(Message):
    """OSD → client backoff protocol (src/messages/MOSDBackoff.h +
    the Backoff struct of src/osd/osd_types.h): when a PG cannot take
    an op (peering after a partition, OSD full), the OSD answers the
    op with a tid-paired BLOCK — the Objecter PARKS every op bound
    for that PG instead of hammering resends — and later sends an
    un-paired UNBLOCK (same pgid + id) that releases them.  ``reason``
    ("peering" | "full") is advisory, for dump_backoffs."""

    TYPE = 49
    op: str = BACKOFF_OP_BLOCK
    pgid: str = ""
    id: int = 0
    reason: str = ""
    epoch: int = 0

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.op).string(self.pgid).u64(self.id)
        e.string(self.reason).u32(self.epoch)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MOSDBackoff":
        return cls(
            op=d.string(), pgid=d.string(), id=d.u64(),
            reason=d.string(), epoch=d.u32(),
        )


@register_message
@dataclass
class MCommand(Message):
    """CLI → daemon command (src/messages/MCommand.h): the `ceph
    tell <daemon> ...` surface — the mon resolves the daemon's
    address, the CLI dispatches the JSON command dict here, and the
    daemon answers with MMonCommandReply.  Carries the fault-plane
    commands (`fault set/clear/list`) and `dump_backoffs`."""

    TYPE = 50
    cmd: str = "{}"

    def encode_payload(self, e: Encoder) -> None:
        e.string(self.cmd)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MCommand":
        return cls(cmd=d.string())


@register_message
@dataclass
class MPGStats(Message):
    """OSD → mgr per-PG statistics (src/messages/MPGStats.h): every
    stat-report tick the OSD sends the PG-stat dicts for the PGs it
    leads (state string, object/byte counts, degraded / misplaced /
    unfound accounting, recovery watermark) plus any in-flight
    progress events (scrub/repair chunks).  ``stats`` and ``events``
    are JSON lists — the mgr folds them into the PGMap digest it
    pushes to the mon."""

    TYPE = 51
    osd: int = 0
    epoch: int = 0
    stats: str = "[]"
    events: str = "[]"

    def encode_payload(self, e: Encoder) -> None:
        e.s32(self.osd).u32(self.epoch)
        e.string(self.stats).string(self.events)

    @classmethod
    def decode_payload(cls, d: Decoder) -> "MPGStats":
        return cls(
            osd=d.s32(), epoch=d.u32(),
            stats=d.string(), events=d.string(),
        )
