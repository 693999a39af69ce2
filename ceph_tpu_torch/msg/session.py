"""Lossless-peer sessions — reconnect + replay over the messenger
(src/msg/async/ProtocolV2.cc session reconnect; src/msg/Policy.h
lossless_peer).

The reference's OSD↔OSD connections are *lossless peers*: a dropped
TCP connection is re-established and every message sent but not yet
acknowledged is replayed, with the receive side deduplicating by
sequence number — senders never observe the drop.  This module
renders that contract over the framework messenger without touching
the frame format:

- ``SessionConnection`` (the dialer half) owns what a raw Connection
  owns per-socket — the tid→future pending map, the send queue — plus
  the session state: out_seq, the unacked replay buffer, in_seq.
  TCP connections underneath are disposable transports: every
  send/call lazily (re)dials, performs the MSessionOpen handshake
  (exchanging last-received seqs), prunes acked messages, and replays
  the remainder.  Payload messages ride seq-stamped MSessionData
  envelopes.
- ``SessionService`` (the acceptor half) is registered FIRST on the
  server messenger's dispatcher chain.  It keeps per-session state
  (in_seq, its own out_seq + unacked buffer, the live socket),
  unwraps inbound envelopes (dropping seq <= in_seq — redelivered
  duplicates), and hands the inner message to the ordinary dispatcher
  chain wrapped in a ``_SessionPeerConn`` whose ``send`` re-wraps
  replies in the session's own envelopes so they replay too.
- Cumulative ``MSessionAck``s flow every ACK_EVERY messages in both
  directions to bound the replay buffers.

The exactly-once write guarantee this buys: a repop whose TCP
connection dies mid-flight is replayed to the replica (which dedups
if it already applied it) and the reply is replayed to the primary —
no -EAGAIN storm, no client-visible retry.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time

from .message import (
    Message,
    MessageError,
    MSessionAck,
    MSessionData,
    MSessionOpen,
)
from .messenger import Connection, Dispatcher, Messenger

ACK_EVERY = 16
_CALL_TIMEOUT = 30.0


def _parse_inner(blob: bytes) -> Message:
    """Decode one complete inner frame (header+crc+payload+crc)."""
    hdr = blob[: Message.HEADER_SIZE]
    mtype, tid, plen = Message.parse_header(hdr)
    body = blob[Message.HEADER_SIZE :]
    payload, crc = body[:plen], int.from_bytes(
        body[plen : plen + 4], "little"
    )
    return Message.from_payload(mtype, tid, payload, crc)


class _SessionState:
    """One direction-agnostic session endpoint's bookkeeping."""

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.RLock()
        self.out_seq = 0
        self.in_seq = 0
        self.unacked: list[tuple[int, bytes]] = []  # (seq, inner frame)
        self.since_ack = 0

    def send_wrapped(self, msg: Message, conn, new_tid) -> None:
        """Assign the seq and SCHEDULE the frame under one lock: the
        cumulative-seq dedup on the receive side requires FIFO, and
        concurrent senders that assigned seqs separately from the
        socket write could put a higher seq on the wire first — the
        reordered lower seq would then be dropped as a duplicate
        forever.  ``conn.send`` only schedules onto the loop (FIFO),
        so holding the lock across it is cheap."""
        if msg.tid == 0:
            msg.tid = new_tid()
        with self.lock:
            self.out_seq += 1
            seq = self.out_seq
            inner = msg.to_frame()
            self.unacked.append((seq, inner))
            if conn is not None:
                env = MSessionData(
                    tid=new_tid(), seq=seq, inner=inner
                )
                try:
                    conn.send(env)
                except (MessageError, OSError):
                    pass  # in unacked: replays on reconnect

    def prune(self, acked_seq: int) -> None:
        with self.lock:
            self.unacked = [
                (s, f) for (s, f) in self.unacked if s > acked_seq
            ]

    GAP = object()  # sentinel: out-of-order arrival, NACK needed

    def accept(self, env: MSessionData):
        """STRICT in-order acceptance: exactly in_seq+1 advances; a
        duplicate returns None; a gap returns GAP (the receiver never
        skips a seq — a skipped message could only be recovered by a
        reconnect that might never come)."""
        with self.lock:
            if env.seq <= self.in_seq:
                return None
            if env.seq > self.in_seq + 1:
                return self.GAP
            self.in_seq = env.seq
            self.since_ack += 1
        return _parse_inner(env.inner)

    def should_ack(self) -> bool:
        with self.lock:
            if self.since_ack >= ACK_EVERY:
                self.since_ack = 0
                return True
        return False

    def resend_after(self, acked_seq: int, conn, new_tid) -> None:
        """NACK recovery: prune then re-send the rest in order."""
        with self.lock:
            self.unacked = [
                (s, f) for (s, f) in self.unacked if s > acked_seq
            ]
            if conn is None:
                return
            for seq, inner in self.unacked:
                try:
                    conn.send(
                        MSessionData(
                            tid=new_tid(), seq=seq, inner=inner
                        )
                    )
                except (MessageError, OSError):
                    return


class SessionConnection:
    """Dialer half: the Connection API (send/call) surviving TCP
    drops with replay.  One instance per (messenger, peer, name)."""

    def __init__(
        self, msgr: Messenger, host: str, port: int, name: str
    ):
        import os

        self.msgr = msgr
        self.host, self.port = host, int(port)
        self.name = name
        self.nonce = os.urandom(8).hex()
        self._server_nonce: str | None = None
        self.state = _SessionState(name)
        self._conn: Connection | None = None
        self._dial_lock = threading.RLock()
        self._pending: dict[int, concurrent.futures.Future] = {}
        self._plock = threading.Lock()
        self._closed = False
        # proactive reconnect state: one redial attempt in flight at
        # a time, kicked by the transport's reset notification
        self._redial_lock = threading.Lock()
        self._redialing = False

    # -- Connection API ----------------------------------------------------
    @property
    def is_closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True
        with self._dial_lock:
            if self._conn is not None:
                self._conn.close()

    def send(self, msg: Message) -> None:
        try:
            conn = self._ensure()
        except (MessageError, OSError):
            conn = None  # queued in unacked: replays on reconnect
        self.state.send_wrapped(msg, conn, self.msgr.new_tid)

    def call(
        self, msg: Message, timeout: float = _CALL_TIMEOUT
    ) -> Message:
        if msg.tid == 0:
            msg.tid = self.msgr.new_tid()
        # fail fast when the peer is unreachable NOW and no session
        # socket survives — a dead peer must behave like a dead raw
        # connection for the caller's failure handling (the map-driven
        # re-peer paths), not burn the whole call timeout
        conn = None
        try:
            conn = self._ensure()
        except (MessageError, OSError):
            if self._conn is None or self._conn.is_closed:
                raise
        cf: concurrent.futures.Future = concurrent.futures.Future()
        with self._plock:
            self._pending[msg.tid] = cf
        deadline = time.monotonic() + timeout
        try:
            self.state.send_wrapped(msg, conn, self.msgr.new_tid)
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise MessageError(
                        f"session call tid={msg.tid} timed out"
                    )
                try:
                    return cf.result(min(0.1, remaining))
                except concurrent.futures.TimeoutError:
                    # reconnect only when the socket actually died —
                    # the handshake replays the request AND the reply
                    conn = self._conn
                    if conn is None or conn.is_closed:
                        try:
                            self._ensure()
                        except (MessageError, OSError):
                            time.sleep(0.05)
        finally:
            with self._plock:
                self._pending.pop(msg.tid, None)

    # -- transport management ----------------------------------------------
    def _ensure(self) -> Connection:
        with self._dial_lock:
            if self._closed:
                raise MessageError("session closed")
            if self._conn is not None and not self._conn.is_closed:
                return self._conn
            conn = self.msgr.connect(self.host, self.port)
            reply = conn.call(
                MSessionOpen(
                    session=self.name,
                    last_in_seq=self.state.in_seq,
                    nonce=self.nonce,
                ),
                timeout=2.0,
            )
            if not isinstance(reply, MSessionOpen):
                conn.close()
                raise MessageError("bad session handshake reply")
            first_contact = self._server_nonce is None
            if reply.nonce != self._server_nonce:
                # a NEW server incarnation: reset the dedup floor AND
                # renumber our own unacked backlog from seq 1 — a
                # fresh server expects 1, and replaying the old high
                # seqs would GAP/NACK forever
                self._server_nonce = reply.nonce
                with self.state.lock:
                    self.state.in_seq = 0
                    if not first_contact:
                        self.state.unacked = [
                            (i + 1, frame)
                            for i, (_s, frame) in enumerate(
                                self.state.unacked
                            )
                        ]
                        self.state.out_seq = len(self.state.unacked)
            self.state.prune(reply.last_in_seq)
            # hold the seq lock across the whole replay so a
            # concurrent new send cannot interleave a higher seq
            # ahead of the replayed ones
            with self.state.lock:
                for seq, inner in self.state.unacked:
                    conn.send(
                        MSessionData(
                            tid=self.msgr.new_tid(),
                            seq=seq,
                            inner=inner,
                        )
                    )
                self._conn = conn
            self.msgr.session_client_register(conn, self)
            return conn

    def on_transport_reset(self) -> None:
        """Event-driven reconnect (the replay-window determinism
        fix): the instant the transport dies with work outstanding —
        unacked frames to replay or calls awaiting replies — redial,
        re-handshake and replay ONCE, off the messenger loop.  The
        replay window is then exactly the death-to-redial handshake,
        not however long the caller's poll loop took to notice; each
        death triggers exactly one immediate replay attempt, and a
        failed attempt (peer really down) leaves recovery to the
        callers' retry loops as before."""
        if self._closed:
            return
        with self._plock:
            has_pending = bool(self._pending)
        if not has_pending and not self.state.unacked:
            return
        with self._redial_lock:
            if self._redialing:
                return
            self._redialing = True
        stack = self.msgr._stack

        def _redial():
            try:
                if not self._closed:
                    self._ensure()
            except (MessageError, OSError):
                pass
            finally:
                with self._redial_lock:
                    self._redialing = False

        if stack is not None:
            stack.offload.submit(_redial)
        else:  # messenger already torn down
            with self._redial_lock:
                self._redialing = False

    # -- inbound (called by the messenger's session dispatcher) -----------
    def handle_envelope(self, conn: Connection, env: MSessionData):
        msg = self.state.accept(env)
        if msg is _SessionState.GAP:
            # a seq went missing (e.g. scheduled onto a socket that
            # died mid-write): NACK so the peer resends in order
            try:
                conn.send(
                    MSessionAck(
                        tid=self.msgr.new_tid(),
                        session=self.name,
                        last_in_seq=self.state.in_seq,
                        nack=True,
                    )
                )
            except (MessageError, OSError):
                pass
            return
        if self.state.should_ack():
            try:
                conn.send(
                    MSessionAck(
                        tid=self.msgr.new_tid(),
                        session=self.name,
                        last_in_seq=self.state.in_seq,
                    )
                )
            except (MessageError, OSError):
                pass
        if msg is None:
            return
        with self._plock:
            fut = self._pending.get(msg.tid)
        if fut is not None:
            if fut.set_running_or_notify_cancel():
                fut.set_result(msg)
            return
        # not a reply: hand to the normal dispatcher chain with THIS
        # session as the reply path
        self.msgr._dispatch(_SessionPeerConn(self), msg)

    def handle_ack(self, ack: MSessionAck) -> None:
        if ack.nack:
            self.state.resend_after(
                ack.last_in_seq, self._conn, self.msgr.new_tid
            )
        else:
            self.state.prune(ack.last_in_seq)


class _SessionPeerConn:
    """The 'conn' handed to dispatchers for session traffic: replies
    ride the session (wrapped + replayable), not the raw socket."""

    def __init__(self, endpoint):
        self._ep = endpoint
        self.is_closed = False
        self._closed = False

    def send(self, msg: Message) -> None:
        self._ep.send(msg)

    def call(self, msg: Message, timeout: float = _CALL_TIMEOUT):
        return self._ep.call(msg, timeout)


class _ServerSession:
    """Acceptor half of one named session."""

    def __init__(self, svc: "SessionService", name: str):
        import os

        self.svc = svc
        self.name = name
        self.state = _SessionState(name)
        self.conn: Connection | None = None  # live socket
        self.nonce = ""
        self.my_nonce = os.urandom(8).hex()
        self._pending: dict[int, concurrent.futures.Future] = {}
        self._plock = threading.Lock()

    def send(self, msg: Message) -> None:
        conn = self.conn
        if conn is not None and conn.is_closed:
            conn = None  # replays when the dialer reconnects
        self.state.send_wrapped(
            msg, conn, self.svc.msgr.new_even_tid
        )

    def call(
        self, msg: Message, timeout: float = _CALL_TIMEOUT
    ) -> Message:
        if msg.tid == 0:
            msg.tid = self.svc.msgr.new_even_tid()
        cf: concurrent.futures.Future = concurrent.futures.Future()
        with self._plock:
            self._pending[msg.tid] = cf
        try:
            self.send(msg)
            return cf.result(timeout)
        except concurrent.futures.TimeoutError as e:
            raise MessageError(
                f"session call tid={msg.tid} timed out"
            ) from e
        finally:
            with self._plock:
                self._pending.pop(msg.tid, None)

    def handle_open(self, conn: Connection, msg: MSessionOpen):
        self.conn = conn
        if conn.peer_label is None and "-" in msg.session:
            # session names are "<dialer>-<peer id>" (osd._peer_conn):
            # stamp the dialer's identity so directional fault rules
            # match this accepted connection's replies too
            conn.peer_label = msg.session.rsplit("-", 1)[0]
        if msg.nonce != self.nonce:
            # a NEW dialer incarnation: BOTH seq spaces restart from
            # zero (keeping the old out_seq would make every reply a
            # permanent GAP against the fresh dialer's in_seq=0 — an
            # infinite NACK/resend loop) and the unacked backlog
            # belongs to a dead peer state
            self.nonce = msg.nonce
            with self.state.lock:
                self.state.in_seq = 0
                self.state.out_seq = 0
                self.state.unacked = []
        self.state.prune(msg.last_in_seq)
        conn.send(
            MSessionOpen(
                tid=msg.tid,  # tid-paired handshake reply
                session=self.name,
                last_in_seq=self.state.in_seq,
                nonce=self.my_nonce,
            )
        )
        # replay under the seq lock so no concurrent send interleaves
        # a newer seq ahead of the replayed backlog
        with self.state.lock:
            for seq, inner in self.state.unacked:
                conn.send(
                    MSessionData(
                        tid=self.svc.msgr.new_even_tid(),
                        seq=seq,
                        inner=inner,
                    )
                )

    def handle_envelope(self, conn: Connection, env: MSessionData):
        self.conn = conn
        inner = self.state.accept(env)
        if inner is _SessionState.GAP:
            try:
                conn.send(
                    MSessionAck(
                        tid=self.svc.msgr.new_even_tid(),
                        session=self.name,
                        last_in_seq=self.state.in_seq,
                        nack=True,
                    )
                )
            except (MessageError, OSError):
                pass
            return
        if self.state.should_ack():
            try:
                conn.send(
                    MSessionAck(
                        tid=self.svc.msgr.new_even_tid(),
                        session=self.name,
                        last_in_seq=self.state.in_seq,
                    )
                )
            except (MessageError, OSError):
                pass
        if inner is None:
            return
        with self._plock:
            fut = self._pending.get(inner.tid)
        if fut is not None:
            if fut.set_running_or_notify_cancel():
                fut.set_result(inner)
            return
        self.svc.msgr._dispatch(_SessionPeerConn(self), inner)


class SessionService(Dispatcher):
    """Acceptor-side session registry; registered first on the
    dispatcher chain by Messenger.__init__ so envelopes never reach
    application dispatchers raw."""

    def __init__(self, msgr: Messenger):
        self.msgr = msgr
        self._sessions: dict[str, _ServerSession] = {}
        self._by_conn: dict[int, object] = {}  # id(conn) → endpoint
        self._lock = threading.Lock()

    def client_register(self, conn: Connection, sc) -> None:
        with self._lock:
            self._by_conn[id(conn)] = sc

    def _session(self, name: str) -> _ServerSession:
        with self._lock:
            s = self._sessions.get(name)
            if s is None:
                s = self._sessions[name] = _ServerSession(self, name)
            return s

    def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MSessionOpen):
            s = self._session(msg.session)
            with self._lock:
                self._by_conn[id(conn)] = s
            s.handle_open(conn, msg)
            return True
        if isinstance(msg, MSessionData):
            with self._lock:
                ep = self._by_conn.get(id(conn))
            if ep is None:
                return True  # stray envelope on an unknown socket
            ep.handle_envelope(conn, msg)
            return True
        if isinstance(msg, MSessionAck):
            with self._lock:
                ep = self._by_conn.get(id(conn))
            if ep is not None:
                if isinstance(ep, _ServerSession):
                    if msg.nack:
                        ep.state.resend_after(
                            msg.last_in_seq, ep.conn,
                            self.msgr.new_even_tid,
                        )
                    else:
                        ep.state.prune(msg.last_in_seq)
                else:
                    ep.handle_ack(msg)
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        with self._lock:
            ep = self._by_conn.pop(id(conn), None)
        # a dialer-side endpoint reconnects/replays NOW rather than
        # waiting for a caller's poll to notice the dead socket
        kick = getattr(ep, "on_transport_reset", None)
        if kick is not None:
            kick()
