"""AsyncMessenger — asyncio connection fabric behind the Messenger
contract (src/msg/Messenger.h:89,393-425; src/msg/async/AsyncMessenger.h).

A Messenger is a lightweight façade over the process-wide
``NetworkStack`` (msg/stack.py — the reference's NetworkStack/Worker
pool): at ``start()`` it checks out ONE shared event-loop worker by
least-connections, and every listener, connection, read loop and
timer of this messenger then multiplexes onto that worker's loop
alongside other daemons' messengers.  ``bind()`` starts a TCP
listener; ``connect()`` dials out.  Both directions speak the same
framed protocol (message.py): a fixed banner exchange, then
crc-framed typed messages.

Dispatch mirrors the reference: inbound messages walk the dispatcher
chain until one claims the type (ms_dispatch); connection teardown
notifies ms_handle_reset.  RPC-style request/reply (the sub-op
pattern) is provided by ``Connection.call`` — the reply is paired by
tid, exactly how ECBackend matches sub-op replies to in-flight ops.

Because the loop is SHARED, dispatch never runs on it: inbound
messages (and reset notifications) drain FIFO through a per-messenger
serial strand on the stack's elastic offload pool — a blocking
handler stalls only its own messenger's queue, never a worker, and
nested blocking RPC from handlers (which would deadlock a read loop
waiting on itself) is safe.  Tid-paired ``call`` replies resolve
directly on the read loop and never wait behind dispatch.

The API is synchronous on purpose: callers (stores, daemons, tests)
are plain Python; every sync call marshals onto the worker loop via
``run_coroutine_threadsafe``.  Per-messenger single-loop affinity is
what keeps the FaultInjector's seeded RNG single-threaded, so chaos
decision streams replay byte-identically on the shared stack.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import os
import threading
import time
import weakref

from .faults import FaultInjector
from .message import Message, MessageError
from .stack import NetworkStack

BANNER = b"ceph-tpu-msgr/2\n"
_CALL_TIMEOUT = 30.0
# bounded inbound dispatch queue (the ms_dispatch_throttle_bytes
# role, counted in messages): when a messenger's dispatch-strand
# backlog reaches the high watermark its socket reads PAUSE — TCP
# flow control pushes back on the senders — and resume once the
# strand drains to the low watermark.  Messages are never dropped;
# stalls are counted (l_msgr_dispatch_queue_stalls).
DISPATCH_QUEUE_HIGH_DEFAULT = 256
# largest ciphertext a peer may announce in secure mode; generous vs
# any legitimate message (multi-MB chunk writes) but far below the
# 4 GiB the u32 prefix could otherwise demand
MAX_FRAME_LEN = 1 << 28


class Dispatcher:
    """The Dispatcher contract (Messenger.h:89): return True from
    ms_dispatch to claim a message."""

    def ms_dispatch(self, conn: "Connection", msg: Message) -> bool:
        raise NotImplementedError

    def ms_handle_reset(self, conn: "Connection") -> None:
        pass


class SecureCtx:
    """Per-connection AEAD state for secure wire mode (the
    ProtocolV2 secure-mode role, src/msg/async/crypto_onwire.cc:1-309,
    with the framework's sha256-CTR+HMAC cipher — CryptoKey, the same
    implementation cephx tickets use — in the AES-GCM seat).

    Keys derive from the cephx session key plus both handshake nonces
    (fresh per connection); each direction gets its own key and an
    implicit strictly-increasing counter — the counter is NOT on the
    wire, so a spliced, replayed, or reordered record fails its MAC
    and drops the connection."""

    def __init__(self, session_key: bytes, challenge: bytes,
                 nonce: bytes, outgoing: bool):
        import hashlib
        import hmac as hmac_mod

        from ..auth.cephx import CryptoKey

        conn_key = hmac_mod.new(
            session_key, b"secure" + challenge + nonce, hashlib.sha256
        ).digest()
        c2s = CryptoKey(
            hmac_mod.new(conn_key, b"c2s", hashlib.sha256).digest()
        )
        s2c = CryptoKey(
            hmac_mod.new(conn_key, b"s2c", hashlib.sha256).digest()
        )
        self._send = c2s if outgoing else s2c
        self._recv = s2c if outgoing else c2s
        self.send_ctr = 0
        self.recv_ctr = 0

    def seal(self, frame: bytes) -> bytes:
        from ..auth.cephx import CryptoKey

        ctr8 = self.send_ctr.to_bytes(8, "little")
        ct = CryptoKey.xor(
            frame, self._send.keystream(ctr8, len(frame))
        )
        clen4 = len(ct).to_bytes(4, "little")
        # the length prefix is part of the MAC'd material: a tampered
        # length cannot steer the receiver even before the tag check
        tag = self._send.hmac(ctr8 + clen4 + ct)
        self.send_ctr += 1
        return clen4 + ct + tag

    def unseal(self, ct: bytes, tag: bytes) -> bytes:
        import hmac as hmac_mod

        from ..auth.cephx import CryptoKey

        ctr8 = self.recv_ctr.to_bytes(8, "little")
        want = self._recv.hmac(
            ctr8 + len(ct).to_bytes(4, "little") + ct
        )
        if not hmac_mod.compare_digest(tag, want):
            raise MessageError(
                "secure frame authentication failed (tampered or "
                "replayed) — dropping connection"
            )
        plain = CryptoKey.xor(
            ct, self._recv.keystream(ctr8, len(ct))
        )
        self.recv_ctr += 1
        return plain


class Connection:
    """One framed peer link (AsyncConnection role)."""

    def __init__(self, msgr: "Messenger", reader, writer, outgoing: bool):
        self.msgr = msgr
        self._reader = reader
        self._writer = writer
        self.outgoing = outgoing
        self.peer_addr = writer.get_extra_info("peername")
        self.peer_entity = ""  # authenticated cephx entity ('' = none)
        # fault-plane destination identity: "host:port" on dialed
        # connections; accepted connections start unlabeled and a
        # higher layer may stamp a daemon name (session handshakes,
        # mon subscriptions) so directional rules can match them
        self.peer_label: str | None = None
        # pending replies are concurrent futures: resolved from the
        # loop thread, awaited from caller threads (thread-safe both
        # ways, unlike asyncio futures)
        self._pending: dict[int, concurrent.futures.Future] = {}
        self._plock = threading.Lock()
        self._closed = False
        self._send_lock = asyncio.Lock()
        self.secure: SecureCtx | None = None

    # -- sync API ----------------------------------------------------------
    def send(self, msg: Message) -> None:
        """Fire-and-forget (Messenger::send_to)."""
        self.msgr._run(self._send(msg))

    def call(
        self, msg: Message, timeout: float = _CALL_TIMEOUT
    ) -> Message:
        """Send and wait for the tid-paired reply (sub-op pattern).
        Raises MessageError on connection loss or timeout.

        Request tids live in direction-disjoint spaces (dialer odd,
        acceptor even) so nested RPC initiated from BOTH ends of one
        socket can never collide in the tid-routed read loops."""
        if msg.tid == 0:
            msg.tid = (
                self.msgr.new_tid()
                if self.outgoing
                else self.msgr.new_even_tid()
            )
        cf: concurrent.futures.Future = concurrent.futures.Future()
        with self._plock:
            if self._closed:
                raise MessageError("connection closed")
            self._pending[msg.tid] = cf
        try:
            self.msgr._run(self._send(msg)).result(timeout)
            return cf.result(timeout)
        except MessageError:
            raise
        except concurrent.futures.TimeoutError as e:
            raise MessageError(f"call tid={msg.tid} timed out") from e
        except (Exception, concurrent.futures.CancelledError) as e:
            # CancelledError is a BaseException; shutdown()'s cancel-all
            # must surface as MessageError in caller threads, not escape
            raise MessageError(
                f"call tid={msg.tid} failed: {type(e).__name__}: {e}"
            ) from e
        finally:
            with self._plock:
                self._pending.pop(msg.tid, None)

    def close(self) -> None:
        if self.msgr._loop is not None and not self._closed:
            self.msgr._run(self._close())

    @property
    def is_closed(self) -> bool:
        return self._closed

    # -- loop-side ---------------------------------------------------------
    async def _send(self, msg: Message) -> None:
        if self._closed:
            raise MessageError("connection closed")
        plan = self.msgr.faults.plan(self)
        if plan.sockfail:
            # legacy ms_inject_socket_failures semantics: tear the
            # connection down instead of transmitting
            await self._close()
            raise MessageError(
                "injected socket failure (ms_inject_socket_failures)"
            )
        if plan.drop:
            return  # netem loss: the frame silently vanishes
        if plan.delay > 0.0:
            # deliver later off a task: ordering vs frames sent in
            # the meantime is deliberately NOT preserved (netem
            # delay/reorder semantics).  Tracked so shutdown cancels
            # it instead of leaving it pending on the SHARED loop.
            self.msgr._spawn(
                self._delayed_send(msg, plan.delay, plan.duplicate)
            )
            return
        await self._write_frame(msg, duplicate=plan.duplicate)

    async def _delayed_send(
        self, msg: Message, delay: float, duplicate: bool
    ) -> None:
        try:
            await asyncio.sleep(delay)
            if not self._closed:
                await self._write_frame(msg, duplicate=duplicate)
        except (asyncio.CancelledError, Exception):  # noqa: BLE001 —
            # a delayed frame racing shutdown/teardown is just lost
            pass

    async def _write_frame(
        self, msg: Message, duplicate: bool = False
    ) -> None:
        # duplication happens at MESSAGE level: each copy is sealed
        # with its own counter in secure mode, so both arrive as
        # valid frames and the receiver's dedup layers really work
        for _ in range(2 if duplicate else 1):
            frame = msg.to_frame()
            async with self._send_lock:
                # seal under the send lock: the implicit counter must
                # match the on-wire record order
                if self.secure is not None:
                    frame = self.secure.seal(frame)
                self._writer.write(frame)
                await self._writer.drain()

    async def _read_loop(self) -> None:
        try:
            while True:
                if self.secure is not None:
                    clen = int.from_bytes(
                        await self._reader.readexactly(4), "little"
                    )
                    # the prefix is plaintext; bound it before
                    # buffering so a tamperer can't force a multi-GiB
                    # allocation or an indefinite readexactly hang
                    # (it is also folded into the MAC, so a forged
                    # length never yields a valid frame)
                    if clen > MAX_FRAME_LEN:
                        raise MessageError(
                            f"secure frame length {clen} exceeds "
                            f"{MAX_FRAME_LEN}"
                        )
                    ct = await self._reader.readexactly(clen)
                    tag = await self._reader.readexactly(32)
                    frame = self.secure.unseal(ct, tag)
                    header = frame[: Message.HEADER_SIZE]
                    mtype, tid, plen = Message.parse_header(header)
                    body = frame[Message.HEADER_SIZE :]
                    if len(body) != plen + 4:
                        raise MessageError("secure frame length")
                else:
                    header = await self._reader.readexactly(
                        Message.HEADER_SIZE
                    )
                    mtype, tid, plen = Message.parse_header(header)
                    if plen > MAX_FRAME_LEN:
                        raise MessageError(
                            f"frame length {plen} exceeds "
                            f"{MAX_FRAME_LEN}"
                        )
                    body = await self._reader.readexactly(plen + 4)
                msg = Message.from_payload(
                    mtype,
                    tid,
                    body[:plen],
                    int.from_bytes(body[plen:], "little"),
                )
                with self._plock:
                    fut = self._pending.pop(tid, None)
                if fut is not None:
                    if not fut.set_running_or_notify_cancel():
                        continue  # caller gave up (timeout)
                    fut.set_result(msg)
                else:
                    self.msgr._dispatch(self, msg)
                    # bounded dispatch queue: past the watermark this
                    # connection stops reading (TCP pushes back on
                    # the peer) until the strand drains — backlog is
                    # bounded without ever dropping a message
                    await self.msgr._maybe_stall_reads()
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            MessageError,
            OSError,
        ):
            pass
        finally:
            await self._close()

    async def _close(self) -> None:
        if self._closed:
            return
        with self._plock:
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            if fut.set_running_or_notify_cancel():
                fut.set_exception(MessageError("connection reset"))
        try:
            self._writer.close()
        except Exception:
            pass
        else:
            # wait for connection_lost so the transport is truly dead
            # before the loop can be closed — an unfinished transport's
            # __del__ would otherwise call close() on the closed loop
            # (an unraisable "Event loop is closed" at pytest teardown)
            try:
                await asyncio.wait_for(
                    self._writer.wait_closed(), 1.0
                )
            except Exception:
                pass
        self.msgr._conn_reset(self)


class Messenger:
    """Messenger::create + bind/start/shutdown lifecycle.

    ``auth_server`` (a CephxServiceHandler) makes inbound connections
    demand a cephx authorizer after the banner; ``auth_client`` (a
    ticket-holding CephxClientHandler) satisfies such demands on
    outbound connections and verifies the server's proof back (mutual
    auth).  Both None = AUTH_NONE, the reference's
    auth_cluster_required=none mode (AuthRegistry negotiation)."""

    # every live messenger, weakly held — the fault-plane janitor
    # (tests/conftest.py) sweeps leaked rules/partitions off every
    # surviving instance between tests so one test's chaos cannot
    # shadow-fail the next
    _live: "weakref.WeakSet[Messenger]" = weakref.WeakSet()

    def __init__(
        self,
        name: str = "client",
        auth_server=None,
        auth_client=None,
        secure: bool = False,
    ):
        if secure and auth_server is None and auth_client is None:
            raise ValueError(
                "secure mode needs cephx (the session key is the "
                "wire key)"
            )
        self.secure = secure
        self.name = name
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stack: NetworkStack | None = None
        self._worker = None  # the checked-out stack Worker
        self._start_lock = threading.Lock()
        # tasks THIS messenger created on the shared loop (read
        # loops, delayed sends, in-flight dials): shutdown cancels
        # exactly these — never another messenger's
        self._tasks: set = set()
        # dispatch-offload strand (created at start)
        self._dispatch_strand = None
        # bounded dispatch queue: backlog accounting + the read gate
        # every read loop of this messenger awaits while stalled
        self._dispatch_high = max(
            1,
            int(
                os.environ.get(
                    "CEPH_TPU_MSGR_DISPATCH_HIGH",
                    DISPATCH_QUEUE_HIGH_DEFAULT,
                )
            ),
        )
        self._dispatch_low = max(1, self._dispatch_high // 2)
        self._dispatch_depth = 0
        self._depth_lock = threading.Lock()
        self._read_gate: asyncio.Event | None = None
        self._shut = False  # shutdown() is terminal
        self._server: asyncio.AbstractServer | None = None
        self._dispatchers: list[Dispatcher] = []
        self._conns: set[Connection] = set()
        self._tid = 0
        self._tid_lock = threading.Lock()
        self.auth_server = auth_server
        self.auth_client = auth_client
        self.bound_addr: tuple[str, int] | None = None
        # lossless-peer sessions (msg/session.py), created lazily
        self._session_service = None
        self._session_conns: dict[tuple, object] = {}
        self._session_lock = threading.Lock()
        # fault-injection plane (msg/faults.py): netem-style rules,
        # partitions, and the legacy ms_inject_socket_failures knob
        self.faults = FaultInjector(name)
        Messenger._live.add(self)

    @property
    def inject_socket_failures(self) -> int:
        """Legacy knob (ms_inject_socket_failures,
        src/common/options.cc:1087): every Nth outbound frame PER
        CONNECTION tears the connection down instead of sending;
        0 = off.  Lives on the FaultInjector so both fault paths
        share one code path and counter set."""
        return self.faults.socket_failure_every

    @inject_socket_failures.setter
    def inject_socket_failures(self, n: int) -> None:
        self.faults.socket_failure_every = max(0, int(n))

    # -- lossless-peer sessions (ProtocolV2 reconnect/replay role) ---------
    def _sessions(self):
        if self._session_service is None:
            from .session import SessionService

            svc = SessionService(self)
            # envelopes must unwrap before application dispatchers
            self._dispatchers.insert(0, svc)
            self._session_service = svc
        return self._session_service

    def connect_session(self, host: str, port: int, name: str):
        """A lossless-peer connection: survives TCP drops, replays
        unacked messages on reconnect (src/msg/Policy.h
        lossless_peer).  One persistent object per (peer, name)."""
        from .session import SessionConnection

        self._sessions()  # inbound replies need the unwrapper
        key = (host, int(port), name)
        with self._session_lock:
            sc = self._session_conns.get(key)
            if sc is None or sc.is_closed:
                sc = SessionConnection(self, host, int(port), name)
                self._session_conns[key] = sc
            return sc

    def session_client_register(self, conn, sc) -> None:
        self._sessions().client_register(conn, sc)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._start_lock:
            if self._worker is not None:
                return
            if self._shut:
                # TERMINAL shutdown: a background reconnect racing
                # teardown must not resurrect this messenger onto a
                # (possibly different) worker — half its state would
                # still be bound to the old loop
                raise MessageError("messenger shut down")
            while True:
                # a stack latching teardown between instance() and
                # checkout() hands back None: retry on the fresh
                # generation instead of adopting a dying loop
                stack = NetworkStack.instance()
                worker = stack.checkout(self)
                if worker is not None:
                    break
            self._stack = stack
            self._worker = worker
            self._loop = worker.loop
            self._dispatch_strand = stack.offload.strand()
            self._read_gate = asyncio.Event()

    # -- shared-loop task bookkeeping --------------------------------------
    def _track(self, task: asyncio.Task) -> None:
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _spawn(self, coro) -> asyncio.Task:
        """create_task + track (loop thread only).  Falls back to
        the running loop when shutdown cleared self._loop under a
        task still in flight — the task is tracked either way, so it
        dies with the worker at the latest."""
        loop = self._loop
        if loop is None:
            loop = asyncio.get_running_loop()
        task = loop.create_task(coro)
        self._track(task)
        return task

    def _run_tracked(self, coro, timeout: float):
        """Run a coroutine on the worker loop as a TRACKED task and
        wait for its result — used for dials/binds so an in-flight
        attempt is cancelled by shutdown() instead of lingering on
        the shared loop."""
        loop = self._loop
        if loop is None:
            coro.close()
            raise MessageError("messenger not started")
        cf: concurrent.futures.Future = concurrent.futures.Future()

        def _schedule():
            task = loop.create_task(coro)
            self._track(task)

            def _transfer(t: asyncio.Task):
                if cf.set_running_or_notify_cancel():
                    try:
                        exc = t.exception()
                    except asyncio.CancelledError:
                        # task cancelled (shutdown raced the dial):
                        # surface a catchable error, not the
                        # BaseException-derived CancelledError
                        exc = MessageError("cancelled by shutdown")
                    if exc is not None:
                        cf.set_exception(exc)
                    else:
                        cf.set_result(t.result())

            task.add_done_callback(_transfer)

        try:
            loop.call_soon_threadsafe(_schedule)
        except RuntimeError as e:  # shared loop stopping under us
            coro.close()
            raise MessageError(f"messenger stopping: {e}") from e
        return cf.result(timeout)

    def bind(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        """Listen; returns the bound (host, port)."""
        if self.secure and self.auth_server is None:
            raise ValueError(
                "secure listener needs auth_server (cephx) — it "
                "would otherwise serve PLAINTEXT despite secure=True"
            )
        self.start()
        self._sessions()  # listeners serve lossless-peer handshakes

        async def _serve():
            self._server = await asyncio.start_server(
                self._accept, host, port
            )
            return self._server.sockets[0].getsockname()[:2]

        self.bound_addr = self._run_tracked(_serve(), 10)
        return self.bound_addr

    def connect(
        self, host: str, port: int, timeout: float = 10.0
    ) -> Connection:
        if self.secure and self.auth_client is None:
            raise MessageError(
                "secure dialer needs auth_client (cephx)"
            )
        self.start()

        async def _dial():
            reader, writer = await asyncio.open_connection(host, port)
            try:
                return await _negotiate(reader, writer)
            except BaseException:
                writer.close()
                raise

        async def _negotiate(reader, writer):
            writer.write(BANNER)
            await writer.drain()
            peer = await reader.readexactly(len(BANNER))
            if peer != BANNER:
                raise MessageError("banner mismatch")
            mode = await reader.readexactly(1)
            if self.secure and mode != b"S":
                # a secure-required dialer refuses the downgrade: an
                # on-path attacker rewriting 'S' to 'A'/'N' must not
                # yield a plaintext session
                raise MessageError(
                    "server did not offer secure mode (downgrade "
                    "refused)"
                )
            if mode in (b"A", b"S"):
                # server demands a cephx authorizer; its 16-byte
                # challenge follows (CEPHX_V2 anti-replay)
                challenge = await reader.readexactly(16)
                if self.auth_client is None:
                    raise MessageError(
                        "server requires cephx auth, no ticket held"
                    )
                blob, nonce = self.auth_client.build_authorizer(challenge)
                writer.write(len(blob).to_bytes(4, "little") + blob)
                await writer.drain()
                plen = int.from_bytes(await reader.readexactly(4), "little")
                if plen == 0:
                    raise MessageError("cephx authorizer rejected")
                proof = await reader.readexactly(plen)
                from ..auth.cephx import AuthError

                try:
                    self.auth_client.verify_server(challenge, nonce, proof)
                except AuthError as e:
                    raise MessageError(f"server auth failed: {e}")
            elif mode != b"N":
                raise MessageError("bad auth negotiation byte")
            conn = Connection(self, reader, writer, outgoing=True)
            conn.peer_label = f"{host}:{port}"
            if mode == b"S":
                conn.secure = SecureCtx(
                    self.auth_client.session.secret,
                    challenge,
                    nonce,
                    outgoing=True,
                )
            if self._shut:
                # a dial landing after shutdown's cancel sweep must
                # not register a connection nobody will ever read or
                # close (the fd would leak until stack teardown)
                writer.close()
                raise MessageError("messenger shut down")
            self._register_conn(conn)
            self._spawn(conn._read_loop())
            return conn

        try:
            return self._run_tracked(_dial(), timeout)
        except MessageError:
            raise
        except (Exception, concurrent.futures.CancelledError) as e:
            raise MessageError(
                f"connect {host}:{port} failed: {e}"
            ) from e

    def shutdown(self) -> None:
        with self._start_lock:
            self._shut = True
            if self._worker is None:
                return

        async def _stop():
            if self._server is not None:
                self._server.close()
            for conn in list(self._conns):
                await conn._close()
            if self._server is not None:
                # after the conns: on 3.12+ wait_closed blocks until
                # every connection handler returns, so waiting first
                # would always eat the full timeout
                try:
                    await asyncio.wait_for(
                        self._server.wait_closed(), 1.0
                    )
                except Exception:
                    pass
            # Cancel what THIS messenger still has in flight (dials
            # that never completed, lingering read loops, delayed
            # fault sends) — the loop is shared, so only our own
            # tracked tasks are fair game.
            me = asyncio.current_task()
            pending = [
                t for t in list(self._tasks)
                if t is not me and not t.done()
            ]
            for t in pending:
                t.cancel()
            if pending:
                # BOUNDED: a task slow to honor its cancellation (a
                # banner-less accepted socket mid-timeout, a wedged
                # transport) must not eat the caller's whole shutdown
                # budget — leftovers are already cancelled and die
                # with the worker at stack teardown
                await asyncio.wait(pending, timeout=5.0)

        try:
            self._run(_stop()).result(10)
        finally:
            with self._start_lock:
                stack, worker = self._stack, self._worker
                self._loop = None
                self._worker = None
                self._stack = None
                self._server = None
            if stack is not None:
                # last release tears the worker loops down
                stack.release(worker)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- dispatch ----------------------------------------------------------
    def add_dispatcher(self, d: Dispatcher) -> None:
        """add_dispatcher_head: earlier dispatchers see messages first."""
        self._dispatchers.append(d)

    def _dispatch(self, conn: Connection, msg: Message) -> None:
        """Queue one inbound message onto this messenger's dispatch
        strand (the dispatch-offload seam): handlers run FIFO on the
        stack's offload pool, never on the shared worker loop — a
        blocking handler stalls this messenger's queue, not a worker,
        and may safely make nested blocking RPC."""
        worker = self._worker
        if worker is not None:
            worker.count_dispatch()
        strand = self._dispatch_strand
        if strand is None:
            # racing shutdown: nobody left to deliver to
            return
        with self._depth_lock:
            self._dispatch_depth += 1
        stack = self._stack
        if stack is not None:
            stack.perf.inc("l_msgr_dispatch_queue_depth")

        def _run_one():
            try:
                self._dispatch_now(conn, msg)
            finally:
                self._dispatch_done()

        strand.submit(_run_one)

    def _dispatch_done(self) -> None:
        """Backlog drained by one (offload thread): below the low
        watermark, reopen this messenger's read gate so stalled
        socket reads resume."""
        wake = False
        with self._depth_lock:
            self._dispatch_depth -= 1
            gate = self._read_gate
            if (
                gate is not None
                and self._dispatch_depth <= self._dispatch_low
                and not gate.is_set()
            ):
                wake = True
        stack = self._stack
        if stack is not None:
            stack.perf.dec("l_msgr_dispatch_queue_depth")
        if wake:
            loop = self._loop
            if loop is not None:
                try:
                    # Event.set wakes loop futures — loop thread only
                    loop.call_soon_threadsafe(gate.set)
                except RuntimeError:
                    pass  # loop stopping: readers die with it

    @property
    def dispatch_backlog(self) -> int:
        with self._depth_lock:
            return self._dispatch_depth

    async def _maybe_stall_reads(self) -> None:
        """Read-loop side of the bounded dispatch queue (loop
        thread): at/over the high watermark, clear the gate and wait
        for the strand to drain.  Check-and-clear shares the depth
        lock with _dispatch_done's decrement, so a drain racing this
        stall can never strand the gate closed with an empty queue."""
        gate = self._read_gate
        if gate is None:
            return
        with self._depth_lock:
            if self._dispatch_depth < self._dispatch_high:
                return
            gate.clear()
        stack = self._stack
        if stack is not None:
            stack.perf.inc("l_msgr_dispatch_queue_stalls")
        await gate.wait()

    def _dispatch_now(self, conn, msg: Message) -> None:
        # trace propagation (the ZTracer trace-info handoff): a
        # message carrying a span/trace id makes it ambient for its
        # handlers, so spans they open join the sender's trace
        # without every handler re-plumbing the id
        trace = getattr(msg, "trace", "") or getattr(msg, "reqid", "")
        if trace:
            from ..common import tracing

            with tracing.propagate(trace):
                self._dispatch_inner(conn, msg)
        else:
            self._dispatch_inner(conn, msg)

    def _dispatch_inner(self, conn: Connection, msg: Message) -> None:
        for d in self._dispatchers:
            try:
                if d.ms_dispatch(conn, msg):
                    return
            except Exception:  # noqa: BLE001 — a dispatcher must not
                # kill the read loop; the reference logs and drops too
                import traceback

                traceback.print_exc()
                return

    def _register_conn(self, conn: Connection) -> None:
        """Loop-thread bookkeeping for a new live connection."""
        self._conns.add(conn)
        if self._worker is not None:
            self._worker.conn_opened()

    def _conn_reset(self, conn: Connection) -> None:
        if conn in self._conns:
            self._conns.discard(conn)
            if self._worker is not None:
                self._worker.conn_closed()
        # reset notifications ride the dispatch strand so dispatchers
        # observe them AFTER every message already queued from this
        # connection — the ordering inline dispatch used to give
        strand = self._dispatch_strand
        if strand is not None:
            strand.submit(lambda: self._conn_reset_now(conn))
        else:
            self._conn_reset_now(conn)

    def _conn_reset_now(self, conn: Connection) -> None:
        for d in self._dispatchers:
            try:
                d.ms_handle_reset(conn)
            except Exception:
                pass

    # -- internals ---------------------------------------------------------
    def new_tid(self) -> int:
        """Odd tid space: dialer-side requests and fire-and-forget."""
        with self._tid_lock:
            self._tid += 1
            return self._tid * 2 + 1

    def new_even_tid(self) -> int:
        """Even tid space: requests initiated from the ACCEPTING side
        of a connection (e.g. a replica's rollback re-pulls)."""
        with self._tid_lock:
            self._tid += 1
            return self._tid * 2

    def _run(self, coro):
        loop = self._loop
        if loop is None:
            coro.close()  # no loop: silence the never-awaited warning
            raise MessageError("messenger not started")
        try:
            return asyncio.run_coroutine_threadsafe(coro, loop)
        except RuntimeError as e:  # shared loop stopping under us
            coro.close()
            raise MessageError(f"messenger stopping: {e}") from e

    async def _accept(self, reader, writer) -> None:
        # the server spawned this handler as its own task on the
        # shared loop: track it so shutdown() cancels it with the
        # rest of this messenger's work
        self._track(asyncio.current_task())
        peer_entity = ""
        try:
            writer.write(BANNER)
            await writer.drain()
            peer = await asyncio.wait_for(
                reader.readexactly(len(BANNER)), 10
            )
            if peer != BANNER:
                writer.close()
                return
            secure_ctx = None
            if self.auth_server is not None:
                challenge = self.auth_server.make_challenge()
                # 'S' demands cephx AND switches the wire to sealed
                # frames after the handshake (ProtocolV2 secure
                # mode); 'A' is crc mode with cephx
                writer.write(
                    (b"S" if self.secure else b"A") + challenge
                )
                await writer.drain()
                blen = int.from_bytes(
                    await asyncio.wait_for(reader.readexactly(4), 10),
                    "little",
                )
                blob = await asyncio.wait_for(
                    reader.readexactly(blen), 10
                )
                from ..auth.cephx import AuthError

                try:
                    peer_entity, proof, session_key = (
                        self.auth_server.verify_authorizer(
                            blob, challenge
                        )
                    )
                except AuthError:
                    # reject: zero-length proof then close
                    writer.write((0).to_bytes(4, "little"))
                    await writer.drain()
                    writer.close()
                    return
                writer.write(
                    len(proof).to_bytes(4, "little") + proof
                )
                await writer.drain()
                if self.secure:
                    from ..common.encoding import Decoder as _D

                    d = _D(blob)
                    d.bytes()  # ticket blob
                    nonce = d.bytes()  # the client's handshake nonce
                    secure_ctx = SecureCtx(
                        session_key, challenge, nonce, outgoing=False
                    )
            else:
                writer.write(b"N")
                await writer.drain()
        except Exception:
            writer.close()
            return
        conn = Connection(self, reader, writer, outgoing=False)
        conn.secure = secure_ctx
        conn.peer_entity = peer_entity
        self._register_conn(conn)
        await conn._read_loop()


def wait_for(predicate, timeout: float, interval: float = 0.02) -> bool:
    """Poll helper for tests/daemons."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()
