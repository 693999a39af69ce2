"""Monitor quorum — elections + single-decree Paxos over the
MonitorStore (src/mon/Paxos.cc:1-1592 collect/begin/accept/commit/
lease; src/mon/Elector.cc + ElectionLogic.cc).

``QuorumMonitor`` wraps the single-node ``Monitor`` in the quorum
machinery the reference's Monitor.cc runs:

- **Election**: a candidate PROPOSEs with its (last_committed, rank);
  peers defer (ACK) to the most-up-to-date, lowest-rank candidate
  (the ElectionLogic CLASSIC strategy with the dev-order tiebreak);
  a majority of ACKs makes it leader and it broadcasts VICTORY with
  the quorum.  Every election bumps a monotonic, store-persisted
  election epoch — the proposal-number (pn) role that fences deposed
  leaders out of later Paxos rounds.
- **Collect**: a fresh leader COLLECTs each peon's last_committed and
  any uncommitted value; peons ahead of the leader hand the missing
  commits back in the LAST reply, lagging peons are caught up with
  COMMIT runs, and an uncommitted value found anywhere is re-proposed
  (Paxos::handle_last's uncommitted recovery).
- **Begin/accept/commit**: every map mutation is one Paxos value —
  BEGIN ships the incremental to the quorum, a majority of ACCEPTs
  commits it locally, and COMMIT fans the value out; peons apply it
  to their own OSDMap copy and push to their own subscribers, so any
  quorum mon serves maps.
- **Lease**: the leader heartbeats LEASEs; a peon whose lease expires
  calls a new election (Paxos::extend_lease / lease_timeout).

Deadlock discipline: every blocking round-trip (forwarding, begin,
collect) runs on the monitor's worker thread, never on the messenger
loop (the loop could not read the reply it is waiting for).  Inbound
BEGIN/COMMIT/COLLECT handling is non-blocking store work and runs
inline.  Client-facing behavior on a peon: commands, boot reports and
failure reports are forwarded to the leader (the MForward role);
subscriptions and ``mon_status`` (this monitor's own rank, state,
leader, quorum and last committed version) are served locally.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field

from ..msg import (
    Message,
    MessageError,
    Messenger,
    MMonElection,
    MMonPaxos,
)
from ..msg.message import (
    ELECT_ACK,
    ELECT_PROPOSE,
    ELECT_VICTORY,
    MMonCommand,
    MMonCommandReply,
    MOSDBoot,
    MOSDFailure,
    PAXOS_ACCEPT,
    PAXOS_BEGIN,
    PAXOS_COLLECT,
    PAXOS_COMMIT,
    PAXOS_LAST,
    PAXOS_LEASE,
    PAXOS_SYNC,
)
from ..msg.messenger import Connection
from ..osd.osdmap import Incremental, OSDMap
from ..store.objectstore import StoreError
from .monitor import MON_COLL, Monitor, MonitorStore
from ..common import lockdep

STATE_ELECTING = "electing"
STATE_LEADER = "leader"
STATE_PEON = "peon"


def _prefix(cmd_json: str) -> str:
    try:
        return str(json.loads(cmd_json).get("prefix", ""))
    except (ValueError, AttributeError):
        return ""


class _StrandQueue:
    """queue.Queue stand-in for shared-services mode: ``put`` feeds
    the item straight onto a serial strand of the shared network
    stack — FIFO, one at a time, on whatever offload thread is free,
    which is exactly the semantics of one worker thread draining a
    Queue, minus the thread.  The ``None`` shutdown sentinel is a
    no-op (strands have no loop to stop)."""

    def __init__(self, strand, handler):
        self._strand = strand
        self._handler = handler

    def put(self, item) -> None:
        if item is None:
            return
        self._strand.submit(lambda: self._handler(item))


@dataclass
class MonMap:
    """Monitor cluster membership: rank → address (MonMap role)."""

    addrs: dict[int, tuple[str, int]] = field(default_factory=dict)
    epoch: int = 1

    @property
    def size(self) -> int:
        return len(self.addrs)

    @property
    def majority(self) -> int:
        return self.size // 2 + 1

    def ranks(self) -> list[int]:
        return sorted(self.addrs)


class QuorumMonitor(Monitor):
    """A Monitor participating in a quorum.  With a 1-mon monmap it
    degenerates to the single-node Monitor (always leader, no RPC)."""

    def __init__(
        self,
        osdmap: OSDMap,
        monmap: MonMap,
        rank: int,
        messenger: Messenger | None = None,
        store: MonitorStore | None = None,
        min_reporters: int = 2,
        election_timeout: float = 1.0,
        lease_interval: float = 0.5,
        shared_services: bool | None = None,
    ):
        super().__init__(osdmap, store=store, min_reporters=min_reporters)
        self.monmap = monmap
        self.rank = rank
        self.messenger = messenger or Messenger(f"mon.{rank}")
        self.messenger.add_dispatcher(self)
        self.election_timeout = election_timeout
        self.lease_interval = lease_interval
        self.state = STATE_ELECTING
        self.leader = -1
        self.quorum: set[int] = set()
        self.election_epoch = self._load_election_epoch()
        self._acked_me: set[int] = set()
        self._election_start = 0.0
        self._deferred_to = -1
        self._lease_expiry = 0.0
        self._mon_conns: dict[int, Connection] = {}
        self._conn_lock = lockdep.Mutex("mon.conn")
        # two queues: _workq carries client work (commands/forwards,
        # which may block up to their RPC timeouts); _electq carries
        # election/paxos coordination (proposals, victories' collect
        # phase, sync requests).  Separate threads so a blocked
        # forward can never stall an election.  NOTHING that dials a
        # connection may run on the messenger loop thread —
        # Messenger.connect marshals onto that loop and would
        # deadlock (the OSD daemon's worker-queue rule).
        self._workq: queue.Queue = queue.Queue()
        self._electq: queue.Queue = queue.Queue()
        # concurrent BEGIN fan-out (commit's pipelined accept gather);
        # daemon threads so a straggler call never blocks shutdown
        import concurrent.futures as _cf

        self._paxos_pool = _cf.ThreadPoolExecutor(
            max_workers=max(4, self.monmap.size),
            thread_name_prefix=f"mon.{rank}.paxos",
        )
        self._worker: threading.Thread | None = None
        self._elector: threading.Thread | None = None
        self._ticker: threading.Thread | None = None
        self._stop = threading.Event()
        self.addr: tuple[str, int] | None = None
        # shared-services: the work/elect queues become strands on
        # the shared network stack and the tick a stack timer — a
        # quorum mon then costs ZERO dedicated threads beyond the
        # paxos fan-out pool (as the OSD does with shared services)
        self.shared_services = bool(shared_services)
        self._tick_handle = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Bind at my monmap address and call the first election."""
        host, port = self.monmap.addrs[self.rank]
        self.addr = self.messenger.bind(host, port)
        if self.shared_services:
            # bind() started the messenger, so the stack is held for
            # this daemon's whole lifetime — strands/timers on it can
            # never outlive their carrier
            stack = self.messenger._stack
            self._workq = _StrandQueue(
                stack.offload.strand(), self._work_one
            )
            self._electq = _StrandQueue(
                stack.offload.strand(), self._elect_one
            )
            self._tick_handle = stack.timers.every(
                self.lease_interval, self._tick_once
            )
        else:
            self._worker = threading.Thread(
                target=self._work_loop, name=f"mon.{self.rank}.wq",
                daemon=True,
            )
            self._worker.start()
            self._elector = threading.Thread(
                target=self._elect_loop, name=f"mon.{self.rank}.elect",
                daemon=True,
            )
            self._elector.start()
            self._ticker = threading.Thread(
                target=self._tick_loop, name=f"mon.{self.rank}.tick",
                daemon=True,
            )
            self._ticker.start()
        if self.monmap.size == 1:
            self.state = STATE_LEADER
            self.leader = self.rank
            self.quorum = {self.rank}
        else:
            self._electq.put(("election",))

    def shutdown(self) -> None:
        self._stop.set()
        self._workq.put(None)
        self._electq.put(None)
        if self._tick_handle is not None:
            self._tick_handle.cancel()
        if self._worker is not None:
            self._worker.join(timeout=5)
        if self._elector is not None:
            self._elector.join(timeout=5)
        self._paxos_pool.shutdown(wait=False)
        self.messenger.shutdown()

    @property
    def is_leader(self) -> bool:
        return self.state == STATE_LEADER

    @property
    def in_quorum(self) -> bool:
        return self.state in (STATE_LEADER, STATE_PEON)

    # -- persisted election epoch (the pn store) ---------------------------
    def _load_election_epoch(self) -> int:
        try:
            return int(
                self.store.store.getattr(
                    MON_COLL, "meta", "election_epoch"
                )
            )
        except StoreError:
            return 0

    def _save_election_epoch(self) -> None:
        from ..store.objectstore import Transaction

        txn = Transaction()
        txn.touch(MON_COLL, "meta")
        txn.setattr(
            MON_COLL, "meta", "election_epoch",
            str(self.election_epoch).encode(),
        )
        self.store.store.queue_transaction(txn)

    # -- peer connections --------------------------------------------------
    def _mon_conn(self, rank: int) -> Connection:
        with self._conn_lock:
            conn = self._mon_conns.get(rank)
            if conn is not None and not conn.is_closed:
                return conn
        host, port = self.monmap.addrs[rank]
        conn = self.messenger.connect(host, port, timeout=3.0)
        with self._conn_lock:
            self._mon_conns[rank] = conn
        return conn

    def _send_to(self, rank: int, msg: Message) -> bool:
        try:
            conn = self._mon_conn(rank)
            if msg.tid == 0:
                msg.tid = self.messenger.new_tid()
            conn.send(msg)
            return True
        except (MessageError, OSError):
            return False

    def _peers(self) -> list[int]:
        return [r for r in self.monmap.ranks() if r != self.rank]

    # -- election ----------------------------------------------------------
    def _candidacy(self) -> tuple[int, int]:
        """Sort key: most committed first, then lowest rank."""
        return (self.store.last_committed(), -self.rank)

    def _start_election(self) -> None:
        with self._lock:
            self.state = STATE_ELECTING
            self.leader = -1
            self.quorum = set()
            self.election_epoch += 1
            self._save_election_epoch()
            self._acked_me = {self.rank}
            self._deferred_to = self.rank
            self._election_start = time.monotonic()
            epoch = self.election_epoch
            lc = self.store.last_committed()
        for rank in self._peers():
            self._send_to(
                rank,
                MMonElection(
                    op=ELECT_PROPOSE, epoch=epoch, rank=self.rank,
                    last_committed=lc,
                ),
            )
        # a lone mon (or one whose peers are all down) still needs to
        # win once a majority of the monmap is itself
        self._maybe_win()

    def _maybe_win(self, expired: bool = False) -> None:
        """Declare victory when EVERY mon acked, or when a majority
        acked and the gather window passed (Elector's victory-after-
        timeout: winning on the first majority ack would leave slow
        mons out of the quorum, starving them of leases/commits and
        provoking election churn)."""
        with self._lock:
            if self.state != STATE_ELECTING:
                return
            if len(self._acked_me) < self.monmap.majority:
                return
            if (
                len(self._acked_me) < self.monmap.size
                and not expired
            ):
                return
            self.state = STATE_LEADER
            self.leader = self.rank
            self.quorum = set(self._acked_me)
            epoch = self.election_epoch
            quorum = sorted(self.quorum)
        for rank in self._peers():
            self._send_to(
                rank,
                MMonElection(
                    op=ELECT_VICTORY, epoch=epoch, rank=self.rank,
                    quorum=quorum,
                ),
            )
        # collect runs blocking RPC → election thread
        self._electq.put(("collect", epoch))

    def _handle_election(self, conn: Connection, msg: MMonElection):
        if msg.op == ELECT_PROPOSE:
            peer_key = (msg.last_committed, -msg.rank)
            with self._lock:
                if msg.epoch < self.election_epoch:
                    return  # stale round
                my_key = (self.store.last_committed(), -self.rank)
                defer = peer_key > my_key
                if defer:
                    self.state = STATE_ELECTING
                    self.leader = -1
                    self.election_epoch = msg.epoch
                    self._save_election_epoch()
                    self._deferred_to = msg.rank
                    self._election_start = time.monotonic()
            if defer:
                self._send_to(
                    msg.rank,
                    MMonElection(
                        op=ELECT_ACK, epoch=msg.epoch, rank=self.rank,
                    ),
                )
            else:
                # I am the better candidate: counter-propose at a
                # higher epoch (the peer will defer to my key)
                with self._lock:
                    self.election_epoch = max(
                        self.election_epoch, msg.epoch
                    )
                self._start_election()
            return
        if msg.op == ELECT_ACK:
            with self._lock:
                if (
                    self.state == STATE_ELECTING
                    and msg.epoch == self.election_epoch
                ):
                    self._acked_me.add(msg.rank)
            self._maybe_win()
            return
        if msg.op == ELECT_VICTORY:
            with self._lock:
                if msg.epoch < self.election_epoch:
                    return
                self.election_epoch = msg.epoch
                self._save_election_epoch()
                self.state = (
                    STATE_LEADER
                    if msg.rank == self.rank
                    else STATE_PEON
                )
                self.leader = msg.rank
                self.quorum = set(msg.quorum)
                self._lease_expiry = (
                    time.monotonic() + 4 * self.lease_interval
                )

    # -- paxos: leader side ------------------------------------------------
    def commit(self, inc: Incremental) -> int:
        """propose_pending through Paxos: BEGIN to the quorum, commit
        on majority accept, COMMIT fan-out (Paxos.cc begin/commit)."""
        if self.monmap.size == 1:
            return super().commit(inc)
        with self._lock:
            if not self.is_leader:
                raise RuntimeError(
                    f"mon.{self.rank} is not leader (-EAGAIN)"
                )
            blob = inc.encode()
            version = self.osdmap.epoch + 1
            epoch = self.election_epoch
            peons = sorted(self.quorum - {self.rank})

            # BEGIN fans out CONCURRENTLY with one shared deadline
            # (Paxos.cc pipelines begin/accept the same way): a dead
            # peon costs one timeout total, not one per peon, and the
            # leader stops waiting the moment a majority accepts
            def _begin(rank: int) -> bool:
                try:
                    reply = self._mon_conn(rank).call(
                        MMonPaxos(
                            op=PAXOS_BEGIN, epoch=epoch,
                            version=version, inc_blob=blob,
                            rank=self.rank,
                        ),
                        timeout=3.0,
                    )
                    return isinstance(reply, MMonPaxos) and reply.ok
                except (MessageError, OSError):
                    return False

            accepts = 1
            if peons:
                import concurrent.futures as cf

                futs = [
                    self._paxos_pool.submit(_begin, r) for r in peons
                ]
                try:
                    for f in cf.as_completed(futs, timeout=3.5):
                        if f.result():
                            accepts += 1
                        if accepts >= self.monmap.majority:
                            break  # stragglers finish on their own
                except cf.TimeoutError:
                    pass
            if accepts < self.monmap.majority:
                # lost the quorum mid-round: step down and re-elect
                self.state = STATE_ELECTING
                self._electq.put(("election",))
                raise RuntimeError(
                    f"no quorum for commit ({accepts} accepts, "
                    f"need {self.monmap.majority}) (-EAGAIN)"
                )
            self.osdmap.apply_incremental(inc)
            self.store.put_commit(
                self.osdmap.epoch, blob, self.osdmap.encode()
            )
            self._clear_uncommitted()
            self._push_maps()
            committed = self.osdmap.epoch
        for rank in peons:
            self._send_to(
                rank,
                MMonPaxos(
                    op=PAXOS_COMMIT, epoch=epoch, version=committed,
                    inc_blob=blob, rank=self.rank,
                ),
            )
        return committed

    def _collect(self, epoch: int) -> None:
        """Fresh-leader collect: learn every peon's last_committed,
        adopt newer commits, catch lagging peons up, re-propose any
        uncommitted value (Paxos.cc collect/handle_last)."""
        with self._lock:
            if not self.is_leader or epoch != self.election_epoch:
                return
            peons = sorted(self.quorum - {self.rank})
        uncommitted: tuple[int, bytes] | None = self._get_uncommitted()
        peer_lc: dict[int, int] = {}
        for rank in peons:
            try:
                reply = self._mon_conn(rank).call(
                    MMonPaxos(
                        op=PAXOS_COLLECT, epoch=epoch,
                        last_committed=self.store.last_committed(),
                        rank=self.rank,
                    ),
                    timeout=3.0,
                )
            except (MessageError, OSError):
                continue
            if not isinstance(reply, MMonPaxos) or not reply.ok:
                continue
            peer_lc[rank] = reply.last_committed
            # adopt commits from a peon that is ahead of us
            with self._lock:
                for v, inc_blob, full_blob in reply.entries:
                    self._apply_commit(v, inc_blob, full_blob)
            if reply.version and reply.inc_blob:
                cand = (reply.version, reply.inc_blob)
                if uncommitted is None or cand[0] > uncommitted[0]:
                    uncommitted = cand
        # catch lagging peons up with a COMMIT run
        with self._lock:
            my_lc = self.store.last_committed()
        for rank in peons:
            lc = peer_lc.get(rank)
            if lc is None or lc >= my_lc:
                continue
            self._send_catchup(rank, lc, my_lc, epoch)
        # recover an uncommitted value through a fresh round
        # (Paxos::handle_last's "share the previous value" path)
        if uncommitted is not None:
            v, blob = uncommitted
            inc = None
            with self._lock:
                if v == self.store.last_committed() + 1:
                    try:
                        inc = Incremental.decode(blob)
                    except Exception:  # noqa: BLE001 — torn blob
                        inc = None
            if inc is not None:
                try:
                    self.commit(inc)
                except RuntimeError:
                    pass
        # leases start flowing from the tick loop
        with self._lock:
            self._lease_expiry = (
                time.monotonic() + 4 * self.lease_interval
            )

    def _send_catchup(
        self,
        rank: int,
        since: int,
        to: int,
        epoch: int,
        conn: Connection | None = None,
    ) -> None:
        """COMMIT run (since, to].  With ``conn`` the run answers on
        the requester's own connection — the inline SYNC path must
        never dial from the messenger loop thread."""
        entries = []
        for v in range(since + 1, to + 1):
            inc = self.store.get_inc(v) or b""
            full = self.store.get_full(v) or b""
            entries.append((v, inc, full))
        msg = MMonPaxos(
            op=PAXOS_COMMIT, epoch=epoch, version=to,
            rank=self.rank, entries=entries,
        )
        if conn is not None:
            msg.tid = self.messenger.new_tid()
            try:
                conn.send(msg)
            except (MessageError, OSError):
                pass
        else:
            self._send_to(rank, msg)

    # -- paxos: peon side --------------------------------------------------
    def _store_uncommitted(self, version: int, blob: bytes) -> None:
        from ..store.objectstore import Transaction

        txn = Transaction()
        txn.touch(MON_COLL, "paxos_uncommitted")
        txn.truncate(MON_COLL, "paxos_uncommitted", 0)
        txn.write(MON_COLL, "paxos_uncommitted", 0, blob)
        txn.setattr(
            MON_COLL, "paxos_uncommitted", "version",
            str(version).encode(),
        )
        self.store.store.queue_transaction(txn)

    def _get_uncommitted(self) -> tuple[int, bytes] | None:
        try:
            v = int(
                self.store.store.getattr(
                    MON_COLL, "paxos_uncommitted", "version"
                )
            )
            blob = self.store.store.read(MON_COLL, "paxos_uncommitted")
        except StoreError:
            return None
        if v <= self.store.last_committed() or not blob:
            return None
        return (v, blob)

    def _clear_uncommitted(self) -> None:
        from ..store.objectstore import Transaction

        try:
            self.store.store.queue_transaction(
                Transaction().remove(MON_COLL, "paxos_uncommitted")
            )
        except StoreError:
            pass

    def _apply_commit(
        self, version: int, inc_blob: bytes, full_blob: bytes
    ) -> bool:
        """Apply one committed value to our map copy (caller holds
        the lock).  Returns False on a gap the blobs cannot bridge."""
        if version <= self.osdmap.epoch:
            return True
        if version == self.osdmap.epoch + 1 and inc_blob:
            inc = Incremental.decode(inc_blob)
            self.osdmap.apply_incremental(inc)
            self.store.put_commit(
                version, inc_blob, self.osdmap.encode()
            )
        elif full_blob:
            self.osdmap = OSDMap.decode(full_blob)
            self.store.put_commit(version, inc_blob or None, full_blob)
        else:
            return False
        self._clear_uncommitted()
        self._push_maps()
        return True

    def _handle_paxos(self, conn: Connection, msg: MMonPaxos) -> None:
        if msg.op == PAXOS_BEGIN:
            with self._lock:
                ok = (
                    msg.epoch == self.election_epoch
                    and self.state == STATE_PEON
                    and msg.rank == self.leader
                    and msg.version == self.store.last_committed() + 1
                )
                if ok:
                    self._store_uncommitted(msg.version, msg.inc_blob)
            conn.send(
                MMonPaxos(
                    tid=msg.tid, op=PAXOS_ACCEPT,
                    epoch=msg.epoch, version=msg.version, ok=ok,
                    rank=self.rank,
                )
            )
            return
        if msg.op == PAXOS_COMMIT:
            with self._lock:
                if msg.epoch != self.election_epoch:
                    return
                if msg.entries:
                    for v, inc_blob, full_blob in msg.entries:
                        if not self._apply_commit(
                            v, inc_blob, full_blob
                        ):
                            break
                elif not self._apply_commit(
                    msg.version, msg.inc_blob, b""
                ):
                    # gap: ask the leader for the missing run
                    lc = self.store.last_committed()
                    leader = self.leader
                    self._electq.put(("sync", leader, lc))
            return
        if msg.op == PAXOS_COLLECT:
            with self._lock:
                ok = msg.epoch >= self.election_epoch
                lc = self.store.last_committed()
                reply = MMonPaxos(
                    tid=msg.tid, op=PAXOS_LAST, epoch=msg.epoch,
                    last_committed=lc, ok=ok, rank=self.rank,
                )
                if ok:
                    self.election_epoch = msg.epoch
                    unc = self._get_uncommitted()
                    if unc is not None:
                        reply.version, reply.inc_blob = unc
                    # hand the leader commits it does not have
                    if msg.last_committed < lc:
                        for v in range(msg.last_committed + 1, lc + 1):
                            reply.entries.append(
                                (
                                    v,
                                    self.store.get_inc(v) or b"",
                                    self.store.get_full(v) or b"",
                                )
                            )
            conn.send(reply)
            return
        if msg.op == PAXOS_LEASE:
            with self._lock:
                if (
                    msg.epoch == self.election_epoch
                    and self.state == STATE_PEON
                ):
                    self._lease_expiry = (
                        time.monotonic() + 4 * self.lease_interval
                    )
                    if msg.last_committed > self.store.last_committed():
                        lc = self.store.last_committed()
                        self._electq.put(("sync", self.leader, lc))
            return
        if msg.op == PAXOS_SYNC:
            # a lagging peon asks for commits after msg.last_committed;
            # answer on ITS connection (this runs inline on the loop —
            # dialing here would deadlock)
            with self._lock:
                if not self.is_leader:
                    return
                my_lc = self.store.last_committed()
                epoch = self.election_epoch
            if msg.last_committed < my_lc:
                self._send_catchup(
                    msg.rank, msg.last_committed, my_lc, epoch,
                    conn=conn,
                )
            return

    # -- forwarding (MForward role) ----------------------------------------
    def _forward_command(self, conn: Connection, msg: MMonCommand):
        try:
            with self._lock:
                leader = self.leader
            if leader < 0 or leader == self.rank or not self.in_quorum:
                # no leader, or this monitor won an election after
                # its caller looked: the client resends
                raise MessageError("no quorum")
            reply = self._mon_conn(leader).call(
                MMonCommand(cmd=msg.cmd), timeout=10.0
            )
            assert isinstance(reply, MMonCommandReply)
            reply.tid = msg.tid
        except (MessageError, OSError, AssertionError):
            reply = MMonCommandReply(
                tid=msg.tid, rc=-11,
                outs="monitor has no quorum/leader (-EAGAIN)",
            )
        try:
            conn.send(reply)
        except (MessageError, OSError):
            pass

    def _forward_to_leader(self, msg: Message) -> None:
        with self._lock:
            leader = self.leader
        if leader >= 0 and leader != self.rank:
            msg.tid = 0
            self._send_to(leader, msg)

    def mon_status(self) -> dict:
        """This monitor's own view (the reference's ``mon_status``,
        answered by the monitor asked, never forwarded): rank, state,
        leader, quorum, election epoch and last committed version."""
        with self._lock:
            return {
                "rank": self.rank,
                "state": self.state,
                "leader": self.leader,
                "quorum": sorted(self.quorum),
                "election_epoch": self.election_epoch,
                "last_committed": self.store.last_committed(),
            }

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MMonCommand) and _prefix(msg.cmd) == "mon_status":
            try:
                conn.send(
                    MMonCommandReply(
                        tid=msg.tid, outb=json.dumps(self.mon_status())
                    )
                )
            except (MessageError, OSError):
                pass
            return True
        if isinstance(msg, MMonElection):
            if msg.op == ELECT_VICTORY:
                # pure state adoption, no sends: safe inline
                self._handle_election(conn, msg)
            else:
                # PROPOSE/ACK may answer with dialing sends → thread
                self._electq.put(("msg", conn, msg))
            return True
        if isinstance(msg, MMonPaxos):
            # BEGIN/COLLECT/SYNC reply on the incoming connection,
            # COMMIT/LEASE are receive-only: all safe inline
            self._handle_paxos(conn, msg)
            return True
        if isinstance(msg, MMonCommand):
            if self.monmap.size == 1 or self.is_leader:
                # leader commits block on peon RPC → worker
                self._workq.put(("command", conn, msg))
            else:
                self._workq.put(("forward", conn, msg))
            return True
        if isinstance(msg, (MOSDBoot, MOSDFailure)):
            if self.monmap.size == 1 or self.is_leader:
                self._workq.put(("base", conn, msg))
            else:
                self._forward_to_leader(msg)
            return True
        return super().ms_dispatch(conn, msg)

    # -- worker / ticker ---------------------------------------------------
    def _work_loop(self) -> None:
        while not self._stop.is_set():
            item = self._workq.get()
            if item is None:
                return
            self._work_one(item)

    def _work_one(self, item) -> None:
        if self._stop.is_set():
            return
        kind = item[0]
        try:
            if kind in ("command", "forward"):
                # an election may have moved the leader since the
                # item was queued: decide where it runs now.  A leader
                # forwarding to itself would wait out the call's
                # timeout behind its own worker, one queued command
                # after another (a fault of the reference, which
                # decides at receipt only).
                with self._lock:
                    here = self.monmap.size == 1 or self.is_leader
                if not here:
                    self._forward_command(item[1], item[2])
                    return
                reply = self.handle_command(item[2].cmd)
                reply.tid = item[2].tid
                try:
                    item[1].send(reply)
                except (MessageError, OSError):
                    pass
            elif kind == "base":
                try:
                    if self.monmap.size > 1 and not self.is_leader:
                        # lost leadership between enqueue and
                        # processing: hand it to the new leader
                        self._forward_to_leader(item[2])
                    else:
                        super().ms_dispatch(item[1], item[2])
                except RuntimeError:
                    self._forward_to_leader(item[2])
        except Exception:  # noqa: BLE001 — worker must survive
            import traceback

            traceback.print_exc()

    def _elect_loop(self) -> None:
        while not self._stop.is_set():
            item = self._electq.get()
            if item is None:
                return
            self._elect_one(item)

    def _elect_one(self, item) -> None:
        if self._stop.is_set():
            return
        kind = item[0]
        try:
            if kind == "msg":
                self._handle_election(item[1], item[2])
            elif kind == "collect":
                self._collect(item[1])
            elif kind == "election":
                self._start_election()
            elif kind == "sync":
                _k, leader, lc = item
                if leader >= 0 and leader != self.rank:
                    self._send_to(
                        leader,
                        MMonPaxos(
                            op=PAXOS_SYNC, rank=self.rank,
                            last_committed=lc,
                        ),
                    )
        except Exception:  # noqa: BLE001 — elector must survive
            import traceback

            traceback.print_exc()

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.lease_interval):
            self._tick_once()

    def _tick_once(self) -> None:
        if self._stop.is_set():
            return
        now = time.monotonic()
        with self._lock:
            state = self.state
            epoch = self.election_epoch
            lc = self.store.last_committed()
            peons = sorted(self.quorum - {self.rank})
            since_start = now - self._election_start
            election_stale = (
                state == STATE_ELECTING
                and since_start > self.election_timeout
            )
            gather_expired = (
                state == STATE_ELECTING
                and since_start > self.election_timeout / 2
            )
            lease_dead = (
                state == STATE_PEON and now > self._lease_expiry
            )
        if gather_expired:
            # majority acked but not everyone: close the gather
            # window and take the quorum we have
            self._maybe_win(expired=True)
            with self._lock:
                state = self.state
                election_stale = (
                    state == STATE_ELECTING and election_stale
                )
        if state == STATE_LEADER:
            for rank in peons:
                self._send_to(
                    rank,
                    MMonPaxos(
                        op=PAXOS_LEASE, epoch=epoch,
                        last_committed=lc, rank=self.rank,
                    ),
                )
        elif election_stale or lease_dead:
            if self.monmap.size == 1:
                return
            self._start_election()
