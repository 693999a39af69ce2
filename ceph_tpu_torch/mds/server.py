"""The MDS daemon: sessions, caps, journaled metadata cache, failover
(src/mds/Server.cc + src/mds/Locker.cc + src/mds/MDCache.h reduced to
the load-bearing machinery).

Shape of the reference this mirrors:

- **Sessions** (Server.cc handle_client_session): clients open a
  session over the messenger; every metadata op arrives as an
  MClientRequest on it.
- **Journal-ahead metadata** (MDLog/EUpdate): every mutation is
  journaled to rados (Journaler) and applied to the in-memory cache
  BEFORE the reply; the backing dirfrag/inode omap objects (the same
  layout ceph_tpu_torch.fs uses) are flushed lazily every
  ``flush_every`` mutations, then the journal is trimmed — so a
  standby taking over replays the journal tail to rebuild exactly the
  unflushed mutations.
- **Capabilities** (Locker.cc): readdir/stat grant the session a
  read-caching cap on the inode; a conflicting mutation REVOKES every
  other session's cap (MClientCaps round trip) before it commits, so
  a client whose sibling just created a file learns by recall, not by
  polling.
- **Mon-driven failover** (MDSMonitor role): daemons beacon the
  monitor ("mds beacon" on the command plane); the monitor holds the
  mdsmap (one active + standbys), promotes a standby when the
  active's beacons stop, and the promoted daemon replays the journal
  before serving.

- **Multi-MDS subtree delegation** (MDCache subtree auth,
  src/mds/MDCache.cc:1, + Migrator export, src/mds/Migrator.cc:1,
  reduced): up to max_mds actives, each auth for the pinned subtrees
  the mon's table assigns it (longest-prefix match), each journaling
  its own rank's mutations.  Because metadata lives in shared rados
  omap objects and caches load lazily, EXPORT is a flush + table
  flip + cap revoke (with a mon-side barrier: clients only see a
  table every active has flushed under) instead of a cache-streaming
  state machine.  Cross-subtree renames run as an MDS→MDS
  ``peer_link`` sub-op (the slave-request seat) followed by the
  local unlink.  A demoted/replaced active is blocklist-fenced via
  its beacon-carried client id.

Deviations (documented): caps are per-inode read-caching only (no
cap bits spectrum, no file-data leases — file DATA goes
client→rados directly), sessions/caps are in-memory (clients
re-open sessions after failover, as in the reference's reconnect
phase), cap coherence is per-rank (a mutation revokes only the auth
rank's sessions; cross-rank readers of boundary dirfrags read fresh
instead), and a crashed cross-rename can leave the name briefly
visible in both directories (link-then-unlink order — never lost).
"""

from __future__ import annotations

import json
import queue
import threading
import time

from ..common import crash as crash_util
from ..common import lockdep
from ..common.log_client import LogClient
from ..msg import Messenger
from ..msg.message import (
    MClientCaps,
    MClientReply,
    MClientRequest,
    MessageError,
)
from ..msg.messenger import Connection, Dispatcher
from .journaler import Journaler

from ..fs import ROOT_INO, _dir_oid, _ino_oid  # shared on-disk naming


class _Session:
    def __init__(self, conn: Connection, name: str):
        self.conn = conn
        self.name = name
        self.caps: set[int] = set()
        # recent reqid -> reply payload (op dedup across client
        # retries on a live session; lost on failover — the client
        # reconciles, see MDSClient._retry_outcome)
        self.replies: dict[str, tuple[int, str, str]] = {}


class MDSDaemon(Dispatcher):
    """One metadata daemon (active or standby)."""

    def __init__(
        self,
        name: str,
        rados,
        meta_pool: str,
        beacon_interval: float = 0.5,
        flush_every: int = 16,
        shared_services: bool | None = None,
    ):
        self.name = name
        self.rados = rados
        self.meta = rados.open_ioctx(meta_pool)
        self.journal = Journaler(self.meta)
        self.flush_every = flush_every
        self.beacon_interval = beacon_interval
        self.state = "standby"
        self.mdsmap_epoch = 0
        # multi-MDS (subtree delegation, MDCache subtree auth +
        # Migrator reduced): my rank, the subtree auth table, and the
        # peer actives' addresses — all distributed via beacons
        self.rank = -1
        self.ops_served = 0  # observability: which actives take traffic
        self._subtrees: dict[str, int] = {"/": 0}
        self._applied_table_epoch = 0
        self._peer_addrs: dict[int, str] = {}
        self._peer_conns: dict[int, Connection] = {}
        # shrink adoption (mon stray_ranks protocol): (rank, gen)
        # pairs whose journals WE replayed; acked on the next beacon
        # so the mon drains its queue and lets the re-pinned table
        # stabilize.  The generation tag pins each ack to ONE
        # eviction: a stale ack can never drain a newer eviction of
        # the same rank whose journal we have not replayed yet
        self._adopted_ranks: set[tuple[int, int]] = set()
        self.adopted_entries = 0  # observability/test hook

        # metadata cache (MDCache role): dirfrags + inodes, loaded
        # lazily from the backing omap, mutated ahead of lazy flushes
        self._lock = lockdep.RMutex("mds.cache")
        self._dirs: dict[int, dict[str, dict]] = {}
        self._inodes: dict[int, dict] = {}
        self._dirty_dentries: dict[int, dict[str, dict | None]] = {}
        self._dirty_inodes: set[int] = set()
        self._removed_inodes: set[int] = set()
        self._next_ino = 0
        self._unflushed = 0

        self._sessions: dict[Connection, _Session] = {}
        self._cap_holders: dict[int, set[_Session]] = {}

        # cluster log + crash capture: entries drain to the mon on the
        # beacon cadence; crash reports join the process-global queue
        # the mgr crash module drains (no mgr session on the MDS)
        self._log_client = LogClient(f"mds.{name}")
        self.clog = self._log_client.channel()

        self.msgr = Messenger(f"mds.{name}")
        self.msgr.add_dispatcher(self)
        self.addr = "%s:%d" % self.msgr.bind()
        self._stop = threading.Event()
        # ops run on a worker thread, NEVER on the messenger loop: a
        # cap revoke is a blocking conn.call, and blocking calls from
        # the loop thread deadlock (the op_shardedwq rule every
        # daemon here follows)
        self._workq: queue.Queue = queue.Queue()
        self.shared_services = bool(shared_services)
        self._worker = None
        self._beacon_thread = None
        self._beacon_handle = None
        if self.shared_services:
            # zero dedicated threads: ops drain through a serial
            # strand on the shared stack (same FIFO semantics as the
            # worker thread), beacons ride a stack timer
            stack = self.msgr._stack
            self._work_strand = stack.offload.strand()
            self._beacon_handle = stack.timers.every(
                self.beacon_interval, self._beacon_once,
                fire_now=True,
            )
        else:
            self._worker = threading.Thread(
                target=self._work_loop, name=f"mds.{name}.worker",
                daemon=True,
            )
            self._worker.start()
            self._beacon_thread = threading.Thread(
                target=self._beacon_loop, name=f"mds.{name}.beacon",
                daemon=True,
            )
            self._beacon_thread.start()

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> None:
        self._stop.set()
        self._workq.put(None)
        if self._beacon_handle is not None:
            self._beacon_handle.cancel()
        if self._beacon_thread is not None:
            self._beacon_thread.join(timeout=5)
        if self._worker is not None:
            self._worker.join(timeout=5)
        if self.state == "active":
            with self._lock:
                try:
                    self._flush()
                except Exception:  # noqa: BLE001 — shutdown best-effort
                    pass
        self.msgr.shutdown()

    def _beacon_loop(self) -> None:
        while not self._stop.is_set():
            self._beacon_once()
            self._stop.wait(self.beacon_interval)

    def _beacon_once(self) -> None:
        if not self._stop.is_set():
            try:
                beacon = {
                    "prefix": "mds beacon",
                    "name": self.name,
                    "addr": self.addr,
                    "state": self.state,
                    # the mon fences THIS id if it replaces us
                    # while we are partitioned (_fence_mds)
                    "client": self.rados.client_id,
                    # ack: the subtree table epoch we have
                    # FLUSHED under (the export barrier)
                    "table_epoch": self._applied_table_epoch,
                }
                if self._adopted_ranks:
                    beacon["adopted_ranks"] = sorted(
                        list(e) for e in self._adopted_ranks
                    )
                rc, outb, _outs = self.rados.mon_command(beacon)
                if rc == 0 and outb:
                    told = json.loads(outb)
                    self.mdsmap_epoch = told.get("epoch", 0)
                    want = told.get("state", "standby")
                    self._peer_addrs = {
                        int(r): a
                        for r, a in told.get("actives", {}).items()
                    }
                    new_table = told.get("subtrees")
                    new_te = told.get("table_epoch", 0)
                    new_rank = told.get("rank", 0)
                    if self._adopted_ranks:
                        # the mon drained acked ranks from its stray
                        # queue: forget them, so a rank evicted AGAIN
                        # after a re-grow is re-adopted, not skipped
                        # (the gen tag already guarantees that; this
                        # just bounds the ack set)
                        still = {
                            (int(e[0]), int(e[1]))
                            for e in told.get("adopt_ranks", [])
                        }
                        self._adopted_ranks &= still
                    if want == "active" and (
                        self.state != "active"
                        or new_rank != self.rank
                    ):
                        # fresh promotion OR a mon-side rank
                        # reassignment (e.g. set-max-mds reshuffle):
                        # flush the old rank's state, then take over
                        # the new rank's journal
                        if self.state == "active":
                            with self._lock:
                                self._flush()
                        self._subtrees = dict(new_table or {"/": 0})
                        self._applied_table_epoch = new_te
                        self._become_active(new_rank)
                        if told.get("adopt_ranks"):
                            self._adopt_stray_ranks(
                                told["adopt_ranks"]
                            )
                    elif (
                        want == "active"
                        and told.get("adopt_ranks")
                    ):
                        # shrink adoption BEFORE acking the re-pinned
                        # table: the evicted rank's client-acked
                        # mutations must be in OUR cache/omap before
                        # clients route its subtrees here
                        self._adopt_stray_ranks(told["adopt_ranks"])
                        if (
                            new_table is not None
                            and new_te > self._applied_table_epoch
                        ):
                            self._apply_subtree_table(
                                new_table, new_te
                            )
                    elif (
                        want == "active"
                        and new_table is not None
                        and new_te > self._applied_table_epoch
                    ):
                        self._apply_subtree_table(new_table, new_te)
                    elif want != "active" and self.state == "active":
                        # demoted (mon promoted someone else while we
                        # were partitioned): stop serving immediately.
                        # Our old client id is blocklist-fenced — shed
                        # it for a fresh identity (the reference's
                        # respawn-with-new-addr) so a LATER promotion
                        # of this daemon can write again
                        self.state = "standby"
                        self.rados.objecter.new_identity()
            except Exception:  # noqa: BLE001 — beacons retry forever
                pass
            self._log_client.flush(self.rados.monc)

    def _become_active(self, rank: int = 0) -> None:
        """Standby takeover of a RANK: replay that rank's journal
        tail into the cache (the up:replay → up:active walk), then
        serve.  Each rank journals independently (MDLog is per-rank
        in the reference too), so replay rebuilds exactly the dead
        rank's unflushed mutations."""
        with self._lock:
            self.rank = rank
            self.journal = Journaler(
                self.meta,
                prefix=(
                    "mds_journal" if rank == 0
                    else f"mds_journal.{rank}"
                ),
            )
            self._dirs.clear()
            self._inodes.clear()
            self._dirty_dentries.clear()
            self._dirty_inodes.clear()
            self._removed_inodes.clear()
            self._mkfs_if_needed()
            self.journal.load()
            replayed = 0
            for blob in self.journal.replay():
                self._apply_entry(json.loads(blob))
                replayed += 1
            self.replayed_entries = replayed
            self._load_next_ino()
            self.state = "active"
            self.clog.info(
                f"mds.{self.name} is now active for rank {rank} "
                f"(replayed {replayed} journal entries)"
            )

    def _apply_subtree_table(self, table: dict, te: int) -> None:
        """Subtree table changed (a pin moved authority): flush ALL
        dirty state to the backing omap, drop the cache, and revoke
        every cap — the export/import handoff reduced to its
        essentials (the new auth loads lazily from the same backing
        objects, so migration IS the flush + table flip; the
        reference's Migrator streams cache state instead —
        deviation documented in the module docstring).  Only after
        this does the next beacon ack ``te``, which is what lets the
        mon expose the new table to clients."""
        with self._lock:
            self._flush()
            self._dirs.clear()
            self._inodes.clear()
            for ino in list(self._cap_holders):
                self._revoke(ino, None)
            self._subtrees = dict(table)
            self._applied_table_epoch = te

    def _adopt_stray_ranks(self, ranks) -> None:
        """Shrink adoption (``mds set-max-mds``): an evicted rank was
        FENCED mid-life, so its client-acked but unflushed mutations
        exist only in its per-rank journal.  Replay that journal into
        OUR cache (the ``mds fail`` takeover walk, but into the
        re-pin target instead of a promoted standby), flush to the
        backing omap, and trim the stray stream so a later re-grow
        promotion replays nothing stale.  ``ranks`` holds the mon's
        ``[rank, gen]`` queue entries; acked pair-for-pair on the
        next beacon (``adopted_ranks``) so the mon drains its queue
        and lets the re-pinned table stabilize for clients."""
        with self._lock:
            for rank, gen in sorted(
                (int(e[0]), int(e[1])) for e in ranks
            ):
                if (
                    (rank, gen) in self._adopted_ranks
                    or rank == self.rank
                ):
                    continue
                j = Journaler(
                    self.meta,
                    prefix=(
                        "mds_journal" if rank == 0
                        else f"mds_journal.{rank}"
                    ),
                )
                j.load()
                adopted = 0
                # allocations in the stray journal must advance the
                # EVICTED rank's persisted ino counter, not ours: a
                # re-grown rank resumes allocating from its own key,
                # and our counter must never jump into a foreign
                # range (disjoint per-rank ino spaces)
                saved_next = self._next_ino
                stray_max = -1
                for blob in j.replay():
                    ent = json.loads(blob)
                    self._apply_entry(ent)
                    if ent["op"] in ("mkdir", "create"):
                        ino = int(ent["ino"])
                        if (ino >> 40) == rank:
                            stray_max = max(stray_max, ino)
                    adopted += 1
                self._next_ino = max(
                    [saved_next]
                    + [
                        i + 1
                        for i in self._inodes
                        if self._my_ino(i)
                    ]
                )
                self._flush()
                if stray_max >= 0:
                    key = f"next_ino.{rank}"
                    stored = int(
                        self._ino_meta(ROOT_INO).get(
                            key, (rank << 40) + 2
                        )
                    )
                    nxt = max(stored, stray_max + 1)
                    self.meta.omap_set(
                        _ino_oid(ROOT_INO), {key: str(nxt).encode()}
                    )
                    self._inodes[ROOT_INO][key] = nxt
                j.trim()
                self._adopted_ranks.add((rank, gen))
                self.adopted_entries += adopted
                self.clog.info(
                    f"mds.{self.name} adopted rank {rank}'s journal "
                    f"({adopted} entries) after shrink"
                )

    # -- backing store (the ceph_tpu_torch.fs omap layout) -----------------------
    def _mkfs_if_needed(self) -> None:
        from ..osdc.objecter import ObjectNotFound, RadosError

        try:
            self.meta.omap_get_vals(_ino_oid(ROOT_INO), max_return=1)
        except (ObjectNotFound, RadosError):
            self.meta.write_full(_ino_oid(ROOT_INO), b"")
            self.meta.omap_set(
                _ino_oid(ROOT_INO),
                {"type": b"dir", "next_ino": b"2"},
            )
            self.meta.write_full(_dir_oid(ROOT_INO), b"")

    # -- per-rank ino space ------------------------------------------------
    # ranks allocate from disjoint ranges (rank << 40 | counter) so
    # two actives never collide (the reference partitions via
    # per-rank inotable, src/mds/InoTable.cc); rank 0 keeps the
    # legacy low range.
    def _ino_key(self) -> str:
        return (
            "next_ino" if self.rank <= 0 else f"next_ino.{self.rank}"
        )

    def _ino_base(self) -> int:
        return 2 if self.rank <= 0 else (self.rank << 40) + 2

    def _my_ino(self, ino: int) -> bool:
        return (ino >> 40) == max(self.rank, 0)

    def _load_next_ino(self) -> None:
        stored = int(
            self._ino_meta(ROOT_INO).get(
                self._ino_key(), self._ino_base()
            )
        )
        # journal replay may carry allocations past the flushed value
        highest = max(
            [stored - 1]
            + [i for i in self._inodes if self._my_ino(i)]
            + [
                d["ino"]
                for frag in self._dirs.values()
                for d in frag.values()
                if self._my_ino(d["ino"])
            ]
        )
        self._next_ino = max(highest + 1, self._ino_base())

    def _load_dir(self, ino: int) -> dict[str, dict]:
        from ..osdc.objecter import ObjectNotFound, RadosError

        if ino not in self._dirs:
            try:
                vals = self.meta.omap_get_vals(_dir_oid(ino))
            except (ObjectNotFound, RadosError):
                raise KeyError(f"dirfrag {ino} missing")
            self._dirs[ino] = {
                k: json.loads(v) for k, v in vals.items()
            }
        return self._dirs[ino]

    def _ino_meta(self, ino: int) -> dict:
        from ..osdc.objecter import ObjectNotFound, RadosError

        if ino not in self._inodes:
            try:
                vals = self.meta.omap_get_vals(_ino_oid(ino))
            except (ObjectNotFound, RadosError):
                raise KeyError(f"inode {ino} missing")
            meta = {}
            for k, v in vals.items():
                v = v.decode()
                meta[k] = (
                    int(v)
                    if k in ("size",) or k.startswith("next_ino")
                    else v
                )
            self._inodes[ino] = meta
        return self._inodes[ino]

    def _flush(self) -> None:
        """Write dirty cache state to the backing omap and trim the
        journal (the MDLog expire / LogSegment flush role)."""
        for ino, dentries in self._dirty_dentries.items():
            sets = {
                name: json.dumps(d).encode()
                for name, d in dentries.items()
                if d is not None
            }
            rms = [name for name, d in dentries.items() if d is None]
            try:
                self.meta.stat(_dir_oid(ino))
            except Exception:  # noqa: BLE001 — create the frag object
                self.meta.write_full(_dir_oid(ino), b"")
            if sets:
                self.meta.omap_set(_dir_oid(ino), sets)
            if rms:
                self.meta.omap_rm_keys(_dir_oid(ino), rms)
        for ino in self._dirty_inodes:
            if ino in self._removed_inodes:
                continue
            meta = self._inodes.get(ino, {})
            try:
                self.meta.stat(_ino_oid(ino))
            except Exception:  # noqa: BLE001
                self.meta.write_full(_ino_oid(ino), b"")
            self.meta.omap_set(
                _ino_oid(ino),
                {
                    k: str(v).encode()
                    for k, v in meta.items()
                },
            )
        for ino in self._removed_inodes:
            for oid in (_ino_oid(ino), _dir_oid(ino)):
                try:
                    self.meta.remove(oid)
                except Exception:  # noqa: BLE001
                    pass
        self.meta.omap_set(
            _ino_oid(ROOT_INO),
            {self._ino_key(): str(self._next_ino).encode()},
        )
        self._dirty_dentries.clear()
        self._dirty_inodes.clear()
        self._removed_inodes.clear()
        self._unflushed = 0
        self.journal.trim()

    # -- journal apply (shared by live ops and replay) ---------------------
    def _apply_entry(self, ent: dict) -> None:
        """Apply one EUpdate-style record to the cache.  Replay must
        be idempotent: records carry every allocated ino."""
        op = ent["op"]
        if op in ("mkdir", "create"):
            parent, name, ino = ent["parent"], ent["name"], ent["ino"]
            frag = self._load_dir_or_empty(parent)
            typ = "dir" if op == "mkdir" else "file"
            frag[name] = {"type": typ, "ino": ino}
            self._mark_dentry(parent, name, frag[name])
            meta = {"type": typ, "mtime": ent["mtime"]}
            if op == "create":
                meta["size"] = 0
            else:
                self._dirs.setdefault(ino, {})
            self._inodes[ino] = meta
            self._dirty_inodes.add(ino)
            self._removed_inodes.discard(ino)
            self._next_ino = max(self._next_ino, ino + 1)
        elif op in ("rmdir", "unlink"):
            parent, name, ino = ent["parent"], ent["name"], ent["ino"]
            frag = self._load_dir_or_empty(parent)
            frag.pop(name, None)
            self._mark_dentry(parent, name, None)
            self._inodes.pop(ino, None)
            self._dirs.pop(ino, None)
            self._removed_inodes.add(ino)
            self._dirty_inodes.discard(ino)
        elif op == "rename":
            sp, sn = ent["sparent"], ent["sname"]
            dp, dn = ent["dparent"], ent["dname"]
            dentry = ent["dentry"]
            self._load_dir_or_empty(sp).pop(sn, None)
            self._mark_dentry(sp, sn, None)
            self._load_dir_or_empty(dp)[dn] = dentry
            self._mark_dentry(dp, dn, dentry)
        elif op == "rename_out":
            # OUR half of a cross-rank rename: the dentry leaves
            # this rank's subtree (the peer journals the insert).
            # Drop the cached inode meta too — the new auth owns it
            # now, and a later rename BACK must reload its (possibly
            # mutated) meta from the backing omap, not trust ours.
            parent, name = ent["parent"], ent["name"]
            frag = self._load_dir_or_empty(parent)
            gone = frag.pop(name, None)
            self._mark_dentry(parent, name, None)
            if gone is not None:
                self._inodes.pop(gone["ino"], None)
                self._dirty_inodes.discard(gone["ino"])
        elif op == "rename_in":
            parent, name = ent["parent"], ent["name"]
            dentry = ent["dentry"]
            self._load_dir_or_empty(parent)[name] = dentry
            self._mark_dentry(parent, name, dentry)
            # force a lazy reload of the arriving inode's meta (the
            # old auth flushed it before the peer_link)
            self._inodes.pop(dentry["ino"], None)
        elif op == "setattr":
            ino = ent["ino"]
            try:
                meta = self._ino_meta(ino)
            except KeyError:
                meta = self._inodes.setdefault(ino, {})
            meta.update(ent["attrs"])
            self._dirty_inodes.add(ino)
        else:
            raise ValueError(f"unknown journal op {op!r}")

    def _load_dir_or_empty(self, ino: int) -> dict[str, dict]:
        try:
            return self._load_dir(ino)
        except KeyError:
            return self._dirs.setdefault(ino, {})

    def _mark_dentry(self, dir_ino, name, dentry) -> None:
        self._dirty_dentries.setdefault(dir_ino, {})[name] = dentry

    def _journal_and_apply(
        self, ent: dict, force_flush: bool = False
    ) -> None:
        self.journal.append(json.dumps(ent).encode())
        self.journal.flush()
        self._apply_entry(ent)
        self._unflushed += 1
        if force_flush or self._unflushed >= self.flush_every:
            self._flush()

    # -- subtree authority (MDCache subtree auth, reduced) -----------------
    def _auth_rank(self, path: str) -> int:
        from . import subtree_auth_rank

        return subtree_auth_rank(self._subtrees, path)

    def _check_auth(self, path: str) -> None:
        r = self._auth_rank(path)
        if r != self.rank:
            # the client re-routes from the hinted rank (the
            # reference's MDS would forward the request itself;
            # client-side re-dispatch is the reduction)
            raise _Err(
                -116,
                f"not auth for {path!r}; mds rank {r} is (-ESTALE "
                f"auth={r})",
            )

    def _is_boundary(self, dir_path: str) -> bool:
        """A dirfrag some pin path passes THROUGH: its dentries are
        walked by other ranks, so mutations flush immediately (other
        ranks read boundary frags fresh from the backing omap — see
        _walk).  Non-boundary frags keep the lazy-flush + journal
        discipline."""
        parts = [p for p in dir_path.split("/") if p]
        for pref in self._subtrees:
            pp = [x for x in pref.split("/") if x]
            if len(pp) > len(parts) and pp[: len(parts)] == parts:
                return True
        return False

    @staticmethod
    def _dirname(path: str) -> str:
        from . import path_dirname

        return path_dirname(path)

    def _read_dir_fresh(self, ino: int) -> dict[str, dict]:
        """Uncached read of a FOREIGN dirfrag: another rank owns (and
        may be mutating) it; caching would go stale with no recall
        path.  Boundary frags flush-on-mutate at their auth, so this
        read is coherent up to the op in flight."""
        from ..osdc.objecter import ObjectNotFound, RadosError

        try:
            vals = self.meta.omap_get_vals(_dir_oid(ino))
        except (ObjectNotFound, RadosError):
            return {}
        return {k: json.loads(v) for k, v in vals.items()}

    # -- path walking ------------------------------------------------------
    def _walk(self, path: str) -> tuple[int, dict]:
        parts = [p for p in path.split("/") if p]
        ino = ROOT_INO
        dentry = {"type": "dir", "ino": ROOT_INO}
        for i, name in enumerate(parts):
            if dentry["type"] != "dir":
                raise _Err(-20, f"{name!r}: not a directory (-ENOTDIR)")
            prefix = "/" + "/".join(parts[:i])
            if self._auth_rank(prefix) == self.rank:
                frag = self._load_dir_or_empty(ino)
            else:
                frag = self._read_dir_fresh(ino)
            if name not in frag:
                raise _Err(-2, f"{path!r} (-ENOENT)")
            dentry = frag[name]
            ino = dentry["ino"]
        return ino, dentry

    def _parent_of(self, path: str) -> tuple[int, str]:
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise _Err(-22, "root has no parent (-EINVAL)")
        ino, dentry = self._walk("/".join(parts[:-1]))
        if dentry["type"] != "dir":
            raise _Err(-20, "not a directory (-ENOTDIR)")
        return ino, parts[-1]

    # -- capabilities (Locker role) ----------------------------------------
    def _grant(self, session: _Session, ino: int) -> None:
        session.caps.add(ino)
        self._cap_holders.setdefault(ino, set()).add(session)

    def _revoke(self, ino: int, requester: _Session | None) -> None:
        """Recall every OTHER session's cap on ``ino`` and wait for
        the acks — the mutation must not commit while a peer still
        trusts its cache (Locker::issue_caps / revoke flow)."""
        holders = self._cap_holders.get(ino)
        if not holders:
            return
        for sess in list(holders):
            if sess is requester:
                continue
            try:
                ack = sess.conn.call(
                    MClientCaps(action="revoke", ino=ino), timeout=5.0
                )
                if (
                    not isinstance(ack, MClientCaps)
                    or ack.action != "ack"
                ):
                    raise MessageError("bad cap ack")
            except (MessageError, OSError):
                # dead client: drop the whole session (its caps die
                # with it), exactly so one hung client cannot wedge
                # the namespace
                self._drop_session(sess)
            holders.discard(sess)
            sess.caps.discard(ino)
        if not self._cap_holders.get(ino):
            self._cap_holders.pop(ino, None)

    def _drop_session(self, sess: _Session) -> None:
        for ino in sess.caps:
            holders = self._cap_holders.get(ino)
            if holders:
                holders.discard(sess)
        sess.caps.clear()
        self._sessions.pop(sess.conn, None)

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if not isinstance(msg, MClientRequest):
            return False
        if self.shared_services:
            self._work_strand.submit(
                lambda: self._work_one((conn, msg))
            )
        else:
            self._workq.put((conn, msg))
        return True

    def _work_loop(self) -> None:
        while True:
            item = self._workq.get()
            if item is None:
                return
            self._work_one(item)

    def _work_one(self, item) -> None:
        if self._stop.is_set():
            return
        try:
            self._process(*item)
        except Exception as e:  # noqa: BLE001 — the worker
            # survives; the dead op files a crash report
            import traceback

            traceback.print_exc()
            crash_util.capture(
                f"mds.{self.name}", e, clog=self.clog
            )

    def _process(self, conn: Connection, msg: MClientRequest) -> None:
        reply = MClientReply(tid=msg.tid)
        try:
            with self._lock:
                if msg.op == "open_session":
                    args = json.loads(msg.args)
                    self._sessions[conn] = _Session(
                        conn, args.get("name", "")
                    )
                    reply.outb = json.dumps({"state": self.state})
                elif self.state != "active":
                    reply.rc = -11
                    reply.outs = "mds not active (-EAGAIN)"
                elif msg.op.startswith("peer_"):
                    # MDS→MDS sub-op (the slave-request seat): no
                    # client session — the caller is a peer rank
                    outb = self._handle_peer(
                        msg.op, json.loads(msg.args)
                    )
                    reply.outb = json.dumps(outb)
                else:
                    sess = self._sessions.get(conn)
                    if sess is None:
                        reply.rc = -1
                        reply.outs = "no session (-EPERM)"
                    elif msg.reqid and msg.reqid in sess.replies:
                        rc, outs, outb = sess.replies[msg.reqid]
                        reply.rc, reply.outs, reply.outb = rc, outs, outb
                    else:
                        outb = self._handle_op(
                            sess, msg.op, json.loads(msg.args)
                        )
                        reply.outb = json.dumps(outb)
                        if msg.reqid:
                            sess.replies[msg.reqid] = (
                                0, "", reply.outb,
                            )
                            while len(sess.replies) > 128:
                                sess.replies.pop(
                                    next(iter(sess.replies))
                                )
        except _Err as e:
            reply.rc, reply.outs = e.rc, str(e)
        except Exception as e:  # noqa: BLE001 — the RPC contract: an
            # op must always produce a reply
            reply.rc = -5
            reply.outs = f"{type(e).__name__}: {e}"
        try:
            conn.send(reply)
        except (MessageError, OSError):
            pass

    def ms_handle_reset(self, conn: Connection) -> None:
        with self._lock:
            sess = self._sessions.get(conn)
            if sess is not None:
                self._drop_session(sess)

    # -- ops (Server.cc handle_client_* reduced) ---------------------------
    def _handle_op(self, sess: _Session, op: str, args: dict) -> dict:
        self.ops_served += 1
        if op == "mkdir":
            self._check_auth(self._dirname(args["path"]))
            parent, name = self._parent_of(args["path"])
            if name in self._load_dir_or_empty(parent):
                raise _Err(-17, f"{args['path']!r} exists (-EEXIST)")
            self._revoke(parent, sess)
            ino = self._next_ino
            self._next_ino += 1
            self._journal_and_apply(
                {
                    "op": "mkdir", "parent": parent, "name": name,
                    "ino": ino, "mtime": time.time(),
                },
                force_flush=self._is_boundary(
                    self._dirname(args["path"])
                ),
            )
            return {"ino": ino}
        if op == "create":
            self._check_auth(self._dirname(args["path"]))
            parent, name = self._parent_of(args["path"])
            if name in self._load_dir_or_empty(parent):
                raise _Err(-17, f"{args['path']!r} exists (-EEXIST)")
            self._revoke(parent, sess)
            ino = self._next_ino
            self._next_ino += 1
            self._journal_and_apply(
                {
                    "op": "create", "parent": parent, "name": name,
                    "ino": ino, "mtime": time.time(),
                },
                force_flush=self._is_boundary(
                    self._dirname(args["path"])
                ),
            )
            return {"ino": ino}
        if op == "rmdir":
            self._check_auth(self._dirname(args["path"]))
            parent, name = self._parent_of(args["path"])
            frag = self._load_dir_or_empty(parent)
            if name not in frag:
                raise _Err(-2, f"{args['path']!r} (-ENOENT)")
            dentry = frag[name]
            if dentry["type"] != "dir":
                raise _Err(-20, "not a directory (-ENOTDIR)")
            if self._load_dir_or_empty(dentry["ino"]):
                raise _Err(-39, "not empty (-ENOTEMPTY)")
            self._revoke(parent, sess)
            self._revoke(dentry["ino"], sess)
            self._journal_and_apply(
                {
                    "op": "rmdir", "parent": parent, "name": name,
                    "ino": dentry["ino"],
                },
                force_flush=self._is_boundary(
                    self._dirname(args["path"])
                ),
            )
            return {}
        if op == "unlink":
            self._check_auth(self._dirname(args["path"]))
            parent, name = self._parent_of(args["path"])
            frag = self._load_dir_or_empty(parent)
            if name not in frag:
                raise _Err(-2, f"{args['path']!r} (-ENOENT)")
            dentry = frag[name]
            if dentry["type"] == "dir":
                raise _Err(-21, "is a directory (-EISDIR)")
            self._revoke(parent, sess)
            self._revoke(dentry["ino"], sess)
            self._journal_and_apply(
                {
                    "op": "unlink", "parent": parent, "name": name,
                    "ino": dentry["ino"],
                },
                force_flush=self._is_boundary(
                    self._dirname(args["path"])
                ),
            )
            return {"ino": dentry["ino"]}
        if op == "rename":
            src_dir = self._dirname(args["src"])
            dst_dir = self._dirname(args["dst"])
            self._check_auth(src_dir)
            sp, sn = self._parent_of(args["src"])
            sfrag = self._load_dir_or_empty(sp)
            if sn not in sfrag:
                raise _Err(-2, f"{args['src']!r} (-ENOENT)")
            dst_rank = self._auth_rank(dst_dir)
            if dst_rank != self.rank:
                # cross-subtree rename: the dst auth journals the
                # link (our "slave request", Migrator/Server
                # rename-across-auth reduced to link-then-unlink; a
                # crash between the two leaves the name visible in
                # BOTH places — never lost).  Flush FIRST: the moved
                # inode's dirty meta (size/mtime) must reach the
                # backing omap before the new auth loads it lazily —
                # the same export barrier a pin flip uses.
                self._flush()
                self._peer_call(
                    dst_rank, "peer_link",
                    {"dst": args["dst"], "dentry": sfrag[sn]},
                )
                self._revoke(sp, sess)
                self._journal_and_apply(
                    {"op": "rename_out", "parent": sp, "name": sn},
                    force_flush=self._is_boundary(src_dir),
                )
                return {}
            dp, dn = self._parent_of(args["dst"])
            if dn in self._load_dir_or_empty(dp):
                raise _Err(-17, f"{args['dst']!r} exists (-EEXIST)")
            self._revoke(sp, sess)
            self._revoke(dp, sess)
            self._journal_and_apply(
                {
                    "op": "rename", "sparent": sp, "sname": sn,
                    "dparent": dp, "dname": dn,
                    "dentry": sfrag[sn],
                },
                force_flush=(
                    self._is_boundary(src_dir)
                    or self._is_boundary(dst_dir)
                ),
            )
            return {}
        if op == "readdir":
            self._check_auth(args["path"])
            ino, dentry = self._walk(args["path"])
            if dentry["type"] != "dir":
                raise _Err(-20, "not a directory (-ENOTDIR)")
            self._grant(sess, ino)
            return {
                "ino": ino,
                "entries": self._load_dir_or_empty(ino),
            }
        if op == "stat":
            self._check_auth(args["path"])
            ino, dentry = self._walk(args["path"])
            try:
                meta = self._ino_meta(ino)
            except KeyError:
                meta = {}
            self._grant(sess, ino)
            return {
                "ino": ino,
                "type": dentry["type"],
                "size": int(meta.get("size", 0)),
                "mtime": float(meta.get("mtime", 0)),
            }
        if op == "setattr":
            self._check_auth(args["path"])
            ino, dentry = self._walk(args["path"])
            attrs = dict(args["attrs"])
            if args.get("grow_only") and "size" in attrs:
                try:
                    cur = int(self._ino_meta(ino).get("size", 0))
                except KeyError:
                    cur = 0
                attrs["size"] = max(cur, int(attrs["size"]))
            self._revoke(ino, sess)
            self._journal_and_apply(
                {"op": "setattr", "ino": ino, "attrs": attrs}
            )
            return {"ino": ino, "size": attrs.get("size")}
        raise _Err(-22, f"unknown op {op!r} (-EINVAL)")

    # -- MDS-to-MDS sub-ops (slave requests, reduced) ----------------------
    def _peer_call(self, rank: int, op: str, args: dict) -> dict:
        """Blocking sub-op on a peer active.  Runs on the worker
        thread (never the messenger loop — connect/call would
        deadlock there).  A timeout surfaces as -EAGAIN so the
        client retries the whole op; two opposite-direction
        cross-renames can in principle wait on each other's worker,
        and the timeout is what unwinds that (the reference orders
        slave requests by MDRequest instead)."""
        addr = self._peer_addrs.get(rank)
        if addr is None:
            raise _Err(-11, f"no active mds rank {rank} (-EAGAIN)")
        try:
            conn = self._peer_conns.get(rank)
            if conn is None or conn.is_closed:
                host, _, port = addr.rpartition(":")
                conn = self.msgr.connect(host, int(port))
                self._peer_conns[rank] = conn
            from ..msg.message import MClientRequest as _Req

            reply = conn.call(
                _Req(op=op, args=json.dumps(args)), timeout=5.0
            )
        except (MessageError, OSError) as e:
            self._peer_conns.pop(rank, None)
            raise _Err(-11, f"peer rank {rank} unreachable: {e} (-EAGAIN)")
        if reply.rc != 0:
            raise _Err(reply.rc, reply.outs)
        return json.loads(reply.outb) if reply.outb else {}

    def _handle_peer(self, op: str, args: dict) -> dict:
        if op == "peer_link":
            dst = args["dst"]
            self._check_auth(self._dirname(dst))
            dp, dn = self._parent_of(dst)
            existing = self._load_dir_or_empty(dp).get(dn)
            if existing is not None:
                if existing.get("ino") == args["dentry"].get("ino"):
                    # retried cross-rename whose first attempt
                    # already linked here: idempotent success (the
                    # ack was lost, not the commit)
                    return {}
                raise _Err(-17, f"{dst!r} exists (-EEXIST)")
            self._revoke(dp, None)
            self._journal_and_apply(
                {
                    "op": "rename_in", "parent": dp, "name": dn,
                    "dentry": args["dentry"],
                },
                force_flush=self._is_boundary(self._dirname(dst)),
            )
            return {}
        raise _Err(-22, f"unknown peer op {op!r} (-EINVAL)")


class _Err(Exception):
    def __init__(self, rc: int, msg: str):
        super().__init__(msg)
        self.rc = rc
