"""The capability-aware FS client (src/client/Client.cc reduced).

Metadata goes through the MDS session (MClientRequest); file DATA is
striped straight to the data pool with the REAL CephFS object naming
(<ino:x>.<objno:08x>), exactly like the kernel/fuse clients talk to
OSDs directly.  readdir/stat results are cached while the MDS-granted
capability stands; a cap recall (MClientCaps revoke, pushed by the
MDS before a sibling's conflicting mutation commits) invalidates the
cache — coherence by recall, not by polling.

Failover: when the MDS connection dies the client re-resolves the
active MDS from the monitor ("mds stat"), reopens its session (the
reference's reconnect phase; all caps are implicitly dropped) and
retries the op.  Retried mutations reconcile at-least-once delivery:
a retry observing EEXIST (mkdir/create) or ENOENT (unlink/rmdir/
rename-src) after a reconnect checks whether the FIRST attempt
already landed and treats that as success — the reference dedups via
session reqids, which die with the failed MDS here too (sessions are
in-memory; deviation documented in the package docstring).
"""

from __future__ import annotations

import itertools
import json
import stat as statmod
import threading
import time

from ..msg import Messenger
from ..msg.message import MClientCaps, MClientReply, MClientRequest
from ..msg.messenger import Connection, Dispatcher, MessageError
from ..fs import _data_oid  # one definition of the on-disk naming
from ..osdc.objecter import ObjectNotFound, RadosError
from ..osdc.striper import StripeLayout, map_extent


class MDSError(RadosError):
    def __init__(self, rc: int, msg: str):
        super().__init__(msg)
        self.rc = rc


class MDSClient(Dispatcher):
    """One mounted filesystem through the MDS tier."""

    def __init__(
        self,
        rados,
        data_pool: str,
        name: str = "client",
        layout: StripeLayout | None = None,
        op_timeout: float = 30.0,
    ):
        self.rados = rados
        self.data = rados.open_ioctx(data_pool)
        self.layout = layout or StripeLayout(
            stripe_unit=1 << 20, stripe_count=1, object_size=1 << 22
        )
        self.name = name
        self.op_timeout = op_timeout
        self.msgr = Messenger(f"fsclient.{name}")
        self.msgr.add_dispatcher(self)
        self.msgr.start()
        self._lock = threading.RLock()
        # one session per ACTIVE RANK (multi-MDS): ops route to the
        # subtree's auth rank by longest-prefix match of the client's
        # copy of the mon's stable pin table
        self._conns: dict[int, Connection] = {}
        self._subtrees: dict[str, int] = {"/": 0}
        # caches valid while the cap stands: ino -> payload, plus the
        # path -> ino tags to invalidate on recall
        self._dir_cache: dict[int, dict] = {}
        self._stat_cache: dict[str, dict] = {}
        self._reqids = itertools.count(1)
        self.recalls = 0  # observability: cap revokes received
        # bumped on every recall: an in-flight readdir/stat must not
        # cache its reply if a recall landed while it was pending
        # (the reply could predate the mutation the recall fences)
        self._recall_gen = 0
        self._connect()

    def close(self) -> None:
        self.msgr.shutdown()

    # -- session / failover / routing --------------------------------------
    def _mdsmap(self) -> dict:
        rc, outb, outs = self.rados.mon_command({"prefix": "mds stat"})
        if rc != 0:
            raise MDSError(rc, outs)
        m = json.loads(outb)
        if not m.get("actives"):
            raise MDSError(-11, "no active mds (-EAGAIN)")
        with self._lock:
            self._subtrees = dict(m.get("subtrees") or {"/": 0})
        return m

    def _auth_rank(self, path: str) -> int:
        """Longest-prefix match against the stable pin table (the
        client-side half of subtree delegation: ops go straight to
        the auth rank)."""
        from . import subtree_auth_rank

        with self._lock:
            table = dict(self._subtrees)
        return subtree_auth_rank(table, path)

    def _connect(self, rank: int = 0) -> Connection:
        m = self._mdsmap()
        addr = m["actives"].get(str(rank))
        if addr is None:
            raise MDSError(-11, f"no active mds rank {rank} (-EAGAIN)")
        addr = addr["addr"] if isinstance(addr, dict) else addr
        old = self._conns.get(rank)
        if old is not None and not old.is_closed:
            try:
                old.close()
            except (MessageError, OSError):
                pass
        host, _, port = addr.rpartition(":")
        conn = self.msgr.connect(host, int(port))
        reply = conn.call(
            MClientRequest(
                op="open_session",
                args=json.dumps({"name": self.name}),
            ),
            timeout=10.0,
        )
        if not isinstance(reply, MClientReply) or reply.rc != 0:
            raise MDSError(-5, "session open failed")
        with self._lock:
            self._conns[rank] = conn
            # a fresh session holds no caps: nothing cached is covered
            self._dir_cache.clear()
            self._stat_cache.clear()
        return conn

    def _call(
        self,
        op: str,
        args: dict,
        reqid: str | None = None,
        path: str | None = None,
    ):
        """One metadata op with failover retry and subtree routing:
        a -ESTALE "not auth" reply refreshes the pin table and
        re-routes (the reference MDS forwards instead)."""
        deadline = time.monotonic() + self.op_timeout
        reqid = reqid or f"{self.name}.{next(self._reqids)}"
        retried = False
        rank = self._auth_rank(path) if path is not None else 0
        while True:
            conn = self._conns.get(rank)
            try:
                if conn is None or conn.is_closed:
                    raise MessageError("no mds connection")
                reply = conn.call(
                    MClientRequest(
                        op=op, args=json.dumps(args), reqid=reqid
                    ),
                    timeout=10.0,
                )
                if not isinstance(reply, MClientReply):
                    raise MessageError("bad reply")
                if reply.rc == -11:  # mds not active: map is moving
                    raise MessageError(reply.outs)
                if reply.rc == -116:
                    # not the auth (our table is stale): refresh and
                    # re-route to the hinted/looked-up rank
                    if time.monotonic() >= deadline:
                        raise MDSError(-110, "mds re-route timeout")
                    try:
                        self._mdsmap()
                    except MDSError:
                        # actives momentarily empty mid-failover:
                        # keep the retry budget, not a hard error
                        time.sleep(0.25)
                        continue
                    new_rank = (
                        self._auth_rank(path)
                        if path is not None
                        else 0
                    )
                    if new_rank == rank:
                        time.sleep(0.25)  # table still propagating
                    rank = new_rank
                    if rank not in self._conns or (
                        self._conns[rank] is None
                        or self._conns[rank].is_closed
                    ):
                        try:
                            self._connect(rank)
                        except (MDSError, MessageError, OSError):
                            time.sleep(0.25)
                    continue
                if reply.rc != 0:
                    if retried:
                        out = self._retry_outcome(op, args, reply)
                        if out is not None:
                            return out
                    raise MDSError(reply.rc, reply.outs)
                return json.loads(reply.outb)
            except (MessageError, OSError) as e:
                if time.monotonic() >= deadline:
                    raise MDSError(-110, f"mds op timeout: {e}")
                retried = True
                time.sleep(0.25)
                if path is not None:
                    rank = self._auth_rank(path)
                try:
                    self._connect(rank)
                except (MDSError, MessageError, OSError):
                    continue

    @staticmethod
    def _dirof(path: str) -> str:
        from . import path_dirname

        return path_dirname(path)

    def _retry_outcome(self, op, args, reply) -> dict | None:
        """At-least-once reconciliation after a failover retry: the
        first attempt may have committed before the MDS died."""
        if reply.rc == -17 and op in ("mkdir", "create"):
            st = self._call(
                "stat", {"path": args["path"]}, path=args["path"]
            )
            want = "dir" if op == "mkdir" else "file"
            if st.get("type") == want:
                return {"ino": st["ino"]}
        if reply.rc == -2 and op in ("unlink", "rmdir"):
            return {}
        if reply.rc == -2 and op == "rename":
            try:
                self._call(
                    "stat", {"path": args["dst"]}, path=args["dst"]
                )
                return {}
            except MDSError:
                pass
        return None

    # -- cap recall --------------------------------------------------------
    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if not isinstance(msg, MClientCaps) or msg.action != "revoke":
            return False
        with self._lock:
            self.recalls += 1
            self._recall_gen += 1
            self._dir_cache.pop(msg.ino, None)
            self._stat_cache = {
                p: st
                for p, st in self._stat_cache.items()
                if st["ino"] != msg.ino and st["_pino"] != msg.ino
            }
        try:
            conn.send(MClientCaps(action="ack", ino=msg.ino, tid=msg.tid))
        except (MessageError, OSError):
            pass
        return True

    def ms_handle_reset(self, conn: Connection) -> None:
        with self._lock:
            for rank, c in list(self._conns.items()):
                if c is conn:
                    self._conns.pop(rank, None)
                    self._dir_cache.clear()
                    self._stat_cache.clear()

    # -- metadata verbs ----------------------------------------------------
    def _local_invalidate(self, *paths: str) -> None:
        """Drop OWN cached state touched by an own mutation — the MDS
        exempts the requester from the cap recall (it just told us),
        so self-coherence is the client's job."""
        with self._lock:
            for p in paths:
                st = self._stat_cache.pop(p, None)
                if st is not None:
                    self._dir_cache.pop(st["ino"], None)
                parts = [x for x in p.split("/") if x]
                parent = "/".join(parts[:-1])
                pst = self._stat_cache.get(parent)
                if pst is not None:
                    self._dir_cache.pop(pst["ino"], None)
                else:
                    # parent ino unknown (its stat was never cached):
                    # a targeted drop is impossible, and a stale
                    # parent listing would show the old name — clear
                    # the dir cache conservatively
                    self._dir_cache.clear()

    def mkdir(self, path: str) -> int:
        out = self._call("mkdir", {"path": path},
                         path=self._dirof(path))
        self._local_invalidate(path)
        return out["ino"]

    def rmdir(self, path: str) -> None:
        self._call("rmdir", {"path": path}, path=self._dirof(path))
        self._local_invalidate(path)

    def create(self, path: str) -> int:
        out = self._call("create", {"path": path},
                         path=self._dirof(path))
        self._local_invalidate(path)
        return out["ino"]

    def rename(self, src: str, dst: str) -> None:
        self._call("rename", {"src": src, "dst": dst},
                   path=self._dirof(src))
        self._local_invalidate(src, dst)

    def readdir(self, path: str = "/") -> list[str]:
        with self._lock:
            st = self._stat_cache.get(path)
            if st is not None and st["ino"] in self._dir_cache:
                return sorted(self._dir_cache[st["ino"]])
        with self._lock:
            gen = self._recall_gen
        out = self._call("readdir", {"path": path}, path=path)
        with self._lock:
            if self._recall_gen == gen:
                self._dir_cache[out["ino"]] = out["entries"]
        return sorted(out["entries"])

    def stat(self, path: str) -> dict:
        with self._lock:
            st = self._stat_cache.get(path)
            if st is not None:
                return dict(st)
        with self._lock:
            gen = self._recall_gen
        out = self._call("stat", {"path": path}, path=path)
        st = {
            "ino": out["ino"],
            "type": out["type"],
            "size": out["size"],
            "mtime": out["mtime"],
            "mode": (
                statmod.S_IFDIR
                if out["type"] == "dir"
                else statmod.S_IFREG
            ),
            "_pino": self._parent_ino_tag(path),
        }
        with self._lock:
            if self._recall_gen == gen:
                self._stat_cache[path] = st
        return dict(st)

    def _parent_ino_tag(self, path: str) -> int:
        """Tag cached stats with the parent dir's ino when we hold it
        cached, so a recall on the DIRECTORY also drops child stats
        (the dentry lease rides the dir cap here)."""
        parts = [p for p in path.split("/") if p]
        parent = "/".join(parts[:-1])
        with self._lock:
            st = self._stat_cache.get(parent)
            return st["ino"] if st is not None else -1

    def unlink(self, path: str) -> None:
        out = self._call("unlink", {"path": path},
                         path=self._dirof(path))
        self._local_invalidate(path)
        ino = out.get("ino")
        if ino is not None:
            prefix = f"{ino:x}."
            for oid in self.data.list_objects():
                if oid.startswith(prefix):
                    try:
                        self.data.remove(oid)
                    except (ObjectNotFound, RadosError):
                        pass

    # -- file I/O (client -> data pool directly) ---------------------------
    def write(self, path: str, offset: int, data: bytes) -> int:
        st = self.stat(path)
        if st["type"] != "file":
            raise MDSError(-21, f"{path!r}: not a file (-EISDIR)")
        data = bytes(data)
        pos = 0
        for objectno, obj_off, n in map_extent(
            self.layout, offset, len(data)
        ):
            self.data.write(
                _data_oid(st["ino"], objectno),
                data[pos : pos + n],
                offset=obj_off,
            )
            pos += n
        # size/mtime flush to the MDS (the cap-flush analog)
        self._call(
            "setattr",
            {
                "path": path,
                "attrs": {
                    "size": offset + len(data),
                    "mtime": time.time(),
                },
                "grow_only": True,
            },
            path=path,
        )
        with self._lock:
            self._stat_cache.pop(path, None)
        return len(data)

    def read(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        st = self.stat(path)
        if st["type"] != "file":
            raise MDSError(-21, f"{path!r}: not a file (-EISDIR)")
        size = st["size"]
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
                    _data_oid(st["ino"], objectno),
                    length=n,
                    offset=obj_off,
                )
            except (ObjectNotFound, RadosError):
                got = b""
            parts.append(got + b"\0" * (n - len(got)))
        return b"".join(parts)

    def truncate(self, path: str, size: int) -> None:
        st = self.stat(path)
        if st["type"] != "file":
            raise MDSError(-21, f"{path!r}: not a file (-EISDIR)")
        if size < st["size"]:
            for objectno, obj_off, n in map_extent(
                self.layout, size, st["size"] - size
            ):
                try:
                    self.data.write(
                        _data_oid(st["ino"], objectno),
                        b"\0" * n,
                        offset=obj_off,
                    )
                except RadosError:
                    pass
        self._call(
            "setattr", {"path": path, "attrs": {"size": size}},
            path=path,
        )
        with self._lock:
            self._stat_cache.pop(path, None)
