"""rbd exclusive lock — cooperative write arbitration on an image
(the ManagedLock/ExclusiveLock state machines,
src/librbd/ManagedLock.cc:1, src/librbd/exclusive_lock/ — redesigned
as one small client-side protocol object instead of a callback state
machine; the asyncio-era control flow those 854 LoC of continuations
encode is a plain method sequence here).

The lock itself is the cls_lock record on the image header object
(src/cls/lock/cls_lock.cc role); coordination rides watch/notify on
the same object:

- ``acquire`` tries ``lock.lock``; on -EBUSY it notifies
  ``request_lock`` and waits for the owner's cooperative release
  (the owner flushes its cache and unlocks; cls unlock broadcasts
  ``unlocked`` to every watcher).
- An owner that never answers is DEAD or partitioned: after
  ``break_timeout`` the waiter **fences** it — OSDMap-blocklists the
  owner's client id (every OSD then rejects its ops, including any
  in-flight writeback), force-unlocks the stale record, and takes
  the lock.  This is the reference's break-lock + blocklist flow
  (ManagedLock::break_lock, ExclusiveLock's
  blacklist-on-break) and is what makes two mounts of one image
  safe against a half-dead writer.

The lock cookie is ``<client_id>:<watch_cookie>`` so a breaker knows
exactly which client to fence and which watch to test for liveness.
"""

from __future__ import annotations

import json
import threading
import time

from ..osdc.objecter import RadosError

__all__ = ["ExclusiveLock", "LockBusy"]


class LockBusy(RadosError):
    """Another client holds the lock and is still alive."""


class ExclusiveLock:
    def __init__(
        self,
        ioctx,
        header_oid: str,
        *,
        request_timeout: float = 2.0,
        break_timeout: float = 5.0,
        on_release_request=None,
    ):
        """``on_release_request()`` is the owner-side hook: called
        (off the watch thread) when a peer asks for the lock; it must
        quiesce writes, flush, and call :meth:`release`."""
        self.ioctx = ioctx
        self.oid = header_oid
        self.request_timeout = request_timeout
        self.break_timeout = break_timeout
        self.on_release_request = on_release_request
        self._watch_cookie: int | None = None
        self._owned = False
        self._lock = threading.Lock()
        self._released = threading.Event()

    # -- identity ----------------------------------------------------------
    @property
    def cookie(self) -> str:
        return f"{self.ioctx.rados.client_id}:{self._watch_cookie}"

    @property
    def is_owner(self) -> bool:
        return self._owned

    # -- watch plumbing ----------------------------------------------------
    def _ensure_watch(self) -> None:
        if self._watch_cookie is not None:
            return
        self._watch_cookie = self.ioctx.watch(self.oid, self._on_notify)

    def _on_notify(self, payload: bytes):
        try:
            ev = json.loads(payload)
        except ValueError:
            return None
        if ev.get("event") == "request_lock":
            if self._owned and self.on_release_request is not None:
                # hand off OUTSIDE the notify ack path: the requester
                # is waiting on the 'unlocked' broadcast, not our ack
                threading.Thread(
                    target=self._cooperative_release, daemon=True
                ).start()
            return b"owner" if self._owned else b"idle"
        if ev.get("event") == "unlocked":
            self._released.set()
        return None

    def _cooperative_release(self) -> None:
        try:
            self.on_release_request()
        except Exception:
            pass

    # -- core protocol -----------------------------------------------------
    def _try_lock(self) -> bool:
        try:
            self.ioctx.execute(
                self.oid, "lock", "lock",
                json.dumps({"cookie": self.cookie,
                            "type": "exclusive"}).encode(),
            )
            return True
        except RadosError as e:
            if "EBUSY" in str(e):
                return False
            raise

    def _holder(self) -> str | None:
        info = json.loads(self.ioctx.execute(
            self.oid, "lock", "get_info", b""
        ))
        holders = list(info.get("holders", {}))
        return holders[0] if holders else None

    def acquire(self) -> None:
        """Block until this client owns the lock, requesting a
        cooperative handoff; a DEAD owner (its watch never acks the
        request) is fenced and its lock broken.  A live owner that
        acks but keeps the lock past ``break_timeout`` raises
        :class:`LockBusy` — liveness is the break criterion, not
        patience (ManagedLock breaks only an expired/dead locker)."""
        with self._lock:
            if self._owned:
                return
            self._ensure_watch()
            if self._try_lock():
                self._owned = True
                return
            deadline = time.monotonic() + self.break_timeout
            dead_owner: str | None = None
            while time.monotonic() < deadline:
                self._released.clear()
                acks = self.ioctx.notify(self.oid, json.dumps(
                    {"event": "request_lock", "from": self.cookie}
                ).encode())
                if self._try_lock():
                    self._owned = True
                    return
                owner = self._holder()
                if owner is None:
                    continue  # released; retry the lock op
                # is the owner's watch alive?  its watch cookie is in
                # the lock cookie; an owner that did not ack the
                # notify is gone (or partitioned) — fence it
                _oc, _, own_wc = owner.partition(":")
                if not any(
                    a["acked"] and str(a["cookie"]) == own_wc
                    for a in acks
                ):
                    dead_owner = owner
                    break
                self._released.wait(self.request_timeout)
            owner = self._holder()
            if owner is None and self._try_lock():
                self._owned = True
                return
            if owner is None or owner != dead_owner:
                # either we lost a race to another waiter, or the
                # holder CHANGED since the liveness test — the cookie
                # we proved dead is the ONLY one we may fence
                # (blocklisting whoever holds it now could fence a
                # live, healthy new owner)
                raise LockBusy(
                    f"image lock held by live owner {owner!r} (-EBUSY)"
                )
            self._break_lock(owner)
            if not self._try_lock():
                raise LockBusy("lost the break-lock race (-EBUSY)")
            self._owned = True

    def _break_lock(self, owner: str) -> None:
        """Fence-then-break (ManagedLock::break_lock): blocklist the
        dead owner FIRST so any write it still has in flight is
        rejected, then remove its stale lock record."""
        own_client, _, _wc = owner.partition(":")
        if own_client and own_client != self.ioctx.rados.client_id:
            self.ioctx.rados.blocklist_add(own_client)
        try:
            self.ioctx.execute(
                self.oid, "lock", "unlock",
                json.dumps({"cookie": owner}).encode(),
            )
        except RadosError as e:
            if "ENOENT" not in str(e):
                raise

    def release(self) -> None:
        with self._lock:
            if not self._owned:
                return
            self._owned = False
            try:
                self.ioctx.execute(
                    self.oid, "lock", "unlock",
                    json.dumps({"cookie": self.cookie}).encode(),
                )
            except RadosError as e:
                if "ENOENT" not in str(e):
                    raise

    def close(self) -> None:
        self.release()
        if self._watch_cookie is not None:
            try:
                self.ioctx.unwatch(self.oid, self._watch_cookie)
            except RadosError:
                pass
            self._watch_cookie = None
