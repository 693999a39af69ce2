"""lockdep — lock-ordering cycle detection
(src/common/lockdep.cc reduced; SURVEY §5.2's race-detection tier).

The reference registers every named mutex and records, at acquire
time, "B taken while holding A" edges; a new edge that closes a cycle
in the global order graph is a potential deadlock and aborts with the
two conflicting backtraces — catching ABBA inversions on the FIRST
run through the code path, not the unlucky interleaving years later.

Same machinery here:

- ``Mutex(name)`` / ``RMutex(name)`` wrap threading locks; when
  lockdep is enabled, each acquire records order edges against every
  lock the thread already holds.
- a cycle (B before A registered while A-before-B exists, possibly
  transitively) raises ``LockOrderError`` naming the full cycle and
  where each edge was first taken.
- disabled (the default) the wrappers are plain locks — zero
  overhead in production daemons; tests and the thrasher enable it.

Orders are keyed by lock NAME, so every instance of "pg-lock" shares
one vertex — exactly lockdep's design: instance-level cycles across
different objects of the same class are the bugs worth catching.
"""

from __future__ import annotations

import threading
import traceback

_enabled = False
_state_lock = threading.Lock()
# order[a][b] = first-stack-trace where b was taken while holding a
_order: dict[str, dict[str, str]] = {}
_held = threading.local()


class LockOrderError(RuntimeError):
    pass


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    with _state_lock:
        _order.clear()


def enabled() -> bool:
    return _enabled


def _holding() -> list[str]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _path(src: str, dst: str) -> list[str] | None:
    """Existing order path src -> ... -> dst (DFS over the graph)."""
    seen = set()
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in _order.get(node, {}):
            stack.append((nxt, path + [nxt]))
    return None


def _will_lock(name: str, recursive: bool) -> None:
    holding = _holding()
    if not holding:
        return
    with _state_lock:
        for prev in holding:
            if prev == name:
                if recursive:
                    continue  # RMutex: same-class re-take is legal
                # nested acquisition of a non-recursive class: either
                # self-deadlock (same instance) or the classic two-
                # instance ABBA (pg1->pg2 in one thread, pg2->pg1 in
                # another) — real lockdep flags it here, from ONE
                # thread's behavior
                raise LockOrderError(
                    "nested acquisition of non-recursive lock "
                    + f"class {name!r}:" + chr(10)
                    + "".join(traceback.format_stack(limit=8))
                )
            # does an order name -> ... -> prev already exist?  Then
            # prev -> name closes a cycle.
            cycle = _path(name, prev)
            if cycle is not None:
                first = _order[cycle[0]][cycle[1]]
                raise LockOrderError(
                    f"lock order inversion: taking {name!r} while "
                    f"holding {prev!r}, but the inverse order "
                    f"{' -> '.join(cycle)} was established here:\n"
                    f"{first}\n--- current acquisition:\n"
                    + "".join(traceback.format_stack(limit=8))
                )
            edges = _order.setdefault(prev, {})
            if name not in edges:
                edges[name] = "".join(
                    traceback.format_stack(limit=8)
                )


def _locked(name: str) -> None:
    _holding().append(name)


def _unlocked(name: str) -> None:
    holding = _holding()
    # remove the most recent entry (locks release innermost-first in
    # well-formed code; lockdep tolerates out-of-order releases)
    for i in range(len(holding) - 1, -1, -1):
        if holding[i] == name:
            del holding[i]
            return


class Mutex:
    """threading.Lock with lockdep registration."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = name
        self._lock = self._factory()

    RECURSIVE = False

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if _enabled:
            _will_lock(self.name, self.RECURSIVE)
        got = self._lock.acquire(blocking, timeout)
        if got and _enabled:
            _locked(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        # unconditional: an acquire tracked before disable() must not
        # strand a phantom entry in the per-thread held stack
        _unlocked(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class RMutex(Mutex):
    """threading.RLock with lockdep registration."""

    RECURSIVE = True
    _factory = staticmethod(threading.RLock)
