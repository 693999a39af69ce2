"""Shared PG-backend machinery: scrub result + per-object op ordering.

Both backends (ec_store, replicated) order client ops per object the
same way — the reference's waiting_state/waiting_reads/waiting_commit
op lists collapsed to a FIFO ticket queue — and report scrub findings
in the same shape, so the machinery lives once here.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque


class ScrubResult:
    def __init__(self):
        self.missing: list[int] = []
        self.corrupt: list[int] = []
        # faults that cannot be attributed to one shard/replica
        self.inconsistent: bool = False

    @property
    def clean(self) -> bool:
        return (
            not self.missing and not self.corrupt and not self.inconsistent
        )

    def __repr__(self):
        return (
            f"ScrubResult(missing={self.missing}, corrupt={self.corrupt}, "
            f"inconsistent={self.inconsistent})"
        )


class ObjectOpQueue:
    """Per-object FIFO tickets: ops on one object run in submission
    order; ops on different objects proceed concurrently."""

    def __init__(self):
        self._cond = threading.Condition()
        self._queues: dict[str, deque[int]] = {}
        self._tickets = itertools.count(1)

    def enter(self, name: str, on_enter=None) -> int:
        with self._cond:
            ticket = next(self._tickets)
            q = self._queues.setdefault(name, deque())
            q.append(ticket)
            if on_enter is not None:
                on_enter()
            while q[0] != ticket:
                self._cond.wait()
            return ticket

    def exit(self, name: str, ticket: int, on_exit=None):
        """Release the ticket; returns on_exit()'s result (run under
        the queue lock) so callers can hand values out of the critical
        section without closure plumbing."""
        with self._cond:
            q = self._queues[name]
            assert q[0] == ticket
            q.popleft()
            if not q:
                del self._queues[name]
            result = on_exit() if on_exit is not None else None
            self._cond.notify_all()
            return result
