"""Throttle — bounded-resource admission control
(src/common/Throttle.cc:1-876 reduced to the load-bearing contract).

The reference gates memory/in-flight-op budgets with a counted
throttle whose waiters wake FIFO (no barging: a large request parked
at the head must not starve behind a stream of small ones).  Same
semantics here: ``get`` blocks in arrival order, ``get_or_fail``
never blocks, ``put`` returns budget and wakes the head waiter(s).
"""

from __future__ import annotations

import collections
import threading
from . import lockdep


class Throttle:
    """Counted budget with FIFO waiters."""

    def __init__(self, name: str, max_: int):
        self.name = name
        self._max = max_
        self._count = 0
        self._lock = lockdep.Mutex(f"throttle.{name}")
        # FIFO of (amount, Event) — head wakes first (Throttle.cc's
        # ordered cond list)
        self._waiters: collections.deque = collections.deque()

    @property
    def max(self) -> int:
        return self._max

    @property
    def current(self) -> int:
        return self._count

    def past_midpoint(self) -> bool:
        return self._count >= self._max / 2

    def set_max(self, m: int) -> None:
        with self._lock:
            self._max = m
            self._wake_locked()

    def _fits_locked(self, c: int) -> bool:
        # a request larger than max is admitted alone (the reference
        # lets oversized requests through when the throttle is empty,
        # rather than deadlocking them forever)
        if c >= self._max:
            return self._count == 0
        return self._count + c <= self._max

    def _wake_locked(self) -> None:
        while self._waiters:
            amount, ev = self._waiters[0]
            if not self._fits_locked(amount):
                break
            self._count += amount
            self._waiters.popleft()
            ev.set()

    def get(self, c: int = 1, timeout: float | None = None) -> bool:
        """Take ``c`` units, blocking FIFO; False on timeout (the
        budget is NOT taken then)."""
        with self._lock:
            if not self._waiters and self._fits_locked(c):
                self._count += c
                return True
            ev = threading.Event()
            entry = (c, ev)
            self._waiters.append(entry)
        if ev.wait(timeout):
            return True
        with self._lock:
            if ev.is_set():
                return True  # won the race with the timeout
            self._waiters.remove(entry)
            self._wake_locked()  # our slot may unblock smaller heads
            return False

    def get_or_fail(self, c: int = 1) -> bool:
        with self._lock:
            if self._waiters or not self._fits_locked(c):
                return False
            self._count += c
            return True

    def put(self, c: int = 1) -> int:
        with self._lock:
            self._count = max(0, self._count - c)
            self._wake_locked()
            return self._count
