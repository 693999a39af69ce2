"""Op scheduler — the OSD worker queue with QoS classes
(src/osd/scheduler/OpScheduler.cc + WeightedPriorityQueue.h reduced).

The reference feeds every shard worker from an OpScheduler: strict
items (peering/map events) preempt everything, and the remaining
classes (client ops, recovery, scrub/background) share the worker in
proportion to configured weights via a weighted round-robin over op
COST — so a burst of background work cannot starve client ops, and
vice versa.  Same machinery here, replacing the plain FIFO the
daemon's worker drained before:

- ``enqueue(klass, cost, item)`` / ``dequeue()`` — the OpScheduler
  surface; CLASS_STRICT dequeues first, always in FIFO order.
- weighted classes drain by deficit round-robin: each visit grants a
  class ``weight`` credits; items charge their cost against them —
  byte-sized client ops and chunky recovery pushes share accurately.
- ``put``/``get`` aliases keep the queue.Queue shape the daemon's
  producers already use (None = shutdown sentinel, delivered ahead
  of everything).
"""

from __future__ import annotations

import collections
import threading

CLASS_STRICT = "strict"  # peering/map/activation: never queued behind IO
CLASS_CLIENT = "client"
CLASS_RECOVERY = "recovery"
CLASS_BACKGROUND = "background"  # scrub, splits, trims

DEFAULT_WEIGHTS = {
    # osd_op_queue weights role: client IO dominates, recovery gets a
    # protected share, background trickles
    CLASS_CLIENT: 63,
    CLASS_RECOVERY: 10,
    CLASS_BACKGROUND: 5,
}


class _SchedulerBase:
    """Shared scheduler chassis: the strict deque (peering/map events
    preempt all QoS), the drain-aware shutdown sentinel, and the
    queue.Queue-shaped put/get aliases — subclasses supply only the
    weighted enqueue and pick policy."""

    def __init__(self, classes):
        self._draining = False
        self._strict: collections.deque = collections.deque()
        self._queues: dict[str, collections.deque] = {
            k: collections.deque() for k in classes
        }
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._size = 0
        # event-driven consumers (the shared-services strand drain)
        # register here: called AFTER every enqueue/put, outside the
        # scheduler lock, so a drain can be kicked without a thread
        # parked in get()
        self.on_enqueue = None
        # recent dequeue classes (observability: tests prove client
        # ops interleave with a recovery storm from this trace)
        self.class_log: collections.deque = collections.deque(
            maxlen=512
        )

    def enqueue(self, klass: str, cost: int, item) -> None:
        with self._cond:
            if klass == CLASS_STRICT:
                self._strict.append(item)
            elif klass not in self._queues:
                # an unregistered QoS class must not ride the strict
                # lane (that would let any client BYPASS QoS by naming
                # a class): it degrades to the default client class,
                # or strict only when no client queue exists at all
                if CLASS_CLIENT in self._queues:
                    self._enqueue_weighted(
                        CLASS_CLIENT, max(int(cost), 1), item
                    )
                else:
                    self._strict.append(item)
            else:
                self._enqueue_weighted(klass, max(int(cost), 1), item)
            self._size += 1
            self._cond.notify()
        cb = self.on_enqueue
        if cb is not None:
            cb()

    def known_class(self, klass: str) -> bool:
        """True when this scheduler has a registered queue (weight or
        dmclock profile) for ``klass``."""
        return klass in self._queues

    def last_class(self) -> str | None:
        """The class the most recent dequeue served (single-consumer
        worker loops use this to coalesce follow-on work from the
        same class)."""
        return self.class_log[-1] if self.class_log else None

    def drain_class(self, klass: str, predicate, max_n: int) -> list:
        """Write-coalescing hook: pop up to ``max_n`` CONSECUTIVE
        head items of ``klass``'s queue that satisfy ``predicate``
        (first non-match stops the drain — skipping over it would
        reorder the class's stream, and per-object ordering is the
        invariant batching must keep).  The drained items ride the
        dispatch the caller is already committing, so their costs are
        still charged (subclass hook) — cross-class fairness is
        perturbed by at most one bounded burst, exactly like the
        reference's op-shard batching.  ``predicate`` runs under the
        scheduler lock: it must be cheap and lock-free."""
        out: list = []
        with self._cond:
            q = self._queues.get(klass)
            if not q:
                return out
            while q and len(out) < max_n:
                entry = q[0]
                item = entry[-1]
                if not predicate(item):
                    break
                q.popleft()
                self._size -= 1
                self._drained(klass, entry)
                self.class_log.append(klass)
                out.append(item)
        return out

    def _drained(self, klass: str, entry) -> None:
        """Cost accounting for an item drained outside dequeue()
        (default: none — dmclock tags advanced at enqueue)."""

    def qlen(self) -> int:
        with self._lock:
            return self._size

    def put(self, item) -> None:
        """None marks the queue DRAINING — the consumer sees it only
        once everything already queued has been served (queue.Queue's
        FIFO sentinel semantics the daemon's shutdown relies on);
        legacy tuples go strict."""
        if item is None:
            with self._cond:
                self._draining = True
                self._cond.notify_all()
            cb = self.on_enqueue
            if cb is not None:
                cb()  # wake an event-driven drain to observe draining
            return
        self.enqueue(CLASS_STRICT, 0, item)

    def get(self, timeout: float | None = None):
        return self.dequeue(timeout)


class WeightedPriorityQueue(_SchedulerBase):
    """Strict + deficit-weighted-round-robin work queue."""

    def __init__(self, weights: dict[str, int] | None = None):
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        super().__init__(self.weights)
        self._credit: dict[str, float] = {k: 0.0 for k in self.weights}
        self._rr = list(self.weights)  # round-robin order
        self._rr_pos = 0
        self._fresh = True  # current class not yet granted this visit

    def set_weight(self, klass: str, weight: int) -> None:
        """Register (or retune) a weighted class at runtime — the
        osd_op_queue per-class weight knob."""
        with self._cond:
            self.weights[klass] = int(weight)
            if klass not in self._queues:
                self._queues[klass] = collections.deque()
                self._credit[klass] = 0.0
                self._rr.append(klass)

    def _enqueue_weighted(self, klass: str, cost: int, item) -> None:
        self._queues[klass].append((cost, item))

    def _drained(self, klass: str, entry) -> None:
        # charge the drained item's cost; credit may go negative, so
        # the class yields the worker longer afterwards — fairness
        # holds over time even though the burst ran now
        if klass in self._credit:
            self._credit[klass] -= entry[0]

    def dequeue(self, timeout: float | None = None):
        with self._cond:
            while self._size == 0:
                if self._draining:
                    return None  # shutdown AFTER the queue drained
                if not self._cond.wait(timeout):
                    raise TimeoutError("queue idle")
            self._size -= 1
            if self._strict:
                self.class_log.append(CLASS_STRICT)
                return self._strict.popleft()
            # deficit round-robin: the current class serves while its
            # credit lasts (a burst proportional to its weight), gets
            # ONE quantum grant per visit, then yields the worker —
            # an expensive head accumulates credit across laps
            # instead of being skipped forever
            n = len(self._rr)
            spins = 0
            while spins <= 2 * n:
                klass = self._rr[self._rr_pos]
                q = self._queues[klass]
                if not q:
                    # clear UNUSED positive credit, but keep drain
                    # DEBT (negative, from coalesced bursts): a class
                    # that repeatedly empties its queue between
                    # bursts must still pay for them
                    self._credit[klass] = min(self._credit[klass], 0.0)
                    self._rr_pos = (self._rr_pos + 1) % n
                    self._fresh = True
                    spins += 1
                    continue
                if self._fresh:
                    # the quantum grants on ARRIVAL at a class, once
                    # per visit — granting whenever credit ran short
                    # would let one class hold the worker forever
                    self._credit[klass] += self.weights[klass]
                    self._fresh = False
                cost, item = q[0]
                if cost <= self._credit[klass]:
                    q.popleft()
                    self._credit[klass] -= cost
                    if not q:
                        self._credit[klass] = min(
                            self._credit[klass], 0.0
                        )
                    self.class_log.append(klass)
                    return item
                self._rr_pos = (self._rr_pos + 1) % n
                self._fresh = True
                spins += 1
            # every head exceeded a full lap of grants: serve the
            # cheapest head rather than stalling
            best = min(
                (q[0][0], k)
                for k, q in self._queues.items()
                if q
            )
            cost, item = self._queues[best[1]].popleft()
            self._credit[best[1]] = min(self._credit[best[1]], 0.0)
            self.class_log.append(best[1])
            return item


class MClockQueue(_SchedulerBase):
    """dmClock-style QoS queue (the mclock_scheduler role,
    src/osd/scheduler/mClockScheduler.cc over the dmclock library) —
    the reference's DEFAULT osd_op_queue.

    Each class gets (reservation, weight, limit) in cost-units/sec:

    - reservation: guaranteed rate — requests whose reservation tag
      has come due are served FIRST, in tag order, regardless of
      weights (the qos floor);
    - limit: hard cap — a request whose limit tag lies in the future
      is ineligible even when the worker idles (anti-starvation for
      OTHER consumers of the device behind this queue);
    - weight: proportional share of whatever capacity remains.

    Tags advance by cost/rate per request (dmclock's RhoPhi tags with
    delta/rho collapsed for the single-server case).  The clock is
    injectable so QoS tests drive virtual time deterministically.
    Strict items (peering/map events) bypass QoS entirely, and the
    drain-aware ``put(None)`` sentinel matches WeightedPriorityQueue.
    """

    def __init__(
        self,
        profiles: dict[str, tuple[float, float, float]] | None = None,
        clock=None,
        cost_unit: float = 4096.0,
    ):
        import time as _time

        # (reservation, weight, limit) per class in COST-UNITS/sec;
        # limit 0 = none.  The daemon enqueues BYTE costs, so
        # cost_unit converts (default: one 4KB op = one unit).  The
        # defaults cap only background work — a default limit on
        # recovery would stall pulls outright when uncontended.
        self.profiles = dict(
            profiles
            or {
                CLASS_CLIENT: (100.0, 60.0, 0.0),
                CLASS_RECOVERY: (20.0, 20.0, 0.0),
                CLASS_BACKGROUND: (5.0, 10.0, 100.0),
            }
        )
        super().__init__(self.profiles)
        self.clock = clock or _time.monotonic
        self.cost_unit = cost_unit
        # next-tag state per class
        self._rtag: dict[str, float] = {}
        self._wtag: dict[str, float] = {}
        self._ltag: dict[str, float] = {}

    def set_profile(
        self, klass: str, profile: tuple[float, float, float]
    ) -> None:
        """Register (or retune) a dmclock class at runtime: the
        (reservation, weight, limit) triple in cost-units/sec — how
        per-tenant QoS classes (gold/bulk/...) come to exist."""
        res, wgt, lim = (float(x) for x in profile)
        with self._cond:
            self.profiles[klass] = (res, wgt, lim)
            if klass not in self._queues:
                self._queues[klass] = collections.deque()

    def _enqueue_weighted(self, klass: str, cost: int, item) -> None:
        now = self.clock()
        res, wgt, lim = self.profiles[klass]
        c = max(float(cost), 1.0) / self.cost_unit
        c = max(c, 1e-6)
        rtag = max(
            now, self._rtag.get(klass, 0.0)
        ) + (c / res if res > 0 else float("inf"))
        wtag = max(now, self._wtag.get(klass, 0.0)) + c / max(
            wgt, 1e-9
        )
        ltag = (
            max(now, self._ltag.get(klass, 0.0)) + c / lim
            if lim > 0
            else now
        )
        self._rtag[klass] = rtag
        self._wtag[klass] = wtag
        self._ltag[klass] = ltag
        self._queues[klass].append((rtag, wtag, ltag, item))

    def _pick_locked(self):
        now = self.clock()
        # 1) reservation phase: any head whose reservation tag is due
        due = [
            (q[0][0], k)
            for k, q in self._queues.items()
            if q and q[0][0] <= now
        ]
        if due:
            _tag, k = min(due)
            self.class_log.append(k)
            return self._queues[k].popleft()[3]
        # 2) weight phase among limit-eligible heads
        eligible = [
            (q[0][1], k)
            for k, q in self._queues.items()
            if q and q[0][2] <= now
        ]
        if eligible:
            _tag, k = min(eligible)
            self.class_log.append(k)
            return self._queues[k].popleft()[3]
        return None

    def dequeue(self, timeout: float | None = None):
        import time as _time

        # the timeout is wall-clock even under an injected (virtual)
        # QoS clock — a test clock that never advances must not turn
        # a bounded dequeue into an infinite loop
        deadline = (
            None if timeout is None else _time.monotonic() + timeout
        )
        with self._cond:
            while True:
                if self._strict:
                    self._size -= 1
                    self.class_log.append(CLASS_STRICT)
                    return self._strict.popleft()
                if self._size > 0:
                    item = self._pick_locked()
                    if item is not None:
                        self._size -= 1
                        return item
                    # queued work exists but every head is limited:
                    # sleep until the earliest tag comes due (or the
                    # caller's deadline, whichever is first)
                    next_due = min(
                        min(q[0][0], q[0][2])
                        for q in self._queues.values()
                        if q
                    )
                    wait = max(0.001, next_due - self.clock())
                    if deadline is not None:
                        remaining = deadline - _time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError("queue idle")
                        wait = min(wait, remaining)
                    self._cond.wait(wait)
                    continue
                if self._draining:
                    return None
                remaining = (
                    None
                    if deadline is None
                    else deadline - _time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("queue idle")
                if not self._cond.wait(remaining):
                    raise TimeoutError("queue idle")
