"""Shared-event-loop network stack — the process-wide worker pool
every Messenger multiplexes onto (src/msg/async/Stack.{h,cc}
NetworkStack + Worker; src/msg/async/Event.cc EventCenter).

The reference's AsyncMessenger does NOT give each messenger its own
thread: one NetworkStack owns ``ms_async_op_threads`` epoll workers,
and every daemon's messenger binds/dials *through* a worker — which
is what lets one host run hundreds of daemons without hundreds of
reactor threads.  This module renders that shape over asyncio:

- ``Worker``     one asyncio loop on one daemon thread (the
                 EventCenter seat).  Messengers check out a worker at
                 ``start()`` by least-connections; every connection,
                 read loop, timer and send of that messenger then
                 lives on that worker's loop.  One-messenger-one-
                 worker (rather than per-connection scatter) is
                 deliberate: it keeps the FaultInjector's seeded RNG
                 single-threaded per messenger, so chaos decision
                 streams replay byte-identically (tests/chaos.py
                 scenario_lossy_link's contract).
- ``NetworkStack``  the process singleton: lazily spawns up to
                 ``CEPH_TPU_MSGR_WORKERS`` workers (default
                 ~min(cpu, 8)), refcounts live messengers, and tears
                 every loop down when the last messenger shuts down
                 (so pytest sessions never leak reactor threads).
- ``OffloadPool``  the dispatch-offload seam: inbound dispatch NEVER
                 runs on a worker loop (a blocking handler would
                 stall every messenger sharing that worker — the
                 exact cross-daemon coupling the per-messenger-loop
                 design never had).  Each messenger drains its
                 dispatch queue FIFO through a serial strand on this
                 pool, so a wedged handler stalls only its own
                 messenger's queue.  The pool is ELASTIC with idle
                 reaping: threads spawn when every existing one is
                 busy (nested blocking RPC between daemons can never
                 starve the pool into deadlock) and exit after
                 ``idle`` seconds, so steady-state thread count stays
                 small and independent of daemon count.
- ``Timers``     shared periodic callbacks riding the worker loops
                 (``loop.call_later``), fired onto the offload pool
                 with an overlap guard — the shared-services seat
                 daemon tick/report loops move onto at scale.

Telemetry: ``build_stack_perf`` declares the ``l_msgr_worker_*``
family (per-worker connections / dispatch counts / loop lag plus the
process aggregates); the live stack updates it and daemons merge
``stack_perf_dump()`` into their MMgrReport perf push, so the series
ride the existing perf → MMgrReport → prometheus pipe exactly like
the fault-plane counters.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import os
import threading
import time

from ..common.perf_counters import PerfCountersBuilder

# worker count: ~cpu cores, capped — 8 loops already multiplex
# hundreds of daemons and the virtual-mesh CI boxes report many more
# cores than they schedule
MAX_WORKERS_DEFAULT = 8
OFFLOAD_MAX_DEFAULT = 512  # runaway backstop, not a working limit
OFFLOAD_IDLE_DEFAULT = 5.0  # seconds an offload thread waits for
# work before exiting (steady-state pool shrinks back after storms)

# loop-lag sampling period: cheap enough to always run, long enough
# to never matter
_LAG_PROBE_PERIOD = 0.5


def default_workers() -> int:
    env = os.environ.get("CEPH_TPU_MSGR_WORKERS")
    if env:
        return max(1, int(env))
    return max(2, min(os.cpu_count() or 4, MAX_WORKERS_DEFAULT))


def build_stack_perf(n_workers: int):
    """The shared-stack counter schema (l_msgr_worker_* family) —
    module-level so tools/check_metrics.py lints it without a live
    stack.  Per-worker series carry the worker index in the name
    (``l_msgr_worker0_connections``); the index-free names are the
    process aggregates the dashboards alert on."""
    b = (
        PerfCountersBuilder("msgr.stack")
        .add_u64_gauge(
            "l_msgr_workers", "event-loop workers started"
        )
        .add_u64_gauge(
            "l_msgr_worker_connections",
            "open connections across all workers",
        )
        .add_u64_counter(
            "l_msgr_worker_dispatch",
            "messages dispatched across all workers",
        )
        .add_u64_gauge(
            "l_msgr_worker_loop_lag",
            "worst worker event-loop lag (ms) at the last probe",
        )
        .add_u64_gauge(
            "l_msgr_offload_threads",
            "live dispatch-offload threads",
        )
        .add_u64_gauge(
            "l_msgr_offload_threads_peak",
            "dispatch-offload thread high-water mark",
        )
        .add_u64_gauge(
            "l_msgr_dispatch_queue_depth",
            "inbound messages queued on dispatch strands across "
            "all messengers",
        )
        .add_u64_counter(
            "l_msgr_dispatch_queue_stalls",
            "read-loop pauses: a messenger's dispatch backlog "
            "crossed the high watermark and its socket reads "
            "stalled until the strand drained",
        )
    )
    for i in range(n_workers):
        b.add_u64_gauge(
            f"l_msgr_worker{i}_connections",
            f"open connections on worker {i}",
        )
        b.add_u64_counter(
            f"l_msgr_worker{i}_dispatch",
            f"messages dispatched from worker {i}",
        )
        b.add_u64_gauge(
            f"l_msgr_worker{i}_loop_lag",
            f"event-loop lag (ms) on worker {i} at the last probe",
        )
    return b.create_perf_counters()


class Worker:
    """One asyncio loop on one daemon thread (the EventCenter /
    Worker seat).  Counters are mutated from the loop thread and the
    stack lock's owners; PerfCounters itself is lock-guarded."""

    def __init__(self, stack: "NetworkStack", idx: int):
        self.stack = stack
        self.idx = idx
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(
            target=self.loop.run_forever,
            name=f"msgr-worker-{idx}",
            daemon=True,
        )
        self.messengers = 0  # facades checked out here
        self.connections = 0  # open conns (least-connections metric)
        self.lag_ms = 0.0
        self._lag_handle = None

    def start(self) -> None:
        self.thread.start()
        self.loop.call_soon_threadsafe(self._arm_lag_probe)

    # -- loop-lag probe (loop thread) ---------------------------------------
    def _arm_lag_probe(self) -> None:
        expected = time.monotonic() + _LAG_PROBE_PERIOD
        self._lag_handle = self.loop.call_later(
            _LAG_PROBE_PERIOD, self._lag_probe, expected
        )

    def _lag_probe(self, expected: float) -> None:
        self.lag_ms = max(0.0, (time.monotonic() - expected) * 1000.0)
        perf = self.stack.perf
        perf.set(f"l_msgr_worker{self.idx}_loop_lag", self.lag_ms)
        perf.set(
            "l_msgr_worker_loop_lag",
            max(w.lag_ms for w in self.stack.workers),
        )
        self._arm_lag_probe()

    # -- accounting ---------------------------------------------------------
    def conn_opened(self) -> None:
        self.connections += 1
        perf = self.stack.perf
        perf.inc(f"l_msgr_worker{self.idx}_connections")
        perf.inc("l_msgr_worker_connections")

    def conn_closed(self) -> None:
        self.connections -= 1
        perf = self.stack.perf
        perf.dec(f"l_msgr_worker{self.idx}_connections")
        perf.dec("l_msgr_worker_connections")

    def count_dispatch(self) -> None:
        perf = self.stack.perf
        perf.inc(f"l_msgr_worker{self.idx}_dispatch")
        perf.inc("l_msgr_worker_dispatch")

    def stop(self) -> None:
        async def _halt():
            if self._lag_handle is not None:
                self._lag_handle.cancel()
            me = asyncio.current_task()
            tasks = [
                t for t in asyncio.all_tasks(self.loop) if t is not me
            ]
            for task in tasks:
                task.cancel()
            if tasks:
                # let cancellations actually deliver before the loop
                # dies — stopping in the same beat would strand them
                # as "Task was destroyed but it is pending"
                await asyncio.wait(tasks, timeout=1.0)

        try:
            asyncio.run_coroutine_threadsafe(
                _halt(), self.loop
            ).result(3.0)
        except (RuntimeError, concurrent.futures.TimeoutError,
                concurrent.futures.CancelledError):
            pass
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
        except RuntimeError:
            return  # already closed
        self.thread.join(timeout=5)
        try:
            self.loop.close()
        except RuntimeError:
            pass


class OffloadPool:
    """Elastic thread pool with idle reaping — the dispatch-offload
    seam.  Unlike a fixed ThreadPoolExecutor, a task submitted while
    every thread is blocked spawns a NEW thread (up to a runaway
    backstop far above any sane working set): daemons' dispatch
    handlers make nested blocking RPC to each other, and a fixed pool
    exhausted by blocked handlers could deadlock the whole cluster.
    Idle threads exit after ``idle`` seconds, so the pool's
    steady-state size tracks concurrent *blockage*, not daemon
    count."""

    def __init__(
        self,
        max_threads: int = OFFLOAD_MAX_DEFAULT,
        idle: float = OFFLOAD_IDLE_DEFAULT,
        perf=None,
    ):
        self.max_threads = max_threads
        self.idle = idle
        self.perf = perf
        self._lock = threading.Lock()
        self._work: collections.deque = collections.deque()
        # LIFO handoff: submit wakes the MOST-RECENTLY idled thread.
        # FIFO (a plain condvar) would rotate a steady trickle of
        # work across every thread, resetting all their idle timers —
        # a post-storm pool would then never shrink.  With LIFO a
        # small hot set serves the trickle and the cold surplus
        # actually times out.
        self._idle_stack: list[threading.Event] = []
        self._threads = 0
        self._peak = 0
        self._seq = 0
        self._shutdown = False

    @property
    def size(self) -> int:
        with self._lock:
            return self._threads

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak

    def submit(self, fn) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._work.append(fn)
            if self._idle_stack:
                self._idle_stack.pop().set()  # newest waiter (LIFO)
                return
            if self._threads >= self.max_threads:
                return  # queued; a busy thread will get to it
            self._threads += 1
            self._peak = max(self._peak, self._threads)
            self._seq += 1
            name = f"msgr-offload-{self._seq}"
            if self.perf is not None:
                self.perf.set("l_msgr_offload_threads", self._threads)
                self.perf.set("l_msgr_offload_threads_peak", self._peak)
        threading.Thread(
            target=self._run, name=name, daemon=True
        ).start()

    def _run(self) -> None:
        ev = threading.Event()
        while True:
            fn = None
            with self._lock:
                if self._work:
                    fn = self._work.popleft()
                elif self._shutdown:
                    self._exit_locked()
                    return
                else:
                    ev.clear()
                    self._idle_stack.append(ev)
            if fn is None:
                signalled = ev.wait(self.idle)
                with self._lock:
                    if not signalled and not ev.is_set():
                        # true timeout: deregister and reap (submit
                        # sets the event under the lock, so is_set
                        # here is authoritative)
                        try:
                            self._idle_stack.remove(ev)
                        except ValueError:
                            pass
                        if not self._work:
                            self._exit_locked()
                            return
                continue
            try:
                fn()
            except Exception:  # noqa: BLE001 — an offload task must
                # never kill its carrier thread
                import traceback

                traceback.print_exc()

    def _exit_locked(self) -> None:
        self._threads -= 1
        if self.perf is not None:
            self.perf.set("l_msgr_offload_threads", self._threads)

    def strand(self) -> "Strand":
        return Strand(self)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._work.clear()
            while self._idle_stack:
                self._idle_stack.pop().set()


class Strand:
    """Serial execution lane over an OffloadPool (the boost.asio
    strand idiom): tasks run FIFO, one at a time, but on whatever
    pool thread is free — per-daemon ordering without per-daemon
    threads."""

    def __init__(self, pool: OffloadPool):
        self._pool = pool
        self._lock = threading.Lock()
        self._q: collections.deque = collections.deque()
        self._busy = False

    def submit(self, fn) -> None:
        with self._lock:
            self._q.append(fn)
            if self._busy:
                return
            self._busy = True
        self._pool.submit(self._drain)

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._q:
                    self._busy = False
                    return
                fn = self._q.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 — a strand task must not
                # wedge the lane behind it
                import traceback

                traceback.print_exc()

    @property
    def idle(self) -> bool:
        with self._lock:
            return not self._busy and not self._q


class _TimerHandle:
    def __init__(self, timers: "Timers"):
        self._timers = timers
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class Timers:
    """Periodic callbacks on the shared worker loops, executed on the
    offload pool with an overlap guard (a slow callback skips beats
    instead of stacking) — the shared-services replacement for
    per-daemon tick/report threads."""

    def __init__(self, stack: "NetworkStack"):
        self._stack = stack
        self._rr = 0

    def _a_loop(self):
        workers = self._stack.workers
        if not workers:
            return None
        self._rr = (self._rr + 1) % len(workers)
        return workers[self._rr].loop

    def every(
        self, period: float, fn, fire_now: bool = False
    ) -> _TimerHandle:
        """Run ``fn`` on the offload pool every ``period`` seconds.
        A still-running previous firing makes the beat skip (never
        two concurrent runs of one registration)."""
        handle = _TimerHandle(self)
        running = {"flag": False}

        def fire():
            if handle.cancelled:
                return
            if not running["flag"]:
                running["flag"] = True

                def run():
                    try:
                        if not handle.cancelled:
                            fn()
                    finally:
                        running["flag"] = False

                self._stack.offload.submit(run)
            arm()

        def arm():
            loop = self._a_loop()
            if loop is None or handle.cancelled:
                return
            try:
                loop.call_soon_threadsafe(
                    loop.call_later, period, fire
                )
            except RuntimeError:
                pass  # stack torn down under us

        if fire_now:
            fire()
        else:
            arm()
        return handle

    def after(self, delay: float, fn) -> _TimerHandle:
        """One-shot: run ``fn`` on the offload pool after ``delay``."""
        handle = _TimerHandle(self)

        def fire():
            if not handle.cancelled:
                self._stack.offload.submit(fn)

        loop = self._a_loop()
        if loop is not None:
            try:
                loop.call_soon_threadsafe(
                    loop.call_later, delay, fire
                )
            except RuntimeError:
                pass
        return handle


class NetworkStack:
    """The process-wide stack singleton.  Messengers check workers
    out at start() and release them at shutdown(); the last release
    stops every worker loop and drops the singleton, so test
    processes never accumulate reactor threads across cases."""

    _instance: "NetworkStack | None" = None
    _instance_lock = threading.Lock()

    def __init__(self, n_workers: int | None = None):
        self.n_workers = n_workers or default_workers()
        self.perf = build_stack_perf(self.n_workers)
        self.workers: list[Worker] = []
        self.offload = OffloadPool(
            max_threads=int(
                os.environ.get(
                    "CEPH_TPU_MSGR_OFFLOAD_MAX", OFFLOAD_MAX_DEFAULT
                )
            ),
            perf=self.perf,
        )
        self.timers = Timers(self)
        self._lock = threading.Lock()
        self._refs = 0
        self._dead = False  # teardown latched; checkouts must retry

    # -- singleton ----------------------------------------------------------
    @classmethod
    def instance(cls) -> "NetworkStack":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def live(cls) -> "NetworkStack | None":
        """The current stack if any messenger holds it (telemetry
        readers must not create one as a side effect)."""
        with cls._instance_lock:
            return cls._instance

    # -- checkout / release -------------------------------------------------
    def checkout(self, _msgr) -> Worker | None:
        """Least-connections worker selection (the reference's
        Stack::get_worker policy): prefer an idle started worker,
        grow the pool while under the cap, else the worker carrying
        the fewest connections (messengers as tiebreak).  Returns
        None when this stack latched teardown between the caller's
        instance() and this call — the caller re-fetches a fresh
        instance and retries."""
        with self._lock:
            if self._dead:
                return None
            self._refs += 1
            idle = [w for w in self.workers if w.messengers == 0]
            if idle:
                worker = idle[0]
            elif len(self.workers) < self.n_workers:
                worker = Worker(self, len(self.workers))
                worker.start()
                self.workers.append(worker)
                self.perf.set("l_msgr_workers", len(self.workers))
            else:
                worker = min(
                    self.workers,
                    key=lambda w: (w.connections, w.messengers),
                )
            worker.messengers += 1
            return worker

    def release(self, worker: Worker | None) -> None:
        teardown = False
        with self._lock:
            if worker is not None:
                worker.messengers -= 1
            self._refs -= 1
            if self._refs <= 0:
                # latch: a concurrent checkout() racing this release
                # now gets None and retries against a FRESH instance
                # instead of checking out of a dying stack
                self._dead = True
                teardown = True
        if teardown:
            with NetworkStack._instance_lock:
                if NetworkStack._instance is self:
                    NetworkStack._instance = None
            self._teardown()

    def _teardown(self) -> None:
        self.offload.shutdown()
        for w in self.workers:
            w.stop()
        self.workers = []
        self.perf.set("l_msgr_workers", 0)

    # -- introspection ------------------------------------------------------
    def thread_count(self) -> int:
        """Worker + offload threads this stack currently owns — the
        messenger plane's entire thread bill."""
        with self._lock:
            n = len(self.workers)
        return n + self.offload.size


def stack_perf_dump() -> dict:
    """Flat l_msgr_worker_* entries for the MMgrReport perf merge
    (the kernel_stats().dump() idiom); {} when no stack is live."""
    stack = NetworkStack.live()
    if stack is None:
        return {}
    return stack.perf.dump()
