"""Performance counters (src/common/perf_counters.{h,cc}).

Typed per-subsystem metrics with the reference's four shapes: u64
counters, gauges, long-run averages (avgcount+sum pairs, used for
latencies), and histograms — dumped as the nested JSON `perf dump`
emits over the admin socket.  A PerfCountersBuilder declares the
schema up front; instances are cheap to update on hot paths.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

PERFCOUNTER_U64 = "u64"
PERFCOUNTER_GAUGE = "gauge"
PERFCOUNTER_LONGRUNAVG = "avg"
PERFCOUNTER_TIME = "time"
PERFCOUNTER_HISTOGRAM = "histogram"


@dataclass
class _Counter:
    name: str
    kind: str
    description: str = ""
    value: float = 0
    avgcount: int = 0
    buckets: list = field(default_factory=list)
    bucket_bounds: tuple = ()


class PerfCounters:
    """One subsystem's counter set (e.g. l_osd_*, OSD.cc:9681)."""

    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, _Counter] = {}
        self._lock = threading.Lock()

    # -- updates -----------------------------------------------------------
    def inc(self, name: str, amount: int = 1) -> None:
        c = self._counters[name]
        assert c.kind in (
            PERFCOUNTER_U64,
            PERFCOUNTER_GAUGE,
            PERFCOUNTER_LONGRUNAVG,
        ), f"inc on {c.kind} counter {name}; use tinc/hinc"
        with self._lock:
            if c.kind == PERFCOUNTER_LONGRUNAVG:
                c.value += amount
                c.avgcount += 1
            else:
                c.value += amount

    def dec(self, name: str, amount: int = 1) -> None:
        c = self._counters[name]
        assert c.kind == PERFCOUNTER_GAUGE, "dec is gauge-only"
        with self._lock:
            c.value -= amount

    def set(self, name: str, value: float) -> None:
        c = self._counters[name]
        assert c.kind in (PERFCOUNTER_U64, PERFCOUNTER_GAUGE), (
            f"set on {c.kind} counter {name}"
        )
        with self._lock:
            c.value = value

    def tinc(self, name: str, seconds: float) -> None:
        """Accumulate a latency sample (time + avgcount pair)."""
        c = self._counters[name]
        assert c.kind == PERFCOUNTER_TIME
        with self._lock:
            c.value += seconds
            c.avgcount += 1

    def hinc(self, name: str, value: float) -> None:
        c = self._counters[name]
        assert c.kind == PERFCOUNTER_HISTOGRAM
        with self._lock:
            # sum + count accumulate alongside the buckets so the
            # exporter can emit the prometheus-native _sum/_count pair
            c.value += value
            c.avgcount += 1
            for i, bound in enumerate(c.bucket_bounds):
                if value <= bound:
                    c.buckets[i] += 1
                    return
            c.buckets[-1] += 1

    def time_it(self, name: str) -> "_Timer":
        """Context manager: tinc the elapsed wall time."""
        return _Timer(self, name)

    # -- dump --------------------------------------------------------------
    def dump(self) -> dict:
        """The `perf dump` JSON shape: avg/time counters dump as
        {avgcount, sum}; histograms as bucket arrays."""
        out = {}
        with self._lock:
            for name, c in self._counters.items():
                if c.kind in (PERFCOUNTER_LONGRUNAVG, PERFCOUNTER_TIME):
                    out[name] = {
                        "avgcount": c.avgcount,
                        "sum": c.value,
                    }
                elif c.kind == PERFCOUNTER_HISTOGRAM:
                    out[name] = {
                        "bounds": list(c.bucket_bounds),
                        "buckets": list(c.buckets),
                        "sum": c.value,
                        "count": c.avgcount,
                    }
                else:
                    out[name] = c.value
        return out

    def reset(self) -> None:
        with self._lock:
            for c in self._counters.values():
                c.value = 0
                c.avgcount = 0
                c.buckets = [0] * len(c.buckets)


class _Timer:
    __slots__ = ("_pc", "_name", "_t0")

    def __init__(self, pc: PerfCounters, name: str):
        self._pc = pc
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._pc.tinc(self._name, time.perf_counter() - self._t0)
        return False


class PerfCountersBuilder:
    """Declare the counter schema, then create_perf_counters()
    (the perf_counters.h PerfCountersBuilder pattern)."""

    def __init__(self, name: str):
        self._pc = PerfCounters(name)

    def _add(self, name, kind, description="", bounds=()):
        assert name not in self._pc._counters, name
        c = _Counter(name, kind, description, bucket_bounds=tuple(bounds))
        if kind == PERFCOUNTER_HISTOGRAM:
            c.buckets = [0] * (len(bounds) + 1)
        self._pc._counters[name] = c
        return self

    def add_u64_counter(self, name, description=""):
        return self._add(name, PERFCOUNTER_U64, description)

    def add_u64_gauge(self, name, description=""):
        return self._add(name, PERFCOUNTER_GAUGE, description)

    def add_u64_avg(self, name, description=""):
        return self._add(name, PERFCOUNTER_LONGRUNAVG, description)

    def add_time_avg(self, name, description=""):
        return self._add(name, PERFCOUNTER_TIME, description)

    def add_histogram(self, name, bounds, description=""):
        return self._add(name, PERFCOUNTER_HISTOGRAM, description, bounds)

    def create_perf_counters(self) -> PerfCounters:
        return self._pc


class PerfCountersCollection:
    """Registry of every subsystem's counters — the admin socket's
    `perf dump` aggregates across it (perf_counters.cc collection)."""

    def __init__(self):
        self._sets: dict[str, PerfCounters] = {}
        self._lock = threading.Lock()

    def add(self, pc: PerfCounters) -> None:
        with self._lock:
            self._sets[pc.name] = pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._sets.pop(name, None)

    def dump(self) -> dict:
        with self._lock:
            return {name: pc.dump() for name, pc in self._sets.items()}

    def reset(self) -> None:
        """Zero every registered set (the `perf reset all` builtin)."""
        with self._lock:
            for pc in self._sets.values():
                pc.reset()
