"""Device-kernel telemetry — the perf-counter plane for the device hot
paths (the l_osd_* PerfCounters idiom, src/common/perf_counters.h).

One process-global ``PerfCounters`` set named ``tpu_kernels`` holds a
counter group per kernel entry point, under the JAX package's names so
a dump of either package reads alike:

    l_tpu_<group>_calls      u64   kernel invocations
    l_tpu_<group>_bytes_in   u64   input bytes handed to the device
    l_tpu_<group>_bytes_out  u64   output bytes produced
    l_tpu_<group>_lat        time  wall latency on the host clock
                                   (device-sync bounded: callers time
                                   up to the download or
                                   torch.cuda.synchronize())

plus the cache counters:

    l_tpu_compile_cache_hit / l_tpu_compile_cache_miss

which here count the host-side bitmatrix and crc-matrix caches (the
port compiles no programs per shape).

Groups registered by the instrumented modules: ``ec_encode`` /
``ec_decode`` (ec/stripe.py batched seam), ``scrub_crc32c`` /
``scrub_verify`` (ops/scrub_kernels.py).

Being process-global, every store in a process shares one set, the
same way they share the one CUDA context.
"""

from __future__ import annotations

import threading
import time

from ..common.histogram import LATENCY_BUCKETS, LATENCY_MIN_S, log2_bounds
from ..common.perf_counters import (
    PERFCOUNTER_HISTOGRAM,
    PERFCOUNTER_TIME,
    PERFCOUNTER_U64,
    PerfCounters,
    _Counter,
)

# the shared log2 latency axis (common/histogram.py): every
# l_tpu_*_lat_hist uses it, so kernel latency histograms merge with
# the op-path ones under one bucket layout
_LAT_HIST_BOUNDS = log2_bounds(LATENCY_MIN_S, LATENCY_BUCKETS)


class KernelStats:
    def __init__(self, name: str = "tpu_kernels"):
        self.perf = PerfCounters(name)
        self._lock = threading.Lock()
        self._cache_call_lock = threading.Lock()
        self._groups: set[str] = set()
        self._ensure_counter("l_tpu_compile_cache_hit", PERFCOUNTER_U64,
                             "device bitmatrix/table cache hits")
        self._ensure_counter("l_tpu_compile_cache_miss", PERFCOUNTER_U64,
                             "device bitmatrix/table cache misses")
        # zero bytes a dispatch stacks in to give its rows one width
        # (crc right-align, compare widening): device-visible bytes
        # that carry no payload
        self._ensure_counter(
            "l_tpu_pad_bytes_wasted", PERFCOUNTER_U64,
            "device bytes padded in to give rows one width"
        )

    def _ensure_counter(
        self, name: str, kind: str, desc: str, bounds: tuple = ()
    ) -> None:
        with self.perf._lock:
            if name not in self.perf._counters:
                c = _Counter(name, kind, desc, bucket_bounds=bounds)
                if kind == PERFCOUNTER_HISTOGRAM:
                    c.buckets = [0] * (len(bounds) + 1)
                self.perf._counters[name] = c

    def _ensure_group(self, group: str) -> None:
        with self._lock:
            if group in self._groups:
                return
            base = f"l_tpu_{group}"
            self._ensure_counter(
                f"{base}_calls", PERFCOUNTER_U64, f"{group} kernel calls"
            )
            self._ensure_counter(
                f"{base}_bytes_in", PERFCOUNTER_U64, f"{group} input bytes"
            )
            self._ensure_counter(
                f"{base}_bytes_out", PERFCOUNTER_U64, f"{group} output bytes"
            )
            self._ensure_counter(
                f"{base}_lat", PERFCOUNTER_TIME, f"{group} kernel latency"
            )
            # histogram variant of the sync-bounded latency: the avg
            # pair answers "mean", the log2 buckets answer "p99"
            self._ensure_counter(
                f"{base}_lat_hist",
                PERFCOUNTER_HISTOGRAM,
                f"{group} kernel latency distribution (log2 buckets)",
                bounds=_LAT_HIST_BOUNDS,
            )
            self._groups.add(group)

    # -- recording ---------------------------------------------------------
    def record(
        self,
        group: str,
        bytes_in: int = 0,
        bytes_out: int = 0,
        seconds: float = 0.0,
    ) -> None:
        self._ensure_group(group)
        base = f"l_tpu_{group}"
        self.perf.inc(f"{base}_calls")
        if bytes_in:
            self.perf.inc(f"{base}_bytes_in", int(bytes_in))
        if bytes_out:
            self.perf.inc(f"{base}_bytes_out", int(bytes_out))
        self.perf.tinc(f"{base}_lat", seconds)
        self.perf.hinc(f"{base}_lat_hist", seconds)

    def record_cache(self, hits: int, misses: int) -> None:
        if hits:
            self.perf.inc("l_tpu_compile_cache_hit", hits)
        if misses:
            self.perf.inc("l_tpu_compile_cache_miss", misses)

    def counted_cache_call(self, cached_fn, *args):
        """Call an ``functools.lru_cache``-wrapped function and record
        the hit/miss it produced.  The snapshot-call-snapshot runs
        under one lock so concurrent callers cannot double- or
        zero-count against the shared cache_info (misses — the
        expensive bitmatrix builds — serialize; hits are dict
        lookups, so the lock is cheap where it matters)."""
        with self._cache_call_lock:
            before = cached_fn.cache_info()
            out = cached_fn(*args)
            after = cached_fn.cache_info()
            self.record_cache(
                after.hits - before.hits, after.misses - before.misses
            )
        return out

    def record_pad(self, nbytes: int) -> None:
        """Count shape-bucketing pad bytes (device-visible bytes that
        carry no payload)."""
        if nbytes:
            self.perf.inc("l_tpu_pad_bytes_wasted", int(nbytes))

    def counter(self, group: str, suffix: str, kind=PERFCOUNTER_U64,
                desc: str = "", bounds: tuple = ()):
        """Register an extra per-group counter (e.g. the residency
        family's l_tpu_residency_hits) and return its full name."""
        name = f"l_tpu_{group}_{suffix}"
        self._ensure_counter(name, kind, desc, bounds=bounds)
        return name

    def timed(self, group: str, bytes_in: int = 0):
        """Context manager timing one kernel call; the caller must
        sync the device inside the block (the download or
        torch.cuda.synchronize()) so the latency is real, not the
        launch."""
        return _KernelTimer(self, group, bytes_in)

    def dump(self) -> dict:
        return self.perf.dump()

    def snapshot(self) -> dict:
        """Compact rollup for result artifacts: cache hit ratio plus
        per-group call/byte totals — kernel behavior, not just GB/s."""
        dump = self.dump()
        hits = int(dump.get("l_tpu_compile_cache_hit", 0))
        misses = int(dump.get("l_tpu_compile_cache_miss", 0))
        lookups = hits + misses
        groups = {}
        with self._lock:
            known = sorted(self._groups)
        for group in known:
            base = f"l_tpu_{group}"
            lat = dump.get(f"{base}_lat") or {}
            groups[group] = {
                "calls": int(dump.get(f"{base}_calls", 0)),
                "bytes_in": int(dump.get(f"{base}_bytes_in", 0)),
                "bytes_out": int(dump.get(f"{base}_bytes_out", 0)),
                "lat_sum_s": round(float(lat.get("sum", 0.0)), 6),
            }
        return {
            "compile_cache": {
                "hits": hits,
                "misses": misses,
                "hit_ratio": (
                    round(hits / lookups, 4) if lookups else None
                ),
            },
            "groups": groups,
        }


class _KernelTimer:
    __slots__ = ("_ks", "_group", "_bytes_in", "bytes_out", "_t0")

    def __init__(self, ks: KernelStats, group: str, bytes_in: int):
        self._ks = ks
        self._group = group
        self._bytes_in = bytes_in
        self.bytes_out = 0

    def __enter__(self) -> "_KernelTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is None:
            self._ks.record(
                self._group,
                bytes_in=self._bytes_in,
                bytes_out=self.bytes_out,
                seconds=time.perf_counter() - self._t0,
            )
        return False


_instance: KernelStats | None = None
_instance_lock = threading.Lock()


def kernel_stats() -> KernelStats:
    """The process-global collector (like the one CUDA context the
    kernels themselves share)."""
    global _instance
    if _instance is None:
        with _instance_lock:
            if _instance is None:
                _instance = KernelStats()
    return _instance
