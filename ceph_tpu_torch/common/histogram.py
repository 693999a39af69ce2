"""Latency histograms — fixed-bucket log2 distributions and the
reference-shaped 2D latency×size grid (src/common/perf_histogram.h +
the HdrHistogram idea reduced to its storage-useful core).

PRs 1–2 gave every latency an avgcount+sum pair, which answers "what
is the mean" and nothing else; tail latency — the metric the paper's
TPU-offload story is judged on — needs distributions.  Two shapes:

- ``LogHistogram`` — one-dimensional latency distribution over
  log2-spaced buckets: bucket *i* covers
  ``(min_value·2^(i-1), min_value·2^i]``.  ``add`` is an integer
  log2 (``frexp``) plus one += under a lock — cheap enough for every
  op completion.  Histograms MERGE exactly (same bucket layout ⇒
  elementwise add), which is what lets the mgr aggregate per-daemon
  snapshots cluster-wide, and SUBTRACT (cumulative counters ⇒ a
  sliding window is snapshot(now) − snapshot(then)).  Percentiles
  interpolate linearly inside the winning bucket — bounded relative
  error of one bucket ratio (×2 by default), exactly HdrHistogram's
  contract.
- ``PerfHistogram2D`` — the reference's ``PerfHistogramCommon`` 2D
  grid (axis conventions from src/common/perf_histogram.h): by
  default latency × request size, each axis log2-scaled, dumped in
  the ``perf histogram dump`` shape (axes config + row-major counts)
  the `ceph tell osd.N perf histogram dump` surface serves.

Snapshots are plain dicts (JSON- and MMgrReport-safe) and have a
dencoder-stable binary encoding (``encode``/``decode``) pinned in the
corpus, so the wire/artifact shape cannot drift silently.
"""

from __future__ import annotations

import math
import threading

from .encoding import Decoder, Encoder

# the default latency axis: 10 µs lower bound, 28 log2 buckets →
# covers ~10 µs .. ~22 min with ≤2x relative error per bucket
LATENCY_MIN_S = 1e-5
LATENCY_BUCKETS = 28

# the default size axis: 512 B lower bound, 16 buckets → 512 B .. 16 MB
SIZE_MIN_B = 512.0
SIZE_BUCKETS = 16


def log2_bounds(min_value: float, buckets: int) -> tuple[float, ...]:
    """Upper bounds of every bucket except the +Inf overflow:
    ``min_value · 2^i`` for i in [0, buckets)."""
    return tuple(min_value * (2.0**i) for i in range(buckets))


def bucket_index(value: float, min_value: float, buckets: int) -> int:
    """value → bucket, 0..buckets (the last index is the overflow
    bucket).  Bucket i covers (min·2^(i-1), min·2^i]."""
    if value <= min_value:
        return 0
    # frexp is an exponent read, not a log: value = m·2^e, m ∈ [0.5,1);
    # an exact power of two (m == 0.5) belongs to the bucket it CLOSES
    # — (2^(e-2), 2^(e-1)] — because buckets are upper-inclusive
    m, e = math.frexp(value / min_value)
    idx = e - 1 if m == 0.5 else e
    return min(idx, buckets)


def percentile_from_counts(
    bounds, counts, sum_, p: float
) -> float:
    """The p-th percentile (0..100) from bucket counts, linearly
    interpolated inside the winning bucket.  The overflow bucket
    (beyond the last bound) has no upper edge: report the larger of
    the last bound and the overall mean — bounded below by the data,
    never inventing precision the layout cannot support."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = max(0.0, min(100.0, p)) / 100.0 * total
    acc = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if acc + c >= rank:
            if i >= len(bounds):  # overflow bucket
                mean = sum_ / total if total else 0.0
                return max(bounds[-1] if bounds else 0.0, mean)
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = (rank - acc) / c
            return lo + frac * (bounds[i] - lo)
        acc += c
    return bounds[-1] if bounds else 0.0


class LogHistogram:
    """Mergeable fixed-layout log2 histogram (cumulative counter
    semantics: counts only ever grow; windows are snapshot deltas)."""

    __slots__ = ("min_value", "buckets", "bounds", "counts", "sum",
                 "count", "_lock")

    def __init__(
        self,
        min_value: float = LATENCY_MIN_S,
        buckets: int = LATENCY_BUCKETS,
    ):
        assert min_value > 0 and buckets >= 1
        self.min_value = float(min_value)
        self.buckets = int(buckets)
        self.bounds = log2_bounds(self.min_value, self.buckets)
        # buckets+1 slots: the last is the +Inf overflow
        self.counts = [0] * (self.buckets + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    # -- hot path ----------------------------------------------------------
    def add(self, value: float) -> None:
        idx = bucket_index(value, self.min_value, self.buckets)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1

    # -- aggregation -------------------------------------------------------
    def merge(self, other) -> None:
        """Elementwise add of another LogHistogram or snapshot dict
        with the SAME layout (mismatched layouts raise — silently
        rebinning would corrupt percentiles)."""
        snap = other.snapshot() if isinstance(other, LogHistogram) else other
        if (
            float(snap.get("min_value", -1)) != self.min_value
            or len(snap.get("counts", ())) != len(self.counts)
        ):
            raise ValueError(
                "histogram layout mismatch: "
                f"{snap.get('min_value')}x{len(snap.get('counts', ()))}"
                f" vs {self.min_value}x{len(self.counts)}"
            )
        with self._lock:
            for i, c in enumerate(snap["counts"]):
                self.counts[i] += int(c)
            self.sum += float(snap.get("sum", 0.0))
            self.count += int(snap.get("count", 0))

    def snapshot(self) -> dict:
        """Plain-dict snapshot (the MMgrReport / artifact shape)."""
        with self._lock:
            return {
                "min_value": self.min_value,
                "bounds": list(self.bounds),
                "counts": list(self.counts),
                "sum": self.sum,
                "count": self.count,
            }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "LogHistogram":
        h = cls(
            min_value=float(snap["min_value"]),
            buckets=len(snap["counts"]) - 1,
        )
        h.counts = [int(c) for c in snap["counts"]]
        h.sum = float(snap.get("sum", 0.0))
        h.count = int(snap.get("count", 0))
        return h

    def percentile(self, p: float) -> float:
        with self._lock:
            counts = list(self.counts)
            s = self.sum
        return percentile_from_counts(self.bounds, counts, s, p)

    # -- dencoder-stable binary form ---------------------------------------
    def encode(self) -> bytes:
        snap = self.snapshot()
        e = Encoder()
        e.u8(1)  # struct version
        e.f64(snap["min_value"]).u32(len(snap["counts"]))
        for c in snap["counts"]:
            e.u64(c)
        e.f64(snap["sum"]).u64(snap["count"])
        return e.getvalue()

    @classmethod
    def decode(cls, blob: bytes) -> "LogHistogram":
        d = Decoder(blob)
        v = d.u8()
        if v != 1:
            raise ValueError(f"unknown histogram version {v}")
        min_value = d.f64()
        n = d.u32()
        counts = [d.u64() for _ in range(n)]
        s = d.f64()
        count = d.u64()
        return cls.from_snapshot(
            {
                "min_value": min_value,
                "counts": counts,
                "sum": s,
                "count": count,
            }
        )


def is_histogram_snapshot(value) -> bool:
    """Duck-check for a histogram shape riding a flat perf dump —
    either a LogHistogram snapshot (``counts``) or a PerfCounters
    histogram dump (``buckets``); the exporter and the mgr slo
    module both key on this."""
    return (
        isinstance(value, dict)
        and "bounds" in value
        and ("counts" in value or "buckets" in value)
    )


def snapshot_counts(snap: dict) -> list[int]:
    """Per-bucket counts from either snapshot shape."""
    return [
        int(c) for c in (snap.get("counts") or snap.get("buckets") or [])
    ]


def cumulative_buckets(snap: dict) -> list[tuple[str, int]]:
    """Prometheus-native cumulative buckets: [(le_label, cum_count)],
    ending with the mandatory ("+Inf", total)."""
    out: list[tuple[str, int]] = []
    acc = 0
    bounds = snap.get("bounds", [])
    counts = snapshot_counts(snap)
    for i, bound in enumerate(bounds):
        acc += int(counts[i]) if i < len(counts) else 0
        out.append((repr(float(bound)), acc))
    total = sum(int(c) for c in counts)
    out.append(("+Inf", total))
    return out


class PerfHistogram2D:
    """The reference's 2D grid (PerfHistogramCommon): two log2 axes —
    by default latency (x) × size (y) — and a row-major count grid.
    ``dump()`` matches the `perf histogram dump` shape: axes config
    first, then values."""

    def __init__(
        self,
        name: str = "op_w_latency_in_bytes_histogram",
        x_min: float = LATENCY_MIN_S,
        x_buckets: int = LATENCY_BUCKETS,
        y_min: float = SIZE_MIN_B,
        y_buckets: int = SIZE_BUCKETS,
        x_name: str = "latency_s",
        y_name: str = "request_size_bytes",
    ):
        self.name = name
        self.x_min, self.x_buckets = float(x_min), int(x_buckets)
        self.y_min, self.y_buckets = float(y_min), int(y_buckets)
        self.x_name, self.y_name = x_name, y_name
        self._grid = [
            [0] * (self.x_buckets + 1) for _ in range(self.y_buckets + 1)
        ]
        self.count = 0
        self._lock = threading.Lock()

    def add(self, x_value: float, y_value: float) -> None:
        xi = bucket_index(x_value, self.x_min, self.x_buckets)
        yi = bucket_index(y_value, self.y_min, self.y_buckets)
        with self._lock:
            self._grid[yi][xi] += 1
            self.count += 1

    def merge(self, other) -> None:
        snap = (
            other.dump() if isinstance(other, PerfHistogram2D) else other
        )
        values = snap.get("values", [])
        if len(values) != len(self._grid) or (
            values and len(values[0]) != len(self._grid[0])
        ):
            raise ValueError("2D histogram layout mismatch")
        with self._lock:
            for yi, row in enumerate(values):
                for xi, c in enumerate(row):
                    self._grid[yi][xi] += int(c)
            self.count += int(snap.get("count", 0))

    def dump(self) -> dict:
        with self._lock:
            values = [list(row) for row in self._grid]
            count = self.count
        return {
            "name": self.name,
            "axes": [
                {
                    "name": self.x_name,
                    "min": self.x_min,
                    "buckets": self.x_buckets + 1,
                    "scale_type": "log2",
                },
                {
                    "name": self.y_name,
                    "min": self.y_min,
                    "buckets": self.y_buckets + 1,
                    "scale_type": "log2",
                },
            ],
            "count": count,
            "values": values,
        }

    # -- dencoder-stable binary form ---------------------------------------
    def encode(self) -> bytes:
        snap = self.dump()
        e = Encoder()
        e.u8(1)
        e.string(snap["name"])
        e.f64(self.x_min).u32(self.x_buckets)
        e.f64(self.y_min).u32(self.y_buckets)
        e.string(self.x_name).string(self.y_name)
        e.u64(snap["count"])
        e.u32(len(snap["values"]))
        for row in snap["values"]:
            e.list(row, lambda e2, c: e2.u64(c))
        return e.getvalue()

    @classmethod
    def decode(cls, blob: bytes) -> "PerfHistogram2D":
        d = Decoder(blob)
        v = d.u8()
        if v != 1:
            raise ValueError(f"unknown 2D histogram version {v}")
        name = d.string()
        x_min, x_buckets = d.f64(), d.u32()
        y_min, y_buckets = d.f64(), d.u32()
        x_name, y_name = d.string(), d.string()
        count = d.u64()
        nrows = d.u32()
        grid = cls(
            name=name, x_min=x_min, x_buckets=x_buckets,
            y_min=y_min, y_buckets=y_buckets,
            x_name=x_name, y_name=y_name,
        )
        values = [
            d.list(lambda d2: d2.u64()) for _ in range(nrows)
        ]
        if len(values) != y_buckets + 1 or any(
            len(r) != x_buckets + 1 for r in values
        ):
            raise ValueError("2D histogram grid shape mismatch")
        grid._grid = [[int(c) for c in row] for row in values]
        grid.count = count
        return grid
