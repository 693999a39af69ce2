"""mgr ``slo`` module — cluster-wide latency SLOs over the histogram
plane (the prometheus/alert-rule seat pulled into the mgr, shaped
like the SRE multi-window burn-rate recipe).

Daemons push cumulative ``op_hist.<qos_class>.<op_type>`` histogram
snapshots on MMgrReport (common/histogram.py layout).  This module:

- merges them cluster-wide per QoS class every tick (same-layout
  histograms add elementwise);
- keeps a ring of timestamped merges, so any sliding window is a
  snapshot SUBTRACTION (cumulative-counter semantics, the prometheus
  ``rate()`` trick without a TSDB);
- computes p50/p95/p99 per class over the fast window — the
  ``slo status`` surface and the curves the exporter serves;
- evaluates declarative targets (``slo_targets``, e.g.
  ``client_p99_ms=50@99.9``): the violation fraction over a window,
  divided by the error budget (1 − objective), is the BURN RATE;
- raises ``SLO_LATENCY`` through the mon ("slo report", the crash
  report push idiom): HEALTH_WARN when the fast window burns hot
  (a page-worthy spike), HEALTH_ERR when the slow window burns too
  (sustained — the budget is actually being spent), clearing on
  recovery since every push replaces the verdict set.

Target grammar: ``<class>_p<percentile>_ms=<target>[@<objective>]``,
whitespace- or comma-separated; objective defaults to 99.9 (%).  The
percentile names the INTENT ("p99 under 50 ms"); the evaluation is
exact over buckets: the fraction of ops slower than the target must
stay under 1 − objective.
"""

from __future__ import annotations

import json
import re
import threading
import time
from collections import deque

from ..common.histogram import (
    is_histogram_snapshot,
    percentile_from_counts,
    snapshot_counts,
)
from ..msg.message import MMonCommandReply
from . import MgrModule

_TARGET_RE = re.compile(
    r"^(?P<klass>[a-zA-Z][a-zA-Z0-9_]{0,31})"
    r"_p(?P<pct>\d{1,2}(?:\.\d+)?)"
    r"_ms=(?P<target>\d+(?:\.\d+)?)"
    r"(?:@(?P<objective>\d+(?:\.\d+)?)%?)?$"
)


def parse_slo_targets(spec: str) -> list[dict]:
    """``client_p99_ms=50@99.9 bulk_p95_ms=500`` → target dicts.
    Raises ValueError on any malformed token (a half-applied SLO
    config is worse than a rejected one)."""
    targets = []
    for token in re.split(r"[\s,]+", spec.strip()):
        if not token:
            continue
        m = _TARGET_RE.match(token)
        if m is None:
            raise ValueError(f"bad slo target {token!r}")
        objective = float(m.group("objective") or 99.9)
        if not 0.0 < objective < 100.0:
            raise ValueError(
                f"objective {objective} out of (0, 100) in {token!r}"
            )
        targets.append(
            {
                "qos_class": m.group("klass"),
                "percentile": float(m.group("pct")),
                "target_s": float(m.group("target")) / 1000.0,
                "objective": objective,
            }
        )
    return targets


def fraction_over(bounds, counts, threshold: float) -> float:
    """Fraction of samples ABOVE ``threshold`` seconds, interpolating
    inside the bucket the threshold splits."""
    total = sum(counts)
    if total == 0:
        return 0.0
    under = 0.0
    prev = 0.0
    for i, c in enumerate(counts):
        if i >= len(bounds):  # overflow bucket: entirely above any
            break  # finite threshold ≥ the last bound
        hi = bounds[i]
        if hi <= threshold:
            under += c
        else:
            if threshold > prev and c:
                under += c * (threshold - prev) / (hi - prev)
            break
        prev = hi
    return max(0.0, min(1.0, 1.0 - under / total))


def _merge_into(acc: dict, snap: dict) -> None:
    counts = snapshot_counts(snap)
    if "counts" not in acc:
        acc["counts"] = [0] * len(counts)
        acc["bounds"] = list(snap.get("bounds", []))
    if len(acc["counts"]) != len(counts):
        return  # foreign layout: drop rather than corrupt
    for i, c in enumerate(counts):
        acc["counts"][i] += c
    acc["sum"] = acc.get("sum", 0.0) + float(snap.get("sum", 0.0))
    acc["count"] = acc.get("count", 0) + sum(counts)


def _delta(cur: dict, old: dict | None) -> dict:
    """cur − old per class (cumulative counters → window counts);
    old=None means the window reaches back to the start."""
    out: dict[str, dict] = {}
    for klass, snap in cur.items():
        prev = (old or {}).get(klass)
        counts = list(snap["counts"])
        s = snap.get("sum", 0.0)
        if prev and len(prev.get("counts", ())) == len(counts):
            counts = [
                max(0, c - p) for c, p in zip(counts, prev["counts"])
            ]
            s = max(0.0, s - prev.get("sum", 0.0))
        out[klass] = {
            "bounds": snap["bounds"],
            "counts": counts,
            "sum": s,
            "count": sum(counts),
        }
    return out


class SLOModule(MgrModule):
    """The burn-rate evaluator (see module docstring)."""

    NAME = "slo"
    TICK_EVERY = 0.5
    # at least this many window ops before a verdict: a two-op window
    # with one slow op is noise, not a burning SLO
    MIN_WINDOW_OPS = 10

    def __init__(self, mgr):
        super().__init__(mgr)
        self._lock = threading.Lock()
        # ring of (wallclock, {class: merged cumulative snapshot})
        self._ring: deque[tuple[float, dict]] = deque(maxlen=4096)
        self._targets_raw: str | None = None
        self._targets: list[dict] = []
        self._target_error = ""
        self._config_cached: str | None = None
        self._config_checked = -1e9
        self.last_status: dict = {}
        # what the mon currently holds (for change-driven pushes)
        self._reported: dict | None = None
        self._last_push = 0.0

    # -- config ------------------------------------------------------------
    def _opt_float(self, key: str, default: float) -> float:
        try:
            return float(self.get_module_option(key, default))
        except (TypeError, ValueError):
            return default

    # how often to re-poll the mon config_db for slo_targets when no
    # module option overrides it (a config-set must take effect
    # without an mgr restart, but not cost a mon round-trip per tick)
    CONFIG_POLL_EVERY = 5.0

    def _config_targets(self) -> str | None:
        """`ceph config set mgr slo_targets ...` — the persistent
        path; polled at a slow cadence, cached between polls."""
        now = time.monotonic()
        if now - self._config_checked < self.CONFIG_POLL_EVERY:
            return self._config_cached
        self._config_checked = now
        try:
            reply = self.mon_command(
                {"prefix": "config get", "who": "mgr",
                 "key": "slo_targets"},
                timeout=2.0,
            )
            self._config_cached = (
                json.loads(reply.outb)
                if reply.rc == 0 and reply.outb
                else None
            )
        except Exception:  # noqa: BLE001 — mon away: keep last known
            pass
        return self._config_cached

    def _refresh_targets(self) -> None:
        """Precedence: runtime module option (`slo targets set`) >
        mon config_db (`ceph config set mgr slo_targets ...`) >
        schema default."""
        raw = str(self.get_module_option("targets", "") or "")
        if not raw:
            raw = str(self._config_targets() or "")
        if not raw:
            from ..common.config import SCHEMA

            raw = str(SCHEMA["slo_targets"].default)
        if raw == self._targets_raw:
            return
        self._targets_raw = raw
        try:
            self._targets = parse_slo_targets(raw)
            self._target_error = ""
        except ValueError as e:
            self._targets = []
            self._target_error = str(e)

    # -- ingestion ---------------------------------------------------------
    def _merged_now(self) -> dict:
        """Merge every daemon's op_hist.* snapshots per QoS class."""
        merged: dict[str, dict] = {}
        for _daemon, dump in (self.get("daemon_perf") or {}).items():
            if not isinstance(dump, dict):
                continue
            for key, val in dump.items():
                if not key.startswith("op_hist."):
                    continue
                if not is_histogram_snapshot(val):
                    continue
                parts = key.split(".")
                klass = parts[1] if len(parts) > 2 else "client"
                _merge_into(merged.setdefault(klass, {}), val)
        return {k: v for k, v in merged.items() if "counts" in v}

    def _window(self, seconds: float, now: float) -> dict:
        """Per-class counts over the trailing ``seconds`` (newest ring
        entry at or before the window start is the baseline)."""
        with self._lock:
            if not self._ring:
                return {}
            cur = self._ring[-1][1]
            baseline = None
            for ts, snap in reversed(self._ring):
                if ts <= now - seconds:
                    baseline = snap
                    break
        return _delta(cur, baseline)

    # -- evaluation --------------------------------------------------------
    def serve(self) -> None:
        self._refresh_targets()
        now = time.time()
        merged = self._merged_now()
        if merged:
            with self._lock:
                self._ring.append((now, merged))
        fast_s = self._opt_float("fast_window", 60.0)
        slow_s = self._opt_float("slow_window", 300.0)
        fast_burn_thresh = self._opt_float("fast_burn_threshold", 14.4)
        slow_burn_thresh = self._opt_float("slow_burn_threshold", 6.0)
        fast = self._window(fast_s, now)
        slow = self._window(slow_s, now)
        classes: dict[str, dict] = {}
        for klass, snap in fast.items():
            if snap["count"] <= 0:
                continue
            classes[klass] = {
                "count": snap["count"],
                **{
                    f"p{int(p)}_ms": round(
                        1000.0
                        * percentile_from_counts(
                            snap["bounds"], snap["counts"],
                            snap["sum"], p,
                        ),
                        3,
                    )
                    for p in (50, 95, 99)
                },
            }
        burning: list[dict] = []
        for tgt in self._targets:
            verdict = {
                **tgt,
                "target_ms": round(tgt["target_s"] * 1000.0, 3),
            }
            budget = 1.0 - tgt["objective"] / 100.0
            for label, win, thresh in (
                ("fast", fast, fast_burn_thresh),
                ("slow", slow, slow_burn_thresh),
            ):
                snap = win.get(tgt["qos_class"])
                if snap is None or snap["count"] < self.MIN_WINDOW_OPS:
                    verdict[f"{label}_burn"] = 0.0
                    verdict[f"{label}_burning"] = False
                    continue
                frac = fraction_over(
                    snap["bounds"], snap["counts"], tgt["target_s"]
                )
                burn = frac / budget if budget > 0 else 0.0
                verdict[f"{label}_burn"] = round(burn, 3)
                verdict[f"{label}_burning"] = burn >= thresh
            burning.append(verdict)
        checks = self._build_checks(burning)
        self.last_status = {
            "targets": burning,
            "targets_error": self._target_error,
            "classes": classes,
            "fast_window_s": fast_s,
            "slow_window_s": slow_s,
            "active_checks": checks,
        }
        self._push_report(checks, now)

    def _build_checks(self, verdicts: list[dict]) -> dict:
        """WARN on a fast burn, ERR when the slow window burns too
        (sustained budget spend); one rollup check for the plane."""
        warn, err = [], []
        for v in verdicts:
            who = (
                f"{v['qos_class']} p{v['percentile']:g}"
                f"<{v['target_ms']:g}ms"
            )
            if v.get("fast_burning") and v.get("slow_burning"):
                err.append(
                    f"{who} burn {v['slow_burn']:g}x sustained"
                )
            elif v.get("fast_burning"):
                warn.append(f"{who} burn {v['fast_burn']:g}x fast")
        if not warn and not err:
            return {}
        severity = "HEALTH_ERR" if err else "HEALTH_WARN"
        detail = "; ".join(err + warn)
        return {
            "SLO_LATENCY": {
                "severity": severity,
                "summary": (
                    f"{len(err) + len(warn)} latency SLO(s) burning "
                    f"error budget: {detail}"
                ),
            }
        }

    def _push_report(self, checks: dict, now: float) -> None:
        """Push on change immediately; refresh an unchanged NONEMPTY
        set every few seconds (the mon ages reports out, so silence
        means clear — exactly the crash/slow-ops re-report idiom)."""
        unchanged = checks == self._reported
        if unchanged and (not checks or now - self._last_push < 5.0):
            return
        try:
            reply = self.mon_command(
                {"prefix": "slo report", "checks": checks},
                timeout=2.0,  # tick thread: never stall other modules
            )
            if reply.rc == 0:
                self._reported = checks
                self._last_push = now
        except Exception:  # noqa: BLE001 — retried next tick
            pass

    # -- command surface ---------------------------------------------------
    def status(self) -> dict:
        return dict(self.last_status)

    def handle_command(self, cmd: dict) -> MMonCommandReply:
        prefix = cmd.get("prefix", "")
        if prefix == "slo status":
            return MMonCommandReply(outb=json.dumps(self.status()))
        if prefix == "slo targets":
            return MMonCommandReply(
                outb=json.dumps(
                    {
                        "raw": self._targets_raw,
                        "parsed": self._targets,
                        "error": self._target_error,
                    }
                )
            )
        if prefix == "slo targets set":
            raw = str(cmd.get("targets", ""))
            try:
                parse_slo_targets(raw)  # validate before adopting
            except ValueError as e:
                return MMonCommandReply(rc=-22, outs=str(e))
            self.mgr.set_module_option(self.NAME, "targets", raw)
            # persist through the mon config database so an mgr
            # restart keeps evaluating (module options are in-memory)
            try:
                self.mon_command(
                    {"prefix": "config set", "who": "mgr",
                     "key": "slo_targets", "value": raw},
                    timeout=2.0,
                )
            except Exception:  # noqa: BLE001 — runtime set still
                pass  # applies; persistence retried by the operator
            return MMonCommandReply(outs=f"slo targets set to {raw!r}")
        return MMonCommandReply(
            rc=-22, outs=f"unknown slo command {prefix!r}"
        )
