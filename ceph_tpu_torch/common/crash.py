"""Crash capture (the reference's SIGSEGV/assert handler dump +
src/pybind/mgr/crash's report shape).

Daemon loops call :func:`capture` from their catch-all handlers; the
report bundles the traceback, the tail of the process dout ring
(exactly what the reference's async log dumps on crash), and daemon
metadata under a ``crash_id`` shaped like the reference's
(``<ISO stamp>_<uuid>``).

Delivery is two-path, matching how this framework deploys:

- daemons with an mgr session (the OSD) keep a local sink and
  piggyback reports on their next MMgrReport push — the wire path;
- daemons without one (mon, mds, mgr modules) append to the
  process-global pending queue, which the mgr ``crash`` module drains
  directly (co-hosted daemons share the process — documented
  deviation from the reference's ceph-crash uploader).

The mgr module dedupes by ``crash_id``, so double delivery is
harmless.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
import uuid
from collections import deque
from datetime import datetime, timezone

from .log import log as _ring_log

# schema bounds (tools/check_metrics.py lints these)
MAX_BACKTRACE_LINES = 100
MAX_BACKTRACE_LINE_LEN = 2048
DOUT_TAIL_LINES = 50

_pending: deque[dict] = deque(maxlen=64)
_pending_lock = threading.Lock()

# per-signature throttle (the reference crash module dedupes by stack
# signature): a loop that dies identically every tick must not flood
# the crash store, the clog, and RECENT_CRASH with one fresh-uuid
# report per iteration
THROTTLE_WINDOW = 60.0
_MAX_SIGNATURES = 128
_recent_sigs: dict[tuple, float] = {}
_sig_lock = threading.Lock()
suppressed_total = 0


def _throttled(entity: str, exc: BaseException) -> bool:
    """True when an identical (entity, exception) crashed within the
    window — the new occurrence is counted, not reported."""
    global suppressed_total
    sig = (entity, type(exc).__name__, str(exc)[:120])
    now = time.monotonic()
    with _sig_lock:
        last = _recent_sigs.get(sig)
        if last is not None and now - last < THROTTLE_WINDOW:
            suppressed_total += 1
            return True
        if len(_recent_sigs) >= _MAX_SIGNATURES:
            _recent_sigs.clear()  # coarse reset beats unbounded growth
        _recent_sigs[sig] = now
        return False


def reset_throttle() -> None:
    """Forget signature history (test isolation)."""
    with _sig_lock:
        _recent_sigs.clear()


def build_report(
    entity: str, exc: BaseException, extra_meta: dict | None = None
) -> dict:
    """Traceback + dout-ring tail + daemon metadata, under a
    reference-shaped crash id."""
    from ..version import FRAMEWORK_VERSION

    now = time.time()
    stamp = (
        datetime.fromtimestamp(now, tz=timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    )
    lines = traceback.format_exception(type(exc), exc, exc.__traceback__)
    backtrace = [
        ln[:MAX_BACKTRACE_LINE_LEN]
        for chunk in lines
        for ln in chunk.rstrip("\n").split("\n")
    ][:MAX_BACKTRACE_LINES]
    meta = {
        "framework_version": FRAMEWORK_VERSION,
        "python_version": sys.version.split()[0],
        "platform": sys.platform,
    }
    if extra_meta:
        meta.update(extra_meta)
    return {
        "crash_id": f"{stamp}_{uuid.uuid4()}",
        "entity_name": entity,
        "timestamp": now,
        "timestamp_iso": stamp,
        "exception": f"{type(exc).__name__}: {exc}",
        "backtrace": backtrace,
        "dout_tail": _ring_log().dump_recent()[-DOUT_TAIL_LINES:],
        "meta": meta,
    }


def build_process_report(
    entity: str,
    returncode: int,
    log_tail: list[str] | None = None,
    extra_meta: dict | None = None,
) -> dict:
    """A crash report for a REAL process death (the supervisor's
    ceph-crash role): same schema as :func:`build_report`, but the
    "exception" is the wait status (signal name for a killed child,
    exit code otherwise) and the backtrace is the tail of the child's
    captured log — the closest thing to a stack an external observer
    has."""
    import signal as _signal

    from ..version import FRAMEWORK_VERSION

    now = time.time()
    stamp = (
        datetime.fromtimestamp(now, tz=timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    )
    if returncode < 0:
        try:
            signame = _signal.Signals(-returncode).name
        except ValueError:
            signame = f"signal {-returncode}"
        exception = f"ProcessDeath: killed by {signame}"
    else:
        exception = f"ProcessDeath: exited with status {returncode}"
    backtrace = [
        ln[:MAX_BACKTRACE_LINE_LEN] for ln in (log_tail or [])
    ][-MAX_BACKTRACE_LINES:]
    meta = {
        "framework_version": FRAMEWORK_VERSION,
        "python_version": sys.version.split()[0],
        "platform": sys.platform,
        "process_death": True,
        "returncode": returncode,
    }
    if extra_meta:
        meta.update(extra_meta)
    return {
        "crash_id": f"{stamp}_{uuid.uuid4()}",
        "entity_name": entity,
        "timestamp": now,
        "timestamp_iso": stamp,
        "exception": exception,
        "backtrace": backtrace,
        "dout_tail": [],
        "meta": meta,
    }


def capture(
    entity: str,
    exc: BaseException,
    sink=None,
    clog=None,
    extra_meta: dict | None = None,
) -> dict | None:
    """Build a report and queue it for the mgr crash module.

    ``sink`` is the daemon's local pending deque (wire delivery via
    MMgrReport); without one the report joins the process-global
    queue.  ``clog`` (a LogChannel) additionally announces the crash
    on the cluster log — the health timeline entry.

    Identical (entity, exception) faults within ``THROTTLE_WINDOW``
    return None without filing a report (counted in
    ``suppressed_total``)."""
    if _throttled(entity, exc):
        return None
    # derr the fault FIRST (the reference's handler does too), so the
    # ring tail in the report always carries at least the crash line
    subsys = entity.split(".", 1)[0]
    _ring_log().derr(
        subsys, f"{entity} crashed: {type(exc).__name__}: {exc}"
    )
    report = build_report(entity, exc, extra_meta=extra_meta)
    if sink is not None:
        sink.append(report)
    else:
        with _pending_lock:
            _pending.append(report)
    if clog is not None:
        try:
            clog.error(
                f"daemon {entity} crashed: {report['exception']} "
                f"(crash id {report['crash_id']})"
            )
        except Exception:  # noqa: BLE001 — capture must never raise
            pass
    return report


def drain_pending() -> list[dict]:
    """Take the process-global queue (the mgr crash module's direct
    ingest path)."""
    with _pending_lock:
        out = list(_pending)
        _pending.clear()
        return out
