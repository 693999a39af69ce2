"""qa — the randomized robustness plane (qa/tasks/thrashosds +
ceph_manager.py's Thrasher loop, in-repo and deterministic).

Hand-scripted chaos scenarios (tests/chaos.py) prove exactly the
failure modes someone thought to write down.  This package *generates*
them: a weighted, seed-deterministic schedule of composed faults
(schedule.py) drives a live cluster (thrasher.py) while a continuous
consistency oracle (oracle.py) checks every client op against the
acked history; a violating run shrinks itself to a minimal repro
artifact (shrink.py).  Every run is a pure function of its seed.
"""

from .oracle import ConsistencyOracle, HistoryRecorder, Violation
from .schedule import Schedule, ScheduleEvent
from .shrink import shrink_events, write_repro
from .thrasher import ThrashCluster, Thrasher, build_thrash_perf

__all__ = [
    "ConsistencyOracle",
    "HistoryRecorder",
    "Violation",
    "Schedule",
    "ScheduleEvent",
    "ThrashCluster",
    "Thrasher",
    "build_thrash_perf",
    "shrink_events",
    "write_repro",
]
