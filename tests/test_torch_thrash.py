"""The port's thrasher live on the CPU: 3 ``OSD(device="cpu")`` over
WAL-fronted MemStores, a monitor, a manager and the oracle's workload,
in this process.

- The smoke thrash at the JAX tier-1 gate's seed and length, held as
  ``tests/test_qa_thrasher.py`` holds the JAX one: zero violations,
  HEALTH_OK, at least half the events applied, a workload that ran.
- The executed trace (each event applied or skipped, and why) of the
  8 s mutation schedule equals the JAX thrasher's on the same schedule:
  the guards are a pure function of the events applied.

The mutation gate is in ``tests/test_torch_thrash_mutation.py``, so
each file stays well inside a worker's share of the tier-1 run.
"""

from __future__ import annotations

import json
import re

import pytest

import ceph_tpu.msg as jmsg
from ceph_tpu.qa import Schedule as JSchedule
from ceph_tpu.qa.thrasher import Thrasher as JThrasher
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.msg import NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.qa import Schedule
from ceph_tpu_torch.qa.thrasher import Thrasher

SMOKE_SEED = 20260807
MUTATION_WEIGHTS = {"power_loss": 3.0, "lossy": 2.0, "settle": 1.0, "kill": 1.0}


@pytest.fixture(autouse=True)
def no_live_reactor():
    yield
    crash.drain_pending()
    crash.reset_throttle()
    assert wait_for(
        lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None, 10.0
    )


def test_smoke_thrash_fixed_seed():
    sched = Schedule.from_seed(SMOKE_SEED, duration=30.0, osds=3)
    assert sched.to_json() == JSchedule.from_seed(SMOKE_SEED, duration=30.0, osds=3).to_json()
    thr = Thrasher(sched, convergence_timeout=60.0, device="cpu")
    report = thr.run()
    assert report["violations"] == [], json.dumps(report["violations"], indent=2)
    assert report["converged"], "never reached HEALTH_OK"
    assert report["events_applied"] >= len(sched.events) // 2, report["trace"]
    assert report["ops"] > 50, "workload barely ran"
    assert report["audited"] > 0
    perf = thr.perf.dump()
    assert perf["l_thrash_events"] == report["events_applied"]
    assert perf["l_thrash_violations"] == 0


def _trace(report) -> list:
    """(t, kind, applied, note) with the replayed-record counts masked:
    how many WAL records a remount replays depends on timing."""
    return [
        (e["t"], e["kind"], e["applied"], re.sub(r"replayed=\d+", "replayed=N", e["note"]))
        for e in report["trace"]
    ]


def test_executed_trace_equals_the_jax_thrasher():
    kw = dict(duration=8.0, osds=3, weights=MUTATION_WEIGHTS)
    mine = Thrasher(Schedule.from_seed(777, **kw), time_scale=2.0, convergence_timeout=20.0,
                    device="cpu").run()
    ref = JThrasher(JSchedule.from_seed(777, **kw), time_scale=2.0,
                    convergence_timeout=20.0).run()
    assert _trace(mine) == _trace(ref)
    assert len(mine["trace"]) == len(Schedule.from_seed(777, **kw).events)
    assert any(e[1] == "power_loss" and e[2] for e in _trace(mine))
    assert mine["violations"] == [] and ref["violations"] == []
    assert mine["converged"] and ref["converged"]
