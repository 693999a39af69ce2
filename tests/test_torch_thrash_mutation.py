"""The port's mutation gate, on the CPU: with WAL replay suppressed on
every remount (``mutation="suppress_replay"``) the oracle must report
``lost_acked_write``, the shrinker must cut the schedule to at most a
quarter of its events, and the repro artifact it writes must name the
mutation and reproduce the violation on its own — as
``tests/test_qa_thrasher.py`` holds the JAX thrasher.
"""

from __future__ import annotations

import json

import pytest

import ceph_tpu.msg as jmsg
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.msg import NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.qa import Schedule
from ceph_tpu_torch.qa.thrasher import Thrasher, replay_repro

MUTATION_WEIGHTS = {"power_loss": 3.0, "lossy": 2.0, "settle": 1.0, "kill": 1.0}


@pytest.fixture(autouse=True)
def no_live_reactor():
    yield
    crash.drain_pending()
    crash.reset_throttle()
    assert wait_for(
        lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None, 10.0
    )


def test_mutation_gate_oracle_fires_and_shrinks(tmp_path):
    sched = Schedule.from_seed(777, duration=8.0, osds=3, weights=MUTATION_WEIGHTS)
    assert any(e.kind == "power_loss" for e in sched.events)
    thr = Thrasher(sched, mutation="suppress_replay", time_scale=2.0,
                   convergence_timeout=20.0, device="cpu")
    report = thr.run_with_shrink(artifact_dir=tmp_path, max_shrink_runs=16)
    kinds = {v["kind"] for v in report["violations"]}
    assert "lost_acked_write" in kinds, report["violations"]
    assert len(report["minimal_events"]) <= max(1, len(sched.events) // 4), (
        f"shrink too weak: {len(report['minimal_events'])} of {len(sched.events)} events"
    )
    assert thr.perf.dump()["l_thrash_shrink_steps"] == report["shrink_runs"]

    path = report["repro_path"]
    doc = json.loads(open(path).read())
    assert doc["mutation"] == "suppress_replay"
    assert doc["report"]["role"] == "qa.thrasher"
    replay = replay_repro(path, time_scale=2.0, device="cpu")
    assert any(v["kind"] == "lost_acked_write" for v in replay["violations"])
