"""The port's qa plane held against the JAX package's, as pure units on
the CPU: the seeded schedule generator, the payload codec, the
consistency oracle's verdicts on hand-built histories, the ddmin
shrinker on synthetic predicates, the repro artifact and the thrasher's
counter schema.

Tolerance: exact. Schedules compare as their JSON text, verdicts as
``Violation.to_dict()`` under one fixed clock, shrink results as the
minimal events and the probe count, repro artifacts as file bytes.
"""

from __future__ import annotations

import pytest

import ceph_tpu.qa as jqa
import ceph_tpu.qa.oracle as joracle
import ceph_tpu.qa.shrink as jshrink
import ceph_tpu.qa.thrasher as jthrasher
import ceph_tpu_torch.qa as tqa
import ceph_tpu_torch.qa.oracle as toracle
import ceph_tpu_torch.qa.shrink as tshrink
import ceph_tpu_torch.qa.thrasher as tthrasher

SMOKE_SEED = 20260807
MUTATION_WEIGHTS = {"power_loss": 3.0, "lossy": 2.0, "settle": 1.0, "kill": 1.0}

SCHEDULES = [
    dict(seed=SMOKE_SEED, duration=30.0, osds=3),
    dict(seed=777, duration=8.0, osds=3, weights=MUTATION_WEIGHTS),
    dict(seed=20260807, duration=45.0, osds=5),
    dict(seed=99, duration=60.0, osds=4),
    dict(seed=424242, duration=45.0, osds=3, pace=2.0,
         weights={"kill": 3.0, "wal_kill": 2.0, "out": 1.5, "lossy": 2.0,
                  "scrub": 1.0, "settle": 2.0}),
    dict(seed=1, duration=120.0, osds=7, weights={"netsplit": 2.0, "fill_pressure": 1.0,
                                                 "reweight": 1.0}),
    dict(seed=987654321, duration=60.0, osds=3),
]


@pytest.mark.parametrize("case", SCHEDULES, ids=[f"seed{c['seed']}_{c['osds']}osd"
                                                  f"_{c['duration']:g}s" for c in SCHEDULES])
def test_schedule_json_equal(case):
    mine = tqa.Schedule.from_seed(**case)
    ref = jqa.Schedule.from_seed(**case)
    assert mine.to_json() == ref.to_json()
    assert tqa.Schedule.from_json(ref.to_json()).to_json() == ref.to_json()
    assert mine.subset(mine.events[::2]).to_json() == ref.subset(ref.events[::2]).to_json()


def test_schedule_rejects_the_same_kinds():
    for qa in (tqa, jqa):
        with pytest.raises(ValueError, match="frobnicate"):
            qa.Schedule.from_seed(1, weights={"frobnicate": 3.0})


@pytest.mark.parametrize("oid,version,size", [("qa-c0-o1", 7, 512), ("x", 1, 8),
                                               ("qa-c1-o3", 12345, 4096), ("o", 3, 0)])
def test_payload_codec_equal(oid, version, size):
    data = toracle.encode_payload(oid, version, size)
    assert data == joracle.encode_payload(oid, version, size)
    corrupt = data[:-1] + bytes([data[-1] ^ 0xFF]) if data else b"junk"
    for blob in (data, corrupt, b"not a payload"):
        assert toracle.parse_payload(blob) == joracle.parse_payload(blob)


# Each history is a list of steps: ("m", client, oid, version, acked,
# delete), ("r", client, oid, observed, payload_ok), ("v", kind,
# detail) for add_violation, ("e", oid) for expected_present.
HISTORIES = {
    "durable": [("m", "c", "a", 1, True, False), ("r", "c", "a", 1, True),
                ("m", "c", "a", 2, True, False), ("r", "c", "a", 2, True),
                ("m", "c", "a", 3, True, True), ("r", "c", "a", None, True)],
    "lost_acked_write": [("m", "c", "a", 1, True, False), ("r", "c", "a", None, True)],
    "stale_read": [("m", "c", "a", 1, True, False), ("m", "c", "a", 2, True, False),
                   ("r", "c", "a", 1, True)],
    "resurrected_delete": [("m", "c", "a", 1, True, False), ("m", "c", "a", 2, True, True),
                           ("r", "c", "a", 1, True)],
    "phantom_version": [("m", "c", "a", 1, True, False), ("r", "c", "a", 5, True),
                        ("m", "c", "b", 1, True, True), ("r", "c", "b", 1, True)],
    "corrupt_payload": [("m", "c", "a", 1, True, False), ("r", "c", "a", 1, False)],
    "indeterminate": [("m", "c", "a", 1, True, False), ("m", "c", "a", 2, False, False),
                      ("r", "c", "a", 1, True)],
    "observation_collapses": [("m", "c", "a", 1, True, False),
                              ("m", "c", "a", 2, False, False),
                              ("r", "c", "a", 2, True), ("r", "c", "a", 1, True)],
    "lost_ack_delete": [("m", "c", "a", 1, True, False), ("m", "c", "a", 2, False, True),
                        ("r", "c", "a", None, True), ("r", "c", "a", 1, True)],
    "expected_present": [("e", "never"), ("m", "c", "a", 1, True, False), ("e", "a"),
                         ("m", "c", "a", 2, True, True), ("e", "a"),
                         ("m", "c", "a", 3, False, False), ("e", "a")],
    "no_health_convergence": [("m", "c", "a", 1, True, False), ("r", "c", "a", None, True),
                              ("v", "no_health_convergence", {"timeout": 1})],
    "many_objects": [("m", f"c{i % 2}", f"o{i % 5}", i // 5 + 1, i % 3 != 0, i % 7 == 6)
                     for i in range(40)]
                    + [("r", "c0", f"o{i}", v, i != 2) for i, v in enumerate([8, 1, None, 3, 2])],
}


def _replay(oracle_mod, thrasher_mod, steps):
    perf = thrasher_mod.build_thrash_perf()
    o = oracle_mod.ConsistencyOracle(perf=perf, clock=lambda: 5.0)
    answers = []
    for step in steps:
        if step[0] == "m":
            _k, client, oid, version, acked, delete = step
            o.note_mutation(client, oid, version, acked=acked, delete=delete)
        elif step[0] == "r":
            _k, client, oid, observed, ok = step
            v = o.note_read(client, oid, observed, payload_ok=ok)
            answers.append(None if v is None else v.to_dict())
        elif step[0] == "v":
            o.add_violation(step[1], step[2])
        else:
            answers.append(o.expected_present(step[1]))
    return (answers, [v.to_dict() for v in o.violations], o.summary(), sorted(o.objects()),
            perf.dump())


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_oracle_verdicts_equal(name):
    mine = _replay(toracle, tthrasher, HISTORIES[name])
    ref = _replay(joracle, jthrasher, HISTORIES[name])
    assert mine == ref
    if name not in ("durable", "indeterminate", "expected_present"):
        assert mine[1], "the history provokes no violation"


def _events(qa, n):
    return [qa.ScheduleEvent(t=float(i), kind="settle", args={"i": i}) for i in range(n)]


SHRINKS = {
    "pair": (12, lambda s: {3, 7} <= {e.args["i"] for e in s}, 64),
    "single": (8, lambda s: any(e.args["i"] == 5 for e in s), 64),
    "max_runs": (64, lambda s: len(s) >= 1, 7),
    "unreproducible": (6, lambda s: False, 64),
    "triple_spread": (40, lambda s: {0, 19, 39} <= {e.args["i"] for e in s}, 64),
    "count": (30, lambda s: sum(e.args["i"] % 4 == 1 for e in s) >= 3, 48),
}


@pytest.mark.parametrize("name", sorted(SHRINKS))
def test_shrink_events_equal(name):
    n, pred, max_runs = SHRINKS[name]
    got = []
    for qa, thr in ((tqa, tthrasher), (jqa, jthrasher)):
        perf = thr.build_thrash_perf()
        minimal, runs = qa.shrink_events(_events(qa, n), pred, perf=perf, max_runs=max_runs)
        got.append(([e.to_dict() for e in minimal], runs, perf.dump()))
    assert got[0] == got[1]


def test_write_repro_documents_equal(tmp_path):
    vio = [{"kind": "lost_acked_write", "oid": "qa-c0-o0", "client": "audit",
            "detail": {}, "t": 1.0}]
    paths = []
    for qa, shrink, sub in ((tqa, tshrink, "torch"), (jqa, jshrink, "jax")):
        s = qa.Schedule.from_seed(5, duration=10.0, osds=3)
        path = qa.write_repro(tmp_path / sub, s, s.events[:2], vio, shrink_runs=4,
                              mutation="suppress_replay")
        assert path.name == "repro_5.json"
        paths.append((path, shrink.load_repro(path)))
    (mine, mine_doc), (ref, ref_doc) = paths
    assert mine.read_bytes() == ref.read_bytes()
    assert mine_doc == ref_doc
    assert mine_doc["report"]["role"] == "qa.thrasher"


def _schema(pc):
    return pc.name, {n: (c.kind, c.description) for n, c in pc._counters.items()}, pc.dump()


def test_thrash_perf_schema_equal():
    assert _schema(tthrasher.build_thrash_perf()) == _schema(jthrasher.build_thrash_perf())


def test_thrasher_rejects_the_same_mutations():
    for qa, thr in ((tqa, tthrasher), (jqa, jthrasher)):
        with pytest.raises(ValueError, match="bogus"):
            thr.Thrasher(qa.Schedule.from_seed(1), mutation="bogus")


def test_thrasher_defaults_to_cuda():
    thr = tthrasher.Thrasher(tqa.Schedule.from_seed(1))
    assert thr.device == "cuda"
    import inspect

    for fn in (tthrasher.ThrashCluster.__init__, tthrasher.ProcThrashCluster.__init__,
               tthrasher.replay_repro):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
