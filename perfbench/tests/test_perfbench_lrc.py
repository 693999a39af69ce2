"""The LRC remap cell on the CPU at a reduced size: the driver end to end
with the reference deciding ``correct``, the planted faults turning it
false, the reference's LRC rule against the program plugin's, and the
pre-flight that ends a run whose CRUSH stage the batched mapper
refuses before any update."""

import time

import pytest

from perfbench import maps, run
from perfbench.drivers import _program, osdmap_lrc
from perfbench.reference import crush as refcrush
from perfbench.reference import lrc as reflrc

import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = run.load_spec(ROOT)
CELL = "osdmap_10k_lrc.remap"
PROFILE = {"plugin": "lrc", "k": "4", "m": "2", "l": "3", "crush-locality": "rack",
           "crush-failure-domain": "host"}

# a 400-OSD map in the cell's layout: 4 OSDs a host, 5 hosts a rack, 2
# racks a row (100 hosts, 20 racks, 10 rows); one LRC pool of 1024 PGs
OSDMAP = {"osds": 400, "fanout": [4, 5, 2], "pools": [
    {"pool_id": 1, "type": "erasure", "size": 8, "min_size": 5, "pg_num": 1024,
     "profile": PROFILE}]}
TRAFFIC = {"check": {"cycles": 1, "random_pgs": 100, "domain_pgs": 30}, "preflight_pgs": 64}


def _run(fault="", trace=False, seed=2**31 + 4321):
    # a window long enough for a whole cycle of epochs on a busy CPU:
    # the check and the control need one
    return run.run_cell(SPEC, CELL, seed, 20.0, trace, device="cpu", fault=fault,
                        traffic_overrides=TRAFFIC, config_overrides=OSDMAP)


def test_cell_rehearses_correct():
    line = _run(trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["pgs_differing"]["value"] == 0
    assert line["checks"]["host_route_pgs"]["value"] == 0
    assert line["checks"]["pgs_checked"]["value"] >= 4 * 100
    # the device-trace readers read nothing on the CPU
    assert line["metrics"] == {}


def test_cell_reports_its_end_to_end_metrics():
    line = _run()
    assert set(line["metrics"]) == {m["name"] for m in run.end_to_end_of(SPEC, CELL)}
    assert set(line["metrics"]) == {"mappings_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["altered", "control"])
def test_a_planted_fault_turns_correct_false(fault):
    line = _run(fault=fault)
    assert not line["correct"], line["checks"]


def test_reference_steps_equal_the_program_plugins():
    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance

    h = maps.hierarchy(400, [4, 5, 2])
    cmap = _program.crush_map(h)
    ec = registry_instance().factory("lrc", ErasureCodeProfile(dict(PROFILE), device="cpu"))
    rule = ec.create_rule("lrc", cmap)
    type_ids = {name: t for t, name in maps.type_names(h).items()}
    steps = reflrc.kml_steps(4, 2, 3, "rack", "host")
    ref = reflrc.add_rule(h, min(h.buckets), type_ids, steps)
    assert [(s.op, s.arg1, s.arg2) for s in cmap.rules[rule].steps] == h.rules[ref]
    assert reflrc.chunk_count(4, 2, 3) == ec.get_chunk_count() == 8
    weight = [0x10000] * 400
    for o in range(0, 400, 13):
        weight[o] = 0
    for x in range(0, 1 << 31, (1 << 31) // 60):
        assert refcrush.do_rule(h, ref, x, 8, weight) == cmap.do_rule(rule, x, 8, weight)
    with pytest.raises(ValueError):
        reflrc.kml_steps(8, 4, 4, "rack", "host")  # BASELINE config 3's, refused


def test_preflight_exits_before_any_update(monkeypatch):
    """Where the batched mapper refuses the rule (as it did before it ran
    chained choose steps), the run ends at the pre-flight: no update."""
    from ceph_tpu_torch.crush import torchmap
    from ceph_tpu_torch.osd import OSDMapMapping

    def refuse(rule):
        raise torchmap.UnsupportedMap("rule shape: choose without take")

    def no_update(*a, **k):
        raise AssertionError("an update ran before the pre-flight")

    monkeypatch.setattr(torchmap, "_compile_rule", refuse)
    monkeypatch.setattr(OSDMapMapping, "update", no_update)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="refuses the LRC rule"):
        _run()
    assert time.perf_counter() - t0 < 60


def test_span_busy_time_equals_the_clipping_reader():
    """The LRC readers' one-pass busy time inside many spans equals the
    shared reader's interval-by-interval clipping."""
    import random
    import types

    from perfbench.metrics import _device, _spans

    rng = random.Random(3)
    events, t = [], 0
    for _ in range(5000):
        t += rng.randint(0, 50)
        events.append(("k", t, t + rng.randint(1, 80), rng.random() < 0.1))
    spans, t = [], 0
    while t < events[-1][2]:
        lo = t + rng.randint(0, 300)
        t = lo + rng.randint(1, 2000)
        spans.append((lo, t))
    run_ = types.SimpleNamespace(events=events, window_ns=(0, t), on_card=True)
    assert _spans.busy_ns(run_, spans) == _device.busy_ns(run_, None, spans) > 0


@pytest.mark.parametrize("seed", [3, 2719400001])
def test_host_index_equals_a_scan_of_the_mapping(seed):
    """The driver's index of the base mapping gives each host's PGs as
    ``np.isin`` over every row does, NONE holes and unused OSDs
    included."""
    import numpy as np

    rng = np.random.default_rng(seed)
    up = rng.integers(0, 400, (4096, 8))
    up[rng.random(up.shape) < 0.05] = 0x7FFFFFFF
    of = osdmap_lrc._holders(up)
    for host in ([0, 1, 2, 3], [396, 397, 398, 399], [400, 401, 402, 403], [7, 0x7FFFFFFF - 1]):
        want = np.nonzero(np.isin(up, np.asarray(host)).any(1))[0]
        np.testing.assert_array_equal(of(host), want)
