"""The spans and counters of the port's OSD-map mapping path, on the CPU.

Under an ambient tracer ``OSDMapMapping.update`` opens
``osdmap_mapping.update`` > ``crush_stage`` > ``dev_compute`` /
``dev_sync``, and a ``sync.<site>`` span at each host wait (the
download among them), whatever the route; without one it makes none and maps the same.
The ``osdmap_mapping`` counters ``crush_oracle_lanes``,
``crush_compiles`` and ``host_syncs`` count traced or not, and
``osdmaptool --trace`` prints both.  Spans are stamped in integer
nanoseconds of ``time.time_ns()``.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import tracing
from ceph_tpu_torch.crush import torchmap
from ceph_tpu_torch.ops import mesh as meshmod
from ceph_tpu_torch.osd import Incremental, OSDMap, OSDMapMapping, PgPool
from ceph_tpu_torch.tools import osdmaptool
from ceph_tpu_torch.tools.crushtool import build_hierarchy

ARRAYS = ("up", "up_primary", "acting", "acting_primary")


def mixed_weight_vector(n, seed=3):
    """A sixth of the OSDs out and a fifth at half weight: enough
    ``is_out`` rejects that some lanes outrun the fast path's window."""
    rng = np.random.default_rng(seed)
    w = np.full(n, 0x10000, dtype=np.int64)
    w[rng.choice(n, size=max(1, n // 6), replace=False)] = 0
    w[rng.choice(n, size=max(1, n // 5), replace=False)] = 0x8000
    return w


def cluster(reweights=False):
    """5 hosts of 4 OSDs, one replicated pool of 512 PGs x 3."""
    om = OSDMap.build(build_hierarchy(20, 4), 20)
    om.add_pool(PgPool(pool_id=1, size=3, crush_rule=0, pg_num=512))
    if reweights:
        om.osd_weight = [int(w) for w in mixed_weight_vector(20)]
    return om


def counters(mapping):
    d = mapping.perf.dump()
    return {k: d[k] for k in ("crush_oracle_lanes", "crush_compiles", "host_syncs")}


def test_update_yields_the_span_tree():
    om = cluster()
    mapping = OSDMapMapping(device="cpu")
    mapping.update(om)
    syncs = mapping.perf.dump()["host_syncs"]
    tracer = tracing.Tracer("test")
    inc = Incremental(epoch=om.epoch + 1)
    inc.mark_down(3)
    with tracer.start_span("epoch"):
        om.apply_incremental(inc)
        mapping.update(om)
    spans = tracer.dump_traces()["spans"]
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    parent = {s["span_id"]: s for s in spans}

    def parent_of(name):
        (s,) = by_name[name]
        return parent[s["parent_id"]]["name"]

    assert parent_of("osdmap_mapping.update") == "epoch"
    assert parent_of("crush_stage") == "osdmap_mapping.update"
    assert parent_of("dev_compute") == "crush_stage"
    assert parent_of("dev_sync") == "crush_stage"
    assert by_name["osdmap_mapping.update"][0]["tags"] == {
        "epoch": om.epoch, "pools": 1, "pgs": 512}
    assert by_name["crush_stage"][0]["tags"] == {"pool": 1, "pgs": 512}
    # every host wait is a sync.<site> span, one for each count; the
    # seeds hashed by the first update are kept (no pool_id_upload)
    sites = {s["name"]: parent[s["parent_id"]]["name"] for s in spans
             if s["name"].startswith("sync.")}
    assert sites == {
        "sync.weights_upload": "dev_compute",
        "sync.ok_read": "dev_sync",
        "sync.exists_upload": "osdmap_mapping.update",
        "sync.up_upload": "osdmap_mapping.update",
        "sync.download": "osdmap_mapping.update",
    }
    syncs = mapping.perf.dump()["host_syncs"] - syncs
    assert sum(s["name"].startswith("sync.") for s in spans) == syncs == 5
    assert len({s["trace_id"] for s in spans}) == 1
    assert tracer.dump_traces()["spans_dropped"] == 0


@pytest.mark.parametrize("change", ["none", "pgp_num", "hashpspool", "pool_gone"])
def test_seeds_are_hashed_again_only_where_the_pool_changed(change):
    """An update hashes a pool's seeds (``sync.pool_id_upload``) when it
    first maps the pool or after its pgp_num or hashing changed; every
    update's rows equal the scalar map's."""
    om = cluster()
    om.add_pool(PgPool(pool_id=2, size=3, crush_rule=0, pg_num=64))
    mapping = OSDMapMapping(device="cpu")
    mapping.update(om)
    assert set(mapping._seeds) == {1, 2}
    if change == "pgp_num":
        om.pools[1].pgp_num = 256
    elif change == "hashpspool":
        om.pools[1].hashpspool = False
    elif change == "pool_gone":
        del om.pools[2]
    tracer = tracing.Tracer("test")
    with tracer.start_span("epoch"):
        mapping.update(om)
    hashed = [s for s in tracer.dump_traces()["spans"] if s["name"] == "sync.pool_id_upload"]
    assert len(hashed) == (change == "pgp_num")  # seeds without hashpspool upload nothing
    assert set(mapping._seeds) == ({1} if change == "pool_gone" else {1, 2})
    for ps in range(0, 512, 5):
        got, want = mapping.get(1, ps), om.pg_to_up_acting_osds(1, ps)
        assert got == (want[0], want[1], want[2], want[3])


def test_without_a_tracer_no_span_is_made_and_results_are_equal(monkeypatch):
    om = cluster(reweights=True)
    traced = OSDMapMapping(device="cpu")
    tracer = tracing.Tracer("test")
    with tracer.start_span("epoch"):
        traced.update(om)
    assert tracer.dump_traces()["num_spans"] > 10

    def no_span(*a, **k):
        raise AssertionError("a span was made with no tracer installed")

    monkeypatch.setattr(tracing.Span, "__init__", no_span)
    assert tracing.span("crush_stage") is tracing.NULL_SPAN
    plain = OSDMapMapping(device="cpu")
    plain.update(om)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(plain, name)[1], getattr(traced, name)[1])
    # the tables are cached on the map: only the first mapping compiled
    assert counters(plain) == dict(counters(traced), crush_compiles=0)


def test_oracle_lanes_equal_the_fallback_lanes():
    om = cluster(reweights=True)
    mapping = OSDMapMapping(device="cpu")
    before = torchmap.counts["crush_oracle_lanes"]
    tracer = tracing.Tracer("test")
    with tracer.start_span("epoch"):
        mapping.update(om)
    lanes = torchmap.counts["crush_oracle_lanes"] - before
    assert lanes > 0
    assert counters(mapping)["crush_oracle_lanes"] == lanes
    (fallback,) = [s for s in tracer.dump_traces()["spans"] if s["name"] == "oracle_fallback"]
    assert fallback["tags"] == {"lanes": lanes}
    # the oracle's four downloads and two uploads are host waits too
    assert counters(mapping)["host_syncs"] == 6 + 4 + 2
    for ps in range(0, 512, 7):
        got = mapping.get(1, ps)
        want = om.pg_to_up_acting_osds(1, ps)
        assert (got[1], got[3]) == (want[1], want[3])


def test_compiles_counted_once_a_map():
    om = cluster()
    mapping = OSDMapMapping(device="cpu")
    compiles = []
    for _ in range(2):
        mapping.update(om)
        compiles.append(counters(mapping)["crush_compiles"])
    om.crush.touch()  # a CRUSH mutation
    mapping.update(om)
    compiles.append(counters(mapping)["crush_compiles"])
    assert np.diff([0] + compiles).tolist() == [1, 0, 1]


def test_override_stages_span_their_host_waits():
    om = cluster()
    om.pg_upmap[(1, 3)] = [0, 4, 8]
    om.pg_upmap_items[(1, 7)] = [(om.pg_to_up_acting_osds(1, 7)[0][0], 13)]
    om.pg_temp[(1, 5)] = [10, 14, 18]
    om.primary_temp[(1, 9)] = 6
    om.osd_primary_affinity = [0x10000] * 20
    om.osd_primary_affinity[1] = 0
    mapping = OSDMapMapping(device="cpu")
    mapping.update(om)
    syncs = counters(mapping)["host_syncs"]
    tracer = tracing.Tracer("test")
    with tracer.start_span("epoch"):
        mapping.update(om)
    sites = [s["name"] for s in tracer.dump_traces()["spans"] if s["name"].startswith("sync.")]
    assert len(sites) == counters(mapping)["host_syncs"] - syncs
    assert {"sync.upmap_rows_upload", "sync.upmap_read", "sync.upmap_upload",
            "sync.affinity_upload"} <= set(sites)
    assert sites.count("sync.temp_upload") == 5
    for ps in (3, 5, 7, 9):
        got, want = mapping.get(1, ps), om.pg_to_up_acting_osds(1, ps)
        assert (got[1], got[3]) == (want[1], want[3])


def test_the_oracle_route_spans_its_host_waits():
    om = cluster()
    mapping = OSDMapMapping(device="cpu")
    tracer = tracing.Tracer("test")
    with tracer.start_span("epoch"):
        mapping.update(om, use_device=False)
    spans = tracer.dump_traces()["spans"]
    parent = {s["span_id"]: s["name"] for s in spans}
    sites = {s["name"]: parent[s["parent_id"]] for s in spans if s["name"].startswith("sync.")}
    # the seed; the oracle's download and upload; two fix-up uploads and the download
    assert sites == {
        "sync.pool_id_upload": "osdmap_mapping.update",
        "sync.oracle_download": "crush_stage",
        "sync.oracle_upload": "crush_stage",
        "sync.exists_upload": "osdmap_mapping.update",
        "sync.up_upload": "osdmap_mapping.update",
        "sync.download": "osdmap_mapping.update",
    }
    assert counters(mapping) == {"crush_oracle_lanes": 0, "crush_compiles": 0, "host_syncs": 6}


def test_the_mesh_route_counts_its_compiles_and_every_wait(monkeypatch):
    """A default mesh of four ``cpu:0`` entries: the tables compile once
    for the one distinct device, and the waits inside the sharded call
    (under ``sync.mesh_gather``) are spans and counts like any other."""
    om = cluster(reweights=True)
    plain = OSDMapMapping(device="cpu")
    plain.update(om)
    meshmod._reset_default_mesh_for_tests()
    monkeypatch.setattr(meshmod, "available_devices", lambda: [torch.device("cpu", 0)] * 4)
    monkeypatch.setenv("CEPH_TPU_MESH", "1")
    try:
        mapping = OSDMapMapping(device="cpu:0")
        lanes = torchmap.counts["crush_oracle_lanes"]
        tracer = tracing.Tracer("test")
        with tracer.start_span("epoch"):
            mapping.update(om)
        lanes = torchmap.counts["crush_oracle_lanes"] - lanes
    finally:
        meshmod._reset_default_mesh_for_tests()
    spans = tracer.dump_traces()["spans"]
    parent = {s["span_id"]: s["name"] for s in spans}
    sites = [s for s in spans if s["name"].startswith("sync.")]
    inner = [s["name"] for s in sites if parent[s["parent_id"]] == "sync.mesh_gather"]
    assert inner == ["sync.weights_upload"] * 4  # a reweight vector a shard
    assert lanes > 0
    assert counters(mapping) == {"crush_oracle_lanes": lanes, "crush_compiles": 1,
                                 "host_syncs": len(sites)}
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(mapping, name)[1], getattr(plain, name)[1])


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_osdmaptool_trace_prints_the_spans_and_the_waits(capsys, backend):
    argv = ["--test-map-pgs", "--build", "48:4:4", "--pg-num", "300", "--device", "cpu",
            "--backend", backend]
    assert osdmaptool.main(argv) == 0
    plain = capsys.readouterr().out.splitlines()
    assert osdmaptool.main(argv + ["--trace"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == plain[1] and len(plain) == 2
    assert lines[2] == "  trace of the timed update (span, ms, count):"
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[3:-1]}
    assert {"test_map_pgs", "osdmap_mapping.update", "crush_stage",
            "sync.download"} <= set(rows)
    assert all(float(ms) >= 0 and int(n) == 1 for ms, n in rows.values())
    waits = sum(name.startswith("sync.") for name in rows)
    assert lines[-1] == (
        f"  host waits {waits}, oracle lanes 0, table compiles 0, kernel draws 0, "
        "chained lanes 0, fast replays 0, host route pgs 0"
    )


@pytest.mark.parametrize("finished", [True, False])
def test_span_stamps_are_integer_nanoseconds(finished):
    tracer = tracing.Tracer("test")
    lo = time.time_ns()
    span = tracer.start_span("s")
    if finished:
        span.finish()
        d = tracer.dump_traces()["spans"][0]
    else:
        d = span.dump()
    hi = time.time_ns()
    assert isinstance(span.start_ns, int) and isinstance(d["start_ns"], int)
    assert isinstance(d["end_ns"], int)
    assert lo <= d["start_ns"] <= d["end_ns"] <= hi
    for key in ("start", "end", "duration"):
        assert isinstance(d[key], float)
    assert d["start"] == d["start_ns"] / 1e9 and d["end"] == d["end_ns"] / 1e9
    assert d["duration"] == pytest.approx((d["end_ns"] - d["start_ns"]) / 1e9)
    assert tracing.assemble_tree([d])[0]["span_id"] == d["span_id"]
