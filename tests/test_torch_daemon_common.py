"""The daemons' common runtime of the port held against the JAX
package's on the CPU: the config schema option by option (the two
backend enums are the one deliberate difference: the port's
``erasure_code_backend`` and ``crush_backend`` default to ``torch``),
the precedence chain, the admin socket's replies over its unix socket,
the op tracker's history, and the cluster-log entries and crash reports.

Tolerance: exact. Fields that carry a clock (stamps, durations, crash
ids) are compared by type, not value.
"""

from __future__ import annotations

import json

import pytest

from ceph_tpu.common import AdminSocket as JAdminSocket
from ceph_tpu.common import Config as JConfig
from ceph_tpu.common import OpTracker as JOpTracker
from ceph_tpu.common import PerfCountersBuilder as JPerfCountersBuilder
from ceph_tpu.common import PerfCountersCollection as JPerfCountersCollection
from ceph_tpu.common import admin_command
from ceph_tpu.common import crash as jcrash
from ceph_tpu.common.config import SCHEMA as JSCHEMA
from ceph_tpu.common.config import ConfigError as JConfigError
from ceph_tpu.common.log_client import LogClient as JLogClient
from ceph_tpu.common.log_client import prio_rank as jprio_rank
from ceph_tpu_torch.common import (
    AdminSocket,
    Config,
    OpTracker,
    PerfCountersBuilder,
    PerfCountersCollection,
)
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.common.config import SCHEMA, ConfigError
from ceph_tpu_torch.common.log_client import LogClient, prio_rank

# the port's backends: the one difference from the JAX schema
BACKENDS = {
    "erasure_code_backend": ("torch", ("torch",)),
    "crush_backend": ("torch", ("oracle", "torch")),
}


@pytest.fixture(autouse=True)
def _drain_port_crash_queue():
    yield
    crash.drain_pending()
    crash.reset_throttle()


def test_schema_names_equal():
    assert sorted(SCHEMA) == sorted(JSCHEMA)


@pytest.mark.parametrize("name", sorted(JSCHEMA))
def test_schema_option(name):
    mine, ref = SCHEMA[name], JSCHEMA[name]
    fields = ("name", "type", "description", "level", "min", "max", "see_also")
    if name in BACKENDS:
        default, allowed = BACKENDS[name]
        assert (mine.default, mine.enum_allowed) == (default, allowed)
        assert ref.default == "jax" and "jax" in ref.enum_allowed
        fields = ("name", "type", "level", "min", "max", "see_also")
    else:
        fields += ("default", "enum_allowed")
    assert {f: getattr(mine, f) for f in fields} == {f: getattr(ref, f) for f in fields}


def _chain(cfg_cls, tmp_path, tag):
    cfg = cfg_cls()
    seen = []
    cfg.add_observer(lambda n, v: seen.append((n, v)))
    trail = [cfg.get("osd_pool_default_size")]
    conf = tmp_path / f"{tag}.json"
    conf.write_text(json.dumps({"osd_pool_default_size": 4, "osd_tpu_batch_max": 8}))
    cfg.parse_file(str(conf))
    trail.append(cfg.get("osd_pool_default_size"))
    cfg.parse_env({"CEPH_TPU_OSD_POOL_DEFAULT_SIZE": "5", "CEPH_TPU_LOCKDEP": "1"})
    trail.append(cfg.get("osd_pool_default_size"))
    cfg.set("osd_pool_default_size", 6)
    trail.append(cfg.get("osd_pool_default_size"))
    cfg.override("osd_pool_default_size", 7)
    trail += [cfg.get("osd_pool_default_size"), cfg.get_source("osd_pool_default_size")]
    cfg.rm("osd_pool_default_size", "override")
    trail += [cfg.get("osd_pool_default_size"), cfg.get_source("osd_pool_default_size")]
    cfg.set("perf_enabled", "false")
    cfg.set("crush_backend", "oracle")
    errors = []
    for opt, val in (
        ("osd_pool_default_size", "not-a-number"),
        ("osd_pool_default_size", 0),
        ("crush_backend", "gpu"),
        ("no_such_option", 1),
    ):
        try:
            cfg.set(opt, val)
        except (ConfigError, JConfigError) as e:
            errors.append(str(e))
    return trail, seen, errors, cfg.diff(), cfg.show_config()


def test_precedence_chain_equal(tmp_path):
    trail, seen, errors, diff, show = _chain(Config, tmp_path, "torch")
    jtrail, jseen, jerrors, jdiff, jshow = _chain(JConfig, tmp_path, "jax")
    assert trail == jtrail == [3, 4, 5, 6, 7, "override", 6, "runtime"]
    assert seen == jseen and len(errors) == len(jerrors) == 4
    # the enum error names each package's allowed backends
    assert errors[2] == "crush_backend: 'gpu' not one of ('oracle', 'torch')"
    assert jerrors[2] == "crush_backend: 'gpu' not one of ('oracle', 'jax')"
    assert errors[:2] + errors[3:] == jerrors[:2] + jerrors[3:]
    # the backends' defaults differ; every other value and source agrees
    assert diff.pop("crush_backend") == {"value": "oracle", "source": "runtime", "default": "torch"}
    assert jdiff.pop("crush_backend") == {"value": "oracle", "source": "runtime", "default": "jax"}
    assert diff == jdiff
    for name in BACKENDS:
        show.pop(name)
        jshow.pop(name)
    assert show == jshow


def _socket(asok_cls, tracker_cls, builder, coll, path):
    perf = coll()
    pc = builder("ec").add_u64_counter("encodes").create_perf_counters()
    perf.add(pc)
    pc.inc("encodes", 5)
    cfg_cls = Config if asok_cls is AdminSocket else JConfig
    asok = asok_cls(str(path), cfg_cls(), perf)
    tracker = tracker_cls(history_size=4)
    tracker.register_admin_commands(asok)
    return asok, tracker


ASOK_COMMANDS = [
    "perf dump",
    "version",
    "help",
    {"prefix": "config set", "var": "osd_max_scrubs", "val": "3"},
    {"prefix": "config get", "var": "osd_max_scrubs"},
    "config diff",
    {"prefix": "config set", "var": "osd_max_scrubs", "val": "many"},
    "nope",
    "perf reset",
    "perf dump",
]


def test_admin_socket_replies_equal(tmp_path):
    replies = {}
    for tag, asok_cls, tracker_cls, builder, coll in (
        ("torch", AdminSocket, OpTracker, PerfCountersBuilder, PerfCountersCollection),
        ("jax", JAdminSocket, JOpTracker, JPerfCountersBuilder, JPerfCountersCollection),
    ):
        asok, _tracker = _socket(asok_cls, tracker_cls, builder, coll, tmp_path / f"{tag}.asok")
        with asok:
            replies[tag] = [admin_command(asok.path, c) for c in ASOK_COMMANDS]
        # the reply over the wire is what execute() answers in process
        assert replies[tag][1] == asok.execute("version")
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][0]["ok"]["ec"]["encodes"] == 5
    assert replies["torch"][-1]["ok"]["ec"]["encodes"] == 0
    assert "error" in replies["torch"][6] and "error" in replies["torch"][7]


def _strip_clock(obj):
    """Replace every clock-bearing field by its type name."""
    if isinstance(obj, dict):
        return {
            k: type(v).__name__
            if k in ("time", "initiated_at", "duration", "stamp", "age", "gap")
            else _strip_clock(v)
            for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [_strip_clock(v) for v in obj]
    return obj


def _drive_tracker(tracker_cls):
    tracker = tracker_cls(history_size=4)
    inflight = []
    for i in range(7):
        with tracker.create_op(
            f"osd_op(client.1 pg 1.{i})", trace=f"r{i}", op_type="write", qos_class="client"
        ) as op:
            op.mark_event("queued_for_pg")
            op.mark_event("commit_sent")
            if i == 3:
                inflight.append(tracker.dump_ops_in_flight())
    with pytest.raises(RuntimeError):
        with tracker.create_op("failing op", op_type="read"):
            raise RuntimeError("op died")
    slow = tracker.dump_historic_slow_ops()
    # which ops the slow history keeps, in what order, and their
    # slowest stage are clock readings: compare its shape
    slow = {
        "num_ops": slow["num_ops"],
        "fields": sorted({k for op in slow["ops"] for k in op}),
        "stage_fields": sorted({k for op in slow["ops"] for k in op.get("slowest_stage", {})}),
    }
    return inflight, tracker.dump_historic_ops(), slow, sorted(tracker.dump_histograms())


def test_op_tracker_history_equal():
    mine = _drive_tracker(OpTracker)
    ref = _drive_tracker(JOpTracker)
    assert _strip_clock(mine) == _strip_clock(ref)
    inflight, hist, _slow, _h = mine
    assert inflight[0]["num_ops"] == 1
    assert hist["num_ops"] == 4
    events = [e["event"] for e in hist["ops"][-1]["type_data"]["events"]]
    assert events == ["start", "exception", "done"]


def _drive_log_client(cls):
    lc = cls("osd.3", max_pending=4)
    lc.channel().warn("w1")
    lc.channel("audit").info("a1")
    first = lc.drain()
    lc.requeue(first)
    lc.channel().error("e1")
    second = lc.drain()
    for i in range(10):
        lc.channel().debug(f"d{i}")
    return first, second, lc.pending_count(), lc.entries_dropped, lc.drain()


def test_log_client_entries_equal():
    mine = _drive_log_client(LogClient)
    ref = _drive_log_client(JLogClient)
    assert _strip_clock(list(mine)) == _strip_clock(list(ref))
    assert [e["message"] for e in mine[1]] == ["w1", "a1", "e1"]
    assert [prio_rank(p) for p in ("debug", "info", "warn", "error")] == [
        jprio_rank(p) for p in ("debug", "info", "warn", "error")
    ]


def _crash_report(mod):
    try:
        raise ValueError("boom for the report")
    except ValueError as e:
        return mod.capture("osd.7", e, sink=[], extra_meta={"work_item": "op"})


def test_crash_report_format_equal():
    mine, ref = _crash_report(crash), _crash_report(jcrash)
    assert sorted(mine) == sorted(ref)
    for key in ("entity_name", "exception", "meta"):
        assert mine[key] == ref[key], key
    # the traceback's last line and the dout tail's crash line agree
    assert mine["backtrace"][-1] == ref["backtrace"][-1]
    assert [e["message"] for e in mine["dout_tail"] if "crashed" in e["message"]][-1] == (
        "osd.7 crashed: ValueError: boom for the report"
    )
    # crash ids are "<iso stamp>_<uuid>" in both
    for rep in (mine, ref):
        stamp, _, uid = rep["crash_id"].partition("_")
        assert stamp == rep["timestamp_iso"] and len(uid) == 36
