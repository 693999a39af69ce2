"""The port's PG log, op schedulers and object classes held against the
JAX package's on the CPU: ``LogEntry``/``PGInfo``/``PGLog`` encodings
both ways, ``find_best_info`` and ``needs_backfill``, the WPQ and mClock
dequeue order under one seeded enqueue sequence (mClock on a virtual
clock), and the ``cls`` built-in methods' results and staged writes.

Tolerance: exact.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

import ceph_tpu.cls as jcls
from ceph_tpu.common.encoding import Decoder as JDecoder
from ceph_tpu.common.encoding import Encoder as JEncoder
from ceph_tpu.osd import pg_log as jpg_log
from ceph_tpu.osd import scheduler as jsched
import ceph_tpu_torch.cls as tcls
from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.osd import pg_log
from ceph_tpu_torch.osd import scheduler as sched


def _entries(mod, seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    out = []
    prior = {}
    for v in range(1, n + 1):
        oid = f"obj{int(rng.integers(0, 9))}"
        op = mod.DELETE if rng.random() < 0.2 else mod.MODIFY
        version = (1 + v // 10, v)
        out.append(
            mod.LogEntry(
                op=op,
                oid=oid,
                version=version,
                prior_version=prior.get(oid, mod.EV_ZERO),
                reqid=f"client.{int(rng.integers(1, 4))}:{v}" if rng.random() < 0.7 else "",
            )
        )
        prior[oid] = version
    return out


def _enc(obj, enc_cls) -> bytes:
    e = enc_cls()
    obj.encode(e)
    return e.getvalue()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_entry_encoding_both_ways(seed):
    mine, ref = _entries(pg_log, seed), _entries(jpg_log, seed)
    for a, b in zip(mine, ref):
        blob = _enc(a, Encoder)
        assert blob == _enc(b, JEncoder)
        # each package decodes the other's bytes to the same entry
        assert pg_log.LogEntry.decode(Decoder(_enc(b, JEncoder))) == a
        assert jpg_log.LogEntry.decode(JDecoder(blob)) == b


def test_pg_info_encoding_both_ways():
    for info in [
        dict(),
        dict(pgid="3.7", last_update=(4, 91), log_tail=(2, 11), last_epoch_started=4),
        dict(pgid="12.1f", last_update=(2**32 - 1, 2**64 - 1), log_tail=(1, 1), last_epoch_started=9),
    ]:
        a, b = pg_log.PGInfo(**info), jpg_log.PGInfo(**info)
        blob = _enc(a, Encoder)
        assert blob == _enc(b, JEncoder)
        assert pg_log.PGInfo.decode(Decoder(blob)) == a
        assert jpg_log.PGInfo.decode(JDecoder(blob)) == b


@pytest.mark.parametrize("seed", [0, 1])
def test_pg_log_operations_equal(seed):
    logs = []
    for mod in (pg_log, jpg_log):
        log = mod.PGLog()
        for ent in _entries(mod, seed):
            log.append(ent)
        res = [log.head, log.missing_since(mod.EV_ZERO), log.missing_since((2, 13))]
        res.append([(e.op, e.oid, e.version) for e in log.entries_after((3, 25))])
        res.append(log.object_op("obj3"))
        log.trim(keep=12)
        res += [log.log_tail, len(log.entries)]
        res.append([(e.oid, e.version) for e in log.truncate_after((4, 33))])
        res.append(log.head)
        logs.append(res)
    mine, ref = logs
    assert repr(mine) == repr(ref).replace("ceph_tpu.osd", "ceph_tpu_torch.osd")


def _infos(mod, seed):
    rng = np.random.default_rng(seed)
    infos = {}
    for osd in range(6):
        if rng.random() < 0.15:
            infos[osd] = mod.PGInfo()
            continue
        les = int(rng.integers(1, 4))
        lu = (les + int(rng.integers(0, 2)), int(rng.integers(1, 40)))
        tail = (1, int(rng.integers(0, lu[1] + 1)))
        infos[osd] = mod.PGInfo(
            pgid="1.0", last_update=lu, log_tail=tail, last_epoch_started=les
        )
    return infos


@pytest.mark.parametrize("seed", range(8))
def test_find_best_info_and_backfill_equal(seed):
    mine, ref = _infos(pg_log, seed), _infos(jpg_log, seed)
    best = pg_log.find_best_info(mine)
    assert best == jpg_log.find_best_info(ref)
    if best is not None:
        for osd in mine:
            assert pg_log.needs_backfill(mine[best], mine[osd]) == jpg_log.needs_backfill(
                ref[best], ref[osd]
            )


def _ops(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    classes = ["client", "recovery", "background", "strict", "gold"]
    ops = []
    for i in range(n):
        klass = classes[int(rng.choice(5, p=[0.5, 0.2, 0.15, 0.05, 0.1]))]
        cost = int(rng.integers(1, 64)) * 4096
        ops.append((klass, cost, f"op{i}", float(rng.random() * 0.01)))
    return ops


def _drain_wpq(mod, seed):
    q = mod.WeightedPriorityQueue()
    q.set_weight("gold", 30)
    out = []
    for klass, cost, item, _dt in _ops(seed):
        q.enqueue(klass, cost, item)
        if int(item[2:]) % 7 == 0:
            out.append(q.dequeue(timeout=0))
    while q.qlen():
        out.append(q.dequeue(timeout=0))
    return out, list(q.class_log)


def _drain_mclock(mod, seed):
    clock = [0.0]
    q = mod.MClockQueue(clock=lambda: clock[0])
    q.set_profile("gold", (50.0, 40.0, 200.0))
    out = []
    for klass, cost, item, dt in _ops(seed):
        clock[0] += dt
        q.enqueue(klass, cost, item)
        if int(item[2:]) % 5 == 0:
            try:
                out.append(q.dequeue(timeout=0.001))
            except TimeoutError:
                out.append(None)
    while q.qlen():
        clock[0] += 0.05
        try:
            out.append(q.dequeue(timeout=0.001))
        except TimeoutError:
            continue
    return out, list(q.class_log)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wpq_dequeue_order_equal(seed):
    mine, ref = _drain_wpq(sched, seed), _drain_wpq(jsched, seed)
    assert mine == ref
    assert len([x for x in mine[0] if x is not None]) == 300


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mclock_dequeue_order_equal(seed):
    mine, ref = _drain_mclock(sched, seed), _drain_mclock(jsched, seed)
    assert mine == ref
    assert len([x for x in mine[0] if x is not None]) == 300


class _Obj:
    """One object's state, as the OSD hands it to a method."""

    def __init__(self):
        self.data = b""
        self.attrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}
        self.exists = False

    def ctx(self, mod):
        return mod.MethodContext(lambda: self.data, self.attrs, self.exists, lambda: self.omap)

    def apply(self, ctx):
        if ctx.removed:
            self.__init__()
            return
        if ctx.new_data is not None:
            self.data = ctx.new_data
        self.attrs.update(ctx.new_attrs)
        for k in ctx.rm_omap:
            self.omap.pop(k, None)
        self.omap.update(ctx.new_omap)
        self.exists = self.exists or ctx.has_staged_writes


CLS_CALLS = [
    ("hello", "say_hello", b"ceph"),
    ("hello", "say_hello", b""),
    ("hello", "record_hello", b"port"),
    ("version", "inc", b""),
    ("version", "inc", b""),
    ("version", "read", b""),
    ("version", "set", b"41"),
    ("version", "inc", b""),
    ("lock", "lock", json.dumps({"cookie": "a"}).encode()),
    ("lock", "lock", json.dumps({"cookie": "b"}).encode()),
    ("lock", "lock", json.dumps({"cookie": "a"}).encode()),
    ("lock", "unlock", json.dumps({"cookie": "a"}).encode()),
    ("lock", "lock", json.dumps({"cookie": "s1", "type": "shared"}).encode()),
    ("lock", "lock", json.dumps({"cookie": "s2", "type": "shared"}).encode()),
    ("lock", "lock", json.dumps({"cookie": "x"}).encode()),
    ("lock", "get_info", b""),
    ("lock", "unlock", json.dumps({"cookie": "zz"}).encode()),
    ("log", "add", b"first line"),
    ("log", "add", json.dumps(["l2", "l3", "l4"]).encode()),
    ("log", "list", json.dumps({"max": 2}).encode()),
    ("log", "trim", b"2"),
    ("log", "list", b""),
    ("nope", "method", b""),
]


def _run_cls(mod, monkeypatch):
    # the lock and log methods stamp time.time(): pin it
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(time=lambda: 1700000000.25))
    obj = _Obj()
    out = []
    for cls_name, method, indata in CLS_CALLS:
        ctx = obj.ctx(mod)
        try:
            ret = mod.default_handler.call(cls_name, method, ctx, indata)
            flags = mod.default_handler.flags_of(cls_name, method)
            out.append(("ok", ret, flags, ctx.notifies))
            obj.apply(ctx)
        except mod.ClassError as e:
            out.append(("err", str(e)))
    out.append((obj.data, obj.attrs, obj.omap))
    out.append(mod.default_handler.classes())
    return out


def test_cls_method_results_equal(monkeypatch):
    mine = _run_cls(tcls, monkeypatch)
    ref = _run_cls(jcls, monkeypatch)
    assert mine == ref
    assert mine[0] == ("ok", b"Hello, ceph!", tcls.RD, [])
    assert mine[9][0] == "err" and "-EBUSY" in mine[9][1]
