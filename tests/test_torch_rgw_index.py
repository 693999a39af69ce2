"""The port's sharded bucket index held against the JAX package's, on
the CPU.

Pure functions on seeded inputs: ``shard_of`` over many keys and shard
counts, ``shard_oid``, and the canonical bucket-record and
reshard-entry encodings give equal values and bytes.

On live clusters (``tests/test_torch_cluster.py``'s ``Cluster`` pair,
the port's OSDs on ``device="cpu"``), the same seeded sequence runs on
both, each package driving its own cluster: an unsharded bucket in
the 3-replica pool beside a 4-shard one in the isa k=3 m=2 pool, their
HTTP listing pages across marker and max-keys edges, stat and delete
and the emptiness probe across shards, a quiet reshard 1 -> 4 -> 2 that
leaves the datalog alone, a resharder crashed at each stage and then
resumed, a superseded resharder, the per-shard fill check's queue
drained by ``reshard process`` and by the ``ReshardWorker``, the
progress events, and the ``l_rgw_*`` counters. Equal, exactly: every
result and error, every page, every progress event and every counter.
The clock and the entropy are ``test_torch_rgw``'s (a fixed clock the
sequence moves forward past the cutover grace; seeded ``os.urandom``
for the gateway), and the reshard reports' ``duration_s`` is taken
out (monotonic clock); nothing else is masked.

Under concurrent PUTs and DELETEs (3 writer threads) each package's
online reshard loses no acked entry and lists no phantom, its datalog
counts exactly the client ops, and its listing pages equal those of
the other package's gateway holding the final state unsharded on the
same cluster.
"""

from __future__ import annotations

import random
import threading

import pytest

from ceph_tpu.rados import Rados as JRados
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.rados import Rados

from test_torch_rgw import (  # noqa: F401 — the fixtures are this module's too
    CLOCK, ENTROPY, PKGS, T0, _drain_port_crash_queue, _http, _recorder, _timeless, clusters,
)

TORCH, JAX = PKGS["torch"], PKGS["jax"]


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 7, 8, 16, 61, 1021])
def test_shard_of_and_oid_equal(num_shards):
    rng = random.Random(num_shards)
    keys = [f"key-{i:05d}" for i in range(2000)] + [
        "".join(chr(rng.randrange(32, 0x2FF)) for _ in range(rng.randrange(1, 40)))
        for _ in range(2000)]
    got = [TORCH.index.shard_of(k, num_shards) for k in keys]
    assert got == [JAX.index.shard_of(k, num_shards) for k in keys]
    assert set(got) == set(range(num_shards)) or num_shards > 64
    for gen in (0, 1, 5):
        for s in range(min(num_shards, 8)):
            assert (TORCH.index.shard_oid("b", gen, s, num_shards)
                    == JAX.index.shard_oid("b", gen, s, num_shards))


@pytest.mark.parametrize("seed", range(4))
def test_record_encodings_equal(seed):
    rng = random.Random(seed)
    rec = {"ctime": rng.random() * 2e9, "owner": rng.choice([None, "alice", "bob"]),
           "acl": {"owner": "alice", "grants": [{"grantee": "ALL", "perms": ["READ"]}]},
           "index": {"gen": rng.randrange(9), "num_shards": rng.randrange(1, 64)}}
    if seed % 2:
        rec["reshard"] = {"status": rng.choice(["in_progress", "cutover"]),
                          "target_gen": rng.randrange(9), "target_shards": rng.randrange(64),
                          "stamp": rng.random() * 2e9}
    ent = {"bucket": f"b{seed}", "target_shards": rng.randrange(2, 64),
           "reason": "threshold", "queued_at": rng.random() * 2e9}
    blob = TORCH.index.encode_bucket_record(rec)
    assert blob == JAX.index.encode_bucket_record(rec)
    assert TORCH.index.decode_bucket_record(blob) == JAX.index.decode_bucket_record(blob)
    blob = TORCH.index.encode_reshard_entry(ent)
    assert blob == JAX.index.encode_reshard_entry(ent)
    assert TORCH.index.decode_reshard_entry(blob) == JAX.index.decode_reshard_entry(blob)


def _full_listing(gw, bucket, max_keys=1000):
    out, marker = [], ""
    while True:
        entries, trunc = gw.list_objects(bucket, marker=marker, max_keys=max_keys)
        out.extend(entries)
        if not trunc:
            return out
        marker = entries[-1]["key"]


QUERIES = [{}, {"max-keys": "1"}, {"max-keys": "2"}, {"max-keys": "7"}, {"max-keys": "100"},
           {"marker": "img/011.jpg", "max-keys": "3"}, {"marker": "log.9", "max-keys": "50"},
           {"marker": "zz/tail"}, {"marker": "a", "max-keys": "1"}]


def _index_scenario(ns, rados) -> list:
    RGW, RGWError = ns.rgw.RGW, ns.rgw.RGWError
    shard_of, shard_oid = ns.index.shard_of, ns.index.shard_oid
    CLOCK.now = T0 + 5000.0
    ENTROPY.reset()
    out = []
    rec = _recorder(out)

    io_u, io_s = rados.open_ioctx("rep"), rados.open_ioctx("ec")
    gw_u, gw_s = RGW(io_u, name="idx.u"), RGW(io_s, bucket_index_shards=4, name="idx.s")
    events = []
    for gw in (gw_u, gw_s):
        gw.progress_hook = lambda *a: events.append(a)
    port_u, port_s = gw_u.serve(), gw_s.serve()
    gws = [gw_u, gw_s]
    try:
        # -- sharded vs unsharded listings
        rec("create u", lambda: gw_u.create_bucket("b"))
        rec("create s", lambda: gw_s.create_bucket("b"))
        rec("s shards", lambda: gw_s._bucket_rec("b")["index"])
        keys = ([f"img/{i:03d}.jpg" for i in range(23)] + [f"log.{i}" for i in range(17)]
                + ["a", "zz/tail", "m-mid", "img/", "img0"])
        for i, k in enumerate(keys):
            body = f"payload-{i}".encode() * (i % 3 + 1)
            for gw in gws:
                rec(f"put {k} {gw.name}", lambda: gw.put_object("b", k, body))
        rec("filled", lambda: [len(io_s.omap_get_vals(shard_oid("b", 0, s, 4)))
                               for s in range(4)])
        rec("legacy oid", lambda: io_s.stat("bucket.index.b"))
        for q in QUERIES:
            for port in (port_u, port_s):
                rec(f"page {q} {port == port_s}",
                    lambda: _http(ns.rgw, port, "GET", "/b", query=q)[:2])
        for gw in gws:
            rec(f"walk {gw.name}", lambda: _full_listing(gw, "b", max_keys=2))

        # -- stat, delete and the emptiness probe across shards
        rec("probe bucket", lambda: gw_s.create_bucket("probe"))
        key = next(f"k{i}" for i in range(64) if shard_of(f"k{i}", 4) != 0)
        rec("probe put", lambda: gw_s.put_object("probe", key, b"x"))
        rec("probe stat", lambda: gw_s.stat_object("probe", key))
        rec("probe delete full", lambda: gw_s.delete_bucket("probe"))
        rec("probe delete object", lambda: gw_s.delete_object("probe", key))
        rec("probe delete", lambda: gw_s.delete_bucket("probe"))
        for s in range(4):
            rec(f"probe shard {s}", lambda: io_s.stat(shard_oid("probe", 0, s, 4)))

        # -- a quiet reshard leaves the datalog alone
        rec("quiet", lambda: gw_u.create_bucket("quiet"))
        for i in range(40):
            rec(f"quiet put {i}", lambda: gw_u.put_object("quiet", f"o{i:03d}", f"v{i}".encode()))
        rec("quiet head", gw_u.datalog_head)
        rec("quiet 1->4", lambda: _timeless(gw_u.bucket_reshard("quiet", 4)))
        rec("quiet head after", gw_u.datalog_head)
        rec("quiet status", lambda: gw_u.reshard_status("quiet"))
        rec("quiet listing", lambda: _full_listing(gw_u, "quiet"))
        rec("quiet stat", lambda: gw_u.stat_object("quiet", "o007"))
        rec("quiet old oid", lambda: io_u.stat("bucket.index.quiet"))
        rec("quiet 4->2", lambda: _timeless(gw_u.bucket_reshard("quiet", 2)))
        rec("quiet listing 2", lambda: _full_listing(gw_u, "quiet", max_keys=3))

        # -- a resharder crashed at each stage, then resumed
        rec("frail", lambda: gw_u.create_bucket("frail"))
        for i in range(30):
            rec(f"frail put {i}", lambda: gw_u.put_object("frail", f"f{i:02d}", f"d{i}".encode()))
        for stage in ("marked", "migrated", "cutover"):
            def boom(s, stage=stage):
                if s == stage:
                    raise RuntimeError(f"crash at {stage}")

            rec(f"crash {stage}", lambda: gw_u.index.reshard("frail", 4, fault_hook=boom))
            rec(f"crashed status {stage}", lambda: gw_u.reshard_status("frail"))
            CLOCK.now += 10.0  # past CUTOVER_GRACE: a crashed cutover goes stale
            rec(f"crashed listing {stage}", lambda: _full_listing(gw_u, "frail"))
            rec(f"live put {stage}", lambda: gw_u.put_object("frail", f"new-{stage}", b"alive"))
            rec(f"live delete {stage}", lambda: gw_u.delete_object("frail", "f00"))
            rec(f"resume {stage}", lambda: _timeless(gw_u.bucket_reshard("frail", 4)))
            rec(f"resumed status {stage}", lambda: gw_u.reshard_status("frail"))
            rec(f"resumed listing {stage}", lambda: _full_listing(gw_u, "frail"))
            rec(f"rearm {stage}", lambda: _timeless(gw_u.index.reshard("frail", 1)))

        # -- a superseded resharder aborts
        rec("race", lambda: gw_u.create_bucket("race"))
        for i in range(20):
            rec(f"race put {i}", lambda: gw_u.put_object("race", f"r{i:02d}", b"v"))

        def crash_marked(stage):
            if stage == "marked":
                raise RuntimeError("crash at marked")

        def finish_elsewhere(stage):
            if stage == "marked":
                gw_u.index.reshard("race", 4)

        rec("race crash", lambda: gw_u.index.reshard("race", 4, fault_hook=crash_marked))
        rec("race superseded", lambda: gw_u.index.reshard("race", 4,
                                                          fault_hook=finish_elsewhere))
        rec("race status", lambda: gw_u.reshard_status("race"))
        rec("race listing", lambda: _full_listing(gw_u, "race"))

        # -- the fill check's queue, drained by hand and by the worker
        gw_q = RGW(io_u, max_objs_per_shard=8, name="idx.q")
        gws.append(gw_q)
        gw_q.progress_hook = lambda *a: events.append(a)
        gw_q.index.check_interval = 4
        for bucket in ("fat", "fat2"):
            rec(f"{bucket} bucket", lambda: gw_q.create_bucket(bucket))
            for i in range(40):
                rec(f"{bucket} put {i}", lambda: gw_q.put_object(bucket, f"fat{i:03d}", b"x"))
            rec(f"{bucket} queue", gw_q.reshard_list)
            rec(f"{bucket} queued status", lambda: gw_q.reshard_status(bucket))
            if bucket == "fat":
                rec("process", gw_q.reshard_process)
            else:
                gw_q.start_reshard(interval=0.05)
                rec("worker drained", lambda: wait_for(
                    lambda: not gw_q.reshard_list() and not gw_q.reshard_status("fat2")
                    ["queued"], 30.0))
                gw_q.reshard_worker.stop()
                rec("worker passes ran", lambda: gw_q.reshard_worker.passes > 0)
            rec(f"{bucket} status", lambda: gw_q.reshard_status(bucket))
            rec(f"{bucket} listing", lambda: _full_listing(gw_q, bucket))
        rec("admin-only list", lambda: gw_q.reshard_list(user="bob"))
        rec("admin-only process", lambda: gw_q.reshard_process(user="bob"))
        rec("unknown status", lambda: gw_q.reshard_status("nope"))
        rec("bad reshard", lambda: gw_q.bucket_reshard("fat", 0))
        rec("progress events", lambda: list(events))
        for gw in gws:
            rec(f"perf {gw.name}", gw.perf.dump)
        rec("RGWError", lambda: issubclass(ns.rgw.AccessDenied, RGWError))
    finally:
        for gw in gws:
            gw.shutdown()
    return out


@pytest.fixture(scope="module")
def scenario(clusters):
    t, j = clusters
    return _index_scenario(TORCH, t.rados), _index_scenario(JAX, j.rados)


def test_index_scenario_equal(scenario):
    mine, ref = scenario
    assert [label for label, _g in mine] == [label for label, _g in ref]
    for a, b in zip(mine, ref):
        assert a == b, a[0]
    got = dict(mine)
    assert sum(1 for n in got["filled"] if n) > 1
    assert got["legacy oid"][:2] == ("err", "ObjectNotFound")
    assert got["quiet head"] == got["quiet head after"]
    assert got["race superseded"][:2] == ("err", "RGWError")
    assert got["fat2 status"]["num_shards"] >= 2 and not got["fat2 status"]["queued"]
    assert got["worker drained"] is True
    assert any(done for _id, _m, _f, done in got["progress events"])
    assert got["perf idx.q"]["l_rgw_reshard_completed"] >= 2


def test_listing_pages_equal_between_shardings(scenario):
    mine, _ref = scenario
    got = dict(mine)
    for q in QUERIES:
        unsharded, sharded = got[f"page {q} False"], got[f"page {q} True"]
        assert unsharded == sharded and unsharded[0] == 200, q


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_reshard_under_concurrent_puts(clusters, pkg):
    """An online 1 -> 4 reshard under three writer threads; the other
    package's gateway, unsharded on the same cluster, is the oracle of
    the final listing pages."""
    t, j = clusters
    c, ns, other = (t, TORCH, JAX) if pkg == "torch" else (j, JAX, TORCH)
    guest = (JRados if pkg == "torch" else Rados)(f"oracle-{pkg}").connect(*c.mon_addr)
    gw = ns.rgw.RGW(c.rados.open_ioctx("ec"), name="hot")
    oracle = other.rgw.RGW(guest.open_ioctx("rep"), name="oracle")
    try:
        head0 = gw.datalog_head()  # the pool's datalog holds the scenario's entries
        gw.create_bucket("hot")
        prefill = {f"pre{i:03d}": f"seed{i}".encode() for i in range(60)}
        for k, v in prefill.items():
            gw.put_object("hot", k, v)
        stop = threading.Event()
        oracles = [dict() for _ in range(3)]
        acked = [0, 0, 0]
        failures = []

        def writer(w: int):
            mine, i = oracles[w], 0
            try:
                while not stop.is_set():
                    key = f"w{w}-{i % 25:02d}"
                    if i % 5 == 4 and key in mine:
                        gw.delete_object("hot", key)
                        del mine[key]
                    else:
                        val = f"{w}:{i}".encode()
                        gw.put_object("hot", key, val)
                        mine[key] = val
                    acked[w] += 1
                    i += 1
            except Exception as e:  # noqa: BLE001 — surfaced below
                failures.append(f"writer {w}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=writer, args=(w,), daemon=True) for w in range(3)]
        for th in threads:
            th.start()
        assert wait_for(lambda: sum(acked) > 30, 60.0)
        assert gw.bucket_reshard("hot", 4)["to_shards"] == 4
        post = sum(acked)
        assert wait_for(lambda: sum(acked) > post + 15, 60.0)
        stop.set()
        for th in threads:
            th.join(timeout=60)
        assert not failures, failures
        expect = dict(prefill)
        for mine in oracles:
            expect.update(mine)
        listing = _full_listing(gw, "hot")
        got_keys = [e["key"] for e in listing]
        assert got_keys == sorted(expect)
        for k, v in expect.items():
            assert gw.get_object("hot", k) == v, k
        assert gw.datalog_head() == head0 + 1 + len(prefill) + sum(acked)
        assert gw.reshard_status("hot")["num_shards"] == 4
        oracle.create_bucket("hot")
        for k, v in expect.items():
            oracle.put_object("hot", k, v)
        port_o, port_h = oracle.serve(), gw.serve()
        for q in ({}, {"max-keys": "7"}, {"marker": "pre030", "max-keys": "11"}):
            assert (_http(other.rgw, port_o, "GET", "/hot", query=q)[:2]
                    == _http(ns.rgw, port_h, "GET", "/hot", query=q)[:2]), q
    finally:
        oracle.shutdown()
        gw.shutdown()
        guest.shutdown()
