"""The port's object gateway held against the JAX package's on live
clusters, on the CPU.

A JAX and a port cluster side by side (``tests/test_torch_cluster.py``'s
``Cluster``: a monitor, 5 OSDs over MemStore and a client each; a
3-replica pool and an isa k=3 m=2 pool at pg_num 4; the port's OSDs on
``device="cpu"``). The same seeded sequence runs on both clusters, in
both pools, each package driving its own cluster through its own
``RGW``: over HTTP (buckets, objects, HEAD, paged listings, multipart,
SigV4 identities, ACLs through ``?acl``, STS credentials and their
expiry, CORS preflight and echo) and through the library (the ACL
matrix, lifecycle expiration and the COLD transition). Then a
two-zone multisite pair (zone a on the replicated pool, zone b on the
erasure-coded one) syncs through ``SyncAgent.sync_once``.

Equal, exactly: every HTTP status, body and header but ``Date``; every
library result and error; the stored objects at every acting position
of every PG (bucket directory, index omap, data shards and hinfo,
multipart parts and manifests, users, lifecycle records, datalog, sync
markers); ``rgw_admin``'s output; ``sign_request``'s headers for the
same inputs. Across the packages on one cluster: a bucket the JAX
gateway wrote reads equal through the port's, and the reverse.

Time and entropy: one fixed clock (``_Clock``) stands in for ``time``
in both packages' ``rgw`` modules, so ``ctime``, ``mtime``, STS
``expires``, the reshard stamps and the SigV4 dates are equal; the
scenario moves it forward where lifecycle and STS expiry need time to
pass. ``os.urandom`` answers calls from the ``rgw`` modules (access
and secret keys, STS keys, upload ids) from one seeded stream for each
package, and every other caller from the system. Masked, and only
these: the HTTP ``Date`` header, and the ``duration_s`` of a reshard's
report, which is read off the monotonic clock.

The JAX isa codes need ``ErasureCodeIsa.w = 8`` for an EC pool
(ROADMAP §C); it is set for this module only, as in the cluster test.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import sys
import time
import types
import urllib.parse

import pytest

import ceph_tpu.ec.isa as jisa
import ceph_tpu.msg as jmsg
import ceph_tpu.rgw as jrgw
import ceph_tpu.rgw.index as jindex
import ceph_tpu.rgw.lifecycle as jlifecycle
import ceph_tpu.rgw.multisite as jmultisite
import ceph_tpu.tools.rgw_admin as jadmin
from ceph_tpu.rados import Rados as JRados
import ceph_tpu_torch.rgw as trgw
import ceph_tpu_torch.rgw.index as tindex
import ceph_tpu_torch.rgw.lifecycle as tlifecycle
import ceph_tpu_torch.rgw.multisite as tmultisite
import ceph_tpu_torch.tools.rgw_admin as tadmin
from ceph_tpu_torch.common import crash
from ceph_tpu_torch.msg import NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.rados import Rados

from test_torch_cluster import Cluster, _stored, _wait

T0 = 1767225600.0  # 2026-01-01T00:00:00Z
PKGS = {
    "torch": types.SimpleNamespace(rgw=trgw, index=tindex, lifecycle=tlifecycle,
                                   multisite=tmultisite, admin=tadmin),
    "jax": types.SimpleNamespace(rgw=jrgw, index=jindex, lifecycle=jlifecycle,
                                 multisite=jmultisite, admin=jadmin),
}


class _Clock:
    """``time`` with a settable wall clock; everything else is the
    real module (``monotonic``, ``sleep``, ``strftime``...)."""

    def __init__(self):
        self.now = T0

    def time(self) -> float:
        return self.now

    def gmtime(self, secs=None):
        return time.gmtime(self.now if secs is None else secs)

    def __getattr__(self, name):
        return getattr(time, name)


class _Entropy:
    """``os.urandom``: a seeded stream for each package's ``rgw``
    modules, the system's for every other caller."""

    def __init__(self, real):
        self.real = real
        self.streams: dict = {}

    def reset(self) -> None:
        self.streams.clear()

    def __call__(self, n: int) -> bytes:
        mod = sys._getframe(1).f_globals.get("__name__", "")
        pkg, _, rest = mod.partition(".")
        if pkg in ("ceph_tpu", "ceph_tpu_torch") and rest.split(".")[0] == "rgw":
            return self.streams.setdefault(pkg, random.Random(23)).randbytes(n)
        return self.real(n)


CLOCK = _Clock()
ENTROPY = _Entropy(os.urandom)


@pytest.fixture(scope="module")
def clusters():
    mp = pytest.MonkeyPatch()
    mp.setattr(jisa.ErasureCodeIsa, "w", 8, raising=False)
    for ns in PKGS.values():
        for mod in (ns.rgw, ns.index, ns.lifecycle, ns.multisite):
            mp.setattr(mod, "time", CLOCK)
    mp.setattr(os, "urandom", ENTROPY)
    made = []
    try:
        for pkg in ("torch", "jax"):
            c = Cluster(pkg)
            made.append(c)
            c.create_pools()
        for c in made:
            _wait(c.clean, f"{c.pkg} cluster never went active+clean")
        yield made
    finally:
        for c in made:
            c.shutdown()
        mp.undo()
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None, 10.0
        )


@pytest.fixture(autouse=True)
def _drain_port_crash_queue():
    yield
    crash.drain_pending()
    crash.reset_throttle()


def _recorder(out: list):
    """``rec(label, fn)``: run ``fn`` and append (label, its result or
    its error) to ``out``; errors are results here."""
    def rec(label, fn):
        try:
            got = fn()
        except Exception as e:  # noqa: BLE001 — errors are results here
            got = ("err", type(e).__name__, str(e))
        out.append((label, got))
        return got
    return rec


def _amz_date() -> str:
    return time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(CLOCK.now))


def _http(rgw_mod, port, method, path, payload=b"", headers=None, query=None,
          creds=None) -> tuple:
    """One request; ``creds`` (access, secret) signs it with the fixed
    clock's date. The reply as (status, body, headers but Date)."""
    q = dict(query or {})
    url = path + ("?" + urllib.parse.urlencode(q) if q else "")
    hdrs = dict(headers or {})
    if creds is not None:
        hdrs.update(rgw_mod.sign_request(method, path, q, payload, creds[0], creds[1],
                                         amz_date=_amz_date()))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, url, body=payload or None, headers=hdrs)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, body, sorted((k, v) for k, v in resp.getheaders() if k != "Date")
    finally:
        conn.close()


def _timeless(report: dict) -> dict:
    """A reshard report with its ``duration_s`` (read off the monotonic
    clock) checked and taken out."""
    assert report.pop("duration_s") >= 0.0
    return report


def _upload_id(reply: tuple) -> str:
    body = reply[1].decode()
    return body.split("<UploadId>")[1].split("</UploadId>")[0]


def _scenario(ns, rados, pool: str, seed: int) -> list:
    """One seeded run of gateway operations on ``pool``: every result
    and every error."""
    rgw_mod = ns.rgw
    RGW = rgw_mod.RGW
    CLOCK.now = T0
    ENTROPY.reset()
    rng = random.Random(seed)
    out = []
    rec = _recorder(out)

    io = rados.open_ioctx(pool)
    gw = RGW(io)
    agw = RGW(io, auth=True, name="rgw.auth")
    port, aport = gw.serve(), agw.serve()
    try:
        # -- authless gateway over HTTP: buckets, objects, listings
        h = lambda *a, **kw: _http(rgw_mod, port, *a, **kw)  # noqa: E731
        rec("put bucket", lambda: h("PUT", "/photos"))
        rec("list buckets", lambda: h("GET", "/"))
        rec("put bucket again", lambda: h("PUT", "/photos"))
        payloads = {"cat.jpg": b"jpeg-bytes" * 500}
        for i in range(4):
            payloads[f"big{i}"] = rng.randbytes(rng.randint(1, 150000))
        for key, data in payloads.items():
            rec(f"put {key}", lambda: h("PUT", f"/photos/{key}", data))
        for key in payloads:
            rec(f"get {key}", lambda: h("GET", f"/photos/{key}"))
            rec(f"head {key}", lambda: h("HEAD", f"/photos/{key}"))
        for i in range(5):
            rec(f"put img{i}", lambda: h("PUT", f"/photos/img{i:02d}", b"x"))
        rec("list page", lambda: h("GET", "/photos", query={"max-keys": "3"}))
        rec("list marker", lambda: h("GET", "/photos",
                                     query={"marker": "img02", "max-keys": "100"}))
        rec("delete full bucket", lambda: h("DELETE", "/photos"))
        rec("delete cat", lambda: h("DELETE", "/photos/cat.jpg"))
        rec("get deleted", lambda: h("GET", "/photos/cat.jpg"))
        rec("head missing", lambda: h("HEAD", "/photos/nope"))
        rec("get missing bucket", lambda: h("GET", "/nobucket/x"))
        for i in range(5):
            rec(f"delete img{i}", lambda: h("DELETE", f"/photos/img{i:02d}"))
        rec("index omap", lambda: sorted(io.omap_get_vals("bucket.index.photos").items()))

        # -- SigV4 identities, multipart
        creds = rec("create user", lambda: agw.create_user("tester"))
        a = lambda *args, **kw: _http(rgw_mod, aport, *args, **kw)  # noqa: E731
        rec("anonymous put", lambda: a("PUT", "/authed"))
        rec("bad signature", lambda: a("PUT", "/authed", creds=(creds[0], "0" * 40)))
        rec("signed put bucket", lambda: a("PUT", "/authed", creds=creds))
        rec("signed put", lambda: a("PUT", "/authed/hello", b"signed world", creds=creds))
        rec("signed get", lambda: a("GET", "/authed/hello", creds=creds))
        init = rec("initiate", lambda: a("POST", "/authed/big.bin", query={"uploads": ""},
                                         creds=creds))
        uid = _upload_id(init)
        parts = {1: rng.randbytes(70000), 2: rng.randbytes(50000), 3: b"C" * 1234}
        for n, data in parts.items():
            rec(f"part {n}", lambda: a("PUT", "/authed/big.bin", data, creds=creds,
                                       query={"uploadId": uid, "partNumber": str(n)}))
        rec("part out of range", lambda: a("PUT", "/authed/big.bin", b"x", creds=creds,
                                           query={"uploadId": uid, "partNumber": "0"}))
        rec("complete", lambda: a("POST", "/authed/big.bin", query={"uploadId": uid},
                                  creds=creds))
        rec("get multipart", lambda: a("GET", "/authed/big.bin", creds=creds))
        rec("stat multipart", lambda: agw.stat_object("authed", "big.bin"))
        rec("overwrite multipart", lambda: a("PUT", "/authed/big.bin", b"small now",
                                             creds=creds))
        rec("get overwritten", lambda: a("GET", "/authed/big.bin", creds=creds))
        init2 = rec("initiate tmp", lambda: a("POST", "/authed/tmp.bin",
                                              query={"uploads": ""}, creds=creds))
        uid2 = _upload_id(init2)
        rec("part tmp", lambda: a("PUT", "/authed/tmp.bin", b"zzz", creds=creds,
                                  query={"uploadId": uid2, "partNumber": "1"}))
        rec("abort", lambda: a("DELETE", "/authed/tmp.bin", query={"uploadId": uid2},
                               creds=creds))
        rec("stat aborted", lambda: agw.stat_object("authed", "tmp.bin"))
        rec("complete unknown", lambda: a("POST", "/authed/tmp.bin",
                                          query={"uploadId": "feed"}, creds=creds))

        # -- ACLs over HTTP
        rec("put page", lambda: a("PUT", "/authed/page", b"<html>", creds=creds))
        rec("anonymous get page", lambda: a("GET", "/authed/page"))
        rec("acl public-read", lambda: a("PUT", "/authed/page", query={"acl": ""},
                                         headers={"x-amz-acl": "public-read"}, creds=creds))
        rec("anonymous get public", lambda: a("GET", "/authed/page"))
        rec("anonymous deface", lambda: a("PUT", "/authed/page", b"defaced"))
        rec("get acl", lambda: a("GET", "/authed/page", query={"acl": ""}, creds=creds))
        rec("bucket acl", lambda: a("PUT", "/authed", query={"acl": ""},
                                    headers={"x-amz-acl": "public-read"}, creds=creds))
        rec("anonymous list", lambda: a("GET", "/authed"))

        # -- STS credentials
        rec("anonymous assume", lambda: a("POST", "/", query={"Action": "AssumeRole"}))
        for bad in ("abc", "nan", "inf", "0", "999999999"):
            rec(f"duration {bad}", lambda: a("POST", "/", creds=creds, query={
                "Action": "AssumeRole", "DurationSeconds": bad}))
        sts = rec("assume", lambda: a("POST", "/", creds=creds, query={
            "Action": "AssumeRole", "DurationSeconds": "2"}))
        doc = json.loads(sts[1])
        temp = (doc["AccessKeyId"], doc["SecretAccessKey"])
        rec("temp put bucket", lambda: a("PUT", "/stsbucket", creds=temp))
        rec("temp put", lambda: a("PUT", "/stsbucket/obj", b"sts data", creds=temp))
        rec("temp get", lambda: a("GET", "/stsbucket/obj", creds=temp))
        rec("temp re-mint", lambda: a("POST", "/", creds=temp, query={
            "Action": "AssumeRole", "DurationSeconds": "60"}))
        rec("sts owner", lambda: agw._bucket_rec("stsbucket")["owner"])
        CLOCK.now += 2.5
        rec("temp expired", lambda: a("GET", "/stsbucket/obj", creds=temp))
        rec("permanent get", lambda: a("GET", "/stsbucket/obj", creds=creds))

        # -- CORS
        rec("cors bucket", lambda: a("PUT", "/corsb", creds=creds))
        rec("cors object", lambda: a("PUT", "/corsb/pub", b"cors data", creds=creds,
                                     headers={"x-amz-acl": "public-read"}))
        rules = [{"allowed_origins": ["https://app.example"], "allowed_methods": ["GET"],
                  "allowed_headers": ["content-type"], "max_age": 300}]
        rec("put cors", lambda: a("PUT", "/corsb", json.dumps(rules).encode(),
                                  query={"cors": ""}, creds=creds))
        rec("get cors", lambda: a("GET", "/corsb", query={"cors": ""}, creds=creds))
        good = {"Origin": "https://app.example", "Access-Control-Request-Method": "GET"}
        rec("preflight", lambda: a("OPTIONS", "/corsb/pub", headers=good))
        rec("preflight origin", lambda: a("OPTIONS", "/corsb/pub", headers={
            **good, "Origin": "https://evil.example"}))
        rec("preflight method", lambda: a("OPTIONS", "/corsb/pub", headers={
            **good, "Access-Control-Request-Method": "DELETE"}))
        rec("echo", lambda: a("GET", "/corsb/pub", headers={"Origin": "https://app.example"}))
        rec("no echo", lambda: a("GET", "/corsb/pub",
                                 headers={"Origin": "https://evil.example"}))
        rec("delete cors", lambda: a("DELETE", "/corsb", query={"cors": ""}, creds=creds))
        rec("cors gone", lambda: a("GET", "/corsb", query={"cors": ""}, creds=creds))

        # -- the ACL matrix at the storage layer
        rec("matrix bucket", lambda: agw.create_bucket("matrix", user="alice"))
        rec("matrix put", lambda: agw.put_object("matrix", "secret.txt", b"top", user="alice"))
        for who in ("alice", "bob", None):
            rec(f"private get {who}", lambda: agw.get_object("matrix", "secret.txt", user=who))
        rec("bob list", lambda: agw.list_objects("matrix", user="bob"))
        rec("bob put", lambda: agw.put_object("matrix", "x", b"", user="bob"))
        rec("bob delete", lambda: agw.delete_object("matrix", "secret.txt", user="bob"))
        for canned in ("public-read", "authenticated-read"):
            rec(f"object {canned}", lambda: agw.set_object_acl("matrix", "secret.txt", canned,
                                                               user="alice"))
            for who in ("bob", None):
                rec(f"{canned} get {who}",
                    lambda: agw.get_object("matrix", "secret.txt", user=who))
        rec("bucket public-read", lambda: agw.set_bucket_acl("matrix", "public-read",
                                                             user="alice"))
        rec("anonymous listing", lambda: agw.list_objects("matrix", user=None))
        rec("bucket public-read-write", lambda: agw.set_bucket_acl(
            "matrix", "public-read-write", user="alice"))
        rec("bob puts", lambda: agw.put_object("matrix", "bob.txt", b"bobdata", user="bob"))
        for who in ("bob", "alice", "carol"):
            rec(f"bob's object {who}", lambda: agw.get_object("matrix", "bob.txt", user=who))
        rec("bob bucket acl", lambda: agw.set_bucket_acl("matrix", "private", user="bob"))
        rec("bucket acl", lambda: agw.get_bucket_acl("matrix"))
        rec("object acl", lambda: agw.get_object_acl("matrix", "bob.txt"))
        rec("bob deletes bucket", lambda: agw.delete_bucket("matrix", user="bob"))

        # -- lifecycle: expiration and the COLD transition
        rec("lc bucket", lambda: agw.create_bucket("lcbuck", user="alice"))
        rec("lc put rules", lambda: agw.put_bucket_lifecycle("lcbuck", [
            {"id": "exp-old", "prefix": "logs/", "status": "Enabled", "expiration_days": 1},
            {"id": "cool", "prefix": "cold/", "status": "Enabled", "transition_days": 0.5,
             "storage_class": "COLD"}], user="alice"))
        rec("lc get rules", lambda: agw.get_bucket_lifecycle("lcbuck", user="alice"))
        rec("lc bob", lambda: agw.put_bucket_lifecycle("lcbuck", [], user="bob"))
        rec("lc old", lambda: agw.put_object("lcbuck", "logs/old.log", b"x" * 100,
                                             user="alice"))
        rec("lc keep", lambda: agw.put_object("lcbuck", "keep/forever", b"y", user="alice"))
        cold = b"transition me " * 500
        rec("lc warm", lambda: agw.put_object("lcbuck", "cold/warm.bin", cold, user="alice"))
        CLOCK.now += 1.5
        rec("lc new", lambda: agw.put_object("lcbuck", "logs/new", b"z", user="alice"))
        rec("lc pass", lambda: agw.lc_process(debug=True))
        rec("lc listing", lambda: agw.list_objects("lcbuck", user="alice"))
        rec("lc cold entry", lambda: agw.stat_object("lcbuck", "cold/warm.bin"))
        rec("lc cold raw", lambda: len(io.read(agw.stat_object("lcbuck",
                                                               "cold/warm.bin")["data_oid"])))
        rec("lc cold read", lambda: agw.get_object("lcbuck", "cold/warm.bin", user="alice"))
        rec("lc second pass", lambda: agw.lc_process(debug=True))
        rec("lc delete rules", lambda: agw.delete_bucket_lifecycle("lcbuck", user="alice"))
        rec("lc rules gone", lambda: agw.get_bucket_lifecycle("lcbuck", user="alice"))
        rec("apply rules", lambda: ns.lifecycle.apply_rules(agw, "lcbuck", [
            {"prefix": "keep/", "expiration_days": 0}], True))

        # -- the sharded index through the gateway
        rec("sharded bucket", lambda: gw.create_bucket("sharded", shards=4))
        for i in range(24):
            rec(f"sharded put {i}", lambda: gw.put_object("sharded", f"k{i:03d}",
                                                          rng.randbytes(rng.randint(1, 3000))))
        rec("sharded list", lambda: gw.list_objects("sharded", max_keys=10))
        rec("sharded list marker", lambda: gw.list_objects("sharded", marker="k009",
                                                           max_keys=100))
        rec("reshard", lambda: _timeless(gw.bucket_reshard("sharded", 7)))
        rec("reshard status", lambda: gw.reshard_status("sharded"))
        rec("resharded list", lambda: gw.list_objects("sharded", max_keys=1000))
        rec("buckets", lambda: sorted(gw._buckets()))
        rec("datalog", lambda: list(gw.datalog_entries(0)))
        rec("datalog head", agw.datalog_head)
    finally:
        gw.shutdown()
        agw.shutdown()
    return out


def _multisite(ns, rados) -> list:
    """Zone a on the replicated pool, zone b on the erasure-coded one:
    bootstrap, incremental, a resumed agent, and active-active."""
    RGW, SYSTEM = ns.rgw.RGW, ns.rgw.SYSTEM
    SyncAgent = ns.multisite.SyncAgent
    CLOCK.now = T0 + 1000.0
    out = []
    rec = _recorder(out)

    a, b = RGW(rados.open_ioctx("rep"), name="zone.a"), RGW(rados.open_ioctx("ec"),
                                                             name="zone.b")
    agents = []
    try:
        rec("a bucket", lambda: a.create_bucket("zphotos", user="alice", canned="public-read"))
        rec("a p1", lambda: a.put_object("zphotos", "p1.jpg", b"jpeg-one", user="alice"))
        rec("a p2", lambda: a.put_object("zphotos", "p2.jpg", b"jpeg-two", user="alice"))
        rec("a lc", lambda: a.put_bucket_lifecycle("zphotos", [
            {"id": "e", "prefix": "tmp/", "status": "Enabled", "expiration_days": 30}],
            user="alice"))
        agent = SyncAgent(a, b, zone="zb", interval=3600.0)
        agents.append(agent)
        rec("bootstrap", agent.sync_once)
        rec("full syncs", lambda: agent.full_syncs)
        rec("b p1", lambda: b.get_object("zphotos", "p1.jpg", user=SYSTEM))
        rec("b owner", lambda: b._bucket_rec("zphotos")["owner"])
        rec("b anonymous list", lambda: b.list_objects("zphotos", user=None))
        rec("b lc", lambda: b.get_bucket_lifecycle("zphotos", user=SYSTEM))
        rec("a p3", lambda: a.put_object("zphotos", "p3.jpg", b"jpeg-three", user="alice"))
        rec("a delete p1", lambda: a.delete_object("zphotos", "p1.jpg", user="alice"))
        rec("a acl p2", lambda: a.set_object_acl("zphotos", "p2.jpg", "public-read",
                                                 user="alice"))
        rec("incremental", agent.sync_once)
        rec("b listing", lambda: b.list_objects("zphotos", user=SYSTEM))
        rec("b anonymous p2", lambda: b.get_object("zphotos", "p2.jpg", user=None))
        agent.stop()
        rec("a p4", lambda: a.put_object("zphotos", "p4.jpg", b"jpeg-four", user="alice"))
        agent2 = SyncAgent(a, b, zone="zb", interval=3600.0)
        agents.append(agent2)
        rec("resume", agent2.sync_once)
        rec("resume full syncs", lambda: agent2.full_syncs)
        rec("b p4", lambda: b.get_object("zphotos", "p4.jpg", user=SYSTEM))
        rec("a east", lambda: a.create_bucket("east", user="east-user"))
        rec("b west", lambda: b.create_bucket("west", user="west-user"))
        rec("a e1", lambda: a.put_object("east", "e1", b"from-east", user="east-user"))
        rec("b w1", lambda: b.put_object("west", "w1", b"from-west", user="west-user"))
        ab = SyncAgent(a, b, zone="zb2", interval=3600.0)
        ba = SyncAgent(b, a, zone="za2", interval=3600.0)
        agents += [ab, ba]
        for rnd in range(3):
            rec(f"a->b {rnd}", ab.sync_once)
            rec(f"b->a {rnd}", ba.sync_once)
        rec("b e1", lambda: b.get_object("east", "e1", user=SYSTEM))
        rec("a w1", lambda: a.get_object("west", "w1", user=SYSTEM))
        rec("heads", lambda: (a.datalog_head(), b.datalog_head()))
    finally:
        for ag in agents:
            ag.stop()
        a.shutdown()
        b.shutdown()
    return out


@pytest.fixture(scope="module")
def scenario(clusters):
    t, j = clusters
    got = {}
    for seed, pool in enumerate(("rep", "ec")):
        got[pool] = (_scenario(PKGS["torch"], t.rados, pool, 31 + seed),
                     _scenario(PKGS["jax"], j.rados, pool, 31 + seed))
    got["multisite"] = (_multisite(PKGS["torch"], t.rados), _multisite(PKGS["jax"], j.rados))
    return got


@pytest.mark.parametrize("pool", ["rep", "ec"])
def test_gateway_exchanges_equal(scenario, pool):
    mine, ref = scenario[pool]
    assert [label for label, _g in mine] == [label for label, _g in ref]
    for a, b in zip(mine, ref):
        assert a == b, a[0]
    got = dict(mine)
    assert got["put bucket again"][0] == 409 and got["delete full bucket"][0] == 409
    assert got["anonymous put"][0] == 403 and got["bad signature"][0] == 403
    assert got["get multipart"][0] == 200 and len(got["get multipart"][1]) == 121234
    assert got["stat multipart"]["etag"].endswith("-3")
    assert got["temp get"][1] == b"sts data" and got["temp expired"][0] == 403
    assert ("Access-Control-Allow-Origin", "https://app.example") in got["echo"][2]
    assert got["lc pass"] == {"expired": 1, "transitioned": 1}
    assert got["lc cold entry"]["storage_class"] == "COLD"
    assert got["lc cold raw"] < 7000
    assert got["private get bob"][:2] == ("err", "AccessDenied")


def test_multisite_equal(scenario):
    mine, ref = scenario["multisite"]
    assert mine == ref
    got = dict(mine)
    assert got["full syncs"] == 1 and got["resume full syncs"] == 0
    assert got["b e1"] == b"from-east" and got["a w1"] == b"from-west"


def test_stored_gateway_objects_equal(clusters, scenario):
    t, j = clusters
    _wait(lambda: t.clean() and j.clean(), "clusters not clean")
    mine, ref = _stored(t), _stored(j)
    assert sorted(mine) == sorted(ref)
    for key in ref:
        assert mine[key] == ref[key], key
    names = {k[3] for k in mine}
    for want in ("o_rgw.buckets", "o_rgw.users", "o_rgw.lc", "o_rgw.datalog",
                 "o_bucket.index.photos", "o_rgw.sync.markers"):
        assert want in names, want
    # an EC PG holds the gateway's data as shards with their hinfo
    ec = [v for k, v in mine.items() if k[0].startswith(f"{t.pools['ec']}.")
          and k[3].startswith("o_rgw.obj.")]
    assert ec and all(any("hinfo" in a for a in attrs) for _d, attrs, _o in ec)


@pytest.mark.parametrize("pool", ["rep", "ec"])
def test_rgw_admin_outputs_equal(clusters, scenario, pool, capsys):
    t, j = clusters
    for args in (["bucket", "stats", "--bucket", "sharded"],
                 ["bucket", "stats", "--bucket", "authed"],
                 ["reshard", "status", "--bucket", "sharded"], ["reshard", "list"],
                 ["reshard", "process"], ["reshard", "status", "--bucket", "nope"]):
        got = []
        for ns, c in ((PKGS["torch"], t), (PKGS["jax"], j)):
            host, port = c.mon_addr
            rc = ns.admin.main(["-m", f"{host}:{port}", "-p", pool] + args)
            cap = capsys.readouterr()
            got.append((rc, cap.out, cap.err))
        assert got[0] == got[1], args
    host, port = t.mon_addr
    assert tadmin.main(["-m", f"{host}:{port}", "-p", pool, "bucket", "stats",
                        "--bucket", "sharded"]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["num_shards"] == 7 and st["entries"] == 24


@pytest.mark.parametrize("seed", range(6))
def test_sign_request_equal(seed):
    rng = random.Random(seed)
    method = rng.choice(["GET", "PUT", "POST", "DELETE", "HEAD"])
    path = "/" + "/".join(rng.choice(["b", "a b", "k%", "ü", "x.y"]) for _ in range(2))
    query = {rng.choice(["uploadId", "acl", "partNumber", "x y"]): str(rng.randrange(99))
             for _ in range(rng.randrange(3))}
    payload = rng.randbytes(rng.randrange(0, 300))
    access, secret = "AK" + str(seed), "s" * (seed + 10)
    date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(T0 + seed * 86399))
    for region in ("default", "us-east-1"):
        mine = trgw.sign_request(method, path, query, payload, access, secret,
                                 region=region, amz_date=date)
        assert mine == jrgw.sign_request(method, path, query, payload, access, secret,
                                         region=region, amz_date=date)


def _write_bucket(ns, io, bucket: str, rng) -> dict:
    gw = ns.rgw.RGW(io, bucket_index_shards=3)
    model = {}
    try:
        gw.create_bucket(bucket, user="alice")
        for i in range(10):
            data = rng.randbytes(rng.randint(0, 40000))
            gw.put_object(bucket, f"obj/{i:02d}", data, user="alice")
            model[f"obj/{i:02d}"] = data
        uid = gw.initiate_multipart(bucket, "mp", user="alice")
        parts = [rng.randbytes(30000), rng.randbytes(777)]
        for n, data in enumerate(parts, 1):
            gw.upload_part(bucket, "mp", uid, n, data, user="alice")
        gw.complete_multipart(bucket, "mp", uid, user="alice")
        model["mp"] = b"".join(parts)
        gw.set_object_acl(bucket, "obj/03", "public-read", user="alice")
        gw.put_bucket_lifecycle(bucket, [{"id": "x", "prefix": "tmp/", "status": "Enabled",
                                          "expiration_days": 9}], user="alice")
    finally:
        gw.shutdown()
    return model


def _read_bucket(ns, io, bucket: str) -> dict:
    gw = ns.rgw.RGW(io)
    try:
        entries, truncated = gw.list_objects(bucket, max_keys=1000, user="alice")
        return {
            "keys": [e["key"] for e in entries], "truncated": truncated,
            "data": {e["key"]: gw.get_object(bucket, e["key"], user="alice") for e in entries},
            "stat": {e["key"]: gw.stat_object(bucket, e["key"]) for e in entries},
            "anonymous": gw.get_object(bucket, "obj/03", user=None),
            "lc": gw.get_bucket_lifecycle(bucket, user="alice"),
            "status": gw.reshard_status(bucket),
        }
    finally:
        gw.shutdown()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bucket_reads_across_packages(clusters, writer):
    """One package's gateway writes a sharded bucket with a multipart
    object, an ACL and a lifecycle rule into the other package's
    cluster, in both pools; the other package's gateway reads it
    equal, and so does the writer's."""
    t, j = clusters
    host_cluster = t if writer == "jax" else j
    guest_cls = JRados if writer == "jax" else Rados
    guest = guest_cls(f"{writer}-guest").connect(*host_cluster.mon_addr)
    reader = PKGS["torch" if writer == "jax" else "jax"]
    try:
        for pool in ("rep", "ec"):
            bucket = f"carried-{writer}"
            model = _write_bucket(PKGS[writer], guest.open_ioctx(pool), bucket,
                                  random.Random(len(pool)))
            got = _read_bucket(reader, host_cluster.rados.open_ioctx(pool), bucket)
            assert got == _read_bucket(PKGS[writer], guest.open_ioctx(pool), bucket)
            assert got["keys"] == sorted(model)
            assert got["data"] == model
            assert got["stat"]["mp"]["etag"].endswith("-2")
    finally:
        guest.shutdown()
