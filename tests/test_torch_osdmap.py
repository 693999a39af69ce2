"""ceph_tpu_torch's OSD-map placement against the JAX package, on the CPU.

The same cluster is built twice, once from each package's classes, and
mapped by each package's ``OSDMapMapping``: the port's arrays (up,
up_primary, acting, acting_primary) must equal the JAX package's under
every override (pg_upmap, pg_upmap_items, pg_temp, primary_temp,
primary affinity 0 and fractional, down, out, nonexistent OSDs), for
replicated and EC pools, on straw2 hosts and on legacy straw and list
hosts.  The balancer's upmaps, the maps' wire bytes and osdmaptool's
report are held to the JAX package's too.
"""

from __future__ import annotations

import random
import types

import numpy as np
import pytest

import ceph_tpu.crush.builder as j_builder
import ceph_tpu.crush.encode as j_encode
import ceph_tpu.osd as j_osd
import ceph_tpu.osd.balancer as j_balancer
import ceph_tpu_torch.crush.builder as t_builder
import ceph_tpu_torch.crush.encode as t_encode
import ceph_tpu_torch.osd as t_osd
import ceph_tpu_torch.osd.balancer as t_balancer
from ceph_tpu.crush.types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    PG_POOL_TYPE_ERASURE,
    PG_POOL_TYPE_REPLICATED,
    Tunables,
)
from ceph_tpu_torch.crush import torchmap
from ceph_tpu_torch.osd import mapping as t_mapping

JEWEL = Tunables(0, 0, 50, 1, 1, 1, 0)
ARGONAUT = Tunables(2, 5, 19, 0, 0, 0, 0)
JAX = types.SimpleNamespace(CrushMap=j_builder.CrushMap, osd=j_osd)
PORT = types.SimpleNamespace(CrushMap=t_builder.CrushMap, osd=t_osd)
ARRAYS = ("up", "up_primary", "acting", "acting_primary")


def build_cluster(pkg, alg=CRUSH_BUCKET_STRAW2, tunables=JEWEL):
    """tests/test_osdmap.py's cluster from ``pkg``'s classes: 6 hosts of
    4 OSDs (``alg`` buckets) under a straw2 root, a replicated pool of
    48 PGs and an EC pool of 27, with every kind of override."""
    m = pkg.CrushMap(tunables=tunables)
    hosts = []
    for h in range(6):
        items = list(range(h * 4, h * 4 + 4))
        weights = [0x10000 + (i % 3) * 0x8000 for i in items]
        hosts.append(m.add_bucket(alg, 1, items, weights, name=f"h{h}"))
    m.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts, [m.buckets[b].weight for b in hosts],
        name="default",
    )
    rep = m.add_simple_rule("rep", "default", "host", mode="firstn")
    ec = m.add_simple_rule("ecr", "default", "host", mode="indep")
    om = pkg.osd.OSDMap.build(m, 24)
    om.add_pool(pkg.osd.PgPool(pool_id=1, type=PG_POOL_TYPE_REPLICATED, size=3,
                               pg_num=48, crush_rule=rep))
    om.add_pool(pkg.osd.PgPool(pool_id=2, type=PG_POOL_TYPE_ERASURE, size=5,
                               pg_num=27, crush_rule=ec))
    om.mark_down(5)
    om.mark_down(13)
    om.osd_exists[17] = False
    om.mark_out(9)
    om.osd_weight[2] = 0x8000
    om.pg_upmap[(1, 3)] = [0, 4, 8]
    om.pg_upmap[(2, 4)] = [0, 4, 8, 12, 16]
    om.pg_upmap_items[(1, 7)] = [(0, 20), (4, 21)]
    om.pg_upmap_items[(2, 11)] = [(8, 22)]
    om.pg_temp[(1, 5)] = [10, 11, 12]
    om.pg_temp[(2, 6)] = [1, 2, 3, 4, 6]
    om.pg_temp[(1, 40)] = [5, 13]  # every temp OSD down
    om.primary_temp[(1, 9)] = 15
    om.primary_temp[(2, 20)] = 3
    om.osd_primary_affinity = [0x10000] * 24
    om.osd_primary_affinity[0] = 0
    om.osd_primary_affinity[4] = 0x4000
    om.osd_primary_affinity[8] = 0x8000
    return om


def seeded_incremental(pkg, om, seed):
    """An incremental for ``om``: OSDs down and out, a reweight, primary
    affinities, upmaps, pg_temp and primary_temp over both pools."""
    rng = random.Random(seed)
    inc = om.new_incremental()
    osds = rng.sample(range(om.max_osd), 8)
    inc.mark_down(osds[0])
    inc.mark_out(osds[1])
    inc.new_weight[osds[2]] = 0x8000
    inc.new_primary_affinity[osds[3]] = 0
    inc.new_primary_affinity[osds[4]] = 0x8000
    for pid, pool in om.pools.items():
        ps = rng.sample(range(pool.pg_num), 4)
        inc.new_pg_upmap_items[(pid, ps[0])] = [(osds[5], osds[6])]
        inc.new_pg_temp[(pid, ps[1])] = rng.sample(range(om.max_osd), pool.size)
        inc.new_primary_temp[(pid, ps[2])] = osds[7]
        inc.new_pg_upmap[(pid, ps[3])] = rng.sample(range(om.max_osd), pool.size)
    return inc


def _map(pkg, om, **kw):
    mapping = (
        pkg.osd.OSDMapMapping(device="cpu") if pkg is PORT else pkg.osd.OSDMapMapping()
    )
    mapping.update(om, **kw)
    return mapping


def _assert_arrays_equal(ours, theirs, om):
    for pid in om.pools:
        for name in ARRAYS:
            got, want = getattr(ours, name)[pid], getattr(theirs, name)[pid]
            assert got.dtype == np.int64 and isinstance(got, np.ndarray), name
            np.testing.assert_array_equal(got, np.asarray(want, dtype=np.int64),
                                          err_msg=f"pool {pid} {name}")


def _assert_get_equals_scalar(mapping, om):
    def norm(v):
        v = list(v)
        while v and v[-1] == CRUSH_ITEM_NONE:
            v.pop()
        return v

    for pid, pool in om.pools.items():
        for ps in range(pool.pg_num):
            up, upp, acting, actp = om.pg_to_up_acting_osds(pid, ps)
            gup, gupp, gact, gactp = mapping.get(pid, ps)
            assert (norm(gup), gupp, norm(gact), gactp) == (norm(up), upp, norm(acting), actp), (
                pid, ps,
            )


@pytest.mark.parametrize("alg", [CRUSH_BUCKET_STRAW2, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_LIST],
                         ids=["straw2", "straw", "list"])
def test_mapping_arrays_equal_the_jax_package(alg):
    jom, om = build_cluster(JAX, alg), build_cluster(PORT, alg)
    ours = _map(PORT, om)
    _assert_arrays_equal(ours, _map(JAX, jom), om)
    _assert_get_equals_scalar(ours, om)
    assert ours.perf.dump()["pgs_mapped"] == 48 + 27


def test_oracle_route_equals_the_device_route():
    om = build_cluster(PORT)
    _assert_arrays_equal(_map(PORT, om, use_device=False), _map(PORT, om), om)


def test_epoch_after_a_wire_incremental_equals_the_jax_package():
    jom, om = build_cluster(JAX), build_cluster(PORT)
    for seed in (1, 2):
        jinc = seeded_incremental(JAX, jom, seed)
        inc = t_osd.Incremental.decode(jinc.encode())
        assert inc.encode() == jinc.encode()
        jom.apply_incremental(jinc)
        om.apply_incremental(inc)
        ours = _map(PORT, om)
        _assert_arrays_equal(ours, _map(JAX, jom), om)
        _assert_get_equals_scalar(ours, om)


def test_unsupported_map_maps_through_the_oracle():
    """Argonaut tunables are outside the batched mapper, as in jaxmap: the
    mapping takes the oracle and still equals the JAX package."""
    jom, om = build_cluster(JAX, tunables=ARGONAUT), build_cluster(PORT, tunables=ARGONAUT)
    with pytest.raises(torchmap.UnsupportedMap):
        torchmap.compile_map(om.crush, device="cpu")
    _assert_arrays_equal(_map(PORT, om), _map(JAX, jom), om)


def test_compiled_cache_invalidated_on_mutation():
    m = t_builder.CrushMap(tunables=JEWEL)
    h0 = m.add_bucket(CRUSH_BUCKET_STRAW2, 1, [0, 1], [0x10000] * 2, name="h0")
    root = m.add_bucket(CRUSH_BUCKET_STRAW2, 3, [h0], [m.buckets[h0].weight], name="root")
    rep = m.add_simple_rule("rep", "root", "osd", mode="firstn")
    om = t_osd.OSDMap.build(m, 2)
    om.add_pool(t_osd.PgPool(pool_id=1, type=PG_POOL_TYPE_REPLICATED, size=2,
                             pg_num=16, crush_rule=rep))
    mapping = _map(PORT, om)
    cm = t_mapping._compiled(m, mapping.device)
    assert t_mapping._compiled(m, mapping.device) is cm
    h1 = m.add_bucket(CRUSH_BUCKET_STRAW2, 1, [2, 3], [0x10000] * 2, name="h1")
    m.buckets[root].items.append(h1)
    m.buckets[root].item_weights.append(m.buckets[h1].weight)
    m.buckets[root].weight += m.buckets[h1].weight
    m.touch()
    om.max_osd = 4
    om.osd_exists += [True, True]
    om.osd_up += [True, True]
    om.osd_weight += [0x10000, 0x10000]
    assert t_mapping._compiled(m, mapping.device) is not cm
    mapping.update(om)
    placed = {int(o) for o in mapping.up[1].ravel() if o != CRUSH_ITEM_NONE}
    assert placed & {2, 3}
    _assert_get_equals_scalar(mapping, om)


def skewed_cluster(pkg, nhosts=6, per_host=4, pg_num=256):
    """tests/test_balancer.py's cluster from ``pkg``'s classes."""
    m = pkg.CrushMap(tunables=JEWEL)
    hosts = []
    for h in range(nhosts):
        items = [h * per_host + i for i in range(per_host)]
        weights = [0x10000 + (h % 3) * 0x4000] * per_host
        hosts.append(m.add_bucket(CRUSH_BUCKET_STRAW2, 1, items, weights, name=f"host{h}"))
    m.add_bucket(CRUSH_BUCKET_STRAW2, 3, hosts, [m.buckets[b].weight for b in hosts],
                 name="default")
    rep = m.add_simple_rule("rep", "default", "host", mode="firstn")
    om = pkg.osd.OSDMap.build(m, nhosts * per_host)
    om.add_pool(pkg.osd.PgPool(pool_id=1, size=3, pg_num=pg_num, crush_rule=rep))
    return om


@pytest.mark.parametrize("max_deviation,max_changes,pg_num", [(1, 3, 256), (1, 50, 256),
                                                              (2, 30, 512)])
def test_balancer_equals_the_jax_package(max_deviation, max_changes, pg_num):
    jom, om = skewed_cluster(JAX, pg_num=pg_num), skewed_cluster(PORT, pg_num=pg_num)
    want = j_balancer.calc_pg_upmaps(jom, max_deviation, max_changes)
    got = t_balancer.calc_pg_upmaps(om, max_deviation, max_changes, device="cpu")
    assert got == want > 0
    assert om.pg_upmap_items == jom.pg_upmap_items
    for (pid, ps), items in om.pg_upmap_items.items():
        up = om.pg_to_up_acting_osds(pid, ps)[0]
        assert all(src not in up and dst in up for src, dst in items)
    _assert_arrays_equal(_map(PORT, om), _map(JAX, jom), om)


def _decorate(om):
    om.blocklist["10.0.0.9:0"] = 12345.0
    om.erasure_code_profiles["p"] = {"k": "2", "m": "1"}
    om.pool_names = {1: "rbd", 2: "ecpool"}
    return om


def test_osdmap_encoding_is_byte_equal_both_ways():
    jom, om = _decorate(build_cluster(JAX)), _decorate(build_cluster(PORT))
    blob = om.encode()
    assert blob == jom.encode()
    assert t_encode.encode_crush_map(om.crush) == j_encode.encode_crush_map(jom.crush)
    assert j_osd.OSDMap.decode(blob).encode() == blob
    back = t_osd.OSDMap.decode(jom.encode())
    assert back.encode() == blob
    _assert_arrays_equal(_map(PORT, back), _map(PORT, om), om)


def test_incremental_encoding_is_byte_equal_both_ways():
    jom, om = build_cluster(JAX), build_cluster(PORT)
    jinc, inc = seeded_incremental(JAX, jom, 7), seeded_incremental(PORT, om, 7)
    inc.crush = om.crush
    jinc.crush = jom.crush
    blob = inc.encode()
    assert blob == jinc.encode()
    assert j_osd.Incremental.decode(blob).encode() == blob
    assert t_osd.Incremental.decode(blob).encode() == blob


def test_encode_crc_detects_corruption():
    blob = bytearray(build_cluster(PORT).encode())
    blob[10] ^= 0xFF
    with pytest.raises(Exception, match="crc"):
        t_osd.OSDMap.decode(bytes(blob))
    inc = bytearray(seeded_incremental(PORT, build_cluster(PORT), 3).encode())
    inc[12] ^= 0x01
    with pytest.raises(Exception, match="crc"):
        t_osd.Incremental.decode(bytes(inc))


@pytest.mark.parametrize("extra", [[], ["--pool-type", "erasure", "--size", "4"]],
                         ids=["replicated", "erasure"])
def test_osdmaptool_prints_the_jax_tools_lines(capsys, extra):
    from ceph_tpu.tools import osdmaptool as j_tool
    from ceph_tpu_torch.tools import osdmaptool

    argv = ["--test-map-pgs", "--build", "48:4:4", "--pg-num", "300"] + extra
    assert j_tool.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert osdmaptool.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()

    def timeless(line):
        head, _, tail = line.partition(" in ")
        return head, tail.rsplit("[", 1)[1]

    assert timeless(got[0]) == (timeless(want[0])[0], "torch]")
    assert got[1:] == want[1:]
    assert osdmaptool.main(argv + ["--backend", "oracle"]) == 0
    assert capsys.readouterr().out.splitlines()[1:] == want[1:]
