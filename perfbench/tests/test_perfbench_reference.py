"""The frozen references against the program's own oracles."""

import numpy as np
import pytest

from perfbench import maps
from perfbench.reference import crush
from perfbench.reference import osdmap as refmap


def test_the_cells_layout_has_crushtools_fan_out():
    h = maps.hierarchy(10000, [4, 20, 2])
    kinds = maps.type_names(h)
    count = {}
    for t, items, _w in h.buckets.values():
        count[kinds[t]] = count.get(kinds[t], 0) + 1
    assert count == {"host": 2500, "rack": 125, "row": 63, "root": 1}
    assert all(len(osds) == 4 for osds in maps.hosts(h))
    (root,) = [b for b, (t, _i, _w) in h.buckets.items() if kinds[t] == "root"]
    assert h.weight(root) == 10000 * 0x10000


def test_hashes_match_the_program():
    from ceph_tpu_torch.crush import hashing

    rng = np.random.default_rng(7)
    for a, b, c in rng.integers(0, 1 << 32, (200, 3)).tolist():
        assert crush.hash32_2(a, b) == hashing.crush_hash32_2(a, b)
        assert crush.hash32_3(a, b, c) == hashing.crush_hash32_3(a, b, c)
    for name in ("", "a", "bench_00017", "x" * 25):
        assert crush.str_hash_rjenkins(name) == hashing.ceph_str_hash_rjenkins(name)


def test_crush_ln_matches_the_program():
    from ceph_tpu_torch.crush.ln import crush_ln

    for x in range(0, 0x10000, 97):
        assert crush.crush_ln(x) == crush_ln(x)


@pytest.mark.parametrize("fanout", [[8, 5], [4, 5, 2]])
@pytest.mark.parametrize("mode,size", [("firstn", 3), ("indep", 11)])
def test_do_rule_matches_the_program_oracle(mode, size, fanout):
    from perfbench.drivers import _program

    h = maps.hierarchy(240, fanout)
    cmap = _program.crush_map(h)
    rule = 0 if mode == "firstn" else 1
    weight = [0x10000] * 240
    for o in range(0, 240, 17):
        weight[o] = 0 if o % 2 else 0x8000
    for x in range(0, 1 << 31, (1 << 31) // 150):
        assert crush.do_rule(h, rule, x, size, weight) == cmap.do_rule(rule, x, size, weight)


def test_pg_pipeline_matches_the_program_oracle():
    from perfbench.drivers import _program
    from ceph_tpu_torch.crush.types import PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED
    from ceph_tpu_torch.osd import OSDMap, PgPool

    n = 120
    h = maps.hierarchy(n, [6, 4])
    om = OSDMap.build(_program.crush_map(h), n)
    st = refmap.MapState.fresh(h, n)
    pools = [refmap.Pool(1, True, 3, 256, 0), refmap.Pool(2, False, 7, 64, 1)]
    for p in pools:
        om.add_pool(PgPool(pool_id=p.pool_id, size=p.size, pg_num=p.pg_num, crush_rule=p.rule,
                           type=PG_POOL_TYPE_REPLICATED if p.replicated else PG_POOL_TYPE_ERASURE))
    rng = np.random.default_rng(11)
    for o in rng.choice(n, 6, replace=False).tolist():
        om.mark_down(o)
        st.up[o] = False
    for o in rng.choice(n, 6, replace=False).tolist():
        om.mark_out(o)
        st.weight[o] = 0
    for o in rng.choice(n, 10, replace=False).tolist():
        om.set_primary_affinity(o, 0x4000)
        st.affinity[o] = 0x4000
    for p in pools:
        for ps in rng.choice(p.pg_num, 12, replace=False).tolist():
            up = refmap.pg_to_up_acting(st, p, ps)[0]
            pick = [o for o in up if o != crush.ITEM_NONE]
            items = [(pick[0], int(rng.integers(n)))]
            om.pg_upmap_items[(p.pool_id, ps)] = st.pg_upmap_items[(p.pool_id, ps)] = items
        for ps in rng.choice(p.pg_num, 6, replace=False).tolist():
            temp = rng.choice(n, p.size, replace=False).tolist()
            om.pg_temp[(p.pool_id, ps)] = st.pg_temp[(p.pool_id, ps)] = temp
            om.primary_temp[(p.pool_id, ps)] = st.primary_temp[(p.pool_id, ps)] = temp[-1]
        for ps in rng.choice(p.pg_num, 4, replace=False).tolist():
            um = rng.choice(n, p.size, replace=False).tolist()
            om.pg_upmap[(p.pool_id, ps)] = st.pg_upmap[(p.pool_id, ps)] = um
    for p in pools:
        for ps in range(p.pg_num):
            assert refmap.pg_to_up_acting(st, p, ps) == om.pg_to_up_acting_osds(p.pool_id, ps)
