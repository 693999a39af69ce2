"""ceph_tpu_torch's CRUSH port against the JAX package, on the CPU.

The port's host modules are copies, its batched mapper
(``crush/torchmap.py``) a rewrite of ``ceph_tpu/crush/jaxmap.py`` in
torch.  Maps are built with the JAX package's builder and copied across
(``CrushMap.copy_from``); every comparison is exact: the finished
placements against the JAX package's oracle, the raw ``(res, counts,
ok)`` against jaxmap's kernel lane for lane (so the oracle fallback
cannot hide a divergence), the device tables against jaxmap's
``CompiledMap``, and the reference C's golden vectors.
"""

from __future__ import annotations

import gzip
import pathlib

import numpy as np
import pytest
import torch

from ceph_tpu.crush import hashing as j_hashing
from ceph_tpu.crush import jaxmap
from ceph_tpu.crush import ln as j_ln
from ceph_tpu.crush.builder import CrushMap as JCrushMap
from ceph_tpu.crush.types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_TAKE,
    ChooseArg,
    Rule,
    RuleStep,
    Tunables,
)
from ceph_tpu.tools.crushtool import build_hierarchy as j_build_hierarchy
from ceph_tpu_torch.crush import torchmap
from ceph_tpu_torch.crush.builder import CrushMap

GOLDEN = pathlib.Path(__file__).parent / "data" / "crush_do_rule_golden.txt.gz"
JEWEL = Tunables(0, 0, 50, 1, 1, 1, 0)
FIREFLY = Tunables(0, 0, 50, 1, 1, 0, 0)
ARGONAUT = Tunables(2, 5, 19, 0, 0, 0, 0)


# -- maps, built with the JAX package's builder ---------------------------


def _add_two_rules(m, root, domain_type):
    m.add_rule(
        Rule(
            steps=[
                RuleStep(CRUSH_RULE_TAKE, root),
                RuleStep(
                    CRUSH_RULE_CHOOSELEAF_FIRSTN if domain_type else CRUSH_RULE_CHOOSE_FIRSTN,
                    0,
                    domain_type,
                ),
                RuleStep(CRUSH_RULE_EMIT),
            ],
            type=1,
        ),
        0,
    )
    m.add_rule(
        Rule(
            steps=[
                RuleStep(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5),
                RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 100),
                RuleStep(CRUSH_RULE_TAKE, root),
                RuleStep(
                    CRUSH_RULE_CHOOSELEAF_INDEP if domain_type else CRUSH_RULE_CHOOSE_INDEP,
                    0,
                    domain_type,
                ),
                RuleStep(CRUSH_RULE_EMIT),
            ],
            type=3,
        ),
        1,
    )


def flat_map(tun=JEWEL):
    m = JCrushMap(tunables=tun)
    root = m.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, list(range(10)), [(i + 1) * 0x10000 // 2 for i in range(10)]
    )
    _add_two_rules(m, root, 0)
    return m


def _two_level(tun, algs, nhosts, per_host, wfun, root_alg):
    m = JCrushMap(tunables=tun)
    hosts = []
    for h in range(nhosts):
        items = [h * per_host + i for i in range(per_host)]
        hosts.append(
            m.add_bucket(algs[h % len(algs)], 1, items, [wfun(h, i) for i in range(per_host)])
        )
    root = m.add_bucket(root_alg, 3, hosts, [m.buckets[b].weight for b in hosts])
    _add_two_rules(m, root, 1)
    return m


def two_level_map(tun=JEWEL):
    return _two_level(
        tun, [CRUSH_BUCKET_STRAW2], 5, 4,
        lambda h, i: 0x10000 + ((h * 4 + i) % 5) * 0x4000, CRUSH_BUCKET_STRAW2,
    )


def three_level_map():
    """racks(2) -> hosts(3 each) -> osds(4 each), mixed weights."""
    m = JCrushMap(tunables=JEWEL)
    racks = []
    osd = 0
    rng = np.random.default_rng(7)
    for _ in range(2):
        hosts = []
        for _ in range(3):
            items = list(range(osd, osd + 4))
            osd += 4
            weights = [int(w) * 0x4000 for w in rng.integers(1, 8, 4)]
            hosts.append(m.add_bucket(CRUSH_BUCKET_STRAW2, 1, items, weights))
        racks.append(m.add_bucket(CRUSH_BUCKET_STRAW2, 2, hosts, [m.buckets[b].weight for b in hosts]))
    root = m.add_bucket(CRUSH_BUCKET_STRAW2, 3, racks, [m.buckets[b].weight for b in racks])
    _add_two_rules(m, root, 1)
    return m


def large_map():
    """200 OSDs, 20 hosts of 10, uneven weights."""
    return _two_level(
        JEWEL, [CRUSH_BUCKET_STRAW2], 20, 10,
        lambda h, i: 0x10000 + ((h * 10 + i) % 7) * 0x2000, CRUSH_BUCKET_STRAW2,
    )


MAPS = {"flat": flat_map, "two_level": two_level_map, "three_level": three_level_map}


def mixed_weight_vector(n, seed=3):
    rng = np.random.default_rng(seed)
    w = np.full(n, 0x10000, dtype=np.int64)
    w[rng.choice(n, size=max(1, n // 6), replace=False)] = 0
    w[rng.choice(n, size=max(1, n // 5), replace=False)] = 0x8000
    return w


def _port(m):
    pm = CrushMap.copy_from(m)
    return pm, torchmap.compile_map(pm, device="cpu")


def _assert_matches_oracle(m, got, counts, rule, xs, result_max, weights=None):
    """Row i of (got, counts) is the oracle's mapping of xs[i] (``m`` is
    the port's copy of the map: its oracle is held to the JAX package's
    by the golden vectors and test_copy_from_and_tables_equal_jaxmap)."""
    for i, x in enumerate(xs):
        want = m.do_rule(rule, int(x), result_max, None if weights is None else list(weights))
        assert got[i, : counts[i]].tolist() == want, (rule, result_max, int(x))


# -- primitives -------------------------------------------------------------


@pytest.mark.parametrize("arity", [2, 3, 4])
def test_hashes_match_the_jax_package(arity):
    rng = np.random.default_rng(arity)
    words = [rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32) for _ in range(arity)]
    # the ends of the u32 range, where int32 words wrap
    for w in words:
        w[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
        w[4:8] = [0x80000000, 0xFFFFFFFE, 0x80000001, 12345]
    t = [torch.from_numpy(w.view(np.int32)) for w in words]
    ours = {2: torchmap.hash2, 3: torchmap.hash3, 4: torchmap.hash4}[arity]
    theirs = {2: j_hashing.crush_hash32_2, 3: j_hashing.crush_hash32_3,
              4: j_hashing.crush_hash32_4}[arity]
    got = ours(*t).numpy().view(np.uint32)
    want = theirs(*words)
    np.testing.assert_array_equal(got, want)


def test_crush_ln_exact_over_the_full_domain():
    rh, lh, ll = (torch.from_numpy(v) for v in j_ln._tables())
    got = torchmap.crush_ln(torch.arange(0x10000), rh, lh, ll).numpy()
    np.testing.assert_array_equal(got, j_ln.crush_ln(np.arange(0x10000, dtype=np.uint32)))


def test_straw2_draw_first_index_wins_a_tie():
    """Equal draws (same hash input, same weight): the first column wins,
    like the C's strict ``>``; a zero weight never wins while another
    column draws, and an all-zero row takes column 0."""
    _, cm = _port(flat_map())
    lanes = torchmap._Lanes(cm, torch.full((10,), 0x10000))
    x = torch.arange(64, dtype=torch.int32)[:, None]
    ids = torch.full((1, 5), 7, dtype=torch.int32)
    r = torch.zeros((1, 1), dtype=torch.int32)
    for w, first in (([3, 3, 3, 3, 3], 0), ([0, 3, 3, 3, 3], 1), ([0, 0, 0, 5, 5], 3),
                     ([0, 0, 0, 0, 0], 0)):
        wt = torch.tensor([w])
        am = lanes.draw(x, ids, torch.where(wt > 0, wt, 1), wt > 0, r)
        assert am.squeeze(1).tolist() == [first] * 64, w


# -- the compiled map -------------------------------------------------------


@pytest.mark.parametrize(
    "mkmap",
    [flat_map, two_level_map, three_level_map, large_map, lambda: j_build_hierarchy(10000, 40, 25)],
    ids=["flat", "two_level", "three_level", "large", "baseline5"],
)
def test_copy_from_and_tables_equal_jaxmap(mkmap):
    m = mkmap()
    pm, cm = _port(m)
    for x in range(0, 64, 7):
        for rule, rmax in ((0, 3), (1, 4)):
            assert pm.do_rule(rule, x, rmax) == m.do_rule(rule, x, rmax)
    jcm = jaxmap.compile_map(m)
    sz, rp = jcm.sz, np.asarray(jcm.row_pack).astype(np.int64)
    assert (cm.sz, cm.nb) == (sz, jcm.nb)
    np.testing.assert_array_equal(cm.items.numpy(), rp[:, :sz])
    np.testing.assert_array_equal(cm.weights.numpy(), rp[:, sz : 2 * sz] * 65536 + rp[:, 2 * sz : 3 * sz])
    np.testing.assert_array_equal(cm.sizes.numpy(), rp[:, 7 * sz])
    np.testing.assert_array_equal(cm.algs.numpy(), rp[:, 7 * sz + 1])
    np.testing.assert_array_equal(cm.ids.numpy(), rp[:, 7 * sz + 2])
    np.testing.assert_array_equal(cm.types.numpy(), np.asarray(jcm.types_f).astype(np.int64))
    np.testing.assert_array_equal(cm.bidx.numpy(), np.asarray(jcm.bidx_f).astype(np.int64))
    assert cm.host_bidx == jcm.bidx and cm.tunables == jcm.tunables and cm.rules == jcm.rules
    for rule, rmax, boost in ((0, 3, 0), (0, 5, 1), (1, 4, 0)):
        ours = torchmap._plan_groups(cm, rule, rmax, boost)
        theirs = jaxmap._plan_groups(jcm, rule, rmax, boost)
        assert ours == theirs


def test_weights_only_change_reuses_the_plans():
    m = two_level_map()
    pm, cm = _port(m)
    plans = torchmap._plans(cm, 0, 3, 0)
    bid = min(pm.buckets)
    pm.buckets[bid].item_weights[0] += 0x1000
    pm.touch()
    cm2 = torchmap.compile_map(pm, device="cpu")
    assert cm2.skey == cm.skey and torchmap._plans(cm2, 0, 3, 0) is plans
    assert not torch.equal(cm2.weights, cm.weights)


def _refusal_pair(m):
    with pytest.raises(jaxmap.UnsupportedMap) as theirs:
        jaxmap.compile_map(m)
    with pytest.raises(torchmap.UnsupportedMap) as ours:
        torchmap.compile_map(CrushMap.copy_from(m), device="cpu")
    assert str(ours.value) == str(theirs.value)


def test_compile_map_refusals():
    """UnsupportedMap where jaxmap refuses (same message); legacy bucket
    algorithms and choose_args compile and map equal to jaxmap."""
    argonaut = flat_map(ARGONAUT)
    for m in (argonaut, JCrushMap()):
        _refusal_pair(m)
    xs = np.arange(64)
    for alg in (CRUSH_BUCKET_UNIFORM, CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE, CRUSH_BUCKET_STRAW):
        m = _two_level(JEWEL, [alg], 3, 2, lambda h, i: 0x10000, CRUSH_BUCKET_STRAW2)
        _, cm = _port(m)
        for rule in (0, 1):
            (res, counts, ok), (jres, jcounts, jok) = _raw_pair(m, cm, rule, xs, 3, None)
            np.testing.assert_array_equal(ok, jok)
            np.testing.assert_array_equal(res[ok], jres[ok])
            np.testing.assert_array_equal(counts[ok], jcounts[ok])
    m = two_level_map()
    m.set_choose_args({min(m.buckets): ChooseArg(ids=list(range(100, 105)))})
    _, cm = _port(m)
    (res, counts, ok), (jres, jcounts, jok) = _raw_pair(m, cm, 0, xs, 3, None)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(res[ok], jres[ok])
    # jaxmap's choose_args and legacy-table guards, same messages
    bad = two_level_map()
    host = max(b for b in bad.buckets)
    bad.set_choose_args({host: ChooseArg(ids=[1, 2])})
    _refusal_pair(bad)
    bad.set_choose_args({host: ChooseArg(weight_set=[[0x10000] * 3])})
    _refusal_pair(bad)
    bad.set_choose_args({host: ChooseArg(weight_set=[[1 << 32] * 4])})
    _refusal_pair(bad)
    bad.set_choose_args({host: ChooseArg(ids=[1 << 24, 1, 2, 3])})
    _refusal_pair(bad)
    straw = _two_level(JEWEL, [CRUSH_BUCKET_STRAW], 3, 2, lambda h, i: 0x10000, CRUSH_BUCKET_STRAW2)
    straw.buckets[max(straw.buckets)].straws = None
    _refusal_pair(straw)
    lst = _two_level(JEWEL, [CRUSH_BUCKET_LIST], 3, 2, lambda h, i: 0x10000, CRUSH_BUCKET_STRAW2)
    lst.buckets[max(lst.buckets)].sum_weights[1] = 1 << 32
    _refusal_pair(lst)
    tree = _two_level(JEWEL, [CRUSH_BUCKET_TREE], 3, 2, lambda h, i: 0x10000, CRUSH_BUCKET_STRAW2)
    tree.buckets[max(tree.buckets)].node_weights[1] = 1 << 32
    _refusal_pair(tree)
    tree.buckets[max(tree.buckets)].node_weights = []
    _refusal_pair(tree)


# -- the batched mapper against the JAX package -----------------------------


@pytest.mark.parametrize("name", sorted(MAPS))
@pytest.mark.parametrize("rule", [0, 1], ids=["firstn", "indep"])
def test_device_matches_oracle(name, rule):
    pm, cm = _port(MAPS[name]())
    xs = np.arange(256)
    for result_max in (1, 3, 5):
        for weights in (None, mixed_weight_vector(pm.max_devices)):
            got, counts = torchmap.batch_do_rule(cm, rule, xs, result_max, weights)
            _assert_matches_oracle(pm, got, counts, rule, xs, result_max, weights)


def _raw_pair(m, cm, rule, xs, rmax, weights):
    w = np.full(m.max_devices, 0x10000, np.int64) if weights is None else weights
    jcm = jaxmap.compile_map(m)
    theirs = jaxmap._batched(jcm, rule, rmax, jaxmap._spec_boost_for(weights))(
        np.asarray(xs, np.int32), np.asarray(w, np.int32), *jaxmap._kernel_tables(jcm)
    )
    ours = torchmap.batch_do_rule_raw(cm, rule, xs, rmax, weights)
    return [t.numpy() for t in ours], [np.asarray(t) for t in theirs]


@pytest.mark.parametrize("name", sorted(MAPS))
@pytest.mark.parametrize("rule", [0, 1], ids=["firstn", "indep"])
@pytest.mark.parametrize("weights,rmax", [("full", 3), ("mixed", 5)])
def test_raw_output_matches_jaxmap_lane_for_lane(name, rule, weights, rmax):
    m = MAPS[name]()
    _, cm = _port(m)
    w = mixed_weight_vector(m.max_devices) if weights == "mixed" else None
    (res, counts, ok), (jres, jcounts, jok) = _raw_pair(m, cm, rule, np.arange(256), rmax, w)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(res[ok], jres[ok])
    np.testing.assert_array_equal(counts[ok], jcounts[ok])
    if rule == 0 and weights == "mixed":
        assert not ok.all()  # the small maps overflow the window: fallback is exercised


@pytest.mark.parametrize("rule,rmax", [(0, 3), (1, 11)], ids=["replicated", "ec8+3"])
def test_baseline5_hierarchy_matches_jaxmap(rule, rmax):
    """build_hierarchy(10000, 40, 25) at 4096 PGs, raw output equal."""
    m = j_build_hierarchy(10000, 40, 25)
    pm, cm = _port(m)
    (res, counts, ok), (jres, jcounts, jok) = _raw_pair(m, cm, rule, np.arange(4096), rmax, None)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_array_equal(res, jres)
    np.testing.assert_array_equal(counts, jcounts)
    _assert_matches_oracle(pm, res[::512], counts[::512], rule, range(0, 4096, 512), rmax)


def test_firefly_stable0_matches_oracle():
    m = _two_level(FIREFLY, [CRUSH_BUCKET_STRAW2], 5, 4,
                   lambda h, i: 0x10000 + ((h * 4 + i) % 5) * 0x4000, CRUSH_BUCKET_STRAW2)
    pm, cm = _port(m)
    got, counts = torchmap.batch_do_rule(cm, 0, np.arange(128), 3)
    _assert_matches_oracle(pm, got, counts, 0, range(128), 3)


def test_unsupported_fallback():
    m = JCrushMap(tunables=Tunables.argonaut())
    root = m.add_bucket(CRUSH_BUCKET_STRAW2, 3, [0, 1, 2], [0x10000] * 3)
    _add_two_rules(m, root, 0)
    with pytest.raises(torchmap.UnsupportedMap):
        torchmap.compile_map(CrushMap.copy_from(m), device="cpu")


def test_large_hierarchy_spot_check():
    pm, cm = _port(large_map())
    xs = np.arange(0, 64000, 2000)
    wv = mixed_weight_vector(pm.max_devices, seed=11)
    for rule in (0, 1):
        got, counts = torchmap.batch_do_rule(cm, rule, xs, 4, wv)
        _assert_matches_oracle(pm, got, counts, rule, xs, 4, wv)


def test_firstn_numrep_exceeding_result_max_matches_oracle():
    m = JCrushMap(tunables=JEWEL)
    root = m.add_bucket(CRUSH_BUCKET_STRAW2, 3, list(range(8)), [0x10000] * 8)
    m.add_rule(Rule(steps=[
        RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 1),
        RuleStep(CRUSH_RULE_TAKE, root),
        RuleStep(CRUSH_RULE_CHOOSE_FIRSTN, 5, 0),
        RuleStep(CRUSH_RULE_EMIT),
    ], type=1), 0)
    pm, cm = _port(m)
    wv = mixed_weight_vector(8, seed=5)
    got, counts = torchmap.batch_do_rule(cm, 0, np.arange(200), 3, wv)
    _assert_matches_oracle(pm, got, counts, 0, range(200), 3, wv)


def test_set_tries_zero_override_ignored_like_c():
    m = JCrushMap(tunables=JEWEL)
    root = m.add_bucket(CRUSH_BUCKET_STRAW2, 3, list(range(6)), [0x10000] * 6)
    m.add_rule(Rule(steps=[
        RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 0),
        RuleStep(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 0),
        RuleStep(CRUSH_RULE_TAKE, root),
        RuleStep(CRUSH_RULE_CHOOSE_INDEP, 0, 0),
        RuleStep(CRUSH_RULE_EMIT),
    ], type=3), 0)
    pm, cm = _port(m)
    got, counts = torchmap.batch_do_rule(cm, 0, np.arange(50), 3)
    _assert_matches_oracle(pm, got, counts, 0, range(50), 3)


def test_range_packed_chained_and_fallback_guard():
    pm, cm = _port(two_level_map())
    w = mixed_weight_vector(pm.max_devices)
    xs = np.arange(100, 356)
    packed = torchmap.batch_do_rule_range(cm, 0, 100, 256, 5, w, packed=True)
    assert packed[0].dtype == torch.int16 and packed[1].dtype == torch.uint8
    before = torchmap.fallback_lanes
    res, counts = torchmap.apply_oracle_fallback(cm, 0, xs, *packed, 5, w)
    assert torchmap.fallback_lanes - before == int((~packed[2]).sum()) > 0
    _assert_matches_oracle(pm, res, counts, 0, xs, 5, w)
    run = torchmap.make_chained_runner(cm, 1, 3, 128, iters=3)
    assert run(0)[0] == run(0)[0] != run(1)[0]
    pm.touch()  # the source map changed: the fallback must refuse
    with pytest.raises(RuntimeError, match="mutated"):
        torchmap.apply_oracle_fallback(cm, 0, xs, *packed, 5, w)


# -- the reference C's golden vectors ---------------------------------------


def _golden_scenarios():
    """tests/test_crush.py's five scenarios, built as the reference C
    built them (straw_calc_version 0)."""
    m0 = JCrushMap(tunables=JEWEL)
    root = m0.add_bucket(CRUSH_BUCKET_STRAW2, 3, list(range(10)),
                         [(i + 1) * 0x10000 // 2 for i in range(10)])
    _add_two_rules(m0, root, 0)
    return {
        0: m0,
        1: _two_level(JEWEL, [CRUSH_BUCKET_STRAW2], 5, 4, lambda h, i: 0x10000 + i * 0x4000,
                      CRUSH_BUCKET_STRAW2),
        2: _two_level(
            JEWEL,
            [CRUSH_BUCKET_UNIFORM, CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE, CRUSH_BUCKET_STRAW,
             CRUSH_BUCKET_STRAW2],
            5, 4, lambda h, i: 0x18000 if h % 5 == 0 else 0x10000 + i * 0x6000,
            CRUSH_BUCKET_STRAW2,
        ),
        3: _two_level(ARGONAUT, [CRUSH_BUCKET_STRAW], 6, 3,
                      lambda h, i: 0x10000 * (1 + (h + i) % 3), CRUSH_BUCKET_STRAW),
        4: _two_level(FIREFLY, [CRUSH_BUCKET_STRAW2], 4, 5, lambda h, i: 0x8000 * (1 + (i % 4)),
                      CRUSH_BUCKET_STRAW2),
    }


def _golden_weights(n):
    return [0 if i % 11 == 5 else 0x8000 if i % 7 == 3 else 0x10000 for i in range(n)]


def _golden():
    rows = {}
    for line in gzip.open(GOLDEN, "rt").read().splitlines():
        head, _, tail = line.partition(" ->")
        scen, rule, x, rmax = head.split()
        key = (int(scen[1:]), int(rule[1:]), int(rmax.split("=")[1]))
        rows.setdefault(key, {})[int(x.split("=")[1])] = [int(v) for v in tail.split()]
    return rows


def test_golden_vectors_through_the_port():
    """All five scenarios through the port's oracle copy and, but for
    scenario 3, through the batched mapper too: scenario 3's argonaut
    tunables (choose_local_tries 2) are outside it, as outside jaxmap,
    so its 600 lines map through the oracle as crushtool and
    OSDMapMapping map them."""
    scenarios = _golden_scenarios()
    maps = {s: CrushMap.copy_from(m) for s, m in scenarios.items()}
    _refusal_pair(scenarios[3])
    oracle = mapped = 0
    for (scen, rule, rmax), rows in sorted(_golden().items()):
        m = maps[scen]
        w = _golden_weights(m.max_devices)
        xs = np.array(sorted(rows))
        for x in xs:
            assert m.do_rule(rule, int(x), rmax, w) == rows[x], (scen, rule, int(x))
            oracle += 1
        if scen != 3:
            res, counts = torchmap.batch_do_rule(
                torchmap.compile_map(m, device="cpu"), rule, xs, rmax, w
            )
            for i, x in enumerate(xs):
                assert res[i, : counts[i]].tolist() == rows[x], (scen, rule, int(x))
                mapped += 1
    assert (oracle, mapped) == (3000, 2400)


# -- lrc's rule and crushtool -----------------------------------------------


def test_lrc_create_rule_equals_the_jax_plugins():
    from ceph_tpu.ec import ErasureCodeProfile as JProfile
    from ceph_tpu.ec import registry_instance as j_registry
    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
    from ceph_tpu_torch.tools import crushtool

    prof = {"k": "4", "m": "2", "l": "3", "crush-locality": "rack"}
    jm = j_build_hierarchy(96, 4, 4)
    pm = CrushMap.copy_from(jm)
    jrule = j_registry().factory("lrc", JProfile(prof)).create_rule("lrc_rule", jm)
    rule = registry_instance().factory("lrc", ErasureCodeProfile(prof, device="cpu")).create_rule(
        "lrc_rule", pm
    )
    assert rule == jrule == 2 and pm.rule_names[rule] == "lrc_rule"
    assert [(s.op, s.arg1, s.arg2) for s in pm.rules[rule].steps] == [
        (s.op, s.arg1, s.arg2) for s in jm.rules[jrule].steps
    ]
    assert pm.rules[rule].type == jm.rules[jrule].type
    for x in range(0, 400, 37):
        placed = pm.do_rule(rule, x, 8)
        assert placed == jm.do_rule(jrule, x, 8) and len(set(placed)) == 8
    # two choose steps in one group: outside the batched mapper's rule
    # shapes, so crushtool maps through the oracle and says so
    with pytest.raises(torchmap.UnsupportedMap, match="choose without take"):
        torchmap.compile_map(pm, device="cpu")
    args = crushtool.parse_args(["--test", "--rule", str(rule), "--num-rep", "8",
                                 "--max-x", "16", "--device", "cpu"])
    stats = crushtool.run_test(pm, args)
    assert args.backend == "oracle" and stats["bad"] == 0


def test_crushtool_cli(capsys):
    from ceph_tpu_torch.tools import crushtool

    assert crushtool.main(["--build", "600:10:6", "--test", "--max-x", "512", "--device", "cpu",
                           "--show-statistics", "--show-bad-mappings", "--weight", "3:0.5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("[torch]") and out[1].startswith("oracle fallback lanes:")
    assert out[2] == "bad mappings (short of 3): 0" and out[3].startswith("chi-squared = ")
    legacy = CrushMap.copy_from(
        _two_level(JEWEL, [CRUSH_BUCKET_LIST], 4, 2, lambda h, i: 0x10000, CRUSH_BUCKET_STRAW2)
    )
    test = ["--test", "--max-x", "32", "--device", "cpu", "--show-bad-mappings"]
    assert crushtool.main(test, crushmap=legacy) == 0
    ours = capsys.readouterr().out.splitlines()
    assert ours[0].endswith("[torch]")
    assert crushtool.main(test + ["--backend", "oracle"], crushmap=legacy) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert theirs[0].endswith("[oracle]") and ours[2] == theirs[1]
