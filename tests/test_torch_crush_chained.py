"""Chained choose steps in the port's batched mapper, on the CPU.

A rule group with several choose steps between its TAKE and its EMIT
(lrc's ``choose indep <groups> type <locality>; chooseleaf indep <l+1>
type <failure domain>``) runs each chained step over the previous
step's output, one sub-lane a (PG, item), as ``crush_do_rule`` calls
the chooser once an item.  Every case is held lane for lane against the
port's oracle (``CrushMap.do_rule``) and the JAX package's scalar
``ceph_tpu/crush/mapper.py``, on seeded straw2 maps with seeded out and
reweighted OSDs; the raw batched output is compared, so no oracle
fallback can hide a divergence.  ``OSDMapMapping`` maps an LRC pool on
the device route like the scalar route, with every PG through the
chained path.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from ceph_tpu.crush.types import Rule as JRule
from ceph_tpu.crush.types import RuleStep as JRuleStep
from ceph_tpu.tools.crushtool import build_hierarchy as j_build_hierarchy
from ceph_tpu_torch.crush import torchmap
from ceph_tpu_torch.crush.builder import CrushMap
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_TAKE,
    PG_POOL_TYPE_ERASURE,
    Rule,
    RuleStep,
)
from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
from ceph_tpu_torch.osd import OSDMap, OSDMapMapping, PgPool

RACK, HOST = 2, 1
LRC = {"k": "4", "m": "2", "l": "3", "crush-locality": "rack",
       "crush-failure-domain": "host"}


def _weight_fn(seed):
    """Seeded CRUSH weights: most OSDs at 1.0, some at 0.5 or 1.5."""
    rng = np.random.default_rng([seed, 1])
    table = rng.choice([0x8000, 0x10000, 0x10000, 0x18000], size=4096)
    return lambda osd: int(table[osd])


def _reweights(n, seed, out=()):
    """Seeded reweight vector: a twelfth of the OSDs out, a tenth at
    half, and every OSD of ``out`` out."""
    rng = np.random.default_rng([seed, 2])
    w = np.full(n, 0x10000, dtype=np.int64)
    w[rng.choice(n, size=max(1, n // 12), replace=False)] = 0
    w[rng.choice(n, size=max(1, n // 10), replace=False)] = 0x8000
    w[list(out)] = 0
    return w


def _steps(*chooses, tries=True):
    pre = [(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5, 0), (CRUSH_RULE_SET_CHOOSE_TRIES, 100, 0)]
    return (pre if tries else []) + [(CRUSH_RULE_TAKE, None, 0), *chooses, (CRUSH_RULE_EMIT, 0, 0)]


def _lrc_rule(pm):
    """The rule lrc's plugin makes for the k=4 m=2 l=3 rack-local profile."""
    ec = registry_instance().factory("lrc", ErasureCodeProfile(dict(LRC), device="cpu"))
    rule = ec.create_rule("lrc_rule", pm)
    return [(s.op, s.arg1, s.arg2) for s in pm.rules[rule].steps]


# name -> (osds, per host, hosts a rack, rule steps (None: lrc's), result_max, OSDs out)
CASES = {
    # 24 hosts in 6 racks: 2 racks of 4 hosts a PG
    "lrc": (96, 4, 4, None, 8, ()),
    # result_max 6: the second rack's sub-lane gets 2 slots, not 4
    "lrc_short": (96, 4, 4, None, 6, ()),
    # 2 racks for 3 rack slots: step 1 leaves a NONE and step 2 packs
    # the racks after it to the left
    "few_racks": (24, 4, 3, _steps((CRUSH_RULE_CHOOSE_INDEP, 3, RACK),
                                   (CRUSH_RULE_CHOOSELEAF_INDEP, 2, HOST)), 6, ()),
    # one rack for lrc's two
    "one_rack": (16, 4, 4, None, 8, ()),
    # every OSD of rack 0 out: a PG drawing that rack gets NONE holes
    "rack_all_out": (96, 4, 4, None, 8, range(16)),
    "firstn": (96, 4, 4, _steps((CRUSH_RULE_CHOOSE_FIRSTN, 2, RACK),
                                (CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, HOST), tries=False), 4, ()),
    # result_max 3: the second rack keeps one of its two leaves
    "firstn_short": (96, 4, 4, _steps((CRUSH_RULE_CHOOSE_FIRSTN, 2, RACK),
                                      (CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, HOST), tries=False),
                     3, ()),
    # two emit groups: a chained one, then a single step after it
    "two_groups": (96, 4, 4, [(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5, 0),
                              (CRUSH_RULE_TAKE, None, 0), (CRUSH_RULE_CHOOSE_INDEP, 1, RACK),
                              (CRUSH_RULE_CHOOSELEAF_INDEP, 2, HOST), (CRUSH_RULE_EMIT, 0, 0),
                              (CRUSH_RULE_TAKE, None, 0), (CRUSH_RULE_CHOOSELEAF_INDEP, 3, HOST),
                              (CRUSH_RULE_EMIT, 0, 0)], 4, ()),
    # three steps: rack, then host, then one OSD a host
    "three_steps": (96, 4, 4, _steps((CRUSH_RULE_CHOOSE_INDEP, 2, RACK),
                                     (CRUSH_RULE_CHOOSE_INDEP, 2, HOST),
                                     (CRUSH_RULE_CHOOSE_INDEP, 1, 0)), 4, ()),
}


def _case(name, seed):
    osds, per_host, per_rack, steps, rmax, out = CASES[name]
    jm = j_build_hierarchy(osds, per_host, per_rack, _weight_fn(seed))
    pm = CrushMap.copy_from(jm)
    root = min(pm.buckets)
    if steps is None:
        steps = _lrc_rule(pm)
    else:
        steps = [(op, root if op == CRUSH_RULE_TAKE else a1, a2) for op, a1, a2 in steps]
        pm.add_rule(Rule(steps=[RuleStep(*s) for s in steps], type=PG_POOL_TYPE_ERASURE))
    jrule = jm.add_rule(JRule(steps=[JRuleStep(*s) for s in steps], type=PG_POOL_TYPE_ERASURE))
    rule = len(pm.rules) - 1
    assert rule == jrule
    return jm, pm, rule, rmax, _reweights(osds, seed, out)


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
@pytest.mark.parametrize("name", sorted(CASES))
def test_chained_rule_equals_both_oracles(name, seed):
    jm, pm, rule, rmax, w = _case(name, seed)
    cm = torchmap.compile_map(pm, device="cpu")
    # a PG that draws the empty rack retries it for all of lrc's 100
    # rounds, in the oracles as in the batch: fewer PGs there
    xs = np.random.default_rng([seed, 3]).integers(
        0, 2**32, size=48 if name == "rack_all_out" else 240
    )
    before = torchmap.counts["crush_chained_lanes"]
    res, counts, ok = (t.numpy() for t in torchmap.batch_do_rule_raw(cm, rule, xs, rmax, w))
    assert ok.all()
    chained = sum(len(steps) - 1 for _take, steps in cm.rules[rule])
    assert torchmap.counts["crush_chained_lanes"] - before >= chained * len(xs)
    wl = [int(v) for v in w]
    holes = 0
    for i, x in enumerate(xs):
        want = pm.do_rule(rule, int(x), rmax, wl)
        if i % 4 == 0:  # the JAX package's oracle is the slower
            assert want == jm.do_rule(rule, int(x), rmax, wl), (name, int(x))
        got = res[i, : counts[i]].tolist()
        assert got == want, (name, int(x))
        assert (res[i, counts[i]:] == CRUSH_ITEM_NONE).all()
        holes += want.count(CRUSH_ITEM_NONE)
    if name == "rack_all_out":
        assert holes  # PGs drew the empty rack
    if name in ("few_racks", "one_rack"):
        # the missing rack took no slots: PGs come out short
        assert (counts < rmax).any()


def test_lrc_rule_compiles_to_one_group_of_two_steps():
    _jm, pm, rule, _rmax, _w = _case("lrc", 7)
    cm = torchmap.compile_map(pm, device="cpu")
    ((take, steps),) = cm.rules[rule]
    assert take == min(pm.buckets)
    assert [s[:3] for s in steps] == [(CRUSH_RULE_CHOOSE_INDEP, 2, RACK),
                                      (CRUSH_RULE_CHOOSELEAF_INDEP, 4, HOST)]
    plans = torchmap._plan_groups(cm, rule, 8)
    assert [p["take_row"] is None for p in plans] == [False, True]
    assert all(p["fast"] is None for p in plans)
    assert (plans[0]["tries"], plans[1]["leaf_tries"]) == (100, 5)


@pytest.mark.parametrize("steps,message", [
    ([(CRUSH_RULE_TAKE, -1, 0), (CRUSH_RULE_CHOOSE_INDEP, 2, RACK), (CRUSH_RULE_TAKE, -1, 0),
      (CRUSH_RULE_CHOOSELEAF_INDEP, 2, HOST), (CRUSH_RULE_EMIT, 0, 0)], "take after choose"),
    ([(CRUSH_RULE_CHOOSE_INDEP, 2, RACK), (CRUSH_RULE_EMIT, 0, 0)], "choose without take"),
])
def test_rule_shapes_still_refused(steps, message):
    pm = CrushMap.copy_from(j_build_hierarchy(16, 4, 2))
    pm.add_rule(Rule(steps=[RuleStep(*s) for s in steps]))
    with pytest.raises(torchmap.UnsupportedMap, match=message):
        torchmap.compile_map(pm, device="cpu")


def test_mapping_an_lrc_pool_takes_the_chained_path():
    jm = j_build_hierarchy(96, 4, 4, _weight_fn(5))
    pm = CrushMap.copy_from(jm)
    ec = registry_instance().factory("lrc", ErasureCodeProfile(dict(LRC), device="cpu"))
    rule = ec.create_rule("lrcpool", pm)
    om = OSDMap.build(pm, 96)
    pg_num = 1024
    om.add_pool(PgPool(pool_id=1, type=PG_POOL_TYPE_ERASURE, size=ec.get_chunk_count(),
                       min_size=ec.get_data_chunk_count() + 1, pg_num=pg_num,
                       crush_rule=rule, erasure_code_profile="lrcpool"))
    om.osd_weight = [int(v) for v in _reweights(96, 5)]
    for o in (3, 40, 41):
        om.osd_up[o] = False
    device, host = OSDMapMapping(device="cpu"), OSDMapMapping(device="cpu")
    device.update(om)
    host.update(om, use_device=False)
    for name in ("up", "up_primary", "acting", "acting_primary"):
        np.testing.assert_array_equal(getattr(device, name)[1], getattr(host, name)[1])
    perf = device.perf.dump()
    assert perf["crush_host_route_pgs"] == 0 and perf["crush_oracle_lanes"] == 0
    assert perf["crush_chained_lanes"] == 2 * pg_num
    assert host.perf.dump()["crush_chained_lanes"] == 0
    assert device.up[1].shape == (pg_num, 8)
    for ps in range(0, pg_num, 97):
        assert device.get(1, ps)[1] == om.pg_to_up_acting_osds(1, ps)[1]


def test_each_choose_step_is_a_span_and_the_host_route_counts():
    from ceph_tpu_torch.common import tracing
    from ceph_tpu_torch.crush.types import Tunables

    pm = CrushMap.copy_from(j_build_hierarchy(96, 4, 4))
    ec = registry_instance().factory("lrc", ErasureCodeProfile(dict(LRC), device="cpu"))
    om = OSDMap.build(pm, 96)
    om.add_pool(PgPool(pool_id=1, type=PG_POOL_TYPE_ERASURE, size=8, pg_num=256,
                       crush_rule=ec.create_rule("lrcpool", pm)))
    mapping = OSDMapMapping(device="cpu")
    tracer = tracing.Tracer("test")
    with tracer.start_span("epoch"):
        mapping.update(om)
    spans = tracer.dump_traces()["spans"]
    names = {s["span_id"]: s["name"] for s in spans}
    steps = [s for s in spans if s["name"] == "crush_step"]
    assert [s["tags"] for s in steps] == [
        {"step": 0, "op": "choose", "mode": "indep", "numrep": 2, "type": RACK,
         "lanes": 256, "chained": False},
        {"step": 1, "op": "chooseleaf", "mode": "indep", "numrep": 4, "type": HOST,
         "lanes": 512, "chained": True},
    ]
    assert {names[s["parent_id"]] for s in steps} == {"dev_compute"}
    assert mapping.perf.dump()["crush_host_route_pgs"] == 0
    # argonaut tunables: the batched mapper refuses the map, and every
    # PG of the pool goes the scalar oracle's way, counted
    om.crush.tunables = Tunables(2, 5, 19, 0, 0, 0, 0)
    om.crush.touch()
    with pytest.raises(torchmap.UnsupportedMap):
        torchmap.compile_map(om.crush, device="cpu")
    before = mapping.perf.dump()
    mapping.update(om)
    after = mapping.perf.dump()
    assert after["crush_host_route_pgs"] - before["crush_host_route_pgs"] == 256
    assert after["crush_chained_lanes"] == before["crush_chained_lanes"]


@pytest.mark.parametrize("name", ["lrc", "few_racks", "firstn", "single_indep"])
def test_replayed_blocks_equal_the_eager_loop(monkeypatch, name):
    """The generic choosers' recorded blocks (a CUDA graph on the card;
    here their recorders run the same steps eagerly) over every lane
    give the dropping loop's output, and a block recorded under one
    reweight vector maps the next call's."""
    if name == "single_indep":
        jm, pm, rule, rmax, w = _case("lrc", 7)
        rule = 1  # build_hierarchy's chooseleaf indep over hosts
    else:
        jm, pm, rule, rmax, w = _case(name, 7)
    cm = torchmap.compile_map(pm, device="cpu")
    xs = np.random.default_rng(9).integers(0, 2**32, size=160)
    other = _reweights(pm.max_devices, 8)
    want = [[t.numpy() for t in torchmap.batch_do_rule_raw(cm, rule, xs, rmax, v)]
            for v in (w, other)]
    monkeypatch.setattr(torchmap, "_replays", lambda cm, lanes: True)
    monkeypatch.setattr(torchmap, "_BLOCKS", threading.local())
    for v, (res, counts, ok) in zip((w, other), want):
        got = [t.numpy() for t in torchmap.batch_do_rule_raw(cm, rule, xs, rmax, v)]
        np.testing.assert_array_equal(got[0], res)
        np.testing.assert_array_equal(got[1], counts)
        np.testing.assert_array_equal(got[2], ok)
    steps = 1 if name == "single_indep" else len(cm.rules[rule][0][1])
    # a start and a block a chooser, made once, run for both vectors
    assert [len(recs) for recs in torchmap._block_cache().values()] == [2] * steps
