"""ceph_tpu_torch's batched CRUSH mapper on the legacy bucket algorithms
(uniform, list, tree, straw) and choose_args, against jaxmap and the
oracle, on the CPU.

Maps are built with the JAX package's builder and copied across; the
raw ``(res, counts, ok)`` must equal jaxmap's kernel lane for lane, the
finished placements the oracle's, and the choose_args placements the
reference C's golden vectors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu.crush.builder import CrushMap as JCrushMap
from ceph_tpu.crush.types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    ChooseArg,
)
from ceph_tpu_torch.crush import torchmap
from test_torch_crush import (
    JEWEL,
    _add_two_rules,
    _assert_matches_oracle,
    _golden_scenarios,
    _golden_weights,
    _port,
    _raw_pair,
    _two_level,
    mixed_weight_vector,
)


def legacy_map(alg):
    """tests/test_crush_jax.py's legacy hierarchy: 3 hosts of 4 OSDs
    under a root, every bucket of algorithm ``alg``."""
    m = JCrushMap(tunables=JEWEL)
    hosts = []
    for h in range(3):
        items = [h * 4 + i for i in range(4)]
        hosts.append(m.add_bucket(alg, 1, items, [0x10000 + (i % 3) * 0x4000 for i in items]))
    root = m.add_bucket(alg, 3, hosts, [m.buckets[b].weight for b in hosts])
    _add_two_rules(m, root, 1)
    return m


def uniform_maps():
    """tests/test_crush_jax.py's uniform maps: a flat uniform root of 8,
    and uniform hosts of 4 (a size that divides numrep, the indep
    stride case) under a straw2 root."""
    m1 = JCrushMap(tunables=JEWEL)
    _add_two_rules(m1, m1.add_bucket(CRUSH_BUCKET_UNIFORM, 3, list(range(8)), [0x18000] * 8), 0)
    m2 = _two_level(JEWEL, [CRUSH_BUCKET_UNIFORM], 6, 4, lambda h, i: 0x10000, CRUSH_BUCKET_STRAW2)
    return m1, m2


LEGACY = {
    "straw": lambda: legacy_map(CRUSH_BUCKET_STRAW),
    "list": lambda: legacy_map(CRUSH_BUCKET_LIST),
    "tree": lambda: legacy_map(CRUSH_BUCKET_TREE),
    "uniform_flat": lambda: uniform_maps()[0],
    "uniform_hosts": lambda: uniform_maps()[1],
    "mixed": lambda: _golden_scenarios()[2],
}


@pytest.mark.parametrize("name", sorted(LEGACY))
@pytest.mark.parametrize("rule", [0, 1], ids=["firstn", "indep"])
def test_legacy_algorithms_raw_output_matches_jaxmap(name, rule):
    """Every legacy bucket algorithm (and a map mixing all five), full
    and mixed weights, raw (res, counts, ok) equal to jaxmap's lane for
    lane and the finished placements equal to the oracle."""
    m = LEGACY[name]()
    pm, cm = _port(m)
    xs = np.arange(192)
    for rmax, w in ((3, None), (4, mixed_weight_vector(m.max_devices, seed=13)),
                    (2, mixed_weight_vector(m.max_devices))):
        (res, counts, ok), (jres, jcounts, jok) = _raw_pair(m, cm, rule, xs, rmax, w)
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(res[ok], jres[ok])
        np.testing.assert_array_equal(counts[ok], jcounts[ok])
        got, cnt = torchmap.apply_oracle_fallback(cm, rule, xs, res, counts, ok, rmax, w)
        _assert_matches_oracle(pm, got, cnt, rule, xs, rmax, w)


def test_tree_draw_is_exact_at_the_u32_ends():
    """The tree draw's (hash * weight) >> 32 in 16-bit halves equals the
    python-int product at the ends of both u32 ranges."""
    rng = np.random.default_rng(5)
    h = np.concatenate([[0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x80000000],
                        rng.integers(0, 1 << 32, 500)]).astype(np.int64)
    w = np.concatenate([[0xFFFFFFFF, 1, 0xFFFFFFFF, 0xFFFF, 0xFFFFFFFF, 0x10000],
                        rng.integers(0, 1 << 32, 500)]).astype(np.int64)
    got = torchmap._mulhi32(torch.from_numpy(h), torch.from_numpy(w))
    assert got.tolist() == [(int(a) * int(b)) >> 32 for a, b in zip(h, w)]


def test_choose_args_golden_vectors():
    """The 600 choose_args lines of the reference C (weight-set positions
    and id remaps; firstn passes the running outpos, indep the frame's)
    through the batched mapper, and its raw output equal to jaxmap's."""
    from test_crush import build_choose_args_scenario, iter_choose_args_golden

    m = build_choose_args_scenario()
    pm, cm = _port(m)
    assert cm.arg_positions == 2
    w = np.array(_golden_weights(20))
    xs = np.arange(100)
    results = {}
    for rule in (0, 1):
        for nrep in (2, 3, 4):
            results[rule, nrep] = torchmap.batch_do_rule(cm, rule, xs, nrep, w)
            (res, counts, ok), (jres, jcounts, jok) = _raw_pair(m, cm, rule, xs, nrep, w)
            np.testing.assert_array_equal(ok, jok)
            np.testing.assert_array_equal(res[ok], jres[ok])
            np.testing.assert_array_equal(counts[ok], jcounts[ok])
    checked = 0
    for tag, rule, nrep, x, want in iter_choose_args_golden():
        if tag == "ca":
            got, counts = results[rule, nrep]
            assert got[x, : counts[x]].tolist() == want, (rule, nrep, x)
            checked += 1
    assert checked == 600


def test_choose_args_single_position_takes_the_fast_path():
    """One weight-set position (the mgr balancer's compat weight-set)
    keeps firstn on the fast path, as in jaxmap; weight-set draws and
    remapped hash ids equal the oracle and jaxmap lane for lane."""
    from test_crush import build_choose_args_scenario

    m = build_choose_args_scenario()
    hosts = sorted(b for b, bk in m.buckets.items() if bk.type == 1)
    m.set_choose_args({
        hosts[0]: ChooseArg(weight_set=[[0x8000 + i * 0x2000 for i in range(4)]]),
        hosts[2]: ChooseArg(ids=[1008, 1009, 1010, 1011]),
    })
    pm, cm = _port(m)
    assert cm.arg_positions == 1
    assert torchmap._plan_groups(cm, 0, 3)[0]["fast"] is not None
    xs = np.arange(200)
    for rule in (0, 1):
        got, counts = torchmap.batch_do_rule(cm, rule, xs, 3)
        _assert_matches_oracle(pm, got, counts, rule, xs, 3)
        (res, c, ok), (jres, jc, jok) = _raw_pair(m, cm, rule, xs, 3, None)
        np.testing.assert_array_equal(ok, jok)
        np.testing.assert_array_equal(res[ok], jres[ok])
