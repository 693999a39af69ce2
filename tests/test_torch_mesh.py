"""The port's device mesh (ops/mesh.py, osd/sharded_mapping.py) against
the JAX package's, on the CPU.

A mesh of the port is one process over a list of torch devices; here
it repeats the CPU device (``DeviceMesh(["cpu"] * n)``), the
counterpart of the conftest's 8-device virtual XLA mesh the JAX tests
shard over.  The contract: sharding never changes a byte.  Sharded EC
encode and sharded CRUSH mapping equal the port's single-device routes
and the JAX package's sharded functions on its 8-device mesh, on meshes
of 1, 2, 3 and 8 entries with ragged batches; the per-device counters
carry the JAX names; with a default mesh forced (``available_devices``
patched to CPU entries, the ``CEPH_TPU_MESH*`` gates) ``TorchBackend``
and ``OSDMapMapping`` route through it and equal the JAX package's
output; the dryrun's storage step over an 8-entry mesh gives the JAX
step's parity and checksum.

Tolerance: exact (bytes, placements, counters).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceph_tpu.ops.mesh as j_mesh
from ceph_tpu import gf as j_gf
from ceph_tpu.crush import jaxmap
from ceph_tpu.ops.gf_matmul import matrix_to_device_bitmatrix as j_bitmatrix
from ceph_tpu.ops.kernel_stats import kernel_stats as j_kernel_stats
from ceph_tpu.osd.sharded_mapping import sharded_batch_do_rule as j_sharded
from ceph_tpu.tools.crushtool import build_hierarchy as j_build_hierarchy
from ceph_tpu_torch import gf
from ceph_tpu_torch.crush import torchmap
from ceph_tpu_torch.ops import mesh as meshmod
from ceph_tpu_torch.ops.gf_matmul import gf_matrix_stripes, matrix_to_device_bitmatrix
from ceph_tpu_torch.ops.kernel_stats import kernel_stats
from ceph_tpu_torch.osd.sharded_mapping import (
    ShardedPGMapper,
    mesh_batch_do_rule,
    sharded_batch_do_rule,
)
from ceph_tpu_torch.tools import mesh_dryrun
from ceph_tpu_torch.tools.crushtool import build_hierarchy

CPU = torch.device("cpu")


def cpu_mesh(n: int) -> meshmod.DeviceMesh:
    return meshmod.DeviceMesh(["cpu"] * n)


@pytest.fixture()
def forced_mesh(monkeypatch):
    """A default mesh of CPU entries: ``available_devices`` patched to
    eight CPU devices (no card here), ``CEPH_TPU_MESH=1`` over the
    conftest's 0, the cached probe reset around the test."""
    meshmod._reset_default_mesh_for_tests()
    monkeypatch.setattr(meshmod, "available_devices", lambda: [CPU] * 8)
    monkeypatch.setenv("CEPH_TPU_MESH", "1")
    yield monkeypatch
    meshmod._reset_default_mesh_for_tests()


@pytest.fixture(scope="module")
def jax_mesh():
    return j_mesh.build_mesh()


# -- discovery and the default mesh ----------------------------------------


def test_discovery_without_a_card():
    """No CPU device stands in for a missing card."""
    assert meshmod.available_devices() == []
    assert meshmod.device_count() == 0
    assert meshmod.build_mesh() is None
    full = meshmod.build_mesh(devices=["cpu"] * 8)
    assert full.n == 8 and full.platform == "cpu" and full.distinct() == [CPU]
    sub = meshmod.build_mesh(3, devices=["cpu"] * 8)
    assert sub.n == 3 and sub.cache_key() != full.cache_key()
    with pytest.raises(ValueError):
        meshmod.DeviceMesh([])
    with pytest.raises(ValueError):
        meshmod.DeviceMesh(["cpu", "cuda:0"])
    meshmod._reset_default_mesh_for_tests()
    try:
        assert meshmod.default_mesh() is None
    finally:
        meshmod._reset_default_mesh_for_tests()


def test_probe_devices_subprocess_reports_no_card():
    count, platform, reason = meshmod.probe_devices_subprocess(timeout=120)
    assert (count, platform) == (0, None) and reason


def test_default_mesh_env_gates(forced_mesh):
    forced_mesh.setenv("CEPH_TPU_MESH", "0")
    assert meshmod.default_mesh() is None
    meshmod._reset_default_mesh_for_tests()
    forced_mesh.setenv("CEPH_TPU_MESH", "1")
    forced_mesh.setenv("CEPH_TPU_MESH_DEVICES", "2")
    dm = meshmod.default_mesh()
    assert dm is not None and dm.n == 2
    # probed once: the same object comes back
    assert meshmod.default_mesh() is dm
    # one device is no mesh: product paths keep their dispatch
    meshmod._reset_default_mesh_for_tests()
    forced_mesh.setenv("CEPH_TPU_MESH_DEVICES", "1")
    assert meshmod.default_mesh() is None
    meshmod._reset_default_mesh_for_tests()
    forced_mesh.delenv("CEPH_TPU_MESH_DEVICES")
    assert meshmod.default_mesh().n == 8


@pytest.mark.parametrize("shape,axis,n_dev", [
    ((10,), 0, 8), ((16,), 0, 8), ((1,), 0, 3), ((7, 3), 0, 2), ((5, 4, 3), 1, 3),
    ((13, 2, 6), 0, 8),
])
def test_pad_to_devices_equals_the_jax_package(shape, axis, n_dev):
    a = np.arange(int(np.prod(shape))).reshape(shape)
    padded, n = meshmod.pad_to_devices(a, n_dev, axis)
    jpadded, jn = j_mesh.pad_to_devices(a, n_dev, axis)
    assert n == jn == shape[axis] and np.array_equal(padded, jpadded)
    assert padded.shape[axis] % n_dev == 0
    # the pad repeats a valid lane
    assert (np.take(padded, range(n, padded.shape[axis]), axis=axis)
            == np.take(a, [n - 1], axis=axis)).all()


def test_split_and_gather_round_trip():
    t = torch.arange(24).reshape(12, 2)
    dm = cpu_mesh(3)
    parts = dm.split(t)
    assert [p.shape[0] for p in parts] == [4, 4, 4]
    assert torch.equal(dm.gather(parts), t)
    u = torch.arange(36).reshape(2, 18)
    assert torch.equal(dm.gather(dm.split(u, axis=1), axis=1), u)
    with pytest.raises(ValueError):
        dm.split(torch.arange(10))


# -- sharded CRUSH ----------------------------------------------------------


@pytest.fixture(scope="module")
def maps():
    """build_hierarchy(64, 8, 4) of each package, the port's compiled
    on the CPU."""
    jm, pm = j_build_hierarchy(64, 8, 4), build_hierarchy(64, 8, 4)
    return jm, jaxmap.compile_map(jm), pm, torchmap.compile_map(pm, device="cpu")


@pytest.fixture(scope="module")
def jax_sharded_results(maps, jax_mesh):
    """The JAX package's sharded mapping on its 8-device mesh, per PG
    count (each new padded shape is one XLA compile, so computed once)."""
    _jm, jcm, _pm, _cm = maps
    cache = {}

    def get(n_pgs):
        if n_pgs not in cache:
            cache[n_pgs] = j_sharded(jcm, 0, np.arange(n_pgs), 3, dmesh=jax_mesh)
        return cache[n_pgs]

    return get


@pytest.mark.parametrize("n_pgs", [1, 7, 101, 1029])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_sharded_mapping_byte_identity_ragged(maps, jax_sharded_results, n_pgs, n_dev):
    """sharded == single-device == the JAX sharded function, on PG
    counts that do not divide the mesh."""
    _jm, _jcm, _pm, cm = maps
    xs = np.arange(n_pgs)
    res1, cnt1 = torchmap.batch_do_rule(cm, 0, xs, 3)
    res2, cnt2 = sharded_batch_do_rule(cm, 0, xs, 3, dmesh=cpu_mesh(n_dev))
    assert res2.shape == (n_pgs, 3)
    assert np.array_equal(res1, res2) and np.array_equal(cnt1, cnt2)
    jres, jcnt = jax_sharded_results(n_pgs)
    assert np.array_equal(res2, jres) and np.array_equal(cnt2, jcnt)


@pytest.mark.parametrize("n_dev", [1, 3, 8])
def test_sharded_mapping_with_reweights_and_fallback_lanes(jax_mesh, n_dev):
    """A reweight vector that sends lanes past the fast path's window:
    the oracle re-maps them after the gather; every lane equals the
    oracle and the JAX sharded function."""
    pm, jm = build_hierarchy(20, 4), j_build_hierarchy(20, 4)
    weights = np.full(20, 0x10000, np.int64)
    weights[[1, 6, 11, 13]] = 0
    weights[[3, 8, 17]] = 0x4000
    xs = np.arange(53)
    cm = torchmap.compile_map(pm, device="cpu")
    _res, _cnt, ok = torchmap.batch_do_rule_raw(cm, 0, xs, 5, weights)
    assert not bool(ok.all())  # the fallback is exercised
    before = torchmap.counts["crush_oracle_lanes"]
    res, cnt = sharded_batch_do_rule(pm, 0, xs, 5, weights=weights, dmesh=cpu_mesh(n_dev))
    assert torchmap.counts["crush_oracle_lanes"] - before == int((~ok).sum())
    wl = [int(w) for w in weights]
    for x in xs:
        oracle = pm.do_rule(0, int(x), 5, wl)
        assert cnt[x] == len(oracle) and res[x].tolist()[: len(oracle)] == oracle
    if n_dev == 8:
        jres, jcnt = j_sharded(jaxmap.compile_map(jm), 0, xs, 5,
                               weights=weights.astype(np.int32), dmesh=jax_mesh)
        assert np.array_equal(res, jres) and np.array_equal(cnt, jcnt)


def test_sharded_pg_mapper_compiles_once_per_distinct_device():
    pm = build_hierarchy(32, 4, 2)
    mapper = ShardedPGMapper(pm, cpu_mesh(3))
    assert list(pm._torch_compiled[1]) == ["cpu"]
    cm = pm._torch_compiled[1]["cpu"]
    assert cm.device == CPU
    res, cnt = mapper.map_pgs(0, np.arange(37), 3)
    assert pm._torch_compiled[1]["cpu"] is cm
    ref = torchmap.batch_do_rule(cm, 0, np.arange(37), 3)
    assert np.array_equal(res, ref[0]) and np.array_equal(cnt, ref[1])
    assert list(pm._torch_compiled[1]) == ["cpu"]
    # a mutated map compiles afresh
    pm.touch()
    mapper.map_pgs(1, np.arange(5), 3)
    assert pm._torch_compiled[0] == pm.mutation


def test_mesh_batch_do_rule_product_dispatch(maps, forced_mesh):
    _jm, _jcm, _pm, cm = maps
    xs = np.arange(37)
    forced_mesh.setenv("CEPH_TPU_MESH", "0")
    calls = kernel_stats().dump().get("l_tpu_mesh_crush_calls", 0)
    res_off, cnt_off = mesh_batch_do_rule(cm, 0, xs, 3)
    assert kernel_stats().dump().get("l_tpu_mesh_crush_calls", 0) == calls
    meshmod._reset_default_mesh_for_tests()
    forced_mesh.setenv("CEPH_TPU_MESH", "1")
    res_on, cnt_on = mesh_batch_do_rule(cm, 0, xs, 3)
    assert kernel_stats().dump()["l_tpu_mesh_crush_calls"] == calls + 1
    assert np.array_equal(res_off, res_on) and np.array_equal(cnt_off, cnt_on)


# -- sharded EC encode ------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 13, 64 + 3])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 8])
def test_sharded_ec_encode_byte_identity_ragged(jax_mesh, batch, n_dev):
    mat = gf.reed_sol_vandermonde_coding_matrix(4, 2, 8)
    bm = matrix_to_device_bitmatrix(mat, 8, "cpu")
    stripes = np.random.default_rng(7).integers(0, 256, size=(batch, 4, 512), dtype=np.uint8)
    ref = gf_matrix_stripes(bm, torch.from_numpy(stripes), w=8).numpy()
    out = meshmod.sharded_matrix_stripes(bm, stripes, 8, cpu_mesh(n_dev))
    assert out.dtype == np.uint8 and np.array_equal(ref, out)
    jout = j_mesh.sharded_matrix_stripes(
        j_bitmatrix(j_gf.reed_sol_vandermonde_coding_matrix(4, 2, 8), 8), stripes, 8, jax_mesh
    )
    assert np.array_equal(out, jout)


def test_sharded_ec_encode_other_word_size(jax_mesh):
    """w=16 takes the plain route on each shard, as the JAX package's
    XLA function does on its mesh."""
    mat = gf.reed_sol_vandermonde_coding_matrix(3, 2, 16)
    stripes = np.random.default_rng(9).integers(0, 256, size=(11, 3, 256), dtype=np.uint8)
    out = meshmod.sharded_matrix_stripes(matrix_to_device_bitmatrix(mat, 16, "cpu"), stripes,
                                         16, cpu_mesh(3))
    jout = j_mesh.sharded_matrix_stripes(
        j_bitmatrix(j_gf.reed_sol_vandermonde_coding_matrix(3, 2, 16), 16), stripes, 16, jax_mesh
    )
    assert np.array_equal(out, jout)


def test_per_device_telemetry_counters(maps, jax_mesh):
    """One sharded dispatch adds one call a mesh entry and its bytes,
    plus the group rollup, under the JAX package's counter names."""
    _jm, jcm, _pm, cm = maps
    ks, jks = kernel_stats(), j_kernel_stats()
    before = ks.dump()
    sharded_batch_do_rule(cm, 0, np.arange(37), 3, dmesh=cpu_mesh(8))
    dump = ks.dump()
    assert dump["l_tpu_mesh_crush_calls"] == before.get("l_tpu_mesh_crush_calls", 0) + 1
    for i in range(8):
        name = f"l_tpu_mesh_dev{i}_calls"
        assert dump[name] == before.get(name, 0) + 1, name
        assert dump[f"l_tpu_mesh_dev{i}_bytes"] > before.get(f"l_tpu_mesh_dev{i}_bytes", 0)
    meshmod.sharded_matrix_stripes(
        matrix_to_device_bitmatrix(gf.reed_sol_vandermonde_coding_matrix(4, 2, 8), 8, "cpu"),
        np.zeros((16, 4, 64), np.uint8), 8, cpu_mesh(8),
    )
    j_sharded(jcm, 0, np.arange(37), 3, dmesh=jax_mesh)
    j_mesh.sharded_matrix_stripes(
        j_bitmatrix(j_gf.reed_sol_vandermonde_coding_matrix(4, 2, 8), 8),
        np.zeros((16, 4, 64), np.uint8), 8, jax_mesh,
    )
    names = {k for k in ks.dump() if k.startswith("l_tpu_mesh_")}
    assert names == {k for k in jks.dump() if k.startswith("l_tpu_mesh_")}
    assert ks.dump()["l_tpu_mesh_dev7_bytes"] - dump["l_tpu_mesh_dev7_bytes"] == 16 * 4 * 64 // 8


# -- product routing through a default mesh ---------------------------------


def test_torch_backend_routes_through_the_default_mesh(forced_mesh):
    """The port's stripe encode shards across the default mesh when one
    exists (and the batch has a stripe a mesh entry): the same shards
    as without it and as the JAX package's, and the dispatch lands in
    the mesh counters."""
    from ceph_tpu.ec import ErasureCodeProfile as JProfile
    from ceph_tpu.ec import registry_instance as j_registry
    from ceph_tpu.ec.stripe import StripeInfo as JStripeInfo
    from ceph_tpu.ec.stripe import encode as j_stripe_encode
    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
    from ceph_tpu_torch.ec.stripe import StripeInfo
    from ceph_tpu_torch.ec.stripe import encode as stripe_encode

    ec = registry_instance().factory("jerasure", ErasureCodeProfile({"k": "2", "m": "1"},
                                                                    device="cpu"))
    sinfo = StripeInfo(2, 2 * ec.get_chunk_size(2 * 1024))
    data = np.arange(11 * sinfo.stripe_width, dtype=np.uint8) % 251  # 11: ragged for 8
    forced_mesh.setenv("CEPH_TPU_MESH", "0")
    single = stripe_encode(sinfo, ec, data)
    meshmod._reset_default_mesh_for_tests()
    forced_mesh.setenv("CEPH_TPU_MESH", "1")
    assert meshmod.default_mesh().n == 8
    before = kernel_stats().dump().get("l_tpu_mesh_ec_encode_calls", 0)
    sharded = stripe_encode(sinfo, ec, data)
    assert kernel_stats().dump()["l_tpu_mesh_ec_encode_calls"] > before
    jec = j_registry().factory("jerasure", JProfile({"k": "2", "m": "1", "backend": "jax"}))
    ref = j_stripe_encode(JStripeInfo(2, sinfo.stripe_width), jec, data)
    assert set(single) == set(sharded) == set(ref)
    for i in single:
        assert bytes(single[i]) == bytes(sharded[i]) == bytes(ref[i]), i
    # a batch smaller than the mesh keeps the single-device route
    before = kernel_stats().dump()["l_tpu_mesh_ec_encode_calls"]
    stripe_encode(sinfo, ec, data[: 3 * sinfo.stripe_width])
    assert kernel_stats().dump()["l_tpu_mesh_ec_encode_calls"] == before


def test_osdmap_mapping_routes_through_the_default_mesh(forced_mesh):
    from test_torch_osdmap import JAX, PORT, _assert_arrays_equal, _map, build_cluster

    om, jom = build_cluster(PORT), build_cluster(JAX)
    forced_mesh.setenv("CEPH_TPU_MESH", "0")
    single = _map(PORT, om)
    meshmod._reset_default_mesh_for_tests()
    forced_mesh.setenv("CEPH_TPU_MESH", "1")
    forced_mesh.setenv("CEPH_TPU_MESH_DEVICES", "3")
    before = kernel_stats().dump().get("l_tpu_mesh_crush_calls", 0)
    sharded = _map(PORT, om)
    assert kernel_stats().dump()["l_tpu_mesh_crush_calls"] == before + len(om.pools)
    _assert_arrays_equal(sharded, single, om)
    _assert_arrays_equal(sharded, _map(JAX, jom, use_device=False), om)
    # compiled once for the mesh's one distinct device
    assert list(om.crush._torch_compiled[1]) == ["cpu"]


def test_mesh_serves_only_its_own_devices():
    cards = meshmod.DeviceMesh(["cuda:0", "cuda:1"])
    assert cards.serves("cuda:1") and cards.serves("cuda")
    assert not cards.serves("cuda:2") and not cards.serves("cpu")
    assert meshmod.DeviceMesh(["cpu"] * 4).serves("cpu")


def test_a_device_outside_the_default_mesh_keeps_its_single_route(monkeypatch):
    """A backend or a mapping pinned to a device the default mesh does
    not hold (here ``cpu:1`` beside a mesh of ``cpu:0`` entries, as
    ``cuda:1`` beside a mesh of ``cuda:0``) keeps its single-device
    route; one pinned to a mesh entry shards."""
    from test_torch_osdmap import PORT, _assert_arrays_equal, build_cluster

    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
    from ceph_tpu_torch.ec.stripe import StripeInfo
    from ceph_tpu_torch.ec.stripe import encode as stripe_encode
    from ceph_tpu_torch.osd import OSDMapMapping

    meshmod._reset_default_mesh_for_tests()
    monkeypatch.setattr(meshmod, "available_devices", lambda: [torch.device("cpu", 0)] * 4)
    monkeypatch.setenv("CEPH_TPU_MESH", "1")
    try:
        assert meshmod.default_mesh().n == 4

        def encode_on(device):
            ec = registry_instance().factory(
                "jerasure", ErasureCodeProfile({"k": "2", "m": "1"}, device=device))
            sinfo = StripeInfo(2, 2 * ec.get_chunk_size(2 * 1024))
            data = np.arange(9 * sinfo.stripe_width, dtype=np.uint8) % 251
            before = kernel_stats().dump().get("l_tpu_mesh_ec_encode_calls", 0)
            shards = stripe_encode(sinfo, ec, data)
            sharded = kernel_stats().dump().get("l_tpu_mesh_ec_encode_calls", 0) > before
            return {i: bytes(v) for i, v in shards.items()}, sharded

        outside, outside_sharded = encode_on("cpu:1")
        inside, inside_sharded = encode_on("cpu:0")
        assert not outside_sharded and inside_sharded and outside == inside

        def map_on(device):
            om = build_cluster(PORT)
            before = kernel_stats().dump().get("l_tpu_mesh_crush_calls", 0)
            mapping = OSDMapMapping(device=device)
            mapping.update(om)
            return om, mapping, kernel_stats().dump().get("l_tpu_mesh_crush_calls", 0) - before

        om, outside_map, outside_calls = map_on("cpu:1")
        _om, inside_map, inside_calls = map_on("cpu:0")
        assert outside_calls == 0 and inside_calls == len(om.pools)
        _assert_arrays_equal(outside_map, inside_map, om)
    finally:
        meshmod._reset_default_mesh_for_tests()


# -- the dryrun's step ------------------------------------------------------


def _jax_step(n):
    """The JAX dryrun's step (__graft_entry__.dryrun_multichip) on the
    conftest's virtual mesh: parity and checksum."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ceph_tpu.ops.gf_matmul import gf_matrix_stripes as j_stripes

    sd, bd = mesh_dryrun.mesh_axes(n)
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(sd, bd), ("stripe", "byte"))
    matrix = j_gf.reed_sol_vandermonde_coding_matrix(4, 2, 8)
    stripes = np.random.default_rng(0).integers(0, 256, size=(2 * sd, 4, 256 * bd), dtype=np.uint8)
    data_spec = NamedSharding(mesh, P("stripe", None, "byte"))
    repl = NamedSharding(mesh, P())

    def step(bm, s):
        parity = j_stripes(bm, s, w=8)
        return parity, jnp.sum(parity.astype(jnp.uint32)) + jnp.sum(s.astype(jnp.uint32))

    parity, checksum = jax.jit(step, in_shardings=(repl, data_spec),
                               out_shardings=(data_spec, repl))(
        jax.device_put(j_bitmatrix(matrix, 8), repl), jax.device_put(jnp.asarray(stripes), data_spec)
    )
    return np.asarray(parity), int(checksum)


@pytest.mark.parametrize("n", [3, 8])
def test_dryrun_step_over_the_port_mesh(n):
    out = mesh_dryrun.step(cpu_mesh(n))
    assert out["errors"] == 0 and out["pgs"] == 4 * n + 3
    parity, checksum = _jax_step(n)
    assert np.array_equal(out["parity"], parity) and out["checksum"] == checksum
    res, counts = out["placement"]
    assert res.shape == (4 * n + 3, 3) and (counts == 3).all()
