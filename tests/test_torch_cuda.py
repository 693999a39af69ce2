"""ceph_tpu_torch's CUDA kernels on the card: K1 and K2 against their
plain versions (exactly: GF arithmetic has no rounding) and the numpy
oracle, and the registry path on
``device="cuda"``: jerasure and isa, the layered plugins (equal to
``device="cpu"``), ``ec_benchmark`` over them, and ECCodec's batch
routes with their K2 launch counts; the CRUSH mapper's hash,
``crush_ln`` and raw output on ``cuda`` against ``cpu``; the store plane:
``DeviceBuf`` on the card, the crc at 64 MiB against the host C crc,
resident scrub and compare with no upload, ``ECStore`` on ``cuda``
against ``cpu``.  Marked
``cuda``: skips where there is no GPU.  On a
card (whose Python has no JAX, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu_torch import gf
from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
from ceph_tpu_torch.ops import _build, bitplane_gf, packed_gf
from ceph_tpu_torch.ops.gf_matmul import matrix_to_device_bitmatrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("k,m,b,chunk", [(8, 3, 1, 4100), (4, 2, 3, 4096), (32, 32, 2, 1024)])
def test_kernels_match_plain(cuda, k, m, b, chunk):
    mat = gf.reed_sol_vandermonde_coding_matrix(k, m, 8)
    bm = matrix_to_device_bitmatrix(mat, 8, cuda)
    host = np.random.default_rng(k).integers(0, 256, (b, k, chunk), dtype=np.uint8)
    x = torch.from_numpy(host).to(cuda)
    want = bitplane_gf.gf8_bitplane_plain(bm, x)
    for got in (packed_gf.packed_matrix_stripes(bm, x), bitplane_gf.gf8_bitplane_stripes(bm, x)):
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    np.testing.assert_array_equal(
        want[0].cpu().numpy(), gf.matrix_vector_mul_region(mat, host[0], 8)
    )


def test_registry_path_on_the_card(cuda):
    ec = registry_instance().factory(
        "isa", ErasureCodeProfile(k="8", m="3", device="cuda")
    )
    data = np.random.default_rng(3).integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    before = packed_gf.launches
    enc = ec.encode(set(range(11)), data)
    avail = {i: c for i, c in enc.items() if i not in (1, 9)}
    assert ec.decode_concat(avail)[: len(data)].tobytes() == data
    assert packed_gf.launches > before


def _k1_equals_plain(bm, x):
    got = packed_gf.packed_matrix_stripes(bm, x)
    torch.cuda.synchronize()
    assert torch.equal(got, packed_gf.packed_stripes_plain(bm, x))
    return got


def _stripes(cuda, shape, seed):
    host = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return torch.from_numpy(host).to(cuda)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 32])
@pytest.mark.parametrize("k", [4, 8, 10, 32])
def test_k1_matches_plain_across_shapes(cuda, k, m):
    bm = matrix_to_device_bitmatrix(gf.reed_sol_vandermonde_coding_matrix(k, m, 8), 8, cuda)
    for chunk in (4, 12, 4096, 4100, 131072):
        _k1_equals_plain(bm, _stripes(cuda, (2, k, chunk), k * 100 + m + chunk))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 32])
def test_k1_sixteen_byte_variant_matches_plain(cuda, m):
    # 16-byte aligned rows: K1 takes 4 words a thread, for one stripe too
    k = 10
    bm = matrix_to_device_bitmatrix(gf.reed_sol_vandermonde_coding_matrix(k, m, 8), 8, cuda)
    for b in (1, 64):
        x = _stripes(cuda, (b, k, 65536), m + b)
        got = _k1_equals_plain(bm, x)
        assert _build.words_per_thread(x, got) == 4


@pytest.mark.parametrize("m,kernels", [(3, 1), (8, 1), (9, 2), (16, 1), (20, 2)])
def test_k1_counts_each_kernel_launch(cuda, m, kernels):
    # m > 8: the groups of eight rows in one launch, the rest in another
    bm = matrix_to_device_bitmatrix(gf.reed_sol_vandermonde_coding_matrix(8, m, 8), 8, cuda)
    before = packed_gf.launches
    _k1_equals_plain(bm, _stripes(cuda, (2, 8, 4096), m))
    assert packed_gf.launches - before == kernels


def test_k1_misaligned_and_strided_views(cuda):
    k, m = 8, 3
    mat = gf.reed_sol_vandermonde_coding_matrix(k, m, 8)
    bm = matrix_to_device_bitmatrix(mat, 8, cuda)
    base = _stripes(cuda, (64, k, 65536 + 4), 7)
    offset = base[:, :, 4:]  # rows start 4 bytes past a 16-byte boundary
    got = _k1_equals_plain(bm, offset)
    assert _build.words_per_thread(offset, got) == 1
    wide = _stripes(cuda, (128, k, 65536), 8)
    _k1_equals_plain(bm, wide[::2])
    for tail in (4, 8, 12):  # chunk % 16 != 0: one word a thread
        x = _stripes(cuda, (64, k, 65536 + tail), tail)
        got = _k1_equals_plain(bm, x)
        assert _build.words_per_thread(x, got) == 1
    np.testing.assert_array_equal(
        got[5].cpu().numpy(), gf.matrix_vector_mul_region(mat, x[5].cpu().numpy(), 8)
    )


def test_k1_decoding_matrix(cuda):
    k, m = 8, 3
    enc = gf.reed_sol_vandermonde_coding_matrix(k, m, 8)
    dec = gf.make_decoding_matrix(enc, [1, 6], k, 8)[0]
    bm = matrix_to_device_bitmatrix(dec, 8, cuda)
    for shape in ((1, k, 131072), (64, k, 65536)):
        x = _stripes(cuda, shape, shape[0])
        got = _k1_equals_plain(bm, x)
    np.testing.assert_array_equal(
        got[3].cpu().numpy(), gf.matrix_vector_mul_region(dec, x[3].cpu().numpy(), 8)
    )


def test_k1_refused_launch_raises(cuda):
    bm = matrix_to_device_bitmatrix(gf.reed_sol_vandermonde_coding_matrix(4, 2, 8), 8, cuda)
    base = _stripes(cuda, (1, 4, 4097), 9)
    out = torch.empty((1, 2, 4096), dtype=torch.uint8, device=cuda)
    # rows one byte off a word boundary: the C entry refuses, the wrapper raises
    with pytest.raises(RuntimeError, match="gf8_packed_stripes launch failed"):
        _build.launch_stripes("gf8_packed_stripes", bm, base[:, :, 1:], out)
    with pytest.raises(ValueError):
        packed_gf.packed_matrix_stripes(bm, base[:, :, 1:])
    wide = torch.zeros((8, 33 * 8), dtype=torch.uint8, device=cuda)  # k = 33
    with pytest.raises(RuntimeError, match="gf8_packed_stripes launch failed"):
        _build.launch_stripes(
            "gf8_packed_stripes", wide, _stripes(cuda, (1, 33, 64), 10),
            torch.empty((1, 1, 64), dtype=torch.uint8, device=cuda),
        )


def _k2_equals_plain(bm, x):
    got = bitplane_gf.gf8_bitplane_stripes(bm, x)
    torch.cuda.synchronize()
    assert torch.equal(got, bitplane_gf.gf8_bitplane_plain(bm, x))
    return got


@pytest.mark.parametrize("m", [1, 3, 8, 9, 32])
@pytest.mark.parametrize("k", [4, 8, 40])
def test_k2_matches_plain_across_shapes(cuda, k, m):
    bm = matrix_to_device_bitmatrix(gf.reed_sol_vandermonde_coding_matrix(k, m, 8), 8, cuda)
    for chunk in (1, 3, 4, 12, 4100, 131072):
        x = _stripes(cuda, (2, k, chunk), k * 100 + m + chunk)
        got = _k2_equals_plain(bm, x)
        assert _build.words_per_thread(x, got) == (4 if chunk % 16 == 0 else 1)


def test_k2_offset_and_strided_views(cuda):
    k, m = 8, 3
    mat = gf.reed_sol_vandermonde_coding_matrix(k, m, 8)
    bm = matrix_to_device_bitmatrix(mat, 8, cuda)
    for offset in (1, 2, 4):  # rows 1, 2 and 4 bytes past a 16-byte boundary
        for chunk in (65536, 4097):
            base = _stripes(cuda, (16, k, chunk + offset), offset * chunk)
            x = base[:, :, offset:]
            got = _k2_equals_plain(bm, x)
            assert _build.words_per_thread(x, got) == 1
    np.testing.assert_array_equal(
        got[5].cpu().numpy(), gf.matrix_vector_mul_region(mat, x[5].cpu().numpy(), 8)
    )
    wide = _stripes(cuda, (128, k, 65536), 8)
    got = _k2_equals_plain(bm, wide[::2])
    assert _build.words_per_thread(wide[::2], got) == 4
    _k2_equals_plain(bm, _stripes(cuda, (32, k, 4101), 11)[::2, :, 1:])


def test_k2_decoding_matrix_and_widest_code(cuda):
    enc = gf.reed_sol_vandermonde_coding_matrix(8, 3, 8)
    dec = gf.make_decoding_matrix(enc, [1, 6], 8, 8)[0]
    x = _stripes(cuda, (64, 8, 65536), 12)
    got = _k2_equals_plain(matrix_to_device_bitmatrix(dec, 8, cuda), x)
    np.testing.assert_array_equal(
        got[7].cpu().numpy(), gf.matrix_vector_mul_region(dec, x[7].cpu().numpy(), 8)
    )
    # k + m = 256, as far as GF(2^8) goes
    wide = gf.reed_sol_vandermonde_coding_matrix(128, 128, 8)
    _k2_equals_plain(matrix_to_device_bitmatrix(wide, 8, cuda), _stripes(cuda, (2, 128, 4100), 13))


@pytest.mark.parametrize("k,m,rows,kernels", [(8, 3, 3, 1), (8, 8, 8, 1), (8, 9, 8, 2),
                                              (8, 32, 8, 4), (128, 128, 8, 16), (1000, 9, 7, 2)])
def test_k2_counts_each_kernel_launch(cuda, k, m, rows, kernels):
    # at most eight rows a launch, fewer where k*8 rep words a row crowd
    # shared memory (k = 1000: seven rows)
    bm = _stripes(cuda, (m * 8, k * 8), k + m) & 1
    assert bitplane_gf.rows_per_launch(k, m) == rows
    before = bitplane_gf.launches
    _k2_equals_plain(bm, _stripes(cuda, (2, k, 260), m))
    assert bitplane_gf.launches - before == kernels


def test_k2_refused_launch_raises(cuda):
    k = 7265  # one row's rep table, k*8 words, exceeds shared memory
    bm = torch.zeros((8, k * 8), dtype=torch.uint8, device=cuda)
    x = _stripes(cuda, (1, k, 8), 14)
    assert bitplane_gf.rows_per_launch(k, 1) == 0
    with pytest.raises(RuntimeError, match="gf8_bitplane_stripes launch failed"):
        _build.launch_stripes(
            "gf8_bitplane_stripes", bm, x, torch.empty((1, 1, 8), dtype=torch.uint8, device=cuda)
        )
    before = bitplane_gf.launches
    with pytest.raises(ValueError):
        bitplane_gf.gf8_bitplane_stripes(bm, x)
    assert bitplane_gf.launches == before
    assert bitplane_gf.rows_per_launch(7264, 3) == 1


LAYERED = [
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("clay", {"k": "4", "m": "2", "d": "5"}),
    ("clay", {"k": "4", "m": "2", "d": "5", "scalar_mds": "isa"}),
]


@pytest.mark.parametrize("plugin,prof", LAYERED, ids=["lrc", "shec", "clay", "clay-isa"])
def test_layered_plugins_on_the_card_equal_the_cpu(cuda, plugin, prof):
    import itertools

    from ceph_tpu_torch.ec import ErasureCodeError

    on_card = registry_instance().factory(plugin, ErasureCodeProfile(prof, device="cuda"))
    on_cpu = registry_instance().factory(plugin, ErasureCodeProfile(prof, device="cpu"))
    n = on_card.get_chunk_count()
    data = np.random.default_rng(n).integers(0, 256, 3 * on_cpu.get_chunk_size(1) * on_cpu.k,
                                             dtype=np.uint8).tobytes()
    before = packed_gf.launches + bitplane_gf.launches
    got = on_card.encode(set(range(n)), data)
    assert packed_gf.launches + bitplane_gf.launches > before
    want = on_cpu.encode(set(range(n)), data)
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i])
    for e in (1, 2):
        for erased in itertools.combinations(range(n), e):
            avail = {i: c for i, c in want.items() if i not in erased}
            try:
                ref = on_cpu._decode(set(erased), dict(avail))
            except ErasureCodeError:
                with pytest.raises(ErasureCodeError):
                    on_card._decode(set(erased), dict(avail))
                continue
            dec = on_card._decode(set(erased), dict(avail))
            for i in erased:
                np.testing.assert_array_equal(dec[i], ref[i])
                np.testing.assert_array_equal(dec[i], want[i])


def test_eccodec_batch_routes_launch_k2_per_group(cuda):
    from ceph_tpu_torch.osd.ec_pg import ECCodec

    codec = ECCodec({"plugin": "isa", "k": "8", "m": "3", "device": "cuda"})
    assert codec.sinfo.chunk_size == 4096
    rng = np.random.default_rng(5)
    datas = [rng.integers(0, 256, n * codec.sinfo.stripe_width, dtype=np.uint8).tobytes()
             for n in (100, 200, 300)]
    before = bitplane_gf.launches
    got = codec.encode_object_batch(datas)
    # greedy groups of at most 256 stripes, an object never split: 100,
    # then 200, then 300; one K2 launch each (m=3 rows fit one launch)
    assert bitplane_gf.launches - before == 3
    for d, g in zip(datas, got):
        assert g == codec.encode_object(d)
    survivors = [{p: s for p, s in shards.items() if p not in (1, 9)} for shards, _ in got]
    before = bitplane_gf.launches
    rec = codec.decode_object_batch(survivors, {1, 9})
    assert bitplane_gf.launches - before == 3
    for r, (shards, _) in zip(rec, got):
        assert r[1].tobytes() == shards[1] and r[9].tobytes() == shards[9]


@pytest.mark.parametrize("plugin,params", [
    ("lrc", ["k=8", "m=4", "l=6"]),
    ("shec", ["k=8", "m=4", "c=2"]),
    ("clay", ["k=8", "m=4", "d=11"]),
])
def test_ec_benchmark_runs_the_layered_plugins_on_the_card(cuda, plugin, params, capsys):
    from ceph_tpu_torch.tools import ec_benchmark

    args = ["-p", plugin, "-s", str(1 << 16), "--device", "cuda"]
    for p in params:
        args += ["-P", p]
    before = packed_gf.launches + bitplane_gf.launches
    assert ec_benchmark.main(args + ["-w", "encode", "-i", "2"]) == 0
    assert ec_benchmark.main(args + ["-w", "decode", "-E", "exhaustive", "-e", "1"]) == 0
    assert packed_gf.launches + bitplane_gf.launches > before
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split("\t")[1] for line in lines] == ["128", "64"]


# -- CRUSH: the batched mapper on the card against the CPU ----------------


def _crush_maps():
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    return {
        "flat": build_hierarchy(12, 12),
        "hosts": build_hierarchy(64, 4),
        "racks": build_hierarchy(600, 10, 6),
    }


def _mixed_weights(n, seed):
    rng = np.random.default_rng(seed)
    w = np.full(n, 0x10000, dtype=np.int64)
    w[rng.choice(n, max(1, n // 6), replace=False)] = 0
    w[rng.choice(n, max(1, n // 5), replace=False)] = 0x8000
    return w


def test_crush_hash_and_ln_on_the_card(cuda):
    from ceph_tpu_torch.crush import hashing, ln, torchmap

    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, 1 << 32, 4096, dtype=np.uint64) for _ in range(3))
    t = [torch.from_numpy(v.astype(np.uint32).view(np.int32)).to(cuda) for v in (a, b, c)]
    got3 = torchmap.hash3(*t).cpu().numpy().view(np.uint32)
    got2 = torchmap.hash2(t[0], t[1]).cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(got3, hashing.crush_hash32_3(a, b, c))
    np.testing.assert_array_equal(got2, hashing.crush_hash32_2(a, b))
    rh, lh, ll = (torch.from_numpy(v).to(cuda) for v in ln._tables())
    us = torch.arange(0x10000, device=cuda)
    got = torchmap.crush_ln(us, rh, lh, ll).cpu().numpy()
    np.testing.assert_array_equal(got, ln.crush_ln(np.arange(0x10000, dtype=np.uint32)))


@pytest.mark.parametrize("name", ["flat", "hosts", "racks"])
@pytest.mark.parametrize("rule,rmax", [(0, 3), (0, 5), (1, 4), (1, 6)])
@pytest.mark.parametrize("mixed", [False, True], ids=["full", "mixed"])
def test_crush_raw_output_on_the_card_equals_cpu(cuda, name, rule, rmax, mixed):
    from ceph_tpu_torch.crush import torchmap

    m = _crush_maps()[name]
    w = _mixed_weights(m.max_devices, 3) if mixed else None
    card = torchmap.compile_map(m)
    assert all(
        v.device.type == "cuda" for v in vars(card).values() if isinstance(v, torch.Tensor)
    )
    cpu = torchmap.compile_map(m, device="cpu")
    xs = np.arange(2048)
    got = torchmap.batch_do_rule_raw(card, rule, xs, rmax, w)
    want = torchmap.batch_do_rule_raw(cpu, rule, xs, rmax, w)
    for g, v in zip(got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), v)


@pytest.mark.parametrize("rule,rmax", [(0, 3), (1, 6)])
def test_crush_packed_range_equals_unpacked(cuda, rule, rmax):
    from ceph_tpu_torch.crush import torchmap

    m = _crush_maps()["racks"]
    w = _mixed_weights(m.max_devices, 8)
    cm = torchmap.compile_map(m)
    lo, n = 1000, 4096
    xs = np.arange(lo, lo + n)
    packed = torchmap.batch_do_rule_range(cm, rule, lo, n, rmax, w, packed=True)
    plain = torchmap.batch_do_rule_range(cm, rule, lo, n, rmax, w)
    assert packed[0].dtype == torch.int16 and packed[1].dtype == torch.uint8
    a = torchmap.apply_oracle_fallback(cm, rule, xs, *packed, rmax, w)
    b = torchmap.apply_oracle_fallback(cm, rule, xs, *plain, rmax, w)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    for i in range(0, n, 97):
        assert a[0][i, : a[1][i]].tolist() == m.do_rule(rule, int(xs[i]), rmax, list(w))


# -- the store data plane -------------------------------------------------------


def test_devicebuf_on_the_card(cuda):
    from ceph_tpu_torch.ops.residency import DeviceBuf

    data = np.random.default_rng(4).integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    buf = DeviceBuf(data=data)
    dev = buf.device()
    assert dev.is_cuda and buf.resident and buf.device() is dev
    assert buf.host() == data and np.asarray(buf).tobytes() == data
    born = DeviceBuf(dev=dev[:100].clone())
    assert born.torch_device.type == "cuda" and born.host() == data[:100]


def test_crc_on_the_card_equals_host_crc_at_64_mib(cuda):
    from ceph_tpu_torch.native import ceph_crc32c
    from ceph_tpu_torch.ops.scrub_kernels import GOLDEN_VECTORS, batch_crc32c

    rng = np.random.default_rng(64)
    bufs = [rng.integers(0, 256, (4 << 20) - 7 * i, dtype=np.uint8).tobytes()
            for i in range(16)]
    got = batch_crc32c(bufs, 0xFFFFFFFF)
    assert [int(c) for c in got] == [ceph_crc32c(0xFFFFFFFF, b) for b in bufs]
    for init, payload, want in GOLDEN_VECTORS:
        assert batch_crc32c([payload], init)[0] == want


def test_resident_scrub_and_compare_on_the_card_upload_nothing(cuda):
    from ceph_tpu_torch.native import ceph_crc32c
    from ceph_tpu_torch.ops.profiler import dispatch_profiler
    from ceph_tpu_torch.ops.residency import DeviceBuf
    from ceph_tpu_torch.ops.scrub_kernels import batch_compare, batch_crc32c

    rng = np.random.default_rng(5)
    raws = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (5000, 4096, 1, 70001)]
    bufs = [DeviceBuf(data=r) for r in raws]
    for b in bufs:
        b.device()
    before = dispatch_profiler().totals()
    got = batch_crc32c(bufs, 7)
    assert [int(c) for c in got] == [ceph_crc32c(7, r) for r in raws]
    flipped = [r[:-1] + bytes([r[-1] ^ 1]) if i % 2 else r for i, r in enumerate(raws)]
    assert list(batch_compare(bufs, flipped)) == [False, True, False, True]
    after = dispatch_profiler().totals()
    assert after["crc32c"]["bytes_uploaded"] == before.get("crc32c", {}).get(
        "bytes_uploaded", 0)
    assert after["crc32c"]["bytes_resident"] - before.get("crc32c", {}).get(
        "bytes_resident", 0) == sum(map(len, raws))


def test_ecstore_on_the_card(cuda):
    """put, scrub_batch (residency hits), corruption flagged, a dead
    position rebuilt in one batched decode, degraded reads: K1 and K2
    launched, every byte equal to device=cpu."""
    from ceph_tpu_torch.ops.residency import residency_cache
    from ceph_tpu_torch.store import ECStore

    prof = {"k": "4", "m": "2"}
    card = ECStore(plugin="isa", profile={**prof, "device": "cuda"})
    cpu = ECStore(plugin="isa", profile={**prof, "device": "cpu"})
    rng = np.random.default_rng(9)
    datas = {f"o{i}": rng.integers(0, 256, (1 << 18) + 333 * i, dtype=np.uint8).tobytes()
             for i in range(6)}
    k1, k2 = packed_gf.launches, bitplane_gf.launches
    for st in (card, cpu):
        for name, data in datas.items():
            st.put(name, data)
    names = list(datas)
    hits = residency_cache().stats()["hits"]
    assert all(r.clean for r in card.scrub_batch(names).values())
    assert residency_cache().stats()["hits"] >= hits + 6 * card.n
    card.corrupt_shard("o2", 3)
    assert card.scrub_batch(names)["o2"].corrupt == [3]
    card.recover_shard("o2", 3)
    for st in (card, cpu):
        for name in names:
            st.lose_shard(name, 1)
    stats = card.recover_objects_batch(names, 1)
    assert stats["batched"] == len(names)
    cpu.recover_objects_batch(names, 1)
    for name in names:
        for pos in range(card.n):
            assert card.stores[pos].read(card.cid, name) == cpu.stores[pos].read(cpu.cid, name)
    assert all(r.clean for r in card.scrub_batch(names).values())
    for name in names:
        card.lose_shard(name, 0)
        assert card.get(name) == datas[name]
    assert packed_gf.launches > k1 and bitplane_gf.launches > k2
