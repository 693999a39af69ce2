"""ceph_tpu_torch's CUDA kernels on the card: K1 and K2 against their
plain versions (exactly: GF arithmetic has no rounding) and the numpy
oracle, and the registry path on
``device="cuda"``: jerasure and isa, the layered plugins (equal to
``device="cpu"``), ``ec_benchmark`` over them, and ECCodec's batch
routes with their K2 launch counts; the CRUSH mapper's hash,
``crush_ln`` and raw output on ``cuda`` against ``cpu`` (the benchmark's
10,000-OSD map among the maps), the straw2 draw kernel against the plain
draw on the CPU bit for bit, with its launch counts, and lrc's two-step
rule on that map against the oracle; the store plane:
``DeviceBuf`` on the card, the crc at 64 MiB against the host C crc,
resident scrub and compare with no upload, ``ECStore`` on ``cuda``
against ``cpu``; the durable stores: ``build_scrub_map`` over BlockStore
media and the WAL's replay verify on ``cuda`` against ``cpu`` and the
host C crc; port clusters (monitor, ``OSD(device="cuda")``, librados) of
a replicated and an EC pool against the same on ``cpu``; a process
cluster (a monitor and 3 OSD processes on ``cuda``) whose reads equal
the same cluster's on ``cpu``; an rbd image on an EC pool of
``OSD(device="cuda")`` whose shards and reads equal the same on
``cpu``; a ``["cuda:0"] * 4`` mesh's sharded encode and placement
against the single device; program spans on kineto's clock, and every
host wait of a remap-sized OSD-map update counted.  Marked
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


# -- CRUSH's legacy algorithms and choose_args, and the OSD map, on the card ----


def _legacy_card_maps():
    from ceph_tpu_torch.crush.types import (
        CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_TREE, CRUSH_BUCKET_UNIFORM,
        ChooseArg,
    )
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    maps = {name: build_hierarchy(96, 4, 4, host_alg=alg) for name, alg in (
        ("straw", CRUSH_BUCKET_STRAW), ("list", CRUSH_BUCKET_LIST),
        ("tree", CRUSH_BUCKET_TREE), ("uniform", CRUSH_BUCKET_UNIFORM))}
    for name, positions in (("choose_args1", 1), ("choose_args2", 2)):
        m = build_hierarchy(96, 4, 4)
        rng = np.random.default_rng(positions)
        m.set_choose_args({
            bid: ChooseArg(weight_set=[[int(w) for w in rng.integers(0x4000, 0x20000, b.size)]
                                       for _ in range(positions)])
            for bid, b in m.buckets.items() if b.type == 1
        })
        maps[name] = m
    return maps


@pytest.mark.parametrize("name", ["straw", "list", "tree", "uniform", "choose_args1",
                                  "choose_args2"])
@pytest.mark.parametrize("rule,rmax", [(0, 3), (1, 6)])
def test_crush_legacy_and_choose_args_on_the_card_equal_cpu(cuda, name, rule, rmax):
    from ceph_tpu_torch.crush import torchmap

    m = _legacy_card_maps()[name]
    w = _mixed_weights(m.max_devices, 4)
    card, cpu = torchmap.compile_map(m), torchmap.compile_map(m, device="cpu")
    xs = np.arange(4096)
    got = torchmap.batch_do_rule_raw(card, rule, xs, rmax, w)
    want = torchmap.batch_do_rule_raw(cpu, rule, xs, rmax, w)
    for g, v in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), v)
    res, counts = torchmap.apply_oracle_fallback(card, rule, xs, *got, rmax, w)
    for i in range(0, len(xs), 131):
        assert res[i, : counts[i]].tolist() == m.do_rule(rule, int(xs[i]), rmax, list(w))


@pytest.mark.parametrize("name,rule", [(n, 1) for n in ("straw", "list", "tree", "uniform",
                                                          "choose_args1", "choose_args2")]
                         + [("choose_args2", 0)])
def test_recorded_chooser_blocks_on_the_card_equal_cpu(cuda, name, rule):
    """A generic chooser over GRAPH_LANES lanes replays its recorded
    blocks (CUDA graphs) on the card, on every bucket algorithm: the raw
    output equals the CPU's dropping loop, and a second reweight vector
    through the same blocks equals the CPU's too."""
    from ceph_tpu_torch.crush import torchmap

    m = _legacy_card_maps()[name]
    card, cpu = torchmap.compile_map(m), torchmap.compile_map(m, device="cpu")
    xs = np.arange(torchmap.GRAPH_LANES)
    for seed in (4, 5):
        w = _mixed_weights(m.max_devices, seed)
        got = torchmap.batch_do_rule_raw(card, rule, xs, 6, w)
        want = torchmap.batch_do_rule_raw(cpu, rule, xs, 6, w)
        for g, v in zip(got, want):
            assert torch.equal(g.cpu(), v)
    assert torchmap._block_cache()


@pytest.mark.parametrize("mixed", [False, True], ids=["full", "mixed"])
def test_lrc_chained_rule_on_the_card_equals_the_oracle(cuda, mixed):
    """lrc's rack-local rule (k=4 m=2 l=3: choose indep 2 type rack, then
    chooseleaf indep 4 type host) on the benchmark's 10,000-OSD map:
    2^17 PGs in one call on the card, both steps through the straw2
    kernel in the chooser's recorded blocks (CUDA graphs), against the
    oracle on 2,048 seeded PGs."""
    from ceph_tpu_torch.crush import torchmap

    pm = _bench_map()
    prof = {"k": "4", "m": "2", "l": "3", "crush-locality": "rack"}
    rule = registry_instance().factory("lrc", ErasureCodeProfile(prof, device="cpu")).create_rule(
        "lrc", pm
    )
    w = _mixed_weights(pm.max_devices, 17) if mixed else None
    cm = torchmap.compile_map(pm)
    xs = np.random.default_rng(2**31 + 17).integers(0, 1 << 32, 1 << 17)
    draws, lanes = torchmap.counts["crush_kernel_draws"], torchmap.counts["crush_chained_lanes"]
    res, counts, ok = (t.cpu().numpy() for t in torchmap.batch_do_rule_raw(cm, rule, xs, 8, w))
    assert ok.all() and (counts == 8).all()
    assert torchmap.counts["crush_chained_lanes"] - lanes == 2 << 17
    assert torchmap.counts["crush_kernel_draws"] > draws
    # 2^17 lanes and more replay the chooser's recorded blocks
    assert torchmap._block_cache()
    wl = None if w is None else [int(v) for v in w]
    for i in np.random.default_rng(5).choice(1 << 17, 2048, replace=False):
        assert res[i].tolist() == pm.do_rule(rule, int(xs[i]), 8, wl), int(xs[i])


# -- CRUSH: the straw2 draw kernel against the plain draw on the CPU ------------


def _bench_map():
    """The benchmark's map: 10,000 straw2 OSDs, 4 a host, 20 hosts a
    rack, 2 racks a row, 63 rows under the root; rules 0 (firstn) and 1
    (indep) choose leaves over hosts."""
    from perfbench import maps
    from perfbench.drivers import _program

    return _program.crush_map(maps.hierarchy(10000, [4, 20, 2]))


def _straw2_cols(cm, rows, pos, szi):
    """The (ids, divisors, live) columns ``_Lanes.pick`` hands the plain
    draw for bucket rows ``rows`` at choose_args position ``pos``."""
    one = isinstance(rows, int)

    def cols(t, at=rows):
        return t[at, :szi] if one else t[:, :szi][at]

    if not cm.arg_positions:
        return cols(cm.items32), cols(cm.wdiv), cols(cm.wlive)
    arows = rows
    if pos is not None:
        arows = rows * cm.arg_positions + pos.clamp(0, cm.arg_positions - 1)
    return cols(cm.args_ids32), cols(cm.args_wdiv, arows), cols(cm.args_wlive, arows)


def _kernel_equals_plain_draw(card, cpu, rows, x, r, pos, szi):
    """One kernel launch on ``card`` against the plain draw and pick on
    ``cpu`` (the same map), bit for bit: the winning column and its
    item."""
    from ceph_tpu_torch.crush import torchmap
    from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2

    def on(t):
        return t if t is None or isinstance(t, int) else t.cuda()

    before = torchmap.counts["crush_kernel_draws"]
    col, item = torchmap.straw2_draw_kernel(card, on(rows), on(x), on(r), on(pos), szi, True)
    torch.cuda.synchronize()
    assert torchmap.counts["crush_kernel_draws"] == before + 1
    lanes = torchmap._Lanes(cpu, torch.full((max(cpu.max_devices, 1),), 0x10000))
    want = lanes.draw(x, *_straw2_cols(cpu, rows, pos, szi), r)
    assert col.dtype == torch.int64 and torch.equal(col.cpu(), want)
    want_item, _ = lanes.pick(rows, x, r, pos, szi, (CRUSH_BUCKET_STRAW2,), 1)
    assert torch.equal(item.cpu(), want_item)
    return col.cpu()


def _lanes_x(n, seed):
    """n inputs over the whole int32 range, its ends and -1 among them,
    shaped (n, 1, 1) like the fast path's."""
    x = np.random.default_rng(seed).integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    x[:5] = [-(1 << 31), -1, 0, 1, (1 << 31) - 1]
    return torch.from_numpy(x.astype(np.int32)).view(n, 1, 1)


@pytest.mark.parametrize("level,btype", [("root", 4), ("row", 3), ("rack", 2), ("host", 1)])
def test_straw2_kernel_equals_plain_at_the_cells_shapes(cuda, level, btype):
    """The remap cell's four draw levels over 2^16 lanes x 5 candidates:
    the 63-wide root as one row shared by every lane, then (N, 5) row
    tensors of 2-wide rows, 20-wide racks and 4-wide hosts."""
    from ceph_tpu_torch.crush import torchmap

    m = _bench_map()
    card, cpu = torchmap.compile_map(m), torchmap.compile_map(m, device="cpu")
    n, c = 1 << 16, 5
    x = _lanes_x(n, btype)
    r = torch.arange(c, dtype=torch.int32).view(1, c, 1)
    of_type = np.nonzero(cpu.np_types == btype)[0]
    szi = int(cpu.np_sizes[of_type].max())
    assert szi == {4: 63, 3: 2, 2: 20, 1: 4}[btype]
    if level == "root":
        (rows,) = of_type.tolist()
    else:
        rng = np.random.default_rng(btype)
        rows = torch.from_numpy(rng.choice(of_type, (n, c)).astype(np.int64))
    col = _kernel_equals_plain_draw(card, cpu, rows, x, r, None, szi)
    assert col.shape == (n, c, 1) and len(torch.unique(col)) == szi


def test_straw2_kernel_zero_weights_and_ties(cuda):
    """Zero-weight columns never win while another draws and an all-zero
    row takes column 0; equal draws (one id repeated, equal weights)
    take the first column, like the C's strict ``>``."""
    import dataclasses

    from ceph_tpu_torch.crush import torchmap
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    m = build_hierarchy(48, 4, weight_fn=lambda o: 0 if o % 5 == 0 or 8 <= o < 12 else 0x10000)
    card, cpu = torchmap.compile_map(m), torchmap.compile_map(m, device="cpu")
    hosts = torch.from_numpy(np.nonzero(cpu.np_types == 1)[0])
    n = 4096
    x = _lanes_x(n, 7)
    r = torch.arange(3, dtype=torch.int32).view(1, 3, 1)
    rows = hosts[torch.arange(n * 3) % len(hosts)].view(n, 3)
    col = _kernel_equals_plain_draw(card, cpu, rows, x, r, None, 4)
    dead = cpu.wlive[rows].sum(-1) == 0
    assert dead.any() and (col.squeeze(-1)[dead] == 0).all()
    # ties: every column of every row hashes id 7 and weighs one of the
    # patterns below, the first live maximum winning
    pats = [[3, 3, 3, 3], [0, 3, 3, 3], [0, 0, 5, 5], [0, 0, 0, 0], [1, 2, 2, 1]]
    w = torch.zeros((cpu.nb, cpu.sz), dtype=torch.int64)
    w[: len(pats), :4] = torch.tensor(pats)
    tie = {"items32": torch.full((cpu.nb, cpu.sz), 7, dtype=torch.int32),
           "wdiv": torch.where(w > 0, w, 1), "wlive": w > 0,
           "sizes": torch.full((cpu.nb,), 4, dtype=torch.int64)}
    tcpu = dataclasses.replace(cpu, **tie)
    tcard = dataclasses.replace(card, **{k: v.cuda() for k, v in tie.items()})
    rows = torch.arange(len(pats)).repeat(n, 1)
    r = torch.zeros((1, 1, 1), dtype=torch.int32)
    col = _kernel_equals_plain_draw(tcard, tcpu, rows, x, r, None, 4)
    assert col.squeeze(-1)[0].tolist() == [0, 1, 2, 0, 1]


@pytest.mark.parametrize("name", ["choose_args1", "choose_args2"])
def test_straw2_kernel_choose_args_tables(cuda, name):
    """choose_args: the hash ids of ``args_ids32`` and the weight-set row
    of each lane's position, clamped to the positions there are, as the
    generic chooser draws (one row and position a lane), and position 0
    as the fast path draws."""
    from ceph_tpu_torch.crush import torchmap

    m = _legacy_card_maps()[name]
    card, cpu = torchmap.compile_map(m), torchmap.compile_map(m, device="cpu")
    assert cpu.arg_positions == int(name[-1])
    n = 8192
    rng = np.random.default_rng(cpu.arg_positions)
    hosts = np.nonzero(cpu.np_types == 1)[0]
    rows = torch.from_numpy(rng.choice(hosts, n).astype(np.int64))
    pos = torch.from_numpy(rng.integers(-1, 4, n))
    x = _lanes_x(n, 11)[:, :, 0]
    r = torch.from_numpy(rng.integers(0, 60, (n, 1)).astype(np.int32))
    _kernel_equals_plain_draw(card, cpu, rows, x, r, pos, cpu.sz)
    if cpu.arg_positions == 1:
        _kernel_equals_plain_draw(card, cpu, rows.view(n // 4, 4), _lanes_x(n // 4, 12),
                                  torch.arange(4, dtype=torch.int32).view(1, 4, 1), None, 4)


def test_straw2_kernel_counts_launches_and_raises_on_a_refused_one(cuda):
    """One launch a straw2 level of a chunk (the cell's rule 0: root, rows,
    racks, hosts), ``crush_kernel_draws`` an update's launches (two
    chunks of 2^19 at 2^20 PGs), and a launch the C entry refuses (a
    width past the table's) or inputs it does not take raise and count
    nothing."""
    from ceph_tpu_torch.crush import torchmap
    from ceph_tpu_torch.osd import OSDMap, OSDMapMapping, PgPool

    m = _bench_map()
    card = torchmap.compile_map(m)
    before = torchmap.counts["crush_kernel_draws"]
    torchmap.batch_do_rule_raw(card, 0, np.arange(4096), 3)
    assert torchmap.counts["crush_kernel_draws"] - before == 4
    om = OSDMap.build(m, 10000)
    om.add_pool(PgPool(pool_id=1, size=3, crush_rule=0, pg_num=1 << 20))
    mapping = OSDMapMapping()
    mapping.update(om)
    assert mapping.perf.dump()["crush_kernel_draws"] == 8
    x = _lanes_x(64, 3).cuda()
    r = torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda)
    before = torchmap.counts["crush_kernel_draws"]
    with pytest.raises(RuntimeError, match="crush_straw2_draw launch failed"):
        torchmap.straw2_draw_kernel(card, 0, x, r, None, card.sz + 1, True)
    with pytest.raises(ValueError):
        torchmap.straw2_draw_kernel(card, 0, x.to(torch.int64), r, None, 4, True)
    with pytest.raises(ValueError):
        torchmap.straw2_draw_kernel(card, 0, x.cpu(), r, None, 4, True)
    assert torchmap.counts["crush_kernel_draws"] == before


def _recorders(cm, fast: bool) -> list:
    """This thread's recorders over compiled map ``cm``: the fast firstn
    path's, or the generic choosers' (a start and a block each)."""
    from ceph_tpu_torch.crush import torchmap

    return [r for key, recs in torchmap._block_cache().items()
            if (key[0][0] == "fast") == fast for r in recs if r.cm is cm]


@pytest.mark.parametrize("rule,rmax", [(0, 3), (1, 6)])
def test_crush_raw_output_of_the_benchmark_map_equals_cpu(cuda, monkeypatch, rule, rmax):
    """Rules 0 (the fast firstn path) and 1 (the generic indep chooser)
    of the benchmark's 10,000-OSD map, one host's OSDs out, over 2^16
    PGs: the raw output on the card equals the CPU's.  Three calls on
    the card, the second over the lanes reversed, and every recorder by
    one policy: its first run records nothing, its second records once,
    later runs replay (rule 0's one recorder runs once a call; rule 1's
    start once a call and its block until every lane is done, so the
    block records inside the first call).  Every call counts the eager
    run's straw2 launches, replays included, and a replay's outputs
    outlive the next replay."""
    from ceph_tpu_torch.crush import torchmap

    m = _bench_map()
    w = np.full(m.max_devices, 0x10000, dtype=np.int64)
    w[4 * 1234 : 4 * 1235] = 0
    card, cpu = torchmap.compile_map(m), torchmap.compile_map(m, device="cpu")
    captured = []
    capture = torchmap._capture
    monkeypatch.setattr(torchmap, "_capture",
                        lambda cm, fn: captured.append(fn) or capture(cm, fn))
    xs = np.arange(1 << 16)
    runs, draws = [], []
    for call, lanes in enumerate((xs, xs[::-1].copy(), xs)):
        before = torchmap.counts["crush_kernel_draws"]
        runs.append(torchmap.batch_do_rule_raw(card, rule, lanes, rmax, w))
        draws.append(torchmap.counts["crush_kernel_draws"] - before)
        recs = _recorders(card, fast=rule == 0)
        assert len(recs) == (1 if rule == 0 else 2)
        assert all((r.graph is not None) == (r.calls >= 2) for r in recs)
        assert len(captured) == sum(r.calls >= 2 for r in recs)  # each recorded once
        if call == 0:
            assert recs[0].calls == 1 and recs[0].graph is None  # the first run records nothing
        else:
            assert recs[0].calls == call + 1 and recs[0].graph is not None
    assert draws[0] == draws[1] == draws[2] > 0
    want = torchmap.batch_do_rule_raw(cpu, rule, xs, rmax, w)
    for g, b, a, v in zip(*runs, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), v)
        assert torch.equal(b.cpu(), v.flip(0))
        assert torch.equal(a.cpu(), v)


def test_fast_path_recording_over_remap_updates_equals_the_eager_path(cuda, monkeypatch):
    """The benchmark's map with a pool of 2^20 PGs, as the remap cell
    maps it: a base update, one host down, then the same host out.  The
    fast firstn path runs through its recording (a CUDA graph, recorded
    in the first update and run once a 2^19-lane chunk): every update
    equals the same update with the path launched op by op, all four
    arrays of every PG, and the scalar oracle on 2,048 seeded PGs;
    ``crush_fast_replays`` reads 2 an update and ``crush_kernel_draws``
    8, and no recording is made after the first update."""
    from ceph_tpu_torch.crush import torchmap
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osd import Incremental, OSDMap, OSDMapMapping, PgPool
    from ceph_tpu_torch.osd.mapping import _compiled

    def trim(v):
        v = list(v)
        while v and v[-1] == CRUSH_ITEM_NONE:
            v.pop()
        return v

    om = OSDMap.build(_bench_map(), 10000)
    om.add_pool(PgPool(pool_id=1, size=3, crush_rule=0, pg_num=1 << 20))
    mapping = OSDMapMapping()
    cache = torchmap._block_cache()
    recorded = None
    for epoch, change in enumerate(("base", "down", "out")):
        inc = Incremental(epoch=om.epoch + 1)
        for o in range(4 * 1234, 4 * 1235):
            if change == "down":
                inc.mark_down(o)
            elif change == "out":
                inc.new_weight[o] = 0
        om.apply_incremental(inc)
        before = mapping.perf.dump()
        mapping.update(om)
        after = mapping.perf.dump()
        assert after["crush_fast_replays"] - before["crush_fast_replays"] == 2
        assert after["crush_kernel_draws"] - before["crush_kernel_draws"] == 8
        if recorded is None:
            recorded = dict(cache)
            # recorded in the first update's second chunk
            card = _compiled(om.crush, torch.device("cuda", torch.cuda.current_device()))
            (fast,) = _recorders(card, fast=True)
            assert fast.graph is not None
        assert fast.calls == 2 * (epoch + 1)
        assert list(cache) == list(recorded)
        assert all(cache[k] is b for k, b in recorded.items())
        eager = OSDMapMapping()
        with monkeypatch.context() as patch:
            patch.setattr(torchmap, "_replays", lambda cm, lanes: False)
            eager.update(om)
        for name in ("up", "up_primary", "acting", "acting_primary"):
            np.testing.assert_array_equal(getattr(mapping, name)[1], getattr(eager, name)[1])
        for ps in np.random.default_rng(2**31 + 21).choice(1 << 20, 2048, replace=False):
            up, upp, acting, actp = om.pg_to_up_acting_osds(1, int(ps))
            assert mapping.get(1, int(ps)) == (trim(up), upp, trim(acting), actp)


def test_recordings_follow_the_maps_card_not_the_current_one(cuda):
    """A map's tables on the second card while the first is current, as
    the mesh route maps its shards from one thread: rule 0's fast path
    (recorded in its second call) and rule 1's chooser blocks record
    and replay on the map's card, three calls each equal to the CPU;
    then both rules through the mesh over every card, twice (the second
    call records the fast path on each shard's card), equal to one
    card's mapping."""
    from ceph_tpu_torch.crush import torchmap
    from ceph_tpu_torch.ops import mesh as meshmod
    from ceph_tpu_torch.osd.sharded_mapping import sharded_batch_do_rule

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    m = _bench_map()
    w = np.full(m.max_devices, 0x10000, np.int64)
    w[4 * 1234 : 4 * 1235] = 0
    second, cpu = torchmap.compile_map(m, device="cuda:1"), torchmap.compile_map(m, device="cpu")
    xs = np.arange(torchmap.GRAPH_LANES)
    with torch.cuda.device(0):
        for rule, rmax in ((0, 3), (1, 6)):
            want = torchmap.batch_do_rule_raw(cpu, rule, xs, rmax, w)
            runs = [torchmap.batch_do_rule_raw(second, rule, xs, rmax, w) for _ in range(3)]
            for got in runs:
                for g, v in zip(got, want):
                    assert g.device == torch.device("cuda:1") and torch.equal(g.cpu(), v)
        for fast in (True, False):
            assert any(r.graph is not None for r in _recorders(second, fast))
        dmesh = meshmod.build_mesh()
        assert dmesh.n == torch.cuda.device_count()
        pgs = np.arange(1 << 20)
        for rule, rmax in ((0, 3), (1, 6)):
            want = torchmap.batch_do_rule(torchmap.compile_map(m, device="cuda:0"), rule, pgs,
                                          rmax, w)
            for _ in range(2):
                got = sharded_batch_do_rule(m, rule, pgs, rmax, w, dmesh)
                assert all(np.array_equal(g, v) for g, v in zip(got, want))


def _card_cluster():
    from ceph_tpu_torch.crush.types import PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED
    from ceph_tpu_torch.osd import OSDMap, PgPool
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    om = OSDMap.build(build_hierarchy(240, 8, 5), 240)
    om.add_pool(PgPool(pool_id=1, type=PG_POOL_TYPE_REPLICATED, size=3, pg_num=4096,
                       crush_rule=0))
    om.add_pool(PgPool(pool_id=2, type=PG_POOL_TYPE_ERASURE, size=6, pg_num=1000,
                       crush_rule=1))
    rng = np.random.default_rng(11)
    for o in rng.choice(240, 6, replace=False):
        om.mark_down(int(o))
    for o in rng.choice(240, 6, replace=False):
        om.mark_out(int(o))
    om.osd_exists[7] = False
    om.osd_primary_affinity = [0x10000] * 240
    for o in rng.choice(240, 20, replace=False):
        om.osd_primary_affinity[int(o)] = int(rng.choice([0, 0x8000]))
    for pid, pool in om.pools.items():
        for ps in rng.choice(pool.pg_num, 8, replace=False):
            ps = int(ps)
            src = om.pg_to_up_acting_osds(pid, ps)[0]
            om.pg_upmap_items[(pid, ps)] = [(src[0], int(rng.integers(240)))]
        om.pg_temp[(pid, 3)] = [int(v) for v in rng.choice(240, pool.size, replace=False)]
        om.primary_temp[(pid, 5)] = int(rng.integers(240))
        om.pg_upmap[(pid, 9)] = [int(v) for v in rng.choice(240, pool.size, replace=False)]
    return om


def test_osdmap_mapping_on_the_card_equals_cpu(cuda):
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osd import OSDMapMapping

    om = _card_cluster()
    card, cpu = OSDMapMapping(), OSDMapMapping(device="cpu")
    assert card.device.type == "cuda"
    card.update(om)
    cpu.update(om)
    for pid in om.pools:
        for name in ("up", "up_primary", "acting", "acting_primary"):
            np.testing.assert_array_equal(getattr(card, name)[pid], getattr(cpu, name)[pid])
    def norm(v):
        v = list(v)
        while v and v[-1] == CRUSH_ITEM_NONE:
            v.pop()
        return v

    for pid, pool in om.pools.items():
        for ps in range(0, pool.pg_num, 37):
            up, upp, acting, actp = om.pg_to_up_acting_osds(pid, ps)
            gup, gupp, gact, gactp = card.get(pid, ps)
            assert (norm(gup), gupp, norm(gact), gactp) == (norm(up), upp, norm(acting), actp)


def test_balancer_on_the_card_equals_cpu(cuda):
    from ceph_tpu_torch.crush.types import PG_POOL_TYPE_REPLICATED
    from ceph_tpu_torch.osd import OSDMap, PgPool
    from ceph_tpu_torch.osd.balancer import calc_pg_upmaps
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    maps = []
    for _ in range(2):
        om = OSDMap.build(build_hierarchy(60, 6, weight_fn=lambda o: 0x10000 + (o // 6 % 3) * 0x4000),
                          60)
        om.add_pool(PgPool(pool_id=1, type=PG_POOL_TYPE_REPLICATED, size=3, pg_num=1024,
                           crush_rule=0))
        maps.append(om)
    assert calc_pg_upmaps(maps[0], 1, 40) == calc_pg_upmaps(maps[1], 1, 40, device="cpu") > 0
    assert maps[0].pg_upmap_items == maps[1].pg_upmap_items


def _shard_store_with_objects(path, n=12):
    from ceph_tpu_torch.store import BlockStore, Transaction

    store = BlockStore(path, sync=False)
    store.queue_transaction(Transaction().create_collection("pg_1.0"))
    rng = np.random.default_rng(9)
    for i in range(n):
        txn = Transaction().touch("pg_1.0", f"o{i}")
        txn.write("pg_1.0", f"o{i}", 0, rng.integers(0, 256, 4096 * i + 3, dtype=np.uint8).tobytes())
        txn.setattr("pg_1.0", f"o{i}", "u_k", bytes([i]))
        store.queue_transaction(txn)
    return store


def test_scrub_map_on_the_card_equals_cpu_and_host_crc(cuda, tmp_path):
    from ceph_tpu_torch.native import ceph_crc32c
    from ceph_tpu_torch.osd.scrub import DIGEST_SEED, build_scrub_map

    store = _shard_store_with_objects(tmp_path / "bs")
    oids = [f"o{i}" for i in range(12)] + ["absent"]
    card = build_scrub_map(store, "pg_1.0", oids, deep=True)
    assert card == build_scrub_map(store, "pg_1.0", oids, deep=True, device="cpu")
    for oid in oids[:-1]:
        assert card[oid]["data_digest"] == ceph_crc32c(DIGEST_SEED, store.read("pg_1.0", oid))
    store.close()


def test_wal_replay_on_the_card_verifies_and_truncates_like_cpu(cuda, tmp_path):
    """One record's payload corrupted under a valid frame (so only the
    record's own crc, verified on the device, can catch it): replay on
    ``cuda`` keeps the same prefix, truncates to the same bytes and
    leaves the same state as on ``cpu``."""
    import shutil

    from ceph_tpu_torch.common.encoding import Decoder, Encoder
    from ceph_tpu_torch.store import BlockStore, Transaction, WALStore
    from ceph_tpu_torch.store.framed_log import frame, replay_frames
    from ceph_tpu_torch.store.wal_store import decode_wal_record, encode_wal_record

    src = tmp_path / "src"
    w = WALStore(BlockStore(src / "data", sync=False), src / "wal", device="cpu")
    w.drain_paused = True
    w.queue_transaction(Transaction().create_collection("c"))
    for i in range(8):
        w.queue_transaction(Transaction().write("c", f"o{i}", 0, bytes([i]) * (3000 + i)))
    w._closed = True
    w.inner.close()
    log = b""
    for n, (body, _end) in enumerate(replay_frames((src / "wal" / "wal.log").read_bytes())):
        rec = decode_wal_record(Decoder(body))
        if n == 5:
            rec.payload = rec.payload[:-1] + bytes([rec.payload[-1] ^ 1])
        e = Encoder()
        encode_wal_record(e, rec)
        log += frame(e.getvalue())
    results = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        shutil.copytree(src, d)
        (d / "wal" / "wal.log").write_bytes(log)
        again = WALStore(BlockStore(d / "data", sync=False), d / "wal", device=dev)
        results[dev] = (
            again.replayed_records,
            {o: again.read("c", o) for o in again.list_objects("c")},
            (d / "wal" / "wal.log").read_bytes(),
        )
        again.close()
    assert results["cuda"] == results["cpu"]
    assert results["cuda"][0] == 5
    assert len(results["cuda"][2]) < len(log)


def _port_cluster(n: int, device: str):
    """A port monitor, ``n`` OSDs on ``device`` over MemStore, a client."""
    from ceph_tpu_torch.crush.builder import CrushMap
    from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables
    from ceph_tpu_torch.mon.monitor import Monitor
    from ceph_tpu_torch.msg import Messenger
    from ceph_tpu_torch.osd.daemon import OSD
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.rados import Rados

    cmap = CrushMap(tunables=Tunables())
    hosts = [
        cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h], [0x10000], name=f"host{h}")
        for h in range(n)
    ]
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts, [cmap.buckets[b].weight for b in hosts], name="default"
    )
    cmap.add_simple_rule("rep", "default", "host", mode="firstn")
    mon_msgr = Messenger("mon")
    mon_msgr.add_dispatcher(Monitor(OSDMap.build(cmap, n), min_reporters=2))
    addr = mon_msgr.bind()
    osds = []
    for i in range(n):
        osd = OSD(i, tick_interval=0.2, heartbeat_grace=20.0, device=device)
        osd.boot(*addr)
        osds.append(osd)
    return mon_msgr, osds, Rados(f"client-{device}").connect(*addr)


def _port_cluster_bytes(n: int, device: str, ec: bool) -> dict:
    """Seeded writes (full, at an offset, appended) into one pool of a
    fresh port cluster on ``device``; returns every OSD's data objects
    and the bytes read back."""
    from ceph_tpu_torch.msg import NetworkStack
    from ceph_tpu_torch.msg.messenger import wait_for

    mon_msgr, osds, rados = _port_cluster(n, device)
    try:
        if ec:
            rc, _b, outs = rados.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "p",
                "profile": ["plugin=isa", "k=3", "m=2"],
            })
            assert rc == 0, outs
            rados.pool_create("pool", pool_type=3, pg_num=4, erasure_code_profile="p")
        else:
            rados.pool_create("pool", pg_num=4, size=3)
        io = rados.open_ioctx("pool")
        rng = np.random.default_rng(9)
        for i in range(8):
            io.write_full(f"o{i}", rng.integers(0, 256, 1000 + 9000 * i, dtype=np.uint8).tobytes())
        io.write("o3", b"W" * 5000, 4096)
        io.append("o5", b"tail" * 100)
        futs = [io.aio_write_full(f"a{i}", bytes([i]) * 20000) for i in range(8)]
        for f in futs:
            f.result(timeout=60)
        reads = {oid: io.read(oid) for oid in io.list_objects()}
        stored = {}
        for osd in osds:
            for cid in sorted(osd.store.list_collections()):
                for oid in sorted(osd.store.list_objects(cid)):
                    if oid.startswith("o_"):
                        stored[(osd.whoami, cid, oid)] = (
                            osd.store.read(cid, oid), dict(osd.store.list_attrs(cid, oid))
                        )
        return {"reads": reads, "stored": stored}
    finally:
        rados.shutdown()
        for osd in osds:
            osd.shutdown()
        mon_msgr.shutdown()
        assert wait_for(lambda: NetworkStack.live() is None, 10.0)


@pytest.mark.parametrize("n,ec", [(3, False), (5, True)], ids=["replicated-3", "isa-k3m2-5"])
def test_port_cluster_on_the_card_equals_cpu(cuda, n, ec):
    """A 3-OSD replicated pool and a 5-OSD EC pool with ``OSD(device=
    "cuda")``: the same writes leave the same bytes in every OSD's store
    (shards, hinfo, xattrs) and read back the same as on ``cpu``; the
    EC pool's encodes launched the kernels."""
    before = packed_gf.launches + bitplane_gf.launches
    card = _port_cluster_bytes(n, "cuda", ec)
    if ec:
        assert packed_gf.launches + bitplane_gf.launches > before
    host = _port_cluster_bytes(n, "cpu", ec)
    assert card["reads"] == host["reads"] and len(card["reads"]) == 16
    assert card["stored"] == host["stored"]


def _process_cluster_reads(tmp_path, device: str) -> dict:
    from ceph_tpu_torch.proc import ClusterSpec, Supervisor
    from ceph_tpu_torch.rados import Rados

    spec = ClusterSpec.plan(tmp_path / device, mons=1, osds=3, mgrs=0, device=device)
    sup = Supervisor(spec, report_interval=3600.0)
    client = None
    try:
        sup.start(ready_timeout=120)
        client = Rados(f"proc-{device}").connect_any(spec.mon_addrs)
        client.objecter.op_timeout = 60.0
        rc, _b, outs = client.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "p",
            "profile": ["plugin=isa", "k=2", "m=1"],
        })
        assert rc == 0, outs
        client.pool_create("ec", pool_type=3, pg_num=4, erasure_code_profile="p", min_size=2)
        io = client.open_ioctx("ec")
        rng = np.random.default_rng(12)
        for i in range(8):
            io.write_full(f"o{i}", rng.integers(0, 256, 1000 + 30000 * i, dtype=np.uint8).tobytes())
        io.write("o3", b"W" * 5000, 4096)
        reads = {oid: io.read(oid) for oid in io.list_objects()}
        dead = [r for r, c in sup.status().items() if c["state"] != "running"]
        assert not dead, dead
        return reads
    finally:
        if client is not None:
            client.shutdown()
        sup.stop()


def test_process_cluster_on_the_card_equals_cpu(cuda, tmp_path):
    """A monitor and 3 OSD processes with ``device="cuda"`` (each its own
    CUDA context) serve the reads the same cluster serves on ``cpu``."""
    from ceph_tpu_torch.tools.cluster import prebuild_kernels

    prebuild_kernels("cuda")
    card = _process_cluster_reads(tmp_path, "cuda")
    host = _process_cluster_reads(tmp_path, "cpu")
    assert card == host and len(card) == 8


def _rbd_image_bytes(device: str) -> dict:
    """A port rbd image (exclusive-lock, object-map, journaling; 4-wide
    stripes over 64 KiB objects) on a fresh 5-OSD cluster's isa k=3 m=2
    pool on ``device``: seeded writes across object boundaries, a
    discard, a snapshot and an overwrite, 4 KiB aio writes. Returns the
    reads, the diff and every OSD's stored objects."""
    import random

    from ceph_tpu_torch.msg import NetworkStack
    from ceph_tpu_torch.msg.messenger import wait_for
    from ceph_tpu_torch.rbd import RBD, Image

    mon_msgr, osds, rados = _port_cluster(5, device)
    try:
        rc, _b, outs = rados.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "p",
            "profile": ["plugin=isa", "k=3", "m=2"],
        })
        assert rc == 0, outs
        rados.pool_create("ec", pool_type=3, pg_num=4, erasure_code_profile="p")
        io = rados.open_ioctx("ec")
        size = 1 << 20
        RBD().create(io, "img", size, stripe_unit=16384, stripe_count=4, object_size=65536,
                     features="exclusive-lock,object-map,journaling")
        rng = random.Random(21)
        out = {}
        with Image(io, "img") as img:
            for _ in range(8):
                off = rng.randrange(0, size - 1)
                img.write(off, rng.randbytes(rng.randint(1, min(200000, size - off))))
            img.discard(65536, 100000)
            img.snap_create("s1")
            img.write(0, rng.randbytes(70000))
            # distinct blocks: concurrent writes to one block land in any order
            futs = [img.aio_write(blk * 4096, rng.randbytes(4096))
                    for blk in rng.sample(range(256), 32)]
            for f in futs:
                f.result(timeout=60)
            out["head"] = img.read(0, size)
            out["diff"] = img.diff_objects("s1")
            img.set_snap("s1")
            out["s1"] = img.read(0, size)
        stored = {}
        for osd in osds:
            for cid in sorted(osd.store.list_collections()):
                for oid in sorted(osd.store.list_objects(cid)):
                    if oid.startswith("o_rbd_data"):
                        stored[(osd.whoami, cid, oid)] = osd.store.read(cid, oid)
        out["stored"] = stored
        return out
    finally:
        rados.shutdown()
        for osd in osds:
            osd.shutdown()
        mon_msgr.shutdown()
        assert wait_for(lambda: NetworkStack.live() is None, 10.0)


def test_rbd_image_on_the_card_equals_cpu(cuda):
    """The same image operations leave the same shards and read the same
    bytes with ``OSD(device="cuda")`` as on ``cpu``; the card's encodes
    launched the kernels."""
    before = packed_gf.launches + bitplane_gf.launches
    card = _rbd_image_bytes("cuda")
    assert packed_gf.launches + bitplane_gf.launches > before
    host = _rbd_image_bytes("cpu")
    assert card == host
    assert card["head"] != card["s1"] and card["diff"]


@pytest.mark.parametrize("shape", [(1, 8, 0), (0, 8, 4096), (3, 4, 0)])
def test_kernels_take_empty_stripes_without_a_launch(cuda, shape):
    """A zero-length object's shards decode to nothing: both wrappers
    return the empty product on the card, as the plain versions do, and
    launch nothing (an empty tensor's strides are 1, which K1's
    alignment test once refused, crashing every OSD that rebuilt such a
    shard)."""
    b, k, chunk = shape
    mat = gf.reed_sol_vandermonde_coding_matrix(k, 3, 8)
    bm = matrix_to_device_bitmatrix(mat, 8, cuda)
    x = torch.empty(shape, dtype=torch.uint8, device=cuda)
    before = (packed_gf.launches, bitplane_gf.launches)
    for got in (packed_gf.packed_matrix_stripes(bm, x), bitplane_gf.gf8_bitplane_stripes(bm, x)):
        assert got.shape == (b, 3, chunk) and got.is_cuda
    assert (packed_gf.launches, bitplane_gf.launches) == before
    from ceph_tpu_torch.ops.ec_backend import TorchBackend

    regions = np.zeros((k, 0), dtype=np.uint8)
    assert TorchBackend(device="cuda").matrix_regions(mat, regions, 8).shape == (3, 0)


def test_mesh_of_one_card_repeated_equals_the_single_device(cuda):
    """A ``["cuda:0"] * 4`` mesh (the virtual mesh of a one-card host):
    the sharded encode launches K2 once a shard and equals the
    single-device K2 output, ragged batch included; the sharded
    placement equals torchmap's single-device output; the default mesh
    of a one-card host is None."""
    from ceph_tpu_torch.crush import torchmap
    from ceph_tpu_torch.ops import mesh as meshmod
    from ceph_tpu_torch.ops.gf_matmul import gf_matrix_stripes
    from ceph_tpu_torch.osd.sharded_mapping import sharded_batch_do_rule
    from ceph_tpu_torch.tools import mesh_dryrun
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    if torch.cuda.device_count() == 1:
        meshmod._reset_default_mesh_for_tests()
        assert meshmod.default_mesh() is None
    dmesh = meshmod.DeviceMesh(["cuda:0"] * 4)
    bm = matrix_to_device_bitmatrix(gf.reed_sol_vandermonde_coding_matrix(8, 3, 8), 8, cuda)
    for b in (64, 63):
        host = np.random.default_rng(b).integers(0, 256, (b, 8, 4096), dtype=np.uint8)
        want = gf_matrix_stripes(bm, torch.from_numpy(host).to(cuda), w=8).cpu()
        before = bitplane_gf.launches
        got = meshmod.sharded_matrix_stripes(bm, host, 8, dmesh)
        assert bitplane_gf.launches - before == 4
        assert torch.equal(torch.from_numpy(got), want)
    pm = build_hierarchy(600, 10, 6)
    cm = torchmap.compile_map(pm, device=cuda)
    xs = np.arange(5003)
    for rule, rmax in ((0, 3), (1, 11)):
        want = torchmap.batch_do_rule(cm, rule, xs, rmax)
        got = sharded_batch_do_rule(pm, rule, xs, rmax, dmesh=dmesh)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert mesh_dryrun.step(dmesh)["errors"] == 0


def test_program_spans_share_the_device_traces_clock(cuda):
    """A program span around a ~1.3 ms kernel and a sync contains the
    kernel's interval as ``torch.profiler`` (CUDA activity, kineto)
    reports it, within 50 us: span stamps and device events are on one
    clock, ``time.time_ns()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.common import tracing

    a = torch.randn(4096, 2048, device=cuda)
    b = torch.randn(2048, 4096, device=cuda)
    a @ b
    torch.cuda.synchronize()
    tracer = tracing.Tracer("test")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(6):
            with tracer.start_span("matmul"):
                a @ b
                torch.cuda.synchronize()
    spans = sorted((s["start_ns"], s["end_ns"]) for s in tracer.dump_traces()["spans"])
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    assert len(kernels) == len(spans) == 6
    for (lo, hi), (ks, ke) in zip(spans, kernels):
        assert ke - ks > 500_000, (ks, ke)
        assert lo - 50_000 <= ks and ke <= hi + 50_000, (lo, hi, ks, ke)
        # and not far inside it: the span ends soon after the kernel, so
        # no offset between the clocks hides behind the containment
        assert hi - ke < 500_000, (lo, hi, ks, ke)


def test_host_syncs_count_every_wait_of_a_remap_sized_update(cuda):
    """One update of 2^20 PGs on 10,000 OSDs under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing
    call it warns of lies inside a ``sync.<site>`` span, and there are
    no more of them than ``host_syncs`` counts."""
    import gc
    import threading
    import traceback
    import warnings

    from ceph_tpu_torch.common import tracing
    from ceph_tpu_torch.osd import Incremental, OSDMap, OSDMapMapping, PgPool
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    # sites the debug mode does not flag (torch 2.11 flags every site of
    # this path, the pageable uploads included)
    unflagged: set = set()
    om = OSDMap.build(build_hierarchy(10000, 4, 20), 10000)
    om.add_pool(PgPool(pool_id=1, size=3, crush_rule=0, pg_num=1 << 20))
    mapping = OSDMapMapping()
    mapping.update(om)
    inc = Incremental(epoch=om.epoch + 1)
    for o in range(8, 12):
        inc.mark_down(o)
    om.apply_incremental(inc)
    me = threading.get_ident()
    seen, elsewhere = [], []

    def note(message, *a, **k):
        # the update's own waits: those raised on its thread (setting the
        # mode also warns, once, that it is a prototype)
        if "called a synchronizing CUDA operation" not in str(message):
            return
        if threading.get_ident() != me:
            elsewhere.append(threading.current_thread().name)
            return
        name = getattr(tracing.current_span(), "name", None)
        if name is None:  # where it came from, for the failure's message
            name = " < ".join(f"{f.name}:{f.lineno}" for f in traceback.extract_stack()[-6:-1])
        seen.append(name)

    tracer = tracing.Tracer("test", max_spans=4096)
    before = mapping.perf.dump()["host_syncs"]
    torch.cuda.synchronize()
    gc.collect()  # no finalizer of an earlier test's objects runs inside
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with tracer.start_span("epoch"):
                mapping.update(om)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = mapping.perf.dump()["host_syncs"] - before
    sites = [s["name"] for s in tracer.dump_traces()["spans"] if s["name"].startswith("sync.")]
    assert all(name.startswith("sync.") for name in seen), (seen, elsewhere)
    assert len(seen) <= syncs == len(sites), (seen, sites, elsewhere)
    assert set(sites) - set(seen) == unflagged, (seen, sites)
    assert sites.count("sync.weights_upload") == 1  # one for both 2^19-lane chunks
