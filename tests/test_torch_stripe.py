"""The port's stripe seam (``ec/stripe.py``), crc32c (``native``) and
OSD codec (``osd/ec_pg.ECCodec``) held against the JAX package's, on the
CPU (``device="cpu"``), byte-exact."""

from __future__ import annotations

import numpy as np
import pytest

from ceph_tpu.ec import ErasureCodeProfile as JProfile
from ceph_tpu.ec import registry_instance as j_registry
from ceph_tpu.ec import stripe as j_stripe
from ceph_tpu.native import ceph_crc32c as j_crc32c
from ceph_tpu.osd.ec_pg import ECCodec as JCodec
from ceph_tpu_torch.ec import ErasureCodeError, ErasureCodeProfile, registry_instance
from ceph_tpu_torch.ec import stripe
from ceph_tpu_torch.native import ceph_crc32c, crc32c_plain, crc32c_plain_rows
from ceph_tpu_torch.osd.ec_pg import DEFAULT_STRIPE_UNIT, ECCodec

RS = ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"})
CAUCHY = ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2", "packetsize": "16"})
CLAY = ("clay", {"k": "4", "m": "2", "d": "5"})
LRC = ("lrc", {"k": "4", "m": "2", "l": "3"})


def _pair(plugin, prof):
    return (
        j_registry().factory(plugin, JProfile(prof)),
        registry_instance().factory(plugin, ErasureCodeProfile(prof, device="cpu")),
    )


def _bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _assert_shards_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_array_equal(np.asarray(got[i]), np.asarray(want[i]), f"shard {i}")


# -- crc32c -----------------------------------------------------------------


@pytest.mark.parametrize("crc_fn", [ceph_crc32c, crc32c_plain], ids=["library", "plain"])
def test_crc32c_reference_vectors(crc_fn):
    """src/test/common/test_crc32c.cc vectors (tests/test_stripe.py)."""
    assert crc_fn(0, b"foo bar baz") == 4119623852
    assert crc_fn(1234, b"foo bar baz") == 881700046
    assert crc_fn(0, b"whiz bang boom") == 2360230088
    assert crc_fn(5678, b"whiz bang boom") == 3743019208
    assert crc_fn(0, b"\x01" * 5) == 2715569182
    assert crc_fn(0, b"\x01" * 35) == 440531800
    if crc_fn is ceph_crc32c:  # 4 MB through the byte-a-step version takes seconds
        assert crc_fn(0, b"\x01" * 4096000) == 31583199
        assert crc_fn(1234, b"\x01" * 4096000) == 1400919119


def test_crc32c_library_matches_plain_and_jax():
    data = _bytes(100_003, 0)
    for seed in (0, 0xFFFFFFFF, 1234):
        assert ceph_crc32c(seed, data) == j_crc32c(seed, data)
        assert ceph_crc32c(seed, data[:3001]) == crc32c_plain(seed, data[:3001])
    # numpy arrays, offset views and bytes-likes hash alike
    arr = np.frombuffer(data, dtype=np.uint8)
    assert ceph_crc32c(7, arr[13:5000]) == ceph_crc32c(7, data[13:5000])
    assert ceph_crc32c(7, memoryview(data)[1:]) == ceph_crc32c(7, data[1:])
    rows = np.random.default_rng(1).integers(0, 256, (6, 777), dtype=np.uint8)
    assert [int(c) for c in crc32c_plain_rows(0xFFFFFFFF, rows)] == [
        crc32c_plain(0xFFFFFFFF, r.tobytes()) for r in rows
    ]


def test_hashinfo_cumulative_matches_jax():
    hi, jhi = stripe.HashInfo(3), j_stripe.HashInfo(3)
    a = {0: b"aaa", 1: b"bbb", 2: b"ccc"}
    b = {0: np.frombuffer(b"ddd", np.uint8), 1: b"eee", 2: b"fff"}
    for h in (hi, jhi):
        h.append(0, a)
        h.append(3, b)
    assert hi.total_chunk_size == 6
    assert hi.cumulative_shard_hashes == jhi.cumulative_shard_hashes
    assert hi.get_chunk_hash(0) == ceph_crc32c(ceph_crc32c(0xFFFFFFFF, b"aaa"), b"ddd")
    with pytest.raises(AssertionError):
        hi.append(3, a)  # wrong old_size
    hi.clear()
    assert hi.cumulative_shard_hashes == [0xFFFFFFFF] * 3 and hi.total_chunk_size == 0


# -- StripeInfo and rmw -------------------------------------------------------


def test_stripe_info_algebra():
    s = stripe.StripeInfo(4, 4096)
    assert s.chunk_size == 1024
    assert s.logical_to_prev_chunk_offset(8192) == 2048
    assert s.logical_to_next_chunk_offset(8193) == 3072
    assert s.logical_to_prev_stripe_offset(5000) == 4096
    assert s.logical_to_next_stripe_offset(5000) == 8192
    assert s.aligned_logical_offset_to_chunk_offset(8192) == 2048
    assert s.aligned_chunk_offset_to_logical_offset(2048) == 8192
    assert s.offset_len_to_stripe_bounds(5000, 5000) == (4096, 8192)
    assert s.logical_aligned(8192) and not s.logical_aligned(8193)
    js = j_stripe.StripeInfo(4, 4096)
    for off in (0, 1, 1023, 4095, 4096, 4097, 12345):
        for name in ("logical_to_prev_chunk_offset", "logical_to_next_chunk_offset",
                     "logical_to_prev_stripe_offset", "logical_to_next_stripe_offset"):
            assert getattr(s, name)(off) == getattr(js, name)(off), (name, off)
        assert s.offset_len_to_stripe_bounds(off, 777) == js.offset_len_to_stripe_bounds(off, 777)
    with pytest.raises(ErasureCodeError):
        stripe.StripeInfo(3, 4096)


def test_rmw_range_and_encode_match_jax():
    jec, tec = _pair(*RS)
    sinfo = stripe.StripeInfo(4, 4 * 512)
    jsinfo = j_stripe.StripeInfo(4, 4 * 512)
    old = _bytes(sinfo.stripe_width * 5, 3)

    def read_stripes(stripes):
        sw = sinfo.stripe_width
        return {s: old[s * sw : (s + 1) * sw] for s in stripes}

    for offset, length, old_size in ((0, 2048, 10240), (100, 50, 10240), (2000, 3000, 10240),
                                     (9000, 4000, 10240), (12000, 10, 10240), (3, 5, 0)):
        assert stripe.rmw_range(sinfo, offset, length, old_size) == j_stripe.rmw_range(
            jsinfo, offset, length, old_size
        )
        data = _bytes(length, offset)
        got = stripe.rmw_encode(sinfo, tec, offset, data, old_size, read_stripes)
        want = j_stripe.rmw_encode(jsinfo, jec, offset, data, old_size, read_stripes)
        assert got[:2] == want[:2]
        np.testing.assert_array_equal(got[2], want[2])
        _assert_shards_equal(got[3], want[3])


# -- encode / encode_batch ---------------------------------------------------


@pytest.mark.parametrize("plugin,prof", [RS, CAUCHY, CLAY], ids=["matrix", "bitmatrix", "clay"])
def test_encode_and_encode_batch_match_jax(plugin, prof):
    jec, tec = _pair(plugin, prof)
    chunk = tec.get_chunk_size(4 * 512)
    assert chunk == jec.get_chunk_size(4 * 512)
    sinfo, jsinfo = stripe.StripeInfo(4, 4 * chunk), j_stripe.StripeInfo(4, 4 * chunk)
    bufs = [_bytes(sinfo.stripe_width * n, n) for n in (3, 1, 2)]
    for buf in bufs:
        _assert_shards_equal(stripe.encode(sinfo, tec, buf), j_stripe.encode(jsinfo, jec, buf))
    got = stripe.encode_batch(sinfo, tec, bufs)
    want = j_stripe.encode_batch(jsinfo, jec, bufs)
    for g, w, buf in zip(got, want, bufs):
        _assert_shards_equal(g, w)
        _assert_shards_equal(g, stripe.encode(sinfo, tec, buf))
    assert stripe.encode(sinfo, tec, b"") == {}
    assert stripe.encode(sinfo, tec, bufs[0], want={0, 5}).keys() == {0, 5}
    with pytest.raises(ErasureCodeError):
        stripe.encode(sinfo, tec, b"x" * 1000)
    shards = stripe.encode(sinfo, tec, bufs[0])
    del shards[1], shards[4]
    assert stripe.decode_concat(sinfo, tec, shards).tobytes() == bufs[0]


def test_matrix_codes_take_the_batched_routes(monkeypatch):
    _jec, tec = _pair(*RS)
    calls = []
    for name in ("matrix_stripes", "matrix_stripes_batch"):
        real = getattr(tec.backend, name)
        monkeypatch.setattr(
            tec.backend, name,
            lambda *a, _n=name, _r=real, **kw: calls.append(_n) or _r(*a, **kw),
        )
    sinfo = stripe.StripeInfo(4, 4 * 256)
    stripe.encode(sinfo, tec, bytes(sinfo.stripe_width * 2))
    stripe.encode_batch(sinfo, tec, [bytes(sinfo.stripe_width)] * 3)
    assert calls == ["matrix_stripes", "matrix_stripes_batch"]


# -- decode_batch -------------------------------------------------------------


def _survivor_sets(sinfo, ec, nstripes, lost, seed):
    out = []
    for i, n in enumerate(nstripes):
        shards = stripe.encode(sinfo, ec, _bytes(sinfo.stripe_width * n, seed + i))
        out.append(({p: v for p, v in shards.items() if p not in lost}, shards))
    return out


@pytest.mark.parametrize("plugin,prof,lost", [(*RS, {1, 4}), (*LRC, {1})], ids=["matrix", "lrc"])
def test_decode_batch_matches_jax(plugin, prof, lost, monkeypatch):
    jec, tec = _pair(plugin, prof)
    chunk = tec.get_chunk_size(tec.k * 256)
    k = tec.get_data_chunk_count()
    sinfo, jsinfo = stripe.StripeInfo(k, k * chunk), j_stripe.StripeInfo(k, k * chunk)
    objs = _survivor_sets(sinfo, tec, (2, 1, 3), lost, 11)
    seen = []
    backend = tec.backend if plugin != "lrc" else tec.layers[-1].erasure_code.backend
    real = backend.decode_stripes_batch

    def recording(rows, row_sets, w, cs):
        seen.append((rows.shape, [len(r) for r in row_sets]))
        return real(rows, row_sets, w, cs)

    monkeypatch.setattr(backend, "decode_stripes_batch", recording)
    got = stripe.decode_batch(sinfo, tec, [s for s, _ in objs], lost)
    want = j_stripe.decode_batch(jsinfo, jec, [s for s, _ in objs], lost)
    for g, w, (_s, full) in zip(got, want, objs):
        _assert_shards_equal(g, w)
        for p in lost:
            np.testing.assert_array_equal(g[p], full[p])
    # one batched call for the three objects
    if plugin == "lrc":
        plan = tec.decode_matrix(lost, set(range(tec.get_chunk_count())) - lost)
        layer = next(lay for lay in reversed(tec.layers) if lost <= lay.chunks_as_set)
        # the local layer's solve: its k_local survivors, not the global k
        k_local = layer.erasure_code.get_data_chunk_count()
        assert k_local < k and set(plan[1]) <= layer.chunks_as_set
        assert seen == [((1, k_local), [k_local] * 3)]
    else:
        assert seen == [((2, k), [k] * 3)]


def test_decode_batch_lets_kernel_errors_propagate(monkeypatch):
    jec, tec = _pair(*RS)
    sinfo, jsinfo = stripe.StripeInfo(4, 4 * 256), j_stripe.StripeInfo(4, 4 * 256)
    objs = [s for s, _ in _survivor_sets(sinfo, tec, (2, 2), {0}, 5)]

    def failing(*_a, **_kw):
        raise RuntimeError("gf8_bitplane_stripes launch failed: simulated")

    monkeypatch.setattr(tec.backend, "decode_stripes_batch", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        stripe.decode_batch(sinfo, tec, objs, {0})
    # shards the batched route cannot take (not whole chunks) fall back to
    # the per-object decode, as in the JAX package, without reaching it
    ragged = [{p: v[:-8] for p, v in s.items()} for s in objs]
    got = stripe.decode_batch(sinfo, tec, ragged, {0})
    want = j_stripe.decode_batch(jsinfo, jec, ragged, {0})
    for g, w in zip(got, want):
        _assert_shards_equal(g, w)
    # unequal survivor lengths degrade too; the per-object decode then
    # refuses them on both sides
    unequal = [dict(s) for s in objs]
    for s in unequal:
        s[2] = s[2][:-256]
    with pytest.raises(ValueError):
        stripe.decode_batch(sinfo, tec, unequal, {0})
    with pytest.raises(ValueError):
        j_stripe.decode_batch(jsinfo, jec, unequal, {0})


# -- ECCodec --------------------------------------------------------------------


@pytest.mark.parametrize("plugin,prof", [RS, LRC, CLAY], ids=["jerasure", "lrc", "clay"])
def test_eccodec_matches_jax(plugin, prof):
    profile = {"plugin": plugin, **prof}
    codec, jcodec = ECCodec({**profile, "device": "cpu"}), JCodec(profile)
    assert codec.sinfo.stripe_width == jcodec.sinfo.stripe_width
    sw = codec.sinfo.stripe_width
    sizes = (0, 100, sw, 2 * sw + 7) if plugin != "clay" else (0, 100, sw + 7)
    datas = [_bytes(n, n) for n in sizes]
    got = codec.encode_object_batch(datas)
    assert got == jcodec.encode_object_batch(datas)
    assert got == [codec.encode_object(d) for d in datas]
    for (shards, meta), data in zip(got, datas):
        assert meta["size"] == len(data)
        assert meta["hashes"] == [crc32c_plain(0xFFFFFFFF, shards[i]) for i in range(codec.n)]
    lost = {2}
    survivors = [{p: s for p, s in shards.items() if p not in lost} for shards, _ in got[1:]]
    rec = codec.decode_object_batch(survivors, lost)
    jrec = jcodec.decode_object_batch(survivors, lost)
    for r, jr, (shards, _) in zip(rec, jrec, got[1:]):
        assert r[2].tobytes() == shards[2]
        if plugin == "clay" and len(shards[2]) > codec.sinfo.chunk_size:
            # the JAX package decodes a clay shard of several stripes as
            # one chunk, which its sub-chunk layout does not allow: other
            # bytes (ROADMAP §C); the port decodes it stripe by stripe
            assert jr[2].tobytes() != shards[2]
        else:
            _assert_shards_equal(r, jr)


def test_eccodec_isa_takes_the_batched_route():
    # the JAX package's stripe seam reads ``ec.w``, which its isa codes
    # lack, so its ECCodec cannot encode an isa pool; the port's isa codes
    # carry w=8.  Held against the JAX isa code's per-stripe encode.
    profile = {"plugin": "isa", "k": "4", "m": "2"}
    with pytest.raises(AttributeError):
        JCodec(profile).encode_object(b"x")
    codec = ECCodec({**profile, "device": "cpu"})
    jec = j_registry().factory("isa", JProfile(k="4", m="2"))
    assert codec.sinfo.stripe_width == 4 * DEFAULT_STRIPE_UNIT
    datas = [_bytes(n, n) for n in (5000, 3 * codec.sinfo.stripe_width)]
    for (shards, _meta), data in zip(codec.encode_object_batch(datas), datas):
        sw = codec.sinfo.stripe_width
        padded = data + bytes(-len(data) % sw)
        for s in range(len(padded) // sw):
            want = jec.encode(set(range(6)), padded[s * sw : (s + 1) * sw])
            cs = codec.sinfo.chunk_size
            for i in range(6):
                assert shards[i][s * cs : (s + 1) * cs] == want[i].tobytes()
