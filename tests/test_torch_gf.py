"""ceph_tpu_torch GF math and bitplane ops held against ceph_tpu.

Same inputs (numpy, seeded) through the JAX package and the port; GF
arithmetic is exact, so every comparison is byte-exact (tolerance 0).
The Pallas kernel runs in interpret mode, as tests/test_pallas_gf.py
runs it off-TPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu import gf as jgf
from ceph_tpu.ops import bitops as jbitops
from ceph_tpu.ops import gf_matmul as jgm
from ceph_tpu.ops.pallas_gf import TILE_N, gf8_regions_pallas
from ceph_tpu_torch import gf as tgf
from ceph_tpu_torch.layout import fold_stripes, unfold_stripes
from ceph_tpu_torch.ops import bitops as tbitops
from ceph_tpu_torch.ops import bitplane_gf
from ceph_tpu_torch.ops import gf_matmul as tgm


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize(
    "name,args",
    [
        ("reed_sol_vandermonde_coding_matrix", (8, 3, 8)),
        ("reed_sol_vandermonde_coding_matrix", (4, 2, 16)),
        ("reed_sol_vandermonde_coding_matrix", (6, 3, 32)),
        ("reed_sol_r6_coding_matrix", (7, 8)),
        ("isa_rs_matrix", (10, 4)),
        ("isa_cauchy_matrix", (10, 4)),
        ("cauchy_original_matrix", (5, 3, 8)),
        ("cauchy_good_matrix", (6, 3, 8)),
    ],
)
def test_matrix_constructors_match(name, args):
    want = getattr(jgf, name)(*args)
    got = getattr(tgf, name)(*args)
    np.testing.assert_array_equal(got, want)
    w = args[-1] if name not in ("isa_rs_matrix", "isa_cauchy_matrix") else 8
    np.testing.assert_array_equal(
        tgf.jerasure_bitmatrix(got, w), jgf.jerasure_bitmatrix(want, w)
    )


@pytest.mark.parametrize("erasures", [[1], [1, 6], [0, 9], [2, 8, 10]])
def test_make_decoding_matrix_matches(erasures):
    mat = jgf.reed_sol_vandermonde_coding_matrix(8, 3, 8)
    want_rows, want_surv = jgf.make_decoding_matrix(mat, erasures, 8, 8)
    got_rows, got_surv = tgf.make_decoding_matrix(mat, erasures, 8, 8)
    np.testing.assert_array_equal(got_rows, want_rows)
    assert got_surv == want_surv


def test_region_oracle_matches():
    mat = jgf.isa_cauchy_matrix(6, 3)
    regions = _rng(1).integers(0, 256, (6, 1030), dtype=np.uint8)
    np.testing.assert_array_equal(
        tgf.matrix_vector_mul_region(mat, regions, 8),
        jgf.matrix_vector_mul_region(mat, regions, 8),
    )


@pytest.mark.parametrize("w", [8, 16, 32])
def test_word_bits_roundtrip_matches(w):
    regions = _rng(2).integers(0, 256, (3, 64), dtype=np.uint8)
    want = np.asarray(jbitops.unpack_word_bits(jnp.asarray(regions), w))
    got = tbitops.unpack_word_bits(torch.from_numpy(regions), w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbitops.pack_word_bits(got, w).numpy(), regions
    )


def test_byte_bits_roundtrip_matches():
    regions = _rng(3).integers(0, 256, (5, 40), dtype=np.uint8)
    want = np.asarray(jbitops.unpack_byte_bits(jnp.asarray(regions)))
    got = tbitops.unpack_byte_bits(torch.from_numpy(regions))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tbitops.pack_byte_bits(got).numpy(), regions)


def test_mod2_matmul_matches():
    rng = _rng(4)
    bm = rng.integers(0, 2, (24, 64), dtype=np.uint8)
    bits = rng.integers(0, 2, (64, 300), dtype=np.uint8)
    want = np.asarray(jgm.mod2_matmul(jnp.asarray(bm), jnp.asarray(bits, jnp.int8)))
    got = tgm.mod2_matmul(torch.from_numpy(bm), torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,k,m,nbytes", [(8, 8, 3, 4100), (16, 4, 2, 512), (32, 6, 3, 1024)])
def test_gf_matrix_regions_matches(w, k, m, nbytes):
    mat = jgf.reed_sol_vandermonde_coding_matrix(k, m, w)
    regions = _rng(5 + w).integers(0, 256, (k, nbytes), dtype=np.uint8)
    want = np.asarray(
        jgm.gf_matrix_regions(
            jgm.matrix_to_device_bitmatrix(mat, w), jnp.asarray(regions), w=w
        )
    )
    bm = tgm.matrix_to_device_bitmatrix(mat, w, "cpu")
    got = tgm.gf_matrix_regions(bm, torch.from_numpy(regions), w=w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), jgf.matrix_vector_mul_region(mat, regions, w)
    )


@pytest.mark.parametrize("w", [8, 16])
def test_gf_matrix_stripes_matches(w):
    mat = jgf.isa_rs_matrix(5, 2) if w == 8 else jgf.reed_sol_vandermonde_coding_matrix(5, 2, w)
    stripes = _rng(6).integers(0, 256, (3, 5, 96), dtype=np.uint8)
    want = np.asarray(
        jgm.gf_matrix_stripes(
            jgm.matrix_to_device_bitmatrix(mat, w), jnp.asarray(stripes), w=w
        )
    )
    bm = tgm.matrix_to_device_bitmatrix(mat, w, "cpu")
    got = tgm.gf_matrix_stripes(bm, torch.from_numpy(stripes), w=w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,packetsize", [(8, 16), (7, 8)])
def test_bitmatrix_packet_regions_matches(w, packetsize):
    rng = _rng(7)
    k, m = 4, 2
    bm = rng.integers(0, 2, (m * w, k * w), dtype=np.uint8)
    regions = rng.integers(0, 256, (k, 3 * w * packetsize), dtype=np.uint8)
    want = np.asarray(
        jgm.bitmatrix_packet_regions(
            jnp.asarray(bm, jnp.int8), jnp.asarray(regions), w=w, packetsize=packetsize
        )
    )
    got = tgm.bitmatrix_packet_regions(
        torch.from_numpy(bm), torch.from_numpy(regions), w=w, packetsize=packetsize
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitplane_plain_matches_pallas_kernel():
    matrix = jgf.reed_sol_vandermonde_coding_matrix(8, 3, 8)
    regions = _rng(0).integers(0, 256, size=(8, TILE_N * 2), dtype=np.uint8)
    want = np.asarray(
        gf8_regions_pallas(
            jgm.matrix_to_device_bitmatrix(matrix, 8, dtype=jnp.bfloat16),
            regions,
            m=3,
            interpret=True,
        )
    )
    bm = tgm.matrix_to_device_bitmatrix(matrix, 8, "cpu")
    got = bitplane_gf.gf8_bitplane_regions(bm, torch.from_numpy(regions))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitplane_takes_ragged_width_and_k_past_packed_limit():
    # the TPU kernel refused widths not divisible by 4096; K2 masks the edge
    matrix = jgf.reed_sol_vandermonde_coding_matrix(40, 4, 8)
    regions = _rng(8).integers(0, 256, size=(40, 100), dtype=np.uint8)
    bm = tgm.matrix_to_device_bitmatrix(matrix, 8, "cpu")
    got = bitplane_gf.gf8_bitplane_regions(bm, torch.from_numpy(regions))
    np.testing.assert_array_equal(
        got.numpy(), jgf.matrix_vector_mul_region(matrix, regions, 8)
    )


@pytest.mark.parametrize("case", ["decode_k8_e1_6", "rs_k4_m2"])
def test_bitplane_plain_matches_pallas_kernel_across_matrices(case):
    # K2's plain version runs K1's mask/AND-XOR arithmetic; the Pallas
    # bitplane kernel (bf16 dot of unpacked planes, & 1) is the reference
    enc = jgf.reed_sol_vandermonde_coding_matrix(8, 3, 8)
    if case == "decode_k8_e1_6":
        matrix = np.asarray(jgf.make_decoding_matrix(enc, [1, 6], 8, 8)[0])
    else:
        matrix = jgf.reed_sol_vandermonde_coding_matrix(4, 2, 8)
    m, k = matrix.shape
    regions = _rng(20 + k).integers(0, 256, size=(k, TILE_N * 2), dtype=np.uint8)
    want = np.asarray(
        gf8_regions_pallas(
            jgm.matrix_to_device_bitmatrix(matrix, 8, dtype=jnp.bfloat16),
            regions,
            m=m,
            interpret=True,
        )
    )
    bm = tgm.matrix_to_device_bitmatrix(matrix, 8, "cpu")
    got = bitplane_gf.gf8_bitplane_plain(bm, torch.from_numpy(regions)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [1, 3, 100, 4097])
@pytest.mark.parametrize("case", ["rs_k40_m4", "rs_k32_m32", "dense_k40_popcount_320"])
def test_bitplane_plain_matches_xla_product(case, width):
    # past K1's k, m <= 32 and the TPU's popcount <= 255 carry bound, at
    # widths that are not multiples of 4 (the plain version pads and cuts);
    # held against the JAX package's XLA bitplane product, since the Pallas
    # kernel takes minutes in interpret mode at these sizes
    rng = _rng(30 + width)
    if case == "dense_k40_popcount_320":
        k = 40
        bm_np = rng.integers(0, 2, (4 * 8, k * 8), dtype=np.uint8)
        bm_np[0] = 1  # one output bit is the parity of all 320 input bits
        matrix = None
    else:
        k, m = (40, 4) if case == "rs_k40_m4" else (32, 32)
        matrix = jgf.reed_sol_vandermonde_coding_matrix(k, m, 8)
        bm_np = np.array(jgm.matrix_to_device_bitmatrix(matrix, 8))
    regions = rng.integers(0, 256, (k, width), dtype=np.uint8)
    want = np.asarray(
        jgm.gf_matrix_regions(jnp.asarray(bm_np), jnp.asarray(regions), w=8)
    )
    got = bitplane_gf.gf8_bitplane_plain(
        torch.from_numpy(bm_np), torch.from_numpy(regions)[None]
    )[0]
    np.testing.assert_array_equal(got.numpy(), want)
    if matrix is not None:
        np.testing.assert_array_equal(
            got.numpy(), jgf.matrix_vector_mul_region(matrix, regions, 8)
        )


@pytest.mark.parametrize("view", ["offset1", "offset2", "offset3", "every_other"])
def test_bitplane_plain_reads_views_like_the_oracle(view):
    # the kernel reads rows at any byte alignment and any batch stride in
    # place; its plain version takes the same views
    matrix = jgf.isa_cauchy_matrix(6, 3)
    base = _rng(40).integers(0, 256, (6, 6, 1031), dtype=np.uint8)
    if view == "every_other":
        x = torch.from_numpy(base)[::2]
    else:
        x = torch.from_numpy(base)[:, :, int(view[-1]) :]
    bm = tgm.matrix_to_device_bitmatrix(matrix, 8, "cpu")
    got = bitplane_gf.gf8_bitplane_stripes(bm, x)
    assert got.is_contiguous() and tuple(got.shape) == (x.shape[0], 3, x.shape[2])
    for s in range(x.shape[0]):
        np.testing.assert_array_equal(
            got[s].numpy(),
            jgf.matrix_vector_mul_region(matrix, np.ascontiguousarray(x[s].numpy()), 8),
        )


def test_layout_fold_is_the_same_on_numpy_and_torch():
    stripes = _rng(9).integers(0, 256, (4, 3, 10), dtype=np.uint8)
    t = torch.from_numpy(stripes)
    np.testing.assert_array_equal(fold_stripes(t).numpy(), fold_stripes(stripes))
    np.testing.assert_array_equal(
        unfold_stripes(fold_stripes(t), 4, 10).numpy(), stripes
    )


def test_device_bitmatrix_is_cached_by_value():
    mat = jgf.isa_rs_matrix(4, 2)
    a = tgm.matrix_to_device_bitmatrix(mat, 8, "cpu")
    b = tgm.matrix_to_device_bitmatrix(mat.astype(np.int32).copy(), 8, "cpu")
    assert a is b
    assert a.dtype == torch.uint8 and tuple(a.shape) == (16, 32)
