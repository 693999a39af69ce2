"""ceph_tpu_torch packed kernel K1's plain version held against ceph_tpu's
packed-lane Pallas kernel (interpret mode) and the numpy oracle, over
tests/test_packed_gf.py's cases and the shapes where the CUDA kernel
changes form (rows per register group, words per thread, strides).
Byte-exact: tolerance 0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.gf import matrix_vector_mul_region
from ceph_tpu.gf.matrix import (
    isa_cauchy_matrix,
    make_decoding_matrix,
    reed_sol_vandermonde_coding_matrix,
)
from ceph_tpu.ops import gf_matmul as jgm
from ceph_tpu.ops import packed_gf as jpacked
from ceph_tpu.ops.gf_matmul import matrix_to_device_bitmatrix as j_bitmatrix
from ceph_tpu_torch.ops import packed_gf
from ceph_tpu_torch.ops.gf_matmul import matrix_to_device_bitmatrix


def _check(matrix, k, nbytes, seed):
    bm_np = np.asarray(j_bitmatrix(matrix, 8))
    bm = matrix_to_device_bitmatrix(matrix, 8, "cpu")
    np.testing.assert_array_equal(bm.numpy(), bm_np)
    assert packed_gf.supports(bm_np, 8)
    regions = np.random.default_rng(seed).integers(0, 256, (k, nbytes), dtype=np.uint8)
    want = np.asarray(jpacked.packed_bitmatrix_regions(bm_np, regions, interpret=True))
    got = packed_gf.packed_bitmatrix_regions(bm, torch.from_numpy(regions))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), matrix_vector_mul_region(matrix, regions, 8)
    )


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3), (10, 4)])
def test_encode_matches_packed_kernel(k, m):
    _check(reed_sol_vandermonde_coding_matrix(k, m, 8), k, 4096, k)


def test_cauchy_and_tail_matches_packed_kernel():
    # 4100 bytes: not a multiple of the TPU tile width
    _check(isa_cauchy_matrix(6, 3), 6, 4100, 11)


def test_decode_matrix_matches_packed_kernel():
    k, m = 8, 3
    enc = reed_sol_vandermonde_coding_matrix(k, m, 8)
    dec, _survivors = make_decoding_matrix(enc, [1, 6], k, 8)
    _check(np.asarray(dec), k, 2048, 12)


def test_stripes_layout_matches_packed_kernel():
    k, m = 8, 3
    mat = reed_sol_vandermonde_coding_matrix(k, m, 8)
    bm_np = np.asarray(j_bitmatrix(mat, 8))
    stripes = np.random.default_rng(13).integers(0, 256, (5, k, 512), dtype=np.uint8)
    want = np.asarray(jpacked.packed_matrix_stripes(bm_np, stripes, interpret=True))
    t = torch.from_numpy(stripes)
    got = packed_gf.packed_matrix_stripes(bm_np, t)
    np.testing.assert_array_equal(got.numpy(), want)
    # strided stripes: every other stripe of a larger batch, read in place
    wide = torch.from_numpy(
        np.random.default_rng(14).integers(0, 256, (6, k, 512), dtype=np.uint8)
    )
    got = packed_gf.packed_matrix_stripes(bm_np, wide[::2])
    for s in range(3):
        np.testing.assert_array_equal(
            got[s].numpy(), matrix_vector_mul_region(mat, wide[2 * s].numpy(), 8)
        )


@pytest.mark.parametrize(
    "k,m,nbytes,case",
    [
        (8, 1, 4096, "regions"),  # rows held in registers: R = m up to 8
        (8, 5, 4096, "regions"),
        (8, 8, 4096, "regions"),
        (8, 9, 4096, "regions"),  # m > 8: a group of eight, then one more row
        # the largest column table, narrow; held against the JAX package's
        # XLA bitplane product, since the Pallas kernel unrolls 256 ADD-chains
        # of up to 256 terms at trace time and takes minutes in interpret mode
        (32, 32, 256, "xla"),
        (6, 3, 4100, "regions"),  # chunk % 16 == 4, 8, 12: one word a thread
        (6, 3, 4104, "regions"),
        (6, 3, 4108, "regions"),
        (8, 9, 1040, "strided"),  # every other stripe of a batch, read in place
    ],
)
def test_plain_matches_packed_kernel_across_shapes(k, m, nbytes, case):
    mat = reed_sol_vandermonde_coding_matrix(k, m, 8)
    bm_np = np.asarray(j_bitmatrix(mat, 8))
    bm = matrix_to_device_bitmatrix(mat, 8, "cpu")
    if case == "regions":
        _check(mat, k, nbytes, k * 100 + m + nbytes)
    elif case == "xla":
        assert packed_gf.supports(bm_np, 8)
        regions = np.random.default_rng(m).integers(0, 256, (k, nbytes), dtype=np.uint8)
        got = packed_gf.packed_bitmatrix_regions(bm, torch.from_numpy(regions)).numpy()
        want = np.asarray(
            jgm.gf_matrix_regions(jnp.asarray(bm_np), jnp.asarray(regions), w=8)
        )
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, matrix_vector_mul_region(mat, regions, 8))
    else:
        wide = np.random.default_rng(m).integers(0, 256, (6, k, nbytes), dtype=np.uint8)
        want = np.asarray(
            jpacked.packed_matrix_stripes(
                bm_np, np.ascontiguousarray(wide[::2]), interpret=True
            )
        )
        got = packed_gf.packed_matrix_stripes(bm, torch.from_numpy(wide)[::2])
        np.testing.assert_array_equal(got.numpy(), want)
        for s in range(3):
            np.testing.assert_array_equal(
                got[s].numpy(), matrix_vector_mul_region(mat, wide[2 * s], 8)
            )


def test_supports_guard():
    mat = reed_sol_vandermonde_coding_matrix(4, 2, 8)
    bm = np.asarray(j_bitmatrix(mat, 8))
    assert packed_gf.supports(bm, 8) == jpacked.supports(bm, 8) is True
    assert not packed_gf.supports(bm, 16)
    dense = np.ones((8, 64 * 40), dtype=np.uint8)  # popcount 2560 > 255
    assert not packed_gf.supports(dense, 8)
    # within the TPU's carry bound but past this kernel's k <= 32
    wide = np.asarray(j_bitmatrix(reed_sol_vandermonde_coding_matrix(40, 4, 8), 8))
    assert jpacked.supports(wide, 8) and not packed_gf.supports(wide, 8)


def test_word_form_views_and_prebuilt_call():
    mat = isa_cauchy_matrix(4, 2)
    bm_np = np.asarray(j_bitmatrix(mat, 8))
    regions = np.random.default_rng(15).integers(0, 256, (4, 256), dtype=np.uint8)
    words = packed_gf.to_words(torch.from_numpy(regions))
    assert words.dtype == torch.int32 and tuple(words.shape) == (4, 64)
    np.testing.assert_array_equal(words.numpy(), regions.view(np.uint32).view(np.int32))
    np.testing.assert_array_equal(packed_gf.from_words(words).numpy(), regions)
    call = packed_gf.prebuilt_word_call(bm_np, 8, device="cpu")
    want = jpacked.prebuilt_word_call(bm_np, 8, interpret=True)(
        *jpacked.to_words(regions)
    )
    got = packed_gf.from_words(call(words)).numpy()
    np.testing.assert_array_equal(got, jpacked.from_words([np.asarray(o) for o in want]))


def test_kernel_limits_raise():
    bm = matrix_to_device_bitmatrix(reed_sol_vandermonde_coding_matrix(4, 2, 8), 8, "cpu")
    with pytest.raises(ValueError):
        packed_gf.packed_bitmatrix_regions(bm, torch.zeros((4, 102), dtype=torch.uint8))
    with pytest.raises(ValueError):
        packed_gf.packed_bitmatrix_regions(bm, torch.zeros((3, 100), dtype=torch.uint8))
