"""ceph_tpu_torch's CUDA kernels on the card: K1 and K2 against their
plain versions and the numpy oracle, and the registry path on
``device="cuda"``.  Marked ``cuda``: skips where there is no GPU.  On a
card (whose Python has no JAX, so without the suite's conftest):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ceph_tpu_torch import gf
from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
from ceph_tpu_torch.ops import bitplane_gf, packed_gf
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
