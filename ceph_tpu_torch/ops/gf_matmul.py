"""GF(2^w) region math as mod-2 matrix products, in PyTorch.

The reference computes ``coding[i] = Σ_j M[i,j] ⊗ data[j]`` with per-
coefficient table-lookup region passes (jerasure_matrix_encode /
ec_encode_data, SURVEY.md §3.1).  Multiplication by a constant in
GF(2^w) is linear over GF(2), so the whole matrix lifts to a
(m·w, k·w) bitmatrix B and the product is

    bits_out = (B @ bits_in) & 1

Decode is the same product with the inverted-survivor-submatrix rows
(built host-side, tiny).

Two bit layouts share the primitive:

- word layout (matrix techniques, w ∈ {8,16,32}): bit x of each
  little-endian w-bit word → ``gf_matrix_regions``.  At w=8 this goes
  through kernel K2 (``ops.bitplane_gf``), whose plain version is
  ``word_regions_plain`` below.
- packet layout (bitmatrix techniques: cauchy/liberation XOR schedules):
  regions are blocks of w packets of ``packetsize`` bytes; B works on
  whole packets, bytes are opaque → ``bitmatrix_packet_regions``, plain
  PyTorch on whichever device the tensors are on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import gf
from ..layout import fold_stripes, unfold_stripes
from .bitops import (
    pack_byte_bits,
    pack_word_bits,
    unpack_byte_bits,
    unpack_word_bits,
)


def mod2_matmul(bm: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(R, C) 0/1 @ (C, N) 0/1 → (R, N) 0/1 uint8.

    A float32 product of 0/1 operands is exact while the sums stay below
    2^24; here they are at most C = k·w.  TF32 would keep only 10
    mantissa bits and round sums above 2^11, so it is switched off for
    CUDA matmuls before the product (PyTorch's default, set explicitly
    because a caller may have turned it on).  ``int8 @ int8`` would wrap
    in int8, which keeps the parity but not ``mod2_matmul``'s contract."""
    if bits.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    acc = bm.to(torch.float32) @ bits.to(torch.float32)
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def word_regions_plain(
    bm: torch.Tensor, regions: torch.Tensor, w: int
) -> torch.Tensor:
    """unpack → mod2_matmul → pack: (k, nbytes) uint8 → (m, nbytes)."""
    return pack_word_bits(mod2_matmul(bm, unpack_word_bits(regions, w)), w)


def gf_matrix_regions(
    bm: torch.Tensor, regions: torch.Tensor, *, w: int
) -> torch.Tensor:
    """Apply a GF(2^w) coding matrix, given as its (m·w, k·w) bitmatrix,
    to (k, nbytes) uint8 regions → (m, nbytes) uint8.  w=8 launches K2
    on a CUDA tensor."""
    if w == 8:
        from .bitplane_gf import gf8_bitplane_regions

        return gf8_bitplane_regions(bm, regions)
    return word_regions_plain(bm, regions, w)


def gf_matrix_stripes(
    bm: torch.Tensor, stripes: torch.Tensor, *, w: int
) -> torch.Tensor:
    """Batched encode: (B, k, chunk_bytes) → (B, m, chunk_bytes).

    The ECUtil::encode per-stripe loop (src/osd/ECUtil.cc:123-162) hoisted
    into one device call.  At w=8 K2 reads the stripes in place; other
    word sizes fold the stripes into the byte axis."""
    if w == 8:
        from .bitplane_gf import gf8_bitplane_stripes

        return gf8_bitplane_stripes(bm, stripes)
    b, _k, chunk = stripes.shape
    out = gf_matrix_regions(bm, fold_stripes(stripes), w=w)
    return unfold_stripes(out, b, chunk)


def bitmatrix_packet_regions(
    bm: torch.Tensor, regions: torch.Tensor, *, w: int, packetsize: int
) -> torch.Tensor:
    """jerasure_bitmatrix_dotprod contract: each region is blocks of w
    packets of ``packetsize`` bytes; output packet i of each block is the
    XOR of input packets j where bm[i, j] == 1."""
    n, size = regions.shape
    out_rows = bm.shape[0] // w
    block = w * packetsize
    if size % block:
        raise ValueError(f"region size {size} is not a multiple of {block}")
    nblocks = size // block
    # (n, size) → packet planes (n*w, nblocks*packetsize): row j*w+p is
    # packet p of region j, blocks laid out contiguously per row.
    planes = (
        regions.reshape(n, nblocks, w, packetsize)
        .permute(0, 2, 1, 3)
        .reshape(n * w, nblocks * packetsize)
    )
    out = pack_byte_bits(mod2_matmul(bm, unpack_byte_bits(planes)))
    return (
        out.reshape(out_rows, w, nblocks, packetsize)
        .permute(0, 2, 1, 3)
        .reshape(out_rows, size)
    )


@functools.lru_cache(maxsize=512)
def _bitmatrix_cache(key: bytes, shape: tuple, w: int, device: str):
    mat = np.frombuffer(key, dtype=np.int64).reshape(shape)
    return torch.as_tensor(
        gf.jerasure_bitmatrix(mat, w), dtype=torch.uint8, device=device
    ).contiguous()


def matrix_to_device_bitmatrix(
    matrix: np.ndarray, w: int, device
) -> torch.Tensor:
    """Lift a GF(2^w) matrix (numpy, any int dtype) to its (m·w, k·w)
    0/1 uint8 bitmatrix on ``device``, cached by value — the bitmatrix
    expansion and the upload happen once per distinct (matrix, w, device)
    (the analog of ErasureCodeIsaTableCache's one-time per-signature
    table preparation).  This is the state the kernels read."""
    mat = np.ascontiguousarray(matrix, dtype=np.int64)
    return _bitmatrix_cache(mat.tobytes(), mat.shape, w, str(torch.device(device)))
