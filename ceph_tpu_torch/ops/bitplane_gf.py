"""Kernel K2: the bitplane GF(2^8) region product, and its plain version.

Replaces ``ceph_tpu/ops/pallas_gf.py`` ``_kernel`` (launched at :60 by
``gf8_regions_pallas``), which unpacks a (k, 4096) byte tile into k·8 bit
planes, takes a bf16 dot with the (m·8, k·8) 0/1 bitmatrix, masks ``& 1``
and repacks.  It is the w=8 case of ``gf_matmul.gf_matrix_regions`` /
``gf_matrix_stripes``: the batched encode and decode routes of the torch
backend and the w=8 products kernel K1 does not take.

What it keeps from the TPU kernel is the bitmatrix product; the planes,
the popcounts and the bf16 dot do not pay on this card (the CUDA source,
``csrc/gf8_kernels.cu`` ``gf8_bitplane_kernel``, gives the counts).  It
runs K1's arithmetic: one full-byte mask per input bit, shared by every
output row, and one AND-XOR per row.  It keeps its own contract, which is
wider than K1's: any chunk width (the TPU's ``N % TILE_N == 0``,
``pallas_gf.py:91-95``, was a tiling artefact), any byte alignment of the
rows, read in place through their strides, and any k and m of a GF(2^8)
code.  It computes at most eight output rows a launch, as many as its
shared-memory table of k·8 words per row holds (``rows_per_launch``), so
a larger m takes one launch per group of rows.

The wrapper takes the plain version only for a CPU tensor; on a CUDA
tensor it launches the kernel or raises.  ``launches`` counts kernel
launches, one per group of rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .packed_gf import word_product_plain

launches = 0


def _check(bm: torch.Tensor, stripes: torch.Tensor) -> None:
    if stripes.dim() != 3 or stripes.dtype != torch.uint8:
        raise ValueError("stripes must be a (B, k, chunk) uint8 tensor")
    k = stripes.shape[1]
    if bm.dim() != 2 or bm.shape[1] != k * 8 or bm.shape[0] % 8:
        raise ValueError(
            f"bitmatrix {tuple(bm.shape)} does not fit k={k} at w=8"
        )


def gf8_bitplane_plain(bm: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """K2's plain version: the kernels' shared arithmetic
    (``packed_gf.word_product_plain``) on the stripes, the chunk padded
    with zeros to a multiple of 4 and cut back.  (B, k, chunk) uint8 →
    (B, m, chunk) uint8."""
    _check(bm, stripes)
    chunk = stripes.shape[2]
    if chunk % 4:
        stripes = F.pad(stripes, (0, -chunk % 4))
    return word_product_plain(bm, stripes)[:, :, :chunk].contiguous()


def rows_per_launch(k: int, m: int) -> int:
    """Output rows one launch of K2 computes, as the C entry decides it:
    at most 8, and no more than its shared-memory table holds; 0 where
    not one row's table fits."""
    return _build.library().gf8_bitplane_rows(k, m)


def gf8_bitplane_stripes(bm: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """(m·8, k·8) 0/1 bitmatrix applied to (B, k, chunk) uint8 stripes →
    (B, m, chunk) uint8; K2 on a CUDA tensor, the plain version on a CPU
    one."""
    global launches
    if not stripes.is_cuda:
        return gf8_bitplane_plain(bm, stripes)
    _check(bm, stripes)
    b, k, chunk = stripes.shape
    m = bm.shape[0] // 8
    out = torch.empty((b, m, chunk), dtype=torch.uint8, device=stripes.device)
    if out.numel() == 0:
        return out
    rows = rows_per_launch(k, m)
    if rows < 1:
        raise ValueError(f"k={k}: one output row's table exceeds shared memory")
    bm = bm.to(device=stripes.device, dtype=torch.uint8).contiguous()
    _build.launch_stripes("gf8_bitplane_stripes", bm, stripes, out)
    launches += -(-m // rows)
    return out


def gf8_bitplane_regions(bm: torch.Tensor, regions: torch.Tensor) -> torch.Tensor:
    """(k, N) uint8 regions → (m, N) uint8 (the ``gf8_regions_pallas``
    contract without its width constraint)."""
    return gf8_bitplane_stripes(bm, regions[None])[0]
