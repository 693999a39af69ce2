"""Kernel K2: the bitplane GF(2^8) region product, and its plain version.

Replaces ``ceph_tpu/ops/pallas_gf.py`` ``_kernel`` (launched at :60 by
``gf8_regions_pallas``), which unpacks a (k, 4096) byte tile into k·8 bit
planes, takes a bf16 dot with the (m·8, k·8) 0/1 bitmatrix, masks ``& 1``
and repacks.  It is the w=8 case of ``gf_matmul.gf_matrix_regions`` /
``gf_matrix_stripes``: the batched encode and decode routes of the torch
backend and widths the packed kernel K1 does not take.

On this card it is bound by bytes moved, (k + m) bytes per byte column.
The CUDA kernel (``csrc/gf8_kernels.cu``, ``gf8_bitplane_kernel``) never
forms the planes: a thread gathers its column's k bytes into 32-bit
groups and takes ``popc(row_mask & column) & 1`` per output bit, the
bitmatrix rows held as masks in shared memory.  It reads the stripes in
place through their strides and masks the ragged edge itself, so any
width works: the TPU's ``N % TILE_N == 0`` (``pallas_gf.py:91-95``) was a
tiling artefact and is not kept.

The wrapper takes the plain version only for a CPU tensor; on a CUDA
tensor it launches the kernel or raises.  ``launches`` counts launches.
"""

from __future__ import annotations

import torch

from ..layout import fold_stripes, unfold_stripes
from . import _build
from .gf_matmul import word_regions_plain

launches = 0
# shared-memory rows the kernel can hold: m*8*ceil(k/4) u32 in 227 KB
_MAX_SHARED = 232448
# plain version: bytes of input per slice (its float32 planes are 32x)
_PLAIN_SLICE_BYTES = 1 << 26


def _check(bm: torch.Tensor, stripes: torch.Tensor) -> None:
    if stripes.dim() != 3 or stripes.dtype != torch.uint8:
        raise ValueError("stripes must be a (B, k, chunk) uint8 tensor")
    k = stripes.shape[1]
    if bm.dim() != 2 or bm.shape[1] != k * 8 or bm.shape[0] % 8:
        raise ValueError(
            f"bitmatrix {tuple(bm.shape)} does not fit k={k} at w=8"
        )


def gf8_bitplane_plain(bm: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """K2's plain version: unpack → mod2_matmul → pack on the folded
    stripes, one slice of byte columns at a time so the float32 planes
    stay bounded.  (B, k, chunk) uint8 → (B, m, chunk) uint8."""
    _check(bm, stripes)
    b, k, chunk = stripes.shape
    regions = fold_stripes(stripes)
    out = torch.empty(
        (bm.shape[0] // 8, b * chunk), dtype=torch.uint8, device=stripes.device
    )
    step = max(1, _PLAIN_SLICE_BYTES // k)
    for s in range(0, b * chunk, step):
        out[:, s : s + step] = word_regions_plain(bm, regions[:, s : s + step], 8)
    return unfold_stripes(out, b, chunk).contiguous()


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
    if m * 8 * ((k + 3) // 4) * 4 > _MAX_SHARED:
        raise ValueError(f"k={k}, m={m}: bitmatrix rows exceed shared memory")
    bm = bm.to(device=stripes.device, dtype=torch.uint8).contiguous()
    out = torch.empty((b, m, chunk), dtype=torch.uint8, device=stripes.device)
    _build.launch_stripes("gf8_bitplane_stripes", bm, stripes, out)
    launches += 1
    return out


def gf8_bitplane_regions(bm: torch.Tensor, regions: torch.Tensor) -> torch.Tensor:
    """(k, N) uint8 regions → (m, N) uint8 (the ``gf8_regions_pallas``
    contract without its width constraint)."""
    return gf8_bitplane_stripes(bm, regions[None])[0]
