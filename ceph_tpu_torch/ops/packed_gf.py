"""Kernel K1: the packed-lane GF(2^8) region product, and its plain version.

Replaces ``ceph_tpu/ops/packed_gf.py`` ``_make_kernel`` (launched at :179
by ``_packed_call``), the TPU's fast w=8 encode/decode path: bytes stay
packed four per 32-bit lane (byte 4w+q of a region is field q of word w,
little-endian), bit b of the four bytes is taken at once, and the output
bits are deposited back into the packed byte fields.

On this card it is bound by integer instructions (the CUDA source,
``csrc/gf8_kernels.cu`` ``gf8_packed_kernel``, has the count).  For each
input column (j, b) it builds one full-byte mask, each byte 0xFF where bit
b of that input byte is set, and every output row XORs in the mask ANDed
with its column byte replicated into the four fields.  XOR replaces the
TPU's ADD-chain, so the popcount ≤ 255 carry bound does not bind it.  It
reads the (B, k, chunk) stripes in place through their strides: 16 bytes
a thread where every address is 16-byte aligned, 4 otherwise
(``_build.words_per_thread``).  It takes k ≤ 32 and m ≤ 32 (its
shared-memory column table) and 4-byte-aligned rows.  Kernel K2
(``bitplane_gf``) runs the same arithmetic without those limits, and its
plain version is this module's ``word_product_plain`` too.

Not carried over: ``_schedule``'s pair-CSE (trace-time unrolling for
Mosaic; per-matrix specialisation is later performance work) and the
one-array-per-row layout (a workaround for an XLA layout problem).  Word
form here is one (k, nwords) int32 view of the bytes (PyTorch has no
shifts on uint32, so words travel as int32 and the plain version widens
them to int64).

The wrapper takes the plain version only for a CPU tensor; on a CUDA
tensor it launches the kernel or raises.  ``launches`` counts kernel
launches: one a call, two for m > 8 when m is not a multiple of 8 (the
groups of eight rows, then the rest).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

launches = 0
MAX_K = 32
MAX_M = 32
_LSB = 0x01010101
_MSB = 0x80808080
# plain version: words per slice of the chunk axis per stripe row
_PLAIN_SLICE_WORDS = 1 << 24


def supports(bm, w: int) -> bool:
    """Eligibility, as the JAX package routes: w=8, whole 8-bit blocks,
    every output row's popcount ≤ 255 (the TPU's carry bound, kept so
    routing matches), plus this kernel's k ≤ 32 and m ≤ 32."""
    bm = np.asarray(bm)
    return (
        w == 8
        and bm.shape[0] % 8 == 0
        and bm.shape[1] % 8 == 0
        and bm.shape[0] // 8 <= MAX_M
        and bm.shape[1] // 8 <= MAX_K
        and int(bm.sum(axis=1).max(initial=0)) <= 255
    )


def to_words(regions: torch.Tensor) -> torch.Tensor:
    """(k, nbytes) uint8 → (k, nbytes//4) int32 little-endian words — a
    free view of contiguous rows."""
    if regions.shape[-1] % 4:
        raise ValueError(f"width {regions.shape[-1]} is not a multiple of 4")
    return regions.contiguous().view(torch.int32)


def from_words(words: torch.Tensor) -> torch.Tensor:
    """(k, nwords) int32 → (k, nwords*4) uint8 — a free view."""
    return words.contiguous().view(torch.uint8)


def _check(bm, stripes: torch.Tensor) -> None:
    if stripes.dim() != 3 or stripes.dtype != torch.uint8:
        raise ValueError("stripes must be a (B, k, chunk) uint8 tensor")
    b, k, chunk = stripes.shape
    if bm.dim() != 2 or bm.shape[1] != k * 8 or bm.shape[0] % 8:
        raise ValueError(f"bitmatrix {tuple(bm.shape)} does not fit k={k} at w=8")
    m = bm.shape[0] // 8
    if k > MAX_K or m > MAX_M:
        raise ValueError(f"packed kernel takes k, m <= 32, got k={k} m={m}")
    if chunk % 4:
        raise ValueError(f"packed kernel needs chunk % 4 == 0, got {chunk}")


def word_product_plain(bm: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """The arithmetic of both kernels (K1 here, K2 in ``bitplane_gf``) on
    int64 word lanes: for each column c = (j, b), mask = each byte of
    ``x_j << (7 - b)`` set to 0xFF where its bit 7 is set, and
    out_word[i] ^= mask & rep[i, c], where rep[i, c] is the byte of bits
    bm[8i..8i+7, c] in all four fields.  (B, k, chunk) uint8 with
    chunk % 4 == 0 → (B, m, chunk) uint8, a slice of words at a time; any
    k and m."""
    b, k, chunk = stripes.shape
    m = bm.shape[0] // 8
    dev = stripes.device
    rep = (
        bm.to(device=dev, dtype=torch.int64).reshape(m, 8, k * 8)
        << torch.arange(8, device=dev)[None, :, None]
    ).sum(1) * _LSB  # (m, k*8)
    nw = chunk // 4
    out = torch.empty((b, m, nw), dtype=torch.int32, device=dev)
    step = max(1, _PLAIN_SLICE_WORDS // max(1, b * m))
    for s in range(0, nw, step):
        x = (
            stripes[:, :, 4 * s : 4 * (s + step)].contiguous().view(torch.int32)
        ).to(torch.int64) & 0xFFFFFFFF  # (b, k, n)
        acc = torch.zeros((b, m, x.shape[2]), dtype=torch.int64, device=dev)
        for c in range(k * 8):
            j, bit = divmod(c, 8)
            mask = (((x[:, j] << (7 - bit)) & _MSB) >> 7) * 0xFF  # (b, n)
            acc ^= mask[:, None, :] & rep[None, :, c, None]
        # back into int32's range before narrowing (no reliance on wrap)
        out[:, :, s : s + step] = (acc - ((acc >> 31) << 32)).to(torch.int32)
    return out.view(torch.uint8)


def packed_stripes_plain(bm: torch.Tensor, stripes: torch.Tensor) -> torch.Tensor:
    """K1's plain version: ``word_product_plain`` within K1's limits."""
    _check(bm, stripes)
    return word_product_plain(bm, stripes)


def packed_matrix_stripes(bm, stripes: torch.Tensor) -> torch.Tensor:
    """(m·8, k·8) 0/1 bitmatrix applied to (B, k, chunk) uint8 stripes →
    (B, m, chunk) uint8; K1 on a CUDA tensor (stripes read in place, any
    batch/row strides), the plain version on a CPU one."""
    global launches
    if not isinstance(bm, torch.Tensor):
        bm = torch.from_numpy(np.array(bm, dtype=np.uint8))
    if not stripes.is_cuda:
        return packed_stripes_plain(bm, stripes)
    _check(bm, stripes)
    b, k, chunk = stripes.shape
    out = torch.empty(
        (b, bm.shape[0] // 8, chunk), dtype=torch.uint8, device=stripes.device
    )
    if out.numel() == 0:
        # nothing to compute (a zero-length object's shards): an empty
        # tensor's strides are 1, which the alignment test would refuse
        return out
    if stripes.data_ptr() % 4 or stripes.stride(0) % 4 or stripes.stride(1) % 4:
        raise ValueError("packed kernel needs 4-byte aligned stripe rows")
    bm = bm.to(device=stripes.device, dtype=torch.uint8).contiguous()
    _build.launch_stripes("gf8_packed_stripes", bm, stripes, out)
    m = out.shape[1]
    launches += 2 if m > 8 and m % 8 else 1
    return out


def packed_bitmatrix_regions(bm, regions: torch.Tensor) -> torch.Tensor:
    """(k, nbytes) uint8 → (m, nbytes) uint8."""
    return packed_matrix_stripes(bm, regions[None])[0]


def packed_word_regions(bm, words: torch.Tensor) -> torch.Tensor:
    """Word form: (k, nwords) int32 → (m, nwords) int32."""
    return to_words(packed_bitmatrix_regions(bm, from_words(words)))


def prebuilt_word_call(bm, w: int = 8, *, device="cuda"):
    """The word-form product for one bitmatrix, with the bitmatrix placed
    on ``device`` once: returns ``call(words) -> words``.  For callers
    that apply the same matrix repeatedly."""
    bm_np = np.array(bm, dtype=np.uint8)
    if not supports(bm_np, w):
        raise ValueError("packed kernel needs w=8, k, m <= 32, row popcount <= 255")
    bm_dev = torch.from_numpy(bm_np).to(device)
    return lambda words: packed_word_regions(bm_dev, words)
