"""Bit-plane (un)packing for GF(2^w) word regions, in PyTorch.

Layout contract (matches the jerasure bitmatrix convention consumed by
``gf.jerasure_bitmatrix``): a byte region is a sequence of little-endian
w-bit words; bit x of word j is indexed LSB-first, i.e.
``bit(word, x) = (word >> x) & 1``; with little-endian bytes this means
bit x lives in byte ``x // 8`` at in-byte position ``x % 8``.

``unpack_word_bits`` turns (n, nbytes) uint8 regions into (n*w, nwords)
0/1 planes, row ``j*w + x`` holding bit x of region j's words — exactly
the column index space of a (R, n*w) bitmatrix.  ``pack_word_bits`` is
the inverse.  Everything works on bytes, so no 32-bit word type (and no
shift on ``torch.uint32``, which PyTorch does not implement) is needed.
Planes are uint8 0/1 (the JAX package's are int8; the values agree).
"""

from __future__ import annotations

import torch


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def unpack_byte_bits(regions: torch.Tensor) -> torch.Tensor:
    """(r, c) uint8 → (r, c*8) 0/1 uint8, LSB-first per byte."""
    r, c = regions.shape
    bits = (regions[:, :, None] >> _shifts(regions.device)) & 1
    return bits.reshape(r, c * 8)


def pack_byte_bits(bits: torch.Tensor) -> torch.Tensor:
    """(r, c*8) 0/1 → (r, c) uint8 (inverse of unpack_byte_bits)."""
    r, c8 = bits.shape
    if c8 % 8:
        raise ValueError(f"bit count {c8} is not a multiple of 8")
    bits = bits.reshape(r, c8 // 8, 8).to(torch.uint8)
    return (bits << _shifts(bits.device)).sum(-1, dtype=torch.uint8)


def unpack_word_bits(regions: torch.Tensor, w: int) -> torch.Tensor:
    """(n, nbytes) uint8 → (n*w, nwords) uint8 bit planes (values 0/1)."""
    n, nbytes = regions.shape
    if nbytes % (w // 8):
        raise ValueError(f"{nbytes} bytes is not a whole number of w={w} words")
    nwords = nbytes // (w // 8)
    # little-endian bytes: word bit index = 8*byte_in_word + bit_in_byte
    bits = unpack_byte_bits(regions).reshape(n, nwords, w)
    return bits.permute(0, 2, 1).reshape(n * w, nwords)


def pack_word_bits(bits: torch.Tensor, w: int) -> torch.Tensor:
    """(m*w, nwords) 0/1 → (m, nwords * w//8) uint8 regions (inverse)."""
    mw, nwords = bits.shape
    if mw % w:
        raise ValueError(f"{mw} bit rows is not a multiple of w={w}")
    m = mw // w
    bits = bits.reshape(m, w, nwords).permute(0, 2, 1)  # (m, nwords, w)
    return pack_byte_bits(bits.reshape(m, nwords * w)).reshape(
        m, nwords * (w // 8)
    )
