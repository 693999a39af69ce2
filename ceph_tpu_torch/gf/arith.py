"""Scalar and vectorized GF(2^w) arithmetic over numpy.

This is the CPU oracle (SURVEY.md §7 Phase 0): every kernel result is
checked byte-for-byte against these functions.  w=8 and w=16 use log/exp
tables (the generator alpha=2 is primitive for both default polynomials);
w=32 uses shift-and-add carryless multiplication (log tables would need
2^32 entries).
"""

from __future__ import annotations

import functools

import numpy as np

# Default primitive polynomials of gf-complete / isa-l (see package docstring).
PRIM_POLY = {8: 0x11D, 16: 0x1100B, 32: 0x400007}

_DTYPE = {8: np.uint8, 16: np.uint16, 32: np.uint32}


@functools.lru_cache(maxsize=None)
def _tables(w: int):
    """(exp, log) tables for GF(2^w), w in {8, 16}.

    exp has 2*(2^w - 1) entries so exp[log a + log b] never needs a mod.
    log[0] is unused (set to 0); gf_mul handles zeros explicitly.
    """
    if w not in (8, 16):
        raise ValueError(f"log/exp tables only for w in (8, 16), got {w}")
    order = (1 << w) - 1
    poly = PRIM_POLY[w]
    exp = np.zeros(2 * order, dtype=np.uint32)
    log = np.zeros(1 << w, dtype=np.uint32)
    x = 1
    for i in range(order):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x >> w:
            x ^= poly
    if x != 1:  # alpha=2 must be primitive for the chosen polynomial
        raise AssertionError(f"2 is not primitive for poly {poly:#x}")
    exp[order : 2 * order] = exp[:order]
    return exp, log


def gf_exp_table(w: int) -> np.ndarray:
    return _tables(w)[0]


def gf_log_table(w: int) -> np.ndarray:
    return _tables(w)[1]


def _clmul32(a: int, b: int) -> int:
    """Multiply in GF(2^32) by shift-and-add with reduction by PRIM_POLY[32]."""
    poly = PRIM_POLY[32]
    a &= 0xFFFFFFFF
    b &= 0xFFFFFFFF
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> 32:
            a = (a ^ poly) & 0xFFFFFFFF
    return r


def gf_mul_scalar(a: int, b: int, w: int = 8) -> int:
    """Scalar GF(2^w) product (python ints)."""
    if a == 0 or b == 0:
        return 0
    if w == 32:
        return _clmul32(a, b)
    exp, log = _tables(w)
    return int(exp[int(log[a]) + int(log[b])])


def gf_pow_scalar(a: int, n: int, w: int = 8) -> int:
    """a**n in GF(2^w) by square-and-multiply."""
    r = 1
    base = a
    while n:
        if n & 1:
            r = gf_mul_scalar(r, base, w)
        base = gf_mul_scalar(base, base, w)
        n >>= 1
    return r


def gf_inv(a: int, w: int = 8) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of 0 in GF(2^w)")
    if w == 32:
        # a^(2^32 - 2)
        return gf_pow_scalar(a, (1 << 32) - 2, w)
    exp, log = _tables(w)
    order = (1 << w) - 1
    return int(exp[(order - int(log[a])) % order])


def gf_div(a: int, b: int, w: int = 8) -> int:
    if b == 0:
        raise ZeroDivisionError("division by 0 in GF(2^w)")
    if a == 0:
        return 0
    return gf_mul_scalar(a, gf_inv(b, w), w)


def gf_mul(a: np.ndarray, b: np.ndarray, w: int = 8) -> np.ndarray:
    """Elementwise GF(2^w) product of two arrays (w in {8, 16})."""
    if w == 32:
        raise NotImplementedError("vectorized w=32 mul: use region_mul")
    exp, log = _tables(w)
    a = np.asarray(a)
    b = np.asarray(b)
    out = exp[log[a.astype(np.uint32)] + log[b.astype(np.uint32)]]
    out = np.where((a == 0) | (b == 0), 0, out)
    return out.astype(_DTYPE[w])


def region_xor(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """XOR src into dst (bytes); returns dst."""
    np.bitwise_xor(dst, src, out=dst)
    return dst


@functools.lru_cache(maxsize=256)
def _byte_table8(c: int) -> np.ndarray:
    """The 256-entry multiply-by-c table for w=8 (galois_w08 region
    table), cached per coefficient instead of rebuilt per call."""
    exp, log = _tables(8)
    table = np.zeros(256, dtype=np.uint8)
    nz = np.arange(1, 256, dtype=np.uint32)
    table[1:] = exp[log[nz] + int(log[c])].astype(np.uint8)
    return table


@functools.lru_cache(maxsize=256)
def _pair_table8(c: int) -> np.ndarray:
    """(65536,) LITTLE-ENDIAN uint16 pair table: entry for the
    little-endian byte pair (b0, b1) holds (T[b0], T[b1]) in the same
    order, so a region's free ``<u2`` view gathers two bytes per
    lookup.  The explicit ``<u2`` dtype keeps the output byte order
    right on big-endian hosts too (a native-endian view would swap
    the pair there)."""
    t = _byte_table8(c)
    idx = np.arange(65536, dtype=np.uint32)
    return (
        t[idx & 255].astype(np.uint16)
        | (t[idx >> 8].astype(np.uint16) << 8)
    ).astype("<u2")


def region_mul(region: np.ndarray, c: int, w: int = 8) -> np.ndarray:
    """Multiply every w-bit word of a byte region by constant c.

    Matches galois_wNN_region_multiply: the region is interpreted as
    native-little-endian w-bit words.  Returns a new uint8 array.
    """
    region = np.ascontiguousarray(region, dtype=np.uint8)
    if c == 0:
        return np.zeros_like(region)
    if c == 1:
        return region.copy()
    if w == 8:
        if region.nbytes % 2 == 0:
            # pair path: ONE gather maps TWO bytes — the u16 view of
            # the FLATTENED region indexes a cached 64K pair table
            # directly (no index arithmetic), halving the gather
            # traffic that bounds the host encode rate (the
            # gf-complete SPLIT_TABLE(8,16) idea in numpy terms).
            # Flatten first: a multi-dim region with an odd last axis
            # cannot be u16-viewed in place
            words = region.reshape(-1).view("<u2")
            return (
                _pair_table8(int(c))[words]
                .view(np.uint8)
                .reshape(region.shape)
            )
        return _byte_table8(int(c))[region]
    if w == 16:
        exp, log = _tables(16)
        words = region.view("<u2").astype(np.uint32)
        out = exp[log[words] + int(log[c])].astype(np.uint16)
        out[words == 0] = 0
        return out.astype("<u2").view(np.uint8).reshape(region.shape)
    if w == 32:
        words = region.view("<u4").astype(np.uint64)
        acc = np.zeros_like(words)
        a = np.uint64(c)
        poly = np.uint64(PRIM_POLY[32])
        cur = words.copy()
        for bit in range(32):
            if (int(a) >> bit) & 1:
                acc ^= cur
            carry = (cur >> np.uint64(31)) & np.uint64(1)
            cur = (cur << np.uint64(1)) & np.uint64(0xFFFFFFFF)
            cur ^= carry * poly
        return acc.astype("<u4").view(np.uint8).reshape(region.shape)
    raise ValueError(f"unsupported w={w}")
