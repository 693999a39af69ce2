"""rjenkins1 hash — the only hash CRUSH uses (src/crush/hash.c).

One numpy implementation serves scalars and batches: uint32 arithmetic
wraps naturally, so results are byte-exact against crush_hash32_* for
every arity (seed 1315423911, hash.c:24; mix rounds hash.c:12-22).

The C macro ``crush_hashmix(a, b, c)`` mutates all three of its
arguments in the caller's scope, and the x/y scratch values thread
through successive mix calls — the rebinding chains below reproduce
that dataflow exactly.

Scalars in, python int out; arrays in, uint32 arrays out.  The arity 2
and 3 hashes of python ints (every call the oracle makes) run on python
ints directly, ten times faster than numpy scalars.
"""

from __future__ import annotations

import functools

import numpy as np

CRUSH_HASH_RJENKINS1 = 0
CRUSH_HASH_SEED = np.uint32(1315423911)

_U32 = np.uint32
_X0 = _U32(231232)
_Y0 = _U32(1232)


def _suppress_overflow(fn):
    """uint32 wraparound is the point; one errstate per hash call."""

    @functools.wraps(fn)
    def wrapped(*args):
        with np.errstate(over="ignore"):
            return fn(*args)

    return wrapped


def _mix_inner(a, b, c):
    a = a - b
    a = a - c
    a = a ^ (c >> _U32(13))
    b = b - c
    b = b - a
    b = b ^ (a << _U32(8))
    c = c - a
    c = c - b
    c = c ^ (b >> _U32(13))
    a = a - b
    a = a - c
    a = a ^ (c >> _U32(12))
    b = b - c
    b = b - a
    b = b ^ (a << _U32(16))
    c = c - a
    c = c - b
    c = c ^ (b >> _U32(5))
    a = a - b
    a = a - c
    a = a ^ (c >> _U32(3))
    b = b - c
    b = b - a
    b = b ^ (a << _U32(10))
    c = c - a
    c = c - b
    c = c ^ (b >> _U32(15))
    return a, b, c


def _coerce(*vals):
    arrs = [np.asarray(v).astype(np.uint32) for v in vals]
    scalar = all(a.ndim == 0 for a in arrs)
    return arrs, scalar


_M32 = 0xFFFFFFFF


def _mix_int(a, b, c):
    """_mix_inner on python ints (the oracle's scalar path)."""
    a = (a - b - c) & _M32
    a ^= c >> 13
    b = (b - c - a) & _M32
    b ^= (a << 8) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 13
    a = (a - b - c) & _M32
    a ^= c >> 12
    b = (b - c - a) & _M32
    b ^= (a << 16) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 5
    a = (a - b - c) & _M32
    a ^= c >> 3
    b = (b - c - a) & _M32
    b ^= (a << 10) & _M32
    c = (c - a - b) & _M32
    c ^= b >> 15
    return a, b, c


def _ints(vals):
    """The arguments as u32 python ints when every one is a python int,
    else None (arrays and numpy scalars take the numpy path)."""
    if all(type(v) is int for v in vals):
        return [v & _M32 for v in vals]
    return None


def _ret(h, scalar):
    return int(h) if scalar else h


@_suppress_overflow
def crush_hash32(a):
    (a,), scalar = _coerce(a)
    h = CRUSH_HASH_SEED ^ a
    b = a
    b, x, h = _mix_inner(b, _X0, h)
    y, a, h = _mix_inner(_Y0, a, h)
    return _ret(h, scalar)


def crush_hash32_2(a, b):
    ints = _ints((a, b))
    if ints is not None:
        a, b = ints
        h = 1315423911 ^ a ^ b
        a, b, h = _mix_int(a, b, h)
        x, a, h = _mix_int(231232, a, h)
        b, y, h = _mix_int(b, 1232, h)
        return h
    return _crush_hash32_2(a, b)


@_suppress_overflow
def _crush_hash32_2(a, b):
    (a, b), scalar = _coerce(a, b)
    h = CRUSH_HASH_SEED ^ a ^ b
    a, b, h = _mix_inner(a, b, h)
    x, a, h = _mix_inner(_X0, a, h)
    b, y, h = _mix_inner(b, _Y0, h)
    return _ret(h, scalar)


def crush_hash32_3(a, b, c):
    ints = _ints((a, b, c))
    if ints is not None:
        a, b, c = ints
        h = 1315423911 ^ a ^ b ^ c
        a, b, h = _mix_int(a, b, h)
        c, x, h = _mix_int(c, 231232, h)
        y, a, h = _mix_int(1232, a, h)
        b, x, h = _mix_int(b, x, h)
        y, c, h = _mix_int(y, c, h)
        return h
    return _crush_hash32_3(a, b, c)


@_suppress_overflow
def _crush_hash32_3(a, b, c):
    (a, b, c), scalar = _coerce(a, b, c)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    a, b, h = _mix_inner(a, b, h)
    c, x, h = _mix_inner(c, _X0, h)
    y, a, h = _mix_inner(_Y0, a, h)
    b, x, h = _mix_inner(b, x, h)
    y, c, h = _mix_inner(y, c, h)
    return _ret(h, scalar)


@_suppress_overflow
def crush_hash32_4(a, b, c, d):
    (a, b, c, d), scalar = _coerce(a, b, c, d)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    a, b, h = _mix_inner(a, b, h)
    c, d, h = _mix_inner(c, d, h)
    a, x, h = _mix_inner(a, _X0, h)
    y, b, h = _mix_inner(_Y0, b, h)
    c, x, h = _mix_inner(c, x, h)
    y, d, h = _mix_inner(y, d, h)
    return _ret(h, scalar)


@_suppress_overflow
def crush_hash32_5(a, b, c, d, e):
    (a, b, c, d, e), scalar = _coerce(a, b, c, d, e)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e
    a, b, h = _mix_inner(a, b, h)
    c, d, h = _mix_inner(c, d, h)
    e, x, h = _mix_inner(e, _X0, h)
    y, a, h = _mix_inner(_Y0, a, h)
    b, x, h = _mix_inner(b, x, h)
    y, c, h = _mix_inner(y, c, h)
    d, x, h = _mix_inner(d, x, h)
    y, e, h = _mix_inner(y, e, h)
    return _ret(h, scalar)


def ceph_str_hash_rjenkins(name: bytes | str) -> int:
    """Object-name hash feeding PG placement
    (src/common/ceph_hash.cc ceph_str_hash_rjenkins — Jenkins lookup2
    over the name bytes; the default pg_pool_t object_hash)."""
    if isinstance(name, str):
        name = name.encode("utf-8")
    k = name
    length = len(k)
    a = 0x9E3779B9
    b = a
    c = 0
    M = 0xFFFFFFFF

    def mix(a, b, c):
        a = (a - b - c) & M; a ^= c >> 13
        b = (b - c - a) & M; b ^= (a << 8) & M
        c = (c - a - b) & M; c ^= b >> 13
        a = (a - b - c) & M; a ^= c >> 12
        b = (b - c - a) & M; b ^= (a << 16) & M
        c = (c - a - b) & M; c ^= b >> 5
        a = (a - b - c) & M; a ^= c >> 3
        b = (b - c - a) & M; b ^= (a << 10) & M
        c = (c - a - b) & M; c ^= b >> 15
        return a, b, c

    i = 0
    rem = length
    while rem >= 12:
        a = (a + int.from_bytes(k[i : i + 4], "little")) & M
        b = (b + int.from_bytes(k[i + 4 : i + 8], "little")) & M
        c = (c + int.from_bytes(k[i + 8 : i + 12], "little")) & M
        a, b, c = mix(a, b, c)
        i += 12
        rem -= 12
    c = (c + length) & M
    tail = k[i:]
    if rem >= 11:
        c = (c + (tail[10] << 24)) & M
    if rem >= 10:
        c = (c + (tail[9] << 16)) & M
    if rem >= 9:
        c = (c + (tail[8] << 8)) & M
    if rem >= 8:
        b = (b + (tail[7] << 24)) & M
    if rem >= 7:
        b = (b + (tail[6] << 16)) & M
    if rem >= 6:
        b = (b + (tail[5] << 8)) & M
    if rem >= 5:
        b = (b + tail[4]) & M
    if rem >= 4:
        a = (a + (tail[3] << 24)) & M
    if rem >= 3:
        a = (a + (tail[2] << 16)) & M
    if rem >= 2:
        a = (a + (tail[1] << 8)) & M
    if rem >= 1:
        a = (a + tail[0]) & M
    _a, _b, c = mix(a, b, c)
    return c
