"""Binary encoding primitives — the bufferlist encode/decode role.

The reference serializes every wire/disk struct through its denc/
encode framework (src/include/encoding.h): little-endian fixed-width
integers, length-prefixed strings, counted containers, and versioned
struct envelopes (ENCODE_START/ENCODE_FINISH with a compat version and
a byte length so old decoders can skip unknown trailing fields).  This
module provides the same primitives for the framework's own structs
(OSDMap/Incremental, messenger frames, object-store records).

It is deliberately NOT the reference's exact wire format (that would
require feature-bit negotiation and a hundred legacy struct layouts);
it is a clean versioned format with the same design rules: LE, length-
prefixed, versioned envelopes, crc-checkable.  Where we decode the
reference's actual on-disk formats (binary crushmaps), the decoder
lives with that component.
"""

from __future__ import annotations

import struct
from io import BytesIO


class Encoder:
    """Append-only little-endian byte sink (bufferlist::encode role)."""

    def __init__(self):
        self._buf = BytesIO()

    # fixed-width ints
    def u8(self, v: int) -> "Encoder":
        self._buf.write(struct.pack("<B", v & 0xFF))
        return self

    def u16(self, v: int) -> "Encoder":
        self._buf.write(struct.pack("<H", v & 0xFFFF))
        return self

    def u32(self, v: int) -> "Encoder":
        self._buf.write(struct.pack("<I", v & 0xFFFFFFFF))
        return self

    def u64(self, v: int) -> "Encoder":
        self._buf.write(struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF))
        return self

    def s32(self, v: int) -> "Encoder":
        self._buf.write(struct.pack("<i", v))
        return self

    def s64(self, v: int) -> "Encoder":
        self._buf.write(struct.pack("<q", v))
        return self

    def f64(self, v: float) -> "Encoder":
        self._buf.write(struct.pack("<d", v))
        return self

    def bool(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    # variable-size
    def bytes(self, v: bytes) -> "Encoder":
        self.u32(len(v))
        self._buf.write(v)
        return self

    def string(self, v: str) -> "Encoder":
        return self.bytes(v.encode("utf-8"))

    def raw(self, v: bytes) -> "Encoder":
        self._buf.write(v)
        return self

    # containers: u32 count then elements (encoding.h container encode)
    def list(self, items, item_fn) -> "Encoder":
        self.u32(len(items))
        for it in items:
            item_fn(self, it)
        return self

    def map(self, d: dict, key_fn, val_fn) -> "Encoder":
        self.u32(len(d))
        for k in sorted(d):
            key_fn(self, k)
            val_fn(self, d[k])
        return self

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


class Decoder:
    """Cursor over an encoded buffer (bufferlist::const_iterator role).

    Raises ``DecodeError`` (never struct.error/IndexError) on truncated
    or malformed input.
    """

    def __init__(self, data: bytes, pos: int = 0):
        self._data = memoryview(data)
        self._pos = pos

    def _take(self, n: int) -> memoryview:
        if self._pos + n > len(self._data):
            raise DecodeError(
                f"buffer underrun: need {n} at {self._pos}, "
                f"have {len(self._data)}"
            )
        v = self._data[self._pos : self._pos + n]
        self._pos += n
        return v

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def s32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def s64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def bool(self) -> bool:
        return self.u8() != 0

    def bytes(self) -> bytes:
        return bytes(self._take(self.u32()))

    def string(self) -> str:
        return self.bytes().decode("utf-8")

    def raw(self, n: int) -> bytes:
        return bytes(self._take(n))

    def list(self, item_fn) -> list:
        return [item_fn(self) for _ in range(self.u32())]

    def map(self, key_fn, val_fn) -> dict:
        return {key_fn(self): val_fn(self) for _ in range(self.u32())}

    @property
    def pos(self) -> int:
        return self._pos

    def remaining(self) -> int:
        return len(self._data) - self._pos

    def skip(self, n: int) -> None:
        self._take(n)


class DecodeError(Exception):
    pass


# -- versioned struct envelope (ENCODE_START/ENCODE_FINISH) ---------------


def encode_versioned(version: int, compat: int, body: bytes) -> bytes:
    """ENCODE_START(v, compat, bl) ... ENCODE_FINISH: u8 version,
    u8 compat, u32 length, payload (src/include/encoding.h:1312)."""
    e = Encoder()
    e.u8(version).u8(compat).u32(len(body)).raw(body)
    return e.getvalue()


def decode_versioned(
    d: Decoder, understand: int
) -> tuple[int, Decoder]:
    """DECODE_START: returns (struct version, body decoder).  Raises
    DecodeError if compat > understand (we cannot safely interpret);
    unknown trailing fields of newer-but-compatible versions are
    skipped by the caller advancing past the body."""
    version = d.u8()
    compat = d.u8()
    length = d.u32()
    if compat > understand:
        raise DecodeError(
            f"struct compat {compat} > understood {understand}"
        )
    body = Decoder(d.raw(length))
    return version, body
