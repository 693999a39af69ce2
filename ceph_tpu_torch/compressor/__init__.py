"""Compressor plugin family (src/compressor/ — the second consumer of
the dlopen-plugin registry design, CompressionPlugin.h).

Same shape as the erasure-code registry: plugins self-register by
name, ``Compressor.create(name)`` is the factory
(Compressor::create, src/compressor/Compressor.cc), and every plugin
implements the tiny compress/decompress contract.  The reference
ships zlib/snappy/lz4/zstd/brotli (+ QAT offload); here each plugin
wraps the matching Python codec and registers only when its module
imports — exactly how the reference gates plugins on available
libraries at build time.  ``none`` (passthrough) always exists.

On-wire framing: 4-byte little-endian original length + codec bytes,
so decompress can sanity-check expansion (the reference carries the
logical length in the bluestore blob metadata instead).
"""

from __future__ import annotations

__all__ = [
    "Compressor",
    "CompressorError",
    "available",
    "create",
    "register",
]


class CompressorError(Exception):
    pass


_REGISTRY: dict[str, type["Compressor"]] = {}


def register(cls: type["Compressor"]) -> type["Compressor"]:
    _REGISTRY[cls.name] = cls
    return cls


def available() -> list[str]:
    """get_supported_compressors() role."""
    return sorted(_REGISTRY)


def create(name: str) -> "Compressor":
    """Compressor::create — factory by plugin name."""
    cls = _REGISTRY.get(name)
    if cls is None:
        raise CompressorError(
            f"unsupported compressor {name!r} (have {available()})"
        )
    return cls()


class Compressor:
    """The CompressionPlugin contract."""

    name = ""

    def _compress(self, data: bytes) -> bytes:  # pragma: no cover
        raise NotImplementedError

    def _decompress(self, data: bytes) -> bytes:  # pragma: no cover
        raise NotImplementedError

    def compress(self, data: bytes) -> bytes:
        data = bytes(data)
        return len(data).to_bytes(4, "little") + self._compress(data)

    def decompress(self, blob: bytes) -> bytes:
        if len(blob) < 4:
            raise CompressorError("short compressed blob")
        want = int.from_bytes(blob[:4], "little")
        try:
            out = self._decompress(bytes(blob[4:]))
        except Exception as e:
            raise CompressorError(f"{self.name}: {e}") from e
        if len(out) != want:
            raise CompressorError(
                f"{self.name}: length mismatch {len(out)} != {want}"
            )
        return out


@register
class NoneCompressor(Compressor):
    """Passthrough (the 'none' mode)."""

    name = "none"

    def _compress(self, data: bytes) -> bytes:
        return data

    def _decompress(self, data: bytes) -> bytes:
        return data


try:
    import zlib as _zlib

    @register
    class ZlibCompressor(Compressor):
        """ZlibCompressor.cc role."""

        name = "zlib"

        def _compress(self, data: bytes) -> bytes:
            return _zlib.compress(data, 5)

        def _decompress(self, data: bytes) -> bytes:
            return _zlib.decompress(data)

except ImportError:  # pragma: no cover
    pass


try:
    import bz2 as _bz2

    @register
    class Bz2Compressor(Compressor):
        name = "bz2"

        def _compress(self, data: bytes) -> bytes:
            return _bz2.compress(data, 5)

        def _decompress(self, data: bytes) -> bytes:
            return _bz2.decompress(data)

except ImportError:  # pragma: no cover
    pass


try:
    import lzma as _lzma

    @register
    class LzmaCompressor(Compressor):
        name = "lzma"

        def _compress(self, data: bytes) -> bytes:
            return _lzma.compress(data, preset=1)

        def _decompress(self, data: bytes) -> bytes:
            return _lzma.decompress(data)

except ImportError:  # pragma: no cover
    pass


try:
    import zstandard as _zstd

    @register
    class ZstdCompressor(Compressor):
        """ZstdCompressor.cc role."""

        name = "zstd"

        def _compress(self, data: bytes) -> bytes:
            return _zstd.ZstdCompressor(level=3).compress(data)

        def _decompress(self, data: bytes) -> bytes:
            return _zstd.ZstdDecompressor().decompress(data)

except ImportError:  # pragma: no cover
    pass


try:  # pragma: no cover — not in the baked image; gated like the rest
    import snappy as _snappy

    @register
    class SnappyCompressor(Compressor):
        name = "snappy"

        def _compress(self, data: bytes) -> bytes:
            return _snappy.compress(data)

        def _decompress(self, data: bytes) -> bytes:
            return _snappy.decompress(data)

except ImportError:
    pass


try:  # pragma: no cover
    import lz4.frame as _lz4

    @register
    class Lz4Compressor(Compressor):
        name = "lz4"

        def _compress(self, data: bytes) -> bytes:
            return _lz4.compress(data)

        def _decompress(self, data: bytes) -> bytes:
            return _lz4.decompress(data)

except ImportError:
    pass
