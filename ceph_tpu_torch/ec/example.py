"""Example XOR code — k=2, m=1 (src/test/erasure-code/ErasureCodeExample.h).

The trivial parity code the reference ships as plugin documentation and
as the registry's test subject; kept here for the same two purposes.
"""

from __future__ import annotations

import numpy as np

from .interface import ErasureCode, ErasureCodeError, ErasureCodeProfile
from .registry import ErasureCodePlugin, register


class ErasureCodeExample(ErasureCode):
    def __init__(self):
        super().__init__()
        self.k = 2
        self.m = 1

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        super().init(profile)

    def get_chunk_size(self, object_size: int) -> int:
        return (object_size + self.k - 1) // self.k

    def encode_chunks(self, want_to_encode, encoded) -> None:
        a = encoded[self.chunk_index(0)]
        b = encoded[self.chunk_index(1)]
        np.bitwise_xor(a, b, out=encoded[self.chunk_index(2)])

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        missing = [
            i for i in range(3) if self.chunk_index(i) not in chunks
        ]
        if len(missing) > 1:
            raise ErasureCodeError(
                f"{len(missing)} erasures exceed m=1 (-EIO)"
            )
        if not missing:
            return
        others = [
            decoded[self.chunk_index(i)] for i in range(3) if i != missing[0]
        ]
        np.bitwise_xor(
            others[0], others[1], out=decoded[self.chunk_index(missing[0])]
        )


@register("example")
class ErasureCodePluginExample(ErasureCodePlugin):
    def make(self, profile: ErasureCodeProfile):
        return ErasureCodeExample()
