"""ErasureCode base class — the contract every code family implements.

Python rendering of the reference interface and base-class semantics
(src/erasure-code/ErasureCodeInterface.h:170-462, ErasureCode.cc:42-242):
systematic codes over k data + m coding chunks; objects are padded to k
equal chunks of ``get_chunk_size(object_size)`` bytes; ``encode`` splits,
pads and delegates to ``encode_chunks``; ``decode`` returns available
chunks directly or allocates and delegates to ``decode_chunks``; chunk
remapping via the ``mapping=DDD_D_`` profile string; greedy
``minimum_to_decode``.

Chunks are numpy uint8 arrays; the chunk dict is keyed by chunk id
(position), exactly like the reference's ``map<int, bufferlist>``.
"""

from __future__ import annotations

import numpy as np

SIMD_ALIGN = 32  # ErasureCode.cc:42 — kept for layout parity


class ErasureCodeError(Exception):
    """Profile or decode errors (the reference's -EINVAL/-EIO paths)."""


class ErasureCodeProfile(dict):
    """str->str map, as in ErasureCodeInterface.h:155."""


def to_int(name, profile, default, ss=None):
    v = profile.get(name, None)
    if v is None or v == "":
        profile[name] = str(default)
        return int(default)
    try:
        return int(v)
    except ValueError:
        raise ErasureCodeError(f"{name}={v} is not a valid int")


def to_bool(name, profile, default, ss=None):
    v = profile.get(name, None)
    if v is None or v == "":
        profile[name] = str(default)
        v = str(default)
    return str(v).lower() in ("yes", "true", "1")


def to_string(name, profile, default, ss=None):
    v = profile.get(name, None)
    if v is None:
        profile[name] = default
        return default
    return v


class ErasureCode:
    """Base class; subclasses set k/m and implement encode_chunks /
    decode_chunks / get_chunk_size."""

    def __init__(self):
        self.k = 0
        self.m = 0
        self.chunk_mapping: list[int] = []
        self._profile: ErasureCodeProfile = ErasureCodeProfile()
        self.rule_root = "default"
        self.rule_failure_domain = "host"
        self.rule_device_class = ""

    # -- profile ----------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.rule_root = to_string("crush-root", profile, "default")
        self.rule_failure_domain = to_string(
            "crush-failure-domain", profile, "host"
        )
        self.rule_device_class = to_string("crush-device-class", profile, "")
        self._profile = profile

    def parse(self, profile: ErasureCodeProfile) -> None:
        """Parse the common ``mapping`` profile key (ErasureCode.cc:261-280):
        chunk_mapping[logical chunk, data first] = physical position."""
        mapping = profile.get("mapping")
        if mapping:
            data_positions = []
            coding_positions = []
            for position, c in enumerate(mapping):
                (data_positions if c == "D" else coding_positions).append(
                    position
                )
            self.chunk_mapping = data_positions + coding_positions

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    # -- geometry ---------------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_chunk_size(self, object_size: int) -> int:
        raise NotImplementedError

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    # -- encode -----------------------------------------------------------
    def encode_prepare(self, raw: bytes | np.ndarray) -> dict[int, np.ndarray]:
        """Split + zero-pad input into k aligned data chunks and allocate m
        coding chunks (ErasureCode.cc:151-186 semantics, including the
        partial-trailing-chunk zero fill)."""
        raw = np.frombuffer(bytes(raw), dtype=np.uint8) if isinstance(
            raw, (bytes, bytearray, memoryview)
        ) else np.ascontiguousarray(raw, dtype=np.uint8).ravel()
        k, m = self.k, self.m
        if len(raw) == 0:
            raise ErasureCodeError("cannot encode an empty payload")
        blocksize = self.get_chunk_size(len(raw))
        padded_chunks = k - len(raw) // blocksize
        encoded: dict[int, np.ndarray] = {}
        for i in range(k - padded_chunks):
            encoded[self.chunk_index(i)] = raw[
                i * blocksize : (i + 1) * blocksize
            ].copy()
        if padded_chunks:
            remainder = len(raw) - (k - padded_chunks) * blocksize
            buf = np.zeros(blocksize, dtype=np.uint8)
            buf[:remainder] = raw[(k - padded_chunks) * blocksize :]
            encoded[self.chunk_index(k - padded_chunks)] = buf
            for i in range(k - padded_chunks + 1, k):
                encoded[self.chunk_index(i)] = np.zeros(
                    blocksize, dtype=np.uint8
                )
        for i in range(k, k + m):
            encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        return encoded

    def encode(
        self, want_to_encode: set[int], raw: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        encoded = self.encode_prepare(raw)
        self.encode_chunks(set(range(self.k + self.m)), encoded)
        for i in range(self.k + self.m):
            if i not in want_to_encode:
                encoded.pop(i, None)
        return encoded

    def encode_chunks(
        self, want_to_encode: set[int], encoded: dict[int, np.ndarray]
    ) -> None:
        raise NotImplementedError

    # -- decode -----------------------------------------------------------
    def decode(
        self,
        want_to_read: set[int],
        chunks: dict[int, np.ndarray],
        chunk_size: int = 0,
    ) -> dict[int, np.ndarray]:
        return self._decode(want_to_read, chunks)

    def _decode(
        self, want_to_read: set[int], chunks: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        """ErasureCode.cc:206-242; note there is deliberately no
        have-at-least-k guard — non-MDS codes (shec) decode from fewer
        than k chunks, and each code family raises -EIO itself when its
        recovery system is unsolvable."""
        have = set(chunks)
        if want_to_read <= have:
            return {i: chunks[i] for i in want_to_read}
        k, m = self.k, self.m
        if not chunks:
            raise ErasureCodeError("no chunks to decode from (-EIO)")
        blocksize = len(next(iter(chunks.values())))
        decoded: dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i in chunks:
                decoded[i] = chunks[i].copy()
            else:
                decoded[i] = np.zeros(blocksize, dtype=np.uint8)
        self.decode_chunks(want_to_read, chunks, decoded)
        return decoded

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: dict[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        raise NotImplementedError

    def decode_concat(self, chunks: dict[int, np.ndarray]) -> np.ndarray:
        """Decode and concatenate the data chunks in logical order
        (ErasureCode.cc:332)."""
        want = {self.chunk_index(i) for i in range(self.k)}
        decoded = self._decode(want, chunks)
        return np.concatenate(
            [decoded[self.chunk_index(i)] for i in range(self.k)]
        )

    # -- minimum ----------------------------------------------------------
    def _minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        if want_to_read <= available:
            return set(want_to_read)
        if len(available) < self.k:
            raise ErasureCodeError("not enough chunks to decode (-EIO)")
        return set(sorted(available)[: self.k])

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        ids = self._minimum_to_decode(want_to_read, available)
        sub = [(0, self.get_sub_chunk_count())]
        return {i: list(sub) for i in sorted(ids)}

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: dict[int, int]
    ) -> set[int]:
        return self._minimum_to_decode(want_to_read, set(available))

    # -- crush ------------------------------------------------------------
    def create_rule(self, name: str, crush, ss=None) -> int:
        """ErasureCode.cc:64-83: an ``indep`` rule under the profile's
        root/failure-domain/device-class."""
        return crush.add_simple_rule(
            name,
            self.rule_root,
            self.rule_failure_domain,
            self.rule_device_class,
            "indep",
        )


def sanity_check_k_m(k: int, m: int) -> None:
    if k < 2:
        raise ErasureCodeError(f"k={k} must be >= 2")
    if m < 1:
        raise ErasureCodeError(f"m={m} must be >= 1")
