"""jerasure-compatible Reed-Solomon code family.

Re-design of src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc}: the
technique classes keep the reference's geometry rules (alignment, chunk
sizing, parameter validation) while the GF math comes from ``gf`` and
region compute is dispatched through the torch backend (``ops.ec_backend``).

The profile key ``backend`` defaults to ``torch`` and ``device`` to
``cuda``: the port runs on the card unless the caller asks for the CPU
(``device=cpu``), and a missing card raises ErasureCodeError.  This
differs on purpose from the JAX package, whose default is its numpy
oracle.

Techniques (ErasureCodePluginJerasure.cc:40-57 dispatch):
- reed_sol_van   — Vandermonde RS, w in {8,16,32}       (matrix)
- reed_sol_r6_op — RAID6 optimized, m=2, w in {8,16,32} (matrix)
- cauchy_orig    — original Cauchy                      (bitmatrix)
- cauchy_good    — ones-minimized Cauchy                (bitmatrix)
- liberation     — minimal-density RAID6, w prime       (bitmatrix)
- blaum_roth     — w+1 prime RAID6                      (bitmatrix)
- liber8tion     — w=8 RAID6                            (bitmatrix)
"""

from __future__ import annotations

import numpy as np

from .. import gf
from ._matrix_ops import matrix_decode
from .backend import get_backend
from .interface import (
    ErasureCode,
    ErasureCodeError,
    ErasureCodeProfile,
    sanity_check_k_m,
    to_bool,
    to_int,
    to_string,
)
from .registry import ErasureCodePlugin, register

LARGEST_VECTOR_WORDSIZE = 16  # ErasureCodeJerasure.cc:30


class ErasureCodeJerasure(ErasureCode):
    DEFAULT_K = 2
    DEFAULT_M = 1
    DEFAULT_W = 8
    technique = "undefined"

    def __init__(self):
        super().__init__()
        self.w = 8
        self.per_chunk_alignment = False
        self.backend = None

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        super().init(profile)
        self.prepare()

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = to_int("m", profile, self.DEFAULT_M)
        self.w = to_int("w", profile, self.DEFAULT_W)
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            self.chunk_mapping = []
            raise ErasureCodeError("mapping size != k+m")
        sanity_check_k_m(self.k, self.m)
        self.backend = get_backend(
            to_string("backend", profile, "torch"),
            to_string("device", profile, "cuda"),
        )

    def prepare(self) -> None:
        raise NotImplementedError

    def get_alignment(self) -> int:
        raise NotImplementedError

    def get_chunk_size(self, object_size: int) -> int:
        """ErasureCodeJerasure.cc:80-103 semantics."""
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = (object_size + self.k - 1) // self.k
            if alignment > chunk_size:
                chunk_size = alignment
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    # Chunk dicts are keyed by physical position; the math runs in logical
    # order (data 0..k-1, coding k..k+m-1) through chunk_index().  NOTE:
    # deliberate deviation from the reference, whose base-family
    # encode_chunks reads the map by raw index and silently corrupts data
    # under a non-identity ``mapping`` profile (only CLAY overrides it
    # mapping-aware); here the remap is honored for every family.
    def encode_chunks(self, want_to_encode, encoded) -> None:
        data = np.stack(
            [encoded[self.chunk_index(i)] for i in range(self.k)]
        )
        coding = self._encode_regions(data)
        for i in range(self.m):
            np.copyto(encoded[self.chunk_index(self.k + i)], coding[i])

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        erasures = [
            i
            for i in range(self.k + self.m)
            if self.chunk_index(i) not in chunks
        ]
        if not erasures:
            return
        logical = {
            i: decoded[self.chunk_index(i)] for i in range(self.k + self.m)
        }
        self._decode_regions(erasures, logical)

    def _encode_regions(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _decode_regions(self, erasures, decoded) -> None:
        raise NotImplementedError


class _MatrixTechnique(ErasureCodeJerasure):
    """Techniques encoded by a GF(2^w) matrix over w-bit words."""

    def __init__(self):
        super().__init__()
        self.matrix: np.ndarray | None = None

    def _encode_regions(self, data):
        return self.backend.matrix_regions(self.matrix, data, self.w)

    def _decode_regions(self, erasures, decoded):
        matrix_decode(
            self.backend, self.matrix, erasures, decoded, self.k, self.w
        )


class _BitmatrixTechnique(ErasureCodeJerasure):
    """Techniques encoded by a GF(2) bitmatrix over w packet planes."""

    DEFAULT_PACKETSIZE = 2048  # ErasureCodeJerasure.h:141

    def __init__(self):
        super().__init__()
        self.bitmatrix: np.ndarray | None = None  # (m*w, k*w)
        self.packetsize = self.DEFAULT_PACKETSIZE

    def parse(self, profile):
        super().parse(profile)
        self.packetsize = to_int(
            "packetsize", profile, self.DEFAULT_PACKETSIZE
        )
        if self.packetsize <= 0:
            raise ErasureCodeError(
                f"packetsize={self.packetsize} must be positive"
            )

    def _encode_regions(self, data):
        return self.backend.bitmatrix_regions(
            self.bitmatrix, data, self.w, self.packetsize
        )

    def _decode_regions(self, erasures, decoded):
        k, m, w = self.k, self.m, self.w
        erased = set(erasures)
        survivors = [i for i in range(k + m) if i not in erased][:k]
        if len(survivors) < k:
            raise ErasureCodeError("not enough chunks to decode (-EIO)")
        data_erasures = sorted(e for e in erased if e < k)
        if data_erasures:
            # binary survivor matrix (k*w, k*w): identity blocks for data
            # rows, bitmatrix rows for coding survivors
            # (jerasure_make_decoding_bitmatrix)
            b = np.zeros((k * w, k * w), dtype=np.uint8)
            for r, chunk in enumerate(survivors):
                if chunk < k:
                    b[
                        r * w : (r + 1) * w, chunk * w : (chunk + 1) * w
                    ] = np.eye(w, dtype=np.uint8)
                else:
                    b[r * w : (r + 1) * w, :] = self.bitmatrix[
                        (chunk - k) * w : (chunk - k + 1) * w, :
                    ]
            binv = _invert_bitmatrix(b)
            sel = np.concatenate(
                [binv[e * w : (e + 1) * w, :] for e in data_erasures]
            )
            surv = np.stack([decoded[i] for i in survivors])
            rec = self.backend.bitmatrix_regions(
                sel, surv, w, self.packetsize
            )
            for idx, e in enumerate(data_erasures):
                np.copyto(decoded[e], rec[idx])
        coding_erasures = [e for e in erased if e >= k]
        if coding_erasures:
            data = np.stack([decoded[i] for i in range(k)])
            sel = np.concatenate(
                [
                    self.bitmatrix[(e - k) * w : (e - k + 1) * w, :]
                    for e in coding_erasures
                ]
            )
            rec = self.backend.bitmatrix_regions(
                sel, data, w, self.packetsize
            )
            for idx, e in enumerate(coding_erasures):
                np.copyto(decoded[e], rec[idx])


def _invert_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan over GF(2)."""
    mat = mat.astype(np.uint8).copy()
    n = mat.shape[0]
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = col
        while pivot < n and mat[pivot, col] == 0:
            pivot += 1
        if pivot == n:
            raise ErasureCodeError("singular bitmatrix")
        if pivot != col:
            mat[[col, pivot]] = mat[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        rows = np.nonzero(mat[:, col])[0]
        rows = rows[rows != col]
        mat[rows] ^= mat[col]
        inv[rows] ^= inv[col]
    return inv


class ReedSolomonVandermonde(_MatrixTechnique):
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 7, 3, 8
    technique = "reed_sol_van"

    def parse(self, profile):
        super().parse(profile)
        if self.w not in (8, 16, 32):
            raise ErasureCodeError(f"w={self.w} must be one of 8, 16, 32")
        self.per_chunk_alignment = to_bool(
            "jerasure-per-chunk-alignment", profile, "false"
        )

    def get_alignment(self):
        # ErasureCodeJerasure.cc:174-184
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * 4
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def prepare(self):
        self.matrix = gf.reed_sol_vandermonde_coding_matrix(
            self.k, self.m, self.w
        )


class ReedSolomonRAID6(_MatrixTechnique):
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 7, 2, 8
    technique = "reed_sol_r6_op"

    def parse(self, profile):
        super().parse(profile)
        self.m = 2
        profile["m"] = "2"
        if self.w not in (8, 16, 32):
            raise ErasureCodeError(f"w={self.w} must be one of 8, 16, 32")

    def get_alignment(self):
        return self.k * self.w * 4

    def prepare(self):
        self.matrix = gf.reed_sol_r6_coding_matrix(self.k, self.w)


class _Cauchy(_BitmatrixTechnique):
    DEFAULT_K, DEFAULT_M, DEFAULT_W = 7, 3, 8

    def parse(self, profile):
        super().parse(profile)
        self.per_chunk_alignment = to_bool(
            "jerasure-per-chunk-alignment", profile, "false"
        )

    def get_alignment(self):
        # ErasureCodeJerasureCauchy::get_alignment
        if self.per_chunk_alignment:
            alignment = self.w * self.packetsize
            modulo = alignment % LARGEST_VECTOR_WORDSIZE
            if modulo:
                alignment += LARGEST_VECTOR_WORDSIZE - modulo
            return alignment
        alignment = self.k * self.w * self.packetsize * 4
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = (
                self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
            )
        return alignment

    def _gf_matrix(self):
        raise NotImplementedError

    def prepare(self):
        self.matrix = self._gf_matrix()
        self.bitmatrix = gf.jerasure_bitmatrix(self.matrix, self.w)


class CauchyOrig(_Cauchy):
    technique = "cauchy_orig"

    def _gf_matrix(self):
        return gf.cauchy_original_matrix(self.k, self.m, self.w)


class CauchyGood(_Cauchy):
    technique = "cauchy_good"

    def _gf_matrix(self):
        return gf.cauchy_good_matrix(self.k, self.m, self.w)


def _is_prime(value: int) -> bool:
    if value < 2:
        return False
    f = 2
    while f * f <= value:
        if value % f == 0:
            return False
        f += 1
    return True


class Liberation(_BitmatrixTechnique):
    """Minimal-density RAID6 (Plank's Liberation codes): m=2, w prime,
    k <= w.  P row: identity blocks; Q block j: the rotation matrix
    row i -> (i + j) mod w, plus for j > 0 one extra bit at
    (i, (i + j - 1) mod w) with i = (j * (w - 1) / 2) mod w."""

    DEFAULT_K, DEFAULT_M, DEFAULT_W = 2, 2, 7
    technique = "liberation"

    def parse(self, profile):
        super().parse(profile)
        self.m = 2
        profile["m"] = "2"
        self._check_kw()
        self._check_packetsize()

    def _check_kw(self):
        if self.k > self.w:
            raise ErasureCodeError(f"k={self.k} must be <= w={self.w}")
        if not _is_prime(self.w):
            raise ErasureCodeError(f"w={self.w} must be prime")

    def _check_packetsize(self):
        if (self.packetsize % 8) != 0:
            raise ErasureCodeError(
                f"packetsize={self.packetsize} must be multiple of 8"
            )

    def get_alignment(self):
        alignment = self.k * self.w * self.packetsize * 4
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = (
                self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
            )
        return alignment

    def prepare(self):
        k, w = self.k, self.w
        bm = np.zeros((2 * w, k * w), dtype=np.uint8)
        for j in range(k):
            bm[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
            for i in range(w):
                bm[w + i, j * w + (j + i) % w] = 1
            if j > 0:
                i = (j * ((w - 1) // 2)) % w
                bm[w + i, j * w + (i + j - 1) % w] = 1
        self.bitmatrix = bm


class BlaumRoth(Liberation):
    """Blaum-Roth minimal-density RAID6: m=2 over the polynomial ring
    R = GF(2)[x]/M_p(x) with p = w+1 prime and M_p = 1+x+...+x^w.
    Q block for data column j is multiplication by x^j in R (the
    mult-by-x matrix shifts coefficients up and folds the top
    coefficient into every row, since x^w = Σ_{i<w} x^i).

    Re-derivation note for parity review: the reference's generator
    (blaum_roth_coding_bitmatrix) lives in the absent jerasure
    submodule; this construction is the published Blaum-Roth code and
    is validated by exhaustive-erasure roundtrips, not byte-parity
    against the C library.
    """

    DEFAULT_K, DEFAULT_M, DEFAULT_W = 7, 2, 6
    technique = "blaum_roth"

    def _check_kw(self):
        if self.k > self.w:
            raise ErasureCodeError(f"k={self.k} must be <= w={self.w}")
        # w=7 tolerated for Firefly compatibility
        # (ErasureCodeJerasure.cc check_w)
        if self.w != 7 and (self.w <= 2 or not _is_prime(self.w + 1)):
            raise ErasureCodeError(
                f"w={self.w} must be greater than two and w+1 must "
                "be prime"
            )

    def prepare(self):
        k, w = self.k, self.w
        mult_x = np.zeros((w, w), dtype=np.uint8)
        for i in range(w - 1):
            mult_x[i + 1, i] = 1  # shift up
        mult_x[:, w - 1] = 1  # fold x^w = sum of lower powers
        bm = np.zeros((2 * w, k * w), dtype=np.uint8)
        block = np.eye(w, dtype=np.uint8)
        for j in range(k):
            bm[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
            bm[w:, j * w : (j + 1) * w] = block
            block = (mult_x @ block) % 2
        self.bitmatrix = bm


class Liber8tion(Liberation):
    """RAID6 for w=8: m=2, k <= 8, packetsize multiple of 8
    (ErasureCodeJerasure.cc ErasureCodeJerasureLiber8tion — w is forced
    to 8 and m to 2 regardless of the profile, like the reference).

    Construction note for parity review: upstream's bitmatrix is
    Plank's search-found minimal-density table (71 ones), shipped only
    inside the jerasure submodule that is absent from the reference
    mount, so the exact table cannot be reproduced here.  This class
    keeps the technique's parameter slot and RAID6 geometry with a
    provably-MDS low-density construction instead: Q block j is the
    GF(2) bitmatrix of multiply-by-``c_j`` over GF(2^8), with the
    constants chosen as the eight nonzero bytes whose multiply
    bitmatrices are sparsest (111 ones total vs the 71 bound).  MDS is
    immediate: every block is invertible (c_j != 0) and every pairwise
    sum is multiply-by-(c_i ^ c_j) != 0, hence invertible.  Chunk
    bytes therefore do NOT match upstream liber8tion output —
    deviation tracked in docs/PARITY.md alongside blaum_roth.
    """

    DEFAULT_K, DEFAULT_M, DEFAULT_W = 2, 2, 8
    technique = "liber8tion"
    # The 8 sparsest multiply-by-c bitmatrices over GF(2^8)/0x11d,
    # sorted by density then value (ones: 8,11,11,14,14,17,18,18).
    CONSTANTS = (1, 2, 142, 4, 71, 8, 70, 173)

    def parse(self, profile):
        profile["w"] = "8"  # forced, reference parse() does the same
        super().parse(profile)

    def _check_kw(self):
        if self.k > self.w:
            raise ErasureCodeError(f"k={self.k} must be <= w={self.w}")

    def prepare(self):
        k, w = self.k, self.w
        bm = np.zeros((2 * w, k * w), dtype=np.uint8)
        for j in range(k):
            bm[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
            cmat = np.array([[self.CONSTANTS[j]]], dtype=np.uint32)
            bm[w:, j * w : (j + 1) * w] = gf.jerasure_bitmatrix(cmat, w)
        self.bitmatrix = bm


@register("jerasure")
class ErasureCodePluginJerasure(ErasureCodePlugin):
    TECHNIQUES = {
        "reed_sol_van": ReedSolomonVandermonde,
        "reed_sol_r6_op": ReedSolomonRAID6,
        "cauchy_orig": CauchyOrig,
        "cauchy_good": CauchyGood,
        "liberation": Liberation,
        "blaum_roth": BlaumRoth,
        "liber8tion": Liber8tion,
    }

    def make(self, profile: ErasureCodeProfile):
        technique = profile.get("technique", "reed_sol_van")
        cls = self.TECHNIQUES.get(technique)
        if cls is None:
            raise ErasureCodeError(
                f"technique={technique} is not a valid coding technique "
                f"(have {sorted(self.TECHNIQUES)})"
            )
        return cls()
