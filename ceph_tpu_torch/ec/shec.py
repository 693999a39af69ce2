"""SHEC — shingled erasure code (src/erasure-code/shec/).

k data + m parity chunks where each parity covers a sliding window of
the data; c is the durability floor.  The coding matrix is a
Vandermonde RS matrix with per-row windows zeroed out
(shec_reedsolomon_coding_matrix, ErasureCodeShec.cc:461-524); the
"multiple" technique splits the parities into two shingle stacks chosen
by the recovery-efficiency heuristic (shec_calc_recovery_efficiency1,
:420-459).  Decode searches all parity subsets for the smallest
invertible recovery system (shec_make_decoding_matrix, :526-760) and
caches the result per (want, avails) signature like
ErasureCodeShecTableCache.

Deviation noted for parity review: the reference validates candidate
recovery systems with a determinant computed in GF(2^8) regardless of w
(determinant.c); here the check is invertibility in GF(2^w) —
equivalent for the default and overwhelmingly common w=8.

Profile keys ``backend`` (default ``torch``) and ``device`` (default
``cuda``) select where region math runs; see ``ec.jerasure``.
"""

from __future__ import annotations

import numpy as np

from .. import gf
from .backend import get_backend
from .interface import (
    ErasureCode,
    ErasureCodeError,
    ErasureCodeProfile,
    to_int,
    to_string,
)
from .registry import ErasureCodePlugin, register

MULTIPLE, SINGLE = 0, 1


def _recovery_efficiency1(k, m1, m2, c1, c2) -> float:
    """shec_calc_recovery_efficiency1 (ErasureCodeShec.cc:420-459)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [100000000] * k
    r_e1 = 0.0
    for m_i, c_i in ((m1, c1), (m2, c2)):
        for rr in range(m_i):
            start = ((rr * k) // m_i) % k
            end = (((rr + c_i) * k) // m_i) % k
            width = ((rr + c_i) * k) // m_i - (rr * k) // m_i
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], width)
                cc = (cc + 1) % k
            r_e1 += width
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


class ErasureCodeShec(ErasureCode):
    DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8

    def __init__(self, technique=MULTIPLE):
        super().__init__()
        self.c = 0
        self.w = 8
        self.technique = technique
        self.matrix: np.ndarray | None = None
        self.backend = None
        self._decode_cache: dict = {}

    # -- profile -----------------------------------------------------------
    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse(profile)
        self.prepare()
        super().init(profile)

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        has = [key in profile for key in ("k", "m", "c")]
        if not any(has):
            self.k, self.m, self.c = (
                self.DEFAULT_K, self.DEFAULT_M, self.DEFAULT_C
            )
        elif not all(has):
            raise ErasureCodeError("(k, m, c) must all be chosen")
        else:
            self.k = to_int("k", profile, self.DEFAULT_K)
            self.m = to_int("m", profile, self.DEFAULT_M)
            self.c = to_int("c", profile, self.DEFAULT_C)
            if self.k <= 0 or self.m <= 0 or self.c <= 0:
                raise ErasureCodeError("k, m, c must be positive")
            if self.m < self.c:
                raise ErasureCodeError(f"c={self.c} must be <= m={self.m}")
            if self.k > 12:
                raise ErasureCodeError(f"k={self.k} must be <= 12")
            if self.k + self.m > 20:
                raise ErasureCodeError(f"k+m={self.k + self.m} must be <= 20")
            if self.k < self.m:
                raise ErasureCodeError(f"m={self.m} must be <= k={self.k}")
        w = to_int("w", profile, self.DEFAULT_W)
        self.w = w if w in (8, 16, 32) else self.DEFAULT_W
        self.backend = get_backend(
            to_string("backend", profile, "torch"),
            to_string("device", profile, "cuda"),
        )

    def prepare(self) -> None:
        self.matrix = self._coding_matrix(self.technique == SINGLE)

    def _coding_matrix(self, is_single: bool) -> np.ndarray:
        k, m, c = self.k, self.m, self.c
        if is_single:
            m1, c1 = 0, 0
        else:
            best = (-1, -1)
            min_r = 100.0
            for c1 in range(c // 2 + 1):
                for m1 in range(m + 1):
                    c2, m2 = c - c1, m - m1
                    if m1 < c1 or m2 < c2:
                        continue
                    if (m1 == 0) != (c1 == 0) or (m2 == 0) != (c2 == 0):
                        continue
                    r = _recovery_efficiency1(k, m1, m2, c1, c2)
                    if min_r - r > np.finfo(float).eps and r < min_r:
                        min_r = r
                        best = (c1, m1)
            c1, m1 = best
        m2, c2 = self.m - m1, self.c - c1
        matrix = gf.reed_sol_vandermonde_coding_matrix(k, m, self.w)
        for rows, cs, base in ((m1, c1, 0), (m2, c2, m1)):
            for rr in range(rows):
                end = ((rr * k) // rows) % k
                cc = (((rr + cs) * k) // rows) % k
                while cc != end:
                    matrix[base + rr, cc] = 0
                    cc = (cc + 1) % k
        return matrix

    # -- geometry ----------------------------------------------------------
    def get_alignment(self) -> int:
        return self.k * self.w * 4

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    # -- encode/decode -----------------------------------------------------
    def encode_chunks(self, want_to_encode, encoded) -> None:
        data = np.stack(
            [encoded[self.chunk_index(i)] for i in range(self.k)]
        )
        coding = self.backend.matrix_regions(self.matrix, data, self.w)
        for i in range(self.m):
            np.copyto(encoded[self.chunk_index(self.k + i)], coding[i])

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        k, m = self.k, self.m
        want = [0] * (k + m)
        avails = [0] * (k + m)
        erased_count = 0
        for i in range(k + m):
            if i in chunks:
                avails[i] = 1
            elif i in want_to_read:
                want[i] = 1
                erased_count += 1
        if erased_count == 0:
            return
        plan = self._make_decoding_matrix(False, tuple(want), tuple(avails))
        if plan is None:
            raise ErasureCodeError("cannot find recovery matrix (-EIO)")
        dec_matrix, dm_row, dm_column, _minimum = plan
        dm_size = len(dm_row)
        if dm_size:
            # sources per the remapped dm_row: < dm_size -> selected
            # data column, else parity (shec_matrix_decode)
            srcs = []
            for sid in dm_row:
                if sid < dm_size:
                    srcs.append(decoded[dm_column[sid]])
                else:
                    srcs.append(decoded[k + (sid - dm_size)])
            src = np.stack(srcs)
            rows = [
                i for i in range(dm_size) if not avails[dm_column[i]]
            ]
            if rows:
                rec = self.backend.matrix_regions(
                    dec_matrix[rows], src, self.w
                )
                for out_i, i in enumerate(rows):
                    np.copyto(decoded[dm_column[i]], rec[out_i])
        recode = [
            i for i in range(m) if want[k + i] and not avails[k + i]
        ]
        if recode:
            data = np.stack([decoded[i] for i in range(k)])
            rec = self.backend.matrix_regions(
                self.matrix[recode], data, self.w
            )
            for out_i, i in enumerate(recode):
                np.copyto(decoded[k + i], rec[out_i])

    # -- recovery-system search --------------------------------------------
    def _make_decoding_matrix(self, prepare, want_t, avails_t):
        """shec_make_decoding_matrix: smallest invertible recovery
        system over all parity subsets; returns (decoding_matrix,
        dm_row, dm_column, minimum) or None."""
        key = (want_t, avails_t)
        cached = self._decode_cache.get(key)
        if cached is not None:
            return cached
        k, m = self.k, self.m
        want = list(want_t)
        avails = list(avails_t)
        # wanted-but-missing parity pulls its window's data into want
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if self.matrix[i, j] > 0:
                        want[j] = 1

        mindup = k + 1
        minp = k + 1
        best_rows: list[int] | None = None
        best_cols: list[int] | None = None
        for pp in range(1 << m):
            parities = [i for i in range(m) if pp & (1 << i)]
            if len(parities) > minp:
                continue
            if any(not avails[k + p] for p in parities):
                continue
            tmprow = [0] * (k + m)
            tmpcol = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcol[i] = 1
            for p in parities:
                tmprow[k + p] = 1
                for j in range(k):
                    if self.matrix[p, j] != 0:
                        tmpcol[j] = 1
                        if avails[j]:
                            tmprow[j] = 1
            dup_rows = sum(tmprow)
            dup_cols = sum(tmpcol)
            if dup_rows != dup_cols:
                continue
            dup = dup_rows
            if dup == 0:
                mindup = 0
                best_rows, best_cols = [], []
                break
            if dup >= mindup:
                continue
            rows = [i for i in range(k + m) if tmprow[i]]
            cols = [j for j in range(k) if tmpcol[j]]
            tmpmat = self._system_matrix(rows, cols)
            if self._invertible(tmpmat):
                mindup = dup
                best_rows, best_cols = rows, cols
                minp = len(parities)

        if mindup == k + 1:
            return None

        minimum = [0] * (k + m)
        for r in best_rows:
            minimum[r] = 1
        for i in range(k):
            if want[i] and avails[i]:
                minimum[i] = 1
        for i in range(m):
            if want[k + i] and avails[k + i] and not minimum[k + i]:
                if any(
                    self.matrix[i, j] > 0 and not want[j]
                    for j in range(k)
                ):
                    minimum[k + i] = 1

        if mindup == 0:
            plan = (np.zeros((0, 0), dtype=np.int64), [], [], minimum)
            self._decode_cache[key] = plan
            return plan

        tmpmat = self._system_matrix(best_rows, best_cols)
        # remap rows to the compact source index space (the dm_row
        # rewrite at the end of shec_make_decoding_matrix)
        dm_row = []
        for r in best_rows:
            if r < k:
                dm_row.append(best_cols.index(r))
            else:
                dm_row.append(r - (k - mindup))
        dec = gf.matrix_invert(tmpmat, self.w)
        plan = (dec, dm_row, list(best_cols), minimum)
        if not prepare:
            self._decode_cache[key] = plan
        return plan

    def _system_matrix(self, rows, cols) -> np.ndarray:
        n = len(rows)
        mat = np.zeros((n, n), dtype=np.int64)
        for ri, r in enumerate(rows):
            for ci, c in enumerate(cols):
                if r < self.k:
                    mat[ri, ci] = 1 if r == c else 0
                else:
                    mat[ri, ci] = self.matrix[r - self.k, c]
        return mat

    def _invertible(self, mat: np.ndarray) -> bool:
        try:
            gf.matrix_invert(mat, self.w)
            return True
        except (ErasureCodeError, ValueError):
            return False

    # -- minimum -----------------------------------------------------------
    def _minimum_to_decode(self, want_to_read, available):
        k, m = self.k, self.m
        for i in want_to_read | available:
            if i < 0 or i >= k + m:
                raise ErasureCodeError(f"invalid chunk id {i} (-EINVAL)")
        want = [1 if i in want_to_read else 0 for i in range(k + m)]
        avails = [1 if i in available else 0 for i in range(k + m)]
        plan = self._make_decoding_matrix(
            True, tuple(want), tuple(avails)
        )
        if plan is None:
            raise ErasureCodeError("not enough chunks to decode (-EIO)")
        return {i for i in range(k + m) if plan[3][i] == 1}


@register("shec")
class ErasureCodePluginShec(ErasureCodePlugin):
    def make(self, profile: ErasureCodeProfile):
        technique = profile.get("technique", "multiple")
        if technique == "single":
            return ErasureCodeShec(SINGLE)
        if technique == "multiple":
            return ErasureCodeShec(MULTIPLE)
        raise ErasureCodeError(
            f"technique={technique} is not a valid coding technique: "
            "choose one of single, multiple"
        )
