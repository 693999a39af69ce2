"""Coding-matrix construction and linear algebra over GF(2^w).

Clean-room reimplementations of the matrix generators whose call contracts
the reference EC plugins rely on (SURVEY.md §2.1; the jerasure/gf-complete
and isa-l submodules are absent from the reference mount):

- ``reed_sol_vandermonde_coding_matrix`` — jerasure ``reed_sol_van``:
  extended Vandermonde matrix reduced to systematic form with an all-ones
  first coding row and all-ones first column (consumed by
  src/erasure-code/jerasure/ErasureCodeJerasure.cc:203 prepare()).
- ``reed_sol_r6_coding_matrix`` — jerasure RAID6 [1..1; 1,2,4,...].
- ``isa_rs_matrix`` / ``isa_cauchy_matrix`` — isa-l gf_gen_rs_matrix /
  gf_gen_cauchy1_matrix (consumed by ErasureCodeIsa.cc:385-387).
- ``cauchy_original_matrix`` / ``cauchy_good_matrix`` — jerasure cauchy
  plugin matrices (ErasureCodeJerasure.cc:259-336).
- ``matrix_invert`` — Gaussian elimination over GF(2^w), the decode path
  of every RS family (isa-l gf_invert_matrix, jerasure invert_matrix).
- ``jerasure_bitmatrix`` — w×w bit expansion of a GF matrix (the object
  cauchy/liberation XOR scheduling operates on).

All matrices are numpy int arrays shaped (m, k) holding GF elements.
"""

from __future__ import annotations

import numpy as np

from .arith import gf_div, gf_inv, gf_mul_scalar, gf_pow_scalar, region_mul


def matrix_vector_mul_region(
    matrix: np.ndarray, regions: np.ndarray, w: int = 8
) -> np.ndarray:
    """Apply a GF(2^w) matrix (m, k) to k byte regions (k, nbytes),
    producing (m, nbytes) — the semantics of jerasure_matrix_encode /
    isa-l ec_encode_data over w-bit little-endian words."""
    m, k = matrix.shape
    assert regions.shape[0] == k
    out = np.zeros((m, regions.shape[1]), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            c = int(matrix[i, j])
            if c:
                out[i] ^= region_mul(regions[j], c, w)
    return out


def _extended_vandermonde(rows: int, cols: int, w: int) -> np.ndarray:
    """Extended Vandermonde matrix: row 0 = e_0, last row = e_{cols-1},
    interior row i = [1, i, i^2, ...] in GF(2^w)."""
    if w < 30 and ((1 << w) < rows or (1 << w) < cols):
        raise ValueError(f"rows/cols too large for w={w}")
    vdm = np.zeros((rows, cols), dtype=np.int64)
    vdm[0, 0] = 1
    if rows == 1:
        return vdm
    vdm[rows - 1, cols - 1] = 1
    for i in range(1, rows - 1):
        acc = 1
        for j in range(cols):
            vdm[i, j] = acc
            acc = gf_mul_scalar(acc, i, w)
    return vdm


def _big_vandermonde_distribution(rows: int, cols: int, w: int) -> np.ndarray:
    """Reduce the extended Vandermonde matrix to a systematic distribution
    matrix: top cols×cols identity, row ``cols`` all ones, first column of
    every later row one.  Column-operation elimination, mirroring the
    jerasure reed_sol construction the reference plugins load."""
    if cols >= rows:
        raise ValueError("need rows > cols")
    dist = _extended_vandermonde(rows, cols, w)

    for i in range(1, cols):
        # find a row at or below i with a nonzero pivot in column i
        j = i
        while j < rows and dist[j, i] == 0:
            j += 1
        if j == rows:
            raise AssertionError("singular vandermonde — bad rows/w")
        if j > i:
            dist[[i, j], :] = dist[[j, i], :]
        # scale column i so the pivot is 1
        if dist[i, i] != 1:
            inv = gf_div(1, int(dist[i, i]), w)
            for r in range(rows):
                dist[r, i] = gf_mul_scalar(inv, int(dist[r, i]), w)
        # eliminate every other column of row i with column operations
        for jj in range(cols):
            e = int(dist[i, jj])
            if jj != i and e != 0:
                for r in range(rows):
                    dist[r, jj] = int(dist[r, jj]) ^ gf_mul_scalar(
                        e, int(dist[r, i]), w
                    )

    # make row ``cols`` (first coding row) all ones by scaling the coding
    # part of each column
    for j in range(cols):
        t = int(dist[cols, j])
        if t != 1:
            inv = gf_div(1, t, w)
            for r in range(cols, rows):
                dist[r, j] = gf_mul_scalar(inv, int(dist[r, j]), w)

    # make the first column of the remaining coding rows one by scaling rows
    for r in range(cols + 1, rows):
        t = int(dist[r, 0])
        if t != 1:
            inv = gf_div(1, t, w)
            for j in range(cols):
                dist[r, j] = gf_mul_scalar(int(dist[r, j]), inv, w)

    return dist


def reed_sol_vandermonde_coding_matrix(k: int, m: int, w: int) -> np.ndarray:
    """jerasure reed_sol_van coding matrix: the m coding rows (m, k)."""
    dist = _big_vandermonde_distribution(k + m, k, w)
    return dist[k:, :].copy()


def reed_sol_r6_coding_matrix(k: int, w: int) -> np.ndarray:
    """jerasure RAID6 (m=2): row0 all ones, row1 = [1, 2, 4, ... 2^j]."""
    mat = np.ones((2, k), dtype=np.int64)
    for j in range(k):
        mat[1, j] = gf_pow_scalar(2, j, w)
    return mat


def isa_rs_matrix(k: int, m: int) -> np.ndarray:
    """isa-l gf_gen_rs_matrix coding rows (w=8): row i = [g^0, g^1...] with
    g = 2^i walking powers per row (ErasureCodeIsa.cc kVandermonde)."""
    mat = np.zeros((m, k), dtype=np.int64)
    gen = 1
    for i in range(m):
        p = 1
        for j in range(k):
            mat[i, j] = p
            p = gf_mul_scalar(p, gen, 8)
        gen = gf_mul_scalar(gen, 2, 8)
    return mat


def isa_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """isa-l gf_gen_cauchy1_matrix coding rows (w=8): a[i][j] = inv(i ^ j)
    for row index i in [k, k+m)."""
    mat = np.zeros((m, k), dtype=np.int64)
    for i in range(k, k + m):
        for j in range(k):
            mat[i - k, j] = gf_inv(i ^ j, 8)
    return mat


def cauchy_original_matrix(k: int, m: int, w: int) -> np.ndarray:
    """jerasure cauchy_original_coding_matrix: m[i][j] = 1/(i ^ (m+j))."""
    if w < 31 and (k + m) > (1 << w):
        raise ValueError("k+m too large for w")
    mat = np.zeros((m, k), dtype=np.int64)
    for i in range(m):
        for j in range(k):
            mat[i, j] = gf_div(1, i ^ (m + j), w)
    return mat


def cauchy_n_ones(n: int, w: int) -> int:
    """Number of ones in the w×w bitmatrix of multiply-by-n over GF(2^w)."""
    total = 0
    col = n
    for _ in range(w):
        total += bin(col).count("1")
        col = gf_mul_scalar(col, 2, w)
    return total


def cauchy_good_matrix(k: int, m: int, w: int) -> np.ndarray:
    """jerasure cauchy_good: original Cauchy matrix improved to minimize
    bitmatrix ones — divide each column by its row-0 element (making row 0
    all ones), then for each later row pick the element whose inverse,
    multiplied through the row, minimizes the row's total bitmatrix ones."""
    mat = cauchy_original_matrix(k, m, w)
    # normalize row 0 to all ones via column scaling
    for j in range(k):
        if mat[0, j] != 1:
            inv = gf_div(1, int(mat[0, j]), w)
            for i in range(m):
                mat[i, j] = gf_mul_scalar(int(mat[i, j]), inv, w)
    # improve each subsequent row
    for i in range(1, m):
        best_row = [int(x) for x in mat[i]]
        best = sum(cauchy_n_ones(x, w) for x in best_row)
        for j in range(k):
            e = int(mat[i, j])
            if e == 1:
                continue
            inv = gf_div(1, e, w)
            cand = [gf_mul_scalar(int(x), inv, w) for x in mat[i]]
            ones = sum(cauchy_n_ones(x, w) for x in cand)
            if ones < best:
                best = ones
                best_row = cand
        mat[i] = best_row
    return mat


def jerasure_bitmatrix(matrix: np.ndarray, w: int) -> np.ndarray:
    """Expand a GF(2^w) matrix (m, k) to its (m*w, k*w) GF(2) bitmatrix.

    Block (i, j) is the bit-level linear map of multiply-by-matrix[i][j]:
    column x holds the bits of matrix[i][j] * 2^x, bit l in row l — the
    layout jerasure's bitmatrix XOR scheduling consumes
    (jerasure_matrix_to_bitmatrix contract).
    """
    m, k = matrix.shape
    bm = np.zeros((m * w, k * w), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            elt = int(matrix[i, j])
            for x in range(w):
                for l in range(w):
                    bm[i * w + l, j * w + x] = (elt >> l) & 1
                elt = gf_mul_scalar(elt, 2, w)
    return bm


def matrix_multiply(a: np.ndarray, b: np.ndarray, w: int = 8) -> np.ndarray:
    """(r×n) @ (n×c) over GF(2^w)."""
    r, n = a.shape
    n2, c = b.shape
    assert n == n2
    out = np.zeros((r, c), dtype=np.int64)
    for i in range(r):
        for j in range(c):
            acc = 0
            for t in range(n):
                acc ^= gf_mul_scalar(int(a[i, t]), int(b[t, j]), w)
            out[i, j] = acc
    return out


def matrix_invert(mat: np.ndarray, w: int = 8) -> np.ndarray:
    """Invert a square matrix over GF(2^w) by Gauss-Jordan elimination."""
    mat = np.array(mat, dtype=np.int64)
    n = mat.shape[0]
    assert mat.shape == (n, n)
    inv = np.eye(n, dtype=np.int64)
    for col in range(n):
        pivot = col
        while pivot < n and mat[pivot, col] == 0:
            pivot += 1
        if pivot == n:
            raise np.linalg.LinAlgError("singular matrix over GF(2^w)")
        if pivot != col:
            mat[[col, pivot]] = mat[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pv = gf_inv(int(mat[col, col]), w)
        for j in range(n):
            mat[col, j] = gf_mul_scalar(int(mat[col, j]), pv, w)
            inv[col, j] = gf_mul_scalar(int(inv[col, j]), pv, w)
        for r in range(n):
            e = int(mat[r, col])
            if r != col and e != 0:
                for j in range(n):
                    mat[r, j] = int(mat[r, j]) ^ gf_mul_scalar(
                        e, int(mat[col, j]), w
                    )
                    inv[r, j] = int(inv[r, j]) ^ gf_mul_scalar(
                        e, int(inv[col, j]), w
                    )
    return inv


def survivor_basis(
    coding_matrix: np.ndarray,
    erasures,
    k: int,
    w: int = 8,
) -> tuple[np.ndarray, list[int]]:
    """The survivor basis B⁻¹ (k × k over GF(2^w)) and the k survivor
    ids it spans (first k available, ascending — data-then-coding
    order): B⁻¹ @ survivor_chunks = data_chunks.  The ONE
    implementation both the per-op decode (make_decoding_matrix) and
    the batched reconstruction-matrix path (ec/stripe) build on —
    their byte identity rests on picking the SAME system."""
    m = coding_matrix.shape[0]
    erased = set(erasures)
    survivors = [i for i in range(k + m) if i not in erased][:k]
    if len(survivors) < k:
        raise ValueError("not enough surviving chunks to decode")
    # B[r] = unit row for surviving data chunk, coding row for surviving parity
    b = np.zeros((k, k), dtype=np.int64)
    for r, chunk in enumerate(survivors):
        if chunk < k:
            b[r, chunk] = 1
        else:
            b[r] = coding_matrix[chunk - k]
    return matrix_invert(b, w), survivors


def make_decoding_matrix(
    coding_matrix: np.ndarray,
    erasures: list[int],
    k: int,
    w: int = 8,
) -> tuple[np.ndarray, list[int]]:
    """Rows that reconstruct the erased *data* chunks from the first k
    surviving chunks (data-then-coding order), mirroring
    jerasure_make_decoding_matrix / isa-l's decode path
    (ErasureCodeIsa.cc:220-310).

    Returns (decode_rows, survivors): decode_rows is (len(data_erasures), k)
    and maps the survivor chunk vector to each erased data chunk; survivors
    is the list of k chunk ids used as input, ascending.
    """
    binv, survivors = survivor_basis(coding_matrix, erasures, k, w)
    data_erasures = sorted(e for e in set(erasures) if e < k)
    rows = np.array([binv[e] for e in data_erasures], dtype=np.int64).reshape(
        len(data_erasures), k
    )
    return rows, survivors
