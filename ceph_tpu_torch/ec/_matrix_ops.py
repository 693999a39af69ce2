"""Shared encode/decode drivers for GF-matrix code families.

One implementation of the stack-regions → matrix-multiply → scatter-back
dance, used by both the jerasure and isa families (the reference
duplicates this between ErasureCodeJerasure.cc and ErasureCodeIsa.cc; here
it is one seam so the torch backend slots under both).

All functions speak *logical* chunk ids (data 0..k-1, coding k..k+m-1);
the callers translate physical positions through chunk_index().
"""

from __future__ import annotations

import numpy as np

from .. import gf


def matrix_decode(
    backend,
    matrix: np.ndarray,
    erasures: list[int],
    decoded: dict[int, np.ndarray],
    k: int,
    w: int,
    decode_rows_fn=None,
) -> None:
    """Reconstruct erased chunks in-place in ``decoded``.

    ``decode_rows_fn(erasures) -> (rows, survivors)`` lets callers cache
    the survivor-matrix inversion (the isa table-cache analog); defaults
    to computing it fresh.  Only runs the O(k^3) inversion when a data
    chunk is actually erased.
    """
    data_erasures = sorted(e for e in erasures if e < k)
    if data_erasures:
        try:
            if decode_rows_fn is None:
                rows, survivors = gf.make_decoding_matrix(
                    matrix, erasures, k, w
                )
            else:
                rows, survivors = decode_rows_fn(erasures)
        except ValueError as e:
            from .interface import ErasureCodeError

            raise ErasureCodeError(f"{e} (-EIO)")
        surv = np.stack([decoded[i] for i in survivors])
        rec = backend.matrix_regions(rows, surv, w)
        for idx, e in enumerate(data_erasures):
            np.copyto(decoded[e], rec[idx])
    coding_erasures = [e for e in erasures if e >= k]
    if coding_erasures:
        data = np.stack([decoded[i] for i in range(k)])
        sub = matrix[[e - k for e in coding_erasures]]
        rec = backend.matrix_regions(sub, data, w)
        for idx, e in enumerate(coding_erasures):
            np.copyto(decoded[e], rec[idx])
