"""GF(2^w) arithmetic — the executable spec for all erasure-code math.

Numpy implementation of the Galois-field arithmetic that the reference
delegates to the gf-complete/jerasure/isa-l submodules (absent from the
reference mount; call contracts documented in SURVEY.md §2.1).  Primitive
polynomials match gf-complete/isa-l defaults so coded chunks are
byte-compatible with the C plugins:

- w=8 : x^8+x^4+x^3+x^2+1           (0x11D)
- w=16: x^16+x^12+x^3+x+1           (0x1100B)
- w=32: x^32+x^22+x^2+x+1           (0x400007)
"""

from .arith import (
    PRIM_POLY,
    gf_div,
    gf_exp_table,
    gf_inv,
    gf_log_table,
    gf_mul,
    gf_mul_scalar,
    gf_pow_scalar,
    region_mul,
    region_xor,
)
from .matrix import (
    cauchy_good_matrix,
    cauchy_n_ones,
    cauchy_original_matrix,
    isa_cauchy_matrix,
    isa_rs_matrix,
    jerasure_bitmatrix,
    make_decoding_matrix,
    matrix_invert,
    survivor_basis,
    matrix_multiply,
    matrix_vector_mul_region,
    reed_sol_r6_coding_matrix,
    reed_sol_vandermonde_coding_matrix,
)

__all__ = [
    "PRIM_POLY",
    "gf_mul",
    "gf_div",
    "gf_inv",
    "gf_mul_scalar",
    "gf_pow_scalar",
    "gf_exp_table",
    "gf_log_table",
    "region_mul",
    "region_xor",
    "matrix_invert",
    "matrix_multiply",
    "matrix_vector_mul_region",
    "make_decoding_matrix",
    "survivor_basis",
    "reed_sol_vandermonde_coding_matrix",
    "reed_sol_r6_coding_matrix",
    "isa_rs_matrix",
    "isa_cauchy_matrix",
    "cauchy_original_matrix",
    "cauchy_good_matrix",
    "cauchy_n_ones",
    "jerasure_bitmatrix",
]
