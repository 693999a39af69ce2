"""Region math for the erasure-code plane, in PyTorch and CUDA.

GF(2^w) arithmetic is GF(2)-linear over the bits of each w-bit word, so a
coding matrix lifts to a (m·w, k·w) GF(2) bitmatrix and parity is that
bitmatrix applied to the data bits.  Two hand-written CUDA kernels apply
it at w=8: ``packed_gf`` (four bytes per 32-bit lane) and
``bitplane_gf`` (one byte column per thread); ``gf_matmul`` holds the
plain PyTorch formulation for every word size and the packet layout.

Beside the region math: ``scrub_kernels`` (crc32c and the compare of a
whole PG in one device call), ``residency`` (``DeviceBuf`` and the
generation-checked residency cache), ``kernel_stats`` (the ``l_tpu_*``
counters) and ``profiler`` (the dispatch flight recorder).

Importing this module registers the ``torch`` erasure-code backend.
"""

from .ec_backend import TorchBackend  # noqa: F401

__all__ = ["TorchBackend"]
