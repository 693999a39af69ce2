"""ceph_tpu_torch — the erasure-code plane of ceph_tpu on PyTorch and CUDA.

A second package beside ``ceph_tpu``: the same plugin registry and
jerasure/isa code families, with region math on an NVIDIA Hopper card
through two hand-written CUDA kernels (``ops.packed_gf`` and
``ops.bitplane_gf``) and plain PyTorch elsewhere.  Entry points run on
the card unless the caller asks for the CPU (profile key ``device``).

It imports torch and numpy only; nothing of ``ceph_tpu`` and no JAX.
"""

from .version import FRAMEWORK_VERSION  # noqa: F401
