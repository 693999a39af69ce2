"""ceph_tpu_torch — ceph_tpu's device planes on PyTorch and CUDA.

A second package beside ``ceph_tpu``: the same plugin registry and code
families, with region math on an NVIDIA Hopper card through two
hand-written CUDA kernels (``ops.packed_gf`` and ``ops.bitplane_gf``);
CRUSH placement as batched torch (``crush.torchmap``); and the store data
plane (``store``: ``ECStore``, ``ReplicatedStore``) with deep scrub on the
card (``ops.scrub_kernels``), the residency cache (``ops.residency``) and
the kernel counters and dispatch profiler.  Entry points run on the card
unless the caller asks for the CPU (profile key or argument ``device``).

It imports torch and numpy only; nothing of ``ceph_tpu`` and no JAX.
"""

from .version import FRAMEWORK_VERSION  # noqa: F401
