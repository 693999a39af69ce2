"""Erasure-code framework: profiles, plugin registry, code families.

The same split as the JAX package's ``ec``:

- ``interface``  — ``ErasureCode`` base class (chunk sizing, padding,
  chunk remapping, greedy minimum_to_decode).
- ``registry``   — name → plugin factory.
- ``jerasure``   — reed_sol_van / reed_sol_r6_op / cauchy_* / liberation /
  blaum_roth / liber8tion.
- ``isa``        — isa-l compatible RS/Cauchy (w=8) with decode-table cache.

Plugins take the profile keys ``backend`` (only ``torch``) and
``device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""

from . import jerasure as _jerasure  # noqa: F401  (self-registration)
from . import isa as _isa  # noqa: F401
from .interface import ErasureCode, ErasureCodeError, ErasureCodeProfile
from .registry import ErasureCodePluginRegistry, instance as registry_instance

__all__ = [
    "ErasureCode",
    "ErasureCodeError",
    "ErasureCodeProfile",
    "ErasureCodePluginRegistry",
    "registry_instance",
]
