"""Erasure-code framework: profiles, plugin registry, code families.

The same split as the JAX package's ``ec``:

- ``interface``  — ``ErasureCode`` base class (chunk sizing, padding,
  chunk remapping, greedy minimum_to_decode).
- ``registry``   — name → plugin factory.
- ``jerasure``   — reed_sol_van / reed_sol_r6_op / cauchy_* / liberation /
  blaum_roth / liber8tion.
- ``isa``        — isa-l compatible RS/Cauchy (w=8) with decode-table cache.
- ``lrc/shec/clay`` — layered codes composing over the base families;
  their inner codes take the outer profile's ``backend`` and ``device``.
- ``example``    — the k=2 m=1 XOR code, the registry's test subject
  (a host XOR, no kernel).
- ``stripe``     — the stripe seam: batched encode/decode over many
  stripes and objects, HashInfo.

Plugins take the profile keys ``backend`` (only ``torch``) and
``device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
"""

from . import jerasure as _jerasure  # noqa: F401  (self-registration)
from . import isa as _isa  # noqa: F401
from . import lrc as _lrc  # noqa: F401
from . import shec as _shec  # noqa: F401
from . import clay as _clay  # noqa: F401
from . import example as _example  # noqa: F401
from .interface import ErasureCode, ErasureCodeError, ErasureCodeProfile
from .registry import ErasureCodePluginRegistry, instance as registry_instance

__all__ = [
    "ErasureCode",
    "ErasureCodeError",
    "ErasureCodeProfile",
    "ErasureCodePluginRegistry",
    "registry_instance",
]
