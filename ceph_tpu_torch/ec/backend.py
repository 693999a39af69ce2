"""The seam between code families and region math.

Code families ask ``get_backend(name, device)`` for an object with the
region-math contract:

- ``matrix_regions(matrix, regions, w)``      — GF(2^w) matrix x chunk
  regions (the jerasure_matrix_encode / ec_encode_data contract).
- ``bitmatrix_regions(bm, regions, w, packetsize)`` — GF(2) bitmatrix over
  packet-interleaved regions (the jerasure_bitmatrix_dotprod contract).

The only backend is ``torch`` (``ops.ec_backend.TorchBackend``), which
registers itself on first use; there is no numpy backend here.  One
instance is bound per (name, device).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def _host_row(r) -> np.ndarray:
    """1-D uint8 view of a survivor payload: DeviceBuf tokens fetch
    host-side, bytes-likes go through frombuffer (ascontiguousarray
    would parse bytes as a scalar)."""
    if hasattr(r, "host"):
        r = r.host()
    if isinstance(r, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(r), dtype=np.uint8)
    return np.ascontiguousarray(r, dtype=np.uint8).ravel()


_factories: dict[str, Callable[[str], object]] = {}
_bound: dict[tuple[str, str], object] = {}


def register_backend(name: str, factory: Callable[[str], object]) -> None:
    """``factory(device) -> backend``; called once per device."""
    _factories[name] = factory


def get_backend(name: str, device: str = "cuda"):
    if name == "torch" and name not in _factories:
        from .. import ops  # noqa: F401  (registers the torch backend)
    if name not in _factories:
        raise ValueError(
            f"unknown EC backend {name!r} (have {sorted(_factories)})"
        )
    key = (name, device)
    backend = _bound.get(key)
    if backend is None:
        backend = _bound[key] = _factories[name](device)
    return backend
