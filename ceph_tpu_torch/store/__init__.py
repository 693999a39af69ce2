"""Object stores and the PG backends over them (src/os/, src/osd/).

- ``objectstore`` — the transaction boundary, ``MemStore``, the
  transaction codec and the residency generations;
- ``ec_store`` — ``ECStore``, the erasure-coded data plane (write,
  RMW, degraded read, deep scrub, recovery) over k+m stores;
- ``replicated`` — ``ReplicatedStore`` over the acting set's stores;
- ``pg_backend`` — the pool-type factory;
- ``pg_util`` — per-object op ordering and ``ScrubResult``.

The JAX package's WAL, KStore and BlockStore stores and the remote
shard proxy come with the daemons.
"""

from .ec_store import ECStore, ScrubResult
from .objectstore import MemStore, ObjectStore, Transaction
from .replicated import ReplicatedStore

__all__ = [
    "ECStore",
    "MemStore",
    "ObjectStore",
    "ReplicatedStore",
    "ScrubResult",
    "Transaction",
]
