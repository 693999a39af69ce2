"""Object stores and the PG backends over them (src/os/, src/osd/).

- ``objectstore`` — the transaction boundary, ``MemStore``, the
  transaction codec and the residency generations;
- ``blockstore`` / ``kstore`` — the durable stores (a block file with
  an allocator and an onode log; a key/value log of whole objects),
  over ``framed_log``'s crc-framed records;
- ``wal_store`` — ``WALStore``, the write-ahead-log front over any of
  them (group commit, deferred apply, replay verified on the device);
- ``remote`` — ``ShardServer`` and ``RemoteStore``, the EC sub-op
  boundary over the messenger (imported from ``store.remote``: the
  messenger's codec imports ``objectstore``, so this package does not
  import the messenger);
- ``ec_store`` — ``ECStore``, the erasure-coded data plane (write,
  RMW, degraded read, deep scrub, recovery) over k+m stores;
- ``replicated`` — ``ReplicatedStore`` over the acting set's stores;
- ``pg_backend`` — the pool-type factory;
- ``pg_util`` — per-object op ordering and ``ScrubResult``.
"""

from .blockstore import BlockStore
from .ec_store import ECStore, ScrubResult
from .kstore import KStore
from .objectstore import MemStore, ObjectStore, Transaction
from .replicated import ReplicatedStore
from .wal_store import WALStore

__all__ = [
    "BlockStore",
    "ECStore",
    "KStore",
    "MemStore",
    "ObjectStore",
    "ReplicatedStore",
    "ScrubResult",
    "Transaction",
    "WALStore",
]
