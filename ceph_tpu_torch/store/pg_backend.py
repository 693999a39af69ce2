"""PGBackend factory — pool-type dispatch
(src/osd/PGBackend.cc:571-607 build_pg_backend).

REPLICATED pools get a ReplicatedStore sized to the pool; ERASURE
pools resolve the pool's erasure-code profile through the plugin
registry (the reference looks the plugin up by the profile stored in
the OSDMap and constructs an ECBackend with the pool stripe width).
"""

from __future__ import annotations

from ..crush.types import PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED
from .ec_store import ECStore
from .objectstore import ObjectStore
from .replicated import ReplicatedStore


class PGBackendError(ValueError):
    pass


def build_pg_backend(
    pool,
    erasure_code_profiles: dict[str, dict[str, str]] | None = None,
    stores: list[ObjectStore] | None = None,
    stripe_width: int | None = None,
):
    """Construct the backend for a PgPool (osd/osdmap.py).

    ``erasure_code_profiles`` is the OSDMap's profile table (the
    monitor-managed ``osd erasure-code-profile`` namespace); erasure
    pools must name a profile in it, exactly like the reference's
    ceph_assert(profile) path (PGBackend.cc:588-596).
    """
    if pool.type == PG_POOL_TYPE_REPLICATED:
        if stores is not None and len(stores) != pool.size:
            raise PGBackendError(
                f"pool {pool.pool_id}: {len(stores)} stores for "
                f"size={pool.size} pool"
            )
        return ReplicatedStore(stores=stores, size=pool.size)
    if pool.type == PG_POOL_TYPE_ERASURE:
        profiles = erasure_code_profiles or {}
        profile = profiles.get(pool.erasure_code_profile)
        if profile is None:
            raise PGBackendError(
                f"pool {pool.pool_id}: erasure code profile "
                f"{pool.erasure_code_profile!r} does not exist"
            )
        plugin = profile.get("plugin", "jerasure")
        return ECStore(
            plugin=plugin,
            profile={
                k: v for k, v in profile.items() if k != "plugin"
            },
            stores=stores,
            stripe_width=stripe_width,
        )
    raise PGBackendError(f"pool {pool.pool_id}: unknown type {pool.type}")
