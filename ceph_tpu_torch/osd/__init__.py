"""OSD cluster-map layer of the port: pools, OSD state, PG→OSD mapping,
and the per-pool erasure codec.

The reference's OSDMap (src/osd/OSDMap.{h,cc}) is an epoch-versioned
cluster map whose hot path is ``pg_to_up_acting_osds`` — a scalar oracle
here (``osdmap``) plus a batched torch pipeline (``mapping``) that
recomputes every PG of every pool on the card in one pass per pool (the
OSDMapMapping/ParallelPGMapper role, src/osd/OSDMapMapping.h:18-156).
``balancer.calc_pg_upmaps`` plans pg_upmap_items over it, and
``ec_pg.ECCodec`` is the OSD's erasure codec.
"""

from .ec_pg import DEFAULT_STRIPE_UNIT, ECCodec
from .mapping import OSDMapMapping
from .osdmap import Incremental, OSDMap, PgPool

__all__ = [
    "DEFAULT_STRIPE_UNIT",
    "ECCodec",
    "Incremental",
    "OSDMap",
    "OSDMapMapping",
    "PgPool",
]
