"""The OSD map's placement pipeline for one PG, a frozen plain copy of
OSDMap::pg_to_up_acting_osds (OSDMap.cc): placement seed, CRUSH,
nonexistent OSDs, pg_upmap and pg_upmap_items, down OSDs, primary
affinity, pg_temp and primary_temp."""

from __future__ import annotations

from dataclasses import dataclass, field

from .crush import ITEM_NONE, Hierarchy, do_rule, hash32_2

DEFAULT_AFFINITY = 0x10000
MAX_AFFINITY = 0x10000


@dataclass
class Pool:
    pool_id: int
    replicated: bool
    size: int
    pg_num: int
    rule: int


@dataclass
class MapState:
    crush: Hierarchy
    max_osd: int
    exists: list = field(default_factory=list)
    up: list = field(default_factory=list)
    weight: list = field(default_factory=list)
    affinity: list = field(default_factory=list)
    pg_temp: dict = field(default_factory=dict)
    primary_temp: dict = field(default_factory=dict)
    pg_upmap: dict = field(default_factory=dict)
    pg_upmap_items: dict = field(default_factory=dict)

    @classmethod
    def fresh(cls, crush: Hierarchy, n: int) -> "MapState":
        return cls(crush, n, [True] * n, [True] * n, [0x10000] * n,
                   [DEFAULT_AFFINITY] * n)

    def is_up(self, o: int) -> bool:
        return 0 <= o < self.max_osd and self.exists[o] and self.up[o]


def _mask(n: int) -> int:
    return (1 << max(n - 1, 0).bit_length()) - 1


def stable_mod(x: int, b: int, bmask: int) -> int:
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def pg_seed(pool: Pool, ps: int) -> int:
    return stable_mod(ps, pool.pg_num, _mask(pool.pg_num))


def pps_of(pool: Pool, ps: int) -> int:
    """raw_pg_to_pps of a hashpspool pool."""
    return hash32_2(pg_seed(pool, ps), pool.pool_id)


def object_ps(pool: Pool, name: str) -> int:
    from .crush import str_hash_rjenkins

    return pg_seed(pool, str_hash_rjenkins(name))


def _apply_upmap(st: MapState, pool: Pool, ps: int, raw: list) -> list:
    pg = (pool.pool_id, pg_seed(pool, ps))
    explicit = st.pg_upmap.get(pg)
    if explicit and not any(
        o != ITEM_NONE and 0 <= o < st.max_osd and st.weight[o] == 0 for o in explicit
    ):
        raw = list(explicit)
    for src, dst in st.pg_upmap_items.get(pg) or ():
        pos, exists = -1, False
        for i, o in enumerate(raw):
            if o == dst:
                exists = True
                break
            if o == src and pos < 0:
                if not (dst != ITEM_NONE and 0 <= dst < st.max_osd and st.weight[dst] == 0):
                    pos = i
        if not exists and pos >= 0:
            raw[pos] = dst
    return raw


def _first(osds: list) -> int:
    return next((o for o in osds if o != ITEM_NONE), -1)


def pg_to_up_acting(st: MapState, pool: Pool, ps: int) -> tuple:
    """(up, up_primary, acting, acting_primary); replicated pools
    compact holes, erasure pools keep ITEM_NONE at their positions."""
    pg = (pool.pool_id, pg_seed(pool, ps))
    temp = []
    for o in st.pg_temp.get(pg, []):
        if not st.is_up(o):
            if not pool.replicated:
                temp.append(ITEM_NONE)
        else:
            temp.append(o)
    temp_primary = st.primary_temp.get(pg, -1)
    if temp_primary == -1 and temp:
        temp_primary = _first(temp)

    pps = pps_of(pool, ps)
    raw = do_rule(st.crush, pool.rule, pps, pool.size, st.weight)
    exists = lambda o: 0 <= o < st.max_osd and st.exists[o]  # noqa: E731
    if pool.replicated:
        raw = [o for o in raw if exists(o)]
    else:
        raw = [o if o == ITEM_NONE or exists(o) else ITEM_NONE for o in raw]
    raw = _apply_upmap(st, pool, ps, raw)
    if pool.replicated:
        up = [o for o in raw if st.is_up(o)]
    else:
        up = [o if o != ITEM_NONE and st.is_up(o) else ITEM_NONE for o in raw]
    up_primary = _first(up)

    if any(o != ITEM_NONE and st.affinity[o] != DEFAULT_AFFINITY for o in up):
        pos = -1
        for i, o in enumerate(up):
            if o == ITEM_NONE:
                continue
            a = st.affinity[o]
            if a < MAX_AFFINITY and (hash32_2(pps, o) >> 16) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos >= 0:
            up_primary = up[pos]
            if pool.replicated and pos > 0:
                up = [up[pos]] + up[:pos] + up[pos + 1:]

    acting, acting_primary = temp, temp_primary
    if not acting:
        acting = list(up)
        if acting_primary == -1:
            acting_primary = up_primary
    return up, up_primary, acting, acting_primary
