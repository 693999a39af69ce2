"""OSDMap — epoch-versioned cluster map + the scalar PG→OSD oracle.

Pipeline semantics re-derived from src/osd/OSDMap.cc:
``pg_to_up_acting_osds`` (:2668) = raw_pg_to_pps seed → crush do_rule
(_pg_to_raw_osds :2436) → _apply_upmap (:2466) → _raw_to_up_osds
(:2513) → _pick_primary (:2456) → _apply_primary_affinity (:2540) →
_get_temp_osds (:2593).  PG seeds: pg_pool_t::raw_pg_to_pps
(src/osd/osd_types.cc:1793) with ceph_stable_mod
(src/include/rados.h:96-102) keeping splits stable.

Epoch machinery re-derived from ``class OSDMap::Incremental``
(src/osd/OSDMap.h:354-425) and ``OSDMap::apply_incremental``
(src/osd/OSDMap.cc:2062): an incremental is a diff from epoch-1 to
epoch; new_state entries are XORed onto the per-OSD state bits with
the destroy special-case; empty new_pg_temp values remove entries;
primary_temp -1 removes; upmap maps have explicit old_* removal sets.
Wire encode/decode uses the framework's versioned envelope
(common/encoding.py) with a crc32c trailer — same design as the
reference's ENCODE_START/crc scheme, not its exact byte layout.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..common.encoding import (
    Decoder,
    DecodeError,
    Encoder,
    decode_versioned,
    encode_versioned,
)
from ..crush.builder import CrushMap
from ..crush.encode import decode_crush_map, encode_crush_map
from ..crush.hashing import crush_hash32_2
from ..crush.types import (
    CRUSH_ITEM_NONE,
    PG_POOL_TYPE_ERASURE,
    PG_POOL_TYPE_REPLICATED,
)
from ..native import ceph_crc32c

CEPH_OSD_DEFAULT_PRIMARY_AFFINITY = 0x10000
CEPH_OSD_MAX_PRIMARY_AFFINITY = 0x10000

# process-wide raw CRUSH mapping memo (OSDMapMapping role,
# src/osd/OSDMapMapping.h): keyed on the crush CONTENT fingerprint +
# the exact do_rule inputs, so every daemon in an in-process cluster
# shares one pure-Python straw2 descent per (map, PG) instead of
# re-walking it per daemon — the 100-OSD scale harness turns a
# minutes-long map walk into one
_RAW_MAP_CACHE: dict = {}
_RAW_MAP_CACHE_MAX = 65536


def _crush_fp(crush: CrushMap) -> bytes:
    """Content fingerprint of a CrushMap, memoized against its
    ``mutation`` counter (bumped by every mutator) — the encode runs
    once per distinct map content per object, not per mapping.
    128-bit digest: a 32-bit crc keyed placement for the whole
    process, where a silent collision would misdirect I/O."""
    import hashlib

    cached = getattr(crush, "_content_fp", None)
    if cached is not None and cached[0] == crush.mutation:
        return cached[1]
    fp = hashlib.blake2b(
        encode_crush_map(crush), digest_size=16
    ).digest()
    crush._content_fp = (crush.mutation, fp)
    return fp

# per-OSD state bits (src/include/rados.h:125-132)
CEPH_OSD_EXISTS = 1 << 0
CEPH_OSD_UP = 1 << 1
CEPH_OSD_AUTOOUT = 1 << 2
CEPH_OSD_NEW = 1 << 3
CEPH_OSD_DESTROYED = 1 << 7


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Stable modulo: values keep their slot across pg_num doublings
    (src/include/rados.h:96-102)."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def _pg_mask(n: int) -> int:
    """Smallest all-ones mask covering [0, n) (pg_pool_t pg_num_mask)."""
    return (1 << max(n - 1, 0).bit_length()) - 1


@dataclass
class PgPool:
    """pg_pool_t subset relevant to mapping (src/osd/osd_types.h)."""

    pool_id: int
    type: int = PG_POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    pgp_num: int = 0  # defaults to pg_num
    crush_rule: int = 0
    erasure_code_profile: str = ""
    hashpspool: bool = True
    last_change: int = 0  # epoch of last pool modification
    # pool snapshots (pg_pool_t::snaps / snap_seq): snap id → name;
    # snap_seq is the newest snap id, the write path's snap context
    snap_seq: int = 0
    snaps: dict[int, str] = field(default_factory=dict)
    # cache tiering (pg_pool_t tier fields, src/osd/osd_types.h):
    # on a BASE pool, read_tier/write_tier name the overlay cache
    # pool clients route to; on a CACHE pool, tier_of names the base
    tier_of: int = -1
    read_tier: int = -1
    write_tier: int = -1
    cache_mode: str = ""  # "" | "writeback"
    target_max_objects: int = 0  # agent eviction pressure point

    def __post_init__(self):
        if not self.pgp_num:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return _pg_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return _pg_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        """Replicated mappings compact holes; EC keeps positions."""
        return self.type == PG_POOL_TYPE_REPLICATED

    def raw_pg_to_pg_seed(self, ps: int) -> int:
        """raw ps → stable pg seed (pg_pool_t::raw_pg_to_pg)."""
        return ceph_stable_mod(ps, self.pg_num, self.pg_num_mask)

    def raw_pg_to_pps(self, ps: int) -> int:
        """Placement seed fed to CRUSH (osd_types.cc:1793-1809)."""
        m = ceph_stable_mod(ps, self.pgp_num, self.pgp_num_mask)
        if self.hashpspool:
            return crush_hash32_2(m, self.pool_id & 0xFFFFFFFF)
        return m + self.pool_id


@dataclass
class OSDMap:
    """Cluster map: OSD state vectors + pools + the crush map.

    pg ids are (pool_id, ps) tuples; override maps are keyed by the
    stable pg seed like the reference's pg_t keys."""

    crush: CrushMap
    max_osd: int = 0
    epoch: int = 1
    pools: dict[int, PgPool] = field(default_factory=dict)
    osd_exists: list[bool] = field(default_factory=list)
    osd_up: list[bool] = field(default_factory=list)
    osd_weight: list[int] = field(default_factory=list)  # 16.16 reweight
    osd_primary_affinity: list[int] | None = None  # 16.16, None = defaults
    pg_temp: dict[tuple[int, int], list[int]] = field(default_factory=dict)
    primary_temp: dict[tuple[int, int], int] = field(default_factory=dict)
    pg_upmap: dict[tuple[int, int], list[int]] = field(default_factory=dict)
    pg_upmap_items: dict[tuple[int, int], list[tuple[int, int]]] = field(
        default_factory=dict
    )
    # epoch-machinery state (OSDMap.h map body beyond the mapping core)
    pool_max: int = -1  # highest pool id ever allocated
    flags: int = 0  # CEPH_OSDMAP_* cluster flags
    pool_names: dict[int, str] = field(default_factory=dict)
    erasure_code_profiles: dict[str, dict[str, str]] = field(
        default_factory=dict
    )
    # residual per-OSD state bits beyond EXISTS/UP (AUTOOUT/NEW/...)
    osd_flags: list[int] = field(default_factory=list)
    osd_addrs: dict[int, str] = field(default_factory=dict)
    osd_down_at: list[int] = field(default_factory=list)
    osd_up_from: list[int] = field(default_factory=list)
    blocklist: dict[str, float] = field(default_factory=dict)

    @classmethod
    def build(cls, crush: CrushMap, num_osd: int) -> OSDMap:
        return cls(
            crush=crush,
            max_osd=num_osd,
            osd_exists=[True] * num_osd,
            osd_up=[True] * num_osd,
            osd_weight=[0x10000] * num_osd,
            osd_flags=[0] * num_osd,
            osd_down_at=[0] * num_osd,
            osd_up_from=[0] * num_osd,
        )

    def add_pool(self, pool: PgPool) -> PgPool:
        self.pools[pool.pool_id] = pool
        self.pool_max = max(self.pool_max, pool.pool_id)
        return pool

    def is_blocklisted(self, addr: str, now: float | None = None) -> bool:
        """Client fencing check (OSDMap::is_blocklisted,
        src/osd/OSDMap.h:585).  ``addr`` is the client's entity
        address analog — here the objecter's client id.  Entries
        carry an absolute expiry; expired entries no longer fence
        (the mon trims them on later commits)."""
        until = self.blocklist.get(addr)
        if until is None:
            return False
        import time as _time

        return (now if now is not None else _time.time()) < until

    def set_max_osd(self, n: int) -> None:
        """Grow (or truncate) every per-OSD vector (OSDMap::set_max_osd).
        New slots exist but are down/out until an incremental boots them."""
        grow = n - self.max_osd
        for vec, fill in (
            (self.osd_exists, False),
            (self.osd_up, False),
            (self.osd_flags, 0),
            (self.osd_down_at, 0),
            (self.osd_up_from, 0),
        ):
            if grow > 0:
                vec.extend([fill] * grow)
            else:
                del vec[n:]
        if grow > 0:
            self.osd_weight.extend([0] * grow)
        else:
            del self.osd_weight[n:]
        if self.osd_primary_affinity is not None:
            if grow > 0:
                self.osd_primary_affinity.extend(
                    [CEPH_OSD_DEFAULT_PRIMARY_AFFINITY] * grow
                )
            else:
                del self.osd_primary_affinity[n:]
        self.max_osd = n

    # -- state bits --------------------------------------------------------
    def get_state(self, osd: int) -> int:
        """Composite CEPH_OSD_* bits for one OSD."""
        s = self.osd_flags[osd]
        if self.osd_exists[osd]:
            s |= CEPH_OSD_EXISTS
        if self.osd_up[osd]:
            s |= CEPH_OSD_UP
        return s

    def _set_state(self, osd: int, s: int) -> None:
        self.osd_exists[osd] = bool(s & CEPH_OSD_EXISTS)
        self.osd_up[osd] = bool(s & CEPH_OSD_UP)
        self.osd_flags[osd] = s & ~(CEPH_OSD_EXISTS | CEPH_OSD_UP)

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = [
                CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
            ] * self.max_osd
        self.osd_primary_affinity[osd] = aff

    # -- state queries -----------------------------------------------------
    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and self.osd_exists[osd]

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and self.osd_up[osd]

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def mark_down(self, osd: int) -> None:
        self.osd_up[osd] = False

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0

    # -- mapping pipeline (scalar oracle) ----------------------------------
    def _pg_to_raw_osds(self, pool: PgPool, ps: int) -> tuple[list[int], int]:
        pps = pool.raw_pg_to_pps(ps)
        ruleno = self.crush.find_rule(pool.crush_rule, pool.type, pool.size)
        raw: list[int] = []
        if ruleno >= 0:
            # process-wide raw-mapping memo (the OSDMapMapping role,
            # src/osd/OSDMapMapping.h: the reference precomputes every
            # PG's mapping per epoch rather than re-walking CRUSH).
            # In-process clusters hold one OSDMap copy PER DAEMON with
            # identical contents, so keying on content — crush
            # fingerprint + the exact do_rule inputs — lets 100
            # daemons share one descent per PG per epoch instead of
            # paying the pure-Python straw2 walk 100 times.
            key = (
                _crush_fp(self.crush),
                struct.pack(
                    f"<{len(self.osd_weight)}I", *self.osd_weight
                ),
                bytes(self.osd_exists),
                ruleno,
                pps,
                pool.size,
                pool.can_shift_osds(),
            )
            hit = _RAW_MAP_CACHE.get(key)
            if hit is not None:
                return list(hit), pps
            raw = self.crush.do_rule(ruleno, pps, pool.size, self.osd_weight)
            self._remove_nonexistent(pool, raw)
            if len(_RAW_MAP_CACHE) >= _RAW_MAP_CACHE_MAX:
                _RAW_MAP_CACHE.clear()
            _RAW_MAP_CACHE[key] = tuple(raw)
            return raw, pps
        self._remove_nonexistent(pool, raw)
        return raw, pps

    def _remove_nonexistent(self, pool: PgPool, osds: list[int]) -> None:
        if pool.can_shift_osds():
            osds[:] = [o for o in osds if self.exists(o)]
        else:
            for i, o in enumerate(osds):
                if o != CRUSH_ITEM_NONE and not self.exists(o):
                    osds[i] = CRUSH_ITEM_NONE

    def _apply_upmap(self, pool: PgPool, ps: int, raw: list[int]) -> list[int]:
        pg = (pool.pool_id, pool.raw_pg_to_pg_seed(ps))
        explicit = self.pg_upmap.get(pg)
        if explicit:
            if not any(
                o != CRUSH_ITEM_NONE
                and 0 <= o < self.max_osd
                and self.osd_weight[o] == 0
                for o in explicit
            ):
                raw = list(explicit)
        items = self.pg_upmap_items.get(pg)
        if items:
            for src, dst in items:
                pos = -1
                exists = False
                for i, o in enumerate(raw):
                    if o == dst:
                        exists = True
                        break
                    if o == src and pos < 0:
                        dst_out = (
                            dst != CRUSH_ITEM_NONE
                            and 0 <= dst < self.max_osd
                            and self.osd_weight[dst] == 0
                        )
                        if not dst_out:
                            pos = i
                if not exists and pos >= 0:
                    raw[pos] = dst
        return raw

    def _raw_to_up_osds(self, pool: PgPool, raw: list[int]) -> list[int]:
        if pool.can_shift_osds():
            return [o for o in raw if self.is_up(o)]
        return [
            o if o != CRUSH_ITEM_NONE and self.is_up(o) else CRUSH_ITEM_NONE
            for o in raw
        ]

    @staticmethod
    def _pick_primary(osds: list[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _apply_primary_affinity(
        self, pps: int, pool: PgPool, osds: list[int], primary: int
    ) -> tuple[list[int], int]:
        aff = self.osd_primary_affinity
        if aff is None:
            return osds, primary
        if not any(
            o != CRUSH_ITEM_NONE
            and aff[o] != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
            for o in osds
        ):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = aff[o]
            if (
                a < CEPH_OSD_MAX_PRIMARY_AFFINITY
                and (crush_hash32_2(pps, o) >> 16) >= a
            ):
                if pos < 0:
                    pos = i  # fallback, keep looking
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [osds[pos]] + osds[:pos] + osds[pos + 1 :]
        return osds, primary

    def _get_temp_osds(
        self, pool: PgPool, ps: int
    ) -> tuple[list[int], int]:
        pg = (pool.pool_id, pool.raw_pg_to_pg_seed(ps))
        temp_pg: list[int] = []
        for o in self.pg_temp.get(pg, []):
            if not self.is_up(o):
                if pool.can_shift_osds():
                    continue
                temp_pg.append(CRUSH_ITEM_NONE)
            else:
                temp_pg.append(o)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1 and temp_pg:
            temp_primary = self._pick_primary(temp_pg)
        return temp_pg, temp_primary

    def pg_to_up_acting_osds(
        self, pool_id: int, ps: int
    ) -> tuple[list[int], int, list[int], int]:
        """(up, up_primary, acting, acting_primary) — OSDMap.cc:2668."""
        pool = self.pools.get(pool_id)
        if pool is None or ps >= pool.pg_num:
            return [], -1, [], -1
        acting, acting_primary = self._get_temp_osds(pool, ps)
        raw, pps = self._pg_to_raw_osds(pool, ps)
        raw = self._apply_upmap(pool, ps, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(
            pps, pool, up, up_primary
        )
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    # -- incrementals ------------------------------------------------------
    def new_incremental(self) -> "Incremental":
        """Start a diff producing epoch+1 (OSDMonitor pending_inc role)."""
        return Incremental(epoch=self.epoch + 1)

    def apply_incremental(self, inc: "Incremental") -> None:
        """OSDMap::apply_incremental (OSDMap.cc:2062), field for field in
        the reference's order; asserts the epoch chain is contiguous."""
        if inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental epoch {inc.epoch} != map epoch "
                f"{self.epoch} + 1"
            )
        # validate BEFORE mutating anything: a bad osd id must not
        # leave a half-applied map at a phantom epoch
        effective_max = (
            inc.new_max_osd if inc.new_max_osd >= 0 else self.max_osd
        )
        for field_name in (
            "new_weight",
            "new_state",
            "new_primary_affinity",
            "new_up_client",
        ):
            for osd in getattr(inc, field_name):
                if not 0 <= osd < effective_max:
                    raise ValueError(
                        f"{field_name} osd.{osd} out of range "
                        f"[0, {effective_max})"
                    )
        self.epoch += 1

        if inc.fullmap is not None:
            full = OSDMap.decode(inc.fullmap)
            if full.epoch != self.epoch:
                raise ValueError("fullmap epoch mismatch")
            self.__dict__.update(full.__dict__)
            return
        if inc.crush is not None:
            self.crush = (
                decode_crush_map(inc.crush)
                if isinstance(inc.crush, bytes)
                else inc.crush
            )

        if inc.new_flags >= 0:
            self.flags = inc.new_flags
        if inc.new_max_osd >= 0:
            self.set_max_osd(inc.new_max_osd)
        if inc.new_pool_max != -1:
            self.pool_max = inc.new_pool_max
        for pool_id, pool in inc.new_pools.items():
            self.pools[pool_id] = pool
            pool.last_change = self.epoch
            self.pool_max = max(self.pool_max, pool_id)
        for pool_id, name in inc.new_pool_names.items():
            self.pool_names[pool_id] = name
        for pool_id in inc.old_pools:
            self.pools.pop(pool_id, None)
            self.pool_names.pop(pool_id, None)

        for osd, w in inc.new_weight.items():
            self.osd_weight[osd] = w
            if w:
                # marking in clears AUTOOUT/NEW (OSDMap.cc:2153-2159)
                self.osd_flags[osd] &= ~(CEPH_OSD_AUTOOUT | CEPH_OSD_NEW)
        for osd, aff in inc.new_primary_affinity.items():
            self.set_primary_affinity(osd, aff)

        for name in inc.old_erasure_code_profiles:
            self.erasure_code_profiles.pop(name, None)
        for name, profile in inc.new_erasure_code_profiles.items():
            self.erasure_code_profiles[name] = dict(profile)

        # up/down: XOR with the destroy special-case (OSDMap.cc:2177-2201)
        for osd, st in inc.new_state.items():
            s = st if st else CEPH_OSD_UP
            cur = self.get_state(osd)
            if (cur & CEPH_OSD_UP) and (s & CEPH_OSD_UP):
                self.osd_down_at[osd] = self.epoch
            if (cur & CEPH_OSD_EXISTS) and (s & CEPH_OSD_EXISTS):
                # destroyed: clear out anything interesting
                if self.osd_primary_affinity is not None:
                    self.osd_primary_affinity[osd] = (
                        CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
                    )
                self.osd_addrs.pop(osd, None)
                self.osd_down_at[osd] = 0
                self.osd_up_from[osd] = 0
                self._set_state(osd, 0)
            else:
                self._set_state(osd, cur ^ s)
        for osd, addr in inc.new_up_client.items():
            cur = self.get_state(osd)
            self._set_state(osd, cur | CEPH_OSD_EXISTS | CEPH_OSD_UP)
            self.osd_addrs[osd] = addr
            self.osd_up_from[osd] = self.epoch

        for pg, osds in inc.new_pg_temp.items():
            if not osds:
                self.pg_temp.pop(pg, None)
            else:
                self.pg_temp[pg] = list(osds)
        for pg, primary in inc.new_primary_temp.items():
            if primary == -1:
                self.primary_temp.pop(pg, None)
            else:
                self.primary_temp[pg] = primary
        for pg, osds in inc.new_pg_upmap.items():
            self.pg_upmap[pg] = list(osds)
        for pg in inc.old_pg_upmap:
            self.pg_upmap.pop(pg, None)
        for pg, items in inc.new_pg_upmap_items.items():
            self.pg_upmap_items[pg] = list(items)
        for pg in inc.old_pg_upmap_items:
            self.pg_upmap_items.pop(pg, None)

        for addr, until in inc.new_blocklist.items():
            self.blocklist[addr] = until
        for addr in inc.old_blocklist:
            self.blocklist.pop(addr, None)

    # -- wire --------------------------------------------------------------
    def encode(self) -> bytes:
        e = Encoder()
        e.u32(self.epoch)
        e.s32(self.max_osd)
        e.s64(self.pool_max)
        e.u32(self.flags)
        e.bytes(encode_crush_map(self.crush))
        e.map(self.pools, lambda e2, k: e2.s64(k), _enc_pool)
        e.map(
            self.pool_names,
            lambda e2, k: e2.s64(k),
            lambda e2, v: e2.string(v),
        )
        e.map(
            self.erasure_code_profiles,
            lambda e2, k: e2.string(k),
            lambda e2, v: e2.map(
                v, lambda e3, k2: e3.string(k2), lambda e3, v2: e3.string(v2)
            ),
        )
        e.list(self.osd_exists, lambda e2, v: e2.bool(v))
        e.list(self.osd_up, lambda e2, v: e2.bool(v))
        e.list(self.osd_weight, lambda e2, v: e2.u64(v))
        e.list(self.osd_flags, lambda e2, v: e2.u32(v))
        e.list(self.osd_down_at, lambda e2, v: e2.u32(v))
        e.list(self.osd_up_from, lambda e2, v: e2.u32(v))
        if self.osd_primary_affinity is None:
            e.bool(False)
        else:
            e.bool(True)
            e.list(self.osd_primary_affinity, lambda e2, v: e2.u64(v))
        e.map(
            self.osd_addrs, lambda e2, k: e2.s32(k),
            lambda e2, v: e2.string(v),
        )
        _enc_pgmap(e, self.pg_temp, _enc_osd_list)
        _enc_pgmap(e, self.primary_temp, lambda e2, v: e2.s32(v))
        _enc_pgmap(e, self.pg_upmap, _enc_osd_list)
        _enc_pgmap(e, self.pg_upmap_items, _enc_pairs)
        e.map(
            self.blocklist, lambda e2, k: e2.string(k),
            lambda e2, v: e2.f64(v),
        )
        body = encode_versioned(1, 1, e.getvalue())
        return body + ceph_crc32c(0, body).to_bytes(4, "little")

    @classmethod
    def decode(cls, data: bytes) -> "OSDMap":
        if len(data) < 4:
            raise DecodeError("osdmap blob too short")
        body, crc = data[:-4], int.from_bytes(data[-4:], "little")
        if ceph_crc32c(0, body) != crc:
            raise DecodeError("osdmap crc mismatch")
        _version, d = decode_versioned(Decoder(body), 1)
        m = cls(crush=None)  # placeholder, replaced below
        m.epoch = d.u32()
        m.max_osd = d.s32()
        m.pool_max = d.s64()
        m.flags = d.u32()
        m.crush = decode_crush_map(d.bytes())
        m.pools = d.map(lambda d2: d2.s64(), _dec_pool)
        m.pool_names = d.map(lambda d2: d2.s64(), lambda d2: d2.string())
        m.erasure_code_profiles = d.map(
            lambda d2: d2.string(),
            lambda d2: d2.map(
                lambda d3: d3.string(), lambda d3: d3.string()
            ),
        )
        m.osd_exists = d.list(lambda d2: d2.bool())
        m.osd_up = d.list(lambda d2: d2.bool())
        m.osd_weight = d.list(lambda d2: d2.u64())
        m.osd_flags = d.list(lambda d2: d2.u32())
        m.osd_down_at = d.list(lambda d2: d2.u32())
        m.osd_up_from = d.list(lambda d2: d2.u32())
        m.osd_primary_affinity = (
            d.list(lambda d2: d2.u64()) if d.bool() else None
        )
        m.osd_addrs = d.map(lambda d2: d2.s32(), lambda d2: d2.string())
        m.pg_temp = _dec_pgmap(d, _dec_osd_list)
        m.primary_temp = _dec_pgmap(d, lambda d2: d2.s32())
        m.pg_upmap = _dec_pgmap(d, _dec_osd_list)
        m.pg_upmap_items = _dec_pgmap(d, _dec_pairs)
        m.blocklist = d.map(lambda d2: d2.string(), lambda d2: d2.f64())
        return m


@dataclass
class Incremental:
    """A diff from epoch-1 to epoch (OSDMap.h:354 class Incremental;
    the subset of its ~40 fields this framework models — addr vectors
    collapse to one string, info/xinfo to down_at/up_from epochs)."""

    epoch: int
    new_flags: int = -1
    new_max_osd: int = -1
    new_pool_max: int = -1
    fullmap: bytes | None = None
    crush: bytes | CrushMap | None = None
    new_pools: dict[int, PgPool] = field(default_factory=dict)
    new_pool_names: dict[int, str] = field(default_factory=dict)
    old_pools: set[int] = field(default_factory=set)
    new_erasure_code_profiles: dict[str, dict[str, str]] = field(
        default_factory=dict
    )
    old_erasure_code_profiles: list[str] = field(default_factory=list)
    new_up_client: dict[int, str] = field(default_factory=dict)
    new_state: dict[int, int] = field(default_factory=dict)  # XORed
    new_weight: dict[int, int] = field(default_factory=dict)
    new_primary_affinity: dict[int, int] = field(default_factory=dict)
    new_pg_temp: dict[tuple[int, int], list[int]] = field(
        default_factory=dict
    )
    new_primary_temp: dict[tuple[int, int], int] = field(
        default_factory=dict
    )
    new_pg_upmap: dict[tuple[int, int], list[int]] = field(
        default_factory=dict
    )
    old_pg_upmap: set[tuple[int, int]] = field(default_factory=set)
    new_pg_upmap_items: dict[
        tuple[int, int], list[tuple[int, int]]
    ] = field(default_factory=dict)
    old_pg_upmap_items: set[tuple[int, int]] = field(default_factory=set)
    new_blocklist: dict[str, float] = field(default_factory=dict)
    old_blocklist: list[str] = field(default_factory=list)

    # -- OSDMonitor-style convenience mutators -----------------------------
    def mark_down(self, osd: int) -> None:
        """Queue an up→down flip (prepare_failure outcome): XOR of UP."""
        self.new_state[osd] = self.new_state.get(osd, 0) | CEPH_OSD_UP

    def mark_up(self, osd: int, addr: str = "") -> None:
        self.new_up_client[osd] = addr

    def mark_out(self, osd: int) -> None:
        self.new_weight[osd] = 0

    def mark_in(self, osd: int, weight: int = 0x10000) -> None:
        self.new_weight[osd] = weight

    def destroy(self, osd: int) -> None:
        self.new_state[osd] = CEPH_OSD_EXISTS

    # -- wire --------------------------------------------------------------
    def encode(self) -> bytes:
        e = Encoder()
        e.u32(self.epoch)
        e.s32(self.new_flags)
        e.s32(self.new_max_osd)
        e.s64(self.new_pool_max)
        for blob in (self.fullmap, _crush_blob(self.crush)):
            if blob is None:
                e.bool(False)
            else:
                e.bool(True)
                e.bytes(blob)
        e.map(self.new_pools, lambda e2, k: e2.s64(k), _enc_pool)
        e.map(
            self.new_pool_names, lambda e2, k: e2.s64(k),
            lambda e2, v: e2.string(v),
        )
        e.list(sorted(self.old_pools), lambda e2, v: e2.s64(v))
        e.map(
            self.new_erasure_code_profiles,
            lambda e2, k: e2.string(k),
            lambda e2, v: e2.map(
                v, lambda e3, k2: e3.string(k2), lambda e3, v2: e3.string(v2)
            ),
        )
        e.list(
            sorted(self.old_erasure_code_profiles),
            lambda e2, v: e2.string(v),
        )
        e.map(
            self.new_up_client, lambda e2, k: e2.s32(k),
            lambda e2, v: e2.string(v),
        )
        e.map(self.new_state, lambda e2, k: e2.s32(k), lambda e2, v: e2.u32(v))
        e.map(self.new_weight, lambda e2, k: e2.s32(k), lambda e2, v: e2.u64(v))
        e.map(
            self.new_primary_affinity, lambda e2, k: e2.s32(k),
            lambda e2, v: e2.u64(v),
        )
        _enc_pgmap(e, self.new_pg_temp, _enc_osd_list)
        _enc_pgmap(e, self.new_primary_temp, lambda e2, v: e2.s32(v))
        _enc_pgmap(e, self.new_pg_upmap, _enc_osd_list)
        e.list(sorted(self.old_pg_upmap), _enc_pg)
        _enc_pgmap(e, self.new_pg_upmap_items, _enc_pairs)
        e.list(sorted(self.old_pg_upmap_items), _enc_pg)
        e.map(
            self.new_blocklist, lambda e2, k: e2.string(k),
            lambda e2, v: e2.f64(v),
        )
        e.list(sorted(self.old_blocklist), lambda e2, v: e2.string(v))
        body = encode_versioned(1, 1, e.getvalue())
        return body + ceph_crc32c(0, body).to_bytes(4, "little")

    @classmethod
    def decode(cls, data: bytes) -> "Incremental":
        if len(data) < 4:
            raise DecodeError("incremental blob too short")
        body, crc = data[:-4], int.from_bytes(data[-4:], "little")
        if ceph_crc32c(0, body) != crc:
            raise DecodeError("incremental crc mismatch")
        _version, d = decode_versioned(Decoder(body), 1)
        inc = cls(epoch=d.u32())
        inc.new_flags = d.s32()
        inc.new_max_osd = d.s32()
        inc.new_pool_max = d.s64()
        inc.fullmap = d.bytes() if d.bool() else None
        inc.crush = d.bytes() if d.bool() else None
        inc.new_pools = d.map(lambda d2: d2.s64(), _dec_pool)
        inc.new_pool_names = d.map(
            lambda d2: d2.s64(), lambda d2: d2.string()
        )
        inc.old_pools = set(d.list(lambda d2: d2.s64()))
        inc.new_erasure_code_profiles = d.map(
            lambda d2: d2.string(),
            lambda d2: d2.map(
                lambda d3: d3.string(), lambda d3: d3.string()
            ),
        )
        inc.old_erasure_code_profiles = d.list(lambda d2: d2.string())
        inc.new_up_client = d.map(
            lambda d2: d2.s32(), lambda d2: d2.string()
        )
        inc.new_state = d.map(lambda d2: d2.s32(), lambda d2: d2.u32())
        inc.new_weight = d.map(lambda d2: d2.s32(), lambda d2: d2.u64())
        inc.new_primary_affinity = d.map(
            lambda d2: d2.s32(), lambda d2: d2.u64()
        )
        inc.new_pg_temp = _dec_pgmap(d, _dec_osd_list)
        inc.new_primary_temp = _dec_pgmap(d, lambda d2: d2.s32())
        inc.new_pg_upmap = _dec_pgmap(d, _dec_osd_list)
        inc.old_pg_upmap = set(d.list(_dec_pg))
        inc.new_pg_upmap_items = _dec_pgmap(d, _dec_pairs)
        inc.old_pg_upmap_items = set(d.list(_dec_pg))
        inc.new_blocklist = d.map(
            lambda d2: d2.string(), lambda d2: d2.f64()
        )
        inc.old_blocklist = d.list(lambda d2: d2.string())
        return inc


# -- encode helpers --------------------------------------------------------


def _crush_blob(crush) -> bytes | None:
    if crush is None:
        return None
    return crush if isinstance(crush, bytes) else encode_crush_map(crush)


def _enc_pool(e: Encoder, p: PgPool) -> None:
    e.s64(p.pool_id).u8(p.type).u32(p.size).u32(p.min_size)
    e.u32(p.pg_num).u32(p.pgp_num).u32(p.crush_rule)
    e.string(p.erasure_code_profile).bool(p.hashpspool)
    e.u32(p.last_change)
    e.u64(p.snap_seq)
    e.map(
        p.snaps,
        lambda e2, k: e2.u64(k),
        lambda e2, v: e2.string(v),
    )
    e.s64(p.tier_of).s64(p.read_tier).s64(p.write_tier)
    e.string(p.cache_mode).u64(p.target_max_objects)


def _dec_pool(d: Decoder) -> PgPool:
    return PgPool(
        pool_id=d.s64(),
        type=d.u8(),
        size=d.u32(),
        min_size=d.u32(),
        pg_num=d.u32(),
        pgp_num=d.u32(),
        crush_rule=d.u32(),
        erasure_code_profile=d.string(),
        hashpspool=d.bool(),
        last_change=d.u32(),
        snap_seq=d.u64(),
        snaps=d.map(lambda d2: d2.u64(), lambda d2: d2.string()),
        tier_of=d.s64(),
        read_tier=d.s64(),
        write_tier=d.s64(),
        cache_mode=d.string(),
        target_max_objects=d.u64(),
    )


def _enc_pg(e: Encoder, pg: tuple[int, int]) -> None:
    e.s64(pg[0]).u32(pg[1])


def _dec_pg(d: Decoder) -> tuple[int, int]:
    return (d.s64(), d.u32())


def _enc_osd_list(e: Encoder, osds: list[int]) -> None:
    e.list(osds, lambda e2, o: e2.s32(o))


def _dec_osd_list(d: Decoder) -> list[int]:
    return d.list(lambda d2: d2.s32())


def _enc_pairs(e: Encoder, pairs: list[tuple[int, int]]) -> None:
    e.list(pairs, lambda e2, p: e2.s32(p[0]).s32(p[1]))


def _dec_pairs(d: Decoder) -> list[tuple[int, int]]:
    return d.list(lambda d2: (d2.s32(), d2.s32()))


def _enc_pgmap(e: Encoder, m: dict, val_fn) -> None:
    e.u32(len(m))
    for pg in sorted(m):
        _enc_pg(e, pg)
        val_fn(e, m[pg])


def _dec_pgmap(d: Decoder, val_fn) -> dict:
    return {_dec_pg(d): val_fn(d) for _ in range(d.u32())}
