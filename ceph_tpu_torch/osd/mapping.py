"""Batched full-map PG→OSD computation (OSDMapMapping replacement).

The reference shards pgid ranges over a thread pool
(ParallelPGMapper, src/osd/OSDMapMapping.h:18-156).  Here every stage
of a pool runs as torch over all its PGs on the mapping's device (cuda
by default): the placement seeds, the CRUSH stage (``torchmap``, whose
lanes past the fast path's speculation window the oracle re-maps), the
nonexistent/down filtering and compaction, the primary and the primary
affinity draws.  The sparse overrides (pg_upmap, pg_upmap_items,
pg_temp, primary_temp) touch only their rows: those are read once,
fixed through ``OSDMap``'s scalar helpers and written back.  The four
result arrays come back to the host in one download per pool.  A map
outside the batched mapper's scope (``torchmap.UnsupportedMap``) maps
through the scalar oracle, as does ``use_device=False``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crush import torchmap
from ..crush.types import CRUSH_ITEM_NONE
from .osdmap import (
    CEPH_OSD_DEFAULT_PRIMARY_AFFINITY,
    CEPH_OSD_MAX_PRIMARY_AFFINITY,
    OSDMap,
    PgPool,
)

_NONE = CRUSH_ITEM_NONE


def _stable_mod_vec(x: torch.Tensor, b: int, bmask: int) -> torch.Tensor:
    lo = x & bmask
    return torch.where(lo < b, lo, x & (bmask >> 1))


def pool_pps_vec(pool: PgPool, ps: torch.Tensor) -> torch.Tensor:
    """pg_pool_t::raw_pg_to_pps over a tensor of placement seeds: the
    uint32 results as int64."""
    m = _stable_mod_vec(ps, pool.pgp_num, pool.pgp_num_mask)
    if pool.hashpspool:
        pid = torch.tensor(
            pool.pool_id & 0xFFFFFFFF, dtype=torch.int64, device=ps.device
        ).to(torch.int32)
        return torchmap._u32(torchmap.hash2(m.to(torch.int32), pid))
    return (m + pool.pool_id) & 0xFFFFFFFF


def _compact_rows(osds: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shift valid entries left per row (replicated-pool hole removal);
    invalid tail slots become CRUSH_ITEM_NONE."""
    order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    packed = osds.gather(1, order)
    keep = valid.gather(1, order)
    return torch.where(keep, packed, _NONE)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 for none), like np.argmax."""
    return mask.to(torch.uint8).argmax(1)


def _build_perf():
    from ..common import PerfCountersBuilder

    return (
        PerfCountersBuilder("osdmap_mapping")
        .add_u64_counter("updates", "full-map recomputes")
        .add_u64_counter("pgs_mapped", "PGs mapped across updates")
        .add_time_avg("crush_stage", "device/oracle CRUSH stage time")
        .add_time_avg("fixup_stages", "fix-up stage time, download included")
        .create_perf_counters()
    )


class OSDMapMapping:
    """Caches up/acting/primaries for every PG of every pool
    (the consumer API of src/osd/OSDMapMapping.h:173-340) as numpy int64
    arrays; exposes reference-style perf counters (the l_osd_* analog)
    via ``self.perf.dump()``.  ``device`` (default ``cuda``) is where
    the pipeline runs."""

    def __init__(self, device=None):
        self.device = torch.device("cuda" if device is None else device)
        self.up: dict[int, np.ndarray] = {}
        self.up_primary: dict[int, np.ndarray] = {}
        self.acting: dict[int, np.ndarray] = {}
        self.acting_primary: dict[int, np.ndarray] = {}
        self.epoch = 0
        self.perf = _build_perf()

    # -- batch pipeline ----------------------------------------------------
    def update(self, osdmap: OSDMap, use_device: bool = True) -> None:
        """Recompute every pool's full PG mapping; ``use_device=False``
        maps through the scalar oracle and fixes up on the CPU."""
        self.epoch = osdmap.epoch
        self.perf.inc("updates")
        for pool_id, pool in osdmap.pools.items():
            self._update_pool(osdmap, pool, use_device)
            self.perf.inc("pgs_mapped", pool.pg_num)

    def _update_pool(
        self, osdmap: OSDMap, pool: PgPool, use_device: bool
    ) -> None:
        from ..ops.kernel_stats import kernel_stats

        dev = self.device if use_device else torch.device("cpu")
        n = pool.pg_num
        ps = torch.arange(n, dtype=torch.int64, device=dev)
        pps = pool_pps_vec(pool, ps)

        ks = kernel_stats()
        pgs_counter = ks.counter(
            "crush", "pgs", desc="PGs mapped through the CRUSH kernel"
        )
        nbytes = n * 8
        with self.perf.time_it("crush_stage"), ks.timed(
            "crush", bytes_in=nbytes
        ) as kt:
            raw = self._crush_stage(osdmap, pool, pps, use_device)
            kt.bytes_out = raw.numel() * raw.element_size()
        ks.perf.inc(pgs_counter, n)

        with self.perf.time_it("fixup_stages"):
            out = self._fixup(osdmap, pool, pps, raw).cpu().numpy()
        size = raw.shape[1]
        self.up[pool.pool_id] = out[:, :size]
        self.up_primary[pool.pool_id] = out[:, size]
        self.acting[pool.pool_id] = out[:, size + 1 : 2 * size + 1]
        self.acting_primary[pool.pool_id] = out[:, 2 * size + 1]

    def _fixup(self, osdmap, pool, pps, raw):
        """The stages after CRUSH on raw's device; returns one (n,
        2*size+2) tensor: up | up_primary | acting | acting_primary."""
        dev = raw.device
        # _remove_nonexistent_osds + _raw_to_up_osds, fused: both drop
        # to NONE (EC) or compact (replicated)
        exists = torch.zeros(osdmap.max_osd + 1, dtype=torch.bool)
        exists[:-1] = torch.as_tensor(np.asarray(osdmap.osd_exists, dtype=bool))
        up_ok = exists.clone()
        up_ok[:-1] &= torch.as_tensor(np.asarray(osdmap.osd_up, dtype=bool))
        exists, up_ok = exists.to(dev), up_ok.to(dev)
        idx = raw.clamp(0, osdmap.max_osd)
        in_range = (raw >= 0) & (raw < osdmap.max_osd)
        raw_exists = in_range & exists[idx]
        if pool.can_shift_osds():
            raw = _compact_rows(raw, raw_exists)
        else:
            raw = torch.where(raw_exists | (raw == _NONE), raw, _NONE)

        raw = self._upmap_stage(osdmap, pool, raw)

        idx = raw.clamp(0, osdmap.max_osd)
        in_range = (raw >= 0) & (raw < osdmap.max_osd)
        alive = in_range & up_ok[idx]
        if pool.can_shift_osds():
            up = _compact_rows(raw, alive)
        else:
            up = torch.where(alive, raw, _NONE)

        up_primary = self._primary_vec(up)
        up, up_primary = self._affinity_stage(
            osdmap, pool, pps, up, up_primary
        )

        acting = up.clone()
        acting_primary = up_primary.clone()
        self._temp_stage(osdmap, pool, acting, acting_primary)
        return torch.cat(
            [up, up_primary[:, None], acting, acting_primary[:, None]], 1
        )

    def _crush_stage(
        self, osdmap: OSDMap, pool: PgPool, pps: torch.Tensor, use_device: bool
    ) -> torch.Tensor:
        """(npgs, size) raw mappings on pps's device via the batched
        mapper; the scalar oracle outside its scope."""
        from ..ops.profiler import dispatch_profiler

        ruleno = osdmap.crush.find_rule(pool.crush_rule, pool.type, pool.size)
        n = pps.shape[0]
        dev = pps.device
        if ruleno < 0:
            return torch.full((n, pool.size), _NONE, device=dev)
        if use_device:
            from ..ops.residency import note_shape

            try:
                cm = _compiled(osdmap.crush, dev)
                # an UnsupportedMap raised in here discards the
                # flight-recorder entry (no commit on exception); the
                # oracle loop below records its own
                with dispatch_profiler().dispatch(
                    "crush", backend="torch"
                ) as dp:
                    dp.set_ops(1)
                    dp.set_stripes(n)
                    dp.add_bytes_in(n * 8)
                    note_shape("crush_batch", n, pool.size)
                    return self._device_rule(
                        dp, cm, ruleno, pps, pool.size, osdmap.osd_weight
                    )
            except torchmap.UnsupportedMap:
                pass

        with dispatch_profiler().dispatch("crush", backend="cpu") as dp:
            dp.set_ops(1)
            dp.set_stripes(n)
            dp.add_bytes_in(n * 8)
            raw = np.full((n, pool.size), _NONE, dtype=np.int64)
            for i, x in enumerate(pps.cpu().tolist()):
                row = osdmap.crush.do_rule(
                    ruleno, x, pool.size, osdmap.osd_weight
                )
                raw[i, : len(row)] = row
            return torch.as_tensor(raw, device=dev)

    @staticmethod
    def _device_rule(dp, cm, ruleno, pps, size, weights):
        """torchmap's raw output over CHUNK-lane pieces, the oracle's
        rows written over the lanes that outran the fast path's window
        (one read of their indices), positions past each count NONE."""
        n = pps.shape[0]
        with dp.stage("compute"):
            parts = [
                torchmap.batch_do_rule_raw(
                    cm, ruleno, pps[i : i + torchmap.CHUNK], size, weights
                )
                for i in range(0, n, torchmap.CHUNK)
            ]
            res, counts, ok = (torch.cat(p) for p in zip(*parts))
            res, counts = res.to(torch.int64), counts.to(torch.int64)
        with dp.stage("sync"):
            bad = (~ok).nonzero().squeeze(1)
            if bad.numel():
                fres, fcounts = torchmap.apply_oracle_fallback(
                    cm, ruleno, pps[bad], res[bad], counts[bad], ok[bad],
                    size, weights,
                )
                res[bad] = torch.as_tensor(fres, device=pps.device).to(torch.int64)
                counts[bad] = torch.as_tensor(fcounts, device=pps.device).to(
                    torch.int64
                )
        # positions beyond the returned count are absent, not NONE
        cols = torch.arange(size, device=pps.device)
        return torch.where(cols[None, :] < counts[:, None], res, _NONE)

    def _upmap_stage(self, osdmap, pool, raw):
        """Sparse dict overrides: the affected rows are read once, fixed
        by ``OSDMap._apply_upmap`` and written back."""
        pid = pool.pool_id
        rows = sorted(
            {
                seed
                for m in (osdmap.pg_upmap, osdmap.pg_upmap_items)
                for (p, seed) in m
                if p == pid and 0 <= seed < pool.pg_num
            }
        )
        if not rows:
            return raw
        at = torch.tensor(rows, device=raw.device)
        got = raw[at].cpu().numpy()
        fixed = np.full_like(got, _NONE)
        for i, ps in enumerate(rows):
            cur = [int(o) for o in got[i]]
            if pool.can_shift_osds():
                cur = [o for o in cur if o != _NONE]
            new = osdmap._apply_upmap(pool, ps, cur)
            fixed[i, : len(new)] = new
        raw = raw.clone()
        raw[at] = torch.as_tensor(fixed, device=raw.device)
        return raw

    @staticmethod
    def _primary_vec(up: torch.Tensor) -> torch.Tensor:
        """First non-NONE per row, -1 if none (OSDMap::_pick_primary)."""
        valid = up != _NONE
        first = up.gather(1, _first(valid)[:, None]).squeeze(1)
        return torch.where(valid.any(1), first, -1)

    def _affinity_stage(self, osdmap, pool, pps, up, up_primary):
        """Vectorized _apply_primary_affinity (OSDMap.cc:2540-2590)."""
        aff = osdmap.osd_primary_affinity
        if aff is None or all(
            a == CEPH_OSD_DEFAULT_PRIMARY_AFFINITY for a in aff
        ):
            return up, up_primary
        dev = up.device
        affv = torch.zeros(osdmap.max_osd + 1, dtype=torch.int64)
        affv[:-1] = torch.as_tensor(np.asarray(aff, dtype=np.int64))
        affv = affv.to(dev)
        idx = up.clamp(0, osdmap.max_osd)
        valid = (up != _NONE) & (up >= 0) & (up < osdmap.max_osd)
        a = torch.where(valid, affv[idx], CEPH_OSD_DEFAULT_PRIMARY_AFFINITY)
        rows_any = (valid & (a != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY)).any(1)
        draws = (
            torchmap._u32(
                torchmap.hash2(
                    pps.to(torch.int32)[:, None],
                    torch.where(valid, up, 0).to(torch.int32),
                )
            )
            >> 16
        )
        rejected = (a < CEPH_OSD_MAX_PRIMARY_AFFINITY) & (draws >= a)
        # accepted slot: first valid & ~rejected; fallback: first valid
        accept = valid & ~rejected
        has_acc = accept.any(1)
        pos = torch.where(has_acc, _first(accept), _first(valid))
        apply = rows_any & (has_acc | valid.any(1))
        new_primary = torch.where(
            apply, up.gather(1, pos[:, None]).squeeze(1), up_primary
        )
        if pool.can_shift_osds():
            # rotate the chosen primary to the front of each applied row
            cols = torch.arange(up.shape[1], device=dev)
            p = pos[:, None]
            src = torch.where((cols >= 1) & (cols <= p), cols - 1, cols)
            rotated = torch.where(
                cols == 0, new_primary[:, None], up.gather(1, src)
            )
            up = torch.where((apply & (pos > 0))[:, None], rotated, up)
        return up, new_primary

    def _temp_stage(self, osdmap, pool, acting, acting_primary):
        """pg_temp / primary_temp sparse overrides, written in place (the
        rows are computed on the host; nothing is read)."""
        pid = pool.pool_id
        rows, temps, prims = [], [], []
        for (p, seed), _ in osdmap.pg_temp.items():
            if p != pid or seed >= pool.pg_num:
                continue
            t, tp = osdmap._get_temp_osds(pool, seed)
            if t:
                row = [_NONE] * acting.shape[1]
                row[: len(t)] = t
                rows.append(seed)
                temps.append(row)
                prims.append(tp)
        dev = acting.device
        if rows:
            at = torch.tensor(rows, device=dev)
            acting[at] = torch.tensor(temps, dtype=torch.int64, device=dev)
            acting_primary[at] = torch.tensor(prims, dtype=torch.int64, device=dev)
        pt = [
            (seed, tp)
            for (p, seed), tp in osdmap.primary_temp.items()
            if p == pid and seed < pool.pg_num
        ]
        if pt:
            at = torch.tensor([s for s, _ in pt], device=dev)
            acting_primary[at] = torch.tensor(
                [tp for _, tp in pt], dtype=torch.int64, device=dev
            )

    # -- queries (OSDMapMapping consumer API) ------------------------------
    def get(self, pool_id: int, ps: int):
        """(up, up_primary, acting, acting_primary) for one PG."""
        up = [int(o) for o in self.up[pool_id][ps]]
        acting = [int(o) for o in self.acting[pool_id][ps]]
        while up and up[-1] == _NONE:
            up.pop()
        while acting and acting[-1] == _NONE:
            acting.pop()
        return (
            up,
            int(self.up_primary[pool_id][ps]),
            acting,
            int(self.acting_primary[pool_id][ps]),
        )


def _compiled(crush_map, device):
    """Per-CrushMap, per-device compiled-table cache, invalidated on
    mutation.

    Keyed on ``(CrushMap.mutation, device)`` (the mutation counter is
    bumped by every builder mutator / ``touch()``) so editing the map
    after a batched mapping pass recompiles the tables instead of
    silently reusing stale topology/weights."""
    gen = getattr(crush_map, "mutation", 0)
    cache = getattr(crush_map, "_torch_compiled", None)
    if cache is None or cache[0] != gen:
        cache = (gen, {})
        crush_map._torch_compiled = cache
    key = str(device)
    if key not in cache[1]:
        cache[1][key] = torchmap.compile_map(crush_map, device=device)
    return cache[1][key]
