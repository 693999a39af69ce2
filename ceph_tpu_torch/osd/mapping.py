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
result arrays come back to the host in one download per pool, into
page-locked memory where the pool was mapped on the card.  A pool's
placement seeds are hashed once and kept while its ``pg_num``,
``pgp_num`` and hashing stand: no epoch's up, in or weight change
moves them.  Where a
default device mesh exists (``ops.mesh``: more than one CUDA device)
and the mapping's device belongs to it, the CRUSH stage shards its PG
batch across it (``osd/sharded_mapping.py``), as the JAX package's
does.  A map
outside the batched mapper's scope (``torchmap.UnsupportedMap``) maps
through the scalar oracle, as does ``use_device=False``.

Under an ambient tracer (``common/tracing.py``) an update opens the
span ``osdmap_mapping.update`` and, for each pool, ``crush_stage`` (the
dispatch recorder's ``dev_compute``/``dev_sync`` under it, and
``oracle_fallback`` where lanes outran the fast path); each point
where the host waits for the device, the results' download
(``sync.download``) among them, is a ``sync.<site>`` span
(``torchmap.host_wait``) and counts in ``host_syncs``, traced or not.
Inside the stage each choose step of the rule is a ``crush_step`` span
(``torchmap.step_span``); ``crush_chained_lanes`` counts the sub-lanes
of chained steps, ``crush_fast_replays`` the chunks the fast firstn
path mapped through its recording (a CUDA graph on the card) and
``crush_host_route_pgs`` the PGs the oracle mapped because the batched
mapper refused the map, traced or not.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common import tracing
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
        with torchmap.host_wait("pool_id_upload"):
            pid = torch.tensor(
                pool.pool_id & 0xFFFFFFFF, dtype=torch.int64, device=ps.device
            )
        pid = pid.to(torch.int32)
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


def _download(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array.  From the card it lands in page-locked
    memory: one DMA, where a pageable copy is staged through a driver
    buffer by the CPU (slower, and as slow as the host is busy).
    PyTorch's host allocator takes the block back once the arrays that
    view it are gone."""
    if t.device.type != "cuda":
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


# ``perf dump``'s counters of an update, name -> description; the keys
# of ``torchmap.counts`` among them
_COUNTERS = {
    "updates": "full-map recomputes",
    "pgs_mapped": "PGs mapped across updates",
    "crush_oracle_lanes": "lanes the oracle re-mapped past the fast path",
    "crush_compiles": "CRUSH tables compiled (compile_map) for updates",
    "host_syncs": "points where the host waited for the device",
    "crush_kernel_draws": "launches of the straw2 draw kernel (CUDA maps)",
    "crush_chained_lanes":
        "sub-lanes of chained choose steps (a PG and an item of its working vector)",
    "crush_fast_replays":
        "chunks the fast firstn path mapped through its recording (a CUDA graph)",
    "crush_host_route_pgs":
        "PGs mapped by the scalar oracle because the batched mapper refused the map",
}


def _build_perf():
    from ..common import PerfCountersBuilder

    perf = PerfCountersBuilder("osdmap_mapping").add_time_avg(
        "fixup_stages", "fix-up stage time, download included"
    )
    for name, desc in _COUNTERS.items():
        perf.add_u64_counter(name, desc)
    return perf.create_perf_counters()


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
        # pool id -> (what its seeds depend on, the seeds on the device)
        self._seeds: dict[int, tuple] = {}

    # -- batch pipeline ----------------------------------------------------
    def update(self, osdmap: OSDMap, use_device: bool = True) -> None:
        """Recompute every pool's full PG mapping; ``use_device=False``
        maps through the scalar oracle and fixes up on the CPU."""
        self.epoch = osdmap.epoch
        self.perf.inc("updates")
        before = torchmap.counts.copy()
        pgs = sum(pool.pg_num for pool in osdmap.pools.values())
        tags = {"epoch": osdmap.epoch, "pools": len(osdmap.pools), "pgs": pgs}
        with tracing.span("osdmap_mapping.update", tags=tags):
            for pool in osdmap.pools.values():
                self._update_pool(osdmap, pool, use_device)
                self.perf.inc("pgs_mapped", pool.pg_num)
        self._seeds = {k: v for k, v in self._seeds.items() if k in osdmap.pools}
        for name, n in (torchmap.counts - before).items():
            self.perf.inc(name, n)

    def _update_pool(
        self, osdmap: OSDMap, pool: PgPool, use_device: bool
    ) -> None:
        from ..ops.kernel_stats import kernel_stats

        dev = self.device if use_device else torch.device("cpu")
        n = pool.pg_num
        pps = self._pps(pool, dev)

        ks = kernel_stats()
        pgs_counter = ks.counter(
            "crush", "pgs", desc="PGs mapped through the CRUSH kernel"
        )
        nbytes = n * 8
        with ks.timed("crush", bytes_in=nbytes) as kt:
            raw = self._crush_stage(osdmap, pool, pps, use_device)
            kt.bytes_out = raw.numel() * raw.element_size()
        ks.perf.inc(pgs_counter, n)

        with self.perf.time_it("fixup_stages"):
            fixed = self._fixup(osdmap, pool, pps, raw)
            with torchmap.host_wait("download"):
                out = _download(fixed)
        size = raw.shape[1]
        self.up[pool.pool_id] = out[:, :size]
        self.up_primary[pool.pool_id] = out[:, size]
        self.acting[pool.pool_id] = out[:, size + 1 : 2 * size + 1]
        self.acting_primary[pool.pool_id] = out[:, 2 * size + 1]

    def _pps(self, pool: PgPool, dev: torch.device) -> torch.Tensor:
        """The pool's placement seeds on ``dev`` (``pool_pps_vec`` over
        every PG), hashed again only where what they depend on changed.
        Nothing writes into them."""
        key = (pool.pg_num, pool.pgp_num, pool.hashpspool, str(dev))
        kept = self._seeds.get(pool.pool_id)
        if kept is None or kept[0] != key:
            ps = torch.arange(pool.pg_num, dtype=torch.int64, device=dev)
            kept = self._seeds[pool.pool_id] = (key, pool_pps_vec(pool, ps))
        return kept[1]

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
        with torchmap.host_wait("exists_upload"):
            exists = exists.to(dev)
        with torchmap.host_wait("up_upload"):
            up_ok = up_ok.to(dev)
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
        mapper; the scalar oracle outside its scope.  Spanned as
        ``crush_stage`` (pool, PGs); the tables it compiles count in
        ``crush_compiles``."""
        tables = _tables_cached(osdmap.crush)
        tags = {"pool": pool.pool_id, "pgs": pps.shape[0]}
        with tracing.span("crush_stage", tags=tags):
            raw = self._crush_routes(osdmap, pool, pps, use_device)
        self.perf.inc("crush_compiles", _tables_cached(osdmap.crush) - tables)
        return raw

    def _crush_routes(self, osdmap, pool, pps, use_device):
        from ..ops.profiler import dispatch_profiler

        ruleno = osdmap.crush.find_rule(pool.crush_rule, pool.type, pool.size)
        n = pps.shape[0]
        dev = pps.device
        if ruleno < 0:
            return torch.full((n, pool.size), _NONE, device=dev)
        if use_device:
            from ..ops.mesh import default_mesh
            from ..ops.residency import note_shape

            dmesh = default_mesh()
            mesh = dmesh is not None and dmesh.serves(self.device)
            try:
                cm = None if mesh else _compiled(osdmap.crush, dev)
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
                    if mesh:
                        return self._mesh_rule(
                            dp, osdmap.crush, ruleno, pps, pool.size,
                            osdmap.osd_weight,
                        )
                    return self._device_rule(
                        dp, cm, ruleno, pps, pool.size, osdmap.osd_weight
                    )
            except torchmap.UnsupportedMap:
                self.perf.inc("crush_host_route_pgs", n)

        with dispatch_profiler().dispatch("crush", backend="cpu") as dp:
            dp.set_ops(1)
            dp.set_stripes(n)
            dp.add_bytes_in(n * 8)
            raw = np.full((n, pool.size), _NONE, dtype=np.int64)
            with torchmap.host_wait("oracle_download"):
                xs = pps.cpu().tolist()
            for i, x in enumerate(xs):
                row = osdmap.crush.do_rule(
                    ruleno, x, pool.size, osdmap.osd_weight
                )
                raw[i, : len(row)] = row
            with torchmap.host_wait("oracle_upload"):
                return torch.as_tensor(raw, device=dev)

    @staticmethod
    def _mesh_rule(dp, crush_map, ruleno, pps, size, weights):
        """The CRUSH stage sharded across the default mesh
        (``mesh_batch_do_rule``: the oracle fallback applied on the
        host), back on pps's device, positions past each count NONE.
        The host waits inside the sharded call for its gather."""
        from .sharded_mapping import mesh_batch_do_rule

        with dp.stage("compute"), torchmap.host_wait("mesh_gather"):
            res, counts = mesh_batch_do_rule(crush_map, ruleno, pps, size, weights)
        with dp.stage("sync"):
            with torchmap.host_wait("mesh_upload"):
                res = torch.as_tensor(np.asarray(res, dtype=np.int64), device=pps.device)
            with torchmap.host_wait("mesh_upload"):
                counts = torch.as_tensor(
                    np.asarray(counts, dtype=np.int64), device=pps.device
                )
        cols = torch.arange(size, device=pps.device)
        return torch.where(cols[None, :] < counts[:, None], res, _NONE)

    @staticmethod
    def _device_rule(dp, cm, ruleno, pps, size, weights):
        """torchmap's raw output, the oracle's rows written over the lanes
        that outran the fast path's window (one read of their indices),
        positions past each count NONE."""
        with dp.stage("compute"):
            res, counts, ok = torchmap.batch_do_rule_raw(cm, ruleno, pps, size, weights)
            res, counts = res.to(torch.int64), counts.to(torch.int64)
        with dp.stage("sync"):
            with torchmap.host_wait("ok_read"):
                bad = (~ok).nonzero().squeeze(1)
            lanes = bad.numel()
            if lanes:
                with tracing.span("oracle_fallback", tags={"lanes": lanes}):
                    fres, fcounts = torchmap.apply_oracle_fallback(
                        cm, ruleno, pps[bad], res[bad], counts[bad], ok[bad],
                        size, weights,
                    )
                    with torchmap.host_wait("oracle_upload"):
                        fres = torch.as_tensor(fres, device=pps.device)
                    with torchmap.host_wait("oracle_upload"):
                        fcounts = torch.as_tensor(fcounts, device=pps.device)
                res[bad] = fres.to(torch.int64)
                counts[bad] = fcounts.to(torch.int64)
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
        with torchmap.host_wait("upmap_rows_upload"):
            at = torch.tensor(rows, device=raw.device)
        with torchmap.host_wait("upmap_read"):
            got = raw[at].cpu().numpy()
        fixed = np.full_like(got, _NONE)
        for i, ps in enumerate(rows):
            cur = [int(o) for o in got[i]]
            if pool.can_shift_osds():
                cur = [o for o in cur if o != _NONE]
            new = osdmap._apply_upmap(pool, ps, cur)
            fixed[i, : len(new)] = new
        raw = raw.clone()
        with torchmap.host_wait("upmap_upload"):
            fixed = torch.as_tensor(fixed, device=raw.device)
        raw[at] = fixed
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
        with torchmap.host_wait("affinity_upload"):
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
            with torchmap.host_wait("temp_upload"):
                at = torch.tensor(rows, device=dev)
            with torchmap.host_wait("temp_upload"):
                acting[at] = torch.tensor(temps, dtype=torch.int64, device=dev)
            with torchmap.host_wait("temp_upload"):
                acting_primary[at] = torch.tensor(
                    prims, dtype=torch.int64, device=dev
                )
        pt = [
            (seed, tp)
            for (p, seed), tp in osdmap.primary_temp.items()
            if p == pid and seed < pool.pg_num
        ]
        if pt:
            with torchmap.host_wait("temp_upload"):
                at = torch.tensor([s for s, _ in pt], device=dev)
            with torchmap.host_wait("temp_upload"):
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


def _tables_cached(crush_map) -> int:
    """The number of devices ``_compiled`` holds tables for, for the
    map as it stands (0 after a mutation)."""
    cache = getattr(crush_map, "_torch_compiled", None)
    if cache is None or cache[0] != getattr(crush_map, "mutation", 0):
        return 0
    return len(cache[1])
