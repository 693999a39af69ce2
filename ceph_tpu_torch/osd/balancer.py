"""Upmap balancer — OSDMap::calc_pg_upmaps re-designed over the batched
mapper (src/osd/OSDMap.cc:4638-5000, the mgr balancer's upmap mode).

The reference walks every PG through the scalar mapping pipeline and
iteratively generates pg_upmap_items entries that move PGs from
overfull to underfull OSDs (try_pg_upmap/try_remap_rule re-run the
CRUSH rule per candidate).  Here the full PG→OSD table comes from one
batched pass per pool on the card (OSDMapMapping), deviations are
numpy, and candidate remaps are validated against the exact oracle
before being committed — failure-domain separation is enforced by
requiring the replacement OSD's domain ancestor to differ from every
other shard's.
"""

from __future__ import annotations

import numpy as np

from ..crush.types import CRUSH_ITEM_NONE
from .mapping import OSDMapMapping
from .osdmap import OSDMap, PgPool


def _parent_map(crush) -> dict[int, int]:
    """item -> containing bucket id."""
    parents: dict[int, int] = {}
    for b in crush.buckets.values():
        for item in b.items:
            parents[item] = b.id
    return parents


def _domain_of(parents, crush, osd: int, domain_type: int) -> int:
    """Ancestor of ``osd`` at ``domain_type`` (osd itself for type 0)."""
    if domain_type == 0:
        return osd
    node = osd
    while node in parents:
        node = parents[node]
        b = crush.buckets.get(node)
        if b is not None and b.type == domain_type:
            return node
    return osd  # no ancestor of that type: degenerate flat map


def _rule_domain_type(crush, ruleno: int) -> int:
    """The failure-domain type of the rule's choose step (arg2 of the
    first CHOOSE/CHOOSELEAF step)."""
    from ..crush.types import (
        CRUSH_RULE_CHOOSELEAF_FIRSTN,
        CRUSH_RULE_CHOOSELEAF_INDEP,
        CRUSH_RULE_CHOOSE_FIRSTN,
        CRUSH_RULE_CHOOSE_INDEP,
    )

    rule = crush.rules[ruleno]
    for step in rule.steps:
        if step.op in (
            CRUSH_RULE_CHOOSELEAF_FIRSTN,
            CRUSH_RULE_CHOOSELEAF_INDEP,
            CRUSH_RULE_CHOOSE_FIRSTN,
            CRUSH_RULE_CHOOSE_INDEP,
        ):
            return step.arg2
    return 0


def _subtree_osd_weights(crush, root: int) -> dict[int, float]:
    """Leaf crush weights (float) under a bucket — the
    get_rule_weight_osd_map role."""
    out: dict[int, float] = {}

    def walk(item: int, weight_16_16: int):
        if item >= 0:
            out[item] = out.get(item, 0.0) + weight_16_16 / 0x10000
            return
        b = crush.buckets.get(item)
        if b is None:
            return
        for child, w in zip(b.items, b.item_weights):
            walk(child, w)

    walk(root, 0)
    return out


def _rule_root(crush, ruleno: int) -> int:
    from ..crush.types import CRUSH_RULE_TAKE

    for step in crush.rules[ruleno].steps:
        if step.op == CRUSH_RULE_TAKE:
            return step.arg1
    raise ValueError(f"rule {ruleno} has no TAKE step")


def calc_pg_upmaps(
    osdmap: OSDMap,
    max_deviation: int = 1,
    max_changes: int = 10,
    only_pools: set[int] | None = None,
    device=None,
) -> int:
    """Generate pg_upmap_items entries into ``osdmap``; returns the
    number of PG remaps applied (OSDMap::calc_pg_upmaps contract:
    max_deviation floors at 1; stops at ``max_changes`` or when every
    OSD is within max_deviation of its weight-proportional target).
    The PG table is mapped on ``device`` (default ``cuda``)."""
    max_deviation = max(max_deviation, 1)
    pools = {
        pid: pool
        for pid, pool in osdmap.pools.items()
        if not only_pools or pid in only_pools
    }
    if not pools:
        return 0

    mapping = OSDMapMapping(device)
    mapping.update(osdmap)

    # per-OSD PG sets and weight-proportional targets
    pgs_by_osd: dict[int, set] = {}
    osd_weight: dict[int, float] = {}
    total_pgs = 0
    domain_type_by_pool: dict[int, int] = {}
    for pid, pool in pools.items():
        ruleno = osdmap.crush.find_rule(
            pool.crush_rule, pool.type, pool.size
        )
        if ruleno < 0:
            continue
        domain_type_by_pool[pid] = _rule_domain_type(osdmap.crush, ruleno)
        root = _rule_root(osdmap.crush, ruleno)
        for osd, w in _subtree_osd_weights(osdmap.crush, root).items():
            reweight = (
                osdmap.osd_weight[osd] / 0x10000
                if 0 <= osd < osdmap.max_osd
                else 0.0
            )
            if w * reweight > 0:
                osd_weight[osd] = osd_weight.get(osd, 0.0) + w * reweight
        up = mapping.up[pid]
        for ps in range(pool.pg_num):
            for osd in up[ps]:
                if osd != CRUSH_ITEM_NONE:
                    pgs_by_osd.setdefault(int(osd), set()).add((pid, ps))
        total_pgs += pool.size * pool.pg_num
    weight_total = sum(osd_weight.values())
    if weight_total == 0:
        return 0
    for osd in osd_weight:
        pgs_by_osd.setdefault(osd, set())

    parents = _parent_map(osdmap.crush)

    def deviation(osd: int) -> float:
        target = total_pgs * osd_weight.get(osd, 0.0) / weight_total
        return len(pgs_by_osd.get(osd, ())) - target

    num_changed = 0
    for _ in range(max_changes * 4):  # bounded retry budget
        if num_changed >= max_changes:
            break
        plateau = False
        overfull = sorted(
            (o for o in pgs_by_osd if deviation(o) > max_deviation),
            key=deviation,
            reverse=True,
        )
        if not overfull:
            # plateau break (the role of the reference's randomized
            # retries): integer counts cannot hit fractional targets,
            # so an OSD can strand below -max_deviation while every
            # donor sits at dev <= max_deviation.  In plateau mode
            # ONLY stranded, reachable OSDs receive (otherwise moves
            # churn between healthy OSDs forever) and any
            # above-target OSD donates — a donor at dev > 0 lands at
            # dev - 1 > -max_deviation, so it can never itself become
            # stranded (no ping-pong, guaranteed progress).
            stranded = [
                o
                for o in osd_weight
                if deviation(o) < -max_deviation
                and osdmap.is_up(o)
                and 0 <= o < osdmap.max_osd
                and osdmap.osd_weight[o] > 0
            ]
            if stranded:
                plateau = True
                overfull = sorted(
                    (o for o in pgs_by_osd if deviation(o) > 0.0001),
                    key=deviation,
                    reverse=True,
                )
        if not overfull:
            break
        moved = False
        for src in overfull:
            underfull = sorted(
                (
                    o
                    for o in osd_weight
                    if deviation(o)
                    < (-max_deviation if plateau else -0.0001)
                ),
                key=deviation,
            )
            if not underfull:
                break
            for pid, ps in sorted(pgs_by_osd[src]):
                dtype = domain_type_by_pool.get(pid, 0)
                up = [int(o) for o in mapping.up[pid][ps] if o != CRUSH_ITEM_NONE]
                other_domains = {
                    _domain_of(parents, osdmap.crush, o, dtype)
                    for o in up
                    if o != src
                }
                dst = next(
                    (
                        c
                        for c in underfull
                        if osdmap.is_up(c)
                        and osdmap.osd_weight[c] > 0
                        and _domain_of(parents, osdmap.crush, c, dtype)
                        not in other_domains
                    ),
                    None,
                )
                if dst is None:
                    continue
                pg = (pid, ps)
                items = list(osdmap.pg_upmap_items.get(pg, []))
                items.append((src, dst))
                osdmap.pg_upmap_items[pg] = items
                # validate against the exact pipeline; roll back if the
                # remap didn't take effect as intended
                new_up, _, _, _ = osdmap.pg_to_up_acting_osds(pid, ps)
                if src in new_up or dst not in new_up:
                    if len(items) == 1:
                        del osdmap.pg_upmap_items[pg]
                    else:
                        osdmap.pg_upmap_items[pg] = items[:-1]
                    continue
                # commit: adjust the cached table + counts
                row = mapping.up[pid][ps]
                row[row == src] = dst
                pgs_by_osd[src].discard(pg)
                pgs_by_osd.setdefault(dst, set()).add(pg)
                num_changed += 1
                moved = True
                break
            if moved:
                break
        if not moved:
            break
    return num_changed
