"""Epochs of an OSD map, one at a time: each step applies one
incremental and recomputes every PG's mapping with
``OSDMapMapping.update`` (CRUSH on the card, then the fix-ups).

The traffic file lists a cycle of epochs, each a list of what happens
to one failure domain (a host): ``down``, ``out``, ``up``, ``in``; an
empty list is an epoch that changes nothing.  Cycle c acts on the c-th
host of a seeded order, and the cycle ends with the map as it began, so
every step does the same work whatever the seed.  The epochs are
planned in set-up; the window builds each one's small incremental,
applies it and maps.

After each step the rows of a sample of PGs are copied aside: random
ones, drawn from the seed, and ones whose mapping before the cycle held
the cycle's host.  Once the window has closed the reference maps those
PGs on every epoch of a seeded choice of whole cycles."""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from .. import maps
from ..reference import osdmap as refmap
from ..reference.crush import ITEM_NONE
from . import _program


class Epoch:
    """One step: the host it acts on, and the state of each OSD of that
    host it leaves (``up``, ``in``)."""

    def __init__(self, cycle: int, host: list, actions: list, state: dict):
        self.cycle, self.host, self.actions = cycle, host, list(actions)
        if "down" in actions:
            state["up"] = False
        if "up" in actions:
            state["up"] = True
        if "out" in actions:
            state["in"] = False
        if "in" in actions:
            state["in"] = True
        self.up, self.in_ = state["up"], state["in"]

    def incremental(self, inc) -> None:
        """Queue this epoch's changes onto a program ``Incremental``."""
        for o in self.host:
            if "down" in self.actions:
                inc.mark_down(o)
            if "up" in self.actions:
                inc.mark_up(o)
            if "out" in self.actions:
                inc.new_weight[o] = 0
            if "in" in self.actions:
                inc.new_weight[o] = 0x10000

    def reference_state(self, h, n: int) -> refmap.MapState:
        st = refmap.MapState.fresh(h, n)
        for o in self.host:
            st.up[o] = self.up
            st.weight[o] = 0x10000 if self.in_ else 0
        return st


def plan(seed: int, epochs: list, hosts: list, steps: int) -> list:
    """The first ``steps`` epochs: cycle c acts on the c-th host of a
    seeded order of the hosts."""
    order = np.random.default_rng([seed, 0x0D]).permutation(len(hosts))
    out, state = [], {}
    for j in range(steps):
        c, e = divmod(j, len(epochs))
        if e == 0:
            state = {"up": True, "in": True}
        out.append(Epoch(c, hosts[int(order[c % len(hosts)])], epochs[e], state))
    return out


def _sample(seed: int, j: int, check: dict, pg_num: int, on_host: np.ndarray) -> np.ndarray:
    """The PGs of step j kept for the check."""
    rng = np.random.default_rng([seed, 0x5A, j])
    rand = rng.choice(pg_num, min(check["random_pgs"], pg_num), replace=False)
    mine = rng.choice(on_host, min(check["domain_pgs"], len(on_host)), replace=False)
    return np.unique(np.concatenate([rand, mine]).astype(np.int64))


def _install_fault(name: str, mapping, pool_ids: list, pg_nums: dict, n: int, seed: int):
    """A fault planted under the timed path (``--fault``; the benchmark's
    own runs plant none).  The control, every answer one epoch stale, is
    planted in ``run``."""
    cls = type(mapping)
    if name == "unchanged":
        mapping.update = lambda *a, **k: None
    elif name == "half_batch":
        def update(osdmap, use_device=True):
            prev = {a: {p: getattr(mapping, a)[p].copy() for p in pool_ids}
                    for a in ("up", "up_primary", "acting", "acting_primary")}
            cls.update(mapping, osdmap, use_device)
            for a, per in prev.items():
                for p, old in per.items():
                    getattr(mapping, a)[p][len(old) // 2:] = old[len(old) // 2:]
        mapping.update = update
    elif name == "altered":
        rows = {p: np.random.default_rng([seed, 0xA1]).choice(
            pg_nums[p], max(1, pg_nums[p] // 100), replace=False) for p in pool_ids}

        def update(osdmap, use_device=True):
            cls.update(mapping, osdmap, use_device)
            for p, r in rows.items():
                col = mapping.acting[p][r, 0]
                mapping.acting[p][r, 0] = np.where(col == ITEM_NONE, col, (col + 1) % n)
        mapping.update = update


def _crush_spans(mapping, spans: list) -> None:
    """Traced runs only: each ``_crush_stage`` call runs between two
    device syncs, its (start, end) ns kept, so the kernels of the CRUSH
    stage can be told from the fix-ups'."""
    import torch

    stage = mapping._crush_stage

    def timed(*a, **k):
        torch.cuda.synchronize()
        lo = time.time_ns()
        out = stage(*a, **k)
        torch.cuda.synchronize()
        spans.append((lo, time.time_ns()))
        return out

    mapping._crush_stage = timed


def run(cell) -> dict:
    import torch

    from ceph_tpu_torch.crush.types import PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED
    from ceph_tpu_torch.osd import Incremental, OSDMap, OSDMapMapping, PgPool

    t, cfg = cell.traffic, cell.config
    n = cfg["osds"]
    h = maps.hierarchy(n, cfg["fanout"], cfg["osd_weight"])
    om = OSDMap.build(_program.crush_map(h), n)
    pools = []
    for p in cfg["pools"]:
        rep = p["type"] == "replicated"
        om.add_pool(PgPool(pool_id=p["pool_id"], size=p["size"], crush_rule=p["rule"],
                           pg_num=p["pg_num"],
                           type=PG_POOL_TYPE_REPLICATED if rep else PG_POOL_TYPE_ERASURE))
        pools.append(refmap.Pool(p["pool_id"], rep, p["size"], p["pg_num"], p["rule"]))
    total = sum(p.pg_num for p in pools)
    mapping = OSDMapMapping(device=cell.device)
    stale = cell.fault == "control"  # the control: each answer one epoch late

    def step(epoch: Epoch) -> None:
        inc = Incremental(epoch=om.epoch + 1)
        epoch.incremental(inc)
        if stale:
            mapping.update(om)
        om.apply_incremental(inc)
        if not stale:
            mapping.update(om)

    # warm-up: the base map, then one whole cycle on a host of its own
    mapping.update(om)
    base_up = {p.pool_id: mapping.up[p.pool_id].copy() for p in pools}
    hosts = maps.hosts(h)
    for e in plan(cell.seed ^ 0x5EED, t["epochs"], hosts, len(t["epochs"])):
        step(e)
    planned = plan(cell.seed, t["epochs"], hosts, int(4 * cell.seconds) + 8)
    on_host: dict = {}

    def sample(j: int) -> dict:
        c = planned[j].cycle
        if c not in on_host:
            host = np.asarray(planned[j].host)
            on_host[c] = {p.pool_id: np.nonzero(np.isin(base_up[p.pool_id], host).any(1))[0]
                          for p in pools}
        return {p.pool_id: _sample(cell.seed, j, t["check"], p.pg_num, on_host[c][p.pool_id])
                for p in pools}

    samples = [sample(j) for j in range(len(planned))]
    if cell.fault:
        _install_fault(cell.fault, mapping, [p.pool_id for p in pools],
                       {p.pool_id: p.pg_num for p in pools}, n, cell.seed)
    spans: list = []
    if cell.trace and cell.on_card:
        _crush_spans(mapping, spans)
    perf0 = mapping.perf.dump()["fixup_stages"]
    kept, step_s = [], []
    with cell.window():
        t0 = time.perf_counter()
        j = 0
        while True:
            if j == len(planned):  # more steps than planned
                planned = plan(cell.seed, t["epochs"], hosts, 2 * len(planned))
                samples += [sample(i) for i in range(len(samples), len(planned))]
            a = time.perf_counter()
            step(planned[j])
            kept.append({pid: (ps, mapping.up[pid][ps].copy(), mapping.up_primary[pid][ps].copy(),
                               mapping.acting[pid][ps].copy(),
                               mapping.acting_primary[pid][ps].copy())
                         for pid, ps in samples[j].items()})
            j += 1
            now = time.perf_counter()
            step_s.append(now - a)
            elapsed = now - t0
            if elapsed >= cell.seconds:
                break
        if cell.on_card:
            torch.cuda.synchronize()
    perf1 = mapping.perf.dump()["fixup_stages"]
    steps = j
    cell.note_memory()
    print(f"steps: {steps}, step s min {min(step_s):.4f} median "
          f"{statistics.median(step_s):.4f} max {max(step_s):.4f}", file=sys.stderr)

    # every epoch of whole cycles drawn from the seed
    per = len(t["epochs"])
    whole = max(1, steps // per)
    rng = np.random.default_rng([cell.seed, 0xC5])
    cycles = rng.choice(whole, min(t["check"]["cycles"], whole), replace=False)
    chosen = [s for c in sorted(cycles) for s in range(c * per, min((c + 1) * per, steps))]
    bad = checked = 0
    by_id = {p.pool_id: p for p in pools}
    for s in chosen:
        st = planned[s].reference_state(h, n)
        for pid, (pss, up, upp, act, actp) in kept[s].items():
            for i, ps in enumerate(pss):
                want = refmap.pg_to_up_acting(st, by_id[pid], int(ps))
                got = (_trim(up[i]), int(upp[i]), _trim(act[i]), int(actp[i]))
                checked += 1
                bad += got != (_trim(want[0]), want[1], _trim(want[2]), want[3])
    checks = [{"name": "pgs_differing", "value": bad, "limit": 0},
              {"name": "pgs_checked", "value": checked, "limit": 1, "min": True}]
    from .. import stats

    return {
        "e2e": {"mappings_per_s": steps * total / elapsed},
        "attempted": steps, "failed": 0, "checks": checks, "correct": stats.passed(checks),
        "layer": {"pgs_mapped": steps * total, "pool_updates": steps * len(pools),
                  "crush_spans": spans,
                  "fixup": {"sum": perf1["sum"] - perf0["sum"],
                            "count": perf1["avgcount"] - perf0["avgcount"]}},
    }


def _trim(row) -> list:
    out = [int(o) for o in row]
    while out and out[-1] == ITEM_NONE:
        out.pop()
    return out
