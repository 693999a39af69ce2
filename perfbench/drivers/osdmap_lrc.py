"""Epochs of an OSD map that holds one erasure-coded pool on Ceph's LRC
plugin with rack locality: each step applies one incremental and
recomputes every PG's mapping with ``OSDMapMapping.update``, whose
CRUSH stage runs the plugin's two choose steps on the card.

The epochs, the samples and the check are the remap cell's
(``osdmap_remap``'s helpers): a cycle of epochs on a seeded host, 200
random PGs and 100 on the cycle's host kept each step, the reference
mapping them on every epoch of a seeded cycle once the window has
closed.  The epochs are planned in set-up, more than the window
runs; a step's sample is drawn after the step, the PGs on its host
looked up in an index of the base mapping, so the window holds no
burst of planning.  The pool is made as the monitor makes one: the
program's LRC plugin builds its rule on the program's CRUSH map
(``create_rule``).

Before any update a pre-flight maps ``preflight_pgs`` PGs through the
batched mapper on the cell's device; where the mapper refuses the rule
the run exits at once, since the configuration states CRUSH on the
card (the scalar oracle's whole-pool route would take minutes an
epoch).  A traced run installs a program ``Tracer`` with an ``epoch``
span a step, brackets each ``crush_step`` span with device syncs on the
card, and hands those spans and the mapping's counters on."""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import numpy as np

from .. import maps
from ..reference import lrc as reflrc
from ..reference import osdmap as refmap
from . import _program
from . import osdmap_remap as remap

COUNTERS = ("crush_chained_lanes", "crush_host_route_pgs", "crush_oracle_lanes",
            "crush_kernel_draws", "host_syncs")


# epochs planned a second of the window, above what the card maps (about
# 50 steps a second on an H100); past them the plan is extended
PLANNED_PER_S = 200


def _holders(up: np.ndarray):
    """``of(host)``: the rows of ``up`` that hold any OSD of ``host``,
    sorted (the rows of ``np.isin(up, host).any(1)``), looked up in
    one sort of ``up`` made in set-up."""
    flat = up.ravel()
    order = np.argsort(flat, kind="stable")
    keys, rows = flat[order], order // up.shape[1]

    def of(host) -> np.ndarray:
        lo = np.searchsorted(keys, host, "left")
        hi = np.searchsorted(keys, host, "right")
        return np.unique(np.concatenate([rows[a:b] for a, b in zip(lo, hi)]))

    return of


def preflight(crush, ruleno: int, size: int, pgs: int, device: str) -> None:
    """Map ``pgs`` PGs through the batched mapper on ``device``; exit the
    run where it refuses the map."""
    from ceph_tpu_torch.crush import torchmap

    try:
        cm = torchmap.compile_map(crush, device=device)
        torchmap.batch_do_rule_raw(cm, ruleno, np.arange(pgs), size)
    except torchmap.UnsupportedMap as e:
        raise SystemExit(f"perfbench: the batched mapper refuses the LRC rule ({e}); "
                         "this configuration maps CRUSH on the card") from e


@contextlib.contextmanager
def _bracketed_steps(on_card: bool):
    """Traced runs only: each ``crush_step`` span opens after and closes
    before a device sync, so a kernel inside a span's interval is one
    the step launched."""
    from ceph_tpu_torch.crush import torchmap

    inner = torchmap.step_span
    if not on_card:
        yield
        return
    import torch

    @contextlib.contextmanager
    def bracketed(*a, **k):
        torch.cuda.synchronize()
        with inner(*a, **k) as sp:
            yield sp
            torch.cuda.synchronize()

    torchmap.step_span = bracketed
    try:
        yield
    finally:
        torchmap.step_span = inner


def _lrc_pool(om, p: dict):
    """The pool as the monitor creates it: the plugin's rule on the
    program's map, a pool of the plugin's chunk count."""
    from ceph_tpu_torch.crush.types import PG_POOL_TYPE_ERASURE
    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
    from ceph_tpu_torch.osd import PgPool

    profile = dict(p["profile"])
    # only the rule and the chunk count are read: the codec is made on
    # the CPU, as the monitor's check makes it
    ec = registry_instance().factory(profile["plugin"],
                                     ErasureCodeProfile(profile, device="cpu"))
    rule = ec.create_rule(f"lrc_pool{p['pool_id']}", om.crush)
    size = ec.get_chunk_count()
    if size != p["size"]:
        raise SystemExit(f"perfbench: the plugin places {size} chunks, the config says {p['size']}")
    om.add_pool(PgPool(pool_id=p["pool_id"], type=PG_POOL_TYPE_ERASURE, size=size,
                       min_size=p["min_size"], pg_num=p["pg_num"], crush_rule=rule,
                       erasure_code_profile=f"lrc_pool{p['pool_id']}"))
    return rule


def run(cell) -> dict:
    import torch

    from ceph_tpu_torch.common import tracing
    from ceph_tpu_torch.crush.types import PG_POOL_TYPE_ERASURE
    from ceph_tpu_torch.osd import Incremental, OSDMap, OSDMapMapping

    t, cfg = cell.traffic, cell.config
    n = cfg["osds"]
    h = maps.hierarchy(n, cfg["fanout"], cfg["osd_weight"])
    om = OSDMap.build(_program.crush_map(h), n)
    type_ids = {name: t_id for t_id, name in maps.type_names(h).items()}
    root = min(h.buckets)
    pools = []
    for p in cfg["pools"]:
        rule = _lrc_pool(om, p)
        prof = p["profile"]
        steps = reflrc.kml_steps(int(prof["k"]), int(prof["m"]), int(prof["l"]),
                                 prof.get("crush-locality", ""),
                                 prof.get("crush-failure-domain", "host"))
        ref_rule = reflrc.add_rule(h, root, type_ids, steps)
        pools.append(refmap.Pool(p["pool_id"], False, p["size"], p["pg_num"], ref_rule))
        preflight(om.crush, rule, p["size"], t["preflight_pgs"], cell.device)
    assert all(om.pools[p.pool_id].type == PG_POOL_TYPE_ERASURE for p in pools)
    total = sum(p.pg_num for p in pools)
    mapping = OSDMapMapping(device=cell.device)
    stale = cell.fault == "control"  # the control: each answer one epoch late
    tracer = tracing.Tracer("perfbench", max_spans=1 << 20) if cell.trace else None

    def step(epoch: remap.Epoch) -> None:
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
    for e in remap.plan(cell.seed ^ 0x5EED, t["epochs"], hosts, len(t["epochs"])):
        step(e)
    planned = remap.plan(cell.seed, t["epochs"], hosts, int(PLANNED_PER_S * cell.seconds) + 8)
    holders = {p.pool_id: _holders(base_up[p.pool_id]) for p in pools}
    on_host: dict = {}

    def sample(j: int) -> dict:
        c = planned[j].cycle
        if c not in on_host:
            on_host[c] = {pid: of(planned[j].host) for pid, of in holders.items()}
        return {p.pool_id: remap._sample(cell.seed, j, t["check"], p.pg_num, on_host[c][p.pool_id])
                for p in pools}

    if cell.fault:
        remap._install_fault(cell.fault, mapping, [p.pool_id for p in pools],
                             {p.pool_id: p.pg_num for p in pools}, n, cell.seed)
    perf0 = mapping.perf.dump()
    kept, step_s = [], []
    with contextlib.ExitStack() as stack:
        if tracer is not None:
            stack.enter_context(_bracketed_steps(cell.on_card))
        with cell.window():
            t0 = time.perf_counter()
            j = 0
            while True:
                if j == len(planned):  # more steps than planned
                    planned = remap.plan(cell.seed, t["epochs"], hosts, 2 * len(planned))
                a = time.perf_counter()
                if tracer is None:
                    step(planned[j])
                else:
                    with tracer.start_span("epoch", tags={"step": j}):
                        step(planned[j])
                kept.append({pid: (ps, mapping.up[pid][ps].copy(),
                                   mapping.up_primary[pid][ps].copy(),
                                   mapping.acting[pid][ps].copy(),
                                   mapping.acting_primary[pid][ps].copy())
                             for pid, ps in sample(j).items()})
                j += 1
                now = time.perf_counter()
                step_s.append(now - a)
                elapsed = now - t0
                if elapsed >= cell.seconds:
                    break
            if cell.on_card:
                torch.cuda.synchronize()
    perf1 = mapping.perf.dump()
    steps = j
    cell.note_memory()
    counters = {k: perf1[k] - perf0[k] for k in COUNTERS}
    updates = perf1["updates"] - perf0["updates"]
    print(f"steps: {steps}, step s min {min(step_s):.4f} median "
          f"{statistics.median(step_s):.4f} max {max(step_s):.4f}", file=sys.stderr)
    print("per update: " + ", ".join(f"{k} {v / max(updates, 1)}" for k, v in counters.items()),
          file=sys.stderr)

    step_spans = []
    if tracer is not None:
        dump = tracer.dump_traces()
        if dump["spans_dropped"]:
            raise RuntimeError(f"the tracer dropped {dump['spans_dropped']} spans")
        step_spans = [(s["start_ns"], s["end_ns"], s["tags"]["chained"])
                      for s in dump["spans"] if s["name"] == "crush_step"]

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
                got = (remap._trim(up[i]), int(upp[i]), remap._trim(act[i]), int(actp[i]))
                checked += 1
                bad += got != (remap._trim(want[0]), want[1], remap._trim(want[2]), want[3])
    checks = [{"name": "pgs_differing", "value": bad, "limit": 0},
              {"name": "pgs_checked", "value": checked, "limit": 1, "min": True},
              {"name": "host_route_pgs", "value": counters["crush_host_route_pgs"],
               "limit": 0}]
    from .. import stats

    return {
        "e2e": {"mappings_per_s": steps * total / elapsed},
        "attempted": steps, "failed": 0, "checks": checks, "correct": stats.passed(checks),
        "layer": {"pgs_mapped": steps * total, "updates": updates, "counters": counters,
                  "step_spans": step_spans},
    }
