"""osdmaptool --test-map-pgs on the port (src/tools/osdmaptool.cc:41-53,
147-218): bulk-map every PG of a pool, print distribution stats and
timing — the full-map-recompute benchmark (ParallelPGMapper's job, done
as one batched pass per pool on ``--device``):

    python -m ceph_tpu_torch.tools.osdmaptool --test-map-pgs \\
        --build 10000:40:25 --pg-num 1048576        # on the card
    python -m ceph_tpu_torch.tools.osdmaptool --test-map-pgs --device cpu

Backends: ``torch`` (``OSDMapMapping`` on ``--device``) or ``oracle``
(the scalar pipeline's CRUSH, ``use_device=False``).

``--trace`` runs the timed update under a tracer and prints where its
time went: each span of the mapping path (``crush_stage``,
``crush_step``, ``oracle_fallback``, each ``sync.<site>`` where the
host waited for the device, the download among them, ...) with its
count and host milliseconds, and the update's host waits, oracle lanes,
table compiles, kernel draws, chained lanes, fast replays and host
route PGs.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

from ..common import tracing
from ..crush.types import (
    CRUSH_ITEM_NONE,
    PG_POOL_TYPE_ERASURE,
    PG_POOL_TYPE_REPLICATED,
)
from ..osd import OSDMap, OSDMapMapping, PgPool
from .crushtool import build_hierarchy


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="osdmaptool", description=__doc__)
    p.add_argument("--test-map-pgs", action="store_true", required=True)
    p.add_argument("--build", metavar="OSDS:PER_HOST[:HOSTS_PER_RACK]",
                   default="64:4")
    p.add_argument("--pg-num", type=int, default=1024)
    p.add_argument("--pool-type", default="replicated",
                   choices=["replicated", "erasure"])
    p.add_argument("--size", type=int, default=0,
                   help="pool size (default 3 replicated / 5 erasure)")
    p.add_argument("--backend", default="torch", choices=["torch", "oracle"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the torch backend (default cuda)")
    p.add_argument("--dump", action="store_true",
                   help="print per-osd pg counts")
    p.add_argument("--trace", action="store_true",
                   help="print the timed update's spans and host waits")
    return p.parse_args(argv)


COUNTERS = (("host_syncs", "host waits"), ("crush_oracle_lanes", "oracle lanes"),
            ("crush_compiles", "table compiles"), ("crush_kernel_draws", "kernel draws"),
            ("crush_chained_lanes", "chained lanes"), ("crush_fast_replays", "fast replays"),
            ("crush_host_route_pgs", "host route pgs"))


def format_trace(spans: list, perf0: dict, perf1: dict) -> list:
    """The ``--trace`` lines: each span name's count and summed ms,
    most time first, then the update's counter deltas."""
    total: dict = {}
    for s in spans:
        ms, n = total.get(s["name"], (0.0, 0))
        total[s["name"]] = (ms + (s["end_ns"] - s["start_ns"]) / 1e6, n + 1)
    width = max(map(len, total), default=0)
    lines = ["  trace of the timed update (span, ms, count):"]
    for name, (ms, n) in sorted(total.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"    {name:<{width}} {ms:10.3f} {n:5d}")
    lines.append("  " + ", ".join(f"{label} {perf1[k] - perf0[k]}" for k, label in COUNTERS))
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    parts = [int(v) for v in args.build.split(":")]
    num_osds, per_host = parts[0], parts[1]
    hpr = parts[2] if len(parts) > 2 else 0
    crush = build_hierarchy(num_osds, per_host, hpr)
    om = OSDMap.build(crush, num_osds)
    if args.pool_type == "replicated":
        pool = PgPool(
            pool_id=1, type=PG_POOL_TYPE_REPLICATED,
            size=args.size or 3, pg_num=args.pg_num, crush_rule=0,
        )
    else:
        pool = PgPool(
            pool_id=1, type=PG_POOL_TYPE_ERASURE,
            size=args.size or 5, pg_num=args.pg_num, crush_rule=1,
        )
    om.add_pool(pool)

    mapping = OSDMapMapping(args.device)
    use_device = args.backend == "torch"
    mapping.update(om, use_device=use_device)  # warm-up
    tracer = tracing.Tracer("osdmaptool") if args.trace else None
    perf0 = mapping.perf.dump()
    t0 = time.perf_counter()
    with tracer.start_span("test_map_pgs") if tracer else contextlib.nullcontext():
        mapping.update(om, use_device=use_device)
    elapsed = time.perf_counter() - t0

    up = mapping.up[1]
    valid = up != CRUSH_ITEM_NONE
    per_osd = np.bincount(up[valid].astype(np.int64), minlength=num_osds)
    total = int(valid.sum())
    print(
        f"pool 1 pg_num {pool.pg_num} size {pool.size} "
        f"({args.pool_type}): mapped {total} osd slots over "
        f"{num_osds} osds in {elapsed:.4f}s = "
        f"{pool.pg_num / elapsed:.0f} pg mappings/sec [{args.backend}]"
    )
    print(
        f"  per-osd pgs: min {per_osd.min()} max {per_osd.max()} "
        f"avg {per_osd.mean():.1f} stddev {per_osd.std():.1f}"
    )
    if args.dump:
        for osd, cnt in enumerate(per_osd):
            print(f"  osd.{osd}\t{cnt}")
    if tracer is not None:
        spans = tracer.dump_traces()["spans"]
        print("\n".join(format_trace(spans, perf0, mapping.perf.dump())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
