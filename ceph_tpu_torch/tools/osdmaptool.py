"""osdmaptool --test-map-pgs on the port (src/tools/osdmaptool.cc:41-53,
147-218): bulk-map every PG of a pool, print distribution stats and
timing — the full-map-recompute benchmark (ParallelPGMapper's job, done
as one batched pass per pool on ``--device``):

    python -m ceph_tpu_torch.tools.osdmaptool --test-map-pgs \\
        --build 10000:40:25 --pg-num 1048576        # on the card
    python -m ceph_tpu_torch.tools.osdmaptool --test-map-pgs --device cpu

Backends: ``torch`` (``OSDMapMapping`` on ``--device``) or ``oracle``
(the scalar pipeline's CRUSH, ``use_device=False``).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

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
    return p.parse_args(argv)


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
    t0 = time.perf_counter()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
