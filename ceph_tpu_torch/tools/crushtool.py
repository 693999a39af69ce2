"""crushtool --build/--test on the batched torch mapper
(src/tools/crushtool.cc, src/crush/CrushTester.{h,cc}).

``--build --test`` synthesizes a straw2 hierarchy and maps x ∈ [min-x,
max-x) through a rule, reporting mappings/sec, utilization, chi-squared
uniformity and bad mappings:

    python -m ceph_tpu_torch.tools.crushtool --build 10000:40:25 --test \\
        --max-x 1048576 --num-rep 3               # on the card
    python -m ceph_tpu_torch.tools.crushtool --build 10000:40:25 --test \\
        --max-x 4096 --device cpu

Backends: ``torch`` (the batched mapper, on ``--device``) or ``oracle``
(the exact scalar mapper).  A map outside the batched mapper's scope
(UnsupportedMap) is mapped by the oracle, and the report says
``[oracle]``; a map with legacy bucket algorithms or choose_args exits
non-zero unless ``--backend oracle`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..crush.builder import CrushMap
from ..crush.types import (
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    Tunables,
)

NOT_PORTED = (
    "-c/-d/-i (text and binary crushmaps) and --compare wait for a later "
    "slice of the port (ROADMAP A1b)"
)


def build_hierarchy(
    num_osds: int,
    per_host: int,
    hosts_per_rack: int = 0,
    weight_fn=None,
) -> CrushMap:
    """root -> [racks ->] hosts -> osds, all straw2 (the benchmark
    hierarchy: 10k OSDs via --build's layered buckets)."""
    m = CrushMap(tunables=Tunables())
    weight_fn = weight_fn or (lambda osd: 0x10000)
    hosts = []
    for h in range((num_osds + per_host - 1) // per_host):
        items = list(range(h * per_host, min((h + 1) * per_host, num_osds)))
        if not items:
            break
        weights = [weight_fn(i) for i in items]
        hosts.append(
            m.add_bucket(CRUSH_BUCKET_STRAW2, 1, items, weights,
                         name=f"host{h}")
        )
    level = hosts
    if hosts_per_rack:
        racks = []
        for r in range((len(hosts) + hosts_per_rack - 1) // hosts_per_rack):
            sub = hosts[r * hosts_per_rack : (r + 1) * hosts_per_rack]
            racks.append(
                m.add_bucket(
                    CRUSH_BUCKET_STRAW2,
                    2,
                    sub,
                    [m.buckets[b].weight for b in sub],
                    name=f"rack{r}",
                )
            )
        level = racks
    m.add_bucket(
        CRUSH_BUCKET_STRAW2,
        3,
        level,
        [m.buckets[b].weight for b in level],
        name="default",
    )
    m.add_simple_rule("replicated_rule", "default", "host", mode="firstn")
    m.add_simple_rule("ec_rule", "default", "host", mode="indep")
    return m


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="crushtool", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=f"Not ported: {NOT_PORTED}.",
    )
    p.add_argument("--test", action="store_true")
    p.add_argument("--build", metavar="OSDS:PER_HOST[:HOSTS_PER_RACK]",
                   default="64:4",
                   help="synthesize a straw2 hierarchy")
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1024)
    p.add_argument("--num-rep", type=int, default=3)
    p.add_argument("--rule", type=int, default=0)
    p.add_argument("--backend", default="torch", choices=["torch", "oracle"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the batched mapper (default cuda)")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-statistics", action="store_true")
    p.add_argument("--show-bad-mappings", action="store_true")
    p.add_argument("--weight", type=str, action="append", default=[],
                   metavar="OSD:W", help="reweight osd, e.g. 3:0.5")
    args = p.parse_args(argv)
    if not args.test:
        p.error(f"no action specified (use --test; {NOT_PORTED})")
    return args


def _parse_weights(m: CrushMap, args) -> list[int]:
    weights = [0x10000] * m.max_devices
    for spec in args.weight:
        osd, sep, w = spec.partition(":")
        if not sep:
            raise SystemExit(
                f"crushtool: --weight expects OSD:W, got {spec!r}"
            )
        osd = int(osd)
        if osd >= len(weights):
            # ids past max_devices are tolerated like the reference's
            # weight map (crushtool.cc:822); they can't match anyway
            weights.extend([0x10000] * (osd + 1 - len(weights)))
        weights[osd] = int(float(w) * 0x10000)
    return weights


def _map_range(m: CrushMap, args, weights):
    """Map x ∈ [min-x, max-x) through ``--rule`` on the selected
    backend.  Returns (res, counts, elapsed, backend, fallback) with
    ``elapsed`` from a second pass (the throughput figure) and
    ``fallback`` the lanes the oracle re-mapped."""
    xs = np.arange(args.min_x, args.max_x, dtype=np.int64)
    t0 = time.perf_counter()
    backend = args.backend
    fallback = 0
    if backend == "torch":
        from ..crush import torchmap

        try:
            cm = torchmap.compile_map(m, device=args.device)
        except torchmap.UnsupportedMap as e:
            print(f"# map outside device kernel ({e}); using oracle",
                  file=sys.stderr)
            backend = "oracle"
    if backend == "torch":
        before = torchmap.fallback_lanes
        res, counts = torchmap.batch_do_rule(
            cm, args.rule, xs, args.num_rep, weights
        )
        fallback = torchmap.fallback_lanes - before
        # time a second pass for the throughput figure
        t0 = time.perf_counter()
        torchmap.batch_do_rule(cm, args.rule, xs, args.num_rep, weights)
        elapsed = time.perf_counter() - t0
    else:
        rows = []
        counts = []
        for x in xs:
            r = m.do_rule(args.rule, int(x), args.num_rep, weights)
            counts.append(len(r))
            rows.append(r + [CRUSH_ITEM_NONE] * (args.num_rep - len(r)))
        res = np.asarray(rows, dtype=np.int64).reshape(len(xs), args.num_rep)
        counts = np.asarray(counts)
        elapsed = time.perf_counter() - t0
    return res, counts, elapsed, backend, fallback


def run_test(m: CrushMap, args) -> dict:
    n = args.max_x - args.min_x
    num_osds = m.max_devices
    weights = _parse_weights(m, args)
    res, counts, elapsed, backend, fallback = _map_range(m, args, weights)
    args.backend = backend  # report the backend that actually ran

    valid = (res != CRUSH_ITEM_NONE) & (
        np.arange(args.num_rep)[None, :] < counts[:, None]
    )
    per_osd = np.bincount(
        res[valid].astype(np.int64), minlength=num_osds
    )
    bad = int((counts < args.num_rep).sum())
    total = int(valid.sum())
    expected = total / num_osds if num_osds else 0.0
    chi2 = (
        float((((per_osd - expected) ** 2) / expected).sum())
        if expected
        else 0.0
    )
    return {
        "n": n,
        "elapsed": elapsed,
        "mappings_per_sec": n / elapsed if elapsed else float("inf"),
        "per_osd": per_osd,
        "bad": bad,
        "chi2": chi2,
        "expected": expected,
        "fallback": fallback,
    }


def main(argv=None, crushmap: CrushMap | None = None) -> int:
    """The command line; a caller may pass ``crushmap`` in place of
    ``--build``'s hierarchy."""
    args = parse_args(argv)
    m = crushmap
    if m is None:
        parts = [int(v) for v in args.build.split(":")]
        num_osds, per_host = parts[0], parts[1]
        hpr = parts[2] if len(parts) > 2 else 0
        m = build_hierarchy(num_osds, per_host, hpr)
    try:
        stats = run_test(m, args)
    except NotImplementedError as e:
        print(f"crushtool: {e}; use --backend oracle", file=sys.stderr)
        return 1
    print(
        f"rule {args.rule} x [{args.min_x},{args.max_x}) num_rep "
        f"{args.num_rep}: {stats['n']} mappings in "
        f"{stats['elapsed']:.4f}s = {stats['mappings_per_sec']:.0f} "
        f"mappings/sec [{args.backend}]"
    )
    if args.backend == "torch":
        print(f"oracle fallback lanes: {stats['fallback']}")
    if args.show_bad_mappings or stats["bad"]:
        print(f"bad mappings (short of {args.num_rep}): {stats['bad']}")
    if args.show_utilization:
        for osd, cnt in enumerate(stats["per_osd"]):
            print(f"  device {osd}:\t{cnt}")
    if args.show_statistics:
        print(
            f"chi-squared = {stats['chi2']:.2f} "
            f"(expected per device {stats['expected']:.1f})"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
