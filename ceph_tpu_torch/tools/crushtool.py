"""crushtool on the batched torch mapper (src/tools/crushtool.cc:200-231,535,
src/crush/CrushTester.{h,cc}, src/crush/CrushCompiler.cc).

Modes:
- ``-c map.txt -o out``     compile a text crushmap to reference binary
- ``-d map.bin [-o out]``   decompile a reference binary to text
- ``-i map.bin --test``     test a real (reference-format) binary map
- ``--build --test``        test a synthetic straw2 hierarchy
- ``--compare map2.bin``    mapping delta against a second binary map
- ``--tree``                the bucket hierarchy as a tree

--test maps x ∈ [min-x, max-x) through a rule and reports mappings/sec,
utilization, chi-squared uniformity and bad mappings:

    python -m ceph_tpu_torch.tools.crushtool --build 10000:40:25 --test \\
        --max-x 1048576 --num-rep 3               # on the card
    python -m ceph_tpu_torch.tools.crushtool -i map.bin --test \\
        --max-x 4096 --device cpu

Backends: ``torch`` (the batched mapper, on ``--device``) or ``oracle``
(the exact scalar mapper).  A map outside the batched mapper's scope
(UnsupportedMap) is mapped by the oracle, and the report says
``[oracle]``.
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

def build_hierarchy(
    num_osds: int,
    per_host: int,
    hosts_per_rack: int = 0,
    weight_fn=None,
    host_alg: int = CRUSH_BUCKET_STRAW2,
) -> CrushMap:
    """root -> [racks ->] hosts -> osds, straw2 but for the hosts'
    ``host_alg`` (the benchmark hierarchy: 10k OSDs via --build's
    layered buckets)."""
    m = CrushMap(tunables=Tunables())
    weight_fn = weight_fn or (lambda osd: 0x10000)
    hosts = []
    for h in range((num_osds + per_host - 1) // per_host):
        items = list(range(h * per_host, min((h + 1) * per_host, num_osds)))
        if not items:
            break
        weights = [weight_fn(i) for i in items]
        hosts.append(
            m.add_bucket(host_alg, 1, items, weights, name=f"host{h}")
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
    )
    p.add_argument("--test", action="store_true")
    p.add_argument("-c", "--compile", metavar="MAP.TXT",
                   help="compile text crushmap to reference binary")
    p.add_argument("-d", "--decompile", metavar="MAP.BIN",
                   help="decompile reference binary crushmap to text")
    p.add_argument("-i", "--input", metavar="MAP.BIN",
                   help="reference binary crushmap to --test")
    p.add_argument("-o", "--output", metavar="FILE",
                   help="output file for -c/-d")
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
    p.add_argument("--compare", metavar="MAP2.BIN",
                   help="mapping-delta report vs a second binary map "
                        "over the --test x range (crushtool.cc:231)")
    p.add_argument("--tree", action="store_true",
                   help="print the bucket hierarchy as a tree")
    args = p.parse_args(argv)
    if not (args.test or args.compile or args.decompile or args.input
            or args.compare or args.tree):
        p.error("no action specified (use -c, -d, -i, --test, "
                "--compare and/or --tree)")
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


def _map_range(m: CrushMap, args, weights, timed: bool = True):
    """Map x ∈ [min-x, max-x) through ``--rule`` on the selected
    backend.  Returns (res, counts, elapsed, backend, fallback) with
    ``elapsed`` from a second pass (the throughput figure) and
    ``fallback`` the lanes the oracle re-mapped.  ``timed=False`` skips
    that second pass for callers that discard elapsed (--compare maps
    both inputs)."""
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
        before = torchmap.counts["crush_oracle_lanes"]
        res, counts = torchmap.batch_do_rule(
            cm, args.rule, xs, args.num_rep, weights
        )
        fallback = torchmap.counts["crush_oracle_lanes"] - before
        elapsed = time.perf_counter() - t0
        if timed:
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


def run_compare(m1: CrushMap, m2: CrushMap, args) -> dict:
    """Mapping-delta report between two maps (crushtool.cc:231
    --compare, the balancer-validation workflow): map the same x
    range through ``--rule`` on BOTH maps, on the chosen backend and
    device, and count changed mappings — whole-x changes (any position
    differs) and moved slots (data that would migrate).  Output is
    deterministic for a given (maps, range, rule, weights): stable
    field order, fixed float formatting — so workflows can diff it."""
    n = args.max_x - args.min_x
    w1 = _parse_weights(m1, args)
    w2 = _parse_weights(m2, args)
    res1, counts1, _, b1, _ = _map_range(m1, args, w1, timed=False)
    res2, counts2, _, b2, _ = _map_range(m2, args, w2, timed=False)
    args.backend = b1 if b1 == b2 else "mixed"
    row_changed = (res1 != res2).any(axis=1) | (counts1 != counts2)
    valid = (res1 != CRUSH_ITEM_NONE) & (
        np.arange(args.num_rep)[None, :] < counts1[:, None]
    )
    slots = int(valid.sum())
    moved = int((valid & (res1 != res2)).sum())
    changed = int(row_changed.sum())
    return {
        "n": n,
        "changed": changed,
        "changed_ratio": changed / n if n else 0.0,
        "slots": slots,
        "moved": moved,
        "moved_ratio": moved / slots if slots else 0.0,
        "equivalent": changed == 0,
    }


def format_compare(stats: dict, args) -> str:
    lines = [
        (
            f"rule {args.rule} x [{args.min_x},{args.max_x}) num_rep "
            f"{args.num_rep}: {stats['changed']}/{stats['n']} "
            f"mappings changed "
            f"(ratio {stats['changed_ratio']:.6f})"
        ),
        (
            f"moved slots: {stats['moved']}/{stats['slots']} "
            f"(ratio {stats['moved_ratio']:.6f})"
        ),
        (
            "maps appear equivalent"
            if stats["equivalent"]
            else "warning: maps are NOT equivalent"
        ),
    ]
    return "\n".join(lines)


def format_tree(m: CrushMap) -> str:
    """``crushtool --tree``-shaped hierarchy dump: one row per item,
    roots first, children indented under their parent in bucket item
    order.  Deterministic for a given map (stable root ordering,
    fixed-point weights printed at 5 decimals) so the output is
    diffable."""
    lines = ["ID\tWEIGHT\tTYPE NAME"]

    def type_name(t: int) -> str:
        return m.type_names.get(t, f"type{t}")

    def item_name(item: int) -> str:
        if item >= 0:
            return f"osd.{item}"
        return m.item_names.get(item, f"bucket{item}")

    def walk(item: int, weight: int, depth: int) -> None:
        indent = "    " * depth
        if item >= 0:
            lines.append(
                f"{item}\t{weight / 0x10000:.5f}\t"
                f"{indent}{type_name(0)} {item_name(item)}"
            )
            return
        b = m.buckets[item]
        lines.append(
            f"{item}\t{b.weight / 0x10000:.5f}\t"
            f"{indent}{type_name(b.type)} {item_name(item)}"
        )
        for child, w in zip(b.items, b.item_weights):
            walk(child, w, depth + 1)

    for root in sorted(m._roots()):
        walk(root, m.buckets[root].weight, 0)
    return "\n".join(lines)


def main(argv=None, crushmap: CrushMap | None = None) -> int:
    """The command line; a caller may pass ``crushmap`` in place of
    ``--build``'s hierarchy (-c, -d and -i read theirs from files)."""
    args = parse_args(argv)
    from ..crush import compiler

    m = crushmap
    if args.compile:
        with open(args.compile) as f:
            m = compiler.compile_crushmap(f.read())
        blob = compiler.encode_crushmap(m)
        out = args.output or (args.compile + ".compiled")
        with open(out, "wb") as f:
            f.write(blob)
    elif args.decompile:
        with open(args.decompile, "rb") as f:
            m = compiler.decode_crushmap(f.read())
        text = compiler.decompile_crushmap(m)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        # -d composes with --tree/--compare/--test on the decoded map
        # (parse_args advertises "and/or"); plain -d is done here
        if not (args.tree or args.compare or args.test):
            return 0
    elif args.input:
        with open(args.input, "rb") as f:
            m = compiler.decode_crushmap(f.read())
    elif m is None:
        parts = [int(v) for v in args.build.split(":")]
        num_osds, per_host = parts[0], parts[1]
        hpr = parts[2] if len(parts) > 2 else 0
        m = build_hierarchy(num_osds, per_host, hpr)
    if args.tree:
        print(format_tree(m))
    rc = 0
    if args.compare:
        with open(args.compare, "rb") as f:
            m2 = compiler.decode_crushmap(f.read())
        stats = run_compare(m, m2, args)
        print(format_compare(stats, args))
        # non-equivalence is the exit status even when --test also
        # runs below (the flags compose "and/or", parse_args)
        rc = 0 if stats["equivalent"] else 1
    if not args.test:
        return rc
    stats = run_test(m, args)
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
    return rc


if __name__ == "__main__":
    sys.exit(main())
