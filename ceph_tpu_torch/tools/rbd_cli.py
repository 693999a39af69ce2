"""``rbd`` CLI — block-image admin (src/tools/rbd/rbd.cc reduced to
the daily-driver verbs over the librbd analog):

    python -m ceph_tpu_torch.tools.rbd_cli -m HOST:PORT -p POOL create NAME --size BYTES \\
        [--object-size N] [--stripe-unit N] [--stripe-count N] \\
        [--features exclusive-lock,object-map,journaling]
    ... ls | info NAME | rm NAME | resize NAME --size BYTES
    ... export NAME FILE | import FILE NAME [--size BYTES]
    ... snap create NAME@SNAP | snap ls NAME | snap rm NAME@SNAP
    ... clone PARENT@SNAP CHILD | flatten NAME
    ... diff NAME [--from-snap SNAP]   (object-map fast-diff)
    ... du NAME                        (object-map, no scan)
    ... lock status NAME
    ... mirror NAME --target-mon HOST:PORT --target-pool POOL [--once]
"""

from __future__ import annotations

import argparse
import json
import sys

from ..rados import Rados
from ..rbd import RBD, Image, RBDError


def _create(rbd, io, name: str, size: int, args) -> None:
    rbd.create(
        io, name, size,
        stripe_unit=args.stripe_unit or args.object_size,
        stripe_count=args.stripe_count,
        object_size=args.object_size,
        features=args.features,
    )


def _info(io, name: str) -> dict:
    img = Image(io, name)
    try:
        st = img.stat()
        st["name"] = name
        st["features"] = sorted(img.features)
        if img.parent is not None:
            st["parent"] = (
                f"{img.parent['name']}@{img.parent['snap']}"
            )
        st["snaps"] = img.snap_list()
        return st
    finally:
        img.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rbd", description=__doc__)
    p.add_argument("-m", "--mon", required=True, metavar="HOST:PORT")
    p.add_argument("-p", "--pool", required=True)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--object-size", type=int, default=1 << 22)
    p.add_argument("--stripe-unit", type=int, default=None)
    p.add_argument("--stripe-count", type=int, default=1)
    p.add_argument("--features", default="")
    p.add_argument("--from-snap", default=None)
    p.add_argument("--target-mon", default=None)
    p.add_argument("--target-pool", default=None)
    p.add_argument("--once", action="store_true")
    p.add_argument("command", nargs="+")
    args = p.parse_args(argv)
    host, _, port = args.mon.partition(":")
    cmd, rest = args.command[0], args.command[1:]
    r = Rados("rbd-cli").connect(host, int(port))
    try:
        io = r.open_ioctx(args.pool)
        rbd = RBD()
        if cmd == "create":
            if args.size is None:
                p.error("create needs --size")
            _create(rbd, io, rest[0], args.size, args)
        elif cmd == "ls":
            for name in rbd.list(io):
                print(name)
        elif cmd == "info":
            print(json.dumps(_info(io, rest[0]), indent=2))
        elif cmd == "rm":
            rbd.remove(io, rest[0])
        elif cmd == "resize":
            if args.size is None:
                p.error("resize needs --size")
            img = Image(io, rest[0])
            try:
                img.resize(args.size)
            finally:
                img.close()
        elif cmd == "export":
            img = Image(io, rest[0])
            try:
                out = (
                    sys.stdout.buffer
                    if rest[1] == "-"
                    else open(rest[1], "wb")
                )
                step = 4 << 20
                for off in range(0, img.size(), step):
                    out.write(
                        img.read(off, min(step, img.size() - off))
                    )
                if rest[1] != "-":
                    out.close()
            finally:
                img.close()
        elif cmd == "import":
            import os as _os

            if rest[0] == "-":
                fh, size = sys.stdin.buffer, args.size
                if size is None:
                    p.error("import from stdin needs --size")
            else:
                fh = open(rest[0], "rb")
                size = args.size or _os.fstat(fh.fileno()).st_size
            _create(rbd, io, rest[1], size, args)
            img = Image(io, rest[1])
            try:
                # stream in 4MB steps — a multi-GB image must not
                # materialize in RAM (export already streams)
                off = 0
                while off < size:
                    chunk = fh.read(min(4 << 20, size - off))
                    if not chunk:
                        break
                    img.write(off, chunk)
                    off += len(chunk)
            finally:
                img.close()
                if rest[0] != "-":
                    fh.close()
        elif cmd == "snap":
            sub = rest[0]
            if sub == "ls":
                img = Image(io, rest[1])
                try:
                    for s in img.snap_list():
                        print(s)
                finally:
                    img.close()
            else:
                name, _, snap = rest[1].partition("@")
                if not snap:
                    p.error("need NAME@SNAP")
                img = Image(io, name)
                try:
                    if sub == "create":
                        img.snap_create(snap)
                    elif sub == "rm":
                        img.snap_remove(snap)
                    else:
                        p.error(f"unknown snap op {sub!r}")
                finally:
                    img.close()
        elif cmd == "clone":
            parent, _, snap = rest[0].partition("@")
            if not snap:
                p.error("need PARENT@SNAP")
            rbd.clone(io, parent, snap, rest[1])
        elif cmd == "flatten":
            img = Image(io, rest[0])
            try:
                img.flatten()
            finally:
                img.close()
        elif cmd == "diff":
            img = Image(io, rest[0])
            try:
                objs = img.diff_objects(args.from_snap)
                osz = img.layout.object_size
                for o in objs:
                    print(f"{o * osz}\t{osz}\tobject {o}")
            finally:
                img.close()
        elif cmd == "du":
            img = Image(io, rest[0])
            try:
                used = img.used_objects() * img.layout.object_size
                print(
                    f"{rest[0]}\tprovisioned {img.size()}\t"
                    f"used <= {used}"
                )
            finally:
                img.close()
        elif cmd == "lock" and rest[0] == "status":
            img = Image(io, rest[1])
            try:
                try:
                    print(img.lock_holder() or "unlocked")
                except RBDError as e:
                    print(e)
            finally:
                img.close()
        elif cmd == "mirror":
            if not (args.target_mon and args.target_pool):
                p.error("mirror needs --target-mon and --target-pool")
            from ..rbd.mirror import MirrorDaemon

            th, _, tp = args.target_mon.partition(":")
            tr = Rados("rbd-mirror-cli").connect(th, int(tp))
            try:
                dst = tr.open_ioctx(args.target_pool)
                d = MirrorDaemon(
                    io, dst, interval=0.0 if args.once else 0.5
                )
                try:
                    if args.once:
                        d.replay_once()
                    else:
                        print(
                            "mirroring; Ctrl-C to stop",
                            file=sys.stderr,
                        )
                        import time

                        while True:
                            time.sleep(1)
                except KeyboardInterrupt:
                    pass
                finally:
                    d.stop()
            finally:
                tr.shutdown()
        else:
            p.error(f"unknown command {cmd!r}")
        return 0
    except RBDError as e:
        print(f"rbd: {e}", file=sys.stderr)
        return 1
    finally:
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main())
