"""``rados`` CLI — object-level admin I/O + bench
(src/tools/rados/rados.cc: put/get/rm/ls/stat/omap ops and the
``rados bench`` load generator).

    python -m ceph_tpu_torch.tools.rados_cli -m HOST:PORT -p POOL put OBJ FILE
    ... get OBJ FILE | rm OBJ | ls | stat OBJ
    ... setomapval OBJ KEY VALUE | listomapvals OBJ | rmomapkey OBJ KEY
    ... mksnap NAME | rmsnap NAME | lssnap
    ... list-inconsistent-obj PGID
    ... bench SECONDS write|read [--obj-size N] [--concurrent N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..rados import Rados


def _bench(io, rados, seconds: int, mode: str, obj_size: int, conc: int):
    """rados bench: timed write (then read) of sequential objects;
    prints the reference tool's headline numbers (bandwidth, IOPS,
    average latency)."""
    payload = bytes(range(256)) * (obj_size // 256 + 1)
    payload = payload[:obj_size]
    t_end = time.monotonic() + seconds
    lat: list[float] = []
    done = 0
    inflight = []
    i = 0
    while time.monotonic() < t_end or inflight:
        while (
            len(inflight) < conc and time.monotonic() < t_end
        ):
            oid = f"bench_{i:08d}"
            t0 = time.monotonic()
            fut = (
                io.aio_write_full(oid, payload)
                if mode == "write"
                else io.aio_read(f"bench_{i % max(done, 1):08d}")
            )
            inflight.append((t0, fut))
            i += 1
        t0, fut = inflight.pop(0)
        fut.result()
        lat.append(time.monotonic() - t0)
        done += 1
    total = done * obj_size
    dt = max(sum(lat) / max(conc, 1), 1e-9)
    wall = seconds if seconds else dt
    print(
        json.dumps(
            {
                "mode": mode,
                "ops": done,
                "bytes": total,
                "seconds": wall,
                "bandwidth_MBps": round(total / wall / 2**20, 2),
                "iops": round(done / wall, 1),
                "avg_latency_ms": round(
                    1000 * sum(lat) / max(len(lat), 1), 2
                ),
            }
        )
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rados", description=__doc__)
    p.add_argument("-m", "--mon", required=True, metavar="HOST:PORT")
    p.add_argument("-p", "--pool", required=True)
    p.add_argument("command", nargs=argparse.REMAINDER)
    p.add_argument("--obj-size", type=int, default=1 << 20)
    p.add_argument("--concurrent", type=int, default=4)
    args = p.parse_args(argv)
    if not args.command:
        p.error("no command")
    host, _, port = args.mon.partition(":")
    cmd, rest = args.command[0], args.command[1:]
    r = Rados("rados-cli").connect(host, int(port))
    try:
        io = r.open_ioctx(args.pool)
        if cmd == "put":
            oid, path = rest
            data = (
                sys.stdin.buffer.read()
                if path == "-"
                else open(path, "rb").read()
            )
            io.write_full(oid, data)
        elif cmd == "get":
            oid, path = rest
            data = io.read(oid)
            if path == "-":
                sys.stdout.buffer.write(data)
            else:
                open(path, "wb").write(data)
        elif cmd == "rm":
            io.remove(rest[0])
        elif cmd == "ls":
            for name in io.list_objects():
                print(name)
        elif cmd == "stat":
            print(
                json.dumps({"oid": rest[0], "size": io.stat(rest[0])})
            )
        elif cmd == "setomapval":
            oid, key, value = rest
            io.omap_set(oid, {key: value.encode()})
        elif cmd == "listomapvals":
            for k, v in sorted(io.omap_get_vals(rest[0]).items()):
                print(f"{k}: {v.decode('latin-1')}")
        elif cmd == "rmomapkey":
            io.omap_rm_keys(rest[0], [rest[1]])
        elif cmd == "mksnap":
            print(io.snap_create(rest[0]))
        elif cmd == "rmsnap":
            io.snap_remove(rest[0])
        elif cmd == "lssnap":
            for sid, name in sorted(io.snap_list().items()):
                print(f"{sid}\t{name}")
        elif cmd == "list-inconsistent-obj":
            # the pg's persisted ScrubStore findings, served by its
            # primary (src/tools/rados/rados.cc do_get_inconsistent)
            print(
                json.dumps(
                    {
                        "epoch": r.monc.epoch,
                        "inconsistents": r.list_inconsistent_obj(
                            rest[0]
                        ),
                    },
                    indent=2,
                )
            )
        elif cmd == "bench":
            seconds, mode = int(rest[0]), rest[1]
            _bench(
                io, r, seconds, mode, args.obj_size, args.concurrent
            )
        else:
            print(f"unknown command {cmd!r}", file=sys.stderr)
            return 2
        return 0
    finally:
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main())
