"""``radosgw-admin`` analog — bucket-index / reshard administration
(src/rgw/rgw_admin.cc reduced to the sharded-index plane).

    python -m ceph_tpu_torch.tools.rgw_admin -m HOST:PORT -p POOL \
        bucket stats --bucket B
    ... bucket reshard --bucket B --num-shards N
    ... reshard status --bucket B
    ... reshard list
    ... reshard process

Every command prints one JSON document (the reference tool's
formatter::flush shape).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..rados import Rados
from ..rgw import RGW, RGWError


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="radosgw-admin", description=__doc__.splitlines()[0]
    )
    p.add_argument("-m", "--mon", required=True, metavar="HOST:PORT")
    p.add_argument("-p", "--pool", required=True)
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bucket")
    bsub = b.add_subparsers(dest="sub", required=True)
    bs = bsub.add_parser("stats")
    bs.add_argument("--bucket", required=True)
    br = bsub.add_parser("reshard")
    br.add_argument("--bucket", required=True)
    br.add_argument("--num-shards", type=int, required=True)

    r = sub.add_parser("reshard")
    rsub = r.add_subparsers(dest="sub", required=True)
    rst = rsub.add_parser("status")
    rst.add_argument("--bucket", required=True)
    rsub.add_parser("list")
    rsub.add_parser("process")

    args = p.parse_args(argv)
    host, _, port = args.mon.rpartition(":")
    rados = Rados("rgw-admin").connect(host, int(port))
    try:
        gw = RGW(rados.open_ioctx(args.pool))
        if args.cmd == "bucket" and args.sub == "stats":
            st = gw.reshard_status(args.bucket)
            fills = gw.index.shard_counts(args.bucket)
            st["shard_fill"] = fills
            st["entries"] = sum(fills)
            out = st
        elif args.cmd == "bucket" and args.sub == "reshard":
            out = gw.bucket_reshard(args.bucket, args.num_shards)
        elif args.cmd == "reshard" and args.sub == "status":
            out = gw.reshard_status(args.bucket)
        elif args.cmd == "reshard" and args.sub == "list":
            out = gw.reshard_list()
        else:  # reshard process
            out = {"resharded": gw.reshard_process()}
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    except RGWError as e:
        print(f"radosgw-admin: {e}", file=sys.stderr)
        return 1
    finally:
        rados.shutdown()


if __name__ == "__main__":
    sys.exit(main())
