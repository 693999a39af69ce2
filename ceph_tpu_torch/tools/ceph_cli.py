"""``ceph`` CLI — the admin command surface (src/ceph.in).

The reference CLI translates argv into JSON command objects described
by MonCommands.h and ships them to the monitor; replies carry a text
``outs`` and a data ``outb``.  This CLI does exactly that over the
framework's MMonCommand path:

    python -m ceph_tpu_torch.tools.ceph_cli -m HOST:PORT status
    ... osd tree | osd dump | osd pool ls | pg dump | health
    ... osd pool create NAME [PG_NUM] [--size N] [--pool-type N]
    ... osd pool delete NAME
    ... osd down/out/in ID | osd reweight ID WEIGHT
    ... osd erasure-code-profile set NAME k=4 m=2 [...]
    ... osd erasure-code-profile get NAME | ls
    ... config set WHO KEY VALUE | config get WHO [KEY] | config dump

``--format json`` prints outb; the default prints outs (or pretty
outb when there is no outs), like the reference's -f handling.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..mon.monitor import MonClient
from ..msg import Messenger


def _coerce(v: str):
    """key=value coercion for tell/fault arguments."""
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _build_tell_args(args: list[str]) -> dict:
    """The inner `ceph tell osd.N <cmd>` grammar: `fault set
    [dst=X] [drop=P] [delay=S] [jitter=S] [dup=P] [reorder=P]` /
    `fault set partition=NAME groups=a,b;c,d` / `fault clear
    [id=N | partition=NAME]` / `fault list` / `fault seed N` /
    `dump_backoffs` / `perf dump`."""
    if not args:
        raise SystemExit("tell: missing daemon command")
    if args[0] == "fault":
        if len(args) < 2:
            raise SystemExit("tell: fault set|clear|list|seed ...")
        cmd: dict = {"prefix": f"fault {args[1]}"}
        if args[1] == "seed" and len(args) > 2:
            cmd["seed"] = int(args[2])
            cmd["prefix"] = "fault seed"
            return cmd
        for kv in args[2:]:
            k, _, v = kv.partition("=")
            if k == "groups":
                # a,b;c,d → [["a","b"],["c","d"]]
                cmd[k] = [
                    [m for m in grp.split(",") if m]
                    for grp in v.split(";")
                ]
            else:
                cmd[k] = _coerce(v)
        return cmd
    # generic daemon commands (`perf histogram dump`,
    # `dump_historic_slow_ops threshold=1 qos_class=gold`, ...):
    # bare words join into the prefix, k=v tokens become arguments
    words = [a for a in args if "=" not in a]
    cmd = {"prefix": " ".join(words)}
    for kv in args:
        if "=" in kv:
            k, _, v = kv.partition("=")
            cmd[k] = _coerce(v)
    return cmd


def _build_command(args: list[str]) -> dict:
    """argv tail → JSON command (the MonCommands.h translation)."""
    joined = " ".join(args)
    # longest-prefix match over the known command table shapes
    if args[0] == "tell" and len(args) >= 3:
        # `ceph tell osd.N ...`: the mon validates the target and
        # names its address; main() dispatches the inner command
        # there as an MCommand
        return {
            "prefix": "tell",
            "target": args[1],
            "args": _build_tell_args(args[2:]),
        }
    if joined.startswith("osd df"):
        return {"prefix": "osd df"}
    if joined.startswith("osd pool create"):
        rest = args[3:]
        cmd = {"prefix": "osd pool create", "pool": rest[0]}
        if len(rest) > 1 and rest[1].isdigit():
            cmd["pg_num"] = int(rest[1])
        for kv in rest[1:]:
            if "=" in kv:
                k, _, v = kv.partition("=")
                cmd[k.replace("-", "_")] = v
        return cmd
    if joined.startswith("osd pool delete"):
        return {"prefix": "osd pool delete", "pool": args[3]}
    if joined.startswith("osd pool ls"):
        return {"prefix": "osd pool ls"}
    if joined.startswith("osd erasure-code-profile set"):
        # monitor-side _cmd_ec_profile_set expects the raw list of
        # "k=v" strings (the MonCommands.h CephString[] shape)
        return {
            "prefix": "osd erasure-code-profile set",
            "name": args[3],
            "profile": list(args[4:]),
        }
    if joined.startswith("osd erasure-code-profile get"):
        return {"prefix": "osd erasure-code-profile get", "name": args[3]}
    if joined.startswith("osd erasure-code-profile ls"):
        return {"prefix": "osd erasure-code-profile ls"}
    if joined.startswith(("osd down", "osd out", "osd in")):
        return {"prefix": f"osd {args[1]}", "id": int(args[2])}
    if joined.startswith("osd reweight"):
        return {
            "prefix": "osd reweight",
            "id": int(args[2]),
            "weight": float(args[3]),
        }
    if joined.startswith("osd blocklist"):
        # osd blocklist add|rm|ls [ADDR] [EXPIRE]
        cmd = {"prefix": "osd blocklist", "blocklistop": args[2]}
        if len(args) > 3:
            cmd["addr"] = args[3]
        if len(args) > 4:
            cmd["expire"] = float(args[4])
        return cmd
    if joined.startswith("osd tier"):
        # osd tier add|remove|cache-mode|set-overlay BASE CACHE
        # osd tier cache-mode BASE CACHE MODE
        # osd tier remove-overlay BASE
        op = args[2]
        cmd = {"prefix": "osd tier", "tierop": op, "pool": args[3]}
        if op in ("add", "remove", "cache-mode", "set-overlay"):
            if len(args) < 5:
                raise SystemExit(
                    f"osd tier {op} needs BASE CACHE"
                )
            cmd["tierpool"] = args[4]
        if op == "cache-mode" and len(args) > 5:
            cmd["mode"] = args[5]
        return cmd
    if joined.startswith("mds pin"):
        return {"prefix": "mds pin", "path": args[2],
                "rank": int(args[3])}
    if joined.startswith("mds set-max-mds"):
        return {"prefix": "mds set-max-mds", "max_mds": int(args[2])}
    if joined.startswith("mds fail"):
        return {"prefix": "mds fail", "who": args[2]}
    if joined.startswith("mds stat"):
        return {"prefix": "mds stat"}
    if joined.startswith("osd pool set"):
        return {"prefix": "osd pool set", "pool": args[3],
                "var": args[4], "val": args[5]}
    if joined.startswith("osd tree"):
        return {"prefix": "osd tree"}
    if joined.startswith("osd dump"):
        return {"prefix": "osd dump"}
    if joined.startswith("pg dump"):
        return {"prefix": "pg dump"}
    if joined.startswith(("pg scrub", "pg deep-scrub", "pg repair")):
        # pg scrub|deep-scrub|repair PGID — the mon validates and
        # names the primary; main() dispatches the order to it
        if len(args) < 3:
            raise SystemExit(f"pg {args[1]} needs a PGID")
        return {"prefix": f"pg {args[1]}", "pgid": args[2]}
    if joined.startswith("config set"):
        return {
            "prefix": "config set",
            "who": args[2],
            "key": args[3],
            "value": " ".join(args[4:]),
        }
    if joined.startswith("config get"):
        cmd = {"prefix": "config get", "who": args[2]}
        if len(args) > 3:
            cmd["key"] = args[3]
        return cmd
    if joined.startswith("config dump"):
        return {"prefix": "config dump"}
    # exact-token match, NOT joined.startswith: `log "last words"`
    # (one quoted arg) must inject an entry, never run the query
    if args[0] == "log" and len(args) > 1 and args[1] == "last":
        # log last [n] [level] [channel]
        from ..common.log_client import CLOG_PRIOS

        cmd = {"prefix": "log last"}
        for a in args[2:]:
            if a.isdigit():
                cmd["num"] = int(a)
            elif a in CLOG_PRIOS:
                cmd["level"] = a
            else:
                cmd["channel"] = a
        return cmd
    if args[0] == "log" and len(args) > 1 and args[1] == "stat":
        return {"prefix": "log stat"}
    if args[0] == "log" and len(args) > 1:
        return {"prefix": "log", "logtext": " ".join(args[1:])}
    if joined.startswith(("health mute", "health unmute")):
        if len(args) < 3:
            raise SystemExit(f"health {args[1]} needs a check CODE")
        if args[1] == "unmute":
            return {"prefix": "health unmute", "code": args[2]}
        # health mute CODE [--ttl SECONDS]
        cmd = {"prefix": "health mute", "code": args[2]}
        rest = args[3:]
        if rest:
            try:
                raw = rest[1] if rest[0] == "--ttl" else rest[0]
                cmd["ttl"] = float(raw)
            except (IndexError, ValueError):
                raise SystemExit(
                    "health mute --ttl needs a number of seconds"
                ) from None
        return cmd
    if args[0] == "crash":
        # mgr-targeted (routed to the active mgr by main()):
        # crash ls | info ID | stat | archive ID|all
        sub = args[1] if len(args) > 1 else "ls"
        if sub in ("ls", "stat"):
            return {"prefix": f"crash {sub}"}
        if sub == "info":
            if len(args) < 3:
                raise SystemExit("crash info needs a crash id")
            return {"prefix": "crash info", "id": args[2]}
        if sub == "archive":
            if len(args) < 3:
                # NEVER default to archive-all: clearing every crash
                # (and RECENT_CRASH) from a missing argument is a
                # destructive surprise — demand it by name
                raise SystemExit(
                    "crash archive needs an id (or the literal 'all')"
                )
            return {"prefix": "crash archive", "id": args[2]}
        raise SystemExit(f"unknown crash subcommand {sub!r}")
    if args[0] == "tracing":
        # mgr-targeted: tracing dump [qos_class=X] | tracing summary
        sub = args[1] if len(args) > 1 else "summary"
        cmd = {"prefix": f"tracing {sub}"}
        for kv in args[2:]:
            if "=" in kv:
                k, _, v = kv.partition("=")
                cmd[k] = v
        return cmd
    if args[0] == "slo":
        # mgr-targeted (routed to the active mgr by main()):
        # slo status | slo targets | slo targets set SPEC...
        if len(args) >= 3 and args[1] == "targets" and args[2] == "set":
            return {
                "prefix": "slo targets set",
                "targets": " ".join(args[3:]),
            }
        sub = args[1] if len(args) > 1 else "status"
        return {"prefix": f"slo {sub}"}
    if args[0] == "progress":
        # mgr-targeted: progress | progress json | progress clear |
        # progress event id=X fraction=F [message=...] [done=1]
        sub = args[1] if len(args) > 1 else ""
        if sub == "event":
            cmd = {"prefix": "progress event"}
            for kv in args[2:]:
                if "=" in kv:
                    k, _, v = kv.partition("=")
                    cmd[k] = _coerce(v)
            return cmd
        return {"prefix": f"progress {sub}".strip()}
    if args[0] == "df":
        return {"prefix": "df"}
    if args[0] in ("status", "health"):
        return {"prefix": args[0]}
    # pass-through: let the monitor reject unknowns (same as the
    # reference's validation living mon-side)
    return {"prefix": joined}


def _mgr_command(msgr, mc, cmd: dict):
    """Send a command to the active mgr (mgr-module surface)."""
    from ..msg.message import MMonCommand, MMonCommandReply

    reply = mc.command({"prefix": "mgr stat"})
    active = json.loads(reply.outb).get("active") if reply.rc == 0 else None
    if not active or not active.get("addr"):
        raise SystemExit("no active mgr (is one running?)")
    host, _, port = active["addr"].rpartition(":")
    conn = msgr.connect(host, int(port))
    out = conn.call(MMonCommand(cmd=json.dumps(cmd)))
    assert isinstance(out, MMonCommandReply)
    return out


def _watch(msgr, mc, level: str, debug: bool) -> int:
    """`ceph -w`: subscribe to the mon's cluster-log stream and
    print entries as they commit, until interrupted.  The mon pushes
    MLog batches on the subscribed connection (the MLog subscription
    shape); ``--watch-debug`` adds the mon's dout-ring firehose as
    channel="debug" lines."""
    import queue
    import time as _time

    from ..msg.message import MLog
    from ..msg.messenger import Dispatcher

    q: queue.Queue = queue.Queue()

    class _WatchSink(Dispatcher):
        def ms_dispatch(self, conn, msg):
            if isinstance(msg, MLog):
                q.put(msg)
                return True
            return False

        def ms_handle_reset(self, conn):
            q.put(None)

    msgr.add_dispatcher(_WatchSink())
    reply = mc.command(
        {"prefix": "log subscribe", "level": level, "debug": debug}
    )
    if reply.rc != 0:
        raise SystemExit(f"log subscribe failed: {reply.outs}")
    st = mc.command({"prefix": "status"})
    if st.rc == 0 and st.outb:
        print(
            json.dumps(json.loads(st.outb), indent=2), flush=True
        )
    try:
        while True:
            msg = q.get()
            if msg is None:
                print("connection to mon lost", file=sys.stderr)
                return 1
            try:
                entries = json.loads(msg.entries)
            except ValueError:
                continue
            for e in entries:
                if not isinstance(e, dict):
                    continue
                stamp = _time.strftime(
                    "%Y-%m-%d %H:%M:%S",
                    _time.localtime(float(e.get("stamp", 0))),
                )
                print(
                    f"{stamp} {e.get('name', '?')} "
                    f"[{e.get('channel', 'cluster')}:"
                    f"{e.get('prio', 'info')}] "
                    f"{e.get('message', '')}",
                    flush=True,
                )
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ceph", description=__doc__, add_help=True
    )
    p.add_argument(
        "-m", "--mon", required=True, metavar="HOST:PORT",
        help="monitor address",
    )
    p.add_argument(
        "-f", "--format", choices=["plain", "json"], default="plain"
    )
    # explicit flags, declared BEFORE the REMAINDER command so
    # argparse claims them (a REMAINDER would swallow `-w`)
    p.add_argument(
        "-w", "--watch", action="store_true",
        help="stream the cluster log live (the `ceph -w` surface)",
    )
    p.add_argument(
        "--watch-debug", action="store_true",
        help="watch, including the mon's dout-ring firehose",
    )
    p.add_argument(
        "--watch-level", default="debug",
        help="minimum clog priority to stream (default: debug)",
    )
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    watching = args.watch or args.watch_debug
    if not args.command and not watching:
        p.error("no command given")
    host, _, port = args.mon.partition(":")

    msgr = Messenger("ceph-cli")
    try:
        mc = MonClient(msgr, whoami=-1)
        mc.connect(host, int(port))
        if watching:
            return _watch(
                msgr, mc, args.watch_level, args.watch_debug
            )
        cmd = _build_command(args.command)
        prefix = cmd["prefix"]
        if prefix == "progress" or prefix.startswith("progress "):
            # mgr-module command (the progress module's surface)
            reply = _mgr_command(msgr, mc, cmd)
        elif prefix == "slo" or prefix.startswith(("slo ", "tracing ", "balancer ")):
            # mgr-module commands, like crash: the owning module
            # (first prefix word) serves them on the active mgr
            reply = _mgr_command(msgr, mc, cmd)
        elif prefix == "crash" or prefix.startswith("crash "):
            # mgr-module command: discover the active mgr through the
            # monitor and send there (the reference CLI routes
            # MgrCommands to the active mgr the same way)
            reply = _mgr_command(msgr, mc, cmd)
        elif prefix in ("pg scrub", "pg deep-scrub", "pg repair"):
            # scrub-plane order: the mon validates the pg and names
            # the primary; the CLI dispatches the order there
            reply = mc.command(cmd)
            if reply.rc == 0 and reply.outb:
                from ..msg.message import MScrubCommand

                target = json.loads(reply.outb)
                host, _, port = target["addr"].rpartition(":")
                conn = msgr.connect(host, int(port))
                reply = conn.call(
                    MScrubCommand(
                        tid=msgr.new_tid(),
                        op=target["op"], pgid=target["pgid"],
                    )
                )
        elif prefix == "tell":
            # mon names the daemon's address; the CLI dispatches the
            # inner command there as an MCommand (`ceph tell` route)
            reply = mc.command(cmd)
            if reply.rc == 0 and reply.outb:
                from ..msg.message import MCommand

                target = json.loads(reply.outb)
                host, _, port = target["addr"].rpartition(":")
                conn = msgr.connect(host, int(port))
                reply = conn.call(
                    MCommand(
                        tid=msgr.new_tid(),
                        cmd=json.dumps(target["args"]),
                    )
                )
        else:
            reply = mc.command(cmd)
    finally:
        msgr.shutdown()

    if args.format == "json":
        print(reply.outb or json.dumps({"status": reply.outs}))
    else:
        if reply.outs:
            print(reply.outs)
        if reply.outb and not reply.outs:
            try:
                print(json.dumps(json.loads(reply.outb), indent=2))
            except (ValueError, TypeError):
                print(reply.outb)
    if reply.rc != 0 and not reply.outs:
        print(f"Error: rc={reply.rc}", file=sys.stderr)
    return 0 if reply.rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
