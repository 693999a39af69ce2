"""Monitor failover soak: kill a process cluster's leader monitor again
and again, and time each failover.

    python -m ceph_tpu_torch.tools.leader_kills --device cuda --kills 14

Boots what ``tools.cluster start --processes`` boots (3 monitors, a
manager and ``--osds`` OSD processes on ``--device``, each OSD over a
BlockStore), writes ``--objects`` 4 MiB objects into an isa k=8 m=3
pool (a 3-replica pool below 11 OSDs) through librados, then
``--kills`` times: SIGKILL the leader monitor, time a client's
``osd reweight`` until it commits an epoch past the one before the
kill, respawn the monitor and time its catch-up to the quorum's last
committed version, and read objects back byte-equal.

A kill whose commit does not come within ``--wait`` seconds is a miss:
each monitor's own view is printed, every child writes its threads'
stacks into its log (SIGUSR1), the monitors' logs are printed, and the
tool exits 1. The last line is a JSON summary; on ``cuda`` the line
before it is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time

MONS = 3
OBJECT_BYTES = 4 << 20
PG_NUM = 16
CHILD_RESIDENCY = 256 << 20  # the residency cache's default, per child


def mon_status(msgr, addr) -> dict | None:
    """One monitor's own view, over a connection that is closed again."""
    from ..msg import MessageError
    from ..msg.message import MMonCommand

    try:
        conn = msgr.connect(addr[0], int(addr[1]), timeout=5.0)
        try:
            reply = conn.call(MMonCommand(cmd=json.dumps({"prefix": "mon_status"})), timeout=5.0)
        finally:
            conn.close()
    except (MessageError, OSError):
        return None
    return json.loads(reply.outb) if reply.rc == 0 else None


def _leader(sup, msgr, addrs) -> int | None:
    """The leader every running monitor agrees on, all in its quorum."""
    live = [r for r in range(MONS) if sup.status()[f"mon.{r}"]["state"] == "running"]
    st = [mon_status(msgr, addrs[r]) for r in live]
    if any(s is None or s["state"] not in ("leader", "peon") for s in st):
        return None
    leaders = {s["leader"] for s in st}
    if len(leaders) != 1 or not set(live) <= set(st[0]["quorum"]):
        return None
    return leaders.pop()


def _dump_stacks(sup, spec) -> None:
    for s in sup.status().values():
        if s["pid"]:
            try:
                os.kill(s["pid"], signal.SIGUSR1)
            except OSError:
                pass
    time.sleep(2.0)
    for r in range(MONS):
        print(f"--- mon.{r}.log")
        print(spec.log_path(f"mon.{r}").read_text(errors="replace")[-6000:])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="leader_kills", description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--osds", type=int, default=12)
    p.add_argument("--kills", type=int, default=10)
    p.add_argument("--objects", type=int, default=32)
    p.add_argument("--wait", type=float, default=60.0,
                   help="seconds a kill may take to the next commit")
    p.add_argument("-d", "--dir", default="build/leader_kills")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import numpy as np

    from ..msg import Messenger
    from ..msg.messenger import wait_for
    from ..proc import ClusterSpec, Supervisor
    from ..rados import Rados
    from .cluster import prebuild_kernels

    card = ""
    if args.device.startswith("cuda"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.splitlines()[0]
    root = pathlib.Path(args.dir).resolve()
    shutil.rmtree(root, ignore_errors=True)
    spec = ClusterSpec.plan(root, mons=MONS, osds=args.osds, mgrs=1, device=args.device,
                            osd_options={"heartbeat_grace": 20.0, "tick_interval": 0.5})
    prebuild_kernels(args.device)
    sup = Supervisor(spec, extra_env={"CEPH_TPU_RESIDENCY_BYTES": str(CHILD_RESIDENCY)})
    msgr = Messenger("leader-kills")
    rados = None
    addrs = spec.mon_addrs
    commits: list[float] = []
    catch_ups: list[float] = []
    missed = None
    try:
        sup.start(ready_timeout=180.0)
        if not wait_for(lambda: _leader(sup, msgr, addrs) is not None, 60.0, 0.25):
            raise RuntimeError("no quorum formed")
        rados = Rados("leader-kills").connect_any(addrs)
        if args.osds >= 11:
            rc, _b, outs = rados.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "isa",
                "profile": ["plugin=isa", "k=8", "m=3"]})
            if rc != 0:
                raise RuntimeError(outs)
            rados.pool_create("data", pool_type=3, pg_num=PG_NUM, erasure_code_profile="isa")
        else:
            rados.pool_create("data", pg_num=PG_NUM, size=3)
        io = rados.open_ioctx("data")
        rng = np.random.default_rng(args.seed)
        model = {f"obj{i:03d}": rng.bytes(OBJECT_BYTES) for i in range(args.objects)}
        for name, data in model.items():
            io.write_full(name, data)
        names = list(model)
        for k in range(args.kills):
            lead = _leader(sup, msgr, addrs)
            epoch = rados.monc.osdmap.epoch
            sup.kill(f"mon.{lead}", hold=True)
            t0 = time.perf_counter()
            tries = []

            def committed() -> bool:
                try:
                    rc, outb, outs = rados.mon_command(
                        {"prefix": "osd reweight", "id": 0, "weight": 1.0})
                except Exception as e:  # noqa: BLE001 — no quorum yet: retried
                    tries.append((round(time.perf_counter() - t0, 3), str(e)[:80]))
                    return False
                tries.append((round(time.perf_counter() - t0, 3), rc, outs[:80]))
                return rc == 0 and json.loads(outb).get("epoch", 0) > epoch

            if not wait_for(committed, args.wait, 0.25):
                missed = k
                print(f"kill {k}: mon.{lead} SIGKILLed, no commit in {args.wait} s; "
                      f"the client's tries {tries}")
                for r in range(MONS):
                    print(f"mon.{r}: {mon_status(msgr, addrs[r])}")
                _dump_stacks(sup, spec)
                break
            commits.append(time.perf_counter() - t0)
            sup.respawn(f"mon.{lead}")
            t0 = time.perf_counter()

            def caught_up() -> bool:
                st = [mon_status(msgr, a) for a in addrs]
                return (all(s is not None and s["state"] in ("leader", "peon") for s in st)
                        and len({s["last_committed"] for s in st}) == 1)

            if not wait_for(caught_up, args.wait, 0.25):
                missed = k
                print(f"kill {k}: mon.{lead} respawned, no catch-up in {args.wait} s")
                _dump_stacks(sup, spec)
                break
            catch_ups.append(time.perf_counter() - t0)
            name = names[k % len(names)]
            if io.read(name) != model[name]:
                raise RuntimeError(f"{name} read back other bytes")
            print(f"kill {k}: mon.{lead} SIGKILLed, next commit {commits[-1]:.3f} s later; "
                  f"respawned, caught up in {catch_ups[-1]:.3f} s")
    finally:
        if rados is not None:
            rados.shutdown()
        msgr.shutdown()
        sup.stop()
    if card:
        print(card)
    print(json.dumps({
        "device": args.device, "osds": args.osds, "kills": args.kills,
        "committed": len(commits), "missed_at": missed,
        "commit_s": commits, "catch_up_s": catch_ups,
    }))
    return 0 if missed is None else 1


if __name__ == "__main__":
    sys.exit(main())
