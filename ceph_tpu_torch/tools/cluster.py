"""``ceph-tpu-cluster`` — the vstart.sh/cephadm-role launcher
(src/vstart.sh:1, reduced to its working core): stand up a whole
mon+mgr+N-OSD(+MDS+RGW) cluster OUTSIDE pytest, from one command,
with persistent stores under a cluster directory.

    python -m ceph_tpu_torch.tools.cluster start --osds 3 --mds 1 --rgw 1 -d /tmp/c1
    python -m ceph_tpu_torch.tools.cluster status -d /tmp/c1
    python -m ceph_tpu_torch.tools.cluster stop -d /tmp/c1

``--device`` (default ``cuda``) is where the manager and the OSDs
compute; ``cpu`` runs the whole cluster without a card.  The MDS and
RGW daemons (``--mds``, ``--rgw``) compute nothing on a device: the
OSDs encode the bytes of their pools.

``start`` runs the daemons in THIS process (they are thread-hosted,
like vstart's standalone daemons collapsed onto one host) and writes
``<dir>/cluster.json`` — mon address, pools, rgw port — which the
``ceph``/``rados`` CLIs and librados clients consume:

``start --processes`` instead boots the REAL process model: a mon
trio + mgr + OSDs (+MDS/RGW), each daemon its own OS process under
the crash-respawning :class:`~ceph_tpu_torch.proc.Supervisor`, traffic on
real sockets — vstart the way the reference actually runs, and the
only mode whose throughput can exceed one core.  ``--mons`` sizes
the quorum; per-child logs land in ``<dir>/<role>.log``.  On ``cuda``
the launcher builds the kernels before it spawns the fleet, so the OSD
processes load one build instead of each running ``nvcc``.

    python -m ceph_tpu_torch.tools.ceph_cli \
        -m $(python -m ceph_tpu_torch.tools.cluster addr -d /tmp/c1) status

``--daemonize`` forks into the background with a pidfile so ``stop``
(SIGTERM) and ``status`` work from other shells — the vstart
lifecycle.  OSD data lives in <dir>/osd.N (BlockStore), so a stopped
cluster restarts with its objects (``--memstore`` opts out).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import sys
import time


def _build_map(n_osd: int):
    from ..crush.builder import CrushMap
    from ..crush.types import CRUSH_BUCKET_STRAW2, Tunables
    from ..osd.osdmap import OSDMap

    cmap = CrushMap(tunables=Tunables())
    hosts = []
    for h in range(n_osd):
        hosts.append(
            cmap.add_bucket(
                CRUSH_BUCKET_STRAW2, 1, [h], [0x10000],
                name=f"host{h}",
            )
        )
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts,
        [cmap.buckets[b].weight for b in hosts], name="default",
    )
    cmap.add_simple_rule("replicated_rule", "default", "host",
                         mode="firstn")
    return OSDMap.build(cmap, n_osd)


def prebuild_kernels(device: str) -> None:
    """Build the host crc32c and, for a CUDA device, the GF(2^8)
    kernels once, before daemon processes start: each process then
    loads the built library instead of running the compiler."""
    from ..ops import _build

    _build.build("crc32c.c")
    if device.startswith("cuda"):
        _build.build()


class Cluster:
    """One running cluster (every daemon thread-hosted here)."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.dir = pathlib.Path(spec["dir"])
        self.mon = None
        self.mon_msgr = None
        self.osds = []
        self.mgr = None
        self.mds = []
        self.rgw = None
        self._clients = []

    # -- bring-up (the vstart order: mon, mgr, osds, mds, rgw) ---------
    def start(self) -> dict:
        from ..mgr import Manager
        from ..mon.monitor import Monitor
        from ..msg import Messenger
        from ..osd.daemon import OSD
        from ..rados import Rados

        self.dir.mkdir(parents=True, exist_ok=True)
        n = int(self.spec["osds"])
        mon_store = None
        if not self.spec.get("memstore"):
            # persistent mon store: a restarted cluster replays its
            # committed map chain (pools/epochs survive with the OSD
            # data, the vstart dev-cluster restart contract)
            from ..mon.monitor import MonitorStore
            from ..store import BlockStore

            mon_store = MonitorStore(
                BlockStore(self.dir / "mon", sync=False)
            )
        self.mon = Monitor(
            _build_map(n), store=mon_store,
            min_reporters=min(2, n),
        )
        self.mon_msgr = Messenger("mon")
        self.mon_msgr.add_dispatcher(self.mon)
        mon_addr = self.mon_msgr.bind(
            "127.0.0.1", int(self.spec.get("mon_port", 0))
        )

        device = self.spec.get("device", "cuda")
        self.mgr = Manager(name="x", device=device)
        self.mgr.start(mon_addr)

        for i in range(n):
            store = self._store_for(i)
            osd = OSD(
                i, store=store,
                wal_dir=(
                    str(self.dir / f"osd.{i}-wal")
                    if self.spec.get("wal") else None
                ),
                admin_socket_path=str(self.dir / f"osd.{i}.asok"),
                # big clusters ride the shared network stack's
                # strands/timers instead of 3 threads per daemon
                shared_services=bool(
                    self.spec.get("shared_services")
                ) or None,
                device=device,
            )
            osd.boot(*mon_addr)
            self.osds.append(osd)

        conf = {
            "mon_addr": list(mon_addr),
            "osds": n,
            "pools": [],
            "dir": str(self.dir),
            "pid": os.getpid(),
        }

        admin = Rados("cluster-admin").connect(*mon_addr)
        self._clients.append(admin)
        existing = set(admin.monc.osdmap.pool_names.values())

        def pool(name, **kw):
            if name not in existing:
                admin.pool_create(name, **kw)
            conf["pools"].append(name)

        if int(self.spec.get("mds", 0)) > 0:
            from ..mds import MDSDaemon

            size = min(3, max(1, n))
            pool("fsmeta", pg_num=4, size=size)
            pool("fsdata", pg_num=8, size=size)
            for j in range(int(self.spec["mds"])):
                r = Rados(f"mds-{j}").connect(*mon_addr)
                self._clients.append(r)
                self.mds.append(
                    MDSDaemon(f"mds{j}", r, "fsmeta")
                )
            conf["mds"] = int(self.spec["mds"])
        if int(self.spec.get("rgw", 0)) > 0:
            from ..rgw import RGW

            pool("rgwpool", pg_num=8, size=min(3, max(1, n)))
            r = Rados("rgw-0").connect(*mon_addr)
            self._clients.append(r)
            self.rgw = RGW(
                r.open_ioctx("rgwpool"),
                auth=bool(self.spec.get("rgw_auth", False)),
                name="rgw.0",
            )
            conf["rgw_port"] = self.rgw.serve(
                int(self.spec.get("rgw_port", 0))
            )
            # production posture: the dynamic-reshard worker drains
            # the threshold queue, and index/reshard counters flow
            # to the mgr like every other daemon's
            self.rgw.start_reshard()
            self.rgw.start_mgr_reports()
        # atomic publish: the daemonize parent polls for this file
        # and reads it immediately — a partial write would crash it
        tmp = self.dir / "cluster.json.tmp"
        tmp.write_text(json.dumps(conf))
        os.replace(tmp, self.dir / "cluster.json")
        return conf

    def _store_for(self, i: int):
        if self.spec.get("memstore"):
            return None  # the OSD defaults to MemStore
        from ..store import BlockStore

        return BlockStore(self.dir / f"osd.{i}", sync=False)

    def wait_healthy(self, timeout: float = 30.0) -> bool:
        from ..rados import Rados

        deadline = time.monotonic() + timeout
        admin = self._clients[0]
        while time.monotonic() < deadline:
            rc, outb, _ = admin.mon_command({"prefix": "status"})
            if rc == 0:
                st = json.loads(outb)
                if st["num_up_osds"] == st["num_osds"]:
                    return True
            time.sleep(0.3)
        return False

    def stop(self) -> None:
        if self.rgw is not None:
            self.rgw.shutdown()
        if self.mgr is not None:
            try:
                self.mgr.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        for d in self.mds:
            d.shutdown()
        for osd in self.osds:
            osd.shutdown()
        for c in self._clients:
            try:
                c.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if self.mon_msgr is not None:
            self.mon_msgr.shutdown()
        try:
            (self.dir / "cluster.json").unlink()
        except OSError:
            pass


def _load_conf(d: pathlib.Path) -> dict:
    f = d / "cluster.json"
    if not f.exists():
        raise SystemExit(f"no running cluster at {d} (no cluster.json)")
    return json.loads(f.read_text())


def _daemonize(args) -> int | None:
    """Fork into the background with readiness polling.  Returns the
    parent's exit code, or None in the detached child (which carries
    on to boot the cluster)."""
    pid = os.fork()
    if pid:
        # parent: wait for the child to report readiness
        for _ in range(200):
            if (pathlib.Path(args.dir) / "cluster.json").exists():
                conf = _load_conf(pathlib.Path(args.dir))
                print(json.dumps(conf))
                return 0
            time.sleep(0.3)
        print("cluster failed to start", file=sys.stderr)
        return 1
    os.setsid()
    # drop the inherited stdio: a caller capturing our pipes would
    # otherwise wait forever for EOF the daemon never sends; daemon
    # output goes to <dir>/cluster.log
    logdir = pathlib.Path(args.dir)
    logdir.mkdir(parents=True, exist_ok=True)
    log = open(logdir / "cluster.log", "ab", buffering=0)
    devnull = open(os.devnull, "rb")
    os.dup2(devnull.fileno(), 0)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    return None


def _start_processes(args) -> int:
    """``start --processes``: supervised one-daemon-per-OS-process
    fleet (the tentpole runtime) behind the same cluster.json
    contract the thread-hosted mode publishes."""
    from ..proc import ClusterSpec, Supervisor
    from ..rados import Rados

    cdir = pathlib.Path(args.dir)
    # a previous run that died uncleanly may have left daemon
    # process groups squatting the pinned ports
    Supervisor.reap_orphans(cdir)
    spec = ClusterSpec.plan(
        args.dir,
        mons=args.mons,
        osds=args.osds,
        mgrs=1,
        mds=args.mds,
        rgw=args.rgw,
        memstore=args.memstore,
        wal=args.wal,
        mon_port=args.mon_port,
        rgw_port=args.rgw_port,
        device=args.device,
    )
    prebuild_kernels(args.device)
    sup = Supervisor(spec)
    sup.start()
    conf = {
        "mode": "processes",
        "mon_addr": list(spec.mon_addrs[0]),
        "mon_addrs": [list(a) for a in spec.mon_addrs],
        "osds": int(args.osds),
        "pools": [],
        "dir": str(cdir),
        "pid": os.getpid(),
    }
    if args.mds:
        conf["mds"] = int(args.mds)
        conf["pools"] += ["fsmeta", "fsdata"]
    if args.rgw:
        conf["rgw_port"] = int(spec.data["rgw_ports"][0])
        conf["pools"].append("rgwpool")

    admin = Rados("cluster-admin").connect_any(spec.mon_addrs)
    healthy = False
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        rc, outb, _ = admin.mon_command({"prefix": "status"})
        if rc == 0:
            st = json.loads(outb)
            if st["num_up_osds"] == st["num_osds"]:
                healthy = True
                break
        time.sleep(0.3)
    admin.shutdown()

    tmp = cdir / "cluster.json.tmp"
    tmp.write_text(json.dumps(conf))
    os.replace(tmp, cdir / "cluster.json")
    if not args.daemonize:
        print(json.dumps(conf))
        print(
            f"cluster {'healthy' if healthy else 'DEGRADED'} "
            f"({len(spec.roles())} processes); Ctrl-C to stop",
            file=sys.stderr,
        )
    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while not stop["flag"]:
            time.sleep(0.5)
    finally:
        sup.stop()
        try:
            (cdir / "cluster.json").unlink()
        except OSError:
            pass
    return 0


def _cmd_start(args) -> int:
    # nothing before the fork touches CUDA: the daemons open their
    # device in the detached child (thread-hosted) or in their own
    # processes (--processes)
    if args.daemonize:
        rc = _daemonize(args)
        if rc is not None:
            return rc
    if args.processes:
        return _start_processes(args)
    spec = {
        "dir": args.dir,
        "osds": args.osds,
        "mds": args.mds,
        "rgw": args.rgw,
        "memstore": args.memstore,
        "wal": args.wal,
        "mon_port": args.mon_port,
        "rgw_port": args.rgw_port,
        "shared_services": args.shared_services,
        "device": args.device,
    }
    c = Cluster(spec)
    conf = c.start()
    healthy = c.wait_healthy()
    if not args.daemonize:
        print(json.dumps(conf))
        print(
            f"cluster {'healthy' if healthy else 'DEGRADED'}; "
            "Ctrl-C to stop",
            file=sys.stderr,
        )
    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while not stop["flag"]:
            time.sleep(0.5)
    finally:
        c.stop()
    return 0


def _cmd_status(args) -> int:
    from ..mon.monitor import MonClient
    from ..msg import Messenger

    conf = _load_conf(pathlib.Path(args.dir))
    msgr = Messenger("cluster-status")
    try:
        monc = MonClient(msgr, whoami=-1)
        if conf.get("mon_addrs"):
            # multi-mon (--processes): any quorum member answers
            monc.connect_any(
                [tuple(a) for a in conf["mon_addrs"]]
            )
        else:
            monc.connect(*conf["mon_addr"])
        reply = monc.command({"prefix": "status"})
        print(reply.outb if reply.rc == 0 else reply.outs)
        return 0 if reply.rc == 0 else 1
    finally:
        msgr.shutdown()


def _cmd_stop(args) -> int:
    from ..proc import Supervisor

    cdir = pathlib.Path(args.dir)
    conf = _load_conf(cdir)
    pid = conf.get("pid")
    if pid is None:
        return 1
    try:
        # the daemonized launcher is a setsid group leader: signal
        # the whole GROUP, so helpers it forked (and, in --processes
        # mode, the supervisor thread's machinery) die with it — a
        # single os.kill used to strand them
        os.killpg(pid, signal.SIGTERM)
    except ProcessLookupError:
        print("already gone", file=sys.stderr)
    except PermissionError:
        os.kill(pid, signal.SIGTERM)
    for _ in range(150):
        if not (cdir / "cluster.json").exists():
            return 0
        time.sleep(0.2)
    # launcher wedged: reap the recorded daemon process groups
    # directly, then put the launcher group down hard
    reaped = Supervisor.reap_orphans(cdir)
    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        (cdir / "cluster.json").unlink()
    except OSError:
        pass
    print(
        f"cluster did not stop cleanly; force-killed "
        f"(reaped {len(reaped)} daemon groups)",
        file=sys.stderr,
    )
    return 1


def _cmd_addr(args) -> int:
    conf = _load_conf(pathlib.Path(args.dir))
    host, port = conf["mon_addr"]
    print(f"{host}:{port}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-tpu-cluster")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("start")
    sp.add_argument("--osds", type=int, default=3)
    sp.add_argument("--mds", type=int, default=0)
    sp.add_argument("--rgw", type=int, default=0)
    sp.add_argument("--memstore", action="store_true",
                    help="RAM stores (no persistence)")
    sp.add_argument(
        "--wal", action="store_true",
        help="front each OSD store with the write-ahead log "
        "(deferred small writes, group commit, crash replay)",
    )
    sp.add_argument(
        "--shared-services", action="store_true",
        help="OSD tick/report/op-queue on the shared network "
        "stack (zero per-daemon threads; for large --osds)",
    )
    sp.add_argument(
        "--processes", "-P", action="store_true",
        help="one OS process per daemon under the crash-respawning "
        "supervisor (real mon quorum, real sockets, scales past "
        "one core)",
    )
    sp.add_argument(
        "--mons", type=int, default=3,
        help="monitor quorum size (--processes mode only)",
    )
    sp.add_argument(
        "--device", default="cuda",
        help="where the manager and the OSDs compute (cuda or cpu)",
    )
    sp.add_argument("--mon-port", type=int, default=0)
    sp.add_argument("--rgw-port", type=int, default=0)
    sp.add_argument("-d", "--dir", default="./ceph-tpu-cluster")
    sp.add_argument("--daemonize", "-D", action="store_true")
    sp.set_defaults(fn=_cmd_start)
    for name, fn in (
        ("status", _cmd_status), ("stop", _cmd_stop),
        ("addr", _cmd_addr),
    ):
        s = sub.add_parser(name)
        s.add_argument("-d", "--dir", default="./ceph-tpu-cluster")
        s.set_defaults(fn=fn)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
