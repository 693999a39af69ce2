"""Per-daemon process entrypoint (the ceph-osd/ceph-mon binary seat,
src/ceph_osd.cc global_init reduced to this framework's daemons)::

    python -m ceph_tpu_torch.proc.daemon --role osd.3 --spec /c1/spec.json

Boots exactly ONE daemon from the cluster spec, on the per-process
shared-event-loop stack (``shared_services=True`` everywhere — a
child process carries the network stack's workers plus the offload
pool and nothing else), publishes a readiness file the supervisor
probes, then parks until SIGTERM.

Exit discipline (what the supervisor discriminates on):

- SIGTERM/SIGINT → clean shutdown, exit 0 (never respawned);
- uncaught boot/runtime exception → traceback on stderr (captured in
  the child log), exit 1 (respawned, crash-reported);
- SIGKILL/SIGSEGV → wait status carries the signal (respawned,
  crash-reported with the signal name);
- SIGUSR1 → every thread's stack into the child log; the daemon runs
  on (a look inside a wedged daemon).

The mgr and OSD roles compute on the spec's ``device`` (default
``cuda``).  A CUDA device that cannot be opened is a boot failure (exit
1, the reason in the child log), never a quiet switch to the CPU.  The
mds and rgw roles compute nothing on a device: they are rados clients,
and the OSDs of their pools encode their bytes.

The readiness file is JSON ``{"role", "pid", "addr"?, "replayed"?, "pgs"?}``
written atomically NEXT TO the spec; a respawned daemon overwrites
it, so its pid always names the live incarnation.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import pathlib
import signal
import sys
import time

from .spec import SPEC_FILENAME, ClusterSpec


def _publish_ready(spec: ClusterSpec, role: str, extra: dict) -> None:
    info = {"role": role, "pid": os.getpid(), **extra}
    path = spec.ready_path(role)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(info))
    tmp.replace(path)
    print(f"ready {role} {json.dumps(info)}", flush=True)


def _boot_mon(spec: ClusterSpec, rank: int):
    from ..mon.monitor import MonitorStore
    from ..mon.quorum import MonMap, QuorumMonitor
    from ..tools.cluster import _build_map

    store = None
    if not spec.data["memstore"]:
        from ..store import BlockStore

        store = MonitorStore(
            BlockStore(spec.dir / f"mon.{rank}", sync=False)
        )
    mon = QuorumMonitor(
        _build_map(spec.data["osds"]),
        MonMap(addrs=dict(enumerate(spec.mon_addrs))),
        rank,
        store=store,
        min_reporters=min(2, spec.data["osds"]),
        shared_services=True,
    )
    mon.start()
    _publish_ready(
        spec, f"mon.{rank}", {"addr": list(mon.addr)}
    )
    return mon


def _open_device(spec: ClusterSpec) -> None:
    """Open the spec's device before the daemon boots, so a card that
    is missing or unusable fails the boot with its reason."""
    import torch

    if spec.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {spec.device!r} asked for, but no usable CUDA card"
        )
    torch.zeros(1, device=spec.device)


def _boot_mgr(spec: ClusterSpec, idx: int):
    from ..mgr import Manager

    _open_device(spec)
    mgr = Manager(
        name=str(idx), shared_services=True, device=spec.device
    )
    mgr.start(spec.mon_addrs)
    _publish_ready(spec, f"mgr.{idx}", {"addr": mgr.addr})
    return mgr


def _boot_osd(spec: ClusterSpec, idx: int):
    from ..osd.daemon import OSD

    _open_device(spec)
    store = None
    if not spec.data["memstore"]:
        from ..store import BlockStore

        store = BlockStore(spec.dir / f"osd.{idx}", sync=False)
    osd = OSD(
        idx,
        store=store,
        wal_dir=(
            str(spec.dir / f"osd.{idx}-wal")
            if spec.data["wal"]
            else None
        ),
        admin_socket_path=str(spec.dir / f"osd.{idx}.asok"),
        shared_services=True,
        device=spec.device,
        **spec.data.get("osd_options", {}),
    )
    osd.boot(mon_addrs=spec.mon_addrs)
    # WAL replay count in the readiness record: the chaos plane
    # asserts a SIGKILLed OSD's respawn actually replayed its log;
    # "pgs" counts the PGs it reloaded from its store
    replayed = getattr(osd.store, "replayed_records", 0)
    _publish_ready(
        spec, f"osd.{idx}", {"replayed": replayed, "pgs": len(osd.pgs)}
    )
    return osd


def _ensure_pools(rados, pools: dict[str, dict]) -> None:
    existing = set(rados.monc.osdmap.pool_names.values())
    for name, kw in pools.items():
        if name not in existing:
            try:
                rados.pool_create(name, **kw)
            except Exception:  # noqa: BLE001 — a sibling gateway
                # racing the same create loses benignly
                pass


def _boot_mds(spec: ClusterSpec, idx: int):
    from ..mds import MDSDaemon
    from ..rados import Rados

    size = spec.data["pool_size"]
    r = Rados(f"mds-{idx}").connect_any(spec.mon_addrs)
    _ensure_pools(
        r,
        {
            "fsmeta": {"pg_num": 4, "size": size},
            "fsdata": {"pg_num": 8, "size": size},
        },
    )
    mds = MDSDaemon(
        f"mds{idx}", r, "fsmeta", shared_services=True
    )
    _publish_ready(spec, f"mds.{idx}", {"addr": mds.addr})
    return _Composite([mds, r])


def _boot_rgw(spec: ClusterSpec, idx: int):
    from ..rados import Rados
    from ..rgw import RGW

    r = Rados(f"rgw-{idx}").connect_any(spec.mon_addrs)
    _ensure_pools(
        r,
        {"rgwpool": {"pg_num": 8, "size": spec.data["pool_size"]}},
    )
    gw = RGW(r.open_ioctx("rgwpool"), name=f"rgw.{idx}")
    port = gw.serve(int(spec.data["rgw_ports"][idx]))
    gw.start_reshard()
    gw.start_mgr_reports(shared_services=True)
    _publish_ready(spec, f"rgw.{idx}", {"port": port})
    return _Composite([gw, r])


class _Composite:
    """Shut several objects down in order (daemon + its client)."""

    def __init__(self, parts):
        self.parts = parts

    def shutdown(self) -> None:
        for p in self.parts:
            try:
                p.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass


_BOOTERS = {
    "mon": _boot_mon,
    "mgr": _boot_mgr,
    "osd": _boot_osd,
    "mds": _boot_mds,
    "rgw": _boot_rgw,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-tpu-daemon")
    p.add_argument(
        "--role", required=True,
        help="daemon to boot, e.g. mon.0 / osd.3 / mgr.0",
    )
    p.add_argument(
        "--spec", default=None,
        help=f"cluster spec path (default <--dir>/{SPEC_FILENAME})",
    )
    p.add_argument("-d", "--dir", default=".")
    args = p.parse_args(argv)

    spec_path = args.spec or (
        pathlib.Path(args.dir) / SPEC_FILENAME
    )
    spec = ClusterSpec.load(spec_path)
    kind, _, idx = args.role.partition(".")
    if kind not in _BOOTERS:
        print(f"unknown role {args.role!r}", file=sys.stderr)
        return 2

    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    daemon = _BOOTERS[kind](spec, int(idx))
    try:
        while not stop["flag"]:
            time.sleep(0.2)
    finally:
        try:
            daemon.shutdown()
        finally:
            try:
                spec.ready_path(args.role).unlink()
            except OSError:
                pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
