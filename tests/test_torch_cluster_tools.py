"""The port's cluster tools held against the JAX package's on the CPU.

- ``ceph_cli._build_command``: every argv of the table below (the
  command shapes the JAX package's CLI tests use, and each branch of
  the translation) gives the JAX CLI's command, or the same refusal.
- ``monstore_tool``: two equal monitor stores, one made by each
  package's ``Monitor`` from the same commits; each package's tool
  prints the same status, dumps and export, and leaves the same store
  after the same rescue (rewind, import, prune).
- ``dencoder``: every type both packages register has the same sample
  bytes, and the port decodes and re-encodes every pinned blob of the
  corpus byte for byte. The bucket-index types wait for rgw.
- ``tools.cluster``: ``start --daemonize`` thread-hosted and with
  ``--processes`` (3 monitors, a manager, 3 OSD processes), on
  ``--device cpu``; ``status``, ``addr`` and ``stop`` from other
  processes; the port's and the JAX package's ``ceph`` CLI, run as
  subprocesses against the port's cluster, print the same output.

Tolerance: exact (commands, bytes, text).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

import ceph_tpu.mon.monitor as jmonitor
import ceph_tpu.tools.ceph_cli as jcli
import ceph_tpu.tools.dencoder as jdencoder
import ceph_tpu.tools.monstore_tool as jmonstore
from ceph_tpu.crush.builder import CrushMap as JCrushMap
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
from ceph_tpu.store import KStore as JKStore
import ceph_tpu_torch.mon.monitor as tmonitor
import ceph_tpu_torch.tools.ceph_cli as tcli
import ceph_tpu_torch.tools.dencoder as tdencoder
import ceph_tpu_torch.tools.monstore_tool as tmonstore
from ceph_tpu_torch.crush.builder import CrushMap
from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.store import KStore

REPO = pathlib.Path(__file__).resolve().parent.parent

ARGVS = [
    ["status"], ["health"], ["df"],
    ["osd", "down", "3"], ["osd", "out", "1"], ["osd", "in", "1"],
    ["osd", "reweight", "2", "0.5"], ["osd", "df"], ["osd", "tree"], ["osd", "dump"],
    ["osd", "pool", "create", "data", "8", "size=2"],
    ["osd", "pool", "create", "ec", "16", "pool-type=3", "erasure-code-profile=p"],
    ["osd", "pool", "delete", "data"], ["osd", "pool", "ls"],
    ["osd", "pool", "set", "data", "size", "2"],
    ["osd", "erasure-code-profile", "set", "p", "k=4", "m=2", "plugin=isa"],
    ["osd", "erasure-code-profile", "get", "p"], ["osd", "erasure-code-profile", "ls"],
    ["osd", "blocklist", "add", "abc123", "60"], ["osd", "blocklist", "ls"],
    ["osd", "tier", "add", "base", "cache"],
    ["osd", "tier", "cache-mode", "base", "cache", "writeback"],
    ["osd", "tier", "add", "base"],
    ["mds", "pin", "/a", "1"], ["mds", "set-max-mds", "2"], ["mds", "fail", "0"],
    ["mds", "stat"],
    ["pg", "dump"], ["pg", "scrub", "1.0"], ["pg", "deep-scrub", "2.3"],
    ["pg", "repair", "1.1"], ["pg", "repair"],
    ["config", "set", "osd", "debug", "5"], ["config", "get", "osd"],
    ["config", "get", "osd", "debug"], ["config", "dump"],
    ["log", "operator", "entry"], ["log", "last", "50", "error"], ["log", "last", "cluster"],
    ["log", "stat"],
    ["health", "mute", "RECENT_CRASH", "--ttl", "300"], ["health", "mute", "X", "30"],
    ["health", "mute", "X", "--ttl", "soon"], ["health", "unmute", "X"], ["health", "mute"],
    ["crash", "ls"], ["crash", "stat"], ["crash", "info", "abc"], ["crash", "info"],
    ["crash", "archive", "all"], ["crash", "archive"], ["crash", "bogus"],
    ["tracing", "dump", "qos_class=client"], ["tracing", "summary"],
    ["slo", "status"], ["slo", "targets"], ["slo", "targets", "set", "client_p99_ms=15@99"],
    ["progress"], ["progress", "json"], ["progress", "clear"],
    ["progress", "event", "id=x", "fraction=0.5", "done=1"],
    ["tell", "osd.0", "perf", "dump"], ["tell", "osd.1", "fault", "set", "dst=*", "delay=0.06"],
    ["tell", "osd.1", "fault", "seed", "7"], ["tell", "osd.1", "fault", "list"],
    ["tell", "osd.2", "dump_historic_slow_ops", "threshold=0", "qos_class=client"],
    ["mgr", "stat"], ["bogus", "command"],
]


def _translate(build, argv):
    try:
        return ("ok", build(list(argv)))
    except SystemExit as e:
        return ("exit", str(e))


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_build_command_equal(argv):
    assert _translate(tcli._build_command, argv) == _translate(jcli._build_command, argv)


# -- monstore_tool --------------------------------------------------------------
def _mkmap(crush_cls, map_cls, n=4):
    m = crush_cls(tunables=Tunables())
    hosts = [m.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h], [0x10000], name=f"h{h}") for h in range(n)]
    m.add_bucket(CRUSH_BUCKET_STRAW2, 3, hosts, [m.buckets[b].weight for b in hosts],
                 name="default")
    m.add_simple_rule("rep", "default", "host", mode="firstn")
    return map_cls.build(m, n)


STORES = {
    "torch": (tmonitor, KStore, CrushMap, OSDMap, tmonstore),
    "jax": (jmonitor, JKStore, JCrushMap, JOSDMap, jmonstore),
}


def _populated_store(pkg: str, path) -> int:
    monitor, kstore, crush_cls, map_cls, _tool = STORES[pkg]
    store = kstore(path)
    mon = monitor.Monitor(_mkmap(crush_cls, map_cls), store=monitor.MonitorStore(store))
    for i in range(3):
        inc = mon.pending()
        inc.mark_up(i, addr=f"127.0.0.1:{6800 + i}")
        inc.mark_in(i)
        mon.commit(inc)
    for cmd in ({"prefix": "osd pool create", "pool": "data", "pg_num": 8},
                {"prefix": "osd out", "id": 3}, {"prefix": "osd pool mksnap", "pool": "data",
                                                 "snap": "s"}):
        reply = mon.handle_command(json.dumps(cmd))
        assert reply.rc == 0, reply.outs
    final = mon.osdmap.epoch
    store.close()
    return final


def _tool_walk(pkg: str, tool_pkg: str, tmp_path, capsys) -> list:
    """Status, dumps and an export, then set-last-committed back one
    epoch, an import of a doctored map and a prune."""
    path = tmp_path / f"{pkg}-{tool_pkg}" / "mon"
    final = _populated_store(pkg, path)
    main = STORES[tool_pkg][4].main
    out = []
    for args in (["status"], ["dump"], ["dump", "--epoch", "2"]):
        main([str(path), *args])
        out.append(capsys.readouterr().out)
    blob_path = path.parent / "map.bin"
    main([str(path), "export", "--out", str(blob_path)])
    capsys.readouterr()
    out.append(blob_path.read_bytes())
    main([str(path), "set-last-committed", str(final - 1)])
    main([str(path), "status"])
    out.append(capsys.readouterr().out)
    m = STORES[tool_pkg][3].decode(blob_path.read_bytes())
    m.epoch = final + 5
    doctored = path.parent / "newer.bin"
    doctored.write_bytes(m.encode())
    main([str(path), "import", "--in", str(doctored)])
    main([str(path), "prune", "--keep", "2"])
    main([str(path), "status"])
    out.append(capsys.readouterr().out)
    return out


@pytest.mark.parametrize("store_pkg", ["torch", "jax"])
def test_monstore_tool_output_equal(tmp_path, capsys, store_pkg):
    """The port's tool on a store made by ``store_pkg``'s monitor, and
    the JAX tool on the JAX monitor's store."""
    mine = _tool_walk(store_pkg, "torch", tmp_path, capsys)
    ref = _tool_walk("jax", "jax", tmp_path, capsys)
    assert mine == ref
    assert json.loads(mine[0])["consistent"]
    assert "data" in json.loads(mine[1])["pools"]


# -- dencoder ----------------------------------------------------------------------
SHARED_TYPES = sorted(set(jdencoder.list_types()) - tdencoder.UNPORTED)


def test_dencoder_registers_every_shared_type():
    assert tdencoder.list_types() == SHARED_TYPES
    assert tdencoder.UNPORTED <= set(jdencoder.list_types())
    assert tdencoder.check() == {}


@pytest.mark.parametrize("name", SHARED_TYPES)
def test_dencoder_sample_and_corpus_bytes_equal(name):
    mine, ref = tdencoder._build_types()[name], jdencoder._build_types()[name]
    sample = mine[0]()
    assert sample == ref[0]()
    blob = (tdencoder.CORPUS_DIR / f"{name}.bin").read_bytes()
    assert mine[1](blob) == blob == ref[1](blob)


# -- the launcher and the CLI as processes ----------------------------------------------
def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    env.pop("XLA_FLAGS", None)
    return env


def _run(module: str, *args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True, text=True, env=_env(),
        timeout=timeout, cwd=str(REPO),
    )


def _cli_outputs(addr: str) -> list:
    """The port's CLI makes the changes; then the port's and the JAX
    CLI print the same for each read."""
    changes = [
        ["osd", "erasure-code-profile", "set", "p", "k=2", "m=1", "plugin=isa"],
        ["osd", "pool", "create", "cli", "4", "size=2"],
        ["config", "set", "osd", "osd_max_scrubs", "2"],
    ]
    for cmd in changes:
        r = _run("ceph_tpu_torch.tools.ceph_cli", "-m", addr, *cmd, timeout=60)
        assert r.returncode == 0, (cmd, r.stderr)
    reads = [
        ["osd", "pool", "ls"], ["osd", "erasure-code-profile", "get", "p"],
        ["config", "get", "osd", "osd_max_scrubs"], ["osd", "tree"], ["bogus", "command"],
    ]
    out = []
    for cmd in reads:
        got = []
        for module in ("ceph_tpu_torch.tools.ceph_cli", "ceph_tpu.tools.ceph_cli"):
            r = _run(module, "-m", addr, *cmd, timeout=60)
            got.append((r.returncode, r.stdout))
        assert got[0] == got[1], cmd
        out.append(got[0])
    return out


@pytest.mark.parametrize("mode", [[], ["--processes", "--mons", "3"]], ids=["threads", "processes"])
def test_launcher_lifecycle_and_cli(tmp_path, mode):
    d = tmp_path / "c"
    r = _run("ceph_tpu_torch.tools.cluster", "start", "--osds", "3", "--memstore",
             "--device", "cpu", *mode, "-D", "-d", str(d))
    assert r.returncode == 0, r.stderr
    conf = json.loads(r.stdout)
    try:
        assert conf["osds"] == 3
        addr = _run("ceph_tpu_torch.tools.cluster", "addr", "-d", str(d))
        assert addr.returncode == 0
        assert addr.stdout.strip() == f"{conf['mon_addr'][0]}:{conf['mon_addr'][1]}"
        deadline = time.monotonic() + 90.0
        while True:
            st = _run("ceph_tpu_torch.tools.cluster", "status", "-d", str(d))
            assert st.returncode == 0, st.stderr
            status = json.loads(st.stdout)
            if status["num_up_osds"] == 3 or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        assert status["num_osds"] == 3 and status["num_up_osds"] == 3
        if mode:
            spec = json.loads((d / "spec.json").read_text())
            assert spec["device"] == "cpu" and spec["mons"] == 3
            ready = json.loads((d / "osd.0.ready").read_text())
            ps = subprocess.run(["ps", "-o", "args=", "-p", str(ready["pid"])],
                                capture_output=True, text=True)
            assert "ceph_tpu_torch.proc.daemon" in ps.stdout
            r = _run("ceph_tpu_torch.tools.ceph_cli", "-m", addr.stdout.strip(), "mgr", "stat")
            assert r.returncode == 0 and json.loads(r.stdout)["active"]
        else:  # the CLIs are compared on the thread-hosted cluster
            outputs = _cli_outputs(addr.stdout.strip())
            assert [rc for rc, _o in outputs][:-1] == [0] * (len(outputs) - 1)
            assert outputs[-1][0] != 0
            assert "cli" in outputs[0][1] and outputs[2][1].strip() == "2"
    finally:
        stop = _run("ceph_tpu_torch.tools.cluster", "stop", "-d", str(d))
    assert stop.returncode == 0, stop.stderr
    assert not (d / "cluster.json").exists()
    if mode:
        assert not (d / "supervisor.json").exists()


def test_launcher_refuses_unported_daemons(tmp_path):
    r = _run("ceph_tpu_torch.tools.cluster", "start", "--mds", "1", "--device", "cpu",
             "-d", str(tmp_path / "c"))
    assert r.returncode == 2
    assert "does not have yet" in r.stderr
