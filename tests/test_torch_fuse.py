"""The port's kernel mount held against the JAX package's, on the CPU.

Each package mounts its own cluster (``tests/test_torch_cluster.py``'s
``Cluster``, the port's OSDs on ``device="cpu"``, plus an ``fsmeta``
pool) through ``/dev/fuse``: an ``MDSDaemon`` of the package in this
process, and ``python -m <package>.fs.fuse_client`` as a process of
its own with its file data in the isa k=3 m=2 pool. The same seeded
sequence of plain POSIX syscalls (mkdir, open, write, read, stat,
listdir, rename, unlink, truncate, and the errors of a missing file
and of a non-empty directory) runs on both mounts and gives equal
results; an ``MDSClient`` of the package beside each mount sees the
kernel's writes and the kernel sees the client's.

Skipped, as ``tests/test_fuse.py`` is, where ``/dev/fuse`` is not
usable or ``fusermount`` is missing (libfuse 2 is loaded by ctypes).
"""

from __future__ import annotations

import os
import pathlib
import random
import shutil
import subprocess
import sys
import time

import pytest

import ceph_tpu.ec.isa as jisa
import ceph_tpu.mds as jmds
import ceph_tpu.msg as jmsg
from ceph_tpu.rados import Rados as JRados
import ceph_tpu_torch.mds as tmds
from ceph_tpu_torch.msg import NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.rados import Rados

from test_torch_cluster import PG_NUM, Cluster, _wait

REPO = pathlib.Path(__file__).resolve().parent.parent

fuse_available = (
    os.path.exists("/dev/fuse")
    and os.access("/dev/fuse", os.R_OK | os.W_OK)
    and shutil.which("fusermount") is not None
)

pytestmark = pytest.mark.skipif(
    not fuse_available, reason="/dev/fuse or fusermount unavailable"
)

PKGS = {"torch": (tmds, Rados, "ceph_tpu_torch"), "jax": (jmds, JRados, "ceph_tpu")}


class _Mount:
    """One package's cluster, MDS, kernel mount and side client."""

    def __init__(self, pkg: str, root: pathlib.Path):
        mds_mod, rados_cls, top = PKGS[pkg]
        self.cluster = Cluster(pkg)
        self.cluster.create_pools()
        self.cluster.pools["fsmeta"] = self.cluster.rados.pool_create(
            "fsmeta", pg_num=PG_NUM, size=3)
        self.radoses = [rados_cls(f"mds-{pkg}").connect(*self.cluster.mon_addr),
                        rados_cls(f"side-{pkg}").connect(*self.cluster.mon_addr)]
        self.mds = mds_mod.MDSDaemon("fa", self.radoses[0], "fsmeta", beacon_interval=0.3,
                                     flush_every=32)
        _wait(lambda: self.mds.state == "active", f"{pkg} mds never became active")
        self.side = mds_mod.MDSClient(self.radoses[1], "ec", name="side")
        self.mnt = root / pkg
        self.mnt.mkdir()
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = str(REPO)
        env.pop("XLA_FLAGS", None)
        host, port = self.cluster.mon_addr
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"{top}.fs.fuse_client", str(self.mnt),
             "--mon", f"{host}:{port}", "--data-pool", "ec"],
            env=env, cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        deadline = time.monotonic() + 60
        while not os.path.ismount(self.mnt):
            assert self.proc.poll() is None, f"{pkg} fuse daemon died"
            assert time.monotonic() < deadline, f"{pkg} mount never appeared"
            time.sleep(0.2)

    def shutdown(self) -> None:
        subprocess.run(["fusermount", "-u", str(self.mnt)], capture_output=True)
        try:
            self.proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.side.close()
        self.mds.shutdown()
        for r in self.radoses:
            r.shutdown()
        self.cluster.shutdown()


@pytest.fixture(scope="module")
def mounts(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(jisa.ErasureCodeIsa, "w", 8, raising=False)
    root = tmp_path_factory.mktemp("fuse")
    made = {}
    try:
        for pkg in ("torch", "jax"):
            made[pkg] = _Mount(pkg, root)
        for m in made.values():
            _wait(m.cluster.clean, f"{m.cluster.pkg} cluster never went active+clean")
        yield made
    finally:
        for m in made.values():
            m.shutdown()
        mp.undo()
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None, 10.0
        )


def _posix(mnt: pathlib.Path, seed: int) -> list:
    """test_fuse's syscall sequence: every result and every error."""
    rng = random.Random(seed)
    out = []

    def rec(label, fn):
        try:
            got = fn()
        except OSError as e:
            got = ("err", type(e).__name__, e.errno)
        out.append((label, got))
        return got

    proj = mnt / "proj"
    rec("mkdir", lambda: os.mkdir(proj))
    rec("write text", lambda: (proj / "notes.txt").write_text("posix works"))
    rec("read text", lambda: (proj / "notes.txt").read_text())
    rec("listdir", lambda: os.listdir(proj))
    blob = rng.randbytes(300_000)
    rec("write big", lambda: (proj / "big.bin").write_bytes(blob))
    rec("size", lambda: os.stat(proj / "big.bin").st_size)
    rec("read big", lambda: (proj / "big.bin").read_bytes() == blob)
    for i in range(4):
        off, piece = rng.randrange(0, 300_000), rng.randbytes(rng.randrange(1, 9000))

        def patch():
            with open(proj / "big.bin", "r+b") as f:
                f.seek(off)
                return f.write(piece)

        rec(f"patch {i}", patch)
    rec("read patched", lambda: (proj / "big.bin").read_bytes())
    rec("rename", lambda: os.rename(proj / "notes.txt", proj / "renamed.txt"))
    rec("listdir renamed", lambda: sorted(os.listdir(proj)))
    rec("remove", lambda: os.remove(proj / "big.bin"))
    rec("listdir removed", lambda: os.listdir(proj))

    def truncate():
        with open(proj / "renamed.txt", "r+") as f:
            f.truncate(5)

    rec("truncate", truncate)
    rec("read truncated", lambda: (proj / "renamed.txt").read_text())
    rec("open missing", lambda: open(proj / "missing"))
    rec("rmdir full", lambda: os.rmdir(proj))
    rec("stat dir", lambda: os.path.isdir(proj))
    return out


def test_posix_surface_equal(mounts):
    mine, ref = _posix(mounts["torch"].mnt, 5), _posix(mounts["jax"].mnt, 5)
    assert [label for label, _g in mine] == [label for label, _g in ref]
    for a, b in zip(mine, ref):
        assert a == b, a[0]
    got = dict(mine)
    assert got["read text"] == "posix works" and got["read big"] is True
    assert got["listdir removed"] == ["renamed.txt"] and got["read truncated"] == "posix"
    assert got["open missing"][1] == "FileNotFoundError" and got["rmdir full"][0] == "err"


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_kernel_mount_coherent_with_client(mounts, pkg):
    m = mounts[pkg]
    fs = m.side
    fs.mkdir("/shared")
    fs.create("/shared/from-lib")
    fs.write("/shared/from-lib", 0, b"library wrote this")
    assert (m.mnt / "shared" / "from-lib").read_bytes() == b"library wrote this"
    (m.mnt / "shared" / "from-kernel").write_bytes(b"kernel wrote this")
    assert fs.read("/shared/from-kernel") == b"kernel wrote this"
    assert sorted(fs.readdir("/shared")) == ["from-kernel", "from-lib"]
    assert fs.stat("/proj/renamed.txt")["size"] == 5
