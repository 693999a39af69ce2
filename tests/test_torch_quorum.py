"""The port's monitor quorum held against the JAX package's on the CPU.

The ``tests/test_paxos.py`` scenarios run on both packages: three
``QuorumMonitor``s over real messengers elect a leader, and one command
sequence, sent through a ``MonClient`` (commands reaching a peon are
forwarded to the leader), commits the same ``Incremental`` bytes and
the same full-map bytes version by version on every monitor of either
package. Leader loss (a new quorum keeps committing, the dead monitor
rejoins on its store and catches up), a peon that missed commits, and a
value a majority accepted but whose leader died before COMMIT
(recovered by the new leader's collect) each end with equal chains. A
mixed quorum, one port monitor and two JAX monitors, commits the same
values: the wire has been the JAX package's since the messenger port.

Tolerance: exact (committed bytes).
"""

from __future__ import annotations

import json
import queue
import socket

import pytest

import ceph_tpu.mon.monitor as jmonitor
import ceph_tpu.mon.quorum as jquorum
import ceph_tpu.msg as jmsg
from ceph_tpu.crush.builder import CrushMap as JCrushMap
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
from ceph_tpu.osd.osdmap import PgPool as JPgPool
import ceph_tpu_torch.mon.monitor as tmonitor
import ceph_tpu_torch.mon.quorum as tquorum
from ceph_tpu_torch.crush.builder import CrushMap
from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables
from ceph_tpu_torch.msg import Messenger, NetworkStack
from ceph_tpu_torch.msg.message import MMonCommand
from ceph_tpu_torch.msg.messenger import wait_for
from ceph_tpu_torch.osd.osdmap import OSDMap, PgPool

from conftest import strict_timing

DEADLINE = 20.0 if strict_timing() else 60.0
N_OSD = 6

PKGS = {
    "torch": (tquorum, tmonitor, Messenger, CrushMap, OSDMap, PgPool),
    "jax": (jquorum, jmonitor, jmsg.Messenger, JCrushMap, JOSDMap, JPgPool),
}

COMMANDS = [
    {"prefix": "osd erasure-code-profile set", "name": "ecp",
     "profile": ["plugin=isa", "k=3", "m=2"]},
    {"prefix": "osd pool create", "pool": "rbd", "pg_num": 8, "size": 3},
    {"prefix": "osd pool create", "pool": "ecpool", "pool_type": 3, "pg_num": 8,
     "erasure_code_profile": "ecp"},
    {"prefix": "osd down", "id": 2},
    {"prefix": "osd out", "id": 2},
    {"prefix": "osd in", "id": 2},
    {"prefix": "osd reweight", "id": 4, "weight": 0.5},
    {"prefix": "osd pg-upmap-items", "pgid": "1.3", "mappings": [[0, 5]]},
    {"prefix": "osd pool mksnap", "pool": "rbd", "snap": "s1"},
    {"prefix": "osd pool set", "pool": "ecpool", "var": "pg_num", "val": "16"},
]


@pytest.fixture(autouse=True)
def no_live_reactor():
    before = (NetworkStack.live(), jmsg.NetworkStack.live())
    yield
    if before == (None, None):
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None, 10.0
        )


def _base_map(pkg: str):
    _q, _m, _msgr, crush_cls, map_cls, pool_cls = PKGS[pkg]
    cmap = crush_cls(tunables=Tunables())
    hosts = [
        cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h], [0x10000], name=f"host{h}")
        for h in range(N_OSD)
    ]
    cmap.add_bucket(
        CRUSH_BUCKET_STRAW2, 3, hosts, [cmap.buckets[b].weight for b in hosts], name="default"
    )
    cmap.add_simple_rule("rep", "default", "host", mode="firstn")
    om = map_cls.build(cmap, N_OSD)
    om.add_pool(pool_cls(pool_id=1, size=3, pg_num=8, crush_rule=0))
    return om


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class Quorum:
    """Monitors of the packages ``pkgs`` (one a rank) over real
    messengers, each on a ``MonitorStore`` of its own package."""

    def __init__(self, pkgs: list[str]):
        self.pkgs = pkgs
        self.addrs = dict(enumerate(("127.0.0.1", p) for p in _free_ports(len(pkgs))))
        self.mons: dict = {}
        self.stores: dict = {}
        self.clients: list = []
        for r in range(len(pkgs)):
            self.start(r)

    def start(self, rank: int):
        quorum, monitor, _msgr, *_ = PKGS[self.pkgs[rank]]
        store = self.stores.get(rank) or monitor.MonitorStore()
        self.stores[rank] = store
        mon = quorum.QuorumMonitor(
            _base_map(self.pkgs[rank]), quorum.MonMap(addrs=dict(self.addrs)), rank,
            store=store, min_reporters=2, election_timeout=0.5, lease_interval=0.25,
        )
        mon.start()
        self.mons[rank] = mon
        return mon

    def kill(self, rank: int) -> None:
        self.mons.pop(rank).shutdown()

    def settled(self):
        leaders = [m for m in self.mons.values() if m.state == "leader"]
        if len(leaders) != 1:
            return None
        lead = leaders[0]
        others = set(self.mons) - {lead.rank}
        if lead.quorum >= set(self.mons) and all(
            self.mons[r].state == "peon" and self.mons[r].leader == lead.rank for r in others
        ):
            return lead
        return None

    def wait_quorum(self):
        assert wait_for(lambda: self.settled() is not None, DEADLINE), {
            r: (m.state, m.leader) for r, m in self.mons.items()
        }
        return self.settled()

    def client(self, pkg: str):
        _q, monitor, msgr_cls, *_ = PKGS[pkg]
        msgr = msgr_cls(f"quorum-client-{len(self.clients)}")
        monc = monitor.MonClient(msgr, whoami=-1)
        monc.connect_any(list(self.addrs.values()))
        self.clients.append(msgr)
        return monc

    def run(self, monc, commands) -> list:
        out = []
        for cmd in commands:
            r = monc.command(cmd, timeout=DEADLINE)
            out.append((r.rc, r.outs))
        return out

    def chains_converge(self) -> int:
        """Wait until every live monitor holds the same last committed
        version; returns it."""
        def same():
            lcs = {m.store.last_committed() for m in self.mons.values()}
            return len(lcs) == 1

        assert wait_for(same, DEADLINE), {
            r: m.store.last_committed() for r, m in self.mons.items()
        }
        return next(iter(self.mons.values())).store.last_committed()

    def chain(self, rank: int, last: int) -> list:
        store = self.mons[rank].store
        return [(store.get_inc(v), store.get_full(v)) for v in range(1, last + 1)]

    def shutdown(self) -> None:
        for msgr in self.clients:
            msgr.shutdown()
        for r in list(self.mons):
            self.kill(r)


def _with_quorum(pkgs, scenario):
    q = Quorum(pkgs)
    try:
        return scenario(q)
    finally:
        q.shutdown()


def _commands(q: Quorum) -> tuple:
    q.wait_quorum()
    replies = q.run(q.client(q.pkgs[0]), COMMANDS)
    last = q.chains_converge()
    chains = [q.chain(r, last) for r in sorted(q.mons)]
    assert all(c == chains[0] for c in chains)
    return replies, chains[0]


def _leader_loss(q: Quorum) -> tuple:
    """Half the commands, the leader killed, the rest on the new
    quorum; the dead monitor rejoins on its store and catches up."""
    leader = q.wait_quorum()
    monc = q.client(q.pkgs[0])
    replies = q.run(monc, COMMANDS[:5])
    dead = leader.rank
    q.kill(dead)
    assert q.wait_quorum().rank != dead
    replies += q.run(monc, COMMANDS[5:])
    q.start(dead)
    q.wait_quorum()
    last = q.chains_converge()
    assert last >= 1 + len(COMMANDS) - 1
    chains = [q.chain(r, last) for r in sorted(q.mons)]
    assert all(c == chains[0] for c in chains)
    return replies, chains[0]


def _peon_catch_up(q: Quorum) -> tuple:
    """A peon is down while commands commit and rejoins behind."""
    leader = q.wait_quorum()
    peon = next(r for r in q.mons if r != leader.rank)
    monc = q.client(q.pkgs[leader.rank])
    replies = q.run(monc, COMMANDS[:3])
    behind = q.mons[peon].store.last_committed()
    q.kill(peon)
    q.wait_quorum()
    replies += q.run(monc, COMMANDS[3:])
    q.start(peon)
    q.wait_quorum()
    last = q.chains_converge()
    assert last > behind
    chains = [q.chain(r, last) for r in sorted(q.mons)]
    assert all(c == chains[0] for c in chains)
    return replies, chains[0]


def _uncommitted_recovery(q: Quorum) -> tuple:
    """The leader commits one value but its COMMIT fan-out is lost, and
    it dies: the peons hold the value only as accepted. The new
    leader's collect commits it at the same version with the same
    bytes."""
    leader = q.wait_quorum()
    monc = q.client(q.pkgs[leader.rank])
    replies = q.run(monc, COMMANDS[:4])
    q.chains_converge()
    leader._send_to = lambda rank, msg: True
    replies += q.run(monc, COMMANDS[4:5])
    version = leader.store.last_committed()
    value = leader.store.get_inc(version)
    assert all(
        m.store.last_committed() == version - 1 for r, m in q.mons.items() if r != leader.rank
    )
    q.kill(leader.rank)
    q.wait_quorum()
    # the collect's round runs after the victory
    assert wait_for(
        lambda: all(m.store.last_committed() == version for m in q.mons.values()), DEADLINE
    )
    last = q.chains_converge()
    chains = [q.chain(r, last) for r in sorted(q.mons)]
    assert all(c == chains[0] for c in chains)
    assert chains[0][version - 1][0] == value
    return replies, chains[0]


@pytest.mark.parametrize(
    "scenario",
    [_commands, _leader_loss, _peon_catch_up, _uncommitted_recovery],
    ids=["commands", "leader_loss", "peon_catch_up", "uncommitted_recovery"],
)
def test_paxos_commits_equal_bytes(scenario):
    mine = _with_quorum(["torch"] * 3, scenario)
    ref = _with_quorum(["jax"] * 3, scenario)
    assert mine[0] == ref[0]
    assert [rc for rc, _outs in mine[0]] == [0] * len(mine[0])
    assert len(mine[1]) == len(ref[1])
    for version, (got, want) in enumerate(zip(mine[1], ref[1]), start=1):
        assert got == want, version


def test_mixed_quorum_commits_same_values():
    """Rank 0 is a port monitor, ranks 1 and 2 JAX ones. Commands from
    a port client and then, after the port monitor is killed and
    respawned, from a JAX client commit the chain the all-port quorum
    commits."""
    def mixed(q: Quorum):
        q.wait_quorum()
        replies = q.run(q.client("torch"), COMMANDS[:5])
        q.kill(0)
        q.wait_quorum()
        replies += q.run(q.client("jax"), COMMANDS[5:])
        q.start(0)
        q.wait_quorum()
        last = q.chains_converge()
        chains = [q.chain(r, last) for r in sorted(q.mons)]
        assert all(c == chains[0] for c in chains)
        return replies, chains[0]

    got = _with_quorum(["torch", "jax", "jax"], mixed)
    want = _with_quorum(["torch"] * 3, _commands)
    assert got[0] == want[0]
    assert got[1] == want[1]


def test_mon_status_answers_locally():
    """``mon_status`` (the port's addition) is answered by the monitor
    asked, not forwarded: each reports its own rank and state, and all
    agree on the leader, the quorum and the last committed version."""
    q = Quorum(["torch"] * 3)
    try:
        leader = q.wait_quorum()
        q.run(q.client("torch"), COMMANDS[:3])
        last = q.chains_converge()
        seen = {}
        for rank, addr in q.addrs.items():
            msgr = Messenger(f"status-{rank}")
            q.clients.append(msgr)
            monc = tmonitor.MonClient(msgr, whoami=-1)
            monc.connect(*addr)
            reply = monc.command({"prefix": "mon_status"}, timeout=DEADLINE)
            assert reply.rc == 0
            seen[rank] = json.loads(reply.outb)
        assert {r: s["rank"] for r, s in seen.items()} == {0: 0, 1: 1, 2: 2}
        assert {s["state"] for r, s in seen.items() if r != leader.rank} == {"peon"}
        assert seen[leader.rank]["state"] == "leader"
        assert {s["leader"] for s in seen.values()} == {leader.rank}
        assert all(s["quorum"] == [0, 1, 2] and s["last_committed"] == last for s in seen.values())
    finally:
        q.shutdown()


class _ReplySink:
    """The client side of a queued command: keeps what is sent back."""

    def __init__(self):
        self.replies: queue.Queue = queue.Queue()

    def send(self, msg) -> None:
        self.replies.put(msg)


@pytest.mark.parametrize("role,kind", [("leader", "forward"), ("peon", "command")])
def test_queued_command_runs_where_the_leader_is_now(role, kind):
    """A command is queued as ``forward`` or ``command`` by the role its
    monitor had when it arrived; an election can change that role before
    the worker reaches it. The leader answers a queued ``forward`` itself
    (forwarding would dial itself and wait out the 10 s call timeout
    behind its own worker, one queued command after another), and a peon
    forwards a queued ``command`` to the leader (running it would fail
    the commit as not leader). Either way the command commits once."""
    q = Quorum(["torch"] * 3)
    try:
        lead = q.wait_quorum()
        mon = lead if role == "leader" else q.mons[min(set(q.mons) - {lead.rank})]
        before = lead.store.last_committed()
        sink = _ReplySink()
        cmd = json.dumps({"prefix": "osd reweight", "id": 4, "weight": 0.5})
        mon._workq.put((kind, sink, MMonCommand(tid=7, cmd=cmd)))
        reply = sink.replies.get(timeout=DEADLINE)
        assert (reply.tid, reply.rc, reply.outs) == (7, 0, "")
        assert json.loads(reply.outb) == {"epoch": before + 1}
        assert q.chains_converge() == before + 1
    finally:
        q.shutdown()


def test_leader_kills_tool_commits_after_every_kill(tmp_path, capsys):
    """``tools.leader_kills`` on the CPU: 3 monitor processes, a manager
    and 3 OSD processes; the leader is SIGKILLed twice, and each time a
    client's command commits the next epoch and the respawned monitor
    catches up."""
    from ceph_tpu_torch.tools import leader_kills

    rc = leader_kills.main([
        "--device", "cpu", "--osds", "3", "--kills", "2", "--objects", "2",
        "--wait", str(DEADLINE), "-d", str(tmp_path / "lk"),
    ])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary
    assert (summary["committed"], summary["missed_at"]) == (2, None)
    assert len(summary["catch_up_s"]) == 2
