"""The port's messenger held against the JAX package's on the CPU:
every registered message type encodes to the same frame bytes in both
packages and decodes the other's; frames, call/reply pairing, the
shared network stack, seeded fault injection and lossless sessions
behave as the JAX package's ``tests/test_msg.py``,
``tests/test_msgr_stack.py`` and the messenger-only tests of
``tests/test_session.py`` hold them; and a messenger of one package
talks to the other's, both ways."""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest

import ceph_tpu.msg as jmsg
from ceph_tpu.msg import message as jmessage
from ceph_tpu.store import objectstore as j_objectstore
from ceph_tpu_torch.msg import (
    MECSubWrite,
    Message,
    MessageError,
    Messenger,
    MPing,
    NetworkStack,
    stack_perf_dump,
)
from ceph_tpu_torch.msg import message as tmessage
from ceph_tpu_torch.msg.messenger import Dispatcher, wait_for
from ceph_tpu_torch.msg.stack import default_workers
from ceph_tpu_torch.store.objectstore import Transaction


@pytest.fixture(autouse=True)
def no_live_reactor():
    """Every test shuts its messengers down: neither package's stack
    outlives it."""
    before = (NetworkStack.live(), jmsg.NetworkStack.live())
    yield
    if before == (None, None):
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None,
            5.0,
        )


# -- every message type, byte for byte ---------------------------------------


def _txn(rng, txn_cls):
    cid, oid = f"c{rng.integers(100)}", f"o{rng.integers(100)}"
    data = rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8).tobytes()
    return (
        txn_cls()
        .create_collection(cid)
        .touch(cid, oid)
        .write(cid, oid, int(rng.integers(0, 1 << 20)), data)
        .setattr(cid, oid, "k", data[:3])
        .omap_setkeys(cid, oid, {"a": data[:5], "b": b""})
        .truncate(cid, oid, int(rng.integers(0, 64)))
        .rmattr(cid, oid, "k")
        .remove(cid, oid)
    )


def _blob(rng) -> bytes:
    return rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()


def _s(rng) -> str:
    return "".join(chr(c) for c in rng.integers(0x20, 0x7F, int(rng.integers(0, 12))))


def _n(rng) -> int:
    # fits every integer field of the wire (u8 kinds included)
    return int(rng.integers(0, 200))


# container fields named by what the wire carries in them
_CONTAINERS = {
    "ops": lambda rng: [(_n(rng), _s(rng), _s(rng), int(rng.integers(0, 1 << 40)), _s(rng)) for _ in range(3)],
    "results": lambda rng: [(bool(rng.integers(2)), _blob(rng)) for _ in range(3)],
    "incrementals": lambda rng: [_blob(rng) for _ in range(3)],
    "entry_blobs": lambda rng: [_blob(rng) for _ in range(3)],
    "names": lambda rng: [_s(rng) for _ in range(3)],
    "oids": lambda rng: [_s(rng) for _ in range(3)],
    "quorum": lambda rng: [_n(rng) for _ in range(3)],
    "entries": lambda rng: [(_n(rng), _blob(rng), _blob(rng)) for _ in range(2)],
    "since": lambda rng: (_n(rng), int(rng.integers(0, 1 << 40))),
    "rewind_to": lambda rng: (_n(rng), int(rng.integers(0, 1 << 40))),
    "attrs": lambda rng: {_s(rng): _blob(rng) for _ in range(3)},
    "omap": lambda rng: {_s(rng): _blob(rng) for _ in range(3)},
}


_SCALARS = ("bool", "int", "float", "str", "bytes")


def _seeded_fields(cls, seed: int, txn_cls) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tid": int(rng.integers(0, 1 << 62))}
    for f in dataclasses.fields(cls):
        if f.name == "tid":
            continue
        kind = f.type.strip("'")
        if kind not in _SCALARS and f.name in _CONTAINERS:
            out[f.name] = _CONTAINERS[f.name](rng)
        elif kind == "Transaction":
            out[f.name] = _txn(rng, txn_cls)
        elif kind == "bool":
            out[f.name] = bool(rng.integers(2))
        elif kind == "int":
            out[f.name] = _n(rng)
        elif kind == "float":
            out[f.name] = float(rng.random())
        elif kind == "str":
            out[f.name] = _s(rng)
        elif kind == "bytes":
            out[f.name] = _blob(rng)
        else:
            raise AssertionError(f"{cls.__name__}.{f.name}: no seed for {kind}")
    return out


def test_registries_match():
    assert sorted(tmessage._REGISTRY) == sorted(jmessage._REGISTRY)
    assert [c.__name__ for _t, c in sorted(tmessage._REGISTRY.items())] == [
        c.__name__ for _t, c in sorted(jmessage._REGISTRY.items())
    ]
    assert len(tmessage._REGISTRY) == 42


def _decode_frame(mod, frame: bytes):
    m = mod.Message
    mtype, tid, plen = m.parse_header(frame[: m.HEADER_SIZE])
    payload = frame[m.HEADER_SIZE : m.HEADER_SIZE + plen]
    crc = int.from_bytes(frame[m.HEADER_SIZE + plen :], "little")
    return m.from_payload(mtype, tid, payload, crc)


@pytest.mark.parametrize("mtype", sorted(jmessage._REGISTRY))
def test_message_bytes_match_jax_both_ways(mtype):
    tcls, jcls = tmessage._REGISTRY[mtype], jmessage._REGISTRY[mtype]
    for seed in (mtype, mtype + 1000):
        tm = tcls(**_seeded_fields(tcls, seed, Transaction))
        jm = jcls(**_seeded_fields(jcls, seed, j_objectstore.Transaction))
        frame = tm.to_frame()
        assert frame == jm.to_frame()
        # each package decodes the other's frame to the same message
        from_j = _decode_frame(tmessage, jm.to_frame())
        from_t = _decode_frame(jmessage, frame)
        assert type(from_j) is tcls and type(from_t) is jcls
        assert from_j.to_frame() == frame == from_t.to_frame()


# -- frames and the transaction codec ---------------------------------------


def test_frame_roundtrip():
    msg = MPing(tid=7, from_osd=3, stamp=1.5)
    out = _decode_frame(tmessage, msg.to_frame())
    assert isinstance(out, MPing)
    assert (out.tid, out.from_osd, out.stamp) == (7, 3, 1.5)


@pytest.mark.parametrize("where", ["magic", "header", "header_crc", "payload"])
def test_frame_corruption_detected_like_jax(where):
    size = Message.HEADER_SIZE
    pos = {"magic": 0, "header": 5, "header_crc": size - 1, "payload": size + 2}[where]
    verdicts = []
    for mod in (tmessage, jmessage):
        frame = bytearray(mod.MPing(tid=1, from_osd=2, stamp=0.25).to_frame())
        frame[pos] ^= 0xFF
        with pytest.raises(mod.MessageError) as err:
            _decode_frame(mod, bytes(frame))
        verdicts.append(str(err.value))
    assert verdicts[0] == verdicts[1]


def test_transaction_codec_roundtrip():
    rng = np.random.default_rng(5)
    txn = _txn(rng, Transaction)
    out = _decode_frame(tmessage, MECSubWrite(txn=txn).to_frame())
    assert out.txn.ops == txn.ops


# -- the messenger -------------------------------------------------------------


class _Echo(Dispatcher):
    """Echoes pings and records their stamps (either package)."""

    def __init__(self, ping_cls=MPing):
        self.ping_cls = ping_cls
        self.received: list[float] = []
        self.resets = 0

    def ms_dispatch(self, conn, msg):
        if isinstance(msg, self.ping_cls) and not msg.is_reply:
            self.received.append(msg.stamp)
            conn.send(self.ping_cls(tid=msg.tid, from_osd=99, stamp=msg.stamp, is_reply=True))
            return True
        return False

    def ms_handle_reset(self, conn):
        self.resets += 1


def test_call_reply_pairing_and_reset():
    server = Messenger("server")
    server.add_dispatcher(_Echo())
    host, port = server.bind()
    client = Messenger("client")
    try:
        conn = client.connect(host, port)
        results = {}

        def call(i):
            results[i] = conn.call(MPing(from_osd=i, stamp=float(i)))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert [results[i].stamp for i in range(8)] == [float(i) for i in range(8)]
        assert all(results[i].is_reply for i in range(8))
        server.shutdown()
        assert wait_for(lambda: conn.is_closed, 5)
        with pytest.raises(MessageError):
            conn.call(MPing(from_osd=1), timeout=2)
    finally:
        client.shutdown()
        server.shutdown()


def test_unclaimed_message_drops_silently():
    server = Messenger("server")
    server.add_dispatcher(_Echo())
    host, port = server.bind()
    client = Messenger("client")
    try:
        conn = client.connect(host, port)
        conn.send(MECSubWrite(tid=client.new_tid(), txn=Transaction()))
        assert conn.call(MPing(from_osd=1), timeout=10).is_reply
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_cross_package_call_and_session(server_pkg):
    """A JAX client against a port server and the reverse: plain calls,
    concurrent pairing and a lossless session across a socket kill."""
    srv_cls = jmsg.Messenger if server_pkg == "jax" else Messenger
    cli_cls = Messenger if server_pkg == "jax" else jmsg.Messenger
    srv_ping = jmsg.MPing if server_pkg == "jax" else MPing
    cli_ping = MPing if server_pkg == "jax" else jmsg.MPing
    jax_stack = jmsg.NetworkStack.live()  # another file's leftover, or None
    srv = srv_cls("x-srv")
    echo = _Echo(srv_ping)
    srv.add_dispatcher(echo)
    host, port = srv.bind()
    cli = cli_cls("x-cli")
    try:
        conn = cli.connect(host, port)
        for i in range(5):
            r = conn.call(cli_ping(from_osd=i, stamp=float(i)), timeout=10)
            assert isinstance(r, cli_ping) and r.is_reply and r.stamp == float(i)
        sc = cli.connect_session(host, port, "xs")
        assert sc.call(cli_ping(from_osd=1, stamp=10.0), timeout=10).stamp == 10.0
        old = sc._conn
        for c in list(srv._conns):
            c.close()
        assert wait_for(lambda: old.is_closed, 5.0)
        assert sc.call(cli_ping(from_osd=1, stamp=11.0), timeout=10).stamp == 11.0
        assert echo.received == [0.0, 1.0, 2.0, 3.0, 4.0, 10.0, 11.0]
    finally:
        cli.shutdown()
        srv.shutdown()
    assert wait_for(lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is jax_stack, 5.0)


# -- the shared stack ----------------------------------------------------------


def test_two_packages_keep_separate_refcounted_stacks():
    """Each package's stack is its own singleton; the last shutdown of
    each tears its own down, and a fresh start builds a new generation.
    (A JAX stack another test file left running stays as it was.)"""
    assert NetworkStack.live() is None
    jax_stack = jmsg.NetworkStack.live()
    t1, t2, j1 = Messenger("gen-a"), Messenger("gen-b"), jmsg.Messenger("gen-j")
    t1.start()
    j1.start()
    gen, jgen = NetworkStack.live(), jmsg.NetworkStack.live()
    assert gen is not None and jgen is not None and gen is not jgen
    assert jax_stack in (None, jgen)
    t2.start()
    t1.shutdown()
    assert NetworkStack.live() is gen
    t2.shutdown()
    assert NetworkStack.live() is None
    assert jmsg.NetworkStack.live() is jgen
    j1.shutdown()
    assert jmsg.NetworkStack.live() is jax_stack
    t3 = Messenger("gen-c")
    t3.start()
    try:
        assert NetworkStack.live() not in (None, gen)
    finally:
        t3.shutdown()
    assert NetworkStack.live() is None
    with pytest.raises(Exception):
        t1.start()  # shutdown is terminal


def test_many_messengers_share_bounded_workers():
    before = threading.active_count()
    msgrs = []
    try:
        for i in range(12):
            m = Messenger(f"fleet-{i}")
            m.add_dispatcher(_Echo())
            m.bind()
            msgrs.append(m)
        stack = NetworkStack.live()
        assert len(stack.workers) <= default_workers()
        assert threading.active_count() - before <= default_workers() + stack.offload.size + 2
        cli = Messenger("fleet-cli")
        msgrs.append(cli)
        for m in msgrs[:4]:
            assert cli.connect(*m.bound_addr).call(MPing(stamp=1.5), timeout=10).is_reply
        dump = stack_perf_dump()
        n = dump["l_msgr_workers"]
        assert sum(dump[f"l_msgr_worker{i}_dispatch"] for i in range(n)) == dump["l_msgr_worker_dispatch"]
        assert dump["l_msgr_worker_dispatch"] >= 4
    finally:
        for m in msgrs:
            m.shutdown()
    assert NetworkStack.live() is None
    assert stack_perf_dump() == {}


def test_stack_perf_schema_matches_jax():
    from ceph_tpu.msg.faults import build_msgr_perf as j_build_msgr_perf
    from ceph_tpu.msg.stack import build_stack_perf as j_build_stack_perf
    from ceph_tpu_torch.msg import build_msgr_perf, build_stack_perf

    assert build_stack_perf(2).dump() == j_build_stack_perf(2).dump()
    assert build_msgr_perf("osd.0").dump() == j_build_msgr_perf("osd.0").dump()


# -- seeded fault injection ----------------------------------------------------


def _seeded_run(msgr_cls, ping_cls, seed: int):
    srv = msgr_cls("det-srv")
    srv.add_dispatcher(_Echo(ping_cls))
    cli = msgr_cls("det-cli")
    try:
        addr = srv.bind()
        cli.faults.reseed(seed)
        cli.faults.add_rule(dst=f"{addr[0]}:{addr[1]}", delay=0.002, jitter=0.004, dup=0.4)
        cli.faults.add_rule(drop=0.0, reorder=0.3)
        conn = cli.connect(*addr)
        for i in range(30):
            assert conn.call(ping_cls(stamp=float(i)), timeout=10.0).stamp == float(i)
        return [what for (_dst, what) in cli.faults.decisions], cli.faults.perf.dump()
    finally:
        cli.shutdown()
        srv.shutdown()


def test_fault_decisions_deterministic_and_equal_to_jax():
    s1, c1 = _seeded_run(Messenger, MPing, 7)
    s2, c2 = _seeded_run(Messenger, MPing, 7)
    assert (s1, c1) == (s2, c2)
    assert c1["fault_duplicated"] > 0
    assert _seeded_run(Messenger, MPing, 8)[0] != s1
    # the same seed draws the same weather in the JAX package
    assert _seeded_run(jmsg.Messenger, jmsg.MPing, 7) == (s1, c1)


# -- lossless sessions ---------------------------------------------------------


def test_session_survives_socket_kill_and_replays():
    srv_msgr = Messenger("sess-srv")
    srv = _Echo()
    srv_msgr.add_dispatcher(srv)
    host, port = srv_msgr.bind()
    cli_msgr = Messenger("sess-cli")
    try:
        sc = cli_msgr.connect_session(host, port, "t1")
        assert sc.call(MPing(from_osd=1, stamp=1.0)).is_reply
        old_conn = sc._conn
        for conn in list(srv_msgr._conns):
            conn.close()
        assert wait_for(lambda: old_conn.is_closed, 5.0)
        assert sc.call(MPing(from_osd=1, stamp=2.0)).stamp == 2.0
        assert srv.received == [1.0, 2.0]
    finally:
        cli_msgr.shutdown()
        srv_msgr.shutdown()


def test_session_replays_unacked_after_drop_without_duplicates():
    srv_msgr = Messenger("sess-srv2")
    srv = _Echo()
    srv_msgr.add_dispatcher(srv)
    host, port = srv_msgr.bind()
    cli_msgr = Messenger("sess-cli2")
    try:
        sc = cli_msgr.connect_session(host, port, "t2")
        cli_msgr.inject_socket_failures = 3
        for i in range(20):
            sc.call(MPing(from_osd=1, stamp=float(i)), timeout=30.0)
        cli_msgr.inject_socket_failures = 0
        assert srv.received == [float(i) for i in range(20)]
    finally:
        cli_msgr.shutdown()
        srv_msgr.shutdown()


def test_session_replay_survives_reset_kick():
    srv = Messenger("kick-srv")
    echo = _Echo()
    srv.add_dispatcher(echo)
    cli = Messenger("kick-cli")
    try:
        host, port = srv.bind()
        sc = cli.connect_session(host, port, "kick1")
        for i in range(3):
            sc.call(MPing(from_osd=1, stamp=float(i)))
        old = sc._conn
        for conn in list(srv._conns):
            conn.close()
        assert wait_for(lambda: old.is_closed, 5.0)
        sc.send(MPing(from_osd=1, stamp=99.0))
        assert wait_for(lambda: 99.0 in echo.received, 5.0)
        assert echo.received == [0.0, 1.0, 2.0, 99.0]
    finally:
        cli.shutdown()
        srv.shutdown()


def test_wedged_dispatcher_stalls_only_its_own_messenger():
    wedge = threading.Event()
    a_got: list[float] = []

    class Wedged(Dispatcher):
        def ms_dispatch(self, conn, msg) -> bool:
            if isinstance(msg, MPing) and not msg.is_reply:
                if not a_got:
                    wedge.wait(30.0)
                a_got.append(msg.stamp)
                return True
            return False

    a, b, cli = Messenger("wedged-a"), Messenger("live-b"), Messenger("wedge-cli")
    a.add_dispatcher(Wedged())
    b.add_dispatcher(_Echo())
    try:
        conn_a = cli.connect(*a.bind())
        conn_b = cli.connect(*b.bind())
        for stamp in (1.0, 2.0, 3.0):
            conn_a.send(MPing(tid=cli.new_tid(), stamp=stamp))
        t0 = time.monotonic()
        assert conn_b.call(MPing(stamp=9.0), timeout=5.0).is_reply
        assert time.monotonic() - t0 < 5.0
        assert a_got == []
        wedge.set()
        assert wait_for(lambda: len(a_got) == 3, 5.0), a_got
        assert a_got == [1.0, 2.0, 3.0]
    finally:
        wedge.set()
        cli.shutdown()
        a.shutdown()
        b.shutdown()
