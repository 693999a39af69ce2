"""The port's cephx held against the JAX package's on the CPU.  Sealing
draws fresh nonces and expiries (``os.urandom``, ``time.time``), so the
two packages are held by what stays fixed — the keystream, the MAC and
the ticket codec are byte-equal for the same secret and nonce — and by
what one package seals, the other opens: tickets, authorizers and the
server's proof cross-verify, and a cephx messenger session (crc and
secure mode) works between a JAX and a port messenger both ways.  Bad
keys and forged tickets are refused as in ``tests/test_auth.py``."""

from __future__ import annotations

import time

import numpy as np
import pytest

import ceph_tpu.auth as jauth
import ceph_tpu.msg as jmsg
import ceph_tpu_torch.msg as tmsg
from ceph_tpu_torch.auth import (
    AuthError,
    CephxClientHandler,
    CephxServiceHandler,
    CryptoKey,
    Keyring,
    Ticket,
)
from ceph_tpu_torch.auth.cephx import TicketGrant
from ceph_tpu_torch.msg import MessageError, Messenger, NetworkStack
from ceph_tpu_torch.msg.messenger import wait_for


@pytest.fixture(autouse=True)
def no_live_reactor():
    before = (NetworkStack.live(), jmsg.NetworkStack.live())
    yield
    if before == (None, None):
        assert wait_for(
            lambda: NetworkStack.live() is None and jmsg.NetworkStack.live() is None,
            5.0,
        )


def _secret(seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, 32, dtype=np.uint8).tobytes()


PKGS = {
    "torch": (CryptoKey, Keyring, CephxServiceHandler, CephxClientHandler, AuthError),
    "jax": (
        jauth.CryptoKey, jauth.Keyring, jauth.CephxServiceHandler,
        jauth.CephxClientHandler, jauth.AuthError,
    ),
}


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000])
def test_cipher_primitives_byte_equal(n):
    rng = np.random.default_rng(n)
    secret = _secret(n)
    nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    tk, jk = CryptoKey(secret), jauth.CryptoKey(secret)
    assert tk.keystream(nonce, n) == jk.keystream(nonce, n)
    assert CryptoKey.xor(data, tk.keystream(nonce, n)) == jauth.CryptoKey.xor(
        data, jk.keystream(nonce, n)
    )
    assert tk.hmac(data) == jk.hmac(data)
    # what one package seals, the other opens
    assert jk.decrypt(tk.encrypt(data)) == data
    assert tk.decrypt(jk.encrypt(data)) == data


def test_ticket_codec_byte_equal():
    t = Ticket(entity="osd.3", session_key=_secret(1), expires=1234.5)
    j = jauth.Ticket(entity="osd.3", session_key=_secret(1), expires=1234.5)
    assert t.encode() == j.encode()
    assert jauth.Ticket.decode(t.encode()) == j
    assert Ticket.decode(j.encode()) == t
    g = TicketGrant(sealed_session=b"s" * 48, ticket_blob=b"t" * 60)
    assert g.encode() == jauth.cephx.TicketGrant(b"s" * 48, b"t" * 60).encode()


@pytest.mark.parametrize("authority", ["jax", "torch"])
def test_tickets_and_mutual_auth_cross_verify(authority):
    """One package's authority issues the ticket and verifies the
    authorizer; the other package's client unseals, proves and checks
    the server back."""
    client_pkg = "torch" if authority == "jax" else "jax"
    key_cls, ring_cls, svc_cls, _c, _e = PKGS[authority]
    ckey_cls, _r, _s, cli_cls, cerr = PKGS[client_pkg]
    secret = _secret(7)
    ring = ring_cls()
    ring.add("client.admin", key_cls(secret))
    svc = svc_cls(ring, rotating=key_cls(_secret(8)))
    client = cli_cls("client.admin", ckey_cls(secret))
    client.handle_response(svc.issue_ticket("client.admin"))
    challenge = svc.make_challenge()
    blob, nonce = client.build_authorizer(challenge)
    entity, proof, skey = svc.verify_authorizer(blob, challenge)
    assert entity == "client.admin" and skey == client.session.secret
    client.verify_server(challenge, nonce, proof)
    with pytest.raises(cerr):
        client.verify_server(challenge, nonce, b"x" * 32)
    # anti-replay: the authorizer fails another connection's challenge
    with pytest.raises(PKGS[authority][4]):
        svc.verify_authorizer(blob, svc.make_challenge())


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_bad_keys_and_forged_tickets_refused(pkg):
    key_cls, ring_cls, svc_cls, cli_cls, err = PKGS[pkg]
    ring = ring_cls()
    key = ring.add("client.admin")
    svc = svc_cls(ring)
    with pytest.raises(err):
        svc.issue_ticket("client.rogue")
    # a client with the wrong key cannot unseal its grant
    with pytest.raises(err):
        cli_cls("client.admin", key_cls()).handle_response(svc.issue_ticket("client.admin"))
    # an expired ticket is refused
    client = cli_cls("client.admin", key)
    client.handle_response(svc.issue_ticket("client.admin", ttl=-1))
    ch = svc.make_challenge()
    with pytest.raises(err):
        svc.verify_authorizer(client.build_authorizer(ch)[0], ch)
    # a ticket the client sealed itself is refused
    client.handle_response(svc.issue_ticket("client.admin"))
    fake = (Ticket if pkg == "torch" else jauth.Ticket)(
        entity="client.admin", session_key=b"k" * 32, expires=time.time() + 999
    )
    client.ticket_blob = key_cls().encrypt(fake.encode())
    with pytest.raises(err):
        svc.verify_authorizer(client.build_authorizer(ch)[0], ch)
    # a tampered ciphertext fails its MAC
    blob = bytearray(key.encrypt(b"secret payload" * 10))
    blob[20] ^= 1
    with pytest.raises(err):
        key.decrypt(bytes(blob))


class _Echo:
    def __init__(self, ping_cls):
        self.ping_cls = ping_cls
        self.peers: list[str] = []

    def ms_dispatch(self, conn, msg):
        if isinstance(msg, self.ping_cls) and not msg.is_reply:
            self.peers.append(conn.peer_entity)
            conn.send(self.ping_cls(tid=msg.tid, from_osd=99, stamp=msg.stamp, is_reply=True))
            return True
        return False

    def ms_handle_reset(self, conn):
        pass


@pytest.mark.parametrize("secure", [False, True], ids=["crc", "secure"])
@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_cephx_session_between_packages(server_pkg, secure):
    """A cephx server of one package and a client of the other: the
    handshake authenticates both ways and pings flow, in crc mode and
    in secure (AEAD) mode; a client without a ticket or with a forged
    one is refused."""
    client_pkg = "torch" if server_pkg == "jax" else "jax"
    smsg = jmsg if server_pkg == "jax" else tmsg
    cmsg = jmsg if client_pkg == "jax" else tmsg
    key_cls, ring_cls, svc_cls, _c, _e = PKGS[server_pkg]
    ckey_cls, _r, _s, cli_cls, _ce = PKGS[client_pkg]
    secret = _secret(11)
    ring = ring_cls()
    ring.add("client.app", key_cls(secret))
    svc = svc_cls(ring)
    echo = _Echo(smsg.MPing)
    server = smsg.Messenger("srv", auth_server=svc, secure=secure)
    server.add_dispatcher(echo)
    addr = server.bind()
    handler = cli_cls("client.app", ckey_cls(secret))
    handler.handle_response(svc.issue_ticket("client.app"))
    client = cmsg.Messenger("cli", auth_client=handler, secure=secure)
    bare = cmsg.Messenger("bare")
    evil_handler = cli_cls("client.app", ckey_cls())
    evil_handler.session = ckey_cls()
    evil_handler.ticket_blob = b"garbage-ticket-bytes" * 3
    evil = cmsg.Messenger("evil", auth_client=evil_handler)
    try:
        conn = client.connect(*addr)
        for i in range(3):
            r = conn.call(cmsg.MPing(stamp=float(i), from_osd=i), timeout=10)
            assert isinstance(r, cmsg.MPing) and r.is_reply and r.stamp == float(i)
        big = cmsg.MOSDOp(oid="o", data=bytes(range(256)) * 300)
        assert conn.call(cmsg.MPing(stamp=5.0), timeout=10).stamp == 5.0
        conn.send(big)  # unclaimed, larger than one keystream block
        assert conn.call(cmsg.MPing(stamp=6.0), timeout=10).stamp == 6.0
        assert echo.peers == ["client.app"] * 5
        with pytest.raises(cmsg.MessageError):
            bare.connect(*addr)
        with pytest.raises(cmsg.MessageError):
            evil.connect(*addr)
    finally:
        for m in (client, bare, evil, server):
            m.shutdown()


def test_secure_client_refuses_plain_jax_server():
    """A port dialer that requires secure mode refuses a JAX cephx
    server that offers only crc mode (no downgrade)."""
    ring = jauth.Keyring()
    ring.add("client.app", jauth.CryptoKey(_secret(3)))
    svc = jauth.CephxServiceHandler(ring)
    server = jmsg.Messenger("plain-auth-srv", auth_server=svc)
    server.add_dispatcher(_Echo(jmsg.MPing))
    addr = server.bind()
    handler = CephxClientHandler("client.app", CryptoKey(_secret(3)))
    handler.handle_response(svc.issue_ticket("client.app"))
    strict = Messenger("strict-cli", auth_client=handler, secure=True)
    try:
        with pytest.raises(MessageError):
            strict.connect(*addr)
        with pytest.raises(ValueError):
            Messenger("bad", auth_client=handler, secure=True).bind()
    finally:
        strict.shutdown()
        server.shutdown()
