"""cephx-analog ticket protocol (src/auth/cephx/CephxProtocol.{h,cc},
src/auth/Crypto.cc, src/auth/AuthRegistry.cc).

The reference's kerberos-like flow, kept whole but rendered on
stdlib crypto:

1. Entities share secrets with the auth authority via a keyring
   (``Keyring`` — the /etc/ceph/keyring role).
2. A client authenticates to the authority
   (``CephxServiceHandler.issue_ticket``): it receives a fresh
   SESSION KEY encrypted under its own secret, plus an opaque TICKET
   — {entity, session key, expiry} encrypted under the service's
   ROTATING secret (CephxTicketBlob).  The client cannot read or
   forge the ticket.
3. To open a connection the client builds an AUTHORIZER
   (``CephxClientHandler.build_authorizer``): the ticket plus an
   HMAC proof over a nonce using the session key.
4. The service (``CephxServiceHandler.verify_authorizer``) decrypts
   the ticket with its rotating secret, recovers the session key,
   verifies the proof and the expiry, and answers its own proof so
   the client can authenticate the SERVER too (mutual auth,
   CephxProtocol.cc's authorizer challenge).

Crypto: the reference uses AES-CBC via nss/openssl; the stdlib has
none, so encryption here is a SHA-256 counter-mode keystream XOR with
an encrypt-then-MAC HMAC-SHA256 tag — authenticated encryption built
from hashlib/hmac primitives only.  The protocol shape (tickets,
rotating service keys, session-key proofs) is the parity surface, not
the cipher choice.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time
from dataclasses import dataclass, field

from ..common.encoding import Decoder, Encoder

TICKET_TTL = 3600.0  # auth_service_ticket_ttl default role


class AuthError(Exception):
    pass


class CryptoKey:
    """Symmetric key + the framework's authenticated encryption."""

    def __init__(self, secret: bytes | None = None):
        self.secret = secret if secret is not None else os.urandom(32)

    # -- sha256-ctr keystream + encrypt-then-mac ---------------------------
    def keystream(self, nonce: bytes, n: int) -> bytes:
        """CTR keystream for ``nonce`` — the one cipher primitive,
        shared by ticket sealing (random nonces) and the messenger's
        secure wire mode (per-connection counters)."""
        out = bytearray()
        counter = 0
        while len(out) < n:
            out += hashlib.sha256(
                self.secret + nonce + counter.to_bytes(8, "little")
            ).digest()
            counter += 1
        return bytes(out[:n])

    _keystream = keystream

    @staticmethod
    def xor(data: bytes, ks: bytes) -> bytes:
        """Whole-buffer XOR via big-int ops (the byte-loop would cost
        O(n) interpreter time per message on the wire hot path)."""
        n = len(data)
        return (
            int.from_bytes(data, "little")
            ^ int.from_bytes(ks[:n], "little")
        ).to_bytes(n, "little")

    def encrypt(self, plain: bytes) -> bytes:
        nonce = os.urandom(16)
        ct = self.xor(plain, self.keystream(nonce, len(plain)))
        tag = hmac.new(self.secret, nonce + ct, hashlib.sha256).digest()
        return nonce + ct + tag

    def decrypt(self, blob: bytes) -> bytes:
        if len(blob) < 48:
            raise AuthError("ciphertext too short")
        nonce, ct, tag = blob[:16], blob[16:-32], blob[-32:]
        want = hmac.new(self.secret, nonce + ct, hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise AuthError("ciphertext authentication failed")
        return self.xor(ct, self.keystream(nonce, len(ct)))

    def hmac(self, data: bytes) -> bytes:
        return hmac.new(self.secret, data, hashlib.sha256).digest()


class Keyring:
    """entity name → secret (the keyring file / AuthMonitor database)."""

    def __init__(self):
        self._keys: dict[str, CryptoKey] = {}

    def add(self, entity: str, key: CryptoKey | None = None) -> CryptoKey:
        key = key or CryptoKey()
        self._keys[entity] = key
        return key

    def get(self, entity: str) -> CryptoKey:
        key = self._keys.get(entity)
        if key is None:
            raise AuthError(f"entity {entity!r} has no key (-EACCES)")
        return key

    def entities(self) -> list[str]:
        return sorted(self._keys)


@dataclass
class Ticket:
    """Decrypted ticket contents (CephxServiceTicketInfo)."""

    entity: str
    session_key: bytes
    expires: float

    def encode(self) -> bytes:
        e = Encoder()
        e.string(self.entity).bytes(self.session_key).f64(self.expires)
        return e.getvalue()

    @classmethod
    def decode(cls, blob: bytes) -> "Ticket":
        d = Decoder(blob)
        return cls(
            entity=d.string(), session_key=d.bytes(), expires=d.f64()
        )


@dataclass
class TicketGrant:
    """What the authority hands the client (CephxResponse): the
    session key sealed under the CLIENT key, the ticket sealed under
    the SERVICE rotating key."""

    sealed_session: bytes
    ticket_blob: bytes

    def encode(self) -> bytes:
        e = Encoder()
        e.bytes(self.sealed_session).bytes(self.ticket_blob)
        return e.getvalue()

    @classmethod
    def decode(cls, blob: bytes) -> "TicketGrant":
        d = Decoder(blob)
        return cls(sealed_session=d.bytes(), ticket_blob=d.bytes())


class CephxServiceHandler:
    """Authority + service side: issues and verifies tickets.

    The monitor holds the keyring AND the rotating service secret (in
    the reference rotating secrets are pushed to OSDs by the monitor;
    here every service handler is constructed with the same rotating
    key object, the KeyServer role)."""

    def __init__(self, keyring: Keyring, rotating: CryptoKey | None = None):
        self.keyring = keyring
        self.rotating = rotating or CryptoKey()

    # -- authority ---------------------------------------------------------
    def issue_ticket(
        self, entity: str, ttl: float = TICKET_TTL
    ) -> bytes:
        """Encoded TicketGrant for an entity in the keyring; raises
        AuthError for unknown entities."""
        client_key = self.keyring.get(entity)
        session = os.urandom(32)
        ticket = Ticket(
            entity=entity,
            session_key=session,
            expires=time.time() + ttl,
        )
        return TicketGrant(
            sealed_session=client_key.encrypt(session),
            ticket_blob=self.rotating.encrypt(ticket.encode()),
        ).encode()

    # -- service -----------------------------------------------------------
    def make_challenge(self) -> bytes:
        """Fresh per-connection server challenge (the CEPHX_V2
        anti-replay challenge): the client's proof must cover it, so a
        captured authorizer cannot be replayed on a new connection."""
        return os.urandom(16)

    def verify_authorizer(
        self, authorizer_blob: bytes, challenge: bytes
    ) -> tuple[str, bytes, bytes]:
        """Check a client authorizer against THIS connection's
        challenge: decrypt the ticket with the rotating key, verify
        expiry and the session-key proof.  Returns
        (entity, server_proof, session_key) — the proof lets the
        client authenticate the server back; the session key keys the
        secure (AEAD) wire mode."""
        d = Decoder(authorizer_blob)
        ticket_blob = d.bytes()
        nonce = d.bytes()
        proof = d.bytes()
        ticket = Ticket.decode(self.rotating.decrypt(ticket_blob))
        if ticket.expires < time.time():
            raise AuthError(f"ticket for {ticket.entity!r} expired")
        session = CryptoKey(ticket.session_key)
        want = session.hmac(b"authorizer" + challenge + nonce)
        if not hmac.compare_digest(proof, want):
            raise AuthError("bad session-key proof")
        return (
            ticket.entity,
            session.hmac(b"server" + challenge + nonce),
            ticket.session_key,
        )


class CephxClientHandler:
    """Client side: unseal the grant, build authorizers."""

    def __init__(self, entity: str, key: CryptoKey):
        self.entity = entity
        self.key = key
        self.session: CryptoKey | None = None
        self.ticket_blob: bytes = b""

    def handle_response(self, grant_blob: bytes) -> None:
        grant = TicketGrant.decode(grant_blob)
        self.session = CryptoKey(self.key.decrypt(grant.sealed_session))
        self.ticket_blob = grant.ticket_blob

    def build_authorizer(self, challenge: bytes) -> tuple[bytes, bytes]:
        """(authorizer_blob, nonce): ticket + HMAC proof over the
        server's per-connection challenge and a fresh nonce."""
        if self.session is None:
            raise AuthError("no ticket yet (authenticate first)")
        nonce = os.urandom(16)
        e = Encoder()
        e.bytes(self.ticket_blob).bytes(nonce)
        e.bytes(self.session.hmac(b"authorizer" + challenge + nonce))
        return e.getvalue(), nonce

    def verify_server(
        self, challenge: bytes, nonce: bytes, server_proof: bytes
    ) -> None:
        want = self.session.hmac(b"server" + challenge + nonce)
        if not hmac.compare_digest(server_proof, want):
            raise AuthError("server failed mutual authentication")
