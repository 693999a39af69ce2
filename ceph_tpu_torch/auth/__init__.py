"""auth — cephx-analog ticket authentication (src/auth/)."""

from .cephx import (
    AuthError,
    CephxClientHandler,
    CephxServiceHandler,
    CryptoKey,
    Keyring,
    Ticket,
)

__all__ = [
    "AuthError",
    "CephxClientHandler",
    "CephxServiceHandler",
    "CryptoKey",
    "Keyring",
    "Ticket",
]
