"""S3 ACLs — ownership + grants enforced on every gateway op
(src/rgw/rgw_acl.cc, rgw_acl_s3.cc reduced to the working core).

An ACL is ``{"owner": <user>, "grants": [{"grantee": g, "perms":
[...]}]}`` where a grantee is ``user:<name>``, ``ALL`` (the AllUsers
group — anonymous requests match it) or ``AUTH`` (any authenticated
user).  Permissions are the S3 five: READ, WRITE, READ_ACP,
WRITE_ACP, FULL_CONTROL.  The owner (and the bucket owner, for
objects) always has FULL_CONTROL — exactly the reference's
``RGWAccessControlPolicy::verify_permission`` short-circuit.

Canned ACLs (x-amz-acl) expand to grant lists at set time, like
rgw_acl_s3's canned-ACL table: private, public-read,
public-read-write, authenticated-read.
"""

from __future__ import annotations

READ = "READ"
WRITE = "WRITE"
READ_ACP = "READ_ACP"
WRITE_ACP = "WRITE_ACP"
FULL_CONTROL = "FULL_CONTROL"

CANNED = {
    "private": [],
    "public-read": [{"grantee": "ALL", "perms": [READ]}],
    "public-read-write": [
        {"grantee": "ALL", "perms": [READ, WRITE]}
    ],
    "authenticated-read": [{"grantee": "AUTH", "perms": [READ]}],
}


def make_acl(owner: str | None, canned: str = "private") -> dict:
    if canned not in CANNED:
        raise ValueError(f"unknown canned acl {canned!r}")
    return {"owner": owner, "grants": list(CANNED[canned])}


def check(
    acl: dict | None,
    user: str | None,
    perm: str,
    bucket_owner: str | None = None,
) -> bool:
    """Does ``user`` (None = anonymous) hold ``perm``?  Owners hold
    everything; group grants match by authentication state."""
    acl = acl or {}
    owner = acl.get("owner")
    if user is not None and user in (owner, bucket_owner):
        return True
    for grant in acl.get("grants", ()):
        g = grant["grantee"]
        if not (
            g == "ALL"
            or (g == "AUTH" and user is not None)
            or (user is not None and g == f"user:{user}")
        ):
            continue
        if perm in grant["perms"] or FULL_CONTROL in grant["perms"]:
            return True
    return False
