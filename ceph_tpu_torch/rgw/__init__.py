"""RGW analog — an HTTP object gateway over the rados layer
(src/rgw/: the beast-frontend + rgw_rados layout, reduced to the
load-bearing architecture).

What carries over from the reference's design:

- **The gateway is a rados CLIENT daemon**: it owns no storage; every
  bucket/object operation becomes librados I/O (rgw_rados.cc's role).
- **Bucket indexes are omap objects** (the cls_rgw bucket-index
  pattern): ``bucket.index.<name>`` maps key → JSON entry
  (size/etag/mtime), so listings are key-ordered omap pages with
  marker/max-keys — exactly how S3 ListObjects pagination rides
  RocksDB in the reference.
- **A bucket directory object** (``rgw.buckets``) indexes the
  buckets themselves.
- Object payloads live at ``rgw.obj.<bucket>/<key>``; multipart-scale
  striping would ride osdc/striper.py like rbd (not wired yet).

Served surface (S3-flavored REST over http.server, the beast role):

    PUT    /<bucket>                 create bucket
    DELETE /<bucket>                 remove empty bucket
    GET    /                         ListAllMyBuckets (XML)
    PUT    /<bucket>/<key>           upload (body = object)
    GET    /<bucket>/<key>           download
    HEAD   /<bucket>/<key>           stat
    DELETE /<bucket>/<key>           remove
    GET    /<bucket>?marker=&max-keys=   ListObjects (XML, paged)

    POST   /<bucket>/<key>?uploads      initiate multipart upload
    PUT    /<bucket>/<key>?uploadId=&partNumber=   upload one part
    POST   /<bucket>/<key>?uploadId=    complete (manifest head)
    DELETE /<bucket>/<key>?uploadId=    abort

Auth (round 4): AWS SigV4-shaped request signing (rgw_auth_s3.cc
role) — users live in an omap-backed store (access key → secret),
the Authorization header carries credential scope + signed headers +
signature, the gateway recomputes the signature over the canonical
request and rejects mismatches/stale dates with 403.  Multipart
(round 4): parts land as separate rados objects; complete writes a
MANIFEST head (the reference's multipart manifest), so GET streams
part reads and the "-N" composite etag matches S3's shape.

ACLs (round 5, acl.py — src/rgw/rgw_acl.cc): buckets and objects
carry owner + grant lists (canned x-amz-acl or explicit), enforced
on EVERY op — anonymous requests match only AllUsers grants; ?acl
subresources read/write policies under READ_ACP/WRITE_ACP.
Lifecycle (round 5, lifecycle.py — src/rgw/rgw_lc.cc): per-bucket
expiration + storage-class transition rules applied by a scanning
worker; COLD transition really recompresses the payload through the
compressor registry; ``?lifecycle`` subresource round-trips configs.

STS (round 5): GetSessionToken/AssumeRole mint expiring temporary
credentials (12h cap, session creds may not re-mint) that sign
requests exactly like permanent keys.  Multisite (round 5,
multisite.py): per-zone datalog + cross-zone sync agents.

CORS (round 5): per-bucket rules (?cors subresource), OPTIONS
preflight, and Allow-Origin echo on admitted requests.

Deviations, documented: keystone absent; STS issues no role
ARNs/policies (the temp identity IS the caller); region/service
names checked only for self-consistency; single pool; lifecycle
configs are JSON on the wire (not S3's XML schema).
"""

from __future__ import annotations

import hashlib
import http.server
import json
import threading
import time
import urllib.parse
from xml.sax.saxutils import escape

from ..osdc.objecter import ObjectNotFound, RadosError
from . import acl as aclmod
from .lifecycle import LCWorker, apply_rules

__all__ = ["RGW", "RGWError", "AccessDenied", "sign_request"]


def _default_max_objs_per_shard() -> int:
    from ..common.config import SCHEMA

    return int(SCHEMA["rgw_max_objs_per_shard"].default)

BUCKETS_DIR = "rgw.buckets"
USERS_OID = "rgw.users"
LC_OID = "rgw.lc"  # lifecycle configs: bucket -> rules (lc shard role)
SKEW = 900.0  # max x-amz-date clock skew (seconds)
# storage-layer callers that bypass ACLs (internal plumbing, admin
# tools, tests of the storage logic itself) pass SYSTEM — the
# reference's system-user bypass in verify_permission
SYSTEM = "__rgw_system__"
# the multisite sync agent's identity: same bypass as SYSTEM, but its
# mutations are NOT datalogged (a mirrored write must not ping-pong
# between active-active zones; the reference short-circuits on the
# entry's source zone)
SYNC_USER = "__rgw_sync__"
DATALOG_OID = "rgw.datalog"
_DENIED = object()  # HTTP sentinel: signature rejected, 403 sent


def _hmac(key: bytes, msg: str) -> bytes:
    import hmac as hmac_mod

    return hmac_mod.new(key, msg.encode(), hashlib.sha256).digest()


def _sigv4_key(secret: str, date: str, region: str, service: str):
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def _canonical(method, path, query, amz_date, payload_sha) -> str:
    q = "&".join(
        f"{urllib.parse.quote(k, safe='')}="
        f"{urllib.parse.quote(v, safe='')}"
        for k, v in sorted(query.items())
    )
    headers = f"x-amz-content-sha256:{payload_sha}\nx-amz-date:{amz_date}\n"
    return "\n".join(
        (
            method,
            urllib.parse.quote(path),
            q,
            headers,
            "x-amz-content-sha256;x-amz-date",
            payload_sha,
        )
    )


def sign_request(
    method: str,
    path: str,
    query: dict,
    payload: bytes,
    access: str,
    secret: str,
    region: str = "default",
    amz_date: str | None = None,
) -> dict:
    """Headers for a SigV4-shaped request against the gateway (the
    client half; boto-equivalent for this reduced dialect)."""
    amz_date = amz_date or time.strftime(
        "%Y%m%dT%H%M%SZ", time.gmtime()
    )
    date = amz_date[:8]
    payload_sha = hashlib.sha256(payload).hexdigest()
    canonical = _canonical(method, path, query, amz_date, payload_sha)
    scope = f"{date}/{region}/s3/aws4_request"
    sts = "\n".join(
        (
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        )
    )
    import hmac as hmac_mod

    sig = hmac_mod.new(
        _sigv4_key(secret, date, region, "s3"), sts.encode(),
        hashlib.sha256,
    ).hexdigest()
    return {
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
            "SignedHeaders=x-amz-content-sha256;x-amz-date, "
            f"Signature={sig}"
        ),
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_sha,
    }


class RGWError(Exception):
    pass


def _data_oid(bucket: str, key: str) -> str:
    return f"rgw.obj.{bucket}/{key}"


def _mp_oid(bucket: str) -> str:
    return f"bucket.multipart.{bucket}"


def _part_oid(bucket: str, key: str, upload_id: str, n: int) -> str:
    return f"rgw.part.{bucket}/{key}.{upload_id}.{n:05d}"


class AccessDenied(RGWError):
    pass


class RGW:
    """The gateway daemon: storage logic + embedded HTTP frontend."""

    def __init__(
        self,
        ioctx,
        auth: bool = False,
        bucket_index_shards: int = 1,
        max_objs_per_shard: int | None = None,
        name: str = "rgw",
    ):
        from .index import BucketIndex, build_rgw_perf

        self.io = ioctx
        self.server = None
        self.port = 0
        self.auth = auth
        self.name = name
        self.lc_worker = None
        self.lc_debug = False
        # sharded bucket-index plane (index.py): every index
        # read/write/list below rides it; new buckets default to
        # this many shards (1 = the legacy single-omap layout)
        self.bucket_index_shards = int(bucket_index_shards)
        self.max_objs_per_shard = (
            _default_max_objs_per_shard()
            if max_objs_per_shard is None
            else int(max_objs_per_shard)
        )
        self.perf = build_rgw_perf("rgw")
        self.index = BucketIndex(self)
        # optional mgr progress-event bridge: callable (event_id,
        # message, fraction, done) fed by the reshard state machine
        # (index.py _report_progress); None = no progress reporting
        self.progress_hook = None
        self.reshard_worker = None
        self._mgr_stop = None
        self._mgr_thread = None
        self._mgr_handle = None  # shared-services stack timer
        # set by _verify per call: was the last verified identity a
        # temporary (STS) credential?  Read immediately by the STS
        # route to refuse self-renewal (handler threads each verify
        # right before reading it, so the gap is per-thread-benign —
        # worst case a refused re-mint)
        self._last_caller_temp = False
        # bucket -> (stamp, rules); see cors_match
        self._cors_cache: dict[str, tuple] = {}
        self._datalog_lock = threading.Lock()
        # per-bucket serialization of bucket-record read-modify-
        # writes (ACL/CORS/lifecycle): two handler threads updating
        # different fields of one record would otherwise each
        # read-modify-write the whole JSON blob and silently drop
        # the other's change (the cls_rgw bucket-index op atomicity
        # the omap blob cannot give us)
        self._bucket_locks: dict[str, threading.Lock] = {}
        self._bucket_locks_guard = threading.Lock()
        # LC_OID create-on-first-use: write_full on an existing
        # object wipes its omap, so creation must be serialized or a
        # losing racer erases another bucket's freshly-set rules
        self._lc_lock = threading.Lock()
        self._datalog_seq: int | None = None

    def _bucket_lock(self, bucket: str) -> threading.Lock:
        with self._bucket_locks_guard:
            lock = self._bucket_locks.get(bucket)
            if lock is None:
                lock = self._bucket_locks[bucket] = threading.Lock()
            return lock

    # -- datalog (rgw datalog/mdlog role, feeding multisite.py) ------------
    def _log_change(self, op: str, bucket: str, key: str | None,
                    user) -> None:
        if user == SYNC_USER:
            return
        with self._datalog_lock:
            if self._datalog_seq is None:
                last = 0
                for seq, _e in self.datalog_entries(0):
                    last = seq
                self._datalog_seq = last
            self._datalog_seq += 1
            seq = self._datalog_seq
            # OMAPSET touches the object into existence; no stat dance
            self.io.omap_set(DATALOG_OID, {
                f"e{seq:016d}": json.dumps(
                    {"op": op, "bucket": bucket, "key": key}
                ).encode()
            })

    def datalog_head(self) -> int:
        with self._datalog_lock:
            if self._datalog_seq is not None:
                return self._datalog_seq
        # cold start: walk forward from the beginning once
        last = 0
        for seq, _e in self.datalog_entries(0):
            last = seq
        return last

    def datalog_entries(self, after: int = 0):
        """(seq, entry) in order for every event past ``after`` —
        PAGED from the marker (each poll costs the new entries, not
        the whole history)."""
        marker = f"e{after:016d}" if after else ""
        while True:
            try:
                vals = self.io.omap_get_vals(
                    DATALOG_OID, start_after=marker, max_return=256
                )
            except (ObjectNotFound, RadosError):
                return
            keys = sorted(k for k in vals if k.startswith("e"))
            if not keys:
                return
            for k in keys:
                yield int(k[1:]), json.loads(vals[k])
            marker = keys[-1]

    # -- users / auth (rgw_user + rgw_auth_s3 roles) -----------------------
    def _put_user_key(self, access: str, record: dict) -> None:
        try:
            self.io.stat(USERS_OID)
        except (ObjectNotFound, RadosError):
            self.io.write_full(USERS_OID, b"")
        self.io.omap_set(
            USERS_OID, {access: json.dumps(record).encode()}
        )

    def create_user(self, name: str) -> tuple[str, str]:
        """Provision a user; returns (access_key, secret_key)."""
        import os as _os

        access = _os.urandom(10).hex().upper()
        secret = _os.urandom(20).hex()
        self._put_user_key(
            access, {"name": name, "secret": secret}
        )
        return access, secret

    # -- STS (rgw_sts.cc / rgw_rest_sts.cc reduced) ------------------------
    def assume_role(
        self, user: str, duration: float = 3600.0
    ) -> tuple[str, str, float]:
        """Issue TEMPORARY credentials bound to ``user`` (the
        AssumeRole/GetSessionToken seat): a fresh access/secret pair
        that signs requests exactly like permanent keys but expires.
        Deviations: no role ARNs/policies — the temp identity IS the
        requesting user (GetSessionToken semantics), and the
        response is JSON, not STS XML."""
        import math
        import os as _os

        duration = float(duration)
        if not math.isfinite(duration) or not (
            0 < duration <= 12 * 3600
        ):
            # nan/inf would defeat the expiry compare entirely; STS
            # itself caps sessions at 12h
            raise RGWError(
                "DurationSeconds must be in (0, 43200] (-EINVAL)"
            )
        access = "TEMP" + _os.urandom(8).hex().upper()
        secret = _os.urandom(20).hex()
        expires = time.time() + duration
        self._put_user_key(access, {
            "name": user, "secret": secret, "expires": expires,
        })
        return access, secret, expires

    def _verify(self, method, path, query, headers, payload) -> str:
        """SigV4 verification; returns the user name or raises
        AccessDenied (403)."""
        authz = headers.get("Authorization", "")
        if not authz.startswith("AWS4-HMAC-SHA256 "):
            raise AccessDenied("missing SigV4 authorization")
        fields = {}
        for part in authz[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = part.strip().partition("=")
            fields[k] = v
        try:
            access, date, region, service, term = fields[
                "Credential"
            ].split("/")
        except (KeyError, ValueError):
            raise AccessDenied("malformed credential scope")
        amz_date = headers.get("x-amz-date", "")
        payload_sha = headers.get("x-amz-content-sha256", "")
        if service != "s3" or term != "aws4_request":
            raise AccessDenied("bad credential scope")
        if not amz_date.startswith(date):
            raise AccessDenied("credential date mismatch")
        import calendar

        try:
            then = calendar.timegm(
                time.strptime(amz_date, "%Y%m%dT%H%M%SZ")
            )
        except ValueError:
            raise AccessDenied("bad x-amz-date")
        if abs(time.time() - then) > SKEW:
            raise AccessDenied("request time too skewed")
        if hashlib.sha256(payload).hexdigest() != payload_sha:
            raise AccessDenied("payload hash mismatch")
        try:
            user = json.loads(
                self.io.omap_get_vals(USERS_OID)[access]
            )
        except (KeyError, ObjectNotFound, RadosError):
            raise AccessDenied("unknown access key")
        if "expires" in user and time.time() > float(user["expires"]):
            # expired STS credentials die hard (and get reaped so
            # the user store does not accrete dead keys)
            try:
                self.io.omap_rm_keys(USERS_OID, [access])
            except (ObjectNotFound, RadosError):
                pass
            raise AccessDenied("temporary credentials expired")
        want = sign_request(
            method, path, query, payload, access, user["secret"],
            region=region, amz_date=amz_date,
        )["Authorization"]
        import hmac as hmac_mod

        if not hmac_mod.compare_digest(want, authz):
            raise AccessDenied("signature mismatch")
        self._last_caller_temp = "expires" in user
        return user["name"]

    # -- ACL plumbing (rgw_acl.cc verify_permission seat) ------------------
    @staticmethod
    def _parse_bucket_rec(raw: bytes) -> dict:
        from .index import decode_bucket_record

        try:
            return decode_bucket_record(raw)
        except ValueError:
            # legacy record (bare ctime string): system-owned
            return {"ctime": raw.decode(), "owner": None,
                    "acl": aclmod.make_acl(None)}

    def _bucket_rec(self, bucket: str) -> dict:
        raw = self._buckets().get(bucket)
        if raw is None:
            raise RGWError(f"no bucket {bucket!r}")
        return self._parse_bucket_rec(raw)

    def _save_bucket_rec(self, bucket: str, rec: dict) -> None:
        from .index import encode_bucket_record

        self.io.omap_set(
            BUCKETS_DIR, {bucket: encode_bucket_record(rec)}
        )

    def _require(
        self,
        user,
        perm: str,
        acl: dict | None,
        bucket_owner: str | None = None,
        what: str = "",
    ) -> None:
        if user in (SYSTEM, SYNC_USER):
            return
        if not aclmod.check(acl, user, perm, bucket_owner):
            raise AccessDenied(
                f"{user or 'anonymous'} lacks {perm} on {what}"
            )

    def _require_owner(self, user, rec: dict, what: str) -> None:
        """Owner-only ops (DeleteBucket, lifecycle management): the
        caller must BE the bucket owner — an owner-less (system)
        bucket is manageable only by SYSTEM callers, and anonymous
        NEVER passes (None == None must not authorize)."""
        if user in (SYSTEM, SYNC_USER):
            return
        owner = rec.get("owner")
        if user is None or owner is None or user != owner:
            raise AccessDenied(
                f"{user or 'anonymous'} does not own {what}"
            )

    def set_bucket_acl(
        self, bucket: str, canned: str, user=SYSTEM
    ) -> None:
        with self._bucket_lock(bucket):
            rec = self._bucket_rec(bucket)
            self._require(
                user, aclmod.WRITE_ACP, rec.get("acl"),
                rec.get("owner"), bucket,
            )
            rec["acl"] = aclmod.make_acl(rec.get("owner"), canned)
            self._save_bucket_rec(bucket, rec)
        self._log_change("bucket_acl", bucket, None, user)

    def get_bucket_acl(self, bucket: str, user=SYSTEM) -> dict:
        rec = self._bucket_rec(bucket)
        self._require(
            user, aclmod.READ_ACP, rec.get("acl"),
            rec.get("owner"), bucket,
        )
        return rec.get("acl") or aclmod.make_acl(rec.get("owner"))

    def set_object_acl(
        self, bucket: str, key: str, canned: str, user=SYSTEM
    ) -> None:
        rec = self._bucket_rec(bucket)
        entry = self.stat_object(bucket, key, rec=rec)
        self._require(
            user, aclmod.WRITE_ACP, entry.get("acl"),
            rec.get("owner"), f"{bucket}/{key}",
        )
        entry["acl"] = aclmod.make_acl(entry.get("owner"), canned)
        self.index.set_entry(bucket, key, entry, rec=rec)
        self._log_change("acl", bucket, key, user)

    def get_object_acl(self, bucket: str, key: str, user=SYSTEM) -> dict:
        rec = self._bucket_rec(bucket)
        entry = self.stat_object(bucket, key)
        self._require(
            user, aclmod.READ_ACP, entry.get("acl"),
            rec.get("owner"), f"{bucket}/{key}",
        )
        return entry.get("acl") or aclmod.make_acl(
            entry.get("owner")
        )

    # -- CORS (rgw_cors.cc reduced) ----------------------------------------
    def put_bucket_cors(
        self, bucket: str, rules: list[dict], user=SYSTEM
    ) -> None:
        """Owner-gated CORS configuration: rules of
        {allowed_origins, allowed_methods, allowed_headers?,
        max_age?}; '*' wildcards origins."""
        rec = self._bucket_rec(bucket)
        self._require_owner(user, rec, bucket)
        known = {"GET", "PUT", "POST", "DELETE", "HEAD"}

        def _ok(r):
            import math

            hdrs = r.get("allowed_headers", ["*"]) if isinstance(
                r, dict
            ) else None
            age = r.get("max_age", 600) if isinstance(r, dict) else 0
            return (
                isinstance(r, dict)
                and isinstance(r.get("allowed_origins"), list)
                and r["allowed_origins"]
                and all(
                    isinstance(o, str) for o in r["allowed_origins"]
                )
                and isinstance(r.get("allowed_methods"), list)
                and r["allowed_methods"]
                and set(r["allowed_methods"]) <= known
                # headers/max_age reach ', '.join and str() in the
                # preflight reply: same list-of-strings rule
                and isinstance(hdrs, list)
                and all(isinstance(h, str) for h in hdrs)
                and isinstance(age, (int, float))
                and not isinstance(age, bool)
                and math.isfinite(age)
                and age >= 0
            )

        if not isinstance(rules, list) or not all(
            _ok(r) for r in rules
        ):
            # STRING values would pass a truthiness check and then
            # char/substring-match in cors_match ("GET" in "FORGET",
            # '*' in "*.example") — lists of strings only
            raise RGWError(
                "each CORS rule needs allowed_origins (list of "
                "strings) and allowed_methods (list from "
                "GET/PUT/POST/DELETE/HEAD)"
            )
        with self._bucket_lock(bucket):
            # re-read under the lock: the record checked above may
            # have been rewritten by a concurrent ACL update
            rec = self._bucket_rec(bucket)
            rec["cors"] = rules
            self._save_bucket_rec(bucket, rec)
        self._cors_cache.pop(bucket, None)
        self._log_change("bucket_acl", bucket, None, user)

    def get_bucket_cors(self, bucket: str, user=SYSTEM) -> list:
        rec = self._bucket_rec(bucket)
        self._require_owner(user, rec, bucket)
        return rec.get("cors", [])

    def delete_bucket_cors(self, bucket: str, user=SYSTEM) -> None:
        with self._bucket_lock(bucket):
            rec = self._bucket_rec(bucket)
            self._require_owner(user, rec, bucket)
            rec.pop("cors", None)
            self._save_bucket_rec(bucket, rec)
        self._cors_cache.pop(bucket, None)
        self._log_change("bucket_acl", bucket, None, user)

    def cors_match(
        self, bucket: str, origin: str, method: str
    ) -> dict | None:
        """First rule admitting (origin, method), else None — the
        RGWCORSConfiguration::host_name_rule walk.  Rules read
        through a short-TTL cache: the echo in _reply would
        otherwise double the bucket-record reads on every
        Origin-carrying request (config changes propagate within
        the TTL; browsers cache preflights far longer via max_age)."""
        now = time.monotonic()
        hit = self._cors_cache.get(bucket)
        if hit is not None and now - hit[0] < 5.0:
            rules = hit[1]
        else:
            try:
                rules = self._bucket_rec(bucket).get("cors", [])
            except RGWError:
                rules = []
            self._cors_cache[bucket] = (now, rules)
            if len(self._cors_cache) > 1024:
                self._cors_cache.pop(
                    next(iter(self._cors_cache))
                )
        if not rules:
            return None
        for rule in rules:
            origins = rule.get("allowed_origins", [])
            if not any(
                o == "*" or o == origin for o in origins
            ):
                continue
            if method in rule.get("allowed_methods", []):
                return rule
        return None

    # -- storage logic (rgw_rados roles) -----------------------------------
    def _buckets(self) -> dict[str, bytes]:
        try:
            return self.io.omap_get_vals(BUCKETS_DIR)
        except (ObjectNotFound, RadosError):
            return {}

    def create_bucket(
        self,
        bucket: str,
        user=SYSTEM,
        canned: str = "private",
        shards: int | None = None,
    ) -> None:
        if user is None:
            # S3: bucket creation always needs an authenticated
            # identity — there is no ACL yet to grant it
            raise AccessDenied("anonymous cannot create buckets")
        if "/" in bucket or not bucket:
            raise RGWError(f"invalid bucket name {bucket!r}")
        if bucket in self._buckets():
            raise RGWError(f"bucket {bucket!r} exists")
        owner = None if user == SYSTEM else user
        idx = self.index.create(
            bucket,
            self.bucket_index_shards if shards is None else shards,
        )
        self._save_bucket_rec(
            bucket,
            {
                "ctime": time.time(),
                "owner": owner,
                "acl": aclmod.make_acl(owner, canned),
                "index": idx,
            },
        )
        self._log_change("create_bucket", bucket, None, user)

    def delete_bucket(self, bucket: str, user=SYSTEM) -> None:
        rec = self._bucket_rec(bucket)
        # DeleteBucket is OWNER-only (S3/RGW): a public-read-write
        # WRITE grant covers objects, never the bucket itself
        self._require_owner(user, rec, bucket)
        if self.index.layout(bucket, rec).resharding():
            # deleting mid-reshard would race the migrator's record
            # reads and the cutover cleanup (the reference refuses
            # this too)
            raise RGWError(f"bucket {bucket!r} is resharding")
        # emptiness must consult EVERY shard of the current
        # generation — one empty shard proves nothing
        if self.index.any_entries(bucket, rec=rec):
            raise RGWError(f"bucket {bucket!r} not empty")
        self.index.remove_index(bucket, rec=rec)
        self.io.omap_rm_keys(BUCKETS_DIR, [bucket])
        self.io.omap_rm_keys(LC_OID, [bucket])
        self._log_change("delete_bucket", bucket, None, user)

    def put_object(
        self,
        bucket: str,
        key: str,
        data: bytes,
        user=SYSTEM,
        canned: str = "private",
    ) -> str:
        rec = self._bucket_rec(bucket)
        self._require(
            user, aclmod.WRITE, rec.get("acl"), rec.get("owner"),
            bucket,
        )
        etag = hashlib.md5(data).hexdigest()
        self._drop_object_data(bucket, key)  # stale manifest parts
        self.io.write_full(_data_oid(bucket, key), data)
        owner = None if user in (SYSTEM, None) else user
        # the index entry commits AFTER the data (the reference's
        # prepare/complete index transaction, collapsed)
        self.index.set_entry(
            bucket,
            key,
            {
                "size": len(data),
                "etag": etag,
                "mtime": time.time(),
                "owner": owner,
                "acl": aclmod.make_acl(owner, canned),
            },
            rec=rec,
        )
        self._log_change("put", bucket, key, user)
        return etag

    def get_object(self, bucket: str, key: str, user=SYSTEM) -> bytes:
        rec = self._bucket_rec(bucket)
        entry = self.stat_object(bucket, key)  # -ENOENT via index
        self._require(
            user, aclmod.READ, entry.get("acl"), rec.get("owner"),
            f"{bucket}/{key}",
        )
        if "parts" in entry:
            data = b"".join(
                self.io.read(oid) for oid in entry["parts"]
            )
        else:
            data = self.io.read(
                entry.get("data_oid") or _data_oid(bucket, key)
            )
        codec = entry.get("compression")
        if codec:
            # a lifecycle transition re-wrote the payload through the
            # compressor; reads stay transparent
            from ..compressor import create as compressor_create

            data = compressor_create(codec).decompress(data)
        if len(data) != entry["size"]:
            raise RGWError(f"{bucket}/{key}: torn object")
        return data

    def stat_object(
        self, bucket: str, key: str, rec: dict | None = None
    ) -> dict:
        """Entry lookup via ONE index shard (no longer a full-index
        read — stat cost is independent of bucket size)."""
        raw = self.index.get_entry(bucket, key, rec=rec)
        if raw is None:
            raise ObjectNotFound(f"{bucket}/{key}")
        return json.loads(raw)

    def delete_object(self, bucket: str, key: str, user=SYSTEM) -> None:
        rec = self._bucket_rec(bucket)
        self._require(
            user, aclmod.WRITE, rec.get("acl"), rec.get("owner"),
            bucket,
        )
        self.stat_object(bucket, key, rec=rec)
        self._drop_object_data(bucket, key)
        self.index.rm_entry(bucket, key, rec=rec)
        self._log_change("delete", bucket, key, user)

    # -- lifecycle (rgw_lc.cc reduced; see lifecycle.py) -------------------
    def put_bucket_lifecycle(
        self, bucket: str, rules: list[dict], user=SYSTEM
    ) -> None:
        rec = self._bucket_rec(bucket)
        # S3: only the bucket owner manages lifecycle
        self._require_owner(user, rec, bucket)
        if not isinstance(rules, list):
            raise RGWError("lifecycle config must be a rule list")
        for rule in rules:
            if not isinstance(rule, dict):
                raise RGWError("each lifecycle rule must be an object")
            if (
                "expiration_days" not in rule
                and "transition_days" not in rule
            ):
                raise RGWError("rule needs expiration or transition")
            for f in ("expiration_days", "transition_days"):
                if f in rule:
                    try:
                        float(rule[f])
                    except (TypeError, ValueError):
                        raise RGWError(f"{f} must be numeric")
            if not isinstance(rule.get("prefix", ""), str):
                raise RGWError("prefix must be a string")
        with self._bucket_lock(bucket), self._lc_lock:
            try:
                self.io.stat(LC_OID)
            except (ObjectNotFound, RadosError):
                self.io.write_full(LC_OID, b"")
            self.io.omap_set(
                LC_OID, {bucket: json.dumps(rules).encode()}
            )
        self._log_change("lifecycle", bucket, None, user)

    def get_bucket_lifecycle(self, bucket: str, user=SYSTEM) -> list:
        rec = self._bucket_rec(bucket)
        self._require_owner(user, rec, bucket)
        try:
            raw = self.io.omap_get_vals(LC_OID).get(bucket)
        except (ObjectNotFound, RadosError):
            raw = None
        return json.loads(raw) if raw else []

    def delete_bucket_lifecycle(self, bucket: str, user=SYSTEM) -> None:
        rec = self._bucket_rec(bucket)
        self._require_owner(user, rec, bucket)
        with self._bucket_lock(bucket):
            self.io.omap_rm_keys(LC_OID, [bucket])
        self._log_change("lifecycle", bucket, None, user)

    def lc_process(self, debug: bool | None = None) -> dict:
        """One scan over every configured bucket (RGWLC::process)."""
        debug = self.lc_debug if debug is None else debug
        totals = {"expired": 0, "transitioned": 0}
        try:
            configs = self.io.omap_get_vals(LC_OID)
        except (ObjectNotFound, RadosError):
            return totals
        for bucket, raw in configs.items():
            stats = apply_rules(self, bucket, json.loads(raw), debug)
            for k in totals:
                totals[k] += stats[k]
        return totals

    def _transition_object(
        self, bucket: str, key: str, storage_class: str
    ) -> None:
        """Move an object to the cold tier: recompress the payload
        (zlib — the framework's real second storage tier) and tag
        the entry.  Multipart manifests consolidate to one blob."""
        from ..compressor import create as compressor_create

        entry = self.stat_object(bucket, key)
        data = self.get_object(bucket, key, user=SYSTEM)
        comp = compressor_create("zlib")
        blob = comp.compress(data)
        old_oids = entry.pop("parts", None) or [
            entry.get("data_oid") or _data_oid(bucket, key)
        ]
        # write the cold blob to a NEW oid, flip the index entry to
        # it, THEN drop the old payload: a concurrent reader holding
        # either entry version reads a consistent (oid, entry) pair —
        # only a reader stale across the final delete sees a
        # transient miss, never a torn object
        cold_oid = _data_oid(bucket, key) + "#cold"
        self.io.write_full(cold_oid, blob)
        entry["data_oid"] = cold_oid
        entry["storage_class"] = storage_class
        entry["compression"] = "zlib"
        self.index.set_entry(bucket, key, entry)
        self._log_change("transition", bucket, key, None)
        for oid in old_oids:
            if oid == cold_oid:
                continue
            try:
                self.io.remove(oid)
            except (ObjectNotFound, RadosError):
                pass

    def start_lc(
        self, interval: float = 1.0, debug: bool = False
    ) -> None:
        """Run the lifecycle worker (RGWLC::start_processor);
        ``debug`` makes *_days count seconds (rgw_lc_debug_interval)."""
        self.lc_debug = debug
        if self.lc_worker is None:
            self.lc_worker = LCWorker(self, interval, debug)

    # -- multipart (rgw multipart manifest role) ---------------------------
    def initiate_multipart(
        self, bucket: str, key: str, user=SYSTEM
    ) -> str:
        rec = self._bucket_rec(bucket)
        self._require(
            user, aclmod.WRITE, rec.get("acl"), rec.get("owner"),
            bucket,
        )
        import os as _os

        upload_id = _os.urandom(8).hex()
        try:
            self.io.stat(_mp_oid(bucket))
        except (ObjectNotFound, RadosError):
            self.io.write_full(_mp_oid(bucket), b"")
        self.io.omap_set(
            _mp_oid(bucket),
            {f"{key}.{upload_id}": b"open"},
        )
        return upload_id

    def _mp_check(self, bucket: str, key: str, upload_id: str) -> None:
        try:
            vals = self.io.omap_get_vals(_mp_oid(bucket))
        except (ObjectNotFound, RadosError):
            vals = {}
        if f"{key}.{upload_id}" not in vals:
            raise RGWError(f"no such upload {upload_id!r}")

    def _mp_parts(
        self, bucket: str, key: str, upload_id: str
    ) -> dict[int, dict]:
        prefix = f"{key}.{upload_id}.part."
        try:
            vals = self.io.omap_get_vals(_mp_oid(bucket))
        except (ObjectNotFound, RadosError):
            vals = {}
        return {
            int(k[len(prefix):]): json.loads(v)
            for k, v in vals.items()
            if k.startswith(prefix)
        }

    def upload_part(
        self, bucket: str, key: str, upload_id: str, part: int,
        data: bytes, user=SYSTEM,
    ) -> str:
        rec = self._bucket_rec(bucket)
        self._require(
            user, aclmod.WRITE, rec.get("acl"), rec.get("owner"),
            bucket,
        )
        if not 1 <= part <= 10000:
            raise RGWError("part number out of range")
        self._mp_check(bucket, key, upload_id)
        etag = hashlib.md5(data).hexdigest()
        self.io.write_full(
            _part_oid(bucket, key, upload_id, part), data
        )
        # ONE omap key per part: concurrent part uploads (the S3
        # client default) never read-modify-write shared state
        self.io.omap_set(
            _mp_oid(bucket),
            {
                f"{key}.{upload_id}.part.{part:05d}": json.dumps(
                    {"etag": etag, "size": len(data)}
                ).encode()
            },
        )
        return etag

    def complete_multipart(
        self, bucket: str, key: str, upload_id: str, user=SYSTEM
    ) -> str:
        """Write the manifest HEAD: the object's index entry points
        at the part objects (no data copy), with the S3-shaped
        composite '-N' etag."""
        rec = self._bucket_rec(bucket)
        self._require(
            user, aclmod.WRITE, rec.get("acl"), rec.get("owner"),
            bucket,
        )
        self._mp_check(bucket, key, upload_id)
        by_num = self._mp_parts(bucket, key, upload_id)
        if not by_num:
            raise RGWError("no parts uploaded")
        parts = sorted(by_num.items())
        md5s = b"".join(
            bytes.fromhex(meta["etag"]) for _n, meta in parts
        )
        etag = (
            hashlib.md5(md5s).hexdigest() + f"-{len(parts)}"
        )
        self._drop_object_data(bucket, key)  # overwrite semantics
        owner = None if user in (SYSTEM, None) else user
        self.index.set_entry(
            bucket,
            key,
            {
                "size": sum(m["size"] for _n, m in parts),
                "etag": etag,
                "mtime": time.time(),
                "owner": owner,
                "acl": aclmod.make_acl(owner),
                "parts": [
                    _part_oid(bucket, key, upload_id, n)
                    for n, _m in parts
                ],
            },
            rec=rec,
        )
        self.io.omap_rm_keys(
            _mp_oid(bucket),
            [f"{key}.{upload_id}"]
            + [
                f"{key}.{upload_id}.part.{n:05d}"
                for n, _m in parts
            ],
        )
        self._log_change("put", bucket, key, user)
        return etag

    def abort_multipart(
        self, bucket: str, key: str, upload_id: str, user=SYSTEM
    ) -> None:
        rec = self._bucket_rec(bucket)
        self._require(
            user, aclmod.WRITE, rec.get("acl"), rec.get("owner"),
            bucket,
        )
        self._mp_check(bucket, key, upload_id)
        by_num = self._mp_parts(bucket, key, upload_id)
        for n in by_num:
            try:
                self.io.remove(_part_oid(bucket, key, upload_id, n))
            except (ObjectNotFound, RadosError):
                pass
        self.io.omap_rm_keys(
            _mp_oid(bucket),
            [f"{key}.{upload_id}"]
            + [
                f"{key}.{upload_id}.part.{n:05d}" for n in by_num
            ],
        )

    def _drop_object_data(self, bucket: str, key: str) -> None:
        """Remove an existing entry's payload (plain or manifest)."""
        try:
            entry = self.stat_object(bucket, key)
        except ObjectNotFound:
            return
        oids = entry.get("parts") or [
            entry.get("data_oid") or _data_oid(bucket, key)
        ]
        for oid in oids:
            try:
                self.io.remove(oid)
            except (ObjectNotFound, RadosError):
                pass

    def list_objects(
        self,
        bucket: str,
        marker: str = "",
        max_keys: int = 1000,
        user=SYSTEM,
    ) -> tuple[list[dict], bool]:
        """Key-ordered page after ``marker`` → (entries, truncated):
        k-way merge-sorted across the bucket's index shards —
        byte-identical to the single-omap listing (see index.py)."""
        rec = self._bucket_rec(bucket)
        self._require(
            user, aclmod.READ, rec.get("acl"), rec.get("owner"),
            bucket,
        )
        page, truncated = self.index.list_page(
            bucket, marker=marker, max_keys=max_keys, rec=rec
        )
        out = []
        for k, raw in page:
            entry = json.loads(raw)
            entry["key"] = k
            out.append(entry)
        return out, truncated

    # -- reshard admin (radosgw-admin bucket reshard roles) ----------------
    def bucket_reshard(
        self, bucket: str, num_shards: int, user=SYSTEM
    ) -> dict:
        """``bucket reshard --num-shards N``: online reshard, owner/
        system only (an index relayout is an administrative act)."""
        rec = self._bucket_rec(bucket)
        self._require_owner(user, rec, bucket)
        return self.index.reshard(bucket, num_shards)

    def reshard_status(self, bucket: str, user=SYSTEM) -> dict:
        """``reshard status --bucket B``."""
        rec = self._bucket_rec(bucket)
        self._require_owner(user, rec, bucket)
        return self.index.status(bucket)

    def reshard_list(self, user=SYSTEM) -> list[dict]:
        """``reshard list``: the pending reshard queue."""
        if user not in (SYSTEM, SYNC_USER):
            raise AccessDenied("reshard list is admin-only")
        return self.index.reshard_queue()

    def reshard_process(self, user=SYSTEM) -> int:
        """``reshard process``: drain the queue now."""
        if user not in (SYSTEM, SYNC_USER):
            raise AccessDenied("reshard process is admin-only")
        return self.index.process_reshard_queue()

    def start_reshard(self, interval: float = 2.0) -> None:
        """Run the background reshard worker (RGWReshard's
        processor thread)."""
        from .index import ReshardWorker

        if self.reshard_worker is None:
            self.reshard_worker = ReshardWorker(self, interval)

    # -- mgr telemetry (perf → MMgrReport → prometheus) --------------------
    def _mgr_report_once(self, state: dict) -> None:
        """One best-effort perf push: discover the active mgr
        through the mon (cached, slow cadence) and send an
        MMgrReport — the exact pipe every daemon's counters ride."""
        from ..msg.message import MMgrReport

        rados = self.io.rados
        now = time.monotonic()
        if state.get("addr") is None and (
            now - state.get("checked", -1e9) < 5.0
        ):
            return
        try:
            if (
                state.get("addr") is None
                or now - state.get("checked", -1e9) > 5.0
            ):
                state["checked"] = now
                rc, outb, _outs = rados.mon_command(
                    {"prefix": "mgr stat"}
                )
                active = (
                    json.loads(outb).get("active") if rc == 0 else None
                )
                addr = active["addr"] if active else None
                if addr != state.get("addr"):
                    state["addr"] = addr
                    state["conn"] = None
            if state.get("addr") is None:
                return
            conn = state.get("conn")
            if conn is None or conn.is_closed:
                host, _, port = state["addr"].rpartition(":")
                conn = state["conn"] = rados.messenger.connect(
                    host, int(port), timeout=5.0
                )
            conn.send(
                MMgrReport(
                    daemon=self.name,
                    perf=json.dumps(self.perf.dump()),
                )
            )
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            state["conn"] = None

    def start_mgr_reports(
        self,
        interval: float = 1.0,
        shared_services: bool | None = None,
    ) -> None:
        """Push ``l_rgw_index_*``/``l_rgw_reshard_*`` to the mgr on
        a timer, like an OSD's stats plane.  With ``shared_services``
        the push rides a shared-stack timer instead of a dedicated
        thread (the PR 14 treatment)."""
        if self._mgr_thread is not None or self._mgr_handle is not None:
            return
        state: dict = {}
        if shared_services:
            stack = self.io.rados.messenger._stack
            self._mgr_handle = stack.timers.every(
                interval, lambda: self._mgr_report_once(state)
            )
            return
        self._mgr_stop = threading.Event()

        def loop():
            while not self._mgr_stop.wait(interval):
                self._mgr_report_once(state)

        self._mgr_thread = threading.Thread(
            target=loop, name=f"{self.name}.mgrreport", daemon=True
        )
        self._mgr_thread.start()

    # -- HTTP frontend (the beast role) ------------------------------------
    def serve(self, port: int = 0) -> int:
        gw = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, code, body=b"", ctype="application/xml",
                       headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                headers = dict(headers or {})
                # CORS echo on EVERY response (success AND error —
                # a browser cannot read an un-echoed 403) for the
                # actual request's method; explicit headers win
                if (
                    "Access-Control-Allow-Origin" not in headers
                    and self.headers.get("Origin")
                    and self.command != "OPTIONS"
                ):
                    headers.update(self._cors_headers(
                        self._route()[0], self.command
                    ))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _err(self, code, name, msg):
                if self.command == "HEAD":
                    # HEAD responses must not carry a body or the
                    # keep-alive stream desyncs
                    self._reply(code)
                    return
                body = (
                    f"<Error><Code>{name}</Code>"
                    f"<Message>{escape(msg)}</Message></Error>"
                ).encode()
                self._reply(code, body)

            def _route(self):
                parsed = urllib.parse.urlparse(self.path)
                parts = parsed.path.strip("/").split("/", 1)
                bucket = parts[0] if parts[0] else None
                key = parts[1] if len(parts) > 1 else None
                q = dict(
                    urllib.parse.parse_qsl(
                        parsed.query, keep_blank_values=True
                    )
                )
                return bucket, key, q

            def _body(self) -> bytes:
                length = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(length) if length else b""

            def _user(self, method, payload):
                """Request identity: SYSTEM when the gateway runs
                authless, the verified user for a signed request,
                None for an ANONYMOUS one (no Authorization header —
                the ACLs decide what it may do), or _DENIED (403
                already sent) on a bad signature."""
                if not gw.auth:
                    return SYSTEM
                if not self.headers.get("Authorization"):
                    return None
                parsed = urllib.parse.urlparse(self.path)
                q = dict(
                    urllib.parse.parse_qsl(
                        parsed.query, keep_blank_values=True
                    )
                )
                try:
                    return gw._verify(
                        method, parsed.path, q,
                        {
                            k.lower() if k.lower().startswith("x-amz")
                            else k: v
                            for k, v in self.headers.items()
                        },
                        payload,
                    )
                except AccessDenied as e:
                    self._err(403, "AccessDenied", str(e))
                    return _DENIED

            def do_OPTIONS(self):  # noqa: N802
                """CORS preflight (RGWHandler preflight dispatch)."""
                bucket, _key, _q = self._route()
                origin = self.headers.get("Origin", "")
                want = self.headers.get(
                    "Access-Control-Request-Method", ""
                )
                rule = (
                    gw.cors_match(bucket, origin, want)
                    if bucket and origin and want
                    else None
                )
                if rule is None:
                    self._reply(403)
                    return
                self._reply(200, b"", headers={
                    "Access-Control-Allow-Origin": origin,
                    "Access-Control-Allow-Methods": ", ".join(
                        rule.get("allowed_methods", [])
                    ),
                    "Access-Control-Allow-Headers": ", ".join(
                        rule.get("allowed_headers", ["*"])
                    ),
                    "Access-Control-Max-Age": str(
                        rule.get("max_age", 600)
                    ),
                })

            def _cors_headers(self, bucket, method) -> dict:
                """Actual-request CORS echo: attach Allow-Origin when
                a rule admits this (Origin, method)."""
                origin = self.headers.get("Origin", "")
                if not bucket or not origin:
                    return {}
                rule = gw.cors_match(bucket, origin, method)
                if rule is None:
                    return {}
                return {"Access-Control-Allow-Origin": origin}

            def do_GET(self):  # noqa: N802
                bucket, key, q = self._route()
                user = self._user("GET", b"")
                if user is _DENIED:
                    return
                try:
                    if bucket is not None and key is None and (
                        "cors" in q
                    ):
                        self._reply(
                            200,
                            json.dumps(
                                gw.get_bucket_cors(bucket, user=user)
                            ).encode(),
                            ctype="application/json",
                        )
                    elif bucket is not None and "acl" in q:
                        policy = (
                            gw.get_bucket_acl(bucket, user=user)
                            if key is None
                            else gw.get_object_acl(
                                bucket, key, user=user
                            )
                        )
                        self._reply(
                            200, json.dumps(policy).encode(),
                            ctype="application/json",
                        )
                    elif bucket is not None and key is None and (
                        "lifecycle" in q
                    ):
                        rules = gw.get_bucket_lifecycle(
                            bucket, user=user
                        )
                        self._reply(
                            200, json.dumps(rules).encode(),
                            ctype="application/json",
                        )
                    elif bucket is None:
                        if user is None:
                            raise AccessDenied(
                                "anonymous cannot list buckets"
                            )
                        names = sorted(
                            b for b, raw in gw._buckets().items()
                            if user == SYSTEM
                            or gw._parse_bucket_rec(raw).get(
                                "owner"
                            ) == user
                        )
                        inner = "".join(
                            f"<Bucket><Name>{escape(n)}</Name></Bucket>"
                            for n in names
                        )
                        self._reply(
                            200,
                            (
                                "<ListAllMyBucketsResult><Buckets>"
                                f"{inner}</Buckets>"
                                "</ListAllMyBucketsResult>"
                            ).encode(),
                        )
                    elif key is None:
                        entries, trunc = gw.list_objects(
                            bucket,
                            marker=q.get("marker", ""),
                            max_keys=int(q.get("max-keys", 1000)),
                            user=user,
                        )
                        inner = "".join(
                            "<Contents>"
                            f"<Key>{escape(e['key'])}</Key>"
                            f"<Size>{e['size']}</Size>"
                            f"<ETag>\"{e['etag']}\"</ETag>"
                            "</Contents>"
                            for e in entries
                        )
                        self._reply(
                            200,
                            (
                                "<ListBucketResult>"
                                f"<Name>{escape(bucket)}</Name>"
                                f"<IsTruncated>{str(trunc).lower()}"
                                f"</IsTruncated>{inner}"
                                "</ListBucketResult>"
                            ).encode(),
                        )
                    else:
                        data = gw.get_object(bucket, key, user=user)
                        self._reply(
                            200, data,
                            ctype="application/octet-stream",
                        )
                except AccessDenied as e:
                    self._err(403, "AccessDenied", str(e))
                except ObjectNotFound as e:
                    self._err(404, "NoSuchKey", str(e))
                except RGWError as e:
                    self._err(404, "NoSuchBucket", str(e))

            def do_HEAD(self):  # noqa: N802
                bucket, key, _q = self._route()
                user = self._user("HEAD", b"")
                if user is _DENIED:
                    return
                try:
                    rec = gw._bucket_rec(bucket)
                    entry = gw.stat_object(bucket, key)
                    gw._require(
                        user, aclmod.READ, entry.get("acl"),
                        rec.get("owner"), f"{bucket}/{key}",
                    )
                    self._reply(
                        200, b"",
                        headers={
                            "ETag": f'"{entry["etag"]}"',
                            "X-Object-Size": str(entry["size"]),
                        },
                    )
                except AccessDenied:
                    self._reply(403)
                except (ObjectNotFound, RGWError):
                    self._reply(404)

            def do_PUT(self):  # noqa: N802
                bucket, key, q = self._route()
                body = self._body()
                user = self._user("PUT", body)
                if user is _DENIED:
                    return
                canned = self.headers.get("x-amz-acl", "private")
                try:
                    if bucket is not None and "acl" in q:
                        if key is None:
                            gw.set_bucket_acl(
                                bucket, canned, user=user
                            )
                        else:
                            gw.set_object_acl(
                                bucket, key, canned, user=user
                            )
                        self._reply(200)
                    elif bucket is not None and key is None and (
                        "cors" in q
                    ):
                        gw.put_bucket_cors(
                            bucket, json.loads(body), user=user
                        )
                        self._reply(200)
                    elif bucket is not None and key is None and (
                        "lifecycle" in q
                    ):
                        gw.put_bucket_lifecycle(
                            bucket, json.loads(body), user=user
                        )
                        self._reply(200)
                    elif key is not None and "uploadId" in q:
                        try:
                            part = int(q.get("partNumber", 0))
                        except ValueError:
                            raise RGWError("bad partNumber")
                        etag = gw.upload_part(
                            bucket, key, q["uploadId"], part, body,
                            user=user,
                        )
                        self._reply(
                            200, b"", headers={"ETag": f'"{etag}"'}
                        )
                    elif key is None:
                        gw.create_bucket(
                            bucket, user=user, canned=canned
                        )
                        self._reply(200)
                    else:
                        etag = gw.put_object(
                            bucket, key, body, user=user,
                            canned=canned,
                        )
                        self._reply(
                            200, b"", headers={"ETag": f'"{etag}"'}
                        )
                except AccessDenied as e:
                    self._err(403, "AccessDenied", str(e))
                except (ValueError, KeyError) as e:
                    self._err(400, "MalformedRequest", str(e))
                except RGWError as e:
                    self._err(409, "BucketError", str(e))

            def do_POST(self):  # noqa: N802
                bucket, key, q = self._route()
                body = self._body()
                user = self._user("POST", body)
                if user is _DENIED:
                    return
                try:
                    if bucket is None and q.get("Action") in (
                        "AssumeRole", "GetSessionToken"
                    ):
                        if user is None:
                            self._err(
                                403, "AccessDenied",
                                "STS needs an authenticated caller",
                            )
                            return
                        if gw._last_caller_temp:
                            # session credentials may not self-renew
                            # (real STS rejects this too) — a leaked
                            # short-lived key must actually die
                            self._err(
                                403, "AccessDenied",
                                "temporary credentials cannot call STS",
                            )
                            return
                        try:
                            dur = float(
                                q.get("DurationSeconds", 3600)
                            )
                        except ValueError:
                            self._err(
                                400, "MalformedRequest",
                                "bad DurationSeconds",
                            )
                            return
                        acc, sec, exp = gw.assume_role(user, dur)
                        self._reply(
                            200,
                            json.dumps({
                                "AccessKeyId": acc,
                                "SecretAccessKey": sec,
                                "Expiration": exp,
                            }).encode(),
                            ctype="application/json",
                        )
                    elif key is not None and "uploads" in q:
                        upload_id = gw.initiate_multipart(
                            bucket, key, user=user
                        )
                        self._reply(
                            200,
                            (
                                "<InitiateMultipartUploadResult>"
                                f"<Bucket>{escape(bucket)}</Bucket>"
                                f"<Key>{escape(key)}</Key>"
                                f"<UploadId>{upload_id}</UploadId>"
                                "</InitiateMultipartUploadResult>"
                            ).encode(),
                        )
                    elif key is not None and "uploadId" in q:
                        etag = gw.complete_multipart(
                            bucket, key, q["uploadId"], user=user
                        )
                        self._reply(
                            200,
                            (
                                "<CompleteMultipartUploadResult>"
                                f"<ETag>\"{etag}\"</ETag>"
                                "</CompleteMultipartUploadResult>"
                            ).encode(),
                        )
                    else:
                        self._err(400, "InvalidRequest", "bad POST")
                except AccessDenied as e:
                    self._err(403, "AccessDenied", str(e))
                except RGWError as e:
                    self._err(409, "UploadError", str(e))

            def do_DELETE(self):  # noqa: N802
                bucket, key, q = self._route()
                user = self._user("DELETE", b"")
                if user is _DENIED:
                    return
                try:
                    if key is not None and "uploadId" in q:
                        gw.abort_multipart(
                            bucket, key, q["uploadId"], user=user
                        )
                    elif key is None and "cors" in q:
                        gw.delete_bucket_cors(bucket, user=user)
                    elif key is None and "lifecycle" in q:
                        gw.delete_bucket_lifecycle(bucket, user=user)
                    elif key is None:
                        gw.delete_bucket(bucket, user=user)
                    else:
                        gw.delete_object(bucket, key, user=user)
                    self._reply(204)
                except AccessDenied as e:
                    self._err(403, "AccessDenied", str(e))
                except ObjectNotFound as e:
                    self._err(404, "NoSuchKey", str(e))
                except RGWError as e:
                    self._err(409, "BucketError", str(e))

        self.server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self.port = self.server.server_address[1]
        threading.Thread(
            target=self.server.serve_forever,
            name="rgw.frontend",
            daemon=True,
        ).start()
        return self.port

    def shutdown(self) -> None:
        if self.lc_worker is not None:
            self.lc_worker.stop()
            self.lc_worker = None
        if self.reshard_worker is not None:
            self.reshard_worker.stop()
            self.reshard_worker = None
        if self._mgr_stop is not None:
            self._mgr_stop.set()
            self._mgr_thread.join(timeout=5)
            self._mgr_stop = None
            self._mgr_thread = None
        if self._mgr_handle is not None:
            self._mgr_handle.cancel()
            self._mgr_handle = None
        if self.server is not None:
            self.server.shutdown()
