"""Scrub maps and their comparison — the replica half of deep scrub
(src/osd/scrubber/: ScrubMap, ScrubStore, be_compare_scrubmaps).

Shape vs the reference:

- ``build_scrub_map`` is one daemon's digest map over a chunk of
  objects: size + omap/xattr digests always, payload checksums when
  ``deep`` — batched per chunk through
  ``ops/scrub_kernels.batch_crc32c`` on ``device`` (default ``cuda``;
  one device call per daemon per chunk instead of the reference's
  per-object CPU loop; a device failure raises).
- Erasure pools audit each shard's crc against the object's stored
  HashInfo (``compare_ec``); overwritten objects (hinfo invalidated,
  matching the reference's ec_overwrites semantics) report that they
  need a decode + re-encode compare.  Replicated pools compare by
  digest majority (``compare_replicated``).
- Findings persist as omap records on a per-PG ``_scrub_`` object
  (``ScrubStore``) in the ``rados list-inconsistent-obj`` shape
  (``make_record``).

``Scrubber`` is the per-OSD scrub engine the daemon (``osd/daemon.py``)
drives: the primary scrubs in chunks of objects and yields the worker
between chunks, replicas answer ``MRepScrub`` reserve/release, ``ls`` and
``scan`` rounds with ``MScrubMap``, and repair pushes the authoritative
copy through the recovery push and re-verifies.  Every scrub map, crc
and compare runs on the daemon's ``device``.
"""

from __future__ import annotations

import json
import time

from ..common.log import dout
from ..ec.interface import ErasureCodeError
from ..msg import MessageError
from ..msg.message import MPGPull, MPGPush, MRepScrub, MScrubMap
from ..native import ceph_crc32c
from ..ops.scrub_kernels import batch_compare, batch_crc32c
from ..store.ec_store import HINFO_KEY
from ..store.objectstore import StoreError, Transaction

# the per-PG scrub metadata object: inconsistency records live in its
# omap (the ScrubStore's OMAP_DIR), outside the OBJ_PREFIX namespace
# so listings and client ops never see it
SCRUB_META = "_scrub_"
REC_PREFIX = "inc_"

# attrs excluded from the xattr digest: t_dirty is cleared locally
# only (cache-tier flush), hinfo is audited separately per shard
VOLATILE_ATTRS = frozenset({"t_dirty", HINFO_KEY})

# the digest seed (the reference's data_digest crc32c(-1) convention,
# shared with the EC HashInfo cumulative seeds)
DIGEST_SEED = 0xFFFFFFFF

# shard/object error vocabulary (rados list-inconsistent-obj codes)
ERR_MISSING = "missing"
ERR_SIZE = "size_mismatch"
ERR_DATA = "data_digest_mismatch"
ERR_OMAP = "omap_digest_mismatch"
ERR_ATTR = "attr_digest_mismatch"
ERR_EC_HASH = "ec_hash_mismatch"
ERR_EC_SIZE = "ec_size_mismatch"
ERR_READ = "read_error"
ERR_INCONSISTENT = "inconsistent"
KNOWN_ERRORS = frozenset(
    {
        ERR_MISSING, ERR_SIZE, ERR_DATA, ERR_OMAP, ERR_ATTR,
        ERR_EC_HASH, ERR_EC_SIZE, ERR_READ, ERR_INCONSISTENT,
    }
)


def _digest(parts: dict[str, bytes]) -> int:
    """Canonical crc32c over sorted (key, value) pairs."""
    crc = DIGEST_SEED
    for key in sorted(parts):
        crc = ceph_crc32c(crc, key.encode() + b"\0")
        crc = ceph_crc32c(crc, bytes(parts[key]) + b"\0")
    return crc


def _resident(store, cid: str, oid: str, expect_len=None):
    """Generation-checked residency lookup (ops/residency.py): a hit
    is the payload the last committed txn landed, already on device —
    the deep-scrub digest of a freshly written object costs zero
    host→device transfer.  Only scrub-trusted stores are consulted:
    proxies mutate out of our sight, and persistent media (whose
    out-of-band bit rot is exactly what deep scrub audits) must be
    READ, never served from cache."""
    from ..ops.residency import residency_cache, scrub_trusted

    if not scrub_trusted(store):
        return None
    return residency_cache().get(store, cid, oid, expect_len=expect_len)


def build_scrub_map(
    store,
    cid: str,
    oids,
    deep: bool,
    with_hinfo: bool = False,
    device="cuda",
) -> dict[str, dict]:
    """One daemon's digest map over a chunk of store oids (the
    ScrubMap role, src/osd/scrubber_common.h): size + omap/xattr
    digests always, payload crc32c when ``deep`` (ALL payloads of the
    chunk in one batched device call; device-RESIDENT payloads — the
    bytes the EC/replicated write path just committed — digest with
    no re-upload).  The crcs run on ``device``."""
    out: dict[str, dict] = {}
    datas: list[bytes] = []
    data_oids: list[str] = []
    for oid in oids:
        try:
            if not store.exists(cid, oid):
                out[oid] = {"exists": False}
                continue
            attrs = store.list_attrs(cid, oid)
            try:
                omap = store.omap_get(cid, oid)
            except StoreError:
                omap = {}
            ent: dict = {
                "exists": True,
                "size": store.stat(cid, oid),
                # omap cardinality feeds the LARGE_OMAP_OBJECTS
                # deep-scrub check (the bucket-index hot-spot signal)
                "omap_keys": len(omap),
                "omap_digest": _digest(omap),
                "attrs_digest": _digest(
                    {
                        k: v
                        for k, v in attrs.items()
                        if k not in VOLATILE_ATTRS
                    }
                ),
            }
            if with_hinfo:
                try:
                    ent["hinfo"] = json.loads(attrs[HINFO_KEY])
                except (KeyError, ValueError):
                    ent["hinfo"] = None
            if deep:
                buf = _resident(store, cid, oid, ent["size"])
                datas.append(
                    buf if buf is not None else store.read(cid, oid)
                )
                data_oids.append(oid)
            out[oid] = ent
        except StoreError:
            out[oid] = {"exists": True, "error": ERR_READ}
    if datas:
        for oid, crc in zip(
            data_oids, batch_crc32c(datas, DIGEST_SEED, device=device)
        ):
            out[oid]["data_digest"] = int(crc)
    return out


class ScrubStore:
    """Inconsistency records persisted in the PG's ``_scrub_`` omap
    (src/osd/scrubber/ScrubStore.cc): written by the scrub that found
    them, served by ``rados list-inconsistent-obj``, cleared by the
    scrub/repair that no longer reproduces them."""

    @staticmethod
    def save(store, cid: str, records: list[dict]) -> None:
        txn = Transaction().touch(cid, SCRUB_META)
        txn.omap_clear(cid, SCRUB_META)
        if records:
            txn.omap_setkeys(
                cid,
                SCRUB_META,
                {
                    REC_PREFIX
                    + rec["object"]["name"]: json.dumps(
                        rec, sort_keys=True
                    ).encode()
                    for rec in records
                },
            )
        store.queue_transaction(txn)

    @staticmethod
    def load(store, cid: str) -> list[dict]:
        try:
            kv = store.omap_get(cid, SCRUB_META)
        except StoreError:
            return []
        out = []
        for key in sorted(kv):
            if not key.startswith(REC_PREFIX):
                continue
            try:
                rec = json.loads(kv[key])
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    @staticmethod
    def clear(store, cid: str) -> None:
        try:
            store.queue_transaction(
                Transaction()
                .touch(cid, SCRUB_META)
                .omap_clear(cid, SCRUB_META)
            )
        except StoreError:
            pass


def make_record(
    oid: str,
    shards: list[dict],
    errors: list[str],
    selected: dict | None = None,
) -> dict:
    """One inconsistency record in the ``rados list-inconsistent-obj``
    shape (src/include/rados/rados_types.hpp obj_err_t), with the
    compact legacy keys (oid/osd/corrupt/missing) the daemon's
    ``pg.scrub_errors`` consumers already read."""
    union = sorted(
        {e for sh in shards for e in sh.get("errors", ())}
    )
    bad = [sh for sh in shards if sh.get("errors")]
    rec = {
        "object": {"name": oid, "nspace": "", "snap": "head"},
        "errors": sorted(set(errors) | set(union)),
        "union_shard_errors": union,
        "selected_object_info": selected,
        "shards": shards,
        # legacy compact keys
        "oid": oid,
        "osd": bad[0]["osd"] if bad else -1,
        "missing": [
            sh.get("shard", sh["osd"])
            for sh in shards
            if ERR_MISSING in sh.get("errors", ())
        ],
        "corrupt": [
            sh.get("shard", sh["osd"])
            for sh in shards
            if {ERR_DATA, ERR_EC_HASH, ERR_EC_SIZE}
            & set(sh.get("errors", ()))
        ],
        "inconsistent": ERR_INCONSISTENT in errors,
    }
    return rec


def compare_replicated(
    oid: str, maps: dict[int, dict], primary: int, deep: bool
) -> dict | None:
    """Compare one object's per-osd scrub-map entries; returns an
    inconsistency record or None.  Authoritative selection is digest
    majority (ties break toward the group holding the primary, then
    the lowest osd) — the be_select_auth_object seat."""
    present = {
        osd: ent
        for osd, ent in maps.items()
        if ent is not None and ent.get("exists")
    }
    if not present:
        return None  # nobody holds it (fully deleted): not an error

    def key_of(ent):
        fields = [ent.get("size"), ent.get("omap_digest"),
                  ent.get("attrs_digest")]
        if deep:
            fields.append(ent.get("data_digest"))
        return tuple(fields)

    groups: dict[tuple, list[int]] = {}
    for osd, ent in present.items():
        if ent.get("error"):
            continue
        groups.setdefault(key_of(ent), []).append(osd)
    if not groups:
        auth_osd, auth_key = primary, None
    else:
        def rank(item):
            key, members = item
            return (
                len(members),
                primary in members,
                -min(members),
            )

        auth_key, members = max(groups.items(), key=rank)
        auth_osd = primary if primary in members else min(members)
    auth = present.get(auth_osd)
    shards = []
    clean = True
    for osd, ent in sorted(maps.items()):
        sh = {"osd": osd, "shard": -1, "errors": []}
        if ent is None:
            # unreachable peer: not scrubbed, not an inconsistency
            continue
        if not ent.get("exists"):
            sh["errors"].append(ERR_MISSING)
        elif ent.get("error"):
            sh["errors"].append(ent["error"])
        else:
            sh["size"] = ent.get("size")
            sh["omap_digest"] = ent.get("omap_digest")
            sh["attrs_digest"] = ent.get("attrs_digest")
            if deep:
                sh["data_digest"] = ent.get("data_digest")
            if auth is not None and ent is not auth:
                if ent.get("size") != auth.get("size"):
                    sh["errors"].append(ERR_SIZE)
                if deep and ent.get("data_digest") != auth.get(
                    "data_digest"
                ):
                    sh["errors"].append(ERR_DATA)
                if ent.get("omap_digest") != auth.get("omap_digest"):
                    sh["errors"].append(ERR_OMAP)
                if ent.get("attrs_digest") != auth.get(
                    "attrs_digest"
                ):
                    sh["errors"].append(ERR_ATTR)
        if sh["errors"]:
            clean = False
        shards.append(sh)
    if clean:
        return None
    selected = None
    if auth is not None:
        selected = {
            "osd": auth_osd,
            "size": auth.get("size"),
            "data_digest": auth.get("data_digest"),
        }
    rec = make_record(oid, shards, [], selected)
    # legacy peer-vs-primary fields the seed tests read
    pri = maps.get(primary) or {}
    rec["primary_crc"] = pri.get("data_digest")
    bad = [sh for sh in shards if sh["errors"]]
    if bad:
        peer = maps.get(bad[0]["osd"]) or {}
        rec["peer_crc"] = peer.get("data_digest")
    return rec


def compare_ec(
    oid: str,
    maps: dict[int, dict],
    acting: list[int],
    sinfo,
    deep: bool,
) -> tuple[dict | None, bool]:
    """Compare one EC object's per-position shard entries against the
    stored HashInfo.  Returns (record | None, needs_reencode): when
    the hinfo carries no per-shard hashes (partial overwrite
    invalidated it, the reference's ec_overwrites behavior) a deep
    scrub must fall back to decode + re-encode — the caller runs that
    batched."""
    by_pos = {
        pos: maps.get(osd)
        for pos, osd in enumerate(acting)
    }
    present = {
        pos: ent
        for pos, ent in by_pos.items()
        if ent is not None and ent.get("exists")
    }
    if not present:
        return None, False
    # authoritative hinfo: the value most shards agree on
    votes: dict[str, list[int]] = {}
    for pos, ent in present.items():
        hinfo = ent.get("hinfo")
        if hinfo is not None:
            votes.setdefault(
                json.dumps(hinfo, sort_keys=True), []
            ).append(pos)
    hinfo = None
    if votes:
        blob, _members = max(
            votes.items(), key=lambda kv: (len(kv[1]), kv[0])
        )
        hinfo = json.loads(blob)
    hashes = (hinfo or {}).get("hashes")
    size = (hinfo or {}).get("size", 0)
    expected_len = (
        sinfo.logical_to_next_chunk_offset(size)
        if sinfo is not None
        else None
    )
    shards = []
    clean = True
    for pos, osd in enumerate(acting):
        ent = by_pos.get(pos)
        if ent is None:
            continue  # unreachable: peering handles it, not scrub
        sh = {"osd": osd, "shard": pos, "errors": []}
        if not ent.get("exists"):
            sh["errors"].append(ERR_MISSING)
        elif ent.get("error"):
            sh["errors"].append(ent["error"])
        else:
            sh["size"] = ent.get("size")
            sh["omap_digest"] = ent.get("omap_digest")
            sh["attrs_digest"] = ent.get("attrs_digest")
            if deep:
                sh["data_digest"] = ent.get("data_digest")
            if (
                expected_len is not None
                and ent.get("size") != expected_len
            ):
                sh["errors"].append(ERR_EC_SIZE)
            if (
                deep
                and hashes is not None
                and pos < len(hashes)
                and ent.get("data_digest") != hashes[pos]
            ):
                sh["errors"].append(ERR_EC_HASH)
        if sh["errors"]:
            clean = False
        shards.append(sh)
    needs_reencode = deep and hashes is None and bool(size)
    if clean:
        return None, needs_reencode
    rec = make_record(oid, shards, [], {"size": size})
    return rec, needs_reencode


class _Run:
    """One in-flight scrub of one PG (resumable between chunks)."""

    __slots__ = (
        "pgid", "deep", "repair", "epoch", "acting", "oids", "idx",
        "records", "large_omap", "reserved", "started",
    )

    def __init__(self, pgid, deep, repair, epoch, acting):
        self.pgid = pgid
        self.deep = deep
        self.repair = repair
        self.epoch = epoch
        self.acting = list(acting)
        self.oids: list[str] = []
        self.idx = 0
        self.records: list[dict] = []
        self.large_omap: list[str] = []
        self.reserved: list[int] = []
        self.started = time.monotonic()


class Scrubber:
    """Per-OSD scrub engine: scheduling state, the osd_max_scrubs
    reservation ledger (both sides), and the chunked run loop the
    worker drains."""

    def __init__(self, osd):
        self.osd = osd
        self._runs: dict[str, _Run] = {}
        # remote grants this OSD handed out: (pgid, from_osd) -> stamp
        self._remote: dict[tuple[str, int], float] = {}
        self.remote_timeout = 120.0
        # on-demand requests: pgid -> (deep, repair)
        self.pending: dict[str, tuple[bool, bool]] = {}
        # last (errors, damaged) shipped to the mon, so the tick can
        # re-report on CHANGE: a primary that loses a damaged PG to
        # remapping must withdraw its contribution or the health
        # check pins forever (the mon no longer ages reports out)
        self._last_reported: tuple | None = None
        self._last_report_stamp = 0.0

    # -- config ------------------------------------------------------------
    @property
    def max_scrubs(self) -> int:
        """Constructor override wins; otherwise the osd_max_scrubs
        config option (so `ceph config set` / env actually works)."""
        if self.osd.osd_max_scrubs is not None:
            return max(1, int(self.osd.osd_max_scrubs))
        try:
            return max(
                1, int(self.osd.config.get("osd_max_scrubs"))
            )
        except (KeyError, ValueError):
            return 1

    @property
    def chunk_max(self) -> int:
        try:
            return max(
                1, int(self.osd.config.get("osd_scrub_chunk_max"))
            )
        except (KeyError, ValueError):
            return 25

    @property
    def auto_repair(self) -> bool:
        if self.osd.scrub_auto_repair is not None:
            return bool(self.osd.scrub_auto_repair)
        try:
            return bool(
                self.osd.config.get("osd_scrub_auto_repair")
            )
        except KeyError:
            return False

    # -- reservation ledger (replica side) ---------------------------------
    def _prune_remote(self, now: float) -> None:
        """Expire timed-out remote grants (a crashed primary never
        sends release; its lease must not block this OSD forever).
        pop(), not del: prune runs on the worker while reserve/
        release mutate the same dict on the messenger thread."""
        for key, stamp in list(self._remote.items()):
            if now - stamp > self.remote_timeout:
                self._remote.pop(key, None)

    def handle_reserve(self, pgid: str, from_osd: int) -> bool:
        now = time.monotonic()
        self._prune_remote(now)
        key = (pgid, from_osd)
        if (
            key in self._remote
            or len(self._remote) + len(self._runs) < self.max_scrubs
        ):
            self._remote[key] = now
            return True
        return False

    def handle_release(self, pgid: str, from_osd: int) -> None:
        self._remote.pop((pgid, from_osd), None)

    # -- scheduling (primary side) -----------------------------------------
    def request(self, pgid: str, deep: bool, repair: bool) -> None:
        """On-demand order (``ceph pg (deep-)scrub / repair``):
        overrides the interval on the next tick; repair implies deep."""
        prev = self.pending.get(pgid, (False, False))
        self.pending[pgid] = (deep or repair or prev[0],
                              repair or prev[1])

    def request_random(
        self, rng, deep: bool = False, repair: bool = False
    ) -> str | None:
        """Thrash hook: order a scrub on one caller-seeded-random PG
        this OSD currently leads (scrub-during-fault composition).
        ``rng`` is the caller's ``random.Random`` so target picks sit
        on the schedule's deterministic stream, not module state.
        Returns the chosen pgid, or None when nothing is eligible."""
        osd = self.osd
        with osd._pg_lock:
            eligible = sorted(
                pg.pgid
                for pg in osd.pgs.values()
                if pg.primary == osd.whoami and pg.state == "active"
            )
        if not eligible:
            return None
        pgid = eligible[rng.randrange(len(eligible))]
        self.request(pgid, deep=deep, repair=repair)
        return pgid

    def due(self, now: float) -> list[tuple[str, bool, bool]]:
        """(pgid, deep, repair) runs the tick should enqueue."""
        osd = self.osd
        out = []
        with osd._pg_lock:
            pgs = list(osd.pgs.values())
        for pg in pgs:
            if (
                pg.primary != osd.whoami
                or pg.state != "active"
                or pg.pgid in osd._scrubbing
            ):
                continue
            if pg.pgid in self.pending:
                deep, repair = self.pending.pop(pg.pgid)
                out.append((pg.pgid, deep, repair))
                continue
            if osd.scrub_interval <= 0:
                continue
            deep_int = (
                osd.deep_scrub_interval
                if osd.deep_scrub_interval is not None
                else osd.scrub_interval
            )
            last_deep = getattr(pg, "last_deep_scrub", 0.0)
            if deep_int > 0 and now - last_deep > deep_int:
                out.append((pg.pgid, True, False))
            elif now - pg.last_scrub > osd.scrub_interval:
                out.append((pg.pgid, False, False))
        return out

    # -- run loop (worker side) --------------------------------------------
    def run(self, pg, deep: bool, repair: bool) -> None:
        """Process ONE chunk (starting the run when none is in
        flight), then re-enqueue — the preemption point that lets
        client ops interleave.  Any abort releases reservations."""
        osd = self.osd
        run = self._runs.get(pg.pgid)
        try:
            if run is None:
                run = self._start(pg, deep, repair)
                if run is None:
                    osd._scrubbing.discard(pg.pgid)
                    return
            if (
                pg.primary != osd.whoami
                or pg.state != "active"
                or list(pg.acting) != run.acting
            ):
                # interval changed under the scrub: abandon, the next
                # schedule rescans (the reference aborts on a new map
                # interval too)
                self._finish(pg, run, aborted=True)
                return
            self._chunk(pg, run)
            if run.idx < len(run.oids):
                from .scheduler import CLASS_BACKGROUND

                osd._workq.enqueue(
                    CLASS_BACKGROUND, 1,
                    ("scrub", pg.pgid, run.deep, run.repair),
                )
                return
            self._finish(pg, run)
        except Exception:
            # a scrub crash must never leak reservations or the
            # _scrubbing guard (the worker's catch-all files the
            # crash report).  A crash inside _start leaves no run
            # registered — the guard still must drop or the PG is
            # unscrubbable until restart (due() skips guarded pgids
            # before it even reads pending orders)
            leaked = self._runs.get(pg.pgid)
            if leaked is not None:
                self._finish(pg, leaked, aborted=True)
            else:
                osd._scrubbing.discard(pg.pgid)
            raise

    def _start(self, pg, deep: bool, repair: bool) -> _Run | None:
        osd = self.osd
        if pg.primary != osd.whoami or pg.state != "active":
            return None
        # the cap counts in-flight runs AND slots granted to other
        # primaries (matching handle_reserve's replica-side count);
        # expired grants are pruned first, or a crashed primary's
        # lease would block this OSD's own scrubs forever
        self._prune_remote(time.monotonic())
        if (
            len(self._runs) + len(self._remote)
            >= self.max_scrubs
        ):
            self.request(pg.pgid, deep, repair)
            return None
        run = _Run(pg.pgid, deep, repair, osd.monc.epoch, pg.acting)
        try:
            return self._start_reserved(pg, run)
        except Exception:
            # partial remote grants must go back on ANY failure, not
            # just the clean deny path
            self._release(run)
            raise

    def _start_reserved(self, pg, run: _Run) -> _Run | None:
        from .daemon import CRUSH_ITEM_NONE

        osd = self.osd
        deep, repair = run.deep, run.repair
        peers = [
            o
            for o in dict.fromkeys(pg.acting)
            if o != osd.whoami
            and o != CRUSH_ITEM_NONE
            and osd.monc.osdmap.is_up(o)
        ]
        # two-sided osd_max_scrubs reservation (ScrubReserver):
        # a deny anywhere releases everything and retries later
        for peer in peers:
            granted = False
            try:
                reply = osd._peer_conn(peer).call(
                    MRepScrub(
                        tid=osd.messenger.new_tid(),
                        op="reserve", pgid=pg.pgid,
                        epoch=run.epoch, from_osd=osd.whoami,
                    ),
                    timeout=5.0,
                )
                granted = (
                    isinstance(reply, MScrubMap) and reply.ok
                )
            except (MessageError, OSError):
                pass
            if not granted:
                self._release(run)
                self.request(pg.pgid, deep, repair)
                return None
            run.reserved.append(peer)
        # object universe: union of every member's listing, so a copy
        # the primary lost is still scrubbed (and flagged missing)
        names = set(self._local_ls(pg))
        for peer in peers:
            try:
                reply = osd._peer_conn(peer).call(
                    MRepScrub(
                        tid=osd.messenger.new_tid(),
                        op="ls", pgid=pg.pgid, epoch=run.epoch,
                        from_osd=osd.whoami,
                    ),
                    timeout=10.0,
                )
                if isinstance(reply, MScrubMap) and reply.ok:
                    names.update(json.loads(reply.map_json))
            except (MessageError, OSError, ValueError):
                pass
        run.oids = sorted(names)
        self._runs[pg.pgid] = run
        what = self._what(run)
        osd.clog.info(f"pg {pg.pgid} {what} starts")
        osd.perf.set("scrubs_active", len(self._runs))
        return run

    def _what(self, run: _Run) -> str:
        if run.repair:
            return "repair"
        return "deep-scrub" if run.deep else "scrub"

    @staticmethod
    def _strip(store_oid: str) -> str:
        from .daemon import OBJ_PREFIX

        return (
            store_oid[len(OBJ_PREFIX):]
            if store_oid.startswith(OBJ_PREFIX)
            else store_oid
        )

    def _local_ls(self, pg) -> list[str]:
        from .daemon import OBJ_PREFIX

        try:
            return [
                o
                for o in self.osd.store.list_objects(pg.cid)
                if o.startswith(OBJ_PREFIX)
            ]
        except StoreError:
            return []

    def _release(self, run: _Run) -> None:
        osd = self.osd
        for peer in run.reserved:
            try:
                osd._peer_conn(peer).send(
                    MRepScrub(
                        tid=osd.messenger.new_tid(),
                        op="release", pgid=run.pgid,
                        epoch=run.epoch, from_osd=osd.whoami,
                    )
                )
            except (MessageError, OSError):
                pass
        run.reserved = []

    def _peer_map(
        self, run: _Run, peer: int, oids: list[str], deep: bool
    ) -> dict | None:
        osd = self.osd
        try:
            reply = osd._peer_conn(peer).call(
                MRepScrub(
                    tid=osd.messenger.new_tid(),
                    op="scan", pgid=run.pgid, epoch=run.epoch,
                    from_osd=osd.whoami, deep=deep, oids=oids,
                ),
                timeout=30.0,
            )
            if isinstance(reply, MScrubMap) and reply.ok:
                return json.loads(reply.map_json)
        except (MessageError, OSError, ValueError):
            pass
        return None

    def _gather_maps(
        self, pg, run: _Run, oids: list[str], deep: bool
    ) -> dict[int, dict | None]:
        """The acting set's digest maps for one chunk: one scan per
        member, each a single batched digest pass (None = unreachable
        peer, skipped by the compares)."""
        import threading

        from .daemon import CRUSH_ITEM_NONE

        osd = self.osd
        is_ec = osd._is_ec(pg)
        maps_by_osd: dict[int, dict | None] = {}
        # peer scans run CONCURRENTLY: they are independent, and a
        # wedged replica must cost the worker one timeout per chunk,
        # not one per peer per chunk (sum→max)
        threads = []
        for osd_id in dict.fromkeys(run.acting):
            if osd_id == CRUSH_ITEM_NONE:
                continue
            if osd_id == osd.whoami:
                maps_by_osd[osd_id] = build_scrub_map(
                    osd.store, pg.cid, oids, deep,
                    with_hinfo=is_ec, device=osd.device,
                )
            elif osd.monc.osdmap.is_up(osd_id):
                def scan(osd_id=osd_id):
                    maps_by_osd[osd_id] = self._peer_map(
                        run, osd_id, oids, deep
                    )

                t = threading.Thread(
                    target=scan,
                    name=f"osd.{osd.whoami}.scrubgather",
                    daemon=True,
                )
                maps_by_osd[osd_id] = None
                t.start()
                threads.append(t)
            else:
                maps_by_osd[osd_id] = None
        for t in threads:
            t.join()
        return maps_by_osd

    def _compare_one(
        self, pg, run: _Run, oid: str,
        maps_by_osd: dict[int, dict | None], deep: bool,
        sinfo,
    ) -> tuple[dict | None, bool]:
        """One object's compare over gathered maps; returns
        (record | None, ec_needs_reencode)."""
        osd = self.osd
        per_osd = {
            o: (m.get(oid) if m is not None else None)
            for o, m in maps_by_osd.items()
        }
        if osd._is_ec(pg):
            return compare_ec(
                oid, per_osd, run.acting, sinfo, deep
            )
        return (
            compare_replicated(oid, per_osd, osd.whoami, deep),
            False,
        )

    def _sinfo_of(self, pg):
        if not self.osd._is_ec(pg):
            return None
        try:
            return self.osd._ec_codec(pg).sinfo
        except StoreError:
            return None

    def _chunk(self, pg, run: _Run) -> None:
        from .daemon import OBJ_PREFIX

        osd = self.osd
        oids = run.oids[run.idx : run.idx + self.chunk_max]
        run.idx += len(oids)
        if not oids:
            return
        maps_by_osd = self._gather_maps(pg, run, oids, run.deep)
        osd.perf.inc("scrub_chunks")
        if run.deep:
            # LARGE_OMAP_OBJECTS: the primary's own digest map
            # carries each object's omap cardinality (replicas hold
            # the same keys; one authoritative count suffices)
            thr = self._large_omap_threshold()
            own = maps_by_osd.get(osd.whoami) or {}
            for oid in oids:
                ent = own.get(oid) or {}
                if ent.get("omap_keys", 0) > thr:
                    run.large_omap.append(self._strip(oid))
        if run.deep:
            osd.perf.inc(
                "scrub_deep_bytes",
                sum(
                    (m or {}).get(oid, {}).get("size", 0)
                    for m in maps_by_osd.values()
                    for oid in oids
                ),
            )
        records: list[dict] = []
        reencode: list[str] = []
        sinfo = self._sinfo_of(pg)
        for oid in oids:
            rec, needs = self._compare_one(
                pg, run, oid, maps_by_osd, run.deep, sinfo
            )
            if needs:
                reencode.append(oid)
            if rec is not None:
                records.append(rec)
        if reencode:
            records.extend(
                self._reencode_verify(pg, run, reencode, records)
            )
        if run.repair and records:
            records = self._repair_chunk(pg, run, records)
        for rec in records:
            rec["object"]["name"] = rec["object"]["name"][
                len(OBJ_PREFIX):
            ]
            rec["oid"] = rec["object"]["name"]
        run.records.extend(records)

    def _reencode_verify(
        self, pg, run: _Run, oids: list[str], records: list[dict]
    ) -> list[dict]:
        """Deep-scrub fallback for hinfo-invalidated EC objects:
        decode the logical bytes, re-encode through the stripe seam
        (the packed-lane device kernel underneath), and compare every
        stored shard device-side.  A mismatch cannot be attributed to
        one shard without hashes — the record says so."""
        from ..ec.stripe import encode as stripe_encode

        osd = self.osd
        flagged = {r["object"]["name"] for r in records}
        out: list[dict] = []
        try:
            ecs = osd._ec_store_for(pg)
            codec = osd._ec_codec(pg)
        except StoreError:
            return out
        stored: list[bytes] = []
        expect: list[bytes] = []
        where: list[tuple[str, int]] = []
        for oid in oids:
            if oid in flagged:
                continue  # already recorded via per-shard errors
            try:
                logical = ecs.get(oid)
                padded = logical + b"\0" * (
                    codec.sinfo.logical_to_next_stripe_offset(
                        len(logical)
                    )
                    - len(logical)
                )
                shards = stripe_encode(
                    codec.sinfo, codec.ec, padded
                )
            except (ErasureCodeError, StoreError):
                continue
            for pos in range(codec.n):
                st = ecs.stores[pos]
                buf = _resident(st, pg.cid, oid)
                if buf is None:
                    try:
                        buf = st.read(pg.cid, oid)
                    except StoreError:
                        continue
                stored.append(buf)
                expect.append(bytes(shards.get(pos, b"")))
                where.append((oid, pos))
        if not stored:
            return out
        mismatch = batch_compare(stored, expect, device=osd.device)
        bad: dict[str, list[int]] = {}
        for (oid, pos), is_bad in zip(where, mismatch):
            if is_bad:
                bad.setdefault(oid, []).append(pos)
        for oid, positions in bad.items():
            shards = [
                {
                    "osd": run.acting[pos],
                    "shard": pos,
                    "errors": [ERR_INCONSISTENT],
                }
                for pos in positions
            ]
            out.append(
                make_record(oid, shards, [ERR_INCONSISTENT], None)
            )
        return out

    # -- repair ------------------------------------------------------------
    def _repair_chunk(
        self, pg, run: _Run, records: list[dict]
    ) -> list[dict]:
        """Fix each finding through the recovery-push machinery, then
        re-verify; only objects still broken stay recorded (the
        PrimaryLogPG repair path: authoritative copy → push →
        rescrub)."""
        osd = self.osd
        is_ec = osd._is_ec(pg)
        fixed: list[str] = []
        for rec in records:
            oid = rec["object"]["name"]
            try:
                if is_ec:
                    self._repair_ec(pg, run, rec)
                else:
                    self._repair_replicated(pg, run, rec)
                fixed.append(oid)
            except (
                StoreError, ErasureCodeError, MessageError, OSError
            ) as e:
                dout(
                    "osd", 1,
                    f"osd.{osd.whoami} pg {pg.pgid} repair of "
                    f"{oid} failed: {e}",
                )
        if not fixed:
            return records
        # re-verify the repaired objects with a fresh deep compare
        still: list[dict] = []
        byname = {r["object"]["name"]: r for r in records}
        maps_by_osd = self._gather_maps(pg, run, fixed, True)
        sinfo = self._sinfo_of(pg)
        fixed_count = 0
        for oid in fixed:
            rec, _needs = self._compare_one(
                pg, run, oid, maps_by_osd, True, sinfo
            )
            if rec is not None:
                still.append(rec)
            else:
                fixed_count += 1
        still.extend(
            r for n, r in byname.items() if n not in fixed
        )
        if fixed_count:
            osd.clog.info(
                f"pg {pg.pgid} repair fixed {fixed_count} objects"
            )
        return still

    def _repair_replicated(self, pg, run: _Run, rec: dict) -> None:
        """Push the authoritative copy over every divergent one."""
        osd = self.osd
        from .daemon import OBJ_PREFIX

        sel = rec.get("selected_object_info") or {}
        source = sel.get("osd")
        if source is None:
            source = osd.whoami
        oid = rec["object"]["name"][len(OBJ_PREFIX):]
        bad = [
            sh["osd"] for sh in rec["shards"] if sh.get("errors")
        ]
        if source == osd.whoami:
            push = osd._push_for(pg, run.epoch, oid)
        else:
            reply = osd._peer_conn(source).call(
                MPGPull(
                    pgid=pg.pgid, epoch=run.epoch, oid=oid,
                    shard=-1,
                ),
                timeout=15.0,
            )
            if not isinstance(reply, MPGPush):
                raise StoreError(
                    f"repair pull of {oid} from osd.{source} failed"
                )
            push = reply
            if osd.whoami in bad:
                osd._apply_push(pg, push)
        for peer in bad:
            if peer == osd.whoami or peer == source:
                continue
            push.tid = osd.messenger.new_tid()
            osd._peer_conn(peer).call(push, timeout=15.0)

    def _repair_ec(self, pg, run: _Run, rec: dict) -> None:
        """Rebuild bad shards from the survivors (decode path); for
        unattributable re-encode mismatches, decode the logical bytes
        from the data shards and rewrite every divergent shard.  A
        rebuilt shard carries the object's birth-snap stamp, read from
        a good shard, so snap reads on it still resolve."""
        osd = self.osd
        from .daemon import BORN_ATTR

        oid = rec["object"]["name"]
        ecs = osd._ec_store_for(pg)
        codec = osd._ec_codec(pg)
        bad_pos = sorted(
            {
                sh["shard"]
                for sh in rec["shards"]
                if sh.get("errors") and sh.get("shard", -1) >= 0
            }
        )
        born = None
        for pos, st in enumerate(ecs.stores):
            if pos in bad_pos:
                continue
            try:
                born = st.getattr(pg.cid, oid, BORN_ATTR)
                break
            except StoreError:
                continue
        meta = None
        try:
            meta = ecs.meta(oid)
        except ErasureCodeError:
            pass
        if (
            rec.get("inconsistent")
            or meta is None
            or meta.get("hashes") is None
        ):
            # no per-shard truth: restore mutual consistency from the
            # data shards (decode-from-surviving-shards)
            logical = ecs.get(oid)
            padded = logical + b"\0" * (
                codec.sinfo.logical_to_next_stripe_offset(
                    len(logical)
                )
                - len(logical)
            )
            from ..ec.stripe import encode as stripe_encode

            shards = stripe_encode(codec.sinfo, codec.ec, padded)
            blob = json.dumps(
                meta or {"size": len(logical)}
            ).encode()
            for pos in bad_pos:
                txn = Transaction()
                if ecs.stores[pos].exists(pg.cid, oid):
                    txn.remove(pg.cid, oid)
                txn.touch(pg.cid, oid)
                txn.write(pg.cid, oid, 0, bytes(shards[pos]))
                txn.setattr(pg.cid, oid, HINFO_KEY, blob)
                if born is not None:
                    txn.setattr(pg.cid, oid, BORN_ATTR, born)
                ecs.stores[pos].queue_transaction(txn)
            return
        for pos in bad_pos:
            # hinfo-verified rebuild: corrupt helpers are filtered by
            # their own crc, the rebuilt shard must match its hash
            ecs.recover_shard(oid, pos, dict(meta))
            if born is not None:
                ecs.stores[pos].queue_transaction(
                    Transaction().setattr(pg.cid, oid, BORN_ATTR, born)
                )

    # -- completion --------------------------------------------------------
    def _finish(self, pg, run: _Run, aborted: bool = False) -> None:
        osd = self.osd
        self._release(run)
        self._runs.pop(pg.pgid, None)
        osd._scrubbing.discard(pg.pgid)
        osd.perf.set("scrubs_active", len(self._runs))
        what = self._what(run)
        if aborted:
            osd.clog.info(f"pg {pg.pgid} {what} aborted")
            return
        now = time.monotonic()
        records = run.records
        if not run.deep:
            # a shallow pass is BLIND to payload corruption: carry
            # forward deep-only findings it cannot re-test (a shallow
            # scrub must never clear OSD_SCRUB_ERRORS raised by a
            # deep one; only a deep scrub or repair re-judges them)
            deep_only = {ERR_DATA, ERR_EC_HASH, ERR_INCONSISTENT}
            new_names = {r["object"]["name"] for r in records}
            universe = {
                self._strip(o) for o in run.oids
            }
            records = records + [
                old
                for old in pg.scrub_errors
                if old["object"]["name"] not in new_names
                and old["object"]["name"] in universe
                and deep_only
                & (
                    set(old.get("errors", ()))
                    | set(old.get("union_shard_errors", ()))
                )
            ]
        pg.scrub_errors = records
        run.records = records
        pg.last_scrub = now
        if run.deep:
            pg.last_deep_scrub = now
            # only a deep pass re-judges omap cardinality (a shallow
            # one never counted keys and must not clear the finding)
            pg.large_omap = list(run.large_omap)
            if run.large_omap:
                osd.clog.warn(
                    f"pg {pg.pgid} {what} found "
                    f"{len(run.large_omap)} large omap object(s): "
                    f"{sorted(run.large_omap)[:4]}"
                )
        try:
            ScrubStore.save(osd.store, pg.cid, run.records)
        except StoreError:
            pass
        from .daemon import PG_META

        txn = Transaction().touch(pg.cid, PG_META)
        stamp = str(time.time()).encode()
        txn.setattr(pg.cid, PG_META, "scrub_stamp", stamp)
        if run.deep:
            txn.setattr(pg.cid, PG_META, "deep_scrub_stamp", stamp)
        try:
            osd.store.queue_transaction(txn)
        except StoreError:
            pass
        nerr = len(run.records)
        if nerr:
            osd.clog.error(
                f"pg {pg.pgid} {what} {nerr} errors"
            )
            dout(
                "osd", 1,
                f"osd.{osd.whoami} pg {pg.pgid} {what} found "
                f"{nerr} inconsistencies",
            )
        else:
            osd.clog.info(f"pg {pg.pgid} {what} ok")
        self.report_health()
        if run.deep and not run.repair and nerr and self.auto_repair:
            try:
                cap = int(
                    self.osd.config.get(
                        "osd_scrub_auto_repair_num_errors"
                    )
                )
            except (KeyError, ValueError):
                cap = 5
            if nerr <= cap:
                # osd_scrub_auto_repair: queue the repair pass
                self.request(pg.pgid, True, True)

    def maybe_report(self, now: float) -> None:
        """Tick hook: re-report when this OSD's contribution CHANGED
        since the last report — e.g. a damaged PG remapped to another
        primary (our count drops to 0 and must withdraw the health
        complaint, since the mon holds reports until cleared)."""
        if now - self._last_report_stamp < 5.0:
            return
        current = self._current_report()
        if current != self._last_reported or (
            (current[0] > 0 or current[2] > 0)
            and now - self._last_report_stamp > 30.0
        ):
            # nonzero findings RE-ASSERT periodically: the mon drops
            # a report when its daemon blips down, and without the
            # re-assert a recovered OSD whose state never changed
            # would leave known damage invisible in ceph health
            self.report_health()

    def _large_omap_threshold(self) -> int:
        try:
            return int(
                self.osd.config.get(
                    "osd_deep_scrub_large_omap_object_key_threshold"
                )
            )
        except (KeyError, TypeError, ValueError):
            return 200000

    def _current_report(self) -> tuple:
        osd = self.osd
        with osd._pg_lock:
            damaged = tuple(
                sorted(
                    pg.pgid
                    for pg in osd.pgs.values()
                    if pg.primary == osd.whoami and pg.scrub_errors
                )
            )
            errors = sum(
                len(pg.scrub_errors)
                for pg in osd.pgs.values()
                if pg.primary == osd.whoami
            )
            large = sum(
                len(pg.large_omap)
                for pg in osd.pgs.values()
                if pg.primary == osd.whoami
            )
        return errors, damaged, large

    def report_health(self) -> None:
        """Tell the mon how many scrub errors this OSD's primary PGs
        carry (feeds OSD_SCRUB_ERRORS / PG_DAMAGED; a zero report
        clears)."""
        osd = self.osd
        errors, damaged, large = self._current_report()
        osd.perf.set("scrub_errors", errors)
        self._last_report_stamp = time.monotonic()
        try:
            osd.monc.command(
                {
                    "prefix": "osd scrub errors",
                    "daemon": f"osd.{osd.whoami}",
                    "errors": errors,
                    "pgs": list(damaged),
                    # omap-cardinality findings ride the same upcall
                    # (LARGE_OMAP_OBJECTS)
                    "large_omap": large,
                },
                timeout=5.0,
            )
            self._last_reported = (errors, damaged, large)
        except (MessageError, OSError):
            pass
