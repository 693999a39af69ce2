"""PGMap digest (src/mon/PGMap.{h,cc} + the DaemonServer stats fold).

The OSDs push per-PG ``pg_stat_t``-analog dicts on MPGStats; the
Manager parks them per-OSD (``Manager.pg_stats``); this module rolls
the freshest primary reports into the PGMap digest — per-pool and
cluster totals, a pg-state histogram, io/recovery rates from
daemon-perf counter deltas, and the full per-PG table — and pushes the
binary-encoded digest to the mon ("pgmap report"), where it feeds
``ceph status``/``ceph df``/``pg dump`` and the PG_DEGRADED /
PG_AVAILABILITY health checks.

The digest encoding is dencoder-pinned (corpus/dencoder/): maps
encode sorted, so the same digest always produces the same bytes.
"""

from __future__ import annotations

import base64
import json
import time
from collections import deque

from ..common.encoding import Decoder, Encoder
from ..msg.message import MMonCommandReply
from . import MgrModule, PrometheusModule

PGMAP_DIGEST_VERSION = 1

# io/recovery rates come from deltas between perf-counter snapshots;
# keep a short window so rates react within a few ticks
RATE_WINDOW_SAMPLES = 8

_RATE_KEYS = (
    "op", "op_r", "op_w", "recovery_pushes", "recovery_push_bytes",
)


def _enc_pool(e: Encoder, p: dict) -> None:
    e.string(p.get("name", ""))
    e.u32(p.get("num_pgs", 0)).u32(p.get("active_pgs", 0))
    e.u64(p.get("objects", 0)).u64(p.get("bytes", 0))
    e.u64(p.get("degraded", 0)).u64(p.get("misplaced", 0))
    e.u64(p.get("unfound", 0))


def _dec_pool(d: Decoder) -> dict:
    return {
        "name": d.string(),
        "num_pgs": d.u32(), "active_pgs": d.u32(),
        "objects": d.u64(), "bytes": d.u64(),
        "degraded": d.u64(), "misplaced": d.u64(),
        "unfound": d.u64(),
    }


def _enc_pg(e: Encoder, p: dict) -> None:
    e.string(p.get("state", ""))
    e.u64(p.get("objects", 0)).u64(p.get("bytes", 0))
    e.u64(p.get("degraded", 0)).u64(p.get("misplaced", 0))
    e.u64(p.get("unfound", 0))
    e.list(p.get("up", []), lambda en, v: en.s32(v))
    e.list(p.get("acting", []), lambda en, v: en.s32(v))
    e.u32(p.get("reported_epoch", 0))
    e.f64(p.get("recovery_progress", 0.0))


def _dec_pg(d: Decoder) -> dict:
    return {
        "state": d.string(),
        "objects": d.u64(), "bytes": d.u64(),
        "degraded": d.u64(), "misplaced": d.u64(),
        "unfound": d.u64(),
        "up": d.list(lambda de: de.s32()),
        "acting": d.list(lambda de: de.s32()),
        "reported_epoch": d.u32(),
        "recovery_progress": d.f64(),
    }


def encode_pgmap_digest(digest: dict) -> bytes:
    """Deterministic binary encoding of the digest (the dencoder pin:
    Encoder.map iterates sorted, so byte-for-byte stable)."""
    e = Encoder()
    e.u32(PGMAP_DIGEST_VERSION)
    e.u32(digest.get("num_pgs", 0)).u32(digest.get("num_pools", 0))
    e.map(
        digest.get("pg_states", {}),
        lambda en, k: en.string(k),
        lambda en, v: en.u64(v),
    )
    e.map(
        digest.get("pools", {}),
        lambda en, k: en.s64(int(k)),
        _enc_pool,
    )
    t = digest.get("totals", {})
    e.u64(t.get("objects", 0)).u64(t.get("bytes", 0))
    e.u64(t.get("degraded", 0)).u64(t.get("misplaced", 0))
    e.u64(t.get("unfound", 0))
    io = digest.get("io", {})
    e.f64(io.get("ops_sec", 0.0)).f64(io.get("read_ops_sec", 0.0))
    e.f64(io.get("write_ops_sec", 0.0))
    rec = digest.get("recovery", {})
    e.f64(rec.get("objects_sec", 0.0)).f64(rec.get("bytes_sec", 0.0))
    e.map(
        digest.get("pgs", {}),
        lambda en, k: en.string(k),
        _enc_pg,
    )
    return e.getvalue()


def decode_pgmap_digest(buf: bytes) -> dict:
    d = Decoder(buf)
    version = d.u32()
    if version != PGMAP_DIGEST_VERSION:
        raise ValueError(f"pgmap digest version {version}")
    out = {
        "version": version,
        "num_pgs": d.u32(),
        "num_pools": d.u32(),
        "pg_states": d.map(
            lambda de: de.string(), lambda de: de.u64()
        ),
        "pools": d.map(lambda de: de.s64(), _dec_pool),
        "totals": {
            "objects": d.u64(), "bytes": d.u64(),
            "degraded": d.u64(), "misplaced": d.u64(),
            "unfound": d.u64(),
        },
        "io": {
            "ops_sec": d.f64(), "read_ops_sec": d.f64(),
            "write_ops_sec": d.f64(),
        },
        "recovery": {
            "objects_sec": d.f64(), "bytes_sec": d.f64(),
        },
        "pgs": d.map(lambda de: de.string(), _dec_pg),
    }
    return out


def pgmap_exposition_lines(digest: dict) -> list[str]:
    """Prometheus text for the pgmap families — module-level so
    tools/check_metrics.py lints the exact text the exporter serves
    (the histogram_exposition_lines pattern).  ``ceph_pg_total`` is
    NOT emitted here: the exporter already serves it from
    pg_summary."""
    esc = PrometheusModule.escape_label
    out: list[str] = []

    def fam(name: str, help_: str) -> None:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} gauge")

    t = digest.get("totals", {})
    fam("ceph_pg_degraded", "objects with missing replicas/shards")
    out.append(f"ceph_pg_degraded {t.get('degraded', 0)}")
    fam("ceph_pg_misplaced", "objects not on their CRUSH-up home")
    out.append(f"ceph_pg_misplaced {t.get('misplaced', 0)}")
    fam("ceph_pg_unfound", "objects with no known authoritative copy")
    out.append(f"ceph_pg_unfound {t.get('unfound', 0)}")
    fam("ceph_pg_state", "pg count by state string")
    for state, count in sorted(digest.get("pg_states", {}).items()):
        out.append(f'ceph_pg_state{{state="{esc(state)}"}} {count}')
    fam("ceph_pool_stored_bytes", "per-pool stored bytes")
    fam("ceph_pool_objects", "per-pool object count")
    pools = digest.get("pools", {})
    for pid in sorted(pools):
        p = pools[pid]
        lbl = f'pool="{esc(p.get("name", str(pid)))}"'
        out.append(
            f"ceph_pool_stored_bytes{{{lbl}}} {p.get('bytes', 0)}"
        )
        out.append(
            f"ceph_pool_objects{{{lbl}}} {p.get('objects', 0)}"
        )
    return out


class PgMapModule(MgrModule):
    """Builds the PGMap digest every tick and pushes it to the mon.

    The mon treats digest staleness like osd-stat staleness (silence
    past the grace drops the pgmap section), so the push is
    continuous rather than on-change — rates move every tick
    anyway."""

    NAME = "pgmap"
    TICK_EVERY = 1.0

    def __init__(self, mgr):
        super().__init__(mgr)
        self.digest: dict = {}
        self._samples: deque[tuple[float, dict]] = deque(
            maxlen=RATE_WINDOW_SAMPLES
        )
        self._last_push = 0.0

    # -- digest construction ----------------------------------------------
    def _rates(self) -> tuple[dict, dict]:
        """io + recovery rates from perf-counter deltas across the
        sample window; negative deltas (an OSD restarted and its
        counters reset) clamp to zero."""
        perf = self.get("daemon_perf") or {}
        total = {k: 0 for k in _RATE_KEYS}
        for daemon, dump in perf.items():
            if not daemon.startswith("osd."):
                continue
            for k in _RATE_KEYS:
                v = dump.get(k, 0)
                if isinstance(v, (int, float)):
                    total[k] += v
        self._samples.append((time.time(), total))
        if len(self._samples) < 2:
            return (
                {"ops_sec": 0.0, "read_ops_sec": 0.0,
                 "write_ops_sec": 0.0},
                {"objects_sec": 0.0, "bytes_sec": 0.0},
            )
        (t0, a), (t1, b) = self._samples[0], self._samples[-1]
        dt = max(t1 - t0, 1e-6)

        def rate(key: str) -> float:
            return round(max(b[key] - a[key], 0) / dt, 2)

        return (
            {
                "ops_sec": rate("op"),
                "read_ops_sec": rate("op_r"),
                "write_ops_sec": rate("op_w"),
            },
            {
                "objects_sec": rate("recovery_pushes"),
                "bytes_sec": rate("recovery_push_bytes"),
            },
        )

    def _build_digest(self) -> dict | None:
        m = self.get("osd_map")
        if m is None:
            return None
        try:
            pg_stats = self.get("pg_stats") or {}
        except KeyError:
            pg_stats = {}
        io, recovery = self._rates()
        pg_states: dict[str, int] = {}
        pools: dict[int, dict] = {}
        totals = {
            "objects": 0, "bytes": 0,
            "degraded": 0, "misplaced": 0, "unfound": 0,
        }
        pgs: dict[str, dict] = {}
        for pid, pool in m.pools.items():
            pools[pid] = {
                "name": m.pool_names.get(pid, str(pid)),
                "num_pgs": pool.pg_num,
                "active_pgs": 0,
                "objects": 0, "bytes": 0,
                "degraded": 0, "misplaced": 0, "unfound": 0,
            }
        for pgid, st in pg_stats.items():
            state = str(st.get("state", "unknown"))
            pg_states[state] = pg_states.get(state, 0) + 1
            rec = st.get("recovery") or {}
            planned = int(rec.get("planned", 0) or 0)
            pushed = int(rec.get("pushed", 0) or 0)
            progress = (
                pushed / planned if planned else
                (1.0 if state.startswith("active") else 0.0)
            )
            row = {
                "state": state,
                "objects": int(st.get("num_objects", 0)),
                "bytes": int(st.get("num_bytes", 0)),
                "degraded": int(st.get("num_objects_degraded", 0)),
                "misplaced": int(st.get("num_objects_misplaced", 0)),
                "unfound": int(st.get("num_objects_unfound", 0)),
                "up": list(st.get("up", [])),
                "acting": list(st.get("acting", [])),
                "reported_epoch": int(st.get("reported_epoch", 0)),
                "recovery_progress": round(progress, 4),
            }
            pgs[pgid] = row
            try:
                pid = int(pgid.split(".")[0])
            except (ValueError, IndexError):
                continue
            pool = pools.get(pid)
            if pool is None:
                continue
            if state.startswith("active"):
                pool["active_pgs"] += 1
            for src, dst in (
                ("objects", "objects"), ("bytes", "bytes"),
                ("degraded", "degraded"),
                ("misplaced", "misplaced"),
                ("unfound", "unfound"),
            ):
                pool[dst] += row[src]
                totals[dst] += row[src]
        return {
            "version": PGMAP_DIGEST_VERSION,
            "num_pgs": sum(p.pg_num for p in m.pools.values()),
            "num_pools": len(m.pools),
            "pg_states": pg_states,
            "pools": pools,
            "totals": totals,
            "io": io,
            "recovery": recovery,
            "pgs": pgs,
        }

    # -- serve/push ---------------------------------------------------------
    def serve(self) -> None:
        digest = self._build_digest()
        if digest is None:
            return
        self.digest = digest
        now = time.time()
        if now - self._last_push < 1.0:
            return
        try:
            reply = self.mon_command(
                {
                    "prefix": "pgmap report",
                    "digest": base64.b64encode(
                        encode_pgmap_digest(digest)
                    ).decode("ascii"),
                },
                timeout=2.0,  # tick thread: never stall other modules
            )
            if reply.rc == 0:
                self._last_push = now
        except Exception:  # noqa: BLE001 — retried next tick
            pass

    # -- command surface ----------------------------------------------------
    def handle_command(self, cmd: dict) -> MMonCommandReply:
        prefix = cmd.get("prefix", "")
        if prefix in ("pgmap dump", "pgmap"):
            return MMonCommandReply(outb=json.dumps(self.digest))
        return MMonCommandReply(
            rc=-22, outs=f"unknown pgmap command {prefix!r}"
        )
