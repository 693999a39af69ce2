"""Bucket lifecycle engine — expiration + storage-class transition
(src/rgw/rgw_lc.cc:1 reduced to its working core).

Rules per bucket (stored in the gateway's lc-config omap, the
reference's lc shard-object role):

    {"id": ..., "prefix": "logs/", "status": "Enabled",
     "expiration_days": 30}                      # delete when aged
    {"id": ..., "prefix": "", "status": "Enabled",
     "transition_days": 7, "storage_class": "COLD"}

A worker (RGW.start_lc / lc_process) scans configured buckets and
applies every enabled rule to matching keys by mtime age —
expiration deletes through the normal delete path; transition
REWRITES the object's data through the zlib compressor and tags the
index entry with the storage class (this framework's one real
second tier), with reads transparently decompressing.  Like the
reference's ``rgw_lc_debug_interval``, ``debug=True`` makes the
``*_days`` fields count SECONDS so tests age objects in real time.
"""

from __future__ import annotations

import json
import threading
import time

__all__ = ["apply_rules", "LCWorker"]


def _matches(rule: dict, key: str) -> bool:
    return rule.get("status", "Enabled") == "Enabled" and key.startswith(
        rule.get("prefix", "")
    )


def apply_rules(rgw, bucket: str, rules: list[dict], debug: bool) -> dict:
    """One lc pass over one bucket; returns {'expired': n,
    'transitioned': n} (the per-bucket RGWLC::bucket_lc_process)."""
    unit = 1.0 if debug else 86400.0
    now = time.time()
    stats = {"expired": 0, "transitioned": 0}
    try:
        # snapshot the merged sharded listing up front: the loop
        # below mutates the index it walks
        index = dict(rgw.index.entries(bucket))
    except Exception:  # noqa: BLE001 — bucket vanished mid-pass
        return stats
    for key, raw in index.items():
        entry = json.loads(raw)
        age = now - float(entry.get("mtime", now))
        for rule in rules:
            if not _matches(rule, key):
                continue
            exp = rule.get("expiration_days")
            if exp is not None and age > float(exp) * unit:
                try:
                    rgw.delete_object(bucket, key)
                    stats["expired"] += 1
                except Exception:  # noqa: BLE001 — raced a delete
                    pass
                break  # entry is gone; later rules moot
            tr = rule.get("transition_days")
            if (
                tr is not None
                and age > float(tr) * unit
                and entry.get("storage_class", "STANDARD")
                != rule.get("storage_class", "COLD")
            ):
                try:
                    rgw._transition_object(
                        bucket, key,
                        rule.get("storage_class", "COLD"),
                    )
                    stats["transitioned"] += 1
                except Exception:  # noqa: BLE001 — raced an overwrite
                    pass
                break
    return stats


class LCWorker:
    """Background scanner (RGWLC::LCWorker): every ``interval``
    seconds, walk each bucket's lifecycle config and apply it."""

    def __init__(self, rgw, interval: float, debug: bool):
        self.rgw = rgw
        self.interval = interval
        self.debug = debug
        self.passes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="rgw.lc", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.rgw.lc_process()
            except Exception:  # noqa: BLE001 — scanner must survive
                pass
            self.passes += 1

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
