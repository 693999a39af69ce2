"""rbd-mirror — one-way asynchronous image replication by journal
replay (src/tools/rbd_mirror/Mirror.cc + src/librbd/mirror/,
reduced to the working core: journal-based mirroring only).

A ``MirrorDaemon`` watches a SOURCE ioctx for journaled images and
replays each image's journal into a TARGET ioctx (another pool or
another cluster entirely — the ioctx carries the cluster session):

- **bootstrap**: a missing target image is created with the source's
  geometry and full-copied at the current journal position (the
  reference's image-sync phase).
- **replay**: the daemon registers as a journal CLIENT on the source
  (trim never passes it — entries survive until consumed), tails
  entries from its recorded position, applies write/discard/resize
  to the target, and advances its position durably.  A restarted
  daemon resumes exactly where it stopped.

Deviations: one-way (no promotion/demotion handshake or split-brain
detection), snapshot-based mirroring absent (journal mode only),
and the target image is plain (no feature bits)."""

from __future__ import annotations

import threading
import time

from ..common.encoding import Decoder
from ..mds.journaler import Journaler
from ..osdc.objecter import ObjectNotFound, RadosError
from . import DIRECTORY, Image, RBD, _header_oid

CLIENT_ID = "rbd-mirror"


class MirrorDaemon:
    def __init__(self, src_ioctx, dst_ioctx, interval: float = 0.5):
        self.src = src_ioctx
        self.dst = dst_ioctx
        self.interval = interval
        self.images_synced = 0  # observability
        self.entries_replayed = 0
        self._stop = threading.Event()
        self._thread = None
        if interval > 0:
            # interval=0: no background thread — the caller drives
            # replay_once() itself (the CLI's --once mode; a thread
            # racing it would replay the same entries concurrently)
            self._thread = threading.Thread(
                target=self._loop, name="rbd-mirror", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # -- discovery ---------------------------------------------------------
    def _journaled_images(self) -> list[str]:
        try:
            names = self.src.omap_get_vals(DIRECTORY)
        except (ObjectNotFound, RadosError):
            return []
        out = []
        for name in names:
            try:
                meta = self.src.omap_get_vals(_header_oid(name))
            except (ObjectNotFound, RadosError):
                continue
            feats = meta.get("features", b"").decode()
            if "journaling" in feats:
                out.append(name)
        return sorted(out)

    # -- replication -------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.replay_once()
            except Exception:  # noqa: BLE001 — the replayer survives
                pass

    def replay_once(self) -> int:
        """One pass over every journaled image; returns entries
        applied (callable directly for deterministic tests)."""
        applied = 0
        for name in self._journaled_images():
            try:
                applied += self._replay_image(name)
            except (ObjectNotFound, RadosError):
                continue  # next pass retries
        return applied

    def _ensure_target(self, name: str, journal: Journaler) -> None:
        """Bootstrap (image-sync): create + full-copy at the current
        replay position so journal entries from here converge."""
        try:
            self.dst.omap_get_vals(_header_oid(name))
            return
        except (ObjectNotFound, RadosError):
            pass
        meta = self.src.omap_get_vals(_header_oid(name))
        RBD().create(
            self.dst, name,
            int(meta["size"]),
            stripe_unit=int(meta["stripe_unit"]),
            stripe_count=int(meta["stripe_count"]),
            object_size=int(meta["object_size"]),
        )
        src_img = Image(self.src, name)
        dst_img = Image(self.dst, name)
        try:
            size = src_img.size()
            step = 4 << 20
            for off in range(0, size, step):
                chunk = src_img.read(off, min(step, size - off))
                if chunk.strip(b"\0"):
                    dst_img.write(off, chunk)
            self.images_synced += 1
        finally:
            src_img.close()
            dst_img.close()

    def _replay_image(self, name: str) -> int:
        journal = Journaler(
            self.src, prefix=f"rbd_journal.{name}"
        ).load()
        pos = journal.register_client(CLIENT_ID)
        self._ensure_target(name, journal)
        applied = 0
        dst_img = None
        try:
            for blob, end in journal.replay_from(pos):
                if dst_img is None:
                    dst_img = Image(self.dst, name)
                self._apply(dst_img, blob)
                journal.update_client(CLIENT_ID, end)
                applied += 1
                self.entries_replayed += 1
        finally:
            if dst_img is not None:
                dst_img.close()
        return applied

    @staticmethod
    def _apply(img: Image, blob: bytes) -> None:
        d = Decoder(blob)
        op, off, length = d.u8(), d.u64(), d.u64()
        data = d.bytes()
        if op == 1:
            if off + len(data) > img.size():
                img.resize(off + len(data))
            img.write(off, data)
        elif op == 2:
            img.discard(off, length)
        elif op == 3:
            img.resize(off)
