"""Continuous consistency oracle — the RadosModel/ceph_test_rados
role (src/test/osd/RadosModel.h: every op records what it was told,
and every read is checked against the set of states the history
permits), grown into an online checker the thrasher runs *during*
the fault schedule.

Model.  Each object has exactly ONE writer (its owning workload
client issues sync ops sequentially), and every mutation carries a
per-object monotonically increasing version stamped INTO the payload.
That makes the permitted-state set tiny and exact:

    possible(oid) = { last acked mutation }
                  ∪ { lost-ack mutations NEWER than the last ack }

A mutation whose ack was lost (timeout / connection reset mid-fault)
is *indeterminate*: it may or may not have landed, so both outcomes
stay permitted until a later acked mutation supersedes it, or a read
OBSERVES it — observation collapses the indeterminacy (the state
provably advanced) and anything older becomes a violation.

Checked invariants, op by op:

- **acked-write durability** — a read may never miss the last acked
  mutation (absent object after an acked write = ``lost_acked_write``);
- **read-your-writes / monotonicity** — an observed version below the
  proven floor is ``stale_read`` (or ``resurrected_delete`` when an
  acked delete sits between); versions never issued are
  ``phantom_version``; payload bytes that do not match the
  deterministic content for their stamped version are
  ``corrupt_payload``;
- **no resurrected deletes** — data observed after an acked delete
  with no newer indeterminate write to explain it.

``ConsistencyOracle`` is pure bookkeeping (unit-testable on
hand-built histories); ``HistoryRecorder`` is the live workload that
feeds it from N client threads against a real IoCtx.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from random import Random

_MAGIC = "QA1"


# -- payload codec (self-describing, self-verifying) ------------------------
def encode_payload(oid: str, version: int, size: int) -> bytes:
    """Deterministic bytes for (oid, version): header + a seeded
    filler stream — a reader can reconstruct and verify every byte
    from the header alone."""
    header = f"{_MAGIC}|{oid}|{version}|".encode()
    fill = max(0, int(size) - len(header))
    return header + _filler(oid, version, fill)


def _filler(oid: str, version: int, n: int) -> bytes:
    rng = Random(zlib.crc32(f"{oid}|{version}".encode()))
    return rng.randbytes(n)


def parse_payload(data: bytes):
    """-> (version, ok) — ok False when the bytes are not a valid
    payload for the version they claim."""
    try:
        magic, oid, version, _rest = data.split(b"|", 3)
        if magic != _MAGIC.encode():
            return None, False
        v = int(version)
    except (ValueError, TypeError):
        return None, False
    return v, data == encode_payload(
        oid.decode(), v, len(data)
    )


@dataclass
class Violation:
    """One oracle finding — the unit the shrinker minimizes toward."""

    kind: str
    oid: str
    client: str
    detail: dict = field(default_factory=dict)
    t: float = 0.0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "oid": self.oid,
            "client": self.client,
            "detail": self.detail,
            "t": round(self.t, 3),
        }


class _ObjState:
    __slots__ = ("acked", "indeterminate", "floor", "issued")

    def __init__(self):
        # (version, deleted) of the last ACKED mutation, or None
        self.acked: tuple[int, bool] | None = None
        # version -> deleted, for lost-ack mutations newer than acked
        self.indeterminate: dict[int, bool] = {}
        # highest version PROVEN applied (acked or observed)
        self.floor = 0
        # every version ever issued -> deleted (phantom detection)
        self.issued: dict[int, bool] = {}


class ConsistencyOracle:
    """Op-by-op history checker.  Feed it every mutation outcome via
    ``note_mutation`` and every read via ``note_read``; violations
    accumulate in ``self.violations`` (and bump the thrasher's
    ``l_thrash_violations`` counter when one is attached)."""

    def __init__(self, perf=None, clock=time.monotonic):
        self._lock = threading.Lock()
        self._objs: dict[str, _ObjState] = {}
        self.violations: list[Violation] = []
        self.perf = perf
        self._clock = clock
        self._t0 = clock()

    # -- recording ----------------------------------------------------------
    def note_mutation(
        self,
        client: str,
        oid: str,
        version: int,
        acked: bool,
        delete: bool = False,
    ) -> None:
        """One write/delete outcome.  ``acked`` False = the ack was
        lost (timeout, reset): the op becomes indeterminate, not
        forgotten."""
        with self._lock:
            st = self._objs.setdefault(oid, _ObjState())
            st.issued[version] = delete
            if acked:
                self._settle(st, version, delete)
            elif st.acked is None or version > st.acked[0]:
                st.indeterminate[version] = delete

    def _settle(self, st: _ObjState, version: int, delete: bool):
        """An outcome at ``version`` is now proven: it supersedes
        every indeterminate at or below it."""
        if st.acked is None or version >= st.acked[0]:
            st.acked = (version, delete)
        st.floor = max(st.floor, version)
        for v in [
            v for v in st.indeterminate if v <= version
        ]:
            del st.indeterminate[v]

    def note_read(
        self,
        client: str,
        oid: str,
        version: int | None,
        payload_ok: bool = True,
    ) -> Violation | None:
        """One completed read: ``version`` is the payload's stamped
        version, or None when the object was absent (-ENOENT).
        Returns the violation, if the observation is impossible."""
        with self._lock:
            st = self._objs.setdefault(oid, _ObjState())
            v = self._check_read_locked(
                client, oid, st, version, payload_ok
            )
            if v is not None:
                self._record(v)
            return v

    def _check_read_locked(
        self, client, oid, st, version, payload_ok
    ) -> Violation | None:
        def vio(kind, **detail):
            return Violation(
                kind=kind,
                oid=oid,
                client=client,
                detail={
                    "observed": version,
                    "acked": st.acked,
                    "indeterminate": sorted(st.indeterminate),
                    "floor": st.floor,
                    **detail,
                },
                t=self._clock() - self._t0,
            )

        if version is None:
            # absent is fine while nothing durable exists, after an
            # acked delete, or while a lost-ack delete may have landed
            if st.acked is None or st.acked[1]:
                return None
            newer_del = [
                v
                for v, d in st.indeterminate.items()
                if d and v > st.acked[0]
            ]
            if newer_del:
                # the delete provably landed: collapse to the newest
                self._settle(st, max(newer_del), True)
                return None
            return vio("lost_acked_write")
        if version not in st.issued:
            return vio("phantom_version")
        if not payload_ok:
            return vio("corrupt_payload")
        if st.issued[version]:
            # a delete's version can never be read back as data
            return vio("phantom_version", note="delete version")
        if st.acked is not None and version == st.acked[0]:
            return None if not st.acked[1] else vio(
                "resurrected_delete"
            )
        if version in st.indeterminate:
            # the lost-ack write landed; the state provably advanced
            self._settle(st, version, st.indeterminate[version])
            return None
        # not the last ack, not a live indeterminate: the state is
        # provably past this version — classify by what superseded it
        over_delete = any(
            d and v > version
            for v, d in st.issued.items()
            if v <= st.floor
        )
        return vio(
            "resurrected_delete" if over_delete else "stale_read"
        )

    def add_violation(
        self, kind: str, detail: dict | None = None
    ) -> Violation:
        """Harness-level findings (e.g. health never converged)."""
        v = Violation(
            kind=kind,
            oid="-",
            client="harness",
            detail=detail or {},
            t=self._clock() - self._t0,
        )
        with self._lock:
            self._record(v)
        return v

    def _record(self, v: Violation) -> None:
        self.violations.append(v)
        if self.perf is not None:
            self.perf.inc("l_thrash_violations")

    # -- summaries ----------------------------------------------------------
    def objects(self) -> list[str]:
        with self._lock:
            return sorted(self._objs)

    def expected_present(self, oid: str) -> bool | None:
        """Final-audit helper: True = data must exist, False = must
        be absent, None = indeterminate either way."""
        with self._lock:
            st = self._objs.get(oid)
            if st is None or st.acked is None:
                return None if st and st.indeterminate else False
            if st.indeterminate:
                return None
            return not st.acked[1]

    def summary(self) -> dict:
        with self._lock:
            return {
                "objects": len(self._objs),
                "violations": [
                    v.to_dict() for v in self.violations
                ],
            }


class HistoryRecorder:
    """The history-recording client workload: N threads, each the
    single writer of its own object set, sync ops only, every outcome
    fed to the oracle the instant it is known (ceph_test_rados'
    write/read/delete mix against a thrashing cluster)."""

    def __init__(
        self,
        io,
        oracle: ConsistencyOracle,
        seed: int,
        clients: int = 2,
        objects_per_client: int = 4,
        op_gap: float = 0.03,
        max_payload: int = 2048,
    ):
        self.io = io
        self.oracle = oracle
        self.seed = int(seed)
        self.n_clients = int(clients)
        self.objects_per_client = int(objects_per_client)
        self.op_gap = float(op_gap)
        self.max_payload = int(max_payload)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.ops = 0
        self.errors = 0
        self._stat_lock = threading.Lock()

    def oids_of(self, client: int) -> list[str]:
        return [
            f"qa-c{client}-o{k}"
            for k in range(self.objects_per_client)
        ]

    def start(self) -> None:
        for c in range(self.n_clients):
            t = threading.Thread(
                target=self._client_loop,
                args=(c,),
                name=f"qa-client-{c}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def stop(self, timeout: float = 60.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)

    def _client_loop(self, c: int) -> None:
        from ..osdc.objecter import ObjectNotFound, RadosError

        name = f"client.{c}"
        rng = Random((self.seed << 16) ^ (c + 1))
        oids = self.oids_of(c)
        versions = {oid: 0 for oid in oids}
        while not self._stop.is_set():
            oid = oids[rng.randrange(len(oids))]
            roll = rng.random()
            with self._stat_lock:
                self.ops += 1
            try:
                if roll < 0.55:
                    versions[oid] += 1
                    v = versions[oid]
                    data = encode_payload(
                        oid, v, rng.randrange(64, self.max_payload)
                    )
                    try:
                        self.io.write_full(oid, data)
                        self.oracle.note_mutation(
                            name, oid, v, acked=True
                        )
                    except RadosError:
                        self.oracle.note_mutation(
                            name, oid, v, acked=False
                        )
                        self._err()
                elif roll < 0.85:
                    try:
                        data = self.io.read(oid)
                        ver, ok = parse_payload(data)
                        self.oracle.note_read(name, oid, ver, ok)
                    except ObjectNotFound:
                        self.oracle.note_read(name, oid, None)
                    except RadosError:
                        self._err()  # read outcome unknown: no claim
                else:
                    versions[oid] += 1
                    v = versions[oid]
                    try:
                        self.io.remove(oid)
                        self.oracle.note_mutation(
                            name, oid, v, acked=True, delete=True
                        )
                    except ObjectNotFound:
                        # definite: nothing was there (counts as an
                        # acked transition to absent)
                        self.oracle.note_mutation(
                            name, oid, v, acked=True, delete=True
                        )
                    except RadosError:
                        self.oracle.note_mutation(
                            name, oid, v, acked=False, delete=True
                        )
                        self._err()
            except Exception:  # noqa: BLE001 — a workload thread
                # must never die silently mid-run; count and continue
                self._err()
            self._stop.wait(self.op_gap)

    def _err(self) -> None:
        with self._stat_lock:
            self.errors += 1

    def final_audit(self, retries: int = 3) -> int:
        """After faults cease and health converges: read EVERY object
        once more through the oracle.  Returns the number of audit
        reads performed."""
        from ..osdc.objecter import ObjectNotFound, RadosError

        audited = 0
        for c in range(self.n_clients):
            for oid in self.oids_of(c):
                for attempt in range(retries):
                    try:
                        data = self.io.read(oid)
                        ver, ok = parse_payload(data)
                        self.oracle.note_read(
                            "audit", oid, ver, ok
                        )
                        audited += 1
                        break
                    except ObjectNotFound:
                        self.oracle.note_read("audit", oid, None)
                        audited += 1
                        break
                    except RadosError:
                        if attempt == retries - 1:
                            self.oracle.add_violation(
                                "audit_read_failed",
                                {"oid": oid},
                            )
                        else:
                            time.sleep(1.0)
        return audited
