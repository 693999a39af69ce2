"""Deterministic fault schedules (the thrashosds config surface:
``chance_down``, ``chance_test_map_discontinuity``, ``timeout`` knobs
of qa/tasks/thrashosds, collapsed to one seeded generator).

A ``Schedule`` is a flat, time-ordered list of ``ScheduleEvent``s —
the *entire* chaos plan for a run.  ``Schedule.from_seed`` derives it
from ONE ``random.Random(seed)`` with a fixed draw pattern, so the
same seed always yields the byte-identical event list (and JSON), and
a different seed yields different weather.  Nothing here touches a
cluster: generation is pure, which is what makes replay and shrinking
(qa/shrink.py) trivial — a run is ``execute(schedule)``, a repro is
the schedule JSON, a shrunk repro is a subset of the same list.

Event grammar (args per kind):

========  ==========================================================
kind      effect (executed by qa/thrasher.py)
========  ==========================================================
kill      SIGKILL-equivalent OSD death (WAL abandoned un-flushed)
revive    remount the WAL (crash replay) + reboot the OSD
wal_kill  kill + revive in one step (crash-restart in place)
out       ``ceph osd out`` — CRUSH stops mapping to it
in        ``ceph osd in``
reweight  ``ceph osd reweight`` to args["weight"] (0.5..1.0)
netsplit  isolate osd args["osd"] from every other OSD (symmetric
          partition via msg/faults.py)
heal_netsplit  clear the partition everywhere
lossy     delay+jitter+dup netem rule on the client->osd.N path
clear_faults   clear every rule and partition on every messenger
power_loss     whole-cluster crash: every OSD's WAL abandoned, then
               every OSD remounted (replay) and rebooted
fill_pressure  shrink one OSD's store capacity until it is
               args["ratio"] full (drives OSD_FULL + backoff parks)
fill_release   restore every shrunk capacity
scrub     order an on-demand (deep-)scrub on a random live PG
settle    quiet gap — no fault injected
========  ==========================================================

Events that leave lasting damage are generated in *pairs* (kill ->
revive, netsplit -> heal_netsplit, out -> in, fill_pressure ->
fill_release) a few seconds apart, and the executor runs an
unconditional epilogue regardless — so ANY subset of a schedule (the
shrinker's probes) still converges to a healthy cluster.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from random import Random

SCHEDULE_VERSION = 1

# relative pick weights for the initiating event kinds (the closers —
# revive/in/heal/release — are generated as pairs, never picked)
DEFAULT_WEIGHTS: dict[str, float] = {
    "kill": 3.0,
    "wal_kill": 2.0,
    "out": 1.5,
    "reweight": 1.5,
    "netsplit": 2.0,
    "lossy": 3.0,
    "clear_faults": 1.0,
    "power_loss": 0.75,
    "fill_pressure": 0.75,
    "scrub": 2.0,
    "settle": 2.0,
}

# how long a paired fault stays open: U(lo, hi) seconds
_PAIR_WINDOW = {
    "kill": (2.5, 5.0),
    "out": (2.5, 5.0),
    "netsplit": (2.0, 4.0),
    "fill_pressure": (1.5, 3.0),
}
_CLOSER = {
    "kill": "revive",
    "out": "in",
    "netsplit": "heal_netsplit",
    "fill_pressure": "fill_release",
}


def _r(x: float) -> float:
    """Round for byte-stable JSON (ms resolution is plenty)."""
    return round(float(x), 3)


@dataclass
class ScheduleEvent:
    """One planned fault at offset ``t`` seconds from run start."""

    t: float
    kind: str
    args: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"t": _r(self.t), "kind": self.kind, "args": self.args}

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleEvent":
        return cls(
            t=float(d["t"]),
            kind=str(d["kind"]),
            args=dict(d.get("args", {})),
        )


@dataclass
class Schedule:
    """A full chaos plan: pure data, replayable, shrinkable."""

    seed: int
    duration: float
    osds: int
    events: list[ScheduleEvent] = field(default_factory=list)

    @classmethod
    def from_seed(
        cls,
        seed: int,
        duration: float = 30.0,
        osds: int = 3,
        weights: dict[str, float] | None = None,
        pace: float = 1.0,
    ) -> "Schedule":
        """The generator: ONE Random(seed), a FIXED draw pattern per
        event (kind pick, target pick, per-kind args, pair window) —
        the determinism contract the acceptance criteria assert.
        ``pace`` scales the mean gap between events (>1 = calmer)."""
        rng = Random(int(seed))
        w = dict(DEFAULT_WEIGHTS if weights is None else weights)
        unknown = set(w) - set(DEFAULT_WEIGHTS)
        if unknown:
            raise ValueError(
                f"unknown event kinds: {sorted(unknown)}"
            )
        kinds = sorted(w)  # sorted: dict order must not matter
        cum, total = [], 0.0
        for k in kinds:
            total += max(0.0, float(w[k]))
            cum.append(total)
        events: list[ScheduleEvent] = []
        t = 0.0
        while True:
            t += rng.uniform(0.6, 1.8) * float(pace)
            if t >= duration or total <= 0.0:
                break
            x = rng.uniform(0.0, total)
            kind = next(
                k for k, c in zip(kinds, cum) if x <= c
            )
            ev = ScheduleEvent(t=_r(t), kind=kind, args={})
            # fixed draws per kind — never conditional on state
            osd = rng.randrange(max(1, int(osds)))
            if kind in (
                "kill", "wal_kill", "out", "netsplit",
                "fill_pressure",
            ):
                ev.args = {"osd": osd}
            elif kind == "reweight":
                ev.args = {
                    "osd": osd,
                    "weight": round(rng.uniform(0.5, 1.0), 2),
                }
            elif kind == "lossy":
                ev.args = {
                    "osd": osd,
                    "delay": round(rng.uniform(0.005, 0.03), 3),
                    "jitter": round(rng.uniform(0.0, 0.03), 3),
                    "dup": round(rng.uniform(0.1, 0.4), 2),
                }
            elif kind == "scrub":
                ev.args = {"deep": rng.random() < 0.5}
            if kind == "fill_pressure":
                ev.args["ratio"] = round(rng.uniform(0.955, 0.97), 3)
            events.append(ev)
            closer = _CLOSER.get(kind)
            if closer is not None:
                lo, hi = _PAIR_WINDOW[kind]
                close_args = (
                    {"osd": osd}
                    if closer in ("revive", "in")
                    else {}
                )
                events.append(
                    ScheduleEvent(
                        t=_r(min(t + rng.uniform(lo, hi), duration)),
                        kind=closer,
                        args=close_args,
                    )
                )
        events.sort(key=lambda e: e.t)
        return cls(
            seed=int(seed),
            duration=_r(duration),
            osds=int(osds),
            events=events,
        )

    # -- serialization (the repro/replay surface) ---------------------------
    def to_dict(self) -> dict:
        return {
            "version": SCHEDULE_VERSION,
            "seed": self.seed,
            "duration": self.duration,
            "osds": self.osds,
            "events": [e.to_dict() for e in self.events],
        }

    def to_json(self) -> str:
        """Canonical bytes: sorted keys, no whitespace — the
        byte-identical-across-runs artifact format."""
        return json.dumps(
            self.to_dict(), sort_keys=True, separators=(",", ":")
        )

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        return cls(
            seed=int(d["seed"]),
            duration=float(d["duration"]),
            osds=int(d["osds"]),
            events=[
                ScheduleEvent.from_dict(e) for e in d["events"]
            ],
        )

    @classmethod
    def from_json(cls, text: str) -> "Schedule":
        return cls.from_dict(json.loads(text))

    def subset(self, events: list[ScheduleEvent]) -> "Schedule":
        """The shrinker's probe: same metadata, fewer events."""
        return Schedule(
            seed=self.seed,
            duration=self.duration,
            osds=self.osds,
            events=list(events),
        )
