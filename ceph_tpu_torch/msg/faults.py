"""Fault-injection network plane — netem-style, deterministic,
runtime-controlled (the ms_inject_* option family of
src/common/options.cc:1080-1100 grown into a rule engine; the
qa/tasks netem/partition thrashers' role in-process).

One ``FaultInjector`` hangs off every ``Messenger``; every outbound
frame consults it on the loop thread.  Rules are **directional**:
they apply to what THIS messenger sends toward a destination — a
one-way (asymmetric) lossy link is one rule on one messenger, a
symmetric netsplit is the same partition installed on every member.

Vocabulary (one ``FaultRule`` may combine all of them):

- ``drop``     probability a frame silently vanishes (netem loss);
- ``delay``    fixed per-frame latency, ``jitter`` adds U(0, jitter);
- ``reorder``  probability a frame is held back an extra window so it
               overtakes later frames (netem reorder);
- ``dup``      probability a frame is transmitted twice (netem
               duplicate — duplicated at MESSAGE level, so secure
               mode seals each copy with its own counter and the
               receiver's dedup layers are really exercised);
- partition groups: named sets of daemon names; a frame crossing
  group boundaries is dropped (a netsplit in one call).

Destinations are matched by the connection's ``peer_label`` — the
dialed ``host:port`` for outbound connections, a daemon name where a
higher layer stamped one (session handshakes carry the dialer's
name; the monitor stamps subscribers) — plus any name ``alias``-ed
to that address, so rules can say ``osd.1`` instead of a port.

Determinism: every probabilistic decision draws from ONE seeded RNG,
consumed only on the messenger loop thread, with a FIXED number of
draws per (rule, send) — so a chaos run with a pinned seed replays
the identical decision stream for the identical send sequence.  The
bounded ``decisions`` log makes that replay assertable.

Counters (``l_msgr_fault_dropped/_delayed/_duplicated``) flow through
the existing perf → MMgrReport → prometheus pipe; ``fault set/clear/
list`` is served over the admin socket and the ``ceph tell <daemon>
fault ...`` route.

The legacy ``ms_inject_socket_failures`` knob (every Nth send tears
the connection down) lives here too, as a special rule whose counter
is **per connection** — the old Messenger-global unlocked counter
made concurrent senders skip or double-fire injection windows.
"""

from __future__ import annotations

import itertools
import threading
import zlib
from collections import deque
from dataclasses import dataclass, field
from random import Random

from ..common.perf_counters import PerfCountersBuilder

# extra hold-back applied to a reordered frame when the rule carries
# no base delay (it must overtake SOMETHING)
REORDER_WINDOW = 0.05


def build_msgr_perf(name: str):
    """The messenger fault-plane counter schema (l_msgr_* block) —
    module-level so tools/check_metrics.py lints it without a
    messenger."""
    return (
        PerfCountersBuilder(f"msgr.{name}")
        .add_u64_counter("fault_dropped", "frames dropped by injection")
        .add_u64_counter("fault_delayed", "frames delayed by injection")
        .add_u64_counter(
            "fault_duplicated", "frames duplicated by injection"
        )
        .add_u64_counter(
            "fault_socket_failures",
            "connections torn down by ms_inject_socket_failures",
        )
        .create_perf_counters()
    )


@dataclass
class FaultRule:
    """One directional netem rule (what this messenger sends toward
    ``dst``; ``"*"`` matches every destination)."""

    rule_id: int
    dst: str = "*"
    drop: float = 0.0
    delay: float = 0.0
    jitter: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0

    def describe(self) -> dict:
        return {
            "id": self.rule_id,
            "dst": self.dst,
            "drop": self.drop,
            "delay": self.delay,
            "jitter": self.jitter,
            "dup": self.dup,
            "reorder": self.reorder,
        }


@dataclass
class FaultAction:
    """The verdict for one send."""

    drop: bool = False
    sockfail: bool = False
    delay: float = 0.0
    duplicate: bool = False


@dataclass
class _Partition:
    name: str
    groups: list = field(default_factory=list)  # list[frozenset[str]]


class FaultInjector:
    """Per-messenger fault plane.  The RNG and counters are touched
    only on the messenger's loop thread (``plan`` runs inside
    ``Connection._send``); the configuration surface (rules/
    partitions/aliases) is mutated from OTHER threads (admin socket,
    `ceph tell`, test drivers) — ``_mut_lock`` guards it so ``plan``
    never iterates a container mid-mutation."""

    def __init__(
        self,
        name: str,
        seed: int | None = None,
        rng: Random | None = None,
    ):
        self.name = name
        self._mut_lock = threading.Lock()
        self._rule_seq = itertools.count(1)
        self._rules: dict[int, FaultRule] = {}
        self._partitions: dict[str, _Partition] = {}
        # name -> "host:port" (so rules/partitions can say "osd.1")
        self._aliases: dict[str, str] = {}
        self._names_by_addr: dict[str, set[str]] = {}
        # legacy ms_inject_socket_failures: every Nth send PER
        # CONNECTION tears the connection down (0 = off)
        self.socket_failure_every = 0
        self.perf = build_msgr_perf(name)
        # bounded decision trace — the replay-determinism witness
        self.decisions: deque = deque(maxlen=512)
        self.reseed(seed, rng=rng)

    # -- configuration ------------------------------------------------------
    def reseed(
        self, seed: int | None = None, rng: Random | None = None
    ) -> None:
        """Pin the decision stream.  The messenger name folds into
        the seed so every daemon draws an independent but
        reproducible stream from one cluster-wide seed.  A harness
        that wants to OWN the stream (the qa thrasher's
        single-source-of-randomness contract) can inject its
        ``rng`` instead; there is deliberately no module-global
        fallback anywhere in this file."""
        base = 0 if seed is None else int(seed)
        self.seed = base
        self._rng = (
            rng
            if rng is not None
            else Random((base << 32) ^ zlib.crc32(self.name.encode()))
        )
        self.decisions.clear()

    def alias(self, name: str, addr: str) -> None:
        """Register daemon name -> "host:port" so rules match names."""
        with self._mut_lock:
            old = self._aliases.get(name)
            if old is not None:
                self._names_by_addr.get(old, set()).discard(name)
            self._aliases[name] = addr
            self._names_by_addr.setdefault(addr, set()).add(name)

    def add_rule(
        self,
        dst: str = "*",
        drop: float = 0.0,
        delay: float = 0.0,
        jitter: float = 0.0,
        dup: float = 0.0,
        reorder: float = 0.0,
    ) -> int:
        rule = FaultRule(
            rule_id=next(self._rule_seq),
            dst=str(dst),
            drop=max(0.0, min(1.0, float(drop))),
            delay=max(0.0, float(delay)),
            jitter=max(0.0, float(jitter)),
            dup=max(0.0, min(1.0, float(dup))),
            reorder=max(0.0, min(1.0, float(reorder))),
        )
        with self._mut_lock:
            self._rules[rule.rule_id] = rule
        return rule.rule_id

    def clear(self, rule_id: int | None = None) -> int:
        """Remove one rule, or everything (rules AND partitions)."""
        with self._mut_lock:
            if rule_id is not None:
                return 1 if self._rules.pop(int(rule_id), None) else 0
            n = len(self._rules) + len(self._partitions)
            self._rules.clear()
            self._partitions.clear()
            return n

    def set_partition(self, name: str, groups) -> None:
        """A named netsplit: ``groups`` is a list of daemon-name
        lists; traffic between members of DIFFERENT groups drops.
        Install the same partition on every member messenger for a
        symmetric split."""
        part = _Partition(
            name=str(name),
            groups=[frozenset(str(m) for m in g) for g in groups],
        )
        with self._mut_lock:
            self._partitions[part.name] = part

    def clear_partition(self, name: str) -> int:
        with self._mut_lock:
            return 1 if self._partitions.pop(str(name), None) else 0

    def list_rules(self) -> dict:
        with self._mut_lock:
            return self._list_rules_locked()

    def _list_rules_locked(self) -> dict:
        return {
            "seed": self.seed,
            "rules": [
                r.describe() for r in self._rules.values()
            ],
            "partitions": {
                p.name: [sorted(g) for g in p.groups]
                for p in self._partitions.values()
            },
            "socket_failure_every": self.socket_failure_every,
            "aliases": dict(self._aliases),
        }

    @property
    def active(self) -> bool:
        return bool(
            self._rules
            or self._partitions
            or self.socket_failure_every
        )

    # -- matching -----------------------------------------------------------
    def _labels_of(self, conn) -> set[str]:
        label = getattr(conn, "peer_label", None)
        if not label:
            return set()
        labels = {label}
        labels |= self._names_by_addr.get(label, set())
        addr = self._aliases.get(label)
        if addr:
            labels.add(addr)
        return labels

    def _partition_blocks(self, labels: set[str]) -> bool:
        for part in self._partitions.values():
            mine = next(
                (g for g in part.groups if self.name in g), None
            )
            if mine is None:
                continue
            for g in part.groups:
                if g is mine:
                    continue
                if labels & g:
                    return True
        return False

    # -- the per-send verdict (loop thread only) ----------------------------
    def plan(self, conn) -> FaultAction:
        act = FaultAction()
        n = self.socket_failure_every
        if n:
            # per-connection counter: concurrent senders on OTHER
            # connections can no longer skip or double-fire this
            # connection's injection window (and the loop thread
            # serializes each connection's sends anyway)
            count = getattr(conn, "_sockfail_count", 0) + 1
            conn._sockfail_count = count
            if count % n == 0:
                act.sockfail = True
                self.perf.inc("fault_socket_failures")
                self._log(conn, "sockfail")
                return act
        if not self._rules and not self._partitions:
            return act
        # snapshot the configuration under the lock: admin-socket /
        # tell / test threads mutate these containers while the loop
        # thread plans
        with self._mut_lock:
            labels = self._labels_of(conn)
            blocked = self._partition_blocks(labels)
            rules = list(self._rules.values())
        if blocked:
            act.drop = True
            self.perf.inc("fault_dropped")
            self._log(conn, "partition-drop")
            return act
        rng = self._rng
        for rule in rules:
            if rule.dst != "*" and rule.dst not in labels:
                continue
            # one draw per declared facet, unconditionally — the
            # draw COUNT must not depend on earlier outcomes or the
            # seeded stream desynchronizes across replays
            if rule.drop and rng.random() < rule.drop:
                act.drop = True
            if rule.delay or rule.jitter:
                act.delay += rule.delay + (
                    rng.uniform(0.0, rule.jitter)
                    if rule.jitter
                    else 0.0
                )
            if rule.reorder and rng.random() < rule.reorder:
                act.delay += max(REORDER_WINDOW, act.delay)
            if rule.dup and rng.random() < rule.dup:
                act.duplicate = True
        if act.drop:
            act.delay = 0.0
            act.duplicate = False
            self.perf.inc("fault_dropped")
            self._log(conn, "drop")
            return act
        if act.delay > 0.0:
            self.perf.inc("fault_delayed")
        if act.duplicate:
            self.perf.inc("fault_duplicated")
        if act.delay > 0.0 or act.duplicate:
            self._log(
                conn,
                f"delay={act.delay:.6f}"
                + (" dup" if act.duplicate else ""),
            )
        return act

    def _log(self, conn, what: str) -> None:
        self.decisions.append(
            (getattr(conn, "peer_label", None) or "?", what)
        )

    # -- command surface (admin socket + `ceph tell <daemon> fault`) --------
    def command(self, args: dict) -> dict:
        """One `fault ...` command; ``args`` is the JSON command dict
        minus its prefix, plus ``op`` = set | clear | list | seed.
        Returns a JSON-able reply (raises ValueError on bad input)."""
        op = str(args.get("op", "list"))
        if op == "list":
            return self.list_rules()
        if op == "seed":
            self.reseed(int(args["seed"]))
            return {"seed": self.seed}
        if op == "set":
            if "partition" in args:
                groups = args.get("groups") or []
                if not isinstance(groups, list) or not all(
                    isinstance(g, (list, tuple)) for g in groups
                ):
                    raise ValueError(
                        "partition groups must be a list of lists"
                    )
                self.set_partition(args["partition"], groups)
                return {"partition": str(args["partition"])}
            rule_id = self.add_rule(
                dst=args.get("dst", "*"),
                drop=args.get("drop", 0.0),
                delay=args.get("delay", 0.0),
                jitter=args.get("jitter", 0.0),
                dup=args.get("dup", 0.0),
                reorder=args.get("reorder", 0.0),
            )
            return {"rule_id": rule_id}
        if op == "clear":
            if "partition" in args:
                return {
                    "cleared": self.clear_partition(args["partition"])
                }
            if "id" in args:
                return {"cleared": self.clear(int(args["id"]))}
            return {"cleared": self.clear()}
        raise ValueError(f"unknown fault op {op!r}")

    def register_admin_commands(self, asok) -> None:
        """`fault set/clear/list` over the admin socket (the
        `ceph daemon <name> fault ...` interaction)."""
        asok.register_command(
            "fault set",
            lambda args: self.command({**args, "op": "set"}),
            "install a fault rule or named partition",
        )
        asok.register_command(
            "fault clear",
            lambda args: self.command({**args, "op": "clear"}),
            "remove a fault rule / partition / everything",
        )
        asok.register_command(
            "fault list",
            lambda args: self.command({"op": "list"}),
            "dump active fault rules, partitions and the seed",
        )
