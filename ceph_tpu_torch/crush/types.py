"""CRUSH map data model (src/crush/crush.h re-rendered as dataclasses).

Buckets carry their precomputed per-algorithm tables (straws, tree node
weights, list prefix sums) exactly as the C structs do; ``builder``
computes them.  Negative ids are buckets (-1-id indexing in the C is
replaced by a dict keyed on the real id), non-negative ids are devices.
"""

from __future__ import annotations

from dataclasses import dataclass, field

CRUSH_BUCKET_UNIFORM = 1
CRUSH_BUCKET_LIST = 2
CRUSH_BUCKET_TREE = 3
CRUSH_BUCKET_STRAW = 4
CRUSH_BUCKET_STRAW2 = 5

CRUSH_RULE_NOOP = 0
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_FIRSTN = 2
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_FIRSTN = 6
CRUSH_RULE_CHOOSELEAF_INDEP = 7
CRUSH_RULE_SET_CHOOSE_TRIES = 8
CRUSH_RULE_SET_CHOOSELEAF_TRIES = 9
CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES = 10
CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
CRUSH_RULE_SET_CHOOSELEAF_VARY_R = 12
CRUSH_RULE_SET_CHOOSELEAF_STABLE = 13

CRUSH_ITEM_UNDEF = 0x7FFFFFFE
CRUSH_ITEM_NONE = 0x7FFFFFFF

# pool/rule types (rados.h)
PG_POOL_TYPE_REPLICATED = 1
PG_POOL_TYPE_ERASURE = 3


@dataclass
class Tunables:
    """crush.h:354-421; profile presets mirror CrushWrapper.h:144-210.
    Defaults are the jewel/default profile."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1

    @classmethod
    def argonaut(cls):
        return cls(2, 5, 19, 0, 0, 0, 0)

    @classmethod
    def bobtail(cls):
        return cls(0, 0, 50, 1, 0, 0, 1)

    @classmethod
    def firefly(cls):
        return cls(0, 0, 50, 1, 1, 0, 1)

    @classmethod
    def hammer(cls):
        return cls(0, 0, 50, 1, 1, 0, 1)

    @classmethod
    def jewel(cls):
        return cls(0, 0, 50, 1, 1, 1, 1)


@dataclass
class Bucket:
    """One interior node.  ``id`` < 0; weights are 16.16 fixed point."""

    id: int
    type: int
    alg: int
    items: list[int] = field(default_factory=list)
    item_weights: list[int] = field(default_factory=list)
    hash: int = 0  # CRUSH_HASH_RJENKINS1
    weight: int = 0
    # straw (alg 4): per-item straw lengths, 16.16
    straws: list[int] | None = None
    # list (alg 2): prefix weight sums
    sum_weights: list[int] | None = None
    # tree (alg 3): implicit binary tree node weights; items sit at odd
    # node indices (item i at node 2i+1)
    node_weights: list[int] | None = None

    @property
    def size(self) -> int:
        return len(self.items)


@dataclass
class RuleStep:
    op: int
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    """crush_rule + its mask (ruleset/type/min_size/max_size)."""

    steps: list[RuleStep]
    ruleset: int = 0
    type: int = PG_POOL_TYPE_REPLICATED
    min_size: int = 1
    max_size: int = 10


@dataclass
class ChooseArg:
    """Per-bucket straw2 override (crush.h:248-293): position-indexed
    alternative weight sets (the mgr balancer's crush-compat mode) and
    optional id remapping."""

    weight_set: list[list[int]] | None = None  # [position][item] 16.16
    ids: list[int] | None = None
