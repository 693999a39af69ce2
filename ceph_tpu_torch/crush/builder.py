"""CrushMap construction — builder.c + the CrushWrapper editing surface.

Computes the per-algorithm derived tables at insert time exactly as
crush_make_*_bucket do (src/crush/builder.c): straw lengths (v0/v1
crush_calc_straw, builder.c:431), tree node weights
(crush_make_tree_bucket, builder.c:340), list prefix sums.  Name/type
maps and add_simple_rule mirror CrushWrapper (CrushWrapper.cc
add_simple_rule_at).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .mapper import crush_do_rule
from .types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
    Bucket,
    ChooseArg,
    Rule,
    RuleStep,
    Tunables,
)


def _calc_straws(weights: list[int], version: int) -> list[int]:
    """crush_calc_straw (builder.c:431-525): straw lengths such that
    P(argmax_i hash16*straw_i = i) ∝ weight_i, computed by ascending-
    weight sweep.  v1 fixes the equal-weight bookkeeping bug of v0."""
    size = len(weights)
    straws = [0] * size
    if size == 0:
        return straws
    # ascending insertion order, stable (reverse sort by weight in the C)
    order = sorted(range(size), key=lambda i: (weights[i], i))
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if weights[order[i]] == 0:
            straws[order[i]] = 0
            i += 1
            if version >= 1:
                numleft -= 1
            continue
        straws[order[i]] = int(straw * 0x10000)
        i += 1
        if i == size:
            break
        if version == 0 and weights[order[i]] == weights[order[i - 1]]:
            continue
        wbelow += (weights[order[i - 1]] - lastw) * numleft
        if version == 0:
            j = i
            while j < size and weights[order[j]] == weights[order[i]]:
                numleft -= 1
                j += 1
        else:
            numleft -= 1
        wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
        pbelow = wbelow / (wbelow + wnext)
        straw *= (1.0 / pbelow) ** (1.0 / numleft)
        lastw = weights[order[i - 1]]
    return straws


def _calc_tree(weights: list[int]) -> list[int]:
    """Implicit-binary-tree node weights (crush_make_tree_bucket,
    builder.c:340-397): item i at node 2i+1; parents sum children."""
    size = len(weights)
    if size == 0:
        return []
    depth = 1
    t = size - 1
    while t:
        t >>= 1
        depth += 1
    num_nodes = 1 << depth
    node_weights = [0] * num_nodes
    for i, wt in enumerate(weights):
        node = (i + 1 << 1) - 1
        node_weights[node] = wt
        for _ in range(1, depth):
            # parent: flip direction bit at this height
            h = 0
            n = node
            while (n & 1) == 0:
                h += 1
                n >>= 1
            if node & (1 << (h + 1)):
                node = node - (1 << h)
            else:
                node = node + (1 << h)
            node_weights[node] += wt
    return node_weights


@dataclass
class CrushMap:
    """Editable map + query API (the CrushWrapper role)."""

    tunables: Tunables = field(default_factory=Tunables)
    buckets: dict[int, Bucket] = field(default_factory=dict)
    rules: list[Rule | None] = field(default_factory=list)
    max_devices: int = 0
    choose_args: dict[int, ChooseArg] = field(default_factory=dict)
    # device classes (CrushWrapper class_map / class_bucket)
    class_map: dict[int, int] = field(default_factory=dict)
    class_names: dict[int, str] = field(default_factory=dict)
    class_bucket: dict[int, dict[int, int]] = field(default_factory=dict)
    # name maps (CrushWrapper name_map/type_map)
    type_names: dict[int, str] = field(
        default_factory=lambda: {0: "osd", 1: "host", 2: "rack", 3: "root"}
    )
    item_names: dict[int, str] = field(default_factory=dict)
    rule_names: dict[int, str] = field(default_factory=dict)
    # Bumped by every mutator; consumers that compile the map to dense
    # device arrays (osd/mapping.py) key their cache on this so a
    # topology or weight change invalidates the compiled form.
    mutation: int = 0

    @classmethod
    def copy_from(cls, other) -> "CrushMap":
        """A map equal to ``other``, any object with the reference
        CrushMap's fields, read by attribute (buckets with their derived
        tables, rules, tunables, choose_args, names and device classes).
        Nothing of ``other`` is shared or imported."""
        t = other.tunables
        m = cls(
            tunables=Tunables(
                t.choose_local_tries,
                t.choose_local_fallback_tries,
                t.choose_total_tries,
                t.chooseleaf_descend_once,
                t.chooseleaf_vary_r,
                t.chooseleaf_stable,
                t.straw_calc_version,
            ),
            max_devices=other.max_devices,
        )

        def opt(v):
            return None if v is None else list(v)

        for bid, b in other.buckets.items():
            m.buckets[bid] = Bucket(
                id=b.id,
                type=b.type,
                alg=b.alg,
                items=list(b.items),
                item_weights=list(b.item_weights),
                hash=b.hash,
                weight=b.weight,
                straws=opt(b.straws),
                sum_weights=opt(b.sum_weights),
                node_weights=opt(b.node_weights),
            )
        for r in other.rules:
            m.rules.append(
                None
                if r is None
                else Rule(
                    steps=[RuleStep(s.op, s.arg1, s.arg2) for s in r.steps],
                    ruleset=r.ruleset,
                    type=r.type,
                    min_size=r.min_size,
                    max_size=r.max_size,
                )
            )
        m.choose_args = {
            bid: ChooseArg(
                weight_set=(
                    None
                    if a.weight_set is None
                    else [list(ws) for ws in a.weight_set]
                ),
                ids=opt(a.ids),
            )
            for bid, a in other.choose_args.items()
        }
        m.class_map = dict(other.class_map)
        m.class_names = dict(other.class_names)
        m.class_bucket = {k: dict(v) for k, v in other.class_bucket.items()}
        m.type_names = dict(other.type_names)
        m.item_names = dict(other.item_names)
        m.rule_names = dict(other.rule_names)
        return m

    def touch(self) -> None:
        """Record a structural/weight mutation (invalidates compiled
        caches).  Call after mutating buckets/rules/tunables directly."""
        self.mutation += 1

    def set_choose_args(self, args: dict[int, ChooseArg]) -> None:
        """Install per-bucket straw2 overrides (the balancer's
        crush-compat weight-set path, CrushWrapper.h:1447) and
        invalidate compiled caches."""
        self.choose_args = dict(args)
        self.touch()

    # -- device classes (CrushWrapper class_map + shadow trees) ------------
    def get_class_id(self, name: str, create: bool = False) -> int:
        for cid, n in self.class_names.items():
            if n == name:
                return cid
        if not create:
            raise KeyError(f"device class {name!r} does not exist")
        cid = max(self.class_names, default=-1) + 1
        self.class_names[cid] = name
        return cid

    def set_item_class(self, item: int, class_name: str) -> None:
        """Tag a device with a class (CrushWrapper::set_item_class);
        shadow trees pick it up at the next populate_classes()."""
        self.class_map[item] = self.get_class_id(class_name, create=True)
        self.touch()

    def _roots(self) -> list[int]:
        """Bucket ids not referenced by any other non-shadow bucket."""
        shadows = {
            c for per in self.class_bucket.values() for c in per.values()
        }
        referenced: set[int] = set()
        for bid, b in self.buckets.items():
            if bid in shadows:
                continue
            referenced.update(i for i in b.items if i < 0)
        return [
            bid
            for bid in self.buckets
            if bid not in shadows and bid not in referenced
        ]

    def populate_classes(self) -> None:
        """(Re)build the per-class shadow hierarchies
        (CrushWrapper::populate_classes → device_class_clone,
        CrushWrapper.cc:2681): for every class and every root, a clone
        named ``<name>~<class>`` holding only that class's devices,
        with sub-bucket clones always included (possibly empty) and
        weights rolled up from the included items.  Existing clones
        keep their ids across rebuilds (the old_class_bucket reuse)."""
        live = {
            c
            for item, c in self.class_map.items()
            if item >= 0
        }
        for per in self.class_bucket.values():
            for cls, cid_clone in per.items():
                self.buckets.pop(cid_clone, None)
                if cls not in live:
                    # retired class: its clone ids stay RESERVED in
                    # class_bucket (never reallocated — a rule may
                    # still TAKE them, and the class may return) but
                    # the shadow buckets and names disappear from the
                    # map until then
                    self.item_names.pop(cid_clone, None)
        roots = self._roots()
        for cls in sorted(live):
            for root in sorted(roots, reverse=True):
                self._device_class_clone(root, cls)
        self.touch()

    def _device_class_clone(self, original_id: int, cls: int) -> int:
        existing = self.class_bucket.get(original_id, {}).get(cls)
        if existing is not None and existing in self.buckets:
            return existing
        orig = self.buckets[original_id]
        items: list[int] = []
        weights: list[int] = []
        for item, w in zip(orig.items, orig.item_weights):
            if item >= 0:
                if self.class_map.get(item) == cls:
                    items.append(item)
                    weights.append(w)
            else:
                child = self._device_class_clone(item, cls)
                items.append(child)
                weights.append(self.buckets[child].weight)
        if existing is not None:
            new_id = existing
        else:
            # like the C's used_ids set: never hand out an id reserved
            # by ANY clone (even one whose bucket is mid-rebuild)
            reserved = {
                c
                for per in self.class_bucket.values()
                for c in per.values()
            }
            new_id = min(set(self.buckets) | reserved, default=0) - 1
            while new_id in self.buckets or new_id in reserved:
                new_id -= 1
        if orig.alg == CRUSH_BUCKET_UNIFORM and weights:
            # a uniform clone keeps the per-item weight invariant
            weights = [weights[0]] * len(weights)
        self.add_bucket(
            orig.alg,
            orig.type,
            items,
            weights,
            id=new_id,
            name=(
                f"{self.item_names[original_id]}~{self.class_names[cls]}"
                if original_id in self.item_names
                else None
            ),
            hash=orig.hash,
        )
        self.class_bucket.setdefault(original_id, {})[cls] = new_id
        self.class_map[new_id] = cls
        return new_id

    def _name_to_item(self, name: str) -> int:
        for item, n in self.item_names.items():
            if n == name:
                return item
        raise KeyError(f"item {name!r} does not exist")

    def _type_id(self, name: str) -> int:
        for t, n in self.type_names.items():
            if n == name:
                return t
        raise KeyError(f"type {name!r} does not exist")

    # -- construction ------------------------------------------------------
    def add_bucket(
        self,
        alg: int,
        type: int,
        items: list[int] | None = None,
        weights: list[int] | None = None,
        id: int | None = None,
        name: str | None = None,
        hash: int = 0,
    ) -> int:
        """crush_add_bucket + crush_make_bucket: computes derived tables
        and registers the bucket.  Weights are 16.16 fixed point; device
        items must be >= 0, sub-buckets already added."""
        items = list(items or [])
        weights = list(weights or [])
        assert len(items) == len(weights)
        if alg == CRUSH_BUCKET_UNIFORM and weights:
            assert all(w == weights[0] for w in weights), (
                "uniform buckets have one item weight"
            )
        if id is None:
            id = min(self.buckets, default=0) - 1
        assert id < 0 and id not in self.buckets
        b = Bucket(
            id=id,
            type=type,
            alg=alg,
            items=items,
            item_weights=weights,
            hash=hash,
            weight=sum(weights),
        )
        if alg == CRUSH_BUCKET_LIST:
            acc, sums = 0, []
            for w in weights:
                acc += w
                sums.append(acc)
            b.sum_weights = sums
        elif alg == CRUSH_BUCKET_TREE:
            b.node_weights = _calc_tree(weights)
        elif alg == CRUSH_BUCKET_STRAW:
            b.straws = _calc_straws(
                weights, self.tunables.straw_calc_version
            )
        self.buckets[id] = b
        self.touch()
        for item in items:
            if item >= 0:
                self.max_devices = max(self.max_devices, item + 1)
        if name is not None:
            self.item_names[id] = name
        return id

    def add_rule(self, rule: Rule, ruleno: int | None = None) -> int:
        if ruleno is None:
            ruleno = len(self.rules)
        while len(self.rules) <= ruleno:
            self.rules.append(None)
        assert self.rules[ruleno] is None
        self.rules[ruleno] = rule
        rule.ruleset = ruleno
        self.touch()
        return ruleno

    def add_simple_rule(
        self,
        name: str,
        root_name: str,
        failure_domain: str = "",
        device_class: str = "",
        mode: str = "firstn",
        rule_type: int | None = None,
    ) -> int:
        """CrushWrapper::add_simple_rule_at semantics: TAKE root,
        CHOOSELEAF over the failure domain (or CHOOSE osd for a flat
        domain), EMIT; indep rules prepend SET_CHOOSELEAF_TRIES 5 and
        SET_CHOOSE_TRIES 100.  A device class resolves the TAKE to the
        class's shadow root ``<root>~<class>`` (built on demand)."""
        assert mode in ("firstn", "indep"), mode
        if device_class:
            self.get_class_id(device_class)  # must exist
            shadow = f"{root_name}~{device_class}"
            try:
                root = self._name_to_item(shadow)
            except KeyError:
                self.populate_classes()
                root = self._name_to_item(shadow)
        else:
            root = self._name_to_item(root_name)
        dtype = self._type_id(failure_domain) if failure_domain else 0
        steps: list[RuleStep] = []
        if mode == "indep":
            steps.append(RuleStep(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5))
            steps.append(RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 100))
        steps.append(RuleStep(CRUSH_RULE_TAKE, root))
        if dtype:
            steps.append(
                RuleStep(
                    CRUSH_RULE_CHOOSELEAF_FIRSTN
                    if mode == "firstn"
                    else CRUSH_RULE_CHOOSELEAF_INDEP,
                    0,
                    dtype,
                )
            )
        else:
            steps.append(
                RuleStep(
                    CRUSH_RULE_CHOOSE_FIRSTN
                    if mode == "firstn"
                    else CRUSH_RULE_CHOOSE_INDEP,
                    0,
                    0,
                )
            )
        steps.append(RuleStep(CRUSH_RULE_EMIT))
        rule = Rule(
            steps=steps,
            type=1 if mode == "firstn" else 3,
            min_size=1 if mode == "firstn" else 3,
            max_size=10 if mode == "firstn" else 20,
        )
        ruleno = self.add_rule(rule)
        self.rule_names[ruleno] = name
        return ruleno

    # -- query -------------------------------------------------------------
    def find_rule(self, ruleset: int, type: int, size: int) -> int:
        """crush_find_rule (mapper.c:41-54)."""
        for i, r in enumerate(self.rules):
            if (
                r is not None
                and r.ruleset == ruleset
                and r.type == type
                and r.min_size <= size <= r.max_size
            ):
                return i
        return -1

    def do_rule(
        self,
        ruleno: int,
        x: int,
        result_max: int,
        weight: list[int] | None = None,
        choose_args=None,
    ) -> list[int]:
        if weight is None:
            weight = [0x10000] * self.max_devices
        return crush_do_rule(
            self, ruleno, x, result_max, weight, choose_args
        )
