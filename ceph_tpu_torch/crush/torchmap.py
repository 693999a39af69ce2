"""Batched CRUSH in torch — the PG mapper of ceph_tpu_torch.

The reference recomputes every PG's placement by sharding pgid ranges
over a thread pool (src/osd/OSDMapMapping.h:18-156).  Here a straw2 map
compiles to dense int64 tensors on the card (``compile_map``) and one
call runs ``crush_do_rule`` for a whole batch of PGs: every lane of the
batch is a PG, every register of the C state machine is a tensor over
the lanes, and every branch is a ``torch.where``.

Scope: straw2 buckets, tunables with choose_local_tries ==
choose_local_fallback_tries == 0, rule programs of [SET_*...] TAKE
CHOOSE[LEAF] EMIT groups, firstn and indep.  Maps outside the reference
device kernel's scope raise ``UnsupportedMap`` (callers use the exact
oracle, ``mapper``); maps with legacy bucket algorithms or choose_args
raise ``NotImplementedError`` (not ported yet).

Exactness: the rjenkins hash runs on int32 words (wrapping subtract and
shift-left, masked logical shift-right), ``crush_ln`` gathers the three
int64 tables of ``ln`` and does the C's integer arithmetic in int64
(including the wrapping ``x * RH``), and the straw2 draw divides with
truncation toward zero like ``div64_s64``.  Two execution strategies per
rule group, as in the reference device kernel:

* FAST (firstn groups on acyclic maps): the candidate descents for
  r' = 0..R0-1 and their chooseleaf descents are drawn in batched rounds
  up front, then a masked loop replays the C state machine over those
  tables; lanes whose retries outrun the window come back with
  ``ok == False`` and are re-mapped by the oracle
  (``apply_oracle_fallback``).
* GENERIC (everything else): one bucket draw per lane per loop step;
  descent levels, retries and the chooseleaf recursion are registers.
  Finished lanes are dropped from the batch as the loop goes.
"""

from __future__ import annotations

import collections
import math
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from .ln import _tables as _ln_tables
from .types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
)

MAX_DEPTH = 16  # CRUSH_MAX_DEPTH is 10
S64_MIN = -(1 << 63)
CHUNK = 1 << 19  # lanes a call of batch_do_rule maps at once
SYNC_EVERY = 8  # generic chooser steps between reads of the done mask

# Lanes re-mapped by apply_oracle_fallback since import (the speculation
# overflow of the fast firstn path); callers zero it and read it.
fallback_lanes = 0


class UnsupportedMap(ValueError):
    """Map/rule shape outside the batched mapper's scope; use the oracle."""


# -- primitives on tensors -------------------------------------------------

_SEED = 1315423911
_X0, _Y0 = 231232, 1232


def _srl(v, s: int):
    """Logical right shift of int32 words."""
    return (v >> s) & ((1 << (32 - s)) - 1)


def _mix(a, b, c):
    """crush_hashmix (hash.c:12-22) on int32 words: subtraction and
    shift-left wrap like uint32, shift-right is made logical."""
    a = a - b
    a = a - c
    a = a ^ _srl(c, 13)
    b = b - c
    b = b - a
    b = b ^ (a << 8)
    c = c - a
    c = c - b
    c = c ^ _srl(b, 13)
    a = a - b
    a = a - c
    a = a ^ _srl(c, 12)
    b = b - c
    b = b - a
    b = b ^ (a << 16)
    c = c - a
    c = c - b
    c = c ^ _srl(b, 5)
    a = a - b
    a = a - c
    a = a ^ _srl(c, 3)
    b = b - c
    b = b - a
    b = b ^ (a << 10)
    c = c - a
    c = c - b
    c = c ^ _srl(b, 15)
    return a, b, c


def hash3(a, b, c):
    """rjenkins1 arity 3 (hash.c:48-59) on int32 tensors (broadcast);
    the result is the uint32 hash's bit pattern as int32."""
    with record_function("crush.hash"):
        h = a ^ b ^ c ^ _SEED
        a, b, h = _mix(a, b, h)
        c, x, h = _mix(c, _X0, h)
        y, a, h = _mix(_Y0, a, h)
        b, x, h = _mix(b, x, h)
        y, c, h = _mix(y, c, h)
        return h


def hash2(a, b):
    """rjenkins1 arity 2 (hash.c:37-46) on int32 tensors."""
    with record_function("crush.hash"):
        h = a ^ b ^ _SEED
        a, b, h = _mix(a, b, h)
        x, a, h = _mix(_X0, a, h)
        b, y, h = _mix(b, _Y0, h)
        return h


def crush_ln(u, rh_t, lh_t, ll_t):
    """2^44*log2(u+1) for u in [0, 0xffff] (mapper.c:248-290), int64.

    ``rh_t``, ``lh_t``, ``ll_t`` are ``ln._tables()`` on u's device.
    ``x * RH`` reaches 2^63 and wraps, like the C; only bits 48-55 of it
    are used."""
    with record_function("crush.ln"):
        x = u.to(torch.int64) + 1
        bitlen = torch.frexp(x.to(torch.float32)).exponent.to(torch.int64)
        shift = torch.where((x & 0x18000) == 0, 16 - bitlen, 0)
        x = x << shift
        k = (x >> 8) - 128
        index2 = ((x * rh_t[k]) >> 48) & 0xFF
        return ((15 - shift) << 44) + ((lh_t[k] + ll_t[index2]) >> 4)


# -- map compilation -------------------------------------------------------


@dataclass(frozen=True, eq=False)
class CompiledMap:
    """Dense int64 rendering of a straw2 CrushMap on one device."""

    items: torch.Tensor  # (nb, sz) item ids, 0 past a bucket's size
    weights: torch.Tensor  # (nb, sz) 16.16 item weights, 0 past size
    sizes: torch.Tensor  # (nb,)
    types: torch.Tensor  # (nb,)
    algs: torch.Tensor  # (nb,)
    ids: torch.Tensor  # (nb,) bucket ids; row order is descending id
    bidx: torch.Tensor  # (max_neg,) (-1-id) -> row, -1 for gaps
    # derived for the draw: int32 hash inputs, divisors with 0 -> 1,
    # and which columns draw at all (weight > 0)
    items32: torch.Tensor
    wdiv: torch.Tensor
    wlive: torch.Tensor
    ln_rh: torch.Tensor  # (129,) int64
    ln_lh: torch.Tensor  # (129,)
    ln_ll: torch.Tensor  # (256,)
    device: torch.device
    sz: int
    nb: int
    max_devices: int
    tunables: tuple  # (total_tries, descend_once, vary_r, stable)
    rules: tuple
    # host side: the static bucket graph the fast path plans from, and
    # the source map for the oracle fallback
    host_bidx: tuple
    np_items: np.ndarray
    np_sizes: np.ndarray
    np_types: np.ndarray
    np_algs: np.ndarray
    source: object
    source_mutation: int
    # structural key: everything a plan depends on except the weights,
    # so a weights-only epoch change reuses the cached plans
    skey: tuple


def compile_map(cmap, device=None) -> CompiledMap:
    """CrushMap -> dense int64 tensors on ``device`` (default ``cuda``).

    Raises UnsupportedMap where the reference device kernel does (callers
    map through the oracle) and NotImplementedError for legacy bucket
    algorithms and choose_args, which are not ported yet."""
    t = cmap.tunables
    if t.choose_local_tries or t.choose_local_fallback_tries:
        raise UnsupportedMap(
            "choose_local_(fallback_)tries != 0 needs the legacy perm "
            "fallback; use the oracle"
        )
    if not cmap.buckets:
        raise UnsupportedMap("empty map")
    for b in cmap.buckets.values():
        if b.alg not in (
            CRUSH_BUCKET_STRAW2,
            CRUSH_BUCKET_UNIFORM,
            CRUSH_BUCKET_STRAW,
            CRUSH_BUCKET_LIST,
            CRUSH_BUCKET_TREE,
        ):
            raise UnsupportedMap(
                f"bucket {b.id} alg {b.alg}: unknown bucket alg"
            )
    for b in cmap.buckets.values():
        if b.alg != CRUSH_BUCKET_STRAW2:
            raise NotImplementedError(
                f"bucket {b.id} alg {b.alg}: only straw2 buckets are "
                "ported to the batched mapper (ROADMAP A1b)"
            )
    if cmap.choose_args:
        raise NotImplementedError(
            "choose_args are not ported to the batched mapper (ROADMAP A1b)"
        )
    nb = len(cmap.buckets)
    sz = max(max(b.size for b in cmap.buckets.values()), 1)
    items = np.zeros((nb, sz), dtype=np.int64)
    weights = np.zeros((nb, sz), dtype=np.int64)
    sizes = np.zeros(nb, dtype=np.int64)
    types = np.zeros(nb, dtype=np.int64)
    algs = np.zeros(nb, dtype=np.int64)
    ids = np.zeros(nb, dtype=np.int64)
    max_neg = max(-b.id for b in cmap.buckets.values())
    bidx = np.full(max_neg, -1, dtype=np.int64)
    for row, b in enumerate(
        sorted(cmap.buckets.values(), key=lambda b: -b.id)
    ):
        items[row, : b.size] = b.items
        weights[row, : b.size] = b.item_weights
        sizes[row] = b.size
        types[row] = b.type
        algs[row] = b.alg
        ids[row] = b.id
        bidx[-1 - b.id] = row
        if b.size and max(abs(i) for i in b.items) >= 1 << 24:
            raise UnsupportedMap("item id magnitude >= 2^24")
        if abs(b.id) >= 1 << 24:
            raise UnsupportedMap("bucket id magnitude >= 2^24")
        if b.weight >= 1 << 32:
            raise UnsupportedMap("bucket weight >= 2^32")

    rules = tuple(
        None if rule is None else _compile_rule(rule) for rule in cmap.rules
    )
    tun = (
        t.choose_total_tries + 1,
        t.chooseleaf_descend_once,
        t.chooseleaf_vary_r,
        t.chooseleaf_stable,
    )
    skey = (
        sz,
        nb,
        cmap.max_devices,
        items.tobytes(),
        sizes.tobytes(),
        types.tobytes(),
        algs.tobytes(),
        ids.tobytes(),
        bidx.tobytes(),
        tun,
        rules,
    )
    dev = torch.device("cuda" if device is None else device)

    def on(a):
        return torch.as_tensor(a, device=dev)

    rh, lh, ll = _ln_tables()
    return CompiledMap(
        items=on(items),
        weights=on(weights),
        sizes=on(sizes),
        types=on(types),
        algs=on(algs),
        ids=on(ids),
        bidx=on(bidx),
        items32=on(items.astype(np.int32)),
        wdiv=on(np.where(weights > 0, weights, 1)),
        wlive=on(weights > 0),
        ln_rh=on(rh),
        ln_lh=on(lh),
        ln_ll=on(ll),
        device=dev,
        sz=sz,
        nb=nb,
        max_devices=cmap.max_devices,
        tunables=tun,
        rules=rules,
        host_bidx=tuple(int(v) for v in bidx),
        np_items=items,
        np_sizes=sizes,
        np_types=types,
        np_algs=algs,
        source=cmap,
        source_mutation=getattr(cmap, "mutation", 0),
        skey=skey,
    )


def _compile_rule(rule):
    """Rule -> tuple of (op, arg1, arg2) groups: [set-overrides..., take,
    choose, emit] repeated; raises UnsupportedMap on other shapes."""
    groups = []
    overrides = {}
    take = None
    choose = None
    for step in rule.steps:
        if step.op in (
            CRUSH_RULE_SET_CHOOSE_TRIES,
            CRUSH_RULE_SET_CHOOSELEAF_TRIES,
            CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
            CRUSH_RULE_SET_CHOOSELEAF_STABLE,
            CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
            CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
        ):
            if step.op in (
                CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
            ):
                if step.arg1 > 0:
                    raise UnsupportedMap("local tries override")
                continue
            # the C applies tries overrides only when > 0 and
            # vary_r/stable only when >= 0 (mapper.c:963-991)
            if step.op in (
                CRUSH_RULE_SET_CHOOSE_TRIES,
                CRUSH_RULE_SET_CHOOSELEAF_TRIES,
            ):
                if step.arg1 > 0:
                    overrides[step.op] = step.arg1
            elif step.arg1 >= 0:
                overrides[step.op] = step.arg1
        elif step.op == CRUSH_RULE_TAKE:
            take = step.arg1
        elif step.op in (
            CRUSH_RULE_CHOOSE_FIRSTN,
            CRUSH_RULE_CHOOSELEAF_FIRSTN,
            CRUSH_RULE_CHOOSE_INDEP,
            CRUSH_RULE_CHOOSELEAF_INDEP,
        ):
            if take is None or choose is not None:
                raise UnsupportedMap("rule shape: choose without take")
            choose = (step.op, step.arg1, step.arg2)
        elif step.op == CRUSH_RULE_EMIT:
            if take is None or choose is None:
                raise UnsupportedMap("rule shape: emit without choose")
            groups.append(
                (take, choose, tuple(sorted(overrides.items())))
            )
            take = choose = None
        else:
            raise UnsupportedMap(f"rule op {step.op}")
    if take is not None or choose is not None:
        raise UnsupportedMap("rule does not end with EMIT")
    return tuple(groups)


# -- host planning ---------------------------------------------------------

# Speculation bounds for the fast firstn path.  _SPEC_TRIES extra
# retries per replica are precomputed; a lane that needs more falls
# back to the exact host oracle (flagged via the ok output).
_SPEC_TRIES = 8
_LEAF_SPEC = 4  # max speculated chooseleaf retries (descend_once => 1)
_SPEC_BUDGET = 512  # max speculative draws per lane per rule group

_K_FOUND, _K_BAD, _K_RETRY, _K_OVER = 0, 1, 2, 3


def _descent_steps(cm: CompiledMap, start_rows, ttype: int):
    """Per-level reachable bucket sets for a descent from
    ``start_rows`` toward ``ttype``, from the static bucket graph.

    Returns (steps, found_rows): steps[i] describes the buckets a
    descent can be drawing from at its i-th draw (the fast path draws
    each round over that set's widest bucket only) and found_rows the
    target-type buckets the descent can land on (the chooseleaf
    domains).  Returns (None, None) when a cycle (or > MAX_DEPTH chain)
    makes the level structure unbounded.  A draw that lands on a bucket
    of the target type (ttype != 0) terminates; for ttype == 0 only
    devices terminate."""
    sizes, types, items = cm.np_sizes, cm.np_types, cm.np_items
    bidx = cm.host_bidx
    cur = set(start_rows)
    steps = []
    found: set = set()
    while cur:
        if len(steps) >= MAX_DEPTH:
            return None, None
        rows = tuple(sorted(cur))
        steps.append(
            {
                "rows": rows,
                "sz": max((int(sizes[r]) for r in rows), default=1) or 1,
                "algs": tuple(sorted({int(cm.np_algs[r]) for r in rows})),
                "usz": max(
                    (
                        int(sizes[r])
                        for r in rows
                        if int(cm.np_algs[r]) == CRUSH_BUCKET_UNIFORM
                    ),
                    default=0,
                )
                or 1,
            }
        )
        nxt: set = set()
        for row in cur:
            for it in items[row, : sizes[row]]:
                it = int(it)
                if it >= 0:
                    continue  # device: terminal
                neg = -1 - it
                if neg >= len(bidx) or bidx[neg] < 0:
                    continue  # invalid item: terminal
                r2 = bidx[neg]
                if ttype != 0 and types[r2] == ttype:
                    found.add(r2)
                    continue
                nxt.add(r2)
        cur = nxt
    return steps, found


def _plan_groups(
    cm: CompiledMap, ruleno: int, result_max: int, spec_boost: int = 0
):
    """Host-side pre-pass over a rule's groups: resolve TAKE rows,
    tries/tunables, and decide per group whether the speculative fast
    path applies (firstn, acyclic bounded-depth descent)."""
    groups = cm.rules[ruleno]
    if groups is None:
        raise UnsupportedMap(f"no rule {ruleno}")
    total_tries, descend_once, vary_r_t, stable_t = cm.tunables
    plans = []
    for take, (op, arg1, arg2), overrides in groups:
        ov = dict(overrides)
        tries = ov.get(CRUSH_RULE_SET_CHOOSE_TRIES, total_tries)
        leaf_override = ov.get(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 0)
        vary_r = ov.get(CRUSH_RULE_SET_CHOOSELEAF_VARY_R, vary_r_t)
        stable = ov.get(CRUSH_RULE_SET_CHOOSELEAF_STABLE, stable_t)
        numrep = arg1 if arg1 > 0 else result_max + arg1
        if numrep <= 0:
            continue
        nslots = min(numrep, result_max)
        if take >= 0:
            raise UnsupportedMap("TAKE of a device (not a bucket)")
        if -1 - take >= len(cm.host_bidx):
            raise UnsupportedMap(f"TAKE of unknown bucket {take}")
        take_row = cm.host_bidx[-1 - take]
        if take_row < 0:
            raise UnsupportedMap(f"TAKE of unknown bucket {take}")
        firstn = op in (
            CRUSH_RULE_CHOOSE_FIRSTN,
            CRUSH_RULE_CHOOSELEAF_FIRSTN,
        )
        leaf = op in (
            CRUSH_RULE_CHOOSELEAF_FIRSTN,
            CRUSH_RULE_CHOOSELEAF_INDEP,
        )
        if firstn:
            if leaf_override:
                leaf_tries = leaf_override
            elif descend_once:
                leaf_tries = 1
            else:
                leaf_tries = tries
        else:
            leaf_tries = leaf_override if leaf_override else 1
        plan = {
            "take_row": take_row,
            "ttype": arg2,
            "numrep": numrep,
            "nslots": nslots,
            "tries": tries,
            "leaf_tries": leaf_tries,
            "vary_r": vary_r,
            "stable": stable,
            "firstn": firstn,
            "leaf": leaf,
            "fast": None,
        }
        plans.append(plan)
        # -- fast-path qualification ----------------------------------
        if not firstn:
            continue
        if leaf and arg2 == 0:
            continue  # chooseleaf targeting devices: degenerate shape
        outer_steps, domains = _descent_steps(cm, [take_row], arg2)
        if outer_steps is None or len(outer_steps) > MAX_DEPTH - 1:
            continue
        # Adaptive speculation width: the retry probability per
        # replica is roughly numrep / (number of distinct targets), so
        # wide maps (many hosts) need only a couple of speculated
        # retries while narrow test maps need the full window.  Sized
        # so the expected oracle-fallback count stays ~10 lanes per
        # million mapped PGs.
        if arg2 == 0:
            ntargets = max(cm.max_devices, 1)
        else:
            ntargets = max(len(domains), 1)
        p_retry = min(numrep / ntargets, 0.9)
        if spec_boost:
            # a non-trivial reweight vector: is_out() rejects add retry
            # pressure the topology-derived estimate cannot see, so
            # take the full speculation window
            spec = _SPEC_TRIES
        else:
            spec = max(
                2,
                min(
                    _SPEC_TRIES,
                    math.ceil(
                        math.log(1e-5 / max(numrep, 1))
                        / math.log(max(p_retry, 1e-9))
                    )
                    - 1,
                ),
            )
        r0 = min(numrep + spec, numrep + tries - 1)
        fast = {
            "R0": r0,
            "outer_steps": outer_steps,
        }
        draws = r0 * len(outer_steps)
        if leaf:
            leaf_steps, _ = _descent_steps(cm, sorted(domains), 0)
            if leaf_steps is None or len(leaf_steps) > MAX_DEPTH - 1:
                continue
            l0 = min(leaf_tries, _LEAF_SPEC)
            pd = 1 if stable else nslots
            fast.update({"leaf_steps": leaf_steps, "L0": l0, "Pd": pd})
            draws += r0 * pd * l0 * len(leaf_steps)
        if draws > _SPEC_BUDGET:
            continue
        plan["fast"] = fast
    return plans


def _spec_boost_for(weights) -> int:
    """1 when the reweight vector meaningfully deviates from full-in
    (is_out() rejects then drive extra retries the topology-sized
    speculation window cannot predict), else 0."""
    if weights is None:
        return 0
    w = np.asarray(weights)
    if w.size == 0:
        return 0
    frac = np.count_nonzero(w != 0x10000) / w.size
    return 1 if frac > 0.02 else 0


# Plans keyed on map STRUCTURE (CompiledMap.skey): recompiling the same
# topology with new weights reuses them.  Bounded LRU.
_PLAN_CACHE: collections.OrderedDict = collections.OrderedDict()
_PLAN_CACHE_MAX = 64


def _plans(cm: CompiledMap, ruleno: int, result_max: int, spec_boost: int):
    key = (cm.skey, ruleno, result_max, spec_boost)
    plans = _PLAN_CACHE.get(key)
    if plans is None:
        plans = _plan_groups(cm, ruleno, result_max, spec_boost)
        _PLAN_CACHE[key] = plans
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    else:
        _PLAN_CACHE.move_to_end(key)
    return plans


# -- the batched rule ------------------------------------------------------


def _i32(v):
    return v.to(torch.int32)


class _Lanes:
    """One batch of PGs against one compiled map and reweight vector:
    the draw, the item classification and ``is_out`` over the lanes."""

    def __init__(self, cm: CompiledMap, wv: torch.Tensor):
        self.cm = cm
        self.wv = wv
        self.nw = wv.shape[0]

    def draw(self, x32, ids32, wdiv, wlive, r32):
        """straw2 draw-argmax (mapper.c:361-384) over the last axis:
        hash(x, id, r) & 0xffff -> crush_ln - 2^48, divided by the item
        weight with truncation toward zero; zero weights (and columns
        past a bucket's size, which carry weight 0) draw S64_MIN; the
        first maximum wins, like the C's strict ``>``."""
        cm = self.cm
        u = hash3(x32, ids32, r32) & 0xFFFF
        ln = crush_ln(u, cm.ln_rh, cm.ln_lh, cm.ln_ll) - (1 << 48)
        with record_function("crush.draw"):
            q = torch.div(ln, wdiv, rounding_mode="trunc")
            q = torch.where(wlive, q, S64_MIN)
            return q.argmax(-1, keepdim=True)

    def row_of(self, item):
        """Bucket row for a (negative) item; -1 if invalid."""
        bidx = self.cm.bidx
        neg = -1 - item
        ok = (item < 0) & (neg < bidx.shape[0])
        row = bidx[neg.clamp(0, bidx.shape[0] - 1)]
        return torch.where(ok, row, -1)

    def classify(self, item, target):
        """(found, descend, hard_bad, nrow) for drawn items against the
        level's target type (the firstn/indep descent checks)."""
        nrow = self.row_of(item)
        is_dev = item >= 0
        invalid = (~is_dev) & (nrow < 0)
        bad_dev = item >= self.cm.max_devices
        itype = torch.where(is_dev, 0, self.cm.types[nrow.clamp_min(0)])
        found = (~bad_dev) & (~invalid) & (itype == target)
        hard_bad = bad_dev | invalid | (is_dev & (itype != target))
        descend = (~found) & (~hard_bad)
        return found, descend, hard_bad, nrow

    def is_out(self, item, x32):
        """mapper.c:424-438 over the device reweight vector."""
        w = self.wv[item.clamp(0, self.nw - 1)]
        oob = item >= self.nw
        hashed = hash2(x32, _i32(item)) & 0xFFFF
        return oob | (w == 0) | ((w < 0x10000) & (hashed >= w))

    def bucket_draw(self, rows, x32, r32):
        """One draw per lane from bucket row ``rows`` (N,) over the full
        map width; returns (item, size)."""
        cm = self.cm
        am = self.draw(
            x32[:, None], cm.items32[rows], cm.wdiv[rows], cm.wlive[rows],
            _i32(r32)[:, None],
        )
        return cm.items[rows].gather(1, am).squeeze(1), cm.sizes[rows]

    def step_draw(self, st, x32, r, ttype):
        """One generic-chooser draw from each lane's current bucket and
        its outcome against the level's target (ttype, or a device in
        chooseleaf): (item, empty, found, descend, hard_bad, nrow).  A
        descent past MAX_DEPTH counts as a bad item."""
        item, bsize = self.bucket_draw(st["row"], x32, r)
        with record_function("crush.choose"):
            empty = bsize == 0
            target = torch.where(st["leaf"], 0, ttype)
            found, desc, hard_bad, nrow = self.classify(item, target)
            too_deep = desc & (st["depth"] + 1 >= MAX_DEPTH)
            hard_bad = (~empty) & (hard_bad | too_deep)
            desc = (~empty) & desc & ~too_deep
            return item, empty, (~empty) & found, desc, hard_bad, nrow

    # -- fast firstn: speculative tables + table-driven replay ---------

    def spec_descend(self, steps, rows, rs, valid, target, x32):
        """Batched candidate descents: each candidate (N, C) draws with
        its own fixed r (rs, (C,)) at every level, one draw round per
        level over that level's widest bucket; returns (kind, item) per
        candidate."""
        cm = self.cm
        n, c = rows.shape
        kinds = torch.where(valid, _K_OVER, _K_BAD).expand(n, c)
        items = torch.full((n, c), CRUSH_ITEM_NONE, device=cm.device)
        xb = x32.view(n, 1, 1)
        rb = _i32(rs).view(1, c, 1)
        for sinfo in steps:
            szi = min(sinfo["sz"], cm.sz)
            if len(sinfo["rows"]) == 1:
                row = sinfo["rows"][0]
                am = self.draw(
                    xb,
                    cm.items32[row, :szi].view(1, 1, szi),
                    cm.wdiv[row, :szi].view(1, 1, szi),
                    cm.wlive[row, :szi].view(1, 1, szi),
                    rb,
                )
                it = cm.items[row, :szi].expand(n, c, szi).gather(2, am)
                bsize = cm.sizes[row]
            else:
                am = self.draw(
                    xb,
                    cm.items32[:, :szi][rows],
                    cm.wdiv[:, :szi][rows],
                    cm.wlive[:, :szi][rows],
                    rb,
                )
                it = cm.items[:, :szi][rows].gather(2, am)
                bsize = cm.sizes[rows]
            it = it.squeeze(2)
            empty = bsize == 0
            found, desc, hard_bad, nrow = self.classify(it, target)
            active = kinds == _K_OVER
            nk = torch.where(
                empty,
                _K_RETRY,
                torch.where(
                    found, _K_FOUND, torch.where(hard_bad, _K_BAD, _K_OVER)
                ),
            )
            kinds = torch.where(active, nk, kinds)
            items = torch.where(active, it, items)
            rows = torch.where(active & desc & ~empty, nrow, rows)
        return kinds, items

    def fast_firstn(self, plan, x32):
        """crush_choose_firstn from precomputed candidate tables: the
        outer descents for r' = 0..R0-1 and, for chooseleaf, the leaf
        descents of each (r', position, leaf retry); then the C's state
        machine replayed over the tables for a number of steps bounded
        on the host, with no sync.  Returns (out, count, ok)."""
        cm = self.cm
        dev = cm.device
        f = plan["fast"]
        R0 = f["R0"]
        ttype = plan["ttype"]
        numrep, nslots = plan["numrep"], plan["nslots"]
        tries, leaf_tries = plan["tries"], plan["leaf_tries"]
        vary_r, stable = plan["vary_r"], plan["stable"]
        leaf = plan["leaf"]
        R = nslots
        n = x32.shape[0]
        rvec = torch.arange(R0, device=dev)
        rows0 = torch.full((n, R0), plan["take_row"], device=dev)
        kinds, items = self.spec_descend(
            f["outer_steps"], rows0, rvec,
            torch.ones((), dtype=torch.bool, device=dev), ttype, x32,
        )
        if ttype == 0:
            oisout = self.is_out(items, x32[:, None]) & (kinds == _K_FOUND)
        if leaf:
            L0, Pd = f["L0"], f["Pd"]
            lvalid = (kinds == _K_FOUND) & (items < 0)
            start_rows = self.row_of(items).clamp_min(0)
            sub_r = rvec >> (vary_r - 1) if vary_r else torch.zeros_like(rvec)
            reps = Pd * L0
            pos_flat = torch.arange(Pd, device=dev).repeat_interleave(L0).repeat(R0)
            l_flat = torch.arange(L0, device=dev).repeat(R0 * Pd)
            leaf_rep = torch.zeros_like(pos_flat) if stable else pos_flat
            rleaf = leaf_rep + sub_r.repeat_interleave(reps) + l_flat
            lkinds, litems = self.spec_descend(
                f["leaf_steps"],
                start_rows.repeat_interleave(reps, dim=1),
                rleaf,
                lvalid.repeat_interleave(reps, dim=1),
                0,
                x32,
            )
            lisout = self.is_out(litems, x32[:, None]) & (lkinds == _K_FOUND)

        with record_function("crush.replay"):
            colsR = torch.arange(R, device=dev)
            zero = torch.zeros(n, dtype=torch.int64, device=dev)
            done = torch.full((n,), numrep <= 0 or R == 0, device=dev)
            okf = torch.ones(n, dtype=torch.bool, device=dev)
            rep, outpos, ftotal, lftotal = zero, zero, zero, zero
            dom_r, domain = zero, zero
            in_leaf = torch.zeros(n, dtype=torch.bool, device=dev)
            out = torch.full((n, R), CRUSH_ITEM_NONE, device=dev)
            out2 = out.clone()
            # each replica takes at most R0 - rep outer attempts, each
            # at most L0 + 1 leaf steps after it, then one failing step
            steps = numrep * R0 * ((f["L0"] if leaf else 0) + 2) + 1
            for _ in range(steps):
                act = ~done
                r = rep + ftotal
                over_r = (~in_leaf) & (r >= R0)
                rc = r.clamp(0, R0 - 1)[:, None]
                k = kinds.gather(1, rc).squeeze(1)
                it = items.gather(1, rc).squeeze(1)
                o = (~in_leaf) & ~over_r
                o_found = o & (k == _K_FOUND)
                o_bad = o & (k == _K_BAD)
                o_retry = o & (k == _K_RETRY)
                o_over = (~in_leaf) & (over_r | (k == _K_OVER))
                prior = colsR < outpos[:, None]
                collide = o_found & (prior & (out == it[:, None])).any(1)
                direct = o_found & ~collide
                if leaf:
                    enter_leaf = direct & (it < 0)
                    direct = direct & (it >= 0)
                if ttype == 0:
                    direct_out = direct & oisout.gather(1, rc).squeeze(1)
                    place_direct = direct & ~direct_out
                else:
                    direct_out = None
                    place_direct = direct
                outer_reject = o_retry | collide
                if direct_out is not None:
                    outer_reject = outer_reject | direct_out
                fail = o_over
                if leaf:
                    l_over_idx = lftotal >= L0
                    pos_comp = 0 if stable else outpos.clamp(0, Pd - 1)
                    fidx = (
                        dom_r * (Pd * L0)
                        + pos_comp * L0
                        + lftotal.clamp(0, L0 - 1)
                    )[:, None]
                    lk = lkinds.gather(1, fidx).squeeze(1)
                    lit = litems.gather(1, fidx).squeeze(1)
                    lio = lisout.gather(1, fidx).squeeze(1)
                    lc = in_leaf & ~l_over_idx
                    l_found = lc & (lk == _K_FOUND)
                    l_bad = lc & (lk == _K_BAD)
                    l_empty = lc & (lk == _K_RETRY)
                    fail = fail | (in_leaf & (l_over_idx | (lk == _K_OVER)))
                    l_rej = l_found & (
                        (prior & (out2 == lit[:, None])).any(1) | lio
                    )
                    l_place = l_found & ~l_rej
                    l_retry_cand = l_empty | l_rej
                    l_exhaust = l_retry_cand & (lftotal + 1 >= leaf_tries)
                    l_retry = l_retry_cand & ~l_exhaust
                    outer_reject = outer_reject | l_bad | l_exhaust
                    place = (place_direct | l_place) & act
                else:
                    place = place_direct & act
                or_skip = outer_reject & (ftotal + 1 >= tries)
                or_retry = outer_reject & ~or_skip
                advance = place | o_bad | or_skip
                fail = fail & act

                sel = place[:, None] & (colsR == outpos[:, None])
                if leaf:
                    out = torch.where(
                        sel, torch.where(l_place, domain, it)[:, None], out
                    )
                    out2 = torch.where(sel, lit[:, None], out2)
                else:
                    out = torch.where(sel, it[:, None], out)
                rep = rep + advance
                outpos = outpos + place
                ftotal = torch.where(
                    advance, 0, torch.where(or_retry, ftotal + 1, ftotal)
                )
                if leaf:
                    lftotal = torch.where(
                        enter_leaf,
                        0,
                        torch.where(l_retry, lftotal + 1, lftotal),
                    )
                    in_leaf = enter_leaf | l_retry
                    dom_r = torch.where(enter_leaf, r, dom_r)
                    domain = torch.where(enter_leaf, it, domain)
                okf = okf & ~fail
                done = done | fail | (rep >= numrep) | (outpos >= nslots)
        return (out2 if leaf else out), outpos, okf

    # -- generic choosers (one draw per lane per step) -----------------

    def _loop(self, step, state, outs, x32, bound):
        """Run ``step(state, x32) -> state`` until every lane is done,
        reading ``done`` every SYNC_EVERY steps and dropping the
        finished lanes once they are half the batch.  Returns the
        ``outs`` fields of the final state over all lanes."""
        final = {k: state[k].clone() for k in outs}
        lanes = None  # global index of each live lane; None = all
        taken = 0
        while True:
            for _ in range(SYNC_EVERY):
                state = step(state, x32)
            taken += SYNC_EVERY
            live = ~state["done"]
            nlive = int(live.sum())
            if nlive == 0:
                break
            if taken >= bound:
                raise RuntimeError(
                    f"CRUSH chooser did not finish in {bound} steps"
                )
            if nlive * 2 <= live.shape[0]:
                gone = ~live
                at = gone.nonzero().squeeze(1)
                idx = at if lanes is None else lanes[at]
                for k in outs:
                    final[k][idx] = state[k][at]
                keep = live.nonzero().squeeze(1)
                lanes = keep if lanes is None else lanes[keep]
                state = {k: v[keep] for k, v in state.items()}
                x32 = x32[keep]
        for k in outs:
            if lanes is None:
                final[k] = state[k]
            else:
                final[k][lanes] = state[k]
        return final

    def choose_firstn(self, plan, x32):
        """crush_choose_firstn (mapper.c:460-648) as a state machine.

        rep/outpos/ftotal track the C loop variables; ``leaf`` switches
        between the outer descent (toward ttype) and the chooseleaf
        descent (toward a device under ``domain``); every reject path
        advances r' exactly as the C does.  ``numrep`` bounds the reps,
        ``nslots`` the placements."""
        cm = self.cm
        dev = cm.device
        take_row = plan["take_row"]
        ttype = plan["ttype"]
        numrep, nslots = plan["numrep"], plan["nslots"]
        tries, leaf_tries = plan["tries"], plan["leaf_tries"]
        vary_r, stable = plan["vary_r"], plan["stable"]
        leaf = plan["leaf"]
        R = nslots
        n = x32.shape[0]
        colsR = torch.arange(R, device=dev)

        def step(st, x32):
            with record_function("crush.choose"):
                outpos, ftotal, lftotal = st["outpos"], st["ftotal"], st["lftotal"]
                in_leaf, out, out2 = st["leaf"], st["out"], st["out2"]
                act = ~st["done"]
                leaf_rep = 0 if stable else outpos
                r_outer = st["rep"] + ftotal
                sub_r = r_outer >> (vary_r - 1) if vary_r else 0
                r = torch.where(in_leaf, leaf_rep + sub_r + lftotal, r_outer)
            item, empty, found, desc, hard_bad, nrow = self.step_draw(
                st, x32, r, ttype
            )
            with record_function("crush.choose"):

                o = ~in_leaf
                o_desc = o & desc
                o_found = o & found
                prior = colsR < outpos[:, None]
                collide = o_found & (prior & (out == item[:, None])).any(1)
                direct = o_found & ~collide
                enter_leaf = direct & (item < 0) if leaf else torch.zeros_like(direct)
                if leaf:
                    direct = direct & (item >= 0)
                out_now = self.is_out(item, x32)
                direct_out = direct & out_now if ttype == 0 else torch.zeros_like(direct)
                place_direct = direct & ~direct_out

                l_desc = in_leaf & desc
                l_found = in_leaf & found
                l_rej = l_found & ((prior & (out2 == item[:, None])).any(1) | out_now)
                l_place = l_found & ~l_rej
                l_retry_cand = (in_leaf & empty) | l_rej
                l_exhaust = l_retry_cand & (lftotal + 1 >= leaf_tries)
                l_retry = l_retry_cand & ~l_exhaust

                outer_reject = (
                    (o & empty) | collide | direct_out
                    | (in_leaf & hard_bad) | l_exhaust
                )
                or_skip = outer_reject & (ftotal + 1 >= tries)
                or_retry = outer_reject & ~or_skip
                place = (place_direct | l_place) & act
                advance = place | (o & hard_bad) | or_skip

                sel = place[:, None] & (colsR == outpos[:, None])
                out = torch.where(
                    sel, torch.where(l_place, st["domain"], item)[:, None], out
                )
                if leaf:
                    out2 = torch.where(sel, item[:, None], out2)
                rep = st["rep"] + advance
                outpos = outpos + place
                domain = torch.where(enter_leaf, item, st["domain"])
                return {
                    "done": st["done"] | (rep >= numrep) | (outpos >= nslots),
                    "rep": rep,
                    "outpos": outpos,
                    "ftotal": torch.where(
                        advance, 0, torch.where(or_retry, ftotal + 1, ftotal)
                    ),
                    "lftotal": torch.where(
                        enter_leaf, 0, torch.where(l_retry, lftotal + 1, lftotal)
                    ),
                    "leaf": enter_leaf | l_desc | l_retry,
                    "row": torch.where(
                        o_desc | l_desc | enter_leaf,
                        nrow,
                        torch.where(l_retry, self.row_of(domain), take_row),
                    ),
                    "domain": domain,
                    "depth": torch.where(o_desc | l_desc, st["depth"] + 1, 0),
                    "out": out,
                    "out2": out2,
                }

        zero = torch.zeros(n, dtype=torch.int64, device=dev)
        state = {
            "done": torch.full((n,), numrep <= 0 or R == 0, device=dev),
            "rep": zero, "outpos": zero, "ftotal": zero, "lftotal": zero,
            "leaf": torch.zeros(n, dtype=torch.bool, device=dev),
            "row": torch.full((n,), take_row, device=dev),
            "domain": zero, "depth": zero,
            "out": torch.full((n, R), CRUSH_ITEM_NONE, device=dev),
            "out2": torch.full((n, R), CRUSH_ITEM_NONE, device=dev),
        }
        bound = numrep * tries * MAX_DEPTH * (1 + leaf_tries) + 8
        final = self._loop(step, state, ("outpos", "out", "out2"), x32, bound)
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        return (final["out2"] if leaf else final["out"]), final["outpos"], ok

    def choose_indep(self, plan, x32):
        """crush_choose_indep (mapper.c:655-843) as a state machine.

        ``slot`` scans the UNDEF positions of each round; finishing a
        slot jumps to the next UNDEF one, and running out of them
        advances the round (ftotal).  r' = slot + numrep*ftotal at the
        outer level and slot + r_outer + numrep*lftotal inside
        chooseleaf, the C's advancement (numrep, unclamped, is the
        stride)."""
        cm = self.cm
        dev = cm.device
        take_row = plan["take_row"]
        ttype = plan["ttype"]
        numrep, nslots = plan["numrep"], plan["nslots"]
        tries, leaf_tries = plan["tries"], plan["leaf_tries"]
        leaf = plan["leaf"]
        R = nslots
        n = x32.shape[0]
        colsR = torch.arange(R, device=dev)

        def step(st, x32):
            with record_function("crush.choose"):
                slot, ftotal, lftotal = st["slot"], st["ftotal"], st["lftotal"]
                in_leaf, out, out2 = st["leaf"], st["out"], st["out2"]
                act = ~st["done"]
                r = torch.where(
                    in_leaf,
                    slot + st["parent_r"] + numrep * lftotal,
                    slot + numrep * ftotal,
                )
            item, empty, found, desc, hard_bad, nrow = self.step_draw(
                st, x32, r, ttype
            )
            with record_function("crush.choose"):

                o = ~in_leaf
                o_desc = o & desc
                o_found = o & found
                collide = o_found & (out == item[:, None]).any(1)
                direct = o_found & ~collide
                enter_leaf = direct & (item < 0) if leaf else torch.zeros_like(direct)
                if leaf:
                    direct = direct & (item >= 0)
                out_now = self.is_out(item, x32)
                direct_out = direct & out_now if ttype == 0 else torch.zeros_like(direct)
                place_direct = direct & ~direct_out

                l_desc = in_leaf & desc
                l_found = in_leaf & found
                l_rej = l_found & out_now
                l_place = l_found & ~l_rej
                l_retry_cand = (in_leaf & empty) | l_rej
                l_exhaust = l_retry_cand & (lftotal + 1 >= leaf_tries)
                l_retry = l_retry_cand & ~l_exhaust

                place = (place_direct | l_place) & act
                kill = o & hard_bad & act  # slot permanently NONE
                # break: the slot stays UNDEF for a later round
                brk = (
                    (o & empty) | collide | direct_out
                    | (in_leaf & hard_bad) | l_exhaust
                )
                at = colsR == slot[:, None]
                put = at & place[:, None]
                none = at & kill[:, None]
                out = torch.where(
                    put,
                    torch.where(l_place, st["domain"], item)[:, None],
                    torch.where(none, CRUSH_ITEM_NONE, out),
                )
                if leaf:
                    out2 = torch.where(
                        put, item[:, None], torch.where(none, CRUSH_ITEM_NONE, out2)
                    )
                left = st["left"] - (place | kill).to(torch.int64)
                finished = place | kill | brk
                # the next UNDEF slot after this one; a wrap starts the
                # next round
                undef = out == CRUSH_ITEM_UNDEF
                after = undef & (colsR > slot[:, None])
                has_after = after.any(1)
                nxt = torch.where(
                    has_after,
                    after.to(torch.int8).argmax(1),
                    undef.to(torch.int8).argmax(1),
                )
                adv_ftotal = ftotal + (~has_after).to(torch.int64)
                adv_done = (left <= 0) | ~undef.any(1) | (adv_ftotal >= tries)
                domain = torch.where(enter_leaf, item, st["domain"])
                return {
                    "done": st["done"] | (finished & adv_done),
                    "slot": torch.where(finished, nxt, slot),
                    "left": left,
                    "ftotal": torch.where(finished, adv_ftotal, ftotal),
                    "leaf": (enter_leaf | l_desc | l_retry) & ~finished,
                    "row": torch.where(
                        o_desc | l_desc | enter_leaf,
                        nrow,
                        torch.where(
                            l_retry & ~finished, self.row_of(domain), take_row
                        ),
                    ),
                    "domain": domain,
                    "lftotal": torch.where(
                        enter_leaf, 0, torch.where(l_retry, lftotal + 1, lftotal)
                    ),
                    "depth": torch.where(o_desc | l_desc, st["depth"] + 1, 0),
                    "parent_r": torch.where(enter_leaf, r, st["parent_r"]),
                    "out": out,
                    "out2": out2,
                }

        zero = torch.zeros(n, dtype=torch.int64, device=dev)
        state = {
            "done": torch.full((n,), R == 0 or tries <= 0, device=dev),
            "slot": zero, "left": torch.full((n,), R, device=dev),
            "ftotal": zero,
            "leaf": torch.zeros(n, dtype=torch.bool, device=dev),
            "row": torch.full((n,), take_row, device=dev),
            "domain": zero, "lftotal": zero, "depth": zero, "parent_r": zero,
            "out": torch.full((n, R), CRUSH_ITEM_UNDEF, device=dev),
            "out2": torch.full((n, R), CRUSH_ITEM_UNDEF, device=dev),
        }
        bound = tries * R * MAX_DEPTH * (1 + leaf_tries) + 8
        final = self._loop(step, state, ("out", "out2"), x32, bound)
        got = final["out2"] if leaf else final["out"]
        got = torch.where(got == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE, got)
        count = torch.full((n,), R, dtype=torch.int64, device=dev)
        return got, count, torch.ones(n, dtype=torch.bool, device=dev)


def _run_rule(cm: CompiledMap, plans, xs, wv, result_max: int):
    """The rule program over emit groups for lanes ``xs`` (N,) on the
    map's device: (result (N, result_max) int32 padded with
    CRUSH_ITEM_NONE, count (N,) int32, ok (N,) bool)."""
    lanes = _Lanes(cm, wv)
    x32 = _i32(xs)
    n = xs.shape[0]
    dev = cm.device
    cols = torch.arange(result_max, device=dev)
    result = torch.full((n, result_max), CRUSH_ITEM_NONE, device=dev)
    rlen = torch.zeros(n, dtype=torch.int64, device=dev)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    for plan in plans:
        if plan["fast"] is not None:
            got, cnt, okg = lanes.fast_firstn(plan, x32)
        elif plan["firstn"]:
            got, cnt, okg = lanes.choose_firstn(plan, x32)
        else:
            got, cnt, okg = lanes.choose_indep(plan, x32)
        with record_function("crush.emit"):
            ok = ok & okg
            # append got[:cnt] to result at rlen
            for i in range(plan["nslots"]):
                slot = rlen + i
                valid = (i < cnt) & (slot < result_max)
                result = torch.where(
                    valid[:, None] & (cols == slot[:, None]),
                    got[:, i : i + 1],
                    result,
                )
            rlen = torch.clamp(rlen + cnt, max=result_max)
    return result.to(torch.int32), rlen.to(torch.int32), ok


# -- entry points ----------------------------------------------------------


def _weight_vector(cm: CompiledMap, weights):
    if weights is None:
        weights = np.full(max(cm.max_devices, 1), 0x10000, np.int64)
    return torch.as_tensor(np.asarray(weights, dtype=np.int64), device=cm.device)


def batch_do_rule_raw(
    cm: CompiledMap, ruleno: int, xs, result_max: int, weights=None
):
    """The batched rule's raw output for inputs ``xs``, as device
    tensors: (results (N, result_max) int32, counts (N,) int32, ok (N,)
    bool).  Lanes with ok == False outran the fast path's speculation
    window; ``apply_oracle_fallback`` finishes them."""
    plans = _plans(cm, ruleno, result_max, _spec_boost_for(weights))
    xs = torch.as_tensor(xs, device=cm.device).to(torch.int64)
    return _run_rule(cm, plans, xs, _weight_vector(cm, weights), result_max)


def apply_oracle_fallback(
    cm: CompiledMap,
    ruleno: int,
    xs,
    res,
    counts,
    ok,
    result_max: int,
    weights=None,
):
    """Re-map the lanes whose speculative retry window overflowed
    (ok == False) through the exact oracle; returns finalized numpy
    (results, counts).  Accepts device tensors or numpy, and the packed
    int16 wire form (see batch_do_rule_range), which it unpacks.  Adds
    the number of lanes it re-mapped to ``fallback_lanes``."""
    global fallback_lanes

    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    res, counts, ok = host(res), host(counts), host(ok)
    if res.dtype == np.int16:
        res32 = res.astype(np.int32)
        res32[res == -32768] = CRUSH_ITEM_NONE
        res = res32
        counts = counts.astype(np.int32)
    bad = np.nonzero(~ok)[0]
    if bad.size:
        if getattr(cm.source, "mutation", 0) != cm.source_mutation:
            raise RuntimeError(
                "CrushMap mutated since compile_map(): the oracle "
                "fallback would mix old-snapshot results with "
                "new-map lanes — recompile the map first"
            )
        if weights is None:
            weights = np.full(max(cm.max_devices, 1), 0x10000, np.int64)
        wl = [int(w) for w in np.asarray(weights)]
        res = res.copy()
        counts = counts.copy()
        xs = host(xs)
        for i in bad:
            row = cm.source.do_rule(ruleno, int(xs[i]), result_max, wl)
            res[i, :] = CRUSH_ITEM_NONE
            res[i, : len(row)] = row
            counts[i] = len(row)
        fallback_lanes += int(bad.size)
    return res, counts


def batch_do_rule(
    cm: CompiledMap,
    ruleno: int,
    xs,
    result_max: int,
    weights=None,
):
    """Map a batch of inputs: xs (N,) -> (results (N, result_max) int32
    padded with CRUSH_ITEM_NONE, counts (N,)) as numpy arrays, CHUNK
    lanes a device call, the oracle fallback applied.  ``weights`` is
    the 16.16 device reweight vector."""
    xs = torch.as_tensor(np.asarray(xs, dtype=np.int64), device=cm.device)
    parts = [
        batch_do_rule_raw(cm, ruleno, xs[i : i + CHUNK], result_max, weights)
        for i in range(0, max(xs.shape[0], 1), CHUNK)
    ]
    res, counts, ok = (torch.cat(p) for p in zip(*parts))
    return apply_oracle_fallback(
        cm, ruleno, xs, res, counts, ok, result_max, weights
    )


def batch_do_rule_range(
    cm: CompiledMap,
    ruleno: int,
    lo: int,
    n: int,
    result_max: int,
    weights=None,
    packed: bool = False,
):
    """Map the contiguous inputs [lo, lo+n): the inputs are made on the
    device and the results stay there.  The fast firstn path runs with
    no host sync, so such a call returns before the device finishes;
    the generic choosers read their done mask every few steps.  Finish
    each chunk with ``apply_oracle_fallback(cm, ruleno, np.arange(lo,
    lo+n), *chunk, result_max, weights)``.  ``packed`` returns results
    as int16 (-32768 encodes NONE) and counts as uint8, half the
    device→host bytes; it needs every id magnitude < 32768."""
    if packed and (
        cm.max_devices >= 32768
        or len(cm.host_bidx) >= 32768
        or result_max > 255
    ):
        packed = False  # ids/counts wouldn't fit the packed wire form
    xs = lo + torch.arange(n, dtype=torch.int64, device=cm.device)
    res, counts, ok = batch_do_rule_raw(cm, ruleno, xs, result_max, weights)
    if packed:
        with record_function("crush.emit"):
            res = torch.where(res == CRUSH_ITEM_NONE, -32768, res).to(torch.int16)
            counts = counts.to(torch.uint8)
    return res, counts, ok


def make_chained_runner(
    cm: CompiledMap,
    ruleno: int,
    result_max: int,
    n: int,
    iters: int = 8,
    weights=None,
):
    """Device-resident rate: ``run(lo) -> (checksum, ms)`` maps ``iters``
    consecutive n-PG ranges back to back on the current stream, each
    round's results folded into a checksum that seeds the next round's
    input offset (so no round can be skipped or overlapped away), and
    times the whole with CUDA events (the host clock on the CPU).
    ms / (iters*n) is the mapping rate with no host transfer of
    results."""
    plans = _plans(cm, ruleno, result_max, _spec_boost_for(weights))
    wv = _weight_vector(cm, weights)
    dev = cm.device
    ar = torch.arange(n, dtype=torch.int64, device=dev)

    def run(lo: int):
        cuda = dev.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(iters):
            xs = lo + acc % 7 + i * n + ar
            res, cnt, ok = _run_rule(cm, plans, xs, wv, result_max)
            acc = acc + res.sum(dtype=torch.int64) + cnt.sum(dtype=torch.int64) + ok.sum()
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        return int(acc), ms

    return run
