"""CrushCompiler: reference text crushmap ⇄ CrushMap ⇄ reference binary.

Implements the REFERENCE formats so real-world maps flow in and out:

- binary: CrushWrapper::encode/decode (CrushWrapper.cc:2929/:3105) —
  CRUSH_MAGIC header, per-row buckets with alg-specific payloads,
  rules with packed masks, 32-or-64-key name maps, trailing tunables,
  device classes and choose_args maps (luminous layout);
- text: the CrushCompiler grammar (CrushCompiler.cc) — tunable lines,
  devices with classes, types, DFS-ordered bucket blocks with shadow
  ``id -N class c`` lines, rules with take/choose/set_* steps, and
  choose_args blocks.  ``decompile`` mirrors the reference's exact
  formatting (tabs, fixed-point %.3f, pos annotations) so that, like
  the reference's compile-decompile-recompile.t, text that came from a
  decompile round-trips byte-for-byte.

Decoded maps drop straight into the oracle and the batched mapper
(``torchmap.compile_map`` reads the alg-specific payloads, straws,
sum_weights and node_weights, from the map): they are kept as stored,
not recomputed, exactly as the C decode does.  Each decode and compile
makes a new ``CrushMap``, so no compiled table of another map is ever
reused for it.
"""

from __future__ import annotations

import re
import struct

from .builder import CrushMap
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
    CRUSH_RULE_NOOP,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
    Bucket,
    ChooseArg,
    Rule,
    RuleStep,
    Tunables,
)

CRUSH_MAGIC = 0x00010000
# (1<<uniform)|(1<<list)|(1<<straw) — crush.h CRUSH_LEGACY_ALLOWED_BUCKET_ALGS
LEGACY_ALLOWED_BUCKET_ALGS = (1 << 1) | (1 << 2) | (1 << 4)

ALG_NAMES = {
    CRUSH_BUCKET_UNIFORM: "uniform",
    CRUSH_BUCKET_LIST: "list",
    CRUSH_BUCKET_TREE: "tree",
    CRUSH_BUCKET_STRAW: "straw",
    CRUSH_BUCKET_STRAW2: "straw2",
}
ALG_IDS = {v: k for k, v in ALG_NAMES.items()}

PG_TYPE_REPLICATED = 1  # CEPH_PG_TYPE_REPLICATED
PG_TYPE_ERASURE = 3  # CEPH_PG_TYPE_ERASURE


class CrushCompilerError(ValueError):
    pass


# -- binary codec ----------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        if self.off + size > len(self.data):
            raise CrushCompilerError("truncated crushmap blob")
        (v,) = struct.unpack_from(fmt, self.data, self.off)
        self.off += size
        return v

    def u8(self):
        return self._unpack("<B")

    def u16(self):
        return self._unpack("<H")

    def u32(self):
        return self._unpack("<I")

    def s32(self):
        return self._unpack("<i")

    def s64(self):
        return self._unpack("<q")

    def string(self, n: int) -> str:
        if self.off + n > len(self.data):
            raise CrushCompilerError("truncated string")
        v = self.data[self.off : self.off + n].decode("utf-8")
        self.off += n
        return v

    @property
    def end(self) -> bool:
        return self.off >= len(self.data)


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def pack(self, fmt: str, v):
        self.parts.append(struct.pack(fmt, v))

    def u8(self, v):
        self.pack("<B", v)

    def u16(self, v):
        self.pack("<H", v)

    def u32(self, v):
        self.pack("<I", v & 0xFFFFFFFF)

    def s32(self, v):
        self.pack("<i", v)

    def s64(self, v):
        self.pack("<q", v)

    def string(self, s: str):
        raw = s.encode("utf-8")
        self.u32(len(raw))
        self.parts.append(raw)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


def _decode_string_map(r: _Reader) -> dict[int, str]:
    """map<int32,string> with the reference's 32-or-64-bit-key
    tolerance (decode_32_or_64_string_map, CrushWrapper.cc:3086):
    a zero 'length' means the key was 64-bit and the real length
    follows."""
    out: dict[int, str] = {}
    n = r.u32()
    for _ in range(n):
        key = r.s32()
        strlen = r.u32()
        if strlen == 0:
            strlen = r.u32()
        out[key] = r.string(strlen)
    return out


def _encode_string_map(w: _Writer, m: dict[int, str]):
    w.u32(len(m))
    for key in sorted(m):
        w.s32(key)
        w.string(m[key])


def decode_crushmap(data: bytes) -> CrushMap:
    """CrushWrapper::decode (CrushWrapper.cc:3105) over a reference
    binary crushmap blob.  Trailing sections are optional exactly as
    in the reference (legacy tunables when absent)."""
    r = _Reader(data)
    if r.u32() != CRUSH_MAGIC:
        raise CrushCompilerError("bad magic number")
    max_buckets = r.s32()
    max_rules = r.u32()
    max_devices = r.s32()

    m = CrushMap(tunables=Tunables(2, 5, 19, 0, 0, 0, 0))
    m.type_names = {}
    m.max_devices = max_devices
    # preserved so a re-encode keeps the original row/rule table sizes
    # (the reference encodes max_buckets/max_rules verbatim, including
    # trailing empty rows)
    m.binary_max_buckets = max_buckets
    m.binary_max_rules = max_rules
    row_ids: list[int | None] = []

    for _ in range(max_buckets):
        alg = r.u32()
        if alg == 0:
            row_ids.append(None)
            continue
        bid = r.s32()
        btype = r.u16()
        alg8 = r.u8()
        hash8 = r.u8()
        weight = r.u32()
        size = r.u32()
        items = [r.s32() for _ in range(size)]
        b = Bucket(
            id=bid, type=btype, alg=alg8, items=items,
            item_weights=[], hash=hash8, weight=weight,
        )
        if alg8 == CRUSH_BUCKET_UNIFORM:
            iw = r.u32()
            b.item_weights = [iw] * size
        elif alg8 == CRUSH_BUCKET_LIST:
            b.sum_weights = []
            for _ in range(size):
                b.item_weights.append(r.u32())
                b.sum_weights.append(r.u32())
        elif alg8 == CRUSH_BUCKET_TREE:
            num_nodes = r.u8()
            b.node_weights = [r.u32() for _ in range(num_nodes)]
            # item j sits at node 2j+1 (crush_calc_tree_node)
            b.item_weights = [
                b.node_weights[2 * j + 1]
                if 2 * j + 1 < num_nodes
                else 0
                for j in range(size)
            ]
        elif alg8 == CRUSH_BUCKET_STRAW:
            b.straws = []
            for _ in range(size):
                b.item_weights.append(r.u32())
                b.straws.append(r.u32())
        elif alg8 == CRUSH_BUCKET_STRAW2:
            b.item_weights = [r.u32() for _ in range(size)]
        else:
            raise CrushCompilerError(f"unknown bucket alg {alg8}")
        m.buckets[bid] = b
        row_ids.append(bid)

    for i in range(max_rules):
        if not r.u32():
            m.rules.append(None)
            continue
        length = r.u32()
        ruleset = r.u8()
        rtype = r.u8()
        min_size = r.u8()
        max_size = r.u8()
        steps = []
        for _ in range(length):
            op = r.u32()
            arg1 = r.s32()
            arg2 = r.s32()
            steps.append(RuleStep(op, arg1, arg2))
        m.rules.append(
            Rule(
                steps=steps, ruleset=ruleset, type=rtype,
                min_size=min_size, max_size=max_size,
            )
        )

    m.type_names = _decode_string_map(r)
    m.item_names = _decode_string_map(r)
    m.rule_names = _decode_string_map(r)

    t = m.tunables
    if not r.end:
        t.choose_local_tries = r.u32()
        t.choose_local_fallback_tries = r.u32()
        t.choose_total_tries = r.u32()
    if not r.end:
        t.chooseleaf_descend_once = r.u32()
    if not r.end:
        t.chooseleaf_vary_r = r.u8()
    if not r.end:
        t.straw_calc_version = r.u8()
    if not r.end:
        m.allowed_bucket_algs = r.u32()
    if not r.end:
        t.chooseleaf_stable = r.u8()
    if not r.end:
        # device classes (luminous+)
        n = r.u32()
        for _ in range(n):
            k = r.s32()
            m.class_map[k] = r.s32()
        m.class_names = {}
        n = r.u32()
        for _ in range(n):
            k = r.s32()
            m.class_names[k] = r.string(r.u32())
        n = r.u32()
        for _ in range(n):
            orig = r.s32()
            per: dict[int, int] = {}
            for _ in range(r.u32()):
                c = r.s32()
                per[c] = r.s32()
            m.class_bucket[orig] = per
    if not r.end:
        # choose_args: map<s64, per-bucket args>
        m.choose_args_maps = {}
        n_maps = r.u32()
        for _ in range(n_maps):
            key = r.s64()
            per: dict[int, ChooseArg] = {}
            n_args = r.u32()
            for _ in range(n_args):
                row = r.u32()
                if row >= len(row_ids) or row_ids[row] is None:
                    raise CrushCompilerError(
                        f"choose_arg for empty bucket row {row}"
                    )
                positions = r.u32()
                ws = None
                if positions:
                    ws = []
                    for _ in range(positions):
                        sz = r.u32()
                        ws.append([r.u32() for _ in range(sz)])
                ids_size = r.u32()
                ids = (
                    [r.s32() for _ in range(ids_size)]
                    if ids_size
                    else None
                )
                per[row_ids[row]] = ChooseArg(weight_set=ws, ids=ids)
            m.choose_args_maps[key] = per
        if m.choose_args_maps:
            # the active map: DEFAULT_CHOOSE_ARGS (-1) if present,
            # else the first (choose_args_get_with_fallback)
            active = (
                -1 if -1 in m.choose_args_maps
                else sorted(m.choose_args_maps)[0]
            )
            m.choose_args = dict(m.choose_args_maps[active])
    m.max_devices = max(
        m.max_devices,
        max(
            (i + 1 for b in m.buckets.values() for i in b.items if i >= 0),
            default=0,
        ),
    )
    m.touch()
    return m


def encode_crushmap(m: CrushMap) -> bytes:
    """CrushWrapper::encode with the modern feature set (tunables5 +
    classes + choose_args always present, like a luminous+ encode)."""
    w = _Writer()
    w.u32(CRUSH_MAGIC)
    max_buckets = max(
        max((-b for b in m.buckets), default=0),
        getattr(m, "binary_max_buckets", 0),
    )
    w.s32(max_buckets)
    nrules = max(len(m.rules), getattr(m, "binary_max_rules", 0))
    w.u32(nrules)
    w.s32(m.max_devices)

    rows: list[Bucket | None] = [None] * max_buckets
    for bid, b in m.buckets.items():
        rows[-1 - bid] = b
    for b in rows:
        if b is None:
            w.u32(0)
            continue
        w.u32(b.alg)
        w.s32(b.id)
        w.u16(b.type)
        w.u8(b.alg)
        w.u8(b.hash)
        w.u32(b.weight)
        w.u32(b.size)
        for item in b.items:
            w.s32(item)
        if b.alg == CRUSH_BUCKET_UNIFORM:
            w.u32(b.item_weights[0] if b.item_weights else 0)
        elif b.alg == CRUSH_BUCKET_LIST:
            for iw, sw in zip(b.item_weights, b.sum_weights or []):
                w.u32(iw)
                w.u32(sw)
        elif b.alg == CRUSH_BUCKET_TREE:
            nodes = b.node_weights or []
            w.u8(len(nodes))
            for nw in nodes:
                w.u32(nw)
        elif b.alg == CRUSH_BUCKET_STRAW:
            for iw, sv in zip(b.item_weights, b.straws or []):
                w.u32(iw)
                w.u32(sv)
        elif b.alg == CRUSH_BUCKET_STRAW2:
            for iw in b.item_weights:
                w.u32(iw)
        else:
            raise CrushCompilerError(f"unknown bucket alg {b.alg}")

    for i in range(nrules):
        rule = m.rules[i] if i < len(m.rules) else None
        if rule is None:
            w.u32(0)
            continue
        w.u32(1)
        w.u32(len(rule.steps))
        w.u8(rule.ruleset)
        w.u8(rule.type)
        w.u8(rule.min_size)
        w.u8(rule.max_size)
        for st in rule.steps:
            w.u32(st.op)
            w.s32(st.arg1)
            w.s32(st.arg2)

    _encode_string_map(w, m.type_names)
    _encode_string_map(w, m.item_names)
    _encode_string_map(w, m.rule_names)

    t = m.tunables
    w.u32(t.choose_local_tries)
    w.u32(t.choose_local_fallback_tries)
    w.u32(t.choose_total_tries)
    w.u32(t.chooseleaf_descend_once)
    w.u8(t.chooseleaf_vary_r)
    w.u8(t.straw_calc_version)
    w.u32(getattr(m, "allowed_bucket_algs", LEGACY_ALLOWED_BUCKET_ALGS))
    w.u8(t.chooseleaf_stable)

    # device classes
    w.u32(len(m.class_map))
    for k in sorted(m.class_map):
        w.s32(k)
        w.s32(m.class_map[k])
    w.u32(len(m.class_names))
    for k in sorted(m.class_names):
        w.s32(k)
        w.string(m.class_names[k])
    w.u32(len(m.class_bucket))
    for orig in sorted(m.class_bucket):
        w.s32(orig)
        per = m.class_bucket[orig]
        w.u32(len(per))
        for c in sorted(per):
            w.s32(c)
            w.s32(per[c])

    # choose_args
    maps = getattr(m, "choose_args_maps", None)
    if maps is None:
        maps = {-1: m.choose_args} if m.choose_args else {}
    w.u32(len(maps))
    for key in sorted(maps):
        w.s64(key)
        per = maps[key]
        live = {
            bid: a
            for bid, a in per.items()
            if (a.weight_set or a.ids)
        }
        w.u32(len(live))
        for bid in sorted(live, key=lambda b: -1 - b):
            a = live[bid]
            w.u32(-1 - bid)
            ws = a.weight_set or []
            w.u32(len(ws))
            for row in ws:
                w.u32(len(row))
                for wt in row:
                    w.u32(wt)
            ids = a.ids or []
            w.u32(len(ids))
            for i in ids:
                w.s32(i)
    return w.bytes()


# -- text: decompile -------------------------------------------------------


def _fixedpoint(v: int) -> str:
    return "%.3f" % (float(v) / float(0x10000))


def _type_name(m: CrushMap, t: int) -> str:
    name = m.type_names.get(t)
    if name is not None:
        return name
    return "device" if t == 0 else f"type{t}"


def _item_name(m: CrushMap, item: int) -> str:
    name = m.item_names.get(item)
    if name is not None:
        return name
    return f"device{item}" if item >= 0 else f"bucket{-1 - item}"


def _split_id_class(m: CrushMap, item: int) -> tuple[int, int | None]:
    """Shadow id -> (original id, class) (CrushWrapper::split_id_class)."""
    for orig, per in m.class_bucket.items():
        for c, cid in per.items():
            if cid == item:
                return orig, c
    return item, None


def decompile_crushmap(m: CrushMap) -> str:
    """CrushCompiler::decompile (CrushCompiler.cc:302): byte-compatible
    formatting, children-before-parents bucket order, shadow buckets
    folded into ``id -N class c`` lines."""
    out: list[str] = ["# begin crush map\n"]
    t = m.tunables
    if t.choose_local_tries != 2:
        out.append(f"tunable choose_local_tries {t.choose_local_tries}\n")
    if t.choose_local_fallback_tries != 5:
        out.append(
            "tunable choose_local_fallback_tries "
            f"{t.choose_local_fallback_tries}\n"
        )
    if t.choose_total_tries != 19:
        out.append(f"tunable choose_total_tries {t.choose_total_tries}\n")
    if t.chooseleaf_descend_once != 0:
        out.append(
            f"tunable chooseleaf_descend_once {t.chooseleaf_descend_once}\n"
        )
    if t.chooseleaf_vary_r != 0:
        out.append(f"tunable chooseleaf_vary_r {t.chooseleaf_vary_r}\n")
    if t.chooseleaf_stable != 0:
        out.append(f"tunable chooseleaf_stable {t.chooseleaf_stable}\n")
    if t.straw_calc_version != 0:
        out.append(f"tunable straw_calc_version {t.straw_calc_version}\n")
    allowed = getattr(m, "allowed_bucket_algs", LEGACY_ALLOWED_BUCKET_ALGS)
    if allowed != LEGACY_ALLOWED_BUCKET_ALGS:
        out.append(f"tunable allowed_bucket_algs {allowed}\n")

    out.append("\n# devices\n")
    for i in range(m.max_devices):
        name = m.item_names.get(i)
        if name is not None:
            line = f"device {i} {name}"
            if i in m.class_map and m.class_map[i] in m.class_names:
                line += f" class {m.class_names[m.class_map[i]]}"
            out.append(line + "\n")

    out.append("\n# types\n")
    # iterate the map directly (scanning i upward until every name is
    # seen would hang on a negative key a malformed blob can carry)
    if 0 not in m.type_names:
        out.append("type 0 osd\n")
    for i in sorted(m.type_names):
        out.append(f"type {i} {m.type_names[i]}\n")

    out.append("\n# buckets\n")
    shadows = {
        cid for per in m.class_bucket.values() for cid in per.values()
    }
    emitted: set[int] = set()

    def emit_bucket(bid: int):
        if bid in emitted or bid not in m.buckets:
            return
        emitted.add(bid)
        b = m.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(item)
        name = m.item_names.get(bid)
        if name is not None and "~" in name:
            return  # shadow bucket: folded into id lines
        out.append(f"{_type_name(m, b.type)} {_item_name(m, bid)} {{\n")
        out.append(f"\tid {bid}\t\t# do not change unnecessarily\n")
        for c, cid in sorted(m.class_bucket.get(bid, {}).items()):
            cname = m.class_names.get(c)
            out.append(
                f"\tid {cid} class {cname}\t\t"
                "# do not change unnecessarily\n"
            )
        out.append(f"\t# weight {_fixedpoint(b.weight)}\n")
        alg_line = f"\talg {ALG_NAMES[b.alg]}"
        dopos = False
        if b.alg == CRUSH_BUCKET_UNIFORM:
            alg_line += (
                f"\t# do not change bucket size ({b.size}) unnecessarily"
            )
            dopos = True
        elif b.alg == CRUSH_BUCKET_LIST:
            alg_line += (
                "\t# add new items at the end; "
                "do not change order unnecessarily"
            )
        elif b.alg == CRUSH_BUCKET_TREE:
            alg_line += (
                "\t# do not change pos for existing items unnecessarily"
            )
            dopos = True
        out.append(alg_line + "\n")
        hname = "rjenkins1" if b.hash == 0 else f"hash{b.hash}"
        out.append(f"\thash {b.hash}\t# {hname}\n")
        for j, (item, iw) in enumerate(zip(b.items, b.item_weights)):
            line = (
                f"\titem {_item_name(m, item)} weight {_fixedpoint(iw)}"
            )
            if dopos:
                line += f" pos {j}"
            out.append(line + "\n")
        out.append("}\n")

    max_buckets = max((-b for b in m.buckets), default=0)
    for bid in range(-1, -1 - max_buckets, -1):
        if bid in shadows:
            continue
        emit_bucket(bid)

    out.append("\n# rules\n")
    for i, rule in enumerate(m.rules):
        if rule is None:
            continue
        rname = m.rule_names.get(i, f"rule{i}")
        out.append(f"rule {rname} {{\n")
        out.append(f"\tid {i}\n")
        if i != rule.ruleset:
            out.append(
                f"\t# WARNING: ruleset {rule.ruleset} != id {i}; "
                "this will not recompile to the same map\n"
            )
        if rule.type == PG_TYPE_REPLICATED:
            out.append("\ttype replicated\n")
        elif rule.type == PG_TYPE_ERASURE:
            out.append("\ttype erasure\n")
        else:
            out.append(f"\ttype {rule.type}\n")
        out.append(f"\tmin_size {rule.min_size}\n")
        out.append(f"\tmax_size {rule.max_size}\n")
        for st in rule.steps:
            if st.op == CRUSH_RULE_NOOP:
                out.append("\tstep noop\n")
            elif st.op == CRUSH_RULE_TAKE:
                orig, c = _split_id_class(m, st.arg1)
                line = f"\tstep take {_item_name(m, orig)}"
                if c is not None:
                    line += f" class {m.class_names.get(c)}"
                out.append(line + "\n")
            elif st.op == CRUSH_RULE_EMIT:
                out.append("\tstep emit\n")
            elif st.op == CRUSH_RULE_SET_CHOOSE_TRIES:
                out.append(f"\tstep set_choose_tries {st.arg1}\n")
            elif st.op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
                out.append(f"\tstep set_choose_local_tries {st.arg1}\n")
            elif st.op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
                out.append(
                    f"\tstep set_choose_local_fallback_tries {st.arg1}\n"
                )
            elif st.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
                out.append(f"\tstep set_chooseleaf_tries {st.arg1}\n")
            elif st.op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
                out.append(f"\tstep set_chooseleaf_vary_r {st.arg1}\n")
            elif st.op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
                out.append(f"\tstep set_chooseleaf_stable {st.arg1}\n")
            elif st.op in (
                CRUSH_RULE_CHOOSE_FIRSTN,
                CRUSH_RULE_CHOOSE_INDEP,
                CRUSH_RULE_CHOOSELEAF_FIRSTN,
                CRUSH_RULE_CHOOSELEAF_INDEP,
            ):
                verb = (
                    "choose"
                    if st.op
                    in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP)
                    else "chooseleaf"
                )
                mode = (
                    "firstn"
                    if st.op
                    in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSELEAF_FIRSTN)
                    else "indep"
                )
                out.append(
                    f"\tstep {verb} {mode} {st.arg1} type "
                    f"{_type_name(m, st.arg2)}\n"
                )
            else:
                out.append(f"\tstep unknown {st.op} {st.arg1} {st.arg2}\n")
        out.append("}\n")

    maps = getattr(m, "choose_args_maps", None)
    if maps is None and m.choose_args:
        maps = {-1: m.choose_args}
    if maps:
        out.append("\n# choose_args\n")
        for key in sorted(maps):
            out.append(f"choose_args {key} {{\n")
            per = maps[key]
            for bid in sorted(per, key=lambda b: -1 - b):
                a = per[bid]
                if not (a.weight_set or a.ids):
                    continue
                out.append("  {\n")
                out.append(f"    bucket_id {bid}\n")
                if a.weight_set:
                    out.append("    weight_set [\n")
                    for row in a.weight_set:
                        out.append(
                            "      [ "
                            + " ".join(_fixedpoint(v) for v in row)
                            + " ]\n"
                        )
                    out.append("    ]\n")
                if a.ids:
                    out.append(
                        "    ids [ "
                        + " ".join(str(i) for i in a.ids)
                        + " ]\n"
                    )
                out.append("  }\n")
            out.append("}\n")

    out.append("\n# end crush map\n")
    return "".join(out)


# -- text: compile ---------------------------------------------------------


def _tokens(text: str):
    """Token stream with comments stripped; braces/brackets split."""
    for raw in text.splitlines():
        line = raw.split("#", 1)[0]
        line = (
            line.replace("{", " { ")
            .replace("}", " } ")
            .replace("[", " [ ")
            .replace("]", " ] ")
        )
        yield from line.split()


def _parse_weight(tok: str) -> int:
    return int(round(float(tok) * 0x10000))


def compile_crushmap(text: str) -> CrushMap:
    """CrushCompiler::compile over the text grammar: tunables, devices
    (with classes), types, buckets (with shadow id lines), rules
    (take ... [class c], choose/chooseleaf, set_*), choose_args."""
    toks = list(_tokens(text))
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else None

    def next_tok():
        nonlocal pos
        if pos >= len(toks):
            raise CrushCompilerError("unexpected end of crushmap text")
        tok = toks[pos]
        pos += 1
        return tok

    def expect(val):
        tok = next_tok()
        if tok != val:
            raise CrushCompilerError(f"expected {val!r}, got {tok!r}")

    m = CrushMap(tunables=Tunables(2, 5, 19, 0, 0, 0, 0))
    m.type_names = {}
    name_to_id: dict[str, int] = {}

    def resolve_item(name: str) -> int | None:
        if name in name_to_id:
            return name_to_id[name]
        # print_item_name fallbacks for nameless items: deviceN /
        # bucketN round-trip back to their ids
        mdev = re.fullmatch(r"device(\d+)", name)
        if mdev:
            dev = int(mdev.group(1))
            m.max_devices = max(m.max_devices, dev + 1)
            return dev
        mbkt = re.fullmatch(r"bucket(\d+)", name)
        if mbkt:
            bid = -1 - int(mbkt.group(1))
            return bid if bid in m.buckets else None
        return None
    # declared shadow ids: bucket name -> {class name: id}
    declared_shadows: dict[int, dict[str, int]] = {}
    pending_rules = []

    while pos < len(toks):
        tok = next_tok()
        if tok == "tunable":
            key = next_tok()
            val = int(next_tok())
            t = m.tunables
            if key == "allowed_bucket_algs":
                m.allowed_bucket_algs = val
            elif hasattr(t, key):
                setattr(t, key, val)
            else:
                raise CrushCompilerError(f"unknown tunable {key!r}")
        elif tok == "device":
            dev = int(next_tok())
            name = next_tok()
            m.item_names[dev] = name
            name_to_id[name] = dev
            m.max_devices = max(m.max_devices, dev + 1)
            if peek() == "class":
                next_tok()
                m.set_item_class(dev, next_tok())
        elif tok == "type":
            tid = int(next_tok())
            m.type_names[tid] = next_tok()
        elif tok == "rule":
            name = next_tok()
            expect("{")
            rid = None
            rtype = PG_TYPE_REPLICATED
            min_size, max_size = 1, 10
            steps: list[RuleStep] = []
            while peek() != "}":
                key = next_tok()
                if key in ("id", "ruleset"):
                    rid = int(next_tok())
                elif key == "type":
                    v = next_tok()
                    rtype = {
                        "replicated": PG_TYPE_REPLICATED,
                        "erasure": PG_TYPE_ERASURE,
                    }.get(v)
                    if rtype is None:
                        rtype = int(v)
                elif key == "min_size":
                    min_size = int(next_tok())
                elif key == "max_size":
                    max_size = int(next_tok())
                elif key == "step":
                    op = next_tok()
                    if op == "take":
                        take_name = next_tok()
                        take_class = None
                        if peek() == "class":
                            next_tok()
                            take_class = next_tok()
                        steps.append(("take", take_name, take_class))
                    elif op == "emit":
                        steps.append(RuleStep(CRUSH_RULE_EMIT))
                    elif op == "noop":
                        steps.append(RuleStep(CRUSH_RULE_NOOP))
                    elif op in ("choose", "chooseleaf"):
                        mode = next_tok()
                        num = int(next_tok())
                        expect("type")
                        tname = next_tok()
                        tid = None
                        for k, v in m.type_names.items():
                            if v == tname:
                                tid = k
                        if tid is None:
                            raise CrushCompilerError(
                                f"type {tname!r} not defined"
                            )
                        opmap = {
                            ("choose", "firstn"): CRUSH_RULE_CHOOSE_FIRSTN,
                            ("choose", "indep"): CRUSH_RULE_CHOOSE_INDEP,
                            (
                                "chooseleaf",
                                "firstn",
                            ): CRUSH_RULE_CHOOSELEAF_FIRSTN,
                            (
                                "chooseleaf",
                                "indep",
                            ): CRUSH_RULE_CHOOSELEAF_INDEP,
                        }
                        steps.append(RuleStep(opmap[op, mode], num, tid))
                    elif op.startswith("set_"):
                        opmap = {
                            "set_choose_tries": CRUSH_RULE_SET_CHOOSE_TRIES,
                            "set_choose_local_tries":
                                CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
                            "set_choose_local_fallback_tries":
                                CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                            "set_chooseleaf_tries":
                                CRUSH_RULE_SET_CHOOSELEAF_TRIES,
                            "set_chooseleaf_vary_r":
                                CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
                            "set_chooseleaf_stable":
                                CRUSH_RULE_SET_CHOOSELEAF_STABLE,
                        }
                        if op not in opmap:
                            raise CrushCompilerError(
                                f"unknown step {op!r}"
                            )
                        steps.append(RuleStep(opmap[op], int(next_tok())))
                    else:
                        raise CrushCompilerError(f"unknown step {op!r}")
                else:
                    raise CrushCompilerError(
                        f"unknown rule field {key!r}"
                    )
            expect("}")
            pending_rules.append(
                (name, rid, rtype, min_size, max_size, steps)
            )
        elif tok == "choose_args":
            key = int(next_tok())
            expect("{")
            per: dict[int, ChooseArg] = {}
            while peek() == "{":
                next_tok()
                bid = None
                ws = None
                ids = None
                while peek() != "}":
                    field = next_tok()
                    if field == "bucket_id":
                        bid = int(next_tok())
                    elif field == "weight_set":
                        expect("[")
                        ws = []
                        while peek() == "[":
                            next_tok()
                            row = []
                            while peek() != "]":
                                row.append(_parse_weight(next_tok()))
                            expect("]")
                            ws.append(row)
                        expect("]")
                    elif field == "ids":
                        expect("[")
                        ids = []
                        while peek() != "]":
                            ids.append(int(next_tok()))
                        expect("]")
                    else:
                        raise CrushCompilerError(
                            f"unknown choose_args field {field!r}"
                        )
                expect("}")
                if bid is None:
                    raise CrushCompilerError(
                        "choose_args entry without bucket_id"
                    )
                per[bid] = ChooseArg(weight_set=ws, ids=ids)
            expect("}")
            if not hasattr(m, "choose_args_maps"):
                m.choose_args_maps = {}
            m.choose_args_maps[key] = per
        else:
            # bucket block: "<type-name> <bucket-name> { ... }"
            tname, bname = tok, next_tok()
            btype = None
            for k, v in m.type_names.items():
                if v == tname:
                    btype = k
            if btype is None:
                raise CrushCompilerError(
                    f"type {tname!r} not defined (at bucket {bname!r})"
                )
            expect("{")
            bid = None
            alg = None
            hash_ = 0
            items: list[tuple[str, int | None, int | None]] = []
            shadow_ids: dict[str, int] = {}
            while peek() != "}":
                key = next_tok()
                if key == "id":
                    v = int(next_tok())
                    if peek() == "class":
                        next_tok()
                        shadow_ids[next_tok()] = v
                    else:
                        bid = v
                elif key == "alg":
                    aname = next_tok()
                    alg = ALG_IDS.get(aname)
                    if alg is None:
                        raise CrushCompilerError(
                            f"unknown bucket alg {aname!r}"
                        )
                elif key == "hash":
                    hash_ = int(next_tok())
                elif key == "item":
                    iname = next_tok()
                    iw = None
                    ipos = None
                    while peek() in ("weight", "pos"):
                        sub = next_tok()
                        if sub == "weight":
                            iw = _parse_weight(next_tok())
                        else:
                            ipos = int(next_tok())
                    items.append((iname, iw, ipos))
                else:
                    raise CrushCompilerError(
                        f"unknown bucket field {key!r}"
                    )
            expect("}")
            if alg is None:
                raise CrushCompilerError(f"bucket {bname!r} without alg")
            if bid is None:
                bid = min(m.buckets, default=0) - 1

            def default_weight(rid_: int) -> int:
                # omitted weight defaults to the child bucket's
                # computed rollup, or 1.0 for devices
                # (CrushCompiler.cc:680-682)
                if rid_ < 0 and rid_ in m.buckets:
                    return m.buckets[rid_].weight
                return 0x10000

            # honor declared pos; unannotated items fill the unused
            # slots in declaration order (CrushCompiler.cc:723-728)
            nslots = len(items)
            for _, _, ip in items:
                if ip is not None:
                    nslots = max(nslots, ip + 1)
            slots: list[tuple[int, int] | None] = [None] * nslots
            loose: list[tuple[int, int]] = []
            for it, iw, ip in items:
                rid_ = resolve_item(it)
                if rid_ is None:
                    raise CrushCompilerError(
                        f"in bucket {bname!r} item {it!r} not defined"
                    )
                entry = (
                    rid_, iw if iw is not None else default_weight(rid_)
                )
                if ip is not None:
                    if slots[ip] is not None:
                        raise CrushCompilerError(
                            f"bucket {bname!r} pos {ip} used twice"
                        )
                    slots[ip] = entry
                else:
                    loose.append(entry)
            for i in range(nslots):
                if slots[i] is None and loose:
                    slots[i] = loose.pop(0)
            ordered = [s for s in slots if s is not None]
            if len(ordered) != len(items):
                raise CrushCompilerError(
                    f"bucket {bname!r} has pos holes"
                )
            if alg == CRUSH_BUCKET_UNIFORM and ordered:
                w0 = ordered[0][1]
                if any(w != w0 for _, w in ordered):
                    raise CrushCompilerError(
                        f"uniform bucket {bname!r} items must all "
                        "have identical weights"
                    )
            m.add_bucket(
                alg,
                btype,
                [i for i, _ in ordered],
                [w for _, w in ordered],
                id=bid,
                name=bname,
                hash=hash_,
            )
            name_to_id[bname] = bid
            if shadow_ids:
                declared_shadows[bid] = shadow_ids

    # shadow trees: reserve the declared ids, then build the clones
    if declared_shadows or m.class_map:
        for bid, per in declared_shadows.items():
            for cname, cid in per.items():
                c = m.get_class_id(cname, create=True)
                m.class_bucket.setdefault(bid, {})[c] = cid
        if any(i >= 0 for i in m.class_map):
            m.populate_classes()

    for name, rid, rtype, min_size, max_size, steps in pending_rules:
        resolved: list[RuleStep] = []
        for st in steps:
            if isinstance(st, tuple):
                _, take_name, take_class = st
                take = resolve_item(take_name)
                if take is None:
                    raise CrushCompilerError(
                        f"in rule {name!r} item {take_name!r} not defined"
                    )
                if take_class is not None:
                    c = m.get_class_id(take_class)
                    cid = m.class_bucket.get(take, {}).get(c)
                    if cid is None:
                        raise CrushCompilerError(
                            f"no shadow tree for {take_name}~{take_class}"
                        )
                    take = cid
                resolved.append(RuleStep(CRUSH_RULE_TAKE, take))
            else:
                resolved.append(st)
        if rid is None:
            rid = len(m.rules)
        if rid < len(m.rules) and m.rules[rid] is not None:
            raise CrushCompilerError(f"rule {rid} already exists")
        rule = Rule(
            steps=resolved,
            type=rtype,
            min_size=min_size,
            max_size=max_size,
        )
        m.add_rule(rule, rid)
        rule.ruleset = rid
        m.rule_names[rid] = name
    m.touch()
    return m
