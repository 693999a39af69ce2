"""CrushMap blob serialization (framework-native format).

The reference embeds the crush map as an opaque encoded blob inside
OSDMap encode (CrushWrapper::encode, src/crush/CrushWrapper.cc) and
ships it to every daemon/client; this module plays that role for the
framework's own wire/disk paths: a versioned little-endian format
carrying everything ``builder.CrushMap`` holds — tunables, buckets
with their per-algorithm derived tables, rules, name maps, and
choose_args.

This is NOT the reference's binary crushmap format; the
reference-compatible compiler/decompiler (crushtool -c/-d ingest of
real maps) lives in ``compiler.py``.
"""

from __future__ import annotations

from ..common.encoding import (
    Decoder,
    DecodeError,
    Encoder,
    decode_versioned,
    encode_versioned,
)
from .builder import CrushMap
from .types import Bucket, ChooseArg, Rule, RuleStep, Tunables

_VERSION = 1
_COMPAT = 1


def _enc_opt_list(e: Encoder, v: list[int] | None) -> None:
    if v is None:
        e.bool(False)
    else:
        e.bool(True)
        e.list(v, lambda e2, x: e2.s64(x))


def _dec_opt_list(d: Decoder) -> list[int] | None:
    if not d.bool():
        return None
    return d.list(lambda d2: d2.s64())


def encode_crush_map(m: CrushMap) -> bytes:
    e = Encoder()
    t = m.tunables
    for v in (
        t.choose_local_tries,
        t.choose_local_fallback_tries,
        t.choose_total_tries,
        t.chooseleaf_descend_once,
        t.chooseleaf_vary_r,
        t.chooseleaf_stable,
        t.straw_calc_version,
    ):
        e.u32(v)
    e.s32(m.max_devices)

    def enc_bucket(e2: Encoder, b: Bucket) -> None:
        e2.s32(b.id).u16(b.type).u8(b.alg).u8(b.hash).u64(b.weight)
        e2.list(b.items, lambda e3, x: e3.s32(x))
        e2.list(b.item_weights, lambda e3, x: e3.u64(x))
        _enc_opt_list(e2, b.straws)
        _enc_opt_list(e2, b.sum_weights)
        _enc_opt_list(e2, b.node_weights)

    e.list(sorted(m.buckets.values(), key=lambda b: b.id), enc_bucket)

    def enc_rule(e2: Encoder, r: Rule | None) -> None:
        if r is None:
            e2.bool(False)
            return
        e2.bool(True)
        e2.u32(r.ruleset).u32(r.type).u32(r.min_size).u32(r.max_size)
        e2.list(
            r.steps,
            lambda e3, s: e3.u32(s.op).s32(s.arg1).s32(s.arg2),
        )

    e.list(m.rules, enc_rule)
    e.map(m.type_names, lambda e2, k: e2.s32(k), lambda e2, v: e2.string(v))
    e.map(m.item_names, lambda e2, k: e2.s32(k), lambda e2, v: e2.string(v))
    e.map(m.rule_names, lambda e2, k: e2.s32(k), lambda e2, v: e2.string(v))

    def enc_choose_arg(e2: Encoder, ca: ChooseArg) -> None:
        if ca.weight_set is None:
            e2.bool(False)
        else:
            e2.bool(True)
            e2.list(
                ca.weight_set,
                lambda e3, ws: e3.list(ws, lambda e4, w: e4.u64(w)),
            )
        _enc_opt_list(e2, ca.ids)

    e.map(m.choose_args, lambda e2, k: e2.s64(k), enc_choose_arg)
    return encode_versioned(_VERSION, _COMPAT, e.getvalue())


def decode_crush_map(data: bytes) -> CrushMap:
    _version, d = decode_versioned(Decoder(data), _COMPAT)
    vals = [d.u32() for _ in range(7)]
    m = CrushMap(tunables=Tunables(*vals))
    m.max_devices = d.s32()

    def dec_bucket(d2: Decoder) -> Bucket:
        return Bucket(
            id=d2.s32(),
            type=d2.u16(),
            alg=d2.u8(),
            hash=d2.u8(),
            weight=d2.u64(),
            items=d2.list(lambda d3: d3.s32()),
            item_weights=d2.list(lambda d3: d3.u64()),
            straws=_dec_opt_list(d2),
            sum_weights=_dec_opt_list(d2),
            node_weights=_dec_opt_list(d2),
        )

    for b in d.list(dec_bucket):
        if b.id >= 0:
            raise DecodeError(f"bucket id {b.id} not negative")
        m.buckets[b.id] = b

    def dec_rule(d2: Decoder) -> Rule | None:
        if not d2.bool():
            return None
        ruleset = d2.u32()
        rtype = d2.u32()
        mn = d2.u32()
        mx = d2.u32()
        steps = d2.list(
            lambda d3: RuleStep(d3.u32(), d3.s32(), d3.s32())
        )
        return Rule(
            steps=steps, ruleset=ruleset, type=rtype,
            min_size=mn, max_size=mx,
        )

    m.rules = d.list(dec_rule)
    m.type_names = d.map(lambda d2: d2.s32(), lambda d2: d2.string())
    m.item_names = d.map(lambda d2: d2.s32(), lambda d2: d2.string())
    m.rule_names = d.map(lambda d2: d2.s32(), lambda d2: d2.string())

    def dec_choose_arg(d2: Decoder) -> ChooseArg:
        weight_set = None
        if d2.bool():
            weight_set = d2.list(
                lambda d3: d3.list(lambda d4: d4.u64())
            )
        return ChooseArg(weight_set=weight_set, ids=_dec_opt_list(d2))

    m.choose_args = d.map(lambda d2: d2.s64(), dec_choose_arg)
    m.touch()
    return m
