"""CRUSH, frozen plain copy: rjenkins1 hashes, crush_ln, straw2, the
firstn and indep choosers and the rule interpreter (src/crush/hash.c,
mapper.c), on python ints, for straw2 maps with no choose_args.

The map is a plain description that the benchmark builds itself
(``Hierarchy``); nothing here reads the program's map or tables.
"""

from __future__ import annotations

import base64
import decimal
import functools
from dataclasses import dataclass, field

ITEM_NONE = 0x7FFFFFFF
ITEM_UNDEF = 0x7FFFFFFE
S64_MIN = -(1 << 63)
M32 = 0xFFFFFFFF

RULE_TAKE = 1
RULE_CHOOSE_FIRSTN = 2
RULE_CHOOSE_INDEP = 3
RULE_EMIT = 4
RULE_CHOOSELEAF_FIRSTN = 6
RULE_CHOOSELEAF_INDEP = 7
RULE_SET_CHOOSE_TRIES = 8
RULE_SET_CHOOSELEAF_TRIES = 9

_LL_B85 = (
    "000000000001Bq!0ssI2#ZI;i2LJ#7XU<UX2><{9{fOn!3;+NCoPKn)4*&oFUa$R@5&!@ISQ~+P6"
    "#xJLp~C)K7ytkOQl)l28vp<RfWzn@9smFULmgEEApigXva-A7BLDyZ<bxc@CIA2c@Q`<^DF6Tf?b"
    "*zXEC2ui@?IQoF8}}l7a(R)G5`PoaUH5NH2?qr8dvBQH~;_uCe0xDIsgCwu76Y7Jpcdz$ZmkVKmY"
    "&$jGCvOLjV8(5Ch48MgRZ+Y^da7NdN!<wu<^hOaK4?2C51tPXGV_at0L%QUCw|6QCLEQ~&?~{dO4"
    "5R{#J2N{bP%S^xk558VWjT>t<8WNh+sU;qFBU^&`UV*mgE8brJ{W&i*HsEn8xX#fBKA`@@=YXATM"
    "pVvR!ZU6uPHQEZkaR2}S{Tk4pbN~PV44RLDcK`qYdRIwfdH?_bUQ_)<eE<Le&W)=kfB*mh;|5d+g"
    "8%>kvcC4|g#Z8mQni!IhyVZp-0CW=ivR!sWna9GjsO4v1rtbckpKVy(*@2^lmGw#<u^_<mjD0&Q>"
    "n-lng9R*Gg>|NoB#j-ol30Np8x;=STujIq5uE@YU+5Jr2qf``<d2zr~m)}aEUHms{jB1<G6r6t^f"
    "c4X(-Jfu>b%77}yg5v;Y7A3dmIAwg3PCQ}~a=xc~qF3~9xryZ`_IN*eWrzW@LLCJY~E!T<mOwmw5"
    "h#Q*>R5wc+^$N&HUO=fxu%K!iXf?JL2%>V!Z$dQ`N&;S4cGYO)t(*OVf-NB=d)&Kwi+q<7{*#H0l"
    "ME8|Y+yDRoFm#47-v9srwK8!M;s5{u>M~aI<NyEw=5#gG=Kufz!T1if>Hq)$kiO!T?EnA(Y{sy5@"
    "Bjb+Y7lu>^8f$<qMSQ8_5c6?Dr@){`2YX_8ho$$`v3p{h|gf!{r~^~jAabF0RaF2JU+6U1OWg5uU"
    "S%j2LS*8{I~2}3IPBBI$41|4FLcEe?1T$5CH%H<Ybxt5&-}Je$O1=6#)PMWPO^y7y$qPt!@&a8vy"
    "_SaifHQ9svLV#vAcqAprmY!`D|qBmn>bf7iGnCjkHe5E~Q%Dggihj-qMeECB!j4{o`_F984ms(k~"
    "aG64VpchN_KH30wsjA@2rH~|0v|3$w;I{^Ry>1OgHJ^=s#Ud$f^K>+{&cy>qRLjeE)OJ!-qMgaf-"
    "@R)_9NdW)=d=Z?4OaTA@2+yo!PXPb`snNGYQUL$}b{V}SRRI71ho-y)SOEY4@_4r7S^)q6&XB6aT"
    ">$_9G47b8U;zLCG?9UXV*vmF?0IBlW&r>IaHv5<X#oHL*BlunYykiOy&1~(Z2<rPs@JyTaRC4TL>"
    "_&^bO8VW9IHK}cL4wZNq+c(dI10c;+L&reE|Rf{`Xu$fB^siSTujIf&l;k8H}m{h5-NoM!-nnhye"
    "fqQaj<miva)tQvGwFjsXAwT?PSwkpTbzi&ltVlmP$$^6d#fmjM6(s?3ERngIX+$nyLBoB;p;V_<C"
    "Ep8)^>lNHyzq5%K^ZW274r2zl{3s;+ar~v=~faCO9s{sH2<+n&Wt^oi5P}G(gu>k-8**M?$vjG4A"
    "mE|GWwgCVDo7!Htxd8wG0~nT;ya50J<DJKKzX1RMQEc;6!T|sPWrG<s#Q^{SHsd)H$N>NV*^5;2$"
    "^ifXXMJhW%>e)a^|yGi&;bAdnmdAz(*XbgZ3u>L)&T$jh8~1X*#Q6m`F(sW+yMXp-zIMh-vIysP8"
    "nS4;Q;^uT~$NL<N*KxBikgX=K%l!wW<Jz>Hz=%E5z1i?EwG)ohPS6@Bsh-AJuUq^8o+=%FH$b_5l"
    "C@vkvy)_yGU_^O~=}`vCv|o^fNI{s900%#sm(0RjL3l>WI}1Ofm64Ygc42Lb>95@K$^2?78BY66k"
    ">3<3ZEe3>HF4*~!HSTujI5&{4K*r+s<6#@VNP$9K(7y<wQ7v(Qd8v+0TkEe5L9RdIV?oJd9Ap!sZ"
    "EcJcsBLV;b6X)T{CISEeyCguUDFOfhPMc>VECK)ksDtZdF9HAn8>KiyG6DbqsS<!8H39$tY0Sa@H"
    "v#|vqz*eQIsyOyTY&BpJpup#A0p{BKmq^&C9jWoLjnK*HRrTeMgjl;{%d6IM*;u<m_6<iOacG^8e"
    "9VLP67Y`na2>%Q33z}Wldy~R0041?u8tSR{{V4@Yoq?S^@w7TY&BpT>=0A7H0z`U;+RDf;dH%Vgd"
    "jFQ!CcsWdZ;I^8vTMXaWELUM7;9YXSfOshIaNZ2|xQ>sU8faRLAUJ7)nlbOHbXu*1a@cLD$aUv7l"
    ")c>(|cVP`$hd;$Of%dUWBegXghvqYYXf&u^lGATxAg#rKoRZ_pbhXMcqO5TJcivj=uTY&BpjRF7w"
    "A0p{BkOBYzf;dH%k^%q#Vf($AmI43(t9qjXnF0U+$z-@xoB{v<gAl#yodN&=wF{gNq5=Q_VO?Oyq"
    "yhi{RZ_pbrvd-~{MuGvsR951?-Z{+tO5W4%ANrmuL1x7f;dH%vH}1A57;8mwE_SDvm8hIxB>tG6X"
    "z0;x&i<I%mGPly#fFL_H21dzybgOrYNK*!vX*ROpjg~#sUBU_L1n}$N~TW!aoAP%K`uZZax;A&H?"
    "}c6OJT#(E<Pf#x5;Z)B*qioggqX*8%_luwyL{+5!Lo6!;|V+yVdq"
)


@dataclass
class Hierarchy:
    """A straw2 CRUSH map: ``buckets[id] = (type, items, weights)`` with
    negative ids, devices ``0 .. max_devices - 1``, rules as lists of
    ``(op, arg1, arg2)`` steps, and the jewel tunables."""

    buckets: dict = field(default_factory=dict)
    max_devices: int = 0
    rules: list = field(default_factory=list)
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1

    def add_bucket(self, type_: int, items: list, weights: list) -> int:
        bid = min(self.buckets, default=0) - 1
        self.buckets[bid] = (type_, list(items), list(weights))
        for i in items:
            if i >= 0:
                self.max_devices = max(self.max_devices, i + 1)
        return bid

    def weight(self, bid: int) -> int:
        return sum(self.buckets[bid][2])

    def add_rule(self, root: int, domain_type: int, mode: str) -> int:
        """TAKE root, CHOOSELEAF over ``domain_type``, EMIT; an indep
        rule first sets chooseleaf tries 5 and choose tries 100, as
        CrushWrapper::add_simple_rule does."""
        steps = []
        if mode == "indep":
            steps += [(RULE_SET_CHOOSELEAF_TRIES, 5, 0), (RULE_SET_CHOOSE_TRIES, 100, 0)]
        op = RULE_CHOOSELEAF_FIRSTN if mode == "firstn" else RULE_CHOOSELEAF_INDEP
        steps += [(RULE_TAKE, root, 0), (op, 0, domain_type), (RULE_EMIT, 0, 0)]
        self.rules.append(steps)
        return len(self.rules) - 1


def _mix(a, b, c):
    a = (a - b - c) & M32
    a ^= c >> 13
    b = (b - c - a) & M32
    b ^= (a << 8) & M32
    c = (c - a - b) & M32
    c ^= b >> 13
    a = (a - b - c) & M32
    a ^= c >> 12
    b = (b - c - a) & M32
    b ^= (a << 16) & M32
    c = (c - a - b) & M32
    c ^= b >> 5
    a = (a - b - c) & M32
    a ^= c >> 3
    b = (b - c - a) & M32
    b ^= (a << 10) & M32
    c = (c - a - b) & M32
    c ^= b >> 15
    return a, b, c


def hash32_2(a: int, b: int) -> int:
    a &= M32
    b &= M32
    h = 1315423911 ^ a ^ b
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(231232, a, h)
    b, y, h = _mix(b, 1232, h)
    return h


def hash32_3(a: int, b: int, c: int) -> int:
    a &= M32
    b &= M32
    c &= M32
    h = 1315423911 ^ a ^ b ^ c
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, 231232, h)
    y, a, h = _mix(1232, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def str_hash_rjenkins(name: str) -> int:
    """ceph_str_hash_rjenkins: Jenkins lookup2 over the name's bytes,
    the object-name hash of a pool."""
    k = name.encode("utf-8")
    length = len(k)
    a = b = 0x9E3779B9
    c = 0
    i = 0
    rem = length
    while rem >= 12:
        a = (a + int.from_bytes(k[i:i + 4], "little")) & M32
        b = (b + int.from_bytes(k[i + 4:i + 8], "little")) & M32
        c = (c + int.from_bytes(k[i + 8:i + 12], "little")) & M32
        a, b, c = _mix(a, b, c)
        i += 12
        rem -= 12
    c = (c + length) & M32
    tail = k[i:]
    for pos, (reg, shift) in enumerate(
        [("a", 0), ("a", 8), ("a", 16), ("a", 24), ("b", 0), ("b", 8),
         ("b", 16), ("b", 24), ("c", 8), ("c", 16), ("c", 24)]
    ):
        if rem > pos:
            v = tail[pos] << shift
            if reg == "a":
                a = (a + v) & M32
            elif reg == "b":
                b = (b + v) & M32
            else:
                c = (c + v) & M32
    return _mix(a, b, c)[2]


@functools.lru_cache(maxsize=1)
def _ln_tables() -> tuple[list, list, list]:
    rh = [-((-(1 << 55)) // (128 + k)) for k in range(129)]
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        ln2 = decimal.Decimal(2).ln()
        lh = [
            int((decimal.Decimal(128 + k).ln() - decimal.Decimal(128).ln()) / ln2 * (1 << 48))
            for k in range(128)
        ] + [0xFFFF00000000]
    raw = base64.b85decode(_LL_B85)
    ll = [int.from_bytes(raw[i:i + 8], "little") for i in range(0, len(raw), 8)]
    return rh, lh, ll


def crush_ln(x: int) -> int:
    """2^44 * log2(x + 1) in fixed point (mapper.c:248-290)."""
    rh, lh, ll = _ln_tables()
    x += 1
    iexpon = 15
    if not x & 0x18000:
        bits = 16 - (x & 0x1FFFF).bit_length()
        x <<= bits
        iexpon = 15 - bits
    k = (x >> 8) - 128
    index2 = ((x * rh[k]) >> 48) & 0xFF
    return (iexpon << 44) + ((lh[k] + ll[index2]) >> 4)


def straw2_choose(items: list, weights: list, x: int, r: int) -> int:
    high, high_draw = 0, 0
    for i, item in enumerate(items):
        w = weights[i]
        if w:
            ln = crush_ln(hash32_3(x, item, r) & 0xFFFF) - 0x1000000000000
            draw = -((-ln) // w) if ln < 0 else ln // w
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return items[high]


def is_out(weight: list, item: int, x: int) -> bool:
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (hash32_2(x, item) & 0xFFFF) >= w


def _type_of(h: Hierarchy, item: int):
    if item >= 0:
        return 0
    b = h.buckets.get(item)
    return None if b is None else b[0]


def choose_firstn(h, bid, weight, x, numrep, type_, out, outpos, out_size,
                  tries, recurse_tries, recurse_to_leaf, out2, parent_r):
    """mapper.c crush_choose_firstn with local tries 0 (jewel tunables)."""
    vary_r, stable = h.chooseleaf_vary_r, h.chooseleaf_stable
    count = out_size
    item = 0
    for rep in range(0 if stable else outpos, numrep):
        if count <= 0:
            break
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_b = bid
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = reject = False
                r = rep + parent_r + ftotal
                _t, items, weights = h.buckets[in_b]
                if not items:
                    reject = True
                else:
                    item = straw2_choose(items, weights, x, r)
                    if item >= h.max_devices:
                        skip_rep = True
                        break
                    itemtype = _type_of(h, item)
                    if itemtype != type_:
                        if item >= 0 or itemtype is None:
                            skip_rep = True
                            break
                        in_b = item
                        retry_bucket = True
                        continue
                    collide = item in out[:outpos]
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if choose_firstn(
                                h, item, weight, x, 1 if stable else outpos + 1, 0,
                                out2, outpos, count, recurse_tries, 0, False, None, sub_r,
                            ) <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = is_out(weight, item, x)
                if reject or collide:
                    ftotal += 1
                    if ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
        if skip_rep:
            continue
        out[outpos] = item
        outpos += 1
        count -= 1
    return outpos


def choose_indep(h, bid, weight, x, left, numrep, type_, out, outpos, tries,
                 recurse_tries, recurse_to_leaf, out2, parent_r):
    """mapper.c crush_choose_indep for straw2 buckets."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = ITEM_UNDEF
        if out2 is not None:
            out2[rep] = ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != ITEM_UNDEF:
                continue
            in_b = bid
            while True:
                r = rep + parent_r + numrep * ftotal
                _t, items, weights = h.buckets[in_b]
                if not items:
                    break
                item = straw2_choose(items, weights, x, r)
                if item >= h.max_devices:
                    out[rep] = ITEM_NONE
                    if out2 is not None:
                        out2[rep] = ITEM_NONE
                    left -= 1
                    break
                itemtype = _type_of(h, item)
                if itemtype != type_:
                    if item >= 0 or itemtype is None:
                        out[rep] = ITEM_NONE
                        if out2 is not None:
                            out2[rep] = ITEM_NONE
                        left -= 1
                        break
                    in_b = item
                    continue
                if any(out[i] == item for i in range(outpos, endpos)):
                    break
                if recurse_to_leaf:
                    if item < 0:
                        choose_indep(h, item, weight, x, 1, numrep, 0, out2, rep,
                                     recurse_tries, 0, False, None, r)
                        if out2[rep] == ITEM_NONE:
                            break
                    elif out2 is not None:
                        out2[rep] = item
                if itemtype == 0 and is_out(weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == ITEM_UNDEF:
            out[rep] = ITEM_NONE
        if out2 is not None and out2[rep] == ITEM_UNDEF:
            out2[rep] = ITEM_NONE


def do_rule(h: Hierarchy, ruleno: int, x: int, result_max: int, weight: list) -> list:
    """mapper.c crush_do_rule; EC holes are ITEM_NONE."""
    choose_tries = h.choose_total_tries + 1
    choose_leaf_tries = 0
    result: list = []
    w: list = []
    for op, arg1, arg2 in h.rules[ruleno]:
        if op == RULE_TAKE:
            w = [arg1]
        elif op == RULE_SET_CHOOSE_TRIES:
            if arg1 > 0:
                choose_tries = arg1
        elif op == RULE_SET_CHOOSELEAF_TRIES:
            if arg1 > 0:
                choose_leaf_tries = arg1
        elif op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSE_FIRSTN,
                    RULE_CHOOSELEAF_INDEP, RULE_CHOOSE_INDEP):
            firstn = op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSE_FIRSTN)
            leaf = op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP)
            o: list = []
            c: list = []
            for item in w:
                numrep = arg1 if arg1 > 0 else arg1 + result_max
                if numrep <= 0 or item not in h.buckets:
                    continue
                avail = result_max - len(o)
                fo = [0] * result_max
                fc = [0] * result_max
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif h.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    got = choose_firstn(h, item, weight, x, numrep, arg2, fo, 0, avail,
                                        choose_tries, recurse_tries, leaf, fc, 0)
                else:
                    got = min(numrep, avail)
                    choose_indep(h, item, weight, x, got, numrep, arg2, fo, 0,
                                 choose_tries, choose_leaf_tries or 1, leaf, fc, 0)
                o.extend(fo[:got])
                c.extend(fc[:got])
            w = c if leaf else o
        elif op == RULE_EMIT:
            result.extend(w[: result_max - len(result)])
            w = []
    return result
