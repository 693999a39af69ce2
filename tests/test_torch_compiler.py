"""ceph_tpu_torch's CRUSH compiler and crushtool against the JAX package.

The port's ``crush/compiler.py`` is a copy of the JAX package's: the
reference binary format (CrushWrapper::encode/decode) and the text
grammar (CrushCompiler).  Every map here is built twice, once with each
package's own builder, from the same recipe: straw2, straw (both
``straw_calc_version``s), list, tree and uniform hosts; device classes
with shadow trees; choose_args with one and with several positions and
several choose_args maps; legacy, hammer and jewel tunables.  The
checks are exact: equal encoded bytes, each package decoding the other's
blob to the same text, compile → decompile round trips byte for byte,
the same exception class and message for each malformed input, and the
two crushtools' stdout and exit status for ``-c``, ``-d``, ``-i …
--test``, ``--tree`` and ``--compare`` (the JAX tool on ``--backend
oracle``, the port's on ``--backend torch --device cpu``; the backend
label, the timings and the port's fallback-lane line left out).

The twins of ``tests/test_compiler.py``'s tests over the reference's
crushtool corpus keep its ``needs_ref`` skip.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

import ceph_tpu.crush.builder as j_builder
import ceph_tpu.crush.compiler as jc
import ceph_tpu.crush.types as j_types
import ceph_tpu.tools.crushtool as j_tool
import ceph_tpu_torch.crush.builder as t_builder
import ceph_tpu_torch.crush.compiler as tc
import ceph_tpu_torch.crush.types as t_types
import ceph_tpu_torch.tools.crushtool as t_tool
from ceph_tpu_torch.crush import torchmap
from ceph_tpu_torch.osd.mapping import _compiled
from test_compiler import REF, _iter_expected_mappings, needs_ref

PKGS = {
    "jax": (j_builder, j_types, j_tool),
    "torch": (t_builder, t_types, t_tool),
}


# -- maps, one recipe built by each package --------------------------------


def _hosts(pkg, tun, algs, nhosts=4, per_host=4, uneven=True, root_alg=None):
    builder, T, _tool = PKGS[pkg]
    m = builder.CrushMap(tunables=T.Tunables(*tun))
    m.type_names = {0: "osd", 1: "host", 3: "root"}
    hosts = []
    for h in range(nhosts):
        alg = algs[h % len(algs)]
        items = [h * per_host + i for i in range(per_host)]
        for i in items:
            m.item_names[i] = f"osd.{i}"
        if alg == T.CRUSH_BUCKET_UNIFORM or not uneven:
            weights = [0x10000] * per_host
        else:
            weights = [0x8000 + ((h * per_host + i) % 5) * 0x4000 for i in range(per_host)]
        hosts.append(m.add_bucket(alg, 1, items, weights, name=f"host{h}"))
    m.add_bucket(
        root_alg or T.CRUSH_BUCKET_STRAW2, 3, hosts,
        [m.buckets[b].weight for b in hosts], name="default",
    )
    m.add_simple_rule("replicated_rule", "default", "host", mode="firstn")
    m.add_simple_rule("ec_rule", "default", "host", mode="indep")
    return m


JEWEL = (0, 0, 50, 1, 1, 1, 1)
HAMMER = (0, 0, 50, 1, 1, 0, 1)
LEGACY = (2, 5, 19, 0, 0, 0, 0)


def _hierarchy(pkg):
    return PKGS[pkg][2].build_hierarchy(64, 8, 4)


def _classes(pkg):
    m = _hosts(pkg, JEWEL, [PKGS[pkg][1].CRUSH_BUCKET_STRAW2], nhosts=4, per_host=4)
    for i in range(16):
        m.set_item_class(i, "ssd" if i % 3 == 0 else "hdd")
    m.populate_classes()
    m.add_simple_rule("ssd_rule", "default", "host", device_class="ssd", mode="firstn")
    m.add_simple_rule("hdd_ec", "default", "osd", device_class="hdd", mode="indep")
    return m


def _choose_args(pkg, positions: int, maps: int):
    T = PKGS[pkg][1]
    m = _hierarchy(pkg)
    rng = np.random.default_rng(41 + positions)
    per_map = []
    for key in range(maps):
        args = {}
        for bid in sorted(m.buckets, reverse=True):
            b = m.buckets[bid]
            ws = [
                [int(w * f) for w, f in zip(b.item_weights, rng.uniform(0.5, 1.5, b.size))]
                for _ in range(positions)
            ]
            ids = [int(i) + 1000 if i >= 0 else int(i) for i in b.items] if bid % 3 == 0 else None
            args[bid] = T.ChooseArg(weight_set=ws, ids=ids)
        per_map.append(args)
    m.set_choose_args(per_map[0])
    if maps > 1:
        m.choose_args_maps = {-1 if k == 0 else k: a for k, a in enumerate(per_map)}
    return m


def _alg(name):
    return lambda pkg: getattr(PKGS[pkg][1], f"CRUSH_BUCKET_{name}")


MAPS = {
    "straw2_racks": _hierarchy,
    "straw_v0": lambda p: _hosts(p, HAMMER[:6] + (0,), [_alg("STRAW")(p)]),
    "straw_v1": lambda p: _hosts(p, HAMMER, [_alg("STRAW")(p)]),
    "list_hosts": lambda p: _hosts(p, JEWEL, [_alg("LIST")(p)]),
    "tree_hosts": lambda p: _hosts(p, JEWEL, [_alg("TREE")(p)], per_host=5),
    "uniform_hosts": lambda p: _hosts(p, JEWEL, [_alg("UNIFORM")(p)]),
    "mixed_algs": lambda p: _hosts(
        p, JEWEL,
        [_alg(a)(p) for a in ("STRAW2", "STRAW", "LIST", "TREE", "UNIFORM")],
        nhosts=5, root_alg=_alg("STRAW")(p),
    ),
    "classes": _classes,
    "choose_args_one": lambda p: _choose_args(p, 1, 1),
    "choose_args_several": lambda p: _choose_args(p, 3, 2),
    "legacy": lambda p: _hosts(p, LEGACY, [_alg("STRAW")(p)]),
    "hammer": lambda p: _hosts(p, HAMMER, [_alg("STRAW2")(p)]),
    "jewel": lambda p: _hosts(p, JEWEL, [_alg("STRAW2")(p)], uneven=False),
}


@pytest.fixture(params=sorted(MAPS), scope="module")
def pair(request):
    """(name, the JAX package's map, the port's map)."""
    build = MAPS[request.param]
    return request.param, build("jax"), build("torch")


# -- the binary format and the text grammar --------------------------------


def test_encode_gives_equal_bytes(pair):
    _name, jm, tm = pair
    blob = tc.encode_crushmap(tm)
    assert blob == jc.encode_crushmap(jm)
    assert len(blob) > 100


def test_each_package_decodes_the_others_blob(pair):
    _name, jm, tm = pair
    jblob, tblob = jc.encode_crushmap(jm), tc.encode_crushmap(tm)
    text = jc.decompile_crushmap(jc.decode_crushmap(jblob))
    assert tc.decompile_crushmap(tm) == jc.decompile_crushmap(jm) == text
    assert tc.decompile_crushmap(tc.decode_crushmap(jblob)) == text
    assert jc.decompile_crushmap(jc.decode_crushmap(tblob)) == text
    assert tc.encode_crushmap(tc.decode_crushmap(jblob)) == jblob


def test_compile_decompile_round_trips_byte_for_byte(pair):
    _name, _jm, tm = pair
    text = tc.decompile_crushmap(tc.decode_crushmap(tc.encode_crushmap(tm)))
    m2 = tc.compile_crushmap(text)
    assert tc.decompile_crushmap(m2) == text
    assert tc.encode_crushmap(m2) == jc.encode_crushmap(jc.compile_crushmap(text))
    assert tc.encode_crushmap(tc.compile_crushmap(tc.decompile_crushmap(m2))) == (
        tc.encode_crushmap(m2)
    )


def test_decoded_map_compiles_fresh_for_the_batched_mapper(pair):
    """A decoded map is a new CrushMap with no compiled table of its
    own; torchmap compiles it from the stored payloads and maps like
    the oracle (and like the JAX package's oracle on its own decode)."""
    name, jm, tm = pair
    blob = tc.encode_crushmap(tm)
    jdec = jc.decode_crushmap(blob)
    xs = np.arange(64)
    try:
        # the source map's cached tables are not carried into a decode
        _compiled(tm, "cpu")
        assert tm._torch_compiled
        decoded = tc.decode_crushmap(blob)
        assert getattr(decoded, "_torch_compiled", None) is None
        cm = _compiled(decoded, "cpu")
        assert cm.source is decoded
    except torchmap.UnsupportedMap:
        assert name == "legacy"
        decoded, cm = tc.decode_crushmap(blob), None
    for rule, rmax in ((0, 3), (1, 4)):
        want = [jdec.do_rule(rule, int(x), rmax) for x in xs]
        assert [decoded.do_rule(rule, int(x), rmax) for x in xs] == want
        if cm is not None:
            res, counts = torchmap.batch_do_rule(cm, rule, xs, rmax)
            assert [res[i, : counts[i]].tolist() for i in range(len(xs))] == want


INVALID_TEXTS = {
    "unknown_tunable": "tunable no_such_tunable 3\n",
    "undefined_type": "device 0 osd.0\ntype 0 osd\nrack r {\n\tid -1\n\talg straw2\n}\n",
    "bad_alg": "type 0 osd\ntype 1 host\nhost h {\n\tid -1\n\talg fancy\n}\n",
    "no_alg": "device 0 osd.0\ntype 0 osd\ntype 1 host\nhost h {\n\tid -1\n\titem osd.0\n}\n",
    "undefined_item": (
        "type 0 osd\ntype 1 host\nhost h {\n\tid -1\n\talg straw2\n\titem osd.9\n}\n"
    ),
    "pos_twice": (
        "device 0 osd.0\ndevice 1 osd.1\ntype 0 osd\ntype 1 host\n"
        "host h {\n\tid -1\n\talg straw2\n\titem osd.0 pos 0\n\titem osd.1 pos 0\n}\n"
    ),
    "bad_weight": (
        "device 0 osd.0\ntype 0 osd\ntype 1 host\n"
        "host h {\n\tid -1\n\talg straw2\n\titem osd.0 weight heavy\n}\n"
    ),
    "unknown_bucket_field": (
        "type 0 osd\ntype 1 host\nhost h {\n\tid -1\n\talg straw2\n\tcolour blue\n}\n"
    ),
    "unknown_step": "type 0 osd\nrule r {\n\tid 0\n\tstep jump 3\n}\n",
    "unknown_set_step": "type 0 osd\nrule r {\n\tid 0\n\tstep set_jump 3\n}\n",
    "unknown_rule_field": "type 0 osd\nrule r {\n\tid 0\n\tcolour 3\n}\n",
    "rule_type_undefined": (
        "type 0 osd\nrule r {\n\tid 0\n\tstep chooseleaf firstn 0 type rack\n}\n"
    ),
    "take_undefined": "type 0 osd\nrule r {\n\tid 0\n\tstep take nowhere\n\tstep emit\n}\n",
    "rule_twice": (
        "device 0 osd.0\ntype 0 osd\ntype 1 root\nroot d {\n\tid -1\n\talg straw2\n"
        "\titem osd.0\n}\nrule a {\n\tid 0\n\tstep take d\n\tstep emit\n}\n"
        "rule b {\n\tid 0\n\tstep take d\n\tstep emit\n}\n"
    ),
    "no_shadow_tree": (
        "device 0 osd.0\ntype 0 osd\ntype 1 root\nroot d {\n\tid -1\n\talg straw2\n"
        "\titem osd.0\n}\nrule a {\n\tid 0\n\tstep take d class ssd\n\tstep emit\n}\n"
    ),
    "choose_args_no_bucket": "choose_args 0 {\n  {\n    ids [ 1 2 ]\n  }\n}\n",
    "choose_args_bad_field": "choose_args 0 {\n  {\n    colour 3\n  }\n}\n",
    "truncated": "device 0 osd.0\ntype 0 osd\ntype 1 host\nhost h {\n\tid -1\n\talg",
    "expected_brace": "type 0 osd\ntype 1 host\nhost h id -1\n",
    "not_a_number": "device zero osd.0\n",
    "uniform_weights": (
        "device 0 osd.0\ndevice 1 osd.1\ntype 0 osd\ntype 1 host\nhost h0 {\n\tid -1\n"
        "\talg uniform\n\thash 0\n\titem osd.0 weight 1.000\n\titem osd.1 weight 2.000\n}\n"
    ),
}


def _raised(fn, arg):
    try:
        fn(arg)
    except Exception as e:  # noqa: BLE001 - the class itself is compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name", sorted(INVALID_TEXTS))
def test_invalid_text_raises_as_the_jax_compiler(name):
    text = INVALID_TEXTS[name]
    got = _raised(tc.compile_crushmap, text)
    assert got is not None, name
    assert got == _raised(jc.compile_crushmap, text)


def _blob():
    return tc.encode_crushmap(MAPS["choose_args_several"]("torch"))


INVALID_BLOBS = {
    "bad_magic": lambda: b"\x00\x00\x02\x00" + _blob()[4:],
    "empty": lambda: b"",
    "truncated_header": lambda: _blob()[:10],
    "truncated_buckets": lambda: _blob()[:200],
    "truncated_choose_args": lambda: _blob()[:-3],
    "choose_arg_empty_row": lambda: _choose_arg_on_empty_row(),
}


def _choose_arg_on_empty_row() -> bytes:
    m = MAPS["straw2_racks"]("torch")
    m.binary_max_buckets = max(-b for b in m.buckets) + 2
    blob = bytearray(tc.encode_crushmap(m))
    # one choose_args map naming row max_buckets - 1 (an empty row)
    tail = (
        (1).to_bytes(4, "little") + (-1).to_bytes(8, "little", signed=True)
        + (1).to_bytes(4, "little") + (m.binary_max_buckets - 1).to_bytes(4, "little")
        + bytes(8)
    )
    return bytes(blob[:-4]) + tail


@pytest.mark.parametrize("name", sorted(INVALID_BLOBS))
def test_invalid_blob_raises_as_the_jax_decoder(name):
    blob = INVALID_BLOBS[name]()
    got = _raised(tc.decode_crushmap, blob)
    assert got is not None and got[0] == "CrushCompilerError", got
    assert got == _raised(jc.decode_crushmap, blob)


def test_decode_reads_64_bit_name_keys_and_optional_tails():
    """decode_32_or_64_string_map's 64-bit keys (a zero length, then
    the real one), and blobs cut where the reference's decode stops
    early: after the name maps (legacy tunables), after each tunable,
    and before the choose_args.  Both packages read the same map."""
    m = MAPS["classes"]("torch")
    blob = tc.encode_crushmap(m)
    names = [m.type_names, m.item_names, m.rule_names]
    narrow = b"".join(_string_map(x) for x in names)
    at = blob.index(narrow)
    head, tail = blob[:at], blob[at + len(narrow):]
    wide = head + b"".join(_string_map(x, wide_keys=True) for x in names)
    full = tc.decode_crushmap(wide + tail)
    assert tc.decompile_crushmap(full) == tc.decompile_crushmap(m)
    assert tc.encode_crushmap(full) == blob
    # tunables: 3 x u32, u32, u8, u8, u32, u8; then the class maps
    cuts = [0, 12, 16, 17, 18, 22, 23, len(tail) - 4, len(tail)]
    for cut in cuts:
        tm, jm = tc.decode_crushmap(wide + tail[:cut]), jc.decode_crushmap(wide + tail[:cut])
        assert tc.decompile_crushmap(tm) == jc.decompile_crushmap(jm), cut
        assert vars(tm.tunables) == vars(jm.tunables), cut
        assert tc.encode_crushmap(tm) == jc.encode_crushmap(jm), cut
    assert tc.decode_crushmap(wide).tunables == t_types.Tunables(*LEGACY)


def _string_map(d: dict, wide_keys: bool = False) -> bytes:
    out = bytearray(len(d).to_bytes(4, "little"))
    for k in sorted(d):
        out += int(k).to_bytes(4, "little", signed=True)
        raw = d[k].encode()
        if wide_keys:
            out += bytes(4)
        out += len(raw).to_bytes(4, "little") + raw
    return bytes(out)


# -- the inline texts of tests/test_compiler.py ----------------------------

MIXED_POS = """
device 0 osd.0
device 1 osd.1
device 2 osd.2
type 0 osd
type 1 host
type 3 root
host h0 {
\tid -1
\talg straw2
\thash 0
\titem osd.1 weight 1.000 pos 1
\titem osd.0 weight 1.000
\titem osd.2 weight 1.000 pos 0
}
root default {
\tid -2
\talg straw2
\thash 0
\titem h0
}
"""


def test_compile_default_weights_and_mixed_pos():
    m = tc.compile_crushmap(MIXED_POS)
    assert m.buckets[-1].items == [2, 1, 0]
    assert m.buckets[-2].item_weights == [3 * 0x10000]
    jm = jc.compile_crushmap(MIXED_POS)
    assert tc.encode_crushmap(m) == jc.encode_crushmap(jm)
    assert tc.decompile_crushmap(m) == jc.decompile_crushmap(jm)


def test_compile_uniform_weight_mismatch_rejected():
    with pytest.raises(tc.CrushCompilerError):
        tc.compile_crushmap(INVALID_TEXTS["uniform_weights"])


# -- crushtool -------------------------------------------------------------

BACKEND = {
    "jax": ["--backend", "oracle"],
    "torch": ["--backend", "torch", "--device", "cpu"],
}
_TIMING = re.compile(r" in [0-9.]+s = [0-9a-z.]+ mappings/sec \[[a-z]+\]$")


def _normal(out: str) -> list[str]:
    return [
        _TIMING.sub("", ln)
        for ln in out.splitlines()
        if not ln.startswith("oracle fallback lanes:")
    ]


def _both(capsys, argv, mapping: bool = True) -> tuple:
    """Run both crushtools on ``argv``; returns ((rc, lines), ...)."""
    got = []
    for pkg in ("jax", "torch"):
        tool = PKGS[pkg][2]
        rc = tool.main(argv + (BACKEND[pkg] if mapping else []))
        got.append((rc, _normal(capsys.readouterr().out)))
    return tuple(got)


@pytest.fixture()
def binaries(tmp_path):
    out = {}
    for name in ("straw2_racks", "classes", "choose_args_several", "mixed_algs", "legacy"):
        p = tmp_path / f"{name}.bin"
        p.write_bytes(jc.encode_crushmap(MAPS[name]("jax")))
        out[name] = p
    return out


def test_crushtool_compile_and_decompile_files(tmp_path, binaries, capsys):
    src = binaries["classes"]
    text = tc.decompile_crushmap(tc.decode_crushmap(src.read_bytes()))
    txt = tmp_path / "m.txt"
    txt.write_text(text)
    outs = {}
    for pkg in ("jax", "torch"):
        tool = PKGS[pkg][2]
        binout, txtout = tmp_path / f"{pkg}.bin", tmp_path / f"{pkg}.txt"
        assert tool.main(["-c", str(txt), "-o", str(binout)]) == 0
        assert tool.main(["-d", str(binout), "-o", str(txtout)]) == 0
        assert tool.main(["-d", str(binout)]) == 0
        outs[pkg] = (binout.read_bytes(), txtout.read_text(), capsys.readouterr().out)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == src.read_bytes()
    assert outs["torch"][1] == outs["torch"][2] == text
    # -c without -o writes next to its input
    assert t_tool.main(["-c", str(txt)]) == 0
    assert (tmp_path / "m.txt.compiled").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("name", ["straw2_racks", "classes", "choose_args_several",
                                  "mixed_algs", "legacy"])
@pytest.mark.parametrize("rule,num_rep", [(0, 3), (1, 4)])
def test_crushtool_input_test(binaries, capsys, name, rule, num_rep):
    argv = ["-i", str(binaries[name]), "--test", "--max-x", "96", "--rule", str(rule),
            "--num-rep", str(num_rep), "--show-utilization", "--show-statistics",
            "--show-bad-mappings", "--weight", "3:0.5", "--weight", "5:0"]
    jax, port = _both(capsys, argv)
    assert port == jax
    assert port[0] == 0 and any(ln.startswith("chi-squared = ") for ln in port[1])


def test_crushtool_decompile_composes_with_test_tree_and_compare(binaries, capsys):
    a, b = binaries["straw2_racks"], binaries["choose_args_several"]
    argv = ["-d", str(a), "--tree", "--compare", str(b), "--test", "--max-x", "64"]
    jax, port = _both(capsys, argv)
    assert port == jax
    rc, lines = port
    assert rc == 1  # the maps differ: --compare's status survives --test
    assert lines[0] == "# begin crush map"
    assert "ID\tWEIGHT\tTYPE NAME" in lines
    assert "warning: maps are NOT equivalent" in lines
    assert any(ln.startswith("rule 0 x [0,64) num_rep 3: 64 mappings") for ln in lines)


@pytest.mark.parametrize("name", ["straw2_racks", "classes", "mixed_algs"])
def test_crushtool_tree(binaries, capsys, name):
    jax, port = _both(capsys, ["-i", str(binaries[name]), "--tree"], mapping=False)
    assert port == jax and port[0] == 0
    assert port[1][0] == "ID\tWEIGHT\tTYPE NAME"
    jax, port = _both(capsys, ["--build", "8:4", "--tree"], mapping=False)
    assert port == jax


def test_crushtool_compare_delta_and_equivalence(tmp_path, capsys):
    """--compare on both backends: identical maps are equivalent (rc
    0), a map with 1 % of its weights changed is not (rc 1), with the
    same delta; the port maps both maps on its backend and device."""
    m1 = t_tool.build_hierarchy(100, 10, 5)
    m2 = t_tool.build_hierarchy(100, 10, 5, weight_fn=lambda o: 0x8000 if o == 7 else 0x10000)
    p1, p2 = tmp_path / "a.bin", tmp_path / "b.bin"
    p1.write_bytes(tc.encode_crushmap(m1))
    p2.write_bytes(tc.encode_crushmap(m2))
    for rule, rep in ((0, 3), (1, 5)):
        base = ["--max-x", "128", "--rule", str(rule), "--num-rep", str(rep)]
        same = _both(capsys, ["-i", str(p1), "--compare", str(p1)] + base)
        assert same[0] == same[1] == (0, [
            f"rule {rule} x [0,128) num_rep {rep}: 0/128 mappings changed (ratio 0.000000)",
            f"moved slots: 0/{128 * rep} (ratio 0.000000)",
            "maps appear equivalent",
        ])
        jax, port = _both(capsys, ["-i", str(p1), "--compare", str(p2)] + base)
        assert port == jax and port[0] == 1
        assert port[1][2] == "warning: maps are NOT equivalent"
        assert int(port[1][0].split(": ")[1].split("/")[0]) > 0


def test_crushtool_needs_an_action():
    for tool in (j_tool, t_tool):
        with pytest.raises(SystemExit):
            tool.main([])
    assert not hasattr(t_tool, "NOT_PORTED")


# -- twins of the reference-corpus tests (skip without the mount) -----------

BINARIES = [
    "check-overlapped-rules.crushmap",
    "five-devices.crushmap",
    "test-map-a.crushmap",
    "test-map-big-1.crushmap",
    "test-map-hammer-tunables.crushmap",
    "test-map-indep.crushmap",
    "test-map-jewel-tunables.crushmap",
    "test-map-tries-vs-retries.crushmap",
    "test-map-vary-r.crushmap",
]


@needs_ref
@pytest.mark.parametrize("name", BINARIES)
def test_decode_reference_binaries(name):
    data = (REF / name).read_bytes()
    m, jm = tc.decode_crushmap(data), jc.decode_crushmap(data)
    assert tc.decompile_crushmap(m) == jc.decompile_crushmap(jm)
    assert tc.encode_crushmap(m) == jc.encode_crushmap(jm)


@needs_ref
def test_modern_binary_reencodes_byte_identical():
    data = (REF / "check-overlapped-rules.crushmap").read_bytes()
    assert tc.encode_crushmap(tc.decode_crushmap(data)) == data


@needs_ref
@pytest.mark.parametrize(
    "name", ["need_tree_order.crush", "choose-args.crush", "device-class.crush"]
)
def test_text_compile_decompile_byte_identical(name):
    text = (REF / name).read_text()
    m = tc.compile_crushmap(text)
    assert tc.decompile_crushmap(m) == text
    assert tc.encode_crushmap(m) == jc.encode_crushmap(jc.compile_crushmap(text))


@needs_ref
def test_binary_roundtrip_through_text():
    m = tc.decode_crushmap((REF / "test-map-tries-vs-retries.crushmap").read_bytes())
    m2 = tc.compile_crushmap(tc.decompile_crushmap(m))
    weight = [0x10000] * m.max_devices
    for x in range(64):
        assert m.do_rule(0, x, 3, weight) == m2.do_rule(0, x, 3, weight), x


@needs_ref
def test_replay_reference_recorded_mappings():
    """The port's decode and batched mapper against the recorded
    mappings of test-map-tries-vs-retries.t (devices 0 and 8 zeroed)."""
    m = tc.decode_crushmap((REF / "test-map-tries-vs-retries.crushmap").read_bytes())
    weight = [0x10000] * m.max_devices
    weight[0] = weight[8] = 0
    cm = torchmap.compile_map(m, device="cpu")
    checked = 0
    for i, (rule, numrep, x, want) in enumerate(
        _iter_expected_mappings(REF / "test-map-tries-vs-retries.t")
    ):
        if i % 13:
            continue
        res, counts = torchmap.batch_do_rule(cm, rule, [x], numrep, weight)
        assert res[0, : counts[0]].tolist() == want, (rule, numrep, x)
        checked += 1
    assert checked > 700


@needs_ref
def test_firstn_indep_bad_mappings():
    text = (REF / "test-map-firstn-indep.txt").read_text()
    m, jm = tc.compile_crushmap(text), jc.compile_crushmap(text)
    weight = [0x10000] * m.max_devices
    for rule in (0, 1):
        for numrep in range(1, 11):
            assert m.do_rule(rule, 1, numrep, weight) == jm.do_rule(rule, 1, numrep, weight)


@needs_ref
def test_crushtool_cli_compile_decompile(tmp_path, capsys):
    src = REF / "need_tree_order.crush"
    binout, txtout = tmp_path / "nto.bin", tmp_path / "nto.txt"
    assert t_tool.main(["-c", str(src), "-o", str(binout)]) == 0
    assert t_tool.main(["-d", str(binout), "-o", str(txtout)]) == 0
    assert txtout.read_text() == src.read_text()
    jax, port = _both(capsys, ["-i", str(binout), "--test", "--max-x", "64", "--num-rep", "2"])
    assert port == jax and port[0] == 0
