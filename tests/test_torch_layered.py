"""The port's layered plugins (lrc, shec, clay) and the example plugin
held against the JAX package, byte-exact (tolerance 0).

At small widths the JAX side runs with ``backend="jax"`` (its XLA region
math on the CPU); at BASELINE.md's widths (lrc k=8 m=4 l=6, shec k=8 m=4
c=2, clay k=8 m=4 d=11), on one stripe, against its default numpy
oracle.  The port runs with ``device="cpu"`` (the kernels' plain
versions).  Compared: the encode, every single erasure and a seeded
sample of double erasures (which patterns raise included),
``minimum_to_decode`` (clay's sub-chunk runs too) and clay's
minimum-bandwidth repair from partial reads.
"""

from __future__ import annotations

import base64
import itertools
import json
import pathlib

import numpy as np
import pytest

from ceph_tpu.ec import ErasureCodeProfile as JProfile
from ceph_tpu.ec import registry_instance as j_registry
from ceph_tpu.ec.interface import ErasureCodeError as JError
from ceph_tpu.tools.ec_non_regression import default_payload
from ceph_tpu_torch.ec import ErasureCodeError, ErasureCodeProfile, registry_instance
from ceph_tpu_torch.ec import backend as ec_backend
from ceph_tpu_torch.ec.registry import (
    FRAMEWORK_VERSION,
    ErasureCodePlugin,
    ErasureCodePluginRegistry,
)
from ceph_tpu_torch.tools import ec_benchmark, ec_non_regression

CORPUS = pathlib.Path(__file__).resolve().parent.parent / "corpus"

EXPLICIT_LAYERS = {
    "mapping": "__DD__DD",
    "layers": '[[ "_cDD_cDD", "" ], [ "cDDD____", "" ], [ "____cDDD", "" ]]',
}
SMALL = [
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("lrc", EXPLICIT_LAYERS),
    ("shec", {"k": "4", "m": "3", "c": "2", "technique": "single"}),
    ("shec", {"k": "4", "m": "3", "c": "2", "technique": "multiple"}),
    ("clay", {"k": "4", "m": "2", "d": "5"}),
    ("clay", {"k": "4", "m": "2", "d": "5", "scalar_mds": "isa"}),
    ("clay", {"k": "4", "m": "2", "d": "5", "scalar_mds": "shec"}),
    ("clay", {"k": "4", "m": "3", "d": "5"}),  # q=2: nu=1
]
BASELINE = [
    ("lrc", {"k": "8", "m": "4", "l": "6"}),
    ("shec", {"k": "8", "m": "4", "c": "2"}),
    ("clay", {"k": "8", "m": "4", "d": "11", "scalar_mds": "jerasure"}),
]


def _ids(cases):
    return ["-".join([plugin] + [f"{k}{v}" for k, v in prof.items() if k != "layers"])
            for plugin, prof in cases]


def _decode_or_error(ec, error, want, avail):
    try:
        return ec._decode(set(want), dict(avail))
    except error:
        return None


def _compare(jec, tec, seed: int, doubles: int):
    n = tec.get_chunk_count()
    assert n == jec.get_chunk_count()
    size = tec.get_chunk_size(1) * tec.get_data_chunk_count() - 5
    assert tec.get_chunk_size(size) == jec.get_chunk_size(size)
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    want = jec.encode(set(range(n)), data)
    got = tec.encode(set(range(n)), data)
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i], f"chunk {i}")
    rng = np.random.default_rng(seed + 1)
    pairs = list(itertools.combinations(range(n), 2))
    picked = [pairs[j] for j in rng.choice(len(pairs), min(doubles, len(pairs)), replace=False)]
    raised = 0
    for erased in [(i,) for i in range(n)] + picked:
        avail = {i: c for i, c in got.items() if i not in erased}
        jd = _decode_or_error(jec, JError, erased, avail)
        td = _decode_or_error(tec, ErasureCodeError, erased, avail)
        assert (jd is None) == (td is None), erased
        if td is None:
            raised += 1
            continue
        for i in erased:
            np.testing.assert_array_equal(td[i], want[i], f"{erased}: chunk {i}")
            np.testing.assert_array_equal(td[i], jd[i])
        assert tec.minimum_to_decode(set(erased), set(avail)) == jec.minimum_to_decode(
            set(erased), set(avail)
        )
    assert tec.decode_concat(got)[: len(data)].tobytes() == data
    return got, raised


def _repair_all(jec, tec, encoded):
    """Clay's minimum-bandwidth repair of each chunk from the partial
    reads minimum_to_decode asks for, on both packages."""
    n = tec.get_chunk_count()
    chunk_size = len(encoded[0])
    sc = chunk_size // tec.get_sub_chunk_count()
    for lost in range(n):
        avail = set(range(n)) - {lost}
        minimum = tec.minimum_to_decode({lost}, avail)
        assert minimum == jec.minimum_to_decode({lost}, avail)
        assert len(minimum) == tec.d
        partial = {
            h: np.concatenate([encoded[h][off * sc : (off + cnt) * sc] for off, cnt in runs])
            for h, runs in minimum.items()
        }
        assert all(len(p) == chunk_size // tec.q for p in partial.values())
        got = tec.decode({lost}, dict(partial), chunk_size)
        np.testing.assert_array_equal(got[lost], encoded[lost], f"repair of {lost}")
        np.testing.assert_array_equal(got[lost], jec.decode({lost}, dict(partial), chunk_size)[lost])


@pytest.mark.parametrize("plugin,prof", SMALL, ids=_ids(SMALL))
def test_small_widths_match_jax_backend(plugin, prof):
    jec = j_registry().factory(plugin, JProfile(prof, backend="jax"))
    tec = registry_instance().factory(plugin, ErasureCodeProfile(prof, device="cpu"))
    encoded, _raised = _compare(jec, tec, seed=len(str(prof)), doubles=6)
    if plugin == "clay":
        _repair_all(jec, tec, encoded)


@pytest.mark.parametrize("plugin,prof", BASELINE, ids=_ids(BASELINE))
def test_baseline_widths_match_numpy_oracle(plugin, prof):
    jec = j_registry().factory(plugin, JProfile(prof))
    tec = registry_instance().factory(plugin, ErasureCodeProfile(prof, device="cpu"))
    encoded, raised = _compare(jec, tec, seed=7, doubles=4 if plugin == "clay" else 10)
    if plugin == "clay":
        assert (tec.q, tec.t, tec.nu, tec.get_sub_chunk_count()) == (4, 3, 0, 64)
        _repair_all(jec, tec, encoded)
    else:
        assert raised < 10  # the sample holds decodable patterns


def test_undecodable_patterns_raise_on_both_sides():
    for plugin, prof, erased in (
        ("shec", {"k": "4", "m": "3", "c": "2"}, (0, 1, 4)),
        ("lrc", {"k": "4", "m": "2", "l": "3"}, (0, 1, 3, 4, 6)),
        ("clay", {"k": "4", "m": "2", "d": "5"}, (0, 1, 2)),
    ):
        jec = j_registry().factory(plugin, JProfile(prof))
        tec = registry_instance().factory(plugin, ErasureCodeProfile(prof, device="cpu"))
        n = tec.get_chunk_count()
        data = bytes(range(256)) * 8
        encoded = tec.encode(set(range(n)), data)
        avail = {i: c for i, c in encoded.items() if i not in erased}
        with pytest.raises(JError):
            jec._decode(set(erased), dict(avail))
        with pytest.raises(ErasureCodeError):
            tec._decode(set(erased), dict(avail))


@pytest.mark.parametrize("plugin,prof", [
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("lrc", EXPLICIT_LAYERS),
    ("clay", {"k": "4", "m": "2", "d": "5", "scalar_mds": "isa"}),
    ("clay", {"k": "4", "m": "2", "d": "5", "scalar_mds": "shec"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
], ids=["lrc-kml", "lrc-layers", "clay-isa", "clay-shec", "shec"])
def test_device_cpu_reaches_every_inner_code(plugin, prof, monkeypatch):
    asked = []
    ec_backend.get_backend("torch", "cpu")  # registers the torch backend
    factory = ec_backend._factories["torch"]

    def recording(device):
        asked.append(device)
        return factory(device)

    monkeypatch.setattr(ec_backend, "_bound", {})
    monkeypatch.setitem(ec_backend._factories, "torch", recording)
    ec = registry_instance().factory(plugin, ErasureCodeProfile(prof, device="cpu"))
    inner = {
        "lrc": lambda: [layer.erasure_code for layer in ec.layers],
        "clay": lambda: [ec.mds, ec.pft],
        "shec": lambda: [ec],
    }[plugin]()
    for code in inner:
        assert code.backend.device.type == "cpu"
    assert asked and set(asked) == {"cpu"}


def test_lrc_layers_keep_their_own_device():
    # no outer device: a layer that names its own keeps it, where the
    # port's default (cuda) would raise without a card
    layers = json.dumps([["DDc_DDc_", {"device": "cpu"}], ["DDc_____", {"device": "cpu"}],
                         ["____DDc_", {"device": "cpu"}]])
    ec = registry_instance().factory("lrc", ErasureCodeProfile(mapping="DD__DD__", layers=layers))
    assert [layer.erasure_code.backend.device.type for layer in ec.layers] == ["cpu"] * 3
    data = bytes(range(256)) * 4
    encoded = ec.encode(set(range(8)), data)
    assert ec.decode_concat(encoded)[: len(data)].tobytes() == data
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    crush = build_hierarchy(64, 4)
    ruleno = ec.create_rule("rule", crush)
    assert crush.rule_names[ruleno] == "rule"
    placed = crush.do_rule(ruleno, 7, 8)
    assert len(set(placed)) == 8


LAYERED_CORPUS = sorted(
    p for p in CORPUS.glob("*.json") if p.name.startswith(("lrc_", "shec_", "clay_"))
)


def test_corpus_has_the_four_layered_entries():
    assert [p.name.split("_")[0] for p in LAYERED_CORPUS] == ["clay", "clay", "lrc", "shec"]


@pytest.mark.parametrize("path", LAYERED_CORPUS, ids=[p.stem for p in LAYERED_CORPUS])
def test_layered_corpus_chunks(path):
    entry = json.loads(path.read_text())
    ec = registry_instance().factory(
        entry["plugin"], ErasureCodeProfile(entry["profile"], device="cpu")
    )
    n = ec.get_chunk_count()
    payload = ec_non_regression.default_payload(entry["size"])
    assert payload == default_payload(entry["size"])
    encoded = ec.encode(set(range(n)), payload)
    archived = {
        int(i): np.frombuffer(base64.b64decode(c), dtype=np.uint8)
        for i, c in entry["chunks"].items()
    }
    for i in range(n):
        np.testing.assert_array_equal(encoded[i], archived[i])
    for lost in range(n):
        avail = {i: c for i, c in archived.items() if i != lost}
        np.testing.assert_array_equal(ec._decode({lost}, avail)[lost], archived[lost])


def test_non_regression_tool_checks_and_names_like_the_jax_tool(tmp_path, capsys):
    from ceph_tpu.tools import ec_non_regression as j_tool

    argv = ["--plugin", "shec", "-P", "k=4", "-P", "m=3", "-P", "c=2", "--size", "4096"]
    assert ec_non_regression.main(
        ["--create", "--directory", str(tmp_path / "port"), "--device", "cpu"] + argv
    ) == 0
    assert j_tool.main(["--create", "--directory", str(tmp_path / "jax")] + argv) == 0
    (port,) = (tmp_path / "port").glob("*.json")
    (jax,) = (tmp_path / "jax").glob("*.json")
    assert port.name == jax.name
    assert json.loads(port.read_text()) == json.loads(jax.read_text())
    capsys.readouterr()
    assert ec_non_regression.main(
        ["--check", "--directory", str(tmp_path / "jax"), "--device", "cpu"]
    ) == 0
    assert capsys.readouterr().out.strip().endswith(": ok")


@pytest.mark.parametrize("plugin,params", [
    ("lrc", ["k=4", "m=2", "l=3"]),
    ("shec", ["k=4", "m=3", "c=2"]),
    ("clay", ["k=4", "m=2", "d=5"]),
])
def test_ec_benchmark_runs_the_layered_plugins(plugin, params, capsys):
    args = ["-p", plugin, "-s", "8192", "--device", "cpu"]
    for p in params:
        args += ["-P", p]
    assert ec_benchmark.main(args + ["-w", "encode"]) == 0
    assert ec_benchmark.main(args + ["-w", "decode", "-E", "exhaustive", "-e", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split("\t")[1] for line in lines] == ["8", "8"]


# -- the example plugin and the registry (tests/test_registry.py) ------------


def test_example_xor_roundtrip_matches_jax():
    ec = registry_instance().factory("example", ErasureCodeProfile())
    jec = j_registry().factory("example", JProfile())
    data = np.random.default_rng(0).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    encoded = ec.encode({0, 1, 2}, data)
    want = jec.encode({0, 1, 2}, data)
    for lost in range(3):
        np.testing.assert_array_equal(encoded[lost], want[lost])
        avail = {i: c for i, c in encoded.items() if i != lost}
        np.testing.assert_array_equal(ec._decode({lost}, avail)[lost], encoded[lost])
    with pytest.raises(ErasureCodeError):
        ec._decode({0, 1}, {2: encoded[2]})


def test_version_mismatch_rejected():
    reg = ErasureCodePluginRegistry()

    class Stale(ErasureCodePlugin):
        version = "ceph-tpu-0"

        def make(self, profile):
            raise AssertionError("unreachable")

    with pytest.raises(ErasureCodeError, match="version"):
        reg.add("stale", Stale())


def test_missing_entry_point_rejected():
    reg = ErasureCodePluginRegistry()

    class NoMake:
        version = FRAMEWORK_VERSION
        make = None

    with pytest.raises(ErasureCodeError, match="entry point"):
        reg.add("nomake", NoMake())


def test_fail_to_initialize_surfaces_error():
    reg = ErasureCodePluginRegistry()

    class Exploding(ErasureCodePlugin):
        def make(self, profile):
            raise ErasureCodeError("cannot initialize")

    reg.add("exploding", Exploding())
    with pytest.raises(ErasureCodeError, match="cannot initialize"):
        reg.factory("exploding", ErasureCodeProfile())


def test_fail_to_register_is_unknown_plugin():
    reg = ErasureCodePluginRegistry()
    with pytest.raises(ErasureCodeError, match="not registered"):
        reg.factory("never_registered", ErasureCodeProfile())


def test_double_registration_rejected():
    reg = ErasureCodePluginRegistry()

    class P(ErasureCodePlugin):
        def make(self, profile):
            raise AssertionError

    reg.add("p", P())
    with pytest.raises(ErasureCodeError, match="already registered"):
        reg.add("p", P())


def test_preload_knows_every_plugin():
    reg = registry_instance()
    reg.preload(["jerasure", "isa", "lrc", "shec", "clay", "example"])
    with pytest.raises(ErasureCodeError):
        reg.preload(["jerasure", "libec_missing"])
