"""The ceph_tpu_torch erasure-code slice held against ceph_tpu as a whole.

Registry → jerasure/isa plugin → encode/decode → torch backend, at
``device="cpu"`` (the kernels' plain versions), against the JAX package
with ``backend="jax"`` and against the archived ``corpus/`` chunks.
Byte-exact: tolerance 0.
"""

from __future__ import annotations

import base64
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

from ceph_tpu.ec import ErasureCodeProfile as JProfile
from ceph_tpu.ec import registry_instance as j_registry
from ceph_tpu.tools.ec_non_regression import default_payload
from ceph_tpu_torch.ec import ErasureCodeError, ErasureCodeProfile, registry_instance
from ceph_tpu_torch.ec.backend import get_backend
from ceph_tpu_torch.tools import ec_benchmark

CORPUS = pathlib.Path(__file__).resolve().parent.parent / "corpus"

PROFILES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "reed_sol_van", "k": "3", "m": "2", "w": "16"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "4"}),
    ("jerasure", {"technique": "cauchy_orig", "k": "3", "m": "2", "packetsize": "8"}),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2", "packetsize": "16"}),
    ("jerasure", {"technique": "liberation", "k": "5", "m": "2", "w": "7", "packetsize": "8"}),
    ("jerasure", {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6", "packetsize": "8"}),
    ("jerasure", {"technique": "liber8tion", "k": "4", "m": "2", "packetsize": "8"}),
    ("isa", {"technique": "reed_sol_van", "k": "5", "m": "3"}),
    ("isa", {"technique": "cauchy", "k": "4", "m": "3"}),
]


def _pair(plugin, prof):
    jec = j_registry().factory(plugin, JProfile(prof, backend="jax"))
    tec = registry_instance().factory(plugin, ErasureCodeProfile(prof, device="cpu"))
    return jec, tec


@pytest.mark.parametrize(
    "plugin,prof", PROFILES, ids=[f"{p}-{d['technique']}" for p, d in PROFILES]
)
def test_slice_matches_jax_package(plugin, prof):
    jec, tec = _pair(plugin, prof)
    size = 3 * tec.get_chunk_size(1) + 17
    data = np.random.default_rng(len(str(prof))).integers(0, 256, size, dtype=np.uint8)
    n = tec.get_chunk_count()
    want = jec.encode(set(range(n)), data.tobytes())
    got = tec.encode(set(range(n)), data.tobytes())
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i])
    for e in range(1, tec.m + 1):
        for erased in itertools.combinations(range(n), e):
            avail = {i: c for i, c in got.items() if i not in erased}
            jd = jec.decode(set(erased), dict(avail))
            td = tec.decode(set(erased), dict(avail))
            for i in erased:
                np.testing.assert_array_equal(td[i], want[i])
                np.testing.assert_array_equal(td[i], jd[i])
    assert tec.decode_concat(got)[: len(data)].tobytes() == data.tobytes()


EC_CORPUS = sorted(
    p for p in CORPUS.glob("*.json") if p.name.startswith(("jerasure_", "isa_"))
)


def test_corpus_has_the_seven_entries():
    assert len(EC_CORPUS) == 7


@pytest.mark.parametrize("path", EC_CORPUS, ids=[p.stem for p in EC_CORPUS])
def test_corpus_chunks(path):
    entry = json.loads(path.read_text())
    ec = registry_instance().factory(
        entry["plugin"], ErasureCodeProfile(entry["profile"], device="cpu")
    )
    n = ec.get_chunk_count()
    encoded = ec.encode(set(range(n)), default_payload(entry["size"]))
    archived = {
        int(i): np.frombuffer(base64.b64decode(c), dtype=np.uint8)
        for i, c in entry["chunks"].items()
    }
    for i in range(n):
        np.testing.assert_array_equal(encoded[i], archived[i])
    for lost in range(n):
        avail = {i: c for i, c in archived.items() if i != lost}
        np.testing.assert_array_equal(ec._decode({lost}, avail)[lost], archived[lost])


@pytest.mark.parametrize(
    "argv",
    [
        ["-w", "encode", "-i", "2"],
        ["-w", "decode", "-E", "exhaustive", "-e", "2"],
        ["-w", "encode", "--batch", "3"],
    ],
)
def test_ec_benchmark_cli(argv, capsys):
    args = ["-p", "isa", "-P", "k=4", "-P", "m=2", "-s", "8192", "--device", "cpu"]
    assert ec_benchmark.main(args + argv) == 0
    seconds, kb = capsys.readouterr().out.strip().splitlines()[-1].split("\t")
    assert float(seconds) >= 0
    batch = int(argv[-1]) if "--batch" in argv else 1
    iterations = int(argv[argv.index("-i") + 1]) if "-i" in argv else 1
    assert int(kb) == 8 * batch * iterations


def test_batch_methods_match_per_batch():
    _jec, tec = _pair("isa", {"technique": "reed_sol_van", "k": "4", "m": "2"})
    backend, mat = tec.backend, tec.matrix
    rng = np.random.default_rng(21)
    batches = [rng.integers(0, 256, (b, 4, 64), dtype=np.uint8) for b in (1, 3, 2, 5)]
    outs = backend.matrix_stripes_batch(mat, batches, 8, group_stripes=4)
    for s, o in zip(batches, outs):
        np.testing.assert_array_equal(o, backend.matrix_stripes(mat, s, 8))
    # decode: survivors 1..4 (chunk 0 erased) as 1-D payloads per object
    from ceph_tpu_torch.gf import make_decoding_matrix

    dec, survivors = make_decoding_matrix(mat, [0], 4, 8)
    row_sets = []
    for s, o in zip(batches, outs):
        full = np.concatenate([s, o], axis=1)  # (B, 6, chunk)
        row_sets.append([full[:, i].reshape(-1).tobytes() for i in survivors])
    rec = backend.decode_stripes_batch(dec, row_sets, 8, 64, group_stripes=4)
    for s, r in zip(batches, rec):
        np.testing.assert_array_equal(r[:, 0], s[:, 0])
    with pytest.raises(TypeError):
        backend.decode_stripes_batch(dec, [[object()] * 4], 8, 64)


def test_batch_methods_take_ragged_batches_unpadded(monkeypatch):
    # K2 reads any batch size in place: each group of stripes reaches the
    # kernel's wrapper as it is, with no padding to a power of two
    from ceph_tpu_torch.gf import make_decoding_matrix
    from ceph_tpu_torch.ops import bitplane_gf

    _jec, tec = _pair("isa", {"technique": "reed_sol_van", "k": "4", "m": "2"})
    backend, mat = tec.backend, tec.matrix
    seen = []
    wrapped = bitplane_gf.gf8_bitplane_stripes

    def recording(bm, stripes):
        seen.append(stripes.shape[0])
        return wrapped(bm, stripes)

    monkeypatch.setattr(bitplane_gf, "gf8_bitplane_stripes", recording)
    rng = np.random.default_rng(22)
    batches = [rng.integers(0, 256, (b, 4, 36), dtype=np.uint8) for b in (1, 3, 300)]
    outs = backend.matrix_stripes_batch(mat, batches, 8)
    assert seen == [4, 300]  # groups of at most 256 stripes: (1 + 3), then 300
    for s, o in zip(batches, outs):
        np.testing.assert_array_equal(o, backend.matrix_stripes(mat, s, 8))
    dec, survivors = make_decoding_matrix(mat, [2], 4, 8)
    row_sets = [
        [np.concatenate([s, o], axis=1)[:, i].reshape(-1) for i in survivors]
        for s, o in zip(batches, outs)
    ]
    seen.clear()
    rec = backend.decode_stripes_batch(dec, row_sets, 8, 36)
    assert seen == [4, 300]
    for s, r in zip(batches, rec):
        np.testing.assert_array_equal(r[:, 0], s[:, 2])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ErasureCodeError):
        registry_instance().factory("jerasure", ErasureCodeProfile(k="4", m="2"))
    with pytest.raises(ErasureCodeError):
        registry_instance().factory(
            "isa", ErasureCodeProfile(k="4", m="2", device="cuda")
        )


def test_unknown_backend_and_device_raise():
    with pytest.raises(ValueError):
        get_backend("numpy", "cpu")
    with pytest.raises(ErasureCodeError):
        registry_instance().factory(
            "isa", ErasureCodeProfile(k="4", m="2", device="nonsense")
        )
