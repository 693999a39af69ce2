"""The port's deep-scrub functions (``ops/scrub_kernels.py``) held against
the JAX package's on the CPU: the GF(2) crc32c as torch products
(``device="cpu"``) against the JAX device path on JAX's CPU, the native
C oracle and the reference vectors; the compare verdicts; the stores'
batched scrub against their per-object scrub; and no fallback that
hides a failed device call."""

from __future__ import annotations

import random

import numpy as np
import pytest

from ceph_tpu.native import ceph_crc32c as j_crc32c
from ceph_tpu.ops import scrub_kernels as j_scrub
from ceph_tpu_torch.native import ceph_crc32c
from ceph_tpu_torch.ops import scrub_kernels as sk
from ceph_tpu_torch.ops.scrub_kernels import GOLDEN_VECTORS, batch_compare, batch_crc32c
from ceph_tpu_torch.store import ECStore, ReplicatedStore, Transaction

LENGTHS = [0, 1, 2, 3, 4, 5, 31, 4095, 4096, 4097, 12289]


def _bufs(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]


@pytest.mark.parametrize("backend", ["device", "oracle"])
def test_golden_vectors(backend):
    """src/test/common/test_crc32c.cc vectors through every route, and
    the same table as the JAX package's."""
    assert GOLDEN_VECTORS == j_scrub.GOLDEN_VECTORS
    for init, payload, want in GOLDEN_VECTORS:
        assert ceph_crc32c(init, payload) == want
        assert batch_crc32c([payload], init, backend=backend, device="cpu")[0] == want


@pytest.mark.parametrize("init", [0, 0xFFFFFFFF, 0xDEADBEEF])
def test_device_matches_jax_device_and_oracle(init):
    """Ragged lengths across the shapes scrub produces: empty, sub-word,
    word-aligned, chunk-aligned, chunk-straddling."""
    bufs = _bufs(LENGTHS, 1234)
    got = batch_crc32c(bufs, init, device="cpu")
    assert got.dtype == np.uint32
    jax_dev = j_scrub.batch_crc32c(bufs, init, backend="device")
    oracle = batch_crc32c(bufs, init, backend="oracle")
    np.testing.assert_array_equal(got, jax_dev)
    np.testing.assert_array_equal(got, oracle)
    assert [int(c) for c in oracle] == [j_crc32c(init, b) for b in bufs]


def test_per_buffer_inits_and_running_composition():
    bufs = _bufs((8, 100, 5000), 7)
    inits = [0, 0xFFFFFFFF, 42]
    got = batch_crc32c(bufs, inits, device="cpu")
    np.testing.assert_array_equal(got, j_scrub.batch_crc32c(bufs, inits, backend="device"))
    for buf, init, c in zip(bufs, inits, got):
        assert ceph_crc32c(init, buf) == int(c)
    # crc(crc(seed, a), b) == batch crc of a+b with the same seed
    a, b = b"foo bar ", b"baz and more bytes" * 97
    want = ceph_crc32c(ceph_crc32c(0xFFFFFFFF, a), b)
    assert int(batch_crc32c([a + b], 0xFFFFFFFF, device="cpu")[0]) == want
    assert int(batch_crc32c([b], ceph_crc32c(0xFFFFFFFF, a), device="cpu")[0]) == want


def test_crc_over_several_blocks(monkeypatch):
    """The first-level product runs in blocks of chunk rows; a block
    edge inside a row changes nothing."""
    monkeypatch.setattr(sk, "_BLOCK_CHUNKS", 3)
    bufs = _bufs((4096 * 5 + 7, 0, 4096 * 2, 9000), 5)
    np.testing.assert_array_equal(
        batch_crc32c(bufs, 0xFFFFFFFF, device="cpu"),
        batch_crc32c(bufs, 0xFFFFFFFF, backend="oracle"),
    )


@pytest.mark.parametrize("backend", ["device", "oracle"])
def test_batch_compare_verdicts(backend):
    stored = [b"same", b"different-a", b"short", b"", b"x" * 9000]
    expect = [b"same", b"different-b", b"shorter", b"", b"x" * 9000]
    got = list(batch_compare(stored, expect, backend=backend, device="cpu"))
    assert got == [False, True, True, False, False]
    assert got == list(j_scrub.batch_compare(stored, expect, backend="device"))
    long_bad = bytearray(b"x" * 9000)
    long_bad[8191] ^= 1
    assert list(batch_compare([bytes(long_bad)], [b"x" * 9000], backend=backend,
                              device="cpu")) == [True]
    assert list(batch_compare([], [], device="cpu")) == []
    with pytest.raises(ValueError):
        batch_compare([b"a"], [], device="cpu")


def test_ecstore_scrub_batch_matches_per_object():
    """Clean, shard-corrupt, shard-missing and hinfo-invalidated
    (partial overwrite) objects: the batched audit equals scrub()."""
    ecs = ECStore(profile={"k": "2", "m": "1", "device": "cpu"}, stripe_width=2 * 1024)
    rng = random.Random(5)
    names = []
    for i, size in enumerate((0, 100, 5000, 8192)):
        name = f"obj{i}"
        ecs.put(name, bytes(rng.randrange(256) for _ in range(size)))
        names.append(name)
    ecs.corrupt_shard("obj2", 1)
    ecs.lose_shard("obj3", 2)
    ecs.write("obj1", 10, b"partial overwrite payload")
    ecs.corrupt_shard("obj1", 0, offset=4)
    batched = ecs.scrub_batch(names)
    for name in names:
        single = ecs.scrub(name)
        got = batched[name]
        assert (got.missing, got.corrupt, got.inconsistent) == (
            single.missing, single.corrupt, single.inconsistent), name
    assert batched["obj2"].corrupt == [1]
    assert batched["obj3"].missing == [2]
    assert batched["obj1"].inconsistent


def test_replicated_scrub_batch_matches_per_object():
    rs = ReplicatedStore(size=3, device="cpu")
    rs.put("a", b"hello world" * 100)
    rs.put("b", b"payload two" * 50)
    rs.put("c", b"")
    raw = bytearray(rs.stores[1].read(rs.cid, "a"))
    raw[3] ^= 0xFF
    rs.stores[1].queue_transaction(Transaction().write(rs.cid, "a", 0, bytes(raw)))
    rs.stores[2].queue_transaction(Transaction().remove(rs.cid, "b"))
    rs.write("c", 0, b"partial")  # digest invalidated
    batched = rs.scrub_batch(["a", "b", "c"])
    for name in ("a", "b", "c"):
        single = rs.scrub(name)
        got = batched[name]
        assert got.missing == single.missing, name
        assert sorted(got.corrupt) == sorted(single.corrupt), name
        assert got.inconsistent == single.inconsistent, name
    assert batched["a"].corrupt == [1]
    assert batched["b"].missing == [2]


def test_device_failure_raises_instead_of_falling_back(monkeypatch):
    """The JAX package answers a failed device call from the host oracle;
    the port raises, for ``backend=None`` as for ``"device"``, and for
    the stores' batched scrub."""
    bufs = _bufs((100, 5000), 3)

    def broken(*_a, **_kw):
        raise RuntimeError("device product failed: simulated")

    monkeypatch.setattr(sk, "crc_bits", broken)
    monkeypatch.setattr(sk, "mismatch", broken)
    for backend in (None, "device"):
        with pytest.raises(RuntimeError, match="simulated"):
            batch_crc32c(bufs, 0, backend=backend, device="cpu")
        with pytest.raises(RuntimeError, match="simulated"):
            batch_compare(bufs, bufs, backend=backend, device="cpu")
    # the oracle is asked for by name only
    assert [int(c) for c in batch_crc32c(bufs, 0, backend="oracle")] == [
        ceph_crc32c(0, b) for b in bufs
    ]
    rs = ReplicatedStore(size=2, device="cpu")
    rs.put("a", bufs[1])
    with pytest.raises(RuntimeError, match="simulated"):
        rs.scrub_batch(["a"])
    with pytest.raises(ValueError):
        batch_crc32c(bufs, backend="numpy")


def test_cuda_without_a_card_raises():
    """The default device is the card; a host without one raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        batch_crc32c([b"abc"], 0)
