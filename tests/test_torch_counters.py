"""The port's kernel counters (``ops/kernel_stats.py``) and dispatch
flight recorder (``ops/profiler.py``) on the CPU, mirroring the
non-cluster cases of the JAX package's ``tests/test_dispatch_profiler.py``:
the ring bound, stage attribution, the summary rollup, breakdown keys at
zero activity, byte attribution, the pad and host entries; and the
``kernel_stats().dump()`` keys of one encode, decode and scrub equal to
the JAX package's for the same calls."""

from __future__ import annotations

import time

import numpy as np
import pytest

import ceph_tpu.ops.kernel_stats as j_ks_mod
import ceph_tpu.ops.profiler as j_prof_mod
import ceph_tpu.ops.residency as j_res_mod
from ceph_tpu.ec import ErasureCodeProfile as JProfile
from ceph_tpu.ec import registry_instance as j_registry
from ceph_tpu.ec import stripe as j_stripe
from ceph_tpu.ops.kernel_stats import KernelStats as JKernelStats
from ceph_tpu.ops.scrub_kernels import batch_crc32c as j_batch_crc32c
from ceph_tpu_torch import gf
from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance, stripe
from ceph_tpu_torch.ec.backend import get_backend
from ceph_tpu_torch.ops import kernel_stats as ks_mod
from ceph_tpu_torch.ops import profiler as prof_mod
from ceph_tpu_torch.ops import residency as res_mod
from ceph_tpu_torch.ops.kernel_stats import KernelStats, kernel_stats
from ceph_tpu_torch.ops.profiler import DispatchProfiler, breakdown, dispatch_profiler
from ceph_tpu_torch.ops.residency import DeviceBuf
from ceph_tpu_torch.ops.scrub_kernels import batch_compare, batch_crc32c

rng = np.random.default_rng(0xF11)


def _pad_wasted() -> int:
    return kernel_stats().perf.dump()["l_tpu_pad_bytes_wasted"]


def _last_seq() -> int:
    ents = dispatch_profiler().history()["entries"]
    return ents[-1]["seq"] if ents else 0


def _entries_after(seq: int, kind: str | None = None) -> list[dict]:
    return [e for e in dispatch_profiler().history(kind=kind)["entries"] if e["seq"] > seq]


def test_ring_bounded_under_dispatch_storm():
    ks = KernelStats()
    prof = DispatchProfiler(capacity=8, ks=ks)
    for i in range(50):
        with prof.dispatch("ec_encode", backend="cpu") as dp:
            dp.set_ops(i)
    h = prof.history()
    assert (h["capacity"], h["num_entries"], h["dropped"]) == (8, 8, 42)
    assert [e["ops"] for e in h["entries"]] == list(range(42, 50))
    assert ks.perf.dump()["l_tpu_dispatch_ring_dropped"] == 42
    assert prof.totals()["ec_encode"]["dispatches"] == 50
    prof.clear()
    assert prof.history()["num_entries"] == 0 and prof.totals() == {}


def test_stage_attribution_and_commit_semantics():
    prof = DispatchProfiler(capacity=16, ks=KernelStats())
    with prof.dispatch("crc32c") as dp:
        dp.set_ops(3)
        dp.add_bytes_in(300)
        with dp.stage("upload"):
            time.sleep(0.002)
        with dp.stage("compute"):
            time.sleep(0.002)
        with dp.stage("upload"):  # stages reopen and accumulate
            time.sleep(0.002)
        with dp.stage("sync"):
            pass
    (e,) = prof.history()["entries"]
    assert e["backend"] == "torch"
    assert e["transfer_s"] > 0 and e["compute_s"] > 0
    assert e["transfer_s"] + e["compute_s"] + e["sync_s"] <= e["wall_s"] + 1e-6
    with prof.dispatch("compare", backend="cpu"):
        time.sleep(0.001)
    host = prof.history(kind="compare")["entries"][-1]
    assert host["compute_s"] == host["wall_s"] > 0
    with pytest.raises(RuntimeError):
        with prof.dispatch("ec_decode"):
            raise RuntimeError("a failed launch")
    assert prof.history(kind="ec_decode")["num_entries"] == 0


def test_history_filters_and_summary_rollup():
    prof = DispatchProfiler(capacity=16, ks=KernelStats())
    for kind, ops in (("ec_encode", 4), ("ec_encode", 6), ("crc32c", 2)):
        with prof.dispatch(kind) as dp:
            dp.set_ops(ops)
            dp.set_stripes(ops * 3)
            dp.add_bytes_in(1000)
            dp.add_upload(750)
            dp.add_resident(250)
    h = prof.history(kind="ec_encode", limit=1)
    assert h["num_entries"] == 1 and h["entries"][0]["ops"] == 6
    s = prof.summary()
    assert s["ring"] == {"capacity": 16, "entries": 3, "dropped": 0}
    enc = s["kinds"]["ec_encode"]
    assert (enc["dispatches"], enc["occupancy"], enc["stripes_per_dispatch"]) == (2, 5.0, 15.0)
    assert enc["resident_byte_ratio"] == 0.25
    assert prof.summary(kind="crc32c")["kinds"].keys() == {"crc32c"}


def test_breakdown_carries_contract_keys_on_zero_activity():
    t = dispatch_profiler().totals()
    bd = breakdown(t, t)
    for k in ("transfer_ms", "compute_ms", "sync_ms", "occupancy",
              "pad_waste_ratio", "resident_byte_ratio"):
        assert k in bd, k
    assert bd["backend"] == "torch"
    assert bd["dispatches"] == 0 and bd["kinds"] == {}


def test_device_byte_attribution_and_pad():
    """uploaded + resident == input bytes on the torch entries, and the
    zeros that right-align the crc rows are the dispatch's pad."""
    lens = (4096, 5000, 300, 8192)
    bufs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in lens]
    mixed = [DeviceBuf(data=b, device="cpu") if i % 2 else b for i, b in enumerate(bufs)]
    for buf in mixed:
        if isinstance(buf, DeviceBuf):
            buf.device()  # registered-resident: served where it lives
    seq, pad0 = _last_seq(), _pad_wasted()
    batch_crc32c(mixed, 0xFFFFFFFF, device="cpu")
    (e,) = _entries_after(seq, kind="crc32c")
    assert e["backend"] == "torch" and e["ops"] == len(bufs)
    assert e["bytes_in"] == sum(lens)
    assert e["bytes_uploaded"] + e["bytes_resident"] == e["bytes_in"]
    assert e["bytes_resident"] == lens[1] + lens[3]
    padded = 2 * 4096 * len(lens) - sum(lens)  # widest row: 2 chunks
    assert e["bytes_padded"] == padded == _pad_wasted() - pad0
    assert e["transfer_s"] + e["compute_s"] + e["sync_s"] <= e["wall_s"] + 1e-6
    seq = _last_seq()
    batch_compare(bufs[:2], [bufs[0], bufs[1][:-1] + b"\0"], device="cpu")
    (c,) = _entries_after(seq, kind="compare")
    assert c["bytes_padded"] == 2 * 5000 * 2 - 2 * (4096 + 5000)


def test_backend_stripe_routes_record_stages_without_pad():
    """The torch backend's stripe routes record one entry each with
    every input byte uploaded and, unlike the JAX package's power-of-two
    batches, no pad."""
    k, m, w, chunk = 4, 2, 8, 128
    matrix = gf.reed_sol_vandermonde_coding_matrix(k, m, w)
    backend = get_backend("torch", "cpu")
    stripes = rng.integers(0, 256, size=(3, k, chunk), dtype=np.uint8)
    seq, pad0 = _last_seq(), _pad_wasted()
    backend.matrix_stripes(matrix, stripes, w)
    batches = [rng.integers(0, 256, size=(n, k, chunk), dtype=np.uint8) for n in (2, 3)]
    backend.matrix_stripes_batch(matrix, batches, w)
    one, batch = _entries_after(seq, kind="ec_encode")
    assert (one["ops"], one["stripes"], one["bytes_uploaded"]) == (1, 3, stripes.nbytes)
    assert (batch["ops"], batch["stripes"]) == (2, 5)
    assert batch["bytes_uploaded"] == batch["bytes_in"] == sum(b.nbytes for b in batches)
    assert one["backend"] == batch["backend"] == "torch"
    assert one["bytes_padded"] == batch["bytes_padded"] == 0 and _pad_wasted() == pad0


def test_host_loops_record_host_entries():
    """The per-stripe encode of a layered code, the per-object repair and
    the oracle routes record host entries (zero link bytes, the wall
    booked as compute)."""
    lrc = registry_instance().factory("lrc", ErasureCodeProfile(k="4", m="2", l="3", device="cpu"))
    sinfo = stripe.StripeInfo(4, 4 * 256)
    data = rng.integers(0, 256, 3 * sinfo.stripe_width, dtype=np.uint8)
    seq = _last_seq()
    shards = stripe.encode(sinfo, lrc, data)
    (e,) = _entries_after(seq, kind="ec_encode")
    assert e["backend"] == "cpu" and e["ops"] == 1 and e["stripes"] == 3
    assert e["bytes_in"] == data.nbytes and e["bytes_uploaded"] == 0
    assert e["compute_s"] == e["wall_s"]
    seq = _last_seq()
    survivors = [{p: s for p, s in shards.items() if p != 0}]
    stripe.decode_batch(sinfo, lrc, survivors, {0})  # one object: per-object path
    (d,) = _entries_after(seq, kind="ec_decode")
    assert d["backend"] == "cpu" and d["ops"] == 1
    assert d["bytes_in"] == sum(len(s) for s in survivors[0].values())
    seq = _last_seq()
    batch_crc32c([b"abc"], 0, backend="oracle")
    batch_compare([b"abc"], [b"abd"], backend="oracle")
    assert [(x["kind"], x["backend"]) for x in _entries_after(seq)] == [
        ("crc32c", "cpu"), ("compare", "cpu")]


def test_batch_counters_move_with_coalesced_passes():
    ks = kernel_stats()
    ec = registry_instance().factory(
        "jerasure", ErasureCodeProfile(technique="reed_sol_van", k="4", m="2", device="cpu"))
    sinfo = stripe.StripeInfo(4, 4 * 256)
    bufs = [rng.integers(0, 256, n * sinfo.stripe_width, dtype=np.uint8) for n in (1, 2, 3)]
    before = ks.dump()
    encoded = stripe.encode_batch(sinfo, ec, bufs)
    stripe.decode_batch(sinfo, ec, [{p: s for p, s in e.items() if p != 1}
                                          for e in encoded], {1})
    after = ks.dump()
    for name, delta in (("l_tpu_batch_encode_dispatches", 1),
                        ("l_tpu_batch_encode_ops_per_dispatch", 3),
                        ("l_tpu_batch_decode_dispatches", 1),
                        ("l_tpu_batch_decode_ops_per_dispatch", 3)):
        assert after[name] - before[name] == delta, name
    assert after["l_tpu_ec_encode_calls"] - before["l_tpu_ec_encode_calls"] == 1
    assert after["l_tpu_ec_decode_calls"] - before["l_tpu_ec_decode_calls"] == 1


def test_dump_keys_equal_jax_for_encode_decode_scrub(monkeypatch):
    """One encode, one batched decode and one scrub in each package, each
    on fresh process-global counter sets: the dumps carry the same
    counter names."""
    for mod in (j_ks_mod, ks_mod):
        monkeypatch.setattr(mod, "_instance", None)
    for mod in (j_prof_mod, prof_mod, j_res_mod, res_mod):
        monkeypatch.setattr(mod, "_instance", None)
    prof = {"technique": "reed_sol_van", "k": "4", "m": "2"}
    jec = j_registry().factory("jerasure", JProfile({**prof, "backend": "jax"}))
    tec = registry_instance().factory("jerasure", ErasureCodeProfile({**prof, "device": "cpu"}))
    bufs = [rng.integers(0, 256, n * 4 * 256, dtype=np.uint8) for n in (2, 3)]
    dumps = []
    for ec, mod, crc, j in ((jec, j_stripe, j_batch_crc32c, True),
                            (tec, stripe, batch_crc32c, False)):
        sinfo = mod.StripeInfo(4, 4 * 256)
        shards = [mod.encode(sinfo, ec, b) for b in bufs]
        mod.decode_batch(sinfo, ec, [{p: s for p, s in e.items() if p != 0} for e in shards],
                         {0})
        crc([bytes(s) for s in shards[0].values()], 0xFFFFFFFF,
            **({} if j else {"device": "cpu"}))
        dumps.append(set((j_ks_mod if j else ks_mod).kernel_stats().dump()))
    jax_keys, torch_keys = dumps
    assert torch_keys == jax_keys
    assert {"l_tpu_ec_encode_calls", "l_tpu_ec_decode_calls", "l_tpu_gf_matmul_calls",
            "l_tpu_scrub_crc32c_calls", "l_tpu_dispatch_count",
            "l_tpu_residency_hits"} <= torch_keys
    assert isinstance(ks_mod.kernel_stats(), KernelStats)
    assert not isinstance(ks_mod.kernel_stats(), JKernelStats)
