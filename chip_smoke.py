#!/usr/bin/env python3
"""Smoke run of ceph_tpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases, each reported on its own lines; any mismatch raises and the
script exits non-zero:

1. the card (nvidia-smi name and power limit), CUDA version, and the
   nvcc build of ``ceph_tpu_torch/csrc/gf8_kernels.cu`` with its time and
   the registers and spills of each kernel instance;
2. kernels K1 (packed) and K2 (bitplane) against their plain PyTorch
   versions on the card, exactly (``torch.equal``), for the coding and
   decoding matrices of the main path and m = 1, 9 and 32 at widths 4096,
   4100, 4097 (K2 alone: K1 takes whole words) and 1 GiB of data, and on
   views read in place (rows 4 bytes off a 16-byte boundary, rows 1 byte
   off a word boundary for K2, every other stripe), and against the numpy
   oracle; each with the words per thread the kernel took;
3. the main path through the registry on ``device="cuda"``: jerasure and
   isa encode and decode of seeded 1 MiB and 16 KiB objects with every
   decode's content verified, a bitmatrix technique, the batched encode
   and decode routes, and the ``ec_benchmark`` exhaustive decode; the
   kernels' launch counts are zeroed before and must be non-zero after;
3b. the layered plugins, the stripe seam and the OSD codec on
   ``device="cuda"``, with the launch counts zeroed before and both
   non-zero after: ``tools.ec_non_regression --check`` of all 11
   ``corpus/`` entries; lrc k=8 m=4 l=6, shec k=8 m=4 c=2 and clay k=8
   m=4 d=11 on a seeded 1 MiB object, each encode equal to the
   ``device="cpu"`` one, every single erasure and a seeded sample of
   double (and for shec and lrc triple) erasures decoded and verified or
   refused on both devices alike, clay's 12 minimum-bandwidth repairs
   from partial reads; ``ECCodec`` over 64 objects of 4 MiB (isa k=8
   m=3): the batch encode equal to the per-object one, HashInfo equal to
   the plain crc32c of every shard, the batched decode of {1, 9}, K2
   launched once per group of 256 stripes; an lrc codec's batched
   repair of one chunk through its local layer; clay through ``ECCodec``
   on a 4-stripe object; each timed, beside the card's name and limit;
4. resident throughput at full size: 1024 stripes of k=8 x 128 KiB
   (1 GiB of data) encoded through K1 and through K2, 1 GiB of survivors
   decoded through each, the 1 GiB encode through K2 on rows offset by
   1 byte (its general form), one group of K2's batched routes (256
   stripes of 4096 bytes), one 1 MiB object (the main path's shape) and
   1024 isa cauchy k=10 m=4 objects of 1 MiB, timed with CUDA events
   beside the bound and the plain versions, and the two small batches
   also from a CUDA graph for the device time alone; then the
   numpy-in/numpy-out ``ec_benchmark --batch 1024`` rate, host transfers
   included;
5. CRUSH placement on the card (BASELINE config 5): the 10 000-OSD
   straw2 hierarchy (40 OSDs a host, 25 hosts a rack) compiled to device
   tables; rule 0 (replicated, chooseleaf firstn, 3 replicas) and rule 1
   (EC, chooseleaf indep, 11 positions) over 2^20 PGs in 2^19-lane
   chunks through ``batch_do_rule_range`` and the oracle fallback, held
   against the oracle on 2048 spread PGs and every fallback lane (in a
   pool of worker processes), the raw output of the first 2^16 lanes
   against ``device="cpu"``; end-to-end and device-resident mappings/s,
   a ``torch.profiler`` split of one chunk, crushtool's statistics; the
   straw2 golden vectors of the reference C; one ``{"crush": ...}`` line;
6. the store data plane on ``device="cuda"`` at one PG's size, with the
   launch counts zeroed before and both non-zero after: an ``ECStore``
   (isa k=8 m=3, stripe unit 4096) over 11 ``MemStore``s with 256
   seeded objects of 4 MiB, the residency cache sized to hold the PG;
   ``put`` of every object, two ``scrub_batch`` passes (clean, residency
   hits growing), three seeded corrupt shards flagged exactly and
   repaired, position 1 lost on every object and rebuilt by one
   ``recover_objects_batch`` equal to the original bytes, a clean scrub,
   then degraded ``get`` with shards {1, 9} lost; ``batch_crc32c`` over
   every shard of the PG equal to the host C crc32c and the HashInfo
   hashes, again on resident ``DeviceBuf``s with zero upload bytes, and
   the golden vectors; ``batch_compare`` against copies with seeded
   one-byte flips equal to the host's verdicts; a ``ReplicatedStore``
   (3 replicas) over the same objects scrubbed clean, one corrupt
   replica flagged and recovered; put, scrub, recovery and degraded-read
   GB/s, the crc and compare times on the card beside their bounds, the
   host C crc's time and the dispatch profiler's breakdown, beside the
   card's name and power limit; one ``{"store": ...}`` line;
7. one JSON line describing each kernel;
8. the last line, ``{"ok": true, "device": {...}}``.

It needs one CUDA device and exits non-zero without one.  It imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
GIB = 1 << 30
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor rate, published


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max().item())


def bound_ms(k: int, m: int, nbytes: int) -> tuple[float, str]:
    """Least time for (k, N) → (m, N): bytes moved (k+m)·N at the HBM
    rate, or the mod-2 product's 2·(8m)·(8k)·N operations at the int8
    tensor rate, whichever is larger."""
    by = (k + m) * nbytes / HBM_BYTES_PER_S * 1e3
    ops = 2 * (8 * m) * (8 * k) * nbytes / INT8_OPS_PER_S * 1e3
    return (by, "bytes") if by >= ops else (ops, "operations")


def random_u8(shape, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)


def phase_build():
    from ceph_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[1] nvcc build of {_build.SOURCE}: "
          f"{_build.build_seconds.get(_build.SOURCE, 0.0):.2f} s compile, "
          f"{time.perf_counter() - t0:.2f} s to load")
    for name, res in _build.kernel_resources(_build.build_log.get(_build.SOURCE, "")).items():
        print(f"    ptxas {name}: {res}")
    return smi


def _k1_takes(bm, x) -> bool:
    from ceph_tpu_torch.ops import packed_gf

    return (packed_gf.supports(bm.cpu().numpy(), 8) and x.shape[2] % 4 == 0
            and x.data_ptr() % 4 == 0 and x.stride(0) % 4 == 0 and x.stride(1) % 4 == 0)


def _check_kernels(errs: dict, label: str, mat, bm, x, oracle: bool) -> str:
    """K1 (where it takes the matrix and the rows) and K2 against their
    plain versions on stripes ``x``, exactly; against the numpy oracle on
    stripe 0 when ``oracle``.  Returns what was checked, each kernel with
    its words per thread."""
    from ceph_tpu_torch import gf
    from ceph_tpu_torch.ops import _build, bitplane_gf, packed_gf

    checked = []
    for kname, kernel, plain in (
        ("K1", packed_gf.packed_matrix_stripes, packed_gf.packed_stripes_plain),
        ("K2", bitplane_gf.gf8_bitplane_stripes, bitplane_gf.gf8_bitplane_plain),
    ):
        if kname == "K1" and not _k1_takes(bm, x):
            continue
        got = kernel(bm, x)
        torch.cuda.synchronize()
        want = plain(bm, x)
        err = max_abs_err(got, want)
        errs[kname] = max(errs[kname], err)
        check(torch.equal(got, want), f"{kname} != plain on {label}")
        if oracle:
            ref = gf.matrix_vector_mul_region(mat, x[0].cpu().numpy(), 8)
            check(np.array_equal(got[0].cpu().numpy(), ref), f"{kname} != numpy oracle on {label}")
        checked.append(f"{kname}(W={_build.words_per_thread(x, got)})")
        del got, want
    return " ".join(checked)


def phase_kernels(errs: dict):
    from ceph_tpu_torch import gf
    from ceph_tpu_torch.ops.gf_matmul import matrix_to_device_bitmatrix

    rs83 = gf.reed_sol_vandermonde_coding_matrix(8, 3, 8)
    matrices = {
        "rs_k8_m3": rs83,
        "decode_k8_m3_e1_6": gf.make_decoding_matrix(rs83, [1, 6], 8, 8)[0],
        "isa_cauchy_k10_m4": gf.isa_cauchy_matrix(10, 4),
        "rs_k4_m2": gf.reed_sol_vandermonde_coding_matrix(4, 2, 8),
        "rs_k8_m1": gf.reed_sol_vandermonde_coding_matrix(8, 1, 8),
        "rs_k8_m9": gf.reed_sol_vandermonde_coding_matrix(8, 9, 8),
        "rs_k32_m32": gf.reed_sol_vandermonde_coding_matrix(32, 32, 8),
        "rs_k40_m4": gf.reed_sol_vandermonde_coding_matrix(40, 4, 8),
    }
    t0 = time.perf_counter()
    for mi, (name, mat) in enumerate(matrices.items()):
        m, k = mat.shape
        bm = matrix_to_device_bitmatrix(mat, 8, "cuda")
        for width in (4096, 4100, 4097, (GIB // k) // 4 * 4):
            x = random_u8((1, k, width), SEED + mi * 7 + width % 97)
            what = _check_kernels(errs, f"{name} width {width}", mat, bm, x, width == 4096)
            print(f"[2] {name} k={k} m={m} width {width}: {what} equal to plain (max_abs_err 0)")
            del x
    # views read in place: rows 4 bytes past a 16-byte boundary, 1 byte
    # past a word boundary (K2 alone), and every other stripe of a batch
    bm = matrix_to_device_bitmatrix(rs83, 8, "cuda")
    for label, x in (
        ("rows offset by 4 bytes", random_u8((64, 8, 65536 + 4), SEED + 3)[:, :, 4:]),
        ("rows offset by 1 byte", random_u8((64, 8, 65536 + 1), SEED + 4)[:, :, 1:]),
        ("rows offset by 1 byte, chunk 4097", random_u8((64, 8, 4097 + 1), SEED + 6)[:, :, 1:]),
        ("stripes [::2]", random_u8((128, 8, 65536), SEED + 5)[::2]),
    ):
        what = _check_kernels(errs, f"rs_k8_m3 {label}", rs83, bm, x, True)
        print(f"[2] rs_k8_m3 {tuple(x.shape)} {label} (strides {x.stride()}): "
              f"{what} equal to plain (max_abs_err 0)")
        del x
    torch.cuda.empty_cache()
    print(f"[2] kernel checks took {time.perf_counter() - t0:.1f} s")


def _verify_decode(ec, encoded, erased):
    avail = {i: c for i, c in encoded.items() if i not in erased}
    decoded = ec.decode(set(erased), avail)
    for c in erased:
        check(np.array_equal(decoded[c], encoded[c]), f"chunk {c} differs after decode")


def phase_main_path():
    from ceph_tpu_torch import gf
    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
    from ceph_tpu_torch.ops import bitplane_gf, packed_gf
    from ceph_tpu_torch.tools import ec_benchmark

    rng = np.random.default_rng(SEED)
    reg = registry_instance()
    packed_gf.launches = 0
    bitplane_gf.launches = 0
    t0 = time.perf_counter()
    runs = [
        ("jerasure", {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"}, 1 << 20, "exhaustive"),
        ("isa", {"technique": "reed_sol_van", "k": "8", "m": "3"}, 1 << 20, "sampled"),
        ("isa", {"technique": "cauchy", "k": "10", "m": "4"}, 1 << 20, "sampled"),
        ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "8"}, 16 << 10, "exhaustive"),
        ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2"}, 1 << 20, "sampled"),
    ]
    for plugin, prof, size, mode in runs:
        ec = reg.factory(plugin, ErasureCodeProfile(prof, device="cuda"))
        n, k, m = ec.get_chunk_count(), ec.k, ec.m
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        encoded = ec.encode(set(range(n)), payload)
        data = np.stack([encoded[i] for i in range(k)])
        if getattr(ec, "matrix", None) is not None and not hasattr(ec, "bitmatrix"):
            oracle = gf.matrix_vector_mul_region(ec.matrix, data, 8)
            for i in range(m):
                check(np.array_equal(encoded[k + i], oracle[i]),
                      f"{plugin} parity {i} != numpy oracle")
        check(ec.decode_concat(encoded)[:size].tobytes() == payload, "concat")
        patterns = 0
        for e in range(1, m + 1):
            combos = list(itertools.combinations(range(n), e))
            if mode == "sampled":
                combos = [combos[j] for j in rng.choice(len(combos), min(12, len(combos)), replace=False)]
            for erased in combos:
                _verify_decode(ec, encoded, erased)
                patterns += 1
        print(f"[3] {plugin} {prof['technique']} k={k} m={m} {size} B object: "
              f"encoded, {patterns} {mode} erasure patterns decoded and verified")
    # the batched encode and decode routes (coalesced objects)
    ec = reg.factory("isa", ErasureCodeProfile(k="8", m="3", device="cuda"))
    backend, mat = ec.backend, ec.matrix
    batches = [rng.integers(0, 256, (b, 8, 4096), dtype=np.uint8) for b in (3, 5, 8, 1, 300)]
    outs = backend.matrix_stripes_batch(mat, batches, 8)
    for s, o in zip(batches, outs):
        check(np.array_equal(o, backend.matrix_stripes(mat, s, 8)), "batched encode")
    dec, survivors = gf.make_decoding_matrix(mat, [1, 6], 8, 8)
    row_sets = [
        [np.concatenate([s, o], axis=1)[:, i].reshape(-1) for i in survivors]
        for s, o in zip(batches, outs)
    ]
    rec = backend.decode_stripes_batch(dec, row_sets, 8, 4096)  # stays on the card
    for s, r in zip(batches, rec):
        check(r.is_cuda and np.array_equal(r.cpu().numpy(), s[:, [1, 6]]), "batched decode")
    print(f"[3] batched encode of {len(batches)} objects and decode of their "
          "erased chunks {1,6} equal the per-object results")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ec_benchmark.main([
            "-p", "jerasure", "-P", "technique=reed_sol_van", "-P", "k=8",
            "-P", "m=3", "-s", str(1 << 20), "-w", "decode", "-E", "exhaustive",
            "-e", "3", "--device", "cuda",
        ])
    print(f"[3] ec_benchmark -w decode -E exhaustive -e 3: {out.getvalue().strip()!r}")
    counts = {"K1": packed_gf.launches, "K2": bitplane_gf.launches}
    print(f"[3] main path took {time.perf_counter() - t0:.1f} s; launches {counts}")
    check(counts["K1"] > 0 and counts["K2"] > 0, f"a kernel was not launched: {counts}")
    return counts


def _decoded_or_refused(ec, erased, avail):
    from ceph_tpu_torch.ec import ErasureCodeError

    try:
        return ec._decode(set(erased), dict(avail))
    except ErasureCodeError:
        return None


def _layered_family(rng, plugin, prof, extra: int) -> dict:
    """One BASELINE family at 1 MiB on the card, held against the CPU:
    returns its timings."""
    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance

    reg = registry_instance()
    card = reg.factory(plugin, ErasureCodeProfile(prof, device="cuda"))
    cpu = reg.factory(plugin, ErasureCodeProfile(prof, device="cpu"))
    n = card.get_chunk_count()
    payload = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    enc = card.encode(set(range(n)), payload)
    first_ms = (time.perf_counter() - t0) * 1e3
    ref = cpu.encode(set(range(n)), payload)
    for i in range(n):
        check(np.array_equal(enc[i], ref[i]), f"{plugin}: chunk {i} on the card != cpu")
    t0 = time.perf_counter()
    for _ in range(3):
        card.encode(set(range(n)), payload)
    enc_ms = (time.perf_counter() - t0) * 1e3 / 3
    dec_ms = []
    for lost in range(n):
        avail = {i: c for i, c in enc.items() if i != lost}
        t0 = time.perf_counter()
        dec = card._decode({lost}, avail)
        dec_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(dec[lost], enc[lost]), f"{plugin}: single decode of {lost}")
    check(card.decode_concat(enc)[: len(payload)].tobytes() == payload, f"{plugin}: concat")
    pairs = list(itertools.combinations(range(n), 2))
    if plugin == "clay":
        patterns = [pairs[j] for j in rng.choice(len(pairs), extra, replace=False)]
    else:
        triples = list(itertools.combinations(range(n), 3))
        patterns = pairs + [triples[j] for j in rng.choice(len(triples), extra, replace=False)]
    refused = 0
    for erased in patterns:
        avail = {i: c for i, c in enc.items() if i not in erased}
        got = _decoded_or_refused(card, erased, avail)
        want = _decoded_or_refused(cpu, erased, avail)
        check((got is None) == (want is None), f"{plugin} {erased}: cuda and cpu disagree on refusal")
        if got is None:
            refused += 1
            continue
        for i in erased:
            check(np.array_equal(got[i], enc[i]), f"{plugin} {erased}: chunk {i} differs")
    print(f"[3b] {plugin} {prof}: 1 MiB encode equal to device=cpu; {n} single and "
          f"{len(patterns)} multiple erasure patterns decoded and verified or refused on both "
          f"devices alike ({refused} refused)")
    return {"first_encode_ms": first_ms, "encode_ms": enc_ms,
            "decode_ms": sum(dec_ms) / len(dec_ms), "enc": enc, "ec": card, "payload": payload}


def _device_busy(fam: dict) -> str:
    """The card's busy time (kernels and copies, from torch.profiler's
    device events) during one encode, against the host clock's time for
    it under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ec, payload = fam["ec"], fam["payload"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ec.encode(set(range(ec.get_chunk_count())), payload)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = copies = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        if "memcpy" in ev.key.lower():
            copies += ev.self_device_time_total / 1e3
        else:
            kernels += ev.self_device_time_total / 1e3
    if kernels == 0.0:
        return f"device time not measured (the profiler saw no kernel), wall {wall_ms:.3f} ms"
    busy = kernels + copies
    return (f"device busy {busy:.3f} ms (kernels {kernels:.3f} ms, copies {copies:.3f} ms) "
            f"of {wall_ms:.3f} ms on the host clock: idle {100 * (1 - busy / wall_ms):.1f} %")


def _clay_repairs(fam: dict) -> tuple[float, int, int]:
    """All single-chunk minimum-bandwidth repairs from the partial reads
    ``minimum_to_decode`` names; returns (ms per repair, bytes read by
    one repair, bytes a full decode reads)."""
    ec, enc = fam["ec"], fam["enc"]
    n = ec.get_chunk_count()
    chunk = len(enc[0])
    sc = chunk // ec.get_sub_chunk_count()
    total = 0.0
    for lost in range(n):
        minimum = ec.minimum_to_decode({lost}, set(range(n)) - {lost})
        check(len(minimum) == ec.d, f"clay repair of {lost} reads {len(minimum)} helpers")
        partial = {
            h: np.concatenate([enc[h][o * sc : (o + c) * sc] for o, c in runs])
            for h, runs in minimum.items()
        }
        t0 = time.perf_counter()
        got = ec.decode({lost}, partial, chunk)
        total += time.perf_counter() - t0
        check(np.array_equal(got[lost], enc[lost]), f"clay repair of chunk {lost}")
        read = sum(len(p) for p in partial.values())
    return total * 1e3 / n, read, ec.k * chunk


def _eccodec_isa(rng) -> dict:
    """64 objects of 4 MiB through ECCodec's batch routes (K2)."""
    from ceph_tpu_torch.ec.stripe import HashInfo, encode_batch
    from ceph_tpu_torch.native import crc32c_plain_rows
    from ceph_tpu_torch.ops import bitplane_gf
    from ceph_tpu_torch.osd.ec_pg import ECCodec

    codec = ECCodec({"plugin": "isa", "k": "8", "m": "3", "device": "cuda"})
    sw, k, m = codec.sinfo.stripe_width, codec.k, codec.n - codec.k
    objects, size, group = 64, 4 << 20, 256
    stripes = size // sw
    groups = -(-objects // (group // stripes))  # whole objects, up to 256 stripes a group
    expect = groups * -(-m // bitplane_gf.rows_per_launch(k, m))
    block = rng.integers(0, 256, (objects, size), dtype=np.uint8)
    datas = [row.tobytes() for row in block]
    del block
    before = bitplane_gf.launches
    t0 = time.perf_counter()
    got = codec.encode_object_batch(datas)
    enc_s = time.perf_counter() - t0
    launched = bitplane_gf.launches - before
    check(launched == expect, f"ECCodec encode: K2 launched {launched} times, expected {expect}")
    for data, g in zip(datas, got):
        check(g == codec.encode_object(data), "ECCodec batch encode != per-object encode")
    rows = np.stack([np.frombuffer(shards[i], dtype=np.uint8)
                     for shards, _ in got for i in range(codec.n)])
    plain = crc32c_plain_rows(0xFFFFFFFF, rows)
    del rows
    check([int(h) for h in plain] == [h for _, meta in got for h in meta["hashes"]],
          "HashInfo != plain crc32c of the shards")
    # where the encode's time goes: a second (warm) batch, and its parts
    t0 = time.perf_counter()
    codec.encode_object_batch(datas)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard_sets = encode_batch(codec.sinfo, codec.ec, datas)
    seam_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for shards in shard_sets:
        HashInfo(codec.n).append(0, shards)
    hash_s = time.perf_counter() - t0
    del shard_sets
    want = {1, 9}
    survivors = [{p: s for p, s in shards.items() if p not in want} for shards, _ in got]
    before = bitplane_gf.launches
    t0 = time.perf_counter()
    rec = codec.decode_object_batch(survivors, want)
    for r in rec:  # numpy out: the device-born DeviceBufs fetched to the host
        for p in want:
            r[p].host()
    dec_s = time.perf_counter() - t0
    launched = bitplane_gf.launches - before
    check(launched == expect, f"ECCodec decode: K2 launched {launched} times, expected {expect}")
    for r, (shards, _) in zip(rec, got):
        check(all(r[p].tobytes() == shards[p] for p in want), "ECCodec batched decode of {1, 9}")
    print(f"[3b] ECCodec isa k=8 m=3: {objects} objects of {size} B ({stripes} stripes of "
          f"{sw} B each), batch encode equal to per-object encode, HashInfo equal to the plain "
          f"crc32c of all {objects * codec.n} shards, batched decode of {{1, 9}} verified; "
          f"K2 launched {expect} times for each ({groups} groups of <= {group} stripes)")
    nbytes = objects * size
    return {"encode_GBps": nbytes / enc_s / 1e9, "decode_GBps": nbytes / dec_s / 1e9,
            "encode_s": enc_s, "decode_s": dec_s, "shape": f"{objects} x {size} B",
            "warm_GBps": nbytes / warm_s / 1e9, "warm_s": warm_s, "seam_s": seam_s,
            "hash_s": hash_s}


def _eccodec_lrc(rng) -> None:
    """lrc's batched repair of one chunk through its local layer."""
    from ceph_tpu_torch.ops import bitplane_gf
    from ceph_tpu_torch.osd.ec_pg import ECCodec

    codec = ECCodec({"plugin": "lrc", "k": "8", "m": "4", "l": "6", "device": "cuda"})
    ec = codec.ec
    datas = [rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes() for _ in range(4)]
    got = codec.encode_object_batch(datas)
    lost = 1
    layer = next(lay for lay in reversed(ec.layers) if lost in lay.chunks_as_set)
    k_local = layer.erasure_code.get_data_chunk_count()
    survivors = [{p: s for p, s in shards.items() if p != lost} for shards, _ in got]
    backend = layer.erasure_code.backend
    seen = []
    real = backend.decode_stripes_batch

    def recording(rows, row_sets, w, cs):
        seen.append((tuple(rows.shape), [sum(len(r) for r in rs) for rs in row_sets]))
        return real(rows, row_sets, w, cs)

    backend.decode_stripes_batch = recording
    try:
        before = bitplane_gf.launches
        rec = codec.decode_object_batch(survivors, {lost})
        launched = bitplane_gf.launches - before
    finally:
        del backend.decode_stripes_batch
    for r, (shards, _) in zip(rec, got):
        check(r[lost].tobytes() == shards[lost], "lrc batched repair differs")
    shard = len(got[0][0][0])
    check(seen == [((1, k_local), [k_local * shard] * len(datas))],
          f"lrc repair did not take the local plan over {k_local} survivors: {seen}")
    check(launched == 1, f"lrc batched repair launched K2 {launched} times, expected 1")
    print(f"[3b] ECCodec lrc k=8 m=4 l=6: chunk {lost} of {len(datas)} objects of 1 MiB rebuilt "
          f"in one K2 launch from its local layer's {k_local} survivors "
          f"({k_local * shard} B an object read, {ec.get_data_chunk_count() * shard} B "
          f"for k={ec.get_data_chunk_count()})")


def _eccodec_clay(rng) -> float:
    """Clay through ECCodec on one 4-stripe object: the per-stripe loop."""
    from ceph_tpu_torch.osd.ec_pg import ECCodec

    profile = {"plugin": "clay", "k": "8", "m": "4", "d": "11"}
    codec = ECCodec({**profile, "device": "cuda"})
    data = rng.integers(0, 256, 4 * codec.sinfo.stripe_width, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    (shards, _meta), = codec.encode_object_batch([data])
    ms = (time.perf_counter() - t0) * 1e3 / 4
    (want, _), = ECCodec({**profile, "device": "cpu"}).encode_object_batch([data])
    check(shards == want, "clay ECCodec encode on the card != cpu")
    (rec,) = codec.decode_object_batch([{p: s for p, s in shards.items() if p != 3}], {3})
    check(rec[3].tobytes() == shards[3], "clay ECCodec decode of chunk 3")
    print(f"[3b] ECCodec clay k=8 m=4 d=11: a 4-stripe object ({codec.sinfo.chunk_size} B "
          "chunks) encoded equal to device=cpu and chunk 3 decoded, stripe by stripe")
    return ms


def phase_layered(smi: str):
    import pathlib

    from ceph_tpu_torch.ops import bitplane_gf, packed_gf
    from ceph_tpu_torch.tools import ec_non_regression

    rng = np.random.default_rng(SEED + 7)
    packed_gf.launches = 0
    bitplane_gf.launches = 0
    t0 = time.perf_counter()
    corpus = pathlib.Path(__file__).resolve().parent / "corpus"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ec_non_regression.main(["--check", "--directory", str(corpus), "--device", "cuda"])
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 11 and all(line.endswith(": ok") for line in lines),
          f"corpus check: rc {rc}, {lines}")
    print(f"[3b] ec_non_regression --check --device cuda: {len(lines)} corpus entries ok "
          f"({time.perf_counter() - t0:.1f} s)")
    fams = {}
    for plugin, prof, extra in (
        ("lrc", {"k": "8", "m": "4", "l": "6"}, 8),
        ("shec", {"k": "8", "m": "4", "c": "2"}, 8),
        ("clay", {"k": "8", "m": "4", "d": "11", "scalar_mds": "jerasure"}, 6),
    ):
        fams[plugin] = _layered_family(rng, plugin, prof, extra)
    repair_ms, read, full = _clay_repairs(fams["clay"])
    print(f"[3b] clay: 12 minimum-bandwidth repairs equal the lost chunks; one reads {read} B "
          f"from {fams['clay']['ec'].d} helpers against {full} B for a full decode")
    isa = _eccodec_isa(rng)
    _eccodec_lrc(rng)
    clay_stripe_ms = _eccodec_clay(rng)
    counts = {"K1": packed_gf.launches, "K2": bitplane_gf.launches}
    print(f"[3b] layered phase took {time.perf_counter() - t0:.1f} s; launches {counts}")
    check(counts["K1"] > 0 and counts["K2"] > 0, f"a kernel was not launched: {counts}")
    print(f"[3b] times on {smi.splitlines()[0]} (host clock, numpy in and out):")
    for plugin, fam in fams.items():
        print(f"[3b]   {plugin}: 1 MiB encode {fam['encode_ms']:.3f} ms (first "
              f"{fam['first_encode_ms']:.3f} ms), single-chunk decode {fam['decode_ms']:.3f} ms")
    print(f"[3b]   clay: minimum-bandwidth repair {repair_ms:.3f} ms; through ECCodec "
          f"{clay_stripe_ms:.3f} ms a stripe")
    print(f"[3b]   ECCodec isa k=8 m=3, {isa['shape']}: batch encode {isa['encode_GBps']:.3f} GB/s "
          f"({isa['encode_s']:.3f} s, HashInfo included), batched decode of {{1, 9}} "
          f"{isa['decode_GBps']:.3f} GB/s ({isa['decode_s']:.3f} s)")
    print(f"[3b]   ECCodec encode again: {isa['warm_GBps']:.3f} GB/s ({isa['warm_s']:.3f} s); "
          f"of such a batch, stripe.encode_batch alone takes {isa['seam_s']:.3f} s and "
          f"HashInfo (crc32c of every shard) {isa['hash_s']:.3f} s")
    print(f"[3b]   clay 1 MiB encode under torch.profiler: {_device_busy(fams['clay'])}")
    return counts


def phase_resident():
    from ceph_tpu_torch import gf
    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
    from ceph_tpu_torch.ec.backend import get_backend
    from ceph_tpu_torch.ops import _build, bitplane_gf, packed_gf
    from ceph_tpu_torch.ops.gf_matmul import gf_matrix_stripes, matrix_to_device_bitmatrix
    from ceph_tpu_torch.tools import ec_benchmark
    from ceph_tpu_torch.tools.timing import graph_ms, time_ms

    backend = get_backend("torch", "cuda")
    mat = gf.reed_sol_vandermonde_coding_matrix(8, 3, 8)
    dec = gf.make_decoding_matrix(mat, [1, 6], 8, 8)[0]
    cauchy = gf.isa_cauchy_matrix(10, 4)
    isa_chunk = registry_instance().factory(
        "isa", ErasureCodeProfile(technique="cauchy", k="10", m="4", device="cuda")
    ).get_chunk_size(1 << 20)
    big = random_u8((1024, 8, 128 << 10), SEED + 1)  # 1 GiB
    one = random_u8((1, 8, 128 << 10), SEED + 2)  # one 1 MiB object
    wide = random_u8((1024, 10, isa_chunk), SEED + 3)  # 1024 isa objects of 1 MiB
    off1 = random_u8((1024, 8, (128 << 10) + 1), SEED + 4)[:, :, 1:]  # 1 GiB, rows 1 byte off
    group = random_u8((256, 8, 4096), SEED + 5)  # one group of the batched routes

    def k1(matrix, x):
        bm = matrix_to_device_bitmatrix(matrix, 8, "cuda")
        return (lambda: backend.matrix_stripes_device(matrix, x, 8),
                lambda: packed_gf.packed_stripes_plain(bm, x), x, matrix.shape[0])

    def k2(matrix, x):
        bm = matrix_to_device_bitmatrix(matrix, 8, "cuda")
        return (lambda: gf_matrix_stripes(bm, x, w=8),
                lambda: bitplane_gf.gf8_bitplane_plain(bm, x), x, matrix.shape[0])

    rows = {}
    for label, (kernel_fn, plain_fn, x, mm) in (
        ("K1 encode", k1(mat, big)),
        ("K2 encode", k2(mat, big)),
        ("K1 decode", k1(dec, big)),
        ("K2 decode", k2(dec, big)),
        ("K2 encode, rows offset by 1 byte", k2(mat, off1)),
        ("K2 batched group", k2(mat, group)),
        ("K1 encode 1 MiB object", k1(mat, one)),
        ("K1 isa cauchy k=10 m=4", k1(cauchy, wide)),
    ):
        b, k, chunk = x.shape
        before = (packed_gf.launches, bitplane_gf.launches)
        got = kernel_fn()
        launched = (packed_gf.launches - before[0], bitplane_gf.launches - before[1])
        check(launched == ((1, 0) if label.startswith("K1") else (0, 1)),
              f"{label} did not go through its kernel: {launched}")
        want = plain_fn()
        check(torch.equal(got, want), f"{label}: kernel != plain at full size")
        words = _build.words_per_thread(x, got)
        del got, want
        ms = time_ms(kernel_fn, iters=10 if b * chunk >= GIB // 8 else 200)
        plain_ms = time_ms(plain_fn, iters=1, warmup=0)
        bms, by = bound_ms(k, mm, b * chunk)
        gms = graph_ms(kernel_fn) if b <= 256 else None
        rows[label] = (ms, plain_ms, bms, by)
        print(f"[4] {label} B={b} k={k} m={mm} chunk={chunk} W={words}: {ms:.4f} ms "
              f"({k * b * chunk / ms / 1e6:.1f} GB/s of input), bound {bms:.4f} ms ({by}), "
              f"plain {plain_ms:.2f} ms")
        if gms is not None:
            print(f"[4] {label}: {gms:.4f} ms a launch on the device alone "
                  "(100 launches replayed from a CUDA graph)")
        torch.cuda.empty_cache()
    del big, one, wide, off1, group
    torch.cuda.empty_cache()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ec_benchmark.main([
            "-p", "jerasure", "-P", "technique=reed_sol_van", "-P", "k=8",
            "-P", "m=3", "-s", str(1 << 20), "-i", "3", "--batch", "1024",
            "--device", "cuda",
        ])
    seconds, kb = out.getvalue().strip().splitlines()[-1].split("\t")
    print(f"[4] ec_benchmark --batch 1024 numpy in/out: {seconds} s for {kb} KB "
          f"= {int(kb) * 1024 / float(seconds) / 1e9:.2f} GB/s of input, host transfers included")
    return rows


CRUSH_PGS = 1 << 20
CRUSH_CHUNK = 1 << 19
CRUSH_LABELS = ("crush.hash", "crush.ln", "crush.draw", "crush.replay", "crush.choose",
                "crush.emit")


def _oracle_rows(job):
    """Pool worker: the oracle's mapping of each x (pickled map)."""
    cmap, rule, rmax, xs = job
    return [cmap.do_rule(rule, int(x), rmax) for x in xs]


def _hold_against_oracle(pool, cmap, rule, rmax, xs, res, counts) -> None:
    jobs = [(cmap, rule, rmax, part) for part in np.array_split(xs, 32)]
    want = [row for rows in pool.map(_oracle_rows, jobs, timeout=600) for row in rows]
    for x, w in zip(xs, want):
        got = res[x, : counts[x]].tolist()
        check(got == w, f"rule {rule} x={x}: {got} != oracle {w}")


def _profile_split(fn) -> dict:
    """Device time of one call under torch.profiler, split by the
    mapper's ``record_function`` labels (exclusive of nested labels),
    with kernels and copies summed and the idle share of the host
    clock's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def labelled_below(ev) -> float:
        tot = 0.0
        for ch in ev.cpu_children:
            tot += ch.device_time_total if ch.name in CRUSH_LABELS else labelled_below(ch)
        return tot

    split = dict.fromkeys(CRUSH_LABELS, 0.0)
    kernels = copies = 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in CRUSH_LABELS:
            split[ev.name] += (ev.device_time_total - labelled_below(ev)) / 1e3
        for k in ev.kernels:
            if "memcpy" in k.name.lower():
                copies += k.duration / 1e3
            else:
                kernels += k.duration / 1e3
    out = {"wall_ms": wall_ms, "kernels_ms": kernels, "copies_ms": copies}
    if kernels == 0.0:
        out["note"] = "device time not measured (the profiler saw no kernel)"
        return out
    out["split_ms"] = {k.split(".")[1]: v for k, v in split.items()}
    out["split_ms"]["unlabelled"] = kernels + copies - sum(split.values())
    out["idle_share"] = 1 - (kernels + copies) / wall_ms
    return out


def _crush_rule(pool, smi: str, pm, cm, rule: int, rmax: int, n: int) -> dict:
    """One rule over n PGs on the card, checked and timed."""
    from ceph_tpu_torch.crush import torchmap as tm
    from ceph_tpu_torch.tools import crushtool

    weights = np.full(pm.max_devices, 0x10000, np.int64)

    def one_pass():
        pending = [(lo, tm.batch_do_rule_range(cm, rule, lo, min(CRUSH_CHUNK, n - lo), rmax,
                                               packed=True))
                   for lo in range(0, n, CRUSH_CHUNK)]
        oks, parts = [], []
        for lo, (r, c, k) in pending:
            oks.append(k.cpu().numpy())
            parts.append(tm.apply_oracle_fallback(cm, rule, np.arange(lo, lo + len(oks[-1])),
                                                  r, c, k, rmax, weights))
        return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
                np.concatenate(oks))

    tm.fallback_lanes = 0
    t0 = time.perf_counter()
    res, counts, ok = one_pass()
    first_s = time.perf_counter() - t0
    fallback = tm.fallback_lanes
    check(res.shape == (n, rmax) and counts.shape == (n,), f"rule {rule}: shapes {res.shape}")
    check(bool((counts == rmax).all()), f"rule {rule}: short mappings {int((counts < rmax).sum())}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = one_pass()
        times.append(time.perf_counter() - t0)
        check(np.array_equal(again[0], res), f"rule {rule}: a second pass differs")
    e2e_s = sorted(times)[1]
    xs = np.unique(np.concatenate([np.linspace(0, n - 1, 2048).astype(np.int64),
                                   np.nonzero(~ok)[0]]))
    t0 = time.perf_counter()
    _hold_against_oracle(pool, pm, rule, rmax, xs, res, counts)
    oracle_s = time.perf_counter() - t0
    print(f"[5] rule {rule} ({rmax} positions) over {n} PGs: {fallback} oracle fallback lanes; "
          f"{len(xs)} PGs ({2048} spread + the fallback lanes) equal to the oracle "
          f"({oracle_s:.1f} s in a pool)")
    # raw output of the first 2^16 lanes on the card against the CPU
    cpu = tm.compile_map(pm, device="cpu")
    lanes = np.arange(1 << 16)
    raw_card = [v.cpu() for v in tm.batch_do_rule_raw(cm, rule, lanes, rmax)]
    t0 = time.perf_counter()
    raw_cpu = tm.batch_do_rule_raw(cpu, rule, lanes, rmax)
    cpu_s = time.perf_counter() - t0
    for a, b, what in zip(raw_card, raw_cpu, ("res", "counts", "ok")):
        check(torch.equal(a, b), f"rule {rule}: raw {what} on cuda != cpu")
    print(f"[5] rule {rule}: raw (res, counts, ok) of 2^16 lanes on cuda equal to device=cpu "
          f"(the CPU took {cpu_s:.2f} s)")
    run = tm.make_chained_runner(cm, rule, rmax, CRUSH_CHUNK, iters=4)
    run(0)
    chained = sorted(run(1 + t)[1] for t in range(3))[1]
    prof = _profile_split(lambda: tm.batch_do_rule_range(cm, rule, 0, CRUSH_CHUNK, rmax,
                                                         packed=True))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = crushtool.main(["--build", "10000:40:25", "--test", "--max-x", str(n),
                             "--rule", str(rule), "--num-rep", str(rmax), "--show-statistics",
                             "--show-bad-mappings"])
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and "[torch]" in lines[0], f"crushtool: rc {rc}, {lines}")
    stats = {"bad": int(lines[2].split(":")[1]), "chi2": float(lines[3].split()[2])}
    check(stats["bad"] == 0, f"crushtool: bad mappings {lines}")
    row = {
        "pgs": n, "positions": rmax, "fallback_lanes": fallback,
        "first_pass_s": first_s, "e2e_s": e2e_s, "e2e_mappings_per_s": n / e2e_s,
        "chained_ms": chained, "chained_mappings_per_s": 4 * CRUSH_CHUNK / chained * 1e3,
        "profile": prof, "crushtool": lines[0], "chi2": stats["chi2"],
        "bad_mappings": stats["bad"], "oracle_checked": int(len(xs)),
    }
    print(f"[5] rule {rule} on {smi}: end to end (numpy out, fallback included, median of 3) "
          f"{n / e2e_s:.0f} mappings/s ({e2e_s:.4f} s, first pass {first_s:.3f} s); "
          f"device-resident (4 x 2^19 chained, CUDA events) "
          f"{row['chained_mappings_per_s']:.0f} mappings/s ({chained:.3f} ms)")
    print(f"[5] rule {rule}: one 2^19 chunk under torch.profiler: {json.dumps(prof)}")
    print(f"[5] rule {rule}: crushtool {lines[0]!r}; chi-squared {stats['chi2']}, "
          f"bad mappings {stats['bad']}")
    return row


def _golden_maps() -> dict:
    """Scenarios 0, 1 and 4 of tests/data/crush_do_rule_golden.txt.gz
    (the straw2 ones), built as the reference C built them."""
    from ceph_tpu_torch.crush.builder import CrushMap
    from ceph_tpu_torch.crush.types import (
        CRUSH_BUCKET_STRAW2, CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
        CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_EMIT,
        CRUSH_RULE_SET_CHOOSE_TRIES, CRUSH_RULE_SET_CHOOSELEAF_TRIES, CRUSH_RULE_TAKE,
        Rule, RuleStep, Tunables,
    )

    def two_rules(m, root, domain):
        m.add_rule(Rule(steps=[
            RuleStep(CRUSH_RULE_TAKE, root),
            RuleStep(CRUSH_RULE_CHOOSELEAF_FIRSTN if domain else CRUSH_RULE_CHOOSE_FIRSTN,
                     0, domain),
            RuleStep(CRUSH_RULE_EMIT)], type=1), 0)
        m.add_rule(Rule(steps=[
            RuleStep(CRUSH_RULE_SET_CHOOSELEAF_TRIES, 5),
            RuleStep(CRUSH_RULE_SET_CHOOSE_TRIES, 100),
            RuleStep(CRUSH_RULE_TAKE, root),
            RuleStep(CRUSH_RULE_CHOOSELEAF_INDEP if domain else CRUSH_RULE_CHOOSE_INDEP,
                     0, domain),
            RuleStep(CRUSH_RULE_EMIT)], type=3), 1)

    def two_level(tun, nhosts, per_host, wfun):
        m = CrushMap(tunables=tun)
        hosts = [m.add_bucket(CRUSH_BUCKET_STRAW2, 1,
                              [h * per_host + i for i in range(per_host)],
                              [wfun(h, i) for i in range(per_host)])
                 for h in range(nhosts)]
        root = m.add_bucket(CRUSH_BUCKET_STRAW2, 3, hosts, [m.buckets[b].weight for b in hosts])
        two_rules(m, root, 1)
        return m

    jewel, firefly = Tunables(0, 0, 50, 1, 1, 1, 0), Tunables(0, 0, 50, 1, 1, 0, 0)
    m0 = CrushMap(tunables=jewel)
    root = m0.add_bucket(CRUSH_BUCKET_STRAW2, 3, list(range(10)),
                         [(i + 1) * 0x10000 // 2 for i in range(10)])
    two_rules(m0, root, 0)
    return {
        0: m0,
        1: two_level(jewel, 5, 4, lambda h, i: 0x10000 + i * 0x4000),
        4: two_level(firefly, 4, 5, lambda h, i: 0x8000 * (1 + (i % 4))),
    }


def _golden_weights(n: int) -> list[int]:
    return [0 if i % 11 == 5 else 0x8000 if i % 7 == 3 else 0x10000 for i in range(n)]


def _crush_golden() -> int:
    import gzip
    import pathlib

    from ceph_tpu_torch.crush import torchmap as tm

    path = pathlib.Path(__file__).resolve().parent / "tests" / "data" / "crush_do_rule_golden.txt.gz"
    maps = _golden_maps()
    want = collections.defaultdict(dict)
    for line in gzip.open(path, "rt").read().splitlines():
        head, _, tail = line.partition(" ->")
        scen, rule, x, rmax = head.split()
        key = (int(scen[1:]), int(rule[1:]), int(rmax.split("=")[1]))
        if key[0] in maps:
            want[key][int(x.split("=")[1])] = [int(v) for v in tail.split()]
    checked = 0
    for (scen, rule, rmax), rows in sorted(want.items()):
        m = maps[scen]
        xs = np.array(sorted(rows))
        res, counts = tm.batch_do_rule(tm.compile_map(m), rule, xs, rmax,
                                       _golden_weights(m.max_devices))
        for i, x in enumerate(xs):
            check(res[i, : counts[i]].tolist() == rows[x], f"golden S{scen} R{rule} x={x}")
            checked += 1
    return checked


def phase_crush(smi: str) -> dict:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from ceph_tpu_torch.crush import torchmap as tm
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    t0 = time.perf_counter()
    pm = build_hierarchy(10000, 40, 25)
    cm = tm.compile_map(pm)
    tables = {k: v for k, v in vars(cm).items() if isinstance(v, torch.Tensor)}
    check(all(v.device.type == "cuda" for v in tables.values()),
          f"compile_map left tables off the card: {[k for k, v in tables.items() if v.is_cpu]}")
    table_bytes = sum(v.numel() * v.element_size() for v in tables.values())
    racks = sum(1 for b in pm.buckets.values() if b.type == 2)
    hosts = sum(1 for b in pm.buckets.values() if b.type == 1)
    print(f"[5] build_hierarchy(10000, 40, 25): {pm.max_devices} OSDs, {hosts} hosts, {racks} "
          f"racks, {cm.nb} straw2 buckets; {len(tables)} device tables on cuda, "
          f"{table_bytes} bytes")
    rows = {}
    # a worker that dies breaks the pool (BrokenProcessPool), it does not hang
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        rows["rule0"] = _crush_rule(pool, smi, pm, cm, 0, 3, CRUSH_PGS)
        rows["rule1"] = _crush_rule(pool, smi, pm, cm, 1, 11, CRUSH_PGS)
    golden = _crush_golden()
    print(f"[5] golden vectors of the reference C, scenarios 0, 1 and 4: {golden} mappings "
          f"on cuda equal to the file")
    print(f"[5] CRUSH phase took {time.perf_counter() - t0:.1f} s")
    return {"card": smi.splitlines()[0],
            "map": {"osds": pm.max_devices, "hosts": hosts, "racks": racks, "buckets": cm.nb,
                    "table_bytes": table_bytes},
            **rows, "golden_checked": golden}


STORE_OBJECTS = 256
STORE_OBJECT_BYTES = 4 << 20  # the RADOS default object size
STORE_REPLICAS = 3
STORE_DEVICE = "cuda"
# the EC PG's 1.375 GiB of shards and the replicated PG's 3 GiB of copies
RESIDENCY_BYTES = 6 << 30


def _scrub_flags(results: dict) -> list:
    """(name, position) of every finding of a scrub_batch, sorted; a
    missing or inconsistent finding is reported as such."""
    flags = []
    for name, r in results.items():
        flags += [(name, p) for p in r.corrupt]
        flags += [(name, "missing", p) for p in r.missing]
        if r.inconsistent:
            flags.append((name, "inconsistent"))
    return sorted(flags, key=str)


def _kind_delta(before: dict, after: dict, kind: str) -> dict:
    a, b = after.get(kind, {}), before.get(kind, {})
    return {f: a.get(f, 0) - b.get(f, 0) for f in ("dispatches", "bytes_in", "bytes_uploaded",
                                                     "bytes_resident")}


def _ec_store(rng, datas: dict) -> dict:
    """The EC PG: put, scrub twice, corrupt and repair, lose a position
    and rebuild it in one batched decode, scrub, degraded reads."""
    from ceph_tpu_torch.ops.profiler import dispatch_profiler
    from ceph_tpu_torch.ops.residency import residency_cache
    from ceph_tpu_torch.store import ECStore

    ecs = ECStore(plugin="isa", profile={"k": "8", "m": "3", "device": STORE_DEVICE})
    names = list(datas)
    cache, prof = residency_cache(), dispatch_profiler()
    check(cache.capacity_bytes == RESIDENCY_BYTES,
          f"residency cache holds {cache.capacity_bytes} B, not {RESIDENCY_BYTES}")
    t0 = time.perf_counter()
    for name in names:
        ecs.put(name, datas[name])
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    shard_len = ecs.stores[0].stat(ecs.cid, names[0])
    shard_bytes = len(names) * ecs.n * shard_len
    out = {"put_s": put_s, "shard_bytes": shard_bytes, "stripe_width": ecs.sinfo.stripe_width}
    for label in ("first", "second"):
        hits, tot = cache.stats()["hits"], prof.totals()
        t0 = time.perf_counter()
        res = ecs.scrub_batch(names)
        out[f"scrub_{label}_s"] = time.perf_counter() - t0
        check(not _scrub_flags(res), f"{label} scrub of a clean PG: {_scrub_flags(res)[:5]}")
        grew = cache.stats()["hits"] - hits
        check(grew == len(names) * ecs.n, f"{label} scrub: residency hits grew by {grew}")
        out[f"scrub_{label}_crc32c"] = _kind_delta(tot, prof.totals(), "crc32c")
    check(out["scrub_second_crc32c"]["bytes_uploaded"] == 0,
          f"the second scrub uploaded {out['scrub_second_crc32c']}")
    # every shard of the PG and its HashInfo hash, for the crc section
    shards = [ecs.stores[p].read(ecs.cid, name) for name in names for p in range(ecs.n)]
    hashes = [h for name in names for h in ecs.meta(name)["hashes"]]
    print(f"[6] ECStore isa k=8 m=3: {len(names)} objects of {STORE_OBJECT_BYTES} B put "
          f"({shard_bytes} B of shards in {ecs.n} MemStores); two scrub_batch passes clean, "
          f"residency hits +{len(names) * ecs.n} each; crc32c bytes uploaded "
          f"{out['scrub_first_crc32c']['bytes_uploaded']} then "
          f"{out['scrub_second_crc32c']['bytes_uploaded']}")
    picks = rng.choice(len(names) * ecs.n, 3, replace=False)
    pairs = sorted(((names[int(i) // ecs.n], int(i) % ecs.n) for i in picks), key=str)
    for name, pos in pairs:
        ecs.corrupt_shard(name, pos, offset=int(rng.integers(0, shard_len)))
    flags = _scrub_flags(ecs.scrub_batch(names))
    check(flags == pairs, f"scrub after corrupting {pairs} flagged {flags}")
    for name, pos in pairs:
        ecs.recover_shard(name, pos)
    print(f"[6] corrupt_shard {pairs}: the next scrub_batch flagged exactly those; repaired")
    originals = {name: ecs.stores[1].read(ecs.cid, name) for name in names}
    for name in names:
        ecs.lose_shard(name, 1)
    t0 = time.perf_counter()
    stats = ecs.recover_objects_batch(names, 1)
    torch.cuda.synchronize()
    out["recover_s"] = time.perf_counter() - t0
    out["recover_stats"] = stats
    check(stats["batched"] == len(names) and stats["objects"] == len(names),
          f"recover_objects_batch: {stats}")
    for name in names:
        check(ecs.stores[1].read(ecs.cid, name) == originals[name], f"rebuilt shard 1 of {name}")
    out["recover_bytes"] = sum(len(v) for v in originals.values())
    del originals
    flags = _scrub_flags(ecs.scrub_batch(names))
    check(not flags, f"scrub after recovery: {flags[:5]}")
    print(f"[6] position 1 lost on every object and rebuilt by one recover_objects_batch "
          f"({stats}): every shard equal to the original; the next scrub clean")
    for name in names:
        ecs.lose_shard(name, 1)
        ecs.lose_shard(name, 9)
    t0 = time.perf_counter()
    for name in names:
        check(ecs.get(name) == datas[name], f"degraded get of {name}")
    out["get_s"] = time.perf_counter() - t0
    print(f"[6] degraded get with shards {{1, 9}} lost: all {len(names)} payloads byte-exact")
    return out, shards, hashes


def _crc_on_card(rng, shards: list, hashes: list) -> dict:
    """batch_crc32c and batch_compare over every shard of the EC PG, on
    host bytes and on resident DeviceBufs, timed beside their bounds and
    the host C crc32c."""
    from ceph_tpu_torch.native import ceph_crc32c
    from ceph_tpu_torch.ops import scrub_kernels as sk
    from ceph_tpu_torch.ops.profiler import dispatch_profiler
    from ceph_tpu_torch.ops.residency import DeviceBuf
    from ceph_tpu_torch.tools.timing import time_ms

    dev = torch.device(STORE_DEVICE)
    total = sum(map(len, shards))
    t0 = time.perf_counter()
    host = [ceph_crc32c(0xFFFFFFFF, s) for s in shards]
    host_ms = (time.perf_counter() - t0) * 1e3
    check(host == hashes, "host crc32c != HashInfo")
    t0 = time.perf_counter()
    got = sk.batch_crc32c(shards, 0xFFFFFFFF, device=dev)
    upload_call_ms = (time.perf_counter() - t0) * 1e3
    check([int(c) for c in got] == host, "batch_crc32c of host bytes != host crc32c")
    bufs = [DeviceBuf(data=s, device=dev) for s in shards]
    for b in bufs:
        b.device()
    torch.cuda.synchronize()
    prof = dispatch_profiler()
    before = prof.totals()
    t0 = time.perf_counter()
    got = sk.batch_crc32c(bufs, 0xFFFFFFFF, device=dev)
    resident_call_ms = (time.perf_counter() - t0) * 1e3
    rec = _kind_delta(before, prof.totals(), "crc32c")
    check([int(c) for c in got] == host, "batch_crc32c of resident DeviceBufs != host crc32c")
    check(rec["bytes_uploaded"] == 0 and rec["bytes_resident"] == total,
          f"resident batch_crc32c moved bytes: {rec}")
    for init, payload, want in sk.GOLDEN_VECTORS:
        check(int(sk.batch_crc32c([payload], init, device=dev)[0]) == want,
              f"golden vector {payload!r}")
    print(f"[6] batch_crc32c on the card: {len(shards)} shards ({total} B) equal to the host C "
          f"crc32c and the HashInfo hashes, from host bytes and from resident DeviceBufs "
          f"(0 B uploaded, {total} B resident); golden vectors equal")
    width = max(map(len, shards))
    rows = sk._gather_rows(bufs, width, dev, align_right=True)
    nchunks = width // sk._CHUNK
    gc_t = sk._device_chunk_matrix(sk._CHUNK, dev)
    hc_t = sk._device_combine_matrix(sk._CHUNK, nchunks, dev)
    crc_ms = time_ms(lambda: sk.crc_bits(rows, gc_t, hc_t), iters=3)
    n = len(shards)
    by_ms = total / HBM_BYTES_PER_S * 1e3
    ops = 2 * (n * nchunks) * (sk._CHUNK * 8) * 32 + 2 * n * (nchunks * 32) * 32
    op_ms = ops / INT8_OPS_PER_S * 1e3
    flips = sorted(int(i) for i in rng.choice(n, 64, replace=False))
    expected = list(shards)
    cols = rng.integers(0, width, len(flips))
    for i, col in zip(flips, cols):
        b = bytearray(shards[i])
        b[int(col)] ^= 1 + int(rng.integers(0, 255))
        expected[i] = bytes(b)
    want = np.array([s != e for s, e in zip(shards, expected)])
    verdict = sk.batch_compare(bufs, expected, device=dev)
    check(np.array_equal(verdict, want), "batch_compare verdicts != the host's")
    flipped = rows.clone()
    flipped[flips, torch.as_tensor(width - len(shards[0]) + cols, device=dev)] ^= 1
    check(np.array_equal(sk.mismatch(rows, flipped).cpu().numpy(), want), "mismatch on the card")
    mis_ms = time_ms(lambda: sk.mismatch(rows, flipped), iters=5)
    print(f"[6] batch_compare of the {n} shards against copies with {len(flips)} seeded one-byte "
          "flips: verdicts equal the host's")
    del rows, flipped, bufs
    torch.cuda.empty_cache()
    return {
        "shards": n, "bytes": total, "host_c_ms": host_ms,
        "call_ms_host_bytes": upload_call_ms, "call_ms_resident": resident_call_ms,
        "crc_bits": {"ms": crc_ms, "bound_ms": max(by_ms, op_ms),
                     "bound_by": "bytes" if by_ms >= op_ms else "operations",
                     "bytes_bound_ms": by_ms, "ops_bound_ms": op_ms, "ops": ops,
                     "dtype": "int8 x int8 -> int32 (torch._int_mm)"},
        "mismatch": {"ms": mis_ms, "bound_ms": 2 * total / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"},
    }


def _replicated_store(rng, datas: dict) -> dict:
    from ceph_tpu_torch.store import ReplicatedStore

    rs = ReplicatedStore(size=STORE_REPLICAS, device=STORE_DEVICE)
    names = list(datas)
    t0 = time.perf_counter()
    for name in names:
        rs.put(name, datas[name])
    put_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flags = _scrub_flags(rs.scrub_batch(names))
    scrub_s = time.perf_counter() - t0
    check(not flags, f"replicated scrub of a clean PG: {flags[:5]}")
    victim = (names[int(rng.integers(0, len(names)))], int(rng.integers(0, STORE_REPLICAS)))
    rs.corrupt_replica(*victim, offset=int(rng.integers(0, STORE_OBJECT_BYTES)))
    flags = _scrub_flags(rs.scrub_batch(names))
    check(flags == [victim], f"replicated scrub after corrupting {victim}: {flags}")
    rs.recover_replica(*victim)
    flags = _scrub_flags(rs.scrub_batch(names))
    check(not flags, f"replicated scrub after recover_replica: {flags[:5]}")
    print(f"[6] ReplicatedStore, {STORE_REPLICAS} replicas of the {len(names)} objects: "
          f"scrub_batch clean, corrupt replica {victim} flagged alone, recover_replica "
          "cleared it")
    return {"replicas": STORE_REPLICAS, "put_s": put_s, "scrub_s": scrub_s,
            "bytes": STORE_REPLICAS * len(names) * STORE_OBJECT_BYTES}


def phase_store(smi: str) -> dict:
    from ceph_tpu_torch.ops import bitplane_gf, packed_gf
    from ceph_tpu_torch.ops.kernel_stats import kernel_stats
    from ceph_tpu_torch.ops.profiler import breakdown, dispatch_profiler
    from ceph_tpu_torch.ops.residency import residency_cache

    rng = np.random.default_rng(SEED + 6)
    block = rng.bytes(STORE_OBJECTS * STORE_OBJECT_BYTES)
    datas = {f"obj{i:03d}": block[i * STORE_OBJECT_BYTES : (i + 1) * STORE_OBJECT_BYTES]
             for i in range(STORE_OBJECTS)}
    del block
    ks = kernel_stats()
    calls0 = {k: ks.dump().get(f"l_tpu_{k}_calls", 0) for k in ("scrub_crc32c", "scrub_verify")}
    packed_gf.launches = 0
    bitplane_gf.launches = 0
    prof0 = dispatch_profiler().totals()
    t0 = time.perf_counter()
    ec, shards, hashes = _ec_store(rng, datas)
    residency_cache().clear()
    torch.cuda.empty_cache()
    crc = _crc_on_card(rng, shards, hashes)
    del shards, hashes
    rep = _replicated_store(rng, datas)
    residency_cache().clear()
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    counts = {"K1": packed_gf.launches, "K2": bitplane_gf.launches}
    calls = {k: ks.dump().get(f"l_tpu_{k}_calls", 0) - v for k, v in calls0.items()}
    check(counts["K1"] > 0 and counts["K2"] > 0, f"a kernel was not launched: {counts}")
    bd = breakdown(prof0, dispatch_profiler().totals())
    logical = STORE_OBJECTS * STORE_OBJECT_BYTES
    gbps = {
        "put_GBps": logical / ec["put_s"] / 1e9,
        "scrub_first_GBps": ec["shard_bytes"] / ec["scrub_first_s"] / 1e9,
        "scrub_second_GBps": ec["shard_bytes"] / ec["scrub_second_s"] / 1e9,
        "recover_GBps": ec["recover_bytes"] / ec["recover_s"] / 1e9,
        "get_degraded_GBps": logical / ec["get_s"] / 1e9,
        "replicated_put_GBps": logical / rep["put_s"] / 1e9,
        "replicated_scrub_GBps": rep["bytes"] / rep["scrub_s"] / 1e9,
    }
    print(f"[6] store phase took {phase_s:.1f} s; launches {counts}; scrub function calls {calls}")
    print(f"[6] on {smi.splitlines()[0]} (host clock, numpy in and out): "
          + ", ".join(f"{k} {v:.3f}" for k, v in gbps.items()))
    print(f"[6] crc_bits over the PG's {crc['shards']} shards ({crc['bytes']} B, resident): "
          f"{crc['crc_bits']['ms']:.3f} ms (CUDA events), bound {crc['crc_bits']['bound_ms']:.3f} "
          f"ms ({crc['crc_bits']['bound_by']}; bytes {crc['crc_bits']['bytes_bound_ms']:.3f}, "
          f"int8 products {crc['crc_bits']['ops_bound_ms']:.3f}); host C crc32c "
          f"{crc['host_c_ms']:.1f} ms; mismatch {crc['mismatch']['ms']:.3f} ms, bound "
          f"{crc['mismatch']['bound_ms']:.3f} ms (bytes)")
    print(f"[6] dispatch profiler over the phase: {json.dumps(bd)}")
    return {"card": smi.splitlines()[0],
            "config": {"plugin": "isa", "k": 8, "m": 3, "stripe_unit": 4096,
                       "objects": STORE_OBJECTS, "object_bytes": STORE_OBJECT_BYTES,
                       "replicas": STORE_REPLICAS, "residency_bytes": RESIDENCY_BYTES},
            **gbps, "seconds": {k: v for k, v in ec.items() if k.endswith("_s")},
            "phase_s": phase_s, "recover_stats": ec["recover_stats"],
            "scrub_crc32c": {k: ec[k] for k in ("scrub_first_crc32c", "scrub_second_crc32c")},
            "crc": crc, "launches": counts, "scrub_calls": calls, "breakdown": bd}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # read when the residency cache is first made, in phase 6
    os.environ["CEPH_TPU_RESIDENCY_BYTES"] = str(RESIDENCY_BYTES)
    smi = phase_build()
    errs = {"K1": 0, "K2": 0}
    phase_kernels(errs)
    counts = phase_main_path()
    phase_layered(smi)
    rows = phase_resident()
    crush = phase_crush(smi)
    store = phase_store(smi)
    note = "no PyTorch call computes a GF(2^8) region product"
    kernels = []
    for key, name, replaces, label in (
        ("K1", "gf8_packed", "ceph_tpu/ops/packed_gf.py:123", "K1 encode"),
        ("K2", "gf8_bitplane", "ceph_tpu/ops/pallas_gf.py:32", "K2 encode"),
    ):
        ms, plain_ms, bms, by = rows[label]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ceph_tpu_torch/csrc/gf8_kernels.cu", "replaces": replaces,
            "launches": counts[key], "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "library_note": note,
            "shape": "B=1024 k=8 m=3 chunk=131072 (1 GiB in)",
        })
    print(json.dumps({"crush": crush}))
    print(json.dumps({"store": store}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
