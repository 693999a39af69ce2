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
5. one JSON line describing each kernel;
6. the last line, ``{"ok": true, "device": {...}}``.

It needs one CUDA device and exits non-zero without one.  It imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
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
    rec = backend.decode_stripes_batch(dec, row_sets, 8, 4096)
    for s, r in zip(batches, rec):
        check(np.array_equal(r, s[:, [1, 6]]), "batched decode")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = phase_build()
    errs = {"K1": 0, "K2": 0}
    phase_kernels(errs)
    counts = phase_main_path()
    phase_layered(smi)
    rows = phase_resident()
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
