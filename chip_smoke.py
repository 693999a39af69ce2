#!/usr/bin/env python3
"""Smoke run of ceph_tpu_torch on one NVIDIA GPU: build, check, drive, time.

    python3 chip_smoke.py
    python3 chip_smoke.py --gateways   # phases 1, 10, 13 and 14 alone, mdtest at 1000 files

Phases, each reported on its own lines; any mismatch raises and the
script exits non-zero:

1. the card (nvidia-smi name and power limit), CUDA version, and the
   nvcc builds of ``ceph_tpu_torch/csrc/gf8_kernels.cu`` and
   ``crush_kernels.cu`` with their times and the registers and spills of
   each kernel instance;
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
   same hierarchy with legacy straw hosts and with a one-position
   choose_args weight-set, both rules over 2^18 PGs each, timed and held
   against the oracle; every golden vector of the reference C (scenarios
   0 to 4 and the choose_args lines) on the card, but scenario 3, whose
   argonaut tunables are outside the batched mapper and map through the
   oracle; the straw2 draw kernel's launches over the phase (zeroed
   before, non-zero after), and the kernel at the remap cell's four draw
   levels (2^19 lanes x 5 candidates: the 63-wide root, 2-wide rows,
   20-wide racks, 4-wide hosts) equal to the plain draw on the card and
   timed beside it and its instruction-issue bound; one ``{"crush": ...}``
   line;
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
7. the OSD map on the card: config 5's cluster (10 000 OSDs) with a
   replicated pool of 2^20 PGs (size 3, rule 0), an EC pool of 2^18
   (size 11, rule 1) and an lrc pool of 2^17 (k=4 m=2 l=3, rack
   locality: two chained choose steps, every PG on the card) through
   ``OSDMapMapping`` on cuda: a warm update and
   three timed ones (PG mappings/s, numpy out; the perf counters' CRUSH
   and fix-up stages; the dispatch profiler's split), then a seeded
   incremental (encoded and decoded: OSDs down, out and reweighted,
   primary affinities, upmaps, pg_temp, primary_temp) and one timed
   update; for each epoch and pool a seeded sample of 2048 PGs and every
   PG an override touches against the scalar pipeline in the process
   pool; the whole map's encoding decoded and mapped again to equal
   arrays; ``osdmaptool --test-map-pgs`` in process; ``calc_pg_upmaps``
   on 1000 OSDs and 2^15 PGs, each upmap held against the scalar
   pipeline; one ``{"osdmap": ...}`` line;
8. the EC sub-op wire and the durable stores, with the launch counts
   zeroed before and both non-zero after: one PG (isa k=8 m=3, stripe
   unit 4096, 64 seeded objects of 4 MiB) whose 11 shards sit behind
   ``ShardServer``s, each on its own ``Messenger`` on 127.0.0.1 over a
   ``WALStore(device="cuda")`` fronting a ``BlockStore`` under
   ``build/``, with one client ``Messenger`` and 11 ``RemoteStore``s
   under an ``ECStore``: put (K1) and every object read back; a deep
   scrub of the media (``build_scrub_map`` on cuda, ``compare_ec``)
   clean, then one bit flipped in one shard's ``block.dev`` flagged as
   exactly that (object, shard) and repaired; one shard server's
   messenger stopped and named by ``HeartbeatTracker`` ping rounds,
   marked down by two reporters in a ``FailureAggregator``; a degraded
   get of a sample; ``recover_objects_batch`` (K2) onto a fresh server,
   every rebuilt shard equal to its first-scrub crc and a clean
   re-scrub; one shard's WAL dropped with 16 small RMW writes acked but
   unapplied, remounted (the replay's crc verify on the card, timed by
   CUDA events beside its byte bound) and every object read back;
   ``python -m ceph_tpu_torch.store.remote --port 0`` answering a
   transaction, a read and a ping; the host crc32c's thread-seconds by
   caller and a 2 ms sample of where the threads run during put and
   recovery; one ``{"wire": ...}`` line;
9. the cluster, with the launch counts zeroed before and both non-zero
   after: a ``Monitor`` on its own messenger, 12 ``OSD(device="cuda")``
   daemons over ``MemStore`` and 2 ``Rados`` clients in this process; an
   isa k=8 m=3 pool (from ``osd erasure-code-profile set``, stripe unit
   4096) and a 3-replica pool, pg_num 16 each; 64 seeded objects of 4
   MiB written through ``aio_write_full`` (8 of them queued behind one
   stalled primary, so write coalescing must fire) and read back, 64
   into the replicated pool; 16 RMW overwrites at stripe offsets; a deep
   scrub of every EC PG (``pg_scrub``) clean, one byte of one shard
   rotted in one OSD's store flagged as exactly that (object, shard),
   ``pg_repair`` and a clean re-scrub; one OSD's messenger stopped and
   the seconds until the monitor marks it down; degraded reads and
   writes; ``osd out`` and the wait until every PG is active+clean on
   the 12th OSD, every object read back; a daemon restarted on the
   stopped OSD's store reloading its PGs; no crash report, no failed
   recovery, no reactor left; GB/s, ``osd perf`` and the launch counts
   beside the card's name and limit; one ``{"cluster": ...}`` line;
10. the cluster as processes, what ``tools.cluster start --processes
   --device cuda --mds 2 --rgw 1`` starts: 3 ``QuorumMonitor``s, a
   ``Manager``, two MDS and a gateway process, and 12 OSD processes on
   ``cuda`` (each its own CUDA context; the kernels built
   once before the spawn; each child's residency cache at its 256 MiB
   default) over a ``BlockStore`` each, under the supervisor; from this
   process, 2 ``Rados`` clients: the same pools as phase 9, 64 EC
   and 64 replicated objects of 4 MiB put and read back byte-equal; the
   leader monitor SIGKILLed, the seconds until the new quorum commits,
   the monitor respawned and caught up (``mon_status``); one OSD process
   SIGKILLed, the seconds to its mark-down at the reference's 20 s
   grace, 32 degraded reads, ``osd out`` to every PG active+clean (the
   manager's digest), every object read back; the OSD respawned on its
   store, its PGs reloaded, rejoined and clean again; ``balancer on``
   through the manager, its first plan equal to ``calc_pg_upmaps`` on
   the CPU on a copy of the map it planned on; each OSD's kernel launch
   counts over its admin socket (every EC primary's non-zero); each
   process's card memory (``nvidia-smi``); then phases 11, 13 and 14 on
   the same fleet; a clean stop: no death but the planned ones (those
   phases' included), ``crash ls`` holding only those, nothing to reap;
   one ``{"processes": ...}`` line;
11. block images on phase 10's fleet, each OSD's K1/K2 launches read
   over its admin socket before and after each step: an isa k=8 m=3
   pool (pg_num 16); through ``python -m ceph_tpu_torch.tools.rbd_cli``
   as a process, a 512 MiB image created with exclusive-lock and
   object-map (4 MiB objects, stripe_count 1) and ``info``, a seeded
   512 MiB file ``import``ed (K1 must fire) and ``export``ed with an equal
   sha256; 256 seeded 4 KiB writes at distinct aligned offsets through
   ``Image.aio_write``, 16 in flight (rbd bench's io-size and
   io-threads), each read back, IOPS and p50/p99 latency; a snapshot, an
   8 MiB overwrite, the read at the snapshot equal to the bytes before
   it and ``rbd diff --from-snap`` listing exactly the touched objects;
   an OSD holding data positions of the image's PGs SIGKILLed and
   marked down, a degraded ``export`` equal to the image (K2 must fire),
   the OSD respawned and every PG clean again; 16 MiB of 4 KiB writes
   through the ObjectCacher (``cache=True``) flushed and read back
   uncached; a journaled 16 MiB image on a 3-replica pool mirrored into
   another pool by ``MirrorDaemon.replay_once``, then its tail; one
   ``{"rbd": ...}`` line;
12. the qa thrasher: the JAX package's tier-1 gate schedule (seed
   20260807, 30 s, 3 OSDs) against 3 in-process ``OSD(device="cuda")``
   over WAL-fronted MemStores, a monitor and a manager, under the
   consistency oracle: zero violations, HEALTH_OK, at least half the
   events applied; the events applied and skipped, ops, WAL records
   replayed and the device crc calls; one ``{"thrash": ...}`` line;
13. the object gateway on phase 10's fleet, after phase 11, each OSD's
   K1/K2 launches read over its admin socket before and after each
   step: an isa k=8 m=3 pool (stripe unit 4096, pg_num 16) with an
   ``RGW`` in this process serving S3 on 127.0.0.1; 256 seeded objects
   of 4 MiB (rgw_max_chunk_size: one rados object a PUT) PUT by 16
   concurrent HTTP clients, each ETag the body's md5; every object GET
   back with an equal sha256, ListObjects at max-keys=100 listing all
   in key order; a 64 MiB multipart upload in 5 MiB parts (13, the
   ETag ending in -13) read back equal; 512 PUTs of 4 KiB at 16 in
   flight (ops/s, p50/p99); a SigV4-signed PUT and GET through
   ``sign_request`` on an ``auth=True`` gateway and an unsigned PUT
   refused with 403; an OSD holding data positions of the pool's PGs
   SIGKILLed and marked down, every object GET back equal (degraded),
   8 objects PUT anew, the OSD respawned and every PG clean again, the
   8 read back; ``python -m
   ceph_tpu_torch.tools.rgw_admin bucket stats`` as a process counting
   every object put; the fleet's ``rgw.0`` role taking a bucket and a
   4 MiB PUT and GET on its replicated ``rgwpool``; K1 + K2 over the
   PUTs, and over the degraded GETs and the rebuild, with the OSDs'
   coalesced batch-encode dispatches over the PUTs; one ``{"rgw": ...}``
   line;
14. the file system on the same fleet: its ``mds.0`` and ``mds.1``
   (active and standby over ``fsmeta``) and an ``MDSClient`` in this
   process whose file data goes to an isa k=8 m=3 pool (pg_num 16) in
   CephFS's default layout (stripe unit 4 MiB, stripe count 1, object
   size 4 MiB): 32 seeded files of 16 MiB written 8 at a time and read
   back with equal sha256s (K1 must fire); a burst of mdtest's shape,
   100 files in one directory (1000 with ``--gateways``) created,
   stat'ed, listed and removed, ops/s each; the active MDS process
   SIGKILLed, the seconds until the
   standby serves a client stat, every file read back equal, the killed
   MDS respawned as standby; one ``{"fs": ...}`` line;
15. CRUSH's compiler on the card, after phase 7 in the same process
   pool: config 5's hierarchy decompiled, compiled, encoded and decoded
   (each timed), equal bytes and text both ways; ``crushtool -c`` to a
   binary and ``-d`` back to the same text; ``crushtool -i MAP.BIN
   --test --backend torch --device cuda`` for rule 0 and rule 1 over
   2^20 PGs (mappings/s beside phase 5's), the mappings of phase 5's
   spread sample held against the oracle in the pool; ``--compare``
   against a copy with 1 % of the OSDs at half weight over 2^20 PGs
   (exit 1, its delta), the second map's sample against the oracle, a
   map against itself equivalent; one ``{"compiler": ...}`` line;
16. the device mesh on the card: ``default_mesh()`` None on a one-card
   host; on ``DeviceMesh(["cuda:0"] * 4)`` 1024 stripes of k=8 m=3 x
   128 KiB (1 GiB) and a ragged 1023 through ``sharded_matrix_stripes``,
   K2 launched once a shard and ``torch.equal`` to the single-device K2
   output; rule 0 and rule 1 over 2^20 PGs through
   ``sharded_batch_do_rule``, equal to torchmap's single-device output;
   the dryrun's step (``tools/mesh_dryrun.py``); the per-device counters
   and the times beside the single-device route's; the same over every
   card where there is more than one; one ``{"mesh": ...}`` line;
17. one JSON line describing each kernel;
18. the last line, ``{"ok": true, "device": {...}}``.

It needs one CUDA device and exits non-zero without one.  It imports
nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import io
import itertools
import json
import multiprocessing
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor

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
    t0 = time.perf_counter()
    _build.crush_library()
    print(f"[1] nvcc build of {_build.CRUSH_SOURCE}: "
          f"{_build.build_seconds.get(_build.CRUSH_SOURCE, 0.0):.2f} s compile, "
          f"{time.perf_counter() - t0:.2f} s to load")
    ptxas = _build.build_log.get(_build.CRUSH_SOURCE, "")
    for name, res in _build.kernel_resources(ptxas).items():
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
CRUSH_VARIANT_PGS = 1 << 18


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

    tm.counts["crush_oracle_lanes"] = 0
    t0 = time.perf_counter()
    res, counts, ok = one_pass()
    first_s = time.perf_counter() - t0
    fallback = tm.counts["crush_oracle_lanes"]
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
        "crushtool": lines[0], "chi2": stats["chi2"],
        "bad_mappings": stats["bad"], "oracle_checked": int(len(xs)),
    }
    print(f"[5] rule {rule} on {smi}: end to end (numpy out, fallback included, median of 3) "
          f"{n / e2e_s:.0f} mappings/s ({e2e_s:.4f} s, first pass {first_s:.3f} s); "
          f"device-resident (4 x 2^19 chained, CUDA events) "
          f"{row['chained_mappings_per_s']:.0f} mappings/s ({chained:.3f} ms)")
    print(f"[5] rule {rule}: crushtool {lines[0]!r}; chi-squared {stats['chi2']}, "
          f"bad mappings {stats['bad']}")
    return row


def _golden_maps() -> dict:
    """The five scenarios of tests/data/crush_do_rule_golden.txt.gz,
    built as the reference C built them (straw_calc_version 0), and the
    choose_args scenario of tests/data/crush_choose_args_golden.txt.gz."""
    from ceph_tpu_torch.crush.builder import CrushMap
    from ceph_tpu_torch.crush.types import (
        CRUSH_BUCKET_LIST, CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2, CRUSH_BUCKET_TREE,
        CRUSH_BUCKET_UNIFORM, CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
        CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSELEAF_INDEP, CRUSH_RULE_EMIT,
        CRUSH_RULE_SET_CHOOSE_TRIES, CRUSH_RULE_SET_CHOOSELEAF_TRIES, CRUSH_RULE_TAKE,
        ChooseArg, Rule, RuleStep, Tunables,
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

    def two_level(tun, algs, nhosts, per_host, wfun, root_alg=CRUSH_BUCKET_STRAW2):
        m = CrushMap(tunables=tun)
        hosts = [m.add_bucket(algs[h % len(algs)], 1,
                              [h * per_host + i for i in range(per_host)],
                              [wfun(h, i) for i in range(per_host)])
                 for h in range(nhosts)]
        root = m.add_bucket(root_alg, 3, hosts, [m.buckets[b].weight for b in hosts])
        two_rules(m, root, 1)
        return m

    jewel, firefly = Tunables(0, 0, 50, 1, 1, 1, 0), Tunables(0, 0, 50, 1, 1, 0, 0)
    argonaut = Tunables(2, 5, 19, 0, 0, 0, 0)
    m0 = CrushMap(tunables=jewel)
    root = m0.add_bucket(CRUSH_BUCKET_STRAW2, 3, list(range(10)),
                         [(i + 1) * 0x10000 // 2 for i in range(10)])
    two_rules(m0, root, 0)
    ca = two_level(jewel, [CRUSH_BUCKET_STRAW2], 5, 4, lambda h, i: 0x10000 + i * 0x4000)
    hosts = sorted((b for b, bk in ca.buckets.items() if bk.type == 1), reverse=True)
    ca.set_choose_args({
        hosts[0]: ChooseArg(weight_set=[[0x8000 + i * 0x2000 for i in range(4)],
                                        [0x20000 - i * 0x3000 for i in range(4)]]),
        hosts[2]: ChooseArg(ids=[1008, 1009, 1010, 1011]),
        min(ca.buckets): ChooseArg(weight_set=[[0x40000 + i * 0x10000 for i in range(5)]]),
    })
    return {
        0: m0,
        1: two_level(jewel, [CRUSH_BUCKET_STRAW2], 5, 4, lambda h, i: 0x10000 + i * 0x4000),
        2: two_level(jewel, [CRUSH_BUCKET_UNIFORM, CRUSH_BUCKET_LIST, CRUSH_BUCKET_TREE,
                             CRUSH_BUCKET_STRAW, CRUSH_BUCKET_STRAW2], 5, 4,
                     lambda h, i: 0x18000 if h % 5 == 0 else 0x10000 + i * 0x6000),
        3: two_level(argonaut, [CRUSH_BUCKET_STRAW], 6, 3,
                     lambda h, i: 0x10000 * (1 + (h + i) % 3), CRUSH_BUCKET_STRAW),
        4: two_level(firefly, [CRUSH_BUCKET_STRAW2], 4, 5, lambda h, i: 0x8000 * (1 + (i % 4))),
        "choose_args": ca,
    }


def _golden_weights(n: int) -> list[int]:
    return [0 if i % 11 == 5 else 0x8000 if i % 7 == 3 else 0x10000 for i in range(n)]


def _crush_golden() -> dict:
    """Every golden line of the reference C: through the batched mapper
    on the card where it takes the map, else (scenario 3's argonaut
    tunables, outside it as outside jaxmap) through the oracle, as
    crushtool and OSDMapMapping map it; and the 600 choose_args lines."""
    import gzip
    import pathlib
    import re

    from ceph_tpu_torch.crush import torchmap as tm

    data = pathlib.Path(__file__).resolve().parent / "tests" / "data"
    maps = _golden_maps()
    want = collections.defaultdict(dict)
    for line in gzip.open(data / "crush_do_rule_golden.txt.gz", "rt").read().splitlines():
        head, _, tail = line.partition(" ->")
        scen, rule, x, rmax = head.split()
        key = (int(scen[1:]), int(rule[1:]), int(rmax.split("=")[1]))
        want[key][int(x.split("=")[1])] = [int(v) for v in tail.split()]
    for line in gzip.open(data / "crush_choose_args_golden.txt.gz", "rt").read().splitlines():
        tag, rule, nrep, x, res = re.match(r"(\w+) (\d+) (\d+) (\d+) \[(.*)\]", line).groups()
        if tag == "ca":
            want[("choose_args", int(rule), int(nrep))][int(x)] = (
                [int(v) for v in res.split(",")] if res else [])
    out = {"card": collections.Counter(), "oracle": collections.Counter(), "refused": {}}
    for (scen, rule, rmax), rows in want.items():
        m = maps[scen]
        w = _golden_weights(m.max_devices)
        xs = np.array(sorted(rows))
        try:
            cm = tm.compile_map(m)
        except tm.UnsupportedMap as e:
            out["refused"][f"S{scen}"] = str(e)
            for x in xs:
                check(m.do_rule(rule, int(x), rmax, w) == rows[x], f"golden S{scen} R{rule} x={x}")
            out["oracle"][f"S{scen}"] += len(xs)
            continue
        res, counts = tm.batch_do_rule(cm, rule, xs, rmax, w)
        for i, x in enumerate(xs):
            check(res[i, : counts[i]].tolist() == rows[x], f"golden {scen} R{rule} x={x}")
        out["card"][f"S{scen}" if scen != "choose_args" else scen] += len(xs)
    check(sum(out["card"].values()) + sum(out["oracle"].values()) == 3600,
          f"golden lines: {out}")
    return {k: dict(v) for k, v in out.items()}


def _crush_variant(pool, smi: str, name: str, pm, rule: int, rmax: int) -> dict:
    """One rule over CRUSH_VARIANT_PGS PGs of a variant of config 5's
    map on the card, end to end (numpy out, oracle fallback included,
    median of 3), held against the oracle."""
    from ceph_tpu_torch.crush import torchmap as tm

    n = CRUSH_VARIANT_PGS
    cm = tm.compile_map(pm)
    xs = np.arange(n)
    tm.counts["crush_oracle_lanes"] = 0
    res, counts = tm.batch_do_rule(cm, rule, xs, rmax)
    fallback = tm.counts["crush_oracle_lanes"]
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = tm.batch_do_rule(cm, rule, xs, rmax)
        times.append(time.perf_counter() - t0)
        check(np.array_equal(again[0], res), f"{name} rule {rule}: a second pass differs")
    e2e_s = sorted(times)[1]
    raw_ok = tm.batch_do_rule_raw(cm, rule, xs, rmax)[2].cpu().numpy()
    sample = np.unique(np.concatenate([np.linspace(0, n - 1, 1024).astype(np.int64),
                                       np.nonzero(~raw_ok)[0]]))
    _hold_against_oracle(pool, pm, rule, rmax, sample, res, counts)
    row = {"pgs": n, "positions": rmax, "e2e_s": e2e_s, "e2e_mappings_per_s": n / e2e_s,
           "fallback_lanes": fallback, "oracle_checked": int(len(sample))}
    print(f"[5] {name}, rule {rule} ({rmax} positions) on {smi}: {n / e2e_s:.0f} mappings/s end "
          f"to end ({e2e_s:.4f} s, median of 3); {fallback} oracle fallback lanes; "
          f"{len(sample)} PGs equal to the oracle")
    return row


def _variant_maps() -> dict:
    """Config 5's hierarchy with its hosts as legacy straw buckets, and
    with a one-position weight-set on every bucket (the mgr balancer's
    compat weight-set, seeded within ±25 % of the weights)."""
    from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW, ChooseArg
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    straw = build_hierarchy(10000, 40, 25, host_alg=CRUSH_BUCKET_STRAW)
    compat = build_hierarchy(10000, 40, 25)
    rng = np.random.default_rng(SEED + 5)
    compat.set_choose_args({
        bid: ChooseArg(weight_set=[[int(w * f) for w, f in zip(
            b.item_weights, rng.uniform(0.75, 1.25, b.size))]])
        for bid, b in compat.buckets.items()
    })
    return {"straw_hosts": straw, "compat_weight_set": compat}


# the card's instruction issue rate: one warp instruction a clock from
# each of the 4 schedulers of each of the H100 SXM's 132 SMs, 32 lanes,
# at its 1,980 MHz boost clock
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
# instructions a thread issues for one live column (cuobjdump -sass of
# the build, sm_90a): 214 of the loop body's 234 on the live path (the
# hash, crush_ln, the compare, the loads) and the 68 of the 64-bit
# division routine it calls
STRAW2_INSTR_PER_DRAW = 282


def _straw2_kernel_times(smi: str) -> dict:
    """The straw2 draw kernel at the remap cell's four draw levels, one
    2^19-lane chunk x 5 candidates each (the root as one shared row, the
    other levels through (N, 5) row tensors), equal to the plain draw on
    the card (its column gathers, ``_Lanes.draw`` and the item gather,
    as ``pick`` ran them before the kernel) and timed beside it with CUDA
    events; the bound is the live draws' instructions at the card's
    issue rate."""
    from ceph_tpu_torch.crush import torchmap as tm
    from ceph_tpu_torch.tools.timing import time_ms
    from perfbench import maps
    from perfbench.drivers import _program

    # the remap cell's map (perfbench/configs/osdmap_10k_straw2.json)
    cm = tm.compile_map(_program.crush_map(maps.hierarchy(10000, [4, 20, 2])))
    lanes = tm._Lanes(cm, torch.full((cm.max_devices,), 0x10000, device="cuda"))
    n, c = CRUSH_CHUNK, 5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randint(-(1 << 31), 1 << 31, (n, 1, 1), dtype=torch.int64, device="cuda",
                      generator=gen).to(torch.int32)
    r = torch.arange(c, dtype=torch.int32, device="cuda").view(1, c, 1)
    out = {}
    for level, btype in (("root", 4), ("rows", 3), ("racks", 2), ("hosts", 1)):
        of_type = np.nonzero(cm.np_types == btype)[0]
        szi = int(cm.np_sizes[of_type].max())
        if len(of_type) == 1:
            rows = int(of_type[0])
        else:
            pick = torch.randint(0, len(of_type), (n, c), device="cuda", generator=gen)
            rows = torch.from_numpy(of_type).cuda()[pick]

        def cols(t, at=rows):
            return t[at, :szi] if isinstance(rows, int) else t[:, :szi][at]

        def plain():
            col = lanes.draw(x, cols(cm.items32), cols(cm.wdiv), cols(cm.wlive), r)
            item = cols(cm.items).expand(n, c, szi).gather(-1, col)
            return col, item.squeeze(-1)

        def kernel():
            return tm.straw2_draw_kernel(cm, rows, x, r, None, szi, True)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"straw2 kernel != plain draw at the {level} level")
        if isinstance(rows, int):
            live = int(cm.wlive[rows, :szi].sum()) * n * c
        else:
            live = int(cm.wlive[:, :szi].sum(1)[rows].sum())
        row = {"lanes": n, "candidates": c, "width": szi, "draws": live,
               "kernel_ms": time_ms(kernel, iters=20),
               "plain_ms": time_ms(plain, iters=3, warmup=1),
               "bound_ms": live * STRAW2_INSTR_PER_DRAW / ISSUE_PER_S * 1e3}
        out[level] = row
        print(f"[5] straw2 kernel at the cell's {level} level ({n} x {c} x {szi}) on {smi}: "
              f"{json.dumps(row)}")
    return out


def phase_crush(smi: str, pool) -> dict:
    from ceph_tpu_torch.crush import torchmap as tm
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    t0 = time.perf_counter()
    tm.counts["crush_kernel_draws"] = 0
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
    rows["rule0"] = _crush_rule(pool, smi, pm, cm, 0, 3, CRUSH_PGS)
    rows["rule1"] = _crush_rule(pool, smi, pm, cm, 1, 11, CRUSH_PGS)
    variants = {}
    for name, vm in _variant_maps().items():
        variants[name] = {f"rule{r}": _crush_variant(pool, smi, name, vm, r, rmax)
                          for r, rmax in ((0, 3), (1, 11))}
    golden = _crush_golden()
    print(f"[5] golden vectors of the reference C: on cuda {golden['card']}, through the "
          f"oracle {golden['oracle']} (refused by the batched mapper, as by jaxmap: "
          f"{golden['refused']}), every line equal to the file")
    launches = tm.counts["crush_kernel_draws"]
    check(launches > 0, "the straw2 draw kernel was never launched")
    print(f"[5] straw2 draw kernel: {launches} launches over the phase")
    kernel = _straw2_kernel_times(smi)
    print(f"[5] CRUSH phase took {time.perf_counter() - t0:.1f} s")
    return {"card": smi.splitlines()[0],
            "map": {"osds": pm.max_devices, "hosts": hosts, "racks": racks, "buckets": cm.nb,
                    "table_bytes": table_bytes},
            **rows, "variants": variants, "golden": golden, "draw_launches": launches,
            "straw2_kernel": kernel}


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


OSDMAP_POOLS = ((1, "replicated", 3, 0, 1 << 20), (2, "erasure", 11, 1, 1 << 18))
# pool 3: lrc k=4 m=2 l=3 with rack locality (two chained choose steps)
OSDMAP_LRC = (3, {"k": "4", "m": "2", "l": "3", "crush-locality": "rack"}, 1 << 17)
OSDMAP_SAMPLE = 2048


def _scalar_rows(job):
    """Pool worker: the scalar pipeline's (up, up_primary, acting,
    acting_primary) of each PG, on a map decoded from its wire bytes."""
    from ceph_tpu_torch.osd import OSDMap

    blob, pid, pss = job
    om = OSDMap.decode(blob)
    return [om.pg_to_up_acting_osds(pid, int(ps)) for ps in pss]


def _hold_mapping(pool, om, mapping, touched: dict, epoch: int) -> dict:
    """mapping.get against the scalar pipeline on a seeded sample of
    each pool's PGs and every PG an override touches, in the pool of
    worker processes; returns the PGs checked a pool."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE

    def norm(v):
        v = list(v)
        while v and v[-1] == CRUSH_ITEM_NONE:
            v.pop()
        return v

    blob = om.encode()
    rng = np.random.default_rng(SEED + 70 + epoch)
    checked = {}
    for pid, p in om.pools.items():
        pss = np.unique(np.concatenate([rng.choice(p.pg_num, OSDMAP_SAMPLE, replace=False),
                                        np.array(sorted(touched.get(pid, ())), dtype=np.int64)]))
        jobs = [(blob, pid, part) for part in np.array_split(pss, 32)]
        want = [r for rows in pool.map(_scalar_rows, jobs, timeout=600) for r in rows]
        for ps, (up, upp, acting, actp) in zip(pss, want):
            gup, gupp, gact, gactp = mapping.get(pid, int(ps))
            check((norm(gup), gupp, norm(gact), gactp) == (norm(up), upp, norm(acting), actp),
                  f"epoch {epoch} pg {pid}.{ps}: {(gup, gupp, gact, gactp)} != scalar "
                  f"{(up, upp, acting, actp)}")
        checked[pid] = int(len(pss))
    return checked


def _timed_update(mapping, om) -> float:
    t0 = time.perf_counter()
    mapping.update(om)
    return time.perf_counter() - t0


def _epoch2(om, mapping) -> tuple:
    """The seeded incremental of epoch 2 (encoded and decoded), and the
    PGs each pool's overrides touch."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osd import Incremental

    rng = np.random.default_rng(SEED + 7)
    inc = om.new_incremental()
    osds = [int(o) for o in rng.permutation(om.max_osd)]
    for o in osds[:100]:
        inc.mark_down(o)
    for o in osds[100:200]:
        inc.mark_out(o)
    for o in osds[200:220]:
        inc.new_weight[o] = 0x8000
    for o in osds[220:320]:
        inc.new_primary_affinity[o] = 0
    for o in osds[320:420]:
        inc.new_primary_affinity[o] = 0x8000
    touched = collections.defaultdict(set)
    pools = list(om.pools.values())
    for kind, count in (("items", 1000), ("upmap", 100), ("temp", 500), ("ptemp", 100)):
        for i in range(count):
            p = pools[i % len(pools)]
            ps = int(rng.integers(p.pg_num))
            touched[p.pool_id].add(ps)
            up = [int(o) for o in mapping.up[p.pool_id][ps] if o != CRUSH_ITEM_NONE]
            pg = (p.pool_id, ps)
            if kind == "items":
                inc.new_pg_upmap_items[pg] = [(up[0], int(rng.integers(om.max_osd)))]
            elif kind == "upmap":
                inc.new_pg_upmap[pg] = [int(o) for o in
                                        rng.choice(om.max_osd, p.size, replace=False)]
            elif kind == "temp":
                inc.new_pg_temp[pg] = [int(o) for o in
                                       rng.choice(om.max_osd, p.size, replace=False)]
            else:
                inc.new_primary_temp[pg] = int(rng.integers(om.max_osd))
    wire = inc.encode()
    return Incremental.decode(wire), len(wire), touched


def _balancer(smi: str) -> dict:
    """calc_pg_upmaps on 1000 OSDs and 2^15 PGs of a size-3 pool (~98
    PG shards an OSD), each upmap checked against the scalar pipeline."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, PG_POOL_TYPE_REPLICATED
    from ceph_tpu_torch.osd import OSDMap, OSDMapMapping, PgPool
    from ceph_tpu_torch.osd.balancer import calc_pg_upmaps
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    om = OSDMap.build(build_hierarchy(1000, 10, 10), 1000)
    om.add_pool(PgPool(pool_id=1, type=PG_POOL_TYPE_REPLICATED, size=3, pg_num=1 << 15,
                       crush_rule=0))
    target = 3 * (1 << 15) / 1000

    def worst():
        m = OSDMapMapping()
        m.update(om)
        up = m.up[1]
        counts = np.bincount(up[up != CRUSH_ITEM_NONE], minlength=1000)
        return float(np.abs(counts - target).max()), int(counts.sum())

    before, total = worst()
    t0 = time.perf_counter()
    changed = calc_pg_upmaps(om, max_deviation=1, max_changes=100)
    seconds = time.perf_counter() - t0
    after, total_after = worst()
    check(changed > 0 and total_after == total and after < before,
          f"balancer: {changed} changes, deviation {before} -> {after}")
    for (pid, ps), items in om.pg_upmap_items.items():
        up = om.pg_to_up_acting_osds(pid, ps)[0]
        check(all(src not in up and dst in up for src, dst in items),
              f"balancer upmap {pid}.{ps} {items} against the scalar up {up}")
    print(f"[7] calc_pg_upmaps(max_deviation=1, max_changes=100) on 1000 OSDs, 2^15 PGs x 3 "
          f"on {smi}: {changed} changes in {seconds:.3f} s; largest |deviation| {before:.3f} "
          f"-> {after:.3f} PGs (target {target}); every upmap valid in the scalar pipeline")
    return {"changes": changed, "seconds": seconds, "max_abs_deviation_before": before,
            "max_abs_deviation_after": after, "target": target}


def phase_osdmap(smi: str, pool) -> dict:
    """The OSD map on the card: config 5's cluster, two epochs."""
    from ceph_tpu_torch.crush import torchmap as tm
    from ceph_tpu_torch.crush.types import PG_POOL_TYPE_ERASURE, PG_POOL_TYPE_REPLICATED
    from ceph_tpu_torch.ec import ErasureCodeProfile, registry_instance
    from ceph_tpu_torch.ops.kernel_stats import kernel_stats
    from ceph_tpu_torch.ops.profiler import breakdown, dispatch_profiler
    from ceph_tpu_torch.osd import OSDMap, OSDMapMapping, PgPool
    from ceph_tpu_torch.tools import osdmaptool
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    t0 = time.perf_counter()
    om = OSDMap.build(build_hierarchy(10000, 40, 25), 10000)
    for pid, kind, size, rule, pg_num in OSDMAP_POOLS:
        om.add_pool(PgPool(pool_id=pid, size=size, crush_rule=rule, pg_num=pg_num,
                           type=PG_POOL_TYPE_REPLICATED if kind == "replicated"
                           else PG_POOL_TYPE_ERASURE))
    lrc_id, lrc_profile, lrc_pgs = OSDMAP_LRC
    lrc = registry_instance().factory("lrc", ErasureCodeProfile(lrc_profile, device="cpu"))
    om.add_pool(PgPool(pool_id=lrc_id, size=lrc.get_chunk_count(), crush_rule=lrc.create_rule(
        "lrc", om.crush), pg_num=lrc_pgs, type=PG_POOL_TYPE_ERASURE))
    pgs = sum(p.pg_num for p in om.pools.values())
    mapping = OSDMapMapping()
    check(mapping.device.type == "cuda", f"OSDMapMapping on {mapping.device}")
    tm.counts["crush_oracle_lanes"] = 0
    warm_s = _timed_update(mapping, om)
    # a pool's CRUSH stage is timed by the kernel set's l_tpu_crush_lat
    perf0 = {**mapping.perf.dump(), **kernel_stats().dump()}
    prof0 = dispatch_profiler().totals()
    times = [_timed_update(mapping, om) for _ in range(3)]
    perf1 = {**mapping.perf.dump(), **kernel_stats().dump()}
    split = breakdown(prof0, dispatch_profiler().totals())
    fallback1 = tm.counts["crush_oracle_lanes"]
    e1 = sorted(times)[1]
    chained = (perf1["crush_chained_lanes"] - perf0["crush_chained_lanes"]) / 3
    host_route = perf1["crush_host_route_pgs"] - perf0["crush_host_route_pgs"]
    check(chained == 2 * lrc_pgs and host_route == 0,
          f"lrc pool: {chained} chained lanes an update (want {2 * lrc_pgs}), "
          f"{host_route} PGs on the host route")

    def avg(key, before, after):
        n = after[key]["avgcount"] - before[key]["avgcount"]
        return (after[key]["sum"] - before[key]["sum"]) / n

    for pid, p in om.pools.items():
        check(mapping.up[pid].shape == (p.pg_num, p.size) and mapping.up[pid].dtype == np.int64,
              f"pool {pid}: up {mapping.up[pid].shape} {mapping.up[pid].dtype}")
    epoch1 = {"warm_s": warm_s, "update_s": e1, "pg_mappings_per_s": pgs / e1,
              "crush_stage_avg_s": avg("l_tpu_crush_lat", perf0, perf1),
              "fixup_stages_avg_s": avg("fixup_stages", perf0, perf1),
              "fallback_lanes": fallback1, "chained_lanes": chained, "dispatch": split}
    print(f"[7] epoch 1 on {smi}: {pgs} PGs (pool 1 2^20 x 3 rule 0, pool 2 2^18 x 11 rule 1, "
          f"pool 3 2^17 x 8 lrc's two-step rule, {chained:.0f} chained lanes an update) "
          f"in {e1:.4f} s median of 3 = {pgs / e1:.0f} PG mappings/s end to end, numpy out "
          f"(first update {warm_s:.3f} s); a pool's crush_stage {epoch1['crush_stage_avg_s']:.4f}"
          f" s, fixup_stages {epoch1['fixup_stages_avg_s']:.4f} s on average; "
          f"{fallback1} oracle lanes in 4 updates")
    print(f"[7] epoch 1 dispatch profiler over 3 updates: {json.dumps(split)}")
    checked1 = _hold_mapping(pool, om, mapping, {}, 1)

    inc, wire_bytes, touched = _epoch2(om, mapping)
    om.apply_incremental(inc)
    tm.counts["crush_oracle_lanes"] = 0
    prof0 = dispatch_profiler().totals()
    e2 = _timed_update(mapping, om)
    perf2 = {**mapping.perf.dump(), **kernel_stats().dump()}
    split2 = breakdown(prof0, dispatch_profiler().totals())
    epoch2 = {"update_s": e2, "pg_mappings_per_s": pgs / e2, "incremental_bytes": wire_bytes,
              "crush_stage_avg_s": avg("l_tpu_crush_lat", perf1, perf2),
              "fixup_stages_avg_s": avg("fixup_stages", perf1, perf2),
              "fallback_lanes": tm.counts["crush_oracle_lanes"], "dispatch": split2,
              "touched_pgs": {pid: len(v) for pid, v in touched.items()}}
    print(f"[7] epoch 2 ({wire_bytes} B incremental: 100 down, 100 out, 20 at 0x8000, affinity 0 "
          f"and 0x8000 on 100 each, 1000 pg_upmap_items, 100 pg_upmap, 500 pg_temp, 100 "
          f"primary_temp): {e2:.4f} s = {pgs / e2:.0f} PG mappings/s; a pool's crush_stage "
          f"{epoch2['crush_stage_avg_s']:.4f} s, fixup_stages {epoch2['fixup_stages_avg_s']:.4f} "
          f"s; {tm.counts["crush_oracle_lanes"]} oracle lanes; dispatch compute {split2['compute_ms']} ms, "
          f"sync (the oracle lanes' read and re-map) {split2['sync_ms']} ms")
    checked2 = _hold_mapping(pool, om, mapping, touched, 2)

    blob = om.encode()
    again = OSDMapMapping()
    again.update(OSDMap.decode(blob))
    for pid in om.pools:
        for name in ("up", "up_primary", "acting", "acting_primary"):
            check(np.array_equal(getattr(again, name)[pid], getattr(mapping, name)[pid]),
                  f"decoded map: pool {pid} {name} differs")
    print(f"[7] scalar pipeline in the process pool: epoch 1 {checked1}, epoch 2 {checked2} PGs "
          f"a pool equal; the whole map's {len(blob)} B encoding, decoded, maps to equal arrays "
          f"on cuda")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = osdmaptool.main(["--test-map-pgs", "--build", "10000:40:25", "--pg-num", "1048576"])
    tool = out.getvalue().strip().splitlines()
    check(rc == 0 and "[torch]" in tool[0], f"osdmaptool: rc {rc}, {tool}")
    print(f"[7] osdmaptool: {tool[0]!r}; {tool[1].strip()!r}")
    balancer = _balancer(smi)
    phase_s = time.perf_counter() - t0
    print(f"[7] OSD-map phase took {phase_s:.1f} s")
    return {"card": smi.splitlines()[0], "osds": om.max_osd,
            "pools": [dict(zip(("pool", "type", "size", "rule", "pg_num"), p))
                      for p in OSDMAP_POOLS]
            + [{"pool": lrc_id, "type": "erasure", "size": lrc.get_chunk_count(),
                "profile": lrc_profile, "pg_num": lrc_pgs}],
            "epoch1": epoch1, "epoch2": epoch2, "checked": {"epoch1": checked1,
                                                            "epoch2": checked2},
            "encoded_bytes": len(blob), "osdmaptool": tool, "balancer": balancer,
            "phase_s": phase_s}


COMPILER_RULES = ((0, 3), (1, 11))
COMPILER_SAMPLE = 2048  # phase 5's spread sample
COMPARE_CHANGED = 100  # OSDs (1 % of config 5's 10 000) at half weight in --compare's second map


def _crushtool(argv: list) -> tuple[int, list]:
    """crushtool in process: (exit status, stdout lines)."""
    from ceph_tpu_torch.tools import crushtool

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = crushtool.main(argv)
    return rc, out.getvalue().splitlines()


@contextlib.contextmanager
def _kept_mappings():
    """While crushtool runs in process, keep each (res, counts, elapsed,
    backend, fallback) its ``_map_range`` returns, so a check holds the
    mappings the command itself made."""
    from ceph_tpu_torch.tools import crushtool

    kept, real = [], crushtool._map_range

    def keep(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]

    crushtool._map_range = keep
    try:
        yield kept
    finally:
        crushtool._map_range = real


def phase_compiler(smi: str, pool, crush: dict) -> dict:
    """Phase 15: CRUSH's compiler and crushtool -c/-d/-i/--compare on
    config 5's hierarchy, the mappings on the card."""
    from ceph_tpu_torch.crush import compiler
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    t_phase = time.perf_counter()
    work = pathlib.Path(__file__).resolve().parent / "build" / "p15"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        pm = build_hierarchy(10000, 40, 25)
        secs = {}
        t0 = time.perf_counter()
        text = compiler.decompile_crushmap(pm)
        secs["decompile"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = compiler.compile_crushmap(text)
        secs["compile"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        blob = compiler.encode_crushmap(compiled)
        secs["encode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = compiler.decode_crushmap(blob)
        secs["decode"] = time.perf_counter() - t0
        check(blob == compiler.encode_crushmap(pm), "compile(decompile(map)) encodes differently")
        check(compiler.decompile_crushmap(decoded) == text, "decode(encode) decompiles differently")
        src, binf, back = work / "map.txt", work / "map.bin", work / "back.txt"
        src.write_text(text)
        t0 = time.perf_counter()
        check(_crushtool(["-c", str(src), "-o", str(binf)])[0] == 0, "crushtool -c failed")
        check(_crushtool(["-d", str(binf), "-o", str(back)])[0] == 0, "crushtool -d failed")
        secs["cli_round_trip"] = time.perf_counter() - t0
        check(binf.read_bytes() == blob, "crushtool -c wrote other bytes")
        check(back.read_text() == text, "crushtool -c then -d gave other text")
        print(f"[15] build_hierarchy(10000, 40, 25): text {len(text)} B, binary {len(blob)} B; "
              f"decompile {secs['decompile']:.3f} s, compile {secs['compile']:.3f} s, encode "
              f"{secs['encode']:.3f} s, decode {secs['decode']:.3f} s; crushtool -c then -d "
              f"{secs['cli_round_trip']:.3f} s, the text equal")

        rules, tested = {}, {}
        xs = np.linspace(0, CRUSH_PGS - 1, COMPILER_SAMPLE).astype(np.int64)
        for rule, rmax in COMPILER_RULES:
            argv = ["-i", str(binf), "--test", "--max-x", str(CRUSH_PGS), "--rule", str(rule),
                    "--num-rep", str(rmax), "--backend", "torch", "--device", "cuda",
                    "--show-statistics", "--show-bad-mappings"]
            with _kept_mappings() as kept:
                rc, lines = _crushtool(argv)
            check(rc == 0 and lines[0].endswith("[torch]"), f"crushtool -i --test: {rc} {lines}")
            rate = float(lines[0].split(" = ")[1].split()[0])
            bad = int(lines[2].split(":")[1])
            check(bad == 0, f"rule {rule}: bad mappings {lines}")
            # the mappings -i --test made, held against the oracle
            check(len(kept) == 1, f"rule {rule}: crushtool mapped {len(kept)} times")
            res, counts, _el, backend, fallback = kept[0]
            check(backend == "torch", f"rule {rule}: mapped by {backend}")
            tested[rule] = res
            t0 = time.perf_counter()
            _hold_against_oracle(pool, compiler.decode_crushmap(blob), rule, rmax, xs, res, counts)
            oracle_s = time.perf_counter() - t0
            p5 = crush[f"rule{rule}"]["e2e_mappings_per_s"]
            rules[f"rule{rule}"] = {"mappings_per_s": rate, "phase5_mappings_per_s": p5,
                                    "fallback_lanes": fallback, "chi2_line": lines[3],
                                    "oracle_checked": int(len(xs)), "oracle_s": oracle_s}
            print(f"[15] crushtool -i map.bin --test rule {rule} on {smi.splitlines()[0]}: "
                  f"{rate:.0f} mappings/s (phase 5's batch_do_rule_range route {p5:.0f}); "
                  f"{lines[3]}; {fallback} oracle fallback lanes; {len(xs)} spread PGs equal "
                  f"to the oracle ({oracle_s:.1f} s in the pool)")

        changed = build_hierarchy(
            10000, 40, 25,
            weight_fn=lambda o: 0x8000 if o % (10000 // COMPARE_CHANGED) == 7 else 0x10000)
        bin2 = work / "map2.bin"
        bin2.write_bytes(compiler.encode_crushmap(changed))
        t0 = time.perf_counter()
        with _kept_mappings() as kept:
            rc, lines = _crushtool(["-i", str(binf), "--compare", str(bin2), "--max-x",
                                    str(CRUSH_PGS), "--rule", "0", "--num-rep", "3",
                                    "--backend", "torch", "--device", "cuda"])
        compare_s = time.perf_counter() - t0
        delta = int(lines[0].split(": ")[1].split("/")[0])
        moved = int(lines[1].split(": ")[1].split("/")[0])
        check(rc == 1 and lines[2] == "warning: maps are NOT equivalent" and 0 < moved < delta * 3,
              f"crushtool --compare: {rc} {lines}")
        # the first map's mappings --compare made equal those -i --test made
        # (held against the oracle above), the second map's held against
        # the oracle on the sample
        check(len(kept) == 2 and all(k[3] == "torch" for k in kept),
              f"--compare mapped {[k[3] for k in kept]}")
        check(np.array_equal(kept[0][0], tested[0]), "--compare's first map differs from --test's")
        res2, counts2 = kept[1][:2]
        _hold_against_oracle(pool, compiler.decode_crushmap(bin2.read_bytes()), 0, 3, xs,
                             res2, counts2)
        rc_same, same = _crushtool(["-i", str(binf), "--compare", str(binf), "--max-x", "65536",
                                    "--backend", "torch", "--device", "cuda"])
        check(rc_same == 0 and same[2] == "maps appear equivalent", f"--compare itself: {same}")
        print(f"[15] crushtool --compare against {COMPARE_CHANGED} OSDs (1 %) at half weight, rule "
              f"0 over 2^20 PGs on the card: {lines[0]!r}, {lines[1]!r}, exit 1, {compare_s:.2f} s "
              f"(both maps mapped); the second map's sample equal to the oracle; a map against "
              f"itself equivalent, exit 0")
        phase_s = time.perf_counter() - t_phase
        print(f"[15] compiler phase took {phase_s:.1f} s")
        return {"card": smi.splitlines()[0], "text_bytes": len(text), "binary_bytes": len(blob),
                "seconds": secs, **rules,
                "compare": {"lines": lines, "changed": delta, "moved": moved, "s": compare_s},
                "phase_s": phase_s}
    finally:
        shutil.rmtree(work, ignore_errors=True)


MESH_ENTRIES = 4  # the virtual mesh of a one-card host: cuda:0 four times


def _mesh_counters(before: dict) -> dict:
    from ceph_tpu_torch.ops.kernel_stats import kernel_stats

    after = kernel_stats().dump()
    return {k: after[k] - before.get(k, 0) for k in sorted(after)
            if k.startswith("l_tpu_mesh_") and isinstance(after[k], int)
            and after[k] != before.get(k, 0)}


def _mesh_run(label: str, dmesh, mat, host, big, pm, cm) -> dict:
    """Encode 1 GiB and a ragged 1023 stripes, both rules over 2^20
    PGs (twice: the second call replays recordings on every card) and
    the dryrun's step through ``dmesh``, each equal to the single-device
    route, with times beside it."""
    from ceph_tpu_torch.crush import torchmap as tm
    from ceph_tpu_torch.ops import bitplane_gf, packed_gf
    from ceph_tpu_torch.ops import mesh as meshmod
    from ceph_tpu_torch.ops.gf_matmul import gf_matrix_stripes, matrix_to_device_bitmatrix
    from ceph_tpu_torch.ops.kernel_stats import kernel_stats
    from ceph_tpu_torch.ops.residency import upload
    from ceph_tpu_torch.osd.sharded_mapping import sharded_batch_do_rule
    from ceph_tpu_torch.tools import mesh_dryrun

    out = {"mesh": [str(d) for d in dmesh.devices]}
    before = kernel_stats().dump()
    path = {"K1": 0, "K2": 0}

    def on_path(fn):
        """fn() with the launch counts set to 0 just before and read
        just after, added to the path's."""
        packed_gf.launches = bitplane_gf.launches = 0
        got = fn()
        path["K1"] += packed_gf.launches
        path["K2"] += bitplane_gf.launches
        return got

    bm = matrix_to_device_bitmatrix(mat, 8, dmesh.devices[0])
    single = gf_matrix_stripes(matrix_to_device_bitmatrix(mat, 8, "cuda:0"), big, w=8).cpu()
    for n in (1024, 1023):
        k2 = path["K2"]
        t0 = time.perf_counter()
        got = on_path(lambda: meshmod.sharded_matrix_stripes(bm, host[:n], 8, dmesh))
        sharded_s = time.perf_counter() - t0
        launched = path["K2"] - k2
        check(launched == dmesh.n, f"{label} B={n}: K2 launched {launched} times for {dmesh.n} shards")
        check(torch.equal(torch.from_numpy(got), single[:n]), f"{label} B={n}: sharded != single K2")
        del got
        out[f"encode_{n}"] = {"sharded_s": sharded_s, "k2_launches": launched}
    # the single-device route the same way (numpy in, numpy out), checked once; then
    # both routes timed in turns, median of 3 (each first call pays pinned allocations)
    bm0 = matrix_to_device_bitmatrix(mat, 8, "cuda:0")

    def one_device():
        return gf_matrix_stripes(bm0, upload(host, torch.device("cuda:0")).view(host.shape),
                                 w=8).cpu()

    check(torch.equal(one_device(), single), f"{label}: the single route differs")
    del single
    turns = {"sharded": [], "single": []}
    for _ in range(3):
        for name, fn in (("sharded", lambda: meshmod.sharded_matrix_stripes(bm, host, 8, dmesh)),
                         ("single", one_device)):
            t0 = time.perf_counter()
            fn()
            turns[name].append(time.perf_counter() - t0)
    out["encode_1024"].update({f"{k}_median_s": sorted(v)[1] for k, v in turns.items()})
    print(f"[16] {label}: 1024 stripes k=8 m=3 x 128 KiB (1 GiB) numpy in/out: sharded "
          f"{out['encode_1024']['sharded_median_s']:.3f} s, single device "
          f"{out['encode_1024']['single_median_s']:.3f} s (median of 3 in turns; the checked "
          f"first sharded call {out['encode_1024']['sharded_s']:.3f} s, 1023 stripes "
          f"{out['encode_1023']['sharded_s']:.3f} s); K2 once a shard, torch.equal to the "
          f"single-device K2")
    xs = np.arange(CRUSH_PGS)
    for rule, rmax in COMPILER_RULES:
        t0 = time.perf_counter()
        want = tm.batch_do_rule(cm, rule, xs, rmax)
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = on_path(lambda: sharded_batch_do_rule(pm, rule, xs, rmax, dmesh=dmesh))
        sharded_s = time.perf_counter() - t0
        # the second call records the fast path on each shard's card and replays it
        again = on_path(lambda: sharded_batch_do_rule(pm, rule, xs, rmax, dmesh=dmesh))
        check(all(np.array_equal(a, b) and np.array_equal(c, b)
                  for a, c, b in zip(got, again, want)),
              f"{label} rule {rule}: sharded placement != single device")
        out[f"rule{rule}"] = {"sharded_s": sharded_s, "single_s": single_s,
                              "sharded_mappings_per_s": CRUSH_PGS / sharded_s,
                              "single_mappings_per_s": CRUSH_PGS / single_s}
        print(f"[16] {label}: rule {rule} over 2^20 PGs sharded {CRUSH_PGS / sharded_s:.0f} "
              f"mappings/s ({sharded_s:.3f} s), single device {CRUSH_PGS / single_s:.0f} "
              f"({single_s:.3f} s), equal")
    t0 = time.perf_counter()
    dry = on_path(lambda: mesh_dryrun.step(dmesh))
    check(dry["errors"] == 0, f"{label}: the dryrun's decode had {dry['errors']} byte errors")
    out["dryrun"] = {"checksum": dry["checksum"], "errors": dry["errors"], "pgs": dry["pgs"],
                     "s": time.perf_counter() - t0}
    out["counters"] = _mesh_counters(before)
    out["launches"] = path
    print(f"[16] {label}: the dryrun's step (k=4 m=2 encode, checksum {dry['checksum']}, "
          f"erasures {{0, 1}} decoded with 0 errors, {dry['pgs']} PGs placed as the oracle); "
          f"per-device counters {json.dumps(out['counters'])}")
    return out


def phase_mesh(smi: str) -> dict:
    """Phase 16: the device mesh on the card."""
    from ceph_tpu_torch import gf
    from ceph_tpu_torch.crush import torchmap as tm
    from ceph_tpu_torch.ops import mesh as meshmod
    from ceph_tpu_torch.tools.crushtool import build_hierarchy

    t_phase = time.perf_counter()
    default = meshmod.default_mesh()
    cards = torch.cuda.device_count()
    check((default is None) == (cards == 1), f"default mesh {default} on {cards} cards")
    mat = gf.reed_sol_vandermonde_coding_matrix(8, 3, 8)
    big = random_u8((1024, 8, 128 << 10), SEED + 16)  # 1 GiB
    host = big.cpu().numpy()
    pm = build_hierarchy(10000, 40, 25)
    cm = tm.compile_map(pm)
    runs = {"virtual": _mesh_run(f"DeviceMesh(['cuda:0'] * {MESH_ENTRIES})",
                                 meshmod.DeviceMesh(["cuda:0"] * MESH_ENTRIES),
                                 mat, host, big, pm, cm)}
    if cards > 1:
        runs["cards"] = _mesh_run(f"DeviceMesh over {cards} cards", meshmod.build_mesh(),
                                  mat, host, big, pm, cm)
    launches = {key: sum(r["launches"][key] for r in runs.values()) for key in ("K1", "K2")}
    check(launches["K2"] > 0 and launches["K1"] == 0, f"mesh phase launches {launches}")
    del big, host
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[16] mesh phase took {phase_s:.1f} s; default mesh on {cards} card(s): {default}; "
          f"launches {launches}")
    return {"card": smi.splitlines()[0], "default_mesh": None if default is None
            else [str(d) for d in default.devices], "cards": cards, **runs,
            "launches": launches, "phase_s": phase_s}


WIRE_OBJECTS = 64  # a quarter of phase 6's PG (128 before PR 13), for the script's time budget
WIRE_OBJECT_BYTES = 4 << 20  # the RADOS default object size
WIRE_GRACE_S = 2.0  # osd_heartbeat_grace is 20 s; cut so detection waits 2
WIRE_PING_S = 0.25  # one heartbeat round every 0.25 s
WIRE_DEGRADED_SAMPLE = 32
WIRE_REPLAY_WRITES = 16
WIRE_LOST = 4  # the position whose shard server is stopped and replaced
WIRE_ROT = 6  # the position whose media rots out of band
WIRE_WAL = 0  # the position whose WAL crashes


class _CrcClock:
    """Host crc32c calls, bytes and thread-seconds by caller over a
    window: each module's ``ceph_crc32c`` (the name it bound at import)
    is swapped for a timed one and put back after."""

    def __init__(self, modules: dict):
        from ceph_tpu_torch import native

        self._orig = native.ceph_crc32c
        self._modules = modules
        self._lock = threading.Lock()
        self.acc = {label: [0, 0, 0.0] for label in modules}

    def _timed(self, label):
        orig, acc, lock = self._orig, self.acc[label], self._lock

        def timed(crc, data):
            t0 = time.perf_counter()
            out = orig(crc, data)
            dt = time.perf_counter() - t0
            with lock:
                acc[0] += 1
                acc[1] += len(data)
                acc[2] += dt
            return out

        return timed

    def __enter__(self):
        for label, mod in self._modules.items():
            mod.ceph_crc32c = self._timed(label)
        return self

    def __exit__(self, *exc):
        for mod in self._modules.values():
            mod.ceph_crc32c = self._orig
        return False

    def dump(self) -> dict:
        return {label: {"calls": c, "bytes": b, "thread_s": s}
                for label, (c, b, s) in self.acc.items()}


def _crc_modules() -> dict:
    from ceph_tpu_torch.ec import stripe
    from ceph_tpu_torch.msg import message
    from ceph_tpu_torch.store import blockstore, framed_log, wal_store

    return {"frame (msg)": message, "HashInfo (ec.stripe)": stripe, "WAL record": wal_store,
            "log frames (framed_log)": framed_log, "BlockStore blob": blockstore}


class _HostSampler:
    """Where the process's threads run, sampled every ``interval`` s from
    ``sys._current_frames()``: each thread's innermost frame by file and
    function; threads parked in a wait (a condition, a lock, a selector,
    a sleep) are counted apart as idle."""

    IDLE = {("threading.py", "wait"), ("threading.py", "_wait_for_tstate_lock"),
            ("selectors.py", "select"), ("queue.py", "get"), ("_base.py", "result"),
            ("chip_smoke.py", "_run")}

    def __init__(self, interval: float = 0.002):
        self.interval = interval
        self.busy = collections.Counter()
        self.idle = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.interval):
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                where = (os.path.basename(frame.f_code.co_filename), frame.f_code.co_name)
                if where in self.IDLE:
                    self.idle += 1
                else:
                    self.busy[f"{where[0]}:{where[1]}"] += 1

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(5)
        return False

    def top(self, n: int = 10) -> dict:
        total = sum(self.busy.values())
        return {"busy_samples": total, "idle_samples": self.idle,
                "top": {k: round(v / max(total, 1), 4) for k, v in self.busy.most_common(n)}}


class _ShardOSD:
    """One shard OSD: a Messenger on 127.0.0.1 with a ShardServer over a
    WALStore (device cuda) fronting a BlockStore, both under ``root``
    (the cluster launcher's ``--wal`` layout)."""

    def __init__(self, root: pathlib.Path, whoami: int):
        from ceph_tpu_torch.msg import Messenger
        from ceph_tpu_torch.store.remote import ShardServer

        self.root = root
        self.store = self.mount()
        self.server = ShardServer(store=self.store, whoami=whoami)
        self.msgr = Messenger(f"osd.{whoami}")
        self.msgr.add_dispatcher(self.server)
        self.addr = self.msgr.bind("127.0.0.1", 0)

    def mount(self):
        from ceph_tpu_torch.store import BlockStore, WALStore

        return WALStore(BlockStore(self.root / "block", sync=False), self.root / "wal",
                        device="cuda")

    def close(self) -> None:
        self.msgr.shutdown()
        if self.store._closed:
            self.store.inner.close()
        else:
            self.store.close()


def _ec_findings(maps: dict, names, acting: list, sinfo) -> list:
    """(object, position, errors) of every shard ``compare_ec`` flags."""
    from ceph_tpu_torch.osd.scrub import compare_ec

    out = []
    for name in names:
        rec, _ = compare_ec(name, {p: m[name] for p, m in maps.items()}, acting, sinfo, True)
        if rec is not None:
            out += [(name, sh["shard"], sh["errors"]) for sh in rec["shards"] if sh["errors"]]
    return out


def _deep_scrub(stores: dict, cid: str, names) -> dict:
    from ceph_tpu_torch.osd.scrub import build_scrub_map

    return {p: build_scrub_map(s, cid, names, deep=True, with_hinfo=True, device="cuda")
            for p, s in stores.items()}


def _rot(osd: _ShardOSD, cid: str, name: str, at: int) -> None:
    """Flip one bit of a shard's bytes in ``block.dev`` behind the
    store's back (no transaction: out-of-band bit rot)."""
    doff = osd.store.inner._onode(cid, name).blobs[0][2]
    with open(osd.root / "block" / "block.dev", "r+b") as f:
        f.seek(doff + at)
        byte = f.read(1)[0]
        f.seek(doff + at)
        f.write(bytes([byte ^ 0x10]))


def _heartbeat(remotes: list, osd: _ShardOSD, lost: int) -> tuple[float, int]:
    """Stop one shard server's messenger, then ping every shard each
    WIRE_PING_S until the tracker names it; returns (seconds to
    detection, ping rounds)."""
    from ceph_tpu_torch.msg import MessageError
    from ceph_tpu_torch.osd.failure import HeartbeatTracker

    tracker = HeartbeatTracker(whoami=-1, grace=WIRE_GRACE_S)

    def ping_round():
        for i, rs in enumerate(remotes):
            try:
                rs.ping(from_osd=-1, timeout=1.0)
                tracker.handle_ping(i, time.monotonic())
            except MessageError:
                pass

    now = time.monotonic()
    for i in range(len(remotes)):
        tracker.add_peer(i, now)
    ping_round()
    check(tracker.failures(time.monotonic()) == [], "a shard failed before any was stopped")
    stopped = time.monotonic()
    osd.msgr.shutdown()
    rounds = 0
    while True:
        ping_round()
        rounds += 1
        failed = [f[0] for f in tracker.failures(time.monotonic())]
        if failed:
            break
        check(time.monotonic() - stopped < 10 * WIRE_GRACE_S, "the stopped shard was not detected")
        time.sleep(WIRE_PING_S)
    check(failed == [lost], f"heartbeats named {failed}, not {lost}")
    return time.monotonic() - stopped, rounds


def _mark_down(lost: int, n: int) -> int:
    """Two reporters' failure reports mark the shard down in an OSD map
    of the PG's n OSDs; returns the new epoch."""
    from ceph_tpu_torch.crush.builder import CrushMap
    from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2
    from ceph_tpu_torch.osd import OSDMap
    from ceph_tpu_torch.osd.failure import FailureAggregator

    cmap = CrushMap()
    cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, list(range(n)), [0x10000] * n, name="host0")
    om = OSDMap.build(cmap, n)
    agg = FailureAggregator(om, min_reporters=2)
    check(not agg.report_failure(lost, 0, time.monotonic()), "one reporter marked it down")
    check(agg.report_failure(lost, 1, time.monotonic()) and om.is_down(lost),
          "two reporters did not mark it down")
    return om.epoch


def _replay(osd: _ShardOSD, ecs, rng, model: dict) -> dict:
    """Crash one shard's WAL with small RMW shard writes committed but
    not applied, remount, and time the replay's crc verify."""
    from ceph_tpu_torch.common.encoding import Decoder
    from ceph_tpu_torch.ops import scrub_kernels as sk
    from ceph_tpu_torch.ops.kernel_stats import kernel_stats
    from ceph_tpu_torch.store.framed_log import replay_frames
    from ceph_tpu_torch.store.wal_store import decode_wal_record
    from ceph_tpu_torch.tools.timing import time_ms

    wal = osd.store
    wal.drain_paused = True
    names = [str(n) for n in rng.choice(sorted(model), WIRE_REPLAY_WRITES, replace=False)]
    for name in names:
        off = int(rng.integers(0, WIRE_OBJECT_BYTES - 4096))
        data = rng.bytes(4096)
        ecs.write(name, off, data)
        b = bytearray(model[name])
        b[off : off + 4096] = data
        model[name] = bytes(b)
    unapplied = len(wal._pending)
    check(unapplied == WIRE_REPLAY_WRITES, f"{unapplied} unapplied records, not "
          f"{WIRE_REPLAY_WRITES}")
    # dropped without close or flush, as if the process died here; the
    # writer thread is woken so it exits instead of waiting forever
    with wal._wal_cv:
        wal._closed = True
        wal._wal_cv.notify_all()
    wal.inner.close()
    payloads = [decode_wal_record(Decoder(body)).payload
                for body, _end in replay_frames((osd.root / "wal" / "wal.log").read_bytes())]
    ks = kernel_stats()
    calls0 = ks.dump().get("l_tpu_scrub_crc32c_calls", 0)
    t0 = time.perf_counter()
    osd.store = osd.mount()
    osd.server.store = osd.store
    mount_s = time.perf_counter() - t0
    calls = ks.dump().get("l_tpu_scrub_crc32c_calls", 0) - calls0
    check(osd.store.replayed_records == unapplied,
          f"replayed {osd.store.replayed_records} of {unapplied} unapplied records")
    check(calls >= 1, "the replay verify made no device crc call")
    total = sum(map(len, payloads))
    crc_ms = time_ms(lambda: sk.batch_crc32c(payloads, device="cuda"), iters=5)
    return {"unapplied": unapplied, "replayed_records": osd.store.replayed_records,
            "log_records": len(payloads), "log_record_bytes": total, "mount_s": mount_s,
            "mount_ms": mount_s * 1e3, "crc32c_calls": calls, "crc_call_ms": crc_ms,
            "crc_bound_ms": total / HBM_BYTES_PER_S * 1e3, "written": names}


def _shard_daemon(client) -> dict:
    """``python -m ceph_tpu_torch.store.remote --port 0``: ready line,
    one transaction, a read and a ping, then killed."""
    from ceph_tpu_torch.store import Transaction
    from ceph_tpu_torch.store.remote import RemoteStore

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "ceph_tpu_torch.store.remote", "--port", "0",
                             "--osd-id", "99"], stdout=subprocess.PIPE, text=True,
                            cwd=pathlib.Path(__file__).resolve().parent)
    try:
        line = proc.stdout.readline().strip()
        ready_s = time.perf_counter() - t0
        check(line.startswith("shard_daemon ready "), f"shard daemon said {line!r}")
        host, port = line.rsplit(" ", 1)[1].split(":")
        rs = RemoteStore(client.connect(host, int(port)))
        payload = bytes(range(256)) * 64
        rs.queue_transaction(Transaction().create_collection("pg_9.0")
                             .write("pg_9.0", "o", 0, payload))
        check(rs.read("pg_9.0", "o") == payload, "shard daemon read back other bytes")
        rtt = rs.ping(from_osd=-1)
        rs.conn.close()
    finally:
        proc.kill()
        proc.wait(30)
    return {"ready_line": line, "ready_s": ready_s, "ping_rtt_s": rtt}


def _sum_wal_perf(stores) -> dict:
    out: dict = {}
    for s in stores:
        for key, val in s.wal_perf.dump().items():
            if isinstance(val, dict):
                acc = out.setdefault(key, {k: 0 for k in val})
                for k, v in val.items():
                    acc[k] += v
            else:
                out[key] = out.get(key, 0) + val
    return out


def phase_wire(smi: str) -> dict:
    """The EC sub-op wire and the durable stores: one PG over the
    messenger, on WAL-fronted BlockStore media."""
    from ceph_tpu_torch.msg import Messenger, NetworkStack, stack_perf_dump
    from ceph_tpu_torch.ops import bitplane_gf, packed_gf
    from ceph_tpu_torch.ops.kernel_stats import kernel_stats
    from ceph_tpu_torch.store import ECStore, Transaction
    from ceph_tpu_torch.store.remote import RemoteStore

    rng = np.random.default_rng(SEED + 8)
    block = rng.bytes(WIRE_OBJECTS * WIRE_OBJECT_BYTES)
    datas = {f"obj{i:03d}": block[i * WIRE_OBJECT_BYTES : (i + 1) * WIRE_OBJECT_BYTES]
             for i in range(WIRE_OBJECTS)}
    del block
    names = list(datas)
    logical = WIRE_OBJECTS * WIRE_OBJECT_BYTES
    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = pathlib.Path(tempfile.mkdtemp(prefix="wire-", dir=build))
    free = shutil.disk_usage(root)
    print(f"[8] media under {root}: {free.free} B free of {free.total}")
    osds, fresh, client = [], None, None
    ks = kernel_stats()
    try:
        osds = [_ShardOSD(root / f"osd.{i}", i) for i in range(11)]
        client = Messenger("client")
        remotes = [RemoteStore(client.connect(*o.addr)) for o in osds]
        exists_calls = collections.Counter()

        def counted(fn, pos):
            def exists(cid, oid):
                exists_calls[pos] += 1
                return fn(cid, oid)

            return exists

        for pos, rs in enumerate(remotes):
            rs.exists = counted(rs.exists, pos)
        ecs = ECStore(plugin="isa", profile={"k": "8", "m": "3", "device": "cuda"},
                      stores=list(remotes))
        check(ecs.n == 11 and ecs.sinfo.stripe_width == 8 * 4096,
              f"isa k=8 m=3 at stripe unit 4096: n={ecs.n} width={ecs.sinfo.stripe_width}")
        acting = list(range(ecs.n))
        packed_gf.launches = 0
        bitplane_gf.launches = 0
        crc_calls0 = ks.dump().get("l_tpu_scrub_crc32c_calls", 0)
        t_phase = time.perf_counter()

        # 1. put, then read every acknowledged object back
        with _CrcClock(_crc_modules()) as clock, _HostSampler() as put_where:
            t0 = time.perf_counter()
            for name in names:
                ecs.put(name, datas[name])
            torch.cuda.synchronize()
            put_s = time.perf_counter() - t0
        put_crc = clock.dump()
        put_exists = sum(exists_calls.values())
        shard_len = osds[0].store.stat(ecs.cid, names[0])
        shard_bytes = WIRE_OBJECTS * ecs.n * shard_len
        t0 = time.perf_counter()
        for name in names:
            check(ecs.get(name) == datas[name], f"get of {name} after put")
        get_s = time.perf_counter() - t0
        print(f"[8] put {WIRE_OBJECTS} objects of {WIRE_OBJECT_BYTES} B (isa k=8 m=3, "
              f"{shard_bytes} B of shards through 11 messengers onto WAL+BlockStore media) in "
              f"{put_s:.3f} s, {put_exists} exists round trips; every object read back "
              f"byte-equal in {get_s:.3f} s")
        print("[8] host crc32c during put (thread-seconds): " + ", ".join(
            f"{k} {v['thread_s']:.3f} s / {v['bytes']} B" for k, v in put_crc.items()))
        print(f"[8] put, threads sampled every 2 ms: {json.dumps(put_where.top())}")

        # 2. deep scrub from media, then out-of-band rot
        for o in osds:
            check(o.store.flush(), "a WAL did not drain")
        t0 = time.perf_counter()
        maps = _deep_scrub({p: o.store for p, o in enumerate(osds)}, ecs.cid, names)
        torch.cuda.synchronize()
        scrub_s = time.perf_counter() - t0
        findings = _ec_findings(maps, names, acting, ecs.sinfo)
        check(not findings, f"deep scrub of a clean PG: {findings[:5]}")
        victim = names[int(rng.integers(0, len(names) - 1))]
        _rot(osds[WIRE_ROT], ecs.cid, victim, at=int(rng.integers(0, 4096)))
        t0 = time.perf_counter()
        rotted = _deep_scrub({p: o.store for p, o in enumerate(osds)}, ecs.cid, names)
        rescrub_s = time.perf_counter() - t0
        findings = _ec_findings(rotted, names, acting, ecs.sinfo)
        check(findings == [(victim, WIRE_ROT, ["read_error"])],
              f"scrub after rotting ({victim}, {WIRE_ROT}) flagged {findings}")
        ecs.recover_shard(victim, WIRE_ROT)
        again = _deep_scrub({WIRE_ROT: osds[WIRE_ROT].store}, ecs.cid, [victim])
        check(again[WIRE_ROT][victim]["data_digest"] == maps[WIRE_ROT][victim]["data_digest"],
              "the repaired shard's digest")
        print(f"[8] deep scrub of the media on cuda: {len(names) * ecs.n} shards clean in "
              f"{scrub_s:.3f} s; one bit of ({victim}, shard {WIRE_ROT}) flipped in its "
              f"block.dev: the next scrub ({rescrub_s:.3f} s) flagged exactly that pair "
              f"(read_error), recover_shard rewrote it to its first digest")

        # 3. failure detection
        detect_s, rounds = _heartbeat(remotes, osds[WIRE_LOST], WIRE_LOST)
        epoch = _mark_down(WIRE_LOST, ecs.n)
        print(f"[8] shard {WIRE_LOST}'s messenger stopped: heartbeats (grace {WIRE_GRACE_S} s, "
              f"a round every {WIRE_PING_S} s) named it after {detect_s:.3f} s ({rounds} rounds);"
              f" two reporters marked it down (epoch {epoch})")

        # 4. degraded get
        sample = [str(n) for n in rng.choice(names, WIRE_DEGRADED_SAMPLE, replace=False)]
        t0 = time.perf_counter()
        for name in sample:
            check(ecs.get(name) == datas[name], f"degraded get of {name}")
        degraded_s = time.perf_counter() - t0
        print(f"[8] degraded get of {len(sample)} objects with shard {WIRE_LOST} down: "
              f"byte-equal in {degraded_s:.3f} s")

        # 5. recovery onto fresh media
        fresh = _ShardOSD(root / "osd.11", 11)
        rs = RemoteStore(client.connect(*fresh.addr))
        rs.queue_transaction(Transaction().create_collection(ecs.cid))
        ecs.stores[WIRE_LOST] = rs
        remotes[WIRE_LOST] = rs
        with _HostSampler() as recover_where:
            t0 = time.perf_counter()
            stats = ecs.recover_objects_batch(names, WIRE_LOST)
            torch.cuda.synchronize()
            recover_s = time.perf_counter() - t0
        check(stats["batched"] == len(names) and stats["objects"] == len(names),
              f"recover_objects_batch: {stats}")
        live = {p: o.store for p, o in enumerate(osds)}
        live[WIRE_LOST] = fresh.store
        t0 = time.perf_counter()
        maps2 = _deep_scrub(live, ecs.cid, names)
        scrub2_s = time.perf_counter() - t0
        for name in names:
            check(maps2[WIRE_LOST][name]["data_digest"] == maps[WIRE_LOST][name]["data_digest"],
                  f"rebuilt shard {WIRE_LOST} of {name}")
        findings = _ec_findings(maps2, names, acting, ecs.sinfo)
        check(not findings, f"scrub after recovery: {findings[:5]}")
        print(f"[8] recover_objects_batch onto a fresh shard server: {stats['objects']} shards "
              f"rebuilt in {recover_s:.3f} s, each equal to its first-scrub crc; re-scrub "
              f"clean in {scrub2_s:.3f} s")
        print(f"[8] recovery, threads sampled every 2 ms: {json.dumps(recover_where.top())}")

        # 6. WAL crash and replay
        model = dict(datas)
        del datas
        replay = _replay(osds[WIRE_WAL], ecs, rng, model)
        t0 = time.perf_counter()
        for name in names:
            check(ecs.get(name) == model[name], f"get of {name} after the WAL replay")
        get2_s = time.perf_counter() - t0
        print(f"[8] shard {WIRE_WAL}'s WAL dropped with {replay['unapplied']} RMW shard writes "
              f"acked but unapplied; remount replayed {replay['replayed_records']} in "
              f"{replay['mount_ms']:.1f} ms ({replay['crc32c_calls']} device crc call over "
              f"{replay['log_records']} records, {replay['log_record_bytes']} B: "
              f"{replay['crc_call_ms']:.3f} ms by CUDA events, byte bound "
              f"{replay['crc_bound_ms']:.5f} ms); every object read back byte-equal in "
              f"{get2_s:.3f} s")

        # 7. the shard daemon process
        daemon = _shard_daemon(client)
        print(f"[8] python -m ceph_tpu_torch.store.remote: {daemon['ready_line']!r} after "
              f"{daemon['ready_s']:.2f} s; one transaction, a read and a ping "
              f"({daemon['ping_rtt_s'] * 1e3:.2f} ms); killed")

        phase_s = time.perf_counter() - t_phase
        counts = {"K1": packed_gf.launches, "K2": bitplane_gf.launches}
        crc_calls = ks.dump().get("l_tpu_scrub_crc32c_calls", 0) - crc_calls0
        check(counts["K1"] > 0 and counts["K2"] > 0, f"a kernel was not launched: {counts}")
        msgr = {k: v for k, v in stack_perf_dump().items()
                if not re.match(r"l_msgr_worker\d", k)}
        wal_perf = _sum_wal_perf([o.store for o in osds] + [fresh.store])
        gbps = {
            "put_GBps": logical / put_s / 1e9,
            "get_GBps": logical / get_s / 1e9,
            "scrub_GBps": shard_bytes / scrub_s / 1e9,
            "recover_GBps": WIRE_OBJECTS * shard_len / recover_s / 1e9,
            "get_degraded_GBps": len(sample) * WIRE_OBJECT_BYTES / degraded_s / 1e9,
        }
        print(f"[8] wire phase took {phase_s:.1f} s; launches {counts}; device crc calls "
              f"{crc_calls}")
        print(f"[8] on {smi.splitlines()[0]} (host clock): "
              + ", ".join(f"{k} {v:.3f}" for k, v in gbps.items()))
        print(f"[8] messenger: {json.dumps(msgr)}")
        result = {
            "card": smi.splitlines()[0],
            "config": {"plugin": "isa", "k": 8, "m": 3, "stripe_unit": 4096,
                       "objects": WIRE_OBJECTS, "object_bytes": WIRE_OBJECT_BYTES,
                       "shard_servers": 11, "store": "WALStore(BlockStore, sync=False)",
                       "heartbeat_grace_s": WIRE_GRACE_S, "ping_interval_s": WIRE_PING_S},
            **gbps,
            "seconds": {"put": put_s, "get": get_s, "scrub": scrub_s, "rescrub": rescrub_s,
                        "degraded_get": degraded_s, "recover": recover_s,
                        "scrub_after_recovery": scrub2_s, "get_after_replay": get2_s,
                        "phase": phase_s},
            "shard_bytes": shard_bytes, "exists_round_trips_in_put": put_exists,
            "put_host_crc32c": put_crc, "put_threads": put_where.top(),
            "recover_threads": recover_where.top(), "detect_s": detect_s, "ping_rounds": rounds,
            "replay": {k: v for k, v in replay.items() if k != "written"},
            "shard_daemon": daemon, "recover_stats": stats,
            "msgr": msgr, "wal": wal_perf, "launches": counts, "device_crc32c_calls": crc_calls,
        }
    finally:
        if client is not None:
            client.shutdown()
        for o in osds + ([fresh] if fresh is not None else []):
            o.close()
        shutil.rmtree(root, ignore_errors=True)
    check(NetworkStack.live() is None, "a messenger reactor outlived the phase")
    return result


CLUSTER_OSDS = 12  # isa k=8 m=3 takes 11 positions; the 12th is the recovery target
CLUSTER_PG_NUM = 16
# on an NVIDIA H100 80GB HBM3 at 700 W: 256 took 350 s after phases 1-8
# (177 s alone); 128 took 115 s, and the script ran past 650 s once
# phases 11 and 12 joined it
CLUSTER_OBJECTS = 64
CLUSTER_OBJECT_BYTES = 4 << 20  # the RADOS default object size
CLUSTER_REP_OBJECTS = 64
CLUSTER_CLIENTS = 2  # each Rados runs 4 aio workers: 8 ops in flight
CLUSTER_BURST = 8  # writes queued behind one stalled primary
CLUSTER_OP_TIMEOUT_S = 60.0  # librados' rados_osd_op_timeout is 0 (no limit); the objecter's 15
CLUSTER_RMW = 16
CLUSTER_DEGRADED_SAMPLE = 32
CLUSTER_DEGRADED_WRITES = 8
CLUSTER_TICK_S = 0.5  # the OSD tick: one heartbeat round every 0.5 s
CLUSTER_HB_GRACE_S = 20.0  # osd_heartbeat_grace
CLUSTER_MAX_BACKFILLS = 8  # osd_max_backfills, raised from 2 as operators do to speed recovery
CLUSTER_GRACE_S = 2.0  # cut from 20 s for the detection step only
CLUSTER_LOST = 5  # the OSD whose messenger is stopped
CLUSTER_WAIT_S = 300.0


def _aio(clients, calls) -> list:
    """Run (pool, method, args) calls spread over every client's aio
    workers; each must be acknowledged with success."""
    futs = []
    for i, (pool, method, args) in enumerate(calls):
        io = clients[i % len(clients)].open_ioctx(pool)
        futs.append(io.rados._pool.submit(getattr(io, method), *args))
    return [f.result(timeout=CLUSTER_WAIT_S) for f in futs]


def _cluster_map(n: int):
    from ceph_tpu_torch.crush.builder import CrushMap
    from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables
    from ceph_tpu_torch.osd.osdmap import OSDMap

    cmap = CrushMap(tunables=Tunables())
    hosts = [cmap.add_bucket(CRUSH_BUCKET_STRAW2, 1, [h], [0x10000], name=f"host{h}")
             for h in range(n)]
    cmap.add_bucket(CRUSH_BUCKET_STRAW2, 3, hosts, [cmap.buckets[b].weight for b in hosts],
                    name="default")
    cmap.add_simple_rule("rep", "default", "host", mode="firstn")
    return OSDMap.build(cmap, n)


class _Cluster:
    """A port monitor on its own messenger, ``n`` OSD daemons on
    ``device`` over MemStore, and ``clients`` librados handles, all in
    this process."""

    def __init__(self, n: int, device: str, clients: int):
        from ceph_tpu_torch.mon.monitor import Monitor
        from ceph_tpu_torch.msg import Messenger
        from ceph_tpu_torch.osd.daemon import OSD
        from ceph_tpu_torch.rados import Rados

        self.mon = Monitor(_cluster_map(n), min_reporters=2)
        self.mon_msgr = Messenger("mon")
        self.mon_msgr.add_dispatcher(self.mon)
        self.mon_addr = self.mon_msgr.bind()
        self.osds, self.stopped, self.clients = {}, {}, []
        for i in range(n):
            osd = OSD(i, tick_interval=CLUSTER_TICK_S, heartbeat_grace=CLUSTER_HB_GRACE_S,
                      max_backfills=CLUSTER_MAX_BACKFILLS, device=device)
            osd.boot(*self.mon_addr)
            self.osds[i] = osd
        self.clients = [Rados(f"smoke.{c}").connect(*self.mon_addr) for c in range(clients)]
        for r in self.clients:
            r.objecter.op_timeout = CLUSTER_OP_TIMEOUT_S
        self.rados = self.clients[0]
        self.pools: dict[str, int] = {}

    def pg_states(self) -> dict:
        out = {}
        for osd in list(self.osds.values()):
            for st in osd.collect_pg_stats():
                out[st["pgid"]] = st["state"]
        return out

    def clean(self) -> bool:
        want = {f"{p}.{ps}" for p in self.pools.values() for ps in range(CLUSTER_PG_NUM)}
        states = self.pg_states()
        return set(states) == want and all(v == "active+clean" for v in states.values())

    def wait(self, cond, what: str, timeout: float = CLUSTER_WAIT_S) -> float:
        from ceph_tpu_torch.msg.messenger import wait_for

        t0 = time.perf_counter()
        if not wait_for(cond, timeout, 0.05):
            print(f"[9] {what}: pg states {self.pg_states()}", file=sys.stderr)
            check(False, what)
        return time.perf_counter() - t0

    def pgid_of(self, pool: str, name: str) -> str:
        from ceph_tpu_torch.osdc.objecter import object_to_pg

        return object_to_pg(self.rados.monc.osdmap.pools[self.pools[pool]], name)

    def acting(self, pgid: str) -> tuple[list, int]:
        pool_id, ps = (int(x) for x in pgid.split("."))
        _u, _p, acting, primary = self.rados.monc.osdmap.pg_to_up_acting_osds(pool_id, ps)
        return list(acting), primary

    def aio(self, calls) -> list:
        return _aio(self.clients, calls)

    def shutdown(self) -> None:
        for r in self.clients:
            r.shutdown()
        for osd in self.osds.values():
            osd.shutdown()
        self.mon_msgr.shutdown()


def _cluster_scrub(c: _Cluster, pgid: str) -> tuple[list, float]:
    """Order a deep scrub of ``pgid`` through its primary and wait for
    it; returns the primary's findings and the seconds it took."""
    _acting, primary = c.acting(pgid)
    pg = c.osds[primary].pgs[pgid]
    stamp = pg.last_deep_scrub
    t0 = time.perf_counter()
    check("deep-scrub" in c.rados.pg_scrub(pgid, deep=True), f"pg {pgid} refused a deep scrub")
    c.wait(lambda: pg.last_deep_scrub != stamp, f"pg {pgid}'s deep scrub never finished")
    return list(pg.scrub_errors), time.perf_counter() - t0


def phase_cluster(smi: str, device: str = "cuda", objects: int = CLUSTER_OBJECTS,
                  object_bytes: int = CLUSTER_OBJECT_BYTES,
                  rep_objects: int = CLUSTER_REP_OBJECTS) -> dict:
    """The cluster on the card: a monitor, 12 OSD daemons on ``device``
    and librados clients, through the system's own write path."""
    from ceph_tpu_torch.msg import NetworkStack
    from ceph_tpu_torch.ops import bitplane_gf, packed_gf
    from ceph_tpu_torch.ops.kernel_stats import kernel_stats
    from ceph_tpu_torch.osd.daemon import OBJ_PREFIX, OSD
    from ceph_tpu_torch.store import Transaction

    rng = np.random.default_rng(SEED + 9)
    block = rng.bytes(objects * object_bytes)
    model = {f"obj{i:03d}": block[i * object_bytes:(i + 1) * object_bytes]
             for i in range(objects)}
    del block
    rep_model = {f"rep{i:02d}": rng.bytes(object_bytes) for i in range(rep_objects)}
    logical = objects * object_bytes
    ks = kernel_stats()
    c = _Cluster(CLUSTER_OSDS, device, CLUSTER_CLIENTS)
    try:
        rc, _b, outs = c.rados.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "isa83",
            "profile": ["plugin=isa", "k=8", "m=3"]})
        check(rc == 0, f"erasure-code-profile set: {outs}")
        c.pools["ec"] = c.rados.pool_create("ecpool", pool_type=3, pg_num=CLUSTER_PG_NUM,
                                            erasure_code_profile="isa83")
        c.pools["rep"] = c.rados.pool_create("reppool", pg_num=CLUSTER_PG_NUM, size=3)
        pool = c.rados.monc.osdmap.pools[c.pools["ec"]]
        check(pool.size == 11 and pool.min_size == 9, f"EC pool size {pool.size}/{pool.min_size}")
        boot_s = c.wait(c.clean, "the pools never went active+clean")
        print(f"[9] monitor + {CLUSTER_OSDS} OSDs (device={device}) + {CLUSTER_CLIENTS} clients; "
              f"isa k=8 m=3 pool and a 3-replica pool, pg_num {CLUSTER_PG_NUM} each, "
              f"active+clean {boot_s:.2f} s after creation")
        packed_gf.launches = 0
        bitplane_gf.launches = 0
        k0 = ks.dump()
        t_phase = time.perf_counter()

        # 1. put: a burst queued behind one stalled primary (write
        # coalescing must fire), the rest from every client at once
        names = list(model)
        first = c.acting(c.pgid_of("ec", names[0]))[1]
        burst = [n for n in names if c.acting(c.pgid_of("ec", n))[1] == first][:CLUSTER_BURST]
        rest = [n for n in names if n not in set(burst)]
        stalled = c.osds[first]
        held, gate = threading.Event(), threading.Event()

        def hold():
            held.set()
            return gate.wait(60)

        stalled._workq.put(("splitcall", hold, concurrent.futures.Future()))
        c.wait(held.is_set, f"osd.{first}'s worker never took the stall", 60)
        base = stalled._workq.qlen()
        t0 = time.perf_counter()
        futs = []
        for i, n in enumerate(burst):
            io = c.clients[i % len(c.clients)].open_ioctx("ecpool")
            futs.append(io.aio_write_full(n, model[n]))
        c.wait(lambda: stalled._workq.qlen() >= base + len(burst), "the burst never queued", 60)
        gate.set()
        c.aio([("ecpool", "write_full", (n, model[n])) for n in rest])
        for f in futs:
            f.result(timeout=CLUSTER_WAIT_S)
        put_s = time.perf_counter() - t0
        perf_after_put = json.loads(c.rados.mon_command({"prefix": "osd perf"})[1] or "{}")
        k1 = ks.dump()
        dispatches = k1.get("l_tpu_batch_encode_dispatches", 0) - k0.get(
            "l_tpu_batch_encode_dispatches", 0)
        batch_ops = k1.get("l_tpu_batch_encode_ops_per_dispatch", 0) - k0.get(
            "l_tpu_batch_encode_ops_per_dispatch", 0)
        check(dispatches >= 1 and batch_ops > dispatches,
              f"write coalescing never fired: {dispatches} dispatches, {batch_ops} ops")
        t0 = time.perf_counter()
        got = c.aio([("ecpool", "read", (n,)) for n in names])
        get_s = time.perf_counter() - t0
        for n, data in zip(names, got):
            check(data == model[n], f"read back {n}")
        t0 = time.perf_counter()
        c.aio([("reppool", "write_full", (n, d)) for n, d in rep_model.items()])
        rep_put_s = time.perf_counter() - t0
        for n, data in zip(rep_model, c.aio([("reppool", "read", (n,)) for n in rep_model])):
            check(data == rep_model[n], f"read back {n} (replicated)")
        print(f"[9] put {objects} objects of {object_bytes} B through librados in {put_s:.3f} s "
              f"({len(burst)} queued behind stalled osd.{first}); {dispatches} coalesced encode "
              f"dispatches carried {batch_ops} ops; every object read back byte-equal in "
              f"{get_s:.3f} s; {rep_objects} objects into the 3-replica pool in "
              f"{rep_put_s:.3f} s, read back")

        # 2. RMW partial overwrites at stripe offsets
        sw = 8 * 4096
        rmw = [str(n) for n in rng.choice(names, CLUSTER_RMW, replace=False)]
        t0 = time.perf_counter()
        for j, n in enumerate(rmw):
            off = sw * (1 + j % max(1, object_bytes // sw - 2))
            patch = rng.bytes(2 * 4096 + 100)
            c.rados.open_ioctx("ecpool").write(n, patch, off)
            buf = bytearray(model[n])
            buf[off:off + len(patch)] = patch
            model[n] = bytes(buf)
        rmw_s = time.perf_counter() - t0
        for n, data in zip(rmw, c.aio([("ecpool", "read", (n,)) for n in rmw])):
            check(data == model[n], f"read back {n} after its RMW overwrite")
        print(f"[9] {CLUSTER_RMW} RMW overwrites of {2 * 4096 + 100} B at stripe offsets in "
              f"{rmw_s:.3f} s, read back")

        # 3. deep scrub of every EC PG, rot, repair
        ec_pgids = [f"{c.pools['ec']}.{ps}" for ps in range(CLUSTER_PG_NUM)]
        crc0 = ks.dump().get("l_tpu_scrub_crc32c_calls", 0)
        t0 = time.perf_counter()
        for pgid in ec_pgids:
            errs, _s = _cluster_scrub(c, pgid)
            check(errs == [], f"deep scrub of a clean pg {pgid}: {errs[:3]}")
        scrub_s = time.perf_counter() - t0
        shard_len = object_bytes // 8
        shard_bytes = objects * 11 * shard_len
        victim = str(rng.choice(names))
        vpg = c.pgid_of("ec", victim)
        acting, primary = c.acting(vpg)
        pos = next(i for i, o in enumerate(acting) if o != primary)
        vstore = c.osds[acting[pos]].store
        cid, soid = f"pg_{vpg}", OBJ_PREFIX + victim
        good = vstore.read(cid, soid)
        at = int(rng.integers(0, len(good)))
        vstore.queue_transaction(Transaction().write(cid, soid, at, bytes([good[at] ^ 0x20])))
        errs, rot_s = _cluster_scrub(c, vpg)
        flagged = [(r["object"]["name"], r.get("corrupt")) for r in errs]
        check(flagged == [(victim, [pos])],
              f"scrub after rotting ({victim}, shard {pos}) flagged {flagged}")
        check("repair" in c.rados.pg_repair(vpg), f"pg {vpg} refused repair")
        c.wait(lambda: vstore.read(cid, soid) == good, "repair never rewrote the rotted shard")
        errs, _s = _cluster_scrub(c, vpg)
        check(errs == [], f"re-scrub after repair: {errs}")
        check(c.rados.open_ioctx("ecpool").read(victim) == model[victim], "read after repair")
        print(f"[9] deep scrub of all {len(ec_pgids)} EC PGs ({shard_bytes} B of shards) clean "
              f"in {scrub_s:.3f} s; one byte of ({victim}, shard {pos}) on osd.{acting[pos]} "
              f"rotted in its MemStore: flagged exactly that pair ({rot_s:.3f} s), pg repair "
              f"rewrote it, re-scrub clean")

        # 4. failure detection, degraded I/O, out, recovery
        lost = c.osds[CLUSTER_LOST]
        heads = {pgid: pg.log.head for pgid, pg in lost.pgs.items()}
        for osd in c.osds.values():
            osd.hb.grace = CLUSTER_GRACE_S
        t0 = time.perf_counter()
        lost.shutdown()
        c.stopped[CLUSTER_LOST] = c.osds.pop(CLUSTER_LOST)
        c.wait(lambda: not c.rados.monc.osdmap.is_up(CLUSTER_LOST),
               f"the monitor never marked osd.{CLUSTER_LOST} down", 60)
        detect_s = time.perf_counter() - t0
        for osd in c.osds.values():
            osd.hb.grace = CLUSTER_HB_GRACE_S
        sample = [str(n) for n in rng.choice(names, min(CLUSTER_DEGRADED_SAMPLE, objects),
                                             replace=False)]
        t0 = time.perf_counter()
        for n, data in zip(sample, c.aio([("ecpool", "read", (n,)) for n in sample])):
            check(data == model[n], f"degraded read of {n}")
        degraded_s = time.perf_counter() - t0
        for i in range(CLUSTER_DEGRADED_WRITES):
            model[f"deg{i}"] = rng.bytes(object_bytes)
        t0 = time.perf_counter()
        c.aio([("ecpool", "write_full", (f"deg{i}", model[f"deg{i}"]))
               for i in range(CLUSTER_DEGRADED_WRITES)])
        degraded_put_s = time.perf_counter() - t0
        pushed0 = sum(o.perf.dump()["recovery_push_bytes"] for o in c.osds.values())
        progress = []

        def recovered() -> bool:
            states = c.pg_states()
            done = len(states) == 2 * CLUSTER_PG_NUM and all(
                v == "active+clean" for v in states.values())
            now = time.perf_counter() - t0
            if not progress or done or now - progress[-1][0] >= 10.0:
                progress.append((round(now, 1), sum(
                    o.perf.dump()["recovery_pushes"] for o in c.osds.values()),
                    sum(v != "active+clean" for v in states.values())))
            return done

        t0 = time.perf_counter()
        rc, _b, outs = c.rados.mon_command({"prefix": "osd out", "id": CLUSTER_LOST})
        check(rc == 0, f"osd out: {outs}")
        with _HostSampler() as recover_where:
            try:
                c.wait(recovered, "recovery never reached active+clean")
            finally:
                print(f"[9] recovery progress (s, pushes, PGs not clean): {progress}")
        recover_s = time.perf_counter() - t0
        pushed = sum(o.perf.dump()["recovery_push_bytes"] for o in c.osds.values()) - pushed0
        batches = sum(o.perf.dump()["recovery_batches"] for o in c.osds.values())
        t0 = time.perf_counter()
        all_names = list(model)
        for n, data in zip(all_names, c.aio([("ecpool", "read", (n,)) for n in all_names])):
            check(data == model[n], f"read of {n} after recovery")
        for n, data in zip(rep_model, c.aio([("reppool", "read", (n,)) for n in rep_model])):
            check(data == rep_model[n], f"read of {n} (replicated) after recovery")
        get2_s = time.perf_counter() - t0
        print(f"[9] osd.{CLUSTER_LOST}'s messenger stopped: marked down by the monitor after "
              f"{detect_s:.3f} s (grace {CLUSTER_GRACE_S} s, a ping round every "
              f"{CLUSTER_TICK_S} s); {len(sample)} degraded reads byte-equal in "
              f"{degraded_s:.3f} s, {CLUSTER_DEGRADED_WRITES} degraded writes in "
              f"{degraded_put_s:.3f} s; marked out: every PG active+clean {recover_s:.3f} s "
              f"later ({pushed} B pushed, {batches} coalesced rebuilds); all "
              f"{len(all_names) + rep_objects} objects read back byte-equal in {get2_s:.3f} s")

        # 5. a daemon restarted on its store reloads its PGs
        t0 = time.perf_counter()
        again = OSD(CLUSTER_LOST + 100, store=c.stopped[CLUSTER_LOST].store, device=device)
        try:
            again.addr = ("", 0)
            again._load_pgs()
            reloaded = {pgid: pg.log.head for pgid, pg in again.pgs.items()}
        finally:
            again.messenger.shutdown()
        reload_s = time.perf_counter() - t0
        check(reloaded == heads and len(heads) > 0,
              f"restart on the store reloaded {len(reloaded)} of {len(heads)} PGs")
        print(f"[9] recovery, threads sampled every 2 ms: {json.dumps(recover_where.top())}")
        print(f"[9] a daemon restarted on osd.{CLUSTER_LOST}'s store reloaded its {len(heads)} "
              f"PGs with their log heads in {reload_s:.3f} s")

        phase_s = time.perf_counter() - t_phase
        counts = {"K1": packed_gf.launches, "K2": bitplane_gf.launches}
        crc_calls = ks.dump().get("l_tpu_scrub_crc32c_calls", 0) - crc0
        check(counts["K1"] > 0 and counts["K2"] > 0, f"a kernel was not launched: {counts}")
        every = list(c.osds.values()) + list(c.stopped.values())
        crashes = [r for o in every for r in o._pending_crashes]
        check(not crashes, f"a daemon queued a crash report: {[r['exception'] for r in crashes]}")
        failed = sum(o.perf.dump()["recovery_failed"] for o in every)
        check(failed == 0, f"{failed} recoveries were marked failed")
        osd_perf = [(e["id"], e["perf_stats"]["commit_latency_ms"],
                     e["perf_stats"]["apply_latency_ms"])
                    for e in perf_after_put.get("osd_perf_infos", [])]
        gbps = {
            "put_GBps": logical / put_s / 1e9,
            "get_GBps": logical / get_s / 1e9,
            "rep_put_GBps": rep_objects * object_bytes / rep_put_s / 1e9,
            "scrub_GBps": shard_bytes / scrub_s / 1e9,
            "recover_GBps": pushed / recover_s / 1e9,
            "get_degraded_GBps": len(sample) * object_bytes / degraded_s / 1e9,
        }
        print(f"[9] cluster phase took {phase_s:.1f} s; launches {counts}; device crc calls "
              f"{crc_calls}; coalesced encodes {dispatches} ({batch_ops / dispatches:.2f} ops "
              f"each)")
        print(f"[9] on {smi.splitlines()[0]} (host clock): "
              + ", ".join(f"{k} {v:.3f}" for k, v in gbps.items()))
        print(f"[9] osd perf after put (osd, commit ms, apply ms): {osd_perf}")
        result = {
            "card": smi.splitlines()[0],
            "config": {"osds": CLUSTER_OSDS, "device": device, "clients": CLUSTER_CLIENTS,
                       "ec_profile": "isa k=8 m=3", "stripe_unit": 4096,
                       "pg_num": CLUSTER_PG_NUM, "objects": objects,
                       "object_bytes": object_bytes, "rep_objects": rep_objects,
                       "store": "MemStore", "heartbeat_grace_s": CLUSTER_HB_GRACE_S,
                       "detect_heartbeat_grace_s": CLUSTER_GRACE_S, "tick_s": CLUSTER_TICK_S,
                       "max_backfills": CLUSTER_MAX_BACKFILLS,
                       "op_timeout_s": CLUSTER_OP_TIMEOUT_S},
            **gbps,
            "seconds": {"put": put_s, "get": get_s, "rep_put": rep_put_s, "rmw": rmw_s,
                        "scrub": scrub_s, "rot_scrub": rot_s, "detect": detect_s,
                        "degraded_get": degraded_s, "degraded_put": degraded_put_s,
                        "recover": recover_s, "get_after_recovery": get2_s,
                        "reload": reload_s, "phase": phase_s},
            "detect_s": detect_s, "recovery_pushed_bytes": pushed,
            "recovery_batches": batches, "recovery_progress": progress,
            "recover_threads": recover_where.top(), "shard_bytes": shard_bytes,
            "batch_encode": {"dispatches": dispatches, "ops": batch_ops},
            "osd_perf_after_put": osd_perf, "launches": counts,
            "device_crc32c_calls": crc_calls, "reloaded_pgs": len(reloaded),
        }
    finally:
        c.shutdown()
        for osd in c.stopped.values():
            osd.shutdown()
    from ceph_tpu_torch.msg.messenger import wait_for

    check(wait_for(lambda: NetworkStack.live() is None, 10.0),
          "a messenger reactor outlived the phase")
    return result


PROC_MONS = 3
PROC_OSDS = 12  # isa k=8 m=3 takes 11 positions; the 12th is the recovery target
PROC_OBJECTS = 64  # 128 before PR 13, cut for the script's time budget
PROC_REP_OBJECTS = 64
PROC_CLIENTS = 2  # each Rados runs 4 aio workers: 8 ops in flight, as in phase 9
PROC_LOST = 5  # the OSD process that is killed and later respawned
PROC_OSD_OPTIONS = {
    "heartbeat_grace": 20.0,  # osd_heartbeat_grace, the reference's
    "tick_interval": 0.5,  # one heartbeat round every 0.5 s, as in phase 9
    "max_backfills": 8,  # as in phase 9
}
PROC_CHILD_RESIDENCY = 256 << 20  # the residency cache's default capacity, for each child
PROC_READY_S = 180.0
PROC_MDS = 2  # an active and a standby, for phase 14
PROC_RGW = 1


class _ProcCluster:
    """What ``tools.cluster start --processes --mds 2 --rgw 1`` starts: 3
    monitors in a quorum, a manager, one OSD process each over a
    BlockStore under ``root`` on ``device``, two MDS processes and a
    gateway; and ``clients`` librados handles in this process."""

    def __init__(self, root: pathlib.Path, device: str, osds: int, clients: int):
        from ceph_tpu_torch.msg import Messenger
        from ceph_tpu_torch.proc import ClusterSpec, Supervisor
        from ceph_tpu_torch.tools.cluster import prebuild_kernels

        shutil.rmtree(root, ignore_errors=True)
        self.spec = ClusterSpec.plan(root, mons=PROC_MONS, osds=osds, mgrs=1, mds=PROC_MDS,
                                     rgw=PROC_RGW, device=device, osd_options=PROC_OSD_OPTIONS)
        # the kernels are built once, here: 12 nvcc runs at once would
        # outlast the supervisor's ready timeout
        prebuild_kernels(device)
        self.sup = Supervisor(self.spec, extra_env={
            "CEPH_TPU_RESIDENCY_BYTES": str(PROC_CHILD_RESIDENCY)})
        self.clients = []
        self.msgr = Messenger("smoke10")
        self._mgr_conn = None
        self.used = {"before_spawn": _card_used_mib(device)}
        t0 = time.perf_counter()
        try:
            self.sup.start(ready_timeout=PROC_READY_S)
        except BaseException:
            # a child that failed its boot: stop the ones already up
            self.msgr.shutdown()
            self.sup.stop()
            raise
        self.ready_s = time.perf_counter() - t0
        self.used["ready"] = _card_used_mib(device)
        self.pools: dict[str, int] = {}

    def connect(self, clients: int) -> None:
        from ceph_tpu_torch.rados import Rados

        self.clients = [Rados(f"smoke10.{c}").connect_any(self.spec.mon_addrs)
                        for c in range(clients)]
        for r in self.clients:
            r.objecter.op_timeout = CLUSTER_OP_TIMEOUT_S
        self.rados = self.clients[0]

    def mon_status(self, rank: int) -> dict | None:
        from ceph_tpu_torch.tools.leader_kills import mon_status

        return mon_status(self.msgr, self.spec.mon_addrs[rank])

    def leader(self) -> tuple[int, dict] | None:
        """The leader of a quorum every live monitor agrees on."""
        live = [r for r in range(PROC_MONS)
                if self.sup.status()[f"mon.{r}"]["state"] == "running"]
        st = {r: self.mon_status(r) for r in live}
        if any(s is None or s["state"] not in ("leader", "peon") for s in st.values()):
            return None
        leaders = {s["leader"] for s in st.values()}
        if len(leaders) != 1 or not set(live) <= set(st[live[0]]["quorum"]):
            return None
        lead = leaders.pop()
        return lead, st[lead]

    def mgr(self, cmd: dict) -> dict:
        """A command to the active manager, answered as JSON."""
        from ceph_tpu_torch.msg.message import MMonCommand

        if self._mgr_conn is None or self._mgr_conn.is_closed:
            rc, outb, outs = self.rados.mon_command({"prefix": "mgr stat"})
            check(rc == 0, f"mgr stat: {outs}")
            host, _, port = json.loads(outb)["active"]["addr"].rpartition(":")
            self._mgr_conn = self.msgr.connect(host, int(port), timeout=10.0)
        reply = self._mgr_conn.call(MMonCommand(cmd=json.dumps(cmd)), timeout=30.0)
        check(reply.rc == 0, f"mgr {cmd['prefix']}: {reply.outs}")
        return json.loads(reply.outb) if reply.outb else {}

    def clean(self, since_epoch: int, n_pgs: int) -> bool:
        """Every PG active+clean in the manager's digest, as reported by
        primaries at ``since_epoch`` or later."""
        pgs = self.mgr({"prefix": "pgmap dump"}).get("pgs", {})
        return len(pgs) == n_pgs and all(
            p["state"] == "active+clean" and p["reported_epoch"] >= since_epoch
            for p in pgs.values())

    def wait(self, cond, what: str, timeout: float = CLUSTER_WAIT_S) -> float:
        from ceph_tpu_torch.msg.messenger import wait_for

        t0 = time.perf_counter()
        check(wait_for(cond, timeout, 0.25), what)
        return time.perf_counter() - t0

    def unclean(self) -> dict:
        """The PGs the manager's digest holds as not active+clean."""
        pgs = self.mgr({"prefix": "pgmap dump"}).get("pgs", {})
        return {pgid: (p["state"], p["reported_epoch"]) for pgid, p in pgs.items()
                if p["state"] != "active+clean"}

    def admin(self, osd: int, command) -> dict:
        """A command over ``osd``'s admin socket (``spec.dir/osd.N.asok``)."""
        from ceph_tpu_torch.common.admin_socket import admin_command

        reply = admin_command(str(self.spec.dir / f"osd.{osd}.asok"), command)
        check("ok" in reply, f"osd.{osd} {command}: {reply}")
        return reply["ok"]

    def aio(self, calls) -> list:
        return _aio(self.clients, calls)

    def shutdown(self) -> None:
        for r in self.clients:
            r.shutdown()
        self.msgr.shutdown()
        self.sup.stop()


def _perf_value(dump: dict, key: str) -> int:
    """A counter from an admin-socket ``perf dump`` (sets by name)."""
    for counters in dump.values():
        if key in counters:
            v = counters[key]
            return int(v["value"] if isinstance(v, dict) else v)
    return 0


def _card_used_mib(device: str) -> int | None:
    """The card's memory in use (MiB, nvidia-smi ``memory.used``), all
    processes together."""
    if device != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return int(out.splitlines()[0])


def _card_memory(sup, used: dict) -> dict:
    """Card memory by process: nvidia-smi's per-process list, by role
    where a pid it names is a child's (a sandbox may report other pids),
    and the card's total in use at each step, whose growth over the
    spawn divided by the card processes is the memory of each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    ).stdout
    roles = {c["pid"]: role for role, c in sup.status().items()}
    apps = {}
    for line in out.splitlines():
        pid, _, mib = (x.strip() for x in line.partition(","))
        if pid.isdigit():
            apps[roles.get(int(pid), f"pid {pid}")] = int(mib)
    card = sum(1 for role in roles.values() if role.startswith(("osd.", "mgr.")))
    return {"apps": apps, "used_mib": used, "card_processes": card,
            "per_process_mib_at_ready": (used["ready"] - used["before_spawn"]) / card}


def phase_processes(smi: str, device: str = "cuda", osds: int = PROC_OSDS, k: int = 8,
                    m: int = 3, objects: int = PROC_OBJECTS,
                    object_bytes: int = CLUSTER_OBJECT_BYTES,
                    rep_objects: int = PROC_REP_OBJECTS, during=None) -> dict:
    """The cluster as processes: what ``tools.cluster start --processes
    --device cuda`` starts, each OSD in its own process with its own
    CUDA context, driven through librados from this process.
    ``during(c, k, m)`` drives later phases on the same fleet after
    this one's numbers are read and before its crash and death audit;
    its result is returned under ``"during"``, and each role it lists
    under ``"victims"`` was killed once on purpose."""
    rng = np.random.default_rng(SEED + 10)
    block = rng.bytes(objects * object_bytes)
    model = {f"obj{i:03d}": block[i * object_bytes:(i + 1) * object_bytes]
             for i in range(objects)}
    del block
    rep_model = {f"rep{i:02d}": rng.bytes(object_bytes) for i in range(rep_objects)}
    logical = objects * object_bytes
    root = pathlib.Path(__file__).resolve().parent / "build" / "p10"
    t_phase = time.perf_counter()
    c = _ProcCluster(root, device, osds, PROC_CLIENTS)
    stopped = False
    try:
        # 1. spawn to ready, and to quorum
        quorum_s = c.ready_s + c.wait(lambda: c.leader() is not None, "no quorum formed", 60)
        c.connect(PROC_CLIENTS)
        roles = c.sup.status()
        check(len(roles) == PROC_MONS + 1 + osds + PROC_MDS + PROC_RGW
              and len({r["pid"] for r in roles.values()}) == len(roles),
              f"not one process a daemon: {roles}")
        rc, _b, outs = c.rados.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "isa",
            "profile": ["plugin=isa", f"k={k}", f"m={m}"]})
        check(rc == 0, f"erasure-code-profile set: {outs}")
        c.pools["ec"] = c.rados.pool_create("ecpool", pool_type=3, pg_num=CLUSTER_PG_NUM,
                                            erasure_code_profile="isa")
        c.pools["rep"] = c.rados.pool_create("reppool", pg_num=CLUSTER_PG_NUM, size=3)
        # the mds and rgw roles made their own pools at boot
        n_pgs = sum(p.pg_num for p in c.rados.monc.osdmap.pools.values())
        epoch0 = c.rados.monc.osdmap.epoch
        active_s = c.wait(lambda: c.clean(epoch0, n_pgs), "the pools never went active+clean")
        print(f"[10] {PROC_MONS} monitors, 1 manager, {osds} OSD processes (device={device}, "
              f"BlockStore each), {PROC_MDS} MDS and {PROC_RGW} gateway processes ready {c.ready_s:.2f} s after spawn, quorum at "
              f"{quorum_s:.2f} s; isa k={k} m={m} and 3-replica pools active+clean "
              f"{active_s:.2f} s after creation")

        # 2. put and get through librados
        names = list(model)
        t0 = time.perf_counter()
        c.aio([("ecpool", "write_full", (n, model[n])) for n in names])
        put_s = time.perf_counter() - t0
        c.used["after_put"] = _card_used_mib(device)
        # the EC PGs' primaries while they encoded the puts
        put_map = c.rados.monc.osdmap
        ec_primaries = {put_map.pg_to_up_acting_osds(c.pools["ec"], ps)[3]
                        for ps in range(CLUSTER_PG_NUM)}
        t0 = time.perf_counter()
        for n, data in zip(names, c.aio([("ecpool", "read", (n,)) for n in names])):
            check(data == model[n], f"read back {n}")
        get_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c.aio([("reppool", "write_full", (n, d)) for n, d in rep_model.items()])
        rep_put_s = time.perf_counter() - t0
        for n, data in zip(rep_model, c.aio([("reppool", "read", (n,)) for n in rep_model])):
            check(data == rep_model[n], f"read back {n} (replicated)")
        print(f"[10] put {objects} objects of {object_bytes} B in {put_s:.3f} s, read back "
              f"byte-equal in {get_s:.3f} s; {rep_objects} into the 3-replica pool in "
              f"{rep_put_s:.3f} s, read back")

        # 3. the leader monitor killed; the new quorum commits; it rejoins
        lead, lead_st = c.leader()
        epoch = c.rados.monc.osdmap.epoch
        c.sup.kill(f"mon.{lead}", hold=True)
        t0 = time.perf_counter()

        def committed() -> bool:
            try:
                rc, outb, _outs = c.rados.mon_command(
                    {"prefix": "osd reweight", "id": 0, "weight": 1.0})
            except Exception:  # noqa: BLE001 — no quorum yet: retried
                return False
            return rc == 0 and json.loads(outb).get("epoch", 0) > epoch

        commit_s = c.wait(committed, "the new quorum never committed an epoch", 60)
        agreed: list = []

        def leader_agreed() -> bool:
            # a monitor may still be settling into the new quorum when
            # its first commit lands
            agreed[:] = c.leader() or ()
            return bool(agreed)

        c.wait(leader_agreed, "the live monitors never agreed on a leader after the kill", 60)
        new_lead = agreed[0]
        check(new_lead != lead, f"mon.{lead} still leads after its kill")
        t0 = time.perf_counter()
        c.sup.respawn(f"mon.{lead}")

        def caught_up() -> bool:
            st = [c.mon_status(r) for r in range(PROC_MONS)]
            return (all(x is not None and x["state"] in ("leader", "peon") for x in st)
                    and len({x["last_committed"] for x in st}) == 1)

        catchup_s = c.wait(caught_up, f"mon.{lead} never caught up", 60)
        print(f"[10] leader mon.{lead} SIGKILLed: mon.{new_lead} leads and committed epoch "
              f"{epoch + 1} or later {commit_s:.3f} s later; mon.{lead} respawned and caught "
              f"up to version {c.mon_status(lead)['last_committed']} in {catchup_s:.3f} s")

        # 4. an OSD process killed and not respawned: detection, degraded
        # reads, out, recovery, every object read back
        launches_lost = c.admin(PROC_LOST, "kernel launches")
        pushed0 = sum(_perf_value(c.admin(o, "perf dump"), "recovery_push_bytes")
                      for o in range(osds) if o != PROC_LOST)
        c.sup.kill(f"osd.{PROC_LOST}", hold=True)
        t0 = time.perf_counter()
        detect_s = c.wait(lambda: not c.rados.monc.osdmap.is_up(PROC_LOST),
                          f"osd.{PROC_LOST} never marked down", 120)
        sample = [str(n) for n in rng.choice(names, min(CLUSTER_DEGRADED_SAMPLE, objects),
                                             replace=False)]
        t0 = time.perf_counter()
        for n, data in zip(sample, c.aio([("ecpool", "read", (n,)) for n in sample])):
            check(data == model[n], f"degraded read of {n}")
        degraded_s = time.perf_counter() - t0
        rc, outb, outs = c.rados.mon_command({"prefix": "osd out", "id": PROC_LOST})
        check(rc == 0, f"osd out: {outs}")
        out_epoch = json.loads(outb)["epoch"]
        t0 = time.perf_counter()
        recover_s = c.wait(lambda: c.clean(out_epoch, n_pgs), "recovery never reached active+clean")
        pushed = sum(_perf_value(c.admin(o, "perf dump"), "recovery_push_bytes")
                     for o in range(osds) if o != PROC_LOST) - pushed0
        t0 = time.perf_counter()
        for n, data in zip(names, c.aio([("ecpool", "read", (n,)) for n in names])):
            check(data == model[n], f"read of {n} after recovery")
        for n, data in zip(rep_model, c.aio([("reppool", "read", (n,)) for n in rep_model])):
            check(data == rep_model[n], f"read of {n} (replicated) after recovery")
        get2_s = time.perf_counter() - t0
        print(f"[10] osd.{PROC_LOST}'s process SIGKILLed: marked down after {detect_s:.3f} s "
              f"(grace {PROC_OSD_OPTIONS['heartbeat_grace']} s); {len(sample)} degraded reads "
              f"byte-equal in {degraded_s:.3f} s; marked out: every PG active+clean "
              f"{recover_s:.3f} s later ({pushed} B pushed); all {objects + rep_objects} "
              f"objects read back in {get2_s:.3f} s")

        # 5. the OSD respawned on its store reloads its PGs and rejoins
        t0 = time.perf_counter()
        c.sup.respawn(f"osd.{PROC_LOST}")
        c.sup.wait_ready([f"osd.{PROC_LOST}"], timeout=PROC_READY_S)
        reloaded = c.sup.ready_info(f"osd.{PROC_LOST}")["pgs"]
        c.wait(lambda: c.rados.monc.osdmap.is_up(PROC_LOST), f"osd.{PROC_LOST} never rejoined", 60)
        rejoin_s = time.perf_counter() - t0
        rejoin_epoch = c.rados.monc.osdmap.epoch
        check(reloaded > 0, f"osd.{PROC_LOST} reloaded no PG")
        clean2_s = c.wait(lambda: c.clean(rejoin_epoch, n_pgs),
                          "the cluster never went clean after the rejoin")
        print(f"[10] osd.{PROC_LOST} respawned on its store: {reloaded} PGs reloaded, up in the "
              f"map {rejoin_s:.3f} s after the respawn, every PG active+clean {clean2_s:.3f} s "
              f"later")

        # 6. the balancer on, through the manager: its first plan equals
        # calc_pg_upmaps on a copy of the map it planned on
        from ceph_tpu_torch.osd.balancer import calc_pg_upmaps

        snap = copy.deepcopy(c.rados.monc.osdmap)
        c.mgr({"prefix": "balancer on"})
        t0 = time.perf_counter()
        c.wait(lambda: c.mgr({"prefix": "balancer status"})["plans_applied"] > 0,
               "the balancer applied no plan", 60)
        c.mgr({"prefix": "balancer off"})
        balance_s = time.perf_counter() - t0
        plans = c.mgr({"prefix": "balancer status"})["plans"]
        first = plans[0]
        check(first["epoch"] == snap.epoch,
              f"the first plan was made at epoch {first['epoch']}, not {snap.epoch}")
        before = dict(snap.pg_upmap_items)
        calc_pg_upmaps(snap, max_deviation=1, max_changes=10, device="cpu")
        expect = {f"{pid}.{ps}": [list(i) for i in items]
                  for (pid, ps), items in snap.pg_upmap_items.items()
                  if before.get((pid, ps)) != items}
        check(first["plan"] == expect, f"balancer plan {first['plan']} != {expect}")
        bal_epoch = c.rados.monc.osdmap.epoch
        clean3_s = c.wait(lambda: c.clean(bal_epoch, n_pgs),
                          "the cluster never went clean after the balancer's plan")
        print(f"[10] balancer on through the manager: {len(plans)} plan(s) applied in "
              f"{balance_s:.3f} s, the first ({len(first['plan'])} PG remaps at epoch "
              f"{first['epoch']}) equal to calc_pg_upmaps(device='cpu') on a copy; clean "
              f"again {clean3_s:.3f} s later")

        # 7. the device-kernel counters of every OSD process
        launched = _launch_delta({o: {"K1": 0, "K2": 0} for o in range(osds)},
                                 _launches_by_osd(c, osds), restarted={PROC_LOST: launches_lost})
        per_osd = {}
        for o in range(osds):
            dump = c.admin(o, "perf dump")
            per_osd[o] = {**launched[o],
                          "ec_encode_calls": _perf_value(dump, "l_tpu_ec_encode_calls"),
                          "ec_decode_calls": _perf_value(dump, "l_tpu_ec_decode_calls"),
                          "scrub_crc32c_calls": _perf_value(dump, "l_tpu_scrub_crc32c_calls")}
        counts = {"K1": sum(v["K1"] for v in per_osd.values()),
                  "K2": sum(v["K2"] for v in per_osd.values())}
        if device == "cuda":
            check(all(per_osd[o]["K1"] + per_osd[o]["K2"] > 0 for o in ec_primaries),
                  f"an EC primary of the puts ({sorted(ec_primaries)}) launched no kernel: "
                  f"{per_osd}")
            check(counts["K1"] > 0 and counts["K2"] > 0, f"a kernel was not launched: {counts}")
        print(f"[10] kernel launches in the OSD processes {counts} (the EC primaries of the "
              f"puts: {sorted(ec_primaries)}); by OSD "
              f"{json.dumps({o: v for o, v in per_osd.items()})}")

        # 8. each process's card memory
        memory = {}
        if device == "cuda":
            c.used["end"] = _card_used_mib(device)
            memory = _card_memory(c.sup, c.used)
            print(f"[10] card memory (MiB, nvidia-smi): in use {json.dumps(c.used)}; "
                  f"{memory['per_process_mib_at_ready']:.1f} a card process at ready "
                  f"({memory['card_processes']} processes); per-process list "
                  f"{json.dumps(memory['apps'])}")

        phase_s = time.perf_counter() - t_phase
        later = during(c, k, m) if during is not None else None

        # 9. a clean stop: the only process deaths are the planned
        # kills, and the crash reports the manager holds are theirs
        kills = collections.Counter([f"mon.{lead}", f"osd.{PROC_LOST}"])
        if later is not None:
            kills.update(later["victims"])
        for role in kills:
            if role.startswith("osd."):
                c.wait(lambda: sum(r["entity_name"] == role
                                   for r in c.mgr({"prefix": "crash ls"})) >= kills[role],
                       f"{role}'s death never reached the manager", 60)
        listing = c.mgr({"prefix": "crash ls"})
        check(all(r["entity_name"] in kills and "SIGKILL" in r["exception"]
                  for r in listing), f"crash reports besides the planned kills: {listing}")
        st = c.sup.status()
        restarts = {role: s["restarts"] for role, s in st.items() if s["restarts"]}
        check(restarts == dict(kills), f"process deaths other than the planned kills: {st}")
        check(all(s["state"] == "running" for s in st.values()), f"a child is not running: {st}")
        pids = [s["pid"] for s in st.values()]
        c.shutdown()
        stopped = True
        from ceph_tpu_torch.proc import Supervisor

        reaped = Supervisor.reap_orphans(c.spec.dir)
        alive = [p for p in pids if _pid_alive(p)]
        check(reaped == [] and alive == [], f"left behind: reaped {reaped}, alive {alive}")
        print(f"[10] stopped: no other death, crash ls holds the planned kills only "
              f"({[r['entity_name'] for r in listing]}), no process left")
    finally:
        if not stopped:
            c.shutdown()
    shutil.rmtree(root, ignore_errors=True)
    gbps = {
        "put_GBps": logical / put_s / 1e9,
        "get_GBps": logical / get_s / 1e9,
        "rep_put_GBps": rep_objects * object_bytes / rep_put_s / 1e9,
        "recover_GBps": pushed / recover_s / 1e9,
        "get_degraded_GBps": len(sample) * object_bytes / degraded_s / 1e9,
    }
    print(f"[10] process cluster phase took {phase_s:.1f} s; on {smi.splitlines()[0]} (host "
          "clock): " + ", ".join(f"{key} {v:.3f}" for key, v in gbps.items()))
    return {
        "card": smi.splitlines()[0],
        "config": {"mons": PROC_MONS, "mgrs": 1, "osds": osds, "mds": PROC_MDS,
                   "rgw": PROC_RGW, "device": device,
                   "ec_profile": f"isa k={k} m={m}", "stripe_unit": 4096,
                   "pg_num": CLUSTER_PG_NUM, "objects": objects, "object_bytes": object_bytes,
                   "rep_objects": rep_objects, "store": "BlockStore(sync=False)",
                   "clients": PROC_CLIENTS, "osd_options": PROC_OSD_OPTIONS,
                   "child_residency_bytes": PROC_CHILD_RESIDENCY},
        **gbps,
        "seconds": {"ready": c.ready_s, "quorum": quorum_s, "pools_active": active_s,
                    "put": put_s, "get": get_s, "rep_put": rep_put_s,
                    "leader_kill_to_commit": commit_s, "mon_catch_up": catchup_s,
                    "detect": detect_s, "degraded_get": degraded_s, "recover": recover_s,
                    "get_after_recovery": get2_s, "rejoin": rejoin_s,
                    "clean_after_rejoin": clean2_s, "balancer": balance_s,
                    "clean_after_balancer": clean3_s, "phase": phase_s},
        "recovery_pushed_bytes": pushed, "reloaded_pgs": reloaded,
        "balancer_plans": len(plans), "balancer_first_plan_remaps": len(first["plan"]),
        "launches": counts, "launches_by_osd": per_osd,
        "ec_primaries_of_puts": sorted(ec_primaries), "card_memory_mib": memory,
        "crash_ls": listing, "during": later,
    }


RBD_IMAGE_BYTES = 512 << 20  # cut from 1 GiB for the time budget (PERF.md §4)
RBD_OBJECT_BYTES = 4 << 20  # rbd_default_order 22
RBD_IO_SIZE = 4096  # rbd bench --io-size default
RBD_IO_THREADS = 16  # rbd bench --io-threads default
RBD_RANDOM_WRITES = 256  # cut from rbd bench's 1 GiB --io-total for the time budget
RBD_OVERWRITE = 8 << 20
RBD_CACHE_BYTES = 16 << 20
RBD_MIRROR_BYTES = 16 << 20
RBD_FEATURES = "exclusive-lock,object-map"
RBD_DEGRADED_WRITES = 8  # whole objects rewritten while an OSD is down


def _rbd_cli(c, pool: str, *args: str) -> tuple[str, float]:
    """``python -m ceph_tpu_torch.tools.rbd_cli`` against the fleet, as
    a process of its own: its stdout and its seconds."""
    host, port = c.spec.mon_addrs[0]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.rbd_cli", "-m", f"{host}:{port}",
         "-p", pool, *args],
        capture_output=True, text=True, timeout=CLUSTER_WAIT_S,
        cwd=pathlib.Path(__file__).resolve().parent)
    check(proc.returncode == 0, f"rbd {' '.join(args)}: rc {proc.returncode}: "
                                f"{proc.stderr[-3000:]}")
    return proc.stdout, time.perf_counter() - t0


def _launches_by_osd(c, osds: int) -> dict:
    return {o: c.admin(o, "kernel launches") for o in range(osds)}


def _encode_counters(c, osds: int) -> dict:
    """Encode calls and coalesced batch-encode dispatches (and the ops
    they carried) summed over the OSD processes' perf dumps."""
    keys = ("l_tpu_ec_encode_calls", "l_tpu_batch_encode_dispatches",
            "l_tpu_batch_encode_ops_per_dispatch")
    dumps = [c.admin(o, "perf dump") for o in range(osds)]
    return {key: sum(_perf_value(d, key) for d in dumps) for key in keys}


def _launch_delta(before: dict, after: dict, restarted: dict | None = None) -> dict:
    """Each OSD's K1/K2 launches between two reads; an OSD that was
    respawned in between counts from 0 again, so its share is what it
    launched up to its kill (``restarted[o]``) plus all since."""
    out = {}
    for o in after:
        if restarted and o in restarted:
            out[o] = {k: restarted[o][k] - before[o][k] + after[o][k] for k in ("K1", "K2")}
        else:
            out[o] = {k: after[o][k] - before[o][k] for k in ("K1", "K2")}
    return out


def _sum_launches(delta: dict) -> dict:
    return {k: sum(v[k] for v in delta.values()) for k in ("K1", "K2")}


def _patched_sha(path: pathlib.Path, size: int, patches: list | tuple = ()) -> str:
    """sha256 of the file at ``path`` with ``patches`` ((offset, bytes),
    later ones winning) written over it, streamed in object-size steps."""
    import hashlib

    h = hashlib.sha256()
    step = RBD_OBJECT_BYTES
    with open(path, "rb") as fh:
        for off in range(0, size, step):
            chunk = bytearray(fh.read(min(step, size - off)))
            for p_off, data in patches:
                lo, hi = max(off, p_off), min(off + len(chunk), p_off + len(data))
                if lo < hi:
                    chunk[lo - off:hi - off] = data[lo - p_off:hi - p_off]
            h.update(chunk)
    return h.hexdigest()


def _pool_clean(c, what: str) -> None:
    """Wait until the manager's digest holds every PG of every pool
    active+clean, reported at the current epoch or later."""
    from ceph_tpu_torch.msg.messenger import wait_for

    n_pgs = sum(p.pg_num for p in c.rados.monc.osdmap.pools.values())
    epoch = c.rados.monc.osdmap.epoch
    if not wait_for(lambda: c.clean(epoch, n_pgs), CLUSTER_WAIT_S, 0.25):
        check(False, f"{what}: {c.unclean()}")


def _busiest_data_osd(c, pool_id: int, k: int) -> tuple[int, int]:
    """The OSD holding the most non-primary data positions of the
    pool's PGs, and how many."""
    osdmap = c.rados.monc.osdmap
    holds: collections.Counter = collections.Counter()
    for ps in range(osdmap.pools[pool_id].pg_num):
        acting, primary = osdmap.pg_to_up_acting_osds(pool_id, ps)[2:]
        holds.update(o for o in acting[:k] if o != primary)
    return holds.most_common(1)[0]


def phase_rbd(smi: str, c, device: str, k: int, m: int,
              image_bytes: int = RBD_IMAGE_BYTES, object_bytes: int = RBD_OBJECT_BYTES,
              random_writes: int = RBD_RANDOM_WRITES, overwrite: int = RBD_OVERWRITE,
              cache_bytes: int = RBD_CACHE_BYTES, mirror_bytes: int = RBD_MIRROR_BYTES) -> dict:
    """Block images on phase 10's process fleet: an isa k=m pool, rbd's
    CLI as processes and librbd's ``Image`` from this process."""
    from ceph_tpu_torch.rbd import Image, RBD
    from ceph_tpu_torch.rbd.mirror import MirrorDaemon

    rng = np.random.default_rng(SEED + 11)
    osds = c.spec.data["osds"]
    work = c.spec.dir / "rbd"
    work.mkdir(parents=True, exist_ok=True)
    t_phase = time.perf_counter()
    launches0 = _launches_by_osd(c, osds)

    # 1. the pool, and an image through the CLI
    c.pools["rbd"] = c.rados.pool_create("rbdpool", pool_type=3, pg_num=CLUSTER_PG_NUM,
                                         erasure_code_profile="isa")
    _pool_clean(c, "the rbd pool never went active+clean")
    _rbd_cli(c, "rbdpool", "create", "vol", "--size", str(image_bytes),
             "--object-size", str(object_bytes), "--features", RBD_FEATURES)
    info = json.loads(_rbd_cli(c, "rbdpool", "info", "vol")[0])
    check(info["size"] == image_bytes and info["obj_size"] == object_bytes
          and info["num_objs"] == image_bytes // object_bytes
          and info["features"] == sorted(RBD_FEATURES.split(",")), f"rbd info vol: {info}")

    # 2. import a seeded file, export it: the same bytes
    src = work / "src.img"
    with open(src, "wb") as fh:
        for off in range(0, image_bytes, 64 << 20):
            fh.write(rng.bytes(min(64 << 20, image_bytes - off)))
    src_sha = _patched_sha(src, image_bytes)
    before = _launches_by_osd(c, osds)
    enc0 = _encode_counters(c, osds)
    _out, import_s = _rbd_cli(c, "rbdpool", "import", str(src), "img",
                              "--object-size", str(object_bytes), "--features", RBD_FEATURES)
    import_delta = _launch_delta(before, _launches_by_osd(c, osds))
    import_enc = {key: v - enc0[key] for key, v in _encode_counters(c, osds).items()}
    out = work / "out.img"
    before = _launches_by_osd(c, osds)
    _out, export_s = _rbd_cli(c, "rbdpool", "export", "img", str(out))
    export_delta = _launch_delta(before, _launches_by_osd(c, osds))
    export_sha = _patched_sha(out, image_bytes)
    out.unlink()
    check(export_sha == src_sha, f"export {export_sha} != source {src_sha}")
    import_k = _sum_launches(import_delta)
    if device == "cuda":
        check(import_k["K1"] > 0, f"the import's encodes launched no K1: {import_delta}")
    print(f"[11] rbd import of {image_bytes} B in {import_s:.3f} s "
          f"({image_bytes / import_s / 1e9:.4f} GB/s), export in {export_s:.3f} s "
          f"({image_bytes / export_s / 1e9:.4f} GB/s), sha256 {export_sha} equal to the "
          f"source; launches during the import {import_k} by OSD "
          f"{json.dumps({o: v for o, v in import_delta.items() if v['K1'] or v['K2']})}; "
          f"encode counters over the import {import_enc}")

    io = c.rados.open_ioctx("rbdpool")
    patches: list = []

    # 3. rbd bench's shape: 4 KiB random writes, 16 in flight
    blocks = rng.choice(image_bytes // RBD_IO_SIZE, random_writes, replace=False)
    datas = [rng.bytes(RBD_IO_SIZE) for _ in blocks]
    lat: list = []
    before = _launches_by_osd(c, osds)
    with Image(io, "img") as img:
        window = collections.deque()
        t0 = time.perf_counter()
        for blk, data in zip(blocks, datas):
            if len(window) >= RBD_IO_THREADS:
                fut, t_sub = window.popleft()
                check(fut.result(timeout=CLUSTER_WAIT_S) == RBD_IO_SIZE, "a short aio write")
            t_sub = time.perf_counter()
            fut = img.aio_write(int(blk) * RBD_IO_SIZE, data)
            fut.add_done_callback(lambda _f, t=t_sub: lat.append(time.perf_counter() - t))
            window.append((fut, t_sub))
        for fut, _t in window:
            check(fut.result(timeout=CLUSTER_WAIT_S) == RBD_IO_SIZE, "a short aio write")
        write_s = time.perf_counter() - t0
        reads = collections.deque()
        for blk, data in zip(blocks, datas):
            if len(reads) >= RBD_IO_THREADS:
                fut, b, d = reads.popleft()
                check(fut.result(timeout=CLUSTER_WAIT_S) == d, f"random write at block {b}")
            reads.append((img.aio_read(int(blk) * RBD_IO_SIZE, RBD_IO_SIZE), blk, data))
        for fut, b, d in reads:
            check(fut.result(timeout=CLUSTER_WAIT_S) == d, f"random write at block {b}")
    write_delta = _launch_delta(before, _launches_by_osd(c, osds))
    patches += [(int(b) * RBD_IO_SIZE, d) for b, d in zip(blocks, datas)]
    lat.sort()
    p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    print(f"[11] {random_writes} random {RBD_IO_SIZE} B writes ({RBD_IO_THREADS} in flight, "
          f"read-modify-write on the EC pool) in {write_s:.3f} s: "
          f"{random_writes / write_s:.1f} IOPS, latency p50 {p50 * 1e3:.2f} ms p99 "
          f"{p99 * 1e3:.2f} ms; every extent read back; launches "
          f"{_sum_launches(write_delta)}")

    # 4. a snapshot, an overwrite, the read at the snapshot, the diff
    ov_off = (image_bytes // 2) // object_bytes * object_bytes
    ov_data = rng.bytes(overwrite)
    with Image(io, "img") as img:
        before_ov = img.read(ov_off, overwrite)
        snap_t0 = time.perf_counter()
        img.snap_create("s1")
        img.write(ov_off, ov_data)
        img.set_snap("s1")
        at_snap = img.read(ov_off, overwrite)
        img.set_snap(None)
        head = img.read(ov_off, overwrite)
        snap_s = time.perf_counter() - snap_t0
    check(at_snap == before_ov, "the read at s1 is not the pre-overwrite bytes")
    check(head == ov_data, "the head does not read the overwrite")
    patches.append((ov_off, ov_data))
    diff_out, _s = _rbd_cli(c, "rbdpool", "diff", "img", "--from-snap", "s1")
    touched = sorted(int(line.split()[0]) // object_bytes for line in diff_out.splitlines())
    want = list(range(ov_off // object_bytes, (ov_off + overwrite - 1) // object_bytes + 1))
    check(touched == want, f"rbd diff --from-snap s1 lists {touched}, not {want}")
    print(f"[11] snapshot s1, {overwrite} B overwritten at {ov_off}: the read at s1 equals the "
          f"bytes before, the head the new ones ({snap_s:.3f} s); rbd diff --from-snap s1 "
          f"lists objects {touched}")

    # 5. an OSD with a data position of the image's PGs stopped: the
    # degraded export decodes on the card and equals the image; writes
    # while it is down land on the other positions, and its respawn
    # rebuilds its shards of them
    from ceph_tpu_torch.osdc.objecter import object_to_pg

    osdmap = c.rados.monc.osdmap
    victim, held = _busiest_data_osd(c, c.pools["rbd"], k)
    # objects of the victim's PGs, from the map before its kill (the
    # client's map is updated in place)
    pool = osdmap.pools[c.pools["rbd"]]
    missed = [o for o in range(image_bytes // object_bytes)
              if victim in osdmap.pg_to_up_acting_osds(
                  c.pools["rbd"], int(object_to_pg(pool, f"rbd_data.img.{o:016x}")
                                      .split(".")[1]))[2]][:RBD_DEGRADED_WRITES]
    expect_sha = _patched_sha(src, image_bytes, patches)
    before = _launches_by_osd(c, osds)
    at_kill = c.admin(victim, "kernel launches")
    c.sup.kill(f"osd.{victim}", hold=True)
    rc, _b, outs = c.rados.mon_command({"prefix": "osd down", "id": victim})
    check(rc == 0, f"osd down {victim}: {outs}")
    c.wait(lambda: not c.rados.monc.osdmap.is_up(victim), f"osd.{victim} never marked down", 60)
    out2 = work / "degraded.img"
    _out, degraded_s = _rbd_cli(c, "rbdpool", "export", "img", str(out2))
    live = {o: c.admin(o, "kernel launches") for o in range(osds) if o != victim}
    degraded_delta = _launch_delta({o: before[o] for o in live}, live)
    degraded_sha = _patched_sha(out2, image_bytes)
    out2.unlink()
    check(degraded_sha == expect_sha, f"degraded export {degraded_sha} != {expect_sha}")
    degraded_k = _sum_launches(degraded_delta)
    missed_data = {o: rng.bytes(object_bytes) for o in missed}
    with Image(io, "img") as img:
        for o, data in missed_data.items():
            img.write(o * object_bytes, data)
    patches += [(o * object_bytes, d) for o, d in missed_data.items()]
    before = {o: c.admin(o, "kernel launches") for o in live}
    t0 = time.perf_counter()
    c.sup.respawn(f"osd.{victim}")
    c.sup.wait_ready([f"osd.{victim}"], timeout=PROC_READY_S)
    c.wait(lambda: c.rados.monc.osdmap.is_up(victim), f"osd.{victim} never rejoined", 60)
    _pool_clean(c, f"never clean after osd.{victim}'s respawn")
    rejoin_s = time.perf_counter() - t0
    rebuild_k = _sum_launches(_launch_delta(before, {o: c.admin(o, "kernel launches")
                                                     for o in live}))
    with Image(io, "img") as img:
        for o, data in missed_data.items():
            check(img.read(o * object_bytes, object_bytes) == data,
                  f"object {o} written while osd.{victim} was down")
    if device == "cuda":
        # the degraded reads decode one stripe at a time, which takes
        # K1; K2 (the batched decode) is held on the rebuild
        check(degraded_k["K1"] + degraded_k["K2"] > 0,
              f"the degraded export decoded no stripe on the card: {degraded_delta}")
        check(rebuild_k["K2"] > 0, f"the rebuild launched no K2: {rebuild_k}")
    print(f"[11] osd.{victim} (data positions in {held} of the image's PGs) "
          f"SIGKILLed and marked down: the degraded export took {degraded_s:.3f} s "
          f"({image_bytes / degraded_s / 1e9:.4f} GB/s), sha256 equal to the image; launches "
          f"{degraded_k}; {len(missed)} objects of its PGs rewritten while it was down; "
          f"respawned, clean {rejoin_s:.3f} s later, launches over the rebuild {rebuild_k}; "
          f"the rewritten objects read back")

    # 6. the ObjectCacher: 4 KiB writes through a cached handle
    base = (image_bytes // 4) // object_bytes * object_bytes
    cache_data = rng.bytes(cache_bytes)
    with Image(io, "img", cache=True) as img:
        t0 = time.perf_counter()
        for off in range(0, cache_bytes, RBD_IO_SIZE):
            img.write(base + off, cache_data[off:off + RBD_IO_SIZE])
        img.flush()
        cache_s = time.perf_counter() - t0
        backend_writes = img._cache.backend_writes
    with Image(io, "img") as img:
        check(img.read(base, cache_bytes) == cache_data, "the cached writes read back uncached")
    print(f"[11] {cache_bytes // RBD_IO_SIZE} cached writes of {RBD_IO_SIZE} B flushed in "
          f"{cache_s:.3f} s as {backend_writes} backend writes; an uncached handle reads them")

    # 7. a journaled image on a 3-replica pool mirrored into another
    c.pools["mirror_src"] = c.rados.pool_create("mirsrc", pg_num=CLUSTER_PG_NUM, size=3)
    c.pools["mirror_dst"] = c.rados.pool_create("mirdst", pg_num=CLUSTER_PG_NUM, size=3)
    _pool_clean(c, "the mirror pools never went active+clean")
    src_io, dst_io = c.rados.open_ioctx("mirsrc"), c.rados.open_ioctx("mirdst")
    RBD().create(src_io, "jimg", mirror_bytes, stripe_unit=object_bytes,
                 object_size=object_bytes, features="journaling")
    mir_data = bytearray(rng.bytes(mirror_bytes))
    with Image(src_io, "jimg") as img:
        for off in range(0, mirror_bytes, object_bytes):
            img.write(off, bytes(mir_data[off:off + object_bytes]))
    d = MirrorDaemon(src_io, dst_io, interval=0.0)
    try:
        t0 = time.perf_counter()
        first = d.replay_once()
        tail = rng.bytes(object_bytes // 2)
        with Image(src_io, "jimg") as img:
            img.write(object_bytes // 4, tail)
            img.discard(mirror_bytes - object_bytes, object_bytes)
        mir_data[object_bytes // 4:object_bytes // 4 + len(tail)] = tail
        mir_data[mirror_bytes - object_bytes:] = bytes(object_bytes)
        second = d.replay_once()
        mirror_s = time.perf_counter() - t0
    finally:
        d.stop()
    with Image(dst_io, "jimg") as img:
        check(img.read(0, mirror_bytes) == bytes(mir_data), "the mirrored image differs")
    check(second == 2, f"the tail replayed {second} entries, not 2")
    print(f"[11] journaled {mirror_bytes} B image mirrored into a second pool in "
          f"{mirror_s:.3f} s ({first} then {second} journal entries replayed), equal")

    after = _launches_by_osd(c, osds)
    delta = _launch_delta(launches0, after, restarted={victim: at_kill})
    counts = _sum_launches(delta)
    phase_s = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    gbps = {"import_GBps": image_bytes / import_s / 1e9,
            "export_GBps": image_bytes / export_s / 1e9,
            "degraded_export_GBps": image_bytes / degraded_s / 1e9}
    print(f"[11] rbd phase took {phase_s:.1f} s; launches {counts}; on {smi.splitlines()[0]} "
          "(host clock): " + ", ".join(f"{key} {v:.4f}" for key, v in gbps.items()))
    return {
        "card": smi.splitlines()[0],
        "config": {"pool": f"isa k={k} m={m}", "pg_num": CLUSTER_PG_NUM,
                   "image_bytes": image_bytes, "object_bytes": object_bytes,
                   "stripe_count": 1, "features": RBD_FEATURES, "io_size": RBD_IO_SIZE,
                   "io_threads": RBD_IO_THREADS, "random_writes": random_writes,
                   "overwrite_bytes": overwrite, "cache_bytes": cache_bytes,
                   "mirror_bytes": mirror_bytes, "osds": osds, "device": device},
        **gbps,
        "random_write_iops": random_writes / write_s,
        "random_write_latency_ms": {"p50": p50 * 1e3, "p99": p99 * 1e3},
        "sha256": {"source": src_sha, "export": export_sha, "degraded_export": degraded_sha,
                   "expected_after_writes": expect_sha},
        "diff_from_snap_objects": touched, "victim": victim,
        "rewritten_while_down": missed,
        "cache": {"writes": cache_bytes // RBD_IO_SIZE, "backend_writes": backend_writes},
        "mirror_entries": [first, second],
        "launches": counts, "import_encode_counters": import_enc,
        "launches_by_step": {"import": import_k, "export": _sum_launches(export_delta),
                             "random_writes": _sum_launches(write_delta),
                             "degraded_export": degraded_k, "rebuild": rebuild_k},
        "seconds": {"import": import_s, "export": export_s, "random_writes": write_s,
                    "snap_overwrite_reads": snap_s, "degraded_export": degraded_s,
                    "rejoin_to_clean": rejoin_s, "cache": cache_s, "mirror": mirror_s,
                    "phase": phase_s},
    }


RGW_OBJECTS = 256
RGW_OBJECT_BYTES = 4 << 20  # rgw_max_chunk_size: one rados object a PUT
RGW_CLIENTS = 16  # concurrent HTTP clients
RGW_PAGE = 100  # ListObjects max-keys
RGW_MP_BYTES = 64 << 20
RGW_PART_BYTES = 5 << 20  # S3's and rgw_multipart_min_part_size's minimum part
RGW_SMALL = 512
RGW_SMALL_BYTES = 4096
RGW_DEGRADED_PUTS = 8  # objects overwritten while an OSD is down, rebuilt on its return


def _s3(port: int, method: str, path: str, body: bytes = b"", headers=None,
        query: dict | None = None) -> tuple[int, bytes, dict]:
    """One HTTP request to a gateway on 127.0.0.1: status, body, headers."""
    import http.client
    import urllib.parse

    url = path + ("?" + urllib.parse.urlencode(query) if query else "")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=CLUSTER_WAIT_S)
    try:
        conn.request(method, url, body=body or None, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _s3_many(calls, workers: int = RGW_CLIENTS) -> tuple[list, list]:
    """``calls`` of ``_s3`` arguments, ``workers`` at a time: each
    reply and each request's seconds, in order."""
    def one(args):
        t0 = time.perf_counter()
        got = _s3(*args)
        return got, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        done = list(ex.map(one, calls))
    return [d[0] for d in done], [d[1] for d in done]


def _pct(lat: list, q: float) -> float:
    lat = sorted(lat)
    return lat[min(len(lat) - 1, int(len(lat) * q))]


def _fired(k: dict) -> str:
    return "+".join(n for n in ("K1", "K2") if k[n]) or "none"


def phase_rgw(smi: str, c, device: str, k: int, m: int, objects: int = RGW_OBJECTS,
              object_bytes: int = RGW_OBJECT_BYTES, mp_bytes: int = RGW_MP_BYTES,
              part_bytes: int = RGW_PART_BYTES, small: int = RGW_SMALL) -> dict:
    """The object gateway on phase 10's fleet: an ``RGW`` in this
    process over an isa k=m pool, serving S3 on 127.0.0.1 to
    concurrent HTTP clients; then the fleet's own ``rgw.0`` role."""
    import hashlib

    from ceph_tpu_torch.rgw import RGW, sign_request

    rng = np.random.default_rng(SEED + 13)
    osds = c.spec.data["osds"]
    t_phase = time.perf_counter()
    launches0 = _launches_by_osd(c, osds)

    # 1. the pool and the gateway
    c.pools["rgw"] = c.rados.pool_create("rgwecpool", pool_type=3, pg_num=CLUSTER_PG_NUM,
                                         erasure_code_profile="isa")
    _pool_clean(c, "the gateway's pool never went active+clean")
    io = c.rados.open_ioctx("rgwecpool")
    gw = RGW(io, name="rgw.smoke")
    agw = RGW(io, auth=True, name="rgw.smoke.auth")
    port, aport = gw.serve(), agw.serve()
    try:
        check(_s3(port, "PUT", "/big")[0] == 200, "PUT bucket")
        check(_s3(port, "PUT", "/small")[0] == 200, "PUT small bucket")

        # 2. the PUTs: 16 clients at once
        block = rng.bytes(objects * object_bytes)
        names = [f"obj{i:03d}" for i in range(objects)]
        model = {n: block[i * object_bytes:(i + 1) * object_bytes] for i, n in enumerate(names)}
        del block
        before = _launches_by_osd(c, osds)
        enc0 = _encode_counters(c, osds)
        t0 = time.perf_counter()
        replies, put_lat = _s3_many([(port, "PUT", f"/big/{n}", model[n]) for n in names])
        put_s = time.perf_counter() - t0
        put_delta = _launch_delta(before, _launches_by_osd(c, osds))
        put_enc = {key: v - enc0[key] for key, v in _encode_counters(c, osds).items()}
        for n, (status, _b, hdrs) in zip(names, replies):
            check(status == 200, f"PUT {n}: {status}")
            check(hdrs.get("ETag") == f'"{hashlib.md5(model[n]).hexdigest()}"',
                  f"PUT {n}: ETag {hdrs.get('ETag')} is not the body's md5")
        put_k = _sum_launches(put_delta)
        print(f"[13] PUT {objects} objects of {object_bytes} B, {RGW_CLIENTS} clients: "
              f"{put_s:.3f} s ({objects * object_bytes / put_s / 1e9:.4f} GB/s), p50 "
              f"{_pct(put_lat, 0.5) * 1e3:.1f} ms p99 {_pct(put_lat, 0.99) * 1e3:.1f} ms; "
              f"every ETag the body's md5; launches {put_k} ({_fired(put_k)}); encode "
              f"counters {put_enc}")

        # 3. every object back, and the listing in pages
        sha = {n: hashlib.sha256(d).hexdigest() for n, d in model.items()}

        def get_all(label: str) -> float:
            t0 = time.perf_counter()
            replies, _lat = _s3_many([(port, "GET", f"/big/{n}") for n in names])
            took = time.perf_counter() - t0
            for n, (status, body, _h) in zip(names, replies):
                check(status == 200 and hashlib.sha256(body).hexdigest() == sha[n],
                      f"{label} GET {n}: {status}, sha256 differs")
            return took

        get_s = get_all("")
        listed, marker, pages = [], "", 0
        while True:
            q = {"max-keys": str(RGW_PAGE), **({"marker": marker} if marker else {})}
            status, body, _h = _s3(port, "GET", "/big", query=q)
            check(status == 200, f"ListObjects page {pages}: {status}")
            keys = re.findall(rb"<Key>([^<]*)</Key>", body)
            listed += [x.decode() for x in keys]
            pages += 1
            if b"<IsTruncated>true</IsTruncated>" not in body:
                break
            marker = listed[-1]
        check(listed == names, f"ListObjects listed {len(listed)} keys, not the {objects} put")
        print(f"[13] GET every object back in {get_s:.3f} s "
              f"({objects * object_bytes / get_s / 1e9:.4f} GB/s), sha256 equal; ListObjects "
              f"at max-keys={RGW_PAGE}: {pages} pages, all {objects} keys in order")

        # 4. a multipart upload
        mp = rng.bytes(mp_bytes)
        status, body, _h = _s3(port, "POST", "/big/multipart.bin", query={"uploads": ""})
        check(status == 200, f"initiate multipart: {status}")
        uid = re.search(rb"<UploadId>([^<]+)</UploadId>", body).group(1).decode()
        parts = [mp[o:o + part_bytes] for o in range(0, mp_bytes, part_bytes)]
        t0 = time.perf_counter()
        for n, part in enumerate(parts, 1):
            status, _b, _h = _s3(port, "PUT", "/big/multipart.bin", part,
                                 query={"uploadId": uid, "partNumber": str(n)})
            check(status == 200, f"part {n}: {status}")
        status, body, _h = _s3(port, "POST", "/big/multipart.bin", query={"uploadId": uid})
        mp_s = time.perf_counter() - t0
        etag = re.search(rb"<ETag>\"?([^<\"]+)\"?</ETag>", body).group(1).decode()
        check(status == 200 and etag.endswith(f"-{len(parts)}"),
              f"complete multipart: {status}, ETag {etag}")
        status, body, _h = _s3(port, "GET", "/big/multipart.bin")
        check(status == 200 and body == mp, "the multipart object reads back different")
        print(f"[13] multipart upload of {mp_bytes} B in {len(parts)} parts of {part_bytes} B "
              f"completed in {mp_s:.3f} s, ETag {etag}, read back equal")

        # 5. small objects: the index-bound case
        smalls = [rng.bytes(RGW_SMALL_BYTES) for _ in range(small)]
        t0 = time.perf_counter()
        replies, small_lat = _s3_many([(port, "PUT", f"/small/s{i:04d}", d)
                                       for i, d in enumerate(smalls)])
        small_s = time.perf_counter() - t0
        check(all(r[0] == 200 for r in replies), "a small PUT failed")
        print(f"[13] {small} PUTs of {RGW_SMALL_BYTES} B, {RGW_CLIENTS} in flight: "
              f"{small / small_s:.1f} ops/s, p50 {_pct(small_lat, 0.5) * 1e3:.2f} ms p99 "
              f"{_pct(small_lat, 0.99) * 1e3:.2f} ms")

        # 6. SigV4 on an auth=True gateway
        access, secret = agw.create_user("smoke")

        def signed(method, path, body=b""):
            return _s3(aport, method, path, body,
                       headers=sign_request(method, path, {}, body, access, secret))

        sig_body = rng.bytes(65536)
        check(signed("PUT", "/signed")[0] == 200, "signed PUT bucket")
        check(signed("PUT", "/signed/o", sig_body)[0] == 200, "signed PUT")
        got = signed("GET", "/signed/o")
        check(got[0] == 200 and got[1] == sig_body, "signed GET")
        anon = _s3(aport, "PUT", "/signed/anon", b"x")[0]
        check(anon == 403, f"an unsigned PUT got {anon}, not 403")
        print("[13] SigV4: signed PUT and GET through sign_request answered 200, equal; an "
              f"unsigned PUT {anon}")

        # 7. an OSD with data positions killed: degraded GETs, then its rebuild
        victim, held = _busiest_data_osd(c, c.pools["rgw"], k)
        before = _launches_by_osd(c, osds)
        at_kill = c.admin(victim, "kernel launches")
        c.sup.kill(f"osd.{victim}", hold=True)
        rc, _b, outs = c.rados.mon_command({"prefix": "osd down", "id": victim})
        check(rc == 0, f"osd down {victim}: {outs}")
        c.wait(lambda: not c.rados.monc.osdmap.is_up(victim), f"osd.{victim} never marked down",
               60)
        degraded_s = get_all("degraded")
        status, body, _h = _s3(port, "GET", "/big/multipart.bin")
        check(status == 200 and body == mp, "the degraded multipart GET differs")
        live = {o: c.admin(o, "kernel launches") for o in range(osds) if o != victim}
        degraded_k = _sum_launches(_launch_delta({o: before[o] for o in live}, live))
        # objects overwritten while it is down: its return rebuilds their shards
        rewritten = names[:RGW_DEGRADED_PUTS]
        for n in rewritten:
            model[n] = rng.bytes(object_bytes)
            sha[n] = hashlib.sha256(model[n]).hexdigest()
        replies, _lat = _s3_many([(port, "PUT", f"/big/{n}", model[n]) for n in rewritten])
        check(all(r[0] == 200 for r in replies), "a PUT while an OSD was down failed")
        t0 = time.perf_counter()
        c.sup.respawn(f"osd.{victim}")
        c.sup.wait_ready([f"osd.{victim}"], timeout=PROC_READY_S)
        c.wait(lambda: c.rados.monc.osdmap.is_up(victim), f"osd.{victim} never rejoined", 60)
        _pool_clean(c, f"never clean after osd.{victim}'s respawn")
        rejoin_s = time.perf_counter() - t0
        after = {o: c.admin(o, "kernel launches") for o in range(osds)}
        rebuild_k = _sum_launches(_launch_delta(live, {o: after[o] for o in live}))
        replies, _lat = _s3_many([(port, "GET", f"/big/{n}") for n in rewritten])
        check(all(r[0] == 200 and r[1] == model[n] for n, r in zip(rewritten, replies)),
              "an object PUT while an OSD was down reads back different")
        if device == "cuda":
            check(put_k["K1"] + put_k["K2"] > 0, f"the PUTs launched no kernel: {put_delta}")
            check(degraded_k["K1"] + degraded_k["K2"] + rebuild_k["K1"] + rebuild_k["K2"] > 0,
                  f"the degraded GETs and the rebuild launched no kernel: {degraded_k}, "
                  f"{rebuild_k}")
        print(f"[13] osd.{victim} (data positions in {held} of the pool's PGs) SIGKILLed and "
              f"marked down: every object GET back degraded in {degraded_s:.3f} s "
              f"({objects * object_bytes / degraded_s / 1e9:.4f} GB/s), sha256 equal; launches "
              f"{degraded_k} ({_fired(degraded_k)}); {len(rewritten)} objects PUT while it was "
              f"down; respawned, clean {rejoin_s:.3f} s later, launches over the rebuild "
              f"{rebuild_k} ({_fired(rebuild_k)}); the objects PUT meanwhile read back equal")

        # 8. radosgw-admin as a process
        host, mport = c.spec.mon_addrs[0]
        stats = {}
        for bucket, want in (("big", objects + 1), ("small", small)):
            proc = subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.tools.rgw_admin", "-m",
                 f"{host}:{mport}", "-p", "rgwecpool", "bucket", "stats", "--bucket", bucket],
                capture_output=True, text=True, timeout=CLUSTER_WAIT_S,
                cwd=pathlib.Path(__file__).resolve().parent)
            check(proc.returncode == 0, f"rgw_admin bucket stats: {proc.stderr[-2000:]}")
            stats[bucket] = json.loads(proc.stdout)
            check(stats[bucket]["entries"] == want,
                  f"rgw_admin counts {stats[bucket]['entries']} in {bucket}, not {want}")
        print(f"[13] rgw_admin bucket stats (a process): big {stats['big']['entries']} "
              f"entries, small {stats['small']['entries']}")
    finally:
        gw.shutdown()
        agw.shutdown()

    # 9. the fleet's own rgw.0 role, on its replicated rgwpool
    fleet_port = c.sup.ready_info("rgw.0")["port"]
    fbody = rng.bytes(object_bytes)
    check(_s3(fleet_port, "PUT", "/fleet")[0] == 200, "rgw.0: PUT bucket")
    check(_s3(fleet_port, "PUT", "/fleet/o", fbody)[0] == 200, "rgw.0: PUT")
    got = _s3(fleet_port, "GET", "/fleet/o")
    check(got[0] == 200 and got[1] == fbody, "rgw.0: GET differs")
    print(f"[13] the fleet's rgw.0 (port {fleet_port}, pool rgwpool) created a bucket and "
          f"took a {object_bytes} B PUT and GET, equal")

    after = _launches_by_osd(c, osds)
    counts = _sum_launches(_launch_delta(launches0, after, restarted={victim: at_kill}))
    phase_s = time.perf_counter() - t_phase
    logical = objects * object_bytes
    out = {
        "put_GBps": logical / put_s / 1e9, "get_GBps": logical / get_s / 1e9,
        "degraded_get_GBps": logical / degraded_s / 1e9,
        "small_put_ops_per_s": small / small_s,
        "small_put_latency_ms": {"p50": _pct(small_lat, 0.5) * 1e3,
                                 "p99": _pct(small_lat, 0.99) * 1e3},
        "put_latency_ms": {"p50": _pct(put_lat, 0.5) * 1e3, "p99": _pct(put_lat, 0.99) * 1e3},
    }
    print(f"[13] gateway phase took {phase_s:.1f} s; launches {counts}; on "
          f"{smi.splitlines()[0]} (host clock): "
          + ", ".join(f"{key} {v}" for key, v in out.items()))
    return {
        "card": smi.splitlines()[0],
        "config": {"pool": f"isa k={k} m={m}", "stripe_unit": 4096, "pg_num": CLUSTER_PG_NUM,
                   "objects": objects, "object_bytes": object_bytes, "clients": RGW_CLIENTS,
                   "multipart_bytes": mp_bytes, "part_bytes": part_bytes,
                   "small_objects": small, "small_bytes": RGW_SMALL_BYTES,
                   "osds": osds, "device": device},
        **out, "victim": victim, "listing_pages": pages, "multipart_etag": etag,
        "admin_entries": {b: s["entries"] for b, s in stats.items()},
        "launches": counts, "put_encode_counters": put_enc,
        "launches_by_step": {"put": put_k, "degraded_get": degraded_k, "rebuild": rebuild_k},
        "seconds": {"put": put_s, "get": get_s, "multipart": mp_s, "small_puts": small_s,
                    "degraded_get": degraded_s, "rejoin_to_clean": rejoin_s, "phase": phase_s},
    }


FS_FILES = 32
FS_FILE_BYTES = 16 << 20
FS_LAYOUT = (4 << 20, 1, 4 << 20)  # CephFS's default layout: unit, count, object size
FS_WRITERS = 8  # files written at once
FS_MDTEST = 1000  # the mdtest burst's files, run by ``--gateways``
FS_BURST = 100  # the default run's burst of mdtest's shape, cut for the time budget (PERF.md §4)


def _mds_roles(c) -> tuple[dict, list]:
    """The MDS map's actives (rank -> role) and standby roles."""
    rc, outb, outs = c.rados.mon_command({"prefix": "mds stat"})
    check(rc == 0, f"mds stat: {outs}")
    st = json.loads(outb)

    def role(e):
        return f"mds.{e['name'][3:]}" if e["name"].startswith("mds") else e["name"]

    return ({r: role(e) for r, e in st.get("actives", {}).items()},
            [role(e) for e in st.get("standbys", [])])


def phase_fs(smi: str, c, device: str, k: int, m: int, files: int = FS_FILES,
             file_bytes: int = FS_FILE_BYTES, burst: int = FS_BURST) -> dict:
    """The file system on phase 10's fleet: its mds.0 and mds.1 over
    ``fsmeta``, an ``MDSClient`` in this process with its file data on
    an isa k=m pool; then the active MDS process killed."""
    import hashlib

    from ceph_tpu_torch.mds import MDSClient
    from ceph_tpu_torch.osdc.striper import StripeLayout

    rng = np.random.default_rng(SEED + 14)
    osds = c.spec.data["osds"]
    t_phase = time.perf_counter()
    launches0 = _launches_by_osd(c, osds)

    # 1. the MDS pair and the data pool
    c.wait(lambda: len(_mds_roles(c)[0]) == 1 and len(_mds_roles(c)[1]) == 1,
           "no active and standby MDS", 60)
    actives, standbys = _mds_roles(c)
    active = actives["0"]
    c.pools["fs"] = c.rados.pool_create("fsecpool", pool_type=3, pg_num=CLUSTER_PG_NUM,
                                        erasure_code_profile="isa")
    _pool_clean(c, "the file data pool never went active+clean")
    fs = MDSClient(c.rados, "fsecpool", name="smoke14", layout=StripeLayout(*FS_LAYOUT),
                   op_timeout=CLUSTER_WAIT_S)
    try:
        # 2. files written and read back
        fs.mkdir("/data")
        block = rng.bytes(files * file_bytes)
        model = {f"/data/f{i:02d}": block[i * file_bytes:(i + 1) * file_bytes]
                 for i in range(files)}
        del block
        sha = {p: hashlib.sha256(d).hexdigest() for p, d in model.items()}

        def write(path):
            fs.create(path)
            return fs.write(path, 0, model[path])

        before = _launches_by_osd(c, osds)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(FS_WRITERS) as ex:
            written = list(ex.map(write, model))
        write_s = time.perf_counter() - t0
        check(written == [file_bytes] * files, f"short writes: {written}")
        write_k = _sum_launches(_launch_delta(before, _launches_by_osd(c, osds)))

        def read_all(label: str) -> float:
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(FS_WRITERS) as ex:
                got = list(ex.map(fs.read, model))
            took = time.perf_counter() - t0
            for path, data in zip(model, got):
                check(hashlib.sha256(data).hexdigest() == sha[path],
                      f"{label} read of {path} differs")
            return took

        read_s = read_all("")
        if device == "cuda":
            check(write_k["K1"] > 0, f"the file writes launched no K1: {write_k}")
        print(f"[14] {files} files of {file_bytes} B (layout {FS_LAYOUT}), {FS_WRITERS} at "
              f"once: written in {write_s:.3f} s ({files * file_bytes / write_s / 1e9:.4f} "
              f"GB/s), read back in {read_s:.3f} s ({files * file_bytes / read_s / 1e9:.4f} "
              f"GB/s), sha256 equal; launches over the writes {write_k} ({_fired(write_k)})")

        # 3. a burst of mdtest's shape in one directory
        fs.mkdir("/mdtest")
        items = [f"/mdtest/file.{i}" for i in range(burst)]
        rates = {}
        t0 = time.perf_counter()
        for p in items:
            fs.create(p)
        rates["create"] = burst / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for p in items:
            check(fs.stat(p)["type"] == "file", f"stat {p}")
        rates["stat"] = burst / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        listed = fs.readdir("/mdtest")
        list_s = time.perf_counter() - t0
        check(sorted(listed) == sorted(p.rsplit("/", 1)[1] for p in items),
              f"readdir listed {len(listed)} of {burst}")
        rates["readdir_entries"] = burst / list_s
        t0 = time.perf_counter()
        for p in items:
            fs.unlink(p)
        rates["remove"] = burst / (time.perf_counter() - t0)
        check(fs.readdir("/mdtest") == [], "the mdtest directory is not empty")
        print(f"[14] metadata burst of {burst} files in one directory (ops/s, one client): "
              + ", ".join(f"{key} {v:.1f}" for key, v in rates.items()))

        # 4. the active MDS process killed: the standby takes over
        c.sup.kill(active, hold=True)
        t0 = time.perf_counter()
        with fs._lock:  # the stat goes to the MDS, not to the client's cache
            fs._stat_cache.clear()
            fs._dir_cache.clear()
        st = fs.stat("/data/f00")
        failover_s = time.perf_counter() - t0
        check(st["size"] == file_bytes, f"stat after the failover: {st}")
        actives2, _sb = _mds_roles(c)
        check(actives2.get("0") in standbys, f"rank 0 is {actives2}, not the standby {standbys}")
        reread_s = read_all("post-failover")
        t0 = time.perf_counter()
        c.sup.respawn(active)
        c.sup.wait_ready([active], timeout=PROC_READY_S)
        c.wait(lambda: active in _mds_roles(c)[1], f"{active} never rejoined as standby", 60)
        rejoin_s = time.perf_counter() - t0
        print(f"[14] {active} (rank 0) SIGKILLed: {actives2['0']} active and a client stat "
              f"answered {failover_s:.3f} s later (the monitor's MDS grace is 4 s); every file "
              f"read back equal in {reread_s:.3f} s; {active} respawned as standby in "
              f"{rejoin_s:.3f} s")
    finally:
        fs.close()

    counts = _sum_launches(_launch_delta(launches0, _launches_by_osd(c, osds)))
    phase_s = time.perf_counter() - t_phase
    logical = files * file_bytes
    out = {"write_GBps": logical / write_s / 1e9, "read_GBps": logical / read_s / 1e9,
           "metadata_ops_per_s": rates, "failover_s": failover_s}
    print(f"[14] file system phase took {phase_s:.1f} s; launches {counts}; on "
          f"{smi.splitlines()[0]} (host clock): " + json.dumps(out))
    return {
        "card": smi.splitlines()[0],
        "config": {"data_pool": f"isa k={k} m={m}", "pg_num": CLUSTER_PG_NUM,
                   "meta_pool": "fsmeta (the mds role's, replicated)", "files": files,
                   "file_bytes": file_bytes, "layout": FS_LAYOUT, "writers": FS_WRITERS,
                   "metadata_files": burst, "osds": osds, "device": device},
        **out, "killed": active, "promoted": actives2["0"],
        "launches": counts, "launches_by_step": {"write": write_k},
        "seconds": {"write": write_s, "read": read_s, "readdir": list_s,
                    "reread_after_failover": reread_s, "respawn_to_standby": rejoin_s,
                    "phase": phase_s},
    }


THRASH_SEED = 20260807  # the JAX package's tier-1 gate schedule (tests/test_qa_thrasher.py)
THRASH_DURATION_S = 30.0
THRASH_OSDS = 3


def phase_thrash(smi: str, device: str = "cuda", seed: int = THRASH_SEED,
                 duration: float = THRASH_DURATION_S) -> dict:
    """The qa thrasher on the card: the gate's seeded fault schedule
    against 3 in-process ``OSD(device=...)`` over WAL-fronted MemStores,
    a monitor and a manager, under the consistency oracle."""
    from ceph_tpu_torch.msg import NetworkStack
    from ceph_tpu_torch.ops import bitplane_gf, packed_gf
    from ceph_tpu_torch.ops.kernel_stats import kernel_stats
    from ceph_tpu_torch.qa import Schedule
    from ceph_tpu_torch.qa.thrasher import Thrasher

    sched = Schedule.from_seed(seed, duration=duration, osds=THRASH_OSDS)
    workdir = pathlib.Path(__file__).resolve().parent / "build" / "p12"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    thr = Thrasher(sched, convergence_timeout=60.0, device=device, workdir=str(workdir))
    ks = kernel_stats()
    crc0 = ks.dump().get("l_tpu_scrub_crc32c_calls", 0)
    packed_gf.launches = bitplane_gf.launches = 0
    t0 = time.perf_counter()
    report = thr.run()
    phase_s = time.perf_counter() - t0
    counts = {"K1": packed_gf.launches, "K2": bitplane_gf.launches}
    crc_calls = ks.dump().get("l_tpu_scrub_crc32c_calls", 0) - crc0
    shutil.rmtree(workdir, ignore_errors=True)
    check(report["violations"] == [],
          f"oracle violations: {json.dumps(report['violations'])}")
    check(report["converged"], "the thrashed cluster never reached HEALTH_OK")
    check(report["events_applied"] >= len(sched.events) // 2,
          f"the guards skipped too much: {report['trace']}")
    check(report["ops"] > 50, f"the workload barely ran: {report['ops']} ops")
    check(report["audited"] > 0, "the final audit read nothing")
    check(NetworkStack.live() is None, "a messenger reactor outlived the thrash")
    skipped = [e for e in report["trace"] if not e["applied"]]
    replayed = sum(report["wal_replays"].values())
    print(f"[12] thrash seed {seed}, {duration:g} s, {THRASH_OSDS} OSDs on {device}: "
          f"{report['events_applied']} of {len(sched.events)} events applied "
          f"({len(skipped)} skipped: {[(e['kind'], e['note']) for e in skipped]}), "
          f"{report['ops']} ops ({report['op_errors']} errors), {report['audited']} objects "
          f"audited, 0 violations, converged; {replayed} WAL records replayed, "
          f"{crc_calls} device crc calls, launches {counts}; {phase_s:.1f} s")
    return {
        "card": smi.splitlines()[0], "seed": seed, "duration_s": duration,
        "osds": THRASH_OSDS, "device": device, "events": len(sched.events),
        "events_applied": report["events_applied"], "events_skipped": len(skipped),
        "skipped": [(e["kind"], e["note"]) for e in skipped],
        "ops": report["ops"], "op_errors": report["op_errors"], "audited": report["audited"],
        "converged": report["converged"], "violations": report["violations"],
        "wal_records_replayed": replayed, "wal_replays": report["wal_replays"],
        "device_crc32c_calls": crc_calls, "launches": counts, "phase_s": phase_s,
    }


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def gateways_at_full_size(smi: str) -> int:
    """Phases 10, 13 and 14 alone, with the metadata burst at mdtest's
    1000 files: the gateway and file system rates PERF.md reports."""
    def later_phases(c, k, m) -> dict:
        rgw = phase_rgw(smi, c, "cuda", k, m)
        fs = phase_fs(smi, c, "cuda", k, m, burst=FS_MDTEST)
        return {"rgw": rgw, "fs": fs, "victims": [f"osd.{rgw['victim']}", fs["killed"]]}

    processes = phase_processes(smi, during=later_phases)
    later = processes.pop("during")
    print(json.dumps({"processes": processes}))
    print(json.dumps({"rgw": later["rgw"]}))
    print(json.dumps({"fs": later["fs"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] not in ([], ["--gateways"]):
        print("usage: chip_smoke.py [--gateways]", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--gateways"]:
        return gateways_at_full_size(phase_build())
    # read when the residency cache is first made, in phase 6
    os.environ["CEPH_TPU_RESIDENCY_BYTES"] = str(RESIDENCY_BYTES)
    smi = phase_build()
    errs = {"K1": 0, "K2": 0}
    phase_kernels(errs)
    counts = phase_main_path()
    phase_layered(smi)
    rows = phase_resident()
    # a worker that dies breaks the pool (BrokenProcessPool), it does not hang
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        crush = phase_crush(smi, pool)
        store = phase_store(smi)
        osdmap = phase_osdmap(smi, pool)
        compiler = phase_compiler(smi, pool, crush)
    mesh = phase_mesh(smi)
    wire = phase_wire(smi)
    cluster = phase_cluster(smi)
    def later_phases(c, k, m) -> dict:
        rbd = phase_rbd(smi, c, "cuda", k, m)
        rgw = phase_rgw(smi, c, "cuda", k, m)
        fs = phase_fs(smi, c, "cuda", k, m)
        return {"rbd": rbd, "rgw": rgw, "fs": fs,
                "victims": [f"osd.{rbd['victim']}", f"osd.{rgw['victim']}", fs["killed"]]}

    processes = phase_processes(smi, during=later_phases)
    later = processes.pop("during")
    rbd, rgw, fs = later["rbd"], later["rgw"], later["fs"]
    thrash = phase_thrash(smi)
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
            "launches_by_path": {"main (3)": counts[key], "store (6)": store["launches"][key],
                                 "wire (8)": wire["launches"][key],
                                 "cluster (9)": cluster["launches"][key],
                                 "processes (10)": processes["launches"][key],
                                 "rbd (11)": rbd["launches"][key],
                                 "thrash (12)": thrash["launches"][key],
                                 "rgw (13)": rgw["launches"][key],
                                 "fs (14)": fs["launches"][key],
                                 "mesh (16)": mesh["launches"][key]},
        })
    root = crush["straw2_kernel"]["root"]
    kernels.append({
        "name": "straw2_draw", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_kernels.cu",
        "replaces": "ceph_tpu/crush/jaxmap.py:811 (straw2_draw, XLA)",
        "launches": crush["draw_launches"], "ms": root["kernel_ms"],
        "plain_ms": root["plain_ms"], "bound_ms": root["bound_ms"],
        "bound_by": "instructions issued", "library_ms": None,
        "library_note": "no PyTorch call computes a straw2 draw",
        "shape": "the remap cell's root: 2^19 lanes x 5 candidates x 63 columns",
    })
    print(json.dumps({"crush": crush}))
    print(json.dumps({"store": store}))
    print(json.dumps({"osdmap": osdmap}))
    print(json.dumps({"wire": wire}))
    print(json.dumps({"cluster": cluster}))
    print(json.dumps({"processes": processes}))
    print(json.dumps({"rbd": rbd}))
    print(json.dumps({"thrash": thrash}))
    print(json.dumps({"rgw": rgw}))
    print(json.dumps({"fs": fs}))
    print(json.dumps({"compiler": compiler}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
