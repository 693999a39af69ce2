"""Time kernel K1 or K2 beside another build of it, on one CUDA card.

    python -m ceph_tpu_torch.tools.kernel_compare --kernel K1|K2 --baseline OLD.cu

``OLD.cu`` is another version of ``csrc/gf8_kernels.cu`` (for example one
taken from an earlier commit with ``git show``).  This tool builds it with
the package's nvcc flags into ``build/ceph_tpu_torch/compare/`` and calls
the kernel's C entry (``gf8_packed_stripes`` for K1,
``gf8_bitplane_stripes`` for K2; both have one signature) in both builds
on the same tensors, through the same ctypes call.  At each shape both
outputs must equal the kernel's plain version; then the two are timed
with CUDA events in turns (old, new, new, old), and for batches of at most
256 stripes also from a CUDA graph of 100 launches (the device time
alone).  One JSON line per shape carries both times, the words per thread
the package's build takes, and the byte bound.  Before that it prints
ptxas's registers and spills of the kernel in both builds and, for each
of its instances in each build, the count of each SASS opcode
(``cuobjdump -sass``).

The shapes, k=8 and 128 KiB chunks unless named.  K1: the 1 GiB encode
(B=1024, m=3), the 1 GiB decode of erasures {1, 6} (m=2), encodes of
B = 1 (the registry path's 1 MiB object), 8 and 64 stripes, and the 1 GiB
encode on rows offset by 4 bytes (K1's one-word form).  K2: the 1 GiB
encode and decode, the 1 GiB encode on rows offset by 1 byte (its general
form), and one group of the batched routes, B=256 stripes of 4096 bytes.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys

import torch

from .. import gf
from ..ops import _build, bitplane_gf, packed_gf
from ..ops.gf_matmul import matrix_to_device_bitmatrix
from .timing import graph_ms, time_ms

SEED = 20261016
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
# C entry, kernel name in the build, plain version
KERNELS = {
    "K1": ("gf8_packed_stripes", "gf8_packed_kernel", packed_gf.packed_stripes_plain),
    "K2": ("gf8_bitplane_stripes", "gf8_bitplane_kernel", bitplane_gf.gf8_bitplane_plain),
}


def build_other(source: pathlib.Path) -> tuple[pathlib.Path, str]:
    """Build another ``gf8_kernels.cu`` with the package's flags; returns
    the library and what ptxas printed."""
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _build.BUILD_DIR / "compare" / f"lib{source.stem}_{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return out, proc.stderr


def stripes_entry(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _shapes(kernel: str):
    """(label, matrix, B, chunk, byte offset of the rows)."""
    rs83 = gf.reed_sol_vandermonde_coding_matrix(8, 3, 8)
    dec = gf.make_decoding_matrix(rs83, [1, 6], 8, 8)[0]
    chunk = 128 << 10
    if kernel == "K1":
        return [
            ("encode 1 GiB", rs83, 1024, chunk, 0),
            ("decode 1 GiB, erasures {1,6}", dec, 1024, chunk, 0),
            ("encode 1 MiB object", rs83, 1, chunk, 0),
            ("encode 8 objects of 1 MiB", rs83, 8, chunk, 0),
            ("encode 64 objects of 1 MiB", rs83, 64, chunk, 0),
            ("encode 1 GiB, rows offset by 4 bytes", rs83, 1024, chunk, 4),
        ]
    return [
        ("encode 1 GiB", rs83, 1024, chunk, 0),
        ("decode 1 GiB, erasures {1,6}", dec, 1024, chunk, 0),
        ("encode 1 GiB, rows offset by 1 byte", rs83, 1024, chunk, 1),
        ("batched group, B=256 x 4096 B", rs83, 256, 4096, 0),
    ]


def sass_counts(lib_path: pathlib.Path, kernel: str) -> dict[str, collections.Counter]:
    """Opcode counts of each instance of ``kernel`` (``gf8_packed_kernel``
    or ``gf8_bitplane_kernel``) in a built library, by its R and W
    template arguments ("all" for a kernel that has none)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run(
        [tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True
    ).stdout
    counts: dict[str, collections.Counter] = {}
    cur = None
    for line in text.splitlines():
        fn = re.search(rf"Function : \S*{kernel}(?:ILi(\d+)ELi(\d+)E)?", line)
        if fn:
            inst = f"R={fn.group(1)},W={fn.group(2)}" if fn.group(1) else "all"
            cur = counts.setdefault(inst, collections.Counter())
            continue
        if "Function :" in line:
            cur = None
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if cur is not None and op:
            cur[op.group(1)] += 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--baseline", required=True, help="another gf8_kernels.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 2
    entry_name, kernel_name, plain = KERNELS[args.kernel]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    new_path = _build.build()
    old_path, old_ptxas = build_other(pathlib.Path(args.baseline).resolve())
    entry = {
        "new": stripes_entry(_build.library(), entry_name),
        "old": stripes_entry(ctypes.CDLL(str(old_path)), entry_name),
    }
    new_ptxas = _build.build_log.get(_build.SOURCE, "")
    for label, ptxas in (("new", new_ptxas), ("baseline", old_ptxas)):
        for name, res in _build.kernel_resources(ptxas).items():
            if name.startswith(kernel_name):
                print(f"ptxas {label} {name}: {res}")
    for label, path in (("new", new_path), ("baseline", old_path)):
        for inst, ops in sorted(sass_counts(path, kernel_name).items()):
            top = ", ".join(f"{o} {n}" for o, n in ops.most_common(14))
            print(f"sass {label} {kernel_name} {inst}: {sum(ops.values())} instructions; {top}")

    for si, (label, mat, b, chunk, offset) in enumerate(_shapes(args.kernel)):
        m, k = mat.shape
        bm = matrix_to_device_bitmatrix(mat, 8, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + si)
        base = torch.randint(0, 256, (b, k, chunk + offset), dtype=torch.uint8,
                             device="cuda", generator=gen)
        stripes = base[:, :, offset:]
        outs = {who: torch.empty((b, m, chunk), dtype=torch.uint8, device="cuda")
                for who in entry}

        def run(who):
            err = entry[who](
                stripes.data_ptr(), stripes.stride(0), stripes.stride(1),
                outs[who].data_ptr(), b, k, m, chunk, bm.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
            if err:
                raise RuntimeError(f"kernel_compare: {who} launch failed ({err})")

        run("new")
        run("old")
        torch.cuda.synchronize()
        want = plain(bm, stripes)
        if not all(torch.equal(o, want) for o in outs.values()):
            raise RuntimeError(f"kernel_compare: {label}: a kernel disagrees with the plain version")
        words = _build.words_per_thread(stripes, outs["new"])
        del want
        iters = 20 if b * chunk >= 1 << 26 else 200  # a small launch is microseconds
        turns = ("old", "new", "new", "old")
        times = {"old": [], "new": []}
        for who in turns:
            times[who].append(time_ms(lambda: run(who), iters, warmup=1))
        graph = {"old": [], "new": []}
        if b <= 256:
            for who in turns:
                graph[who].append(graph_ms(lambda: run(who)))
        nbytes = b * chunk
        row = {
            "kernel": args.kernel, "shape": label, "B": b, "k": k, "m": m, "chunk": chunk,
            "offset": offset, "words_per_thread": words,
            "new_ms": times["new"], "old_ms": times["old"],
            "new_graph_ms": graph["new"], "old_graph_ms": graph["old"],
            "bound_ms": (k + m) * nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "speedup": sum(times["old"]) / sum(times["new"]),
        }
        print(json.dumps(row))
        del base, stripes, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
