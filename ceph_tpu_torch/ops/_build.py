"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The kernels are compiled from the sources in the checkout at first use,
with ``nvcc`` for Hopper (``sm_90a``), into a shared library with a plain
C interface under ``build/ceph_tpu_torch/`` at the repository root, and
loaded with ``ctypes``.  The library name carries a digest of the source
and flags, so an edited source is rebuilt.  There is no fallback: a
missing ``nvcc`` or a failed build raises.  Each ``.cu`` is its own
library (``library()``: the GF(2^8) kernels K1/K2; ``crush_library()``:
CRUSH's straw2 draw), so an edit to one source rebuilds only its own.
Host C sources (``csrc/*.c``: the crc32c of ``native``) build the same
way with ``cc``.

Every C entry launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; ``launch_stripes`` and
``torchmap.straw2_draw_kernel`` raise when that is not 0 (a refused
launch never runs, and no later synchronise reports it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "ceph_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# host C sources (``csrc/*.c``, e.g. crc32c.c): cc, no ISA flags, so the
# library runs on any x86-64 or arm64 host that shares the build tree
CC_FLAGS = ("-O3", "-shared", "-fPIC")
SOURCE = "gf8_kernels.cu"
CRUSH_SOURCE = "crush_kernels.cu"
# (in, in_sb, in_sk, out, B, k, m, chunk, bm, stream)
_STRIPES_ARGS = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p,
]
ENTRIES = ("gf8_packed_stripes", "gf8_bitplane_stripes")
# (in, in_sb, in_sk, out, chunk) -> the kernels' words per thread, 4 or 1
_WORDS_ARGS = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_longlong,
]
# (x, x0, x1, r, r0, r1, rows, w0, w1, row_const, pos, p0, p1, positions,
#  ids, wdiv, wlive, sizes, items, nb, width, szi, rh, lh, ll, n, c, col,
#  item, stream): pointers and strides as the C entry names them
_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_STRAW2_ARGS = [
    _P, _L, _L, _P, _L, _L, _P, _L, _L, _L, _P, _L, _L, _I,
    _P, _P, _P, _P, _P, _L, _L, _I, _P, _P, _P, _L, _L, _P, _P, _P,
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# what the last build printed (ptxas registers/spills) and how long it took
build_log: dict[str, str] = {}
build_seconds: dict[str, float] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def cc() -> str:
    path = shutil.which("cc")
    if path is None:
        raise RuntimeError("cc not found: the host C library cannot be built")
    return path


def build(source: str = SOURCE) -> pathlib.Path:
    """Compile ``csrc/<source>`` unless a library of the same digest
    exists: a ``.cu`` with nvcc, a ``.c`` with the host ``cc``.  What
    the compiler printed (ptxas's report for a ``.cu``) is kept beside
    the library and in ``build_log[source]``."""
    src = CSRC / source
    compiler, flags = (nvcc, NVCC_FLAGS) if src.suffix == ".cu" else (cc, CC_FLAGS)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    log = out.with_suffix(".ptxas.txt")
    if out.exists():
        if source not in build_log and log.exists():
            build_log[source] = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [compiler(), *flags, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"{compiler()} failed on {src}:\n{proc.stderr}")
    log.write_text(proc.stderr)
    os.replace(tmp, out)
    build_seconds[source] = time.perf_counter() - t0
    build_log[source] = proc.stderr
    return out


def kernel_resources(ptxas: str) -> dict[str, str]:
    """Registers and spills of each kernel in ptxas's report of a build
    (``build_log[source]``): ``{"gf8_packed_kernel<R=3,W=4>": "40
    registers, 0 bytes spill stores, 0 bytes spill loads", ...}``."""
    found: dict[str, list[str]] = {}
    name = None
    for line in ptxas.splitlines():
        hit = re.search(r"(?:entry function '|properties for )(\S+?)'?$", line)
        if hit:
            k = re.search(
                r"(gf8_[a-z]+_kernel|straw2_draw_kernel)(?:ILi(\d+)ELi(\d+)E)?", hit.group(1)
            )
            name = hit.group(1) if k is None else (
                k.group(1) + (f"<R={k.group(2)},W={k.group(3)}>" if k.group(2) else "")
            )
            found.setdefault(name, [])
        elif name and "spill" in line:
            found[name] += [p.strip() for p in line.split(",") if "spill" in p]
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                found[name].insert(0, f"{regs.group(1)} registers")
    return {n: ", ".join(v) for n, v in found.items()}


def _load(source: str, bind) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built (``build``) and bound
    (``bind(lib)`` sets argtypes and restypes) on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
    return lib


def _bind_gf8(lib: ctypes.CDLL) -> None:
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = _STRIPES_ARGS
        fn.restype = ctypes.c_int
    lib.gf8_error_string.argtypes = [ctypes.c_int]
    lib.gf8_error_string.restype = ctypes.c_char_p
    lib.gf8_words_per_thread.argtypes = _WORDS_ARGS
    lib.gf8_words_per_thread.restype = ctypes.c_int
    lib.gf8_bitplane_rows.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gf8_bitplane_rows.restype = ctypes.c_int


def _bind_crush(lib: ctypes.CDLL) -> None:
    lib.crush_straw2_draw.argtypes = _STRAW2_ARGS
    lib.crush_straw2_draw.restype = ctypes.c_int
    lib.crush_error_string.argtypes = [ctypes.c_int]
    lib.crush_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The GF(2^8) kernels K1 and K2 (``gf8_kernels.cu``)."""
    return _load(SOURCE, _bind_gf8)


def crush_library() -> ctypes.CDLL:
    """CRUSH's straw2 draw (``crush_kernels.cu``), launched by
    ``crush.torchmap.straw2_draw_kernel``."""
    return _load(CRUSH_SOURCE, _bind_crush)


def words_per_thread(stripes: torch.Tensor, out: torch.Tensor) -> int:
    """The form both kernels take for these CUDA stripes and this output,
    as the C entries decide it: 4 words a thread (16-byte loads and
    stores) where every address is 16-byte aligned, else 1."""
    return library().gf8_words_per_thread(
        stripes.data_ptr(), stripes.stride(0), stripes.stride(1),
        out.data_ptr(), stripes.shape[2],
    )


def launch_stripes(
    entry: str, bm: torch.Tensor, stripes: torch.Tensor, out: torch.Tensor
) -> None:
    """Launch one of the stripe kernels on the current stream.

    ``stripes`` (B, k, chunk) uint8 may have any batch and row strides
    but unit stride along the chunk; ``out`` is a contiguous (B, m, chunk)
    uint8; ``bm`` a contiguous (m*8, k*8) uint8 0/1 bitmatrix; all on one
    CUDA device.  The caller has checked the kernel's own limits."""
    b, k, chunk = stripes.shape
    m = bm.shape[0] // 8
    for name, t in (("stripes", stripes), ("out", out), ("bitmatrix", bm)):
        if not t.is_cuda or t.dtype != torch.uint8:
            raise ValueError(f"{name} must be a uint8 CUDA tensor")
        if t.device != stripes.device:
            raise ValueError(f"{name} is on {t.device}, stripes on {stripes.device}")
    if chunk > 1 and stripes.stride(2) != 1:
        raise ValueError("stripes need unit stride along the chunk axis")
    if not (out.is_contiguous() and bm.is_contiguous()):
        raise ValueError("out and bitmatrix must be contiguous")
    if tuple(bm.shape) != (m * 8, k * 8) or tuple(out.shape) != (b, m, chunk):
        raise ValueError(
            f"shapes disagree: bitmatrix {tuple(bm.shape)}, "
            f"stripes {tuple(stripes.shape)}, out {tuple(out.shape)}"
        )
    if b * chunk == 0 or m == 0:
        return
    lib = library()
    with torch.cuda.device(stripes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            stripes.data_ptr(), stripes.stride(0), stripes.stride(1),
            out.data_ptr(), b, k, m, chunk, bm.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(
            f"{entry} launch failed: {lib.gf8_error_string(err).decode()}"
        )
