"""Device-batched deep-scrub functions — crc32c over a whole PG's
objects in one device call, plus the re-encode compare reduce.

The reference deep scrub checksums every object with a per-object CPU
crc pass (``build_scrub_map_chunk`` → ``ceph_crc32c``,
src/osd/PGBackend.cc:1175); here the whole batch of objects rides one
call by lifting crc32c to GF(2) linear algebra, exactly as the JAX
package's ``ops/scrub_kernels.py`` does:

- The crc32c register update for one byte, ``crc' = (crc >> 8) ^
  T0[(crc ^ b) & 0xff]``, is linear over GF(2) in (crc, byte):
  ``crc' = L(crc ⊕ b)`` with L a fixed 32×32 bit matrix derived from
  the Castagnoli table (the SAME table ``csrc/crc32c.c`` builds).
- Four bytes at a time: with the little-endian u32 word w,
  ``crc' = F(crc ⊕ w)`` where ``F = L⁴``.
- So over m words, ``crc = F^m(init) ⊕ Σ_i F^(m-i)(w_i)`` — the data
  term is a mod-2 product over the objects' word bits.  LSB-first
  byte unpacking IS the LE-u32 bit order, so no relayout is needed.
- Lengths vary per object: buffers are RIGHT-aligned (leading zero
  words contribute nothing to the data term), and the per-object init
  term ``L^len(init)`` folds in host-side via 32×32 matrix powers.
- The product is two-level so the matrices stay small: a cached
  per-chunk matrix (``_CHUNK`` bytes) computes chunk-local terms, and
  a cached combine matrix advances each chunk by ``F^(words/chunk)``
  to its distance from the end.

``crc_bits`` is that product in torch: the bits unpack to int8 and
each level is one ``torch._int_mm`` (int8 × int8 → int32, exact: the
sums reach at most 32768) followed by ``& 1``.  The first level runs
over blocks of at most ``_BLOCK_CHUNKS`` chunk rows, so the unpacked
bits (8 bytes a payload byte) stay near 1 GiB whatever the batch.
``mismatch`` is ``(a != b).any(dim=1)`` over two uint8 row blocks.
Neither is a hand-written kernel; the same torch code is the CPU path
the tests hold against the JAX package.

Golden-checked against the reference crc32c test vectors
(src/test/common/test_crc32c.cc) and the native slicing-by-8 C
implementation (``native.ceph_crc32c``).

Unlike the JAX package, no device failure falls back to the host: the
device route takes an explicit ``device`` (default ``cuda``) and
raises; the host C loop runs only for ``backend="oracle"``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..native import ceph_crc32c

# reference test vectors (src/test/common/test_crc32c.cc): (init,
# payload, crc) — the parity tests AND the import-time self-check of
# the matrix construction both anchor on these
GOLDEN_VECTORS = (
    (0, b"foo bar baz", 4119623852),
    (4294967295, b"", 4294967295),
    (0, b"", 0),
    (1, b"", 1),
)

_CHUNK = 4096  # bytes per chunk row (multiple of 4)
# chunk rows per first-level product: 32768 rows of 4096 bytes unpack
# to 1 GiB of int8 bits
_BLOCK_CHUNKS = 1 << 15
# torch._int_mm on CUDA takes more than 16 rows; shorter products pad
# with zero rows (their parity is zero and is sliced away)
_MIN_ROWS = 17


# -- host-side GF(2) matrix algebra (32x32, entries 0/1) --------------------


@functools.lru_cache(maxsize=1)
def _crc_table() -> tuple[int, ...]:
    """T0 of the Castagnoli table — shared derivation with
    csrc/crc32c.c (reflected, poly 0x1EDC6F41)."""
    from ..native import _table

    return _table()


def _byte_step(x: int) -> int:
    """One crc32c register step with a zero input byte: L(x)."""
    return ((x >> 8) ^ _crc_table()[x & 0xFF]) & 0xFFFFFFFF


def _to_bits(x: int) -> np.ndarray:
    return np.array(
        [(x >> c) & 1 for c in range(32)], dtype=np.uint8
    )


def _from_bits(v: np.ndarray) -> int:
    return int(sum(int(b) << c for c, b in enumerate(v)))


@functools.lru_cache(maxsize=1)
def _L() -> np.ndarray:
    """The per-byte transition as a (32, 32) GF(2) matrix: column c is
    L(e_c)."""
    m = np.zeros((32, 32), dtype=np.uint8)
    for c in range(32):
        m[:, c] = _to_bits(_byte_step(1 << c))
    return m


def _matmul2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # 32-term dot products of 0/1 values fit uint16; mask mod 2
    return (a.astype(np.uint16) @ b.astype(np.uint16) % 2).astype(
        np.uint8
    )


@functools.lru_cache(maxsize=1)
def _F() -> np.ndarray:
    """F = L⁴ — the one-u32-word transition."""
    l2 = _matmul2(_L(), _L())
    return _matmul2(l2, l2)


@functools.lru_cache(maxsize=256)
def _L_pow(n: int) -> np.ndarray:
    """L^n by square-and-multiply (init-term fold for a length-n
    buffer)."""
    if n == 0:
        return np.eye(32, dtype=np.uint8)
    half = _L_pow(n // 2)
    sq = _matmul2(half, half)
    return _matmul2(_L(), sq) if n % 2 else sq


def _apply(mat: np.ndarray, x: int) -> int:
    return _from_bits(mat @ _to_bits(x) % 2)


@functools.lru_cache(maxsize=8)
def _chunk_matrix(chunk_bytes: int) -> np.ndarray:
    """(chunk_bytes*8, 32) int8: rows 32i+b map bit b of word i to the
    chunk-local crc contribution F^(mc-i)(e_b)."""
    mc = chunk_bytes // 4
    f = _F()
    rows = np.empty((mc, 32, 32), dtype=np.int8)
    p = f  # F^1 belongs to the LAST word (i = mc-1)
    for i in range(mc - 1, -1, -1):
        rows[i] = p.T
        if i:
            p = _matmul2(p, f)
    return rows.reshape(chunk_bytes * 8, 32)


@functools.lru_cache(maxsize=64)
def _combine_matrix(chunk_bytes: int, nchunks: int) -> np.ndarray:
    """(nchunks*32, 32) int8: block j advances chunk j's local crc by
    Fc^(nchunks-1-j), Fc = F^(words per chunk)."""
    fc = np.eye(32, dtype=np.uint8)
    f = _F()
    for _ in range(chunk_bytes // 4):
        fc = _matmul2(fc, f)
    blocks = np.empty((nchunks, 32, 32), dtype=np.int8)
    p = np.eye(32, dtype=np.uint8)
    for j in range(nchunks - 1, -1, -1):
        blocks[j] = p.T
        if j:
            p = _matmul2(p, fc)
    return blocks.reshape(nchunks * 32, 32)


def _self_check() -> None:
    """The matrix construction must reproduce the reference vectors
    through the PURE-HOST path before any device math is trusted."""
    for init, payload, want in GOLDEN_VECTORS:
        got = _apply(_L_pow(len(payload)), init)
        m = np.zeros(32, dtype=np.uint8)
        for i, byte in enumerate(payload):
            adv = _L_pow(len(payload) - i)
            contrib = adv @ _to_bits(byte) % 2
            m = (m + contrib) % 2
        got ^= _from_bits(m)
        if got != want:
            raise AssertionError(
                f"crc32c matrix self-check failed: "
                f"crc({init:#x}, {payload!r}) = {got} != {want}"
            )


_self_check()


# -- device plane -----------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _device_chunk_matrix(chunk_bytes: int, device: torch.device) -> torch.Tensor:
    """(32, chunk_bytes*8) int8 on ``device``: the per-chunk matrix,
    transposed so its product operand is column-major."""
    return torch.from_numpy(np.ascontiguousarray(_chunk_matrix(chunk_bytes).T)).to(device)


@functools.lru_cache(maxsize=64)
def _device_combine_matrix(
    chunk_bytes: int, nchunks: int, device: torch.device
) -> torch.Tensor:
    """(32, nchunks*32) int8 on ``device``, transposed likewise."""
    return torch.from_numpy(
        np.ascontiguousarray(_combine_matrix(chunk_bytes, nchunks).T)
    ).to(device)


def _mod2_product(x: torch.Tensor, mat_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 0/1 times the (K, 32) matrix whose transpose is
    ``mat_t`` → (M, 32) int32 0/1: one int8 product, then ``& 1``."""
    rows = x.shape[0]
    if rows < _MIN_ROWS:
        x = torch.cat([x, x.new_zeros(_MIN_ROWS - rows, x.shape[1])])
    return torch._int_mm(x, mat_t.t())[:rows] & 1


def crc_bits(rows: torch.Tensor, gc_t: torch.Tensor, hc_t: torch.Tensor) -> torch.Tensor:
    """The data term of crc32c for each row of ``rows`` ((n, nchunks *
    _CHUNK) uint8, right-aligned), as (n,) int64 holding the u32 value:
    unpack the bits LSB first, take the per-chunk product in blocks of
    ``_BLOCK_CHUNKS`` chunk rows, then the combine product, then pack
    the 32 bits."""
    n, width = rows.shape
    nchunks = width // _CHUNK
    flat = rows.reshape(n * nchunks, _CHUNK)
    shifts = torch.arange(8, dtype=torch.uint8, device=rows.device)
    local = torch.empty((n * nchunks, 32), dtype=torch.int8, device=rows.device)
    for lo in range(0, n * nchunks, _BLOCK_CHUNKS):
        blk = flat[lo : lo + _BLOCK_CHUNKS]
        bits = blk.unsqueeze(-1).bitwise_right_shift(shifts)
        bits.bitwise_and_(1)
        x = bits.view(torch.int8).reshape(blk.shape[0], _CHUNK * 8)
        local[lo : lo + blk.shape[0]] = _mod2_product(x, gc_t)
        del bits, x
    folded = _mod2_product(local.reshape(n, nchunks * 32), hc_t)
    weights = torch.arange(32, dtype=torch.int64, device=rows.device)
    return (folded.to(torch.int64) << weights).sum(dim=1)


def mismatch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row "any byte differs" of two (n, ncols) uint8 tensors."""
    return (a != b).any(dim=1)


def _kstats():
    from .kernel_stats import kernel_stats

    return kernel_stats()


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name one card where either leaves the
    index open."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _gather_rows(entries, width: int, device: torch.device, *, align_right: bool) -> torch.Tensor:
    """An (len(entries), width) uint8 tensor on ``device`` from mixed
    host-bytes / DeviceBuf entries — the ONE pad/stack implementation
    both device functions share: every host row rides a single bulk
    upload, resident rows copy into place on the device (no second
    transfer).  All-host batches return the uploaded block as is."""
    from .profiler import record_resident, record_upload
    from .residency import DeviceBuf, upload

    n = len(entries)
    host_idx = [i for i, e in enumerate(entries) if not isinstance(e, DeviceBuf)]
    res_idx = [i for i, e in enumerate(entries) if isinstance(e, DeviceBuf)]
    # flight-recorder byte attribution: host rows cross the link this
    # dispatch; registered-resident tokens on this device are served
    # where they live (a lazy DeviceBuf's upload, or a token on another
    # device, is a transfer)
    record_upload(sum(len(entries[i]) for i in host_idx))
    for i in res_idx:
        e = entries[i]
        here = e.resident and _same_device(e.torch_device, device)
        (record_resident if here else record_upload)(len(e))
    if host_idx:
        block = np.zeros((len(host_idx), width), dtype=np.uint8)
        for r, i in enumerate(host_idx):
            raw = bytes(entries[i])
            if raw:
                lo = width - len(raw) if align_right else 0
                block[r, lo : lo + len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        dev_block = upload(block, device)
        if not res_idx:
            return dev_block
    out = torch.zeros((n, width), dtype=torch.uint8, device=device)
    if host_idx:
        out.index_copy_(0, torch.tensor(host_idx, device=device), dev_block)
    for i in res_idx:
        row = entries[i].device().to(device)
        lo = width - len(row) if align_right else 0
        out[i, lo : lo + len(row)] = row
    return out


def _oracle(buffers, inits) -> np.ndarray:
    from .profiler import dispatch_profiler
    from .residency import as_host_bytes

    with dispatch_profiler().dispatch("crc32c", backend="cpu") as dp:
        dp.set_ops(len(buffers))
        dp.add_bytes_in(sum(len(b) for b in buffers))
        return np.array(
            [
                ceph_crc32c(init, as_host_bytes(buf))
                for buf, init in zip(buffers, inits)
            ],
            dtype=np.uint32,
        )


def _check_backend(backend) -> None:
    if backend not in (None, "device", "oracle"):
        raise ValueError(f"backend={backend!r}: None, 'device' or 'oracle'")


def batch_crc32c(
    buffers, inits=0, *, backend: str | None = None, device="cuda"
) -> np.ndarray:
    """crc32c of every buffer in one device call (uint32 array).

    ``inits`` is a scalar seed or a per-buffer sequence (ceph_crc32c
    running-crc semantics; the EC HashInfo convention seeds with
    0xffffffff).  ``backend``: None or "device" = the torch product on
    ``device`` (default ``cuda``; a failure raises), "oracle" = the
    native C loop.

    Entries may be host bytes OR ``ops.residency.DeviceBuf`` tokens —
    a resident buffer (e.g. a shard the EC write path just encoded)
    is consumed where it already lives instead of paying a second
    host→device transfer per stage.
    """
    _check_backend(backend)
    buffers = list(buffers)
    if not buffers:
        return np.zeros(0, dtype=np.uint32)
    if isinstance(inits, int):
        inits = [inits] * len(buffers)
    inits = [int(x) & 0xFFFFFFFF for x in inits]
    if backend == "oracle":
        return _oracle(buffers, inits)
    return _device_crc32c(buffers, inits, torch.device(device))


def _device_crc32c(buffers, inits, device: torch.device) -> np.ndarray:
    from .profiler import dispatch_profiler
    from .residency import note_shape

    lens = [len(b) for b in buffers]
    n = len(buffers)
    nchunks = max(-(-max(lens) // _CHUNK), 1)
    padded = nchunks * _CHUNK
    ks = _kstats()
    with ks.timed(
        "scrub_crc32c", bytes_in=sum(lens)
    ) as kt, dispatch_profiler().dispatch("crc32c") as dp:
        dp.set_ops(n)
        dp.add_bytes_in(sum(lens))
        # the zeros that right-align each row to the widest
        dp.add_pad(padded * n - sum(lens))
        gc_t = ks.counted_cache_call(_device_chunk_matrix, _CHUNK, device)
        hc_t = ks.counted_cache_call(_device_combine_matrix, _CHUNK, nchunks, device)
        note_shape("scrub_crc32c", n, nchunks)
        with dp.stage("upload"):
            rows = _gather_rows(buffers, padded, device, align_right=True)
        with dp.stage("compute"):
            res = crc_bits(rows, gc_t, hc_t)
        with dp.stage("sync"):
            out = res.cpu().numpy().astype(np.uint32)
        kt.bytes_out = out.nbytes
    # per-object init fold: crc = data_term ⊕ L^len(init)
    for i, (ln, init) in enumerate(zip(lens, inits)):
        if init:
            out[i] ^= _apply(_L_pow(ln), init)
    return out


def batch_compare(stored, expected, *, backend: str | None = None, device="cuda"):
    """Per-pair any-byte-differs verdict (bool array) — the device
    side of re-encode verification: ``stored[i]`` is the shard bytes
    on disk, ``expected[i]`` the re-encoded truth.  Length mismatches
    are verdicts on their own, decided on the host.

    Entries in either list may be host bytes or
    ``ops.residency.DeviceBuf`` tokens — resident shard payloads are
    compared where they already live.  ``backend`` as for
    :func:`batch_crc32c`: "oracle" compares on the host with numpy."""
    from .profiler import dispatch_profiler
    from .residency import as_host_bytes, note_shape

    _check_backend(backend)
    stored = list(stored)
    expected = list(expected)
    if len(stored) != len(expected):
        raise ValueError(f"{len(stored)} stored against {len(expected)} expected")
    out = np.zeros(len(stored), dtype=bool)
    same_len = [i for i in range(len(stored)) if len(stored[i]) == len(expected[i])]
    for i in range(len(stored)):
        if len(stored[i]) != len(expected[i]):
            out[i] = True
    if not same_len:
        return out
    width = max(len(stored[i]) for i in same_len)
    if width == 0:
        return out
    total = sum(len(stored[i]) + len(expected[i]) for i in same_len)
    if backend == "oracle":
        with dispatch_profiler().dispatch("compare", backend="cpu") as dp:
            dp.set_ops(len(same_len))
            dp.add_bytes_in(total)
            a = np.zeros((len(same_len), width), dtype=np.uint8)
            b = np.zeros((len(same_len), width), dtype=np.uint8)
            for row, i in enumerate(same_len):
                for arr, seq in ((a, stored), (b, expected)):
                    raw = as_host_bytes(seq[i])
                    arr[row, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
            out[same_len] = (a != b).any(axis=1)
        return out
    device = torch.device(device)
    ks = _kstats()
    with ks.timed(
        "scrub_verify", bytes_in=total
    ) as kt, dispatch_profiler().dispatch("compare") as dp:
        dp.set_ops(len(same_len))
        dp.add_bytes_in(total)
        # shorter pairs widen to the widest with zeros on both sides
        dp.add_pad(2 * width * len(same_len) - total)
        with dp.stage("upload"):
            a_dev = _gather_rows([stored[i] for i in same_len], width, device, align_right=False)
            b_dev = _gather_rows([expected[i] for i in same_len], width, device, align_right=False)
        note_shape("scrub_verify", len(same_len), width)
        with dp.stage("compute"):
            vdev = mismatch(a_dev, b_dev)
        with dp.stage("sync"):
            verdict = vdev.cpu().numpy()
        kt.bytes_out = verdict.nbytes
    out[same_len] = verdict
    return out
