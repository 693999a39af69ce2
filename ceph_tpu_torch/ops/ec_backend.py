"""The ``torch`` erasure-code backend: device dispatch of region math.

Slots under both code families through ``ec.backend``; numpy in, numpy
out at the public methods (the JAX package's layout), with the region
math on the backend's device in between.  Routing mirrors the JAX
backend, with "the device is CUDA" in place of "the chip is a TPU":

- w=8 on CUDA, a width divisible by 4 (for stripes: each chunk) and a
  bitmatrix ``packed_gf.supports`` → kernel K1 (``packed_gf``);
- otherwise ``gf_matmul.gf_matrix_regions`` / ``gf_matrix_stripes``,
  which launch kernel K2 (``bitplane_gf``) at w=8 on CUDA and run plain
  PyTorch for other word sizes and on the CPU;
- the batch methods take the bitplane route, as the JAX ones do, on each
  group of stripes as it is: K2 reads any batch size in place, so the
  JAX package's padding of the batch to a power of two (which keeps
  ``jit`` to few shapes) has no counterpart here.

Every call lands in the ``l_tpu_gf_matmul_*`` / ``l_tpu_gf_bitmatrix_*``
kernel counters (``ops.kernel_stats``, timed up to the download or a
synchronize), and the stripe routes record a dispatch in the flight
recorder (``ops.profiler``) with their upload, compute and sync stages,
as the JAX backend does.  ``decode_stripes_batch`` takes resident
``DeviceBuf`` survivors without a second upload and returns its rebuilt
rows on the device.

On the CPU device the kernels' plain versions run.  Asking for a CUDA
device where there is none raises ErasureCodeError: the backend never
carries on on the CPU.  ``matrix_stripes_device`` is the one
device-tensor entry, for callers that keep stripes resident.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import gf
from ..ec.backend import _host_row, register_backend
from ..ec.interface import ErasureCodeError
from . import packed_gf
from .gf_matmul import (
    bitmatrix_packet_regions,
    gf_matrix_regions,
    gf_matrix_stripes,
    matrix_to_device_bitmatrix,
)
from .kernel_stats import kernel_stats
from .profiler import dispatch_profiler
from .residency import is_device_buf, upload


@functools.lru_cache(maxsize=512)
def _host_bitmatrix(key: bytes, shape: tuple, w: int):
    """Host-side packed-kernel eligibility, cached per matrix."""
    mat = np.frombuffer(key, dtype=np.int64).reshape(shape)
    return packed_gf.supports(gf.jerasure_bitmatrix(mat, w), w)


def _packed_ok(matrix: np.ndarray, w: int) -> bool:
    mat = np.ascontiguousarray(matrix, dtype=np.int64)
    return w == 8 and kernel_stats().counted_cache_call(
        _host_bitmatrix, mat.tobytes(), mat.shape, w
    )


class TorchBackend:
    name = "torch"

    def __init__(self, device="cuda"):
        try:
            self.device = torch.device(device)
        except RuntimeError as e:
            raise ErasureCodeError(f"bad device {device!r}: {e}") from None
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ErasureCodeError(
                f"device={device} asked for, but CUDA is not available"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ErasureCodeError(f"device={device}: only cuda or cpu")

    @property
    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        # pinned staging makes the copy stream-ordered: the host goes on
        # while the transfer queues ahead of the kernels after it
        return upload(arr, self.device)

    @staticmethod
    def _download(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    def _sync(self) -> None:
        if self.on_cuda:
            torch.cuda.synchronize(self.device)

    # -- single regions ------------------------------------------------------
    def matrix_regions(
        self, matrix: np.ndarray, regions: np.ndarray, w: int
    ) -> np.ndarray:
        # the download inside the timer syncs the device, so the
        # recorded latency is the kernel, not the launch
        with kernel_stats().timed("gf_matmul", bytes_in=regions.nbytes) as kt:
            dev = self._upload(regions)
            bm = matrix_to_device_bitmatrix(matrix, w, self.device)
            if self.on_cuda and dev.shape[1] % 4 == 0 and _packed_ok(matrix, w):
                out = self._download(packed_gf.packed_bitmatrix_regions(bm, dev))
            else:
                out = self._download(gf_matrix_regions(bm, dev, w=w))
            kt.bytes_out = out.nbytes
            return out

    def bitmatrix_regions(
        self, bm: np.ndarray, regions: np.ndarray, w: int, packetsize: int
    ) -> np.ndarray:
        with kernel_stats().timed("gf_bitmatrix", bytes_in=regions.nbytes) as kt:
            bmd = torch.as_tensor(np.asarray(bm), dtype=torch.uint8, device=self.device)
            out = self._download(bitmatrix_packet_regions(
                bmd, self._upload(regions), w=w, packetsize=packetsize
            ))
            kt.bytes_out = out.nbytes
            return out

    # -- stripe batches ------------------------------------------------------
    def matrix_stripes_device(
        self, matrix: np.ndarray, stripes: torch.Tensor, w: int
    ) -> torch.Tensor:
        """(B, k, chunk) uint8 tensor on the backend's device → (B, m,
        chunk) on the same device; no host transfer."""
        bm = matrix_to_device_bitmatrix(matrix, w, stripes.device)
        if stripes.is_cuda and stripes.shape[2] % 4 == 0 and _packed_ok(matrix, w):
            return packed_gf.packed_matrix_stripes(bm, stripes)
        return gf_matrix_stripes(bm, stripes, w=w)

    def matrix_stripes(
        self, matrix: np.ndarray, stripes: np.ndarray, w: int
    ) -> np.ndarray:
        """Batched (B, k, chunk) → (B, m, chunk); numpy in, numpy out."""
        stripes = np.ascontiguousarray(stripes, dtype=np.uint8)
        with kernel_stats().timed(
            "gf_matmul", bytes_in=stripes.nbytes
        ) as kt, dispatch_profiler().dispatch("ec_encode", backend=self.name) as dp:
            dp.set_ops(1)
            dp.set_stripes(stripes.shape[0])
            dp.add_bytes_in(stripes.nbytes)
            with dp.stage("upload"):
                dev = self._upload(stripes)
            dp.add_upload(stripes.nbytes)
            with dp.stage("compute"):
                odev = self.matrix_stripes_device(matrix, dev, w)
            with dp.stage("sync"):
                out = self._download(odev)
            kt.bytes_out = out.nbytes
            return out

    def _grouped(self, bm, arrays: dict, w: int, group_stripes: int, dp) -> list:
        """Pack {i: (Bi, k, chunk) array} greedily into ~group_stripes-
        stripe groups, upload each (stream-ordered, so group j+1's copy
        is queued while group j computes) and run the bitplane route.
        Returns [(indices, (ΣBi, m, chunk) device tensor)], one per
        group, unsynchronised."""
        groups: list[list[int]] = []
        cur: list[int] = []
        cur_b = 0
        for i, a in arrays.items():
            if cur and cur_b + a.shape[0] > group_stripes:
                groups.append(cur)
                cur, cur_b = [], 0
            cur.append(i)
            cur_b += a.shape[0]
        if cur:
            groups.append(cur)
        out = []
        for group in groups:
            arr = (
                np.concatenate([arrays[i] for i in group])
                if len(group) > 1
                else arrays[group[0]]
            )
            with dp.stage("upload"):
                dev = self._upload(arr)
            dp.add_upload(arr.nbytes)
            with dp.stage("compute"):
                out.append((group, gf_matrix_stripes(bm, dev, w=w)))
        return out

    @staticmethod
    def _split(grouped, arrays: dict) -> dict:
        """{i: rows of group output} from :meth:`_grouped`'s result
        (device tensors or their downloads)."""
        outs = {}
        for group, res in grouped:
            off = 0
            for i in group:
                nb = arrays[i].shape[0]
                outs[i] = res[off : off + nb]
                off += nb
        return outs

    def matrix_stripes_batch(
        self,
        matrix: np.ndarray,
        stripe_batches,
        w: int,
        group_stripes: int = 256,
    ) -> list[np.ndarray]:
        """Coalesced encode of MANY stripe batches (one per queued object),
        byte-identical to per-batch ``matrix_stripes``; ONE sync, at the
        downloads.  Returns one (Bi, m, chunk) array per input batch."""
        batches = [np.ascontiguousarray(s, dtype=np.uint8) for s in stripe_batches]
        if not batches:
            return []
        if len({s.shape[1:] for s in batches}) != 1:
            # heterogeneous geometry: encode per batch, still correct
            return [self.matrix_stripes(matrix, s, w) for s in batches]
        total = sum(s.nbytes for s in batches)
        with kernel_stats().timed(
            "gf_matmul", bytes_in=total
        ) as kt, dispatch_profiler().dispatch("ec_encode", backend=self.name) as dp:
            dp.set_ops(len(batches))
            dp.set_stripes(sum(s.shape[0] for s in batches))
            dp.add_bytes_in(total)
            bm = matrix_to_device_bitmatrix(matrix, w, self.device)
            arrays = dict(enumerate(batches))
            grouped = self._grouped(bm, arrays, w, group_stripes, dp)
            with dp.stage("sync"):
                host = [(group, self._download(res)) for group, res in grouped]
            outs = self._split(host, arrays)
            kt.bytes_out = sum(o.nbytes for o in outs.values())
        return [outs[i] for i in range(len(batches))]

    def decode_stripes_batch(
        self,
        matrix: np.ndarray,
        row_sets,
        w: int,
        chunk: int,
        group_stripes: int = 256,
    ) -> list[torch.Tensor]:
        """Coalesced decode-from-survivors, the repair-side twin of
        :meth:`matrix_stripes_batch`.  ``row_sets`` is one list per
        object of equal-length 1-D survivor payloads — numpy arrays,
        bytes-likes or ``DeviceBuf`` tokens; each object's rows
        reshape to (nstripes, s, chunk) and are multiplied by the
        reconstruction ``matrix``.  Resident survivors ride with ZERO
        re-upload (their link cost was paid at registration; the
        object's host rows go up in one copy); host-only objects pack
        into ~``group_stripes``-stripe groups whose uploads queue ahead
        of compute, exactly like the write path.  The ONLY sync is at
        the end, and the outputs stay on the backend's device: one
        (nstripes, rows, chunk) uint8 tensor per object."""
        for rows in row_sets:
            for r in rows:
                if not isinstance(r, (np.ndarray, bytes, bytearray, memoryview)) \
                        and not is_device_buf(r):
                    raise TypeError(
                        f"survivor payload of type {type(r).__name__}: "
                        "numpy arrays, bytes and DeviceBufs are supported"
                    )
        total = sum(len(r) for rows in row_sets for r in rows)
        with kernel_stats().timed(
            "gf_matmul", bytes_in=total
        ) as kt, dispatch_profiler().dispatch("ec_decode", backend=self.name) as dp:
            dp.set_ops(len(row_sets))
            dp.add_bytes_in(total)
            bm = matrix_to_device_bitmatrix(matrix, w, self.device)
            outs: dict = {}
            host: dict = {}
            for i, rows in enumerate(row_sets):
                if any(is_device_buf(r) for r in rows):
                    outs[i] = self._decode_resident(bm, rows, w, chunk, dp)
                else:
                    host[i] = np.stack(
                        [_host_row(r).reshape(-1, chunk) for r in rows], axis=1
                    )
            outs.update(self._split(self._grouped(bm, host, w, group_stripes, dp), host))
            dp.set_stripes(sum(o.shape[0] for o in outs.values()))
            # sync ONLY here (the commit point); results STAY on the
            # device for device-born registration downstream
            with dp.stage("sync"):
                self._sync()
            out_list = [outs[i] for i in range(len(row_sets))]
            kt.bytes_out = sum(o.numel() for o in out_list)
        return out_list

    def _decode_resident(self, bm, rows, w: int, chunk: int, dp) -> torch.Tensor:
        """One object whose survivors include DeviceBufs: resident rows
        are read where they live, a lazy one's first ``device()`` is a
        real upload, and the object's host rows go up in ONE copy."""
        for r in rows:
            if is_device_buf(r):
                (dp.add_resident if r.resident else dp.add_upload)(len(r))
        host_js = [j for j, r in enumerate(rows) if not is_device_buf(r)]
        with dp.stage("upload"):
            blk = None
            if host_js:
                stacked = np.stack([_host_row(rows[j]).reshape(-1, chunk) for j in host_js])
                dp.add_upload(stacked.nbytes)
                blk = self._upload(stacked)
            devs, hi = [], 0
            for r in rows:
                if is_device_buf(r):
                    devs.append(r.device().to(self.device).reshape(-1, chunk))
                else:
                    devs.append(blk[hi])
                    hi += 1
            dev = torch.stack(devs, dim=1)
        with dp.stage("compute"):
            return gf_matrix_stripes(bm, dev, w=w)


register_backend("torch", TorchBackend)
