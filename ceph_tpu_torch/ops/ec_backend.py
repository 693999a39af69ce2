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


@functools.lru_cache(maxsize=512)
def _host_bitmatrix(key: bytes, shape: tuple, w: int):
    """Host-side packed-kernel eligibility, cached per matrix."""
    mat = np.frombuffer(key, dtype=np.int64).reshape(shape)
    return packed_gf.supports(gf.jerasure_bitmatrix(mat, w), w)


def _packed_ok(matrix: np.ndarray, w: int) -> bool:
    mat = np.ascontiguousarray(matrix, dtype=np.int64)
    return w == 8 and _host_bitmatrix(mat.tobytes(), mat.shape, w)


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
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint8))
        if self.on_cuda:
            # pinned staging makes the copy stream-ordered: the host goes
            # on while the transfer queues ahead of the kernels after it
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @staticmethod
    def _download(t: torch.Tensor) -> np.ndarray:
        return t.cpu().numpy()

    # -- single regions ------------------------------------------------------
    def matrix_regions(
        self, matrix: np.ndarray, regions: np.ndarray, w: int
    ) -> np.ndarray:
        dev = self._upload(regions)
        bm = matrix_to_device_bitmatrix(matrix, w, self.device)
        if self.on_cuda and dev.shape[1] % 4 == 0 and _packed_ok(matrix, w):
            return self._download(packed_gf.packed_bitmatrix_regions(bm, dev))
        return self._download(gf_matrix_regions(bm, dev, w=w))

    def bitmatrix_regions(
        self, bm: np.ndarray, regions: np.ndarray, w: int, packetsize: int
    ) -> np.ndarray:
        bmd = torch.as_tensor(np.asarray(bm), dtype=torch.uint8, device=self.device)
        out = bitmatrix_packet_regions(
            bmd, self._upload(regions), w=w, packetsize=packetsize
        )
        return self._download(out)

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
        out = self.matrix_stripes_device(matrix, self._upload(stripes), w)
        return self._download(out)

    def _grouped(self, bm, arrays: list[np.ndarray], w: int, group_stripes: int):
        """Pack (Bi, k, chunk) arrays greedily into ~group_stripes-stripe
        groups, upload each (stream-ordered, so group j+1's copy is queued
        while group j computes) and run the bitplane route; ONE sync, at
        the download.  Returns one (Bi, m, chunk) array per input."""
        groups: list[list[int]] = []
        cur: list[int] = []
        cur_b = 0
        for i, a in enumerate(arrays):
            if cur and cur_b + a.shape[0] > group_stripes:
                groups.append(cur)
                cur, cur_b = [], 0
            cur.append(i)
            cur_b += a.shape[0]
        if cur:
            groups.append(cur)
        pending = []
        for group in groups:
            arr = (
                np.concatenate([arrays[i] for i in group])
                if len(group) > 1
                else arrays[group[0]]
            )
            pending.append(gf_matrix_stripes(bm, self._upload(arr), w=w))
        outs: list = [None] * len(arrays)
        for group, dev_out in zip(groups, pending):
            host = self._download(dev_out)
            off = 0
            for i in group:
                nb = arrays[i].shape[0]
                outs[i] = host[off : off + nb]
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
        byte-identical to per-batch ``matrix_stripes``.  Returns one
        (Bi, m, chunk) array per input batch."""
        batches = [np.ascontiguousarray(s, dtype=np.uint8) for s in stripe_batches]
        if not batches:
            return []
        if len({s.shape[1:] for s in batches}) != 1:
            # heterogeneous geometry: encode per batch, still correct
            return [self.matrix_stripes(matrix, s, w) for s in batches]
        bm = matrix_to_device_bitmatrix(matrix, w, self.device)
        return self._grouped(bm, batches, w, group_stripes)

    def decode_stripes_batch(
        self,
        matrix: np.ndarray,
        row_sets,
        w: int,
        chunk: int,
        group_stripes: int = 256,
    ) -> list[np.ndarray]:
        """Coalesced decode-from-survivors, the repair-side twin of
        :meth:`matrix_stripes_batch`.  ``row_sets`` is one list per
        object of equal-length 1-D survivor payloads (numpy arrays or
        bytes-likes); each reshapes to (nstripes, s, chunk) and is
        multiplied by the reconstruction ``matrix``.  Device-resident
        survivor tokens are not supported here."""
        for rows in row_sets:
            for r in rows:
                if not isinstance(r, (np.ndarray, bytes, bytearray, memoryview)):
                    raise TypeError(
                        f"survivor payload of type {type(r).__name__}: "
                        "only numpy arrays and bytes are supported"
                    )
        arrays = [
            np.stack([_host_row(r).reshape(-1, chunk) for r in rows], axis=1)
            for rows in row_sets
        ]
        if not arrays:
            return []
        bm = matrix_to_device_bitmatrix(matrix, w, self.device)
        return self._grouped(bm, arrays, w, group_stripes)


register_backend("torch", TorchBackend)
