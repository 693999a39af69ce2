"""Device mesh: discovery, splitting, telemetry — one process over a
list of torch devices.

The JAX package's ``ops/mesh.py`` spreads a batch across every device
of ONE process (a 1-D ``jax.sharding.Mesh``; its tests give it eight
virtual CPU devices).  This is the same plane in torch: a mesh is a
list of ``torch.device``s, and a sharded call splits its batch axis
into one equal part per entry, runs the single-device function on each
part's device, and gathers the parts back in order.  The reference's
CPU analog shards pgid ranges over a thread pool (ParallelPGMapper,
src/osd/OSDMapMapping.h:18-156).  Sharding never changes the per-lane
math, so outputs are byte-identical to the single-device path, ragged
batches included (tests/test_torch_mesh.py).

A mesh may name one device several times.  That is the counterpart of
the XLA virtual mesh: ``DeviceMesh(["cpu"] * 8)`` in the tests, and
``DeviceMesh(["cuda:0"] * 4)`` on a host with one card, where the four
shards run one after another on its stream.

Pieces:

- discovery: ``available_devices()`` lists ``cuda:0`` … ``cuda:n-1`` and
  never raises; without CUDA it is empty (no CPU device ever stands in
  for a missing card).  ``probe_devices_subprocess()`` counts the cards
  in a subprocess, with a timeout.
- the default product mesh: ``default_mesh()`` is None unless more than
  one CUDA device exists, so a one-card host keeps the product paths'
  single-device dispatch; ``CEPH_TPU_MESH=0`` disables it and
  ``CEPH_TPU_MESH_DEVICES=k`` caps its size (the JAX package's names).
- splitting: ``DeviceMesh.split`` / ``gather`` move the parts;
  ragged batches pad to a multiple of the mesh size on the host by
  repeating the last slice and are cut back after the gather
  (``pad_to_devices``).
- sharded EC encode: ``sharded_matrix_stripes`` runs
  ``gf_matrix_stripes`` (kernel K2 at w=8 on CUDA) on each shard.
- telemetry: every sharded dispatch records per-device counters
  (``l_tpu_mesh_dev<i>_calls/_bytes``, i the position in the mesh) and
  the group totals (``l_tpu_mesh_<group>_*``) through ops/kernel_stats.py.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from .kernel_stats import kernel_stats


def available_devices() -> list:
    """The CUDA devices of this process, ``cuda:0`` … ``cuda:n-1``;
    an empty list where CUDA is unavailable or fails to initialize.
    Never raises."""
    try:
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    except RuntimeError:
        return []


def probe_devices_subprocess(
    timeout: float = 60.0,
) -> tuple[int | None, str | None, str | None]:
    """Count CUDA devices in a SUBPROCESS, so a CUDA initialization that
    hangs cannot block the caller: a bounded timeout (seconds) turns the
    hang into ``(None, None, reason)``.  Returns ``(device_count,
    "cuda", None)`` when there are cards, ``(0, None, reason)`` when
    CUDA reports none, ``(None, None, reason)`` when the probe fails."""
    import subprocess
    import sys

    code = (
        "import sys, torch; "
        "n = torch.cuda.device_count() if torch.cuda.is_available() else 0; "
        "sys.stdout.write(f'{n}')"
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            timeout=timeout,
            text=True,
        )
    except subprocess.TimeoutExpired:
        return None, None, f"device probe hung > {timeout:.0f}s"
    except OSError as e:
        return None, None, f"probe spawn failed: {e}"
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().splitlines()
        return None, None, (
            tail[-1] if tail else f"probe rc={proc.returncode}"
        )
    try:
        count = int(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return (
            None,
            None,
            f"unparseable probe output: {proc.stdout[-80:]!r}",
        )
    if count == 0:
        return 0, None, "CUDA reports no device"
    return count, "cuda", None


def device_count() -> int:
    return len(available_devices())


class DeviceMesh:
    """A 1-D mesh over an explicit list of torch devices of one type;
    an entry may repeat.  Its one axis is the batch axis every sharded
    call splits on."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("DeviceMesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(
                f"DeviceMesh devices of mixed types: {self.devices}"
            )

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def platform(self) -> str:
        return self.devices[0].type

    def distinct(self) -> list:
        """The mesh's devices, each once, in first-seen order."""
        return list(dict.fromkeys(self.devices))

    def cache_key(self) -> tuple:
        return tuple(str(d) for d in self.devices)

    def serves(self, device) -> bool:
        """Whether work bound for ``device`` may shard over this mesh:
        the device is of the mesh's type and is one of its entries, or
        names no index (plain ``cuda``, ``cpu``).  A caller pinned to a
        card outside the mesh keeps its single-device route."""
        device = torch.device(device)
        if device.type != self.platform:
            return False
        return device.index is None or device in self.devices

    def split(self, tensor: torch.Tensor, axis: int = 0) -> list:
        """One equal part of ``tensor`` along ``axis`` per mesh entry,
        each on its entry's device (a view where it already is there).
        The length along ``axis`` must be a multiple of ``n``
        (``pad_to_devices``).  A host tensor bound for a card goes
        through pinned staging, so the copies queue on the stream."""
        length = tensor.shape[axis]
        if length % self.n:
            raise ValueError(
                f"axis {axis} of length {length} does not split into "
                f"{self.n} equal parts"
            )
        parts = []
        for part, dev in zip(torch.tensor_split(tensor, self.n, dim=axis), self.devices):
            if dev.type == "cuda" and part.device.type == "cpu":
                staging = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
                staging.copy_(part)
                part = staging.to(dev, non_blocking=True)
            else:
                part = part.to(dev)
            parts.append(part)
        return parts

    def gather(self, parts, axis: int = 0) -> torch.Tensor:
        """The parts, in mesh order, concatenated along ``axis`` on the
        host.  Card parts land in pinned memory, and every card is
        synchronized before the result is returned."""
        cards = {p.device for p in parts if p.is_cuda}
        if not cards:
            return torch.cat(parts, dim=axis)
        shape = list(parts[0].shape)
        shape[axis] = sum(p.shape[axis] for p in parts)
        out = torch.empty(shape, dtype=parts[0].dtype, pin_memory=True)
        off = 0
        for p in parts:
            out.narrow(axis, off, p.shape[axis]).copy_(p, non_blocking=p.is_cuda)
            off += p.shape[axis]
        for dev in cards:
            torch.cuda.synchronize(dev)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"DeviceMesh({self.n}x{self.platform})"


def build_mesh(n: int | None = None, devices=None) -> DeviceMesh | None:
    """Mesh over the first ``n`` (default: all) devices of ``devices``
    (default: ``available_devices()``); None when there is none."""
    devs = list(devices) if devices is not None else available_devices()
    if not devs:
        return None
    if n is not None:
        devs = devs[: max(int(n), 1)]
    return DeviceMesh(devs)


# -- the default product mesh ------------------------------------------------
# Probed once per process.  CEPH_TPU_MESH=0 disables sharding outright;
# CEPH_TPU_MESH_DEVICES=k caps the device count.  Hosts with one card
# (or none) get None so product paths keep their exact existing
# dispatch.

_default_lock = threading.Lock()
_default_probed = False
_default_mesh: DeviceMesh | None = None


def default_mesh() -> DeviceMesh | None:
    """The process mesh product paths shard over when more than one
    CUDA device exists; None on one-card (or cardless, or disabled)
    hosts."""
    global _default_probed, _default_mesh
    if not _default_probed:
        with _default_lock:
            if not _default_probed:
                mesh = None
                if os.environ.get("CEPH_TPU_MESH", "1") != "0":
                    devs = available_devices()
                    try:
                        cap = int(
                            os.environ.get("CEPH_TPU_MESH_DEVICES", "0")
                        )
                    except ValueError:
                        cap = 0
                    if cap > 0:
                        devs = devs[:cap]
                    if len(devs) > 1:
                        mesh = DeviceMesh(devs)
                _default_mesh = mesh
                _default_probed = True
    return _default_mesh


def _reset_default_mesh_for_tests() -> None:
    global _default_probed, _default_mesh
    with _default_lock:
        _default_probed = False
        _default_mesh = None


# -- ragged-batch padding ----------------------------------------------------


def pad_to_devices(arr: np.ndarray, n_dev: int, axis: int = 0):
    """Pad ``axis`` up to a multiple of ``n_dev`` by repeating the
    last slice (any valid input works — padded lanes are discarded
    after gather).  Returns (padded, original_length)."""
    n = arr.shape[axis]
    pad = (-n) % max(n_dev, 1)
    if not pad:
        return arr, n
    tail = np.take(arr, [n - 1], axis=axis)
    reps = [1] * arr.ndim
    reps[axis] = pad
    return np.concatenate([arr, np.tile(tail, reps)], axis=axis), n


# -- telemetry ---------------------------------------------------------------


def record_shard_dispatch(
    dmesh: DeviceMesh, group: str, bytes_in: int, seconds: float
) -> None:
    """Per-device mesh counters: each entry of the mesh saw one shard
    of ~bytes_in/n, plus the per-group rollup (``l_tpu_mesh_*``)."""
    ks = kernel_stats()
    ks.record(f"mesh_{group}", bytes_in=bytes_in, seconds=seconds)
    per_dev = bytes_in // max(dmesh.n, 1)
    for i in range(dmesh.n):
        ks.perf.inc(
            ks.counter("mesh", f"dev{i}_calls", desc="shards dispatched")
        )
        if per_dev:
            ks.perf.inc(
                ks.counter(
                    "mesh", f"dev{i}_bytes", desc="shard bytes in"
                ),
                per_dev,
            )


# -- sharded EC encode -------------------------------------------------------


def sharded_matrix_stripes(
    bm, stripes: np.ndarray, w: int, dmesh: DeviceMesh
) -> np.ndarray:
    """Batched (B, k, chunk) → (B, m, chunk) encode with the object
    batch sharded across ``dmesh``: ``bm`` is the (m·w, k·w) 0/1
    bitmatrix (a tensor on any device, or numpy), copied once to each
    distinct device; each shard runs ``gf_matrix_stripes`` on its
    device (K2 at w=8 on a card, one launch per shard for m ≤ 8).
    Byte-identical to the single-device ``gf_matrix_stripes``: each
    stripe's math is lane-independent, so splitting B never changes a
    byte — ragged B pads on the host and slices back.  numpy in, numpy
    out; a shard's failure propagates."""
    from .gf_matmul import gf_matrix_stripes

    stripes = np.ascontiguousarray(stripes, dtype=np.uint8)
    padded, n = pad_to_devices(stripes, dmesh.n)
    t0 = time.perf_counter()
    bm = torch.as_tensor(bm, dtype=torch.uint8)
    bms = {dev: bm.to(dev) for dev in dmesh.distinct()}
    parts = dmesh.split(torch.from_numpy(padded))
    outs = [
        gf_matrix_stripes(bms[dev], part, w=w)
        for part, dev in zip(parts, dmesh.devices)
    ]
    out = dmesh.gather(outs).numpy()[:n]
    record_shard_dispatch(
        dmesh, "ec_encode", stripes.nbytes, time.perf_counter() - t0
    )
    return out
