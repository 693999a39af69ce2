"""Mesh-sharded batched CRUSH — the ParallelPGMapper analog over a
device mesh.

``crush/torchmap.py`` maps a whole PG batch on one device; this module
splits that batch across the entries of a ``DeviceMesh`` (ops/mesh.py)
the way the reference splits pgid ranges across a thread pool
(src/osd/OSDMapMapping.h:18-156).  Each part maps on its entry's
device through ``torchmap.batch_do_rule_raw``, with that device's
compiled tables from the per-map, per-device cache of
``osd/mapping.py`` (compiled once per distinct device, not per shard).
The per-lane math is untouched, so results are byte-identical to the
single-device path: the parts are gathered on the host in order, the
pad lanes of a ragged batch dropped, and the exact oracle then re-maps
the lanes that outran the fast path's speculation window.

``mesh_batch_do_rule`` is the product entry point: OSDMap full remaps
(osd/mapping.py) route through it when a default mesh exists, which
needs more than one CUDA device; other hosts keep the exact existing
single-device dispatch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..crush import torchmap
from ..ops import mesh as meshmod
from .mapping import _compiled


def _tables(cmap, device: torch.device) -> torchmap.CompiledMap:
    """``cmap``'s compiled tables on ``device``: ``cmap`` itself where
    it is a CompiledMap already there, else the per-map, per-device
    cache (recompiled after any mutation of the map)."""
    if isinstance(cmap, torchmap.CompiledMap):
        if cmap.device == device:
            return cmap
        cmap = cmap.source
    return _compiled(cmap, device)


def _single_device(cmap, ruleno, xs, result_max, weights):
    cm = cmap if isinstance(cmap, torchmap.CompiledMap) else _tables(cmap, torch.device("cuda"))
    return torchmap.batch_do_rule(cm, ruleno, xs, result_max, weights)


def sharded_batch_do_rule(
    cmap,
    ruleno: int,
    xs,
    result_max: int,
    weights=None,
    dmesh: meshmod.DeviceMesh | None = None,
):
    """``torchmap.batch_do_rule`` with the PG batch sharded across
    ``dmesh`` (default: the process mesh).  ``cmap`` is a ``CrushMap``
    or a ``CompiledMap``.  Same (results, counts) numpy contract,
    byte-identical output.  With no mesh it is the single-device call
    (on ``cmap``'s device, or ``cuda`` for a ``CrushMap``)."""
    if dmesh is None:
        dmesh = meshmod.default_mesh()
    if dmesh is None:
        return _single_device(cmap, ruleno, xs, result_max, weights)
    if isinstance(xs, torch.Tensor):
        xs = xs.cpu().numpy()
    xs_np = np.asarray(xs, dtype=np.int64)
    padded, n = meshmod.pad_to_devices(xs_np, dmesh.n)
    t0 = time.perf_counter()
    tables = {dev: _tables(cmap, dev) for dev in dmesh.distinct()}
    raw = [
        torchmap.batch_do_rule_raw(tables[dev], ruleno, part, result_max, weights)
        for part, dev in zip(dmesh.split(torch.from_numpy(padded)), dmesh.devices)
    ]
    # host-side re-assembly: gather every shard, drop the pad lanes
    res, counts, ok = (dmesh.gather(list(p)).numpy()[:n] for p in zip(*raw))
    meshmod.record_shard_dispatch(
        dmesh, "crush", padded.nbytes, time.perf_counter() - t0
    )
    return torchmap.apply_oracle_fallback(
        tables[dmesh.devices[0]], ruleno, xs_np, res, counts, ok, result_max, weights
    )


def mesh_batch_do_rule(cmap, ruleno, xs, result_max, weights=None):
    """Product dispatch: shard across the default mesh when one exists
    (more than one CUDA device), else the single-device path
    unchanged.  The same call as ``sharded_batch_do_rule`` without a
    mesh; it keeps the JAX package's name for the product entry
    point."""
    return sharded_batch_do_rule(cmap, ruleno, xs, result_max, weights)


class ShardedPGMapper:
    """Thin OO wrapper over one (map, mesh) pair: compile once per
    distinct device, map many PG ranges."""

    def __init__(self, crush_map, dmesh: meshmod.DeviceMesh):
        self.crush_map = crush_map
        self.dmesh = dmesh
        # compile up front, once per distinct device, into the per-map
        # cache that every map_pgs reads (and refreshes after a mutation)
        for dev in dmesh.distinct():
            _tables(crush_map, dev)

    def map_pgs(self, ruleno: int, xs, result_max: int, weights=None):
        return sharded_batch_do_rule(
            self.crush_map, ruleno, xs, result_max, weights, self.dmesh
        )
