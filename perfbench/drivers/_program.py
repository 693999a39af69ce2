"""Inputs handed to the program: its CRUSH map, built through its own
builder from the benchmark's description."""

from __future__ import annotations

from .. import maps


def crush_map(h, rules=("firstn", "indep")):
    """The program's ``CrushMap`` of the hierarchy ``h``, with the
    leaves-over-hosts rules named in ``rules``, in order."""
    from ceph_tpu_torch.crush.builder import CrushMap
    from ceph_tpu_torch.crush.types import CRUSH_BUCKET_STRAW2, Tunables

    cmap = CrushMap(tunables=Tunables(), type_names=maps.type_names(h))
    label = maps.names(h)
    for bid in sorted(h.buckets, reverse=True):
        t, items, weights = h.buckets[bid]
        cmap.add_bucket(CRUSH_BUCKET_STRAW2, t, items, weights, id=bid, name=label[bid])
    for mode in rules:
        cmap.add_simple_rule(f"{mode}_rule", "default", "host", mode=mode)
    return cmap
