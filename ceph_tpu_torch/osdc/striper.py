"""Striper — file/image extents ⇄ object extents
(src/osdc/Striper.cc; the file_layout_t math of
src/include/ceph_fs.h: stripe_unit/stripe_count/object_size).

A logical byte range striped RAID-0 style across a rotating window of
``stripe_count`` objects: block b (of ``stripe_unit`` bytes) lands in
stripe ``b // stripe_count`` at position ``b % stripe_count``;
``object_size // stripe_unit`` stripes fill an object before the
window advances to the next object set.  This is the layout librbd,
libradosstriper and the MDS file layer all share.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StripeLayout:
    """file_layout_t subset: all three in bytes/objects."""

    stripe_unit: int = 1 << 22  # 4 MiB
    stripe_count: int = 1
    object_size: int = 1 << 22

    def __post_init__(self):
        if self.stripe_unit <= 0 or self.stripe_count <= 0:
            raise ValueError("stripe_unit/stripe_count must be > 0")
        if (
            self.object_size <= 0
            or self.object_size % self.stripe_unit
        ):
            raise ValueError(
                "object_size must be a positive multiple of "
                "stripe_unit"
            )

    @property
    def stripes_per_object(self) -> int:
        return self.object_size // self.stripe_unit


def map_extent(
    layout: StripeLayout, offset: int, length: int
) -> list[tuple[int, int, int]]:
    """Logical [offset, offset+length) → ordered
    [(object_no, obj_offset, len)] (Striper::file_to_extents),
    adjacent runs within one object coalesced."""
    su = layout.stripe_unit
    sc = layout.stripe_count
    spo = layout.stripes_per_object
    out: list[tuple[int, int, int]] = []
    pos = offset
    end = offset + length
    while pos < end:
        blockno = pos // su
        stripeno = blockno // sc
        stripepos = blockno % sc
        objectsetno = stripeno // spo
        objectno = objectsetno * sc + stripepos
        block_off = pos % su
        obj_off = (stripeno % spo) * su + block_off
        n = min(su - block_off, end - pos)
        if out and out[-1][0] == objectno and (
            out[-1][1] + out[-1][2] == obj_off
        ):
            o, oo, ol = out[-1]
            out[-1] = (o, oo, ol + n)
        else:
            out.append((objectno, obj_off, n))
        pos += n
    return out
