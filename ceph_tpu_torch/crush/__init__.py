"""CRUSH placement for ceph_tpu_torch.

Port-side copies of the CRUSH host modules (types, hashing, ln,
buckets, mapper, builder, encode) and a batched torch mapper:

- ``mapper`` / ``buckets`` — the exact-semantics oracle (pure Python),
  the same placements as the reference ``crush_do_rule`` over every
  bucket algorithm.
- ``builder`` — map construction; ``CrushMap.copy_from`` reads a map
  built elsewhere by attribute.
- ``encode`` — the map's versioned wire form (the OSD map's crush
  blob and content fingerprint).
- ``torchmap`` — the batched mapper: a map (every bucket algorithm,
  choose_args) compiled to dense int64 tensors on the card, and the
  rule program run over a whole PG batch at once.  Imported on demand
  (it imports torch).
"""

from .builder import CrushMap
from .hashing import crush_hash32, crush_hash32_2, crush_hash32_3
from .ln import crush_ln
from .mapper import CRUSH_ITEM_NONE, crush_do_rule
from .types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    Bucket,
    Rule,
    RuleStep,
    Tunables,
)

__all__ = [
    "CRUSH_BUCKET_LIST",
    "CRUSH_BUCKET_STRAW",
    "CRUSH_BUCKET_STRAW2",
    "CRUSH_BUCKET_TREE",
    "CRUSH_BUCKET_UNIFORM",
    "CRUSH_ITEM_NONE",
    "Bucket",
    "CrushMap",
    "Rule",
    "RuleStep",
    "Tunables",
    "crush_do_rule",
    "crush_hash32",
    "crush_hash32_2",
    "crush_hash32_3",
    "crush_ln",
]
