"""Bucket choosers — pure functions of (bucket, x, r) (src/crush/mapper.c).

The C versions are stateful only through the perm workspace; since the
workspace is rebuilt whenever x changes and extended deterministically
within one x, ``bucket_perm_choose`` is a pure function of (bucket, x, r)
— re-derived here without the cache (mapper.c:73-131).

All arithmetic is uint32/uint64 exact; draws use python ints (unbounded)
where the C widens to __u64/__s64.
"""

from __future__ import annotations

from .hashing import crush_hash32_3, crush_hash32_4
from .ln import crush_ln
from .types import (
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_UNIFORM,
    Bucket,
    ChooseArg,
)

S64_MIN = -(1 << 63)


def bucket_perm_choose(bucket: Bucket, x: int, r: int) -> int:
    """Fisher-Yates permutation seeded by hash(x, id, step); pick slot
    r % size (mapper.c:73-131, incl. the r=0 fast path which is the
    p=0 swap of the full construction)."""
    size = bucket.size
    pr = r % size
    if pr == 0:
        s = crush_hash32_3(x, bucket.id, 0) % size
        return bucket.items[s]
    perm = list(range(size))
    for p in range(pr + 1):
        if p < size - 1:
            i = crush_hash32_3(x, bucket.id, p) % (size - p)
            if i:
                perm[p + i], perm[p] = perm[p], perm[p + i]
    return bucket.items[perm[pr]]


def bucket_uniform_choose(bucket: Bucket, x: int, r: int) -> int:
    return bucket_perm_choose(bucket, x, r)


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    """Walk tail→head; item i wins with probability weight_i/sum_i
    (mapper.c:141-164)."""
    for i in range(bucket.size - 1, -1, -1):
        w = crush_hash32_4(x, bucket.items[i], r, bucket.id)
        w &= 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    """Weighted descent of the implicit binary tree (mapper.c:195-222)."""
    n = len(bucket.node_weights) >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (crush_hash32_4(x, n, r, bucket.id) * w) >> 32
        h = _tree_height(n)
        left = n - (1 << (h - 1))
        if t < bucket.node_weights[left]:
            n = left
        else:
            n = n + (1 << (h - 1))
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    """Legacy straw: draw = hash16 * precomputed straw length; argmax
    (mapper.c:227-245)."""
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        draw = crush_hash32_3(x, bucket.items[i], r) & 0xFFFF
        draw *= bucket.straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def _draw_exponential(x: int, y: int, z: int, weight: int) -> int:
    """ln(U16)/weight in fixed point — the negative of an Exp(weight)
    sample (mapper.c:334-359); division truncates toward zero like C
    div64_s64."""
    u = crush_hash32_3(x, y, z) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    if ln < 0:
        return -((-ln) // weight)
    return ln // weight


def bucket_straw2_choose(
    bucket: Bucket,
    x: int,
    r: int,
    arg: ChooseArg | None = None,
    position: int = 0,
) -> int:
    """Min-of-exponentials sampling: P(item i) = w_i/Σw, fully
    independent per item (mapper.c:361-384) — this independence is what
    makes the batched mapper one argmax over a bucket's items."""
    weights = bucket.item_weights
    ids = bucket.items
    # empty weight_set/ids behave like none at all (the C's
    # weight_set_positions == 0 / ids_size == 0 cases)
    if arg is not None and arg.weight_set:
        pos = min(position, len(arg.weight_set) - 1)
        weights = arg.weight_set[pos]
    if arg is not None and arg.ids:
        ids = arg.ids
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        if weights[i]:
            draw = _draw_exponential(x, ids[i], r, weights[i])
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def crush_bucket_choose(
    bucket: Bucket,
    x: int,
    r: int,
    arg: ChooseArg | None = None,
    position: int = 0,
) -> int:
    """Dispatch on bucket.alg (mapper.c:387-418)."""
    assert bucket.size > 0
    if bucket.alg == CRUSH_BUCKET_UNIFORM:
        return bucket_uniform_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_TREE:
        return bucket_tree_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW:
        return bucket_straw_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW2:
        return bucket_straw2_choose(bucket, x, r, arg, position)
    return bucket.items[0]
