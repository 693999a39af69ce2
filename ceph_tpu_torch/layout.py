"""Stripe batch layout — the one definition of the fold the backend uses.

A stripe batch is (B, n, chunk_bytes); region math wants (n, bytes).
Folding the batch into the byte axis keeps the per-stripe chunk layout
and lets arbitrarily many stripes ride one kernel call (the hoisted
ECUtil::encode per-stripe loop, src/osd/ECUtil.cc:123-162).

Works on numpy arrays and torch tensors alike (torch spells the axis
permutation ``permute``; numpy ``transpose``).
"""

from __future__ import annotations


def _swap01(x):
    order = (1, 0, 2)
    return x.permute(order) if hasattr(x, "permute") else x.transpose(order)


def fold_stripes(stripes):
    """(B, n, chunk) → (n, B*chunk)."""
    b, n, chunk = stripes.shape
    return _swap01(stripes).reshape(n, b * chunk)


def unfold_stripes(flat, batch: int, chunk: int):
    """(m, B*chunk) → (B, m, chunk) (inverse of fold_stripes)."""
    m = flat.shape[0]
    return _swap01(flat.reshape(m, batch, chunk))
