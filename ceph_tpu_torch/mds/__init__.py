"""MDS — for now only the replayable metadata journal on rados and the
two path rules the MDS server and its clients share (src/osdc/
Journaler.cc, the MDCache subtree-auth rule).

- ``Journaler`` (journaler.py): a striped entry stream with a head
  object tracking write/expire positions (src/osdc/Journaler.cc:1).
  rbd's image journal and rbd-mirror ride it.

The metadata daemon (``MDSDaemon``) and its capability-aware client
(``MDSClient``, ``MDSError``) are not in this package yet: they come
with the file-system layer, and this module imports neither.
"""


def subtree_auth_rank(table: dict, path: str) -> int:
    """Longest-prefix match of ``path`` against a subtree pin table
    (the MDCache subtree-auth resolution rule).  SHARED between the
    MDS server's enforcement and the client's routing: the two ends
    must agree on this protocol invariant or clients spin on
    -ESTALE."""
    parts = [p for p in path.split("/") if p]
    best, bestlen = 0, -1
    for pref, r in table.items():
        pp = [x for x in pref.split("/") if x]
        if parts[: len(pp)] == pp and len(pp) > bestlen:
            best, bestlen = r, len(pp)
    return best


def path_dirname(path: str) -> str:
    """Parent directory of a slash path ('/' for top-level names)."""
    parts = [p for p in path.split("/") if p]
    return "/" + "/".join(parts[:-1])


from .journaler import Journaler  # noqa: E402

__all__ = ["Journaler", "subtree_auth_rank", "path_dirname"]
