"""MDS — the metadata daemon tier over rados
(src/mds/Server.cc + src/mds/Locker.cc + src/osdc/Journaler.cc,
reduced to the load-bearing machinery).

Three pieces:

- ``Journaler`` (journaler.py): the replayable metadata journal on
  rados — a striped entry stream with a head object tracking
  write/expire positions (src/osdc/Journaler.cc:1). rbd's image journal
  and rbd-mirror ride it too.
- ``MDSDaemon`` (server.py): client sessions, a path-walked metadata
  cache journaled ahead of lazy backing-store flushes, capability
  grant/recall for coherent client caching, and mon-driven
  active/standby failover (beacons through the monitor's command
  plane; the MDSMonitor role).
- ``MDSClient`` (client.py): the capability-aware mount — metadata
  through the MDS session, file DATA striped straight to the data
  pool with the real CephFS object naming, readdir/stat caching valid
  exactly while the MDS-granted capability stands.

The cap-free library-mode client (dirfrags-in-omap, single writer)
remains at ceph_tpu_torch.fs.CephFS. None of these compute on a
device: their bytes are encoded by the OSDs of the pools they name.
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
from .server import MDSDaemon  # noqa: E402
from .client import MDSClient, MDSError  # noqa: E402

__all__ = [
    "Journaler", "MDSDaemon", "MDSClient", "MDSError",
    "subtree_auth_rank", "path_dirname",
]
