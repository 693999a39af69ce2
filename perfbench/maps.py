"""CRUSH hierarchies as the benchmark describes them, for the reference
and, through ``drivers/_program.py``, for the program alike."""

from __future__ import annotations

from .reference.crush import Hierarchy

HOST = 1
# bucket types by level above the OSDs, as ``crushtool --build`` numbers
# its layers; the root is the level above the last
LEVELS = ("host", "rack", "row")


def hierarchy(num_osds: int, fanout, weight: int = 0x10000) -> Hierarchy:
    """root -> ... -> hosts -> OSDs, every bucket straw2, every OSD at
    ``weight``.  ``fanout[0]`` OSDs make a host, ``fanout[1]`` hosts a
    rack, ``fanout[2]`` racks a row (each level's last bucket takes what
    is left); the root holds the top level.  Rule 0 chooses leaves over
    hosts firstn, rule 1 indep.  Bucket ids count down from -1 in the
    order added: hosts, racks, rows, root."""
    h = Hierarchy()
    level = list(range(num_osds))
    for t, per in enumerate(fanout, start=1):
        level = [h.add_bucket(t, level[i:i + per],
                              [weight if o >= 0 else h.weight(o) for o in level[i:i + per]])
                 for i in range(0, len(level), per)]
    root = h.add_bucket(len(fanout) + 1, level, [h.weight(b) for b in level])
    h.add_rule(root, HOST, "firstn")
    h.add_rule(root, HOST, "indep")
    return h


def type_names(h: Hierarchy) -> dict:
    """Type id -> name: osd, host, rack, row, and the top ``root``."""
    top = max(t for t, _i, _w in h.buckets.values())
    return {0: "osd", **{t: LEVELS[t - 1] for t in range(1, top)}, top: "root"}


def names(h: Hierarchy) -> dict:
    """Bucket id -> name: host<n>, rack<n>, row<n>, and the root
    ``default``."""
    kinds = type_names(h)
    out, count = {}, {}
    for bid in sorted(h.buckets, reverse=True):
        kind = kinds[h.buckets[bid][0]]
        if kind == "root":
            out[bid] = "default"
        else:
            out[bid] = f"{kind}{count.setdefault(kind, 0)}"
            count[kind] += 1
    return out


def hosts(h: Hierarchy) -> list:
    """The OSDs of each host, in bucket order."""
    return [items for _b, (t, items, _w) in sorted(h.buckets.items(), reverse=True) if t == HOST]
