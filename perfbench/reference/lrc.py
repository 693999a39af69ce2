"""The CRUSH rule of Ceph's LRC erasure-code plugin, as plain steps for
the reference's ``Hierarchy``: ErasureCodeLrc::parse_kml's choice of
steps from k, m, l, crush-locality and crush-failure-domain, and
ErasureCodeLrc::create_rule's rule around them
(src/erasure-code/lrc/ErasureCodeLrc.cc)."""

from __future__ import annotations

from .crush import (
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_SET_CHOOSE_TRIES,
    RULE_SET_CHOOSELEAF_TRIES,
    RULE_TAKE,
    Hierarchy,
)


def groups(k: int, m: int, lp: int) -> int:
    """The number of local groups, (k + m) / l with ``lp`` the profile's
    l, under parse_kml's checks: l divides k + m, and the groups divide
    k and m."""
    if lp <= 0 or (k + m) % lp:
        raise ValueError("k + m must be a multiple of l")
    g = (k + m) // lp
    if k % g or m % g:
        raise ValueError("k and m must be multiples of (k + m) / l")
    return g


def chunk_count(k: int, m: int, lp: int) -> int:
    """Chunks a PG places: k + m, and one local parity a group."""
    return k + m + groups(k, m, lp)


def kml_steps(k: int, m: int, lp: int, locality: str, failure_domain: str) -> list:
    """parse_kml's rule steps as (op, type name, n): with a locality,
    choose a bucket of that type a group, then l + 1 leaves a bucket
    over the failure domain; without one, leaves over the failure
    domain."""
    g = groups(k, m, lp)
    if locality:
        return [("choose", locality, g), ("chooseleaf", failure_domain, lp + 1)]
    return [("chooseleaf", failure_domain, 0)]


def add_rule(h: Hierarchy, root: int, type_ids: dict, steps: list) -> int:
    """create_rule: chooseleaf tries 5, choose tries 100, TAKE the root,
    each step indep, EMIT; appended to ``h.rules``, its index
    returned."""
    rule = [(RULE_SET_CHOOSELEAF_TRIES, 5, 0), (RULE_SET_CHOOSE_TRIES, 100, 0),
            (RULE_TAKE, root, 0)]
    for op, type_name, n in steps:
        rule.append((RULE_CHOOSE_INDEP if op == "choose" else RULE_CHOOSELEAF_INDEP, n,
                     type_ids[type_name]))
    rule.append((RULE_EMIT, 0, 0))
    h.rules.append(rule)
    return len(h.rules) - 1
