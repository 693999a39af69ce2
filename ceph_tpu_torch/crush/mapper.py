"""crush_do_rule — the exact-semantics CPU oracle (src/crush/mapper.c).

Pure function of (map, ruleno, x, weights, choose_args): no workspace,
no globals.  The retry-descent control flow of crush_choose_firstn
(mapper.c:460-648) and the breadth-first crush_choose_indep
(mapper.c:655-843) are re-derived with explicit loop flags in place of
the C gotos; every reject path advances r' identically, which is the
whole game (SURVEY.md §7 "hard parts" #2).

The C passes pointer slices (o+osize) into the choosers, so all chooser
indexing — collision scans, replica numbering, out2 slots — is relative
to the invocation's own frame.  Here each invocation gets explicit
relative lists and do_rule stitches the frames back together.

``weight`` is the 16.16 per-device reweight vector (OSD in/out state),
NOT the crush weights inside buckets.
"""

from __future__ import annotations

from .buckets import bucket_perm_choose, crush_bucket_choose
from .hashing import crush_hash32_2
from .types import (
    CRUSH_BUCKET_UNIFORM,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_TAKE,
)


def is_out(weight: list[int], item: int, x: int) -> bool:
    """Probabilistic overload rejection against the 16.16 reweight
    vector (mapper.c:424-438)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (crush_hash32_2(x, item) & 0xFFFF) >= w


def _item_type(cmap, item: int) -> int | None:
    """Type of an item; None means invalid reference."""
    if item >= 0:
        return 0
    b = cmap.buckets.get(item)
    return None if b is None else b.type


def crush_choose_firstn(
    cmap,
    bucket,
    weight,
    x: int,
    numrep: int,
    type: int,
    out: list[int],
    outpos: int,
    out_size: int,
    tries: int,
    recurse_tries: int,
    local_retries: int,
    local_fallback_retries: int,
    recurse_to_leaf: bool,
    vary_r: int,
    stable: int,
    out2: list[int] | None,
    parent_r: int,
    choose_args,
) -> int:
    """Depth-first chooser: one replica at a time, full re-descent on
    reject with r' = rep + parent_r + ftotal.  ``out``/``out2`` are
    frame-relative; returns the new outpos."""
    count = out_size
    item = 0
    for rep in range(0 if stable else outpos, numrep):
        if count <= 0:
            break
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_b = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                collide = False
                reject = False
                r = rep + parent_r + ftotal

                if in_b.size == 0:
                    reject = True
                else:
                    if (
                        local_fallback_retries > 0
                        and flocal >= (in_b.size >> 1)
                        and flocal > local_fallback_retries
                    ):
                        item = bucket_perm_choose(in_b, x, r)
                    else:
                        item = crush_bucket_choose(
                            in_b, x, r, choose_args.get(in_b.id), outpos
                        )
                    if item >= cmap.max_devices:
                        skip_rep = True
                        break

                    itemtype = _item_type(cmap, item)

                    if itemtype != type:
                        if item >= 0 or itemtype is None:
                            skip_rep = True
                            break
                        in_b = cmap.buckets[item]
                        retry_bucket = True
                        continue

                    collide = item in out[:outpos]

                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if (
                                crush_choose_firstn(
                                    cmap,
                                    cmap.buckets[item],
                                    weight,
                                    x,
                                    1 if stable else outpos + 1,
                                    0,
                                    out2,
                                    outpos,
                                    count,
                                    recurse_tries,
                                    0,
                                    local_retries,
                                    local_fallback_retries,
                                    False,
                                    vary_r,
                                    stable,
                                    None,
                                    sub_r,
                                    choose_args,
                                )
                                <= outpos
                            ):
                                reject = True  # didn't get a leaf
                        else:
                            out2[outpos] = item  # already a leaf

                    if not reject and not collide and itemtype == 0:
                        reject = is_out(weight, item, x)

                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (
                        local_fallback_retries > 0
                        and flocal <= in_b.size + local_fallback_retries
                    ):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True

        if skip_rep:
            continue
        out[outpos] = item
        outpos += 1
        count -= 1
    return outpos


def crush_choose_indep(
    cmap,
    bucket,
    weight,
    x: int,
    left: int,
    numrep: int,
    type: int,
    out: list[int],
    outpos: int,
    tries: int,
    recurse_tries: int,
    recurse_to_leaf: bool,
    out2: list[int] | None,
    parent_r: int,
    choose_args,
) -> None:
    """Breadth-first positionally-stable chooser for EC: all unplaced
    positions retried per round with r' = rep + parent_r + n*ftotal;
    unfillable slots become CRUSH_ITEM_NONE."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF

    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_b = bucket
            while True:
                r = rep + parent_r
                if (
                    in_b.alg == CRUSH_BUCKET_UNIFORM
                    and in_b.size % numrep == 0
                ):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal

                if in_b.size == 0:
                    break

                item = crush_bucket_choose(
                    in_b, x, r, choose_args.get(in_b.id), outpos
                )
                if item >= cmap.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break

                itemtype = _item_type(cmap, item)

                if itemtype != type:
                    if item >= 0 or itemtype is None:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_b = cmap.buckets[item]
                    continue

                if any(out[i] == item for i in range(outpos, endpos)):
                    break  # collision

                if recurse_to_leaf:
                    if item < 0:
                        crush_choose_indep(
                            cmap,
                            cmap.buckets[item],
                            weight,
                            x,
                            1,
                            numrep,
                            0,
                            out2,
                            rep,
                            recurse_tries,
                            0,
                            False,
                            None,
                            r,
                            choose_args,
                        )
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break  # placed nothing; no leaf
                    elif out2 is not None:
                        out2[rep] = item  # already a leaf

                if itemtype == 0 and is_out(weight, item, x):
                    break

                out[rep] = item
                left -= 1
                break
        ftotal += 1

    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def crush_do_rule(
    cmap,
    ruleno: int,
    x: int,
    result_max: int,
    weight: list[int],
    choose_args=None,
) -> list[int]:
    """Interpret a rule program over working vectors w/o/c
    (mapper.c:900-1105).  Returns the result vector (possibly shorter
    than result_max; EC holes are CRUSH_ITEM_NONE)."""
    if ruleno < 0 or ruleno >= len(cmap.rules) or cmap.rules[ruleno] is None:
        return []
    rule = cmap.rules[ruleno]
    args = choose_args if choose_args is not None else cmap.choose_args
    t = cmap.tunables

    # choose_total_tries counted "retries" historically; +1 (mapper.c:921-925)
    choose_tries = t.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    result: list[int] = []
    w: list[int] = []
    wsize = 0

    for step in rule.steps:
        op = step.op
        if op == CRUSH_RULE_TAKE:
            item = step.arg1
            if (0 <= item < cmap.max_devices) or item in cmap.buckets:
                w = [item]
                wsize = 1
        elif op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif op in (
            CRUSH_RULE_CHOOSELEAF_FIRSTN,
            CRUSH_RULE_CHOOSE_FIRSTN,
            CRUSH_RULE_CHOOSELEAF_INDEP,
            CRUSH_RULE_CHOOSE_INDEP,
        ):
            firstn = op in (
                CRUSH_RULE_CHOOSELEAF_FIRSTN,
                CRUSH_RULE_CHOOSE_FIRSTN,
            )
            if wsize == 0:
                continue
            recurse_to_leaf = op in (
                CRUSH_RULE_CHOOSELEAF_FIRSTN,
                CRUSH_RULE_CHOOSELEAF_INDEP,
            )
            o: list[int] = []
            c: list[int] = []
            osize = 0
            for i in range(wsize):
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                bucket = cmap.buckets.get(w[i])
                if bucket is None:
                    continue  # w[i] is probably CRUSH_ITEM_NONE
                # frame-relative scratch for this invocation (o+osize in C)
                avail = result_max - osize
                fo = [0] * result_max
                fc = [0] * result_max
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    got = crush_choose_firstn(
                        cmap,
                        bucket,
                        weight,
                        x,
                        numrep,
                        step.arg2,
                        fo,
                        0,
                        avail,
                        choose_tries,
                        recurse_tries,
                        choose_local_retries,
                        choose_local_fallback_retries,
                        recurse_to_leaf,
                        vary_r,
                        stable,
                        fc,
                        0,
                        args,
                    )
                else:
                    got = min(numrep, avail)
                    crush_choose_indep(
                        cmap,
                        bucket,
                        weight,
                        x,
                        got,
                        numrep,
                        step.arg2,
                        fo,
                        0,
                        choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf,
                        fc,
                        0,
                        args,
                    )
                o.extend(fo[:got])
                c.extend(fc[:got])
                osize += got

            if recurse_to_leaf:
                o = c[:osize]  # copy final leaf values to output set
            w = o
            wsize = osize
        elif op == CRUSH_RULE_EMIT:
            for i in range(wsize):
                if len(result) >= result_max:
                    break
                result.append(w[i])
            wsize = 0
    return result
