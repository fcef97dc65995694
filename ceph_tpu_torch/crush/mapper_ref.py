"""Scalar reference interpreter for crush_do_rule — the host oracle.

The port's copy of ``ceph_tpu/crush/mapper_ref.py`` (pure Python and
numpy, unchanged). A faithful Python rendition of the mapping semantics
of Ceph's src/crush/mapper.c:883-1088 (crush_do_rule), :443-631
(crush_choose_firstn), :638-826 (crush_choose_indep), :73-131
(bucket_perm_choose), :141-164 (list), :322-367 (straw2), :407-421
(is_out), held against the JAX package's copy by
tests/test_torch_crush.py.

It is the oracle of the batched mapper (``crush/batched.py``), the
fallback for maps and rules outside its fast path, and the executable
model of the CUDA kernel's per-seed loop (``csrc/crush_straw2.cu``).
"""

from __future__ import annotations

import numpy as np

from . import hashing
from .ln import LN_MIN_OFFSET, crush_ln, straw2_draw_divide
from .map import (CRUSH_ITEM_NONE, CRUSH_ITEM_UNDEF, CrushMap, RULE_CHOOSE_FIRSTN,
                  RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_FIRSTN,
                  RULE_CHOOSELEAF_INDEP, RULE_EMIT, RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
                  RULE_SET_CHOOSE_LOCAL_TRIES, RULE_SET_CHOOSE_TRIES,
                  RULE_SET_CHOOSELEAF_STABLE, RULE_SET_CHOOSELEAF_TRIES,
                  RULE_SET_CHOOSELEAF_VARY_R, RULE_TAKE)

S64_MIN = -(1 << 63)


def _u32(v):
    return np.uint32(v & 0xFFFFFFFF)


def _h2(a, b):
    with np.errstate(over="ignore"):
        return int(hashing.hash32_2(_u32(a), _u32(b)))


def _h3(a, b, c):
    with np.errstate(over="ignore"):
        return int(hashing.hash32_3(_u32(a), _u32(b), _u32(c)))


def _h4(a, b, c, d):
    with np.errstate(over="ignore"):
        return int(hashing.hash32_4(_u32(a), _u32(b), _u32(c), _u32(d)))


class _Workspace:
    """Per-computation perm state (struct crush_work_bucket)."""

    def __init__(self):
        self.perm = {}  # bucket id -> dict(perm_x, perm_n, perm list)

    def get(self, bucket):
        st = self.perm.get(bucket.id)
        if st is None:
            st = {"perm_x": 0, "perm_n": 0, "perm": [0] * bucket.size}
            self.perm[bucket.id] = st
        return st


def _bucket_perm_choose(bucket, work, x, r):
    # mapper.c:73-131
    st = work.get(bucket)
    pr = r % bucket.size
    if st["perm_x"] != (x & 0xFFFFFFFF) or st["perm_n"] == 0:
        st["perm_x"] = x & 0xFFFFFFFF
        if pr == 0:
            s = _h3(x, bucket.id, 0) % bucket.size
            st["perm"][0] = s
            st["perm_n"] = 0xFFFF
            return int(bucket.items[s])
        st["perm"] = list(range(bucket.size))
        st["perm_n"] = 0
    elif st["perm_n"] == 0xFFFF:
        for i in range(1, bucket.size):
            st["perm"][i] = i
        st["perm"][st["perm"][0]] = 0
        st["perm_n"] = 1
    while st["perm_n"] <= pr:
        p = st["perm_n"]
        if p < bucket.size - 1:
            i = _h3(x, bucket.id, p) % (bucket.size - p)
            if i:
                st["perm"][p + i], st["perm"][p] = st["perm"][p], st["perm"][p + i]
        st["perm_n"] += 1
    return int(bucket.items[st["perm"][pr]])


def _bucket_list_choose(bucket, x, r):
    # mapper.c:141-164
    sums = bucket.sum_weights
    for i in range(bucket.size - 1, -1, -1):
        w = _h4(x, int(bucket.items[i]), r, bucket.id) & 0xFFFF
        w = (w * int(sums[i])) >> 16
        if w < int(bucket.weights[i]):
            return int(bucket.items[i])
    return int(bucket.items[0])


def _choose_arg_weights(bucket, arg, position):
    """mapper.c:302-311 get_choose_arg_weights: positional weight-set
    substitution (the Luminous balancer's mechanism) — N past the end
    clamps to the last position."""
    if arg is None:
        return bucket.weights
    ws = arg.get("weight_set")
    if not ws:
        return bucket.weights
    if position >= len(ws):
        position = len(ws) - 1
    return ws[position]


def _choose_arg_ids(bucket, arg):
    # mapper.c:314-320: ids replace the item values fed to the HASH
    # only; the returned item still comes from bucket.items
    if arg is None:
        return bucket.items
    ids = arg.get("ids")
    return ids if ids else bucket.items


def _bucket_straw2_choose(bucket, x, r, arg=None, position=0):
    # mapper.c:322-367
    weights = _choose_arg_weights(bucket, arg, position)
    ids = _choose_arg_ids(bucket, arg)
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        wt = int(weights[i])
        if wt:
            u = _h3(x, int(ids[i]), r) & 0xFFFF
            lnv = int(crush_ln(np.int64(u))) - LN_MIN_OFFSET
            draw = int(straw2_draw_divide(lnv, wt))
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return int(bucket.items[high])


def _bucket_choose(bucket, work, x, r, arg=None, position=0):
    if bucket.size == 0:
        raise AssertionError("empty bucket")
    if bucket.alg == "uniform":
        return _bucket_perm_choose(bucket, work, x, r)
    if bucket.alg == "list":
        return _bucket_list_choose(bucket, x, r)
    if bucket.alg == "straw2":
        # only straw2 honors choose_args (mapper.c:374-396)
        return _bucket_straw2_choose(bucket, x, r, arg, position)
    raise NotImplementedError("bucket alg %r" % bucket.alg)


def _is_out(cmap, weight, item, x):
    # mapper.c:407-421
    if item >= len(weight):
        return True
    w = int(weight[item])
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (_h2(x, item) & 0xFFFF) >= w


def _choose_firstn(cmap, work, bucket, weight, x, numrep, type, out, outpos,
                   out_size, tries, recurse_tries, local_retries,
                   local_fallback_retries, recurse_to_leaf, vary_r, stable,
                   out2, parent_r, max_devices=None, choose_args=None):
    if max_devices is None:
        max_devices = cmap.max_devices
    # mapper.c:443-631 (control flow mirrors the do/while + goto structure)
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        item = 0
        while True:                       # do { ... } while (retry_descent)
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            while True:                   # do { ... } while (retry_bucket)
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_bucket.size >> 1)
                            and flocal > local_fallback_retries):
                        item = _bucket_perm_choose(in_bucket, work, x, r)
                    else:
                        # choose_args keyed by bucket id; position is
                        # the CURRENT output slot (mapper.c:512)
                        item = _bucket_choose(
                            in_bucket, work, x, r,
                            choose_args.get(in_bucket.id)
                            if choose_args else None, outpos)
                    if item >= max_devices:
                        skip_rep = True
                        break
                    if item < 0 and item not in cmap.buckets:
                        skip_rep = True
                        break
                    itemtype = cmap.buckets[item].type if item < 0 else 0
                    if itemtype != type:
                        if item >= 0:
                            skip_rep = True
                            break
                        in_bucket = cmap.buckets[item]
                        continue          # retry_bucket, no failure counted
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if _choose_firstn(
                                    cmap, work, cmap.buckets[item], weight, x,
                                    1 if stable else outpos + 1, 0,
                                    out2, outpos, count,
                                    recurse_tries, 0, local_retries,
                                    local_fallback_retries, False, vary_r,
                                    stable, None, sub_r,
                                    max_devices, choose_args) <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = _is_out(cmap, weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_bucket.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
                    if not retry_bucket:
                        break
                else:
                    break                 # success
            if not retry_descent:
                break
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def _choose_indep(cmap, work, bucket, weight, x, left, numrep, type, out,
                  outpos, tries, recurse_tries, recurse_to_leaf, out2,
                  parent_r, max_devices=None, choose_args=None):
    if max_devices is None:
        max_devices = cmap.max_devices
    # mapper.c:638-826
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
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if in_bucket.alg == "uniform" and in_bucket.size % numrep == 0:
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_bucket.size == 0:
                    break
                # indep passes its STARTING outpos as the weight-set
                # position, not rep (mapper.c:719-723)
                item = _bucket_choose(
                    in_bucket, work, x, r,
                    choose_args.get(in_bucket.id) if choose_args
                    else None, outpos)
                if item >= max_devices or (item < 0
                                           and item not in cmap.buckets):
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                itemtype = cmap.buckets[item].type if item < 0 else 0
                if itemtype != type:
                    if item >= 0:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_bucket = cmap.buckets[item]
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(cmap, work, cmap.buckets[item], weight,
                                      x, 1, numrep, 0, out2, rep,
                                      recurse_tries, 0, False, None, r,
                                      max_devices, choose_args)
                        if out2[rep] == CRUSH_ITEM_NONE:
                            break
                    else:
                        out2[rep] = item
                if itemtype == 0 and _is_out(cmap, weight, item, x):
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


def crush_do_rule(cmap: CrushMap, ruleno: int, x: int, result_max: int,
                  weight=None, choose_args=None) -> list[int]:
    """Run rule ruleno for input x; returns the result vector.

    weight: per-device reweight vector (16.16), defaults to all-in.
    choose_args: {bucket_id: {"ids": [...]|None,
    "weight_set": [[w,...] per position]|None}} — straw2 weight/id
    substitution (crush.h crush_choose_arg_map; the balancer's
    mechanism). Pass an int to select one of cmap.choose_args' sets."""
    if ruleno < 0 or ruleno >= len(cmap.rules):
        return []
    if isinstance(choose_args, int):
        choose_args = cmap.choose_args_get_with_fallback(choose_args)
    if choose_args:
        # validate sizes up front (the reference validates at decode):
        # a short row would otherwise IndexError mid-draw
        for bid, arg in choose_args.items():
            if not arg or bid not in cmap.buckets:
                continue
            size = cmap.buckets[bid].size
            ids = arg.get("ids")
            if ids and len(ids) != size:
                raise ValueError(
                    "choose_args ids for bucket %d: %d entries, "
                    "bucket has %d items" % (bid, len(ids), size))
            for row in arg.get("weight_set") or []:
                if len(row) != size:
                    raise ValueError(
                        "choose_args weight_set row for bucket %d: %d "
                        "weights, bucket has %d items"
                        % (bid, len(row), size))
    if weight is None:
        weight = [0x10000] * cmap.max_devices
    rule = cmap.rules[ruleno]
    t = cmap.tunables
    choose_tries = t.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    work = _Workspace()
    max_devices = cmap.max_devices
    w = []
    result = []
    for step in rule.steps:
        op = step[0]
        if op == RULE_TAKE:
            arg = step[1]
            if (0 <= arg < max_devices) or arg in cmap.buckets:
                w = [arg]
        elif op == RULE_SET_CHOOSE_TRIES:
            if step[1] > 0:
                choose_tries = step[1]
        elif op == RULE_SET_CHOOSELEAF_TRIES:
            if step[1] > 0:
                choose_leaf_tries = step[1]
        elif op == RULE_SET_CHOOSE_LOCAL_TRIES:
            if step[1] >= 0:
                choose_local_retries = step[1]
        elif op == RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step[1] >= 0:
                choose_local_fallback_retries = step[1]
        elif op == RULE_SET_CHOOSELEAF_VARY_R:
            if step[1] >= 0:
                vary_r = step[1]
        elif op == RULE_SET_CHOOSELEAF_STABLE:
            if step[1] >= 0:
                stable = step[1]
        elif op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
                    RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP):
            if not w:
                continue
            firstn = op in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN)
            recurse_to_leaf = op in (RULE_CHOOSELEAF_FIRSTN,
                                     RULE_CHOOSELEAF_INDEP)
            numrep_arg, type_arg = step[1], step[2]
            # C offsets the output arrays per working-vector entry
            # (o+osize with outpos j=0, crush_do_rule:1019-1056), scoping
            # collision checks and r values to each bucket's own slice.
            o = []
            c = []
            for wi in w:
                numrep = numrep_arg
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or wi not in cmap.buckets:
                    continue
                bucket = cmap.buckets[wi]
                osize = len(o)
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    sub_o = [0] * (result_max - osize)
                    sub_c = [0] * (result_max - osize)
                    n = _choose_firstn(
                        cmap, work, bucket, weight, x, numrep, type_arg,
                        sub_o, 0, result_max - osize, choose_tries,
                        recurse_tries, choose_local_retries,
                        choose_local_fallback_retries, recurse_to_leaf,
                        vary_r, stable, sub_c, 0, max_devices,
                        choose_args)
                    o.extend(sub_o[:n])
                    c.extend(sub_c[:n])
                else:
                    out_size = min(numrep, result_max - osize)
                    sub_o = [0] * out_size
                    sub_c = [0] * out_size
                    _choose_indep(
                        cmap, work, bucket, weight, x, out_size, numrep,
                        type_arg, sub_o, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, sub_c, 0, max_devices,
                        choose_args)
                    o.extend(sub_o)
                    c.extend(sub_c)
            w = c if recurse_to_leaf else o
        elif op == RULE_EMIT:
            result.extend(w[:result_max - len(result)])
            w = []
    return result
