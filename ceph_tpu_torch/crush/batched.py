"""Batched CRUSH mapping: every seed of a sweep in one device call.

Port of ``ceph_tpu/crush/batched.py``. The reference recomputes PG
mappings with a pool of CPU threads walking crush_do_rule one PG at a
time (Ceph's OSDMapMapping / ParallelPGMapper); here a whole sweep is
one call: :func:`batched_do_rule` runs the hand-written CUDA kernel
(``csrc/crush_straw2.cu``, wrapper ``ops/crush_kernel.py``) for seeds on
the card, one launch a call, and this module's plain PyTorch version for
seeds on the CPU.

Scope of the fast path, as in the reference: straw2 hierarchies with a
rule of the canonical take -> choose/chooseleaf (indep or firstn) ->
emit shape (``set_choose_tries`` / ``set_chooseleaf_tries`` allowed),
firstn under the jewel tunables, with choose_args weight sets and ids
and a reweight vector. Legacy bucket algs, multi-step rules, chooseleaf
to type 0, firstn under other tunables and malformed maps take the
port's scalar interpreter (``crush/mapper_ref.py``) on the host, as in
the reference; :func:`paths` counts which path each call took. A sweep,
kernel or plain, is counted in the device profiler's kernel registry
(``common/profiler.py``) as ``crush.indep`` or ``crush.firstn``, the
reference's names; its signature keys on the map's item table, the seeds
and the reweight vector.

The plain version ports the reference's vectorised XLA program to int64
torch tensors (``take_along_axis`` becomes ``gather``, the while and
fori loops Python loops, ``argmax`` keeps the first maximum). Seeds map
independently, so it maps them in chunks whose largest intermediate
holds at most ``PLAIN_CHUNK_VALUES`` int64 values (at most
``PLAIN_CHUNK_SEEDS`` seeds): the firstn precompute is
``[B, numrep, tries, S]`` and would not fit the card whole at 2^20
seeds.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..common.profiler import PROFILER
from ..device import resolve_device
from ..parallel import rateless
from ..parallel.mesh import Mesh, mesh_devices
from .hashing import hash32_2_t, hash32_3_t
from .ln import LN_MIN_OFFSET, crush_ln_t, straw2_draw_divide_t
from .map import (CRUSH_ITEM_NONE, CRUSH_ITEM_UNDEF, CrushMap,
                  RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP,
                  RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT,
                  RULE_SET_CHOOSE_TRIES, RULE_SET_CHOOSELEAF_TRIES, RULE_TAKE)
from .mapper_ref import crush_do_rule

S64_MIN = -(1 << 63)
PLAIN_CHUNK_VALUES = 1 << 24
PLAIN_CHUNK_SEEDS = 65536

_paths = {"kernel": 0, "plain": 0, "scalar": 0}
_paths_lock = threading.Lock()


def paths() -> dict[str, int]:
    """{path: calls since the last reset}: "kernel" (the CUDA kernel),
    "plain" (the plain version, seeds on the CPU), "scalar" (the host
    interpreter, maps and rules outside the fast path)."""
    with _paths_lock:
        return dict(_paths)


def reset_paths() -> None:
    with _paths_lock:
        for k in _paths:
            _paths[k] = 0


def _count(path: str) -> None:
    with _paths_lock:
        _paths[path] += 1


@dataclass(frozen=True)
class CompiledMap:
    """Dense array form of a straw2 CrushMap for device execution."""
    items: np.ndarray      # [NB, S] int64, padded with 0
    weights: np.ndarray    # [NB, S] int64 (16.16), padded with 0
    size: np.ndarray       # [NB] int64
    btype: np.ndarray      # [NB] int64
    depth: int             # max descent depth (levels of buckets)
    max_devices: int
    # choose_args substitution (crush.h crush_choose_arg): hash ids
    # (position-independent) and positional weight-sets. Per-bucket
    # position clamping (mapper.c:309-310) is materialized into wsets
    # at compile time, so runtime only clamps to npos-1 globally.
    # Without choose_args: ids == items, wsets == weights[:, None].
    ids: np.ndarray = None     # [NB, S] int64 — values fed to the hash
    wsets: np.ndarray = None   # [NB, P, S] int64 — weights per position
    npos: int = 1              # P (max positions across buckets)


def compile_map(cmap: CrushMap, choose_args=None) -> CompiledMap:
    """The reference's ``compile_map`` (batched.py:69): raises
    NotImplementedError for a non-straw2 bucket and ValueError for a
    dangling reference or a cycle, and (the port's addition) for a value
    that crush.h's types cannot hold, which the CUDA kernel holds: item
    ids and bucket types past int32, weights past uint32."""
    nb = cmap.max_buckets
    s = max(b.size for b in cmap.buckets.values())
    items = np.zeros((nb, s), dtype=np.int64)
    weights = np.zeros((nb, s), dtype=np.int64)
    size = np.zeros(nb, dtype=np.int64)
    btype = np.zeros(nb, dtype=np.int64)
    for bid, b in cmap.buckets.items():
        if b.alg != "straw2":
            raise NotImplementedError(
                "batched mapper requires straw2 buckets (got %r); use "
                "mapper_ref for legacy algs" % b.alg)
        idx = -1 - bid
        items[idx, :b.size] = b.items
        weights[idx, :b.size] = b.weights
        size[idx] = b.size
        btype[idx] = b.type
    ids = items.copy()
    npos = 1
    if choose_args:
        for bid, arg in choose_args.items():
            if arg and arg.get("weight_set"):
                npos = max(npos, len(arg["weight_set"]))
    wsets = np.repeat(weights[:, None, :], npos, axis=1)
    if choose_args:
        for bid, arg in choose_args.items():
            if not arg or bid not in cmap.buckets:
                continue
            idx = -1 - bid
            bsz = cmap.buckets[bid].size
            if arg.get("ids"):
                ids[idx, :bsz] = np.asarray(arg["ids"], dtype=np.int64)
            ws = arg.get("weight_set")
            if ws:
                for p, row in enumerate(ws):
                    wsets[idx, p, :bsz] = np.asarray(row, dtype=np.int64)
                # positions past the bucket's own count clamp to its
                # last (mapper.c:309-310)
                for p in range(len(ws), npos):
                    wsets[idx, p, :bsz] = wsets[idx, len(ws) - 1, :bsz]

    def depth_of(bid, seen=frozenset()):
        if bid not in cmap.buckets:
            raise ValueError("dangling bucket reference %d" % bid)
        if bid in seen:
            raise ValueError("cycle through bucket %d" % bid)
        b = cmap.buckets[bid]
        kids = [int(i) for i in b.items if i < 0]
        if not kids:
            return 1
        return 1 + max(depth_of(k, seen | {bid}) for k in kids)

    depth = max(depth_of(bid) for bid in cmap.buckets)
    for what, a, lo, hi in (("item id", items, -(1 << 31), (1 << 31) - 1),
                            ("bucket type", btype, -(1 << 31), (1 << 31) - 1),
                            ("weight", wsets, 0, (1 << 32) - 1)):
        if a.size and (a.min() < lo or a.max() > hi):
            raise ValueError("a %s past crush.h's type" % what)
    return CompiledMap(items=items, weights=weights, size=size, btype=btype,
                       depth=depth, max_devices=cmap.max_devices,
                       ids=ids, wsets=wsets, npos=npos)


@dataclass(frozen=True)
class RulePlan:
    """A fast-path rule resolved against the map's tunables and the
    call's result_max (``batched.py:587-620`` of the reference)."""
    root: int            # bucket id the rule takes
    firstn: bool
    chooseleaf: bool
    target_type: int
    numrep: int          # the retry stride: numrep_arg, or + result_max
    out_size: int        # indep slots filled: min(numrep, result_max)
    result_max: int
    tries: int
    recurse_tries: int
    vary_r: int


def _rule_shape(cmap: CrushMap, ruleno: int):
    """Extract (root, op, numrep_arg, type) from a canonical 3-step rule;
    None if the rule is outside the batched fast path."""
    choose_tries = None
    leaf_tries = None
    core = []
    for s in cmap.rules[ruleno].steps:
        if s[0] == RULE_SET_CHOOSE_TRIES:
            choose_tries = s[1]
        elif s[0] == RULE_SET_CHOOSELEAF_TRIES:
            leaf_tries = s[1]
        else:
            core.append(s)
    if len(core) != 3 or core[0][0] != RULE_TAKE or core[2][0] != RULE_EMIT:
        return None
    op = core[1][0]
    if op not in (RULE_CHOOSE_INDEP, RULE_CHOOSELEAF_INDEP,
                  RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN):
        return None
    return dict(root=core[0][1], op=op, numrep_arg=core[1][1],
                type=core[1][2], choose_tries=choose_tries,
                leaf_tries=leaf_tries)


def plan_rule(cmap: CrushMap, ruleno: int, result_max: int):
    """The RulePlan of rule `ruleno`, or None where the reference's fast
    path does not take the map and rule (then the scalar interpreter
    maps them)."""
    shape = _rule_shape(cmap, ruleno)
    if shape is None:
        return None
    t = cmap.tunables
    firstn = shape["op"] in (RULE_CHOOSE_FIRSTN, RULE_CHOOSELEAF_FIRSTN)
    chooseleaf = shape["op"] in (RULE_CHOOSELEAF_INDEP,
                                 RULE_CHOOSELEAF_FIRSTN)
    # the firstn path is bit-exact for the jewel defaults only
    if firstn and not (t.choose_local_tries == 0
                       and t.choose_local_fallback_tries == 0
                       and t.chooseleaf_stable == 1):
        return None
    if chooseleaf and shape["type"] == 0:
        return None
    if any(b.alg != "straw2" for b in cmap.buckets.values()):
        return None
    numrep = shape["numrep_arg"]
    if numrep <= 0:
        numrep += result_max
    tries = shape["choose_tries"] or (t.choose_total_tries + 1)
    if firstn:
        # recurse_tries per do_rule (mapper.c:1014-1020)
        if shape["leaf_tries"]:
            recurse_tries = shape["leaf_tries"]
        elif t.chooseleaf_descend_once:
            recurse_tries = 1
        else:
            recurse_tries = tries
    else:
        recurse_tries = shape["leaf_tries"] or 1
    return RulePlan(root=shape["root"], firstn=firstn, chooseleaf=chooseleaf,
                    target_type=shape["type"], numrep=numrep,
                    out_size=min(numrep, result_max), result_max=result_max,
                    tries=tries, recurse_tries=recurse_tries,
                    vary_r=t.chooseleaf_vary_r)


def reweight_vector(weight, max_devices: int) -> np.ndarray:
    """The reweight vector as int64 in [0, 0x10000], at least one entry.

    ``is_out`` reads any value of 0x10000 and up as fully in and any
    value of 0 and below as out, and an item past the vector as out, so
    clamping and a trailing 0 for an empty vector map the same."""
    if weight is None:
        return np.full(max(max_devices, 1), 0x10000, dtype=np.int64)
    if isinstance(weight, torch.Tensor):
        weight = weight.cpu().numpy()
    w = np.clip(np.asarray(weight, dtype=np.int64).reshape(-1), 0, 0x10000)
    return w if w.size else np.zeros(1, dtype=np.int64)


# -- the plain version ---------------------------------------------------------

def _tables(cm: CompiledMap, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cm.items, cm.ids, cm.wsets, cm.size, cm.btype))


def _straw2_choose(tabs, bucket_idx, x, r, pos):
    """bucket_straw2_choose (mapper.c:322-367) over [...] buckets, seeds
    and r values: the hash takes the (substituted) ids, the draw divides
    by the position's weight-set row, and the first maximum wins (the C
    compares with a strict >; an empty slot or a zero weight draws
    S64_MIN)."""
    items_a, ids_a, wsets_a, size_a, _ = tabs
    items = items_a[bucket_idx]                  # [..., S]
    ids = ids_a[bucket_idx]
    npos = wsets_a.shape[1]
    if npos == 1:
        weights = wsets_a[bucket_idx, 0]
    else:
        p = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
        p = p.clamp(0, npos - 1).expand(bucket_idx.shape)
        weights = wsets_a[bucket_idx, p]
    u = hash32_3_t(x[..., None], ids, r[..., None]) & 0xFFFF
    draw = straw2_draw_divide_t(crush_ln_t(u) - LN_MIN_OFFSET,
                                weights.clamp(min=1))
    s_idx = torch.arange(items.shape[-1], device=x.device)
    valid = (s_idx < size_a[bucket_idx][..., None]) & (weights > 0)
    draw = torch.where(valid, draw, S64_MIN)
    high = torch.argmax(draw, dim=-1, keepdim=True)
    return items.gather(-1, high)[..., 0]


def _is_out(wvec, item, x):
    """is_out (mapper.c:407-421) for device items; `wvec` as
    :func:`reweight_vector` makes it."""
    w = wvec[item.clamp(0, wvec.shape[0] - 1)]
    oob = item >= wvec.shape[0]
    h = hash32_2_t(x, item) & 0xFFFF
    return oob | ((w < 0x10000) & ((w == 0) | (h >= w)))


def _descend(cm, tabs, root_idx, x, r, target_type, pos=0):
    """Walk from bucket index `root_idx` until an item of target_type is
    chosen. Returns (item, ok, permanent): ok False on any failure;
    permanent True for the failures crush_choose_indep turns into
    CRUSH_ITEM_NONE without retrying (a bad item id, a device of the
    wrong type; mapper.c:724-751). An empty bucket stays retryable."""
    items_a, _, _, size_a, btype_a = tabs
    nb = items_a.shape[0]
    root = torch.as_tensor(root_idx, dtype=torch.int64, device=x.device)
    fail = ((root < 0) | (root >= nb)).expand(x.shape)
    cur = root.clamp(0, nb - 1).expand(x.shape)
    perm = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    done = fail
    chosen = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for _ in range(cm.depth):
        fail = fail | (~done & (size_a[cur] == 0))
        done = done | fail
        item = _straw2_choose(tabs, cur, x, r, pos)
        is_dev = item >= 0
        sub = (-1 - item).clamp(0, nb - 1)
        bad_dev = is_dev & (item >= cm.max_devices)
        bad_bucket = ~is_dev & ((-1 - item) >= nb)
        itype = torch.where(is_dev, 0, btype_a[sub])
        hit = (itype == target_type) & ~bad_dev & ~bad_bucket
        newly_bad = ~done & ~hit & (is_dev | bad_dev | bad_bucket)
        perm = perm | newly_bad
        chosen = torch.where(~done & hit, item, chosen)
        fail = fail | newly_bad
        cur = torch.where(~done & ~hit & ~is_dev, sub, cur)
        done = done | hit | fail
    return chosen, ~(fail | ~done), perm


def _first_true(mask, none: int):
    """Index of the first True along the last axis, `none` where none."""
    first = torch.argmax(mask.to(torch.uint8), dim=-1)
    return torch.where(mask.any(dim=-1), first, none)


def _indep(cm, tabs, plan: RulePlan, xs, wvec):
    """crush_choose_indep over every seed (the reference's
    ``_make_indep``): rounds of every open slot's descent, positional
    holes, permanent failures as NONE."""
    b, n = xs.shape[0], plan.out_size
    dev = xs.device
    out = torch.full((b, n), CRUSH_ITEM_UNDEF, dtype=torch.int64, device=dev)
    out2 = out.clone()
    reps = torch.arange(n, dtype=torch.int64, device=dev)
    xsb = xs[:, None].expand(b, n)
    root_idx = -1 - plan.root
    ftotal = 0
    while ftotal < plan.tries and bool((out == CRUSH_ITEM_UNDEF).any()):
        rr = (reps + plan.numrep * ftotal)[None, :].expand(b, n)
        # top-level descents use weight-set position 0 (the C passes its
        # starting outpos, mapper.c:719-723)
        item, ok0, perm = _descend(cm, tabs, root_idx, xsb, rr,
                                   plan.target_type, pos=0)
        if plan.chooseleaf:
            # the inner descent (left=1, outpos=rep, mapper.c:767-786):
            # r = rep + parent_r + numrep * ftotal_inner, position rep
            leaf = torch.full_like(out, CRUSH_ITEM_UNDEF)
            pos_leaf = reps[None, :].expand(b, n)
            for ft2 in range(plan.recurse_tries):
                r2 = rr + reps[None, :] + plan.numrep * ft2
                cand, lok, _ = _descend(cm, tabs, -1 - item, xsb, r2, 0,
                                        pos=pos_leaf)
                lok = lok & ~_is_out(wvec, cand, xsb)
                leaf = torch.where((leaf == CRUSH_ITEM_UNDEF) & lok, cand,
                                   leaf)
            ok0 = ok0 & (leaf != CRUSH_ITEM_UNDEF)
        elif plan.target_type == 0:
            ok0 = ok0 & ~_is_out(wvec, item, xsb)
        for rep in range(n):
            need = out[:, rep] == CRUSH_ITEM_UNDEF
            cand = item[:, rep]
            collide = (out == cand[:, None]).any(dim=1)
            ok = ok0[:, rep] & ~collide & need
            make_none = need & perm[:, rep]
            if plan.chooseleaf:
                out2[:, rep] = torch.where(
                    ok, leaf[:, rep],
                    torch.where(make_none, CRUSH_ITEM_NONE, out2[:, rep]))
            out[:, rep] = torch.where(
                ok, cand, torch.where(make_none, CRUSH_ITEM_NONE,
                                      out[:, rep]))
        ftotal += 1
    result = out2 if plan.chooseleaf else out
    return torch.where(out == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE, result)


def _firstn(cm, tabs, plan: RulePlan, xs, wvec):
    """crush_choose_firstn over every seed (the reference's
    ``_make_firstn``): every (rep, ftotal) candidate precomputed, then
    the C loop's acceptance order (first fit against the accepted
    prefix, skip_rep on a permanent failure) as a scan over reps. The
    weight-set position is the live outpos (mapper.c:512), so the
    candidates are made once per position."""
    b = xs.shape[0]
    dev = xs.device
    numrep, tries, rtries = plan.numrep, plan.tries, plan.recurse_tries
    reps = torch.arange(numrep, dtype=torch.int64, device=dev)
    fts = torch.arange(tries, dtype=torch.int64, device=dev)
    rr = (reps[None, :, None] + fts[None, None, :]).expand(b, numrep, tries)
    xb = xs[:, None, None].expand(b, numrep, tries)
    npos = min(cm.npos, plan.result_max) if cm.npos > 1 else 1
    root_idx = -1 - plan.root

    def cands_at(p):
        item, ok, perm = _descend(cm, tabs, root_idx, xb, rr,
                                  plan.target_type, pos=p)
        if plan.chooseleaf:
            # the inner recursion: numrep 1 (stable), parent_r = sub_r
            # (mapper.c:552-575), r = sub_r + ftotal_inner, same position
            if plan.vary_r:
                sub_r = rr >> (plan.vary_r - 1)
            else:
                sub_r = torch.zeros_like(rr)
            f2 = torch.arange(rtries, dtype=torch.int64, device=dev)
            r2 = sub_r[..., None] + f2
            x2 = xb[..., None].expand(b, numrep, tries, rtries)
            leaf, lok, lperm = _descend(cm, tabs, (-1 - item)[..., None],
                                        x2, r2, 0, pos=p)
            lok = lok & ~_is_out(wvec, leaf, x2)
            return item, perm, ok, leaf, lok, lperm
        if plan.target_type == 0:
            # is_out applies to devices only (mapper.c:581-585)
            ok = ok & ~_is_out(wvec, item, xb)
        return item, perm, ok

    stacked = [torch.stack(parts, dim=-1)
               for parts in zip(*[cands_at(p) for p in range(npos)])]
    item_s, perm_s, ok_s = stacked[:3]

    none = CRUSH_ITEM_NONE
    out = torch.full((b, plan.result_max), none, dtype=torch.int64,
                     device=dev)
    out2 = out.clone()
    outpos = torch.zeros(b, dtype=torch.int64, device=dev)
    slots = torch.arange(plan.result_max, device=dev)

    def sel_pos(arr, extra_dims):
        """arr [B, ..., P] -> the outpos'th position's variant."""
        if npos == 1:
            return arr[..., 0]
        idx = outpos.clamp(0, npos - 1).reshape((-1,) + (1,) * (extra_dims
                                                                + 1))
        return arr.gather(-1, idx.expand(arr.shape[:-1] + (1,)))[..., 0]

    for rep in range(numrep):
        cand = sel_pos(item_s[:, rep], 1)                      # [B, T]
        collide = (out[:, None, :] == cand[:, :, None]).any(dim=-1)
        acceptable = sel_pos(ok_s[:, rep], 1) & ~collide
        if plan.chooseleaf:
            leaf_s, lok_s, lperm_s = stacked[3:]
            lc = sel_pos(leaf_s[:, rep], 2)                   # [B, T, T2]
            lcollide = (out2[:, None, None, :] == lc[..., None]).any(dim=-1)
            lacc = sel_pos(lok_s[:, rep], 2) & ~lcollide
            first_lacc = _first_true(lacc, rtries)
            first_lbad = _first_true(sel_pos(lperm_s[:, rep], 2), rtries)
            acceptable = acceptable & (first_lacc < first_lbad)
            leaf_pick = lc.gather(-1, first_lacc.clamp(max=rtries - 1)
                                  [..., None])[..., 0]        # [B, T]
        first_acc = _first_true(acceptable, tries)
        first_bad = _first_true(sel_pos(perm_s[:, rep], 1), tries)
        accept = (first_acc < first_bad) & (outpos < plan.result_max)
        at = first_acc.clamp(max=tries - 1)[:, None]
        sel = (slots[None, :] == outpos[:, None]) & accept[:, None]
        out = torch.where(sel, cand.gather(-1, at), out)
        if plan.chooseleaf:
            out2 = torch.where(sel, leaf_pick.gather(-1, at), out2)
        outpos = outpos + accept.to(torch.int64)
    return out2 if plan.chooseleaf else out


def plain_chunk(cm: CompiledMap, plan: RulePlan) -> int:
    """Seeds the plain version maps at a time: its largest intermediate
    (the firstn precompute's [B, numrep, tries, recurse_tries, S] or the
    indep round's [B, out_size, S]) stays within PLAIN_CHUNK_VALUES."""
    s = cm.items.shape[1]
    if plan.firstn:
        per_seed = plan.numrep * plan.tries * s * min(cm.npos,
                                                      plan.result_max)
        if plan.chooseleaf:
            per_seed *= plan.recurse_tries
    else:
        per_seed = max(plan.out_size, 1) * s
    return int(min(PLAIN_CHUNK_SEEDS, max(1, PLAIN_CHUNK_VALUES // per_seed)))


def map_plain(cm: CompiledMap, plan: RulePlan, xs: torch.Tensor,
              wvec: torch.Tensor) -> torch.Tensor:
    """The plain version: seeds xs [B] int64 (any device) against the
    reweight vector `wvec` (int64, as :func:`reweight_vector` makes it,
    on the same device) -> [B, result_max] int64 with CRUSH_ITEM_NONE
    holes."""
    tabs = _tables(cm, xs.device)
    run = _firstn if plan.firstn else _indep
    chunk = plain_chunk(cm, plan)
    parts = [run(cm, tabs, plan, xs[i:i + chunk], wvec)
             for i in range(0, xs.shape[0], chunk)]
    if not parts:
        return torch.empty((0, plan.result_max), dtype=torch.int64,
                           device=xs.device)
    out = torch.cat(parts)
    if out.shape[1] < plan.result_max:
        out = torch.nn.functional.pad(
            out, (0, plan.result_max - out.shape[1]), value=CRUSH_ITEM_NONE)
    return out


# -- the entry point -----------------------------------------------------------

def _sweep(items, xs, wvec, *, cm, plan):
    """One sweep of the CUDA kernel or, for seeds on the CPU, the plain
    version; `items` is ``cm.items``, passed for the profiler's
    signature, as the reference passes its tables."""
    from ..ops import crush_kernel  # it imports this module's plain version
    return crush_kernel.crush_sweep(cm, plan, xs, wvec)


# ref batched.py:301-302 and :442-443
_SWEEPS = {False: PROFILER.wrap_kernel("crush.indep", _sweep),
           True: PROFILER.wrap_kernel("crush.firstn", _sweep)}


def _scalar(cmap, ruleno, xs, result_max, weight, choose_args):
    if isinstance(weight, torch.Tensor):
        weight = weight.cpu().numpy()
    out = np.full((len(xs), result_max), CRUSH_ITEM_NONE, dtype=np.int64)
    for i, x in enumerate(xs):
        res = crush_do_rule(cmap, ruleno, int(x), result_max, weight,
                            choose_args=choose_args)
        out[i, :len(res)] = res
    return out


def batched_do_rule(cmap: CrushMap, ruleno: int, xs, result_max: int,
                    weight=None, *, choose_args=None, device_out: bool = False,
                    device=None, xs_sharding=None, tables_sharding=None):
    """Map a whole batch of seeds in one call.

    xs: [B] int seeds (PG seeds), a numpy array, a list or a tensor; they
    hash as uint32, so a seed below 0 or at 2^31 and above maps as the
    reference maps it. Returns [B, result_max] int64 as numpy
    (CRUSH_ITEM_NONE marks holes), or with `device_out` the tensor on the
    device without a copy back.

    device: None means CUDA (the seeds' own card for a CUDA tensor), and
    raises where CUDA is absent; "cpu" runs the plain version. On CUDA
    the sweep is one launch of the CUDA kernel, which raises if it cannot
    build or launch. Maps and rules outside the fast path take the scalar
    interpreter on the host, whose result is a numpy array even with
    `device_out`.

    choose_args: a weight-set/ids map (bucket_id -> {"ids",
    "weight_set"}) or an int selecting one of cmap.choose_args' sets,
    with the default set as its fallback.

    xs_sharding: a flat mesh (:func:`make_batch_mesh`) over which the
    seeds split into equal contiguous shares, device i mapping share i
    with one sweep there (each seed maps independently, so the result is
    the single-device sweep's); `device` is then unused, the seed count
    must divide by the mesh's size (:func:`mesh_do_rule` pads), and
    `device_out` gathers the result on the mesh's first device.

    tables_sharding: a mesh to whose every card the packed tables and
    reweight vector go up front (``crush_kernel.device_tables``, one
    cached copy a card), so each card sweeps against its own copy.
    """
    if xs_sharding is not None:
        shard_devs = list(xs_sharding.devices.reshape(-1))
        dev = shard_devs[0]
    else:
        if device is None and isinstance(xs, torch.Tensor) and xs.is_cuda:
            device = xs.device
        dev = resolve_device(device)
    if isinstance(choose_args, int):
        choose_args = cmap.choose_args_get_with_fallback(choose_args)
    plan = plan_rule(cmap, ruleno, result_max)
    cm = None
    if plan is not None:
        try:
            cm = compile_map(cmap, choose_args)
        except ValueError:
            # malformed map (dangling refs, cycles): the interpreter
            # degrades per slot instead of failing the whole sweep
            cm = None
    if cm is None:
        _count("scalar")
        xs_host = (xs.cpu().numpy() if isinstance(xs, torch.Tensor)
                   else np.asarray(xs))
        return _scalar(cmap, ruleno, xs_host, result_max, weight,
                       choose_args)

    wvec = reweight_vector(weight, cm.max_devices)
    if tables_sharding is not None:
        from ..ops import crush_kernel
        for d in set(tables_sharding.devices.reshape(-1)):
            if d.type == "cuda":
                crush_kernel.device_tables(cm, wvec, d)
    if xs_sharding is None:
        if isinstance(xs, torch.Tensor):
            xs_t = xs.to(device=dev, dtype=torch.int64)
        else:
            xs_t = torch.from_numpy(np.asarray(xs, dtype=np.int64)).to(dev)
        out = _sweep_on(cm, plan, xs_t, wvec)
        return out if device_out else out.cpu().numpy()
    seeds = xs.cpu() if isinstance(xs, torch.Tensor) else \
        torch.from_numpy(np.asarray(xs, dtype=np.int64))
    if seeds.shape[0] % len(shard_devs):
        raise ValueError("%d seeds do not split over a mesh of %d"
                         % (seeds.shape[0], len(shard_devs)))
    outs = [_sweep_on(cm, plan, part.to(device=d, dtype=torch.int64), wvec)
            for d, part in zip(shard_devs,
                               seeds.chunk(len(shard_devs)))]
    if device_out:
        return torch.cat([o.to(dev) for o in outs])
    return np.concatenate([o.cpu().numpy() for o in outs])


def _sweep_on(cm, plan, xs_t, wvec):
    """One counted sweep of the seeds xs_t where they lie."""
    out = _SWEEPS[plan.firstn](cm.items, xs_t, wvec, cm=cm, plan=plan)
    _count("kernel" if xs_t.device.type == "cuda" else "plain")
    return out


def make_batch_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Flat 1-axis ('batch',) mesh over the first n of `devices`
    (default: the visible CUDA devices; an explicit list may repeat a
    device): the cluster-sweep shape, one share of the seeds a device."""
    return Mesh(mesh_devices(n_devices, devices), ("batch",))


def mesh_do_rule(cmap: CrushMap, ruleno: int, xs, result_max: int,
                 weight=None, *, mesh=None, choose_args=None):
    """Mesh-sharded bulk mapping: the seeds split along a flat ('batch',)
    mesh while the packed tables and the reweight vector go to every
    card, each device mapping its share with one sweep against its own
    copy. Each seed maps independently, so the result is the
    single-device sweep's, bit for bit. Seeds are padded (by repeating
    the last seed) to a multiple of the mesh's size, and the pad rows
    trimmed.

    With no mesh and the rateless dispatcher up
    (``parallel/rateless.get_dispatcher``), the sweep rides its queue
    instead: idle devices pull seed micro-batches, each mapped by one
    sweep on the worker's device. Without either, the mesh is every
    visible CUDA device (raising where there is none)."""
    xs = xs.cpu().numpy() if isinstance(xs, torch.Tensor) else np.asarray(xs)
    if mesh is None:
        disp = rateless.get_dispatcher()
        if disp is not None and len(xs) > 1:
            return disp.map_batch(
                lambda sub: batched_do_rule(
                    cmap, ruleno, sub, result_max, weight,
                    choose_args=choose_args, device=sub.device), xs)
        mesh = make_batch_mesh()
    if len(mesh.axis_names) != 1:
        raise ValueError("mesh_do_rule wants a flat 1-axis mesh, got "
                         "axes %r" % (mesh.axis_names,))
    n, n_shards = len(xs), mesh.size
    if n == 0 or n_shards <= 1:
        return batched_do_rule(cmap, ruleno, xs, result_max, weight,
                               choose_args=choose_args,
                               device=mesh.devices.reshape(-1)[0])
    pad = (-n) % n_shards
    if pad:
        xs = np.concatenate([xs, np.repeat(xs[-1:], pad)])
    out = batched_do_rule(cmap, ruleno, xs, result_max, weight,
                          choose_args=choose_args, xs_sharding=mesh,
                          tables_sharding=mesh)
    return out[:n]
