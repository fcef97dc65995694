"""Upmap balancer: flattens the PG distribution with pg_upmap_items.

Port of ``ceph_tpu/osd/balancer.py``, the role of Ceph's
OSDMap::calc_pg_upmaps (src/osd/OSDMap.cc:3763), OSDMap::try_pg_upmap
(:3718) and the mgr balancer module's upmap mode: compute per-OSD PG
deviation from the CRUSH-weight target, then greedily evacuate the
fullest OSDs by (a) dropping existing pg_upmap_items that land on them
and (b) adding new items that remap one PG shard from an overfull to an
underfull device, never lowering the count of distinct failure-domain
buckets the rule's placement had.

Every sweep of a round is one full remap (``OSDMapMapping.update``): one
straw2 launch a pool on the card (`device`: None for the card, raising
where CUDA is absent, "cpu" for the plain version), or the scalar path
on the host with ``use_device=False``; ``use_native`` maps each pool
through the native runtime's host mapper instead
(``OSDMapMapping.update(native=True)``). The greedy bookkeeping between
sweeps is host code, ported exactly: OSDs are walked by deviation and
their PGs in (pool, ps) order, so the same map gives the same items.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..crush.map import CRUSH_ITEM_NONE, CrushMap
from .osd_map import PGID, Incremental, OSDMap, OSDMapMapping

__all__ = ["calc_pg_upmaps", "eval_distribution", "BalancerResult",
           "Distribution", "measure_sweep"]


# ---------------------------------------------------------------------------
# crush topology helpers


def rule_take_roots(crush: CrushMap, ruleno: int) -> list[int]:
    """Bucket/device ids named by the rule's take steps."""
    if not (0 <= ruleno < len(crush.rules)):
        return []
    return [step[1] for step in crush.rules[ruleno].steps
            if step[0] == "take"]


def rule_failure_domain(crush: CrushMap, ruleno: int) -> int:
    """The separation domain: the deepest non-device type named by a
    choose/chooseleaf step (0 = no bucket-type separation)."""
    domain = 0
    if not (0 <= ruleno < len(crush.rules)):
        return domain
    for step in crush.rules[ruleno].steps:
        if step[0].startswith("choose") and len(step) >= 3 and \
                step[2] > 0:
            domain = step[2]
    return domain


def parent_index(crush: CrushMap) -> dict[int, int]:
    """item id -> containing bucket id (CRUSH trees have one parent)."""
    idx: dict[int, int] = {}
    for bid, bucket in crush.buckets.items():
        for item in bucket.items:
            idx[int(item)] = bid
    return idx


def parent_of_type(crush: CrushMap, item: int, type_id: int,
                   pindex: dict[int, int]) -> int | None:
    """Walk up from item to its ancestor bucket of type_id
    (CrushWrapper::get_parent_of_type)."""
    cur = item
    while True:
        parent = pindex.get(cur)
        if parent is None:
            return None
        if crush.buckets[parent].type == type_id:
            return parent
        cur = parent


def subtree_devices(crush: CrushMap, root: int) -> set[int]:
    """All device ids beneath root (root may itself be a device)."""
    if root >= 0:
        return {root}
    out: set[int] = set()
    stack = [root]
    while stack:
        bid = stack.pop()
        bucket = crush.buckets.get(bid)
        if bucket is None:
            continue
        for item in bucket.items:
            item = int(item)
            if item >= 0:
                out.add(item)
            else:
                stack.append(item)
    return out


def rule_weight_osd_map(crush: CrushMap, ruleno: int) -> dict[int, float]:
    """Per-device CRUSH weight reachable through the rule's take steps
    (CrushWrapper::get_rule_weight_osd_map): the balancer's notion of
    each OSD's fair share."""
    out: dict[int, float] = {}
    for root in rule_take_roots(crush, ruleno):
        if root >= 0:
            out[root] = out.get(root, 0.0) + 1.0
            continue
        stack = [root]
        while stack:
            bid = stack.pop()
            bucket = crush.buckets.get(bid)
            if bucket is None:
                continue
            for item, w in zip(bucket.items, bucket.weights):
                item = int(item)
                if item >= 0:
                    out[item] = out.get(item, 0.0) + int(w) / 0x10000
                else:
                    stack.append(item)
    return out


# ---------------------------------------------------------------------------
# distribution evaluation


@dataclass
class Distribution:
    pg_counts: dict[int, int]           # osd -> #up PG shards
    targets: dict[int, float]           # osd -> fair share (pgs)
    total_deviation: float
    stddev: float

    def deviation(self, osd: int) -> float:
        return self.pg_counts.get(osd, 0) - self.targets.get(osd, 0.0)


def _sweep(osdmap: OSDMap, pools: set[int] | None, use_device: bool,
           use_mesh: bool = False, use_native: bool = False, *,
           device=None) -> dict[PGID, list[int]]:
    """All-PG up mappings: one full remap, each pool one batched sweep
    (with use_mesh, split over every visible card; with use_native, the
    native host mapper), or the scalar path without any of the three."""
    mapping = OSDMapMapping()
    mapping.update(osdmap, batched=use_device or use_mesh or use_native,
                   mesh=True if use_mesh else None, native=use_native,
                   device=device)
    out: dict[PGID, list[int]] = {}
    for pgid, (up, _up_p, _acting, _acting_p) in mapping.by_pg.items():
        if pools is not None and pgid.pool not in pools:
            continue
        out[pgid] = up
    return out


def measure_sweep(osdmap: OSDMap, use_device: bool,
                  pools: set[int] | None = None, use_mesh: bool = False,
                  use_native: bool = False, *, device=None) -> float:
    """Wall seconds of one all-PG placement sweep on the named path."""
    t0 = time.perf_counter()
    _sweep(osdmap, pools, use_device, use_mesh=use_mesh,
           use_native=use_native, device=device)
    return time.perf_counter() - t0


def _targets(osdmap: OSDMap,
             pools: set[int] | None) -> tuple[dict[int, float], float]:
    """Per-OSD fair share: (weights, pgs_per_weight). Shared by the
    scorer and the optimizer so that ``eval_distribution`` agrees with
    the deviations calc_pg_upmaps acted on."""
    total_pgs = 0
    weights: dict[int, float] = {}
    weight_total = 0.0
    for pool_id, pool in osdmap.pools.items():
        if pools is not None and pool_id not in pools:
            continue
        total_pgs += pool.size * pool.pg_num
        for osd, w in rule_weight_osd_map(osdmap.crush,
                                          pool.crush_rule).items():
            # only devices that are in (weight > 0) can hold data
            if osd < osdmap.max_osd and osdmap.is_in(osd):
                weights[osd] = weights.get(osd, 0.0) + w
                weight_total += w
    per_weight = total_pgs / weight_total if weight_total > 0 else 0.0
    return weights, per_weight


def eval_distribution(osdmap: OSDMap, pools: set[int] | None = None,
                      use_device: bool = True, use_mesh: bool = False,
                      use_native: bool = False, *,
                      device=None) -> Distribution:
    """Score the current map: per-OSD up-PG counts against the CRUSH
    weight targets (the `balancer eval` role)."""
    by_pg = _sweep(osdmap, pools, use_device, use_mesh=use_mesh,
                   use_native=use_native, device=device)
    counts: dict[int, int] = {}
    for up in by_pg.values():
        for osd in up:
            if osd != CRUSH_ITEM_NONE:
                counts[osd] = counts.get(osd, 0) + 1
    weights, per_weight = _targets(osdmap, pools)
    targets: dict[int, float] = {}
    for osd, w in weights.items():
        targets[osd] = w * per_weight
        counts.setdefault(osd, 0)
    devs = [counts.get(o, 0) - t for o, t in targets.items()]
    total_dev = float(sum(abs(d) for d in devs))
    stddev = float(np.std(devs)) if devs else 0.0
    return Distribution(counts, targets, total_dev, stddev)


# ---------------------------------------------------------------------------
# the optimizer


@dataclass
class BalancerResult:
    num_changed: int = 0
    start_deviation: float = 0.0
    end_deviation: float = 0.0
    sweeps: int = 0
    # the proposal, Incremental-shaped
    new_pg_upmap_items: dict[PGID, list] = field(default_factory=dict)
    old_pg_upmap_items: list[PGID] = field(default_factory=list)

    def apply_to(self, inc: Incremental) -> None:
        inc.new_pg_upmap_items.update(self.new_pg_upmap_items)
        for pgid in self.old_pg_upmap_items:
            # a pgid dropped in one sweep and re-added in a later one
            # must land as a set, not a removal (apply_incremental
            # processes removals last)
            if pgid not in self.new_pg_upmap_items and \
                    pgid not in inc.old_pg_upmap_items:
                inc.old_pg_upmap_items.append(pgid)


def _try_pg_upmap(osdmap: OSDMap, pgid: PGID, overfull: set[int],
                  underfull: list[int]) -> list[tuple[int, int]] | None:
    """Propose (src, dst) item pairs moving pgid's overfull shards to
    underfull devices while preserving the rule's placement validity
    (OSDMap::try_pg_upmap + CrushWrapper::try_remap_rule role)."""
    pool = osdmap.pools.get(pgid.pool)
    if pool is None:
        return None
    crush = osdmap.crush
    ruleno = pool.crush_rule
    orig, _pps = osdmap._pg_to_raw_osds(pool, pgid)
    if not any(o in overfull for o in orig if o != CRUSH_ITEM_NONE):
        return None
    allowed: set[int] = set()
    for root in rule_take_roots(crush, ruleno):
        allowed |= subtree_devices(crush, root)
    fd_type = rule_failure_domain(crush, ruleno)
    pindex = parent_index(crush)

    def domains(osds) -> list:
        return [parent_of_type(crush, o, fd_type, pindex)
                for o in osds if o != CRUSH_ITEM_NONE]

    orig_domains = domains(orig)
    out = list(orig)
    used = {o for o in out if o != CRUSH_ITEM_NONE}
    for i, osd in enumerate(out):
        if osd == CRUSH_ITEM_NONE or osd not in overfull:
            continue
        for cand in underfull:
            if cand in used or cand not in allowed:
                continue
            trial = list(out)
            trial[i] = cand
            if fd_type > 0:
                # separation must not degrade: at least as many
                # distinct failure-domain buckets as CRUSH produced
                if len(set(domains(trial))) < len(set(orig_domains)):
                    continue
            out = trial
            used.add(cand)
            break
    if out == orig:
        return None
    return [(orig[i], out[i]) for i in range(len(orig))
            if orig[i] != out[i]]


def calc_pg_upmaps(osdmap: OSDMap,
                   max_deviation: float = 1.0,
                   max_deviation_ratio: float = 0.0,
                   max_changes: int = 10,
                   pools: set[int] | None = None,
                   use_device: bool = True,
                   use_mesh: bool = False,
                   use_native: bool = False,
                   changes_per_sweep: int = 1, *,
                   device=None) -> BalancerResult:
    """Greedy upmap optimization, mirroring OSDMap::calc_pg_upmaps'
    restart loop: each sweep is one full remap (on the card with
    use_device, on `device`; the native host mapper with use_native),
    then up to `changes_per_sweep` accepted
    changes, each updating the sweep's per-OSD bookkeeping locally.
    Stops when the fullest OSD sits within max_deviation PGs of its
    target (and, when max_deviation_ratio > 0, within that ratio of the
    target), after max_changes, or when no change is found. Returns the
    proposal; the caller routes it through an Incremental."""
    tmp = osdmap.clone()
    res = BalancerResult()
    remaining = max_changes
    while remaining > 0:
        by_pg = _sweep(tmp, pools, use_device, use_mesh=use_mesh,
                       use_native=use_native, device=device)
        res.sweeps += 1
        pgs_by_osd: dict[int, list[PGID]] = {}
        for pgid, up in sorted(by_pg.items(),
                               key=lambda kv: (kv[0].pool, kv[0].ps)):
            for osd in up:
                if osd != CRUSH_ITEM_NONE:
                    pgs_by_osd.setdefault(osd, []).append(pgid)
        weights, per_weight = _targets(tmp, pools)
        if per_weight <= 0:
            break
        deviations: dict[int, float] = {}
        overfull: set[int] = set()
        total_deviation = 0.0
        for osd, w in weights.items():
            pgs_by_osd.setdefault(osd, [])
            dev = len(pgs_by_osd[osd]) - w * per_weight
            deviations[osd] = dev
            if dev >= 1.0:
                overfull.add(osd)
            total_deviation += abs(dev)
        # devices carrying PGs but outside every rule's weight map
        # (e.g. weight zeroed mid-flight) are maximally overfull
        for osd, pgs in pgs_by_osd.items():
            if osd not in deviations:
                deviations[osd] = float(len(pgs))
                if pgs:
                    overfull.add(osd)
                total_deviation += len(pgs)
        if res.sweeps == 1:
            res.start_deviation = total_deviation
        res.end_deviation = total_deviation
        underfull = [osd for osd, dev in
                     sorted(deviations.items(),
                            key=lambda kv: (kv[1], kv[0]))
                     if dev < -0.999]
        if not overfull or not underfull:
            break
        underfull_set = set(underfull)
        batch = max(1, int(changes_per_sweep))
        accepted = 0
        while accepted < batch and remaining > 0:
            changed = None             # (pgid, pairs|None) on accept
            for osd in sorted(deviations, key=lambda o: -deviations[o]):
                dev = deviations[osd]
                target = weights.get(osd, 0.0) * per_weight
                if max_deviation_ratio > 0 and target > 0 and \
                        dev / target < max_deviation_ratio:
                    break              # fullest is within tolerance
                if dev < max(1.0, max_deviation):
                    break
                # 1) un-remap: drop existing items landing on this osd
                for pgid in pgs_by_osd[osd]:
                    items = tmp.pg_upmap_items.get(pgid)
                    if items and any(dst == osd for _src, dst in items):
                        tmp.pg_upmap_items.pop(pgid)
                        res.new_pg_upmap_items.pop(pgid, None)
                        res.old_pg_upmap_items.append(pgid)
                        res.num_changed += 1
                        changed = (pgid, None)
                        break
                if changed is not None:
                    break
                # 2) remap one PG shard off this osd
                for pgid in pgs_by_osd[osd]:
                    if pgid in tmp.pg_upmap \
                            or pgid in tmp.pg_upmap_items:
                        continue
                    pairs = _try_pg_upmap(tmp, pgid, overfull, underfull)
                    if pairs is None:
                        continue
                    tmp.pg_upmap_items[pgid] = pairs
                    res.new_pg_upmap_items[pgid] = pairs
                    res.num_changed += 1
                    changed = (pgid, pairs)
                    break
                if changed is not None:
                    break
            if changed is None:
                break
            remaining -= 1
            accepted += 1
            if accepted >= batch or remaining <= 0:
                break
            pgid, pairs = changed
            if pairs is None:
                # un-remap: the shard falls back to its raw CRUSH
                # placement, unknowable without a sweep: stop the batch
                # and resweep
                break
            # local bookkeeping: move the shard so the rest of the
            # batch sees it without paying for a sweep
            for src, dst in pairs:
                if pgid in pgs_by_osd.get(src, ()):
                    pgs_by_osd[src].remove(pgid)
                    pgs_by_osd.setdefault(dst, []).append(pgid)
                    deviations[src] = deviations.get(src, 0.0) - 1
                    deviations[dst] = deviations.get(dst, 0.0) + 1
                    if deviations[src] < 1.0:
                        overfull.discard(src)
                    if deviations[dst] >= 1.0:
                        overfull.add(dst)
                        underfull_set.discard(dst)
                    if deviations[dst] >= -0.999:
                        underfull_set.discard(dst)
            underfull = [o for o in
                         sorted(underfull_set,
                                key=lambda o: (deviations.get(o, 0.0), o))
                         if deviations.get(o, 0.0) < -0.999]
            if not overfull or not underfull:
                break
        if accepted == 0:
            break                      # no further improvement found
    return res
