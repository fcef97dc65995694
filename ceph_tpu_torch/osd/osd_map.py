"""Cluster map: pools, device states, the placement pipeline, the full remap.

Port of ``ceph_tpu/osd/osd_map.py``, the role of Ceph's OSDMap
(src/osd/OSDMap.{h,cc}) and pg_pool_t (src/osd/osd_types.{h,cc}):

  raw_pg_to_pps     stable_mod + pool-salted rjenkins hash -> the CRUSH
                    input seed (osd_types.cc:1392-1407)
  _pg_to_raw_osds   CRUSH do_rule (OSDMap.cc:1894-1911)
  _apply_upmap      explicit pg_upmap / pg_upmap_items overrides (:1924)
  _raw_to_up_osds   drop down/dne devices: shift for replicated pools,
                    leave CRUSH_ITEM_NONE holes for EC (:1959)
  primary affinity  proportional primary rejection via hash (:1982)
  _get_temp_osds    pg_temp / primary_temp overlay (:2035)
  pg_to_up_acting_osds   the composition every client and OSD runs (:2103)

:class:`OSDMapMapping` is the full remap (Ceph's OSDMapMapping and
ParallelPGMapper, OSDMapMapping.h:17,169): each pool's whole PG range
maps in one ``crush.batched.batched_do_rule`` call, which is one launch
of the straw2 kernel on the card (``device="cpu"``: the plain version),
or one launch a device over a flat mesh (``mesh_do_rule``); the overlay
steps then run per PG on the host, as in the reference.

The pool keeps the placement fields of the reference's PGPool and the
few the port's PG reads (``removed_snaps``, ``tier_of``, ``cache_mode``);
the rest (pool snaps, the tier agent's knobs, QoS) come with the slices
that read them. ``update(native=True)`` maps each pool through the native
runtime's host mapper (``native.crush_do_rule_batch_native``, the
reference's ``native=`` path), falling back to the device sweep only
when the runtime cannot be built or cannot take the map
(``native.NativeUnavailable``).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field

import numpy as np

from ..crush import hashing
from ..crush.batched import batched_do_rule, make_batch_mesh, mesh_do_rule
from ..crush.map import (CRUSH_ITEM_NONE, CrushMap, POOL_TYPE_ERASURE,
                         POOL_TYPE_REPLICATED)
from ..crush.mapper_ref import crush_do_rule

__all__ = ["PGID", "PGPool", "OSDMap", "Incremental", "OSDMapMapping",
           "POOL_TYPE_REPLICATED", "POOL_TYPE_ERASURE", "CRUSH_ITEM_NONE",
           "stable_mod", "str_hash_rjenkins"]

DEFAULT_PRIMARY_AFFINITY = 0x10000
MAX_PRIMARY_AFFINITY = 0x10000


def calc_bits_of(n: int) -> int:
    bits = 0
    while n:
        n >>= 1
        bits += 1
    return bits


def stable_mod(x: int, b: int, bmask: int) -> int:
    """ceph_stable_mod (src/include/ceph_hash.h idiom): remap x into
    [0, b) such that growing b splits each bucket in two."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


@dataclass(frozen=True)
class PGID:
    pool: int
    ps: int

    def __str__(self):
        return "%d.%x" % (self.pool, self.ps)


@dataclass
class PGPool:
    """pg_pool_t's placement fields and those the PG reads."""

    pool_id: int
    name: str
    type: int = POOL_TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 8
    pgp_num: int = 0
    crush_rule: int = 0
    erasure_code_profile: str = ""
    hashpspool: bool = True
    stripe_width: int = 0
    # what the PG reads of the snapshot and cache-tier fields
    # (pg_pool_t removed_snaps, tier_of, cache_mode)
    removed_snaps: list = field(default_factory=list)
    tier_of: int = -1                  # base pool this pool caches for
    cache_mode: str = "none"     # none|writeback|readproxy|readonly|forward

    def __post_init__(self):
        if self.pgp_num == 0:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return (1 << calc_bits_of(self.pg_num - 1)) - 1

    @property
    def pgp_num_mask(self) -> int:
        return (1 << calc_bits_of(self.pgp_num - 1)) - 1

    def can_shift_osds(self) -> bool:
        # replicated pools shift gaps away; EC pools keep positional
        # holes (osd_types.h can_shift_osds)
        return self.type == POOL_TYPE_REPLICATED

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def is_tier(self) -> bool:
        """Is this pool a cache tier over another pool?
        (pg_pool_t::is_tier)"""
        return self.tier_of >= 0

    def raw_pg_to_pg(self, pgid: PGID) -> PGID:
        return PGID(pgid.pool,
                    stable_mod(pgid.ps, self.pg_num, self.pg_num_mask))

    def raw_pg_to_pps(self, pgid: PGID) -> int:
        if self.hashpspool:
            return int(hashing.hash32_2(
                stable_mod(pgid.ps, self.pgp_num, self.pgp_num_mask),
                pgid.pool))
        return stable_mod(pgid.ps, self.pgp_num,
                          self.pgp_num_mask) + pgid.pool

    def pps_of(self, ps: np.ndarray) -> np.ndarray:
        """:meth:`raw_pg_to_pps` of every placement seed in `ps` at once
        (int64 in, int64 out; the same values)."""
        ps = np.asarray(ps, dtype=np.int64)
        mask = self.pgp_num_mask
        m = np.where((ps & mask) < self.pgp_num, ps & mask,
                     ps & (mask >> 1))
        if self.hashpspool:
            return hashing.hash32_2(m, self.pool_id).astype(np.int64)
        return m + self.pool_id


class Incremental:
    """OSDMap::Incremental: the delta the monitor publishes per epoch."""

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.new_pools: dict[int, PGPool] = {}
        self.old_pools: list[int] = []
        self.new_up: dict[int, object] = {}      # osd -> addr
        self.new_down: list[int] = []
        self.new_weight: dict[int, int] = {}     # osd -> 16.16
        self.new_primary_affinity: dict[int, int] = {}
        self.new_pg_temp: dict[PGID, list] = {}  # [] clears
        self.new_primary_temp: dict[PGID, int] = {}
        self.new_pg_upmap: dict[PGID, list] = {}
        self.old_pg_upmap: list[PGID] = []
        self.new_pg_upmap_items: dict[PGID, list] = {}
        self.old_pg_upmap_items: list[PGID] = []
        self.new_max_osd: int | None = None
        self.new_crush: CrushMap | None = None
        self.new_ec_profiles: dict[str, dict] = {}

    def overlay_only(self) -> bool:
        """True when this inc only touches per-PG overlays (pg_temp /
        primary_temp / upmap) or down-marks: the churn classes whose
        affected-PG set is exactly enumerable, so a precomputed mapping
        can advance without a full CRUSH re-sweep. Weight, boot, pool
        and crush changes move raw placements and need the sweep."""
        return not (self.new_pools or self.old_pools or self.new_up
                    or self.new_weight or self.new_primary_affinity
                    or self.new_max_osd is not None
                    or self.new_crush is not None)

    def overlay_pgs(self) -> set:
        """The raw PGIDs named by this inc's overlay entries."""
        pgs: set = set()
        for d in (self.new_pg_temp, self.new_primary_temp,
                  self.new_pg_upmap, self.new_pg_upmap_items):
            pgs.update(d.keys())
        pgs.update(self.old_pg_upmap)
        pgs.update(self.old_pg_upmap_items)
        return pgs


class OSDMap:
    def __init__(self):
        self.epoch = 0
        self.max_osd = 0
        self.crush = CrushMap()
        self.pools: dict[int, PGPool] = {}
        self.osd_exists: list[bool] = []
        self.osd_up: list[bool] = []
        self.osd_weight: list[int] = []          # 16.16; 0 = out
        self.osd_addrs: dict[int, object] = {}
        self.osd_primary_affinity: list[int] | None = None
        self.pg_temp: dict[PGID, list] = {}
        self.primary_temp: dict[PGID, int] = {}
        self.pg_upmap: dict[PGID, list] = {}
        self.pg_upmap_items: dict[PGID, list] = {}
        # erasure-code profiles ride in the map (OSDMap::erasure_code_profiles)
        self.ec_profiles: dict[str, dict] = {}

    # -- device state --------------------------------------------------

    def set_max_osd(self, n: int) -> None:
        while len(self.osd_exists) < n:
            self.osd_exists.append(False)
            self.osd_up.append(False)
            self.osd_weight.append(0)
        self.max_osd = n

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and self.osd_exists[osd]

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and self.osd_up[osd]

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_out(self, osd: int) -> bool:
        return not self.exists(osd) or self.osd_weight[osd] == 0

    def is_in(self, osd: int) -> bool:
        return not self.is_out(osd)

    def get_up_osds(self) -> list[int]:
        return [o for o in range(self.max_osd) if self.is_up(o)]

    # -- incremental apply --------------------------------------------

    def apply_incremental(self, inc: Incremental) -> None:
        assert inc.epoch == self.epoch + 1, \
            "incremental %d vs epoch %d" % (inc.epoch, self.epoch)
        self.epoch = inc.epoch
        if inc.new_max_osd is not None:
            self.set_max_osd(inc.new_max_osd)
        if inc.new_crush is not None:
            self.crush = inc.new_crush
        for pool_id, pool in inc.new_pools.items():
            self.pools[pool_id] = pool
        for pool_id in inc.old_pools:
            self.pools.pop(pool_id, None)
        for osd, addr in inc.new_up.items():
            if osd >= self.max_osd:
                self.set_max_osd(osd + 1)
            self.osd_exists[osd] = True
            self.osd_up[osd] = True
            self.osd_addrs[osd] = addr
            if self.osd_weight[osd] == 0:
                self.osd_weight[osd] = 0x10000
        for osd in inc.new_down:
            if 0 <= osd < self.max_osd:
                self.osd_up[osd] = False
        for osd, w in inc.new_weight.items():
            if osd >= self.max_osd:
                self.set_max_osd(osd + 1)
            self.osd_exists[osd] = True
            self.osd_weight[osd] = w
        for osd, a in inc.new_primary_affinity.items():
            if self.osd_primary_affinity is None:
                self.osd_primary_affinity = \
                    [DEFAULT_PRIMARY_AFFINITY] * max(self.max_osd, osd + 1)
            while len(self.osd_primary_affinity) <= osd:
                self.osd_primary_affinity.append(DEFAULT_PRIMARY_AFFINITY)
            self.osd_primary_affinity[osd] = a
        for pgid, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pgid] = list(osds)
            else:
                self.pg_temp.pop(pgid, None)
        for pgid, osd in inc.new_primary_temp.items():
            if osd == -1:
                self.primary_temp.pop(pgid, None)
            else:
                self.primary_temp[pgid] = osd
        for pgid, osds in inc.new_pg_upmap.items():
            self.pg_upmap[pgid] = list(osds)
        for pgid in inc.old_pg_upmap:
            self.pg_upmap.pop(pgid, None)
        for pgid, items in inc.new_pg_upmap_items.items():
            self.pg_upmap_items[pgid] = list(items)
        for pgid in inc.old_pg_upmap_items:
            self.pg_upmap_items.pop(pgid, None)
        self.ec_profiles.update(inc.new_ec_profiles)

    def clone(self) -> "OSDMap":
        return copy.deepcopy(self)

    # -- placement pipeline (OSDMap.cc:1894-2160) ----------------------

    def _pg_to_raw_osds(self, pool: PGPool, pgid: PGID):
        pps = pool.raw_pg_to_pps(pgid)
        ruleno = pool.crush_rule
        osds: list[int] = []
        if 0 <= ruleno < len(self.crush.rules):
            # the pool id selects the choose_args set, falling back to
            # the default set (OSDMap.cc passes the pool id as the
            # choose_args index)
            osds = crush_do_rule(self.crush, ruleno, pps, pool.size,
                                 self._weight_vector(),
                                 choose_args=pgid.pool)
        self._remove_nonexistent_osds(pool, osds)
        return osds, pps

    def _weight_vector(self):
        n = max(self.max_osd, self.crush.max_devices)
        w = np.zeros(n, dtype=np.int64)
        for osd in range(min(self.max_osd, n)):
            if self.osd_exists[osd]:
                w[osd] = self.osd_weight[osd]
        return w

    def _remove_nonexistent_osds(self, pool: PGPool, osds: list) -> None:
        # OSDMap::_remove_nonexistent_osds (OSDMap.cc:1870-1892): shift
        # out dne devices for replicated pools, hole them for EC
        if pool.can_shift_osds():
            osds[:] = [o for o in osds
                       if o != CRUSH_ITEM_NONE and self.exists(o)]
        else:
            osds[:] = [o if (o == CRUSH_ITEM_NONE or self.exists(o))
                       else CRUSH_ITEM_NONE for o in osds]

    def _apply_upmap(self, pool: PGPool, raw_pg: PGID, raw: list) -> list:
        pg = pool.raw_pg_to_pg(raw_pg)
        upmap = self.pg_upmap.get(pg)
        if upmap:
            if not any(o != CRUSH_ITEM_NONE and o < self.max_osd
                       and self.osd_weight[o] == 0 for o in upmap):
                raw = list(upmap)
        items = self.pg_upmap_items.get(pg)
        if items:
            raw = list(raw)
            for i, osd in enumerate(raw):
                for src, dst in items:
                    if src != osd:
                        continue
                    if not (dst != CRUSH_ITEM_NONE and dst < self.max_osd
                            and self.osd_weight[dst] == 0):
                        raw[i] = dst
                    break
        return raw

    def _raw_to_up_osds(self, pool: PGPool, raw: list) -> list:
        if pool.can_shift_osds():
            return [o for o in raw
                    if o != CRUSH_ITEM_NONE and self.exists(o)
                    and not self.is_down(o)]
        return [o if (o != CRUSH_ITEM_NONE and self.exists(o)
                      and not self.is_down(o)) else CRUSH_ITEM_NONE
                for o in raw]

    @staticmethod
    def _pick_primary(osds: list) -> int:
        for osd in osds:
            if osd != CRUSH_ITEM_NONE:
                return osd
        return -1

    def _apply_primary_affinity(self, seed: int, pool: PGPool,
                                osds: list, primary: int):
        pa = self.osd_primary_affinity
        if pa is None:
            return osds, primary
        if not any(o != CRUSH_ITEM_NONE and o < len(pa)
                   and pa[o] != DEFAULT_PRIMARY_AFFINITY for o in osds):
            return osds, primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = pa[o] if o < len(pa) else DEFAULT_PRIMARY_AFFINITY
            if a < MAX_PRIMARY_AFFINITY and \
                    (int(hashing.hash32_2(seed, o)) >> 16) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return osds, primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            osds = [osds[pos]] + osds[:pos] + osds[pos + 1:]
        return osds, primary

    def _get_temp_osds(self, pool: PGPool, pgid: PGID):
        pg = pool.raw_pg_to_pg(pgid)
        temp_pg: list[int] = []
        for osd in self.pg_temp.get(pg, []):
            if not self.exists(osd) or self.is_down(osd):
                if not pool.can_shift_osds():
                    temp_pg.append(CRUSH_ITEM_NONE)
            else:
                temp_pg.append(osd)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1 and temp_pg:
            temp_primary = self._pick_primary(temp_pg)
        return temp_pg, temp_primary

    def _overlay(self, pool: PGPool, pgid: PGID, raw: list, pps: int):
        """The steps after CRUSH of :meth:`pg_to_up_acting_osds` on a raw
        placement whose nonexistent devices are already removed:
        (up, up_primary, acting, acting_primary)."""
        raw = self._apply_upmap(pool, pgid, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up, up_primary = self._apply_primary_affinity(pps, pool, up,
                                                      up_primary)
        acting, acting_primary = self._get_temp_osds(pool, pgid)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    def pg_to_raw_osds(self, pgid: PGID):
        pool = self.pools.get(pgid.pool)
        if pool is None:
            return [], -1
        raw, _ = self._pg_to_raw_osds(pool, pgid)
        return raw, self._pick_primary(raw)

    def pg_to_up_acting_osds(self, pgid: PGID):
        """Returns (up, up_primary, acting, acting_primary)."""
        pool = self.pools.get(pgid.pool)
        if pool is None or pgid.ps >= pool.pg_num:
            return [], -1, [], -1
        raw, pps = self._pg_to_raw_osds(pool, pgid)
        return self._overlay(pool, pgid, raw, pps)

    def object_to_pg(self, pool_id: int, name: str) -> PGID:
        """Hash an object name into its raw PG (the librados locator
        path: ceph_str_hash_rjenkins(name) -> ps)."""
        return PGID(pool_id, str_hash_rjenkins(name))


_M32 = 0xFFFFFFFF


def _mix32(a: int, b: int, c: int):
    """Jenkins mix on plain python ints (ceph_hash.cc mix macro)."""
    a = (a - b - c) & _M32; a ^= c >> 13            # noqa: E702
    b = (b - c - a) & _M32; b = (b ^ (a << 8)) & _M32   # noqa: E702
    c = (c - a - b) & _M32; c ^= b >> 13            # noqa: E702
    a = (a - b - c) & _M32; a ^= c >> 12            # noqa: E702
    b = (b - c - a) & _M32; b = (b ^ (a << 16)) & _M32  # noqa: E702
    c = (c - a - b) & _M32; c ^= b >> 5             # noqa: E702
    a = (a - b - c) & _M32; a ^= c >> 3             # noqa: E702
    b = (b - c - a) & _M32; b = (b ^ (a << 10)) & _M32  # noqa: E702
    c = (c - a - b) & _M32; c ^= b >> 15            # noqa: E702
    return a, b, c


def str_hash_rjenkins(name) -> int:
    """ceph_str_hash_rjenkins (src/common/ceph_hash.cc:21-77), exact:
    12-byte little-endian blocks mixed, tail bytes shifted into place
    with c's low byte reserved for the length."""
    k = name.encode() if isinstance(name, str) else bytes(name)
    a = b = 0x9E3779B9
    c = 0
    i, length = 0, len(k)
    while length - i >= 12:
        a = (a + int.from_bytes(k[i:i + 4], "little")) & _M32
        b = (b + int.from_bytes(k[i + 4:i + 8], "little")) & _M32
        c = (c + int.from_bytes(k[i + 8:i + 12], "little")) & _M32
        a, b, c = _mix32(a, b, c)
        i += 12
    tail = k[i:]
    n = len(tail)
    c = (c + length) & _M32
    for idx, shift in ((10, 24), (9, 16), (8, 8)):
        if n > idx:
            c = (c + (tail[idx] << shift)) & _M32
    for idx, shift in ((7, 24), (6, 16), (5, 8), (4, 0)):
        if n > idx:
            b = (b + (tail[idx] << shift)) & _M32
    for idx, shift in ((3, 24), (2, 16), (1, 8), (0, 0)):
        if n > idx:
            a = (a + (tail[idx] << shift)) & _M32
    _, _, c = _mix32(a, b, c)
    return c


def _native_sweep(osdmap: OSDMap, pool_id: int, pool: PGPool,
                  seeds: np.ndarray):
    """A pool's raw placements from the native host mapper: the
    ``[pg_num, size]`` int64 matrix (CRUSH_ITEM_NONE past a short
    result), the rows as the mapper returned them, which the overlay
    takes as the reference's native path does, and the C mapper's own
    seconds; None when the runtime is unavailable for this map."""
    from .. import native
    try:
        results, lengths, mapper_s = native.crush_do_rule_batch_arrays(
            osdmap.crush, pool.crush_rule, seeds, pool.size,
            osdmap._weight_vector(), choose_args=pool_id)
    except native.NativeUnavailable:
        return None
    mat = results[:, :pool.size].astype(np.int64)
    mat[np.arange(pool.size) >= lengths[:, None]] = CRUSH_ITEM_NONE
    rows = results[:, :pool.size].tolist()
    for i in np.flatnonzero(lengths < pool.size).tolist():
        del rows[i][lengths[i]:]
    return mat, rows, mapper_s


class OSDMapMapping:
    """Precomputed full-cluster mapping (OSDMapMapping.h:169), each pool
    one batched CRUSH sweep on the card.

    ``split`` holds, per pool, the path the last :meth:`update` took
    (``path``: "native", "device" or "scalar") and its wall ms:
    ``seeds_ms`` (the placement seeds), ``sweep_ms`` (the batched call,
    host seeds to a host result; on the scalar path every PG's mapping)
    and ``overlay_ms`` (the per-PG overlay steps and the by-OSD index);
    on the native path also ``mapper_ms``, the C mapper's call alone
    within ``sweep_ms``;
    ``raw`` each batched pool's raw result, ``[pg_num, size]`` int64 with
    CRUSH_ITEM_NONE holes."""

    def __init__(self):
        self.epoch = -1
        self.by_pg: dict[PGID, tuple] = {}
        self.by_osd: dict[int, list] = {}
        self.split: dict[int, dict] = {}
        self.raw: dict[int, np.ndarray] = {}

    def update(self, osdmap: OSDMap, batched: bool = True, mesh=None,
               native: bool = False, *, device=None) -> None:
        """Recompute every pool's PG mappings.

        batched: each pool whose rule exists maps its whole PG range in
        one ``batched_do_rule`` call (one straw2 launch) on `device`
        (None: the card, raising where CUDA is absent; "cpu": the plain
        version), with the pool id selecting its choose_args set. False
        maps every PG through the scalar path on the host.

        mesh: True for ``make_batch_mesh()`` over the visible cards, or an
        explicit flat mesh; the PG batch then splits over it
        (``mesh_do_rule``, one launch a device).

        native: with batched, each pool's range goes through the native
        runtime's host mapper in one C call
        (``native.crush_do_rule_batch_native``), the same placements; a
        pool falls back to the device sweep only on NativeUnavailable (no
        compiler, or a map the native side does not implement), where the
        reference falls back on any error."""
        self.by_pg.clear()
        self.by_osd = {o: [] for o in range(osdmap.max_osd)}
        self.split = {}
        self.raw = {}
        mesh_obj = None
        if mesh is not None and mesh is not False:
            mesh_obj = make_batch_mesh() if mesh is True else mesh
        for pool_id, pool in osdmap.pools.items():
            t0 = time.perf_counter()
            pgids = [PGID(pool_id, ps) for ps in range(pool.pg_num)]
            if batched and 0 <= pool.crush_rule < len(osdmap.crush.rules):
                seeds = pool.pps_of(np.arange(pool.pg_num, dtype=np.int64))
                t1 = time.perf_counter()
                swept = _native_sweep(osdmap, pool_id, pool, seeds) \
                    if native else None
                path = "device" if swept is None else "native"
                if swept is not None:
                    mat, raws, mapper_s = swept
                else:
                    if mesh_obj is not None:
                        mat = mesh_do_rule(osdmap.crush, pool.crush_rule,
                                           seeds, pool.size,
                                           osdmap._weight_vector(),
                                           mesh=mesh_obj,
                                           choose_args=pool_id)
                    else:
                        mat = batched_do_rule(osdmap.crush, pool.crush_rule,
                                              seeds, pool.size,
                                              osdmap._weight_vector(),
                                              choose_args=pool_id,
                                              device=device)
                    raws = mat[:, :pool.size].tolist()
                t2 = time.perf_counter()
                self.raw[pool_id] = mat
                for pgid, raw, pps in zip(pgids, raws, seeds.tolist()):
                    osdmap._remove_nonexistent_osds(pool, raw)
                    self._add(pgid, osdmap._overlay(pool, pgid, raw, pps))
                self.split[pool_id] = {
                    "path": path, "seeds_ms": (t1 - t0) * 1e3,
                    "sweep_ms": (t2 - t1) * 1e3,
                    "overlay_ms": (time.perf_counter() - t2) * 1e3}
                if swept is not None:
                    self.split[pool_id]["mapper_ms"] = mapper_s * 1e3
            else:
                for pgid in pgids:
                    self._add(pgid, osdmap.pg_to_up_acting_osds(pgid))
                self.split[pool_id] = {
                    "path": "scalar", "seeds_ms": 0.0,
                    "sweep_ms": (time.perf_counter() - t0) * 1e3,
                    "overlay_ms": 0.0}
        self.epoch = osdmap.epoch

    def _add(self, pgid: PGID, row: tuple) -> None:
        self.by_pg[pgid] = row
        for osd in row[2]:
            if osd != CRUSH_ITEM_NONE and osd in self.by_osd:
                self.by_osd[osd].append(pgid)

    def apply_incremental(self, osdmap: OSDMap, inc: Incremental,
                          batched: bool = True, mesh=None, *,
                          device=None) -> dict:
        """Advance the precomputed mapping by one epoch, touching only
        the PGs the inc can move. The caller applies `inc` to `osdmap`
        first; this then either

          - recomputes exactly the affected PG set on the host's scalar
            path (overlay-only incs: pg_temp / primary_temp / upmap edits
            and down-marks), or
          - falls back to a full :meth:`update` (on `device`, over
            `mesh`) when raw placements moved (weight, boot, pool, crush
            changes).

        Returns {"mode": "incremental"|"full", "recomputed": n}."""
        if osdmap.epoch != inc.epoch or self.epoch != inc.epoch - 1 \
                or not inc.overlay_only():
            self.update(osdmap, batched=batched, mesh=mesh, device=device)
            return {"mode": "full", "recomputed": len(self.by_pg)}
        affected: set[PGID] = set()
        for pgid in inc.overlay_pgs():
            pool = osdmap.pools.get(pgid.pool)
            if pool is not None:
                affected.add(pool.raw_pg_to_pg(pgid))
        for osd in inc.new_down:
            # a downed osd only moves PGs it served: its acting set,
            # plus pg_temp'd PGs where it sat in `up` but not acting
            affected.update(self.by_osd.get(osd, []))
            for pg in osdmap.pg_temp:
                row = self.by_pg.get(pg)
                if row is not None and osd in row[0]:
                    affected.add(pg)
        for pgid in affected:
            old = self.by_pg.get(pgid)
            if old is not None:
                for osd in old[2]:
                    lst = self.by_osd.get(osd)
                    if lst is not None and pgid in lst:
                        lst.remove(pgid)
            up, upp, acting, actp = osdmap.pg_to_up_acting_osds(pgid)
            if not up and not acting and old is None:
                continue
            self.by_pg[pgid] = (up, upp, acting, actp)
            for osd in acting:
                if osd != CRUSH_ITEM_NONE:
                    self.by_osd.setdefault(osd, []).append(pgid)
        self.epoch = inc.epoch
        return {"mode": "incremental", "recomputed": len(affected)}

    def get(self, pgid: PGID):
        return self.by_pg.get(pgid)

    def get_osd_acting_pgs(self, osd: int) -> list:
        return self.by_osd.get(osd, [])
