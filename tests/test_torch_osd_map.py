"""The port's OSDMap and full remap against the JAX package's.

``ceph_tpu_torch.osd.osd_map`` against ``ceph_tpu.osd.osd_map`` on maps
built the same way in both (numpy seeds, a few hosts, 32-64 PGs a pool):
stable_mod and the rjenkins string hash, the placement pipeline
(``pg_to_up_acting_osds``: replicated and EC, down, out, pg_temp,
primary_temp, upmap, upmap items, primary affinity, per-pool weight
sets), ``OSDMapMapping.update`` and ``apply_incremental``, and random
incrementals folded into both maps. The oracle is the reference's scalar
path (``update(batched=False)``, whose own tests tie it to its device
sweep); the port's update runs its plain version (``device="cpu"``),
also over a flat mesh of four CPU devices. Tolerance: none; ``by_osd``
compares in order.
"""

import functools
import random

import numpy as np
import pytest
import torch

from ceph_tpu.crush import map as jcmap
from ceph_tpu.osd import osd_map as J
from ceph_tpu_torch.crush import batched
from ceph_tpu_torch.crush import map as pcmap
from ceph_tpu_torch.osd import osd_map as P

from .torch_util import one_torch_thread  # noqa: F401

# the plain version's many small ops run on one torch thread a worker
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REF, PORT = (jcmap, J), (pcmap, P)
REP, EC = jcmap.POOL_TYPE_REPLICATED, jcmap.POOL_TYPE_ERASURE
NONE = jcmap.CRUSH_ITEM_NONE


# -- maps built alike in both packages -------------------------------------

def build_map(mods, num_hosts=4, osds_per_host=2, pool_type=REP, size=3,
              pg_num=32):
    """tests/test_osd_map.py's map: hosts of osds_per_host devices under
    one root, one pool whose rule picks hosts."""
    cmap, om = mods
    m = om.OSDMap()
    crush = cmap.CrushMap()
    crush.type_names = {"osd": 0, "host": 1, "root": 10}
    host_ids = []
    n = num_hosts * osds_per_host
    for h in range(num_hosts):
        devs = list(range(h * osds_per_host, (h + 1) * osds_per_host))
        host_ids.append(crush.add_bucket(
            "straw2", 1, devs, [0x10000] * len(devs), name="host%d" % h))
    crush.add_bucket("straw2", 10, host_ids,
                     [0x10000 * osds_per_host] * num_hosts, name="default")
    mode = "firstn" if pool_type == REP else "indep"
    crush.add_simple_rule("data", "default", failure_domain="host",
                          mode=mode, rule_type=pool_type)
    inc = om.Incremental(1)
    inc.new_max_osd = n
    inc.new_crush = crush
    inc.new_pools[1] = om.PGPool(pool_id=1, name="p", type=pool_type,
                                 size=size, pg_num=pg_num, crush_rule=0)
    for osd in range(n):
        inc.new_up[osd] = ("127.0.0.1", 7000 + osd)
        inc.new_weight[osd] = 0x10000
    m.apply_incremental(inc)
    return m


def two_pool_map(mods, hosts=8, per_host=4, pg_num=64):
    """A two-pool cluster: pool 1 replicated size 3 (chooseleaf firstn
    over hosts), pool 2 EC of 6 slots (chooseleaf indep over hosts) with
    a two-position weight set under choose_args[2], every 7th OSD at
    half weight and OSD 5 out."""
    cmap, om = mods
    crush = cmap.CrushMap()
    crush.type_names = {"osd": 0, "host": 1, "root": 2}
    hids = []
    for h in range(hosts):
        devs = list(range(h * per_host, (h + 1) * per_host))
        hids.append(crush.add_bucket("straw2", 1, devs,
                                     [0x10000] * per_host,
                                     name="host%d" % h))
    crush.add_bucket("straw2", 2, hids, [0x10000 * per_host] * hosts,
                     name="default")
    rep = crush.add_simple_rule("rep", "default", "host")
    ec = crush.add_simple_rule("ec", "default", "host", mode="indep",
                               rule_type=EC)
    crush.create_choose_args(2, positions=2)
    for h in (1, 4, 6):
        crush.choose_args_adjust_item_weight(2, hids[h], h * per_host + 1,
                                             [0x4000, 0xC000])
    n = hosts * per_host
    m = om.OSDMap()
    inc = om.Incremental(1)
    inc.new_max_osd = n
    inc.new_crush = crush
    inc.new_pools[1] = om.PGPool(pool_id=1, name="rbd", type=REP, size=3,
                                 pg_num=pg_num, crush_rule=rep)
    inc.new_pools[2] = om.PGPool(pool_id=2, name="ec", type=EC, size=6,
                                 pg_num=pg_num, crush_rule=ec)
    for osd in range(n):
        inc.new_up[osd] = ("127.0.0.1", 6800 + osd)
        inc.new_weight[osd] = 0x8000 if osd % 7 == 3 else 0x10000
    inc.new_weight[5] = 0
    m.apply_incremental(inc)
    return m


def inc_of(mods, epoch, **fields):
    """One Incremental of `mods` with `fields`; PGs are (pool, ps)."""
    om = mods[1]
    inc = om.Incremental(epoch)
    for name, value in fields.items():
        if name in ("new_pg_temp", "new_primary_temp", "new_pg_upmap",
                    "new_pg_upmap_items"):
            value = {om.PGID(*pg): v for pg, v in value.items()}
        elif name in ("old_pg_upmap", "old_pg_upmap_items"):
            value = [om.PGID(*pg) for pg in value]
        setattr(inc, name, value)
    return inc


def apply_both(maps, **fields):
    """Apply the same incremental to the reference's and the port's map;
    returns the two incrementals."""
    incs = []
    for mods, m in zip((REF, PORT), maps):
        incs.append(inc_of(mods, m.epoch + 1, **fields))
        m.apply_incremental(incs[-1])
    return incs


def key(pg):
    return (pg.pool, pg.ps)


def by_pg(mapping):
    return {key(pg): row for pg, row in mapping.by_pg.items()}


def by_osd(mapping):
    return {o: [key(pg) for pg in pgs] for o, pgs in mapping.by_osd.items()}


def rows(m, mods, pools=(1,), extra=2):
    """pg_to_up_acting_osds of every PG of `pools` and `extra` past the
    last, and of a pool that does not exist."""
    om = mods[1]
    out = {}
    for pool_id in pools:
        n = m.pools[pool_id].pg_num
        for ps in range(n + extra):
            out[(pool_id, ps)] = m.pg_to_up_acting_osds(om.PGID(pool_id, ps))
    out[(99, 0)] = m.pg_to_up_acting_osds(om.PGID(99, 0))
    return out


def assert_mappings_equal(ref, port):
    assert by_pg(port) == by_pg(ref)
    assert by_osd(port) == by_osd(ref)
    assert port.epoch == ref.epoch


# -- hashes ------------------------------------------------------------------

@pytest.mark.parametrize("x,b,mask", [(5, 8, 15), (13, 8, 15), (11, 12, 15),
                                      (0, 1, 0), (2 ** 32 - 1, 100, 127)])
def test_stable_mod_vectors(x, b, mask):
    assert P.stable_mod(x, b, mask) == J.stable_mod(x, b, mask)


def test_stable_mod_random():
    rng = random.Random(3)
    for _ in range(2000):
        b = rng.randrange(1, 5000)
        mask = (1 << P.calc_bits_of(b - 1)) - 1
        x = rng.randrange(0, 1 << 32)
        assert P.stable_mod(x, b, mask) == J.stable_mod(x, b, mask)
        assert P.calc_bits_of(b) == J.calc_bits_of(b)


def test_rjenkins_vectors_and_random():
    assert P.str_hash_rjenkins(b"") == 3175731469
    assert P.str_hash_rjenkins("foo") == P.str_hash_rjenkins(b"foo")
    rng = np.random.default_rng(7)
    for n in list(range(0, 40)) + [64, 100, 255]:
        s = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert P.str_hash_rjenkins(s) == J.str_hash_rjenkins(s)
    for name in ("foo", "bar", "rbd_data.1234", "été"):
        assert P.str_hash_rjenkins(name) == J.str_hash_rjenkins(name)


@pytest.mark.parametrize("hashpspool", [True, False])
@pytest.mark.parametrize("pg_num,pgp_num", [(64, 0), (48, 40), (1, 0)])
def test_pps_of_every_seed(hashpspool, pg_num, pgp_num):
    ref = J.PGPool(pool_id=7, name="p", pg_num=pg_num, pgp_num=pgp_num,
                   hashpspool=hashpspool)
    mine = P.PGPool(pool_id=7, name="p", pg_num=pg_num, pgp_num=pgp_num,
                    hashpspool=hashpspool)
    ps = np.arange(pg_num + 70, dtype=np.int64)
    want = [ref.raw_pg_to_pps(J.PGID(7, int(p))) for p in ps]
    assert [mine.raw_pg_to_pps(P.PGID(7, int(p))) for p in ps] == want
    assert mine.pps_of(ps).tolist() == want
    assert [key(mine.raw_pg_to_pg(P.PGID(7, int(p)))) for p in ps] == \
        [key(ref.raw_pg_to_pg(J.PGID(7, int(p)))) for p in ps]


def test_object_to_pg():
    maps = [build_map(mods, pg_num=16) for mods in (REF, PORT)]
    for i in range(500):
        name = "obj-%d" % i
        assert key(maps[1].object_to_pg(1, name)) == \
            key(maps[0].object_to_pg(1, name))


# -- the placement pipeline --------------------------------------------------

def _scenario(name, maps):
    """Apply tests/test_osd_map.py's scenario `name` to both maps; the PG
    choices read the reference map."""
    ref = maps[0]
    if name == "down_osd_ec_holes" or name == "down_host":
        apply_both(maps, new_down=[0] if name == "down_osd_ec_holes"
                   else [0, 1])
    elif name == "out_osd":
        apply_both(maps, new_weight={3: 0})
    elif name == "pg_temp":
        up = ref.pg_to_up_acting_osds(J.PGID(1, 0))[0]
        apply_both(maps, new_pg_temp={(1, 0): [o for o in range(8)
                                               if o not in up][:3]})
        apply_both(maps, new_pg_temp={(1, 4): [1, 6, 2]})
    elif name == "pg_temp_cleared":
        apply_both(maps, new_pg_temp={(1, 0): [7, 6, 5]})
        apply_both(maps, new_pg_temp={(1, 0): []})
    elif name == "primary_temp":
        up = ref.pg_to_up_acting_osds(J.PGID(1, 5))[0]
        apply_both(maps, new_primary_temp={(1, 5): up[1], (1, 6): 2})
    elif name == "pg_upmap":
        up = ref.pg_to_up_acting_osds(J.PGID(1, 3))[0]
        apply_both(maps, new_pg_upmap={(1, 3): [o for o in range(8)
                                                if o not in up][:3]})
    elif name == "pg_upmap_items":
        up = ref.pg_to_up_acting_osds(J.PGID(1, 7))[0]
        spare = [o for o in range(8) if o not in up][0]
        apply_both(maps, new_pg_upmap_items={(1, 7): [(up[1], spare)]})
    elif name == "upmap_to_out_osd":
        up = ref.pg_to_up_acting_osds(J.PGID(1, 2))[0]
        spare = [o for o in range(8) if o not in up][0]
        apply_both(maps, new_weight={spare: 0},
                   new_pg_upmap={(1, 2): [spare] + up[1:]})
    elif name == "primary_affinity":
        apply_both(maps, new_primary_affinity={0: 0, 1: 0, 6: 0x8000})
    elif name == "raw_pg_past_pg_num":
        apply_both(maps, new_pg_temp={(1, 33): [4, 5, 6]},
                   new_pg_upmap_items={(1, 40): [(0, 7)]})


SCENARIOS = ["basic", "down_osd_ec_holes", "down_host", "out_osd", "pg_temp",
             "pg_temp_cleared", "primary_temp", "pg_upmap", "pg_upmap_items",
             "upmap_to_out_osd", "primary_affinity", "raw_pg_past_pg_num"]


@pytest.mark.parametrize("pool_type", [REP, EC], ids=["rep", "ec"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_pipeline_matches_reference(name, pool_type):
    maps = [build_map(mods, pool_type=pool_type) for mods in (REF, PORT)]
    _scenario(name, maps)
    assert rows(maps[1], PORT) == rows(maps[0], REF)
    assert maps[1].pg_to_raw_osds(P.PGID(1, 3)) == \
        maps[0].pg_to_raw_osds(J.PGID(1, 3))


def test_apply_incremental_state_matches_reference():
    maps = [build_map(mods) for mods in (REF, PORT)]
    apply_both(maps, new_down=[2], new_weight={5: 0x8000},
               new_primary_affinity={1: 0x4000},
               new_pg_temp={(1, 1): [6, 7, 4]},
               new_primary_temp={(1, 2): 3},
               new_pg_upmap={(1, 3): [0, 2, 4]},
               new_pg_upmap_items={(1, 9): [(0, 6)]},
               new_ec_profiles={"p": {"k": "2"}})
    apply_both(maps, new_up={2: ("127.0.0.1", 1)}, new_max_osd=10,
               old_pg_upmap=[(1, 3)], new_primary_temp={(1, 2): -1})
    ref, mine = maps

    def state(m):
        return (m.epoch, m.max_osd, m.osd_exists, m.osd_up, m.osd_weight,
                m.osd_primary_affinity, m.get_up_osds(),
                {key(k): v for k, v in m.pg_temp.items()},
                {key(k): v for k, v in m.primary_temp.items()},
                {key(k): v for k, v in m.pg_upmap.items()},
                {key(k): v for k, v in m.pg_upmap_items.items()},
                m.ec_profiles, [m.is_in(o) for o in range(12)])
    assert state(mine) == state(ref)
    clone = mine.clone()
    assert state(clone) == state(mine) and clone.crush is not mine.crush


def test_incremental_overlay_classes():
    for mods in (REF, PORT):
        om = mods[1]
        assert inc_of(mods, 2, new_down=[1]).overlay_only()
        assert not inc_of(mods, 2, new_weight={1: 0}).overlay_only()
        assert not inc_of(mods, 2, new_up={1: None}).overlay_only()
        inc = inc_of(mods, 2, new_pg_temp={(1, 1): [1]},
                     new_primary_temp={(1, 2): 3},
                     new_pg_upmap={(1, 3): [1]},
                     new_pg_upmap_items={(1, 4): [(1, 2)]},
                     old_pg_upmap=[(1, 5)], old_pg_upmap_items=[(1, 6)])
        assert inc.overlay_only()
        assert inc.overlay_pgs() == {om.PGID(1, p) for p in range(1, 7)}


# -- the full remap -----------------------------------------------------------

def _update(m, how):
    mapping = P.OSDMapMapping()
    if how == "plain":
        mapping.update(m, device="cpu")
    elif how == "mesh":
        mapping.update(m, mesh=batched.make_batch_mesh(devices=["cpu"] * 4))
    else:
        mapping.update(m, batched=False)
    return mapping


HOWS = ["plain", "mesh", "scalar"]


@functools.lru_cache(maxsize=None)
def _ref_mapping(case):
    """The reference's scalar mapping of a case's map, computed once."""
    maps = _case_maps(case, REF)
    ref = J.OSDMapMapping()
    ref.update(maps, batched=False)
    return ref


def _case_maps(case, mods):
    """The map of `case` built with `mods`: "rep" or "ec" is
    tests/test_osd_map.py's test_bulk_equals_scalar (one down OSD, one
    out, a pg_temp and an upmap item, 64 PGs); "two_pools" adds per-pool
    weight sets, half-weight and out OSDs, primary affinity and every
    overlay on two pools."""
    if case == "two_pools":
        m = two_pool_map(mods, pg_num=32)
        fields = dict(
            new_down=[9, 17],
            new_primary_affinity={0: 0, 4: 0x6000, 12: 0x1000},
            new_pg_temp={(1, 3): [1, 2, 3],
                         (2, 4): [8, 12, 16, 20, 24, 28]},
            new_primary_temp={(1, 6): 13, (2, 7): 20},
            new_pg_upmap={(1, 8): [0, 4, 8]},
            new_pg_upmap_items={(2, 10): [(1, 30)], (1, 11): [(2, 31)]})
    else:
        m = build_map(mods, pool_type=REP if case == "rep" else EC,
                      pg_num=64)
        fields = dict(new_down=[2], new_weight={5: 0},
                      new_pg_temp={(1, 1): [6, 7, 4]},
                      new_pg_upmap_items={(1, 9): [(0, 6)]})
    m.apply_incremental(inc_of(mods, m.epoch + 1, **fields))
    return m


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", ["rep", "ec", "two_pools"])
def test_update_equals_reference_scalar(case, how):
    ref = _ref_mapping(case)
    mine = _update(_case_maps(case, PORT), how)
    assert_mappings_equal(ref, mine)
    if case == "two_pools":
        assert [mine.get_osd_acting_pgs(o) for o in (0, 13, 99)] == \
            [[P.PGID(*key(pg)) for pg in ref.get_osd_acting_pgs(o)]
             for o in (0, 13, 99)]
        assert mine.get(P.PGID(2, 5)) == ref.get(J.PGID(2, 5))


def test_update_split_and_raw_results():
    """Each swept pool keeps its raw result, equal to the scalar mapper
    under the pool's choose_args, and the wall split of its parts."""
    m = two_pool_map(PORT, pg_num=32)
    mapping = _update(m, "plain")
    assert sorted(mapping.split) == [1, 2]
    for pool_id, pool in m.pools.items():
        parts = mapping.split[pool_id]
        assert set(parts) == {"path", "seeds_ms", "sweep_ms", "overlay_ms"}
        assert parts.pop("path") == "device"
        assert all(v >= 0 for v in parts.values())
        raw = mapping.raw[pool_id]
        assert raw.shape == (pool.pg_num, pool.size)
        wv = m._weight_vector()
        for ps in range(0, pool.pg_num, 5):
            want = P.crush_do_rule(m.crush, pool.crush_rule,
                                   pool.raw_pg_to_pps(P.PGID(pool_id, ps)),
                                   pool.size, wv, choose_args=pool_id)
            assert raw[ps].tolist() == want + [NONE] * (pool.size - len(want))


def test_pool_without_rule_takes_scalar_path():
    maps = [build_map(mods, pg_num=16) for mods in (REF, PORT)]
    for mods, m in zip((REF, PORT), maps):
        m.pools[2] = mods[1].PGPool(pool_id=2, name="norule", pg_num=8,
                                    crush_rule=5)
    ref = J.OSDMapMapping()
    ref.update(maps[0], batched=False)
    batched.reset_paths()
    mine = _update(maps[1], "plain")
    assert batched.paths() == {"kernel": 0, "plain": 1, "scalar": 0}
    assert_mappings_equal(ref, mine)
    assert mine.split[2]["path"] == "scalar" and 2 not in mine.raw


def test_update_without_cuda_raises(monkeypatch):
    m = build_map(PORT, pg_num=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.OSDMapMapping().update(m)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.OSDMapMapping().update(m, mesh=True)
    mapping = P.OSDMapMapping()        # the native host mapper needs none
    mapping.update(m, native=True)
    assert mapping.split[1]["path"] == "native"


# -- incrementals against a full rebuild (tests/test_mapchurn.py:102-200) -----

def _random_inc(rng, maps):
    """tests/test_mapchurn.py's churn classes: up/down flaps, reweights,
    pg_temp / primary_temp overlays, upmap edits (PG choices read the
    reference map)."""
    m = maps[0]
    pool = m.pools[0]
    roll = rng.random()
    ps = rng.randrange(pool.pg_num)
    pg = J.PGID(0, ps)
    if roll < 0.25:
        osd = rng.randrange(m.max_osd)
        if m.is_up(osd):
            apply_both(maps, new_down=[osd])
        else:
            apply_both(maps, new_up={osd: ("127.0.0.1", 6800 + osd)})
    elif roll < 0.45:
        apply_both(maps, new_weight={rng.randrange(m.max_osd): rng.choice(
            [0x8000, 0xc000, 0xffff, 0x10000])})
    elif roll < 0.65:
        if pg in m.pg_temp and rng.random() < 0.5:
            apply_both(maps, new_pg_temp={(0, ps): []})
        else:
            apply_both(maps, new_pg_temp={(0, ps): sorted(
                rng.sample(range(m.max_osd), pool.size))})
    elif roll < 0.8:
        if pg in m.primary_temp and rng.random() < 0.5:
            apply_both(maps, new_primary_temp={(0, ps): -1})
        else:
            apply_both(maps, new_primary_temp={(0, ps): rng.randrange(
                m.max_osd)})
    else:
        if pg in m.pg_upmap_items and rng.random() < 0.5:
            apply_both(maps, old_pg_upmap_items=[(0, ps)])
        else:
            a, b = rng.sample(range(m.max_osd), 2)
            apply_both(maps, new_pg_upmap_items={(0, ps): [(a, b)]})


def _simple_maps(osds, pg_num, hosts):
    from ceph_tpu.tools import osdmaptool as jtool
    from ceph_tpu_torch.tools import osdmaptool as ptool
    return [jtool.create_simple(osds, pg_num=pg_num, hosts=hosts),
            ptool.create_simple(osds, pg_num=pg_num, hosts=hosts)]


def test_random_incs_fold_to_the_same_map():
    rng = random.Random(1234)
    maps = _simple_maps(12, 64, 6)
    for step in range(40):
        _random_inc(rng, maps)
        for ps in rng.sample(range(64), 2):
            assert maps[1].pg_to_up_acting_osds(P.PGID(0, ps)) == \
                maps[0].pg_to_up_acting_osds(J.PGID(0, ps)), (step, ps)
    assert rows(maps[1], PORT, pools=(0,)) == rows(maps[0], REF, pools=(0,))


@pytest.mark.parametrize("how", ["plain", "scalar"])
def test_incremental_equals_full_rebuild(how):
    """Overlay-only incs advance the mapping touching only the affected
    PGs, to the state of a full rebuild, and to the reference's
    incremental mapping."""
    rng = random.Random(77)
    maps = _simple_maps(16, 32, 8)
    ref_map = J.OSDMapMapping()
    ref_map.update(maps[0], batched=False)
    mine = _update(maps[1], how)
    pool = maps[0].pools[0]
    for step in range(16):
        m = maps[0]
        ps = rng.randrange(pool.pg_num)
        roll = rng.random()
        if roll < 0.3:
            incs = apply_both(maps, new_pg_temp={(0, ps): sorted(
                rng.sample(range(m.max_osd), pool.size))})
        elif roll < 0.5:
            incs = apply_both(maps, new_primary_temp={
                (0, ps): rng.randrange(m.max_osd)})
        elif roll < 0.7:
            a, b = rng.sample(range(m.max_osd), 2)
            incs = apply_both(maps, new_pg_upmap_items={(0, ps): [(a, b)]})
        elif roll < 0.85:
            up = [o for o in range(m.max_osd) if m.is_up(o)]
            if len(up) <= 3:
                continue
            incs = apply_both(maps, new_down=[rng.choice(up)])
        else:
            if not m.pg_upmap_items:
                continue
            incs = apply_both(maps, old_pg_upmap_items=[key(rng.choice(
                sorted(m.pg_upmap_items, key=str)))])
        ref_info = ref_map.apply_incremental(maps[0], incs[0],
                                             batched=False)
        info = mine.apply_incremental(maps[1], incs[1], device="cpu")
        assert info == ref_info
        assert info["mode"] == "incremental" and \
            info["recomputed"] < pool.pg_num
        assert by_pg(mine) == by_pg(ref_map), step
        assert by_osd(mine) == by_osd(ref_map), step
        if step % 5 != 4:
            continue
        full = _update(maps[1], "scalar")
        assert by_pg(mine) == by_pg(full)
        assert {o: sorted(p) for o, p in by_osd(mine).items() if p} == \
            {o: sorted(p) for o, p in by_osd(full).items() if p}


def test_weight_change_falls_back_to_full():
    maps = _simple_maps(8, 32, 4)
    ref = J.OSDMapMapping()
    ref.update(maps[0], batched=False)
    mine = _update(maps[1], "plain")
    incs = apply_both(maps, new_weight={0: 0x8000})
    assert ref.apply_incremental(maps[0], incs[0], batched=False) == \
        mine.apply_incremental(maps[1], incs[1], device="cpu") == \
        {"mode": "full", "recomputed": 32}
    assert_mappings_equal(ref, mine)
