"""The port's upmap balancer against the JAX package's.

``ceph_tpu_torch.osd.balancer`` against ``ceph_tpu.osd.balancer`` on the
same maps (``osdmaptool.create_simple`` and a two-pool cluster with a
per-pool weight set, 64 PGs a pool): the topology helpers, the scored
distribution and ``calc_pg_upmaps``' proposal (its items in order, the
items it drops, its deviations and sweeps). The oracle is the
reference's scalar path (``use_device=False``); the port's sweeps run
the plain version (``use_device=True, device="cpu"``) and its scalar
path. Tolerance: none (the deviations are the same float operations in
the same order).
"""

import functools

import pytest
import torch

from ceph_tpu.osd import balancer as jbal
from ceph_tpu.tools import osdmaptool as jtool
from ceph_tpu_torch.osd import balancer as pbal
from ceph_tpu_torch.osd.osd_map import CRUSH_ITEM_NONE, OSDMapMapping
from ceph_tpu_torch.tools import osdmaptool as ptool

from .torch_util import one_torch_thread  # noqa: F401
from .test_torch_osd_map import (PORT, REF, apply_both, by_pg, key,
                                 two_pool_map)

# the plain version's many small ops run on one torch thread a worker
pytestmark = pytest.mark.usefixtures("one_torch_thread")

# how the port sweeps: its plain version, or its scalar path
SWEEPS = {"plain": dict(use_device=True, device="cpu"),
          "scalar": dict(use_device=False)}


def simple_maps(osds=12, hosts=4, pg_num=64, size=3):
    return [jtool.create_simple(osds, pg_num=pg_num, pool_size=size,
                                hosts=hosts),
            ptool.create_simple(osds, pg_num=pg_num, pool_size=size,
                                hosts=hosts)]


def overloaded_maps():
    """tests/test_balancer.py's unmap case: up to 4 PGs on OSD 1 given
    an upmap item onto OSD 0 where the hosts allow it."""
    maps = simple_maps(8, 4, 64)
    ref = maps[0]
    pindex = jbal.parent_index(ref.crush)
    host = ref.crush.type_names["host"]
    mapping = jtool.OSDMapMapping()
    mapping.update(ref, batched=False)
    items = {}
    for pgid, (up, _, _, _) in sorted(mapping.by_pg.items(),
                                      key=lambda kv: key(kv[0])):
        if len(items) >= 4 or 1 not in up or 0 in up:
            continue
        others = [jbal.parent_of_type(ref.crush, o, host, pindex)
                  for o in up if o != 1]
        if jbal.parent_of_type(ref.crush, 0, host, pindex) in others:
            continue
        items[key(pgid)] = [(1, 0)]
    apply_both(maps, new_pg_upmap_items=items)
    return maps


def two_pool_maps():
    return [two_pool_map(REF, pg_num=32), two_pool_map(PORT, pg_num=32)]


CASES = {
    "skewed": (lambda: simple_maps(pg_num=32),
               dict(max_deviation_ratio=0.01, max_changes=6)),
    "skewed_batch8": (lambda: simple_maps(),
                      dict(max_changes=16, changes_per_sweep=8)),
    "size2_five_osds": (lambda: simple_maps(5, 5, 64, size=2),
                        dict(max_changes=12, changes_per_sweep=4)),
    "overloaded": (overloaded_maps,
                   dict(max_changes=8, changes_per_sweep=4)),
    "two_pools": (two_pool_maps, dict(max_changes=16, changes_per_sweep=8)),
    "pool_filter": (two_pool_maps,
                    dict(max_changes=4, changes_per_sweep=4, pools={2})),
    "no_such_pool": (lambda: simple_maps(),
                     dict(max_changes=10, pools={999})),
}


@functools.lru_cache(maxsize=None)
def ref_result(case):
    maps, kw = CASES[case][0](), CASES[case][1]
    return jbal.calc_pg_upmaps(maps[0], use_device=False, **kw)


@functools.lru_cache(maxsize=None)
def port_result(case, how):
    maps, kw = CASES[case][0](), CASES[case][1]
    return pbal.calc_pg_upmaps(maps[1], **kw, **SWEEPS[how])


def proposal(res):
    return (res.num_changed, res.start_deviation, res.end_deviation,
            res.sweeps,
            [(key(pg), list(p)) for pg, p in res.new_pg_upmap_items.items()],
            [key(pg) for pg in res.old_pg_upmap_items])


# -- topology helpers ---------------------------------------------------------

def test_topology_helpers_match_reference():
    for ref, mine in (simple_maps(6, 3), two_pool_maps()):
        for rule in range(len(ref.crush.rules) + 1):
            assert pbal.rule_take_roots(mine.crush, rule) == \
                jbal.rule_take_roots(ref.crush, rule)
            assert pbal.rule_failure_domain(mine.crush, rule) == \
                jbal.rule_failure_domain(ref.crush, rule)
            assert pbal.rule_weight_osd_map(mine.crush, rule) == \
                jbal.rule_weight_osd_map(ref.crush, rule)
        pindex = pbal.parent_index(mine.crush)
        assert pindex == jbal.parent_index(ref.crush)
        for osd in range(mine.max_osd):
            for t in (0, 1, 2, 5):
                assert pbal.parent_of_type(mine.crush, osd, t, pindex) == \
                    jbal.parent_of_type(ref.crush, osd, t, pindex)
        for root in list(mine.crush.buckets) + [3, -99]:
            assert pbal.subtree_devices(mine.crush, root) == \
                jbal.subtree_devices(ref.crush, root)


@pytest.mark.parametrize("how", list(SWEEPS))
def test_eval_distribution_matches_reference(how):
    ref, mine = overloaded_maps()
    a = jbal.eval_distribution(ref, use_device=False)
    b = pbal.eval_distribution(mine, **SWEEPS[how])
    assert (b.pg_counts, b.targets, b.total_deviation, b.stddev) == \
        (a.pg_counts, a.targets, a.total_deviation, a.stddev)
    assert [b.deviation(o) for o in range(9)] == \
        [a.deviation(o) for o in range(9)]


# -- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("case,how", [(c, "plain") for c in CASES] + [
    ("skewed", "scalar"), ("overloaded", "scalar")])
def test_calc_pg_upmaps_matches_reference(case, how):
    assert proposal(port_result(case, how)) == proposal(ref_result(case))


def test_overloaded_osd_items_are_dropped():
    res = ref_result("overloaded")
    assert res.old_pg_upmap_items and res.num_changed
    ref, mine = overloaded_maps()
    before = pbal.eval_distribution(mine, use_device=False)
    assert before.deviation(0) >= 4


@pytest.mark.parametrize("case", ["skewed", "overloaded", "two_pools"])
def test_apply_to_lands_the_same_map(case):
    """The proposal through apply_to and an Incremental: the same
    mapping in both packages, every PG keeping its replica count and
    its failure-domain count."""
    maps = CASES[case][0]()
    res = [ref_result(case), port_result(case, "plain")]
    raw = OSDMapMapping()
    raw.update(maps[1], device="cpu")
    for r, m, mods in zip(res, maps, (REF, PORT)):
        inc = mods[1].Incremental(m.epoch + 1)
        r.apply_to(inc)
        m.apply_incremental(inc)
    ref = jtool.OSDMapMapping()
    ref.update(maps[0], batched=False)
    mine = OSDMapMapping()
    mine.update(maps[1], device="cpu")
    assert by_pg(mine) == by_pg(ref)
    crush = maps[1].crush
    pindex = pbal.parent_index(crush)
    for pgid, (up, _, _, _) in mine.by_pg.items():
        pool = maps[1].pools[pgid.pool]
        fd = pbal.rule_failure_domain(crush, pool.crush_rule)
        before = [o for o in raw.by_pg[pgid][0] if o != CRUSH_ITEM_NONE]
        after = [o for o in up if o != CRUSH_ITEM_NONE]
        assert len(after) == len(before)
        assert len({pbal.parent_of_type(crush, o, fd, pindex)
                    for o in after}) >= \
            len({pbal.parent_of_type(crush, o, fd, pindex) for o in before})


def test_measure_sweep_and_no_cuda(monkeypatch):
    m = simple_maps(8, 4, 16)[1]
    assert pbal.measure_sweep(m, True, device="cpu") > 0
    assert pbal.measure_sweep(m, False) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pbal.calc_pg_upmaps(m, max_changes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pbal.eval_distribution(m)
    # the native host mapper needs no card
    assert pbal.calc_pg_upmaps(m, max_changes=2, use_native=True).sweeps >= 1


@pytest.mark.parametrize("batched", [False, True])
def test_osdmaptool_upmap_cli_matches_reference(tmp_path, capsys, batched):
    mapfile = tmp_path / "map.json"
    assert jtool.main(["--createsimple", "8", str(mapfile), "--pg-num",
                       "32", "--hosts", "4"]) == 0
    outs = []
    for tool, extra in ((jtool, []), (ptool, ["--batched", "--device", "cpu"]
                                      if batched else [])):
        up = tmp_path / ("up_%s.txt" % tool.__name__)
        capsys.readouterr()
        assert tool.main([str(mapfile), "--upmap", str(up), "--upmap-max",
                          "3"] + extra) == 0
        outs.append((up.read_text(),
                     capsys.readouterr().out.replace(str(up), "UP")))
    assert outs[1] == outs[0]
    assert "ceph osd pg-upmap-items" in outs[0][0]
