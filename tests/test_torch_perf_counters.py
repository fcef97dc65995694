"""Performance counters of the PyTorch port against the JAX package's.

``ceph_tpu_torch.common.perf_counters`` and ``ceph_tpu.common.perf_counters``
are driven through the same sequence of updates (every kind: u64, u64
counter, time, time average, u64 average, histogram), and their dumps,
schemas, reads and resets must agree exactly; then the per-context
``PerfCountersCollection`` (add, remove, perf_dump, perf_schema,
perf_reset of one logger or all). Tolerance: none (the same floats are
added in the same order).
"""

import time

import pytest

from ceph_tpu.common import perf_counters as ref
from ceph_tpu_torch.common import perf_counters as port

KINDS = ("add_u64", "add_u64_counter", "add_time", "add_time_avg",
         "add_u64_avg", "add_histogram")


def build(mod, name="osd"):
    b = mod.PerfCountersBuilder(name)
    for kind in KINDS:
        getattr(b, kind)(kind[4:], "a %s counter" % kind)
    return b.create_perf_counters()


def drive(pc):
    pc.inc("u64_counter")
    pc.inc("u64_counter", 41)
    pc.dec("u64_counter", 2)
    pc.set("u64", 7)
    pc.dec("u64")
    pc.tinc("time", 0.25)
    pc.tinc("time_avg", 0.5)
    pc.tinc("time_avg", 1.5)
    pc.tinc("u64_avg", 3)
    for sample in (0, 1, 2, 3, 1000, 1 << 29, 1 << 31, 1 << 40):
        pc.hinc("histogram", sample)


def test_every_kind_dumps_as_the_reference():
    mine, theirs = build(port), build(ref)
    drive(mine)
    drive(theirs)
    assert mine.dump() == theirs.dump()
    assert mine.schema() == theirs.schema()
    for name in ("u64", "u64_counter", "time"):
        assert mine.get(name) == theirs.get(name)
    assert mine.avg("time_avg") == theirs.avg("time_avg") == 1.0
    assert mine.avg("u64_avg") == theirs.avg("u64_avg") == 3.0
    assert mine.avg("time") == theirs.avg("time")


def test_histogram_buckets_are_powers_of_two():
    pc = build(port)
    drive(pc)
    h = pc.dump()["histogram"]
    assert pc.schema()["histogram"]["buckets"][:3] == [2, 4, 8]
    assert h["count"] == 8 and sum(h["buckets"]) == 8
    assert h["buckets"][0] == 3            # 0, 1 and 2 are <= 2
    assert h["buckets"][-1] == 2           # past 2^30: the overflow bucket


def test_time_context_manager_adds_one_sample():
    pc = build(port)
    with pc.time("time_avg"):
        time.sleep(0.002)
    d = pc.dump()["time_avg"]
    assert d["avgcount"] == 1 and d["sum"] >= 0.002


def test_reset_zeroes_every_kind_as_the_reference():
    mine, theirs = build(port), build(ref)
    for pc in (mine, theirs):
        drive(pc)
        pc.reset()
    assert mine.dump() == theirs.dump()
    assert sum(mine.dump()["histogram"]["buckets"]) == 0


@pytest.mark.parametrize("target", [None, "osd", "absent"])
def test_collection_dump_schema_reset(target):
    colls = []
    for mod in (port, ref):
        coll = mod.PerfCountersCollection()
        a, b = build(mod, "osd"), build(mod, "osd_gpu")
        coll.add(a)
        coll.add(b)
        drive(a)
        drive(b)
        reset = coll.perf_reset(target)
        colls.append((coll, reset, a, b))
    (mine, mine_reset, ma, mb), (theirs, their_reset, _, _) = colls
    assert mine_reset == their_reset
    assert mine.perf_dump() == theirs.perf_dump()
    assert mine.perf_schema() == theirs.perf_schema()
    assert (ma.get("u64_counter") == 0) == (target in (None, "osd"))
    assert (mb.get("u64_counter") == 0) == (target is None)
    mine.remove(mb)
    theirs.remove(colls[1][3])
    assert sorted(mine.perf_dump()) == sorted(theirs.perf_dump()) == ["osd"]
