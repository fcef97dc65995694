"""The port's PG against the reference's, each hosted in loopback daemons.

One seeded scenario (``tests/torch_pg_scenario.py``) runs through the
reference's ``ceph_tpu.osd.pg.PG`` and through the port's
``ceph_tpu_torch.osd.pg.PG``, each on 8 daemons of the same harness
(``tests/torch_pg_loopback.py``): client ops of every kind, an OSD down
with degraded writes, up with log recovery, another out with its PGs
remapped, bitrot repaired by a deep scrub. Compared byte for byte: every
OSD's collections (object bytes, xattrs, omap, the PG meta object's log
rows), every op's result and data, every scrub's stats, every PG's
``get_stats()`` and the final acting sets.

Three pools, each run once per package per module:

* RS reed_sol_van k=4, m=2: the reference on its host ``jerasure``, the
  port on ``torch_cuda`` on daemons with ``home_device="cpu"``, each with
  a ``GpuDispatcher`` and an ``HbmChunkTier`` on the CPU and the fused
  write in "store" mode (the kernels' plain versions), so the port's deep
  scrub hashes its resident shards through ``device_crc32``.
* MSR k=4, m=3: the reference's ``msr`` against the port's ``msr_cuda``
  (a dispatcher and a tier on every daemon, no fused write: the fused
  transform is for codecs without sub-chunks).
* A replicated pool of size 3, with object-class calls.

Apart from the comparison: the port's deviations (``_digest_from_tier``
propagates anything but a miss; an op parked on a missing object that
fails when woken replies EIO, and the push raises its error after every
parked op ran; a cache-tier op raises ``NotImplementedError``), and a
reference defect the port keeps (a restarted OSD's log loses the row of a
clone).
"""

import importlib
import time
import types

import numpy as np
import pytest
import torch

from . import torch_pg_loopback as loopback
from . import torch_pg_scenario as scenario
from .torch_util import one_torch_thread  # noqa: F401

RS = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4",
      "m": "2", "w": "8"}
MSR = {"plugin": "msr", "k": "4", "m": "3", "w": "8"}
PORT_PLUGIN = {"jerasure": "torch_cuda", "msr": "msr_cuda"}

CASES = {
    "rs": scenario.Config(profile=RS, bitrot=((0, 0), (1, 2))),
    "msr": scenario.Config(seed=21, profile=MSR, objects=8,
                           bitrot=((0, 3),)),
    "replicated": scenario.Config(seed=22, size=3),
}


def pkg_classes(pkg: str) -> types.SimpleNamespace:
    """The names the harness takes, from one package."""
    def mod(name):
        return importlib.import_module("%s.%s" % (pkg, name))

    osd_map = mod("osd.osd_map")
    message = mod("msg.message")
    return types.SimpleNamespace(
        PG=mod("osd.pg").PG, OSDMap=osd_map.OSDMap,
        Incremental=osd_map.Incremental, PGPool=osd_map.PGPool,
        PGID=osd_map.PGID, POOL_TYPE_ERASURE=osd_map.POOL_TYPE_ERASURE,
        POOL_TYPE_REPLICATED=osd_map.POOL_TYPE_REPLICATED,
        build_crush=mod("tools.crushtool").build_map,
        MemStore=mod("store").MemStore,
        SafeTimer=mod("common.workqueue").SafeTimer,
        AsyncReserver=mod("common.reserver").AsyncReserver,
        MOSDOp=message.MOSDOp, MWatchNotifyAck=message.MWatchNotifyAck,
        SpanCollector=mod("common.tracer").SpanCollector)


def case_profile(pkg, cfg):
    if cfg.profile is None or pkg == "ceph_tpu":
        return cfg.profile
    return dict(cfg.profile, plugin=PORT_PLUGIN[cfg.profile["plugin"]])


def reference_cluster(cfg):
    return loopback.Cluster(pkg_classes("ceph_tpu"), cfg.n_osds)


def port_cluster(cfg, device="cpu", tier=True):
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier
    dispatchers = []

    def make_dispatcher(osd):
        dispatchers.append(GpuDispatcher(device=device))
        return dispatchers[-1]

    cluster = loopback.Cluster(
        pkg_classes("ceph_tpu_torch"), cfg.n_osds, home_device=device,
        make_dispatcher=make_dispatcher,
        make_tier=(lambda osd: HbmChunkTier(device=device)) if tier
        else None,
        fused_mode=("store" if cfg.profile is not None
                    and cfg.profile["plugin"] == "torch_cuda" else None))
    cluster.dispatchers = dispatchers
    return cluster


def close(cluster) -> None:
    cluster.shutdown()
    for d in getattr(cluster, "dispatchers", ()):
        d.shutdown()


def run_case(pkg, case, device="cpu"):
    """The case's scenario in one package; the port's daemons, their
    dispatchers and tiers on ``device``."""
    cfg = CASES[case]
    cfg = scenario.Config(**dict(vars(cfg), profile=case_profile(pkg, cfg)))
    codec = None
    if cfg.profile is not None:
        registry = importlib.import_module("%s.registry" % pkg)
        kw = {} if pkg == "ceph_tpu" else {"device": "cpu"}
        codec = registry.factory(cfg.profile["plugin"], dict(cfg.profile),
                                 **kw)
    before = kernel_calls(pkg)
    cluster = reference_cluster(cfg) if pkg == "ceph_tpu" else \
        port_cluster(cfg, device=device)
    try:
        out = scenario.run(cluster, cfg, codec, plain_encoder(pkg, cfg))
    finally:
        close(cluster)
    after = kernel_calls(pkg)
    out["kernels"] = {k: after[k] - before.get(k, 0) for k in after}
    out["threads_alive"] = cluster.threads_alive()
    return out


def plain_encoder(pkg, cfg):
    """The port's plain encode of an object's bytes into its shard
    streams (the port's and the reference's stores are held equal
    apart), or None for a replicated pool and for the reference."""
    if pkg == "ceph_tpu" or cfg.profile is None:
        return None
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.osd import ec_util
    codec = registry.factory(cfg.profile["plugin"], dict(cfg.profile),
                             device="cpu")
    sinfo = ec_util.StripeInfo(
        codec.get_data_chunk_count(),
        scenario.stripe_width(codec, scenario.STRIPE_UNIT))

    def encode(data):
        buf = bytearray(data)
        buf.extend(b"\0" * (-len(buf) % sinfo.stripe_width))
        shards = ec_util.encode(sinfo, codec,
                                np.frombuffer(bytes(buf), dtype=np.uint8))
        return [shards[i].tobytes() for i in range(len(shards))]

    return encode


def kernel_calls(pkg) -> dict:
    """The port's profiled kernel calls by name (none for the
    reference's host codecs)."""
    if pkg == "ceph_tpu":
        return {}
    from ceph_tpu_torch.common.profiler import PROFILER
    return {name: k["compiles"] + k["cache_hits"]
            for name, k in PROFILER.dump()["kernels"].items()}


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    """Each case's outputs, computed once per package in this module."""
    cache = {}

    def get(pkg, case):
        if (pkg, case) not in cache:
            cache[pkg, case] = run_case(pkg, case)
        return cache[pkg, case]

    yield get
    from ceph_tpu.parallel import rateless
    rateless.reset_dispatcher()


PKGS = ["ceph_tpu", "ceph_tpu_torch"]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("pkg", PKGS)
def test_scenario_holds_the_model(runs, pkg, case):
    """Every op returned what the scenario expects and every read the
    model's bytes (checked as it ran), the bitrot was found and repaired,
    a second deep scrub is clean, and no harness thread outlives the
    cluster."""
    out = runs(pkg, case)
    assert out["replies"]
    repair = out["scrubs"]["repair"]
    found = sum(s["errors"] for s in repair.values())
    assert found == len(CASES[case].bitrot), repair
    assert sum(s["repaired"] for s in repair.values()) == found, repair
    assert all(s["state"] == "clean" and s["errors"] == 0
               for s in out["scrubs"]["after"].values()), out["scrubs"]
    assert out["threads_alive"] == []
    if pkg == "ceph_tpu_torch" or CASES[case].profile is None:
        # every acting shard holds the plain encode of the model (heads
        # and clones), or every acting replica its bytes
        assert out["mismatches"] == [], out["mismatches"][:5]
    perf = out["perf"]
    assert perf.get("l_osd_recovery_ops", 0) > 0, perf
    if CASES[case].profile is not None:
        # the deep scrub's rebuilds (and any the read path made)
        assert perf.get("repaired", 0) >= found, perf


def test_port_runs_its_device_paths(runs):
    """The port's RS pool wrote through the fused transform and its deep
    scrub hashed resident shards through ``device_crc32`` (the kernels'
    plain versions on the CPU)."""
    kernels = runs("ceph_tpu_torch", "rs")["kernels"]
    assert kernels.get("fused_transform.program", 0) > 0 and \
        kernels.get("fused_transform.scrub_crc", 0) > 0, kernels


@pytest.mark.parametrize("case", list(CASES))
def test_replies_equal_the_reference(runs, case):
    ref, port = runs("ceph_tpu", case), runs("ceph_tpu_torch", case)
    assert [r[0] for r in port["replies"]] == [r[0] for r in ref["replies"]]
    for a, b in zip(ref["replies"], port["replies"]):
        assert b[1:] == a[1:], a[0]
    assert port["model"] == ref["model"]


@pytest.mark.parametrize("osd", range(8))
@pytest.mark.parametrize("case", list(CASES))
def test_collections_equal_the_reference(runs, case, osd):
    """Every collection of the OSD's store: each object's bytes, xattrs
    (version, size, hinfo, snapset) and omap, the PG meta object's log
    rows (``encoding.encode_any`` of each) among them."""
    ref = runs("ceph_tpu", case)["collections"][osd]
    port = runs("ceph_tpu_torch", case)["collections"][osd]
    assert sorted(port, key=repr) == sorted(ref, key=repr)
    for cid in ref:
        assert sorted(port[cid]) == sorted(ref[cid]), cid
        for oid in ref[cid]:
            assert port[cid][oid] == ref[cid][oid], (cid, oid)


@pytest.mark.parametrize("case", list(CASES))
def test_scrubs_stats_and_acting_equal_the_reference(runs, case):
    ref, port = runs("ceph_tpu", case), runs("ceph_tpu_torch", case)
    assert port["scrubs"] == ref["scrubs"]
    assert port["stats"] == ref["stats"]
    assert port["acting"] == ref["acting"]
    # recoveries, read errors and repair traffic, counted alike. Not the
    # read path's self-heals ("repaired" beyond the scrub's): a read that
    # finds a shard bad repairs it once while a repair of it is in
    # flight, so two reads of one shard make one or two repairs by their
    # timing, in either package
    drop = {"repaired"}
    assert {k: v for k, v in port["perf"].items() if k not in drop} == \
        {k: v for k, v in ref["perf"].items() if k not in drop}


def small_cluster(pkg, n=3):
    """n daemons and a replicated pool of size 3 with one PG."""
    cluster = (reference_cluster if pkg == "ceph_tpu" else port_cluster)(
        scenario.Config(n_osds=n))
    cluster.create_pool(1, "rep", size=3, min_size=2, pg_num=1)
    cluster.drain()
    return cluster


@pytest.mark.parametrize("pkg", PKGS)
def test_parked_op_failure_reaches_its_reply(one_torch_thread, pkg):
    """Two reads park on an object the primary is missing; the push that
    recovers it wakes both, and the first fails. The port's fails with
    EIO and the push raises its error after the second read ran; the
    reference drops the error and the failed read never replies."""
    PG = importlib.import_module("%s.osd.pg" % pkg).PG
    message = importlib.import_module("%s.msg.message" % pkg)
    cluster = small_cluster(pkg)
    try:
        assert cluster.call(1, "a", [("writefull", b"x" * 100)])[0] == 0
        pgid = cluster.pgid_of(1, "a")
        acting, primary = cluster.acting(pgid)
        pg = cluster.daemons[primary].pgs[pgid]
        with pg.lock:
            pg.missing["a"] = 1
        calls = []
        real = PG._do_read_ops

        def flaky(self, msg, reply_fn):
            calls.append(msg.tid)
            if len(calls) == 1:
                raise RuntimeError("read failed")
            return real(self, msg, reply_fn)

        pg._do_read_ops = types.MethodType(flaky, pg)
        first = cluster.submit(1, "a", [("read", 0, 0)])
        second = cluster.submit(1, "a", [("read", 0, 0)])
        deadline = time.monotonic() + 30
        while len(pg._missing_waiters.get("a", ())) < 2:
            cluster.check()
            assert time.monotonic() < deadline, "the reads did not park"
            time.sleep(0.002)
        assert not first.event.is_set() and not second.event.is_set()
        replica = next(o for o in acting if o != primary)
        push = message.MOSDPGPush(
            pgid=pgid, from_osd=replica, shard=-1, oid="a",
            data=b"x" * 100, attrs={"_v": b"1", "_size": b"100"},
            version=1, map_epoch=cluster.osdmap.epoch)
        cluster.daemons[replica].send_to_osd_cluster(primary, push)
        assert second.event.wait(30) and second.reply == (0, b"x" * 100)
        assert len(calls) == 2
        if pkg == "ceph_tpu":
            assert not first.event.is_set() and not cluster.errors
        else:
            assert first.event.wait(10) and first.reply == (-5, None)
            assert [str(e) for e in cluster.errors] == ["read failed"]
            cluster.errors.clear()
    finally:
        close(cluster)


class _Tier:
    """A chunk tier whose digest lookup answers with ``answer``."""

    def __init__(self, answer):
        self.answer = answer

    def shard_digests(self, key):
        if isinstance(self.answer, Exception):
            raise self.answer
        return self.answer

    def codec_of(self, key):
        return None


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("answer", ["none", "keyerror", "short", "row",
                                    "fault"])
def test_digest_from_tier_misses_and_faults(pkg, answer):
    """A miss (no digests, the tier's KeyError, a row too short) is None
    in both packages and a resident row gives its shard's crc; a fault of
    the tier propagates in the port, where the reference hashes on the
    host instead."""
    PG = importlib.import_module("%s.osd.pg" % pkg).PG
    tier = _Tier({"none": None, "keyerror": KeyError("evicted"),
                  "short": np.array([7], dtype=np.uint32),
                  "row": np.array([7, 8, 9], dtype=np.uint32),
                  "fault": RuntimeError("CUDA error: launch failure")}
                 [answer])
    pg = types.SimpleNamespace(pgid="1.0")
    if answer == "fault" and pkg == "ceph_tpu_torch":
        with pytest.raises(RuntimeError, match="launch failure"):
            PG._digest_from_tier(pg, tier, 2, "a")
        return
    want = 9 if answer == "row" else None
    assert PG._digest_from_tier(pg, tier, 2, "a") == want


def test_cache_tier_op_raises(one_torch_thread):
    """The port has no PGTier yet: an op on a cache-tier pool fails
    loudly, naming the slice it waits for."""
    cluster = small_cluster("ceph_tpu_torch")
    try:
        cluster.create_pool(2, "hot", size=3, min_size=2, pg_num=1)
        cluster.set_pool(2, tier_of=1, cache_mode="writeback")
        cluster.drain()
        op = cluster.submit(2, "a", [("writefull", b"x")])
        with pytest.raises(NotImplementedError, match="RADOS client"):
            op.result()
        assert op.reply == (-5, None)
        cluster.errors.clear()
    finally:
        close(cluster)


def test_restart_loses_a_clone_log_row():
    """A reference defect the port keeps: the durable log keys a row by
    its eversion, and an op that clones a head mints two entries of one
    eversion, so the row of the clone is overwritten by the head's. A
    restarted OSD's PG reloads its log without the clone's entry, in both
    packages alike (ROADMAP Queue 3)."""
    logs = {}
    for pkg in PKGS:
        cluster = small_cluster(pkg)
        try:
            assert cluster.call(1, "a", [("writefull", b"x" * 64)])[0] == 0
            assert cluster.call(1, "a", [("write", 0, b"y" * 8)],
                                snapc=(1, (1,)))[0] == 0
            pgid = cluster.pgid_of(1, "a")
            acting, primary = cluster.acting(pgid)
            replica = next(o for o in acting if o != primary)
            before = cluster.daemons[replica].pgs[pgid].pg_log.dump()
            cluster.mark_down(replica, crash=True)
            cluster.drain()
            cluster.mark_up(replica)
            cluster.drain()
            after = cluster.daemons[replica].pgs[pgid].pg_log.dump()
            logs[pkg] = (before, after)
        finally:
            close(cluster)
    assert logs["ceph_tpu_torch"] == logs["ceph_tpu"]
    before, after = logs["ceph_tpu"]
    assert "a@1" in [row[2] for row in before]
    assert "a@1" not in [row[2] for row in after]


def test_erasure_pg_needs_the_card_unless_told_cpu(one_torch_thread):
    """A daemon without ``home_device`` means the card: on a host without
    CUDA the port's PG on an erasure pool cannot build its codec, and
    never carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cluster = loopback.Cluster(pkg_classes("ceph_tpu_torch"), 6)
    try:
        cfg = scenario.Config(profile=dict(RS, plugin="torch_cuda"))
        codec = importlib.import_module("ceph_tpu_torch.registry").factory(
            "torch_cuda", dict(cfg.profile), device="cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            scenario.create_pool(cluster, cfg, codec)
    finally:
        cluster.shutdown()

