"""The port's ECBackend against the reference's, in one loopback PG each.

One seeded sequence of client ops (``tests/torch_ec_sequence.py``) runs
through the reference's ``ceph_tpu.osd.ec_backend.ECBackend`` and through
the port's ``ceph_tpu_torch.osd.ec_backend.ECBackend``, each in the same
harness (``tests/torch_ec_loopback.py``): whole-object writes, reads and
rebuilds from the device chunk tier, a bitrot and an EIO mark the read
path must reconstruct around and repair, pipelined read-modify-write
overwrites and appends, reads, degraded reads with shard OSDs down, and
rebuilds with the tier off. Compared byte for byte: every read, every
rebuilt shard, every shard collection's objects (data, xattrs with the
hinfo, omap), the PG logs, and the messages each step sent.

Three configurations, each run once per package per module:

* RS reed_sol_van k=4, m=2 in the fused write transform's store mode:
  the reference on ``jax_tpu`` with its ``TpuDispatcher`` and
  ``HbmChunkTier`` (JAX on the CPU), the port on ``torch_cuda`` with
  ``device="cpu"``, a ``GpuDispatcher`` and an ``HbmChunkTier`` on the
  CPU (the kernels' plain versions).
* The same in compress mode on low-entropy objects of 8 KiB, below the
  reference's int32 wrap of the ratio rule (2,454,267 bytes, ROADMAP
  Queue 3 item 1), where both compress.
* MSR k=4, m=3 (alpha 3, d 6): the reference's host ``msr`` against the
  port's ``msr_cuda`` with a dispatcher on every OSD: the tier's striped
  rebuild, the regenerating repair through the helpers' fractions, and a
  repair whose helper fails (the fallback to the survivors' decode).

Apart from the comparison: the port compresses a 4 MiB low-entropy object
at the OSD's geometry (RS k=8, m=3, stripe_unit 4096), which the
reference stores raw; and the port's tier paths fall through only on a
miss and propagate any other error.
"""

import json

import numpy as np
import pytest

from . import torch_ec_loopback as loopback
from . import torch_ec_sequence as sequence
from .torch_util import one_torch_thread  # noqa: F401

RS = {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "8"}
MSR = {"k": "4", "m": "3", "w": "8"}
STRIPE_UNIT = 256


def stripe_width(codec, unit=STRIPE_UNIT):
    """The pool's stripe width (ceph_tpu/mon/osd_monitor.py:675)."""
    k = codec.get_data_chunk_count()
    return k * codec.get_chunk_size(unit * k)


CASES = {
    "rs_store": (RS, "store", sequence.Config()),
    "rs_compress": (RS, "compress", sequence.Config(
        seed=19, objects=4, low_entropy=True, overwrites=4, appends=0,
        ranges=6, down_sets=((2,),), eio=(1, 0))),
    "msr": (MSR, None, sequence.Config(
        seed=20, objects=4, object_bytes=6000, overwrites=4, appends=2,
        ranges=6, down_sets=((1,), (2, 5)), repair_fault=(2, 3))),
}


def reference_run(case):
    from ceph_tpu import registry
    from ceph_tpu.common.tracer import SpanCollector
    from ceph_tpu.common.workqueue import SafeTimer
    from ceph_tpu.osd.ec_backend import ECBackend
    from ceph_tpu.osd.hbm_tier import HbmChunkTier
    from ceph_tpu.osd.pg_log import PGLog, entry_from_tuple
    from ceph_tpu.osd.pg_transaction import PGTransaction
    from ceph_tpu.osd.tpu_dispatch import TpuDispatcher
    from ceph_tpu.parallel import rateless
    from ceph_tpu.store import MemStore, Transaction
    profile, mode, cfg = CASES[case]
    if case == "msr":
        codec = registry.factory("msr", dict(profile))
        dispatchers = {}
    else:
        codec = registry.factory("jax_tpu", dict(profile))
        dispatchers = {0: TpuDispatcher()}
    lb = loopback.Loopback(
        ECBackend=ECBackend, MemStore=MemStore, Transaction=Transaction,
        PGLog=PGLog, entry_from_tuple=entry_from_tuple,
        SafeTimer=SafeTimer, tracer=SpanCollector(), codec=codec,
        stripe_width=stripe_width(codec), dispatchers=dispatchers,
        dispatcher_attr="tpu_dispatcher", tier=HbmChunkTier(),
        fused_mode=mode)
    try:
        return sequence.run(lb, PGTransaction, cfg)
    finally:
        lb.shutdown()
        for d in dispatchers.values():
            d.shutdown()
        # the reference's recovery starts its process-global rateless
        # dispatcher on the CPU's eight devices: stop its threads here
        rateless.reset_dispatcher()


def port_loopback(codec, mode, dispatch_all=False, tier="cpu", **kw):
    from ceph_tpu_torch.common.tracer import SpanCollector
    from ceph_tpu_torch.common.workqueue import SafeTimer
    from ceph_tpu_torch.osd.ec_backend import ECBackend
    from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
    from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier
    from ceph_tpu_torch.osd.pg_log import PGLog, entry_from_tuple
    from ceph_tpu_torch.store import MemStore, Transaction
    osds = range(codec.get_chunk_count()) if dispatch_all else (0,)
    dispatchers = {o: GpuDispatcher(device=tier) for o in osds}
    lb = loopback.Loopback(
        ECBackend=ECBackend, MemStore=MemStore, Transaction=Transaction,
        PGLog=PGLog, entry_from_tuple=entry_from_tuple,
        SafeTimer=SafeTimer, tracer=SpanCollector(), codec=codec,
        stripe_width=kw.pop("width", None) or stripe_width(codec),
        dispatchers=dispatchers,
        tier=HbmChunkTier(device=tier), fused_mode=mode, **kw)
    return lb, dispatchers


def close(lb, dispatchers):
    lb.shutdown()
    for d in dispatchers.values():
        d.shutdown()


def port_run(case, device="cpu"):
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.osd.pg_transaction import PGTransaction
    profile, mode, cfg = CASES[case]
    plugin = "msr_cuda" if case == "msr" else "torch_cuda"
    codec = registry.factory(plugin, dict(profile), device=device)
    lb, dispatchers = port_loopback(codec, mode, dispatch_all=case == "msr",
                                    tier=device)
    try:
        return sequence.run(lb, PGTransaction, cfg)
    finally:
        close(lb, dispatchers)


def stable_routes(out) -> dict:
    """The messages of each step, but of the pipelined overwrites only
    their sub-writes: whether an overwrite finds its stripes still pinned
    by an earlier write in flight (no readback) or already released (a
    readback) depends on when that write committed, in either package."""
    routes = dict(out["routes"])
    routes["overwrites"] = {k: v for k, v in routes["overwrites"].items()
                            if k.startswith("MOSDECSubOpWrite")}
    return routes


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    """Each case's outputs, computed once per package in this module."""
    cache = {}

    def get(pkg, case):
        if (pkg, case) not in cache:
            cache[pkg, case] = (reference_run if pkg == "ceph_tpu"
                                else port_run)(case)
        return cache[pkg, case]

    return get


PKGS = ["ceph_tpu", "ceph_tpu_torch"]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("pkg", PKGS)
def test_reads_and_rebuilds_hold_the_model(runs, pkg, case):
    """Every read returns the model's bytes and every rebuilt shard the
    shard its store holds, in each package."""
    out = runs(pkg, case)
    assert out["reads"] and out["rebuilt"]
    for label, got, want in out["reads"]:
        assert got == want, label
    for label, got, want in out["rebuilt"]:
        assert got is not None and got == want, label


@pytest.mark.parametrize("case", list(CASES))
def test_reads_and_rebuilds_equal_the_reference(runs, case):
    ref, port = runs("ceph_tpu", case), runs("ceph_tpu_torch", case)
    assert [r[0] for r in port["reads"]] == [r[0] for r in ref["reads"]]
    assert [r[1] for r in port["reads"]] == [r[1] for r in ref["reads"]]
    assert [r[:2] for r in port["rebuilt"]] == \
        [r[:2] for r in ref["rebuilt"]]
    assert port["model"] == ref["model"]


@pytest.mark.parametrize("shard", range(7))
@pytest.mark.parametrize("case", list(CASES))
def test_shard_stores_equal_the_reference(runs, case, shard):
    """Every object of the shard's collection: its bytes, its xattrs
    (the hinfo and the version) and its omap."""
    ref, port = runs("ceph_tpu", case), runs("ceph_tpu_torch", case)
    if shard not in ref["stores"]:
        assert shard not in port["stores"]
        return
    assert sorted(port["stores"][shard]) == sorted(ref["stores"][shard])
    for oid, (data, attrs, omap) in ref["stores"][shard].items():
        p_data, p_attrs, p_omap = port["stores"][shard][oid]
        assert p_data == data, oid
        assert p_attrs == attrs, oid
        assert p_omap == omap, oid


@pytest.mark.parametrize("case", list(CASES))
def test_routes_logs_and_repairs_equal_the_reference(runs, case):
    """The same messages each step, the same PG logs on every OSD, the
    same shards repaired behind the faulted reads, the same repair
    accounting."""
    ref, port = runs("ceph_tpu", case), runs("ceph_tpu_torch", case)
    assert stable_routes(port) == stable_routes(ref)
    assert port["logs"] == ref["logs"]
    assert port["repaired"] == ref["repaired"]
    assert port["perf"] == ref["perf"]


@pytest.mark.parametrize("case", list(CASES))
def test_tier_steps_take_no_sub_reads(runs, case):
    """Reads and rebuilds of resident objects send no sub-read; the
    faulted reads repaired their shard."""
    out = runs("ceph_tpu_torch", case)
    assert "MOSDECSubOpRead" not in out["routes"]["tier_reads"]
    assert "MOSDECSubOpRead" not in out["routes"]["tier_rebuild"]
    assert out["routes"]["rebuild"].get("MOSDECSubOpRead", 0) + \
        out["routes"]["rebuild"].get("MOSDECSubOpRepairRead", 0) > 0
    assert len(out["repaired"]) >= 2


def test_compress_mode_compressed(runs):
    """Below the wrap both packages compress the low-entropy objects:
    the hinfo records the container."""
    out = runs("ceph_tpu_torch", "rs_compress")
    hinfos = [json.loads(attrs["hinfo_key"].decode())
              for _, attrs, _ in out["stores"][0].values()]
    assert any(h.get("comp_info") for h in hinfos)


def test_msr_rebuilds_through_helper_fractions(runs):
    """With the tier off, MSR rebuilds each shard from d = 6 helpers'
    fractions (d repair reads, no sub-read); a rebuild whose helper fails
    falls back to the survivors' decode (sub-reads)."""
    out = runs("ceph_tpu_torch", "msr")
    route = out["routes"]["rebuild"]
    # object i rebuilds shard i; the primary's own fraction (shard 0)
    # is computed in place, with no message
    assert route["MOSDECSubOpRepairRead"] == sum(
        6 - (shard != 0) for shard in range(4))
    assert "MOSDECSubOpRead" not in route
    fault = out["routes"]["repair_fault"]
    assert fault.get("MOSDECSubOpRead", 0) > 0     # the fallback decode


def test_port_compresses_a_4mib_object(one_torch_thread):
    """RS k=8, m=3 at stripe_unit 4096 in compress mode: the port stores
    a 4 MiB object of values 0..3 compressed (the reference, past its
    int32 wrap, stores it raw) and reads it back."""
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.osd.pg_transaction import PGTransaction
    codec = registry.factory("torch_cuda", {
        "technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"},
        device="cpu")
    lb, dispatchers = port_loopback(codec, "compress",
                                    width=stripe_width(codec, 4096))
    try:
        data = np.random.default_rng(21).integers(
            0, 4, 4 << 20, dtype=np.uint8).tobytes()
        t = PGTransaction()
        t.create("big")
        t.write("big", 0, data)
        lb.submit(t)
        hinfo = lb.primary.backend.get_hinfo("big")
        assert hinfo.comp_info is not None
        stored = lb.shard_store(0).read(lb.cid(0), "big")
        assert hinfo.comp_info["comp_len"] < len(data) // 2
        assert len(stored) == hinfo.get_total_chunk_size() < (4 << 20) // 8
        assert lb.read("big") == data
        assert lb.read("big", 12345, 100000) == data[12345:112345]
    finally:
        close(lb, dispatchers)


class _FaultyTier:
    """A tier whose get / reconstruct fail as told."""

    def __init__(self, tier, fail: str, exc):
        self.tier, self.fail, self.exc = tier, fail, exc

    def __getattr__(self, name):
        attr = getattr(self.tier, name)
        if name != self.fail:
            return attr

        def failing(*a, **kw):
            if self.exc is None:
                return None
            raise self.exc
        return failing


@pytest.mark.parametrize("plugin,fail,exc,propagates", [
    ("torch_cuda", "get", RuntimeError("device fault"), True),
    ("torch_cuda", "get", None, False),
    ("torch_cuda", "reconstruct", RuntimeError("device fault"), True),
    ("torch_cuda", "reconstruct", KeyError("evicted"), False),
    ("msr_cuda", "get", RuntimeError("device fault"), True),
    ("msr_cuda", "get", None, False),
], ids=["read-error", "read-miss", "rebuild-error", "rebuild-miss",
        "striped-error", "striped-miss"])
def test_tier_paths_propagate_all_but_a_miss(one_torch_thread, plugin,
                                             fail, exc, propagates):
    """The port's resident read and rebuild fall through to the
    sub-reads only on a miss (None, KeyError); any other error reaches
    the caller, where the reference would hide it behind the sub-read
    path."""
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.osd.pg_transaction import PGTransaction
    profile = MSR if plugin == "msr_cuda" else RS
    codec = registry.factory(plugin, dict(profile), device="cpu")
    lb, dispatchers = port_loopback(codec, None, hbm_serve_reads=True)
    try:
        data = np.random.default_rng(22).integers(
            0, 256, 4 * lb.primary.backend.sinfo.stripe_width,
            dtype=np.uint8).tobytes()
        t = PGTransaction()
        t.create("o")
        t.write("o", 0, data)
        lb.submit(t)
        daemon = lb.primary.daemon
        daemon.hbm_tier = _FaultyTier(daemon.hbm_tier, fail, exc)
        want_shard = lb.shard_store(1).read(lb.cid(1), "o")
        if fail == "get" and plugin == "torch_cuda":
            call = lambda: lb.read("o")               # noqa: E731
            want = data
        else:
            daemon.hbm_serve_reads = False
            call = lambda: lb.recover("o", 1)         # noqa: E731
            want = want_shard
        if propagates:
            with pytest.raises(RuntimeError, match="device fault"):
                call()
        else:
            before = lb.sent.get("MOSDECSubOpRead", 0) + \
                lb.sent.get("MOSDECSubOpRepairRead", 0)
            assert call() == want
            assert lb.sent.get("MOSDECSubOpRead", 0) + \
                lb.sent.get("MOSDECSubOpRepairRead", 0) > before
    finally:
        lb.errors.clear()
        close(lb, dispatchers)


def _mesh_trip():
    from ceph_tpu_torch.parallel.mesh import MeshChecksumError
    return MeshChecksumError("checksum mismatch")


def _unfit():
    from ceph_tpu_torch.errors import ErasureCodeError
    return ErasureCodeError(22, "fractions have unequal lengths")


@pytest.mark.parametrize("plugin,leg,exc,propagates", [
    ("torch_cuda", "recover_cross_chip", RuntimeError, True),
    ("torch_cuda", "recover_cross_chip", _mesh_trip, False),
    ("msr_cuda", "repair_cross_chip", RuntimeError, True),
    ("msr_cuda", "repair_cross_chip", _mesh_trip, False),
    ("msr_cuda", "repair_combine", RuntimeError, True),
    ("msr_cuda", "repair_combine", _unfit, False),
    ("msr_cuda", "repair_fraction", RuntimeError, True),
    ("msr_cuda", "repair_fraction", lambda: OSError(5, "EIO"), False),
], ids=["recover-error", "recover-miss", "cross-repair-error",
        "cross-repair-miss", "combine-error", "combine-miss",
        "fraction-error", "fraction-miss"])
def test_device_legs_propagate_all_but_a_miss(one_torch_thread,
                                              monkeypatch, plugin, leg,
                                              exc, propagates):
    """Recovery's cross-chip rebuild, the repair's cross-chip and
    dispatcher combines, and a helper's fraction fall back to the slower
    path only on a miss (a checksum trip, fractions that do not fit, a
    helper's read error); any other error, such as a failed launch on
    the card, reaches the caller, where the reference would reroute the
    work and hide it."""
    from ceph_tpu_torch import registry
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.pg_transaction import PGTransaction
    profile = MSR if plugin == "msr_cuda" else RS
    codec = registry.factory(plugin, dict(profile), device="cpu")
    lb, dispatchers = port_loopback(codec, None,
                                    dispatch_all=plugin == "msr_cuda")
    calls = []
    real = getattr(ec_util, leg)

    def failing(*a, **kw):
        # fails once: a repair behind a helper's error runs the leg again
        calls.append(leg)
        if len(calls) > 1:
            return real(*a, **kw)
        raise (exc("device fault") if exc is RuntimeError else exc())

    try:
        data = np.random.default_rng(23).integers(
            0, 256, 4 * lb.primary.backend.sinfo.stripe_width,
            dtype=np.uint8).tobytes()
        t = PGTransaction()
        t.create("o")
        t.write("o", 0, data)
        lb.submit(t)
        lb.primary.daemon.hbm_tier = None
        want = lb.shard_store(1).read(lb.cid(1), "o")
        monkeypatch.setattr(ec_util, leg, failing)
        if propagates:
            with pytest.raises(RuntimeError, match="device fault"):
                lb.recover("o", 1)
        else:
            assert lb.recover("o", 1) == want
        assert calls
    finally:
        lb.errors.clear()
        close(lb, dispatchers)
