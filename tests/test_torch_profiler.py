"""Device profiler of the PyTorch port, against the JAX package's.

``ceph_tpu_torch.common.profiler`` mirrors ``tests/test_profiler.py`` on
the reference: shape signatures (fresh = "compile", then cache hits;
scalars and keywords in the signature; the device in it, where the
reference puts its jax placement), the disabled path (one attribute
check: no signature is built, nothing is recorded), the recompile-storm
window and threshold, the memory ledger's watermarks and reset, and the
sections of ``dump``. Then the wired sites, each under the reference's
name: ``xor_mm.matrix_encode`` / ``matrix_encode_multi`` /
``bitmatrix_encode`` held call for call and signature for signature
against the reference's jitted entry points on the same inputs,
``matrix_base.bank_pick``, the decode-table ledger against the
reference's TableCache, the chunk tier's digest, per-lane rebuild and
ledger category against the reference's tier, the fused program and
``scrub_crc``, and the CRUSH sweeps. Tolerance: none (counts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu.common.profiler import PROFILER as REF_PROFILER
from ceph_tpu.crush import batched as jbatched
from ceph_tpu.crush import map as jmap
from ceph_tpu.models.table_cache import TableCache as RefTableCache
from ceph_tpu.ops import xor_mm as jxor
from ceph_tpu.osd import hbm_tier as jtier
from ceph_tpu_torch import registry
from ceph_tpu_torch.common import profiler
from ceph_tpu_torch.common.profiler import PROFILER, DeviceProfiler
from ceph_tpu_torch.crush import batched
from ceph_tpu_torch.crush import map as pmap
from ceph_tpu_torch.models.table_cache import TableCache
from ceph_tpu_torch.ops import gf, xor_mm
from ceph_tpu_torch.osd import fused_transform as ft
from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier

from .torch_crush_maps import SEEDS, bench_map, bench_reweight
from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RS = {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "8"}


@pytest.fixture
def prof():
    """The process-wide registry, reset around each test (the reference's
    is reset by the suite's conftest)."""
    PROFILER.reset()
    PROFILER.enabled = True
    yield PROFILER
    PROFILER.reset()


def counts(doc, name):
    k = doc["kernels"][name]
    return k["compiles"], k["cache_hits"], k["num_signatures"]


# -- the registry (ref tests/test_profiler.py) ----------------------------

def test_fresh_signature_is_compile_then_cache_hits():
    p = DeviceProfiler()
    calls = []
    fn = p.wrap_kernel("t.k", lambda x: calls.append(x) or x.sum())
    a = torch.zeros((2, 4), dtype=torch.uint8)
    fn(a)
    fn(a)
    fn(torch.ones((2, 4), dtype=torch.uint8))   # same signature: a hit
    k = p.dump()["kernels"]["t.k"]
    assert (k["compiles"], k["cache_hits"], k["num_signatures"]) == (1, 2, 1)
    assert k["compile_wall_s"] >= 0
    assert len(calls) == 3                     # the wrapped fn always runs


def test_distinct_shapes_dtypes_and_devices_are_distinct_signatures():
    p = DeviceProfiler()
    fn = p.wrap_kernel("t.k", lambda x: x)
    for n in (1, 2, 3):
        fn(torch.zeros(n, dtype=torch.uint8))
    fn(torch.zeros(2, dtype=torch.uint8))      # revisit: a hit
    fn(torch.zeros(2, dtype=torch.int32))      # another dtype
    fn(torch.zeros(2, dtype=torch.uint8, device="meta"))   # another device
    fn(np.zeros(2, np.uint8))                  # a host array: no device
    k = p.dump()["kernels"]["t.k"]
    assert (k["compiles"], k["cache_hits"], k["num_signatures"]) == (6, 1, 6)
    sigs = [s["sig"] for s in k["signatures"]]
    assert "((2,), 'torch.uint8', 'meta'),)" in " ".join(sigs)
    assert "((2,), 'uint8'),)" in " ".join(sigs)


def test_scalars_and_kwargs_participate_in_signature():
    p = DeviceProfiler()
    fn = p.wrap_kernel("t.k", lambda x, n=0: x)
    a = torch.zeros(4, dtype=torch.uint8)
    fn(a, n=1)
    fn(a, n=2)                                 # a static arg changed
    fn(a, n=1)                                 # seen: a hit
    fn(a, n=np.int64(5))                       # numpy integers key on type
    fn(a, n=np.int64(6))
    k = p.dump()["kernels"]["t.k"]
    assert (k["compiles"], k["cache_hits"]) == (3, 2)


def test_disabled_profiler_is_one_attribute_check(monkeypatch):
    p = DeviceProfiler()
    p.enabled = False
    fn = p.wrap_kernel("t.k", lambda x: x * 2)
    monkeypatch.setattr(profiler, "_shape_sig", None)   # never reached
    out = fn(torch.full((3,), 7, dtype=torch.uint8))
    assert (out == 14).all()
    assert p.dump()["kernels"] == {}
    p.mem_add("hbm_tier", 100)
    assert p.mem_dump()["total_bytes"] == 0
    assert fn.__wrapped__(torch.ones(1)) == 2 and fn.__name__ == "<lambda>"


def test_the_wrapper_never_synchronises(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the profiler touched the device")
    for name in ("synchronize", "current_stream", "Event"):
        monkeypatch.setattr(torch.cuda, name, boom)
    p = DeviceProfiler()
    fn = p.wrap_kernel("t.k", lambda x: x + 1)
    for _ in range(3):
        fn(torch.zeros(8))
    assert counts(p.dump(), "t.k") == (1, 2, 1)


def test_storm_trips_at_threshold_within_window():
    p = DeviceProfiler(recompile_window=60.0, recompile_threshold=3)
    churn = p.wrap_kernel("churny", lambda x: x)
    stable = p.wrap_kernel("stable", lambda x: x)
    stable(torch.zeros(8))
    for n in range(1, 5):
        churn(torch.zeros(n))
    rep = p.storm_report()
    assert rep["storming"] and rep["kernel"] == "churny"
    assert rep["count"] == 4 and p.storm_count() == 4
    calm = DeviceProfiler(recompile_threshold=10)
    fn = calm.wrap_kernel("calm", lambda x: x)
    for n in range(1, 4):
        fn(torch.zeros(n))
    assert not calm.storm_report()["storming"] and calm.storm_count() == 0


def test_storm_events_expire_and_reset():
    import time
    p = DeviceProfiler(recompile_window=0.5, recompile_threshold=2)
    p.record_compile("old", ("sig",), 0.0)
    assert counts(p.dump(), "old") == (1, 0, 1)
    rep = p.storm_report(now=time.monotonic() + 1.0)
    assert rep["count"] == 0 and not rep["storming"]
    p.recompile_threshold = 1
    assert p.storm_count() == 1
    p.reset()
    assert p.storm_count() == 0 and p.dump()["kernels"] == {}


def test_configure_reads_the_osd_profiler_keys():
    from ceph_tpu.common.config import Config
    p = DeviceProfiler()
    p.configure(Config({"osd_profiler": False,
                        "osd_profiler_recompile_window": 5.0,
                        "osd_profiler_recompile_threshold": 7}))
    assert (p.enabled, p.recompile_window, p.recompile_threshold) == \
        (False, 5.0, 7)
    p.configure(object())                      # no get_val: unchanged
    assert p.recompile_threshold == 7


def test_mem_ledger_watermarks_as_the_reference():
    from ceph_tpu.common.profiler import DeviceProfiler as RefProfiler
    docs = []
    for cls in (DeviceProfiler, RefProfiler):
        p = cls()
        p.mem_add("staging_ring", 100)
        p.mem_add("staging_ring", 50)
        p.mem_sub("staging_ring", 120)
        p.mem_add("donated_buffers", 10)
        p.mem_sub("donated_buffers", 999)      # floors at zero
        p.mem_set("decode_tables", 400)
        p.mem_set("decode_tables", 100)        # a gauge
        p.mem_add("hbm_tier", 500)
        p.mem_sub("hbm_tier", 300)
        before = p.mem_dump()
        p.reset()                              # rebases the watermarks
        docs.append((before, p.mem_dump()))
    assert docs[0] == docs[1]
    before, after = docs[0]
    assert before["staging_ring"] == {"bytes": 30, "high_watermark": 150}
    assert before["decode_tables"] == {"bytes": 100, "high_watermark": 400}
    assert before["donated_buffers"]["bytes"] == 0
    assert after["hbm_tier"] == {"bytes": 200, "high_watermark": 200}
    assert after["total_bytes"] == 330
    assert set(profiler.MEM_CATEGORIES) == {
        "hbm_tier", "staging_ring", "donated_buffers", "decode_tables"}


def test_dump_carries_every_section():
    p = DeviceProfiler()
    p.wrap_kernel("k", lambda x: x)(torch.zeros(2))
    p.mem_add("hbm_tier", 1)
    doc = p.dump()
    assert doc["enabled"] is True
    assert set(doc) == {"enabled", "kernels", "recompile_storm", "memory"}
    assert set(doc["kernels"]["k"]) == {"compiles", "compile_wall_s",
                                        "cache_hits", "signatures",
                                        "num_signatures"}
    assert set(doc["kernels"]["k"]["signatures"][0]) == {
        "sig", "compiles", "compile_wall_s", "cache_hits"}
    assert set(doc["recompile_storm"]) == {"kernel", "count", "window_s",
                                           "threshold", "storming"}


# -- the wired sites --------------------------------------------------------

def _gf_inputs(rng):
    coding = gf.rs_vandermonde_generator(4, 2, 8)
    enc = gf.generator_to_bitmatrix(coding, 8)
    dec = rng.integers(0, 2, (48, 32), dtype=np.uint8)
    datas = [rng.integers(0, 256, shape, dtype=np.uint8)
             for shape in ((2, 4, 64), (2, 4, 64), (3, 4, 64))]
    return enc, dec, datas


def test_xor_mm_entry_points_count_as_the_reference(prof):
    rng = np.random.default_rng(1)
    enc, dec, datas = _gf_inputs(rng)
    for bm in (enc, dec, enc):
        for d in datas:
            xor_mm.matrix_encode(torch.from_numpy(bm), torch.from_numpy(d), 8)
            jxor.matrix_encode(jnp.asarray(bm), jnp.asarray(d), 8)
    assert counts(PROFILER.dump(), "xor_mm.matrix_encode") == \
        counts(REF_PROFILER.dump(), "xor_mm.matrix_encode") == (4, 5, 4)
    lanes = np.stack([enc, enc])
    multi = rng.integers(0, 256, (2, 1, 4, 64), dtype=np.uint8)
    for _ in range(2):
        xor_mm.matrix_encode_multi(torch.from_numpy(lanes),
                                   torch.from_numpy(multi), 8)
        jxor.matrix_encode_multi(jnp.asarray(lanes), jnp.asarray(multi), 8)
    mine, theirs = PROFILER.dump(), REF_PROFILER.dump()
    assert counts(mine, "xor_mm.matrix_encode_multi") == \
        counts(theirs, "xor_mm.matrix_encode_multi") == (1, 1, 1)
    # the reference's per-lane program traces its lanes through the
    # wrapped matrix_encode once, which counts one more signature there;
    # the port's per-lane kernel is one entry point
    assert counts(mine, "xor_mm.matrix_encode") == (4, 5, 4)
    assert counts(theirs, "xor_mm.matrix_encode") == (5, 5, 5)


def test_packet_layout_counts_as_the_reference(prof):
    prof_ = {"technique": "cauchy_good", "k": "3", "m": "2", "w": "8",
             "packetsize": "8"}
    jc = jregistry.factory("jax_tpu", dict(prof_))
    pc = registry.factory("torch_cuda", dict(prof_), device="cpu")
    n = pc.get_chunk_size(3 * 64)
    data = np.random.default_rng(2).integers(0, 256, (2, 3, n), np.uint8)
    full = np.concatenate([data, np.asarray(jc.encode_batch(data))], axis=1)
    REF_PROFILER.reset()
    for codec in (pc, jc):
        codec.encode_batch(data)
        codec.encode_batch(data)
        # two signatures, whose decode bitmatrices set different bit counts
        for avail in ((0, 1, 2), (2, 3, 4), (0, 3, 4)):
            codec.decode_batch(avail, np.ascontiguousarray(
                full[:, list(avail)]))
    assert counts(PROFILER.dump(), "xor_mm.bitmatrix_encode") == \
        counts(REF_PROFILER.dump(), "xor_mm.bitmatrix_encode") == (2, 3, 2)


def test_bank_pick_counts_as_the_reference(prof):
    jc = jregistry.factory("jax_tpu", dict(RS))
    pc = registry.factory("torch_cuda", dict(RS), device="cpu")
    data = np.random.default_rng(3).integers(0, 256, (1, 4, 64), np.uint8)
    full = np.concatenate([data, np.asarray(jc.encode_batch(data))], axis=1)
    for codec in (pc, jc):
        for avail in ((0, 1, 2, 3), (2, 3, 4, 5), (0, 1, 2, 3)):
            codec.decode_batch(avail, np.ascontiguousarray(
                full[:, list(avail)]))
    assert counts(PROFILER.dump(), "matrix_base.bank_pick") == \
        counts(REF_PROFILER.dump(), "matrix_base.bank_pick") == (1, 1, 1)


def test_shec_bank_pick_is_counted(prof):
    codec = registry.factory("shec_cuda", {"k": "4", "m": "3", "c": "2"},
                             device="cpu")
    n = codec.get_chunk_size(4 * 64)
    chunks = np.zeros((1, 5, n), np.uint8)
    codec.decode_batch((0, 1, 2, 4, 5), chunks)
    codec.decode_batch((1, 2, 3, 4, 6), chunks)
    assert counts(PROFILER.dump(), "matrix_base.bank_pick") == (1, 1, 1)


def test_decode_table_ledger_as_the_reference(prof):
    rng = np.random.default_rng(4)
    for p in (PROFILER, REF_PROFILER):     # earlier tests' caches: rebase
        p.mem_set("decode_tables", 0)
        p.reset()
    mine, theirs = TableCache(capacity=2), RefTableCache(capacity=2)
    seen = []
    for sig in range(3):
        entry = {"gf": rng.integers(0, 256, (6, 4), np.uint8),
                 "bitmat": rng.integers(0, 2, (48, 32 + 8 * sig), np.uint8),
                 "mat": np.zeros(3 + sig, np.uint8)}
        mine.put((sig,), dict(entry))
        theirs.put((sig,), dict(entry))
        seen.append((PROFILER.mem_dump()["decode_tables"],
                     REF_PROFILER.mem_dump()["decode_tables"]))
    mine.clear()
    theirs.clear()
    seen.append((PROFILER.mem_dump()["decode_tables"],
                 REF_PROFILER.mem_dump()["decode_tables"]))
    assert all(a == b for a, b in seen)
    assert seen[-2][0]["bytes"] == 48 * 40 + 4 + 48 * 48 + 5   # one evicted
    assert seen[-1][0]["bytes"] == 0


def test_tier_digest_rebuild_and_ledger_as_the_reference(prof):
    import jax
    jc = jregistry.factory("jax_tpu", dict(RS))
    pc = registry.factory("torch_cuda", dict(RS), device="cpu")
    cat = "hbm_tier[cpu:0]"
    for p in (PROFILER, REF_PROFILER):     # earlier tests' tiers: rebase
        p.mem_set(cat, 0)
        p.reset()
    mine = HbmChunkTier(pc, capacity_objects=4, device="cpu")
    theirs = jtier.HbmChunkTier(jc, capacity_objects=4,
                                device=jax.devices()[0])
    data = np.random.default_rng(5).integers(0, 256, (3, 4, 256), np.uint8)
    names = ["a", "b", "c"]
    for tier in (mine, theirs):
        tier.put_encode(names, data)
        tier.deep_scrub(names)
        tier.deep_scrub(names[:2])
        tier.reconstruct_batch(names, [0, 3, 5])
        tier.drop("c")
    m, t = PROFILER.dump(), REF_PROFILER.dump()
    assert counts(m, "xor_mm.matrix_encode_multi") == \
        counts(t, "xor_mm.matrix_encode_multi") == (1, 0, 1)
    # the reference's signature keys on the gathered [objects, k+m, n]
    # array, so two scrub sizes are two signatures; the port's digest
    # reads the objects where they lie through lists (one signature)
    assert counts(t, "hbm_tier.digest") == (2, 0, 2)
    assert counts(m, "hbm_tier.digest") == (1, 1, 1)
    assert m["memory"][cat] == t["memory"][cat]
    assert m["memory"][cat]["bytes"] == mine.stats()["resident_bytes"] \
        == 2 * 6 * data.shape[2]
    assert HbmChunkTier(pc, device=torch.device("cpu"))._mem_category == cat


def test_fused_program_and_scrub_crc(prof):
    codec = registry.factory("torch_cuda", dict(RS), device="cpu")
    batch = np.random.default_rng(6).integers(0, 4, (2, 4, 256), np.uint8)
    ft.run_fused(codec, batch)
    ft.run_fused(codec, batch)
    ft.run_fused(codec, batch, mode="compress")
    ft.device_crc32(b"scrub me", device="cpu")
    doc = PROFILER.dump()
    assert counts(doc, "fused_transform.program") == (2, 1, 2)
    assert counts(doc, "fused_transform.scrub_crc") == (1, 0, 1)
    # the write's encode is the program's (the reference inlines it)
    assert "xor_mm.matrix_encode" not in doc["kernels"]


@pytest.mark.parametrize("ruleno,name", [(0, "crush.indep"),
                                         (1, "crush.firstn")])
def test_crush_sweeps_are_counted(prof, ruleno, name):
    cmap = bench_map(pmap)
    ref_out = jbatched.batched_do_rule(bench_map(jmap), ruleno, SEEDS[:64],
                                       5, bench_reweight("plain"))
    out = batched.batched_do_rule(cmap, ruleno, SEEDS[:64], 5,
                                  bench_reweight("plain"), device="cpu")
    batched.batched_do_rule(cmap, ruleno, SEEDS[64:128], 5,
                            bench_reweight("plain"), device="cpu")
    batched.batched_do_rule(cmap, ruleno, SEEDS[:32], 5,
                            bench_reweight("plain"), device="cpu")
    assert np.array_equal(out, np.asarray(ref_out))
    assert counts(PROFILER.dump(), name) == (2, 1, 2)
    assert counts(REF_PROFILER.dump(), name) == (1, 0, 1)
