"""The port's native seam against the JAX package's.

``ceph_tpu_torch.native`` (the runtime built by the port into
``ceph_tpu_torch/build/native/``) against ``ceph_tpu.native`` (the same
sources built by ``native/Makefile``) on the same seeded inputs:
``NativeCodec`` over tests/test_native.py's techniques (encode, decode,
``minimum_to_decode``, the profile echo, chunk sizes and the chunk
mapping, all byte-equal), the four broken-plugin fixtures and the
reference's error fragments, the GF region kernels forced to the scalar
ISA against the vector one, the host CRUSH mapper (one seed and a batch,
choose_args included) against the reference's and the port's
``mapper_ref``, the batching bridge on ``device="cpu"`` (the plain
version behind the same dispatcher the card runs), ``update(native=True)``
and ``calc_pg_upmaps(use_native=True)`` against the reference's, and the
port-built ``ec_benchmark``'s output. Tolerance: none.
"""

import concurrent.futures
import shutil
import subprocess

import numpy as np
import pytest

from ceph_tpu import native as rn
from ceph_tpu.crush import map as jcmap
from ceph_tpu.osd import balancer as jbal
from ceph_tpu.osd import osd_map as J
from ceph_tpu_torch import native as pn
from ceph_tpu_torch.crush import map as pcmap
from ceph_tpu_torch.crush import mapper_ref
from ceph_tpu_torch.osd import balancer as pbal
from ceph_tpu_torch.osd import osd_map as P

from .torch_crush_maps import bench_map, bench_reweight
from .torch_util import one_torch_thread  # noqa: F401
from .test_torch_osd_map import (PORT, REF, assert_mappings_equal,
                                 two_pool_map)

pytestmark = [
    pytest.mark.skipif(shutil.which("c++") is None and
                       shutil.which("g++") is None,
                       reason="no C++ toolchain"),
    pytest.mark.usefixtures("one_torch_thread", "runtimes")]

TECHNIQUES = ["reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good"]


@pytest.fixture(scope="module")
def runtimes():
    pn.lib()
    rn.lib()


def _profile(technique):
    k, m = (4, 2) if technique == "reed_sol_r6_op" else (5, 3)
    return {"technique": technique, "k": str(k), "m": str(m), "w": "8"}


# -- NativeCodec --------------------------------------------------------------

@pytest.mark.parametrize("technique", TECHNIQUES)
def test_native_codec_matches_reference(technique):
    prof = _profile(technique)
    mine = pn.NativeCodec("jerasure", dict(prof))
    ref = rn.NativeCodec("jerasure", dict(prof))
    assert (mine.k, mine.m) == (ref.k, ref.m)
    assert mine.get_profile() == ref.get_profile()
    assert mine.chunk_mapping() == ref.chunk_mapping()
    for size in (1, 1000, 4096, 100003, 1 << 20):
        assert mine.get_chunk_size(size) == ref.get_chunk_size(size)
    rng = np.random.default_rng(16)
    data = rng.integers(0, 256, 9473, dtype=np.uint8).tobytes()
    enc = mine.encode(data)
    assert enc == ref.encode(data)
    n = mine.k + mine.m
    for lost in ([0], list(range(mine.m)), [1, n - 1]):
        avail = {i: enc[i] for i in enc if i not in lost}
        got = mine.decode(avail, want=lost)
        assert got == ref.decode(avail, want=lost)
        assert got == {i: enc[i] for i in lost}
        assert mine.minimum_to_decode(lost, sorted(avail)) == \
            ref.minimum_to_decode(lost, sorted(avail))
    bs = mine.get_chunk_size(len(data))
    chunks = np.frombuffer(b"".join(enc[i] for i in range(n)),
                           dtype=np.uint8).reshape(n, bs)
    parity = np.zeros((mine.m, bs), dtype=np.uint8)
    mine.encode_chunks(chunks[:mine.k], parity)
    assert np.array_equal(parity, chunks[mine.k:])
    rows = list(range(1, n))
    out = np.zeros((n, bs), dtype=np.uint8)
    mine.decode_chunks(rows, chunks[rows], out)
    assert np.array_equal(out, chunks)


@pytest.mark.parametrize("name,errfrag", [
    ("missing_version", "__erasure_code_version"),
    ("missing_entry_point", "__erasure_code_init"),
    ("fail_to_initialize", "erasure_code_init"),
    ("fail_to_register", "did not register"),
    ("no_such_plugin", "dlopen"),
])
def test_broken_plugin(name, errfrag):
    with pytest.raises(OSError) as ei:
        pn.NativeCodec(name, {"k": "2", "m": "1"})
    assert errfrag in str(ei.value)
    assert str(rn.BUILD_DIR) not in str(ei.value)    # the port's own


def test_codec_errors_match_reference():
    for mod in (pn, rn):
        with pytest.raises(OSError, match="not a valid coding technique"):
            mod.NativeCodec("jerasure", {"technique": "bogus", "k": "2",
                                         "m": "1"})
        nat = mod.NativeCodec("jerasure", {"k": "3", "m": "2", "w": "8"})
        enc = nat.encode(b"q" * 300)
        with pytest.raises(OSError):
            nat.decode({0: enc[0], 1: enc[1], 99: enc[2]}, want=[2])
    with pytest.raises(OSError):
        pn.NativeCodec("jerasure", {"technique": "reed_sol_r6_op",
                                    "k": "4", "m": "3",
                                    "mapping": "D_DDD__"})


# -- the GF region kernels' ISA dispatch --------------------------------------

def test_forced_scalar_matches_vector_and_reference():
    default = pn.gf_isa()
    assert default == rn.gf_isa()
    assert not pn.gf_set_isa("avx512")
    rng = np.random.default_rng(3)
    src = rng.integers(0, 256, size=100003, dtype=np.uint8)
    base = rng.integers(0, 256, size=100003, dtype=np.uint8)
    prof = {"technique": "reed_sol_van", "k": "5", "m": "3", "w": "8"}
    data = bytes(range(256)) * 41
    results, encs = {}, {}
    try:
        for isa in ("scalar", "ssse3", "avx2"):
            if not pn.gf_set_isa(isa):
                continue
            assert pn.gf_isa() == isa
            for g in (1, 2, 0x53, 0xFF):
                dst = base.copy()
                pn.gf_region_madd(dst, src, g, w=8)
                results.setdefault(g, {})[isa] = dst
            encs[isa] = pn.NativeCodec("jerasure", dict(prof)).encode(data)
    finally:
        pn.gf_set_isa(default)
    assert "scalar" in encs and len(encs) > 1 or default == "scalar"
    for g, per_isa in results.items():
        ref = base.copy()
        rn.gf_region_madd(ref, src, g, w=8)
        for isa, dst in per_isa.items():
            assert np.array_equal(dst, ref), (g, isa)
    for isa, enc in encs.items():
        assert enc == encs["scalar"], isa
    with pytest.raises(ValueError):
        pn.gf_region_madd(base.copy(), src[:-1], 3)


# -- the host CRUSH mapper ----------------------------------------------------

def _maps():
    return bench_map(jcmap), bench_map(pcmap)


def _choose_args(rng, hosts=8, per=4):
    cargs = {-1: {"ids": [int(i) - 20 for i in rng.permutation(hosts)],
                  "weight_set": [[int(w) for w in rng.integers(
                      0x4000, 4 * 0x10000, size=hosts)] for _ in range(2)]}}
    for h in range(hosts):
        cargs[-2 - h] = {"ids": None, "weight_set": [[int(w) for w in
                         rng.integers(0x4000, 2 * 0x10000, size=per)]]}
    return cargs


@pytest.mark.parametrize("kind", ["full", "half", "short"])
def test_crush_native_matches_reference_and_mapper_ref(kind):
    ref_map, my_map = _maps()
    weight = bench_reweight(kind)
    cargs = _choose_args(np.random.default_rng(41))
    xs = list(range(0, 3000, 7))
    for ruleno, numrep in ((0, 5), (1, 3)):
        for args in (None, cargs, None):      # set, switch, clear
            batch = pn.crush_do_rule_batch_native(my_map, ruleno, xs, numrep,
                                                  weight, choose_args=args)
            assert batch == rn.crush_do_rule_batch_native(
                ref_map, ruleno, xs, numrep, weight, choose_args=args)
            for x in xs[:40]:
                want = mapper_ref.crush_do_rule(my_map, ruleno, x, numrep,
                                                weight, choose_args=args)
                assert pn.crush_do_rule_native(
                    my_map, ruleno, x, numrep, weight,
                    choose_args=args) == want == batch[xs.index(x)]
    assert pn.crush_do_rule_native(my_map, 7, 1, 3) == []
    assert pn.crush_do_rule_batch_native(my_map, 7, [1, 2], 3) == [[], []]


@pytest.mark.parametrize("alg", ["list", "uniform"])
def test_crush_native_other_algs(alg):
    maps = []
    for mod in (jcmap, pcmap):
        m = mod.CrushMap()
        m.type_names = {"osd": 0, "root": 1}
        m.add_bucket(alg, 1, list(range(6)), [0x10000] * 6, id=-1)
        m.add_rule(mod.Rule(steps=[("take", -1), ("choose_indep", 3, 0),
                                   ("emit",)]))
        maps.append(m)
    xs = list(range(300))
    got = pn.crush_do_rule_batch_native(maps[1], 0, xs, 3)
    assert got == rn.crush_do_rule_batch_native(maps[0], 0, xs, 3)
    assert got == [mapper_ref.crush_do_rule(maps[1], 0, x, 3) for x in xs]
    maps[1].buckets[-1].alg = "tree"
    with pytest.raises(pn.NativeUnavailable):
        pn.crush_do_rule_native(maps[1], 0, 1, 3)


# -- the bridge on the CPU ----------------------------------------------------

def test_bridge_without_dispatcher_fails():
    pn.uninstall_dispatcher()
    with pytest.raises(OSError) as ei:
        pn.bridge_encode(2, 1, 8, "reed_sol_van", [b"a" * 64, b"b" * 64])
    assert ei.value.errno == 11


def test_bridge_batches_match_native_codec():
    k, m = 8, 3
    prof = {"technique": "reed_sol_van", "k": str(k), "m": str(m), "w": "8"}
    ref = rn.NativeCodec("jerasure", dict(prof))
    rng = np.random.default_rng(8)
    objs = [rng.integers(0, 256, k * 4096, dtype=np.uint8).tobytes()
            for _ in range(8)]
    encs = [ref.encode(o) for o in objs]
    dispatch = pn.install_cuda_dispatcher(max_batch=8, max_delay_us=20000,
                                          device="cpu")
    try:
        b0 = pn.lib().ec_tpu_batches_dispatched()
        r0 = pn.lib().ec_tpu_requests_dispatched()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(pn.bridge_encode, k, m, 8, "reed_sol_van",
                                [enc[j] for j in range(k)]) for enc in encs]
            results = [f.result(timeout=120) for f in futs]
        batches = pn.lib().ec_tpu_batches_dispatched() - b0
    finally:
        pn.uninstall_dispatcher()
    for enc, parity in zip(encs, results):
        assert parity == [enc[k + j] for j in range(m)]
    assert pn.lib().ec_tpu_requests_dispatched() - r0 == 8
    assert 1 <= batches < 8 and dispatch.batches == batches
    assert list(dispatch.codecs) == [(k, m, 8, b"reed_sol_van")]
    assert dispatch.codecs[(k, m, 8, b"reed_sol_van")].device.type == "cpu"


def test_bridge_failure_carries_the_text():
    pn.install_cuda_dispatcher(max_batch=4, max_delay_us=0, device="cpu")
    try:
        with pytest.raises(OSError) as ei:
            pn.bridge_encode(2, 1, 8, "bogus", [b"a" * 64, b"b" * 64])
    finally:
        pn.uninstall_dispatcher()
    assert ei.value.errno == 5
    assert "bogus" in str(ei.value) and "ErasureCodeError" in str(ei.value)


def test_bridge_dispatcher_needs_cuda_unless_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pn.install_cuda_dispatcher()


# -- update(native=True) and calc_pg_upmaps(use_native=True) ------------------

def test_update_native_matches_reference():
    ref_map, my_map = two_pool_map(REF, pg_num=48), two_pool_map(PORT,
                                                                 pg_num=48)
    ref = J.OSDMapMapping()
    ref.update(ref_map, native=True)
    mine = P.OSDMapMapping()
    mine.update(my_map, native=True)
    assert_mappings_equal(ref, mine)
    assert {p: s["path"] for p, s in mine.split.items()} == \
        {1: "native", 2: "native"}
    assert all(0 <= s["mapper_ms"] <= s["sweep_ms"]
               for s in mine.split.values())
    plain = P.OSDMapMapping()
    plain.update(my_map, device="cpu")
    assert_mappings_equal(ref, plain)
    for pool_id in my_map.pools:
        assert np.array_equal(mine.raw[pool_id], plain.raw[pool_id])


def test_update_native_falls_back_only_on_unavailable(monkeypatch):
    m = two_pool_map(PORT, pg_num=16)

    def unavailable(*a, **kw):
        raise pn.NativeUnavailable("no compiler")

    monkeypatch.setattr(pn, "crush_do_rule_batch_arrays", unavailable)
    mine = P.OSDMapMapping()
    mine.update(m, native=True, device="cpu")
    assert {s["path"] for s in mine.split.values()} == {"device"}

    def broken(*a, **kw):
        raise ValueError("a fault of the mapper")

    monkeypatch.setattr(pn, "crush_do_rule_batch_arrays", broken)
    with pytest.raises(ValueError, match="fault"):
        P.OSDMapMapping().update(m, native=True, device="cpu")


def test_calc_pg_upmaps_native_matches_reference():
    maps = [two_pool_map(REF, pg_num=32), two_pool_map(PORT, pg_num=32)]
    kw = dict(max_changes=12, changes_per_sweep=4)
    ref = jbal.calc_pg_upmaps(maps[0], use_native=True, **kw)
    mine = pbal.calc_pg_upmaps(maps[1], use_native=True, **kw)
    key = (lambda pg: (pg.pool, pg.ps))
    assert (mine.num_changed, mine.start_deviation, mine.end_deviation,
            mine.sweeps) == (ref.num_changed, ref.start_deviation,
                             ref.end_deviation, ref.sweeps)
    assert [(key(pg), list(p)) for pg, p in mine.new_pg_upmap_items.items()] \
        == [(key(pg), list(p)) for pg, p in ref.new_pg_upmap_items.items()]
    assert [key(pg) for pg in mine.old_pg_upmap_items] == \
        [key(pg) for pg in ref.old_pg_upmap_items]
    dist = pbal.eval_distribution(maps[1], use_native=True)
    rdist = jbal.eval_distribution(maps[0], use_native=True)
    assert (dist.pg_counts, dist.total_deviation) == \
        (rdist.pg_counts, rdist.total_deviation)
    assert pbal.measure_sweep(maps[1], False, use_native=True) > 0


# -- ec_benchmark -------------------------------------------------------------

def test_port_built_ec_benchmark_output_contract():
    out = subprocess.run(
        [str(pn.BUILD_DIR / "ec_benchmark"), "-p", "jerasure",
         "-d", str(pn.BUILD_DIR), "-w", "encode", "-s", "65536",
         "-i", "3", "-P", "k=4", "-P", "m=2"],
        capture_output=True, text=True, check=True).stdout
    secs, rest = out.strip().split("\t")
    float(secs)
    assert rest == "%d (KiB)" % (3 * 64)
    for workload in ("decode", "decode_chunks"):
        subprocess.run(
            [str(pn.BUILD_DIR / "ec_benchmark"), "-p", "jerasure",
             "-d", str(pn.BUILD_DIR), "-w", workload, "-s", "65536",
             "-i", "3", "-e", "2", "-P", "k=6", "-P", "m=3"],
            capture_output=True, check=True)
    bad = subprocess.run(
        [str(pn.BUILD_DIR / "ec_benchmark"), "-p", "no_such_plugin",
         "-d", str(pn.BUILD_DIR)], capture_output=True, text=True)
    assert bad.returncode == 1 and "dlopen" in bad.stderr


# -- the build ----------------------------------------------------------------

def test_build_is_current_and_renames_what_plugins_import(tmp_path,
                                                          monkeypatch):
    assert pn.build() is None                  # every artifact up to date
    renamed = pn.renamed_symbols()
    assert "ectpu_registry_add" in renamed and "ec_codec_create" in renamed
    assert not pn.DLSYM_NAMES & set(renamed)
    assert not [s for s in renamed if s.startswith("ec_crush")]
    newer = tmp_path / "newer.h"
    newer.write_text("")
    monkeypatch.setattr(pn, "_inputs", lambda: [newer])
    assert pn._stale()                         # a newer input rebuilds


def test_build_failure_raises_native_unavailable(monkeypatch):
    stale = pn._stale
    monkeypatch.setattr(pn, "_stale", lambda: True)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(pn.NativeUnavailable, match="compile failed"):
        pn.build()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(pn.NativeUnavailable, match="no .*c\\+\\+"):
        pn.build()
    assert not stale()                         # the artifacts are intact
