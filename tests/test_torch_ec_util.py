"""ec_util and the dispatcher's fused leg of the PyTorch port, against the
JAX package.

``ceph_tpu_torch.osd.ec_util`` (StripeInfo, encode, encode_fused, decode,
decode_concat, HashInfo) on codecs made with ``device="cpu"`` against
``ceph_tpu.osd.ec_util`` on the same payloads, made from a numpy seed;
then ``GpuDispatcher.fused_write`` on the CPU device against the direct
path; and ``recover_cross_chip`` (reed_sol_van w=8 and w=16, cauchy_good)
and ``repair_cross_chip`` (MSR k=4) on meshes of ``["cpu"] * 4`` and
through a rateless dispatcher of 4 CPU workers against the JAX package's
over its virtual devices, their checksums tripping on a corrupted byte,
and None where the reference returns None. Tolerance: none (bytes, crcs
and sizes are exact).
"""

import functools
import random
import threading
import zlib

import numpy as np
import pytest

from ceph_tpu.osd import ec_util as jec
from ceph_tpu_torch import registry
from ceph_tpu_torch.errors import ErasureCodeError
from ceph_tpu_torch.osd import ec_util as ec
from ceph_tpu_torch.parallel import mesh as pmesh, rateless
from ceph_tpu_torch.parallel.mesh import MeshChecksumError
from ceph_tpu_torch.osd import fused_transform as ft
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher

from .torch_fused_ref import jax_codec, make_batch, port_codec
from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPE = (4, 2, 256)           # [S, k, chunk]: the fused tests' shape


def sinfos():
    k, chunk = SHAPE[1], SHAPE[2]
    return ec.StripeInfo(k, k * chunk), jec.StripeInfo(k, k * chunk)


def payload(kind, stripes=SHAPE[0], seed=0):
    return make_batch((stripes,) + SHAPE[1:], kind, seed).tobytes()


def test_stripe_info_matches_jax():
    mine, ref = ec.StripeInfo(4, 4 * 96), jec.StripeInfo(4, 4 * 96)
    for off in (0, 1, 95, 384, 385, 1000, 4 * 384):
        for name in ("logical_to_prev_chunk_offset",
                     "logical_to_next_chunk_offset",
                     "logical_to_prev_stripe_offset",
                     "logical_to_next_stripe_offset",
                     "logical_offset_is_stripe_aligned"):
            assert getattr(mine, name)(off) == getattr(ref, name)(off)
        assert mine.offset_len_to_stripe_bounds((off, 77)) == \
            ref.offset_len_to_stripe_bounds((off, 77))
    with pytest.raises(ValueError):
        ec.StripeInfo(3, 100)


def test_encode_and_decode_match_jax():
    si, jsi = sinfos()
    codec, jcodec = port_codec(2, 1), jax_codec(2, 1)
    data = payload("random")
    shards = ec.encode(si, codec, data)
    ref = jec.encode(jsi, jcodec, data)
    assert set(shards) == set(ref)
    for s in ref:
        assert np.array_equal(shards[s], ref[s]), s
    survivors = {s: v for s, v in shards.items() if s != 1}
    got = ec.decode(si, codec, survivors)
    exp = jec.decode(jsi, jcodec, survivors)
    assert all(np.array_equal(got[s], exp[s]) for s in exp)
    assert ec.decode_concat(si, codec, survivors) == data


@pytest.mark.parametrize("mode,kind", [("store", "random"),
                                       ("compress", "low")])
def test_encode_fused_matches_jax(mode, kind):
    si, jsi = sinfos()
    data = payload(kind)
    shards, r = ec.encode_fused(si, port_codec(2, 1), data, mode=mode)
    ref, jr = jec.encode_fused(jsi, jax_codec(2, 1), data, mode=mode)
    assert set(shards) == set(ref)
    for s in ref:
        assert np.array_equal(shards[s], ref[s]), s
    for name in ("compressed", "comp_len", "used_stripes", "stored_len",
                 "padded_len", "raw_len", "shard_crcs"):
        assert getattr(r, name) == getattr(jr, name), name
    assert np.array_equal(r.chunk_crc32c, jr.chunk_crc32c)
    assert np.array_equal(r.chunk_xxh32, jr.chunk_xxh32)
    # HashInfo takes the device crcs wholesale, as the reference's does
    comp = None
    if r.compressed:
        comp = {"alg": ft.COMP_ALG, "orig_chunk_size":
                si.aligned_logical_offset_to_chunk_offset(len(data)),
                "comp_len": r.comp_len, "padded_len": r.padded_len}
    h, jh = ec.HashInfo(3), jec.HashInfo(3)
    h.set_device_hashes(r.shard_crcs, r.used_stripes * si.chunk_size, comp)
    jh.set_device_hashes(jr.shard_crcs, jr.used_stripes * jsi.chunk_size,
                         comp)
    assert h.to_dict() == jh.to_dict()
    for s, stream in shards.items():
        assert h.get_chunk_hash(s) == zlib.crc32(stream.tobytes())
    assert h.get_total_logical_size(si) == len(data)
    h2 = ec.HashInfo.from_dict(h.to_dict())
    assert h2.to_dict() == jec.HashInfo.from_dict(jh.to_dict()).to_dict()


def test_store_roundtrip_through_decode_concat():
    si, _ = sinfos()
    codec = port_codec(2, 1)
    data = payload("random", seed=13)
    shards, r = ec.encode_fused(si, codec, data)
    assert not r.compressed and r.stored is None
    separate = ec.encode(si, codec, data)
    assert all(np.array_equal(shards[s], separate[s]) for s in separate)
    for lost in range(3):
        survivors = {s: v for s, v in shards.items() if s != lost}
        assert ec.decode_concat(si, codec, survivors) == data


def test_compress_roundtrip_through_decode_concat():
    """A compressed object read back with a lost data shard: decode the
    stored stripes, inflate, and the payload comes back."""
    si, _ = sinfos()
    codec = port_codec(2, 1)
    data = payload("low", seed=17)
    shards, r = ec.encode_fused(si, codec, data, mode="compress")
    assert r.compressed and r.used_stripes < SHAPE[0]
    survivors = {s: v for s, v in shards.items() if s != 0}
    stored = ec.decode_concat(si, codec, survivors)
    assert len(stored) == r.used_stripes * si.stripe_width
    out = ft.bitplane_decompress(stored[:r.comp_len], r.padded_len)
    assert out[:len(data)] == data


def test_encode_fused_edges():
    si, _ = sinfos()
    codec = port_codec(2, 1)
    assert ec.encode_fused(si, codec, b"") == ({}, None)
    with pytest.raises(ErasureCodeError) as e:
        ec.encode_fused(si, codec, b"x" * 100)
    assert e.value.errno == 22
    shards, _ = ec.encode_fused(si, codec, payload("random"), want={2})
    assert set(shards) == {2}


def test_hashinfo_append_matches_jax():
    h, jh = ec.HashInfo(3), jec.HashInfo(3)
    rng = np.random.default_rng(5)
    size = 0
    for _ in range(3):
        app = {i: rng.integers(0, 256, 512, dtype=np.uint8) for i in range(3)}
        h.append(size, app)
        jh.append(size, app)
        size += 512
    assert h.to_dict() == jh.to_dict()
    h.clear()
    jh.clear()
    assert h.to_dict() == jh.to_dict()


@pytest.mark.parametrize("depth", [1, 2])
def test_dispatcher_fused_matches_direct(depth):
    si, _ = sinfos()
    codec = port_codec(2, 1)
    disp = GpuDispatcher(device="cpu", pipeline_depth=depth, max_delay=0.002)
    try:
        assert disp.fused_supported(codec)
        for mode, kind in (("store", "random"), ("compress", "low"),
                           ("compress", "random")):
            data = payload(kind, seed=19)
            direct, r1 = ec.encode_fused(si, codec, data, mode=mode)
            via, r2 = ec.encode_fused(si, codec, data, mode=mode,
                                      dispatcher=disp)
            assert r1.compressed == r2.compressed
            assert r1.shard_crcs == r2.shard_crcs
            assert np.array_equal(r1.chunk_xxh32, r2.chunk_xxh32)
            for s in direct:
                assert np.array_equal(direct[s], via[s]), (mode, s)
        st = disp.fused_stats
        assert st["dispatches"] == 3 and st["compressed"] == 1
        assert st["probe_rejects"] == 1
        perf = disp.perf.dump()
        assert perf["l_gpu_fused_dispatches"] == 3
        assert perf["l_gpu_fused_compressed"] == 1
        assert perf["l_gpu_fused_probe_rejects"] == 1
        assert perf["l_gpu_fused_bytes_in"] == 3 * len(data)
        assert perf["l_gpu_fused_ratio_milli"]["avgcount"] == 3
    finally:
        disp.shutdown()


def test_dispatcher_fused_writes_from_threads_never_coalesce():
    """8 threads, whole-object writes in both modes: every result equals
    the direct path, and each write is its own dispatch."""
    si, _ = sinfos()
    codec = port_codec(2, 1)
    expect = {}
    for mode, kind in (("store", "random"), ("compress", "low")):
        data = payload(kind, seed=23)
        expect[mode] = (data, ec.encode_fused(si, codec, data, mode=mode))
    disp = GpuDispatcher(device="cpu", max_delay=0.002)
    errors = []

    def writer(tid):
        r = random.Random(tid)
        try:
            for _ in range(3):
                mode = r.choice(("store", "compress"))
                data, (shards, res) = expect[mode]
                got, gres = ec.encode_fused(si, codec, data, mode=mode,
                                            dispatcher=disp)
                if gres.shard_crcs != res.shard_crcs or not all(
                        np.array_equal(got[s], shards[s]) for s in shards):
                    errors.append(mode)
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    pool = [threading.Thread(target=writer, args=(t,)) for t in range(8)]
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(60)
    finally:
        disp.shutdown()
    assert not any(t.is_alive() for t in pool)
    assert errors == []
    assert disp.stats["dispatches"] == disp.stats["ops"] == 24
    assert disp.stats["coalesced"] == 0
    assert disp.fused_stats["dispatches"] == 24


# -- cross-chip recovery and repair ----------------------------------------------
#
# The port on meshes of ["cpu"] * 4 and through a rateless dispatcher of
# 4 CPU workers, the JAX package on its virtual devices. For cauchy_good
# the reference is its queue path: its explicit-mesh path applies the
# element-layout product to the packet layout's bitmatrix and rebuilds
# wrong bytes for most targets, where the port's runs the codec's own
# layout kernel on each block.

CROSS = {"rs_w8": {"technique": "reed_sol_van", "k": "4", "m": "2",
                   "w": "8"},
         "rs_w16": {"technique": "reed_sol_van", "k": "4", "m": "2",
                    "w": "16"},
         "cauchy_good": {"technique": "cauchy_good", "k": "4", "m": "2",
                         "packetsize": "64"}}
TARGETS = ((5, 2), (0, 4), (3, 1))      # (rebuilt shard, also lost)


def survivors_of(shards, target, lost):
    rest = {s: v for s, v in shards.items() if s not in (target, lost)}
    return {s: rest[s] for s in sorted(rest)[:4]}


@functools.lru_cache(maxsize=None)
def cross_case(name):
    """A seeded 3-stripe payload, its shards, and the JAX package's
    recover_cross_chip of each target."""
    from ceph_tpu import registry as jregistry
    from ceph_tpu.parallel import mesh as jmesh, rateless as jrateless
    jcodec = jregistry.factory("jax_tpu", CROSS[name])
    chunk = jcodec.get_chunk_size(4 * 2048)
    jsinfo = jec.StripeInfo(4, 4 * chunk)
    data = np.random.default_rng(7).integers(
        0, 256, 3 * 4 * chunk, dtype=np.uint8).tobytes()
    shards = jec.encode(jsinfo, jcodec, data)
    mesh = None if name == "cauchy_good" else jmesh.make_mesh(4)
    try:
        ref = {t: jec.recover_cross_chip(
            jsinfo, jcodec, survivors_of(shards, t, lost), t, mesh=mesh)
            for t, lost in TARGETS}
    finally:
        jrateless.reset_dispatcher()
    return chunk, shards, ref


@pytest.fixture
def cpu_dispatcher():
    rl = rateless.RatelessDispatcher(devices=["cpu"] * 4, name="ec-rl")
    rateless.set_dispatcher(rl)
    try:
        yield rl
    finally:
        rateless.reset_dispatcher()


@pytest.mark.parametrize("name", list(CROSS))
def test_recover_cross_chip_matches_jax(name, cpu_dispatcher):
    chunk, shards, ref = cross_case(name)
    codec = registry.factory("torch_cuda", CROSS[name], device="cpu")
    si = ec.StripeInfo(4, 4 * chunk)
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    for target, lost in TARGETS:
        surv = survivors_of(shards, target, lost)
        want = np.asarray(shards[target]).tobytes()
        assert ref[target] == want, target
        assert ec.recover_cross_chip(si, codec, surv, target,
                                     mesh=mesh) == want, target
        assert ec.recover_cross_chip(si, codec, surv, target) == want
    assert sum(d["completed"] for d in cpu_dispatcher.device_status()) > 0


def test_recover_cross_chip_checksum_trips(cpu_dispatcher):
    chunk, shards, _ = cross_case("rs_w8")
    codec = registry.factory("torch_cuda", CROSS["rs_w8"], device="cpu")
    si = ec.StripeInfo(4, 4 * chunk)
    surv = survivors_of(shards, 5, 2)
    stacked = np.stack([np.asarray(surv[s]) for s in sorted(surv)])
    expected = int(stacked.astype(np.uint64).sum()) % (1 << 32)
    bad = dict(surv)
    bad[1] = np.asarray(surv[1]).copy()
    bad[1][100] ^= 0x40
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    assert ec.recover_cross_chip(si, codec, surv, 5, mesh=mesh,
                                 expected_sum=expected) is not None
    for m in (mesh, None):
        with pytest.raises(MeshChecksumError):
            ec.recover_cross_chip(si, codec, bad, 5, mesh=m,
                                  expected_sum=expected)


def test_cross_chip_is_none_where_the_references_is(monkeypatch):
    """A locality codec, a sub-symbol codec for recovery, one device and
    no mesh, and a stream that is not chunk aligned: None in both
    packages."""
    import jax
    from ceph_tpu import registry as jregistry
    chunk, shards, _ = cross_case("rs_w8")
    si, jsi = ec.StripeInfo(4, 4 * chunk), jec.StripeInfo(4, 4 * chunk)
    surv = survivors_of(shards, 5, 2)
    lrc_prof = {"k": "4", "m": "2", "l": "3"}
    msr_prof = {"technique": "msr", "k": "4", "m": "3", "w": "8"}
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    pairs = [(registry.factory("lrc_cuda", dict(lrc_prof), device="cpu"),
              jregistry.factory("lrc_tpu", dict(lrc_prof))),
             (registry.factory("msr_cuda", msr_prof, device="cpu"),
              jregistry.factory("msr", msr_prof))]
    for mine, ref in pairs:
        assert ec.recover_cross_chip(si, mine, surv, 5, mesh=mesh) is None
        assert jec.recover_cross_chip(jsi, ref, surv, 5) is None
    codec = registry.factory("torch_cuda", CROSS["rs_w8"], device="cpu")
    jcodec = jregistry.factory("jax_tpu", CROSS["rs_w8"])
    short = {s: np.asarray(v)[:chunk // 2] for s, v in surv.items()}
    assert ec.recover_cross_chip(si, codec, short, 5, mesh=mesh) is None
    assert jec.recover_cross_chip(jsi, jcodec, short, 5,
                                  mesh=object()) is None
    assert ec.recover_cross_chip(si, codec, surv, 5) is None   # no devices
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    assert jec.recover_cross_chip(jsi, jcodec, surv, 5) is None


@functools.lru_cache(maxsize=None)
def repair_case():
    """MSR k=4, m=3: the helper fractions of shard 2 and the JAX
    package's repair_cross_chip of them over 4 virtual devices."""
    from ceph_tpu import registry as jregistry
    from ceph_tpu.parallel import mesh as jmesh
    prof = {"technique": "msr", "k": "4", "m": "3", "w": "8"}
    jcodec = jregistry.factory("msr", prof)
    chunk = jcodec.get_chunk_size(4 * 4096)
    jsinfo = jec.StripeInfo(4, 4 * chunk)
    data = np.random.default_rng(8).integers(
        0, 256, 3 * 4 * chunk, dtype=np.uint8).tobytes()
    shards = jec.encode(jsinfo, jcodec, data)
    target = 2
    helpers = sorted(jcodec.minimum_to_repair(target, set(range(7))))
    fractions = {h: jec.repair_fraction(jsinfo, jcodec, target, shards[h])
                 for h in helpers}
    ref = jec.repair_cross_chip(jsinfo, jcodec, target, fractions,
                                mesh=jmesh.make_mesh(4))
    return prof, chunk, shards, target, fractions, ref


def test_repair_cross_chip_matches_jax(cpu_dispatcher):
    prof, chunk, shards, target, fractions, ref = repair_case()
    codec = registry.factory("msr_cuda", prof, device="cpu")
    si = ec.StripeInfo(4, 4 * chunk)
    want = np.asarray(shards[target]).tobytes()
    assert ref == want
    mesh = pmesh.make_mesh(devices=["cpu"] * 4)
    assert ec.repair_cross_chip(si, codec, target, fractions,
                                mesh=mesh) == want
    assert ec.repair_cross_chip(si, codec, target, fractions) == want
    total = sum(int(np.frombuffer(f, np.uint8).astype(np.uint64).sum())
                for f in fractions.values()) % (1 << 32)
    for m in (mesh, None):
        with pytest.raises(MeshChecksumError):
            ec.repair_cross_chip(si, codec, target, fractions, mesh=m,
                                 expected_sum=total + 1)
    rs = registry.factory("torch_cuda", CROSS["rs_w8"], device="cpu")
    assert ec.repair_cross_chip(si, rs, target, fractions,
                                mesh=mesh) is None


def test_repair_cross_chip_without_devices_is_none():
    prof, chunk, _shards, target, fractions, _ref = repair_case()
    codec = registry.factory("msr_cuda", prof, device="cpu")
    assert ec.repair_cross_chip(ec.StripeInfo(4, 4 * chunk), codec, target,
                                fractions) is None
