"""ec_util and the dispatcher's fused leg of the PyTorch port, against the
JAX package.

``ceph_tpu_torch.osd.ec_util`` (StripeInfo, encode, encode_fused, decode,
decode_concat, HashInfo) on codecs made with ``device="cpu"`` against
``ceph_tpu.osd.ec_util`` on the same payloads, made from a numpy seed;
then ``GpuDispatcher.fused_write`` on the CPU device against the direct
path. Tolerance: none (bytes, crcs and sizes are exact).
"""

import random
import threading
import zlib

import numpy as np
import pytest

from ceph_tpu.osd import ec_util as jec
from ceph_tpu_torch.errors import ErasureCodeError
from ceph_tpu_torch.osd import ec_util as ec
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
