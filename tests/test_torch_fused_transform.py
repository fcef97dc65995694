"""Fused write transform of the PyTorch port against the JAX package.

``ceph_tpu_torch.osd.fused_transform.run_fused`` on a codec made with
``device="cpu"`` (every step through its plain PyTorch version) against
``ceph_tpu.osd.fused_transform.run_fused`` on JAX's CPU backend, on the
same inputs made from a numpy seed. Tolerance: none, except
``entropy_milli`` within 1, because the float32 sum of the 256 entropy
terms follows another order in XLA and in the port. Each reference
output is computed once (``tests/torch_fused_ref.py``); the port's own
kernels' functions are also held against zlib and the host oracles.
"""

import zlib

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu.osd import fused_transform as jft
from ceph_tpu_torch import registry
from ceph_tpu_torch.ops import write_kernels as wk
from ceph_tpu_torch.osd import fused_transform as ft

from .torch_fused_ref import make_batch, port_codec, reference
from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STORE = [(1, (3, 2, 96)), (1, (4, 2, 256)), (3, (2, 8, 4096))]
COMPRESS = [(1, (4, 2, 256), "low"), (1, (4, 2, 256), "random")]
EXACT = ("parity", "shard_crcs", "chunk_crc32c", "chunk_xxh32")
DECISION = ("comp_len", "used_stripes", "probe_ok", "do_compress")


def port_host(m, shape, kind, mode, **kw):
    codec = port_codec(shape[1], m)
    return ft.to_host(ft.run_fused(codec, make_batch(shape, kind), mode=mode,
                                   **kw))


@pytest.mark.parametrize("m,shape", STORE, ids=str)
def test_store_matches_jax(m, shape):
    ref = reference(m, shape, "random", "store")
    got = port_host(m, shape, "random", "store")
    assert set(got) == set(ref)
    for name in EXACT:
        assert got[name].shape == ref[name].shape, name
        assert np.array_equal(got[name], ref[name]), name


@pytest.mark.parametrize("m,shape,kind", COMPRESS, ids=str)
def test_compress_matches_jax(m, shape, kind):
    ref = reference(m, shape, kind, "compress")
    got = port_host(m, shape, kind, "compress")
    assert set(got) == set(ref)
    for name in EXACT + ("stored",):
        assert got[name].shape == ref[name].shape, name
        assert np.array_equal(got[name], ref[name]), name
    for name in DECISION:
        assert int(got[name]) == int(ref[name]), name
    assert abs(int(got["entropy_milli"]) - int(ref["entropy_milli"])) <= 1
    # low-entropy bytes compress, random ones are rejected by the probe
    assert bool(got["do_compress"]) == (kind == "low")
    assert bool(got["probe_ok"]) == (kind == "low")


@pytest.mark.parametrize("m,shape,kind", COMPRESS, ids=str)
def test_result_from_host_matches_jax(m, shape, kind):
    S, k, chunk = shape
    ref = jft.result_from_host(reference(m, shape, kind, "compress"),
                               S, k, chunk, "compress")
    got = ft.result_from_host(port_host(m, shape, kind, "compress"),
                              S, k, chunk, "compress")
    for name in ("compressed", "comp_len", "probe_ok", "used_stripes",
                 "stored_len", "raw_len", "padded_len", "shard_crcs"):
        assert getattr(got, name) == getattr(ref, name), name
    assert np.array_equal(got.parity, ref.parity)
    assert np.array_equal(got.stored, ref.stored)
    assert abs(got.entropy_bpb - ref.entropy_bpb) <= 1 / 8000


def test_digests_equal_host_oracles():
    """Every chunk digest against crc32c_host / xxh32_host, every shard
    crc against zlib over the stored streams."""
    shape = (3, 2, 96)
    batch = make_batch(shape, "random")
    out = ft.to_host(ft.run_fused(port_codec(2, 1), batch))
    for s in range(shape[0]):
        for i in range(shape[1]):
            raw = batch[s, i].tobytes()
            assert int(out["chunk_crc32c"][s, i]) == ft.crc32c_host(raw)
            assert int(out["chunk_xxh32"][s, i]) == ft.xxh32_host(raw)
    alln = np.concatenate([batch, out["parity"]], axis=1)
    for i in range(alln.shape[1]):
        stream = np.ascontiguousarray(alln[:, i]).tobytes()
        assert int(out["shard_crcs"][i]) == zlib.crc32(stream)


@pytest.mark.parametrize("m,shape", [(1, (4, 2, 256)), (3, (2, 8, 4096))],
                         ids=str)
def test_compress_container_equals_host_twin(m, shape):
    batch = make_batch(shape, "low")
    codec = port_codec(shape[1], m)
    r = ft.finish_fused(ft.run_fused(codec, batch, mode="compress"),
                        *shape, "compress")
    assert r.compressed and r.used_stripes < shape[0]
    dev = r.stored.reshape(-1)[:r.comp_len].tobytes()
    twin, padded = ft.bitplane_compress_host(batch.tobytes())
    assert dev == twin and padded == r.padded_len
    assert ft.bitplane_decompress(dev, padded)[:batch.size] == \
        batch.tobytes()
    # the parity on disk is the encode of the stored rows
    assert np.array_equal(r.parity, codec.encode_batch(r.stored))
    alln = np.concatenate([r.stored, r.parity], axis=1)
    assert r.shard_crcs == [zlib.crc32(np.ascontiguousarray(
        alln[:, i]).tobytes()) for i in range(alln.shape[1])]
    for s in range(shape[0]):
        for i in range(shape[1]):
            raw = batch[s, i].tobytes()
            assert int(r.chunk_crc32c[s, i]) == ft.crc32c_host(raw)
            assert int(r.chunk_xxh32[s, i]) == ft.xxh32_host(raw)


@pytest.mark.parametrize("length", [0, 1, 15, 16, 96, 4097])
@pytest.mark.parametrize("poly", ["zlib", "crc32c"])
def test_crc32_rows_plain(length, poly):
    data = make_batch((3, length), "random", seed=length)
    consts = ft.dev_consts("cpu")[ft.POLY_ZLIB if poly == "zlib"
                                  else ft.POLY_C]
    got = wk.crc32_rows(torch.from_numpy(data).view(3, 1, length), consts)
    oracle = zlib.crc32 if poly == "zlib" else ft.crc32c_host
    assert [int(c) for c in got] == [oracle(r.tobytes()) for r in data]


def test_crc32_rows_strided_segments_and_pad():
    """Rows read in place as segments at a stride (the shard streams of
    [S, k, chunk]), and a zero tail un-shifted by a pad on the device."""
    batch = make_batch((5, 3, 40), "random", seed=3)
    consts = ft.dev_consts("cpu")[ft.POLY_ZLIB]
    view = torch.from_numpy(batch).permute(1, 0, 2)
    got = wk.crc32_rows(view, consts)
    streams = [np.ascontiguousarray(batch[:, i]).tobytes() for i in range(3)]
    assert [int(c) for c in got] == [zlib.crc32(s) for s in streams]
    batch[3:] = 0               # the last 2 stripes are a zero tail
    pad = torch.tensor([2 * 40])
    got = wk.crc32_rows(torch.from_numpy(batch).permute(1, 0, 2), consts,
                        pad=pad)
    assert [int(c) for c in got] == [
        zlib.crc32(np.ascontiguousarray(batch[:3, i]).tobytes())
        for i in range(3)]


def test_xxh32_rows_plain():
    assert ft.xxh32_host(b"") == 0x02CC5D05
    text = b"Nobody inspects the spammish repetition"
    rows = torch.frombuffer(bytearray(text), dtype=torch.uint8).view(1, -1)
    assert int(wk.xxh32_rows(rows)[0]) == 0xE2293B2F
    for length in (0, 1, 15, 96, 4097):
        data = make_batch((2, length), "random", seed=length)
        got = wk.xxh32_rows(torch.from_numpy(data))
        assert [int(h) for h in got] == [ft.xxh32_host(r.tobytes())
                                         for r in data]


@pytest.mark.parametrize("kind", ["low", "random", "zeros", "ragged"])
def test_bitplane_stage_plain(kind):
    n = 3000 + 17 if kind == "ragged" else 4096
    data = np.zeros(n, np.uint8) if kind == "zeros" else make_batch(
        (n,), "random" if kind == "random" else "low", seed=n)
    sw, chunk = 2 * 64, 64
    cap2 = ft.plan_capacity(n, sw)
    stored, dec = wk.bitplane_stage(torch.from_numpy(data), cap2, sw, chunk,
                                    875, 7000)
    fields = dict(zip(wk.DEC_FIELDS, dec.tolist()))
    twin, padded = ft.bitplane_compress_host(data.tobytes())
    assert fields["comp_len"] == len(twin)
    assert bool(fields["probe_ok"]) == (kind != "random")
    if fields["do_compress"]:
        assert stored[:len(twin)].numpy().tobytes() == twin
        assert not stored[len(twin):].any()
    else:
        assert stored[:n].numpy().tobytes() == data.tobytes()
        assert not stored[n:].any()
    assert fields["used_stripes"] == -(-(
        len(twin) if fields["do_compress"] else n) // sw)
    assert fields["pad_bytes"] == (cap2 // sw - fields["used_stripes"]) * chunk


def test_ratio_rule_has_no_int32_overflow():
    """The reference decides comp_len * 1000 <= N * required_milli in
    int32 (fused_transform.py:529), which wraps for N > 2,454,267 at
    0.875. The port decides in int64: a 4 MiB object at the ratio 0.281
    the bench's bytes give compresses, as comp_len / N <= 0.875 says."""
    n, req = 128 * 8 * 4096, 875
    comp_len = 18 * (n // 64)       # 2 header + 2 stored planes a block
    assert comp_len / n <= req / 1000
    wrapped = np.array([n], np.int32) * np.int32(req)
    assert wrapped[0] < 0           # the reference's product wraps here
    assert comp_len * 1000 <= n * req
    # the port's stage on a small low-entropy object keeps the same rule
    data = make_batch((8 * 4096,), "low", seed=1)
    cap2 = ft.plan_capacity(data.size, 8 * 512)
    for req_milli in (875, 200):
        _, dec = wk.bitplane_stage(torch.from_numpy(data), cap2, 8 * 512,
                                   512, req_milli, 7000)
        f = dict(zip(wk.DEC_FIELDS, dec.tolist()))
        assert f["probe_ok"]
        assert bool(f["do_compress"]) == (
            f["comp_len"] * 1000 <= data.size * req_milli)
    assert f["do_compress"] == 0    # 0.281 does not beat 0.2


def test_host_oracles_equal_jax_packages():
    data = make_batch((1000,), "low").tobytes() + bytes(range(200))
    assert ft.crc32c_host(data) == jft.crc32c_host(data)
    assert ft.xxh32_host(data) == jft.xxh32_host(data)
    assert ft.bitplane_compress_host(data) == jft.bitplane_compress_host(data)
    buf, padded = ft.bitplane_compress_host(data)
    assert ft.bitplane_decompress(buf, padded) == \
        jft.bitplane_decompress(buf, padded)
    assert ft.shannon_bytes_per_byte(data) == \
        jft.shannon_bytes_per_byte(data)
    for n, sw in ((4096, 512), (3 * 2 * 96, 192), (1 << 22, 32768)):
        assert ft.plan_capacity(n, sw) == jft.plan_capacity(n, sw)
    assert ft.COMP_ALG == jft.COMP_ALG
    for poly in (ft.POLY_ZLIB, ft.POLY_C):
        mine, ref = ft._poly_consts(poly), jft._poly_consts(poly)
        # the reference's table, shifts and inverses, then K1's slicing
        # tables T_k[b] = (T_{k-1}[b] >> 8) ^ table[T_{k-1}[b] & 0xFF]
        slices = [ref.table.astype(np.uint32)]
        for _ in range(15):
            slices.append((slices[-1] >> np.uint32(8)) ^
                          ref.table.astype(np.uint32)[slices[-1] & 0xFF])
        assert np.array_equal(mine.packed(), np.concatenate(
            [ref.table, ref.shift.reshape(-1), ref.inv.reshape(-1),
             np.stack(slices[1:]).reshape(-1)]))


def test_device_crc32_on_cpu():
    data = make_batch((70001,), "random", seed=9).tobytes()
    assert ft.device_crc32(data, device="cpu") == zlib.crc32(data)
    assert ft.device_crc32(b"", device="cpu") == 0


FAMILIES = [
    ("torch_cuda", "jax_tpu", {"technique": "reed_sol_van", "k": "4",
                               "m": "2"}),
    ("torch_cuda", "jax_tpu", {"technique": "reed_sol_r6_op", "k": "4",
                               "m": "2"}),
    ("shec_cuda", "shec_tpu", {"k": "4", "m": "3", "c": "2"}),
    ("lrc_cuda", "lrc_tpu", {"k": "4", "m": "2", "l": "3"}),
    ("torch_cuda", "jax_tpu", {"technique": "cauchy_orig", "k": "4",
                               "m": "2", "packetsize": "8"}),
    ("torch_cuda", "jax_tpu", {"technique": "cauchy_good", "k": "4",
                               "m": "2", "packetsize": "8"}),
    ("torch_cuda", "jax_tpu", {"technique": "liberation", "k": "5",
                               "w": "7", "packetsize": "8"}),
    ("torch_cuda", "jax_tpu", {"technique": "blaum_roth", "k": "4",
                               "w": "6", "packetsize": "16"}),
    ("torch_cuda", "jax_tpu", {"technique": "liber8tion", "k": "8",
                               "packetsize": "8"}),
]


@pytest.mark.parametrize("plugin,jplugin,prof", FAMILIES,
                         ids=lambda x: x.get("technique", "")
                         if isinstance(x, dict) else x)
def test_fused_supported_matches_jax(plugin, jplugin, prof):
    codec = registry.factory(plugin, dict(prof), device="cpu")
    jcodec = jregistry.factory(jplugin, dict(prof))
    assert ft.fused_supported(codec) == jft.fused_supported(jcodec)
    family = plugin if "technique" not in prof else prof["technique"]
    assert ft.fused_supported(codec) == (
        family in ("reed_sol_van", "reed_sol_r6_op", "shec_cuda"))


def test_run_fused_checks_its_input():
    codec = port_codec(2, 1)
    with pytest.raises(ValueError, match="mode"):
        ft.run_fused(codec, make_batch((1, 2, 64), "low"), mode="zip")
    with pytest.raises(ValueError, match="data chunks"):
        ft.run_fused(codec, make_batch((1, 3, 64), "low"))
    with pytest.raises(ValueError, match="contiguous"):
        wk.xxh32_rows(torch.zeros(4, 8, dtype=torch.uint8)[:, ::2])
    with pytest.raises(ValueError, match="cap2"):
        wk.bitplane_stage(torch.zeros(640, dtype=torch.uint8), 640, 64, 32,
                          875, 7000)
