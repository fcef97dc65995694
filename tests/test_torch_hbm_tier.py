"""The device chunk tier of the PyTorch port, against the JAX package.

``ceph_tpu_torch.osd.hbm_tier.HbmChunkTier`` (codec ``torch_cuda`` on
``device="cpu"``) against ``ceph_tpu.osd.hbm_tier.HbmChunkTier`` (codec
``jax_tpu``), both fed the same numpy arrays through the same calls, at
the reference test's K=4, M=2 and 64 KiB objects and at k=8, m=3:
resident rows, parity, digests, rebuilt shards, LRU order and
``stats()`` (but for its device label) must be equal. Then ``resident=``
on ``ec_util.encode`` / ``encode_fused`` and on ``GpuDispatcher`` (depth
1 and pipelined), whose adopted entries must equal the reference tier's
adoption of the same write; the store-mode write is held against the
reference's fused transform. The staging-reuse case: a pipelined
dispatch must make the tier's copy of its staged rows before the buffer
goes back to the pool. Tolerance: none.
"""

import functools

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu.osd import ec_util as jec
from ceph_tpu.osd import hbm_tier as jtier
from ceph_tpu_torch import registry
from ceph_tpu_torch.osd import ec_util as ec
from ceph_tpu_torch.osd import gpu_dispatch
from ceph_tpu_torch.osd.gpu_dispatch import GpuDispatcher
from ceph_tpu_torch.osd.hbm_tier import HbmChunkTier, host_digest

from .torch_fused_ref import jax_codec, make_batch, port_codec, reference
from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OBJ = 64 * 1024
CONFIGS = [(4, 2), (8, 3)]


@functools.lru_cache(maxsize=None)
def codecs(k: int, m: int):
    profile = {"technique": "reed_sol_van", "k": str(k), "m": str(m),
               "w": "8"}
    return (jregistry.factory("jax_tpu", dict(profile)),
            registry.factory("torch_cuda", dict(profile), device="cpu"))


def tiers(k, m, capacity=64):
    jc, pc = codecs(k, m)
    return (jtier.HbmChunkTier(jc, capacity_objects=capacity),
            HbmChunkTier(pc, capacity_objects=capacity, device="cpu"))


def objects(k, nobjs, seed, obj=OBJ):
    n = codecs(k, 2 if k == 4 else 3)[1].get_chunk_size(obj)
    return np.random.default_rng(seed).integers(0, 256, (nobjs, k, n),
                                                dtype=np.uint8)


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stats_equal(ref, mine):
    a, b = ref.stats(), mine.stats()
    assert b.pop("device") == "cpu:0"
    a.pop("device")
    assert a == b


@functools.lru_cache(maxsize=None)
def scenario(k, m):
    """Both tiers through put_encode, gets, scrubs and rebuilds; every
    result of each (numpy), computed once per config."""
    ref, mine = tiers(k, m)
    data = objects(k, 4, seed=k)
    names = ["o%d" % i for i in range(4)]
    out = {"parity": (host(ref.put_encode(names, data)),
                      host(mine.put_encode(names, data)))}
    out["get"] = [(host(ref.get(n)), host(mine.get(n))) for n in names]
    out["scrub"] = (ref.deep_scrub(names), mine.deep_scrub(names))
    order = ["o2", "o0", "o3"]
    pair = (ref.deep_scrub(order, device_out=True),
            mine.deep_scrub(order, device_out=True))
    out["finalize"] = (ref.finalize_digests(order, *pair[0]),
                       mine.finalize_digests(order, *pair[1]))
    out["device_out"] = pair[1]
    out["rebuild"] = [(lost, host(ref.reconstruct("o1", lost)),
                       host(mine.reconstruct("o1", lost)))
                      for lost in ((0,), (k,), (1, k + 1), (k + m - 1,))]
    lost = [(i * 2 + 1) % (k + m) for i in range(4)]
    out["batch"] = (host(ref.reconstruct_batch(names, lost)),
                    host(mine.reconstruct_batch(names, lost)), lost)
    # a second upload batch: names spanning two batches, out of order
    more = objects(k, 2, seed=k + 100)
    ref.put_encode(["p0", "p1"], more)
    mine.put_encode(["p0", "p1"], more)
    mixed, mlost = ["p1", "o3", "p0", "o0"], [0, k, k + m - 1, 2]
    out["batch_mixed"] = (host(ref.reconstruct_batch(mixed, mlost)),
                          host(mine.reconstruct_batch(mixed, mlost)))
    out["stats"] = (ref, mine)
    return out


@pytest.mark.parametrize("k,m", CONFIGS)
def test_put_encode_and_get_match_jax(k, m):
    s = scenario(k, m)
    ref, mine = s["parity"]
    assert mine.shape == ref.shape and np.array_equal(mine, ref)
    data = objects(k, 4, seed=k)
    for i, (r, p) in enumerate(s["get"]):
        assert np.array_equal(p, r)
        assert np.array_equal(p[:k], data[i])


@pytest.mark.parametrize("k,m", CONFIGS)
def test_deep_scrub_matches_jax(k, m):
    ref, mine = scenario(k, m)["scrub"]
    assert set(ref) == set(mine)
    for name in ref:
        assert mine[name].dtype == np.uint64
        assert np.array_equal(mine[name], ref[name]), name


@pytest.mark.parametrize("k,m", CONFIGS)
def test_device_out_and_finalize_match_jax(k, m):
    s = scenario(k, m)
    ref, mine = s["finalize"]
    assert list(ref) == list(mine)
    for name in ref:
        assert np.array_equal(mine[name], ref[name])
    d_s, d_ws = s["device_out"]
    assert d_s.dtype == d_ws.dtype == torch.uint32
    assert d_s.shape == (3, k + m)


@pytest.mark.parametrize("k,m", CONFIGS)
def test_reconstruct_matches_jax(k, m):
    full = scenario(k, m)["get"][1][1]
    for lost, ref, mine in scenario(k, m)["rebuild"]:
        assert mine.shape == (len(lost), full.shape[1])
        assert np.array_equal(mine, ref), lost
        assert all(np.array_equal(mine[j], full[s])
                   for j, s in enumerate(lost))


@pytest.mark.parametrize("k,m", CONFIGS)
def test_reconstruct_batch_matches_jax(k, m):
    s = scenario(k, m)
    ref, mine, lost = s["batch"]
    assert np.array_equal(mine, ref)
    for i, (_, full) in enumerate(s["get"]):
        assert np.array_equal(mine[i], full[lost[i]])
    ref, mine = s["batch_mixed"]
    assert np.array_equal(mine, ref)


@pytest.mark.parametrize("k,m", CONFIGS)
def test_stats_and_occupancy_match_jax(k, m):
    ref, mine = scenario(k, m)["stats"]
    stats_equal(ref, mine)
    assert mine.occupancy() == ref.occupancy()
    assert mine.stats()["hits"] > 0


def test_deep_scrub_mixed_shapes_matches_jax():
    ref, mine = tiers(4, 2)
    d1 = objects(4, 2, seed=9)
    d2 = objects(4, 1, seed=10, obj=OBJ // 2)
    for tier in (ref, mine):
        tier.put_encode(["h0", "h1"], d1)
        tier.put_encode(["h2"], d2)
    a = ref.deep_scrub(["h0", "h2", "h1"])
    b = mine.deep_scrub(["h0", "h2", "h1"])
    for name in ("h0", "h1", "h2"):
        assert np.array_equal(b[name], a[name])
        assert np.array_equal(b[name], host_digest(host(mine.get(name))))
    for tier in (ref, mine):
        with pytest.raises(ValueError):
            tier.deep_scrub(["h0", "h2"], device_out=True)


def test_lru_eviction_order_matches_jax():
    ref, mine = tiers(4, 2, capacity=3)
    data = objects(4, 5, seed=3)
    for tier in (ref, mine):
        tier.put_encode(["e%d" % i for i in range(5)], data)
        tier.get("e2")                 # e2 becomes the newest
        tier.put_encode(["f0"], data[:1])
        tier.get("nope")
    for name in ["e%d" % i for i in range(5)] + ["f0"]:
        assert mine.resident(name) == ref.resident(name), name
    assert [mine.resident(n) for n in ("e2", "e4", "f0")] == [True] * 3
    stats_equal(ref, mine)
    for tier in (ref, mine):
        with pytest.raises(KeyError):
            tier.reconstruct("e0", (0,))
    stats_equal(ref, mine)


def test_drop_and_drop_prefix_match_jax():
    ref, mine = tiers(4, 2)
    data = objects(4, 3, seed=8)
    names = [("pgA", "x"), ("pgB", "y"), ("pgA", "z")]
    for tier in (ref, mine):
        tier.put_encode(names, data)
    assert mine.drop_prefix("pgA") == ref.drop_prefix("pgA") == 2
    assert mine.resident(("pgB", "y")) and not mine.resident(("pgA", "x"))
    for tier in (ref, mine):
        tier.drop(("pgB", "y"))
        tier.drop("absent")
    stats_equal(ref, mine)
    assert mine.stats()["resident_objects"] == 0
    assert mine.stats()["resident_bytes"] == 0


@pytest.mark.parametrize("k,m", CONFIGS)
def test_adopt_encode_layout_and_shard_digests_match_jax(k, m):
    ref, mine = tiers(k, m)
    jc, pc = codecs(k, m)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (4, k, 1024), dtype=np.uint8)
    parity = np.array(jc.encode_batch(data))
    crcs = rng.integers(0, 1 << 32, k + m, dtype=np.uint64).astype(np.uint32)
    ref.adopt_encode(("pg1", "a0"), data, parity, jc, digests=crcs)
    mine.adopt_encode(("pg1", "a0"), data, parity, pc, digests=crcs)
    # the same write adopted from tensors (the pipelined dispatcher's)
    ref.adopt_encode(("pg1", "a1"), data, parity, jc)
    mine.adopt_encode(("pg1", "a1"), torch.from_numpy(data),
                      torch.from_numpy(parity), pc)
    for key in (("pg1", "a0"), ("pg1", "a1")):
        assert np.array_equal(host(mine.get(key)), host(ref.get(key)))
    full = host(mine.get(("pg1", "a0")))
    ref.get(("pg1", "a0"))
    assert np.array_equal(full[:k], data.transpose(1, 0, 2).reshape(k, -1))
    assert np.array_equal(mine.shard_digests(("pg1", "a0")),
                          ref.shard_digests(("pg1", "a0")))
    assert mine.shard_digests(("pg1", "a1")) is None
    assert ref.shard_digests(("pg1", "a1")) is None
    assert np.array_equal(host(mine.reconstruct(("pg1", "a1"), (1,))),
                          host(ref.reconstruct(("pg1", "a1"), (1,))))
    stats_equal(ref, mine)
    # host arrays cost one upload, tensors on the tier's device none
    assert mine.uploads() == (1, (k + m) * 4 * 1024)


class _OtherDeviceCodec:
    device = torch.device("meta")


def test_tier_refuses_a_codec_on_another_device():
    with pytest.raises(ValueError, match="tier on cpu"):
        HbmChunkTier(_OtherDeviceCodec(), device="cpu")
    tier = HbmChunkTier(device="cpu")
    with pytest.raises(ValueError):
        tier.put_encode(["x"], objects(4, 1, seed=1), _OtherDeviceCodec())
    with pytest.raises(ValueError):
        tier.adopt_encode("x", torch.zeros((1, 4, 8), dtype=torch.uint8,
                                           device="meta"),
                          torch.zeros((1, 2, 8), dtype=torch.uint8,
                                      device="meta"), codecs(4, 2)[1])


def test_put_encode_counts_one_upload():
    _, mine = tiers(4, 2)
    data = objects(4, 2, seed=2)
    mine.put_encode(["u0", "u1"], data)
    mine.put_encode(["u2", "u3"], torch.from_numpy(data))
    assert mine.uploads() == (1, data.nbytes)


# -- resident= on ec_util and the dispatcher ---------------------------------

SHAPE = (4, 2, 256)           # [S, k, chunk], k=2, m=1: the fused tests'


def sinfos():
    k, chunk = SHAPE[1], SHAPE[2]
    return ec.StripeInfo(k, k * chunk), jec.StripeInfo(k, k * chunk)


def expected_tier(rows, parity, crcs=None):
    """The reference tier after adopting one write's rows and parity."""
    tier = jtier.HbmChunkTier(jax_codec(2, 1))
    tier.adopt_encode("obj", rows, parity, jax_codec(2, 1), digests=crcs)
    return tier


def held_against(tier, ref):
    assert np.array_equal(host(tier.get("obj")), host(ref.get("obj")))
    want = ref.shard_digests("obj")
    got = tier.shard_digests("obj")
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got, want)
    assert tier.stats()["adopted"] == ref.stats()["adopted"] == 1


def store_reference():
    """The reference's fused store-mode write of SHAPE's random bytes:
    (raw rows, parity, shard crcs)."""
    out = reference(1, SHAPE, "random", "store")
    return make_batch(SHAPE, "random"), out["parity"], \
        np.asarray(out["shard_crcs"], np.uint32)


def write(kind, dispatcher, tier):
    si = sinfos()[0]
    payload = make_batch(SHAPE, "random" if kind != "compress" else "low")
    if kind == "encode":
        shards = ec.encode(si, port_codec(2, 1), payload.tobytes(),
                           dispatcher=dispatcher, resident=(tier, "obj"))
        return shards, None
    return ec.encode_fused(si, port_codec(2, 1), payload.tobytes(),
                           dispatcher=dispatcher, resident=(tier, "obj"),
                           mode=kind)


@pytest.mark.parametrize("depth", [None, 1, 2])
@pytest.mark.parametrize("kind", ["encode", "store", "compress"])
def test_resident_writes_match_jax(kind, depth):
    """Without a dispatcher, at depth 1 and pipelined. The encode and the
    store-mode write are held against the reference's codec and fused
    transform; the compress-mode write against the reference tier's
    adoption of the port's result, whose bytes test_torch_ec_util holds
    against the reference."""
    disp = None if depth is None else GpuDispatcher(
        device="cpu", pipeline_depth=depth)
    tier = HbmChunkTier(device="cpu")
    try:
        shards, r = write(kind, disp, tier)
    finally:
        if disp is not None:
            disp.shutdown()
    if kind == "encode":
        rows = make_batch(SHAPE, "random")
        ref = expected_tier(rows, np.asarray(jax_codec(2, 1).encode_batch(
            rows)))
    elif kind == "store":
        ref = expected_tier(*store_reference())
        assert r.shard_crcs == [int(c) for c in store_reference()[2]]
    else:
        assert r.compressed
        ref = expected_tier(r.stored, r.parity,
                            np.asarray(r.shard_crcs, np.uint32))
    held_against(tier, ref)
    # the entry is what landed on disk: row i is shard i's stream
    full = host(tier.get("obj"))
    for i in range(3):
        assert np.array_equal(full[i], shards[i])
    # a dispatcher stages the bytes once; the tier uploads only what it
    # was handed as host arrays (without a dispatcher, and at depth 1)
    assert tier.uploads()[0] == (0 if depth == 2 else 1)
    if disp is not None:
        assert disp.perf.dump()["l_gpu_adopted"] == 1
        assert disp.perf.dump()["l_gpu_h2d_bytes"] == int(np.prod(SHAPE))


def test_resident_adoption_failure_never_fails_the_write():
    class Broken:
        def adopt_encode(self, *a, **kw):
            raise RuntimeError("tier full")
    si = sinfos()[0]
    payload = make_batch(SHAPE, "random").tobytes()
    want = ec.encode(si, port_codec(2, 1), payload)
    for depth in (None, 1, 2):
        disp = None if depth is None else GpuDispatcher(
            device="cpu", pipeline_depth=depth)
        try:
            got = ec.encode(si, port_codec(2, 1), payload, dispatcher=disp,
                            resident=(Broken(), "obj"))
            _, r = ec.encode_fused(si, port_codec(2, 1), payload,
                                   dispatcher=disp,
                                   resident=(Broken(), "obj"))
        finally:
            if disp is not None:
                disp.shutdown()
        assert all(np.array_equal(got[s], want[s]) for s in want)
        assert r is not None
        if disp is not None:
            assert disp.perf.dump()["l_gpu_adopt_failed"] == 2


class _PoolingHostOps(gpu_dispatch._HostDevOps):
    """The CPU legs with the CUDA legs' staging discipline: h2d copies
    into a dispatcher-private buffer, and release() hands it to the next
    batch, which is staged into it at once (here: overwritten)."""

    def h2d(self, host):
        return torch.from_numpy(np.array(host)), None, False

    def release(self, buf) -> None:
        buf.fill_(0xEE)


@pytest.mark.parametrize("kind", ["encode", "store"])
def test_staging_buffer_not_reused_under_an_adopted_entry(kind):
    """Back-to-back resident writes of one shape through the pipelined
    dispatcher: each entry must hold its own bytes, not what the next
    batch staged into a buffer released before the tier copied it."""
    disp = GpuDispatcher(device="cpu", pipeline_depth=2, max_batch=1)
    disp._devops = _PoolingHostOps()
    tier = HbmChunkTier(device="cpu")
    payloads = [make_batch(SHAPE, "random", seed) for seed in (1, 2, 3)]
    try:
        futs = []
        for i, p in enumerate(payloads):
            if kind == "encode":
                futs.append(disp.encode_async(port_codec(2, 1), p,
                                              resident=(tier, i)))
            else:
                futs.append(disp.fused_write_async(port_codec(2, 1), p,
                                                   resident=(tier, i)))
        for f in futs:
            f.result(60)
    finally:
        disp.shutdown()
    for i, p in enumerate(payloads):
        full = host(tier.get(i))
        assert np.array_equal(full[:2], p.transpose(1, 0, 2).reshape(2, -1))


def test_adopted_entry_survives_the_writer_reusing_its_buffer():
    """A client that overwrites its buffer after the write returns must
    not change the resident copy (the tier copies what it adopts)."""
    si = sinfos()[0]
    buf = make_batch(SHAPE, "random", 5)
    first = buf.copy()
    tier = HbmChunkTier(device="cpu")
    for depth in (1, 2):
        disp = GpuDispatcher(device="cpu", pipeline_depth=depth)
        try:
            ec.encode(si, port_codec(2, 1), buf, dispatcher=disp,
                      resident=(tier, ("d", depth)))
            buf[:] = 0x5A
            ec.encode(si, port_codec(2, 1), buf, dispatcher=disp,
                      resident=(tier, ("e", depth)))
        finally:
            disp.shutdown()
        full = host(tier.get(("d", depth)))
        assert np.array_equal(full[:2],
                              first.transpose(1, 0, 2).reshape(2, -1))
        buf[:] = first
