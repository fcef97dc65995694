"""The port's device mesh and placement against the JAX package's.

``ceph_tpu_torch.parallel.mesh`` on meshes of ``["cpu"] * n`` against
``ceph_tpu.parallel.mesh`` on the first n of ``tests/conftest.py``'s 8
virtual JAX devices, on the same seeded numpy inputs: the mesh shapes,
each block's stripe and column range against the reference's
``sharding.devices_indices_map``, ``encode_sharded`` / ``decode_sharded``
at n = 1, 2, 4, 8, the w=16 column split (whole words a block, padded
past the reference's rule where a block would hold half a word),
``recover_sharded`` / ``repair_sharded`` (MSR k=4) and their checksum,
which both packages trip on one corrupted byte, and
``DevicePlacement``'s round robin. The reference compiles once per
shape and mesh, so its outputs are computed once per module. Tolerance:
none (bytes are exact).
"""

import functools

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu.parallel import mesh as jmesh
from ceph_tpu.parallel import placement as jplacement
from ceph_tpu_torch import registry
from ceph_tpu_torch.device import device_label
from ceph_tpu_torch.parallel import mesh as pmesh
from ceph_tpu_torch.parallel import placement
from ceph_tpu_torch.parallel.dryrun import dryrun_multichip

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K, M = 4, 2
SIZES = [1, 2, 4, 8]
AVAILS = [(0, 1, 2, 3), (1, 2, 4, 5), (0, 2, 3, 5)]


def rs_profile(w=8):
    return {"technique": "reed_sol_van", "k": str(K), "m": str(M),
            "w": str(w)}


@functools.lru_cache(maxsize=None)
def codecs(w=8):
    """(reference, port) Reed-Solomon codecs of one profile."""
    return (jregistry.factory("jax_tpu", rs_profile(w)),
            registry.factory("torch_cuda", rs_profile(w), device="cpu"))


@functools.lru_cache(maxsize=None)
def payload(n_cols=512, stripes=8, seed=42):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(stripes, K, n_cols), dtype=np.uint8)


def cpu_mesh(n):
    return pmesh.make_mesh(devices=["cpu"] * n)


@functools.lru_cache(maxsize=None)
def ref_encode(n):
    """The reference's sharded parity and the placement of its blocks:
    ((i, j), stripe range, column range) per device."""
    ref, _ = codecs()
    mesh = jmesh.make_mesh(n)
    out = jmesh.encode_sharded(ref, payload(), mesh)
    where = {d: idx for idx, d in np.ndenumerate(mesh.devices)}
    blocks = sorted(
        (where[d], sl[0].indices(out.shape[0])[:2],
         sl[2].indices(out.shape[2])[:2])
        for d, sl in out.sharding.devices_indices_map(out.shape).items())
    return np.asarray(out), blocks


@functools.lru_cache(maxsize=None)
def ref_decode(n, avail):
    ref, _ = codecs()
    full = np.concatenate([payload(), ref_encode(1)[0]], axis=1)
    return np.asarray(jmesh.decode_sharded(ref, avail,
                                           full[:, list(avail), :],
                                           jmesh.make_mesh(n)))


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_match_jax(n):
    mine, ref = cpu_mesh(n), jmesh.make_mesh(n)
    assert mine.devices.shape == ref.devices.shape
    assert mine.axis_names == tuple(ref.axis_names)
    assert mine.shape == dict(ref.shape)
    assert all(d == torch.device("cpu") for d in mine.devices.reshape(-1))


def test_make_mesh_refuses(monkeypatch):
    with pytest.raises(ValueError):
        pmesh.make_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(pmesh, "_local_devices", lambda: [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh()
    flat = pmesh.make_mesh(devices=["cpu"] * 3, axis_names=("pg", "x"))
    assert flat.shape == {"pg": 1, "x": 3}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_blocks_are_the_references(n):
    mine = [(b.index, b.stripes, b.columns)
            for b in pmesh.partition(payload().shape, cpu_mesh(n))]
    assert sorted(mine) == ref_encode(n)[1]


@pytest.mark.parametrize("n", SIZES)
def test_encode_sharded_matches_jax(n):
    _, codec = codecs()
    got = pmesh.encode_sharded(codec, payload(), cpu_mesh(n))
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, ref_encode(n)[0])
    assert np.array_equal(got, codec.encode_batch(payload()))


@pytest.mark.parametrize("n", SIZES)
def test_decode_sharded_matches_jax(n):
    _, codec = codecs()
    full = np.concatenate([payload(), ref_encode(1)[0]], axis=1)
    for avail in AVAILS:
        got = pmesh.decode_sharded(codec, avail, full[:, list(avail), :],
                                   cpu_mesh(n))
        assert np.array_equal(got, ref_decode(n, avail)), avail
        assert np.array_equal(got, full), avail


def test_tensor_in_tensor_out():
    _, codec = codecs()
    x = torch.from_numpy(payload().copy())
    got = pmesh.encode_sharded(codec, x, cpu_mesh(4))
    assert isinstance(got, torch.Tensor) and got.device == x.device
    assert np.array_equal(got.numpy(), ref_encode(4)[0])


def test_unsplittable_batch_is_refused():
    _, codec = codecs()
    with pytest.raises(ValueError, match="does not split"):
        pmesh.encode_sharded(codec, payload()[:3], cpu_mesh(4))
    _, codec16 = codecs(16)
    with pytest.raises(ValueError, match="2-byte words"):
        pmesh.encode_sharded(codec16, payload(n_cols=12), cpu_mesh(8))


@functools.lru_cache(maxsize=None)
def w16_case():
    """w=16 survivors whose 12 columns split into 4 blocks of 3 bytes
    under the reference's padding: half a word a block."""
    ref, _ = codecs(16)
    data = payload(n_cols=12, stripes=3, seed=16)
    full = np.concatenate([data, ref.encode_batch(data)], axis=1)
    avail = (0, 2, 3, 5)
    chunks = np.ascontiguousarray(full[:, list(avail), :])
    out = jmesh.recover_sharded(ref, avail, chunks, 1,
                                mesh=jmesh.make_mesh(8))
    return full, avail, chunks, out


def test_w16_blocks_hold_whole_words():
    _, codec16 = codecs(16)
    assert pmesh._word(codec16) == 2
    x = payload(n_cols=512)
    assert np.array_equal(pmesh.encode_sharded(codec16, x, cpu_mesh(8)),
                          codecs(16)[0].encode_batch(x))
    full, avail, chunks, ref_out = w16_case()
    got = pmesh.recover_sharded(codec16, avail, chunks, 1,
                                mesh=cpu_mesh(8))
    assert np.array_equal(got, ref_out)
    assert np.array_equal(got, full[:, 1, :])


@functools.lru_cache(maxsize=None)
def recovery_case():
    ref, _ = codecs()
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=(7, K, 200), dtype=np.uint8)
    full = np.concatenate([data, ref.encode_batch(data)], axis=1)
    avail = (0, 1, 3, 4)
    chunks = np.ascontiguousarray(full[:, list(avail), :])
    expected = int(chunks.astype(np.uint64).sum()) % (1 << 32)
    out = jmesh.recover_sharded(ref, avail, chunks, 2,
                                mesh=jmesh.make_mesh(8),
                                expected_sum=expected)
    bad = chunks.copy()
    bad[3, 1, 17] ^= 0xFF
    with pytest.raises(jmesh.MeshChecksumError):
        jmesh.recover_sharded(ref, avail, bad, 2, mesh=jmesh.make_mesh(8),
                              expected_sum=expected)
    return full, avail, chunks, expected, out, bad


@pytest.mark.parametrize("n", [4, 8])
def test_recover_sharded_and_its_checksum_match_jax(n):
    """Padded stripes (7 over 2) and columns (200 over 4), the checksum
    of the blocks against the host sum, and the trip on a byte corrupted
    after the host sum was taken, in both packages."""
    _, codec = codecs()
    full, avail, chunks, expected, ref_out, bad = recovery_case()
    got = pmesh.recover_sharded(codec, avail, chunks, 2, mesh=cpu_mesh(n),
                                expected_sum=expected)
    assert np.array_equal(got, ref_out)
    assert np.array_equal(got, full[:, 2, :])
    assert np.array_equal(pmesh.recover_sharded(codec, avail, chunks, 2,
                                                mesh=cpu_mesh(n)), got)
    with pytest.raises(pmesh.MeshChecksumError):
        pmesh.recover_sharded(codec, avail, bad, 2, mesh=cpu_mesh(n),
                              expected_sum=expected)


@pytest.mark.parametrize("n", [1, 8])
def test_mesh_checksum_is_the_host_sum(n):
    x = payload(n_cols=4096)
    assert pmesh.mesh_checksum(x, cpu_mesh(n)) == \
        int(x.astype(np.uint64).sum()) % (1 << 32)
    big = np.full((8, 4, 4096 * 40), 255, dtype=np.uint8)   # past 2^32
    assert pmesh.mesh_checksum(big, cpu_mesh(n)) == \
        int(big.astype(np.uint64).sum()) % (1 << 32)


def msr_profile():
    return {"technique": "msr", "k": "4", "m": "3", "w": "8"}


@functools.lru_cache(maxsize=None)
def repair_case():
    """MSR k=4, m=3: helper fractions of target 2 and the reference's
    sharded combine of them, clean and with one corrupted byte."""
    ref = jregistry.factory("msr", msr_profile())
    chunk = ref.get_chunk_size(4096 * 4)
    data = np.random.default_rng(43).integers(0, 256, (5, 4, chunk),
                                              dtype=np.uint8)
    full = np.concatenate([data, ref.encode_batch(data)], axis=1)
    target = 2
    helpers = tuple(sorted(ref.minimum_to_repair(target, set(range(7)))))
    fracs = np.stack([ref.repair_fraction_batch(
        target, np.ascontiguousarray(full[:, h])) for h in helpers], 1)
    expected = int(fracs.astype(np.uint64).sum()) % (1 << 32)
    out = jmesh.repair_sharded(ref, target, helpers, fracs,
                               mesh=jmesh.make_mesh(8),
                               expected_sum=expected)
    bad = fracs.copy()
    bad[0, 0, 0] ^= 1
    with pytest.raises(jmesh.MeshChecksumError):
        jmesh.repair_sharded(ref, target, helpers, bad,
                             mesh=jmesh.make_mesh(8), expected_sum=expected)
    return full, target, helpers, fracs, expected, out, bad


@pytest.mark.parametrize("n", [2, 8])
def test_repair_sharded_and_its_checksum_match_jax(n):
    codec = registry.factory("msr_cuda", msr_profile(), device="cpu")
    full, target, helpers, fracs, expected, ref_out, bad = repair_case()
    got = pmesh.repair_sharded(codec, target, helpers, fracs,
                               mesh=cpu_mesh(n), expected_sum=expected)
    assert np.array_equal(got, ref_out)
    assert np.array_equal(got, full[:, target])
    with pytest.raises(pmesh.MeshChecksumError):
        pmesh.repair_sharded(codec, target, helpers, bad, mesh=cpu_mesh(n),
                             expected_sum=expected)


def test_placement_round_robin_matches_jax():
    import jax
    devs = ["cpu"] * len(jax.devices())
    mine, ref = placement.DevicePlacement(devs), jplacement.DevicePlacement()
    for osd in list(range(10)) + [99]:
        idx = 3 if osd == 99 else -1
        assert mine.resolve(osd, idx) == torch.device("cpu")
        ref.resolve(osd, idx)
    got, want = mine.assignments(), ref.assignments()
    assert got["num_devices"] == want["num_devices"]
    assert {o: r["index"] for o, r in got["osds"].items()} == \
        {o: r["index"] for o, r in want["osds"].items()}
    assert got["osds"]["9"]["device"] == "cpu:0"
    assert mine.lookup(9) == torch.device("cpu")
    mine.forget(9)
    assert mine.lookup(9) is None and "9" not in mine.assignments()["osds"]


def test_placement_without_devices_resolves_none(monkeypatch):
    monkeypatch.setattr(placement, "_local_devices", lambda: [])
    reg = placement.DevicePlacement()
    assert reg.resolve(4) is None and reg.lookup(4) is None
    assert reg.assignments() == {"local_devices": [], "num_devices": 0,
                                 "osds": {"4": {"index": -1,
                                                "device": "default"}}}
    assert placement.local_device_count() == 0
    assert placement.device_label is device_label     # one function


def test_dryrun_multichip_on_cpu_devices():
    doc = dryrun_multichip(["cpu"] * 8)
    assert doc["mesh"] == {"stripe": 2, "block": 4}
    assert doc["parity"] == [4, 3, 1024] and doc["decoded"] == [4, 11, 1024]
