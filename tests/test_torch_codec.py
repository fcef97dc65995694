"""RS codec of the PyTorch port against the JAX reference codec.

``ceph_tpu_torch.registry.factory("torch_cuda", ..., device="cpu")``
against ``ceph_tpu.registry.factory("jax_tpu", ...)`` on the same inputs,
made from a seed with numpy; every comparison is byte-exact (tolerance:
none).
"""

import errno
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu_torch import registry
from ceph_tpu_torch.errors import ErasureCodeError
from ceph_tpu_torch.models.matrix_base import load_numpy_state
from ceph_tpu_torch.models.rs import ReedSolomonVandermonde
from ceph_tpu_torch.ops import gf_ref

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PROFILE = {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "8"}


def port_codec(profile=PROFILE, **kw):
    return registry.factory("torch_cuda", dict(profile), device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    return (jregistry.factory("jax_tpu", dict(PROFILE)), port_codec())


@pytest.fixture(scope="module")
def encoded(pair):
    """The __graft_entry__.entry shape: [4, 8, 8192] plus its parity."""
    jax_codec, codec = pair
    data = np.random.default_rng(0).integers(0, 256, size=(4, 8, 8192),
                                             dtype=np.uint8)
    return data, np.concatenate([data, codec.encode_batch(data)], axis=1)


def test_encode_matches_jax(pair, encoded):
    jax_codec, codec = pair
    data, full = encoded
    assert np.array_equal(full[:, 8:],
                          np.asarray(jax_codec.encode_batch(data)))
    for b in range(data.shape[0]):
        assert np.array_equal(
            full[b, 8:], gf_ref.matrix_encode_ref(codec.coding, data[b], 8))


def test_decode_all_165_signatures_match_jax(pair, encoded):
    jax_codec, codec = pair
    _, full = encoded
    sigs = list(itertools.combinations(range(11), 8))
    assert len(sigs) == 165
    for avail in sigs:
        chunks = np.ascontiguousarray(full[:, list(avail)])
        out = codec.decode_batch(avail, chunks)
        assert np.array_equal(out, full), avail
        assert np.array_equal(
            out, np.asarray(jax_codec.decode_batch(avail, chunks))), avail
    # the whole signature space came out of the device-resident bank
    assert tuple(codec._bank_dev.shape) == (165, 88, 64)
    assert codec._bank_dev.dtype == torch.uint8
    assert codec.table_cache_stats()["entries"] == 165


def test_tensor_in_tensor_out(pair, encoded):
    _, codec = pair
    data, full = encoded
    out = codec.encode_batch(torch.from_numpy(data))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert np.array_equal(out.numpy(), full[:, 8:])


@pytest.mark.parametrize("erase", [(0,), (3, 9), (0, 5, 10), (8, 9, 10)])
def test_decode_concat_round_trip(pair, erase):
    jax_codec, codec = pair
    raw = np.random.default_rng(len(erase)).integers(
        0, 256, size=1_000_003, dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(11)), raw)
    jenc = jax_codec.encode(set(range(11)), raw)
    assert all(np.array_equal(enc[i], jenc[i]) for i in range(11))
    for i in erase:
        del enc[i]
    out = codec.decode_concat(enc)
    assert out[:len(raw)] == raw
    assert out == jax_codec.decode_concat(enc)


def test_xor_shortcut_fires():
    codec = port_codec()
    raw = np.random.default_rng(4).integers(0, 256, 65536,
                                            dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(11)), raw)
    want = enc.pop(5)
    assert codec.minimum_to_decode({5}, set(enc)) == \
        set(range(9)) - {5}
    out = codec.decode({5}, enc)
    assert np.array_equal(out[5], want)
    assert codec.xor_fast_hits == 1
    assert codec.table_cache_stats()["xor_fast_hits"] == 1


def test_raid6_matches_jax():
    profile = {"technique": "reed_sol_r6_op", "k": "6", "w": "16"}
    jax_codec = jregistry.factory("jax_tpu", dict(profile))
    codec = port_codec(profile)
    assert codec.get_coding_chunk_count() == 2
    data = np.random.default_rng(6).integers(0, 256, (2, 6, 2048),
                                             dtype=np.uint8)
    assert np.array_equal(codec.encode_batch(data),
                          np.asarray(jax_codec.encode_batch(data)))


def test_numpy_backend_matches_device_backend(encoded):
    data, full = encoded
    codec = ReedSolomonVandermonde(backend="numpy")
    codec.init(dict(PROFILE))
    assert codec.device is None
    assert np.array_equal(codec.encode_batch(data), full[:, 8:])
    avail = (1, 2, 3, 5, 6, 7, 8, 10)
    assert np.array_equal(
        codec.decode_batch(avail, np.ascontiguousarray(full[:, list(avail)])),
        full)


def test_more_than_m_erased_is_eio():
    codec = port_codec()
    enc = codec.encode(set(range(11)), b"x" * 4096)
    for i in (0, 1, 2, 3):
        del enc[i]
    with pytest.raises(ErasureCodeError) as e:
        codec.decode(set(range(11)), enc)
    assert e.value.errno == errno.EIO
    with pytest.raises(ErasureCodeError) as e:
        codec.decode_batch((0, 1, 2), np.zeros((1, 3, 64), np.uint8))
    assert e.value.errno == errno.EIO


def test_unknown_technique_and_plugin_are_enoent():
    with pytest.raises(ErasureCodeError) as e:
        port_codec({"technique": "cauchy_good", "k": "8", "m": "3"})
    assert e.value.errno == errno.ENOENT
    assert "reed_sol_van" in str(e.value) and "reed_sol_r6_op" in str(e.value)
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("jerasure", dict(PROFILE), device="cpu")
    assert e.value.errno == errno.ENOENT


@pytest.mark.parametrize("profile", [
    {"technique": "reed_sol_van", "k": "8", "m": "3", "w": "11"},
    {"technique": "reed_sol_van", "k": "1", "m": "3"},
    {"technique": "reed_sol_van", "k": "eight", "m": "3"},
])
def test_bad_profiles_are_einval(profile):
    with pytest.raises(ErasureCodeError) as e:
        port_codec(profile)
    assert e.value.errno == errno.EINVAL


def test_one_byte_object_round_trip(pair):
    jax_codec, codec = pair
    enc = codec.encode(set(range(11)), b"\x5a")
    assert enc[0].size == codec.get_chunk_size(1)
    assert all(np.array_equal(enc[i], jax_codec.encode(set(range(11)),
                                                       b"\x5a")[i])
               for i in range(11))
    del enc[0], enc[9]
    assert codec.decode_concat(enc)[:1] == b"\x5a"


def test_registry_eexist_exdev_and_profile_echo():
    reg = registry.ErasureCodePluginRegistry()
    reg.add("mine", registry.ErasureCodePlugin())
    with pytest.raises(ErasureCodeError) as e:
        reg.add("mine", registry.ErasureCodePlugin())
    assert e.value.errno == errno.EEXIST

    class Old(registry.ErasureCodePlugin):
        version = "0.9"

    reg.loaders["old"] = Old
    with pytest.raises(ErasureCodeError) as e:
        reg.load("old")
    assert e.value.errno == errno.EXDEV

    class Forgetful(registry.ErasureCodePlugin):
        def factory(self, profile, errors=None, device=None):
            codec = ReedSolomonVandermonde(device=device)
            codec.init(dict(profile), errors)  # echoes into a copy
            codec._profile = {"k": "2"}
            return codec

    reg.add("forgetful", Forgetful())
    with pytest.raises(ErasureCodeError) as e:
        reg.factory("forgetful", dict(PROFILE), device="cpu")
    assert e.value.errno == errno.EINVAL

    profile = {"k": "8", "m": "3"}
    reg.factory("torch_cuda", profile, device="cpu")
    assert profile["technique"] == "reed_sol_van" and profile["w"] == "8"


def test_load_numpy_state(pair):
    jax_codec, _ = pair
    codec = port_codec()
    load_numpy_state(codec, jax_codec.coding, jax_codec._bitmat)
    assert np.array_equal(codec.coding, jax_codec.coding)
    assert np.array_equal(codec._bitmat, jax_codec._bitmat)
    data = np.random.default_rng(8).integers(0, 256, (1, 8, 512),
                                             dtype=np.uint8)
    assert np.array_equal(codec.encode_batch(data),
                          np.asarray(jax_codec.encode_batch(data)))
    bad = jax_codec.coding.copy()
    bad[1, 2] ^= 1
    with pytest.raises(ValueError):
        load_numpy_state(codec, bad, jax_codec._bitmat)
    with pytest.raises(ValueError):
        load_numpy_state(codec, jax_codec.coding, jax_codec._bitmat[:16])
