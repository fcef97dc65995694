"""SHEC codecs of the PyTorch port against the JAX reference.

``registry.factory("shec_cuda", ..., device="cpu")`` against
``ceph_tpu.registry.factory("shec_tpu", ...)`` on the same inputs, made
from a seed with numpy; every comparison is byte-exact (tolerance: none).
The port's fused decode (one compact decode matrix per signature) is also
held against its own stepwise host path and against the original rows.
"""

import errno
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu.errors import ErasureCodeError as JaxErasureCodeError
from ceph_tpu_torch import registry
from ceph_tpu_torch.errors import ErasureCodeError
from ceph_tpu_torch.models.matrix_base import load_numpy_state
from ceph_tpu_torch.models.shec import calc_recovery_efficiency1

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GEOMETRIES = [("multiple", 8, 4, 3), ("single", 8, 4, 3),
              ("multiple", 4, 3, 2), ("single", 4, 3, 2)]


def profile(technique, k, m, c):
    return {"technique": technique, "k": str(k), "m": str(m), "c": str(c)}


def pair(technique, k, m, c):
    prof = profile(technique, k, m, c)
    return (jregistry.factory("shec_tpu", dict(prof)),
            registry.factory("shec_cuda", dict(prof), device="cpu"))


def stripes(codec, seed, batch=2):
    k = codec.get_data_chunk_count()
    size = codec.get_chunk_size(k * 256)
    data = np.random.default_rng(seed).integers(0, 256, (batch, k, size),
                                                dtype=np.uint8)
    return data, np.concatenate([data, codec.encode_batch(data)], axis=1)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_generator_and_encode_match_jax(geometry):
    jax_codec, codec = pair(*geometry)
    assert np.array_equal(codec.coding, jax_codec.coding)
    data, full = stripes(codec, 1)
    assert np.array_equal(full[:, codec.k:],
                          np.asarray(jax_codec.encode_batch(data)))


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_fused_decode_of_one_and_two_erasures_matches_jax(geometry):
    """Every signature of 1 and 2 erasures, without want_rows: the fused
    decode equals the JAX codec, the host path and the original rows."""
    jax_codec, codec = pair(*geometry)
    n = codec.get_chunk_count()
    _, full = stripes(codec, 2)
    for e in (1, 2):
        for erased in itertools.combinations(range(n), e):
            avail = tuple(i for i in range(n) if i not in erased)
            chunks = np.ascontiguousarray(full[:, list(avail)])
            out = codec.decode_batch(avail, chunks)
            assert np.array_equal(out, full), erased
            assert np.array_equal(out, np.asarray(
                jax_codec.decode_batch(avail, chunks))), erased
            assert np.array_equal(
                out, codec._decode_batch_host(avail, chunks)), erased


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=str)
def test_sub_k_local_repair_with_want_rows(geometry):
    """minimum_to_decode's read set through the fused decode with
    want_rows: the wanted row comes back, equal to JAX and the host path."""
    jax_codec, codec = pair(*geometry)
    n = codec.get_chunk_count()
    _, full = stripes(codec, 3)
    for gone in range(n):
        avail_set = set(range(n)) - {gone}
        minimum = codec.minimum_to_decode({gone}, avail_set)
        assert minimum == jax_codec.minimum_to_decode({gone}, avail_set)
        rows = tuple(sorted(minimum))
        chunks = np.ascontiguousarray(full[:, list(rows)])
        out = codec.decode_batch(rows, chunks, want_rows=(gone,))
        assert np.array_equal(out[:, gone], full[:, gone]), gone
        assert np.array_equal(out, np.asarray(jax_codec.decode_batch(
            rows, chunks, want_rows=(gone,)))), gone
        assert np.array_equal(out, codec._decode_batch_host(
            rows, chunks, want_rows=(gone,))), gone


def test_minimum_to_decode_matches_jax():
    jax_codec, codec = pair("multiple", 8, 4, 3)
    rng = np.random.default_rng(4)
    for _ in range(40):
        erased = set(rng.choice(12, rng.integers(1, 4), replace=False)
                     .tolist())
        want = set(rng.choice(12, rng.integers(1, 5), replace=False)
                   .tolist())
        avail = set(range(12)) - erased
        try:
            expect = jax_codec.minimum_to_decode(want, avail)
        except JaxErasureCodeError as e:   # the port fails the same way
            with pytest.raises(ErasureCodeError) as got:
                codec.minimum_to_decode(want, avail)
            assert got.value.errno == e.errno
            continue
        assert codec.minimum_to_decode(want, avail) == expect
    assert len(codec.minimum_to_decode({0}, set(range(1, 12)))) <= 6


def test_unrecoverable_set_is_eio():
    jax_codec, codec = pair("multiple", 8, 4, 3)
    n = codec.get_chunk_count()
    _, full = stripes(codec, 5, batch=1)
    unrecoverable = 0
    for erased in itertools.combinations(range(n), 4):
        avail = tuple(i for i in range(n) if i not in erased)
        chunks = np.ascontiguousarray(full[:, list(avail)])
        try:
            jax_codec.decode_batch(avail, chunks)
        except JaxErasureCodeError:
            with pytest.raises(ErasureCodeError) as e:
                codec.decode_batch(avail, chunks)
            assert e.value.errno == errno.EIO
            unrecoverable += 1
            if unrecoverable == 3:
                break
    assert unrecoverable == 3
    with pytest.raises(ErasureCodeError) as e:
        codec.decode(set(range(n)), {i: full[0, i] for i in range(7)})
    assert e.value.errno == errno.EIO


def test_object_round_trip_matches_jax():
    jax_codec, codec = pair("multiple", 8, 4, 3)
    raw = np.random.default_rng(6).integers(0, 256, 5000,
                                            dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(12)), raw)
    jenc = jax_codec.encode(set(range(12)), raw)
    assert all(np.array_equal(enc[i], jenc[i]) for i in range(12))
    for gone in range(12):
        minimum = codec.minimum_to_decode({gone}, set(range(12)) - {gone})
        dec = codec.decode({gone}, {i: enc[i] for i in minimum})
        assert np.array_equal(dec[gone], enc[gone]), gone
    chunks = {i: enc[i] for i in range(12) if i not in (2, 9)}
    out = codec.decode_all(chunks)
    assert all(np.array_equal(out[i], enc[i]) for i in range(12))


def test_fused_bank_only_for_a_small_signature_space():
    _, small = pair("multiple", 4, 3, 2)
    assert small._ensure_fused_bank()
    for e, (idx, gfs, bms, dev) in small._fused_bank_index.items():
        assert len(gfs) == len(idx) == dev.shape[0]
        assert dev.dtype == torch.uint8
        assert tuple(dev.shape[1:]) == (7 * 8, (7 - e) * 8)
    _, large = pair("multiple", 8, 4, 3)
    assert not large._ensure_fused_bank()    # 793 signatures > 512


def test_tensor_in_tensor_out():
    _, codec = pair("multiple", 8, 4, 3)
    data, full = stripes(codec, 7)
    avail = tuple(i for i in range(12) if i not in (2, 9))
    out = codec.decode_batch(avail, torch.from_numpy(
        np.ascontiguousarray(full[:, list(avail)])),
        want_rows=tuple(range(12)))
    assert isinstance(out, torch.Tensor) and np.array_equal(out.numpy(), full)


@pytest.mark.parametrize("bad", [
    {"k": "4", "m": "3"}, {"k": "4", "m": "5", "c": "2"},
    {"k": "4", "m": "2", "c": "3"}, {"k": "13", "m": "3", "c": "2"},
    {"k": "12", "m": "9", "c": "2"}, {"k": "4", "m": "3", "c": "2",
                                      "w": "7"}])
def test_bad_profiles_are_einval(bad):
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("shec_cuda", dict(bad), device="cpu")
    assert e.value.errno == errno.EINVAL


def test_defaults_and_unknown_technique():
    prof = {}
    codec = registry.factory("shec_cuda", prof, device="cpu")
    assert (codec.k, codec.m, codec.c) == (4, 3, 2)
    assert prof["technique"] == "multiple"
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("shec_cuda", {"technique": "double"}, device="cpu")
    assert e.value.errno == errno.ENOENT
    assert "multiple" in str(e.value) and "single" in str(e.value)
    assert calc_recovery_efficiency1(8, 2, 2, 1, 2) > 0


@pytest.mark.parametrize("geometry", GEOMETRIES[:2], ids=str)
def test_load_numpy_state_round_trips(geometry):
    jax_codec, codec = pair(*geometry)
    load_numpy_state(codec, jax_codec.coding, jax_codec._bitmat)
    assert np.array_equal(codec.coding, jax_codec.coding)
    data, full = stripes(codec, 8, batch=1)
    assert np.array_equal(full[:, 8:], np.asarray(
        jax_codec.encode_batch(data)))
    avail = tuple(range(2, 12))
    assert np.array_equal(codec.decode_batch(
        avail, np.ascontiguousarray(full[:, 2:])), full)
    bad = jax_codec.coding.copy()
    bad[0, 0] ^= 1
    with pytest.raises(ValueError):
        load_numpy_state(codec, bad, jax_codec._bitmat)
