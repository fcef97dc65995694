"""LRC codec of the PyTorch port against the JAX reference.

``registry.factory("lrc_cuda", ..., device="cpu")`` against
``ceph_tpu.registry.factory("lrc_tpu", ...)`` on the same inputs, made
from a seed with numpy; every comparison is byte-exact (tolerance: none).
The port's fused encode and decode (the layer cascade composed into one
matrix) are also held against its own per-layer walk.
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

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KML = {"k": "4", "m": "2", "l": "3"}
# one explicit stack: a global RS layer over six data chunks, and two
# local XOR layers of three data chunks and their parity each
LAYERS = {"mapping": "DDD_DDD___",
          "layers": '[["DDD_DDDcc_", ""], ["DDDc______", ""],'
                    ' ["____DDD__c", ""]]'}
PROFILES = [KML, LAYERS]


def ids(profile):
    return "kml" if "l" in profile else "layers"


def pair(profile):
    return (jregistry.factory("lrc_tpu", dict(profile)),
            registry.factory("lrc_cuda", dict(profile), device="cpu"))


def stripes(codec, seed, batch=2):
    k = codec.get_data_chunk_count()
    size = codec.get_chunk_size(k * 256)
    data = np.random.default_rng(seed).integers(0, 256, (batch, k, size),
                                                dtype=np.uint8)
    return data, np.concatenate([data, codec.encode_batch(data)], axis=1)


def test_kml_geometry_and_inner_codecs():
    prof = dict(KML)
    codec = registry.factory("lrc_cuda", prof, device="cpu")
    assert (codec.get_chunk_count(), codec.get_data_chunk_count()) == (8, 4)
    assert [layer.chunks_map for layer in codec.layers] == \
        ["DDc_DDc_", "DDDc____", "____DDDc"]
    assert "mapping" not in prof and "layers" not in prof
    for layer in codec.layers:     # every inner codec on the LRC's device
        assert layer.codec.backend == "torch"
        assert layer.codec.device == torch.device("cpu")
        assert layer.codec.technique == "reed_sol_van"
    assert codec._fusable()


@pytest.mark.parametrize("profile", PROFILES, ids=ids)
def test_fused_encode_matches_jax_and_the_layer_walk(profile):
    jax_codec, codec = pair(profile)
    data, full = stripes(codec, 1)
    k = codec.get_data_chunk_count()
    assert np.array_equal(full[:, k:], np.asarray(
        jax_codec.encode_batch(data)))
    assert np.array_equal(full[:, k:], codec._encode_batch_layers(data))


@pytest.mark.parametrize("profile", PROFILES, ids=ids)
def test_fused_decode_of_local_and_global_erasures_matches_jax(profile):
    """Every signature of up to 3 erasures: the fused decode equals JAX,
    the per-layer walk and the original rows, or both sides raise EIO."""
    jax_codec, codec = pair(profile)
    n = codec.get_chunk_count()
    _, full = stripes(codec, 2)
    decoded = 0
    for e in (1, 2, 3):
        for erased in itertools.combinations(range(n), e):
            avail = tuple(i for i in range(n) if i not in erased)
            chunks = np.ascontiguousarray(full[:, list(avail)])
            try:
                expect = np.asarray(jax_codec.decode_batch(avail, chunks))
            except JaxErasureCodeError:
                with pytest.raises(ErasureCodeError) as err:
                    codec.decode_batch(avail, chunks)
                assert err.value.errno == errno.EIO
                continue
            out = codec.decode_batch(avail, chunks)
            assert np.array_equal(out, expect), erased
            assert np.array_equal(out, full), erased
            assert np.array_equal(
                out, codec._decode_batch_layers(avail, chunks)), erased
            decoded += 1
    assert decoded > n


def test_decode_one_erasure_per_group_with_want_rows():
    """The BASELINE row: chunks 0 and 5 erased, one in each locality
    group, every row wanted; tensors stay tensors."""
    jax_codec, codec = pair(KML)
    _, full = stripes(codec, 3)
    avail = (1, 2, 3, 4, 6, 7)
    chunks = np.ascontiguousarray(full[:, list(avail)])
    want = tuple(range(8))
    out = codec.decode_batch(avail, torch.from_numpy(chunks), want_rows=want)
    assert isinstance(out, torch.Tensor)
    assert np.array_equal(out.numpy(), full)
    assert np.array_equal(out.numpy(), np.asarray(
        jax_codec.decode_batch(avail, chunks, want_rows=want)))


@pytest.mark.parametrize("profile", PROFILES, ids=ids)
def test_local_repair_from_the_minimum_set(profile):
    jax_codec, codec = pair(profile)
    n = codec.get_chunk_count()
    _, full = stripes(codec, 4)
    logical_of = {codec.chunk_index(i): i for i in range(n)}
    for gone_l in range(n):
        gone = codec.chunk_index(gone_l)
        avail = set(range(n)) - {gone}
        minimum = codec.minimum_to_decode({gone}, avail)
        assert minimum == jax_codec.minimum_to_decode({gone}, avail)
        rows = tuple(sorted(logical_of[p] for p in minimum))
        chunks = np.ascontiguousarray(full[:, list(rows)])
        out = codec.decode_batch(rows, chunks, want_rows=(gone_l,))
        assert np.array_equal(out[:, gone_l], full[:, gone_l]), gone_l
        assert np.array_equal(out, codec._decode_batch_layers(
            rows, chunks, want_rows=(gone_l,))), gone_l


def test_minimum_to_decode_matches_jax():
    jax_codec, codec = pair(KML)
    for erased in itertools.chain(itertools.combinations(range(8), 1),
                                  itertools.combinations(range(8), 2),
                                  [(0, 1, 6), (0, 1, 2, 3, 7)]):
        avail = set(range(8)) - set(erased)
        for want in ({erased[0]}, set(erased), {0, 4}):
            try:
                expect = jax_codec.minimum_to_decode(want, avail)
            except JaxErasureCodeError as e:
                with pytest.raises(ErasureCodeError) as got:
                    codec.minimum_to_decode(want, avail)
                assert got.value.errno == e.errno
                continue
            assert codec.minimum_to_decode(want, avail) == expect
    assert len(codec.minimum_to_decode({0}, set(range(1, 8)))) == 3


def test_object_round_trip_matches_jax():
    jax_codec, codec = pair(KML)
    raw = np.random.default_rng(5).integers(0, 256, 4097,
                                            dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(8)), raw)
    jenc = jax_codec.encode(set(range(8)), raw)
    assert all(np.array_equal(enc[i], jenc[i]) for i in range(8))
    assert codec.decode_concat(enc)[:len(raw)] == raw
    for gone in itertools.combinations(range(8), 2):
        chunks = {i: enc[i] for i in range(8) if i not in gone}
        try:
            jdec = jax_codec.decode(set(gone), dict(chunks))
        except JaxErasureCodeError:
            with pytest.raises(ErasureCodeError):
                codec.decode(set(gone), dict(chunks))
            continue
        dec = codec.decode(set(gone), dict(chunks))
        assert all(np.array_equal(dec[i], jdec[i]) for i in gone), gone
    with pytest.raises(ErasureCodeError) as e:
        codec.decode({0, 1, 2, 3, 7},
                     {i: enc[i] for i in range(8) if i in (4, 5, 6)})
    assert e.value.errno == errno.EIO


def test_layer_options_and_a_stack_that_does_not_fuse():
    prof = {"mapping": "DDDD_",
            "layers": '[["DDDDc", {"technique": "cauchy_good", '
                      '"packetsize": "8"}]]'}
    jax_codec, codec = pair(prof)
    assert codec.layers[0].codec.packetsize == 8
    assert not codec._fusable()     # a packet-layout layer walks
    data, full = stripes(codec, 6)
    assert np.array_equal(full[:, 4:], np.asarray(
        jax_codec.encode_batch(data)))
    avail = (0, 1, 3, 4)
    assert np.array_equal(codec.decode_batch(
        avail, np.ascontiguousarray(full[:, list(avail)])), full)


@pytest.mark.parametrize("bad", [
    {"k": "4", "m": "2"}, {"k": "4", "m": "2", "l": "4"},
    {"k": "3", "m": "3", "l": "3"},
    {"layers": "not json", "mapping": "DD_"},
    {"layers": '{"a": 1}', "mapping": "DD_"},
    {"layers": "[]", "mapping": "DD_"},
    {"layers": '[["DDc", ""]]', "mapping": "DD__"}])
def test_bad_profiles_are_einval(bad):
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("lrc_cuda", dict(bad), device="cpu")
    assert e.value.errno == errno.EINVAL


def test_load_numpy_state_round_trips_every_layer():
    jax_codec, codec = pair(KML)
    for jl, pl in zip(jax_codec.layers, codec.layers):
        load_numpy_state(pl.codec, jl.codec.coding, jl.codec._bitmat)
        assert np.array_equal(pl.codec.coding, jl.codec.coding)
    data, full = stripes(codec, 7, batch=1)
    assert np.array_equal(full[:, 4:], np.asarray(
        jax_codec.encode_batch(data)))
