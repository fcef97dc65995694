"""Packet-layout bitmatrix codecs of the PyTorch port against the JAX
reference.

The port's plain packet product (``xor_mm.bitmatrix_encode_plain``) and
the five bitmatrix techniques of ``registry.factory("torch_cuda", ...,
device="cpu")`` against ``ceph_tpu.ops.xor_mm.bitmatrix_encode``, the
numpy oracle ``gf_ref.bitmatrix_encode_ref`` and
``ceph_tpu.registry.factory("jax_tpu", ...)`` on the same inputs, made from
a seed with numpy. Every comparison is byte-exact (tolerance: none).
Every case has at least two superblocks per chunk, so a slip in the
superblock-major packet order cannot pass.
"""

import errno
import itertools

import numpy as np
import pytest
import torch

from ceph_tpu import registry as jregistry
from ceph_tpu.ops import xor_mm as jxor_mm
from ceph_tpu_torch import registry
from ceph_tpu_torch.errors import ErasureCodeError
from ceph_tpu_torch.models.liberation import binary_invert
from ceph_tpu_torch.models.matrix_base import load_numpy_state
from ceph_tpu_torch.ops import gf, gf_ref, packet_kernel, xor_mm

from .torch_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K, M, B = 3, 2, 2


@pytest.mark.parametrize("supers", [2, 3])
@pytest.mark.parametrize("packetsize", [1, 3, 8, 32, 2048])
@pytest.mark.parametrize("w", [6, 7, 8, 16, 32])
def test_plain_packet_product_matches_jax_and_oracle(w, packetsize, supers):
    rng = np.random.default_rng(w * 10007 + packetsize * 7 + supers)
    bitmat = rng.integers(0, 2, (M * w, K * w), dtype=np.uint8)
    n = supers * w * packetsize
    data = rng.integers(0, 256, (B, K, n), dtype=np.uint8)
    got = xor_mm.bitmatrix_encode_plain(torch.from_numpy(bitmat),
                                        torch.from_numpy(data), w,
                                        packetsize).numpy()
    assert got.shape == (B, M, n)
    assert np.array_equal(got, np.asarray(jxor_mm.bitmatrix_encode(
        bitmat, data, w, packetsize)))
    for b in range(B):
        assert np.array_equal(got[b], gf_ref.bitmatrix_encode_ref(
            bitmat, data[b], w, packetsize))


def test_wrapper_takes_the_plain_version_for_a_cpu_tensor():
    rng = np.random.default_rng(1)
    w, p = 7, 3
    bitmat = torch.from_numpy(rng.integers(0, 2, (2 * w, 4 * w),
                                           dtype=np.uint8))
    data = torch.from_numpy(rng.integers(0, 256, (2, 4, 3 * w * p),
                                         dtype=np.uint8))
    before = packet_kernel.LAUNCHES
    out = xor_mm.bitmatrix_encode(bitmat, data, w, p)
    assert packet_kernel.LAUNCHES == before     # no kernel on the CPU
    assert torch.equal(out, xor_mm.bitmatrix_encode_plain(bitmat, data, w, p))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w, p = 8, 16
    ok_bm = torch.zeros((2 * w, 3 * w), dtype=torch.uint8)
    ok_data = torch.zeros((1, 3, 2 * w * p), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiples"):
        xor_mm.bitmatrix_encode(ok_bm, ok_data[..., :-1], w, p)
    with pytest.raises(ValueError, match="columns"):
        xor_mm.bitmatrix_encode(ok_bm[:, :-1], ok_data, w, p)
    with pytest.raises(TypeError):
        xor_mm.bitmatrix_encode(ok_bm.int(), ok_data, w, p)
    with pytest.raises(ValueError, match="2..32"):
        xor_mm.bitmatrix_encode(ok_bm, ok_data, 33, p)
    # past 1752 rows of 32 mask words an H100's 227 KiB of opt-in shared
    # memory is exceeded, the limit a CUDA tensor's check reads from its
    # card; a CPU tensor takes the plain version, which has no such limit
    h100_optin = 232448
    packet_kernel.check_smem(1752, 1024, h100_optin)
    with pytest.raises(ValueError, match="shared memory"):
        packet_kernel.check_smem(1753, 1024, h100_optin)
    big = torch.zeros((1792, 32 * 32), dtype=torch.uint8)
    data = torch.zeros((1, 32, 32), dtype=torch.uint8)
    assert torch.equal(xor_mm.bitmatrix_encode(big, data, 32, 1),
                       torch.zeros((1, 56, 32), dtype=torch.uint8))


def test_wrapper_rejects_a_design_it_does_not_have():
    bm = torch.zeros((16, 24), dtype=torch.uint8)
    data = torch.zeros((1, 3, 2 * 8 * 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not one of"):
        packet_kernel.bitmatrix_encode(bm, data, 8, 16, design="tiled")
    assert torch.equal(packet_kernel.bitmatrix_encode(bm, data, 8, 16,
                                                      design="vector"),
                       torch.zeros((1, 2, 2 * 8 * 16), dtype=torch.uint8))


@pytest.mark.parametrize("rows,out_rows,want_ms", [
    (32, 4, 0.008764981492537315),      # cauchy_good k=10, m=4 encode
    (112, 14, 0.015027047164179104),    # its decode with chunks 0-3 erased
])
def test_packet_bound_is_the_bytes_at_the_cauchy_shape(rows, out_rows,
                                                       want_ms):
    """Even a dense bitmatrix needs far fewer byte XORs (one per set bit
    per byte of a packet row) than the bytes take at the HBM rate."""
    from ceph_tpu_torch.utils.cuda_timing import packet_bound
    meta = dict(dtype=torch.uint8, device="meta")
    ms, by = packet_bound(torch.ones((rows, 80), dtype=torch.uint8),
                          torch.empty(16, 10, 131072, **meta),
                          torch.empty(16, out_rows, 131072, **meta))
    assert by == "bytes" and ms == pytest.approx(want_ms, rel=1e-12)


# -- the five bitmatrix techniques through the registry ----------------------

TECHNIQUES = [
    {"technique": "cauchy_good", "k": "4", "m": "3", "packetsize": "8"},
    {"technique": "cauchy_good", "k": "5", "m": "2", "w": "16",
     "packetsize": "3"},
    {"technique": "cauchy_orig", "k": "5", "m": "2", "w": "7",
     "packetsize": "32"},
    {"technique": "liberation", "k": "5", "w": "7", "packetsize": "8"},
    {"technique": "blaum_roth", "k": "4", "w": "6", "packetsize": "16"},
    {"technique": "liber8tion", "k": "8", "packetsize": "8"},
]


def ids(profile):
    return "-".join(profile[key] for key in ("technique", "k")
                    ) + "-p" + profile["packetsize"]


def pair(profile):
    return (jregistry.factory("jax_tpu", dict(profile)),
            registry.factory("torch_cuda", dict(profile), device="cpu"))


@pytest.mark.parametrize("profile", TECHNIQUES, ids=ids)
def test_encode_and_every_decode_signature_match_jax(profile):
    jax_codec, codec = pair(profile)
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    super_bytes = codec.w * codec.packetsize
    size = codec.get_chunk_size(k * 2 * super_bytes)
    assert size // super_bytes >= 2
    data = np.random.default_rng(n).integers(0, 256, (2, k, size),
                                             dtype=np.uint8)
    parity = codec.encode_batch(data)
    assert np.array_equal(parity, np.asarray(jax_codec.encode_batch(data)))
    full = np.concatenate([data, parity], axis=1)
    for avail in itertools.combinations(range(n), k):
        chunks = np.ascontiguousarray(full[:, list(avail)])
        out = codec.decode_batch(avail, chunks)
        assert np.array_equal(out, full), avail
        assert np.array_equal(
            out, np.asarray(jax_codec.decode_batch(avail, chunks))), avail


@pytest.mark.parametrize("profile", TECHNIQUES, ids=ids)
def test_object_round_trip_matches_jax(profile):
    jax_codec, codec = pair(profile)
    n = codec.get_chunk_count()
    raw = np.random.default_rng(5).integers(0, 256, 3001,
                                            dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(n)), raw)
    jenc = jax_codec.encode(set(range(n)), raw)
    assert all(np.array_equal(enc[i], jenc[i]) for i in range(n))
    for i in (0, n - 1):
        del enc[i]
    assert codec.decode_concat(enc)[:len(raw)] == raw
    assert codec.decode_concat(enc) == jax_codec.decode_concat(enc)


def test_gf_domain_decode_equals_the_packet_oracle():
    profile = {"technique": "cauchy_orig", "k": "4", "m": "2", "w": "7",
               "packetsize": "3"}
    _, codec = pair(profile)
    raw = np.random.default_rng(6).integers(0, 256, 999,
                                            dtype=np.uint8).tobytes()
    enc = codec.encode(set(range(6)), raw)
    chunks = {i: enc[i] for i in (1, 3, 4, 5)}
    ref = gf_ref.decode_ref(codec.coding, 4, 7, chunks, layout="bitmatrix",
                            packetsize=3)
    out = codec.decode(set(range(6)), dict(chunks))
    assert all(np.array_equal(out[i], ref[i]) for i in range(6))


def test_tensor_in_tensor_out():
    jax_codec, codec = pair(TECHNIQUES[0])
    data = np.random.default_rng(2).integers(
        0, 256, (1, 4, codec.get_chunk_size(4 * 512)), dtype=np.uint8)
    out = codec.encode_batch(torch.from_numpy(data))
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert np.array_equal(out.numpy(), np.asarray(
        jax_codec.encode_batch(data)))


def test_liber8tion_rides_the_decode_bank_and_cauchy_does_not():
    _, lib8 = pair(TECHNIQUES[-1])
    assert lib8._ensure_decode_bank()
    assert tuple(lib8._bank_dev.shape) == (45, 80, 64)
    _, cauchy = pair({"technique": "cauchy_good", "k": "10", "m": "4",
                      "packetsize": "8"})
    assert not cauchy._ensure_decode_bank()   # C(14, 10) = 1001 > 512
    _, lib = pair(TECHNIQUES[3])
    assert not lib._ensure_decode_bank()      # no GF generator


# -- profile probes (tests/test_cauchy.py, tests/test_liberation.py) ---------

def test_alignment_and_per_chunk_alignment():
    _, codec = pair({"technique": "cauchy_good", "k": "4", "m": "2",
                     "packetsize": "8"})
    assert codec.get_alignment() == 4 * 8 * 8 * 4
    _, per = pair({"technique": "cauchy_good", "k": "4", "m": "2",
                   "packetsize": "8", "jerasure-per-chunk-alignment": "true"})
    assert per.get_alignment() == 64
    for packetsize in ("3", "5", "2048"):
        profile = {"technique": "cauchy_orig", "k": "5", "m": "2",
                   "w": "7", "packetsize": packetsize,
                   "jerasure-per-chunk-alignment": "true"}
        jax_codec, codec = pair(profile)
        assert codec.get_alignment() == jax_codec.get_alignment()
        assert codec.get_alignment() % (7 * int(packetsize)) == 0
        assert codec.get_chunk_size(1234) == jax_codec.get_chunk_size(1234)


def test_default_packetsize():
    profile = {"technique": "cauchy_good", "k": "4", "m": "2"}
    _, codec = pair(profile)
    assert codec.packetsize == 2048
    assert codec.get_profile()["packetsize"] == "2048"


@pytest.mark.parametrize("technique,k,w", [
    ("liberation", 2, 4),     # w must be prime
    ("liberation", 8, 7),     # k <= w
    ("blaum_roth", 2, 5),     # w + 1 must be prime
    ("liber8tion", 2, 7),     # w = 8
    ("liber8tion", 9, 8),     # k <= 8
])
def test_geometry_is_einval(technique, k, w):
    profile = {"technique": technique, "k": str(k), "w": str(w),
               "packetsize": "8"}
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("torch_cuda", dict(profile), device="cpu")
    assert e.value.errno == errno.EINVAL


@pytest.mark.parametrize("technique,w", [("liberation", 5),
                                         ("blaum_roth", 4),
                                         ("liber8tion", 8)])
def test_packetsize_must_be_a_multiple_of_8(technique, w):
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("torch_cuda", {"technique": technique, "k": "2",
                                        "w": str(w), "packetsize": "12"},
                         device="cpu")
    assert e.value.errno == errno.EINVAL


def test_m_forced_to_2():
    profile = {"technique": "liberation", "k": "3", "w": "5",
               "packetsize": "8", "m": "4"}
    _, codec = pair(profile)
    assert codec.m == 2 and codec.get_profile()["m"] == "2"


def test_unknown_technique_lists_all_seven():
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("torch_cuda", {"technique": "cauchy_bad"},
                         device="cpu")
    assert e.value.errno == errno.ENOENT
    for t in ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
              "cauchy_good", "liberation", "blaum_roth", "liber8tion"):
        assert t in str(e.value)


def test_binary_invert():
    rng = np.random.default_rng(11)
    for n in (1, 4, 16, 40):
        while True:
            a = rng.integers(0, 2, (n, n), dtype=np.uint8)
            try:
                inv = binary_invert(a)
                break
            except ValueError:
                continue
        assert ((a.astype(np.uint16) @ inv.astype(np.uint16)) % 2
                == np.eye(n)).all()
    with pytest.raises(ValueError):
        binary_invert(np.zeros((3, 3), dtype=np.uint8))


def test_cauchy_generators_match_jax():
    from ceph_tpu.ops import gf as jgf
    for k, m, w in ((10, 4, 8), (5, 2, 7), (6, 3, 16)):
        assert np.array_equal(gf.cauchy_original_generator(k, m, w),
                              jgf.cauchy_original_generator(k, m, w))
        assert np.array_equal(gf.cauchy_good_generator(k, m, w),
                              jgf.cauchy_good_generator(k, m, w))
    assert gf.gf_mult(gf.gf_div(7, 3, 8), 3, 8) == 7


@pytest.mark.parametrize("profile", TECHNIQUES, ids=ids)
def test_load_numpy_state_round_trips(profile):
    jax_codec, codec = pair(profile)
    load_numpy_state(codec, jax_codec.coding, jax_codec._bitmat,
                     jax_codec.packetsize)
    assert np.array_equal(codec._bitmat, jax_codec._bitmat)
    assert (codec.coding is None) == (jax_codec.coding is None)
    k = codec.get_data_chunk_count()
    data = np.random.default_rng(9).integers(
        0, 256, (1, k, codec.get_chunk_size(k * 64)), dtype=np.uint8)
    assert np.array_equal(codec.encode_batch(data),
                          np.asarray(jax_codec.encode_batch(data)))
    with pytest.raises(ValueError, match="packetsize"):
        load_numpy_state(codec, jax_codec.coding, jax_codec._bitmat,
                         jax_codec.packetsize * 2)
    bad = jax_codec._bitmat.copy()
    bad[0, 0] ^= 1
    with pytest.raises(ValueError):
        load_numpy_state(codec, jax_codec.coding, bad, jax_codec.packetsize)
