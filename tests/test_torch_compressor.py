"""The port's compressor plugins against the JAX package's.

``ceph_tpu_torch.compressor`` against ``ceph_tpu.compressor`` on the same
bytes, made from a numpy seed: the ``jax_device`` frames (an 8-byte
``<II`` header, then the bit-plane container) byte-equal both ways, a
bad header or a short frame raising the same errno (EIO); zlib's bytes
(and zstd's where ``zstandard`` imports) equal to the reference's; the
compression modes and the required-ratio gate; the registry's aliases,
version gate and errors (ENOENT, EEXIST, EXDEV), ``preload`` and the
``available`` probe, snappy and lz4 behind their probes (absent here).
Tolerance: none.
"""

import errno

import numpy as np
import pytest

from ceph_tpu import compressor as jcomp
from ceph_tpu.compressor import plugins as jplug
from ceph_tpu.compressor import registry as jreg
from ceph_tpu_torch import compressor
from ceph_tpu_torch.compressor import CompressorError
from ceph_tpu_torch.compressor import plugins as pplug
from ceph_tpu_torch.compressor import registry as preg
from ceph_tpu_torch.errors import ErasureCodeError

ALGS = ["zlib", "zstd", "snappy", "lz4", "jax_device"]
# the algorithms whose host library this machine has (zlib always)
PRESENT = [a for a in ALGS if jreg.available(a)]


def payloads():
    rng = np.random.default_rng(12)
    return {
        "empty": b"",
        "one": b"\x07",
        "low": rng.integers(0, 4, 4096 + 17, dtype=np.uint8).tobytes(),
        "random": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        "zeros": bytes(640),
        "ones": b"\xff" * 129,
    }


@pytest.mark.parametrize("name", list(payloads()))
def test_frames_match_jax_both_ways(name):
    data = payloads()[name]
    mine, ref = compressor.create("jax_device"), jcomp.create("jax_device")
    frame = mine.compress(data)
    assert frame == ref.compress(data)
    assert mine.decompress(frame) == data
    assert ref.decompress(frame) == data
    assert mine.decompress(ref.compress(data)) == data


@pytest.mark.parametrize("frame", [
    b"\x01\x02\x03",                                 # shorter than a header
    (70).to_bytes(4, "little") + (64).to_bytes(4, "little"),   # padded < raw
    (10).to_bytes(4, "little") + (65).to_bytes(4, "little"),   # not 64-aligned
    # one block, all 8 planes stored, but no payload bytes for them
    (64).to_bytes(4, "little") + (64).to_bytes(4, "little") + b"\xff\x00",
])
def test_bad_frames_raise_the_same_errno(frame):
    with pytest.raises(CompressorError) as mine:
        compressor.create("jax_device").decompress(frame)
    with pytest.raises(jcomp.CompressorError) as ref:
        jcomp.create("jax_device").decompress(frame)
    assert mine.value.errno == ref.value.errno == errno.EIO


def test_short_frame_raises_eio():
    """A frame cut short: its container lacks the planes it declares."""
    frame = jcomp.create("jax_device").compress(payloads()["random"])
    for comp, err in ((compressor.create("jax_device"), CompressorError),
                      (jcomp.create("jax_device"), jcomp.CompressorError)):
        with pytest.raises(err) as info:
            comp.decompress(frame[:-1])
        assert info.value.errno == errno.EIO


def test_registry_aliases_and_unknown_names():
    assert compressor.create("") is None and compressor.create("none") is None
    assert compressor.create("jax_device").get_type_name() == "jax_device"
    with pytest.raises(CompressorError) as info:
        compressor.create("brotli9000")
    assert info.value.errno == errno.ENOENT
    assert isinstance(info.value, ErasureCodeError)
    with pytest.raises(jcomp.CompressorError) as ref:
        jcomp.create("brotli9000")
    assert str(info.value) == str(ref.value)


# -- the other algorithms ------------------------------------------------------

def test_probes_match_reference():
    assert (pplug.HAVE_ZSTD, pplug.HAVE_SNAPPY, pplug.HAVE_LZ4) == \
        (jplug.HAVE_ZSTD, jplug.HAVE_SNAPPY, jplug.HAVE_LZ4)
    assert [compressor.available(a) for a in ALGS + ["", "none", "nope"]] \
        == [jcomp.available(a) for a in ALGS + ["", "none", "nope"]]
    assert "zlib" in PRESENT and "jax_device" in PRESENT


@pytest.mark.parametrize("alg", PRESENT)
@pytest.mark.parametrize("name", list(payloads()))
def test_bytes_match_reference(alg, name):
    data = payloads()[name] * (1 if name != "low" else 4)
    mine, ref = compressor.create(alg), jcomp.create(alg)
    blob = mine.compress(data)
    assert blob == ref.compress(data)
    assert mine.decompress(blob) == data == ref.decompress(blob)
    assert mine.get_type_name() == ref.get_type_name() == alg


@pytest.mark.parametrize("alg", PRESENT)
def test_corrupt_input_raises_eio_like_reference(alg):
    garbage = b"this is not a compressed frame"
    with pytest.raises(CompressorError) as mine:
        compressor.create(alg).decompress(garbage)
    with pytest.raises(jcomp.CompressorError) as ref:
        jcomp.create(alg).decompress(garbage)
    assert mine.value.errno == ref.value.errno == errno.EIO


@pytest.mark.parametrize("alg", ["snappy", "lz4", "zstd"])
def test_absent_host_library_enoent_like_reference(alg):
    mine, ref = preg.CompressionPluginRegistry(), \
        jreg.CompressionPluginRegistry()
    if ref.available(alg):
        assert mine.available(alg)
        c = mine.factory(alg)
        assert c.decompress(c.compress(b"abc" * 100)) == b"abc" * 100
        return
    for reg, err in ((mine, CompressorError), (ref, jcomp.CompressorError)):
        with pytest.raises(err) as info:
            reg.load(alg)
        assert info.value.errno == errno.ENOENT
    assert not mine.available(alg)


@pytest.mark.parametrize("mode,hints", [
    (m, h) for m in ("none", "passive", "aggressive", "force")
    for h in ((False, False), (True, False), (False, True), (True, True))])
def test_modes_match_reference(mode, hints):
    assert compressor.should_compress(mode, *hints) == \
        jcomp.should_compress(mode, *hints)


def test_unknown_mode_einval():
    with pytest.raises(CompressorError) as mine:
        compressor.should_compress("sometimes")
    with pytest.raises(jcomp.CompressorError) as ref:
        jcomp.should_compress("sometimes")
    assert mine.value.errno == ref.value.errno == errno.EINVAL
    assert (compressor.MODE_NONE, compressor.MODE_PASSIVE,
            compressor.MODE_AGGRESSIVE, compressor.MODE_FORCE) == \
        (jcomp.MODE_NONE, jcomp.MODE_PASSIVE, jcomp.MODE_AGGRESSIVE,
         jcomp.MODE_FORCE)


@pytest.mark.parametrize("name", list(payloads()))
@pytest.mark.parametrize("ratio", [0.875, 0.5, 1.5])
def test_required_ratio_gate_matches_reference(name, ratio):
    data = payloads()[name]
    got = compressor.compress_if_worthwhile(compressor.create("zlib"), data,
                                            ratio)
    assert got == jcomp.compress_if_worthwhile(jcomp.create("zlib"), data,
                                               ratio)
    assert compressor.compress_if_worthwhile(None, data) == (None, data)


def test_registry_errors_match_reference():
    mine, ref = preg.CompressionPluginRegistry(), \
        jreg.CompressionPluginRegistry()
    codes = []
    for reg, mod, err in ((mine, preg, CompressorError),
                          (ref, jreg, jcomp.CompressorError)):
        reg.load("zlib")
        assert reg.load("zlib") is reg.load("zlib")
        with pytest.raises(err) as dup:
            reg.add("zlib", mod.CompressionPlugin(lambda: None))
        bad = mod.CompressionPlugin(lambda: None)
        bad.version = "0.0.1"
        reg.loaders["bad"] = lambda: bad
        with pytest.raises(err) as gate:
            reg.load("bad")
        with pytest.raises(err) as missing:
            reg.factory("brotli9000")
        codes.append([(e.value.errno, str(e.value))
                      for e in (dup, gate, missing)])
    assert codes[0] == codes[1]
    assert [c for c, _ in codes[0]] == [errno.EEXIST, errno.EXDEV,
                                        errno.ENOENT]


def test_preload_and_add_match_reference():
    mine, ref = preg.CompressionPluginRegistry(), \
        jreg.CompressionPluginRegistry()
    names = ", ".join(a for a in PRESENT if a != "jax_device")
    mine.preload(names)
    ref.preload(names)
    assert set(mine.plugins) == set(ref.plugins)
    mine.preload(["jax_device"])
    assert "jax_device" in mine.plugins
    mine.add("mine", preg.CompressionPlugin(pplug.ZlibCompressor))
    assert mine.factory("mine").compress(b"abc") == \
        jcomp.create("zlib").compress(b"abc")
    assert preg.CompressionPluginRegistry.instance() is \
        preg.CompressionPluginRegistry.instance()
