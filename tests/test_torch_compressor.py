"""The port's ``jax_device`` compressor plugin against the JAX package's.

``ceph_tpu_torch.compressor`` (``create("jax_device")``) against
``ceph_tpu.compressor`` on the same bytes, made from a numpy seed: the
frames (an 8-byte ``<II`` header, then the bit-plane container) must be
byte-equal both ways, and a bad header or a short frame must raise the
same errno (EIO). Tolerance: none.
"""

import errno

import numpy as np
import pytest

from ceph_tpu import compressor as jcomp
from ceph_tpu_torch import compressor
from ceph_tpu_torch.compressor import CompressorError
from ceph_tpu_torch.errors import ErasureCodeError


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
        compressor.create("zstd")
    assert info.value.errno == errno.ENOENT
    assert isinstance(info.value, ErasureCodeError)
